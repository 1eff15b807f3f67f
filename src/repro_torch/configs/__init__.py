"""Architecture registry: the 10 assigned archs + reduced smoke variants
+ the paper-scale pipeline demo config.

``get(name)`` returns the published full config (dry-run only — params
are never materialized at full scale on this host); ``reduced(name)``
returns a small same-family config for CPU smoke tests and examples.
"""
from __future__ import annotations

import dataclasses

from ..models.config import ArchConfig
from . import (falcon_mamba_7b, granite_20b, phi3_5_moe_42b_a6_6b,
               phi_3_vision_4_2b, qwen3_1_7b, qwen3_moe_30b_a3b,
               starcoder2_3b, starcoder2_7b, whisper_small, zamba2_7b)

REGISTRY: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in [
    phi_3_vision_4_2b, falcon_mamba_7b, starcoder2_3b, qwen3_1_7b,
    granite_20b, starcoder2_7b, whisper_small, qwen3_moe_30b_a3b,
    phi3_5_moe_42b_a6_6b, zamba2_7b,
]}

ARCH_NAMES = tuple(REGISTRY)


def get(name: str) -> ArchConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}") from None


def reduced(name: str) -> ArchConfig:
    """Tiny same-family config: same code paths, laptop-scale shapes."""
    c = get(name)
    kw = dict(
        name=c.name + "-reduced", n_layers=2, d_model=64, vocab=256,
        d_ff=128 if c.d_ff else 0, head_dim=16, moe_group_size=64,
        attn_chunk=32, ssm_chunk=16, dtype="float32", remat=False,
    )
    if c.family == "ssm":
        kw.update(n_heads=0, n_kv_heads=0, ssm_state=8)
    elif c.family == "hybrid":
        kw.update(n_heads=4, n_kv_heads=4, ssm_state=8, ssm_head_dim=16,
                  shared_attn_every=2, n_layers=4)
    elif c.family == "moe":
        kw.update(n_heads=4, n_kv_heads=2, n_experts=4, top_k=2)
    elif c.family == "encdec":
        kw.update(n_heads=4, n_kv_heads=4, n_enc_layers=2, enc_frames=24)
    elif c.family == "vlm":
        kw.update(n_heads=4, n_kv_heads=4, n_patches=8)
    else:
        kw.update(n_heads=4, n_kv_heads=max(1, min(c.n_kv_heads, 2)))
    return c.replace(**kw)
