"""Decoder LM for serving: the dense, vlm, moe and ssm (Mamba-1)
families (counterpart of ``src/repro/models/lm.py``).

The reference stacks per-layer params on a leading ``layers`` axis and
scans over it; here the layers are an ``nn.ModuleList`` walked by a
Python loop, each block a ``Leaves`` node with the reference's keys and
leaf shapes, so ``from_reference`` only unstacks that axis.

Cache (serving): ``{"k", "v": (L, B, cache_len, KV, hd), "pos": int}``,
zero past the prompt, for attention (dense, vlm, moe); ``{"conv": (L,
B, K-1, di) in the working dtype, "h": (L, B, di, N) fp32, "pos":
int}`` for ssm, which ignores ``cache_len`` as the reference does.
``pos`` stays a Python int on the host, so no decode step waits on the
device to read it.
Decode writes the new k/v rows, or the new conv window and state, into
the cache tensors in place (the reference returns updated copies): the
cache passed to ``forward_decode`` is the one it returns, with ``pos``
advanced.

``cfg.attn_impl`` picks the kernels: ``"pallas"`` runs attention, the
selective scan and every RMSNorm through ``kernels.ops``, ``"xla"``
through the plain copies of the reference's routes.  A moe block's MLP
is ``mlp.moe_mlp`` (``cfg.moe_impl="sort"``) or ``mlp.moe_mlp_gshard``
(``"gshard"``) on either route; serving discards its load-balance term,
as the reference's prefill and decode do.  The hybrid and encdec
families are not ported yet (ROADMAP queue 1, item 10).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .attention import (attend_decode, attend_prefill, attn_params,
                        cache_update, o_project, qkv_project)
from .cnn.zoo import resolve_device
from .common import DTYPES, Init, Leaves, embed_lookup, lm_logits, norm
from .mlp import mlp, mlp_params, moe_mlp, moe_mlp_gshard, moe_params
from .ssm import mamba1_block, mamba1_params

FAMILIES = ("dense", "vlm", "moe", "ssm")


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP queue 1, item 10; the port serves the "
            f"{', '.join(FAMILIES)} families)")


# --------------------------------------------------------------------------- #
# Parameters
# --------------------------------------------------------------------------- #
def _norm_params(leaf, d: int) -> dict:
    return {"scale": leaf((d,), "ones")}


def layer_params(cfg, leaf) -> dict:
    """One block: the reference's ``_attn_block_params`` (dense/vlm), its
    moe layer (the same with a routed MLP) or its ssm layer (a norm and
    a Mamba-1 mixer)."""
    if cfg.family == "ssm":
        return {"ln": _norm_params(leaf, cfg.d_model),
                "mamba": mamba1_params(cfg, leaf)}
    p = {"ln1": _norm_params(leaf, cfg.d_model),
         "attn": attn_params(cfg, leaf),
         "ln2": _norm_params(leaf, cfg.d_model)}
    if cfg.family == "moe":
        p["moe"] = moe_params(cfg, leaf)
    else:
        p["mlp"] = mlp_params(cfg, leaf)
    return p


def build_params(cfg, leaf) -> dict:
    """The reference's ``build_params`` tree, with ``layers`` a list of
    per-layer trees instead of one stacked tree."""
    _check_family(cfg)
    tree: dict = {"embed": {"table": leaf((cfg.vocab, cfg.d_model),
                                          scale=0.02)}}
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": leaf((cfg.d_model, cfg.vocab))}
    tree["final_norm"] = _norm_params(leaf, cfg.d_model)
    tree["layers"] = [layer_params(cfg, leaf) for _ in range(cfg.n_layers)]
    return tree


class LM(nn.Module):
    """Embedding, blocks, final norm and the optional untied head, as
    frozen parameters; the forward functions below run it."""

    def __init__(self, cfg, tree: dict):
        super().__init__()
        _check_family(cfg)
        if len(tree["layers"]) != cfg.n_layers:
            raise ValueError(f"{len(tree['layers'])} layers for "
                             f"{cfg.name}'s {cfg.n_layers}")
        self.cfg = cfg
        self.embed = Leaves(tree["embed"])
        self.layers = nn.ModuleList(Leaves(p) for p in tree["layers"])
        self.final_norm = Leaves(tree["final_norm"])
        self.lm_head = Leaves(tree["lm_head"]) if "lm_head" in tree else None

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())


def init(cfg, generator: torch.Generator, device=None) -> LM:
    """Random weights drawn from ``generator`` (which must live on the
    target device) with the reference's shapes and scales, in
    ``cfg.dtype``, on ``device`` (``cuda`` unless the caller names
    another)."""
    dev = resolve_device(device)
    return LM(cfg, build_params(cfg, Init(generator, DTYPES[cfg.dtype], dev)))


def from_reference(cfg, params_np: dict, device=None) -> LM:
    """The reference's params (``jax.tree.map(np.asarray, params)``) as a
    port ``LM`` on ``device``: the stacked ``layers`` axis is split into
    per-block nodes (a moe block's expert stacks included), every leaf
    keeps its shape and dtype (a moe router stays fp32 in a bf16 tree).
    bf16 leaves arrive as numpy's ``bfloat16`` extension type and are
    widened to fp32 on the host, then narrowed back on the device (exact
    both ways)."""
    dev = resolve_device(device)

    def tensor(a) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return tensor(node)

    def layer(node, i):
        if isinstance(node, dict):
            return {k: layer(v, i) for k, v in node.items()}
        return tensor(np.asarray(node)[i])

    tree = {k: convert(v) for k, v in params_np.items() if k != "layers"}
    tree["layers"] = [layer(params_np["layers"], i)
                      for i in range(cfg.n_layers)]
    return LM(cfg, tree)


# --------------------------------------------------------------------------- #
# Blocks and trunk
# --------------------------------------------------------------------------- #
def _attention(cfg, p, x, positions, kv_cache, pos):
    """The pre-norm attention half of a block → (x, (k, v)): the
    prompt's k/v in prefill, the updated caches in decode."""
    h = norm(cfg, x, p.ln1.scale)
    q, k, v = qkv_project(cfg, p.attn, h, positions)
    if kv_cache is not None:
        kc, vc = cache_update(*kv_cache, k, v, pos)
        o = attend_decode(cfg, q, kc, vc, pos)
        new_kv = (kc, vc)
    else:
        o = attend_prefill(cfg, q, k, v, causal=True)
        new_kv = (k, v)
    return x + o_project(p.attn, o), new_kv


def attn_mlp_block(cfg, p, x, positions, *, kv_cache=None, pos=None):
    """Standard pre-norm transformer block (the reference's
    ``_attn_mlp_block`` without the layer-norm variant).  Returns
    (x, (k, v)): the prompt's k/v in prefill, the updated caches in
    decode."""
    x, new_kv = _attention(cfg, p, x, positions, kv_cache, pos)
    h2 = norm(cfg, x, p.ln2.scale)
    return x + mlp(cfg, p.mlp, h2), new_kv


def moe_block(cfg, p, x, positions, *, kv_cache=None, pos=None):
    """The reference's ``_moe_block``: attention, then the routed MLP of
    ``cfg.moe_impl``.  Returns (x, (k, v), aux)."""
    x, new_kv = _attention(cfg, p, x, positions, kv_cache, pos)
    h2 = norm(cfg, x, p.ln2.scale)
    moe_fn = moe_mlp_gshard if cfg.moe_impl == "gshard" else moe_mlp
    y, aux = moe_fn(cfg, p.moe, h2)
    return x + y, new_kv, aux


def _serving_block(cfg, p, x, positions, **kw):
    """An attention family's block for serving → (x, (k, v)); a moe
    block's aux is discarded."""
    if cfg.family == "moe":
        return moe_block(cfg, p, x, positions, **kw)[:2]
    return attn_mlp_block(cfg, p, x, positions, **kw)


def ssm_block(cfg, p, x, cache=None, h_out=None):
    """Pre-norm Mamba-1 block (the reference's ``_ssm_block``).  Returns
    (x, {"conv", "h"}); the state goes into ``h_out`` when given."""
    h = norm(cfg, x, p.ln.scale)
    y, new_cache = mamba1_block(cfg, p.mamba, h, cache, h_out)
    return x + y, new_cache


def trunk_prefill(cfg, model: LM, x, positions, cache_len: int):
    """x: (B, S, D) → (hidden, cache); ``cache_len >= S`` (unused by
    ssm)."""
    B, S, _ = x.shape
    if cfg.family == "ssm":
        L, K, di = cfg.n_layers, cfg.ssm_conv, cfg.d_inner
        convs = torch.empty((L, B, K - 1, di), dtype=x.dtype,
                            device=x.device)
        hs = torch.empty((L, B, di, cfg.ssm_state), dtype=torch.float32,
                         device=x.device)
        for i, p in enumerate(model.layers):
            x, new = ssm_block(cfg, p, x, h_out=hs[i])
            convs[i] = new["conv"]
        return x, {"conv": convs, "h": hs, "pos": S}
    shape = (cfg.n_layers, B, cache_len, cfg.n_kv_heads, cfg.hd)
    ks = torch.zeros(shape, dtype=x.dtype, device=x.device)
    vs = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for i, p in enumerate(model.layers):
        x, (k, v) = _serving_block(cfg, p, x, positions)
        ks[i, :, :S] = k
        vs[i, :, :S] = v
    return x, {"k": ks, "v": vs, "pos": S}


def trunk_decode(cfg, model: LM, x, cache: dict):
    """x: (B, 1, D) → (hidden, cache) with the new row written at
    ``cache["pos"]`` of every layer (ssm: each layer's conv window and
    state updated in place)."""
    pos = cache["pos"]
    if cfg.family == "ssm":
        for i, p in enumerate(model.layers):
            x, new = ssm_block(cfg, p, x, {"conv": cache["conv"][i],
                                           "h": cache["h"][i]},
                               h_out=cache["h"][i])
            cache["conv"][i] = new["conv"]
        return x, {"conv": cache["conv"], "h": cache["h"], "pos": pos + 1}
    positions = torch.arange(pos, pos + 1, device=x.device)
    for i, p in enumerate(model.layers):
        x, _ = _serving_block(cfg, p, x, positions,
                              kv_cache=(cache["k"][i], cache["v"][i]),
                              pos=pos)
    return x, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def embed_inputs(cfg, model: LM, inputs: dict) -> torch.Tensor:
    tok = embed_lookup(model.embed.table, inputs["tokens"])
    if cfg.family == "vlm":
        img = inputs["img"].to(tok.dtype)           # (B, P, D) stub
        tok = torch.cat([img, tok], dim=1)
    return tok


def final_hidden(cfg, model: LM, x):
    return norm(cfg, x, model.final_norm.scale)


def _logits(model: LM, x):
    head = model.lm_head.w if model.lm_head is not None else None
    return lm_logits(x, model.embed.table, head)


# --------------------------------------------------------------------------- #
# Serving entry points
# --------------------------------------------------------------------------- #
@torch.no_grad()
def forward_prefill(cfg, model: LM, inputs: dict,
                    cache_len: int | None = None):
    """→ (last-token logits fp32 (B, 1, V), cache)."""
    _check_family(cfg)
    x = embed_inputs(cfg, model, inputs)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    x, cache = trunk_prefill(cfg, model, x, positions, cache_len or S)
    x = final_hidden(cfg, model, x[:, -1:])
    return _logits(model, x), cache


@torch.no_grad()
def forward_decode(cfg, model: LM, token: torch.Tensor, cache: dict):
    """token: (B, 1) int → (logits fp32 (B, 1, V), cache).  Writes the
    step's k/v into ``cache``'s tensors in place."""
    _check_family(cfg)
    x = embed_lookup(model.embed.table, token)
    x, cache = trunk_decode(cfg, model, x, cache)
    x = final_hidden(cfg, model, x)
    return _logits(model, x), cache
