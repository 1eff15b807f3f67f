"""Architecture configuration — one dataclass covers all assigned families.

Families: dense | moe | ssm | hybrid | encdec | vlm.  The per-arch files in
``repro.configs`` instantiate these with the published values.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int | None = None         # default d_model // n_heads
    qk_norm: bool = False               # qwen3
    gated_mlp: bool = True              # SwiGLU (False → GELU 2-matmul, starcoder2/granite)
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 4096          # router/dispatch group (tokens)
    moe_gshard_group: int = 128         # group for the einsum (gshard) path
    moe_impl: str = "sort"              # "sort" (gathers) | "gshard" (einsums)
    # "ep": experts sharded over 'model' (GSPMD gather-partitioned dispatch)
    # "etp": each expert's FFN sharded over 'model' (used in pipeline mode,
    #        where GSPMD's gather partitioner aborts under manual meshes)
    moe_shard: str = "ep"

    # SSM (mamba1: falcon-mamba; mamba2: zamba2)
    ssm_state: int = 0
    ssm_expand: int = 2                 # d_inner = expand * d_model
    ssm_conv: int = 4
    ssm_dt_rank: int = 0                # mamba1; default d_model/16
    ssm_head_dim: int = 64              # mamba2
    ssm_chunk: int = 256                # chunked-scan chunk length

    # hybrid (zamba2): one shared attention block applied every k layers
    shared_attn_every: int = 0

    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_frames: int = 1500              # stub conv frontend output length

    # vlm (phi-3-vision): stub patch embeddings prepended to the sequence
    n_patches: int = 0

    # numerics / training
    dtype: str = "bfloat16"
    remat: bool = True
    # attention implementation: "xla" (chunked pure-jnp; what dry-runs lower)
    # or "pallas" (TPU kernels; validated in interpret mode in tests)
    attn_impl: str = "xla"
    attn_chunk: int = 2048              # kv-chunk for the xla chunked attention
    # §Perf iteration 1/2 (EXPERIMENTS.md): Megatron-style sequence-parallel
    # residual stream + seq-chunked cross-entropy
    seq_parallel: bool = True
    ce_chunk: int = 1024                # tokens per CE chunk (0 = full)

    # ------------------------------------------------------------------ #
    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or max(self.d_model // 16, 1)

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def n_attn_apps(self) -> int:
        """Hybrid: number of shared-attention applications."""
        if self.shared_attn_every <= 0:
            return 0
        return -(-self.n_layers // self.shared_attn_every)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic (SSM/hybrid) archs run long_500k; pure
        full-attention archs skip it (see DESIGN.md §Arch-applicability)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------ #
    def param_count(self) -> int:
        """Analytic parameter count (exact for our implementation)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        H, KV, hd = self.n_heads, self.n_kv_heads, self.hd

        def attn() -> int:
            qn = 2 * hd if self.qk_norm else 0
            return D * H * hd + 2 * D * KV * hd + H * hd * D + qn

        def mlp_dense(f: int) -> int:
            return (3 if self.gated_mlp else 2) * D * f

        def mamba1() -> int:
            di, N, R = self.d_inner, self.ssm_state, self.dt_rank
            return (D * 2 * di + di * self.ssm_conv + di
                    + di * (R + 2 * N) + R * di + di  # x_proj, dt_proj(+bias)
                    + di * N + di                     # A_log, D
                    + di * D)                         # out_proj
        def mamba2() -> int:
            di, N, Hs = self.d_inner, self.ssm_state, self.ssm_heads
            ng = 1  # single B/C group
            d_xbc = di + 2 * ng * N
            return (D * (2 * di + 2 * ng * N + Hs)    # in_proj → z,x,B,C,dt
                    + d_xbc * self.ssm_conv + d_xbc   # conv
                    + Hs + Hs + Hs                    # A_log, D, dt_bias
                    + di + di * D)                    # gated rmsnorm, out_proj

        emb = V * D
        head = 0 if self.tie_embeddings else D * V
        norms2 = 2 * D   # per layer: 2 pre-norms (attn+mlp families)

        if self.family in ("dense", "vlm"):
            per = attn() + mlp_dense(F) + norms2
            return emb + head + self.n_layers * per + D
        if self.family == "moe":
            per = attn() + self.n_experts * 3 * D * F + D * self.n_experts + norms2
            return emb + head + self.n_layers * per + D
        if self.family == "ssm":
            per = mamba1() + D  # single pre-norm
            return emb + head + self.n_layers * per + D
        if self.family == "hybrid":
            per = mamba2() + D
            shared = attn() + mlp_dense(F) + norms2
            return emb + head + self.n_layers * per + shared + D
        if self.family == "encdec":
            enc_per = attn() + mlp_dense(F) + norms2
            dec_per = 2 * attn() + mlp_dense(F) + 3 * D
            return (emb + head + self.n_enc_layers * enc_per
                    + self.n_layers * dec_per + 2 * D)
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """MoE: params touched per token (for MODEL_FLOPS = 6·N_active·D)."""
        if self.family != "moe":
            return self.param_count()
        D, F = self.d_model, self.d_ff
        per = (self.param_count() - self.n_layers * self.n_experts * 3 * D * F
               ) + self.n_layers * self.top_k * 3 * D * F
        return per
