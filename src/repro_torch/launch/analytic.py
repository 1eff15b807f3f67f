"""Analytic executed-FLOPs / HBM-bytes / wire-bytes model per cell
(counterpart of ``src/repro/launch/analytic.py``, a copy of its
formulas).

The reference derives executed quantities from first principles because
XLA's ``cost_analysis()`` counts a while-loop body once; the formulas
feed its roofline and, through ``models.blocks_adapter``, the pipeline
planner, so the port keeps them exactly (its tests hold every function
equal to the reference's).  ``cell_cost`` takes a shape with ``.batch``,
``.seq`` and ``.kind``: a ``launch.specs.ShapeSpec``.

Conventions:
  * matmul (m,k)x(k,n): 2·m·k·n FLOPs.
  * causal chunked attention computes full (chunk x chunk) diagonal
    blocks → effective context per token = (S + chunk)/2.
  * backward = 2x forward matmul FLOPs; full remat re-runs the trunk
    forward once more (factor 4 on trunk, 3 on embed/logits).
  * HBM model assumes the fused attention/scan path (weights and
    activations stream once per pass); validated intent, not measured.
  * wire model: all-reduce ring = 2·T·(s-1)/s, all-gather/reduce-scatter
    = T·(s-1)/s per device, ppermute = T.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..models.config import ArchConfig


def _ar_wire(nbytes: float, s: int) -> float:
    return 2.0 * nbytes * (s - 1) / s if s > 1 else 0.0


def _ag_wire(nbytes: float, s: int) -> float:
    return nbytes * (s - 1) / s if s > 1 else 0.0


@dataclass(frozen=True)
class CellCost:
    flops_total: float           # executed FLOPs, whole step, all chips
    hbm_bytes_per_dev: float
    wire_ici_per_dev: float
    wire_dcn_per_dev: float
    notes: str = ""


# --------------------------------------------------------------------------- #
# Per-layer forward FLOPs for one token
# --------------------------------------------------------------------------- #
def _attn_proj_flops(cfg) -> float:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return 2.0 * D * (H + 2 * KV) * hd + 2.0 * H * hd * D


def _attn_score_flops(cfg, ctx_len: float) -> float:
    """Per token: scores + AV over an effective context."""
    return 2.0 * 2.0 * cfg.n_heads * cfg.hd * ctx_len


def _mlp_flops(cfg, d_ff=None) -> float:
    f = d_ff or cfg.d_ff
    return 2.0 * cfg.d_model * f * (3 if cfg.gated_mlp else 2)


def _moe_flops(cfg) -> float:
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    router = 2.0 * D * E
    expert = 2.0 * 3 * D * F * cfg.top_k * cfg.capacity_factor
    return router + expert


def _mamba1_flops(cfg) -> float:
    D, di, N, R, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                      cfg.ssm_conv)
    proj = 2.0 * D * 2 * di + 2.0 * di * K + 2.0 * di * (R + 2 * N) \
        + 2.0 * R * di + 2.0 * di * D
    scan = 12.0 * di * N          # assoc-scan elementwise (≈2× sequential)
    return proj + scan


def _mamba2_flops(cfg, chunk: int) -> float:
    D, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    d_in = 2 * di + 2 * N + H
    proj = 2.0 * D * d_in + 2.0 * (di + 2 * N) * cfg.ssm_conv + 2.0 * di * D
    L = chunk
    # per token: CB^T row (2·L·N) + att·dtx (2·L·H·P) + carry in/out
    intra = 2.0 * L * N + 2.0 * L * H * P
    inter = 4.0 * H * P * N
    return proj + intra + inter


def _layer_fwd_flops(cfg, ctx_len: float) -> float:
    fam = cfg.family
    if fam in ("dense", "vlm", "encdec"):
        return (_attn_proj_flops(cfg) + _attn_score_flops(cfg, ctx_len)
                + _mlp_flops(cfg))
    if fam == "moe":
        return (_attn_proj_flops(cfg) + _attn_score_flops(cfg, ctx_len)
                + _moe_flops(cfg))
    if fam == "ssm":
        return _mamba1_flops(cfg)
    if fam == "hybrid":
        return _mamba2_flops(cfg, cfg.ssm_chunk)
    raise ValueError(fam)


def _shared_block_flops(cfg, ctx_len: float) -> float:
    return (_attn_proj_flops(cfg) + _attn_score_flops(cfg, ctx_len)
            + _mlp_flops(cfg))


def trunk_fwd_flops(cfg, tokens: float, ctx_len: float) -> float:
    """Whole trunk, forward, `tokens` total tokens at effective context."""
    per = _layer_fwd_flops(cfg, ctx_len)
    total = cfg.n_layers * per * tokens
    if cfg.family == "hybrid":
        total += cfg.n_attn_apps * _shared_block_flops(cfg, ctx_len) * tokens
    if cfg.family == "encdec":
        # cross attention (full F context) + encoder trunk on frame tokens
        total += cfg.n_layers * tokens * (
            2.0 * cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
            + _attn_score_flops(cfg, cfg.enc_frames))
    return total


def _encoder_flops(cfg, batch: int) -> float:
    if cfg.family != "encdec":
        return 0.0
    ftok = batch * cfg.enc_frames
    per = (_attn_proj_flops(cfg) + _attn_score_flops(cfg, cfg.enc_frames)
           + _mlp_flops(cfg))
    return cfg.n_enc_layers * per * ftok


def _logit_flops(cfg, tokens: float) -> float:
    return 2.0 * cfg.d_model * cfg.vocab * tokens


# --------------------------------------------------------------------------- #
# Cell-level model
# --------------------------------------------------------------------------- #
def cell_cost(cfg: ArchConfig, shape, *, n_chips: int, dp: int, tp: int,
              multi_pod: bool, pcfg=None, microbatches: int = 8,
              grad_accum: int = 2) -> CellCost:
    B, S = shape.batch, shape.seq
    fam = cfg.family
    wbytes_total = cfg.param_count() * 2.0       # bf16 weights

    if shape.kind == "decode":
        T = float(B)                             # one token per sequence
        ctx = float(S)
        fwd = trunk_fwd_flops(cfg, T, ctx) + _logit_flops(cfg, T)
        flops = fwd
        # HBM: weights once + caches read(+write tail)
        cache_bytes = _cache_bytes(cfg, B, S)
        hbm_dev = (wbytes_total / tp + cache_bytes / n_chips * 2.05
                   + 3 * 4 * T * cfg.vocab / n_chips)
        # wire: 2 TP psums per layer of (B/dp,1,D)
        psum = _ar_wire(B / dp * cfg.d_model * 2, tp)
        wire_ici = 2 * cfg.n_layers * psum
        wire_dcn = 0.0
        if multi_pod and pcfg is not None:
            K = pcfg.n_stages
            wire_dcn = K * (B / dp * cfg.d_model * 2 / tp)   # tick ppermutes
        return CellCost(flops, hbm_dev, wire_ici, wire_dcn)

    tokens = float(B) * S
    ctx = (S + cfg.attn_chunk) / 2.0 if S > cfg.attn_chunk else (S + 1) / 2.0
    trunk = trunk_fwd_flops(cfg, tokens, ctx) + _encoder_flops(cfg, B)
    heads = _logit_flops(cfg, tokens)

    if shape.kind == "prefill":
        flops = trunk + heads / S  # only last-position logits
        act_layer = tokens * cfg.d_model * 2.0
        hbm_dev = (wbytes_total / tp
                   + cfg.n_layers * act_layer * 2 / n_chips
                   + _cache_bytes(cfg, B, S) / n_chips)
        psum = _ar_wire(tokens / dp * cfg.d_model * 2, tp)
        wire_ici = 2 * cfg.n_layers * psum
        wire_dcn = 0.0
        if multi_pod and pcfg is not None:
            wire_dcn = pcfg.n_stages * tokens / dp * cfg.d_model * 2 / tp
        return CellCost(flops, hbm_dev, wire_ici, wire_dcn)

    # ---- training ------------------------------------------------------ #
    remat = 1.0 if cfg.remat else 0.0
    waste = 1.0
    bubble = 1.0
    if multi_pod and pcfg is not None:
        K, M = pcfg.n_stages, pcfg.microbatches
        _, _, l_max = pcfg.layout(cfg.n_layers)
        # every pod runs l_max (padded) layers every tick, incl. bubble
        waste = (K * l_max * (M + K - 1)) / (cfg.n_layers * M)
        bubble = (M + K - 1) / M
    flops = trunk * (3.0 + remat) * waste + heads * 3.0 \
        + cfg.param_count() * 12.0               # optimizer
    # HBM/device: weights ×(3+remat) passes + optimizer 22B/param +
    # saved layer inputs (write+read) + logits fp32 ×3.
    # seq_parallel shards saved residuals over 'model' (already counted by
    # /n_chips); without it they'd replicate over model (×tp).
    ga = max(grad_accum, 1) if not multi_pod else 1
    params_dev = cfg.param_count() / tp
    sp = 1.0 if cfg.seq_parallel else float(tp)
    act_saved = cfg.n_layers * tokens * cfg.d_model * 2.0 * 2 / n_chips * sp
    # chunked CE re-streams the head weights once per chunk but bounds the
    # fp32 logits residency; traffic ≈ logits once + head reads
    logits_b = 3.0 * 4.0 * tokens * cfg.vocab / n_chips
    # grad_accum re-streams weights per microbatch and adds an fp32 grad
    # accumulator read/write per microbatch
    hbm_dev = (params_dev * 2 * (3 + remat) * ga + params_dev * 22
               + params_dev * 8 * (ga - 1)
               + act_saved + logits_b)
    # wire: TP psums (≈6/layer incl bwd ×(1+remat/2)) + DP grad all-reduce
    psum = _ar_wire(tokens / dp * cfg.d_model * 2, tp)
    wire_ici = 6 * cfg.n_layers * psum * (1 + 0.5 * remat) \
        + _ar_wire(cfg.param_count() * 2 / tp, dp)
    if fam == "moe":
        # dispatch+combine a2a ×3 passes of the capacity buffer
        buf = tokens * cfg.top_k * cfg.capacity_factor * cfg.d_model * 2
        wire_ici += 3 * _ag_wire(buf / dp, tp) * 2
    wire_dcn = 0.0
    if multi_pod and pcfg is not None:
        K, M = pcfg.n_stages, pcfg.microbatches
        ticks = M + K - 1
        mb_bytes = tokens / M / dp * cfg.d_model * 2 / max(tp // tp, 1)
        wire_dcn = 3.0 * ticks * mb_bytes       # fwd + bwd(2×) ppermutes
    return CellCost(flops, hbm_dev, wire_ici, wire_dcn)


def _cache_bytes(cfg, B, S) -> float:
    if cfg.family in ("dense", "vlm", "moe"):
        return 2.0 * cfg.n_layers * B * S * cfg.n_kv_heads * cfg.hd * 2
    if cfg.family == "encdec":
        return 2.0 * cfg.n_layers * B * (S + cfg.enc_frames) \
            * cfg.n_kv_heads * cfg.hd * 2
    if cfg.family == "ssm":
        return cfg.n_layers * B * (cfg.d_inner * cfg.ssm_state * 4
                                   + (cfg.ssm_conv - 1) * cfg.d_inner * 2)
    if cfg.family == "hybrid":
        ssm = cfg.n_layers * B * (cfg.ssm_heads * cfg.ssm_head_dim
                                  * cfg.ssm_state * 4
                                  + (cfg.ssm_conv - 1)
                                  * (cfg.d_inner + 2 * cfg.ssm_state) * 2)
        attn = 2.0 * cfg.n_attn_apps * B * S * cfg.n_kv_heads * cfg.hd * 2
        return ssm + attn
    raise ValueError(cfg.family)
