"""zamba2-7b [hybrid] — Mamba-2 backbone + one shared attention+MLP block
applied every 6 layers (weights shared across applications; the
published per-application LoRA deltas are omitted — DESIGN.md §4).
[arXiv:2411.15242]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, head_dim=112,
    ssm_state=64, ssm_expand=2, ssm_conv=4, ssm_head_dim=64,
    shared_attn_every=6, gated_mlp=True,
)
