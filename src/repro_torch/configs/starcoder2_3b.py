"""starcoder2-3b [dense] — GQA kv=2, RoPE, GELU MLP. [arXiv:2402.19173]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
    d_ff=12288, vocab=49152, head_dim=128,
    gated_mlp=False, rope_theta=1e5,
)
