"""granite-20b [dense] — MQA (kv=1), GELU MLP (GPT-BigCode-style widths
give the published 20B total). [arXiv:2405.04324]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152, head_dim=128,
    gated_mlp=False, rope_theta=1e4,
)
