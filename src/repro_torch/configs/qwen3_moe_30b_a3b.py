"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, GQA kv=4, qk_norm.
[hf:Qwen/Qwen3-30B-A3B]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab=151936, head_dim=128,
    qk_norm=True, n_experts=128, top_k=8, rope_theta=1e6,
)
