"""whisper-small [audio] — enc-dec backbone; conv frontend is a STUB
(input_specs provide precomputed frame embeddings). [arXiv:2212.04356]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, gated_mlp=False, enc_frames=1500,
    tie_embeddings=True,   # whisper ties decoder embedding ↔ output head
)
