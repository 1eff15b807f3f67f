"""Python side of the CUDA prefill-attention kernels (``csrc/lm_kernels.cu``:
``flash_attention_tc_kernel`` for bf16, ``flash_attention_kernel`` for
fp32).

They replace the reference's Pallas ``flash_attention``
(``src/repro/kernels/flash_attention.py``).  The wrapper takes CUDA
tensors only (it raises for any other device before anything is built),
checks shapes and dtypes, allocates the output with ``torch.empty`` and
launches on the current stream without synchronising.  It dispatches by
dtype: bf16 goes to the tensor-core kernel (wgmma), which needs
``hd % 8 == 0`` (16-byte rows); fp32 goes to the FMA kernel, because the
tensor cores take fp32 only as TF32, and takes any ``hd <= 128``.
Unlike the Pallas kernel it takes any ``S`` and ``T``, and decides the
causal skip from token positions.  ``ops`` routes CPU tensors to
``ref.flash_attention_ref`` instead.
"""
from __future__ import annotations

import math

import torch

from ._build import LM_KERNELS, P, aligned16, require_cuda

MAX_HEAD_DIM = 128
ENTRY = {torch.bfloat16: "lm_flash_attention_bf16",
         torch.float32: "lm_flash_attention_f32"}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,hd); k, v: (B,T,KV,hd), one float dtype (fp32 or bf16)
    → (B,S,H,hd).  Causal attention aligns the last query with the last
    key, so it needs T >= S."""
    require_cuda("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {hd} > {MAX_HEAD_DIM}")
    if causal and T < S:
        raise ValueError(f"flash_attention: causal needs T >= S, got "
                         f"S={S}, T={T}")
    if q.dtype not in ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: expected one dtype of "
                        f"{list(ENTRY)}, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dtype == torch.bfloat16 and hd % 8:
        raise ValueError(f"flash_attention: the bf16 kernel copies 16-byte "
                         f"rows and needs head_dim % 8 == 0, got {hd}")
    q, k, v = aligned16(q), aligned16(k), aligned16(v)
    out = torch.empty_like(q)
    LM_KERNELS.launch(ENTRY[q.dtype], q.device, P(q.data_ptr()),
                      P(k.data_ptr()), P(v.data_ptr()), P(out.data_ptr()),
                      B, S, T, H, KV, hd, int(causal), 1.0 / math.sqrt(hd))
    return out
