"""Python side of the CUDA decode-attention kernel
(``csrc/lm_kernels.cu``, ``decode_attention_kernel``).

It replaces the reference's Pallas ``decode_attention``
(``src/repro/kernels/decode_attention.py``).  The wrapper takes CUDA
tensors only (it raises for any other device before anything is built),
checks shapes and dtypes, allocates the output with ``torch.empty`` and
launches on the current stream without synchronising.  ``pos`` is a
Python int: the kernel reads cache rows ``0..pos`` and no further, so
no step waits on the device to learn it.  Unlike the Pallas kernel it
takes any ``Smax``.  ``ops`` routes CPU tensors to
``ref.decode_attention_ref`` instead.
"""
from __future__ import annotations

import math

import torch

from ._build import DTYPE_CODES, LM_KERNELS, P, require_cuda

MAX_HEAD_DIM = 128


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """q: (B,H,hd); caches: (B,Smax,KV,hd), one float dtype (fp32 or
    bf16); ``0 <= pos < Smax`` → (B,H,hd)."""
    require_cuda("decode_attention", q, k_cache, v_cache)
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: bad shapes q {tuple(q.shape)} "
                         f"caches {tuple(k_cache.shape)}/"
                         f"{tuple(v_cache.shape)}")
    B, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape[0] != B or k_cache.shape[3] != hd or KV == 0
            or H % KV):
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"match the caches {tuple(k_cache.shape)}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head_dim {hd} > "
                         f"{MAX_HEAD_DIM}")
    pos = int(pos)
    if not 0 <= pos < Smax:
        raise ValueError(f"decode_attention: pos {pos} outside the cache "
                         f"(Smax={Smax})")
    if (q.dtype not in DTYPE_CODES or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype):
        raise TypeError(f"decode_attention: expected one dtype of "
                        f"{list(DTYPE_CODES)}, got {q.dtype}/"
                        f"{k_cache.dtype}/{v_cache.dtype}")
    q = q.contiguous()
    k_cache, v_cache = k_cache.contiguous(), v_cache.contiguous()
    out = torch.empty_like(q)
    LM_KERNELS.launch("lm_decode_attention", q.device, P(q.data_ptr()),
                      P(k_cache.data_ptr()), P(v_cache.data_ptr()),
                      P(out.data_ptr()), B, H, KV, Smax, hd, pos,
                      1.0 / math.sqrt(hd), DTYPE_CODES[q.dtype])
    return out
