"""Python side of the CUDA RMSNorm kernels (``csrc/lm_kernels.cu``,
``rmsnorm_vec_kernel`` and the scalar ``rmsnorm_kernel``).

They replace the reference's Pallas ``fused_rmsnorm``
(``src/repro/kernels/fused_rmsnorm.py``).  The wrapper takes CUDA
tensors only (it raises for any other device before anything is built),
checks shapes and dtypes, allocates the output with ``torch.empty`` and
launches on the current stream without synchronising.  Rows of whole
16-byte vectors on 16-byte aligned pointers take the vector kernel, any
other last dimension the scalar one; ``ops`` routes CPU tensors to
``ref.fused_rmsnorm_ref`` instead.
"""
from __future__ import annotations

import torch

from ._build import DTYPE_CODES, LM_KERNELS, P, require_cuda


def fused_rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
                  eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d) fp32 or bf16; scale: (d,) fp32 or bf16 → like x."""
    require_cuda("fused_rmsnorm", x, scale)
    if x.dim() < 1 or scale.shape != (x.shape[-1],):
        raise ValueError(f"fused_rmsnorm: x {tuple(x.shape)} and scale "
                         f"{tuple(scale.shape)} do not match")
    if x.dtype not in DTYPE_CODES or scale.dtype not in DTYPE_CODES:
        raise TypeError(f"fused_rmsnorm: expected dtypes of "
                        f"{list(DTYPE_CODES)}, got {x.dtype}/{scale.dtype}")
    d = x.shape[-1]
    x, scale = x.contiguous(), scale.contiguous()
    out = torch.empty_like(x)
    LM_KERNELS.launch("lm_rmsnorm", x.device, P(x.data_ptr()),
                      P(scale.data_ptr()), P(out.data_ptr()),
                      x.numel() // d if d else 0, d, float(eps),
                      DTYPE_CODES[x.dtype], DTYPE_CODES[scale.dtype])
    return out
