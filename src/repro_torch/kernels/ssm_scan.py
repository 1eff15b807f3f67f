"""Python side of the CUDA selective-scan kernel (``csrc/ssm_scan.cu``,
``ssm_scan_kernel``).

It replaces the reference's Pallas ``ssm_scan_chunk``
(``src/repro/kernels/ssm_scan.py``): one chunk of the Mamba-1
recurrence with the state carried in and out.  The wrapper takes CUDA
tensors only (it raises for any other device before anything is built),
checks shapes and dtypes, and launches on the current stream without
synchronising.  ``dt``, ``x``, ``Bc`` and ``Cc`` are read through their
batch and time strides, so chunk views and column slices pass without a
copy; ``y`` and ``h_out`` may be given to write into the caller's
buffers, and ``h_out`` may be ``h0`` itself.  Unlike the Pallas kernel
it takes any ``di``; ``N`` must be one of the compiled instances.
``ops`` routes CPU tensors to ``ref.ssm_scan_chunk_ref`` instead.
"""
from __future__ import annotations

import torch

from ._build import DTYPE_CODES, SSM_SCAN, P, require_cuda

N_INSTANCES = (8, 16)


def _last_dim_dense(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 or t.shape[-1] == 1 else t.contiguous()


def ssm_scan_chunk(dt: torch.Tensor, x: torch.Tensor, Bc: torch.Tensor,
                   Cc: torch.Tensor, A: torch.Tensor, h0: torch.Tensor, *,
                   y: torch.Tensor | None = None,
                   h_out: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """dt (B,L,di) fp32; x (B,L,di), Bc/Cc (B,L,N) of one dtype (fp32 or
    bf16); A (di,N), h0 (B,di,N) fp32 → (y (B,L,di) fp32, h_out
    (B,di,N) fp32)."""
    given = [t for t in (y, h_out) if t is not None]
    require_cuda("ssm_scan_chunk", dt, x, Bc, Cc, A, h0, *given)
    if dt.dim() != 3 or x.shape != dt.shape or Bc.dim() != 3:
        raise ValueError(f"ssm_scan_chunk: bad shapes dt {tuple(dt.shape)} "
                         f"x {tuple(x.shape)} Bc {tuple(Bc.shape)}")
    B, L, di = dt.shape
    N = Bc.shape[2]
    if (Bc.shape != (B, L, N) or Cc.shape != Bc.shape
            or A.shape != (di, N) or h0.shape != (B, di, N)):
        raise ValueError(f"ssm_scan_chunk: shapes do not match: dt "
                         f"{tuple(dt.shape)} Bc {tuple(Bc.shape)} Cc "
                         f"{tuple(Cc.shape)} A {tuple(A.shape)} h0 "
                         f"{tuple(h0.shape)}")
    if N not in N_INSTANCES:
        raise ValueError(f"ssm_scan_chunk: state size N={N} has no compiled "
                         f"instance (the kernel is built for N in "
                         f"{N_INSTANCES})")
    f32 = torch.float32
    if dt.dtype != f32 or A.dtype != f32 or h0.dtype != f32:
        raise TypeError(f"ssm_scan_chunk: dt, A and h0 must be fp32, got "
                        f"{dt.dtype}/{A.dtype}/{h0.dtype}")
    if (x.dtype not in DTYPE_CODES or Bc.dtype != x.dtype
            or Cc.dtype != x.dtype):
        raise TypeError(f"ssm_scan_chunk: x, Bc and Cc must share one dtype "
                        f"of {list(DTYPE_CODES)}, got {x.dtype}/{Bc.dtype}/"
                        f"{Cc.dtype}")
    dt, x, Bc, Cc = (_last_dim_dense(t) for t in (dt, x, Bc, Cc))
    A, h0 = A.contiguous(), h0.contiguous()
    if y is None:
        y = torch.empty((B, L, di), dtype=f32, device=dt.device)
    elif (y.shape != (B, L, di) or y.dtype != f32
          or (y.stride(-1) != 1 and di > 1)):
        raise ValueError(f"ssm_scan_chunk: y must be fp32 {(B, L, di)} with "
                         f"a contiguous last dimension, got {y.dtype} "
                         f"{tuple(y.shape)} strides {y.stride()}")
    if h_out is None:
        h_out = torch.empty_like(h0)
    elif (h_out.shape != h0.shape or h_out.dtype != f32
          or not h_out.is_contiguous()):
        raise ValueError(f"ssm_scan_chunk: h_out must be contiguous fp32 "
                         f"{tuple(h0.shape)}, got {h_out.dtype} "
                         f"{tuple(h_out.shape)}")
    SSM_SCAN.launch(
        "ssm_scan_chunk", dt.device, *(P(t.data_ptr()) for t in
                                       (dt, x, Bc, Cc, A, h0, y, h_out)),
        B, L, di, N, dt.stride(0), dt.stride(1), x.stride(0), x.stride(1),
        Bc.stride(0), Bc.stride(1), Cc.stride(0), Cc.stride(1),
        y.stride(0), y.stride(1), DTYPE_CODES[x.dtype])
    return y, h_out
