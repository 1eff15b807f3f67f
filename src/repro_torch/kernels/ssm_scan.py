"""Python side of the CUDA selective-scan kernel (``csrc/ssm_scan.cu``,
``ssm_scan_kernel<N, T, Gated>``), two entry points of one kernel.

``ssm_scan_chunk`` replaces the reference's Pallas ``ssm_scan_chunk``
(``src/repro/kernels/ssm_scan.py``): one chunk of the Mamba-1
recurrence with the state carried in and out, ``dt`` already
softplus'ed and ``y`` in fp32.  ``mamba1_scan_chunk`` is the same chunk
with what the Mamba-1 block does around it folded in: it takes the raw
``dt`` and ``dt_bias`` and applies the softplus itself, and adds the
D-skip and the SiLU gate ``z`` before it writes ``y`` in the working
dtype.

The wrappers take CUDA tensors only (they raise for any other device
before anything is built), check shapes and dtypes, and launch on the
current stream without synchronising.  The ``(B, L, .)`` operands are
read through their batch and time strides, so chunk views, ``z`` as a
view of the in_proj output and column slices pass without a copy; ``y``
and ``h_out`` may be given to write into the caller's buffers, and
``h_out`` may be ``h0`` itself.  Unlike the Pallas kernel they take any
``di``; ``N`` must be one of the compiled instances.  ``ops`` routes
CPU tensors to ``ref`` instead.
"""
from __future__ import annotations

import torch

from ._build import DTYPE_CODES, SSM_SCAN, P, aligned16, require_cuda

N_INSTANCES = (8, 16)


def _last_dim_dense(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 or t.shape[-1] == 1 else t.contiguous()


def _check(what: str, dt, x, Bc, Cc, A, h0) -> tuple[int, int, int, int]:
    """The shapes both entry points share, and their N → (B, L, di, N)."""
    if dt.dim() != 3 or x.shape != dt.shape or Bc.dim() != 3:
        raise ValueError(f"{what}: bad shapes dt {tuple(dt.shape)} "
                         f"x {tuple(x.shape)} Bc {tuple(Bc.shape)}")
    B, L, di = dt.shape
    N = Bc.shape[2]
    if (Bc.shape != (B, L, N) or Cc.shape != Bc.shape
            or A.shape != (di, N) or h0.shape != (B, di, N)):
        raise ValueError(f"{what}: shapes do not match: dt "
                         f"{tuple(dt.shape)} Bc {tuple(Bc.shape)} Cc "
                         f"{tuple(Cc.shape)} A {tuple(A.shape)} h0 "
                         f"{tuple(h0.shape)}")
    if N not in N_INSTANCES:
        raise ValueError(f"{what}: state size N={N} has no compiled "
                         f"instance (the kernel is built for N in "
                         f"{N_INSTANCES})")
    if (x.dtype not in DTYPE_CODES or Bc.dtype != x.dtype
            or Cc.dtype != x.dtype):
        raise TypeError(f"{what}: x, Bc and Cc must share one dtype of "
                        f"{list(DTYPE_CODES)}, got {x.dtype}/{Bc.dtype}/"
                        f"{Cc.dtype}")
    return B, L, di, N


def _outputs(what: str, y, h_out, h0, shape, dtype):
    """``y`` and ``h_out`` as given (checked) or new: y ``shape`` in
    ``dtype`` with a contiguous last dimension, h_out contiguous fp32
    like ``h0`` and on 16 bytes, as the kernel's float4 stores need."""
    if y is None:
        y = torch.empty(shape, dtype=dtype, device=h0.device)
    elif (y.shape != shape or y.dtype != dtype
          or (y.stride(-1) != 1 and shape[-1] > 1)):
        raise ValueError(f"{what}: y must be {dtype} {shape} with a "
                         f"contiguous last dimension, got {y.dtype} "
                         f"{tuple(y.shape)} strides {y.stride()}")
    if h_out is None:
        h_out = torch.empty_like(h0)
    elif (h_out.shape != h0.shape or h_out.dtype != torch.float32
          or not h_out.is_contiguous() or h_out.data_ptr() % 16):
        raise ValueError(f"{what}: h_out must be contiguous fp32 "
                         f"{tuple(h0.shape)} starting on 16 bytes, got "
                         f"{h_out.dtype} {tuple(h_out.shape)}")
    return y, h_out


def _strides(*ts: torch.Tensor) -> list[int]:
    return [s for t in ts for s in (t.stride(0), t.stride(1))]


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
    B, L, di, N = _check("ssm_scan_chunk", dt, x, Bc, Cc, A, h0)
    f32 = torch.float32
    if dt.dtype != f32 or A.dtype != f32 or h0.dtype != f32:
        raise TypeError(f"ssm_scan_chunk: dt, A and h0 must be fp32, got "
                        f"{dt.dtype}/{A.dtype}/{h0.dtype}")
    dt, x, Bc, Cc = (_last_dim_dense(t) for t in (dt, x, Bc, Cc))
    A, h0 = aligned16(A), aligned16(h0)
    y, h_out = _outputs("ssm_scan_chunk", y, h_out, h0, (B, L, di),
                        torch.float32)
    SSM_SCAN.launch(
        "ssm_scan_chunk", dt.device, *(P(t.data_ptr()) for t in
                                       (dt, x, Bc, Cc, A, h0, y, h_out)),
        B, L, di, N, *_strides(dt, x, Bc, Cc, y), DTYPE_CODES[x.dtype])
    return y, h_out


def mamba1_scan_chunk(dt: torch.Tensor, dt_bias: torch.Tensor,
                      x: torch.Tensor, z: torch.Tensor, Bc: torch.Tensor,
                      Cc: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                      h0: torch.Tensor, *, y: torch.Tensor | None = None,
                      h_out: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """dt (raw), x, z (B,L,di), dt_bias (di), Bc/Cc (B,L,N) of one dtype
    T (fp32 or bf16); A (di,N), D (di), h0 (B,di,N) fp32 → (y (B,L,di)
    in T, h_out (B,di,N) fp32)."""
    given = [t for t in (y, h_out) if t is not None]
    require_cuda("mamba1_scan_chunk", dt, dt_bias, x, z, Bc, Cc, A, D, h0,
                 *given)
    B, L, di, N = _check("mamba1_scan_chunk", dt, x, Bc, Cc, A, h0)
    if z.shape != dt.shape or dt_bias.shape != (di,) or D.shape != (di,):
        raise ValueError(f"mamba1_scan_chunk: shapes do not match: dt "
                         f"{tuple(dt.shape)} z {tuple(z.shape)} dt_bias "
                         f"{tuple(dt_bias.shape)} D {tuple(D.shape)}")
    if dt.dtype != x.dtype or z.dtype != x.dtype or dt_bias.dtype != x.dtype:
        raise TypeError(f"mamba1_scan_chunk: dt, dt_bias and z must be x's "
                        f"dtype {x.dtype}, got {dt.dtype}/{dt_bias.dtype}/"
                        f"{z.dtype}")
    f32 = torch.float32
    if A.dtype != f32 or D.dtype != f32 or h0.dtype != f32:
        raise TypeError(f"mamba1_scan_chunk: A, D and h0 must be fp32, got "
                        f"{A.dtype}/{D.dtype}/{h0.dtype}")
    dt, x, z, Bc, Cc = (_last_dim_dense(t) for t in (dt, x, z, Bc, Cc))
    dt_bias, D = dt_bias.contiguous(), D.contiguous()
    A, h0 = aligned16(A), aligned16(h0)
    y, h_out = _outputs("mamba1_scan_chunk", y, h_out, h0, (B, L, di),
                        x.dtype)
    SSM_SCAN.launch(
        "mamba1_scan_chunk", dt.device,
        *(P(t.data_ptr()) for t in (dt, dt_bias, x, z, Bc, Cc, A, D, h0, y,
                                    h_out)),
        B, L, di, N, *_strides(dt, x, z, Bc, Cc, y), DTYPE_CODES[x.dtype])
    return y, h_out
