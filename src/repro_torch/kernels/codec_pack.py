"""Python side of the CUDA wire-codec kernels (``csrc/codec_pack.cu``).

The five kernels replace the reference's Pallas pack/unpack kernels
(``src/repro/kernels/codec_pack.py``).  ``_build.CODEC_PACK`` compiles
them with ``nvcc`` for ``sm_90a`` at the first call that hands them a
CUDA tensor and binds them through ``ctypes``.  Importing this module
needs neither ``nvcc`` nor a card.

Each wrapper takes CUDA tensors only, checks device, dtype and
contiguity, allocates its outputs with ``torch.empty``, launches on
``torch.cuda.current_stream()`` without synchronising, and raises if the
launch was refused.  ``ops`` routes CPU tensors to ``ref`` instead.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CODEC_PACK, require_cuda

_P = ctypes.c_void_p


def _check(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    require_cuda(what, t)
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _launch(fn: str, t: torch.Tensor, *args) -> None:
    CODEC_PACK.launch(fn, t.device, *args)


def _flat32(x: torch.Tensor, what: str) -> torch.Tensor:
    require_cuda(what, x)
    if not x.is_floating_point():
        raise TypeError(f"{what}: expected a float tensor, got {x.dtype}")
    return x.reshape(-1).to(torch.float32).contiguous()


def _pack(fn: str, x: torch.Tensor, qdtype: torch.dtype
          ) -> tuple[torch.Tensor, torch.Tensor]:
    flat = _flat32(x, fn)
    q = torch.empty(flat.numel(), dtype=qdtype, device=flat.device)
    aux = torch.empty(2, dtype=torch.float32, device=flat.device)
    _launch(fn, flat, _P(flat.data_ptr()), flat.numel(), _P(q.data_ptr()),
            _P(aux.data_ptr()))
    return q, aux[1]


def int8_pack(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA float tensor (n >= 1) → (int8 flat[n], fp32 scale)."""
    return _pack("codec_int8_pack", x, torch.int8)


def fp8_pack(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA float tensor (n >= 1) → (float8_e4m3fn flat[n], fp32 scale)."""
    return _pack("codec_fp8_pack", x, torch.float8_e4m3fn)


def _unpack(fn: str, q: torch.Tensor, qdtype: torch.dtype,
            scale: float) -> torch.Tensor:
    _check(q, qdtype, fn)
    out = torch.empty(q.numel(), dtype=torch.float32, device=q.device)
    _launch(fn, q, _P(q.data_ptr()), float(scale), _P(out.data_ptr()),
            q.numel())
    return out


def int8_unpack(q: torch.Tensor, scale: float) -> torch.Tensor:
    """(CUDA int8 flat[n], scale) → fp32 flat[n] = q * scale."""
    return _unpack("codec_int8_unpack", q, torch.int8, scale)


def fp8_unpack(q: torch.Tensor, scale: float) -> torch.Tensor:
    """(CUDA float8_e4m3fn flat[n], scale) → fp32 flat[n] = q * scale."""
    return _unpack("codec_fp8_unpack", q, torch.float8_e4m3fn, scale)


def topk_keys(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel half of ``topk_select``: → (fp32 flat[n], int64
    keys[n]), key = bits(|x|) << 32 | (0xFFFFFFFF - i)."""
    flat = _flat32(x, "codec_topk_keys")
    if flat.numel() >= 2 ** 31:
        raise ValueError("topk_select: the wire's uint32 indices need "
                         "fewer than 2**31 elements")
    keys = torch.empty(flat.numel(), dtype=torch.int64, device=flat.device)
    _launch("codec_topk_keys", flat, _P(flat.data_ptr()), flat.numel(),
            _P(keys.data_ptr()))
    return flat, keys


def topk_select(x: torch.Tensor, *, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """k largest-|x| entries, ties to the lower index → (int32 indices
    ascending — the wire's uint32 bits, fp32 values).  The key pass is
    the kernel; the selection is ``torch.topk`` over the unique keys and
    an index sort, where the reference ran ``lax.top_k`` outside Pallas."""
    flat, keys = topk_keys(x)
    top = torch.topk(keys, k, sorted=False).values
    idx = torch.sort(0xFFFFFFFF - (top & 0xFFFFFFFF)).values
    return idx.to(torch.int32), flat[idx]
