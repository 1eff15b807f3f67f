"""Public wrappers for the wire-codec kernels.

A tensor on the CPU goes to its plain version in ``ref`` (the CPU tests
run that path, as the reference's tests run Pallas in interpret mode).
Any other tensor goes to the CUDA kernel in ``codec_pack``, which
launches or raises: there is no fallback.  Each wrapper counts its
kernel launches in a plain integer attribute, ``<wrapper>.launches``,
so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import threading

import torch

from . import codec_pack, ref

_count_lock = threading.Lock()


def _counted(fn):
    fn.launches = 0
    return fn


def _launched(fn) -> None:
    with _count_lock:
        fn.launches += 1


@_counted
def int8_pack(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: any shape/float dtype → (int8 flat[n], fp32 scale)."""
    if x.device.type == "cpu":
        return ref.int8_pack_ref(x)
    out = codec_pack.int8_pack(x)
    _launched(int8_pack)
    return out


@_counted
def int8_unpack(q: torch.Tensor, scale) -> torch.Tensor:
    """(int8 flat[n], scale) → fp32 flat[n]."""
    if q.device.type == "cpu":
        return ref.int8_unpack_ref(q, scale)
    out = codec_pack.int8_unpack(q, scale)
    _launched(int8_unpack)
    return out


@_counted
def fp8_pack(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: any shape/float dtype → (float8_e4m3fn flat[n], fp32 scale)."""
    if x.device.type == "cpu":
        return ref.fp8_pack_ref(x)
    out = codec_pack.fp8_pack(x)
    _launched(fp8_pack)
    return out


@_counted
def fp8_unpack(q: torch.Tensor, scale) -> torch.Tensor:
    """(float8_e4m3fn flat[n], scale) → fp32 flat[n]."""
    if q.device.type == "cpu":
        return ref.fp8_unpack_ref(q, scale)
    out = codec_pack.fp8_unpack(q, scale)
    _launched(fp8_unpack)
    return out


@_counted
def topk_select(x: torch.Tensor, *, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """k largest-|x| entries → (int32 indices ascending, fp32 values)."""
    if x.device.type == "cpu":
        return ref.topk_select_ref(x, k=k)
    out = codec_pack.topk_select(x, k=k)
    _launched(topk_select)
    return out


WRAPPERS = (int8_pack, int8_unpack, fp8_pack, fp8_unpack, topk_select)


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def reset_launch_counts() -> None:
    with _count_lock:
        for fn in WRAPPERS:
            fn.launches = 0
