"""Public wrappers for the port's kernels: the wire codecs, the LM
serving path's attention and RMSNorm, and the Mamba-1 selective scan.

A tensor on the CPU goes to its plain version in ``ref`` (the CPU tests
run that path, as the reference's tests run Pallas in interpret mode).
Any other tensor goes to the CUDA kernel in ``codec_pack``,
``flash_attention``, ``decode_attention``, ``fused_rmsnorm`` or
``ssm_scan``, which launches or raises: there is no fallback.  Each
wrapper counts its kernel launches in a plain integer attribute,
``<wrapper>.launches``, so a run can show that its main path went
through the kernels.

The LM wrappers (attention, RMSNorm, the two scans) take plain tensors
and raise for a DTensor: under a mesh the model calls them on each
rank's local shards (``sharding.api.on_shards``), and a layout they
cannot take is an error, never a quiet detour through the plain route.
They also raise when autograd
would record them: their kernels have no backward (nor have the
reference's Pallas kernels), and a ``ctypes`` launch returns a tensor
without a ``grad_fn``, which would cut the graph and leave every weight
upstream without its gradient.  The guard fires on the CPU path too, so
the CPU tests see what the card would do.  Training runs the plain
route (``attn_impl="xla"``), as the reference's always does.
"""
from __future__ import annotations

import threading

import torch
from torch.distributed.tensor import DTensor

from . import codec_pack, ref
from . import decode_attention as _decode
from . import flash_attention as _flash
from . import fused_rmsnorm as _rms
from . import ssm_scan as _ssm

_count_lock = threading.Lock()


def _counted(fn):
    fn.launches = 0
    return fn


def _launched(fn) -> None:
    with _count_lock:
        fn.launches += 1


def _no_autograd(fn, *tensors) -> None:
    """Raise if any of ``tensors`` is a DTensor, or if autograd is on and
    any requires grad."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(
            f"ops.{fn.__name__} takes each rank's local tensors: under a "
            "mesh call it through sharding.api.on_shards")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            f"ops.{fn.__name__} has no backward: its kernel would cut the "
            "autograd graph.  Train through the plain route "
            "(cfg.attn_impl='xla'), or call it under torch.no_grad()")


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


@_counted
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,T,KV,hd) → (B,S,H,hd); GQA, online softmax."""
    _no_autograd(flash_attention, q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    out = _flash.flash_attention(q, k, v, causal=causal)
    _launched(flash_attention)
    return out


@_counted
def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *,
                     with_lse: bool = False):
    """q (B,H,hd), caches (B,Smax,KV,hd), int pos → (B,H,hd) over the
    cache positions ``<= pos``; with ``with_lse`` also the fp32 (B,H)
    log-sum-exp of those positions' scaled scores, by which outputs over
    disjoint ranges of positions merge (a cache split along its
    sequence)."""
    _no_autograd(decode_attention, q, k_cache, v_cache)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, pos,
                                        with_lse=with_lse)
    out = _decode.decode_attention(q, k_cache, v_cache, pos,
                                   with_lse=with_lse)
    _launched(decode_attention)
    return out


@_counted
def fused_rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
                  eps: float = 1e-6) -> torch.Tensor:
    """x (..., d), scale (d,) → ``x * rsqrt(mean(x²) + eps) * scale``."""
    _no_autograd(fused_rmsnorm, x, scale)
    if x.device.type == "cpu":
        return ref.fused_rmsnorm_ref(x, scale, eps=eps)
    out = _rms.fused_rmsnorm(x, scale, eps=eps)
    _launched(fused_rmsnorm)
    return out


@_counted
def ssm_scan_chunk(dt: torch.Tensor, x: torch.Tensor, Bc: torch.Tensor,
                   Cc: torch.Tensor, A: torch.Tensor, h0: torch.Tensor, *,
                   y: torch.Tensor | None = None,
                   h_out: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the Mamba-1 recurrence: dt, x (B,L,di); Bc, Cc
    (B,L,N); A (di,N); h0 (B,di,N) → (y (B,L,di) fp32, h (B,di,N) fp32).
    ``y``/``h_out``, when given, receive the results (``h_out`` may be
    ``h0``)."""
    _no_autograd(ssm_scan_chunk, dt, x, Bc, Cc, A, h0)
    if dt.device.type == "cpu":
        out = ref.ssm_scan_chunk_ref(dt, x, Bc, Cc, A, h0)
        return tuple(res if dst is None else dst.copy_(res)
                     for res, dst in zip(out, (y, h_out)))
    out = _ssm.ssm_scan_chunk(dt, x, Bc, Cc, A, h0, y=y, h_out=h_out)
    _launched(ssm_scan_chunk)
    return out


@_counted
def mamba1_scan_chunk(dt: torch.Tensor, dt_bias: torch.Tensor,
                      x: torch.Tensor, z: torch.Tensor, Bc: torch.Tensor,
                      Cc: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                      h0: torch.Tensor, *, y: torch.Tensor | None = None,
                      h_out: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the Mamba-1 block's scan with its prologue and
    epilogue: raw dt, x, the gate z (B,L,di) and dt_bias (di) in the
    working dtype; Bc, Cc (B,L,N); A (di,N), D (di), h0 (B,di,N) fp32 →
    (y (B,L,di) in x's dtype, h (B,di,N) fp32), with dt =
    softplus(dt + dt_bias) and y = (scan + x·D)·silu(z).  ``y``/``h_out``,
    when given, receive the results (``h_out`` may be ``h0``)."""
    _no_autograd(mamba1_scan_chunk, dt, dt_bias, x, z, Bc, Cc, A, D, h0)
    if dt.device.type == "cpu":
        out = ref.mamba1_scan_chunk_ref(dt, dt_bias, x, z, Bc, Cc, A, D, h0)
        return tuple(res if dst is None else dst.copy_(res)
                     for res, dst in zip(out, (y, h_out)))
    out = _ssm.mamba1_scan_chunk(dt, dt_bias, x, z, Bc, Cc, A, D, h0, y=y,
                                 h_out=h_out)
    _launched(mamba1_scan_chunk)
    return out


WRAPPERS = (int8_pack, int8_unpack, fp8_pack, fp8_unpack, topk_select,
            flash_attention, decode_attention, fused_rmsnorm, ssm_scan_chunk,
            mamba1_scan_chunk)


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def reset_launch_counts() -> None:
    with _count_lock:
        for fn in WRAPPERS:
            fn.launches = 0


def drain_launch_counts() -> dict[str, int]:
    """The counts since the last reset or drain, then zero them, in one
    step (a pipeline stage's process reports them on each STATS flush)."""
    with _count_lock:
        counts = {fn.__name__: fn.launches for fn in WRAPPERS}
        for fn in WRAPPERS:
            fn.launches = 0
    return counts
