"""Python side of the CUDA wire-codec kernels (``csrc/codec_pack.cu``).

The kernels replace the reference's Pallas pack/unpack kernels and its
top-k selection (``src/repro/kernels/codec_pack.py``).
``_build.CODEC_PACK`` compiles them with ``nvcc`` for ``sm_90a`` at the
first call that hands them a CUDA tensor and binds them through
``ctypes``.  Importing this module needs neither ``nvcc`` nor a card.

Each wrapper takes CUDA tensors only, checks device, dtype and
contiguity, allocates its outputs and scratch with ``torch.empty``,
launches on ``torch.cuda.current_stream()`` without synchronising, and
raises if the launch was refused.  ``int8_pack``, ``fp8_pack`` and
``topk_select`` are one cooperative launch each, whose grid the card
must keep resident: a refusal raises, there is no other route.  ``ops`` routes CPU tensors to
``ref`` instead.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CODEC_PACK, require_cuda

_P = ctypes.c_void_p
# csrc/codec_pack.cu: the largest cooperative grid the kernels pick
# themselves (kMaxCoopBlocks), and topk's global histograms (kHistWords)
COOP_MAX_BLOCKS = 1024
TOPK_HIST_WORDS = 2048 + 2048 + 512


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


def _pack(fn: str, x: torch.Tensor, qdtype: torch.dtype,
          blocks: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    flat = _flat32(x, fn)
    q = torch.empty(flat.numel(), dtype=qdtype, device=flat.device)
    # [max|x|, scale, one partial abs-max a CTA]
    aux = torch.empty(2 + max(blocks or 0, COOP_MAX_BLOCKS),
                      dtype=torch.float32, device=flat.device)
    _launch(fn, flat, _P(flat.data_ptr()), flat.numel(), _P(q.data_ptr()),
            _P(aux.data_ptr()), aux.numel(), blocks or 0)
    return q, aux[1]


def int8_pack(x: torch.Tensor, *, blocks: int | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA float tensor → (int8 flat[n], fp32 scale), in one
    cooperative launch.  ``blocks`` forces the grid (tests only: a grid
    of a few CTAs keeps its share in shared memory or reads it again)."""
    return _pack("codec_int8_pack", x, torch.int8, blocks)


def fp8_pack(x: torch.Tensor, *, blocks: int | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA float tensor → (float8_e4m3fn flat[n], fp32 scale), in one
    cooperative launch.  ``blocks`` forces the grid, as for int8."""
    return _pack("codec_fp8_pack", x, torch.float8_e4m3fn, blocks)


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


def topk_scratch_words(blocks: int | None = None) -> int:
    """32-bit words of scratch ``topk_select`` needs for a grid of at
    most ``max(blocks, COOP_MAX_BLOCKS)`` CTAs."""
    return TOPK_HIST_WORDS + 2 * max(blocks or 0, COOP_MAX_BLOCKS)


def topk_select(x: torch.Tensor, *, k: int, blocks: int | None = None,
                scratch: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """k largest keys ``bits(x) & 0x7FFFFFFF`` (``|x|``, NaNs above inf),
    ties to the lower index → (int32 indices ascending — the wire's
    uint32 bits, fp32 values), in one cooperative launch: a radix select
    of the threshold and an ordered compaction, no sort.  ``blocks``
    forces the grid and ``scratch`` (int32, ``topk_scratch_words``
    long) replaces the one allocated here; both for tests."""
    flat = _flat32(x, "codec_topk_select")
    n = flat.numel()
    if n >= 2 ** 31:
        raise ValueError("topk_select: the wire's uint32 indices need "
                         "fewer than 2**31 elements")
    if not 1 <= k <= n:
        raise ValueError(f"topk_select: k={k} outside 1..{n}")
    if scratch is None:
        scratch = torch.empty(topk_scratch_words(blocks), dtype=torch.int32,
                              device=flat.device)
    _check(scratch, torch.int32, "codec_topk_select scratch")
    idx = torch.empty(k, dtype=torch.int32, device=flat.device)
    vals = torch.empty(k, dtype=torch.float32, device=flat.device)
    _launch("codec_topk_select", flat, _P(flat.data_ptr()), n, k,
            _P(idx.data_ptr()), _P(vals.data_ptr()), _P(scratch.data_ptr()),
            scratch.numel(), blocks or 0)
    return idx, vals
