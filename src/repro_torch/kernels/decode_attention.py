"""Python side of the CUDA decode-attention kernels (``csrc/lm_kernels.cu``,
``decode_split_kernel`` + ``decode_combine_kernel``).

They replace the reference's Pallas ``decode_attention``
(``src/repro/kernels/decode_attention.py``), split across the sequence:
each CTA reads one range of cache positions and writes a partial
softmax state to fp32 scratch, and a second kernel merges the ranges.
The wrapper takes CUDA tensors only (it raises for any other device
before anything is built), checks shapes and dtypes, picks the split
count with ``decode_splits``, allocates the output and the scratch with
``torch.empty`` and launches both kernels on the current stream without
synchronising.  ``pos`` is a Python int: the kernels read cache rows
``0..pos`` and no further, so no step waits on the device to learn it.
Unlike the Pallas kernel it takes any ``Smax``.  Rows are read as 16-byte
vectors, so ``hd`` must be a multiple of 8 in bf16 and of 4 in fp32.
``ops`` routes CPU tensors to ``ref.decode_attention_ref`` instead.
"""
from __future__ import annotations

import functools
import math

import torch

from ._build import DTYPE_CODES, LM_KERNELS, P, aligned16, require_cuda

MAX_HEAD_DIM = 128
MIN_SPLIT_POSITIONS = 64   # fewer positions a CTA cost more to merge than save
WAVES = 4                  # CTAs: about this many times the card's SMs


def decode_splits(B: int, KV: int, n_pos: int, sm_count: int) -> int:
    """How many ranges to split ``n_pos`` cache positions into, for a
    grid of ``splits x KV x B`` CTAs on ``sm_count`` SMs: enough for
    ``WAVES`` waves, no fewer than ``MIN_SPLIT_POSITIONS`` positions a range
    (as far as ``n_pos`` allows), never more ranges than positions, and
    none of them empty.  The kernel cuts ``0..n_pos`` into ranges of
    ``ceil(n_pos / splits)``, so the count is the one those ranges need."""
    want = -(-WAVES * sm_count // max(1, B * KV))
    splits = max(1, min(want, n_pos // MIN_SPLIT_POSITIONS, n_pos))
    chunk = -(-n_pos // splits)
    return -(-n_pos // chunk)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *,
                     splits: int | None = None, with_lse: bool = False):
    """q: (B,H,hd); caches: (B,Smax,KV,hd), one float dtype (fp32 or
    bf16); ``0 <= pos < Smax`` → (B,H,hd).  ``splits`` forces the number
    of position ranges (tests only; ``decode_splits`` picks it
    otherwise); ranges past ``pos`` are empty and add nothing.  With
    ``with_lse`` also the fp32 (B,H) log-sum-exp of the scaled scores,
    read from the split kernel's partial softmax states (``_lse``)."""
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
    vec = 16 // q.element_size()
    if hd % vec:
        raise ValueError(f"decode_attention: the kernel reads 16-byte "
                         f"vectors and needs head_dim % {vec} == 0 in "
                         f"{q.dtype}, got {hd}")
    if splits is None:
        splits = decode_splits(B, KV, pos + 1, _sm_count(q.device.index or 0))
    if splits < 1:
        raise ValueError(f"decode_attention: splits {splits} < 1")
    q = aligned16(q)
    k_cache, v_cache = aligned16(k_cache), aligned16(v_cache)
    out = torch.empty_like(q)
    part_o = torch.empty(B * H * splits * hd, dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty(B * H * splits * 2, dtype=torch.float32,
                          device=q.device)
    LM_KERNELS.launch("lm_decode_attention", q.device, P(q.data_ptr()),
                      P(k_cache.data_ptr()), P(v_cache.data_ptr()),
                      P(out.data_ptr()), P(part_o.data_ptr()),
                      P(part_ml.data_ptr()), B, H, KV, Smax, hd, pos,
                      splits, 1.0 / math.sqrt(hd), DTYPE_CODES[q.dtype])
    if with_lse:
        return out, _lse(part_ml.view(B, H, splits, 2))
    return out


def _lse(part_ml: torch.Tensor) -> torch.Tensor:
    """The log-sum-exp (natural log) of the scaled scores from the split
    kernel's (B,H,splits,2) states: each split's max ``m_i`` and sum
    ``l_i`` of ``2^(s - m_i)``, scores in the log2 domain (``scale ·
    log2 e``); an empty split (``m_i = -inf``) adds nothing."""
    m, l = part_ml.unbind(-1)
    mx = m.amax(dim=-1, keepdim=True)
    tot = (l * torch.exp2(m - mx)).sum(dim=-1)
    return (mx[..., 0] + torch.log2(tot)) * math.log(2.0)
