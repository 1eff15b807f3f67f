"""The split-sequence decode attention's host side and its plain
split-and-combine version, on the CPU.

``decode_splits`` (``repro_torch/kernels/decode_attention.py``) picks how
many position ranges the CUDA split kernel reads; ``split_ranges`` below
is how the kernel cuts ``0..pos`` into them.
``ref.decode_attention_split_ref`` runs the kernels' algorithm in plain
PyTorch (a softmax state per range, then the merge); here it is held to
``ref.decode_attention_ref`` and to the reference's Pallas
``decode_attention`` in interpret mode, with ``tests/test_kernels.py``'s
tolerances (2e-5 in fp32, 2e-2 in bf16).  On the card the CUDA kernels
are held to both plain versions by ``test_torch_kernels_cuda.py`` and
``chip_smoke.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.kernels import ops as rops
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (MIN_SPLIT_POSITIONS,
                                                  WAVES, decode_splits)

torch.set_num_threads(1)


def split_ranges(n_pos, splits):
    """``[start, end)`` of each split as ``decode_split_kernel`` takes it
    (``start = split * chunk``, ``chunk = ceil(n_pos / splits)``)."""
    chunk = -(-n_pos // splits)
    return [(min(i * chunk, n_pos), min((i + 1) * chunk, n_pos))
            for i in range(splits)]


def _covers(ranges, n_pos):
    """The ranges tile ``[0, n_pos)`` in order, without gaps or overlap."""
    assert ranges[0][0] == 0 and ranges[-1][1] == n_pos
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(start <= end for start, end in ranges)


@pytest.mark.parametrize("B,KV,pos,sm_count", [
    (8, 8, 1055, 132),     # the LM slice's last decode step
    (8, 8, 1024, 132),     # its first
    (8, 1, 1055, 132),     # MQA: eight (b, head) pairs
    (8, 8, 0, 132),        # the first token: one position
    (8, 8, 63, 132),       # fewer positions than one split's minimum
    (8, 8, 200, 132),
    (1, 1, 32767, 132),    # one pair, a long cache
    (300, 1, 4095, 132),   # B * KV alone fills more than two waves
    (8, 8, 1055, 1),       # a one-SM card
    (3, 5, 999, 7),
])
def test_decode_splits_cover_the_positions(B, KV, pos, sm_count):
    n = pos + 1
    splits = decode_splits(B, KV, n, sm_count)
    assert 1 <= splits <= n
    ranges = split_ranges(n, splits)
    _covers(ranges, n)
    # no split beyond the positions, none empty
    assert all(start < end for start, end in ranges)
    # at least MIN_SPLIT_POSITIONS a split, as far as the positions allow
    assert all(end - start >= min(MIN_SPLIT_POSITIONS, n)
               for start, end in ranges[:-1])
    # two waves of CTAs at least, where the positions allow that many
    want = -(-WAVES * sm_count // (B * KV))
    if n // MIN_SPLIT_POSITIONS >= want:
        assert splits * B * KV >= 2 * sm_count
    else:
        assert splits == max(1, n // MIN_SPLIT_POSITIONS)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(dtype: str) -> dict:
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,H,KV,hd,Smax,pos", [
    (2, 4, 2, 64, 512, 317),
    (1, 8, 1, 128, 256, 0),          # first token: every split past it
    (2, 4, 4, 96, 256, 255),         # full cache
])
@pytest.mark.parametrize("splits", [1, 2, 7, "more than positions"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_and_combine_matches_plain_and_pallas(B, H, KV, hd, Smax, pos,
                                                    splits, dtype):
    n = pos + 3 if splits == "more than positions" else splits
    jd, td = DTYPES[dtype]
    q, kc, vc = (_normal(s, seed) for s, seed in (((B, H, hd), 3),
                                                  ((B, Smax, KV, hd), 4),
                                                  ((B, Smax, KV, hd), 5)))
    out = ref.decode_attention_split_ref(
        *(torch.from_numpy(a).to(td) for a in (q, kc, vc)), pos, n)
    assert out.dtype == td and out.shape == (B, H, hd)
    plain = ref.decode_attention_ref(
        *(torch.from_numpy(a).to(td) for a in (q, kc, vc)), pos)
    pallas = rops.decode_attention(*(jnp.asarray(a, jd) for a in (q, kc, vc)),
                                   pos, block_s=128, interpret=True)
    for exp in (plain.to(torch.float32).numpy(), np.asarray(pallas,
                                                            np.float32)):
        assert_allclose(out.to(torch.float32).numpy(), exp, **tol(dtype))


@pytest.mark.parametrize("splits", [1, 3, "more than positions"])
def test_lse_from_split_states_is_the_scores_logsumexp(splits):
    """``decode_attention._lse`` reads the log-sum-exp that a
    sequence-split cache merges by from the split kernel's partial
    states, as ``decode_split_kernel`` writes them: per split the max
    ``m_i`` and the sum ``l_i`` of ``2^(s - m_i)``, scores in the log2
    domain (scaled by ``scale · log2 e``), an empty split ``(-inf,
    0)``; it must equal the natural log-sum-exp of the scaled scores,
    which ``ref.decode_attention_ref(..., with_lse=True)`` returns."""
    from repro_torch.kernels.decode_attention import _lse
    B, H, KV, hd, Smax, pos = 2, 4, 2, 64, 96, 70
    q, kc, vc = (torch.from_numpy(_normal(s, seed)) for s, seed in
                 (((B, H, hd), 7), ((B, Smax, KV, hd), 8),
                  ((B, Smax, KV, hd), 9)))
    _, want = ref.decode_attention_ref(q, kc, vc, pos, with_lse=True)
    n = pos + 1
    n_splits = n + 3 if splits == "more than positions" else splits
    chunk = -(-n // n_splits)
    s = torch.einsum("bhd,bshd->bhs", q,
                     kc[:, :n].repeat_interleave(H // KV, dim=2)) \
        / math.sqrt(hd) * math.log2(math.e)
    states = []
    for i in range(n_splits):
        part = s[..., min(i * chunk, n):min((i + 1) * chunk, n)]
        if part.shape[-1] == 0:
            states.append(torch.stack([torch.full((B, H), float("-inf")),
                                       torch.zeros((B, H))], -1))
            continue
        m = part.amax(-1)
        states.append(torch.stack([m, torch.exp2(part - m[..., None])
                                   .sum(-1)], -1))
    got = _lse(torch.stack(states, 2))
    assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
