"""The CUDA kernels on the card, against their plain versions: the
codec kernels bit for bit, the LM kernels (attention, RMSNorm) within
``tests/test_kernels.py``'s tolerances (2e-5 in fp32, 2e-2 in bf16), the
selective scan within its 1e-4, the gated scan's bf16 output within one
bf16 ulp (1e-2).

Every test here needs an NVIDIA GPU and skips without one.  This file
imports no jax, so it runs on the GPU machine without the repository's
``conftest.py`` (which imports jax):

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_kernels_cuda.py
"""
import math
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import codecs as C
from repro_torch.kernels import codec_pack, ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


# 3_211_264: the CNN slice's int8 hop, past what the pack kernels' grid
# keeps in registers (the rest goes to shared memory); 40_000_003: past
# what the cooperative grids keep on chip, so their kernels read x again
SIZES = [1, 7, 127, 129, 1_000_003, 3_211_264, 40_000_003]
KINDS = ["normal", "ties", "nan_payloads", "inf_and_neg_zero", "all_equal",
         "all_zeros"]


def _inputs(n, cuda):
    g = torch.Generator(device=cuda).manual_seed(n)
    return (torch.randn(n, generator=g, device=cuda) * 3.0,
            # few distinct magnitudes: top-k ties go to the lower index
            torch.randint(-4, 5, (n,), generator=g, device=cuda).float())


def _input(kind, n, cuda):
    """One flat fp32 input of ``n`` elements: normal or tie-heavy values,
    NaNs of several payloads and signs among them, +-inf and -0.0 among
    them, all equal, or all zeros (+0 and -0)."""
    normal, ties = _inputs(n, cuda)
    if kind in ("normal", "ties"):
        return normal if kind == "normal" else ties
    g = torch.Generator(device=cuda).manual_seed(n + 1)
    m = max(1, n // 997)
    pos = torch.randperm(n, generator=g, device=cuda)
    if kind == "nan_payloads":
        payload = torch.arange(m, device=cuda, dtype=torch.int64) * 7919
        # quiet NaNs, the sign bit set on two in three
        bits = (0x7FC00000 | payload % 0x400000) - 2 ** 31 * (payload % 3 > 0)
        normal.view(torch.int32)[pos[:m]] = bits.to(torch.int32)
        return normal
    if kind == "inf_and_neg_zero":
        normal[pos[:m]] = float("inf")
        normal[pos[m:2 * m]] = float("-inf")
        normal[pos[2 * m:3 * m]] = -0.0
        return normal
    if kind == "all_equal":
        return torch.full((n,), -1.5, device=cuda)
    zeros = torch.zeros(n, device=cuda)
    zeros[::2] = -0.0
    return zeros


def _same_bits(a, b):
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
def test_pack_unpack_kernels_are_bit_exact(n, kind, cuda):
    x = _input(kind, n, cuda)
    # also a view 4 bytes past a 16-byte boundary
    for view in (x, x[1:]) if n > 1 else (x,):
        for pack in ("int8_pack", "fp8_pack"):
            q, s = getattr(ops, pack)(view)
            q_ref, s_ref = getattr(ref, pack + "_ref")(view)
            assert _same_bits(q, q_ref) and _same_bits(s, s_ref)
            unpack = pack.replace("pack", "unpack")
            assert _same_bits(getattr(ops, unpack)(q, float(s)),
                              getattr(ref, unpack + "_ref")(q, s))


def test_packs_of_an_empty_tensor(cuda):
    x = torch.empty(0, device=cuda)
    for pack in ("int8_pack", "fp8_pack"):
        q, s = getattr(ops, pack)(x)
        q_ref, s_ref = getattr(ref, pack + "_ref")(x)
        assert q.numel() == 0 and q.dtype == q_ref.dtype
        assert _same_bits(s, s_ref)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
def test_topk_kernel_is_bit_exact(n, kind, cuda):
    x = _input(kind, n, cuda)
    for k in sorted({1, math.ceil(n / 8), n}):
        i, v = ops.topk_select(x, k=k)
        i_ref, v_ref = ref.topk_select_ref(x, k=k)
        assert torch.equal(i, i_ref) and _same_bits(v, v_ref)


@pytest.mark.parametrize("blocks", [1, 3, 100])
@pytest.mark.parametrize("kind", ["normal", "ties", "nan_payloads"])
def test_cooperative_kernels_at_forced_grids(blocks, kind, cuda):
    """A grid of 1 CTA keeps 8192 (top-k) or 16384 + 51200 (the packs:
    registers, then shared memory) elements on chip and reads the rest
    of its range again; 3 CTAs keep theirs (the packs partly in shared
    memory); 100 CTAs leave some empty at small n."""
    for n in (5, 100_003):
        x = _input(kind, n, cuda)
        for pack in ("int8_pack", "fp8_pack"):
            q, s = getattr(codec_pack, pack)(x, blocks=blocks)
            q_ref, s_ref = getattr(ref, pack + "_ref")(x)
            assert _same_bits(q, q_ref) and _same_bits(s, s_ref)
        for k in sorted({1, math.ceil(n / 8), n}):
            i, v = codec_pack.topk_select(x, k=k, blocks=blocks)
            i_ref, v_ref = ref.topk_select_ref(x, k=k)
            assert torch.equal(i, i_ref) and _same_bits(v, v_ref)


def test_cooperative_kernels_raise_and_do_not_fall_back(cuda):
    x = _inputs(10_000, cuda)[0]
    ops.reset_launch_counts()
    # scratch too small for the grid's per-CTA counts
    small = torch.empty(codec_pack.TOPK_HIST_WORDS + 1, dtype=torch.int32,
                        device=cuda)
    with pytest.raises(RuntimeError, match="codec_topk_select"):
        codec_pack.topk_select(x, k=10, scratch=small)
    # more CTAs than the card keeps resident: the runtime refuses the launch
    with pytest.raises(RuntimeError, match="codec_topk_select"):
        codec_pack.topk_select(x, k=10, blocks=1_000_000)
    with pytest.raises(RuntimeError, match="codec_fp8_pack"):
        codec_pack.fp8_pack(x, blocks=1_000_000)
    with pytest.raises(RuntimeError, match="codec_int8_pack"):
        codec_pack.int8_pack(x, blocks=1_000_000)
    with pytest.raises(ValueError, match="k=0"):
        ops.topk_select(x, k=0)
    assert ops.launch_counts()["topk_select"] == 0
    # a refused launch leaves no error behind for the next one
    i, v = ops.topk_select(x, k=10)
    i_ref, v_ref = ref.topk_select_ref(x, k=10)
    assert torch.equal(i, i_ref) and _same_bits(v, v_ref)
    q, s = ops.int8_pack(x)
    q_ref, s_ref = ref.int8_pack_ref(x)
    assert _same_bits(q, q_ref) and _same_bits(s, s_ref)


@pytest.mark.parametrize("codec", ["int8", "fp8", "topk"])
def test_card_and_cpu_put_the_same_bytes_on_the_wire(codec, cuda):
    x = _inputs(4099, cuda)[0].reshape(1, 4099)
    c = C.get_codec(codec)
    buf = c.encode(x)
    assert buf == c.encode(x.cpu())
    assert torch.equal(c.decode(buf, (1, 4099), torch.float32, cuda).cpu(),
                       c.decode(buf, (1, 4099), torch.float32, "cpu"))


def test_launches_are_counted(cuda):
    ops.reset_launch_counts()
    x = _inputs(1000, cuda)[0]
    C.roundtrip("int8", x)
    C.roundtrip("topk", x)
    counts = ops.launch_counts()
    assert counts["int8_pack"] == counts["int8_unpack"] == 1
    assert counts["topk_select"] == 1 and counts["fp8_pack"] == 0


# --------------------------------------------------------------------------- #
# LM kernels (csrc/lm_kernels.cu)
# --------------------------------------------------------------------------- #
def _lm_tol(dtype):
    """rtol = atol, as ``assert_allclose`` in tests/test_kernels.py."""
    return 2e-2 if dtype == torch.bfloat16 else 2e-5


def _randn(shape, dtype, cuda, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(shape, generator=g, device=cuda).to(dtype)


@pytest.mark.parametrize("B,S,T,H,KV,hd,causal", [
    (1, 128, 128, 4, 4, 64, True),       # MHA
    (2, 256, 256, 4, 2, 64, False),      # GQA
    (1, 1000, 1000, 16, 8, 128, True),   # ragged, the slice's heads
    (2, 64, 1500, 4, 2, 96, False),      # ragged kv, phi3-vision head_dim
    (1, 24, 75, 8, 1, 128, True),        # S < T causal, MQA
    (2, 200, 200, 4, 2, 16, True),       # the reduced configs' head_dim
    (1, 300, 300, 4, 4, 112, True),      # zamba2's head_dim
    (1, 256, 256, 48, 1, 128, True),     # granite-20b's MQA group, G = 48
    (1, 300, 300, 36, 4, 128, True),     # starcoder2-7b's group, G = 9
    (2, 200, 200, 24, 2, 128, True),     # starcoder2-3b's group, G = 12
    (8, 1024, 1024, 48, 1, 128, True),   # granite-20b's prefill
    (8, 1024, 1024, 32, 32, 96, True),   # phi-3-vision-4.2b's prefill
    (2, 333, 333, 4, 2, 64, False),      # S not a multiple of 128
    (1, 77, 300, 4, 2, 128, True),       # causal, S < T, ragged
    (8, 1, 1500, 12, 12, 64, False),     # whisper's cross-attention decode
    (8, 1024, 1024, 32, 32, 112, True),  # zamba2's shared block, prefill
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(B, S, T, H, KV, hd, causal,
                                              dtype, cuda):
    q = _randn((B, S, H, hd), dtype, cuda, 1)
    k = _randn((B, T, KV, hd), dtype, cuda, 2)
    v = _randn((B, T, KV, hd), dtype, cuda, 3)
    out = ops.flash_attention(q, k, v, causal=causal)
    exp = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), exp.float(), rtol=_lm_tol(dtype),
                               atol=_lm_tol(dtype))


@pytest.mark.parametrize("B,H,KV,hd,Smax,pos", [
    (8, 16, 8, 128, 1056, 0),
    (8, 16, 8, 128, 1056, 511),
    (8, 16, 8, 128, 1056, 1055),
    (2, 8, 1, 128, 256, 100),            # MQA, G = 8
    (2, 4, 4, 96, 77, 76),               # ragged Smax, full cache
    (8, 32, 32, 112, 1056, 1055),        # zamba2's shared block, decode
    (2, 36, 4, 128, 300, 299),           # starcoder2-7b's group, G = 9
    (2, 24, 2, 128, 333, 332),           # starcoder2-3b's group, G = 12
    (8, 48, 1, 128, 1032, 1031),         # granite-20b's MQA, G = 48
    (8, 32, 32, 96, 1608, 1031),         # phi-3-vision's, past 1024
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain(B, H, KV, hd, Smax, pos,
                                               dtype, cuda):
    q = _randn((B, H, hd), dtype, cuda, 4)
    kc = _randn((B, Smax, KV, hd), dtype, cuda, 5)
    vc = _randn((B, Smax, KV, hd), dtype, cuda, 6)
    out = ops.decode_attention(q, kc, vc, pos)
    exp = ref.decode_attention_ref(q, kc, vc, pos)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), exp.float(), rtol=_lm_tol(dtype),
                               atol=_lm_tol(dtype))


@pytest.mark.parametrize("Smax,pos", [(77, 0), (77, 76), (1056, 0),
                                      (1056, 1055)])
@pytest.mark.parametrize("splits", [1, 2, "more than positions"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_forced_splits(Smax, pos, splits, dtype,
                                               cuda):
    """The split kernel at forced split counts, empty ranges included,
    against the plain version and the plain split-and-combine."""
    from repro_torch.kernels import decode_attention as dk
    n = pos + 3 if splits == "more than positions" else splits
    q = _randn((2, 8, 128), dtype, cuda, 10)
    kc = _randn((2, Smax, 4, 128), dtype, cuda, 11)
    vc = _randn((2, Smax, 4, 128), dtype, cuda, 12)
    out = dk.decode_attention(q, kc, vc, pos, splits=n)
    torch.cuda.synchronize()
    for exp in (ref.decode_attention_ref(q, kc, vc, pos),
                ref.decode_attention_split_ref(q, kc, vc, pos, n)):
        torch.testing.assert_close(out.float(), exp.float(),
                                   rtol=_lm_tol(dtype), atol=_lm_tol(dtype))


@pytest.mark.parametrize("Smax,pos", [(77, 0), (1056, 511), (1056, 1055)])
@pytest.mark.parametrize("splits", [1, 2, "more than positions"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_lse_matches_plain(Smax, pos, splits, dtype, cuda):
    """With ``with_lse`` the split kernel's output and the log-sum-exp read
    from its partial states (a sequence-split cache merges by it), empty
    ranges included, against the plain version's."""
    from repro_torch.kernels import decode_attention as dk
    n = pos + 3 if splits == "more than positions" else splits
    q = _randn((2, 8, 128), dtype, cuda, 14)
    kc = _randn((2, Smax, 4, 128), dtype, cuda, 15)
    vc = _randn((2, Smax, 4, 128), dtype, cuda, 16)
    out, lse = dk.decode_attention(q, kc, vc, pos, splits=n, with_lse=True)
    exp, exp_lse = ref.decode_attention_ref(q, kc, vc, pos, with_lse=True)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == (2, 8)
    torch.testing.assert_close(out.float(), exp.float(), rtol=_lm_tol(dtype),
                               atol=_lm_tol(dtype))
    torch.testing.assert_close(lse, exp_lse, rtol=2e-5, atol=2e-5)


def test_bf16_flash_refuses_head_dim_off_16_bytes(cuda):
    """hd % 8 != 0 in bf16 is refused before anything is launched."""
    x = _randn((1, 8, 2, 12), torch.bfloat16, cuda, 13)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="head_dim % 8"):
        ops.flash_attention(x, x, x)
    assert ops.launch_counts()["flash_attention"] == 0


# every row the serving paths normalise (qwen3-1.7b prefill and decode:
# d_model rows, then q and k heads; falcon-mamba-7b: d_model 4096), and
# ragged ones
RMS_SHAPES = [(8192, 2048), (131072, 128), (65536, 128), (8, 2048),
              (128, 128), (64, 128), (8192, 4096), (8, 4096), (8, 16, 128),
              (5, 3), (2, 33, 128)]


@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
def test_fused_rmsnorm_kernel_matches_plain(shape, dtype, scale_dtype, cuda):
    x = _randn(shape, dtype, cuda, 7)
    sc = _randn((shape[-1],), scale_dtype, cuda, 8)
    out = ops.fused_rmsnorm(x, sc)
    exp = ref.fused_rmsnorm_ref(x, sc)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == x.shape
    torch.testing.assert_close(out.float(), exp.float(), rtol=_lm_tol(dtype),
                               atol=_lm_tol(dtype))


@pytest.mark.parametrize("route", ["x off 16 bytes", "scale off 16 bytes"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_rmsnorm_scalar_path_matches_plain(route, dtype, cuda):
    """The scalar kernel, which takes a pointer that is not 16-byte
    aligned (a contiguous view one element into its storage)."""
    from repro_torch.kernels import fused_rmsnorm as rk
    rows, d = 300, 2048
    x = _randn((rows * d + 1,), dtype, cuda, 14)
    sc = _randn((d + 1,), dtype, cuda, 15)
    xs = x[1:] if route == "x off 16 bytes" else x[:-1]
    scs = sc[1:] if route == "scale off 16 bytes" else sc[:-1]
    xs = xs.view(rows, d)
    out = rk.fused_rmsnorm(xs, scs)
    exp = ref.fused_rmsnorm_ref(xs, scs)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), exp.float(), rtol=_lm_tol(dtype),
                               atol=_lm_tol(dtype))


def test_lm_kernel_launches_are_counted(cuda):
    ops.reset_launch_counts()
    x = _randn((2, 8, 4, 64), torch.bfloat16, cuda, 9)
    ops.flash_attention(x, x, x)
    ops.decode_attention(x[:, 0], x, x, 3)
    ops.fused_rmsnorm(x, x[0, 0, 0])
    counts = ops.launch_counts()
    assert counts["flash_attention"] == counts["decode_attention"] == 1
    assert counts["fused_rmsnorm"] == 1 and counts["int8_pack"] == 0


# --------------------------------------------------------------------------- #
# selective scan (csrc/ssm_scan.cu)
# --------------------------------------------------------------------------- #
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_kernels.py's


def _scan_inputs(B, L, di, N, dtype, cuda, seed):
    """dt softplus'ed, A negative (the reference sweep's distributions);
    x, B, C in ``dtype``, the rest fp32."""
    g = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    dt = torch.nn.functional.softplus(randn(B, L, di))
    A = -torch.exp(randn(di, N) * 0.5)
    return (dt, randn(B, L, di).to(dtype), randn(B, L, N).to(dtype),
            randn(B, L, N).to(dtype), A, randn(B, di, N))


@pytest.mark.parametrize("B,L,di,N,dtype", [
    (8, 256, 8192, 16, torch.bfloat16),     # the serving path's prefill chunk
    (8, 1, 8192, 16, torch.bfloat16),       # its decode step
    (2, 64, 128, 16, torch.float32),        # the reference sweep
    (1, 32, 256, 8, torch.float32),
    (2, 16, 64, 16, torch.float32),
    (3, 40, 200, 8, torch.float32),         # ragged di, ragged time tile
    (2, 33, 200, 16, torch.bfloat16),
])
def test_ssm_scan_kernel_matches_plain(B, L, di, N, dtype, cuda):
    args = _scan_inputs(B, L, di, N, dtype, cuda, L + di)
    y, h = ops.ssm_scan_chunk(*args)
    ye, he = ref.ssm_scan_chunk_ref(*args)
    torch.cuda.synchronize()
    assert y.dtype == h.dtype == torch.float32
    torch.testing.assert_close(y, ye, **SCAN_TOL)
    torch.testing.assert_close(h, he, **SCAN_TOL)


def test_ssm_scan_kernel_chains_in_place_over_views(cuda):
    """Two chunks read as views of one (B, 2L, .) input, B/C as column
    slices of one projection, y written into one buffer and the state
    updated in place (``h_out`` is ``h0``), equal one long plain scan."""
    Bn, L, di, N, R = 2, 128, 300, 16, 8
    dt, x, _, _, A, h0 = _scan_inputs(Bn, 2 * L, di, N, torch.bfloat16,
                                      cuda, 11)
    g = torch.Generator(device=cuda).manual_seed(12)
    proj = torch.randn(Bn, 2 * L, R + 2 * N, generator=g,
                       device=cuda).to(torch.bfloat16)
    Bc, Cc = proj[..., R:R + N], proj[..., R + N:]
    ye, he = ref.ssm_scan_chunk_ref(dt, x, Bc, Cc, A, h0)
    y = torch.empty(Bn, 2 * L, di, device=cuda)
    h = h0.clone()
    for c in (slice(0, L), slice(L, 2 * L)):
        _, h_new = ops.ssm_scan_chunk(dt[:, c], x[:, c], Bc[:, c], Cc[:, c],
                                      A, h, y=y[:, c], h_out=h)
        assert h_new is h
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ye, **SCAN_TOL)
    torch.testing.assert_close(h, he, **SCAN_TOL)


def test_ssm_scan_kernel_refuses_an_uncompiled_state_size(cuda):
    args = _scan_inputs(1, 4, 32, 4, torch.float32, cuda, 13)
    with pytest.raises(ValueError, match="no compiled instance"):
        ops.ssm_scan_chunk(*args)


def test_ssm_scan_launches_are_counted(cuda):
    ops.reset_launch_counts()
    args = _scan_inputs(1, 4, 32, 8, torch.float32, cuda, 14)
    ops.ssm_scan_chunk(*args)
    ops.ssm_scan_chunk(*args, h_out=args[-1])
    counts = ops.launch_counts()
    assert counts["ssm_scan_chunk"] == 2 and counts["fused_rmsnorm"] == 0


# the gated scan (mamba1_scan_chunk): raw dt with dt_bias, the D-skip and
# the SiLU gate folded in; y in the working dtype, held to one bf16 ulp
GATED_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
             torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


def _gated_inputs(B, L, di, N, dtype, cuda, seed):
    """Raw dt, dt_bias, x, z, B, C in ``dtype``; A negative, D and h0
    fp32 — the argument order of ``ops.mamba1_scan_chunk``."""
    g = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=cuda) * scale
    A = -torch.exp(randn(di, N, scale=0.5))
    return (randn(B, L, di).to(dtype), randn(di, scale=0.5).to(dtype),
            randn(B, L, di).to(dtype), randn(B, L, di).to(dtype),
            randn(B, L, N).to(dtype), randn(B, L, N).to(dtype), A,
            randn(di), randn(B, di, N))


def _hold_gated(got, exp, dtype):
    (y, h), (ye, he) = got, exp
    assert y.dtype == dtype and h.dtype == torch.float32
    torch.testing.assert_close(y, ye, **GATED_TOL[dtype])
    torch.testing.assert_close(h, he, **SCAN_TOL)


@pytest.mark.parametrize("B,L,di,N,dtype", [
    (8, 256, 8192, 16, torch.bfloat16),     # the serving path's prefill chunk
    (8, 1, 8192, 16, torch.bfloat16),       # its decode step
    (2, 64, 128, 16, torch.float32),
    (1, 32, 256, 8, torch.float32),
    (2, 16, 64, 16, torch.float32),
    (3, 40, 200, 8, torch.float32),         # ragged di, ragged time tile
    (2, 33, 200, 16, torch.bfloat16),
    (2, 70, 136, 8, torch.bfloat16),
])
def test_mamba1_scan_kernel_matches_plain(B, L, di, N, dtype, cuda):
    args = _gated_inputs(B, L, di, N, dtype, cuda, L + di + 1)
    got = ops.mamba1_scan_chunk(*args)
    exp = ref.mamba1_scan_chunk_ref(*args)
    torch.cuda.synchronize()
    _hold_gated(got, exp, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba1_scan_kernel_chains_in_place_over_views(dtype, cuda):
    """The model's operands: z the second half of one in_proj output, B/C
    column slices of one x_proj output, two chunks as views, y into one
    buffer of the working dtype and the state in place; equal one long
    plain call."""
    Bn, L, di, N, R = 2, 96, 264, 16, 8
    dt, bias, x, _, _, _, A, D, h0 = _gated_inputs(Bn, 2 * L, di, N, dtype,
                                                   cuda, 15)
    g = torch.Generator(device=cuda).manual_seed(16)
    xz = torch.randn(Bn, 2 * L, 2 * di, generator=g, device=cuda).to(dtype)
    z = xz[..., di:]
    proj = torch.randn(Bn, 2 * L, R + 2 * N, generator=g,
                       device=cuda).to(dtype)
    Bc, Cc = proj[..., R:R + N], proj[..., R + N:]
    exp = ref.mamba1_scan_chunk_ref(dt, bias, x, z, Bc, Cc, A, D, h0)
    y = torch.empty(Bn, 2 * L, di, device=cuda, dtype=dtype)
    h = h0.clone()
    for c in (slice(0, L), slice(L, 2 * L)):
        _, h_new = ops.mamba1_scan_chunk(dt[:, c], bias, x[:, c], z[:, c],
                                         Bc[:, c], Cc[:, c], A, D, h,
                                         y=y[:, c], h_out=h)
        assert h_new is h
    torch.cuda.synchronize()
    _hold_gated((y, h), exp, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernels_read_rows_off_16_bytes(dtype, cuda):
    """Operands whose rows do not start on 16 bytes take the kernel's
    element loads instead of cp.async: B/C columns after an odd dt_rank,
    dt, x and z one element into wider tensors.  Both entries equal
    their plain versions."""
    Bn, L, di, N, R = 2, 40, 72, 16, 3
    g = torch.Generator(device=cuda).manual_seed(19)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    proj = randn(Bn, L, R + 2 * N).to(dtype)
    Bc, Cc = proj[..., R:R + N], proj[..., R + N:]
    x, raw = (randn(Bn, L, di + 1).to(dtype)[..., 1:] for _ in range(2))
    z = randn(Bn, L, 2 * di + 1).to(dtype)[..., di + 1:]
    dt = torch.nn.functional.softplus(randn(Bn, L, di + 1))[..., 1:]
    A, h0 = -torch.exp(randn(di, N) * 0.5), randn(Bn, di, N)
    bias, D = (randn(di) * 0.5).to(dtype), randn(di)
    assert x.data_ptr() % 16 and Bc.data_ptr() % 16
    y, h = ops.ssm_scan_chunk(dt, x, Bc, Cc, A, h0)
    ye, he = ref.ssm_scan_chunk_ref(dt, x, Bc, Cc, A, h0)
    got = ops.mamba1_scan_chunk(raw, bias, x, z, Bc, Cc, A, D, h0)
    exp = ref.mamba1_scan_chunk_ref(raw, bias, x, z, Bc, Cc, A, D, h0)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ye, **SCAN_TOL)
    torch.testing.assert_close(h, he, **SCAN_TOL)
    _hold_gated(got, exp, dtype)


def test_mamba1_scan_kernel_refuses_an_uncompiled_state_size(cuda):
    args = _gated_inputs(1, 4, 32, 4, torch.float32, cuda, 17)
    with pytest.raises(ValueError, match="no compiled instance"):
        ops.mamba1_scan_chunk(*args)


def test_mamba1_scan_launches_are_counted(cuda):
    ops.reset_launch_counts()
    args = _gated_inputs(1, 4, 32, 8, torch.bfloat16, cuda, 18)
    ops.mamba1_scan_chunk(*args)
    ops.mamba1_scan_chunk(*args, h_out=args[-1])
    counts = ops.launch_counts()
    assert counts["mamba1_scan_chunk"] == 2
    assert counts["ssm_scan_chunk"] == 0


# --------------------------------------------------------------------------- #
# one CUDA stream a pipeline stage (runtime/edge.py Worker)
# --------------------------------------------------------------------------- #
def test_concurrent_stage_times_are_their_own(cuda):
    """A heavy and a light stage run at once on two threads
    (``chip_smoke.concurrent_stages``): each on its own stream, the light
    stage's ``exe_s`` ends with its own kernels, not the heavy stage's
    (as a wait on the whole card would make it)."""
    from repro_torch.runtime.edge import Worker

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    hw, lw = chip_smoke.concurrent_stages(torch, Worker, cuda)
    assert hw.stream is not None and hw.stream != lw.stream
    assert hw.stats.calls == 5 and lw.stats.calls == 50
    heavy_s = hw.stats.exe_s / hw.stats.calls
    light_s = lw.stats.exe_s / lw.stats.calls
    assert light_s < heavy_s / 4, (light_s, heavy_s)


def test_stages_keep_streams_of_their_own(cuda):
    """torch hands out its 32 streams a device in turn, so after enough
    draws the next one is a live stage's.  A migration that re-cuts two
    of four stages (one replicated) just then still gives every live
    stage a stream of its own, and the pipeline still runs."""
    from repro_torch.core.devices import Link
    from repro_torch.models.cnn import zoo
    from repro_torch.runtime import EdgePipeline

    model = zoo.get("mobilenetv2", 10).init(
        torch.Generator().manual_seed(0), "cuda")
    links = [Link(name="fast", rtt_s=2e-5, bw_bytes_per_s=1e10)] * 3
    pipe = EdgePipeline(model, (1, 2, 3), links, replicas=(1, 2, 2, 1),
                        device="cuda")

    def handles():
        return [w.stream.cuda_stream for w in pipe.workers]
    first = handles()
    assert len(set(first)) == 6
    for _ in range(64):                # until the pool's next is worker 1's
        if torch.cuda.Stream(cuda).cuda_stream == first[0]:
            break
    else:
        raise AssertionError("the stream pool never came round")
    pipe.migrate((1, 2, 4))
    assert set(handles()[:3]) == set(first[:3])   # stages 0, 1 kept theirs
    assert len(set(handles())) == 6
    x = torch.randn(2, 224, 224, 3, device=cuda)
    out, _, _ = pipe.run_one(x)
    assert out.shape == (2, 10) and bool(torch.isfinite(out).all())
    pipe.close()


def _slice_on_the_card(monkeypatch):
    """The CNN slice's model, scenario and a small input on the card,
    with the numerics every worker is shipped (TF32 off, deterministic
    cuDNN)."""
    from repro_torch.core import scenarios
    from repro_torch.models.cnn import zoo

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    model = zoo.get("mobilenetv2", 10).init(
        torch.Generator().manual_seed(0), "cuda")
    scen = scenarios.get("pi_chain4").with_codec(chip_smoke.CODECS)
    return chip_smoke, model, scen


def _process_stages_case(cuda, monkeypatch, transport):
    """The CNN slice's cuts and codecs over ``transport``: each stage is
    a spawned process with a CUDA context of its own, launches its hops'
    pack and unpack kernels there (counted in that process and sent with
    its STATS flush), and the output equals the emulated pipeline's bit
    for bit.  Closing leaves no live worker."""
    from repro_torch.runtime import EdgePipeline, drain_violations
    chip_smoke, model, scen = _slice_on_the_card(monkeypatch)
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    x = x.to(cuda)
    want, _, _ = EdgePipeline(model, (1, 2, 3), scen,
                              device="cuda").run_one(x)
    drain_violations()
    pipe = EdgePipeline(model, (1, 2, 3), scen, transport=transport,
                        sanitize=True, device="cuda")
    procs = list(pipe._engine._procs)
    with pipe:
        pipe.warmup(x)
        pipe._reset_stats()
        got, _, hops = pipe.run_one(x)
        stats = pipe.stage_stats()
    assert torch.equal(got, want) and all(h > 0 for h in hops)
    assert [s.launches for s in stats] == chip_smoke.hop_launches(
        pipe.codecs)
    assert all(s.device.startswith("cuda") for s in stats)
    assert drain_violations() == []
    assert not any(p.is_alive() for p in procs)


def test_socket_stages_launch_their_hops_kernels_in_their_own_processes(
        cuda, monkeypatch):
    _process_stages_case(cuda, monkeypatch, "socket")


def test_shmem_stages_launch_their_hops_kernels_in_their_own_processes(
        cuda, monkeypatch):
    _process_stages_case(cuda, monkeypatch, "shmem")


def test_supervised_shmem_slice_recovers_a_killed_stage_on_the_card(
        cuda, monkeypatch):
    """Stage 1 SIGKILLed after batch 1 of four: the supervisor rebuilds
    the four CUDA workers, the session replays its unacked batches, and
    the outputs equal the emulated pipeline's bit for bit, in order, with
    one ``restart``; no violation, worker or segment is left."""
    from repro_torch.runtime import (EdgePipeline, FaultPlan,
                                     drain_recoveries, drain_violations)
    _, model, scen = _slice_on_the_card(monkeypatch)
    gen = torch.Generator().manual_seed(2)
    xs = [torch.randn(2, 64, 64, 3, generator=gen).to(cuda)
          for _ in range(4)]
    emu = EdgePipeline(model, (1, 2, 3), scen, device="cuda")
    want = [emu.run_one(x)[0] for x in xs]
    drain_violations()
    drain_recoveries()
    pipe = EdgePipeline(model, (1, 2, 3), scen, transport="shmem",
                        sanitize=True, device="cuda", timeout_s=90.0,
                        stall_timeout_s=45.0,
                        fault_plan=FaultPlan().kill_worker(stage=1,
                                                           at_seq=1))
    procs = list(pipe._engine._procs)
    with pipe:
        pipe.warmup(xs[0])
        with pipe.session() as s:
            for x in xs:
                s.submit(x)
            got = s.drain()
        names = {n for pair in pipe._engine._pairs for end in pair
                 for n in end.segment_names()}
        procs += list(pipe._engine._procs)
    assert len(got) == 4 and all(torch.equal(a, b) for a, b in zip(got, want))
    assert [r.kind for r in drain_recoveries()] == ["restart"]
    assert drain_violations() == []
    assert not any(p.is_alive() for p in procs)
    assert not [n for n in names if Path(f"/dev/shm/{n}").exists()]


def test_chaos_duplicate_on_a_coded_hop_packs_twice_on_the_card(
        cuda, monkeypatch):
    """A frame duplicated on hop 0 (int8) re-sends below the sanitizer
    from stage 0's process, so that batch is packed twice there: stage
    0 launches one ``int8_pack`` more than ``hop_launches``, while stage
    1's receiver drops the duplicate by its wire seq before unpacking
    it.  The outputs equal the emulated pipeline's bit for bit, with no
    recovery and no violation."""
    from repro_torch.runtime import (EdgePipeline, FaultPlan,
                                     drain_recoveries, drain_violations)
    chip_smoke, model, scen = _slice_on_the_card(monkeypatch)
    gen = torch.Generator().manual_seed(3)
    xs = [torch.randn(2, 64, 64, 3, generator=gen).to(cuda)
          for _ in range(3)]
    emu = EdgePipeline(model, (1, 2, 3), scen, device="cuda")
    want = [emu.run_one(x)[0] for x in xs]
    drain_violations()
    drain_recoveries()
    with EdgePipeline(model, (1, 2, 3), scen, transport="shmem",
                      sanitize=True, device="cuda",
                      fault_plan=FaultPlan().duplicate(hop=0,
                                                       at_seq=1)) as pipe:
        pipe.warmup(xs[0])
        pipe._reset_stats()
        with pipe.session() as s:
            for x in xs:
                s.submit(x)
            got = s.drain()
            s.checkpoint(probe=False)
        launches = [st.launches for st in pipe.stage_stats()]
    expect = [{k: v * len(xs) for k, v in w.items()}
              for w in chip_smoke.hop_launches(pipe.codecs)]
    expect[0]["int8_pack"] += 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert launches == expect
    assert drain_recoveries() == [] and drain_violations() == []
