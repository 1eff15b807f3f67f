"""The CUDA kernels on the card, against their plain versions: the
codec kernels bit for bit, the LM kernels (attention, RMSNorm) within
``tests/test_kernels.py``'s tolerances (2e-5 in fp32, 2e-2 in bf16), the
selective scan within its 1e-4.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports no jax, so it runs on the GPU machine without the repository's
``conftest.py`` (which imports jax):

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_kernels_cuda.py
"""
import math

import pytest
import torch

from repro_torch.core import codecs as C
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(n, cuda):
    g = torch.Generator(device=cuda).manual_seed(n)
    return (torch.randn(n, generator=g, device=cuda) * 3.0,
            # few distinct magnitudes: top-k ties go to the lower index
            torch.randint(-4, 5, (n,), generator=g, device=cuda).float())


@pytest.mark.parametrize("n", [1, 7, 127, 129, 1_000_003])
def test_pack_unpack_kernels_are_bit_exact(n, cuda):
    for x in _inputs(n, cuda):
        for pack in ("int8_pack", "fp8_pack"):
            q, s = getattr(ops, pack)(x)
            q_ref, s_ref = getattr(ref, pack + "_ref")(x)
            assert torch.equal(q.view(torch.uint8), q_ref.view(torch.uint8))
            assert torch.equal(s.view(torch.int32), s_ref.view(torch.int32))
            unpack = pack.replace("pack", "unpack")
            assert torch.equal(getattr(ops, unpack)(q, float(s)),
                               getattr(ref, unpack + "_ref")(q, s))


@pytest.mark.parametrize("n", [1, 7, 127, 129, 1_000_003])
def test_topk_kernel_is_bit_exact(n, cuda):
    for x in _inputs(n, cuda):
        k = math.ceil(n / 8)
        i, v = ops.topk_select(x, k=k)
        i_ref, v_ref = ref.topk_select_ref(x, k=k)
        assert torch.equal(i, i_ref) and torch.equal(v, v_ref)


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
    (2, 333, 333, 4, 2, 64, False),      # S not a multiple of 128
    (1, 77, 300, 4, 2, 128, True),       # causal, S < T, ragged
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


def test_bf16_flash_refuses_head_dim_off_16_bytes(cuda):
    """hd % 8 != 0 in bf16 is refused before anything is launched."""
    x = _randn((1, 8, 2, 12), torch.bfloat16, cuda, 13)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="head_dim % 8"):
        ops.flash_attention(x, x, x)
    assert ops.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("shape", [(8192, 2048), (8, 16, 128), (5, 3),
                                   (2, 33, 128)])
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
