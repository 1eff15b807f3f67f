"""Mamba-1 serving parity between the PyTorch port and the JAX reference.

The port's selective scan (``ops.ssm_scan_chunk``: on the CPU the plain
version of the CUDA kernel in ``csrc/ssm_scan.cu``) is held to the
reference's Pallas kernel in interpret mode at ``tests/test_kernels.py``'s
sweep shapes, at L = 1 and chained, within that file's 1e-4.  The gated
scan (``ops.mamba1_scan_chunk``: raw dt, softplus, D-skip and gate around
the same kernel) is held to that Pallas kernel wrapped in the reference
model's own prologue and epilogue, fp32 and bf16, within 1e-4 (fp32; the
state in both) and one bf16 ulp (bf16 y).  The blocks
(``causal_conv``, ``mamba1_block``) and reduced falcon-mamba-7b (prefill,
then four teacher-forced decode steps) are held to the reference on both
port routes, ``attn_impl="pallas"`` (the scan chunk by chunk through
``ops``) and ``"xla"`` (the plain copy of the reference's associative
scan), in fp32 within rtol = atol = 2e-4: the two packages sum in other
orders.  Inputs are numpy-seeded; the reference's weights are loaded into
the port with ``lm.from_reference``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro import configs as RCFG
from repro.kernels import ops as rops
from repro.models import lm as RL
from repro.models import ssm as RS
from repro.models import common as RC
from repro.models.common import InitBuilder
from repro_torch import configs
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import ssm_scan as kssm
from repro_torch.launch import serve
from repro_torch.models import lm, ssm
from repro_torch.models.common import Init, Leaves, silu, softplus

torch.set_num_threads(1)

SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "falcon-mamba-7b"
B, STEPS = 2, 4


def _scan_inputs(B, L, di, N, seed=0):
    """The reference sweep's distributions: softplus'ed dt, negative A."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    dt = np.log1p(np.exp(normal(B, L, di)))
    A = -np.exp(normal(di, N) * 0.5)
    return dt, normal(B, L, di), normal(B, L, N), normal(B, L, N), A, \
        normal(B, di, N)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# --------------------------------------------------------------------------- #
# the kernel module, against the Pallas kernel in interpret mode
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("B_,L,di,N,bd", [
    (2, 64, 128, 16, 64),
    (1, 32, 256, 8, 128),
    (2, 16, 64, 16, 64),
    (2, 1, 128, 16, 64),             # the decode step
])
def test_scan_matches_pallas(B_, L, di, N, bd):
    arrays = _scan_inputs(B_, L, di, N, seed=L)
    ye, he = rops.ssm_scan_chunk(*map(jnp.asarray, arrays), block_d=bd,
                                 interpret=True)
    y, h = ops.ssm_scan_chunk(*_torch(*arrays))
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B_, L, di) and h.shape == (B_, di, N)
    assert_allclose(y.numpy(), np.asarray(ye), **SCAN_TOL)
    assert_allclose(h.numpy(), np.asarray(he), **SCAN_TOL)


def test_scan_chunk_chaining_matches_long_pallas_scan():
    """Two chained chunks, the second reading and writing its state in
    place (``h_out`` is ``h0``), equal one long Pallas scan."""
    L = 32
    dt, x, Bc, Cc, A, _ = _scan_inputs(2, 2 * L, 64, 8, seed=1)
    h0 = np.zeros((2, 64, 8), np.float32)
    ye, he = rops.ssm_scan_chunk(*map(jnp.asarray, (dt, x, Bc, Cc, A, h0)),
                                 block_d=64, interpret=True)
    tdt, tx, tB, tC, tA, th = _torch(dt, x, Bc, Cc, A, h0)
    y = torch.empty(2, 2 * L, 64)
    _, h1 = ops.ssm_scan_chunk(tdt[:, :L], tx[:, :L], tB[:, :L], tC[:, :L],
                               tA, th, y=y[:, :L])
    _, h2 = ops.ssm_scan_chunk(tdt[:, L:], tx[:, L:], tB[:, L:], tC[:, L:],
                               tA, h1, y=y[:, L:], h_out=h1)
    assert h2 is h1 and not th.any()
    assert_allclose(y.numpy(), np.asarray(ye), **SCAN_TOL)
    assert_allclose(h2.numpy(), np.asarray(he), **SCAN_TOL)


def test_plain_scan_reads_bf16_inputs_as_fp32():
    dt, x, Bc, Cc, A, h0 = _torch(*_scan_inputs(1, 8, 16, 8, seed=2))
    bf = [t.to(torch.bfloat16) for t in (x, Bc, Cc)]
    y, h = ops.ssm_scan_chunk(dt, *bf, A, h0)
    ye, he = ref.ssm_scan_chunk_ref(dt, *(t.float() for t in bf), A, h0)
    assert y.dtype == torch.float32
    assert torch.equal(y, ye) and torch.equal(h, he)


def _capture_launch(monkeypatch):
    """Stand in for the CUDA launch (there is no GPU here) and skip the
    device check, so the wrapper's Python side runs on CPU tensors."""
    calls = []
    monkeypatch.setattr(kssm, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_build.SSM_SCAN, "launch",
                        lambda fn, dev, *args: calls.append(args))
    return calls


def test_kernel_wrapper_passes_views_without_copies(monkeypatch):
    """Chunk views of (B, S, .) tensors and the B/C column slices of one
    projection reach the kernel as pointers and strides, not copies."""
    calls = _capture_launch(monkeypatch)
    Bn, S, di, N, R = 2, 12, 16, 8, 4
    dt, x = torch.rand(Bn, S, di), torch.randn(Bn, S, di)
    proj = torch.randn(Bn, S, R + 2 * N)
    A, h = -torch.rand(di, N), torch.zeros(Bn, di, N)
    y = torch.empty(Bn, S, di)
    c = slice(4, 8)
    Bc, Cc = proj[:, c, R:R + N], proj[:, c, R + N:]
    out_y, out_h = kssm.ssm_scan_chunk(dt[:, c], x[:, c], Bc, Cc, A, h,
                                       y=y[:, c], h_out=h)
    assert out_h is h and out_y.data_ptr() == y[:, c].data_ptr()
    (args,) = calls
    ptrs = [p.value for p in args[:8]]
    assert ptrs == [t.data_ptr() for t in (dt[:, c], x[:, c], Bc, Cc, A, h,
                                           y[:, c], h)]
    assert args[8:12] == (Bn, 4, di, N)
    assert args[12:22] == (S * di, di, S * di, di, S * (R + 2 * N),
                           R + 2 * N, S * (R + 2 * N), R + 2 * N, S * di, di)
    assert args[22] == _build.DTYPE_CODES[torch.float32]


@pytest.mark.parametrize("bad, match", [
    (dict(N=4), "N=4 has no compiled instance"),
    (dict(dt_dtype=torch.bfloat16), "dt, A and h0 must be fp32"),
    (dict(x_dtype=torch.float16), "must share one dtype"),
])
def test_kernel_wrapper_refuses_what_it_has_no_instance_for(monkeypatch, bad,
                                                            match):
    calls = _capture_launch(monkeypatch)
    N = bad.get("N", 8)
    dt = torch.rand(1, 4, 8, dtype=bad.get("dt_dtype", torch.float32))
    x = torch.randn(1, 4, 8).to(bad.get("x_dtype", torch.float32))
    Bc = Cc = torch.randn(1, 4, N)
    with pytest.raises((ValueError, TypeError), match=match):
        kssm.ssm_scan_chunk(dt, x, Bc, Cc, -torch.rand(8, N),
                            torch.zeros(1, 8, N))
    assert not calls


# --------------------------------------------------------------------------- #
# the gated scan: raw dt, the D-skip and the gate folded into the chunk
# --------------------------------------------------------------------------- #
# y in the working dtype: fp32 held at the scan's 1e-4, bf16 at one bf16
# ulp; the state is fp32 either way
GATED_TOL = {"float32": SCAN_TOL, "bfloat16": dict(rtol=1e-2, atol=1e-2)}


def _gated_inputs(B, L, di, N, seed=0):
    """Raw dt, dt_bias, x, z, B, C (the working-dtype operands), then A
    (negative), D and h0 (fp32): ``ops.mamba1_scan_chunk``'s order."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return (normal(B, L, di), normal(di, scale=0.5), normal(B, L, di),
            normal(B, L, di), normal(B, L, N), normal(B, L, N),
            -np.exp(normal(di, N, scale=0.5)), normal(di), normal(B, di, N))


def _reference_gated(arrays, dtype, block_d):
    """The reference's own prologue and epilogue around its Pallas kernel
    in interpret mode (``src/repro/models/ssm.py:82-83`` and
    ``:111-112``)."""
    f32 = jnp.float32
    dt, bias, x, z, Bc, Cc = (jnp.asarray(a).astype(dtype)
                              for a in arrays[:6])
    A, D, h0 = map(jnp.asarray, arrays[6:])
    dt = RC.softplus(dt.astype(f32) + bias.astype(f32))
    y, h = rops.ssm_scan_chunk(dt, x, Bc, Cc, A, h0, block_d=block_d,
                               interpret=True)
    y = y + x.astype(f32) * D
    y = (y * RC.silu(z).astype(f32)).astype(x.dtype)
    return np.asarray(y.astype(f32)), np.asarray(h)


def _port_gated(arrays, dtype):
    tdt = getattr(torch, dtype)
    t = _torch(*arrays)
    return [a.to(tdt) for a in t[:6]] + t[6:]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B_,L,di,N,bd", [
    (2, 16, 64, 16, 64),
    (2, 1, 128, 16, 64),             # the decode step
    (1, 32, 128, 8, 128),
    (2, 1, 64, 8, 64),
])
def test_gated_scan_matches_reference_around_pallas(B_, L, di, N, bd, dtype):
    arrays = _gated_inputs(B_, L, di, N, seed=L + N)
    ye, he = _reference_gated(arrays, getattr(jnp, dtype), bd)
    y, h = ops.mamba1_scan_chunk(*_port_gated(arrays, dtype))
    assert y.dtype == getattr(torch, dtype) and h.dtype == torch.float32
    assert y.shape == (B_, L, di) and h.shape == (B_, di, N)
    assert_allclose(y.float().numpy(), ye, **GATED_TOL[dtype])
    assert_allclose(h.numpy(), he, **SCAN_TOL)


def test_gated_scan_plain_version_is_the_model_route():
    """The plain version is the plain route's pieces in its order: the
    model's softplus, the scan, the D-skip, the model's silu."""
    args = _port_gated(_gated_inputs(2, 8, 16, 8, seed=5), "bfloat16")
    dt, bias, x, z, Bc, Cc, A, D, h0 = args
    y, h = ref.mamba1_scan_chunk_ref(*args)
    ys, hs = ref.ssm_scan_chunk_ref(softplus(dt.float() + bias.float()), x,
                                    Bc, Cc, A, h0)
    assert torch.equal(h, hs)
    assert torch.equal(y, ((ys + x.float() * D) * silu(z).float()).to(
        torch.bfloat16))


def test_gated_wrapper_passes_views_without_copies(monkeypatch):
    """z as the second half of the in_proj output, B/C as column slices
    of one projection, chunk views of the bf16 output buffer and the
    state in place reach the kernel as pointers and strides."""
    calls = _capture_launch(monkeypatch)
    Bn, S, di, N, R = 2, 12, 16, 8, 4
    bf = torch.bfloat16
    dt = torch.randn(Bn, S, di).to(bf)
    xz = torch.randn(Bn, S, 2 * di).to(bf)
    x, z = xz[..., :di], xz[..., di:]
    proj = torch.randn(Bn, S, R + 2 * N).to(bf)
    bias, D = torch.randn(di).to(bf), torch.randn(di)
    A, h = -torch.rand(di, N), torch.zeros(Bn, di, N)
    y = torch.empty(Bn, S, di, dtype=bf)
    c = slice(4, 8)
    Bc, Cc = proj[:, c, R:R + N], proj[:, c, R + N:]
    out_y, out_h = kssm.mamba1_scan_chunk(dt[:, c], bias, x[:, c], z[:, c],
                                          Bc, Cc, A, D, h, y=y[:, c],
                                          h_out=h)
    assert out_h is h and out_y.data_ptr() == y[:, c].data_ptr()
    (args,) = calls
    ptrs = [p.value for p in args[:11]]
    assert ptrs == [t.data_ptr() for t in (dt[:, c], bias, x[:, c], z[:, c],
                                           Bc, Cc, A, D, h, y[:, c], h)]
    assert args[11:15] == (Bn, 4, di, N)
    assert args[15:27] == (S * di, di, 2 * S * di, 2 * di, 2 * S * di,
                           2 * di, S * (R + 2 * N), R + 2 * N,
                           S * (R + 2 * N), R + 2 * N, S * di, di)
    assert args[27] == _build.DTYPE_CODES[bf]


@pytest.mark.parametrize("bad, match", [
    (dict(N=4), "N=4 has no compiled instance"),
    (dict(bias_dtype=torch.float32), "dt, dt_bias and z must be x's dtype"),
    (dict(D_dtype=torch.bfloat16), "A, D and h0 must be fp32"),
    (dict(z_len=3), "shapes do not match"),
    (dict(y_dtype=torch.float32), "y must be torch.bfloat16"),
])
def test_gated_wrapper_refuses_what_it_has_no_instance_for(monkeypatch, bad,
                                                           match):
    calls = _capture_launch(monkeypatch)
    N, bf = bad.get("N", 8), torch.bfloat16
    dt = x = torch.randn(1, 4, 8).to(bf)
    z = torch.randn(1, bad.get("z_len", 4), 8).to(bf)
    Bc = Cc = torch.randn(1, 4, N).to(bf)
    bias = torch.randn(8).to(bad.get("bias_dtype", bf))
    D = torch.randn(8).to(bad.get("D_dtype", torch.float32))
    y = torch.empty(1, 4, 8, dtype=bad.get("y_dtype", bf))
    with pytest.raises((ValueError, TypeError), match=match):
        kssm.mamba1_scan_chunk(dt, bias, x, z, Bc, Cc, -torch.rand(8, N), D,
                               torch.zeros(1, 8, N), y=y)
    assert not calls


def test_pallas_route_scans_each_chunk_through_the_gated_wrapper(
        monkeypatch):
    """Reduced falcon-mamba, prompt of four chunks: the "pallas" route
    calls ``ops.mamba1_scan_chunk`` once a chunk a layer at prefill and
    once a layer a decode step, each time on raw dt, and never the
    ungated scan; the "xla" route calls neither."""
    cfg = configs.reduced(ARCH)
    model = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    S = 4 * cfg.ssm_chunk
    tokens = torch.randint(0, cfg.vocab, (B, S),
                           generator=torch.Generator().manual_seed(1))
    calls = {"mamba1_scan_chunk": [], "ssm_scan_chunk": []}
    for name in calls:
        real = getattr(ops, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls[_name].append(args[0].dtype)
            return _real(*args, **kw)
        monkeypatch.setattr(ops, name, spy)
    for impl, per_layer in (("pallas", 4), ("xla", 0)):
        for got in calls.values():
            got.clear()
        c = cfg.replace(attn_impl=impl)
        _, cache = lm.forward_prefill(c, model, {"tokens": tokens})
        lm.forward_decode(c, model, tokens[:, :1], cache)
        assert len(calls["mamba1_scan_chunk"]) == \
            cfg.n_layers * (per_layer + (impl == "pallas"))
        assert not calls["ssm_scan_chunk"]


# --------------------------------------------------------------------------- #
# blocks
# --------------------------------------------------------------------------- #
def test_softplus_is_jax_softplus():
    """Equal to rounding; XLA flushes the subnormal results (x near -88)
    to zero, hence the atol of one subnormal range."""
    x = np.concatenate([np.linspace(-40, 40, 2001),
                        [-1e4, -88.0, 0.0, 20.0, 30.0, 1e4]])
    x = x.astype(np.float32)
    assert_allclose(softplus(torch.from_numpy(x)).numpy(),
                    np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6,
                    atol=np.finfo(np.float32).tiny)


@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("S", [1, 9])
def test_causal_conv_matches_reference(with_carry, S):
    rng = np.random.default_rng(3)
    Bn, C, K = 2, 12, 4
    x = rng.standard_normal((Bn, S, C)).astype(np.float32)
    w = rng.standard_normal((C, K)).astype(np.float32)
    b = rng.standard_normal((C,)).astype(np.float32)
    carry = rng.standard_normal((Bn, K - 1, C)).astype(np.float32) \
        if with_carry else None
    ye, ce = RS.causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            None if carry is None else jnp.asarray(carry))
    y, c = ssm.causal_conv(*_torch(x, w, b),
                           None if carry is None else _torch(carry)[0])
    assert y.is_contiguous() and y.shape == (Bn, S, C)
    assert_allclose(y.numpy(), np.asarray(ye), rtol=1e-5, atol=1e-5)
    assert_allclose(c.numpy(), np.asarray(ce), rtol=0, atol=0)


def _ref_params(cfg, seed=3, dtype=jnp.float32):
    """The reference's params, with the zero/one-initialised biases, D and
    A_log perturbed so every leaf takes part."""
    params = jax.tree.map(np.asarray, RL.build_params(
        cfg, InitBuilder(jax.random.PRNGKey(seed), dtype)))
    rng = np.random.default_rng(seed)
    m = params["layers"]["mamba"]
    for key, scale in (("conv_b", 0.1), ("dt_bias", 0.5), ("D", 0.3),
                       ("A_log", 0.2)):
        noise = rng.standard_normal(m[key].shape).astype(np.float32) * scale
        m[key] = (m[key].astype(np.float32) + noise).astype(m[key].dtype)
    return params


@pytest.fixture(scope="module")
def block_case():
    cfg = RCFG.reduced(ARCH)
    params = _ref_params(cfg)
    p = jax.tree.map(lambda a: a[0], params["layers"]["mamba"])
    rng = np.random.default_rng(4)
    S = 40
    x = rng.standard_normal((B, S + 1, cfg.d_model)).astype(np.float32)
    out, cache = RS.mamba1_block(cfg, jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x[:, :S]))
    out1, cache1 = RS.mamba1_block(cfg, jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x[:, S:]), cache)
    return dict(p=p, x=x, S=S, steps=[
        (np.asarray(out), np.asarray(cache["conv"]), np.asarray(cache["h"])),
        (np.asarray(out1), np.asarray(cache1["conv"]),
         np.asarray(cache1["h"]))])


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_mamba1_block_prefill_and_decode_match_reference(block_case, impl):
    cfg = configs.reduced(ARCH).replace(attn_impl=impl)
    p = Leaves({k: torch.from_numpy(np.array(v))
                for k, v in block_case["p"].items()})
    x, S = torch.from_numpy(block_case["x"]), block_case["S"]
    ops.reset_launch_counts()
    out, cache = ssm.mamba1_block(cfg, p, x[:, :S])
    got = [(out, cache["conv"], cache["h"].clone())]
    out1, cache1 = ssm.mamba1_block(cfg, p, x[:, S:], cache,
                                    h_out=cache["h"])
    assert cache1["h"] is cache["h"]            # the state, in place
    got.append((out1, cache1["conv"], cache1["h"]))
    for step, (mine, exp) in enumerate(zip(got, block_case["steps"])):
        for what, a, b in zip(("out", "conv", "h"), mine, exp):
            assert_allclose(a.numpy(), b, **TOL,
                            err_msg=f"{what} at step {step}")
    assert ops.launch_counts()["ssm_scan_chunk"] == 0
    assert ops.launch_counts()["mamba1_scan_chunk"] == 0


# --------------------------------------------------------------------------- #
# the whole slice: reduced falcon-mamba-7b
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module", params=[64, 40], ids=["S64", "S40"])
def reference(request):
    """The reference's prefill and teacher-forced decode: S = 64 is four
    chunks of 16, S = 40 one chunk of 40."""
    S = request.param
    cfg = RCFG.reduced(ARCH)
    assert cfg.ssm_chunk == 16
    params = _ref_params(cfg)
    rng = np.random.default_rng(S)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, params)
    logits, cache = RL.forward_prefill(cfg, jp, {"tokens": jnp.asarray(
        tokens)})
    steps = [(np.asarray(logits), np.asarray(cache["conv"]),
              np.asarray(cache["h"]))]
    feed = rng.integers(0, cfg.vocab, (STEPS, B, 1)).astype(np.int32)
    for t in range(STEPS):
        logits, cache = RL.forward_decode(cfg, jp, jnp.asarray(feed[t]),
                                          cache)
        steps.append((np.asarray(logits), np.asarray(cache["conv"]),
                      np.asarray(cache["h"])))
    return dict(S=S, tokens=tokens, feed=feed, steps=steps, params=params)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_prefill_and_decode_match_reference(reference, impl):
    cfg = configs.reduced(ARCH).replace(attn_impl=impl)
    model = lm.from_reference(cfg, reference["params"], device="cpu")
    S = reference["S"]
    logits, cache = lm.forward_prefill(
        cfg, model, {"tokens": torch.from_numpy(reference["tokens"])})
    assert cache["pos"] == S
    assert cache["conv"].shape == (cfg.n_layers, B, cfg.ssm_conv - 1,
                                   cfg.d_inner)
    assert cache["h"].shape == (cfg.n_layers, B, cfg.d_inner, cfg.ssm_state)
    assert cache["h"].dtype == torch.float32
    # decode updates the cache in place: keep copies of each step's
    got = [(logits, cache["conv"].clone(), cache["h"].clone())]
    for t in range(STEPS):
        logits, cache = lm.forward_decode(
            cfg, model, torch.from_numpy(reference["feed"][t]), cache)
        assert isinstance(cache["pos"], int) and cache["pos"] == S + t + 1
        got.append((logits, cache["conv"].clone(), cache["h"].clone()))
    for step, (mine, exp) in enumerate(zip(got, reference["steps"])):
        assert mine[0].dtype == torch.float32
        assert mine[0].shape == exp[0].shape == (B, 1, cfg.vocab)
        for what, a, b in zip(("logits", "conv", "h"), mine, exp):
            assert_allclose(a.numpy(), b, **TOL,
                            err_msg=f"{what} at step {step}")


def test_both_routes_agree_and_launch_nothing_on_the_cpu(reference):
    cfg = configs.reduced(ARCH)
    model = lm.from_reference(cfg, reference["params"], device="cpu")
    inputs = {"tokens": torch.from_numpy(reference["tokens"])}
    ops.reset_launch_counts()
    a, _ = lm.forward_prefill(cfg.replace(attn_impl="pallas"), model, inputs)
    b, _ = lm.forward_prefill(cfg.replace(attn_impl="xla"), model, inputs)
    assert sum(ops.launch_counts().values()) == 0
    assert_allclose(a.numpy(), b.numpy(), **TOL)


# --------------------------------------------------------------------------- #
# parameters, init, entry point
# --------------------------------------------------------------------------- #
def test_param_count_and_tree_match_reference():
    cfg = configs.reduced(ARCH)
    model = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert model.param_count() == cfg.param_count() \
        == RCFG.reduced(ARCH).param_count()
    ref_tree = RL.build_params(RCFG.reduced(ARCH),
                               InitBuilder(jax.random.PRNGKey(0),
                                           jnp.float32))
    ref_shapes = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref_tree)[0]:
        keys = [p.key for p in path]
        shape = leaf.shape[1:] if keys[0] == "layers" else leaf.shape
        ref_shapes[".".join(keys)] = tuple(shape)
    mine = {}
    for key, p in model.named_parameters():
        parts = key.split(".")
        if parts[0] == "layers":
            parts = parts[:1] + parts[2:]
        mine[".".join(parts)] = tuple(p.shape)
    assert mine == ref_shapes


def test_bf16_model_keeps_a_log_and_d_in_fp32():
    """Both ways in: the port's own init and the reference's weights."""
    cfg = configs.reduced(ARCH).replace(dtype="bfloat16")
    mine = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    params = jax.tree.map(np.asarray, RL.build_params(
        RCFG.reduced(ARCH).replace(dtype="bfloat16"),
        InitBuilder(jax.random.PRNGKey(0), jnp.bfloat16)))
    loaded = lm.from_reference(cfg, params, device="cpu")
    for model in (mine, loaded):
        m = model.layers[1].mamba
        assert m.A_log.dtype == m.D.dtype == torch.float32
        assert m.in_proj.dtype == m.dt_bias.dtype == torch.bfloat16
        assert model.embed.table.dtype == torch.bfloat16
    a_log = torch.log(torch.arange(1, cfg.ssm_state + 1, dtype=torch.float32))
    assert torch.equal(mine.layers[0].mamba.A_log,
                       a_log.repeat(cfg.d_inner, 1))
    assert torch.equal(loaded.layers[0].mamba.A_log,
                       torch.from_numpy(np.array(
                           params["layers"]["mamba"]["A_log"][0])))


def test_init_takes_a_leaf_dtype_and_a_callable():
    leaf = Init(torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
    assert leaf((3,), "ones", dtype=torch.float32).dtype == torch.float32
    assert leaf((2, 3)).dtype == torch.bfloat16
    made = leaf((2, 3), lambda shape, dtype, device:
                torch.full(shape, 7.0, dtype=dtype, device=device))
    assert made.dtype == torch.bfloat16 and bool((made == 7).all())


def test_serve_main_runs_falcon_mamba_on_the_cpu(capsys):
    ops.reset_launch_counts()
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "40",
                      "--new-tokens", "3"])
    for key in ("prefill_ms", "prefill_tok_s", "decode_ms_per_token",
                "decode_tok_s"):
        assert np.isfinite(res[key]) and res[key] > 0
    assert tuple(res["tokens"].shape) == (2, 3) and res["valid"]
    assert res["device"] == "cpu"
    assert sum(ops.launch_counts().values()) == 0
    assert "prefill latency:" in capsys.readouterr().out
