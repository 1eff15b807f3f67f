"""Hybrid (zamba2) serving parity between the PyTorch port and the JAX
reference.

Mamba-2's chunked SSD (``ssm._ssd_chunk``) is held to the reference's
with a nonzero carried-in state, over several chunks and at a ragged
``S`` (one chunk of ``S``), within rtol = atol = 1e-4; ``mamba2_block``
at prefill and one decode step, and reduced zamba2-7b (four Mamba-2
layers, the shared attention block before layers 0 and 2: prefill, then
four teacher-forced decode steps, comparing logits, ``conv``, ``h``,
``ak`` and ``av``), on both port routes: ``attn_impl="pallas"``
(attention and RMSNorm through ``ops``, their plain versions here on the
CPU) and ``"xla"`` (the plain copies of the reference's routes), within
rtol = atol = 2e-4 in fp32, since the two packages sum in other orders.
The SSD itself is plain code on both routes, as in the reference.
Inputs are numpy-seeded; the reference's weights, with the zero/one
initialised leaves perturbed so every leaf takes part, are loaded into
the port with ``lm.from_reference``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro import configs as RCFG
from repro.models import lm as RL
from repro.models import ssm as RS
from repro.models.common import InitBuilder
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import lm, ssm
from repro_torch.models.common import Leaves

torch.set_num_threads(1)

SSD_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "zamba2-7b"
B, S, STEPS = 2, 64, 4
CACHE = ("conv", "h", "ak", "av")


def _ref_params(cfg, seed=3, dtype=jnp.float32):
    """The reference's params, with the zero/one-initialised conv bias,
    dt_bias, D, A_log and gated-norm scale perturbed."""
    params = jax.tree.map(np.asarray, RL.build_params(
        cfg, InitBuilder(jax.random.PRNGKey(seed), dtype)))
    rng = np.random.default_rng(seed)
    m = params["layers"]["mamba"]
    for key, scale in (("conv_b", 0.1), ("dt_bias", 0.5), ("D", 0.3),
                       ("A_log", 0.2), ("norm", 0.2)):
        noise = rng.standard_normal(m[key].shape).astype(np.float32) * scale
        m[key] = (m[key].astype(np.float32) + noise).astype(m[key].dtype)
    return params


# --------------------------------------------------------------------------- #
# the SSD and the block
# --------------------------------------------------------------------------- #
def _ssd_inputs(cfg, S, seed):
    rng = np.random.default_rng(seed)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    dt = np.log1p(np.exp(normal(B, S, H)))                     # softplus'ed
    A = -np.exp(normal(H) * 0.5)
    return (dt, (dt * A).astype(np.float32), normal(B, S, H, P),
            normal(B, S, N), normal(B, S, N), normal(B, H, P, N))


@pytest.mark.parametrize("S", [64, 40, 1], ids=["chunks", "ragged", "one"])
def test_ssd_chunk_matches_reference(S):
    """S = 64: four chunks of 16; S = 40: one chunk of 40; S = 1: one
    step; each from a nonzero state."""
    cfg = configs.reduced(ARCH)
    assert cfg.ssm_chunk == 16
    arrays = _ssd_inputs(cfg, S, seed=S)
    y_ref, h_ref = RS._ssd_chunk(RCFG.reduced(ARCH),
                                 *(jnp.asarray(a) for a in arrays))
    y, h = ssm._ssd_chunk(cfg, *(torch.from_numpy(a) for a in arrays))
    assert y.dtype == h.dtype == torch.float32
    assert_allclose(y.numpy(), np.asarray(y_ref), **SSD_TOL)
    assert_allclose(h.numpy(), np.asarray(h_ref), **SSD_TOL)


def test_ssd_chunking_does_not_change_the_result():
    cfg = configs.reduced(ARCH)
    arrays = [torch.from_numpy(a) for a in _ssd_inputs(cfg, 64, seed=7)]
    chunked = ssm._ssd_chunk(cfg, *arrays)
    whole = ssm._ssd_chunk(cfg.replace(ssm_chunk=64), *arrays)
    for a, b in zip(chunked, whole):
        assert_allclose(a.numpy(), b.numpy(), **SSD_TOL)


@pytest.fixture(scope="module")
def block_case():
    cfg = RCFG.reduced(ARCH)
    p = jax.tree.map(lambda a: a[1], _ref_params(cfg)["layers"]["mamba"])
    rng = np.random.default_rng(4)
    S = 40
    x = rng.standard_normal((B, S + 1, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    out, cache = RS.mamba2_block(cfg, jp, jnp.asarray(x[:, :S]))
    out1, cache1 = RS.mamba2_block(cfg, jp, jnp.asarray(x[:, S:]), cache)
    return dict(p=p, x=x, S=S, steps=[
        (np.asarray(out), np.asarray(cache["conv"]), np.asarray(cache["h"])),
        (np.asarray(out1), np.asarray(cache1["conv"]),
         np.asarray(cache1["h"]))])


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_mamba2_block_prefill_and_decode_match_reference(block_case, impl):
    cfg = configs.reduced(ARCH).replace(attn_impl=impl)
    p = Leaves({k: torch.from_numpy(np.array(v))
                for k, v in block_case["p"].items()})
    x, S = torch.from_numpy(block_case["x"]), block_case["S"]
    out, cache = ssm.mamba2_block(cfg, p, x[:, :S])
    assert cache["conv"].shape == (B, cfg.ssm_conv - 1,
                                   cfg.d_inner + 2 * cfg.ssm_state)
    got = [(out, cache["conv"], cache["h"].clone())]
    out1, cache1 = ssm.mamba2_block(cfg, p, x[:, S:], cache,
                                    h_out=cache["h"])
    assert cache1["h"] is cache["h"]            # the state, in place
    got.append((out1, cache1["conv"], cache1["h"]))
    for step, (mine, exp) in enumerate(zip(got, block_case["steps"])):
        for what, a, b in zip(("out", "conv", "h"), mine, exp):
            assert_allclose(a.numpy(), b, **TOL,
                            err_msg=f"{what} at step {step}")


# --------------------------------------------------------------------------- #
# the whole slice: reduced zamba2-7b
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def reference():
    """The reference's prefill (four chunks of 16) and teacher-forced
    decode, with the shared block's caches sized for the steps."""
    cfg = RCFG.reduced(ARCH)
    assert cfg.n_attn_apps == 2
    params = _ref_params(cfg)
    rng = np.random.default_rng(S)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    cache_len = S + STEPS + 1
    jp = jax.tree.map(jnp.asarray, params)
    logits, cache = RL.forward_prefill(
        cfg, jp, {"tokens": jnp.asarray(tokens)}, cache_len)
    steps = [(np.asarray(logits), *(np.asarray(cache[k]) for k in CACHE))]
    feed = rng.integers(0, cfg.vocab, (STEPS, B, 1)).astype(np.int32)
    for t in range(STEPS):
        logits, cache = RL.forward_decode(cfg, jp, jnp.asarray(feed[t]),
                                          cache)
        steps.append((np.asarray(logits),
                      *(np.asarray(cache[k]) for k in CACHE)))
    return dict(tokens=tokens, feed=feed, steps=steps, params=params,
                cache_len=cache_len)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_prefill_and_decode_match_reference(reference, impl):
    cfg = configs.reduced(ARCH).replace(attn_impl=impl)
    model = lm.from_reference(cfg, reference["params"], device="cpu")
    logits, cache = lm.forward_prefill(
        cfg, model, {"tokens": torch.from_numpy(reference["tokens"])},
        reference["cache_len"])
    assert cache["pos"] == S
    assert cache["h"].shape == (cfg.n_layers, B, cfg.ssm_heads,
                                cfg.ssm_head_dim, cfg.ssm_state)
    assert cache["h"].dtype == torch.float32
    assert cache["ak"].shape == (cfg.n_attn_apps, B, reference["cache_len"],
                                 cfg.n_kv_heads, cfg.hd)
    tensors = {k: cache[k] for k in CACHE}
    # decode updates the cache in place: keep copies of each step's
    got = [(logits, *(cache[k].clone() for k in CACHE))]
    for t in range(STEPS):
        logits, cache = lm.forward_decode(
            cfg, model, torch.from_numpy(reference["feed"][t]), cache)
        assert isinstance(cache["pos"], int) and cache["pos"] == S + t + 1
        assert all(cache[k] is tensors[k] for k in CACHE)
        got.append((logits, *(cache[k].clone() for k in CACHE)))
    for step, (mine, exp) in enumerate(zip(got, reference["steps"])):
        assert mine[0].dtype == torch.float32
        assert mine[0].shape == exp[0].shape == (B, 1, cfg.vocab)
        for what, a, b in zip(("logits", *CACHE), mine, exp):
            assert_allclose(a.numpy(), b, **TOL,
                            err_msg=f"{what} at step {step}")


def test_routes_agree_and_launch_nothing_on_the_cpu(reference):
    cfg = configs.reduced(ARCH)
    model = lm.from_reference(cfg, reference["params"], device="cpu")
    inputs = {"tokens": torch.from_numpy(reference["tokens"])}
    ops.reset_launch_counts()
    a, _ = lm.forward_prefill(cfg.replace(attn_impl="pallas"), model, inputs)
    b, _ = lm.forward_prefill(cfg.replace(attn_impl="xla"), model, inputs)
    assert sum(ops.launch_counts().values()) == 0
    assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_chunked_and_unchunked_prefill_agree(reference, impl):
    """Four chunks of 16 against one chunk of 64: logits and the whole
    cache."""
    cfg = configs.reduced(ARCH).replace(attn_impl=impl)
    model = lm.from_reference(cfg, reference["params"], device="cpu")
    inputs = {"tokens": torch.from_numpy(reference["tokens"])}
    a, ca = lm.forward_prefill(cfg, model, inputs, reference["cache_len"])
    b, cb = lm.forward_prefill(cfg.replace(ssm_chunk=S), model, inputs,
                               reference["cache_len"])
    assert_allclose(a.numpy(), b.numpy(), **TOL)
    for k in CACHE:
        assert_allclose(ca[k].numpy(), cb[k].numpy(), **TOL, err_msg=k)


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
            parts = parts[:1] + parts[2:]          # drop the layer index
        mine[".".join(parts)] = tuple(p.shape)
    assert mine == ref_shapes
    assert "shared.attn.wq" in mine             # one block, no layer axis


def test_bf16_init_keeps_the_reference_dtypes_and_values():
    """Both ways in: the port's own init and the reference's weights.
    A_log is log(linspace(1, 16, H)); it, D and dt_bias stay fp32."""
    cfg = configs.reduced(ARCH).replace(dtype="bfloat16")
    mine = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    params = jax.tree.map(np.asarray, RL.build_params(
        RCFG.reduced(ARCH).replace(dtype="bfloat16"),
        InitBuilder(jax.random.PRNGKey(0), jnp.bfloat16)))
    loaded = lm.from_reference(cfg, params, device="cpu")
    for model in (mine, loaded):
        m = model.layers[2].mamba
        assert m.A_log.dtype == m.D.dtype == m.dt_bias.dtype == torch.float32
        assert m.in_proj.dtype == m.norm.dtype == torch.bfloat16
        assert model.shared.mlp.w_up.dtype == torch.bfloat16
        assert_allclose(m.A_log.numpy(), np.log(np.linspace(
            1.0, 16.0, cfg.ssm_heads, dtype=np.float32)), rtol=1e-6)
    assert torch.equal(mine.layers[0].mamba.D, torch.ones(cfg.ssm_heads))
    assert abs(float(mine.shared.attn.wq.float().std())
               * cfg.d_model ** 0.5 - 1.0) < 0.05


def test_serve_main_runs_zamba2_on_the_cpu(capsys):
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
    out = capsys.readouterr().out
    assert "prefill latency:" in out and "finite=True" in out
