"""Enc-dec (whisper) serving parity between the PyTorch port and the JAX
reference.

For reduced whisper-small (two encoder and two decoder layers, 24 stub
frames) the reference's weights, with every layer norm's scale and bias
perturbed so both take part, are loaded into the port with
``lm.from_reference``.  Held to the reference on both port routes,
``attn_impl="pallas"`` (attention through ``ops``, its plain versions
here on the CPU) and ``"xla"`` (the plain copies of the reference's
routes): ``attn_mlp_block``'s layer-norm variant with and without its
MLP; ``encode``; prefill, then four teacher-forced decode steps,
comparing logits, ``k``, ``v``, ``ck`` and ``cv``.  Layer norms are
plain on both routes (the reference has no kernel for them).  Inputs are
numpy-seeded; rtol = atol = 2e-4 in fp32, since the two packages sum in
other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro import configs as RCFG
from repro.models import lm as RL
from repro.models.common import InitBuilder
from repro_torch import configs
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.common import Leaves

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "whisper-small"
B, S, STEPS = 2, 40, 4
CACHE = ("k", "v", "ck", "cv")


def _ref_params(cfg, seed=3, dtype=jnp.float32):
    """The reference's params with every norm's scale and bias (ones and
    zeros at init) perturbed."""
    params = jax.tree.map(np.asarray, RL.build_params(
        cfg, InitBuilder(jax.random.PRNGKey(seed), dtype)))
    rng = np.random.default_rng(seed)

    def perturb(node):
        for key, v in node.items():
            if isinstance(v, dict):
                perturb(v)
            elif key in ("scale", "bias"):
                noise = rng.standard_normal(v.shape).astype(np.float32)
                node[key] = (v.astype(np.float32) + 0.2 * noise).astype(
                    v.dtype)
    perturb(params)
    return params


def _inputs(cfg, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "frames": (rng.standard_normal((B, cfg.enc_frames, cfg.d_model))
                       * 0.02).astype(np.float32)}


@pytest.fixture(scope="module")
def reference():
    cfg = RCFG.reduced(ARCH)
    params = _ref_params(cfg)
    inputs = _inputs(cfg)
    jp = jax.tree.map(jnp.asarray, params)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    cache_len = S + STEPS + 1
    enc = RL.encode(cfg, jp, jin["frames"])
    logits, cache = RL.forward_prefill(cfg, jp, jin, cache_len)
    steps = [(np.asarray(logits), *(np.asarray(cache[k]) for k in CACHE))]
    feed = np.random.default_rng(1).integers(
        0, cfg.vocab, (STEPS, B, 1)).astype(np.int32)
    for t in range(STEPS):
        logits, cache = RL.forward_decode(cfg, jp, jnp.asarray(feed[t]),
                                          cache)
        steps.append((np.asarray(logits),
                      *(np.asarray(cache[k]) for k in CACHE)))
    return dict(params=params, inputs=inputs, enc=np.asarray(enc),
                feed=feed, steps=steps, cache_len=cache_len)


def _model(reference, impl):
    cfg = configs.reduced(ARCH).replace(attn_impl=impl)
    return cfg, lm.from_reference(cfg, reference["params"], device="cpu")


@pytest.mark.parametrize("with_mlp", [True, False], ids=["mlp", "no-mlp"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_layer_norm_block_matches_reference(reference, impl, with_mlp):
    """The block with layer norms (an encoder layer's weights), causal,
    with its MLP and, as the decoder's self-attention half, without."""
    cfg, model = _model(reference, impl)
    p = jax.tree.map(lambda a: a[0], reference["params"]["enc_layers"])
    if not with_mlp:
        p = {"ln1": p["ln1"], "attn": p["attn"]}
    x = np.random.default_rng(5).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    exp, (k, v) = RL._attn_mlp_block(
        RCFG.reduced(ARCH), jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        jnp.arange(S), bias_norm=True)
    got, (gk, gv) = lm.attn_mlp_block(
        cfg, model.enc_layers[0], torch.from_numpy(x), torch.arange(S),
        bias_norm=True, with_mlp=with_mlp)
    for what, a, b in (("x", got, exp), ("k", gk, k), ("v", gv, v)):
        assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=what)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_encode_matches_reference(reference, impl):
    cfg, model = _model(reference, impl)
    enc = lm.encode(cfg, model,
                    torch.from_numpy(reference["inputs"]["frames"]))
    assert enc.shape == (B, cfg.enc_frames, cfg.d_model)
    assert_allclose(enc.numpy(), reference["enc"], **TOL)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_prefill_and_decode_match_reference(reference, impl):
    cfg, model = _model(reference, impl)
    inputs = {k: torch.from_numpy(v) for k, v in reference["inputs"].items()}
    logits, cache = lm.forward_prefill(cfg, model, inputs,
                                       reference["cache_len"])
    assert cache["pos"] == S
    assert cache["k"].shape == (cfg.n_layers, B, reference["cache_len"],
                                cfg.n_kv_heads, cfg.hd)
    assert cache["ck"].shape == (cfg.n_layers, B, cfg.enc_frames,
                                 cfg.n_kv_heads, cfg.hd)
    tensors = {k: cache[k] for k in CACHE}
    # decode writes k/v in place: keep copies of each step's
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
    cfg, model = _model(reference, "pallas")
    inputs = {k: torch.from_numpy(v) for k, v in reference["inputs"].items()}
    ops.reset_launch_counts()
    a, _ = lm.forward_prefill(cfg, model, inputs)
    b, _ = lm.forward_prefill(cfg.replace(attn_impl="xla"), model, inputs)
    assert sum(ops.launch_counts().values()) == 0
    assert_allclose(a.numpy(), b.numpy(), **TOL)


# --------------------------------------------------------------------------- #
# parameters, init, data, entry point
# --------------------------------------------------------------------------- #
def test_param_count_and_tree_match_reference():
    """The port's tree is the reference's, leaf for leaf.  The
    reference's analytic ``param_count`` (copied unchanged into the
    port's config) counts a scale but no bias for each layer norm: 2 an
    encoder layer, 3 a decoder layer and the two final norms, so its
    own tree holds that many d_model vectors more."""
    cfg = configs.reduced(ARCH)
    model = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    ref_tree = RL.build_params(RCFG.reduced(ARCH),
                               InitBuilder(jax.random.PRNGKey(0),
                                           jnp.float32))
    n_ref = sum(leaf.size for leaf in jax.tree.leaves(ref_tree))
    biases = (2 * cfg.n_enc_layers + 3 * cfg.n_layers + 2) * cfg.d_model
    assert model.param_count() == n_ref \
        == RCFG.reduced(ARCH).param_count() + biases
    assert cfg.param_count() == RCFG.reduced(ARCH).param_count()
    stacks = ("enc_layers", "dec_layers")
    ref_shapes = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref_tree)[0]:
        keys = [p.key for p in path]
        shape = leaf.shape[1:] if keys[0] in stacks else leaf.shape
        ref_shapes[".".join(keys)] = tuple(shape)
    mine = {}
    for key, p in model.named_parameters():
        parts = key.split(".")
        if parts[0] in stacks:
            parts = parts[:1] + parts[2:]          # drop the layer index
        mine[".".join(parts)] = tuple(p.shape)
    assert mine == ref_shapes
    assert len(model.enc_layers) == cfg.n_enc_layers
    assert len(model.dec_layers) == cfg.n_layers


def test_init_norms_have_biases_and_the_head_is_tied():
    cfg = configs.reduced(ARCH).replace(dtype="bfloat16")
    model = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert model.lm_head is None and cfg.tie_embeddings
    for node in (model.final_norm, model.enc_final_norm,
                 model.dec_layers[1].ln_x, model.enc_layers[0].ln2):
        assert torch.equal(node.scale, torch.ones(cfg.d_model,
                                                  dtype=torch.bfloat16))
        assert torch.equal(node.bias, torch.zeros(cfg.d_model,
                                                  dtype=torch.bfloat16))
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert isinstance(model.dec_layers[0].xattn, Leaves)
    assert not hasattr(model.dec_layers[0].mlp, "w_gate")   # GELU MLP


def test_synthetic_data_carries_the_stub_frames():
    cfg = configs.reduced(ARCH)
    batch = SyntheticLM(cfg, DataConfig(2, 24, seed=5), "cpu").batch_at(0)
    assert tuple(batch["frames"].shape) == (2, cfg.enc_frames, cfg.d_model)
    assert batch["frames"].dtype == torch.float32
    assert tuple(batch["tokens"].shape) == (2, 24)


def test_serve_main_runs_whisper_on_the_cpu(capsys):
    ops.reset_launch_counts()
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "16",
                      "--new-tokens", "3"])
    for key in ("prefill_ms", "prefill_tok_s", "decode_ms_per_token",
                "decode_tok_s"):
        assert np.isfinite(res[key]) and res[key] > 0
    assert tuple(res["tokens"].shape) == (2, 3) and res["valid"]
    assert res["device"] == "cpu"
    assert sum(ops.launch_counts().values()) == 0
    out = capsys.readouterr().out
    assert "prefill latency:" in out and "finite=True" in out
