"""LM serving parity between the PyTorch port and the JAX reference.

For reduced qwen3-1.7b (qk_norm, GQA, tied head), starcoder2-3b and
starcoder2-7b (GELU, untied head, no qk_norm), granite-20b (MQA: one KV
head), phi-3-vision-4.2b (vlm image prefix) and the two MoE archs,
qwen3-moe-30b-a3b and phi3.5-moe-42b-a6.6b (the sort formulation, fp32
router, groups of 64; the prompt is two groups, a decode step less
than one), the reference's weights are loaded into the port with ``from_reference`` and
both packages prefill the same numpy-seeded prompt, then take four
teacher-forced decode steps on the same tokens.  The port runs both of
its routes: ``attn_impl="pallas"`` (the kernels' plain versions here on
the CPU) and ``"xla"`` (its copies of the reference's plain routes); the
reference has only the latter.  Tolerance: rtol = atol = 2e-4 in fp32,
since the two packages sum in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro import configs as RCFG
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.models import lm as RL
from repro.models.common import InitBuilder
from repro_torch import configs
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import lm

torch.set_num_threads(1)

ARCHS = ["qwen3-1.7b", "starcoder2-3b", "phi-3-vision-4.2b", "granite-20b",
         "starcoder2-7b", "qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b"]
TOL = dict(rtol=2e-4, atol=2e-4)
B, S, STEPS = 2, 64, 4


def _inputs(cfg, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    n_tok = S - (cfg.n_patches if cfg.family == "vlm" else 0)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, n_tok)).astype(np.int32)}
    if cfg.family == "vlm":
        out["img"] = (rng.standard_normal((B, cfg.n_patches, cfg.d_model))
                      * 0.02).astype(np.float32)
    return out


@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    """The reference's prefill and teacher-forced decode on one arch."""
    name = request.param
    cfg = RCFG.reduced(name)
    params = RL.build_params(cfg, InitBuilder(jax.random.PRNGKey(3),
                                              jnp.float32))
    inputs = _inputs(cfg)
    cache_len = S + STEPS + 1
    logits, cache = RL.forward_prefill(
        cfg, params, {k: jnp.asarray(v) for k, v in inputs.items()},
        cache_len)
    steps = [(np.asarray(logits), np.asarray(cache["k"]),
              np.asarray(cache["v"]))]
    feed = np.random.default_rng(1).integers(
        0, cfg.vocab, (STEPS, B, 1)).astype(np.int32)
    for t in range(STEPS):
        logits, cache = RL.forward_decode(cfg, params, jnp.asarray(feed[t]),
                                          cache)
        steps.append((np.asarray(logits), np.asarray(cache["k"]),
                      np.asarray(cache["v"])))
    return dict(name=name, cfg=cfg, cache_len=cache_len, inputs=inputs,
                feed=feed, steps=steps,
                params=jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_prefill_and_decode_match_reference(reference, impl):
    cfg = configs.reduced(reference["name"]).replace(attn_impl=impl)
    model = lm.from_reference(cfg, reference["params"], device="cpu")
    inputs = {k: torch.from_numpy(v) for k, v in reference["inputs"].items()}
    logits, cache = lm.forward_prefill(cfg, model, inputs,
                                       reference["cache_len"])
    assert cache["pos"] == S
    # decode writes the cache in place: keep copies of each step's
    got = [(logits, cache["k"].clone(), cache["v"].clone())]
    for t in range(STEPS):
        logits, cache = lm.forward_decode(
            cfg, model, torch.from_numpy(reference["feed"][t]), cache)
        assert isinstance(cache["pos"], int) and cache["pos"] == S + t + 1
        got.append((logits, cache["k"].clone(), cache["v"].clone()))
    for step, (mine, ref) in enumerate(zip(got, reference["steps"])):
        assert mine[0].dtype == torch.float32
        assert mine[0].shape == ref[0].shape == (B, 1, cfg.vocab)
        for what, a, b in zip(("logits", "k", "v"), mine, ref):
            assert_allclose(a.numpy(), b, **TOL,
                            err_msg=f"{what} at step {step}")


def test_port_runs_the_kernels_only_on_the_pallas_route(reference):
    """On the CPU no kernel launches (the plain versions are uncounted),
    and the two routes agree with each other."""
    cfg = configs.reduced(reference["name"])
    model = lm.from_reference(cfg, reference["params"], device="cpu")
    inputs = {k: torch.from_numpy(v) for k, v in reference["inputs"].items()}
    ops.reset_launch_counts()
    a, _ = lm.forward_prefill(cfg.replace(attn_impl="pallas"), model, inputs)
    b, _ = lm.forward_prefill(cfg.replace(attn_impl="xla"), model, inputs)
    assert sum(ops.launch_counts().values()) == 0
    assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_param_count_and_tree_match_reference(name):
    cfg = configs.reduced(name)
    model = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert model.param_count() == cfg.param_count() \
        == RCFG.reduced(name).param_count()
    ref = RL.build_params(RCFG.reduced(name),
                          InitBuilder(jax.random.PRNGKey(0), jnp.float32))
    ref_shapes = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
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


@pytest.mark.parametrize("name", ARCHS)
def test_init_draws_the_reference_scales(name):
    """Random init: reference shapes, dtype from the config, norms at
    one, embedding std 0.02, projections std 1/sqrt(fan_in)."""
    cfg = configs.reduced(name)
    model = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert torch.equal(model.final_norm.scale, torch.ones(cfg.d_model))
    assert abs(float(model.embed.table.std()) - 0.02) < 0.002
    wq = model.layers[0].attn.wq
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    again = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    ffn = "moe" if cfg.family == "moe" else "mlp"
    assert torch.equal(getattr(again.layers[1], ffn).w_up,
                       getattr(model.layers[1], ffn).w_up)


def test_unknown_family_raises():
    cfg = configs.reduced("qwen3-1.7b").replace(family="rnn")
    with pytest.raises(NotImplementedError, match="unknown family 'rnn'"):
        lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    model = lm.init(configs.reduced("qwen3-1.7b"),
                    torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="unknown family"):
        lm.forward_prefill(cfg, model, {"tokens": torch.zeros(
            (1, 4), dtype=torch.int32)})


def test_configs_are_the_reference_configs():
    assert configs.ARCH_NAMES == RCFG.ARCH_NAMES
    for name in configs.ARCH_NAMES:
        for get in ("get", "reduced"):
            mine = getattr(configs, get)(name)
            ref = getattr(RCFG, get)(name)
            assert vars(mine) == vars(ref)
            assert mine.param_count() == ref.param_count()


@pytest.mark.parametrize("name", ["qwen3-1.7b", "phi-3-vision-4.2b"])
def test_synthetic_data_has_the_reference_layout(name):
    cfg = configs.reduced(name)
    mine = SyntheticLM(cfg, DataConfig(2, 24, seed=5), "cpu").batch_at(3)
    ref = RSyntheticLM(RCFG.reduced(name), RDataConfig(2, 24, 5)).batch_at(3)
    assert sorted(mine) == sorted(ref)
    for key in ref:
        assert tuple(mine[key].shape) == tuple(ref[key].shape)
        assert str(mine[key].dtype).split(".")[-1] == str(ref[key].dtype)
    if cfg.family != "vlm":
        assert torch.equal(mine["targets"][:, :-1], mine["tokens"][:, 1:])
    assert int(mine["tokens"].max()) < cfg.vocab
    again = SyntheticLM(cfg, DataConfig(2, 24, seed=5), "cpu").batch_at(3)
    assert all(torch.equal(mine[k], again[k]) for k in mine)
    other = SyntheticLM(cfg, DataConfig(2, 24, seed=5), "cpu").batch_at(4)
    assert not torch.equal(mine["tokens"], other["tokens"])


@pytest.mark.parametrize("name", ARCHS)
def test_serve_main_runs_on_the_cpu(name, capsys):
    res = serve.main(["--arch", name, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "16",
                      "--new-tokens", "3"])
    for key in ("prefill_ms", "prefill_tok_s", "decode_ms_per_token",
                "decode_tok_s"):
        assert np.isfinite(res[key]) and res[key] > 0
    assert tuple(res["tokens"].shape) == (2, 3) and res["valid"]
    assert res["device"] == "cpu"
    out = capsys.readouterr().out
    assert "prefill latency:" in out and "ms/token" in out


def test_serve_asks_for_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "qwen3-1.7b", "--reduced"])
