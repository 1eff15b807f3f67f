"""MoE parity between the PyTorch port and the JAX reference.

The port's ``moe_mlp`` (sort and gather) and ``moe_mlp_gshard`` (one-hot
dispatch and combine) are held to the reference's functions of the same
names on numpy-seeded inputs and the reference's own weights, at
``configs.reduced`` shapes (4 experts, top-2, groups of 64), in fp32
within rtol = atol = 2e-4 (the packages sum in other orders), with the
same expert choices and load-balance term: with capacity drops, without
them, at a decode-shaped batch smaller than a group, and with the two
formulations at one group size.  ``_capacity`` must be the reference's
integer for integer; an uneven split into groups must raise in both
packages.  Reduced qwen3-moe-30b-a3b on the ``"gshard"`` formulation is
held to the reference end to end (the sort formulation is held in
``tests/test_torch_lm.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro import configs as RCFG
from repro.models import lm as RL
from repro.models import mlp as RM
from repro.models.common import InitBuilder
from repro_torch import configs
from repro_torch.models import lm, mlp
from repro_torch.models.common import Init, Leaves

from _torch_sharded_ref import StableInit

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "qwen3-moe-30b-a3b"
FORMULATIONS = {"sort": (RM.moe_mlp, mlp.moe_mlp),
                "gshard": (RM.moe_mlp_gshard, mlp.moe_mlp_gshard)}


def _cfgs(**kw):
    return RCFG.reduced(ARCH).replace(**kw), configs.reduced(ARCH).replace(**kw)


def _params(rcfg, seed=0):
    """The reference's moe node (fp32) → (its numpy leaves, the port's
    ``Leaves`` of the same values)."""
    p = RM.moe_params(StableInit(jax.random.PRNGKey(seed), jnp.float32),
                      rcfg, "m")
    p = {k: np.asarray(v) for k, v in p.items()}
    return p, Leaves({k: torch.from_numpy(v.copy()) for k, v in p.items()})


def _x(B, S, D, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, D)).astype(np.float32)


def _ref_top_e(rcfg, p, x, group):
    """The reference's expert choices, by its own first lines of
    ``moe_mlp``: fp32 logits, softmax, ``lax.top_k``."""
    T = x.shape[0] * x.shape[1]
    Tg = min(group, T)
    xg = jnp.asarray(x).reshape(T // Tg, Tg, -1)
    probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", xg, p["router"]), -1)
    return np.asarray(jax.lax.top_k(probs, rcfg.top_k)[1])


@pytest.mark.parametrize("tokens,E,K,cf", [
    (8, 128, 8, 1.25),          # qwen3-moe decode at batch 8: 4
    (4096, 128, 8, 1.25),       # qwen3-moe prefill group: 320
    (128, 128, 8, 1.25),        # the gshard group: 12
    (64, 4, 2, 1.25), (64, 4, 2, 0.5), (2, 4, 2, 1.25),
    (4096, 16, 2, 1.25), (37, 5, 3, 0.7), (1, 16, 2, 1.0)])
def test_capacity_matches_reference(tokens, E, K, cf):
    rcfg, cfg = _cfgs(n_experts=E, top_k=K, capacity_factor=cf)
    c = mlp._capacity(tokens, cfg)
    assert c == RM._capacity(tokens, rcfg)
    assert c >= 4 and c % 4 == 0
    if (tokens, E) == (8, 128):
        assert c == 4
    if (tokens, E) == (4096, 128):
        assert c == 320


# (B, S, capacity_factor, dropped): prefill-shaped in two groups of 64,
# with and without drops; a decode-shaped batch below one group
CASES = {"prefill": (2, 64, 1.25, None), "drops": (2, 64, 0.5, True),
         "no_drops": (2, 64, 8.0, False), "decode": (2, 1, 1.25, False)}


@pytest.mark.parametrize("impl", FORMULATIONS)
@pytest.mark.parametrize("case", CASES)
def test_moe_matches_reference(impl, case):
    B, S, cf, dropped = CASES[case]
    rcfg, cfg = _cfgs(capacity_factor=cf)
    p_np, p = _params(rcfg)
    x = _x(B, S, cfg.d_model)
    ref_fn, fn = FORMULATIONS[impl]
    y_ref, aux_ref = ref_fn(rcfg, p_np, jnp.asarray(x))
    y, aux = fn(cfg, p, torch.from_numpy(x))
    assert y.shape == (B, S, cfg.d_model) and y.dtype == torch.float32
    assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    assert_allclose(float(aux), float(aux_ref), rtol=1e-6)

    group = cfg.moe_group_size if impl == "sort" else cfg.moe_gshard_group
    xg = mlp.groups(torch.from_numpy(x), group)
    r = mlp.route(cfg, p, xg)
    assert r.logits.dtype == torch.float32
    assert np.array_equal(r.top_e.numpy(), _ref_top_e(rcfg, p_np, x, group))
    C = mlp._capacity(xg.shape[1], cfg)
    kept = mlp.gshard_slots(r.top_e, cfg.n_experts, C)[2]
    if dropped is not None:
        assert bool((~kept).any()) == dropped


@pytest.mark.parametrize("seed", [2, 3, 4, 5])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_formulations_agree_at_equal_groups(cf, seed):
    """At one group size both formulations drop the same (t, k) slots —
    those past a running count of the expert's capacity in (t, k) order
    — and agree, in both packages.  A capacity factor above 1 still
    drops where the draw sends more than C of a group's choices to one
    expert; below 1 the experts' E * C slots are fewer than the T * K
    choices, so every draw drops."""
    rcfg, cfg = _cfgs(capacity_factor=cf, moe_group_size=32,
                      moe_gshard_group=32)
    p_np, p = _params(rcfg, seed=seed)
    x = _x(2, 32, cfg.d_model, seed=seed + 1)
    ys = {}
    for impl, (ref_fn, fn) in FORMULATIONS.items():
        y, aux = fn(cfg, p, torch.from_numpy(x))
        y_ref, aux_ref = ref_fn(rcfg, p_np, jnp.asarray(x))
        ys[impl] = (y.numpy(), float(aux), np.asarray(y_ref), float(aux_ref))
    (a, aux_a, ra, raux_a), (b, aux_b, rb, raux_b) = ys.values()
    assert_allclose(a, b, **TOL)
    assert_allclose(ra, rb, **TOL)
    assert aux_a == aux_b and raux_a == raux_b

    r = mlp.route(cfg, p, mlp.groups(torch.from_numpy(x), 32))
    E, C = cfg.n_experts, mlp._capacity(32, cfg)
    kept_sort = mlp.sort_slots(r.top_e, E, C).kept.reshape(r.top_e.shape)
    kept_gshard = mlp.gshard_slots(r.top_e, E, C)[2]
    # the plain loop: each choice is kept while its expert has room
    count = np.zeros((r.top_e.shape[0], E), int)
    loop = np.zeros(r.top_e.shape, bool)
    for g, t, k in np.ndindex(*r.top_e.shape):
        e = int(r.top_e[g, t, k])
        loop[g, t, k] = count[g, e] < C
        count[g, e] += 1
    assert np.array_equal(kept_sort.numpy(), loop)
    assert np.array_equal(kept_gshard.numpy(), loop)
    if cf < 1:
        assert E * C < r.top_e.shape[1] * cfg.top_k and bool((~loop).any())


@pytest.mark.parametrize("impl", FORMULATIONS)
def test_uneven_groups_raise_in_both_packages(impl):
    """96 tokens over groups of 64 (gshard: of 64 too): the reference's
    reshape fails, and the port raises instead of padding."""
    rcfg, cfg = _cfgs(moe_group_size=64, moe_gshard_group=64)
    p_np, p = _params(rcfg)
    x = _x(3, 32, cfg.d_model)
    ref_fn, fn = FORMULATIONS[impl]
    with pytest.raises(TypeError):
        ref_fn(rcfg, p_np, jnp.asarray(x))
    with pytest.raises(ValueError, match="do not split into MoE groups"):
        fn(cfg, p, torch.from_numpy(x))


def test_bf16_moe_keeps_an_fp32_router():
    """A bf16 model draws its router in fp32; the MoE returns the working
    dtype, and stays within bf16's rounding of the fp32 run."""
    cfg = configs.reduced(ARCH).replace(dtype="bfloat16")
    model = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    node = model.layers[0].moe
    assert node.router.dtype == torch.float32
    assert {node.w_gate.dtype, node.w_up.dtype, node.w_down.dtype} \
        == {torch.bfloat16}
    x = torch.from_numpy(_x(2, 64, cfg.d_model)).to(torch.bfloat16)
    p32 = Leaves({k: v.float() for k, v in node.named_parameters()})
    for fn in (mlp.moe_mlp, mlp.moe_mlp_gshard):
        y, aux = fn(cfg, node, x)
        y32, aux32 = fn(cfg, p32, x.float())
        assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
        assert float(aux) == pytest.approx(float(aux32), rel=1e-5)
        scale = float(y32.abs().max())
        assert float((y.float() - y32).abs().max()) < 2e-2 * scale


def test_init_moe_scales():
    """Router std 1/sqrt(D); expert stacks 1/sqrt(E), their first axis,
    as the reference's builder takes fan-in."""
    cfg = configs.reduced(ARCH).replace(n_experts=64)
    leaf = Init(torch.Generator().manual_seed(0), torch.float32, "cpu")
    p = mlp.moe_params(cfg, leaf)
    assert tuple(p["router"].shape) == (cfg.d_model, 64)
    assert abs(float(p["router"].std()) * cfg.d_model ** 0.5 - 1) < 0.05
    for k in ("w_gate", "w_up", "w_down"):
        assert abs(float(p[k].std()) * 64 ** 0.5 - 1) < 0.05


def test_from_reference_keeps_the_router_fp32_in_a_bf16_tree():
    rcfg = RCFG.reduced(ARCH).replace(dtype="bfloat16")
    params = jax.tree.map(np.asarray, RL.build_params(
        rcfg, InitBuilder(jax.random.PRNGKey(3), jnp.bfloat16)))
    model = lm.from_reference(configs.reduced(ARCH).replace(
        dtype="bfloat16"), params, device="cpu")
    for i, layer in enumerate(model.layers):
        assert layer.moe.router.dtype == torch.float32
        assert layer.moe.w_down.dtype == torch.bfloat16
        assert np.array_equal(layer.moe.router.numpy(),
                              params["layers"]["moe"]["router"][i])
        assert np.array_equal(
            layer.moe.w_up.float().numpy(),
            params["layers"]["moe"]["w_up"][i].astype(np.float32))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_gshard_lm_matches_reference(impl):
    """Reduced qwen3-moe-30b-a3b with ``moe_impl="gshard"``: prefill and
    two teacher-forced decode steps, logits and caches."""
    rcfg = RCFG.reduced(ARCH).replace(moe_impl="gshard")
    params = RL.build_params(rcfg, InitBuilder(jax.random.PRNGKey(5),
                                               jnp.float32))
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, rcfg.vocab, (2, 32)).astype(np.int32)
    feed = rng.integers(0, rcfg.vocab, (2, 2, 1)).astype(np.int32)
    cfg = configs.reduced(ARCH).replace(moe_impl="gshard", attn_impl=impl)
    model = lm.from_reference(cfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    ref = RL.forward_prefill(rcfg, params, {"tokens": jnp.asarray(tokens)},
                             34)
    got = lm.forward_prefill(cfg, model, {"tokens": torch.from_numpy(tokens)},
                             34)
    for t in range(3):
        (r_logits, r_cache), (logits, cache) = ref, got
        assert_allclose(logits.numpy(), np.asarray(r_logits), **TOL)
        for k in ("k", "v"):
            assert_allclose(cache[k].numpy(), np.asarray(r_cache[k]), **TOL)
        if t < 2:
            ref = RL.forward_decode(rcfg, params, jnp.asarray(feed[t]),
                                    r_cache)
            got = lm.forward_decode(cfg, model, torch.from_numpy(feed[t]),
                                    cache)
