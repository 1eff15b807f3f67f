"""Training parity between the PyTorch port and the JAX reference.

For every family's reduced fp32 config (dense qwen3-1.7b, vlm
phi-3-vision-4.2b, moe qwen3-moe-30b-a3b, ssm falcon-mamba-7b, hybrid
zamba2-7b, encdec whisper-small) the reference's weights are loaded
into the port with ``from_reference`` and both packages take the loss
of one numpy-seeded batch and its gradient: ``jax.value_and_grad`` of
``repro.runtime.steps.loss_fn`` against ``torch.autograd.grad`` of the
port's, every gradient leaf compared through ``lm.reference_tree``.
Then remat on against off, the chunked CE against the dense one, two
``make_train_step`` steps (AdamW, clipping, the cosine schedule;
compression on and off; ``grad_accum=2``) against the reference's new
params, moments, count and metrics, the guard that keeps the kernels
out of autograd, and the ``to_reference`` round trip.

The weights are the reference's ``build_params`` tree drawn by numpy
from a seed (``_SeededInit``), the same on every run.

Tolerances (fp32; the two packages sum in other orders): the loss
within rtol 1e-5, and each step's metrics, against the reference's step
from the port's own state, within rtol 1e-5 (with compression the
gradient norm within 1e-4: a level flip moves it by a few 1e-5); a
gradient leaf within rtol 1e-5 plus 1e-5 of its largest magnitude;
and the output of ``forward_train`` alike; after the steps, parameters within 1e-5 absolute
(1e-2 of the largest step, lr 1e-3: Adam's step of an element carries
its gradient's relative error) but for at most 1e-3 of a leaf's
elements, within the two steps' learning rates (those whose gradient is
near eps, or with compression on a level boundary), and the moments
within rtol 1e-4 plus 1e-5 of the leaf's largest magnitude.
"""
import math
import zlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro import configs as RCFG
from repro.models import lm as RL
from repro.models.common import InitBuilder
from repro.optim import CompressionConfig as RComp
from repro.optim import OptConfig as ROpt
from repro.optim import cosine_schedule as rcosine
from repro.optim import init_error_state as rinit_err
from repro.optim import init_opt_state as rinit_opt
from repro.runtime import steps as RS
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.optim import CompressionConfig, OptConfig, cosine_schedule
from repro_torch.runtime import steps

torch.set_num_threads(1)

FAMILIES = {"dense": "qwen3-1.7b", "vlm": "phi-3-vision-4.2b",
            "moe": "qwen3-moe-30b-a3b", "ssm": "falcon-mamba-7b",
            "hybrid": "zamba2-7b", "encdec": "whisper-small"}
B, S = 2, 32
LOSS_TOL = dict(rtol=1e-5, atol=0)
# Adam divides each gradient element by its own running magnitude, so
# an element moves by the learning rate (at most 1e-3 here) times its
# gradient's relative error, which is 1e-6-1e-5 but for the elements
# near eps (1e-8)
PARAM_ATOL = 1e-5


def _batch(cfg, seed=0) -> dict:
    """One training batch from numpy: the reference's keys and shapes."""
    rng = np.random.default_rng(seed)
    n_tok = S - (cfg.n_patches if cfg.family == "vlm" else 0)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, n_tok)).astype(np.int32),
           "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["img"] = (rng.standard_normal((B, cfg.n_patches, cfg.d_model))
                      * 0.02).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = (rng.standard_normal((B, cfg.enc_frames, cfg.d_model))
                         * 0.02).astype(np.float32)
    return out


class _SeededInit(InitBuilder):
    """The reference's ``InitBuilder`` with each leaf drawn by numpy
    from the seed and a CRC of the leaf's path, in place of a key folded
    with ``hash(path)``, which Python salts per process: the same
    weights on every run."""

    def __init__(self, seed, dtype):
        super().__init__(jax.random.PRNGKey(seed), dtype)
        self.seed = seed

    def leaf(self, path, shape, axes, *, init="normal", scale=None,
             dtype=None):
        crc = zlib.crc32(repr(path).encode())
        dtype = dtype or self.dtype
        if callable(init):
            return init(jax.random.fold_in(self.key, crc & 0x7FFFFFFF),
                        shape, dtype)
        if init != "normal":
            return super().leaf(path, shape, axes, init=init, dtype=dtype)
        if scale is None:
            scale = 1.0 / math.sqrt(max(shape[0] if len(shape) >= 2
                                        else shape[-1], 1))
        draw = np.random.default_rng([self.seed, crc]).standard_normal(shape)
        return jnp.asarray((draw * scale).astype(np.float32)).astype(dtype)


def _params(cfg, seed=3, dtype=jnp.float32):
    return jax.tree.map(np.asarray,
                        RL.build_params(cfg, _SeededInit(seed, dtype)))


def _ref_loss_and_grads(cfg, params, batch):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: RS.loss_fn(cfg, p, b), has_aux=True))
    (loss, parts), g = fn(jax.tree.map(jnp.asarray, params),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), jax.tree.map(np.asarray, g)


def _port_loss_and_grads(cfg, params, batch, remat=None):
    cfg_t = configs.reduced(cfg.name.removesuffix("-reduced"))
    cfg_t = cfg_t.replace(ce_chunk=cfg.ce_chunk,
                          remat=cfg.remat if remat is None else remat)
    model = lm.from_reference(cfg_t, params, "cpu").requires_grad_(True)
    names, ps = zip(*model.named_parameters())
    loss, _ = steps.loss_fn(cfg_t, model,
                            {k: torch.from_numpy(v) for k, v in batch.items()})
    g = torch.autograd.grad(loss, ps, materialize_grads=True)
    return loss.item(), dict(zip(names, g))


def _assert_tree_close(mine: dict, ref: dict, rtol, frac, what, atol=0.0,
                       flips=None):
    """Every leaf within ``rtol`` plus ``atol`` plus ``frac`` of the
    reference leaf's largest magnitude; the same paths and shapes.  With
    ``flips = (share, bound, bound_frac)`` that share of a leaf's elements may lie
    beyond the tolerance, none further than ``bound`` (absolute, plus
    ``bound_frac`` of the leaf's largest magnitude: see the compressed
    step)."""
    flat_m = jax.tree_util.tree_flatten_with_path(mine)[0]
    flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in flat_m] == [p for p, _ in flat_r], what
    for (path, a), (_, b) in zip(flat_m, flat_r):
        b = np.asarray(b)
        where = f"{what} {jax.tree_util.keystr(path)}"
        assert a.shape == b.shape, where
        top = float(np.abs(b).max()) if b.size else 0.0
        tol = atol + frac * top
        if flips is None:
            assert_allclose(a, b, rtol=rtol, atol=tol, err_msg=where)
            continue
        share, bound, bound_frac = flips
        diff = np.abs(a - b)
        assert np.mean(diff > tol + rtol * np.abs(b)) <= share, where
        assert diff.max() <= bound + bound_frac * top, where


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    name = FAMILIES[request.param]
    cfg = RCFG.reduced(name)
    params = _params(cfg)
    batch = _batch(cfg)
    loss, grads = _ref_loss_and_grads(cfg, params, batch)
    return dict(name=name, cfg=cfg, params=params, batch=batch, loss=loss,
                grads=grads)


def test_loss_and_every_gradient_match_reference(family):
    cfg = family["cfg"]
    loss, grads = _port_loss_and_grads(cfg, family["params"], family["batch"])
    assert_allclose(loss, family["loss"], **LOSS_TOL)
    _assert_tree_close(lm.reference_tree(grads), family["grads"], 1e-5, 1e-5,
                       "grad")


def test_forward_train_matches_reference(family):
    """``lm.forward_train``'s full-sequence fp32 logits and aux against
    the reference's, within rtol 1e-5 plus 1e-5 of the largest logit."""
    cfg = family["cfg"]
    cfg_t = configs.reduced(family["name"])
    r_logits, r_aux = jax.jit(lambda p, b: RL.forward_train(cfg, p, b))(
        jax.tree.map(jnp.asarray, family["params"]),
        {k: jnp.asarray(v) for k, v in family["batch"].items()
         if k != "targets"})
    r_logits = np.asarray(r_logits)
    model = lm.from_reference(cfg_t, family["params"], "cpu")
    with torch.no_grad():
        logits, aux = lm.forward_train(cfg_t, model, {
            k: torch.from_numpy(v) for k, v in family["batch"].items()
            if k != "targets"})
    assert logits.dtype == torch.float32
    assert_allclose(logits.numpy(), r_logits, rtol=1e-5,
                    atol=1e-5 * float(np.abs(r_logits).max()))
    assert_allclose(aux.item(), float(r_aux), rtol=1e-5, atol=1e-7)


def test_remat_is_the_same_function(family):
    """Recomputing each layer in the backward pass gives the same loss
    and gradients, bit for bit (the same ops run on the same inputs)."""
    cfg = family["cfg"]
    a_loss, a = _port_loss_and_grads(cfg, family["params"], family["batch"],
                                     remat=False)
    b_loss, b = _port_loss_and_grads(cfg, family["params"], family["batch"],
                                     remat=True)
    assert a_loss == b_loss
    for name in a:
        assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("name", ["qwen3-1.7b", "whisper-small"])
def test_chunked_ce_matches_dense_and_reference(name):
    """ce_chunk 8 over S = 32 takes four rematerialised chunks; ce_chunk
    0 the dense logits; both equal the reference's chunked loss."""
    cfg = RCFG.reduced(name).replace(ce_chunk=8)
    params, batch = _params(cfg), _batch(cfg)
    ref_loss, ref_grads = _ref_loss_and_grads(cfg, params, batch)
    loss, grads = _port_loss_and_grads(cfg, params, batch)
    dense_loss, dense = _port_loss_and_grads(cfg.replace(ce_chunk=0), params,
                                             batch)
    assert_allclose(loss, ref_loss, **LOSS_TOL)
    assert_allclose(loss, dense_loss, **LOSS_TOL)
    _assert_tree_close(lm.reference_tree(grads), ref_grads, 1e-5, 1e-5,
                       "chunked grad")
    _assert_tree_close(lm.reference_tree(grads), lm.reference_tree(dense),
                       1e-5, 1e-5, "chunked vs dense grad")


# --------------------------------------------------------------------------- #
# make_train_step
# --------------------------------------------------------------------------- #
STEP_CASES = {"plain": (False, 1), "compressed": (True, 1),
              "grad_accum": (False, 2)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_steps_match_reference(case):
    compress, accum = STEP_CASES[case]
    cfg = RCFG.reduced("qwen3-1.7b")
    params = _params(cfg)
    batches = [_batch(cfg, seed) for seed in (0, 1)]

    r_opt = ROpt(lr=rcosine(1e-3, 2, 10))
    r_comp = RComp(enabled=compress)
    r_step = jax.jit(RS.make_train_step(cfg, r_opt, r_comp, grad_accum=accum))
    jparams = jax.tree.map(jnp.asarray, params)
    r_state = {"params": jparams, "opt": rinit_opt(jparams),
               "step": jnp.zeros((), jnp.int32)}
    if compress:
        r_state["err"] = rinit_err(jparams)
    r_metrics = []
    for b in batches:
        r_state, m = r_step(r_state, {k: jnp.asarray(v) for k, v in b.items()})
        r_metrics.append({k: float(v) for k, v in m.items()})
    r_state = jax.tree.map(np.asarray, r_state)

    cfg_t = configs.reduced("qwen3-1.7b")
    comp = CompressionConfig(enabled=compress)
    state = steps.state_from_reference(cfg_t, {
        "params": params,
        "opt": {"m": jax.tree.map(np.zeros_like, params),
                "v": jax.tree.map(np.zeros_like, params),
                "count": np.zeros((), np.int32)},
        "step": np.zeros((), np.int32),
        **({"err": jax.tree.map(np.zeros_like, params)} if compress else {})},
        "cpu")
    step = steps.make_train_step(cfg_t, OptConfig(lr=cosine_schedule(1e-3, 2,
                                                                     10)),
                                 comp, grad_accum=accum)
    metrics, r_metrics_here = [], []
    for b in batches:
        # the reference's step from the port's own state: each step's
        # metrics are compared on the same parameters (after a step the
        # two packages' parameters differ by the flips bounded below,
        # which move the next gradient norm by more than its rounding)
        here = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)),
                            steps.reference_state(state))
        r_metrics_here.append({k: float(v) for k, v in r_step(
            here, {k: jnp.asarray(v) for k, v in b.items()})[1].items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert all(isinstance(v, torch.Tensor) for v in m.values())
        metrics.append({k: v.item() for k, v in m.items()})

    assert_allclose(r_metrics_here[0]["loss"], r_metrics[0]["loss"], rtol=0)
    for mine, ref in zip(metrics, r_metrics_here):
        assert mine.keys() == ref.keys()
        for k in ref:
            # with compression the norm is the dequantized gradients': an
            # element within the packages' rounding of a level boundary
            # takes the next level in one of them, a quantum (1/127 of its
            # leaf's largest magnitude), which moves the norm by up to a
            # few 1e-5 of itself
            rtol = 1e-4 if compress and k == "grad_norm" else 1e-5
            assert_allclose(mine[k], ref[k], rtol=rtol, atol=1e-7, err_msg=k)
    mine = steps.reference_state(state)
    assert int(mine["step"]) == int(r_state["step"]) == 2
    assert int(mine["opt"]["count"]) == int(r_state["opt"]["count"]) == 2
    # a gradient element near eps (its absolute error, about 1e-6 of the
    # leaf's largest gradient, is then a large share of it) and, with
    # compression, one within the packages' rounding of a level boundary
    # (it takes the next level in one of them) make a few elements a
    # leaf (at most 1e-3 of it) move by up to the two steps' learning
    # rates (1.5e-3); with compression such an element's m and v differ
    # by up to a quantum (1/127 of the leaf's largest magnitude)
    _assert_tree_close(mine["params"], r_state["params"], 0, 0, "params",
                       atol=PARAM_ATOL, flips=(1e-3, 1.5e-3, 0.0))
    flips = (1e-3, 0.0, 0.05) if compress else None
    for k in ("m", "v"):
        _assert_tree_close(mine["opt"][k], r_state["opt"][k], 1e-4, 1e-5, k,
                           flips=flips)
    if compress:
        # the residual g - deq keeps g's absolute error, up to 1e-6 of the
        # leaf's largest gradient: 127 · 2e-6 of the largest residual
        # (half a quantum); a flip moves it by a quantum
        _assert_tree_close(mine["err"], r_state["err"], 0, 1e-3, "err",
                           flips=(1e-3, 0.0, 2.5))


# --------------------------------------------------------------------------- #
# The kernels stay out of autograd
# --------------------------------------------------------------------------- #
def _lm_wrapper_calls(requires_grad: bool) -> dict:
    g = torch.Generator().manual_seed(0)

    def t(*shape):
        return torch.randn(*shape, generator=g).requires_grad_(requires_grad)

    B_, L, di, N = 1, 4, 8, 2
    return {
        "flash_attention": lambda: ops.flash_attention(t(1, 4, 2, 16),
                                                       t(1, 4, 2, 16),
                                                       t(1, 4, 2, 16)),
        "decode_attention": lambda: ops.decode_attention(
            t(1, 2, 16), t(1, 4, 2, 16), t(1, 4, 2, 16), 2),
        "fused_rmsnorm": lambda: ops.fused_rmsnorm(t(3, 16), t(16)),
        "ssm_scan_chunk": lambda: ops.ssm_scan_chunk(
            t(B_, L, di).abs(), t(B_, L, di), t(B_, L, N), t(B_, L, N),
            -t(di, N).abs(), t(B_, di, N)),
        "mamba1_scan_chunk": lambda: ops.mamba1_scan_chunk(
            t(B_, L, di), t(di), t(B_, L, di), t(B_, L, di), t(B_, L, N),
            t(B_, L, N), -t(di, N).abs(), t(di), t(B_, di, N)),
    }


@pytest.mark.parametrize("name", list(_lm_wrapper_calls(False)))
def test_lm_kernel_wrappers_refuse_autograd(name):
    """On the CPU too: a wrapper given an input that requires grad,
    with autograd on, raises and names the plain route; under no_grad,
    or with frozen inputs, it runs."""
    with pytest.raises(RuntimeError, match="attn_impl='xla'"):
        _lm_wrapper_calls(True)[name]()
    with torch.no_grad():
        _lm_wrapper_calls(True)[name]()
    _lm_wrapper_calls(False)[name]()


@pytest.mark.parametrize("fam", ["dense", "ssm", "encdec"])
def test_training_on_the_kernel_route_raises(fam):
    """A train step of a config that asks for the kernels raises before
    any update (the plain route is the training route); serving that
    model afterwards still runs the kernel route, and no step moved the
    launch counts."""
    cfg = configs.reduced(FAMILIES[fam])
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    before = {n: p.detach().clone()
              for n, p in state["model"].named_parameters()}
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="has no backward"):
        steps.make_train_step(cfg.replace(attn_impl="pallas"),
                              OptConfig())(state, batch)
    for n, p in state["model"].named_parameters():
        assert torch.equal(p, before[n]), n
    state, m = steps.make_train_step(cfg, OptConfig())(state, batch)
    assert torch.isfinite(m["loss"])
    inputs = {k: v for k, v in batch.items() if k != "targets"}
    logits, _ = lm.forward_prefill(cfg.replace(attn_impl="pallas"),
                                   state["model"], inputs)
    assert torch.isfinite(logits).all()
    assert sum(ops.launch_counts().values()) == 0


# --------------------------------------------------------------------------- #
# to_reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_to_reference_round_trip(fam, dtype):
    """``from_reference(to_reference(m))`` is ``m`` leaf for leaf, in
    order and bit for bit (bf16 through its ``|V2`` bits), and
    ``to_reference`` of the reference's own tree gives that tree back
    with its keys, shapes and dtypes (bf16 as the bits of ``ml_dtypes``'
    bfloat16)."""
    cfg = configs.reduced(FAMILIES[fam]).replace(dtype=dtype)
    model = lm.init(cfg, torch.Generator().manual_seed(1), "cpu")
    back = lm.from_reference(cfg, lm.to_reference(model), "cpu")
    mine, theirs = list(model.named_parameters()), list(back.named_parameters())
    assert [n for n, _ in mine] == [n for n, _ in theirs]
    for (n, a), (_, b) in zip(mine, theirs):
        assert a.dtype == b.dtype and torch.equal(a, b), n

    rcfg = RCFG.reduced(FAMILIES[fam]).replace(dtype=dtype)
    ref = _params(rcfg, dtype=getattr(jnp, dtype))
    again = lm.to_reference(lm.from_reference(cfg, ref, "cpu"))
    flat_a = jax.tree_util.tree_flatten_with_path(again)[0]
    flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_r]
    for (path, a), (_, r) in zip(flat_a, flat_r):
        if r.dtype == ml_dtypes.bfloat16:
            assert a.dtype == np.dtype("V2"), path
            r = r.view(np.uint16)
            a = a.view(np.uint16)
        assert a.dtype == r.dtype and a.shape == r.shape, path
        np.testing.assert_array_equal(a, r, err_msg=str(path))
