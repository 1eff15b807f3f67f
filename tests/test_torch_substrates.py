"""Substrates of the port's training path against the JAX reference:
the optimizer, gradient compression, data resume and checkpoints
(mirrors ``tests/test_substrates.py``).

The port's AdamW and compression take the same numpy-seeded tensors as
the reference's and must give the same numbers (fp32 elementwise
arithmetic in the same order: within 1e-6 relative, the compression's
levels equal).  Checkpoints cross between the packages both ways, the
files holding the same members byte for byte, and a bf16 checkpoint of
the reference restores in the port bit for bit, which the reference's
own restore cannot do.
"""
import json
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro import configs as RCFG
from repro.checkpoint import load_checkpoint as rload
from repro.checkpoint import save_checkpoint as rsave
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.optim import CompressionConfig as RComp
from repro.optim import OptConfig as ROpt
from repro.optim import apply_gradients as rapply
from repro.optim import compress_gradients as rcompress
from repro.optim import init_opt_state as rinit_opt
from repro.optim.compress import compressed_bytes as rcompressed_bytes
from repro.runtime import steps as RS
from repro_torch import configs
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    save_checkpoint)
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import lm
from repro_torch.optim import (CompressionConfig, OptConfig, apply_gradients,
                               compress_gradients, compressed_bytes,
                               cosine_schedule, init_error_state,
                               init_opt_state)
from repro_torch.runtime import steps

torch.set_num_threads(1)


def _t(a):
    return {k: torch.from_numpy(np.array(v)) for k, v in a.items()}


# --------------------------------------------------------------------------- #
# Optimizer
# --------------------------------------------------------------------------- #
def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    state = init_opt_state(params)
    cfg = OptConfig(lr=0.2, weight_decay=0.0, clip_norm=0.0)
    for _ in range(200):
        g = {"w": 2 * params["w"]}
        state, _ = apply_gradients(params, g, state, cfg)
    assert float(params["w"].abs().max()) < 1e-2
    assert int(state["count"]) == 200


def test_grad_clip_caps_update():
    params = {"w": torch.zeros(4)}
    state = init_opt_state(params)
    cfg = OptConfig(lr=1.0, clip_norm=1.0, weight_decay=0.0)
    _, m = apply_gradients(params, {"w": torch.full((4,), 100.0)}, state, cfg)
    assert float(m["grad_norm"]) == pytest.approx(200.0)
    # the clipped gradient is 0.5 an element: m = 0.05, v = 0.0125
    assert_allclose(state["m"]["w"].numpy(), 0.05, rtol=1e-6)


def test_cosine_schedule_shape():
    fn = cosine_schedule(1e-3, warmup=10, total=100, floor=0.1)

    def at(step):
        return float(fn(torch.tensor(step, dtype=torch.int32)))
    assert at(0) == 0.0
    assert at(10) == pytest.approx(1e-3)
    assert at(100) == pytest.approx(1e-4, rel=1e-2)
    assert at(5) == pytest.approx(5e-4)


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adamw_steps_match_reference(wd):
    """Five steps on the same numpy gradients: a matrix, a vector and a
    stacked block's vector (``layers.0.ln.scale``, which the reference
    holds as one (L, d) leaf and so decays), clipped, with the cosine
    schedule: params and moments within 1e-6 relative."""
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 3), "b": (3,), "layers": (2, 5)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]

    r_cfg = ROpt(lr=lambda c: 1e-2 * jnp.minimum(1.0, c / 2.0),
                 weight_decay=wd, clip_norm=2.0)
    r_p = {k: jnp.asarray(v) for k, v in p0.items()}
    r_state = rinit_opt(r_p)
    for g in grads:
        r_p, r_state, r_m = rapply(r_p, {k: jnp.asarray(v) for k, v in
                                         g.items()}, r_state, r_cfg)

    def named(tree):
        out = {"w": tree["w"], "b": tree["b"]}
        out.update({f"layers.{i}.ln.scale": tree["layers"][i]
                    for i in range(2)})
        return out

    cfg = OptConfig(lr=lambda c: 1e-2 * torch.clamp_max(c / 2.0, 1.0),
                    weight_decay=wd, clip_norm=2.0)
    p = _t(named(p0))
    state = init_opt_state(p)
    for g in grads:
        state, m = apply_gradients(p, _t(named(g)), state, cfg)
    ref_p = named({k: np.asarray(v) for k, v in r_p.items()})
    for k in p:
        assert_allclose(p[k].numpy(), ref_p[k], rtol=1e-6, atol=1e-7,
                        err_msg=k)
        for mom in ("m", "v"):
            ref = named({n: np.asarray(v) for n, v in
                         r_state[mom].items()})[k]
            assert_allclose(state[mom][k].numpy(), ref, rtol=1e-6,
                            atol=1e-9, err_msg=f"{mom} {k}")
    assert_allclose(float(m["grad_norm"]), float(r_m["grad_norm"]),
                    rtol=1e-6)
    assert_allclose(float(m["lr"]), float(r_m["lr"]), rtol=1e-7)


# --------------------------------------------------------------------------- #
# Gradient compression (error feedback)
# --------------------------------------------------------------------------- #
def test_compression_matches_reference():
    """Three rounds of error feedback on the same numpy gradients (a
    stacked block pair shares its leaf's one scale): the dequantized
    gradients and the carried error within 1e-6 of a quantum of the
    reference's, the levels equal."""
    rng = np.random.default_rng(1)
    shapes = {"w": (6, 5), "layers": (3, 7)}
    cfg, r_cfg = CompressionConfig(enabled=True), RComp(enabled=True)

    def named(tree):
        out = {"w": tree["w"]}
        out.update({f"layers.{i}.x": tree["layers"][i] for i in range(3)})
        return out

    r_err = {k: jnp.zeros(s) for k, s in shapes.items()}
    err = init_error_state(_t(named({k: np.zeros(s, np.float32)
                                     for k, s in shapes.items()})))
    for _ in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        r_deq, r_err = rcompress({k: jnp.asarray(v) for k, v in g.items()},
                                 r_err, r_cfg)
        deq, err = compress_gradients(_t(named(g)), err, cfg)
        ref_deq = named({k: np.asarray(v) for k, v in r_deq.items()})
        ref_err = named({k: np.asarray(v) for k, v in r_err.items()})
        for k in deq:
            quantum = float(np.abs(ref_deq[k]).max()) / 127
            assert_allclose(deq[k].numpy(), ref_deq[k], rtol=0,
                            atol=1e-6 * quantum, err_msg=k)
            assert_allclose(err[k].numpy(), ref_err[k], rtol=0,
                            atol=1e-6 * quantum, err_msg=k)
    assert compress_gradients(_t(named(g)), err, CompressionConfig()) \
        [1] is err


@pytest.mark.parametrize("seed", range(10))
def test_error_feedback_is_lossless_in_sum(seed):
    """Σ_t (compressed_t) + err_T == Σ_t raw_t — error feedback never
    loses mass, only delays it."""
    gen = torch.Generator().manual_seed(seed)
    cfg = CompressionConfig(enabled=True)
    g_sum = np.zeros(16, np.float64)
    c_sum = np.zeros(16, np.float64)
    err = {"w": torch.zeros(16)}
    for _ in range(5):
        g = {"w": torch.randn(16, generator=gen)}
        g_sum += g["w"].double().numpy()
        cg, err = compress_gradients(g, err, cfg)
        c_sum += cg["w"].double().numpy()
    assert_allclose(c_sum + err["w"].double().numpy(), g_sum, rtol=1e-5,
                    atol=1e-5)


def test_compressed_training_converges():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_opt_state(params)
    err = init_error_state(params)
    ccfg = CompressionConfig(enabled=True)
    ocfg = OptConfig(lr=0.2, weight_decay=0.0, clip_norm=0.0)
    for _ in range(300):
        g, err = compress_gradients({"w": 2 * params["w"]}, err, ccfg)
        state, _ = apply_gradients(params, g, state, ocfg)
    assert float(params["w"].abs().max()) < 5e-2


@pytest.mark.parametrize("enabled", [False, True])
def test_compressed_bytes_match_reference(enabled):
    """A reduced model's wire bytes, one scale header a reference leaf."""
    cfg = configs.reduced("zamba2-7b")
    model = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = lm.to_reference(model)
    assert compressed_bytes(dict(model.named_parameters()),
                            CompressionConfig(enabled=enabled)) \
        == rcompressed_bytes(ref, RComp(enabled=enabled))


# --------------------------------------------------------------------------- #
# Data determinism
# --------------------------------------------------------------------------- #
def test_data_resume_bit_exact():
    cfg = configs.reduced("qwen3-1.7b")
    a = SyntheticLM(cfg, DataConfig(batch=2, seq=16, seed=3), device="cpu")
    batches = [next(a) for _ in range(5)]
    assert a.state_dict() == {"step": 5, "seed": 3}
    b = SyntheticLM(cfg, DataConfig(batch=2, seq=16, seed=3), device="cpu")
    b.load_state_dict({"step": 3, "seed": 3})
    resumed = next(b)
    for k in batches[3]:
        assert torch.equal(batches[3][k], resumed[k]), k


# --------------------------------------------------------------------------- #
# Checkpointing
# --------------------------------------------------------------------------- #
def test_checkpoint_roundtrip(tmp_path):
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3),
                        "h": torch.arange(4.0).to(torch.bfloat16)},
             "opt": {"m": {"w": torch.ones((2, 3))},
                     "count": torch.tensor(7, dtype=torch.int32)},
             "step": torch.tensor(7, dtype=torch.int32)}
    save_checkpoint(tmp_path / "c", state, 7, extra={"data": {"step": 7}})
    loaded, manifest = load_checkpoint(tmp_path / "c")
    assert manifest["step"] == 7
    assert manifest["extra"]["data"]["step"] == 7
    assert manifest["leaves"]["params/h"] == {"shape": [4],
                                              "dtype": "bfloat16"}
    assert torch.equal(loaded["params"]["w"], state["params"]["w"])
    assert loaded["params"]["h"].dtype == torch.bfloat16
    assert torch.equal(loaded["params"]["h"], state["params"]["h"])
    assert loaded["opt"]["count"].dtype == torch.int32
    assert int(loaded["opt"]["count"]) == 7


def test_manager_cadence_retention_async(tmp_path):
    mgr = CheckpointManager(tmp_path, every=10, keep=2)
    assert not mgr.should_save(5) and mgr.should_save(10)
    w = torch.zeros(4)
    for step in (10, 20, 30):
        mgr.save({"w": w}, step, block=False)
        w += 1.0                  # in place, as a train step does
    mgr.wait()
    kept = sorted(p.name for p in tmp_path.glob("step_*"))
    assert kept == ["step_00000020", "step_00000030"]
    restored, manifest = mgr.restore()
    assert manifest["step"] == 30
    # the snapshot was taken at save(): the write saw w before the += 1
    assert torch.equal(restored["w"], torch.full((4,), 2.0))


def test_manager_ignores_and_gcs_torn_tmp_dirs(tmp_path):
    """A crash mid-async-write leaves step_*.tmp (no manifest): restore
    must never pick it — even though it sorts after its own step — and
    the next save's GC must clean it up."""
    mgr = CheckpointManager(tmp_path, every=1, keep=2)
    mgr.save({"w": torch.zeros(2)}, 5)
    torn = tmp_path / "step_00000005.tmp"
    torn.mkdir()                       # simulated torn write
    assert mgr.latest().name == "step_00000005"
    mgr.save({"w": torch.ones(2)}, 6)
    assert not torn.exists()
    _, manifest = mgr.restore()
    assert manifest["step"] == 6


# --------------------------------------------------------------------------- #
# Checkpoints across the packages
# --------------------------------------------------------------------------- #
CKPT_ARCH = "qwen3-1.7b"


def _ref_run(cfg, state, start, n, data_cfg):
    step_fn = jax.jit(RS.make_train_step(cfg, ROpt(lr=1e-3)))
    data = RSyntheticLM(cfg, data_cfg)
    losses = []
    for s in range(start, start + n):
        state, m = step_fn(state, data.batch_at(s))
        losses.append(float(m["loss"]))
    return state, losses


def test_reference_checkpoint_trains_on_in_the_port(tmp_path):
    """A reference state after 2 steps, saved by the reference, restores
    in the port, which takes the reference's next 2 batches with losses
    within 1e-5 of the reference's own continuation."""
    cfg = RCFG.reduced(CKPT_ARCH)
    data_cfg = RDataConfig(batch=2, seq=32, seed=1)
    state = RS.init_train_state(cfg, jax.random.PRNGKey(0), ROpt())
    state, _ = _ref_run(cfg, state, 0, 2, data_cfg)
    rsave(tmp_path / "c", state, 2, extra={"data": {"step": 2, "seed": 1}})
    _, ref_losses = _ref_run(cfg, state, 2, 2, data_cfg)

    tree, manifest = load_checkpoint(tmp_path / "c")
    cfg_t = configs.reduced(CKPT_ARCH)
    port = steps.state_from_reference(cfg_t, tree, "cpu")
    assert int(port["step"]) == 2 and int(port["opt"]["count"]) == 2
    step_fn = steps.make_train_step(cfg_t, OptConfig(lr=1e-3))
    data = RSyntheticLM(cfg, data_cfg)
    losses = []
    for s in range(manifest["step"], manifest["step"] + 2):
        batch = {k: torch.from_numpy(np.array(v))
                 for k, v in data.batch_at(s).items()}
        port, m = step_fn(port, batch)
        losses.append(m["loss"].item())
    assert_allclose(losses, ref_losses, rtol=1e-5)


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    """A port state (compression on: ``err`` too) saved by the port loads
    through the reference's ``load_checkpoint`` with the reference's
    keys, shapes and dtypes, its leaves equal to ``reference_state``;
    the two packages' files of the same state hold the same members,
    byte for byte."""
    cfg = configs.reduced(CKPT_ARCH)
    comp = CompressionConfig(enabled=True)
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   comp, device="cpu")
    batch = SyntheticLM(cfg, DataConfig(2, 32, 0), device="cpu").batch_at(0)
    state, _ = steps.make_train_step(cfg, OptConfig(), comp)(state, batch)
    tree = steps.reference_state(state)
    save_checkpoint(tmp_path / "port", tree, 1, extra={"data": {"step": 1}})

    loaded, manifest = rload(tmp_path / "port")
    r_cfg = RCFG.reduced(CKPT_ARCH)
    ref = RS.init_train_state(r_cfg, jax.random.PRNGKey(0), ROpt(),
                              RComp(enabled=True))
    ref_paths = [(jax.tree_util.keystr(p), np.shape(v), np.asarray(v).dtype)
                 for p, v in jax.tree_util.tree_flatten_with_path(ref)[0]]
    got = jax.tree_util.tree_flatten_with_path(loaded)[0]
    assert [(jax.tree_util.keystr(p), v.shape, v.dtype) for p, v in got] \
        == ref_paths
    for (p, v), (_, w) in zip(got, jax.tree_util.tree_flatten_with_path(
            tree)[0]):
        np.testing.assert_array_equal(v, np.asarray(w),
                                      err_msg=jax.tree_util.keystr(p))
    assert manifest["step"] == 1 and manifest["extra"]["data"]["step"] == 1

    rsave(tmp_path / "ref", jax.tree.map(jnp.asarray, loaded), 1)
    with zipfile.ZipFile(tmp_path / "port" / "arrays.npz") as a, \
            zipfile.ZipFile(tmp_path / "ref" / "arrays.npz") as b:
        assert a.namelist() == b.namelist()
        for name in a.namelist():
            assert a.read(name) == b.read(name), name
    mine = json.loads((tmp_path / "port" / "manifest.json").read_text())
    theirs = json.loads((tmp_path / "ref" / "manifest.json").read_text())
    assert mine.keys() == theirs.keys()
    assert mine["leaves"] == theirs["leaves"]


def test_reference_bf16_checkpoint_restores_bit_for_bit(tmp_path):
    """A reduced bf16 reference state: the reference writes its bf16
    leaves as ``<V2`` records, and its own restore path
    (``jax.tree.map(jnp.asarray, restored)``, as its launcher does)
    raises on them; the port reads each leaf by the manifest's dtype and
    restores every one bit for bit.  The port's file of that state is
    the reference's, member for member."""
    cfg = RCFG.reduced(CKPT_ARCH).replace(dtype="bfloat16")
    state = jax.tree.map(np.asarray, RS.init_train_state(
        cfg, jax.random.PRNGKey(0), ROpt(), dtype=jnp.bfloat16))
    rsave(tmp_path / "ref", state, 0, extra={"data": {"step": 0}})
    restored, manifest = rload(tmp_path / "ref")
    assert restored["params"]["embed"]["table"].dtype == np.dtype("V2")
    assert manifest["leaves"]["params/embed/table"]["dtype"] == "bfloat16"
    with pytest.raises(TypeError):
        jax.tree.map(jnp.asarray, restored)

    tree, _ = load_checkpoint(tmp_path / "ref")
    port = steps.state_from_reference(configs.reduced(CKPT_ARCH).replace(
        dtype="bfloat16"), tree, "cpu")
    mine = steps.reference_state(port)
    flat_m = jax.tree_util.tree_flatten_with_path(mine)[0]
    flat_r = jax.tree_util.tree_flatten_with_path(state)[0]
    assert len(flat_m) == len(flat_r)
    for (path, a), (_, r) in zip(flat_m, flat_r):
        r = np.asarray(r)
        if r.dtype == ml_dtypes.bfloat16:
            assert a.dtype == np.dtype("V2"), path
            a, r = a.view(np.uint16), r.view(np.uint16)
        np.testing.assert_array_equal(a, r, err_msg=str(path))
    assert port["model"].embed.table.dtype == torch.bfloat16
    assert port["opt"]["m"]["embed.table"].dtype == torch.float32

    save_checkpoint(tmp_path / "port", mine, 0, extra={"data": {"step": 0}})
    with zipfile.ZipFile(tmp_path / "port" / "arrays.npz") as a, \
            zipfile.ZipFile(tmp_path / "ref" / "arrays.npz") as b:
        assert a.namelist() == b.namelist()
        for name in a.namelist():
            assert a.read(name) == b.read(name), name
