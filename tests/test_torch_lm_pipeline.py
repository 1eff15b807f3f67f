"""The port's pod pipeline (``repro_torch.runtime.pipeline``) served,
against the JAX reference's pipelined steps and against the port's own
unpipelined serve.

The stage layout, ``repack_params``/``unpack_params`` (pads included)
and the pipelined parameter tree equal the reference's.  Pipelined
prefill and two decode steps, on the reference's weights and prompts
and at uneven cuts, give the reference's pipelined tokens, with every
cache leaf in the reference's (K, l_max, ...) layout within 2e-4 (fp32):
qwen3 at 5 layers cut at 2, 1 and 4, and the hybrid (the shared block's
slot-compressed caches), ssm, moe and enc-dec families.  On the kernel
route (``attn_impl="pallas"``; on the CPU the kernels' plain versions)
a pipelined serve is the unpipelined one bit for bit, as it must be on
the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pipeline_fixture import leaves, run_reference
from repro import configs as RCFG
from repro.models.common import InitBuilder
from repro.runtime import pipeline as RPL
from repro_torch import configs
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm
from repro_torch.models.common import Init
from repro_torch.runtime import pipeline as PL

torch.set_num_threads(1)
TOL = 2e-4
SERVE_CASES = [("qwen3-1.7b-c2", "qwen3-1.7b", 5, (2,)),
               ("qwen3-1.7b-c1", "qwen3-1.7b", 5, (1,)),
               ("qwen3-1.7b-c4", "qwen3-1.7b", 5, (4,)),
               ("zamba2-7b", "zamba2-7b", 5, (3,)),
               ("falcon-mamba-7b", "falcon-mamba-7b", 3, (2,)),
               ("qwen3-moe-30b-a3b", "qwen3-moe-30b-a3b", 3, (1,)),
               ("whisper-small", "whisper-small", 3, (1,))]
FAMILY_ARCHS = ["qwen3-1.7b", "phi-3-vision-4.2b", "qwen3-moe-30b-a3b",
                "falcon-mamba-7b", "zamba2-7b", "whisper-small"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("serve", tmp_path_factory.mktemp("pipeline_serve"))


# --------------------------------------------------------------------------- #
# Layout and repacking
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("cuts", [(3,), (2,), (5,), (1, 4), (0, 7), None])
def test_layout_and_repack_match_reference(cuts):
    n = 7
    if cuts is None:
        pcfg, rpcfg = PL.PipelineConfig.even(n, 3, 2), \
            RPL.PipelineConfig.even(n, 3, 2)
    else:
        pcfg = PL.PipelineConfig(len(cuts) + 1, 2, cuts)
        rpcfg = RPL.PipelineConfig(len(cuts) + 1, 2, cuts)
    assert pcfg == PL.PipelineConfig(rpcfg.n_stages, rpcfg.microbatches,
                                     tuple(rpcfg.cuts))
    for a, b in zip(pcfg.layout(n), rpcfg.layout(n)):
        np.testing.assert_array_equal(a, b)
    starts, counts, _ = rpcfg.layout(n)
    assert pcfg.ranges(n) == [range(s, s + c) for s, c in zip(starts, counts)]
    tree = {"w": np.arange(n * 3 * 2, dtype=np.float32).reshape(n, 3, 2) + 1,
            "b": {"s": np.arange(n, dtype=np.float32) + 1}}
    want = RPL.repack_params(jax.tree.map(jnp.asarray, tree), rpcfg, n)
    got = PL.repack_params(tree, pcfg, n)
    got_t = PL.repack_params(
        {"w": torch.from_numpy(tree["w"]),
         "b": {"s": torch.from_numpy(tree["b"]["s"])}}, pcfg, n)
    for path in ("w", "b/s"):
        g, gt, w = (t["w"] if path == "w" else t["b"]["s"]
                    for t in (got, got_t, want))
        np.testing.assert_array_equal(g, np.asarray(w))       # pads are 0
        np.testing.assert_array_equal(gt.numpy(), np.asarray(w))
    back = PL.unpack_params(got, pcfg, n)
    back_t = PL.unpack_params(got_t, pcfg, n)
    rback = RPL.unpack_params(want, rpcfg, n)
    np.testing.assert_array_equal(back["w"], tree["w"])
    np.testing.assert_array_equal(back_t["b"]["s"].numpy(), tree["b"]["s"])
    np.testing.assert_array_equal(back["b"]["s"], np.asarray(rback["b"]["s"]))


def test_bad_cuts_raise_as_in_reference():
    for cls in (PL.PipelineConfig, RPL.PipelineConfig):
        with pytest.raises(ValueError, match="bad cuts"):
            cls(2, 2, (9,)).layout(7)
    assert PL.PipelineConfig.even(81, 2, 8).layout(81)[2] == 41
    assert list(PL.PipelineConfig(2, 4, (10,)).layout(81)[1]) == [10, 71]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_pipeline_params_tree_matches_reference(arch):
    """``build_pipeline_params`` declares the reference's tree: its keys,
    shapes and dtypes, in (K, l_max, ...) layout; the pipeline's
    ``n_attn_slots`` is the reference's."""
    cfg = configs.reduced(arch).replace(n_layers=5)
    rcfg = RCFG.reduced(arch).replace(n_layers=5)
    pcfg, rpcfg = PL.PipelineConfig(2, 2, (2,)), RPL.PipelineConfig(2, 2, (2,))
    got = PL.build_pipeline_params(
        cfg, Init(torch.Generator().manual_seed(0), torch.float32, "cpu"),
        pcfg)
    want = RPL.build_pipeline_params(
        rcfg, InitBuilder(jax.random.PRNGKey(0), jnp.float32), rpcfg)
    want = jax.tree.map(np.asarray, want)
    assert [(p, tuple(t.shape), str(t.dtype).split(".")[-1])
            for p, t in leaves(got)] \
        == [(p, a.shape, str(a.dtype)) for p, a in leaves(want)]
    if cfg.family == "hybrid":
        for l_max in (1, 5, 41, 72):
            assert PL.n_attn_slots(cfg, l_max) \
                == RPL.n_attn_slots(rcfg, l_max)


# --------------------------------------------------------------------------- #
# Pipelined serving against the reference's
# --------------------------------------------------------------------------- #
def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _held(what, cfg, pcfg, cache, ref):
    got = PL.reference_cache(cfg, pcfg, cache)
    assert got["pos"] == int(ref["pos"]), what
    assert set(got) == set(ref), what
    for key in ref:
        if key == "pos":
            continue
        g, r = got[key].numpy(), ref[key]
        assert g.shape == r.shape, (what, key)
        np.testing.assert_allclose(g, r, rtol=TOL, atol=TOL,
                                   err_msg=f"{what} {key}")


@pytest.mark.parametrize("case,arch,depth,cuts", SERVE_CASES)
def test_pipelined_serve_matches_reference(reference, case, arch, depth,
                                           cuts):
    ref = reference[case]
    assert tuple(ref["cuts"]) == cuts
    cfg = configs.reduced(arch).replace(n_layers=depth)
    model = lm.from_reference(cfg, ref["params"], "cpu")
    pcfg = PL.PipelineConfig(2, 1, cuts)
    mesh = make_host_mesh(2, device="cpu")
    PL.place_stages(cfg, model, pcfg, mesh)
    prefill = PL.make_pipeline_prefill_step(cfg, pcfg, mesh, cache_len=18)
    decode = PL.make_pipeline_decode_step(cfg, pcfg, mesh)
    tok, cache = prefill(model, _t(ref["inputs"]))
    np.testing.assert_array_equal(tok.numpy(), ref["prefill"]["tokens"])
    _held(f"{case} prefill", cfg, pcfg, cache, ref["prefill"]["cache"])
    for i in range(2):
        tok, cache = decode(model, tok, cache)
        step = ref[f"decode{i}"]
        np.testing.assert_array_equal(tok.numpy(), step["tokens"])
        _held(f"{case} decode {i}", cfg, pcfg, cache, step["cache"])


# --------------------------------------------------------------------------- #
# The kernel route: pipelined == unpipelined, bit for bit
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("pods,cuts", [(2, (1,)), (3, None)])
def test_pipelined_serve_is_the_unpipelined_serve(arch, pods, cuts):
    cfg = configs.reduced(arch).replace(n_layers=4, attn_impl="pallas")
    model = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 16
    cache_len = S + 4 + (cfg.n_patches if cfg.family == "vlm" else 0)
    inputs = {k: v for k, v in SyntheticLM(cfg, DataConfig(B, S, 0),
                                           device="cpu").batch_at(0).items()
              if k != "targets"}
    pcfg = PL.PipelineConfig.even(cfg.n_layers, pods, 1) if cuts is None \
        else PL.PipelineConfig(pods, 1, cuts)
    mesh = make_host_mesh(pods, device="cpu")
    PL.place_stages(cfg, model, pcfg, mesh)
    want, wcache = lm.forward_prefill(cfg, model, inputs, cache_len)
    got, gcache = PL.forward_prefill(cfg, pcfg, mesh, model, inputs,
                                     cache_len)
    assert torch.equal(got, want)
    for _ in range(3):
        tok = want.argmax(-1)
        want, wcache = lm.forward_decode(cfg, model, tok, wcache)
        got, gcache = PL.forward_decode(cfg, pcfg, mesh, model, tok, gcache)
        assert torch.equal(got, want)
    assert gcache["pos"] == wcache["pos"]
    # the stages' caches, laid end to end, are the unpipelined cache
    for key in gcache["stages"][0]:
        if key in ("ak", "av"):
            continue                      # slots per stage (checked above)
        assert torch.equal(torch.cat([c[key] for c in gcache["stages"]]),
                           wcache[key]), key


def test_a_stage_off_its_device_is_refused():
    cfg = configs.reduced("qwen3-1.7b")
    model = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    pcfg = PL.PipelineConfig(2, 1, (1,))
    mesh = make_host_mesh(2, device="cpu")
    PL.place_stages(cfg, model, pcfg, mesh)
    elsewhere = type(mesh)((torch.device("cpu"), torch.device("meta")))
    with pytest.raises(RuntimeError, match="place_stages first"):
        PL.forward_prefill(cfg, pcfg, elsewhere, model,
                           {"tokens": torch.zeros((1, 4), dtype=torch.long)})
    with pytest.raises(ValueError, match="2 devices for 3 stages"):
        PL.place_stages(cfg, model, PL.PipelineConfig(3, 1, (1, 1)), mesh)
    # pods with a data axis are ranks of the (pod, data, model) mesh, which
    # this process is not
    with pytest.raises(RuntimeError, match="not a rank"):
        make_host_mesh(2, data=2, device="cpu")
