"""The port's pipelined train step against the JAX reference's at
uneven cuts (``test_torch_pipeline_train.py`` has the even ones), and
pipelined checkpoints across the packages: a reference state in the
reference's (K, l_max, ...) layout, saved by the reference's
``save_checkpoint``, restores in the port and takes the next step within
1e-5 of the reference's own; a port pipelined state saved by the port
loads through the reference's ``load_checkpoint`` with the reference's
keys, shapes and dtypes, its leaves equal to ``reference_state``.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_pipeline_fixture import (CE_TOL, TRAIN_CASES, check_train_case,
                                     leaves, port_case, run_reference)
from repro.checkpoint import load_checkpoint as rload
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.optim import OptConfig
from repro_torch.runtime import steps
from repro_torch.runtime.pipeline import make_pipeline_train_step

torch.set_num_threads(1)
CKPT_CASE = TRAIN_CASES["uneven"][0]          # qwen3-1.7b, 3 layers, cut 1


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("pipeline_ckpt") / "ref"


@pytest.fixture(scope="module")
def reference(tmp_path_factory, ckpt_dir):
    return run_reference("train", tmp_path_factory.mktemp("pipeline_uneven"),
                         "uneven", str(ckpt_dir))


@pytest.mark.parametrize("case,arch,depth,cuts", TRAIN_CASES["uneven"])
def test_pipelined_train_step_matches_reference(reference, case, arch, depth,
                                                cuts):
    check_train_case(reference[case], arch, depth, cuts)


def _batch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_reference_pipelined_checkpoint_trains_on_in_the_port(reference,
                                                              ckpt_dir):
    case, arch, depth, cuts = CKPT_CASE
    cfg, _, pcfg, mesh = port_case(arch, depth, cuts,
                                   reference[case]["params"])
    tree, manifest = load_checkpoint(ckpt_dir)
    assert manifest["step"] == 1
    state = steps.state_from_reference(cfg, tree, "cpu", pcfg, mesh)
    assert int(state["step"]) == 1 and int(state["opt"]["count"]) == 1
    _, metrics = make_pipeline_train_step(cfg, pcfg, OptConfig(lr=1e-3),
                                          mesh)(state, _batch(
                                              reference["ckpt"]["batch"]))
    assert abs(metrics["loss"].item() - float(reference["ckpt"]["loss"])) \
        <= CE_TOL


def test_port_pipelined_checkpoint_loads_in_the_reference(reference, ckpt_dir,
                                                          tmp_path):
    case, arch, depth, cuts = CKPT_CASE
    cfg, model, pcfg, mesh = port_case(arch, depth, cuts,
                                       reference[case]["params"])
    state, _ = make_pipeline_train_step(cfg, pcfg, OptConfig(lr=1e-3), mesh)(
        steps.train_state(model), _batch(reference[case]["batch"]))
    tree = steps.reference_state(state, pcfg)
    save_checkpoint(tmp_path / "port", tree, 1)
    loaded, manifest = rload(tmp_path / "port")
    theirs, _ = rload(ckpt_dir)              # the reference's own, one step on

    def layout(t):
        return [(jax.tree_util.keystr(p), np.shape(v), np.asarray(v).dtype)
                for p, v in jax.tree_util.tree_flatten_with_path(t)[0]]
    assert layout(loaded) == layout(theirs)
    assert loaded["params"]["layers"]["attn"]["wq"].shape[:2] == (2, 2)
    for (path, v), (_, w) in zip(leaves(loaded), leaves(tree)):
        np.testing.assert_array_equal(v, np.asarray(w), err_msg=path)
    # a stage's pad layer is zero in the parameters and both moments
    for part in (loaded["params"], loaded["opt"]["m"], loaded["opt"]["v"]):
        assert not part["layers"]["mlp"]["w_up"][0, 1].any()
    assert manifest["step"] == 1
