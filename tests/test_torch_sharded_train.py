"""The port's sharded train step (``runtime.steps`` under
``sharding.api``: DTensor on a ``(data, model)`` ``DeviceMesh`` of gloo
ranks, ZeRO-1 moments) against the JAX reference's sharded step on the
same mesh shape (``AxisType.Auto`` axes, 4 forced host devices, in a
subprocess: ``_torch_sharded_ref.py``): reduced qwen3-1.7b in fp32 at
(2, 2), (4, 1), (1, 4) and (1, 3) (seq 24, so that the (1, 3) mesh
shards q's sequence), and ``--compress-grads`` at (2, 1).  The CE within
1e-5 and the gradient norm within 1e-4 relative; every gradient leaf,
recovered from the gathered first moment, within 1e-4 of its largest
magnitude, as the pipeline tests hold it (with compression, at most
1e-3 of a leaf's elements may lie further, none by more than a level of
the int8 grid plus rounding, 1.5/127 of the largest: an element within
the packages' rounding of a level boundary takes the next level in one
of them, the rule of ``test_torch_train.py``'s compressed step).  Each
rank holds the reference's per-device bytes of every leaf's moment
(ZeRO-1's rule), and only rank 0 keeps the state it gathers for a
checkpoint.  The three rank groups (4, 3 and 2 ranks) and the
reference run at once, one thread each.
"""
from concurrent.futures import ThreadPoolExecutor

import pytest

import _torch_sharded_ref as REF
from _torch_sharded_fixture import (CE_TOL, assert_gradients_close,
                                    assert_zero1_bytes, run_ranks,
                                    run_reference, step_gradients)
from repro_torch.optim import OptConfig

# case → (mesh, compression), as in ``_torch_sharded_ref.MESHES``
CASES = {case: (list(shape), compress)
         for case, (shape, compress) in REF.MESHES.items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_train")
    weights = tmp / "weights.npz"
    REF.weights(weights)
    cases = [{"case": case, "arch": REF.ARCH, "mesh": mesh,
              "compress": compress, "weights": str(weights),
              "batch": REF.BATCH, "seq": REF.SEQ, "accum": 1,
              "plain": False}
             for case, (mesh, compress) in CASES.items()]
    groups: dict[int, list] = {}
    for case in cases:
        groups.setdefault(case["mesh"][0] * case["mesh"][1], []).append(case)
    with ThreadPoolExecutor(len(groups) + 1) as pool:
        ref = pool.submit(run_reference, cases, tmp, "reference")
        ranks = [pool.submit(run_ranks, cases, world, tmp, f"world{world}")
                 for world, cases in groups.items()]
        port = {k: v for r in ranks for k, v in r.result().items()}
        return ref.result(), port


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_reference(results, case):
    ref, port = results[0][case], results[1][case]
    ce, rce = float(port["metrics"]["ce"]), float(ref["metrics"]["ce"])
    assert abs(ce - rce) <= CE_TOL, (ce, rce)
    assert float(port["metrics"]["loss"]) == ce
    gn = float(port["metrics"]["grad_norm"])
    rgn = float(ref["metrics"]["grad_norm"])
    assert abs(gn - rgn) <= 1e-4 * rgn, (gn, rgn)
    opt = OptConfig(lr=REF.LR)
    flips = (1e-3, 1.5 / 127) if CASES[case][1] else None
    assert_gradients_close(step_gradients(port, opt),
                           step_gradients(ref, opt), flips)


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_the_zero1_share_of_the_moments(results, case):
    assert_zero1_bytes(results[1][case], REF.ARCH, tuple(CASES[case][0]))


@pytest.mark.parametrize("case", list(CASES))
def test_only_rank_0_keeps_the_gathered_state(results, case):
    """Every rank joins ``reference_state``'s gathers; rank 0, which
    writes checkpoints, alone copies the tree to the host."""
    kept = results[1][case]["kept"]
    assert list(kept) == [True] + [False] * (len(kept) - 1)
