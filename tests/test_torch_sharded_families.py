"""Every family's sharded train step at (data 2, model 2) — four gloo
ranks, DTensor, ZeRO-1 moments — against the JAX reference's sharded
step on the same mesh shape (``AxisType.Auto`` axes, 4 forced host
devices, in a subprocess: ``_torch_sharded_ref.py``) and against the
port's one-process step, all on the reference's weights (``PRNGKey(0)``)
and batch (4 x 32): each family's reduced fp32 config, and qwen3-1.7b
with ``grad_accum=2`` (the fp32 accumulator in the ZeRO-1 placements).
Against the reference: the CE within 1e-5 and the gradient norm within
1e-4 relative, every gradient leaf (recovered from the gathered first
moment) within 1e-4 of its largest magnitude, as
``test_torch_sharded_train.py`` holds reduced qwen3.  Against the
one-process step: the loss within 1e-5 relative, the gradients alike,
the first moment, (1 - b1) times the clipped gradient, within the same
1e-4 of its largest and the second, the gradient's square, within 2e-4
(twice the relative error; the hybrid's SSD, exponentials of cumulative
sums, brings its ``A_log`` gradient to about 5e-5 of its largest).  Each
rank holds the reference's per-device bytes of every leaf's moment
(ZeRO-1's rule).  The one-process step runs in rank 0; the ranks and the
reference (in two processes) run at once.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import _torch_sharded_ref as REF
from _torch_pipeline_fixture import leaves
from _torch_sharded_fixture import (CE_TOL, GRAD_FRAC,
                                    assert_gradients_close,
                                    assert_zero1_bytes, run_ranks,
                                    run_reference, step_gradients)
from repro_torch.optim import OptConfig

FAMILIES = {"dense": "qwen3-1.7b", "vlm": "phi-3-vision-4.2b",
            "moe": "qwen3-moe-30b-a3b", "ssm": "falcon-mamba-7b",
            "hybrid": "zamba2-7b", "encdec": "whisper-small"}
CASES = {**{fam: (arch, 1) for fam, arch in FAMILIES.items()},
         "dense-accum2": ("qwen3-1.7b", 2)}
MESH, BATCH, SEQ = (2, 2), 4, 32


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_families")
    for arch in set(FAMILIES.values()):
        REF.weights(tmp / f"{arch}.npz", arch, BATCH, SEQ)
    cases = [{"case": case, "arch": arch, "mesh": list(MESH),
              "compress": False, "weights": str(tmp / f"{arch}.npz"),
              "batch": BATCH, "seq": SEQ, "accum": accum, "plain": True}
             for case, (arch, accum) in CASES.items()]
    # the reference's compiles are most of the time: two processes
    with ThreadPoolExecutor(3) as pool:
        refs = [pool.submit(run_reference, cases[i::2], tmp, f"reference{i}")
                for i in range(2)]
        port = pool.submit(run_ranks, cases, MESH[0] * MESH[1], tmp,
                           "families")
        return {k: v for r in refs for k, v in r.result().items()}, \
            port.result()


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_reference(results, case):
    ref, port = results[0][case], results[1][case]
    ce, rce = float(port["metrics"]["ce"]), float(ref["metrics"]["ce"])
    assert abs(ce - rce) <= CE_TOL, (ce, rce)
    gn = float(port["metrics"]["grad_norm"])
    rgn = float(ref["metrics"]["grad_norm"])
    assert abs(gn - rgn) <= GRAD_FRAC * rgn, (gn, rgn)
    opt = OptConfig(lr=REF.LR)
    assert_gradients_close(step_gradients(port, opt),
                           step_gradients(ref, opt))


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_one_process(results, case):
    port = results[1][case]
    plain = port["plain"]
    loss, ploss = (float(t["metrics"]["loss"]) for t in (port, plain))
    assert abs(loss - ploss) <= 1e-5 * abs(ploss), (loss, ploss)
    gn, pgn = (float(t["metrics"]["grad_norm"]) for t in (port, plain))
    assert abs(gn - pgn) <= GRAD_FRAC * pgn, (gn, pgn)
    opt = OptConfig(lr=1e-3)
    assert_gradients_close(step_gradients(port, opt),
                           step_gradients(plain, opt))
    for k, frac in (("m", GRAD_FRAC), ("v", 2 * GRAD_FRAC)):
        want = dict(leaves(plain[k]))
        for path, got in leaves(port[k]):
            big = np.abs(want[path]).max()
            assert np.abs(got - want[path]).max() <= frac * big, (k, path)


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_the_zero1_share_of_the_moments(results, case):
    assert_zero1_bytes(results[1][case], CASES[case][0], MESH)
