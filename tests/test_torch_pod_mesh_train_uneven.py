"""The port's pipelined train step on the ranks' ``(pod, data, model)``
mesh (``runtime.pipeline`` on ``launch.mesh.pod_mesh``: each pod's
stage a DTensor on its ``(data, model)`` sub-mesh, the hop a
point-to-point send) against the JAX reference's pipelined train step,
on the reference's own mesh, (pod 2, data 2, model 2): eight gloo ranks,
all six families at uneven cuts, 2 microbatches.  The CE within 1e-5, the
gradient norm within 1e-4 relative and every gradient leaf, recovered
from the first moment gathered to rank 0 in the reference's (K, l_max,
...) layout, within 1e-4 of its largest.  The even cuts are in
``test_torch_pod_mesh_train.py``.
"""
import pytest

from _torch_pipeline_fixture import TRAIN_CASES, assert_matches_reference
from _torch_pod_mesh_fixture import MESH, run_both
from repro_torch.optim import OptConfig

KIND = "uneven"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = [{"case": case, "kind": "pod-train", "arch": arch,
              "depth": depth, "cuts": cuts and list(cuts), "mesh": MESH}
             for case, arch, depth, cuts in TRAIN_CASES[KIND]]
    return run_both("train", cases,
                    tmp_path_factory.mktemp("pod_train_uneven"), KIND)


@pytest.mark.parametrize("case,arch,depth,cuts", TRAIN_CASES[KIND])
def test_pod_mesh_train_step_matches_reference(runs, case, arch, depth,
                                               cuts):
    port, ref = runs
    assert_matches_reference(port[case]["metrics"], port[case]["m"],
                             ref[case], OptConfig(lr=1e-3))
    assert float(port[case]["metrics"]["loss"]) \
        == float(port[case]["metrics"]["ce"])
