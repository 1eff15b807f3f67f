"""The port's pipelined serve on the ranks' ``(pod, data, model)`` mesh
against the JAX reference's pipelined prefill and decode steps, on the
reference's own mesh, (pod 2, data 2, model 2), in eight gloo ranks: for
every case of ``_torch_pipeline_ref.py``'s serving (qwen3 at 5 layers
cut at 2, 1 and 4, and the hybrid, ssm, moe and enc-dec families) the
prefill's and two greedy decode steps' tokens equal, and every cache
leaf, gathered to rank 0 in the reference's (K, l_max, ...) layout,
within 2e-4 (fp32).  Each stage's cache stays on its pod's sub-mesh,
laid out by ``lm.cache_names``: at (pod 2, data 1, model 2) (the first
four of the ranks) qwen3's k/v split their kv heads over ``model``.
"""
import numpy as np
import pytest

from _torch_pipeline_fixture import leaves
from _torch_pod_mesh_fixture import MESH, run_both
from test_torch_lm_pipeline import SERVE_CASES, TOL

STEPS = ("prefill", "decode0", "decode1")
KV = ("qwen3-1.7b-kv", "qwen3-1.7b-c2")       # (its case, the npz's)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = [{"case": case, "kind": "pod-serve", "arch": arch,
              "depth": depth, "cuts": list(cuts), "mesh": MESH}
             for case, arch, depth, cuts in SERVE_CASES]
    cases.append({**cases[0], "case": KV[0], "from": KV[1],
                  "mesh": [2, 1, 2]})
    return run_both("serve", cases, tmp_path_factory.mktemp("pod_serve"))


def _held(got: dict, want: dict, what: str) -> None:
    for step in STEPS:
        np.testing.assert_array_equal(got[step]["tokens"],
                                      want[step]["tokens"], f"{what} {step}")
        g, w = dict(leaves(got[step]["cache"])), \
            dict(leaves(want[step]["cache"]))
        assert sorted(g) == sorted(w), (what, step)
        for key, r in w.items():
            assert g[key].shape == r.shape, (what, step, key)
            np.testing.assert_allclose(g[key], r, rtol=TOL, atol=TOL,
                                       err_msg=f"{what} {step} {key}")


@pytest.mark.parametrize("case,arch,depth,cuts", SERVE_CASES)
def test_pod_mesh_serve_matches_reference(runs, case, arch, depth, cuts):
    port, ref = runs
    assert tuple(ref[case]["cuts"]) == cuts
    _held(port[case], ref[case], case)


def test_pod_mesh_cache_splits_kv_heads_over_model(runs):
    port, ref = runs
    _held(port[KV[0]], ref[KV[1]], KV[0])
    # (data 1, model 2): the batch whole, the kv heads (dim 3) split
    for key in ("k", "v"):
        assert str(port[KV[0]]["placements"][key]) \
            == "(Replicate(), Shard(dim=3))", key
    for key in ("k", "v"):
        assert str(port[SERVE_CASES[0][0]]["placements"][key]) \
            == "(Shard(dim=1), Shard(dim=3))", key
