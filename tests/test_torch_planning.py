"""Planning-layer parity: the port's copies of the reference's jax-free
``core`` modules give the same results on the same inputs.

Block graphs come from the two packages' own zoos (their equality is
held by ``test_torch_cnn.py``); every result is compared as a plain
dict, so float fields must agree exactly — the code paths are copies.
"""
import dataclasses

import pytest

from repro.core import costmodel as RCM
from repro.core import pareto as RP
from repro.core import partitioner as RPT
from repro.core import scenarios as RS
from repro.models.cnn import zoo as RZ
from repro_torch.core import costmodel as CM
from repro_torch.core import pareto as P
from repro_torch.core import partitioner as PT
from repro_torch.core import scenarios as S
from repro_torch.models.cnn import zoo as Z


def _d(points):
    return [dataclasses.asdict(p) for p in points]


def _graphs(model):
    return Z.get(model).block_graph(), RZ.get(model).block_graph()


@pytest.mark.parametrize("model", ["mobilenetv2", "resnet18", "inceptionv3"])
@pytest.mark.parametrize("scen", ["pi_to_pi", "pi_pi_gpu", "pi_chain4",
                                  "pi_only3_duress", "pi_pi_gpu_int8"])
def test_solve_matches_reference(model, scen):
    g, rg = _graphs(model)
    got = PT.solve(g, S.get(scen), batch=8)
    want = RPT.solve(rg, RS.get(scen), batch=8)
    assert _d(got) == _d(want)
    assert dataclasses.asdict(PT.best_throughput(got)) \
        == dataclasses.asdict(RPT.best_throughput(want))


def test_slice_plan_with_one_codec_per_hop():
    """The chip smoke's plan: MobileNetV2 on pi_chain4 with int8, fp8
    and topk on its three hops, and the 4-objective front."""
    codecs = ("int8", "fp8", "topk")
    g, rg = _graphs("mobilenetv2")
    sc = S.get("pi_chain4").with_codec(codecs)
    rsc = RS.get("pi_chain4").with_codec(codecs)
    assert _d(PT.solve(g, sc, batch=8)) == _d(RPT.solve(rg, rsc, batch=8))
    assert _d(PT.solve(g, sc, batch=8, objectives=4)) \
        == _d(RPT.solve(rg, rsc, batch=8, objectives=4))


@pytest.mark.parametrize("model", ["mobilenetv2", "vgg16"])
def test_dp_front_and_sweep_2way_match(model):
    g, rg = _graphs(model)
    sc, rsc = S.get("pi_chain4"), RS.get("pi_chain4")
    assert _d(PT.dp_front_kway(g, sc.devices, sc.links, batch=4)) \
        == _d(RPT.dp_front_kway(rg, rsc.devices, rsc.links, batch=4))
    s2, r2 = S.get("pi_to_gpu"), RS.get("pi_to_gpu")
    got = PT.sweep_2way(g, s2.devices, s2.links[0], batch=8,
                        codecs=("int8",))
    want = RPT.sweep_2way(rg, r2.devices, r2.links[0], batch=8,
                          codecs=("int8",))
    assert _d(got) == _d(want)
    # the quickstart's front and knee
    assert _d(P.pareto_front(got)) == _d(RP.pareto_front(want))
    assert dataclasses.asdict(P.knee_point(got)) \
        == dataclasses.asdict(RP.knee_point(want))


@pytest.mark.parametrize("codecs", [None, ("int8", "fp8", "topk")])
def test_evaluate_pipeline_matches(codecs):
    g, rg = _graphs("mobilenetv2")
    sc, rsc = S.get("pi_chain4"), RS.get("pi_chain4")
    for cuts in [(1, 2, 3), (4, 9, 15), (2, 10, 19)]:
        got = CM.evaluate_pipeline(g, cuts, sc.devices, sc.links, batch=8,
                                   codecs=codecs)
        want = RCM.evaluate_pipeline(rg, cuts, rsc.devices, rsc.links,
                                     batch=8, codecs=codecs)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_scenario_registry_matches():
    assert sorted(S.REGISTRY) == sorted(RS.REGISTRY)
    for name in S.REGISTRY:
        assert dataclasses.asdict(S.get(name)) \
            == dataclasses.asdict(RS.get(name))
    assert S.FAULT_PLANS == RS.FAULT_PLANS
    for name in S.FAULT_PLANS:
        assert dataclasses.asdict(S.get_fault_plan(name)) \
            == dataclasses.asdict(RS.get_fault_plan(name))
    with pytest.raises(KeyError, match="unknown fault plan"):
        S.get_fault_plan("nope")
