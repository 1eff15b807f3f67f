"""The card as ParetoPipe's device: ``core.devices.H100_SXM``, its pods
and links are ``launch.roofline``'s constants; ``scenarios.card_pods``
and ``devices.h100_pod`` scale with the cards a pod; the port's
card-priced fronts are the ones the reference's own solver returns on
the same chain (built from the reference's ``DeviceProfile``/``Link``
with the port's constants), for every registered arch;
``choose_pipeline_cuts`` takes the chain one way only; and
``launch.mesh.plan_pipeline`` keeps its pick on the plan and prices a
stage of the ranks' ``(pod, data, model)`` mesh as its D·M cards, one
of the host mesh as one."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.core import best_latency, best_throughput, dp_front_kway
from repro.core import devices as RD
from repro.models import blocks_adapter as RB
from repro_torch.core import devices as D
from repro_torch.core import scenarios as S
from repro_torch.launch import roofline
from repro_torch.launch.mesh import (cards_per_pod, make_host_mesh,
                                     plan_pipeline)
from repro_torch.models import blocks_adapter as B
from repro_torch.models import lm
from repro_torch.runtime.pipeline import PipelineConfig
from test_torch_analytic import ARCHS, _cfgs

ROOT = pathlib.Path(__file__).resolve().parents[1]


def reference_chain(n_pods: int, cards: int) -> tuple[list, list]:
    """``card_pods(n_pods, cards)`` in the reference's own classes."""
    scen = S.card_pods(n_pods, cards)
    return ([RD.DeviceProfile(**dataclasses.asdict(d)) for d in scen.devices],
            [RD.Link(**dataclasses.asdict(l)) for l in scen.links])


def reference_card_plan(rcfg, seq: int, n_pods: int, cards: int = 1,
                        batch: int = 1, train: bool = True,
                        objective: str = "throughput"):
    """The reference's solver and pick on the card chain → (cuts, pick,
    front), the cuts mapped to layers as ``choose_pipeline_cuts`` maps
    them."""
    devs, links = reference_chain(n_pods, cards)
    front = dp_front_kway(RB.arch_block_graph(rcfg, seq, train=train), devs,
                          links, batch=batch)
    pick = (best_throughput if objective == "throughput"
            else best_latency)(front)
    cuts = tuple(min(max(c - 1, 1), rcfg.n_layers - 1)
                 for c in pick.partition)
    return cuts, pick, front


def paretopipe_line(cuts, pick, _front=None) -> str:
    """The launchers' ``[paretopipe]`` line for a plan."""
    return (f"[paretopipe] cuts={cuts} predicted latency="
            f"{pick.latency_s*1e3:.2f}ms thr={pick.throughput:.1f}/s")


def test_the_card_is_the_rooflines():
    assert D.H100_SXM.flops_per_s == roofline.PEAK_FLOPS == 989e12
    assert D.H100_SXM.mem_bw == roofline.HBM_BW == 3.35e12
    assert D.NVLINK4.bw_bytes_per_s == roofline.ICI_BW == 450e9
    assert D.IB_NDR.bw_bytes_per_s == roofline.DCN_BW == 50e9
    # the measured constants: a card's memory, and power below its limit
    assert 0 < D.H100_SXM.mem_bytes and 0 < D.H100_SXM.stage_overhead_s
    assert 0 < D.H100_SXM.idle_w < D.H100_SXM.active_w


@pytest.mark.parametrize("cards", [1, 2, 4])
def test_card_chains_scale_with_the_cards(cards):
    pod, one = D.h100_pod(cards), D.H100_SXM
    assert pod.name == f"h100_pod{cards}"
    for field in ("flops_per_s", "mem_bytes", "mem_bw", "idle_w",
                  "active_w"):
        assert getattr(pod, field) == getattr(one, field) * cards, field
    assert pod.stage_overhead_s == one.stage_overhead_s
    for n_pods in (2, 4):
        scen = S.card_pods(n_pods, cards)
        assert scen.name == f"cards{n_pods}x{cards}"
        assert scen.devices == tuple(D.h100_pod(cards, name=f"pod{i}")
                                     for i in range(n_pods))
        assert scen.links == (D.NVLINK4,) * (n_pods - 1)
    # the card's chains stay out of the registry the reference shares
    assert not any(s.startswith("cards") for s in S.REGISTRY)


@pytest.mark.parametrize("name,red", ARCHS)
def test_card_front_matches_reference_solver(name, red):
    cfg, rcfg = _cfgs(name, red)
    for pods, cards in ((2, 1), (2, 2), (4, 1)):
        for seq in (128, 2048):
            for train, objective in ((True, "throughput"),
                                     (False, "latency")):
                kw = dict(batch=8, train=train, objective=objective)
                cuts, pick, front = B.choose_pipeline_cuts(cfg, seq, pods,
                                                           cards, **kw)
                want = reference_card_plan(rcfg, seq, pods, cards, **kw)
                assert cuts == want[0], (pods, cards, seq, train)
                assert dataclasses.asdict(pick) \
                    == dataclasses.asdict(want[1])
                assert [dataclasses.asdict(p) for p in front] \
                    == [dataclasses.asdict(p) for p in want[2]]
                # no scenario= is the card chain's
                explicit = B.choose_pipeline_cuts(
                    cfg, seq, pods, **kw, scenario=S.card_pods(pods, cards))
                assert dataclasses.asdict(explicit[1]) \
                    == dataclasses.asdict(pick)


def test_a_chain_is_named_one_way():
    """``scenario=`` names the whole chain: with another pod count, or
    beside ``chips_per_pod``, ``choose_pipeline_cuts`` refuses."""
    cfg = _cfgs("qwen3-1.7b", True)[0]
    with pytest.raises(ValueError, match="names the chain"):
        B.choose_pipeline_cuts(cfg, 32, 4, scenario=S.pods(2))
    with pytest.raises(ValueError, match="names the chain"):
        B.choose_pipeline_cuts(cfg, 32, 2, 2, scenario=S.card_pods(2, 2))


def test_plan_pipeline_keeps_its_pick():
    """The launchers' plan keeps the pick that chose its cuts (what the
    ``[paretopipe]`` line prints); even cuts have none."""
    cfg = _cfgs("qwen3-1.7b", True)[0]
    model = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    pcfg, _ = plan_pipeline(cfg, model, 2, 2, seq=32, batch=4,
                            auto_partition=True, train=True)
    cuts, pick, _ = B.choose_pipeline_cuts(cfg, 32, 2, batch=4)
    assert pcfg.cuts == cuts and pcfg.plan == pick
    assert pcfg == PipelineConfig(2, 2, cuts)
    even, _ = plan_pipeline(cfg, model, 2, 2, seq=32, batch=4,
                            auto_partition=False, train=True)
    assert even.plan is None


def test_plan_pipeline_prices_the_cards_of_a_pod():
    """One card a stage on the host mesh; D·M on the ranks' mesh, here
    (pod 2, data 1, model 2) in four gloo ranks of the training launcher,
    whose rank 0 prints the plan priced for 2 cards a stage."""
    from repro import configs as RCFG
    assert cards_per_pod(None) == 1
    assert cards_per_pod(make_host_mesh(2, device="cpu")) == 1
    rcfg = RCFG.reduced("qwen3-1.7b")
    two = paretopipe_line(*reference_card_plan(rcfg, 32, 2, 2, batch=4))
    one = paretopipe_line(*reference_card_plan(rcfg, 32, 2, 1, batch=4))
    assert two != one
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cp = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-1.7b", "--reduced", "--device", "cpu", "--steps", "1",
         "--batch", "4", "--seq", "32", "--pods", "2", "--microbatches", "2",
         "--auto-partition", "--model-par", "2"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=180)
    assert cp.returncode == 0, cp.stdout + cp.stderr
    lines = [x for x in cp.stdout.splitlines()
             if x.startswith("[paretopipe]")]
    assert lines == [two]
