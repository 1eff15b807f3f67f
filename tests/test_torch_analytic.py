"""The pipeline planner's parity: the port's copies of the reference's
``launch/analytic.py`` and ``models/blocks_adapter.py`` give the same
numbers, block graphs and, on the reference's TPU pod chain, ParetoPipe
cuts, exactly (``==``: the code paths are copies), for every registered
arch, full and reduced; the cuts the card's phases run are those of the
port's own chain, H100s over NVLink."""
import dataclasses

import pytest

from repro import configs as RCFG
from repro.launch import analytic as RA
from repro.launch.specs import ShapeSpec
from repro.models import blocks_adapter as RB
from repro.runtime.pipeline import PipelineConfig as RPipelineConfig
from repro_torch import configs
from repro_torch.launch import analytic as A
from repro_torch.core import scenarios as S
from repro_torch.launch import specs as SP
from repro_torch.models import blocks_adapter as B
from repro_torch.runtime.pipeline import PipelineConfig

ARCHS = [(name, red) for name in configs.ARCH_NAMES for red in (False, True)]
# the port's cells are ``specs.ShapeSpec``s of each kind, at 1024 x 8
KIND_SHAPES = {"train": "train_4k", "prefill": "prefill_32k",
               "decode": "decode_32k"}


def _cfgs(name, red):
    return ((configs.reduced if red else configs.get)(name),
            (RCFG.reduced if red else RCFG.get)(name))


@pytest.mark.parametrize("name,red", ARCHS)
def test_analytic_functions_match_reference(name, red):
    cfg, rcfg = _cfgs(name, red)
    for ctx in (1.0, 64.5, 2048.0):
        assert A._attn_score_flops(cfg, ctx) == RA._attn_score_flops(rcfg, ctx)
        assert A._layer_fwd_flops(cfg, ctx) == RA._layer_fwd_flops(rcfg, ctx)
        assert A._shared_block_flops(cfg, ctx) \
            == RA._shared_block_flops(rcfg, ctx)
        assert A.trunk_fwd_flops(cfg, 4096.0, ctx) \
            == RA.trunk_fwd_flops(rcfg, 4096.0, ctx)
    for fn in ("_attn_proj_flops", "_mlp_flops", "_moe_flops",
               "_mamba1_flops"):
        assert getattr(A, fn)(cfg) == getattr(RA, fn)(rcfg), fn
    assert A._mamba2_flops(cfg, 64) == RA._mamba2_flops(rcfg, 64)
    for batch in (1, 8):
        assert A._encoder_flops(cfg, batch) == RA._encoder_flops(rcfg, batch)
        assert A._logit_flops(cfg, batch * 512) \
            == RA._logit_flops(rcfg, batch * 512)
        assert A._cache_bytes(cfg, batch, 1024) \
            == RA._cache_bytes(rcfg, batch, 1024)
    assert A._ar_wire(1e6, 4) == RA._ar_wire(1e6, 4)
    assert A._ag_wire(1e6, 4) == RA._ag_wire(1e6, 4)


@pytest.mark.parametrize("name,red", ARCHS)
def test_cell_cost_matches_reference(name, red):
    cfg, rcfg = _cfgs(name, red)
    cuts = (max(1, cfg.n_layers // 3),)
    for kind in ("train", "prefill", "decode"):
        shape = dataclasses.replace(SP.SHAPES[KIND_SHAPES[kind]], seq=1024,
                                    batch=8)
        rshape = ShapeSpec("cell", 1024, 8, kind)
        for multi_pod, pc in ((False, None), (True, cuts)):
            kw = dict(n_chips=16, dp=4, tp=4, multi_pod=multi_pod)
            got = A.cell_cost(cfg, shape, **kw, pcfg=pc and PipelineConfig(
                2, 4, pc))
            want = RA.cell_cost(rcfg, rshape, **kw, pcfg=pc and
                                RPipelineConfig(2, 4, pc))
            assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                (kind, multi_pod)


@pytest.mark.parametrize("name,red", ARCHS)
def test_block_graph_matches_reference(name, red):
    cfg, rcfg = _cfgs(name, red)
    for seq in (128, 2048):
        for train in (False, True):
            got = B.arch_block_graph(cfg, seq, train=train)
            want = RB.arch_block_graph(rcfg, seq, train=train)
            assert (got.name, got.input_bytes, got.output_bytes) \
                == (want.name, want.input_bytes, want.output_bytes)
            assert len(got.blocks) == len(want.blocks) == cfg.n_layers + 2
            for a, b in zip(got.blocks, want.blocks):
                assert dataclasses.asdict(a) == dataclasses.asdict(b), a.name


@pytest.mark.parametrize("name,red", ARCHS)
def test_pipeline_cuts_match_reference(name, red):
    cfg, rcfg = _cfgs(name, red)
    for pods in (2, 4):
        for seq in (128, 1024, 2048):
            for train, objective in ((True, "throughput"),
                                     (False, "latency")):
                kw = dict(batch=8, train=train, objective=objective)
                cuts, pick, front = B.choose_pipeline_cuts(
                    cfg, seq, pods, **kw, scenario=S.pods(pods))
                rcuts, rpick, rfront = RB.choose_pipeline_cuts(rcfg, seq,
                                                               pods, **kw)
                assert cuts == rcuts, (pods, seq, train)
                assert dataclasses.asdict(pick) == dataclasses.asdict(rpick)
                assert [dataclasses.asdict(p) for p in front] \
                    == [dataclasses.asdict(p) for p in rfront]


def test_the_cards_cuts():
    """The cuts the card's phases run, priced by default for a card a
    stage (and for two, phase 35c's (2, 1, 2)): qwen3-1.7b trained at seq
    2048 on 2 and 4 pods, served at 1024 on 2; zamba2-7b served at 1024.
    Through the reference's TPU pod chain they are the reference's."""
    q, z = configs.get("qwen3-1.7b"), configs.get("zamba2-7b")
    cases = [((q, 2048, 2), {}, (16,), (7,)),
             ((q, 2048, 4), {}, (8, 16, 24), (3, 6, 10)),
             ((q, 1024, 2), {"train": False}, (17,), (1,)),
             ((z, 1024, 2), {"train": False}, (41,), (9,))]
    for args, kw, card, tpu in cases:
        assert B.choose_pipeline_cuts(*args, batch=8, **kw)[0] == card
        assert B.choose_pipeline_cuts(*args, 2, batch=8, **kw)[0] == card
        assert B.choose_pipeline_cuts(*args, batch=8, **kw,
                                      scenario=S.pods(args[2]))[0] == tpu
        rcfg = RCFG.get(args[0].name)
        assert RB.choose_pipeline_cuts(rcfg, *args[1:], batch=8,
                                       **kw)[0] == tpu
