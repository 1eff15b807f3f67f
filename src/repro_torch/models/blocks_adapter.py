"""ArchConfig → ParetoPipe BlockGraph (counterpart of
``src/repro/models/blocks_adapter.py``, a copy).

This is the bridge that makes the paper's partitioner a first-class
feature of the LM framework: every architecture becomes a chain of
blocks (its layers, plus embed/head endpoints) with per-block FLOPs,
weight bytes, and inter-block activation bytes — exactly what
``core.partitioner`` needs to choose pod-level pipeline cuts.

Costs come from the same formulas as the dry-run's analytic model
(``launch.analytic``), so the partitioner and the roofline agree.  The
port's ``core`` (``dp_front_kway``, ``best_throughput``) is a copy of
the reference's; the chain it solves over is the port's own: pods of
H100s joined by NVLink (``scenarios.card_pods``), the cards its stages
run on.  The reference prices 256-chip TPU v5e pods over DCN
(``scenarios.pods``); given that chain through ``scenario=``, the cuts,
pick and front are the reference's.  The predicted times are the
card's spec peaks over the block graph's FLOPs and bytes, not a
measurement.
"""
from __future__ import annotations

from ..core.blocks import Block, BlockGraph
from ..core.scenarios import Scenario
from ..launch.analytic import (_layer_fwd_flops, _logit_flops,
                               _shared_block_flops)
from .config import ArchConfig


def _layer_weight_bytes(cfg: ArchConfig) -> int:
    n = cfg.param_count()
    head = 0 if cfg.tie_embeddings else cfg.d_model * cfg.vocab
    trunk = n - cfg.vocab * cfg.d_model - head
    if cfg.family == "hybrid":
        trunk -= (2 * cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads)
                  * cfg.hd // 2)  # shared block roughly excluded below
    return int(trunk / cfg.n_layers * 2)


def arch_block_graph(cfg: ArchConfig, seq: int, *, train: bool = False,
                     per_sample: bool = True) -> BlockGraph:
    """Per-sample block graph at sequence length ``seq``.

    Blocks: [embed] + n_layers × [layer] + [head].  For hybrid archs the
    shared attention block is folded into the layers it precedes (with
    ``shared_group`` so its weights are counted once per stage).
    """
    ctx = (seq + cfg.attn_chunk) / 2 if seq > cfg.attn_chunk else (seq + 1) / 2
    act = seq * cfg.d_model * 2              # bf16 inter-layer activation
    mult = 3.0 + (1.0 if (train and cfg.remat) else 0.0) if train else 1.0

    blocks = [Block("embed", flops=seq * cfg.d_model * mult,
                    weight_bytes=cfg.vocab * cfg.d_model * 2,
                    out_bytes=act, act_bytes=act * 2)]
    lw = _layer_weight_bytes(cfg)
    per_layer = _layer_fwd_flops(cfg, ctx) * seq * mult
    shared_extra = 0.0
    if cfg.family == "hybrid":
        shared_extra = _shared_block_flops(cfg, ctx) * seq * mult
    for i in range(cfg.n_layers):
        flops = per_layer
        shared_group = None
        wb = lw
        if cfg.family == "hybrid" and i % cfg.shared_attn_every == 0:
            flops += shared_extra
            shared_group = "shared_attn"
            wb += int((2 * cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads)
                       * cfg.hd + 3 * cfg.d_model * cfg.d_ff) * 2)
        blocks.append(Block(f"layer{i:03d}", flops=flops, weight_bytes=wb,
                            out_bytes=act, act_bytes=act * 4,
                            shared_group=shared_group))
    head_w = 0 if cfg.tie_embeddings else cfg.d_model * cfg.vocab * 2
    blocks.append(Block("head", flops=_logit_flops(cfg, seq) * (3 if train else 1),
                        weight_bytes=head_w,
                        out_bytes=seq * 4,        # predictions
                        act_bytes=seq * cfg.vocab * 4))
    return BlockGraph(name=cfg.name, blocks=tuple(blocks),
                      input_bytes=seq * 4, output_bytes=seq * 4)


def choose_pipeline_cuts(cfg: ArchConfig, seq: int, n_pods: int,
                         chips_per_pod: int = 1, batch: int = 1,
                         train: bool = True,
                         objective: str = "throughput", *,
                         scenario: Scenario | None = None):
    """ParetoPipe-driven stage assignment: solve the k-way partition over
    the arch's block graph on the pod chain, return layer cut indices
    usable by ``PipelineConfig`` (embed/head pinned to first/last pod).
    The chain is ``card_pods(n_pods, chips_per_pod)``, the H100s a stage
    runs on, or ``scenario`` when given: then of ``n_pods`` devices, with
    ``chips_per_pod`` left at 1 (a chain is named one way or the other)."""
    from ..core import dp_front_kway, best_latency, best_throughput
    from ..core.scenarios import card_pods

    if scenario is None:
        scen = card_pods(n_pods, chips_per_pod)
    elif chips_per_pod != 1 or len(scenario.devices) != n_pods:
        raise ValueError(f"scenario {scenario.name!r} names the chain: "
                         f"{len(scenario.devices)} pods, not {n_pods} of "
                         f"{chips_per_pod} chips")
    else:
        scen = scenario
    graph = arch_block_graph(cfg, seq, train=train)
    front = dp_front_kway(graph, scen.devices, scen.links, batch=batch)
    pick = best_throughput(front) if objective == "throughput" \
        else best_latency(front)
    # block index → layer index (block 0 is embed)
    cuts = tuple(min(max(c - 1, 1), cfg.n_layers - 1) for c in pick.partition)
    return cuts, pick, front
