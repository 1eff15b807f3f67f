"""Pipeline performance model — the analytical heart of ParetoPipe.

Given a ``BlockGraph``, an assignment of contiguous block ranges to
devices, and the links between consecutive devices, predict:

  * **end-to-end latency per batch** — one batch flowing through the
    whole pipeline: input dispatch + every stage's compute + every
    inter-stage transfer + result return (paper Sec. IV-C measures
    exactly this),
  * **steady-state throughput** — successive batches pipeline, so the
    bottleneck is the slowest stage *cycle* (its compute plus its
    non-overlapped sends),
  * **energy per batch** — per stage, device active power × compute time
    plus idle power × its outbound wire wait plus the link's radio cost ×
    bytes sent (Kreß et al., arXiv:2406.19913 treat exactly this
    compute+radio decomposition as the edge partitioning energy model);
    with ``include_io`` the dispatch/return hops add their radio cost.
    The sum is additive over stages, which is what lets ``dp_front_kway``
    carry it as a third monotone DP label,
  * per-stage breakdowns and memory feasibility.

Validation against the paper (Table II, MobileNetV2 P3, batch 8):
  exe 0.969 s + 0.941 s + net 0.048 s → latency ≈ 1.96 s and throughput
  ≈ 8/(0.969+0.048) ≈ 7.9 img/s — the paper reports 7.8 img/s, i.e. the
  bottleneck-cycle model (compute + outbound transfer) is the right one.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Sequence

from .blocks import BlockGraph
from .codecs import CodecCalibration, codec_wire_bytes, get_codec
from .devices import DeviceProfile, Link
from .pareto import ObjectiveLike, vector as objective_vector


class CostTable:
    """Measured per-(device, block) execution times in seconds (per batch).

    Overrides the analytic flops/eff_flops model where present — this is
    the paper's block-wise profiling (Fig. 2) feeding the partitioner."""

    def __init__(self, entries: Mapping[tuple[str, str], float] | None = None):
        self._t: dict[tuple[str, str], float] = dict(entries or {})

    def set(self, device: str, block: str, seconds: float) -> None:
        self._t[(device, block)] = seconds

    def get(self, device: str, block: str) -> float | None:
        return self._t.get((device, block))

    def __len__(self) -> int:
        return len(self._t)


@dataclass(frozen=True)
class StageMetrics:
    device: str
    blocks: tuple[int, int]        # [lo, hi) block range
    compute_s: float
    send_s: float                  # outbound transfer time (0 for last stage)
    weight_bytes: int
    mem_ok: bool
    energy_j: float = 0.0          # active×compute + idle×send + radio×bytes
    send_wire_bytes: float = 0.0   # codec-packed bytes on the outbound hop
    replicas: int = 1              # devices running this stage in parallel


@dataclass(frozen=True)
class PipelineMetrics:
    partition: tuple[int, ...]     # cut points; stage i = blocks[cuts[i]:cuts[i+1]]
    latency_s: float               # end-to-end per batch
    throughput: float              # samples / s, steady state
    stages: tuple[StageMetrics, ...]
    net_s: float                   # total wire time per batch
    feasible: bool                 # all stages fit in device memory
    energy_j: float = 0.0          # joules per batch, all stages + IO radio
    # the fourth Pareto axis: predicted end-task fidelity under this
    # partition's per-hop wire codecs (product of per-cut top-1
    # agreements from the calibration; 1.0 = every hop uncoded)
    accuracy: float = 1.0
    codecs: tuple[str, ...] = ()   # per-hop codec names ((): all "none")
    replicas: tuple[int, ...] = ()  # per-stage replica counts ((): all 1)

    @property
    def bottleneck_s(self) -> float:
        # a stage on r devices drains r batches per cycle: its share of
        # the steady-state period is (compute + send) / r
        return max((s.compute_s + s.send_s) / s.replicas
                   for s in self.stages)

    def objectives(self, objectives: Sequence[ObjectiveLike] | None = None
                   ) -> tuple[float, ...]:
        """This partition's objective vector (default: latency, throughput)."""
        return objective_vector(self, objectives)


def _stage_time(graph: BlockGraph, lo: int, hi: int, dev: DeviceProfile,
                batch: int, costs: CostTable | None) -> float:
    """Batch execution time of blocks[lo:hi] on ``dev``."""
    t = 0.0
    analytic_flops = 0.0
    for b in graph.blocks[lo:hi]:
        m = costs.get(dev.name, b.name) if costs is not None else None
        if m is not None:
            t += m
        else:
            analytic_flops += b.flops * batch / max(b.eff, 1e-6)
    if analytic_flops > 0:
        t += analytic_flops / dev.flops_per_s
    if hi > lo:
        t += dev.stage_overhead_s
    return t


def _stage_energy(dev: DeviceProfile, compute_s: float, send_s: float,
                  send_bytes: float, link: Link | None) -> float:
    """Joules one stage spends per batch: busy while computing, idle
    while its outbound transfer drains, radio cost per byte on the wire."""
    e = dev.active_w * compute_s + dev.idle_w * send_s
    if link is not None and send_bytes > 0:
        e += link.transfer_energy(send_bytes)
    return e


def evaluate_pipeline(
    graph: BlockGraph,
    cuts: Sequence[int],
    devices: Sequence[DeviceProfile],
    links: Sequence[Link],
    batch: int = 1,
    costs: CostTable | None = None,
    dispatch_link: Link | None = None,
    include_io: bool = True,
    codecs: Sequence[str] | None = None,
    calibration: CodecCalibration | None = None,
    replicas: Sequence[int] | None = None,
) -> PipelineMetrics:
    """Evaluate one partition.

    ``cuts`` are the interior cut points: stage i runs blocks
    [cuts[i], cuts[i+1]) with implicit cuts[-1]=0 and cuts[k]=n.
    ``len(devices) == len(cuts) + 1`` and ``len(links) == len(cuts)``.
    ``dispatch_link`` models orchestrator→worker1 input dispatch and
    workerN→orchestrator result return (paper Alg. 1 lines 5–9); defaults
    to the first link.

    ``codecs`` names the per-hop wire codec for each of the
    ``len(cuts)`` inter-stage hops (None = all ``none``): hop bytes
    become the codec's analytic packed size — exactly what the runtime
    ships (``TransferRecord.wire_bytes``) — and the predicted
    ``accuracy`` is the product of per-cut degradations from
    ``calibration`` (falling back to each codec's nominal figure).
    Dispatch/return IO is orchestrator plumbing and ships uncoded.

    ``replicas`` gives the per-stage replica count (None = all 1): a
    stage placed on ``r`` identical devices drains ``r`` batches per
    cycle, so it contributes ``(compute + send) / r`` to the
    steady-state bottleneck while one batch's *latency* through it is
    unchanged (a single batch still traverses exactly one replica) —
    the latency/throughput tension replication buys. Energy charges the
    extra ``r - 1`` devices idle power over the stage's per-batch
    period on top of the usual active/idle/radio terms, so replication
    always costs joules while (only sometimes) buying throughput.
    """
    n = graph.n_blocks
    full = (0, *cuts, n)
    n_stages = len(devices)
    if len(cuts) != n_stages - 1 or len(links) != n_stages - 1:
        raise ValueError("need len(devices)-1 cuts and links")
    if codecs is not None and len(codecs) != n_stages - 1:
        raise ValueError(f"need {n_stages - 1} per-hop codecs, "
                         f"got {len(codecs)}")
    if replicas is not None:
        if len(replicas) != n_stages:
            raise ValueError(f"need {n_stages} per-stage replica counts, "
                             f"got {len(replicas)}")
        if any(r < 1 for r in replicas):
            raise ValueError(f"replica counts must be >= 1: {replicas!r}")
    reps = tuple(replicas) if replicas is not None else (1,) * n_stages
    for a, b in zip(full, full[1:]):
        if not (0 <= a <= b <= n):
            raise ValueError(f"bad cuts {cuts!r} for {n} blocks")

    dlink = dispatch_link or (links[0] if links else None)

    stages: list[StageMetrics] = []
    latency = 0.0
    net_total = 0.0
    energy = 0.0
    feasible = True

    if include_io and dlink is not None:
        in_bytes = graph.cut_bytes(0) * batch
        t_in = dlink.transfer_time(in_bytes)
        latency += t_in
        net_total += t_in
        energy += dlink.transfer_energy(in_bytes)

    accuracy = 1.0
    cycle_times: list[float] = []
    for i in range(n_stages):
        lo, hi = full[i], full[i + 1]
        dev = devices[i]
        comp = _stage_time(graph, lo, hi, dev, batch, costs)
        send = 0.0
        send_bytes = 0.0
        link = None
        if i < n_stages - 1:
            link = links[i]
            send_bytes = graph.cut_bytes(hi) * batch
            if codecs is not None:
                codec = get_codec(codecs[i])
                send_bytes = codec_wire_bytes(codec, send_bytes)
                accuracy *= (calibration.accuracy(hi, codec)
                             if calibration is not None
                             else codec.nominal_accuracy)
            send = link.transfer_time(send_bytes)
        r = reps[i]
        e = _stage_energy(dev, comp, send, send_bytes, link)
        # the r-1 extra replicas burn idle power across the stage's
        # per-batch period — replication is never free in joules
        e += (r - 1) * dev.idle_w * (comp + send) / r
        wbytes = graph.segment_weight_bytes(lo, hi)
        abytes = max((b.act_bytes * batch for b in graph.blocks[lo:hi]), default=0)
        ok = wbytes + abytes <= dev.mem_bytes   # per replica: each holds a copy
        feasible &= ok
        stages.append(StageMetrics(device=dev.name, blocks=(lo, hi),
                                   compute_s=comp, send_s=send,
                                   weight_bytes=wbytes, mem_ok=ok,
                                   energy_j=e, send_wire_bytes=send_bytes,
                                   replicas=r))
        latency += comp + send
        net_total += send
        energy += e
        cycle_times.append((comp + send) / r)

    if include_io and dlink is not None:
        out_bytes = graph.output_bytes * batch
        t_out = dlink.transfer_time(out_bytes)
        latency += t_out
        net_total += t_out
        energy += dlink.transfer_energy(out_bytes)
        cycle_times[-1] += t_out

    bottleneck = max(cycle_times)
    throughput = batch / bottleneck if bottleneck > 0 else float("inf")
    return PipelineMetrics(partition=tuple(cuts), latency_s=latency,
                           throughput=throughput, stages=tuple(stages),
                           net_s=net_total, feasible=feasible,
                           energy_j=energy, accuracy=accuracy,
                           codecs=(tuple(get_codec(c).name for c in codecs)
                                   if codecs is not None else ()),
                           replicas=(reps if replicas is not None else ()))
