"""Partition-point search.

Three engines, in increasing generality:

  * ``sweep_2way``      — the paper's method: exhaustively evaluate every
                          block-boundary split across a 2-device pipeline.
  * ``sweep_kway``      — exhaustive k-way enumeration (exact; fine up to
                          ~C(n_blocks, k-1) ≈ 1e6 combinations).
  * ``dp_front_kway``   — multi-objective label-correcting DP over the
                          chain: exact Pareto front for k stages in
                          O(k·n²·|labels|), used when enumeration blows
                          up (many pods / many blocks).  Labels carry one
                          monotone scalar per active objective — latency,
                          bottleneck cycle (↔ throughput), and energy are
                          each monotone under chain extension, so pruning
                          dominated labels is exact for any subset.

``solve`` is the unified scenario-driven entry point: it picks the right
engine for the problem size, so callers (AdaptiveSplitter, the runtime,
benchmarks) never hard-code a pipeline depth.  Pass
``objectives=("latency", "throughput", "energy")`` to widen the DP front
to the 3-D trade-off surface; the default is the paper's bi-objective
pair, and sweeps always return every evaluated point regardless.

All return ``PipelineMetrics`` lists; compose with ``pareto.pareto_front``.
"""
from __future__ import annotations

import itertools
import math
from collections import Counter
from typing import Sequence

from .blocks import BlockGraph
from .codecs import CodecCalibration, get_codec
from .costmodel import (CostTable, PipelineMetrics, _stage_energy,
                        evaluate_pipeline)
from .devices import DeviceProfile, Link, link_at
from .pareto import (ObjectiveLike, min_front, pareto_front,
                     resolve_objectives)


def _floor_filter(points: list[PipelineMetrics],
                  accuracy_floor: float | None) -> list[PipelineMetrics]:
    """Drop partitions whose predicted accuracy is below the floor."""
    if accuracy_floor is None:
        return points
    return [p for p in points if p.accuracy >= accuracy_floor]


def _check_replicas(replicas, k: int) -> tuple[int, ...] | None:
    """Validate a fixed per-stage replica vector (None = all 1)."""
    if replicas is None:
        return None
    reps = tuple(int(r) for r in replicas)
    if len(reps) != k:
        raise ValueError(f"need {k} per-stage replica counts, got {len(reps)}")
    if any(r < 1 for r in reps):
        raise ValueError(f"replica counts must be >= 1: {reps!r}")
    return reps


def replicas_feasible(replicas: Sequence[int],
                      devices: Sequence[DeviceProfile],
                      spare_devices: Sequence[DeviceProfile]) -> bool:
    """Can this replica vector be staffed from the scenario's spares?

    Stage i placed on ``r`` devices needs ``r - 1`` spares whose profile
    *name* matches the stage's assigned device (replicas are identical
    copies — the cost model charges every copy the same compute)."""
    need: Counter[str] = Counter()
    for r, d in zip(replicas, devices):
        need[d.name] += r - 1
    have = Counter(s.name for s in spare_devices)
    return all(have[name] >= cnt for name, cnt in need.items())


def solve(
    graph: BlockGraph,
    scenario,
    batch: int = 1,
    costs: CostTable | None = None,
    include_io: bool = True,
    at_time: float = 0.0,
    max_enum: int = 50_000,
    objectives: Sequence[ObjectiveLike] | int | None = None,
    codecs: Sequence[str] | None = None,
    calibration: CodecCalibration | None = None,
    accuracy_floor: float | None = None,
    replicas: Sequence[int] | str | None = None,
) -> list[PipelineMetrics]:
    """Scenario-driven partition search — the one entry point.

    Dispatches on problem size: ``sweep_2way`` for 2-device chains (every
    point, the paper's method), ``sweep_kway`` while exhaustive k-way
    enumeration stays under ``max_enum`` combinations, ``dp_front_kway``
    beyond that (returns only the exact Pareto front).  Time-varying
    links are resolved to their state at ``at_time``.  ``objectives``
    selects the active objective set for the DP front (default: the
    paper's (latency, throughput) pair; ``objectives=4`` is the
    canonical latency/throughput/energy/accuracy set).

    ``codecs`` fixes the per-hop wire codecs (default: the scenario's
    ``codecs`` declaration, else uncoded); with a codec in play the
    metrics carry packed hop bytes and the accuracy axis (measured via
    ``calibration`` where supplied).  ``accuracy_floor`` drops every
    point whose predicted accuracy falls below it — the returned front
    respects the floor on all engines.

    ``replicas`` assigns per-stage replica counts: a fixed vector is
    plumbed through every engine unchecked (what-if analysis — the
    caller supplies the hardware), while ``"auto"`` runs a
    ``best_throughput``-driven greedy search that staffs extra replicas
    from the scenario's ``spare_devices`` (matched by profile name) as
    long as each added replica strictly improves the best achievable
    steady-state throughput.  The auto pool contains the unreplicated
    baseline plus every accepted step, so latency/energy-optimal picks
    still see the r=1 points.
    """
    if isinstance(replicas, str):
        if replicas != "auto":
            raise ValueError(f"replicas must be a vector, 'auto' or None, "
                             f"got {replicas!r}")
        return _search_replicas(graph, scenario, batch=batch, costs=costs,
                                include_io=include_io, at_time=at_time,
                                max_enum=max_enum, objectives=objectives,
                                codecs=codecs, calibration=calibration,
                                accuracy_floor=accuracy_floor)
    devices = tuple(scenario.devices)
    links = tuple(link_at(l, at_time) for l in scenario.links)
    k = len(devices)
    if k < 1 or len(links) != k - 1:
        raise ValueError("scenario needs >=1 device and len(devices)-1 links")
    if graph.n_blocks < k:
        raise ValueError(
            f"{k}-stage scenario {getattr(scenario, 'name', '?')!r} needs "
            f">= {k} blocks, graph {graph.name!r} has {graph.n_blocks}")
    if codecs is None:
        codecs = getattr(scenario, "codecs", None)
    reps = _check_replicas(replicas, k)
    if k == 1:
        return [evaluate_pipeline(graph, (), devices, (), batch=batch,
                                  costs=costs, include_io=include_io,
                                  replicas=reps)]
    if k == 2:
        return _floor_filter(
            sweep_2way(graph, devices, links[0], batch=batch, costs=costs,
                       include_io=include_io, codecs=codecs,
                       calibration=calibration, replicas=reps),
            accuracy_floor)
    if math.comb(graph.n_blocks - 1, k - 1) <= max_enum:
        return _floor_filter(
            sweep_kway(graph, devices, links, batch=batch, costs=costs,
                       include_io=include_io, codecs=codecs,
                       calibration=calibration, replicas=reps),
            accuracy_floor)
    return dp_front_kway(graph, devices, links, batch=batch, costs=costs,
                         include_io=include_io, objectives=objectives,
                         codecs=codecs, calibration=calibration,
                         accuracy_floor=accuracy_floor, replicas=reps)


def sweep_2way(
    graph: BlockGraph,
    devices: Sequence[DeviceProfile],
    link: Link,
    batch: int = 1,
    costs: CostTable | None = None,
    include_degenerate: bool = False,
    include_io: bool = True,
    codecs: Sequence[str] | None = None,
    calibration: CodecCalibration | None = None,
    replicas: Sequence[int] | None = None,
) -> list[PipelineMetrics]:
    """Every valid split point of a 2-device pipeline (paper Sec. IV-C)."""
    if len(devices) != 2:
        raise ValueError("sweep_2way needs exactly 2 devices")
    lo = 0 if include_degenerate else 1
    hi = graph.n_blocks + (1 if include_degenerate else 0)
    out = []
    for p in range(lo, hi):
        out.append(evaluate_pipeline(graph, (p,), devices, (link,),
                                     batch=batch, costs=costs,
                                     include_io=include_io, codecs=codecs,
                                     calibration=calibration,
                                     replicas=replicas))
    return out


def sweep_kway(
    graph: BlockGraph,
    devices: Sequence[DeviceProfile],
    links: Sequence[Link],
    batch: int = 1,
    costs: CostTable | None = None,
    allow_empty_stages: bool = False,
    include_io: bool = True,
    max_combos: int = 2_000_000,
    codecs: Sequence[str] | None = None,
    calibration: CodecCalibration | None = None,
    replicas: Sequence[int] | None = None,
) -> list[PipelineMetrics]:
    """Exhaustive enumeration of all k-way contiguous partitions."""
    n, k = graph.n_blocks, len(devices)
    if k - 1 != len(links):
        raise ValueError("need len(devices)-1 links")
    pool = range(0, n + 1) if allow_empty_stages else range(1, n)
    combos = math.comb(len(pool), k - 1) if k > 1 else 1
    if combos > max_combos:
        raise ValueError(f"{combos} combinations; use dp_front_kway instead")
    out = []
    for cuts in itertools.combinations(pool, k - 1):
        out.append(evaluate_pipeline(graph, cuts, devices, links,
                                     batch=batch, costs=costs,
                                     include_io=include_io, codecs=codecs,
                                     calibration=calibration,
                                     replicas=replicas))
    return out


# --------------------------------------------------------------------------- #
# Multi-objective DP
# --------------------------------------------------------------------------- #
#: DP-trackable monotone scalars per objective name: the label component
#: is min-convention and monotone non-decreasing under chain extension.
#: "throughput" is tracked as the bottleneck cycle time (throughput =
#: batch / bottleneck is strictly monotone in it); "accuracy" as the
#: negated product of per-cut codec agreements — each hop multiplies by
#: a factor in (0, 1], so -accuracy is monotone non-decreasing and two
#: labels' order is preserved under any shared completion.
_DP_OBJECTIVES = ("latency", "throughput", "energy", "accuracy")


def _prune(labels: list[tuple[tuple[float, ...], tuple[int, ...]]]):
    """Keep non-dominated (vector, cuts) labels (vectors all-minimized)."""
    return min_front(labels)


def dp_front_kway(
    graph: BlockGraph,
    devices: Sequence[DeviceProfile],
    links: Sequence[Link],
    batch: int = 1,
    costs: CostTable | None = None,
    allow_empty_stages: bool = False,
    include_io: bool = True,
    objectives: Sequence[ObjectiveLike] | int | None = None,
    codecs: Sequence[str] | None = None,
    calibration: CodecCalibration | None = None,
    accuracy_floor: float | None = None,
    replicas: Sequence[int] | None = None,
) -> list[PipelineMetrics]:
    """Exact Pareto front over all k-way partitions via label DP.

    A label at state (i devices used, j blocks placed) carries one
    monotone scalar per active objective — cumulative latency, worst
    stage cycle so far (↔ throughput), cumulative energy, accumulated
    codec accuracy — plus the cut vector.  Every component is monotone
    under extension, so dominated labels can never yield a non-dominated
    completion — pruning is exact for any subset of ``_DP_OBJECTIVES``.

    With ``codecs`` fixed per hop, hop bytes are the codec-packed sizes
    and the accuracy component multiplies per-cut degradations (from
    ``calibration`` where measured).  ``accuracy_floor`` prunes labels —
    exactly, since accuracy only falls under extension — and filters the
    returned front.

    With ``replicas`` (fixed per-stage counts), stage i on ``r`` devices
    contributes ``(compute + send) / r`` to the bottleneck component and
    the extra-replica idle joules to the energy component.  Both remain
    per-stage constants once (i, j, j2) is fixed, so every label stays
    monotone under extension and the same d-dimensional prune is exact.
    """
    from .codecs import codec_wire_bytes
    from .costmodel import _stage_time  # internal reuse

    objs = resolve_objectives(objectives)
    for o in objs:
        if o.name not in _DP_OBJECTIVES:
            raise ValueError(
                f"dp_front_kway cannot track objective {o.name!r}: only "
                f"{_DP_OBJECTIVES} are monotone under chain extension")
    track_lat = any(o.name == "latency" for o in objs)
    track_bot = any(o.name == "throughput" for o in objs)
    track_en = any(o.name == "energy" for o in objs)
    track_acc = any(o.name == "accuracy" for o in objs)

    n, k = graph.n_blocks, len(devices)
    if k - 1 != len(links):
        raise ValueError("need len(devices)-1 links")
    hop_codecs = ([get_codec(c) for c in codecs] if codecs is not None
                  else [get_codec("none")] * (k - 1))
    if len(hop_codecs) != k - 1:
        raise ValueError(f"need {k - 1} per-hop codecs, got {len(codecs)}")
    reps = _check_replicas(replicas, k) or (1,) * k

    def cut_accuracy(hop: int, cut: int) -> float:
        codec = hop_codecs[hop]
        if codec.code == 0:
            return 1.0
        return (calibration.accuracy(cut, codec) if calibration is not None
                else codec.nominal_accuracy)

    dlink = links[0] if (include_io and links) else None
    init_lat = dlink.transfer_time(graph.cut_bytes(0) * batch) if dlink else 0.0
    init_en = dlink.transfer_energy(graph.cut_bytes(0) * batch) if dlink else 0.0

    def label_vec(lat: float, bot: float, en: float,
                  acc: float) -> tuple[float, ...]:
        vec = []
        if track_lat:
            vec.append(lat)
        if track_bot:
            vec.append(bot)
        if track_en:
            vec.append(en)
        if track_acc:
            vec.append(-acc)
        return tuple(vec)

    # labels[j] after i stages: list of ((lat, bot, en, acc), cuts); the
    # full vector rides along so pruning can project to the active subset
    labels: dict[int, list] = {0: [((init_lat, 0.0, init_en, 1.0), ())]}
    for i in range(k):
        nxt: dict[int, list] = {}
        last = i == k - 1
        stages_after = k - i - 1       # stages still to fill after this one
        for j, labs in labels.items():
            if last:
                j2_options: Sequence[int] = (n,) if (allow_empty_stages or n > j) else ()
            else:
                lo = j if allow_empty_stages else j + 1
                hi = n if allow_empty_stages else n - stages_after  # leave ≥1 each
                j2_options = range(lo, hi + 1)
            for j2 in j2_options:
                comp = _stage_time(graph, j, j2, devices[i], batch, costs)
                send_bytes = (codec_wire_bytes(hop_codecs[i],
                                               graph.cut_bytes(j2) * batch)
                              if not last else 0.0)
                send = links[i].transfer_time(send_bytes) if not last else 0.0
                out_t = dlink.transfer_time(graph.output_bytes * batch) if (last and dlink) else 0.0
                out_e = dlink.transfer_energy(graph.output_bytes * batch) if (last and dlink) else 0.0
                r = reps[i]
                e_step = _stage_energy(devices[i], comp, send, send_bytes,
                                       links[i] if not last else None) + out_e
                # extra replicas idle across the stage's per-batch period
                e_step += (r - 1) * devices[i].idle_w * (comp + send) / r
                a_step = cut_accuracy(i, j2) if not last else 1.0
                step = comp + send + out_t
                # r replicas drain r batches per cycle; the shared
                # return hop (out_t) stays serial at the orchestrator
                cyc = (comp + send) / r + out_t
                for (lat, bot, en, acc), cuts in labs:
                    nl = lat + step
                    nb = max(bot, cyc)
                    ne = en + e_step
                    na = acc * a_step
                    if accuracy_floor is not None and na < accuracy_floor:
                        continue       # accuracy only falls: prune exactly
                    nc = cuts if last else cuts + (j2,)
                    nxt.setdefault(j2, []).append(((nl, nb, ne, na), nc))
        labels = {j: _prune([(label_vec(*vec), (vec, cuts))
                             for vec, cuts in v])
                  for j, v in nxt.items()}

    finals = labels.get(n, [])
    out = [evaluate_pipeline(graph, cuts, devices, links, batch=batch,
                             costs=costs, include_io=include_io,
                             codecs=codecs, calibration=calibration,
                             replicas=replicas)
           for _, cuts in finals]
    return pareto_front(_floor_filter(out, accuracy_floor), objs)


# Convenience single-objective picks ---------------------------------------- #
def best_latency(points: Sequence[PipelineMetrics]) -> PipelineMetrics:
    feas = [p for p in points if p.feasible] or list(points)
    return min(feas, key=lambda p: p.latency_s)


def best_throughput(points: Sequence[PipelineMetrics]) -> PipelineMetrics:
    feas = [p for p in points if p.feasible] or list(points)
    return max(feas, key=lambda p: p.throughput)


def best_energy(points: Sequence[PipelineMetrics]) -> PipelineMetrics:
    """Lowest joules/batch — the pick for battery-bound deployments."""
    feas = [p for p in points if p.feasible] or list(points)
    return min(feas, key=lambda p: p.energy_j)


def best_accuracy(points: Sequence[PipelineMetrics]) -> PipelineMetrics:
    """Highest predicted fidelity (latency breaks ties)."""
    feas = [p for p in points if p.feasible] or list(points)
    return min(feas, key=lambda p: (-p.accuracy, p.latency_s))


# --------------------------------------------------------------------------- #
# Replica search: staff the bottleneck from the scenario's spare devices
# --------------------------------------------------------------------------- #
def _search_replicas(graph: BlockGraph, scenario,
                     **solve_kwargs) -> list[PipelineMetrics]:
    """Greedy best-improvement replica search (``solve(replicas="auto")``).

    Starts from the unreplicated chain, then repeatedly tries adding one
    replica to each stage that still has a matching spare (same profile
    name in ``scenario.spare_devices``), re-solving the partition each
    time — replication shifts the bottleneck, so the optimal *cuts* move
    with it.  The single best-improving stage is accepted per round;
    the search stops when no spare strictly improves
    ``best_throughput``.  Returns the accumulated pool: baseline points
    plus every accepted assignment's points."""
    devices = tuple(scenario.devices)
    k = len(devices)
    have = Counter(s.name for s in getattr(scenario, "spare_devices", ())
                   or ())
    pool = solve(graph, scenario, **solve_kwargs)
    if not pool:
        return pool
    best_tp = best_throughput(pool).throughput
    reps = [1] * k
    used: Counter[str] = Counter()
    while True:
        winner = None
        for i, dev in enumerate(devices):
            if used[dev.name] >= have[dev.name]:
                continue
            trial = tuple(reps[:i] + [reps[i] + 1] + reps[i + 1:])
            pts = solve(graph, scenario, replicas=trial, **solve_kwargs)
            if not pts:
                continue
            tp = best_throughput(pts).throughput
            if tp > best_tp and (winner is None or tp > winner[0]):
                winner = (tp, i, pts)
        if winner is None:
            return pool
        best_tp, i, pts = winner
        reps[i] += 1
        used[devices[i].name] += 1
        pool.extend(pts)


def sweep_replicas(graph: BlockGraph, scenario,
                   max_assignments: int = 4096,
                   **solve_kwargs) -> list[PipelineMetrics]:
    """Exhaustive replica-assignment sweep — the ground truth the greedy
    ``solve(replicas="auto")`` is cross-validated against in tests.

    Enumerates every per-stage replica vector staffable from
    ``scenario.spare_devices`` (each stage bounded by the count of
    same-name spares, joint feasibility checked per vector) and solves
    the partition under each.  Cost is |assignments| × one ``solve``;
    guarded by ``max_assignments``."""
    devices = tuple(scenario.devices)
    have = Counter(s.name for s in getattr(scenario, "spare_devices", ())
                   or ())
    per_stage = [range(1, 2 + have[d.name]) for d in devices]
    assignments = [reps for reps in itertools.product(*per_stage)
                   if replicas_feasible(reps, devices,
                                        getattr(scenario, "spare_devices",
                                                ()) or ())]
    if len(assignments) > max_assignments:
        raise ValueError(f"{len(assignments)} replica assignments exceed "
                         f"max_assignments={max_assignments}")
    pool: list[PipelineMetrics] = []
    for reps in assignments:
        pool.extend(solve(graph, scenario, replicas=reps, **solve_kwargs))
    return pool


def solve_with_codecs(
    graph: BlockGraph,
    scenario,
    codec_choices: Sequence[str] = ("none", "int8", "fp8", "topk"),
    batch: int = 1,
    costs: CostTable | None = None,
    include_io: bool = True,
    at_time: float = 0.0,
    objectives: Sequence[ObjectiveLike] | int | None = 4,
    calibration: CodecCalibration | None = None,
    accuracy_floor: float | None = None,
) -> list[PipelineMetrics]:
    """Joint partition × per-hop codec search.

    Enumerates every per-hop codec assignment from ``codec_choices``
    (|choices|^(k-1) ``solve`` calls — fine for the paper's 2–4 device
    chains) and returns the joint Pareto front, each point tagged with
    the codec vector that produced it (``PipelineMetrics.codecs``).
    This is the 4-objective front the wire-codec study plots: coarser
    codecs trade the accuracy axis for latency/throughput/energy.
    """
    k = len(scenario.devices)
    objs = resolve_objectives(objectives)
    pool: list[PipelineMetrics] = []
    for assign in itertools.product(codec_choices, repeat=k - 1):
        pool.extend(solve(graph, scenario, batch=batch, costs=costs,
                          include_io=include_io, at_time=at_time,
                          objectives=objs, codecs=assign,
                          calibration=calibration,
                          accuracy_floor=accuracy_floor))
    return pareto_front(pool, objs)
