"""Adaptive split selection under changing network conditions.

The paper's headline deployment finding (Sec. V-B): a split chosen under
lab conditions becomes wrong when the network degrades, so partitioning
must be *network-aware*.  The paper leaves adaptive selection to future
work; we implement it:

  * ``LinkEstimator`` — EWMA estimates of RTT and bandwidth from observed
    transfers (what a runtime actually sees).  The executable runtime
    (``runtime.adaptive``) feeds one estimator per hop straight from its
    emulated-wire observations.
  * ``AdaptiveSplitter`` — re-solves the Pareto front for the *whole*
    device chain (any depth, via ``partitioner.solve``) with the
    estimated links, picks a point for the active policy (min-latency /
    max-throughput / min-energy / knee), and migrates only when the
    predicted gain beats a hysteresis threshold (migration = redeploying
    weights, which has a real cost the runtime charges via
    ``migration_cost_s`` — and a *joule* cost, ``migration_energy_j``:
    the moved blocks' weights crossing each hop at its radio price;
    with ``amortize_horizon_s`` set, both must be amortized by the
    predicted per-batch savings within the horizon before the splitter
    will move).  An ``energy_budget_j`` (joules/batch) turns
    any policy into a constrained pick: candidates above the budget are
    dropped before the policy chooses, falling back to the least-energy
    point when nothing fits — a battery-bound Pi deployment re-solving
    under its power envelope.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal, Sequence

from .blocks import BlockGraph
from .codecs import CodecCalibration
from .costmodel import CostTable, PipelineMetrics, evaluate_pipeline
from .devices import (Link, LinkTrace, attribute_bandwidth,
                      fit_link_params_robust, link_at)
from .pareto import knee_point
from .partitioner import (best_accuracy, best_energy, best_latency,
                          best_throughput, solve, solve_with_codecs)
from .scenarios import Scenario

Policy = Literal["latency", "throughput", "energy", "knee"]


@dataclass
class LinkEstimator:
    """Link-condition estimator fed by observed transfers.

    The link model is ``elapsed = rtt/2 + overhead + nbytes/bw``.  RTT
    comes from header-only probes (EWMA — probes measure it directly).
    For data transfers the estimator accumulates ``(nbytes, elapsed)``
    pairs in a sliding window and, once the window spans more than one
    message size, fits (overhead, bw) **jointly** by least squares:
    slope → 1/bw, intercept − rtt/2 → per-message overhead.  This fixes
    the classic EWMA failure mode where the fixed per-message cost of
    tiny transfers is mis-attributed to bandwidth.  Until the window is
    informative (too few samples, or all one size) it falls back to the
    bounded per-sample EWMA attribution.
    """

    rtt_s: float
    bw_bytes_per_s: float
    alpha: float = 0.3
    per_msg_overhead_s: float = 0.0
    window: int = 64                  # (nbytes, elapsed) pairs kept for the fit
    min_fit_samples: int = 4
    _nbytes: list = field(default_factory=list, repr=False)
    _elapsed: list = field(default_factory=list, repr=False)

    @classmethod
    def from_link(cls, link, alpha: float = 0.3) -> "LinkEstimator":
        """Seed the estimator with a link's nominal (t=0) conditions."""
        l = link_at(link, 0.0)
        return cls(rtt_s=l.rtt_s, bw_bytes_per_s=l.bw_bytes_per_s, alpha=alpha,
                   per_msg_overhead_s=l.per_msg_overhead_s)

    def observe(self, nbytes: float, elapsed_s: float, is_rtt_probe: bool = False):
        if is_rtt_probe or nbytes <= 0:
            self.rtt_s = (1 - self.alpha) * self.rtt_s + self.alpha * elapsed_s
            return
        self._nbytes.append(float(nbytes))
        self._elapsed.append(float(elapsed_s))
        if len(self._nbytes) > self.window:
            del self._nbytes[0], self._elapsed[0]
        if len(self._nbytes) >= self.min_fit_samples and self._fit():
            return
        # fallback: per-sample attribution of elapsed = rtt/2 + overhead
        # + bytes/bw (bounded, see devices.attribute_bandwidth)
        bw = attribute_bandwidth(nbytes, elapsed_s, self.rtt_s,
                                 self.per_msg_overhead_s)
        self.bw_bytes_per_s = (1 - self.alpha) * self.bw_bytes_per_s + self.alpha * bw

    def _fit(self) -> bool:
        """Joint least-squares of (overhead, bw) over the window,
        MAD-gated (``fit_link_params_robust``) so the heavy-tailed
        records a *real* transport produces (scheduler preemption
        inflating a few transfers) do not drag the slope; False when
        the window is degenerate (single message size / bad slope)."""
        fit = fit_link_params_robust(self._nbytes, self._elapsed, self.rtt_s)
        if fit is None:
            return False                       # keep the EWMA fallback
        bw, overhead = fit
        self.bw_bytes_per_s = ((1 - self.alpha) * self.bw_bytes_per_s
                               + self.alpha * bw)
        self.per_msg_overhead_s = ((1 - self.alpha) * self.per_msg_overhead_s
                                   + self.alpha * overhead)
        return True

    def as_link(self, name: str = "estimated") -> Link:
        return Link(name, rtt_s=self.rtt_s, bw_bytes_per_s=self.bw_bytes_per_s,
                    per_msg_overhead_s=self.per_msg_overhead_s)


@dataclass
class AdaptiveSplitter:
    graph: BlockGraph
    scenario: Scenario
    batch: int = 8
    policy: Policy = "knee"
    costs: CostTable | None = None
    hysteresis: float = 0.10          # required relative improvement
    # one-off wall-clock cost of moving the split.  None (the default)
    # computes it per candidate move: the moved blocks' weight bytes
    # crossing each hop at that hop's *current estimated* transfer time,
    # plus ``migration_overhead_s``.  A float pins the legacy constant.
    migration_cost_s: float | None = None
    # fixed redeploy overhead (process teardown/rebuild, jit re-warm)
    # added on top of the weight-shipping time when the cost is computed;
    # also the full charge of a codec-only switch (no weights move, but
    # the RECONFIG + in-band WARMUP still cost real time)
    migration_overhead_s: float = 0.05
    energy_budget_j: float | None = None   # max joules/batch (None = unbounded)
    # joint partition × per-hop codec search: when set, every step
    # re-solves over this codec menu (``partitioner.solve_with_codecs``)
    # and a migration may change codecs, cuts, or both — congestion
    # coarsens the wire, recovery refines it.  None pins the scenario's
    # declared codecs (or uncoded).
    codec_choices: Sequence[str] | None = None
    # minimum predicted end-task fidelity: candidates below the floor
    # are dropped before the policy picks (mirroring energy_budget_j)
    accuracy_floor: float | None = None
    # measured per-cut per-codec degradation table (core.codecs
    # .calibrate_codecs); None falls back to nominal codec figures
    calibration: CodecCalibration | None = None
    # per-stage replica counts for the re-solve: a fixed vector, or
    # "auto" to let every step run the greedy spare-device search
    # (partitioner._search_replicas).  Ignored by the joint codec search
    # (codec_choices) — replica × codec co-search is a follow-on.
    replicas: "Sequence[int] | str | None" = None
    # energy-aware migration hysteresis: when set, a candidate split must
    # amortize *both* migration currencies within this horizon — the
    # wall-clock redeploy cost (``migration_cost_s``) out of its per-batch
    # time saving, and the joules of shipping the moved weights over the
    # crossed hops (``migration_energy_j``) out of its per-batch energy
    # saving.  None keeps the plain relative-gain hysteresis.
    amortize_horizon_s: float | None = None
    # the charges computed for the last accepted migration; the runtime
    # charges/records them (wall-clock stall + weights-over-wire joules)
    last_migration_cost_s: float = 0.0
    last_migration_cost_j: float = 0.0
    # charge orchestrator dispatch/return IO in the model?  True for the
    # paper's analytic studies; the executable runtime has no dispatch
    # hop, so the closed loop (runtime.adaptive) solves with False to
    # optimize the objective the pipeline actually exhibits.
    include_io: bool = True
    current: PipelineMetrics | None = None
    history: list = field(default_factory=list)

    def _pick(self, points) -> PipelineMetrics:
        feas = [p for p in points if p.feasible] or points
        if self.accuracy_floor is not None:
            within = [p for p in feas if p.accuracy >= self.accuracy_floor]
            # nothing above the floor: degrade to the most-accurate point
            feas = within or [best_accuracy(feas)]
        if self.energy_budget_j is not None:
            within = [p for p in feas if p.energy_j <= self.energy_budget_j]
            # nothing under budget: degrade to the least-energy point
            feas = within or [best_energy(feas)]
        if self.policy == "latency":
            return best_latency(feas)
        if self.policy == "throughput":
            return best_throughput(feas)
        if self.policy == "energy":
            return best_energy(feas)
        return knee_point(feas) or best_throughput(feas)

    def _objective(self, m: PipelineMetrics) -> float:
        """Lower is better (throughput negated)."""
        if self.policy == "latency":
            return m.latency_s
        if self.policy == "energy":
            return m.energy_j
        return -m.throughput

    def _with_links(self, links) -> Scenario:
        """Scenario with hop links overridden.

        ``links`` may be None (nominal scenario), a single Link (hop 0,
        the 2-stage convention), or a per-hop sequence where ``None``
        entries keep the scenario's own link."""
        scen = self.scenario
        if links is None:
            return scen
        if isinstance(links, (Link, LinkTrace)):
            links = (links,)
        for i, l in enumerate(links):
            if l is not None:
                scen = scen.with_link(i, l, name=scen.name)
        return scen

    def solve(self, link: Link | Sequence[Link | None] | None = None
              ) -> PipelineMetrics:
        return self._pick(self._solve_points(self._with_links(link)))

    def _solve_points(self, scen: Scenario):
        if self.codec_choices is not None:
            # joint partition × codec search keeps all four axes so the
            # accuracy trades stay visible to _pick
            return solve_with_codecs(
                self.graph, scen, self.codec_choices, batch=self.batch,
                costs=self.costs, include_io=self.include_io, objectives=4,
                calibration=self.calibration,
                accuracy_floor=self.accuracy_floor)
        # when energy drives the pick (policy or budget), the DP path must
        # keep the energy axis, or energy-optimal splits get pruned as
        # (latency, throughput)-dominated before _pick ever sees them;
        # an accuracy constraint likewise needs the accuracy axis kept
        objectives = (("latency", "throughput", "energy")
                      if self.policy == "energy"
                      or self.energy_budget_j is not None else None)
        if self.accuracy_floor is not None or self.calibration is not None:
            objectives = 4
        return solve(self.graph, scen, batch=self.batch, costs=self.costs,
                     include_io=self.include_io, objectives=objectives,
                     calibration=self.calibration,
                     accuracy_floor=self.accuracy_floor,
                     replicas=self.replicas)

    def _moved_bytes(self, old: tuple[int, ...], new: tuple[int, ...],
                     new_replicas: Sequence[int] | None = None
                     ) -> dict[int, float]:
        """Weight bytes crossing each hop when redeploying ``old`` →
        ``new``: every block that changes stage ships its weights across
        the hops between its old and new host.  A block landing on a
        stage replicated ``r``× ships ``r`` copies over each crossed hop
        (every replica holds the full stage weights; the source keeps
        one copy to ship from, so only the *destination* count
        multiplies).  → {hop index: bytes}."""
        n = len(self.graph.blocks)
        ob, nb = (0, *old, n), (0, *new, n)

        def stage_of(bounds, b):
            for s in range(len(bounds) - 1):
                if bounds[s] <= b < bounds[s + 1]:
                    return s
            raise ValueError(f"block {b} outside bounds {bounds}")

        moved: dict[int, float] = {}
        for b, blk in enumerate(self.graph.blocks):
            s0, s1 = stage_of(ob, b), stage_of(nb, b)
            if s0 == s1:
                continue
            copies = (new_replicas[s1] if new_replicas is not None else 1)
            for hop in range(min(s0, s1), max(s0, s1)):
                moved[hop] = moved.get(hop, 0.0) + blk.weight_bytes * copies
        return moved

    def migration_energy_j(self, old: tuple[int, ...],
                           new: tuple[int, ...],
                           new_replicas: Sequence[int] | None = None
                           ) -> float:
        """Joules to redeploy from cuts ``old`` to ``new``: the moved
        weight bytes at each crossed hop's ``energy_per_byte_j`` (times
        the destination stage's replica count — r copies ship)."""
        links = [link_at(l, 0.0) for l in self.scenario.links]
        return sum(links[hop].energy_per_byte_j * nbytes
                   for hop, nbytes in
                   self._moved_bytes(old, new, new_replicas).items())

    def migration_time_s(self, old: tuple[int, ...], new: tuple[int, ...],
                         links: Sequence[Link] | None = None,
                         new_replicas: Sequence[int] | None = None) -> float:
        """Wall-clock to redeploy ``old`` → ``new``: the moved weight
        bytes crossing each hop at its transfer time under ``links``
        (the step's fitted estimates; defaults to the scenario's nominal
        links), plus the fixed ``migration_overhead_s``.  A configured
        ``migration_cost_s`` constant overrides the computation."""
        if self.migration_cost_s is not None:
            return self.migration_cost_s
        if links is None:
            links = [link_at(l, 0.0) for l in self.scenario.links]
        return self.migration_overhead_s + sum(
            links[hop].transfer_time(nbytes)
            for hop, nbytes in
            self._moved_bytes(old, new, new_replicas).items()
            if nbytes > 0)

    def _amortizes(self, cur: PipelineMetrics, cand: PipelineMetrics,
                   cost_j: float, cost_s: float | None = None) -> bool:
        """Does the candidate pay back both migration currencies within
        ``amortize_horizon_s``?  Batches served in the horizon come from
        the candidate's own throughput (the post-migration rate)."""
        horizon = self.amortize_horizon_s
        if horizon is None:
            return True
        if cost_s is None:
            cost_s = self.migration_time_s(cur.partition, cand.partition)
        batch_time = self.batch / max(cand.throughput, 1e-12)
        n = max(horizon / max(batch_time, 1e-12), 0.0)
        # time currency: per-batch serving-time saving must cover the
        # redeploy stall within the horizon (vacuously true for a free
        # move — an energy-motivated migration may well be time-neutral)
        t_cur = self.batch / max(cur.throughput, 1e-12)
        if cost_s > 0.0 and (t_cur - batch_time) * n < cost_s:
            return False
        # energy currency: per-batch joule saving must cover the weight
        # shipment (vacuously true for a free move)
        if cost_j > 0.0 and (cur.energy_j - cand.energy_j) * n < cost_j:
            return False
        return True

    def _reprice(self, partition: tuple[int, ...], scen: Scenario,
                 codecs: Sequence[str] | None = None,
                 replicas: Sequence[int] | None = None
                 ) -> PipelineMetrics | None:
        """Re-evaluate the *current* cuts (and codecs/replicas) under
        new conditions; None when the cut vector is no longer valid for
        the graph/chain (e.g. the graph or pipeline depth changed
        between steps)."""
        static = scen.at(0.0)
        try:
            return evaluate_pipeline(self.graph, partition, static.devices,
                                     static.links, batch=self.batch,
                                     costs=self.costs,
                                     include_io=self.include_io,
                                     codecs=codecs,
                                     calibration=self.calibration,
                                     replicas=replicas)
        except ValueError:
            return None

    def step(self, estimator: "LinkEstimator | Sequence[LinkEstimator]"
             ) -> tuple[PipelineMetrics, bool]:
        """Re-evaluate with the current link estimate(s).

        ``estimator`` is one LinkEstimator (2-stage convention: hop 0) or
        a per-hop sequence.  Returns the active partition and whether a
        migration happened."""
        ests = ([estimator] if isinstance(estimator, LinkEstimator)
                else list(estimator))
        links = [e.as_link(f"est_hop{i}") for i, e in enumerate(ests)]
        scen = self._with_links(links)
        cand = self._pick(self._solve_points(scen))
        migrated = False
        self.last_migration_cost_s = 0.0
        self.last_migration_cost_j = 0.0
        if self.current is None:
            self.current, migrated = cand, True
        elif (cand.partition != self.current.partition
              or cand.codecs != self.current.codecs):
            cost_j = self.migration_energy_j(self.current.partition,
                                             cand.partition,
                                             new_replicas=cand.replicas
                                             or None)
            # codec-only switches move no weights: cost_s degrades to the
            # fixed overhead (still charged — RECONFIG + WARMUP are real)
            cost_s = self.migration_time_s(self.current.partition,
                                           cand.partition, links,
                                           new_replicas=cand.replicas
                                           or None)
            # re-price the *current* split (and codecs) under the new
            # conditions
            cur = self._reprice(self.current.partition, scen,
                                codecs=self.current.codecs or None,
                                replicas=self.current.replicas or None)
            if cur is None:
                # current cuts are stale/invalid — must migrate
                self.current, migrated = cand, True
            elif (self.energy_budget_j is not None
                  and cur.energy_j > self.energy_budget_j >= cand.energy_j):
                # current split violates the energy budget and the
                # candidate fits: a constraint breach overrides hysteresis
                # (and the amortization gate — staying put keeps burning
                # over-budget joules every batch)
                self.current, migrated = cand, True
            else:
                old, new = self._objective(cur), self._objective(cand)
                gain = (old - new) / max(abs(old), 1e-12)
                if gain > self.hysteresis and self._amortizes(cur, cand,
                                                              cost_j,
                                                              cost_s=cost_s):
                    self.current, migrated = cand, True
                else:
                    self.current = cur
            if migrated:
                self.last_migration_cost_s = cost_s
                self.last_migration_cost_j = cost_j
        else:
            self.current = cand
        self.history.append((self.current.partition, migrated))
        return self.current, migrated
