"""Closed adaptive loop: measure → estimate → re-solve → migrate.

(The PyTorch port of the reference's ``runtime/adaptive.py``: the model
is an ``nn.Module`` that holds its weights, so there is no ``params``
argument, and ``device=`` reaches the pipeline.)

This wires the three halves of the system together into the loop the
paper leaves as future work:

  1. the executable k-stage pipeline (``runtime.edge.EdgePipeline``)
     records what every hop *actually* did per transfer — the modeled
     delay under the ``emulated`` transport, or the **measured**
     wall-clock cost when the hops are real sockets / shared memory
     between worker processes (``transport="socket"``/``"shmem"``),
  2. those observations feed one ``LinkEstimator`` per hop (RTT /
     per-message overhead / bandwidth fitted from observed (nbytes,
     elapsed) pairs — what a real runtime can see),
  3. ``AdaptiveSplitter`` re-solves the whole chain with the estimated
     links (``partitioner.solve``: 2-way sweep, k-way enumeration, or
     Pareto DP as the problem size demands) and, when the predicted gain
     clears hysteresis (and, with ``amortize_horizon_s`` set, amortizes
     both the redeploy stall *and* the weights-over-the-wire joules
     within the horizon), the pipeline live-migrates to the new cut
     vector.

``AdaptiveRuntime.run`` opens a :class:`~repro_torch.runtime.session.Session`
with an ``AdaptiveController`` — the same machinery that drives
adaptive *streaming* (batches in flight during migration).  ``run``
keeps the legacy batch-synchronous cadence (``inflight=1``); pass
``inflight > 1`` for the pipelined loop, or use ``EdgePipeline.session``
directly.

Energy rides the same loop: every batch's joules are modeled from the
*measured* per-stage compute times, and an ``energy_budget_j`` makes
the re-solve constrained — a budget breach overrides both hysteresis
and the amortization gate.
"""
from __future__ import annotations

from typing import Callable, Sequence

from ..core.autosplit import AdaptiveSplitter, LinkEstimator, Policy
from ..core.blocks import BlockGraph
from ..core.costmodel import CostTable
from ..core.scenarios import Scenario
from .edge import Backend, EdgePipeline
from .session import AdaptiveController, LoopRecord, MigrationPolicy

__all__ = ["AdaptiveRuntime", "LoopRecord", "AdaptiveController"]


class AdaptiveRuntime:
    """Owns an EdgePipeline + AdaptiveSplitter + per-hop LinkEstimators
    and runs them as one loop (a Session with an AdaptiveController).
    ``device`` is where the pipeline computes: ``cuda`` unless the
    caller names another."""

    def __init__(self, model, scenario: Scenario, *,
                 graph: BlockGraph | None = None, batch: int | None = None,
                 policy: Policy = "throughput",
                 backend: Backend | Sequence[Backend] = "lightweight",
                 transport: str | Sequence[str] | None = None,
                 costs: CostTable | None = None, hysteresis: float = 0.10,
                 migration_cost_s: float = 0.25, check_every: int = 4,
                 alpha: float = 0.5, queue_depth: int = 2, seed: int = 0,
                 energy_budget_j: float | None = None,
                 amortize_horizon_s: float | None = None,
                 device=None):
        self._model = model
        self.scenario = scenario
        self._deploy_opts = dict(batch=batch, policy=policy, costs=costs,
                                 hysteresis=hysteresis,
                                 migration_cost_s=migration_cost_s,
                                 backend=backend, transport=transport,
                                 queue_depth=queue_depth,
                                 alpha=alpha, seed=seed,
                                 energy_budget_j=energy_budget_j,
                                 amortize_horizon_s=amortize_horizon_s)
        self._device = device
        self.check_every = check_every
        self.records: list[LoopRecord] = []
        self.graph: BlockGraph | None = graph
        self.splitter: AdaptiveSplitter | None = None
        self.pipe: EdgePipeline | None = None
        self.estimators: list[LinkEstimator] = []
        # graph and batch must both be known to solve; otherwise deploy
        # lazily at run(), modelling the batches actually served
        if graph is not None and batch is not None:
            self._deploy(graph)

    def _deploy(self, graph: BlockGraph) -> None:
        """Solve under nominal (t=0) conditions — the paper's lab choice —
        and stand the pipeline up at the chosen cuts."""
        o = self._deploy_opts
        self.graph = graph
        # include_io=False: the executable pipeline has no orchestrator
        # dispatch/return hop, so the splitter must optimize the same
        # objective the pipeline actually exhibits
        self.splitter = AdaptiveSplitter(
            graph, self.scenario, batch=o["batch"], policy=o["policy"],
            costs=o["costs"], hysteresis=o["hysteresis"],
            migration_cost_s=o["migration_cost_s"], include_io=False,
            energy_budget_j=o["energy_budget_j"],
            amortize_horizon_s=o["amortize_horizon_s"])
        init = self.splitter.solve()
        self.splitter.current = init
        self.splitter.history.append((init.partition, True))
        self.pipe = EdgePipeline(self._model, init.partition, self.scenario,
                                 backend=o["backend"],
                                 transport=o["transport"],
                                 queue_depth=o["queue_depth"], seed=o["seed"],
                                 device=self._device)
        self.estimators = [LinkEstimator.from_link(l, alpha=o["alpha"])
                           for l in self.scenario.links]

    # ------------------------------------------------------------------ #
    def probe_rtt(self) -> None:
        """Send a header-only message down every hop — the emulated wire
        charges RTT/2, a real socket/shmem hop measures it — giving the
        estimators a compute-free RTT sample."""
        if self.pipe is None:
            raise RuntimeError("pipeline not deployed yet — call run() "
                               "(or pass graph= and batch=) first")
        self.pipe.probe()

    # ------------------------------------------------------------------ #
    def run(self, make_batch: Callable[[], object], n_batches: int,
            probe: bool = True, *, inflight: int = 1,
            migration_policy: MigrationPolicy = "drain") -> list[LoopRecord]:
        """Drive ``n_batches`` through the pipeline, re-solving every
        ``check_every`` batches (each check RTT-probes every hop first
        unless ``probe=False`` — without fresh RTT samples the estimator
        attributes queueing delay to bandwidth).  ``inflight=1`` is the
        legacy batch-synchronous cadence; larger keeps the pipeline full
        while the loop adapts, migrating under ``migration_policy``.
        Returns this call's per-batch records (``self.records``
        accumulates across calls); migrations are also visible in
        ``self.pipe.migrations``."""
        x = make_batch()
        if self.pipe is None:
            # model the batches actually being served: infer resolution
            # and batch size from the first batch unless given explicitly
            # (block boundaries keep NHWC, so dim 1 is the height)
            if self._deploy_opts["batch"] is None:
                self._deploy_opts["batch"] = x.shape[0]
            self._deploy(self.graph if self.graph is not None
                         else self._model.block_graph(input_hw=x.shape[1]))
        self.pipe.warmup(x)
        self.pipe.reset_clock()
        prev = len(self.records)
        ctrl = AdaptiveController(self.splitter, self.estimators,
                                  check_every=self.check_every, probe=probe,
                                  batch_offset=prev)
        with self.pipe.session(ctrl, inflight=inflight,
                               policy=migration_policy,
                               keep_results=False) as s:
            for _ in range(n_batches):
                s.submit(x)
            s.drain()
            self.records.extend(s.records)
        return self.records[prev:]

    # ------------------------------------------------------------------ #
    def close(self) -> None:
        """Tear down the pipeline (worker processes, channels); no-op
        for thread-backed pipelines or before the first deploy."""
        if self.pipe is not None:
            self.pipe.close()

    def __enter__(self) -> "AdaptiveRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ #
    @property
    def cut_history(self) -> list[tuple[int, ...]]:
        """Distinct cut vectors in deployment order."""
        out: list[tuple[int, ...]] = []
        for r in self.records:
            if not out or r.cuts != out[-1]:
                out.append(r.cuts)
        return out
