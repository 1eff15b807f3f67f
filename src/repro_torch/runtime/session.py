"""Streaming Session API — the one always-pipelined entrypoint.

(The PyTorch port of the reference's ``runtime/session.py``, with the
session's side of the process engine's supervisor: pending payloads are
retained until their results arrive and replayed after a stage restart,
a degraded pipeline restaffs at the first quiescent point, and
supervisor-evicted devices reach the controller as device-loss events.)

Everything the runtime used to do through three incompatible entrypoints
(``EdgePipeline.run_one`` for lone batches, ``stream(x, n)`` for a
fixed-count burst, ``AdaptiveRuntime.run`` for the adaptive loop) is the
same execution here: a ``Session`` feeds batches into the pipelined
stage chain (threads under the ``emulated`` transport, worker processes
under ``socket``/``shmem``), keeps at most ``inflight`` of them in
flight, and hands results back **in submit order** —

    with pipe.session(controller=AdaptiveController(splitter)) as s:
        for x in batches:
            s.submit(x)
        for y in s.results():          # ordered, as they complete
            ...

A pluggable ``Controller`` decides what happens around each completed
batch: it builds the per-batch ``LoopRecord`` (latency, windowed
throughput, energy, active cut vector) and may re-solve and migrate.
``PinnedController`` never moves; ``AdaptiveController`` wraps
``AdaptiveSplitter`` + per-hop ``LinkEstimator``s and closes the
measure → estimate → re-solve → migrate loop *while batches are in
flight*.

Migration uses the transports' in-band ``RECONFIG`` token under an
explicit ``MigrationPolicy``:

  * ``"drain"`` — flush every in-flight batch to completion first, then
    reconfigure an empty pipeline (a full pipeline bubble: predictable,
    but throughput dips for ~``inflight`` batch times);
  * ``"drop"`` — drop the flush barrier: the ``RECONFIG`` token is
    injected immediately and chases the in-flight batches down the
    chain.  Batches ahead of the token complete under the outgoing
    placement (every cut vector computes the same function, so results
    stay correct), batches behind it run on the new one.  Admissions
    stall for ``cost_s`` (the weight redeploy) but the pipeline keeps
    draining.

Either way a migration loses, duplicates, and reorders **nothing** —
the in-band token is ordered with the batches around it, and an in-band
``WARMUP`` of the last-seen batch shape follows it so the new placement
is jit-warm before the next real batch arrives.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import TYPE_CHECKING, Literal, Protocol, Sequence, runtime_checkable

from ..core.autosplit import AdaptiveSplitter, LinkEstimator
from .transport import (BATCH, CANCEL, CLOCK, ERROR, PROBE, RECONFIG, STATS,
                        STOP, WARMUP, TransportError, TransportTimeout)

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .edge import EdgePipeline

MigrationPolicy = Literal["drain", "drop"]


@dataclass(frozen=True)
class LoopRecord:
    """One batch through a session (the controller builds these
    uniformly, whatever the controller and transport)."""

    batch_idx: int
    t_s: float                      # pipeline-clock time after the batch
    cuts: tuple[int, ...]           # cut vector the batch was submitted under
    latency_s: float                # submit→result (includes queueing when
                                    # the pipeline is kept full)
    migrated: bool                  # did this step trigger a migration
    migration_cost_s: float         # redeploy wall-clock charged (0 if none)
    predicted_latency_s: float      # controller's model of the active cuts
    predicted_throughput: float
    energy_j: float = 0.0           # modeled J/batch from measured exe
    predicted_energy_j: float = 0.0
    throughput: float = 0.0         # measured samples/s, sliding window
    migration_cost_j: float = 0.0   # weights-over-the-wire J charged
    codecs: tuple[str, ...] = ()    # per-hop wire codecs the batch ran under


@runtime_checkable
class Controller(Protocol):
    """Decides, per completed batch, what the session does next.

    ``on_result`` is called once per batch **in arrival (= submit)
    order** and returns that batch's ``LoopRecord`` (or None to record
    nothing).  Inside it a controller may call ``session.checkpoint()``
    (flush stats/observations from the workers) and
    ``session.migrate(...)`` — the session keeps records ordered by
    batch even when those calls pump further arrivals re-entrantly.
    """

    def bind(self, session: "Session") -> None: ...

    def on_result(self, session: "Session", seq: int, latency_s: float,
                  cuts: tuple[int, ...]) -> "LoopRecord | None": ...


class _EnergyMeter:
    """Per-batch energy estimate from lifetime stage/hop counters.

    Deltas are taken whenever every stage has completed at least one
    more batch since the last snapshot (exact per-batch attribution when
    the session runs batch-synchronously; a window mean when pipelined).
    Under process transports the counters advance at checkpoint cadence,
    so the estimate lags to the last checkpoint — documented behaviour,
    not drift."""

    def __init__(self, pipe: "EdgePipeline"):
        self.pipe = pipe
        self.energy_per_batch = 0.0
        self._snap()

    def _snap(self) -> None:
        stats = self.pipe.stage_stats()
        nets = self.pipe.nets
        self._calls = [s.calls for s in stats]
        self._exe = [s.exe_s for s in stats]
        self._bytes = [n.total_bytes for n in nets]
        self._wire = [(n.total_transfers, n.total_elapsed_s) for n in nets]

    def update(self) -> float:
        stats = self.pipe.stage_stats()
        nets = self.pipe.nets
        # a migration that rebuilds a worker resets its StageStats (the
        # thread engine's in-band RECONFIG does); a shrunk counter means
        # every cached baseline is stale — resync and keep the last
        # estimate until a full post-migration batch lands
        if any(s.calls < c0 for s, c0 in zip(stats, self._calls)):
            self._snap()
            return self.energy_per_batch
        d = min((s.calls - c0 for s, c0 in zip(stats, self._calls)),
                default=0)
        if d >= 1:
            exe = [(s.exe_s - e0) / d
                   for s, e0 in zip(stats, self._exe)]
            nbytes = [(n.total_bytes - b0) / d
                      for n, b0 in zip(nets, self._bytes)]
            wire = [(n.total_elapsed_s - el0) / d
                    for n, (_, el0) in zip(nets, self._wire)]
            energy, _ = self.pipe.stage_energy_model(exe, wire, nbytes)
            self.energy_per_batch = max(energy, 0.0)
            self._snap()
        return self.energy_per_batch


class PinnedController:
    """The null policy: never re-solves, never migrates — records only.
    ``stats_every`` (batches) inserts an in-band stats checkpoint so
    process-transport meters/energy stay fresh mid-stream (None = no
    checkpoints; thread-backed pipelines have live counters anyway)."""

    probe = False

    def __init__(self, stats_every: int | None = None):
        self.stats_every = stats_every
        self._count = 0
        self._busy = False
        self._meter: _EnergyMeter | None = None

    def bind(self, session: "Session") -> None:
        self._meter = _EnergyMeter(session.pipe)

    def on_result(self, session: "Session", seq: int, latency_s: float,
                  cuts: tuple[int, ...]) -> LoopRecord:
        self._count += 1
        if (self.stats_every and not self._busy
                and self._count % self.stats_every == 0):
            self._busy = True
            try:
                session.checkpoint(probe=False)
            finally:
                self._busy = False
        return LoopRecord(
            batch_idx=seq, t_s=session.pipe.clock(), cuts=cuts,
            latency_s=latency_s, migrated=False, migration_cost_s=0.0,
            predicted_latency_s=0.0, predicted_throughput=0.0,
            energy_j=self._meter.update(),
            throughput=session.window_throughput(),
            codecs=session.pipe.codecs)


class AdaptiveController:
    """The closed loop as a session controller: every ``check_every``
    batches, checkpoint (in-band probe + stats flush), feed the drained
    per-hop observations into the ``LinkEstimator``s, re-solve via the
    wrapped ``AdaptiveSplitter``, and migrate in-stream when the
    splitter says so — charging ``migration_cost_s`` wall-clock and
    ``migration_cost_j`` (weights over the wire) on the batch record
    that triggered the move."""

    def __init__(self, splitter: AdaptiveSplitter,
                 estimators: Sequence[LinkEstimator] | None = None, *,
                 check_every: int = 4, probe: bool = True,
                 batch_offset: int = 0, alpha: float = 0.5):
        self.splitter = splitter
        self.estimators = list(estimators) if estimators is not None else None
        self.check_every = check_every
        self.probe = probe
        self.batch_offset = batch_offset
        self.alpha = alpha
        self._count = 0
        self._checking = False
        self._meter: _EnergyMeter | None = None
        self._force_check = False
        self.device_losses: list[tuple[int, int]] = []

    def on_device_loss(self, session: "Session", stage: int,
                       lane: int) -> None:
        """Supervisor-reported replica eviction: the failed device
        changes the pipeline's capacity, so the next arrival re-probes,
        re-estimates, and re-solves immediately instead of waiting out
        the ``check_every`` stride — failure is just another regime
        change to the Pareto loop."""
        self.device_losses.append((stage, lane))
        self._force_check = True

    def bind(self, session: "Session") -> None:
        if self.estimators is None:
            self.estimators = [
                LinkEstimator.from_link(l, alpha=self.alpha)
                for l in session.pipe.links]
        self._meter = _EnergyMeter(session.pipe)

    def ingest_observations(self, pipe: "EdgePipeline") -> None:
        """Drained transfers → estimators (nbytes=0 records are RTT
        probes: header-only ≈ one-way RTT/2)."""
        for est, net in zip(self.estimators, pipe.nets):
            for rec in net.drain_observations():
                if rec.nbytes <= 0:
                    est.observe(0, 2.0 * rec.elapsed_s, is_rtt_probe=True)
                else:
                    # wire bytes, not raw: the estimator must predict the
                    # transfer time of what actually crosses the hop
                    est.observe(rec.nbytes, rec.elapsed_s)

    def on_result(self, session: "Session", seq: int, latency_s: float,
                  cuts: tuple[int, ...]) -> LoopRecord:
        self._count += 1
        pipe = session.pipe
        energy = self._meter.update()
        # the model's view of the cuts this batch actually ran under
        # (captured before any re-solve below replaces it)
        pred = self.splitter.current
        migrated, cost_s, cost_j = False, 0.0, 0.0
        if ((self._count % self.check_every == 0 or self._force_check)
                and not self._checking):
            self._force_check = False
            self._checking = True       # nested arrivals must not re-check
            try:
                session.checkpoint(probe=self.probe)
                self.ingest_observations(pipe)
                m, migrated = self.splitter.step(self.estimators)
                new_codecs = m.codecs or None
                if migrated and (m.partition != pipe.cuts
                                 or (new_codecs is not None
                                     and new_codecs != pipe.codecs)):
                    cost_s = self.splitter.last_migration_cost_s
                    cost_j = self.splitter.last_migration_cost_j
                    session.migrate(m.partition, cost_s=cost_s,
                                    cost_j=cost_j, codecs=new_codecs)
            finally:
                self._checking = False
        return LoopRecord(
            batch_idx=self.batch_offset + seq, t_s=pipe.clock(), cuts=cuts,
            latency_s=latency_s, migrated=migrated,
            migration_cost_s=cost_s,
            predicted_latency_s=pred.latency_s if pred else 0.0,
            predicted_throughput=pred.throughput if pred else 0.0,
            energy_j=energy,
            predicted_energy_j=pred.energy_j if pred else 0.0,
            throughput=session.window_throughput(),
            migration_cost_j=cost_j,
            codecs=pipe.codecs)


# in-band tokens whose round trip a session tracks (kind -> outstanding)
_TOKEN_KINDS = (PROBE, RECONFIG, STATS, WARMUP, CLOCK, CANCEL)


@dataclass
class CancelRecord:
    """One canceled in-flight batch: the resubmit-or-skip bookkeeping a
    drop-policy gateway needs to account for flushed work.  Mutable —
    ``flushed`` flips when the canceled batch's (discarded) arrival
    drains, ``resubmitted_as`` is stamped when its payload re-enters
    the queue as a fresh seq."""

    seq: int
    action: str                     # "skip" | "resubmit"
    flush: bool                     # part of a flush (cancel-all) window
    t_cancel_s: float
    flushed: bool = False           # its arrival has been discarded
    resubmitted_as: int = -1        # new seq when the payload was re-fed


class Session:
    """A live streaming handle over an ``EdgePipeline``.

    One session may be open per pipeline at a time; the pipeline's
    synchronous entrypoints (``run_one``/``stream``/``measure``/
    ``migrate``/…) are shims that open one internally, so they refuse
    to run while a caller-owned session is active.
    """

    def __init__(self, pipe: "EdgePipeline",
                 controller: Controller | None = None, *,
                 inflight: int | None = None,
                 policy: MigrationPolicy = "drain",
                 window: int = 16, keep_results: bool = True,
                 record_cap: int | None = None):
        if policy not in ("drain", "drop"):
            raise ValueError(f"unknown migration policy {policy!r}")
        self.pipe = pipe
        self.controller = controller if controller is not None \
            else PinnedController()
        self.inflight = (inflight if inflight is not None
                         else max(pipe.queue_depth * pipe.n_stages, 1))
        if self.inflight < 1:
            raise ValueError("need inflight >= 1")
        # submit() only pumps while the window is full, so the window
        # must fit inside the engine's guaranteed-drainable capacity —
        # past it, a process-engine feed send would block with nothing
        # draining the result channel until it hard-timed out
        cap = pipe._engine.max_inflight()
        if cap is not None:
            self.inflight = min(self.inflight, cap)
        self.policy: MigrationPolicy = policy
        self.keep_results = keep_results
        # long-lived serving sessions should cap the record log, or it
        # grows one LoopRecord per batch forever (None = unbounded, the
        # right default for finite measurement runs)
        self.record_cap = record_cap
        self._rec_lo = 0                # lowest seq a record may hold
        self.closed = False
        self._engine = pipe._engine
        # supervised engines replay unacked in-flight batches after a
        # stage restart, so the session retains each pending payload
        # (bounded by ``inflight``) until its result arrives
        self._retain = bool(getattr(self._engine, "supervised", False))
        # pending: seq -> (t_submit, cuts, batch size, retained payload)
        self._pending: dict[
            int, tuple[float, tuple[int, ...], int, object]] = {}
        self._ready: dict[int, object] = {}
        self._records: dict[int, LoopRecord] = {}
        self._next_seq = 0              # next submit id
        self._next_arrival = 0          # next BATCH arrival's id
        self._next_emit = 0             # next id results() hands out
        self._arrivals: deque = deque(maxlen=max(window, 2))
        self._expect = {k: 0 for k in _TOKEN_KINDS}
        self._canceled: set[int] = set()      # seqs results() must skip
        self._cancel_live: dict[int, CancelRecord] = {}   # awaiting flush
        self._cancel_log: list[CancelRecord] = []
        self._exemplar = None
        self._failed = False
        self._migrating = False
        self._engine.session_open()
        try:
            self.controller.bind(self)
        except BaseException:
            # a failed bind must not wedge the pipeline behind a
            # Session nobody holds a handle to
            self._engine.session_close(failed=True)
            raise
        if self._retain:
            self._engine._replay_cb = self._replay_for_recovery
        pipe._session = self

    # ------------------------------------------------------------------ #
    @property
    def records(self) -> list[LoopRecord]:
        """Per-batch LoopRecords in batch order (whatever re-entrant
        pumping order the controller's checkpoints caused)."""
        return [self._records[s] for s in sorted(self._records)]

    def window_throughput(self) -> float:
        """Measured samples/s over the sliding arrival window."""
        if len(self._arrivals) < 2:
            return 0.0
        t0, _ = self._arrivals[0]
        t1, _ = self._arrivals[-1]
        samples = sum(b for _, b in list(self._arrivals)[1:])
        return samples / max(t1 - t0, 1e-9)

    @property
    def outstanding(self) -> int:
        return len(self._pending)

    @property
    def backlog(self) -> int:
        """Submitted batches whose emit slot has not been handed out
        yet: in flight, ready-but-unemitted (a re-entrant controller
        pump can park arrivals in the ready map with nothing left
        pending), or canceled-awaiting-skip."""
        return self._next_seq - self._next_emit

    # ------------------------------------------------------------------ #
    def submit(self, x) -> int:
        """Feed one batch; blocks (pumping results) while ``inflight``
        batches are already in the pipeline.  Returns the batch's seq
        id — results() yields values in seq order."""
        if self.closed:
            raise RuntimeError("session is closed")
        self._check_failed()
        while len(self._pending) >= self.inflight:
            self._pump()
        seq = self._next_seq
        self._next_seq += 1
        self._exemplar = x
        shape = getattr(x, "shape", ())       # no host copy on the hot path
        bsz = int(shape[0]) if shape else 1
        # keep the caller's reference as it is — no device-to-host copy
        # and no clone on the hot path; it is what cancel(resubmit=True)
        # re-feeds and what a supervised recovery replays
        self._pending[seq] = (time.perf_counter(), self.pipe.cuts, bsz, x)
        self._engine.submit(x)
        return seq

    def results(self):
        """Ordered iterator over completed batch outputs; yields until
        every batch submitted so far has been handed out (submitting
        more while iterating extends it)."""
        while self._next_emit < self._next_seq:
            self._check_failed()
            if self._next_emit in self._canceled:
                self._next_emit += 1          # canceled: no value to yield
                continue
            while self._next_emit not in self._ready:
                self._pump()
            seq = self._next_emit
            self._next_emit += 1
            yield self._ready.pop(seq)

    def drain(self) -> list:
        """Pump until nothing is in flight; → the not-yet-emitted
        results, in order."""
        while self._pending:
            self._pump()
        return list(self.results())

    def latency_of(self, seq: int) -> float:
        return self._records[seq].latency_s if seq in self._records else 0.0

    def set_inflight(self, n: int) -> int:
        """Retune the admission window mid-stream (the serving
        gateway's AIMD control plane).  Clamped to [1, engine cap];
        returns the window actually applied.  Shrinking never evicts
        in-flight batches — ``submit`` simply blocks until the window
        drains below the new bound."""
        n = max(int(n), 1)
        cap = self._engine.max_inflight()
        if cap is not None:
            n = min(n, cap)
        self.inflight = n
        return n

    # ------------------------------------------------------------------ #
    def cancel(self, seqs: Sequence[int] | None = None, *,
               resubmit: bool = False) -> list[int]:
        """Cancel in-flight (or ready-but-unemitted) batches.

        ``seqs=None`` cancels the whole in-flight window — a *flush*
        cancel: the engine opens an out-of-band skip window (workers
        short-circuit compute on batches already queued) and an in-band
        ``CANCEL`` fence closes it behind them, so the flush confirms
        without paying for the canceled compute.  Explicit ``seqs``
        cancel selectively: those batches still compute, but their
        arrivals are discarded.

        Canceled seqs never reach ``results()`` or the controller; each
        is logged as a :class:`CancelRecord` (see ``drain_cancels``).
        With ``resubmit=True`` every canceled batch whose payload the
        session still holds is immediately re-submitted at the back of
        the queue (``resubmitted_as`` maps old seq to new).

        Returns the seqs actually canceled (already-emitted or
        already-canceled seqs are skipped silently)."""
        if self.closed:
            raise RuntimeError("session is closed")
        self._check_failed()
        flush = seqs is None
        if flush:
            targets = sorted(s for s in self._pending
                             if s not in self._canceled)
        else:
            targets = []
            for s in {int(s) for s in seqs}:
                if s >= self._next_seq:
                    raise ValueError(f"seq {s} was never submitted")
                if (s in self._canceled or s < self._next_emit
                        or (s not in self._pending
                            and s not in self._ready)):
                    continue
                targets.append(s)
            targets.sort()
        if not targets:
            return []
        now = time.perf_counter()
        action = "resubmit" if resubmit else "skip"
        payloads = {}
        made: dict[int, CancelRecord] = {}
        for s in targets:
            if s in self._pending:
                payloads[s] = self._pending[s][3]
            rec = CancelRecord(seq=s, action=action, flush=flush,
                               t_cancel_s=now)
            if s in self._ready:              # already arrived: flushed now
                self._ready.pop(s)
                rec.flushed = True
            else:
                self._cancel_live[s] = rec
            self._canceled.add(s)
            self._cancel_log.append(rec)
            made[s] = rec
        if flush:
            cancel_flush = getattr(self._engine, "cancel_flush", None)
            if cancel_flush is not None:
                cancel_flush()                # out-of-band: skip compute
        # the in-band fence: a truthy payload marks a flush fence (it
        # closes the skip window at each stage); selective cancels send
        # a non-flush fence purely as a flush-progress marker
        self._engine.submit_token(CANCEL, 1 if flush else None)
        self._expect[CANCEL] += 1
        if resubmit:
            # records are mutable and shared with the log, so stamp via
            # the local reference — submit() pumps while the window is
            # full, and the pump may pop _cancel_live[s] before we read
            for s in targets:
                if s in payloads and payloads[s] is not None:
                    made[s].resubmitted_as = self.submit(payloads[s])
        return targets

    def drain_cancels(self) -> list[CancelRecord]:
        """Return-and-clear the cancel log (records are shared with the
        live flush tracker, so a record drained before its batch has
        flushed will still flip ``flushed`` when it does)."""
        out, self._cancel_log = self._cancel_log, []
        return out

    # ------------------------------------------------------------------ #
    def checkpoint(self, probe: bool = True) -> None:
        """Flush worker-side stats + per-hop observations to the
        orchestrator via an in-band ``STATS`` token (preceded by a
        ``PROBE`` for a compute-free RTT sample on every hop), pumping
        batch results until the token(s) come back."""
        self._check_failed()
        if probe:
            self._engine.submit_token(PROBE)
            self._expect[PROBE] += 1
        self._engine.submit_token(STATS)
        self._expect[STATS] += 1
        self._await_tokens(STATS, *((PROBE,) if probe else ()))

    def migrate(self, new_cuts, cost_s: float = 0.0, cost_j: float = 0.0,
                policy: MigrationPolicy | None = None,
                codecs: Sequence[str] | None = None) -> tuple[int, ...]:
        """In-stream migration to ``new_cuts`` under ``policy`` (the
        session default unless overridden).  ``cost_s`` stalls
        admissions for the redeploy; ``cost_j`` is recorded on the
        pipeline's migration log.  ``codecs`` retunes the per-hop wire
        codecs in the same in-band RECONFIG — a codec-only switch (cuts
        unchanged) still runs the full reconfiguration, including the
        in-band WARMUP that pre-compiles the new codec's kernels, so it
        is charged like a migration.  Nested requests (a controller
        deciding again while a migration's own drain is pumping) are
        dropped — the in-progress move supersedes them."""
        if self._migrating:
            return self.pipe.cuts
        new_cuts = self.pipe._check_cuts(new_cuts)
        if codecs is not None:
            from ..core.codecs import get_codec
            codecs = tuple(get_codec(c).name for c in codecs)
            if len(codecs) != self.pipe.n_stages - 1:
                raise ValueError(f"{len(codecs)} codecs for "
                                 f"{self.pipe.n_stages - 1} hops")
            if codecs == self.pipe.codecs:
                codecs = None               # already active: not a switch
        if new_cuts == self.pipe.cuts and codecs is None:
            return self.pipe.cuts
        policy = policy or self.policy
        if policy not in ("drain", "drop"):
            raise ValueError(f"unknown migration policy {policy!r}")
        self._migrating = True
        try:
            if policy == "drain":
                while self._pending:        # empty the pipeline first
                    self._pump()
            if cost_s > 0.0:
                time.sleep(cost_s)          # weight redeploy: admissions
                                            # stall, in-flight work doesn't
            if codecs is not None:
                self.pipe.codecs = codecs
            self.pipe._note_migration(new_cuts, cost_j=cost_j)
            self._engine.submit_token(RECONFIG, self.pipe.reconfig_payload())
            self._expect[RECONFIG] += 1
            if self._exemplar is not None:  # jit-warm the new placement
                self._engine.submit_token(WARMUP, self._exemplar)
                self._expect[WARMUP] += 1
            if policy == "drain":           # confirmed before resuming
                self._await_tokens(RECONFIG, WARMUP)
            # drop: confirmations collected opportunistically by later
            # pumps while in-flight batches keep completing
        finally:
            self._migrating = False
        return self.pipe.cuts

    # ------------------------------------------------------------------ #
    def _check_failed(self) -> None:
        if self._failed:
            raise TransportError("session failed; no further submissions "
                                 "(see the original error)")

    def _await_tokens(self, *kinds: int) -> None:
        deadline = time.perf_counter() + self.pipe.timeout_s
        while any(self._expect[k] > 0 for k in kinds):
            if time.perf_counter() > deadline:
                raise TransportError(
                    "timed out waiting for in-band control token(s)")
            self._pump()

    def _pump(self, timeout: float | None = None) -> None:
        """Handle exactly one arrival at the result end."""
        try:
            kind, obj = self._engine.poll(timeout or self.pipe.timeout_s)
        except TransportTimeout:
            self._failed = True
            raise
        except TransportError:
            self._failed = True
            raise
        if kind == ERROR:
            self._failed = True
            if isinstance(obj, BaseException):
                raise obj                     # the stage's own exception
            raise TransportError(str(obj))
        self._drain_device_loss()
        if kind == BATCH:
            seq = self._next_arrival
            self._next_arrival += 1
            if seq in self._canceled:
                # a canceled batch flushing through: discard the arrival
                # — no result, no controller callback, no throughput
                # sample (skip markers complete unrealistically fast)
                self._pending.pop(seq, None)
                crec = self._cancel_live.pop(seq, None)
                if crec is not None:
                    crec.flushed = True
            else:
                t_sub, cuts, bsz, _ = self._pending.pop(seq)
                now = time.perf_counter()
                self._arrivals.append((now, bsz))
                self._ready[seq] = obj if self.keep_results else None
                rec = self.controller.on_result(self, seq, now - t_sub, cuts)
                if rec is not None:
                    self._records[seq] = rec
                    if self.record_cap:         # evict oldest beyond the cap
                        while len(self._records) > self.record_cap:
                            while self._rec_lo not in self._records:
                                self._rec_lo += 1
                            del self._records[self._rec_lo]
                            self._rec_lo += 1
            # a degraded pipeline restaffs to full replica strength at
            # the first quiescent point (nothing in flight to replay)
            if (getattr(self._engine, "_restaff_needed", False)
                    and not self._pending
                    and not any(n > 0 for n in self._expect.values())):
                self._engine.restaff()
            return
        if kind == STOP:                    # only during engine teardown
            return
        if kind == STATS:
            self._engine.harvest()
        if kind in self._expect:            # PROBE/RECONFIG/STATS/WARMUP/CLOCK
            self._expect[kind] = max(self._expect[kind] - 1, 0)
            return
        # every kind the session protocol can produce is handled above;
        # anything else reaching the result drain is a wire-level bug,
        # not something to silently swallow (pipecheck R1)
        self._failed = True
        raise TransportError(
            f"session: unexpected token kind {kind!r} at the result drain")

    def _drain_device_loss(self) -> None:
        """Forward supervisor-evicted (stage, lane) pairs to the
        controller — a device-loss event enters the adaptation loop like
        any other regime change (estimator update → re-solve →
        migrate over the existing RECONFIG path)."""
        drain = getattr(self._engine, "drain_device_loss", None)
        if drain is None:
            return
        for stage, lane in drain():
            cb = getattr(self.controller, "on_device_loss", None)
            if cb is not None:
                cb(self, stage, lane)

    def _replay_for_recovery(self) -> int:
        """Engine-supervisor callback, invoked after a stage restart has
        rebuilt the worker tier and replayed the WARMUP fence: re-send
        every unacked in-flight batch, oldest first, exactly as it was
        submitted (the retained payload is the caller's tensor).

        Correctness: pending seqs are the contiguous window
        [_next_arrival, _next_seq); the teardown destroyed every
        undelivered result, so re-sending the window in ascending order
        recomputes exactly the missing results in arrival order — zero
        lost, zero duplicated, zero reordered.  The fresh feed ring is
        empty and pending <= inflight <= feed depth, so nothing blocks.
        In-flight control tokens died with the channels: their expect
        counters reset here, and any token the engine's send loop
        retries afterwards is absorbed by _pump's surplus tolerance.
        """
        for k in self._expect:
            self._expect[k] = 0
        for seq in sorted(self._pending):
            self._engine._feed.send(self._pending[seq][3], kind=BATCH)
        return len(self._pending)

    def _flush_failed(self) -> None:
        """Best-effort flush after a failure.  A session aborted by a
        *user* exception leaves healthy workers completing in-flight
        batches into the persistent result channel — unclaimed, they
        would be misattributed as the next session's first arrivals.
        Bounded: after a transport failure there may be nothing alive
        left to drain.  Only process engines need it — a thread
        session's channels die with its stage threads."""
        if not getattr(self._engine, "results_persist", False):
            return
        deadline = time.perf_counter() + min(self.pipe.timeout_s, 10.0)
        while (self._pending
               or any(n > 0 for n in self._expect.values())):
            if time.perf_counter() > deadline:
                break
            try:
                kind, _ = self._engine.poll(1.0)
            except TransportTimeout:
                continue                      # a batch may still be computing
            except TransportError:
                break                         # the pipeline really is gone
            if kind == BATCH and self._pending:
                self._pending.pop(min(self._pending))
            elif kind == STATS:
                try:
                    self._engine.harvest()
                except Exception:
                    pass
                self._expect[STATS] = max(self._expect[STATS] - 1, 0)
            elif kind in self._expect:
                self._expect[kind] = max(self._expect[kind] - 1, 0)
            else:
                # unowned BATCH (pending already empty) or a stray
                # ERROR/STOP: the flush is best-effort by contract, but
                # the drop is explicit, not an accidental fall-through
                pass

    # lifecycle --------------------------------------------------------- #
    def close(self) -> None:
        """Drain (unless already failed) and release the pipeline for
        the next session / synchronous call."""
        if self.closed:
            return
        self.closed = True
        try:
            if not self._failed:
                while self._pending:
                    self._pump()
                outstanding = [k for k, n in self._expect.items() if n > 0]
                if outstanding:
                    self._await_tokens(*outstanding)
            else:
                self._flush_failed()
        finally:
            if getattr(self._engine, "_replay_cb", None) is not None:
                self._engine._replay_cb = None
            try:
                self._engine.session_close(failed=self._failed)
            finally:
                self.pipe._session = None

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        if exc and exc[0] is not None:
            self._failed = True             # don't drain through a wreck
        self.close()
