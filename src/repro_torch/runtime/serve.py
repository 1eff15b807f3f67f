"""ServeGate: a multi-tenant serving gateway over one streaming Session.

(The PyTorch port of the reference's ``runtime/serve.py``: requests are
tensors and stay on the device they were submitted on.)

The paper's Pareto analysis prices a *single* stream; production serves
a workload mix.  This module lifts the split-point story to that
setting: many concurrent :class:`ClientSession`\\ s multiplex onto one
underlying :class:`~repro_torch.runtime.session.Session` pipeline
through a :class:`Gateway` that

* **micro-batches** — shape/dtype/device-compatible head-of-queue
  requests coalesce round-robin across tenants, up to ``max_batch`` rows
  within a ``batch_window_s`` deadline, and (by default) zero-pad to
  exactly ``max_batch`` rows so every pipeline batch has one fixed
  shape.  The padding is what buys *bit-identical* per-request results:
  convolution libraries pick their algorithm by problem size, the batch
  included, so deterministic serving must never let the resident batch
  shape depend on the tenant mix.  A lossy wire codec
  couples the rows of a batch (one abs-max scale per tensor, one global
  top-k), so on a pipeline with such a hop deterministic serving also
  gives every request a micro-batch of its own.
  ``deterministic=False`` trades that guarantee for the padded FLOPs.
* **demuxes on the drain** — the session delivers micro-batches in
  submit order, so each request's rows slice back out by offset (a
  clone on the device the pipeline delivers on); no wire-format change
  is needed for tenancy.
* **admits under SLO control** — the effective in-flight window runs
  AIMD (additive increase per ``ai_every`` clean batches,
  multiplicative decrease on an SLO violation, one decrease per
  in-flight window) against per-tenant latency SLOs, applied to the
  session via ``Session.set_inflight``.
* **accounts per tenant** — every request finishes with a
  :class:`QoSRecord` splitting queueing time vs processing latency vs
  estimated wire time, drained like violations/recoveries
  (module-level :func:`drain_qos` or per-gateway ``Gateway.drain_qos``).
* **cancels expired work** — ``Gateway.cancel_inflight`` flushes the
  in-flight window over the ``CANCEL`` token (workers skip compute on
  batches ahead of the fence) with resubmit-or-skip bookkeeping at
  request granularity.

On top sits :class:`FleetController`: an
:class:`~repro_torch.runtime.session.AdaptiveController` that aggregates
the live tenant mix into fleet objectives (p50/p99 latency, aggregate
req/s, joules per request) and steers the existing re-solve/migrate/
codec-switch machinery against them — the Pareto front computed over
the workload instead of the stream.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import TYPE_CHECKING, Iterable

import numpy as np
import torch

from ..core.codecs import get_codec
from ..core.scenarios import TenantMix, TenantSpec
from .session import AdaptiveController, PinnedController, Session, \
    _EnergyMeter

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .edge import EdgePipeline

__all__ = [
    "ClientSession", "FleetController", "FleetObjectives", "Gateway",
    "QoSRecord", "drain_qos",
]


# --------------------------------------------------------------------------- #
# per-request accounting
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class QoSRecord:
    """One served request, decomposed the way an SLO postmortem needs:
    how long it *queued* at the gateway, how long the pipeline *served*
    it, and how much of that service was estimated *wire* time."""

    tenant: str
    req_id: int                 # per-tenant request index
    seq: int                    # underlying pipeline micro-batch seq
    t_s: float                  # completion time (pipeline clock)
    queue_s: float              # enqueue -> pipeline submit
    service_s: float            # pipeline submit -> rows ready
    wire_s: float               # estimated per-batch hop time share
    latency_s: float            # queue_s + service_s (the SLO quantity)
    rows: int                   # rows this request contributed
    coalesced: int              # requests sharing the micro-batch
    occupancy: float            # real rows / padded batch rows
    energy_j: float             # per-request share of the batch estimate
    slo_s: float
    violated: bool


_QOS: list[tuple[int, QoSRecord]] = []      # (gateway id, record)
_QLOCK = threading.Lock()


def drain_qos() -> list[QoSRecord]:
    """Return-and-clear every gateway's QoS log (the violations /
    recoveries drain idiom, applied to per-request accounting)."""
    with _QLOCK:
        out = [r for _, r in _QOS]
        _QOS.clear()
    return out


def _log_qos(gid: int, rec: QoSRecord) -> None:
    with _QLOCK:
        _QOS.append((gid, rec))


# --------------------------------------------------------------------------- #
# wire-time share of a served batch
# --------------------------------------------------------------------------- #
class _WireMeter:
    """Per-batch wire-time estimate from the pipeline's lifetime hop
    counters (same delta discipline as the energy meter: exact when
    batch-synchronous, a window mean when pipelined, checkpoint-lagged
    under process transports)."""

    def __init__(self, pipe: "EdgePipeline"):
        self.pipe = pipe
        self.wire_per_batch = 0.0
        self._snap()

    def _snap(self) -> None:
        nets = self.pipe.nets
        self._elapsed = sum(n.total_elapsed_s for n in nets)
        self._batches = min((n.total_transfers for n in nets), default=0)

    def update(self) -> float:
        nets = self.pipe.nets
        elapsed = sum(n.total_elapsed_s for n in nets)
        batches = min((n.total_transfers for n in nets), default=0)
        if batches < self._batches:           # migration reset the meters
            self._snap()
            return self.wire_per_batch
        d = batches - self._batches
        if d >= 1:
            self.wire_per_batch = max(elapsed - self._elapsed, 0.0) / d
            self._elapsed, self._batches = elapsed, batches
        return self.wire_per_batch


# --------------------------------------------------------------------------- #
# the gateway
# --------------------------------------------------------------------------- #
class _Req:
    __slots__ = ("req_id", "payload", "rows", "t_enq")

    def __init__(self, req_id: int, payload: torch.Tensor, t_enq: float):
        self.req_id = req_id
        self.payload = payload
        self.rows = int(payload.shape[0])
        self.t_enq = t_enq


class _Member:
    """One request's slot inside an admitted micro-batch."""

    __slots__ = ("tenant", "req_id", "row0", "row1", "t_enq", "payload")

    def __init__(self, tenant: str, req: _Req, row0: int):
        self.tenant = tenant
        self.req_id = req.req_id
        self.row0 = row0
        self.row1 = row0 + req.rows
        self.t_enq = req.t_enq
        self.payload = req.payload            # kept for cancel-resubmit


class Gateway:
    """Multiplex many tenants onto one streaming pipeline session.

    Single-threaded and cooperative: admission, pumping, and demux all
    advance inside the caller's ``submit``/``poll``/``results`` calls,
    so ordering is deterministic and no locks guard the data plane.

    ``tenants`` is a :class:`~repro_torch.core.scenarios.TenantMix` or
    an iterable of :class:`~repro_torch.core.scenarios.TenantSpec`.
    ``max_batch`` counts *rows*; a request wider than it is rejected at
    submit.
    """

    def __init__(self, pipe: "EdgePipeline",
                 tenants: TenantMix | Iterable[TenantSpec], *,
                 controller=None, max_batch: int = 8,
                 batch_window_s: float = 0.002, inflight: int | None = None,
                 policy: str = "drop", deterministic: bool = True,
                 ai_every: int = 4, record_cap: int | None = 1024):
        specs = tuple(tenants.tenants if isinstance(tenants, TenantMix)
                      else tenants)
        if not specs:
            raise ValueError("need at least one tenant")
        names = [t.name for t in specs]
        if len(set(names)) != len(names):
            raise ValueError("duplicate tenant names")
        if max_batch < 1:
            raise ValueError("need max_batch >= 1")
        self.pipe = pipe
        self.tenants: dict[str, TenantSpec] = {t.name: t for t in specs}
        self.max_batch = max_batch
        self.batch_window_s = float(batch_window_s)
        self.deterministic = deterministic
        self.ai_every = max(int(ai_every), 1)
        self.controller = controller if controller is not None \
            else PinnedController()
        if isinstance(self.controller, FleetController):
            self.controller.attach_gateway(self)
        self._session: Session = pipe.session(
            self.controller, inflight=inflight, policy=policy,
            keep_results=True, record_cap=record_cap)
        self._gid = id(self)
        # admission state
        self._order = list(names)             # round-robin tenant order
        self._rr = 0
        self._queues: dict[str, deque[_Req]] = {n: deque() for n in names}
        self._next_req: dict[str, int] = {n: 0 for n in names}
        self._results: dict[str, deque] = {n: deque() for n in names}
        self._members: dict[int, list[_Member]] = {}
        self._submit_times: dict[int, float] = {}
        self._inflight_order: deque[int] = deque()   # seqs, submit order
        self._canceled: set[int] = set()
        # arrival notifications: (tenant, req_id) in completion order —
        # values live in the per-tenant result queues, so a request
        # consumed through a ClientSession is never delivered twice
        self._events: deque[tuple[str, int]] = deque()
        # AIMD window, in micro-batches
        self._win_cap = self._session.inflight
        self._win = self._win_cap
        self._clean = 0                       # clean batches since change
        self._md_barrier = -1                 # newest seq at last decrease
        self.window_history: list[tuple[float, int]] = [(pipe.clock(),
                                                         self._win)]
        # meters
        self._emeter = _EnergyMeter(pipe)
        self._wmeter = _WireMeter(pipe)
        self.qos_recent: deque[QoSRecord] = deque(maxlen=256)
        self.closed = False

    # -- client surface ------------------------------------------------- #
    def client(self, name: str) -> "ClientSession":
        if name not in self.tenants:
            raise KeyError(f"unknown tenant {name!r}; "
                           f"have {sorted(self.tenants)}")
        return ClientSession(self, name)

    def submit(self, tenant: str, x) -> int:
        """Enqueue one request for ``tenant`` (a tensor, left on its
        device; anything else goes through ``torch.as_tensor``); returns
        its per-tenant request id.  Results come back through
        ``poll``/``results`` in per-tenant submit order."""
        if self.closed:
            raise RuntimeError("gateway is closed")
        spec = self.tenants.get(tenant)
        if spec is None:
            raise KeyError(f"unknown tenant {tenant!r}")
        payload = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        if payload.dim() < 1:
            raise ValueError("request payload must be batched (ndim >= 1)")
        if payload.shape[0] > self.max_batch:
            raise ValueError(
                f"request of {payload.shape[0]} rows exceeds "
                f"max_batch={self.max_batch}")
        req = _Req(self._next_req[tenant], payload, time.perf_counter())
        self._next_req[tenant] += 1
        self._queues[tenant].append(req)
        self._admit()
        return req.req_id

    def poll(self, block: bool = True) -> list[tuple[str, int, object]]:
        """Deliver completed requests: ``[(tenant, req_id, value), …]``
        in completion order.  With ``block=True`` waits for at least one
        completion (unless nothing is queued or in flight).  Requests a
        :class:`ClientSession` already claimed are not re-delivered."""
        self._admit()
        if not self._events and block:
            self._advance()
        out = []
        while self._events:
            tenant, req_id = self._events.popleft()
            q = self._results[tenant]
            if q and q[0][0] == req_id:
                out.append((tenant, req_id, q.popleft()[1]))
        return out

    def drain(self) -> dict[str, list[tuple[int, object]]]:
        """Serve everything queued or in flight, then hand back all
        unconsumed results per tenant, in per-tenant submit order."""
        while self._has_work():
            self._advance()
        out = {}
        for name, q in self._results.items():
            out[name] = [(r, v) for r, v in q]
            q.clear()
        self._events.clear()
        return out

    @property
    def pending(self) -> int:
        """Requests accepted but not yet delivered (queued + in flight)."""
        queued = sum(len(q) for q in self._queues.values())
        inflight = sum(len(m) for m in self._members.values())
        return queued + inflight

    @property
    def inflight_window(self) -> int:
        """The AIMD-controlled admission window, in micro-batches."""
        return self._win

    @property
    def session(self) -> Session:
        return self._session

    def drain_qos(self) -> list[QoSRecord]:
        """Return-and-clear this gateway's QoS records."""
        with _QLOCK:
            mine = [r for g, r in _QOS if g == self._gid]
            _QOS[:] = [(g, r) for g, r in _QOS if g != self._gid]
        return mine

    # -- cancellation ---------------------------------------------------- #
    def cancel_inflight(self, action: str = "skip") -> int:
        """Flush the in-flight window over the ``CANCEL`` fence.

        ``action="resubmit"`` re-queues every flushed request at the
        *front* of its tenant's queue in original order (its enqueue
        timestamp — and hence its SLO clock — is preserved);
        ``action="skip"`` drops them (each skipped request surfaces as
        ``(req_id, None)`` so per-tenant ordering stays accountable).
        Returns the number of requests flushed."""
        if action not in ("skip", "resubmit"):
            raise ValueError(f"unknown cancel action {action!r}")
        seqs = self._session.cancel()         # flush-cancel + skip window
        flushed: list[_Member] = []           # submit order across batches
        for seq in sorted(seqs):
            self._canceled.add(seq)
            self._submit_times.pop(seq, None)
            flushed.extend(self._members.pop(seq, []))
        if action == "resubmit":
            # back-to-front appendleft restores original per-tenant
            # order at the *front* of the queues; each request keeps its
            # enqueue timestamp, so its SLO clock keeps running
            for m in reversed(flushed):
                self._queues[m.tenant].appendleft(
                    _Req(m.req_id, m.payload, m.t_enq))
            self._admit()
        else:
            # dropped requests surface as (req_id, None) behind anything
            # already delivered (in-flight ids are higher by FIFO)
            for m in flushed:
                self._results[m.tenant].append((m.req_id, None))
                self._events.append((m.tenant, m.req_id))
        return len(flushed)

    # -- lifecycle ------------------------------------------------------- #
    def close(self) -> None:
        if self.closed:
            return
        try:
            while self._has_work():
                self._advance()
        finally:
            self.closed = True
            self._session.close()

    def __enter__(self) -> "Gateway":
        return self

    def __exit__(self, *exc) -> None:
        if exc and exc[0] is not None:
            self.closed = True                # don't drain through a wreck
            self._session.__exit__(*exc)
            return
        self.close()

    # -- the data plane --------------------------------------------------- #
    def _has_work(self) -> bool:
        return bool(self._members) or any(self._queues.values())

    def _compat(self, a: torch.Tensor, b: torch.Tensor) -> bool:
        return (a.shape[1:] == b.shape[1:] and a.dtype == b.dtype
                and a.device == b.device)

    def _solo_batches(self) -> bool:
        """Deterministic serving over a hop whose codec couples the rows
        of a batch: a request's bits would depend on the requests beside
        it, so each micro-batch carries one request (and its pad)."""
        return self.deterministic and any(
            not get_codec(c).row_local for c in self.pipe.codecs)

    def _gather(self) -> list[tuple[str, _Req]] | None:
        """Round-robin one micro-batch's worth of head requests, or
        None when nothing is queued."""
        n = len(self._order)
        picked: list[tuple[str, _Req]] = []
        rows = 0
        seed: torch.Tensor | None = None
        start = self._rr
        limit = 1 if self._solo_batches() else None   # requests a batch
        for turn in range(2 * n):             # two passes: fill the tail
            name = self._order[(start + turn) % n]
            q = self._queues[name]
            # a tenant's weight is how many head requests one visit may
            # take (>=1); fairness is round-robin over visits
            take = max(int(self.tenants[name].weight), 1)
            while take and q and len(picked) != limit:
                head = q[0]
                if seed is None:
                    seed = head.payload
                elif not self._compat(seed, head.payload):
                    break                     # different shape: next round
                if rows + head.rows > self.max_batch:
                    take = 0
                    break
                picked.append((name, q.popleft()))
                rows += head.rows
                take -= 1
            if rows >= self.max_batch or len(picked) == limit:
                break
        if picked:
            self._rr = (start + 1) % n        # rotate the seed tenant
            return picked
        return None

    def _admit(self, force: bool = False) -> None:
        """Admit ripe micro-batches while the AIMD window has room."""
        while self._session.outstanding < self._win:
            queued = [q for q in self._queues.values() if q]
            if not queued:
                return
            now = time.perf_counter()
            oldest = min(q[0].t_enq for q in queued)
            total_rows = sum(r.rows for q in queued for r in q)
            ripe = (force or total_rows >= self.max_batch
                    or now - oldest >= self.batch_window_s)
            if not ripe:
                return
            picked = self._gather()
            if not picked:
                return
            parts = [r.payload for _, r in picked]
            big = parts[0] if len(parts) == 1 else torch.cat(parts, 0)
            rows = big.shape[0]
            if self.deterministic and rows < self.max_batch:
                pad = torch.zeros((self.max_batch - rows, *big.shape[1:]),
                                  dtype=big.dtype, device=big.device)
                big = torch.cat([big, pad], 0)
            t_sub = time.perf_counter()
            seq = self._session.submit(big)
            members, row0 = [], 0
            for name, req in picked:
                m = _Member(name, req, row0)
                row0 = m.row1
                members.append(m)
            self._members[seq] = members
            self._submit_times[seq] = t_sub
            self._inflight_order.append(seq)

    def _advance(self) -> bool:
        """Deliver the next completed micro-batch (blocking); → False
        when there is nothing queued or in flight."""
        # backlog, not outstanding: a controller that pumps re-entrantly
        # (checkpoint inside on_result) can park the last arrival in the
        # ready map with nothing left pending — it still must be emitted
        if not self._session.backlog:
            self._admit(force=True)           # nothing to wait on: flush
            if not self._session.backlog:
                return False
        # both engines hand the result over ready: a thread stage
        # synchronises its stream before it sends, a process engine's
        # receive synchronises after the unpack — so ``now`` is taken
        # with the rows on the device, not merely enqueued
        value = next(self._session.results(), None)
        now = time.perf_counter()
        while self._inflight_order and self._inflight_order[0] \
                in self._canceled:
            self._canceled.discard(self._inflight_order.popleft())
        if value is None:
            # everything still in flight was canceled: pump the session
            # until the flush markers land, then admit what queued up
            if self._session.outstanding:
                self._session.drain()
            if self._has_work():
                self._admit(force=True)
                return True
            return False
        seq = self._inflight_order.popleft()
        members = self._members.pop(seq, [])
        t_sub = self._submit_times.pop(seq, now)
        energy = self._emeter.update()
        wire = self._wmeter.update()
        n = max(len(members), 1)
        pad_rows = self.max_batch if self.deterministic \
            else (members[-1].row1 if members else 1)
        violated_any = False
        for m in members:
            y = value[m.row0:m.row1].clone()   # detach from the pad
            spec = self.tenants[m.tenant]
            latency = now - m.t_enq
            violated = latency > spec.slo_s
            violated_any = violated_any or violated
            rec = QoSRecord(
                tenant=m.tenant, req_id=m.req_id, seq=seq,
                t_s=self.pipe.clock(),
                queue_s=t_sub - m.t_enq, service_s=now - t_sub,
                wire_s=wire, latency_s=latency,
                rows=m.row1 - m.row0, coalesced=len(members),
                occupancy=(members[-1].row1 / pad_rows) if members else 0.0,
                energy_j=energy / n, slo_s=spec.slo_s, violated=violated)
            _log_qos(self._gid, rec)
            self.qos_recent.append(rec)
            self._results[m.tenant].append((m.req_id, y))
            self._events.append((m.tenant, m.req_id))
        self._aimd(seq, violated_any)
        self._admit()
        return True

    def _aimd(self, seq: int, violated: bool) -> None:
        win0 = self._win
        if violated:
            self._clean = 0
            # one decrease per in-flight window: a violation from a
            # batch submitted before the last decrease is stale signal
            if seq > self._md_barrier:
                self._win = max(self._win // 2, 1)
                self._md_barrier = self._session._next_seq - 1
        else:
            self._clean += 1
            if self._clean >= self.ai_every and self._win < self._win_cap:
                self._win += 1
                self._clean = 0
        if self._win != win0:
            self._session.set_inflight(self._win)
            self.window_history.append((self.pipe.clock(), self._win))


# --------------------------------------------------------------------------- #
# the per-tenant handle
# --------------------------------------------------------------------------- #
class ClientSession:
    """One tenant's view of the gateway: a Session-shaped handle whose
    ``submit``/``results``/``drain`` speak per-tenant request ids.
    Cheap — all state lives in the gateway; make as many as you like."""

    def __init__(self, gateway: Gateway, tenant: str):
        self.gateway = gateway
        self.tenant = tenant
        self._emitted = 0                     # next req_id results() yields

    @property
    def spec(self) -> TenantSpec:
        return self.gateway.tenants[self.tenant]

    def submit(self, x) -> int:
        return self.gateway.submit(self.tenant, x)

    @property
    def pending(self) -> int:
        gw = self.gateway
        queued = len(gw._queues[self.tenant])
        inflight = sum(1 for ms in gw._members.values()
                       for m in ms if m.tenant == self.tenant)
        return queued + inflight

    def results(self):
        """Yield ``(req_id, value)`` in submit order for every request
        submitted so far (skipped/canceled requests yield
        ``(req_id, None)``)."""
        gw = self.gateway
        while self._emitted < gw._next_req[self.tenant]:
            q = gw._results[self.tenant]
            if q and q[0][0] == self._emitted:
                self._emitted += 1
                yield q.popleft()
                continue
            if not gw._advance():
                return                        # nothing left anywhere
        return

    def drain(self) -> list[tuple[int, object]]:
        return list(self.results())


# --------------------------------------------------------------------------- #
# fleet-level Pareto control
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class FleetObjectives:
    """The workload-level Pareto axes at one control decision."""

    t_s: float                  # pipeline clock at aggregation
    n: int                      # requests aggregated
    p50_s: float                # median request latency
    p99_s: float                # tail request latency
    aggregate_ips: float        # served rows / wall-clock second
    j_per_request: float        # energy estimate per request
    violation_rate: float       # SLO-violating fraction
    strictest_slo_s: float      # tightest SLO with live traffic
    policy: str                 # splitter policy chosen for this regime


class FleetController(AdaptiveController):
    """Drive the adaptive split loop by *fleet* objectives.

    Extends :class:`AdaptiveController` (same checkpoint → estimate →
    re-solve → migrate machinery, including codec switches) but, before
    each re-solve, aggregates the gateway's recent per-request QoS into
    :class:`FleetObjectives` and steers the splitter's policy axis:
    tail latency above the strictest live SLO selects the latency-min
    split, headroom selects the throughput-max split.  The existing
    hysteresis/amortization gates still own *whether* a migration is
    worth its cost."""

    def __init__(self, splitter, estimators=None, *,
                 fleet_window: int = 64, **kw):
        super().__init__(splitter, estimators, **kw)
        self.fleet_window = fleet_window
        self.fleet_history: list[FleetObjectives] = []
        self._gw: Gateway | None = None

    def attach_gateway(self, gateway: Gateway) -> None:
        self._gw = gateway

    def fleet_objectives(self) -> FleetObjectives | None:
        gw = self._gw
        if gw is None or not gw.qos_recent:
            return None
        recent = list(gw.qos_recent)[-self.fleet_window:]
        lats = np.asarray([r.latency_s for r in recent])
        t0 = min(r.t_s - r.latency_s for r in recent)
        t1 = max(r.t_s for r in recent)
        rows = sum(r.rows for r in recent)
        strictest = min(gw.tenants[r.tenant].slo_s for r in recent)
        p99 = float(np.percentile(lats, 99))
        policy = "latency" if p99 > strictest else "throughput"
        return FleetObjectives(
            t_s=gw.pipe.clock(), n=len(recent),
            p50_s=float(np.percentile(lats, 50)), p99_s=p99,
            aggregate_ips=rows / max(t1 - t0, 1e-9),
            j_per_request=float(np.mean([r.energy_j for r in recent])),
            violation_rate=float(np.mean([r.violated for r in recent])),
            strictest_slo_s=strictest, policy=policy)

    def on_result(self, session: Session, seq: int, latency_s: float,
                  cuts: tuple[int, ...]):
        # steer before the (possibly re-solving) parent hook runs, so
        # this arrival's re-solve already optimizes the fleet's axis
        if (self._count + 1) % self.check_every == 0:
            obj = self.fleet_objectives()
            if obj is not None:
                self.splitter.policy = obj.policy
                self.fleet_history.append(obj)
        return super().on_result(session, seq, latency_s, cuts)
