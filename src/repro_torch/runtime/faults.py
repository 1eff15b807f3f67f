"""Chaos transport and recovery bookkeeping for fault-tolerant pipelines
(the port of the reference's ``runtime/faults.py``, over this package's
transport).

The paper's testbed is real hardware: workers get OOM-killed, links stall
and flap, frames arrive mangled.  This module supplies the two halves the
runtime needs to survive that world deterministically:

* **Fault injection** — a :class:`FaultPlan` is a seeded, picklable script
  of :class:`FaultEvent`\\ s ("kill stage 1 at batch 3", "stall the feed hop
  for 300 ms at batch 2").  Frame-level events are applied by
  :class:`ChaosChannel`, a send-side composition wrapper in the
  ``SanitizedChannel`` style: it wraps any channel whose ``hop`` carries a
  plan (``HopSpec(faults=...)``) and perturbs the wire *below* the
  sanitizer, so a sanitized stream that recovers cleanly also drains zero
  violations.  Worker-kill events are executed by the engine supervisor
  (``_ProcessEngine``), which SIGKILLs the scripted process the moment the
  triggering batch has been fed.

* **Recovery bookkeeping** — every supervised recovery (stage restart,
  replica failover, background restaff) emits a :class:`RecoveryRecord`
  into a module-level buffer drained with :func:`drain_recoveries`, the
  same contract ``sanitizer.drain_violations`` uses.  :class:`BackoffPolicy`
  pins the bounded exponential retry schedule the supervisor follows
  between recovery attempts.

Determinism: a plan holds *batch sequence numbers*, not wall-clock times.
The feed hop is addressed as hop ``-1``; its seq counter is the global
batch index, so "drop batch 2" means the same thing on every run and every
transport.  Faults fire exactly once — a replayed batch after recovery is
a fresh send on fresh channels and is not re-perturbed.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, replace

from .transport import BATCH

__all__ = [
    "FAULT_KINDS",
    "FaultEvent",
    "FaultPlan",
    "BackoffPolicy",
    "RecoveryRecord",
    "Injection",
    "ChaosChannel",
    "maybe_chaos",
    "note_recovery",
    "drain_recoveries",
    "drain_injections",
]

# The feed hop (orchestrator -> stage 0) in FaultPlan addressing.  Its seq
# counter is the global batch index, which makes feed-side plans portable
# across cut placements.
FEED_HOP = -1

# Frame kind used by header corruption: outside the 0..8 token range, so a
# sanitized receiver flags it (kind-range violation in the worker, which
# the supervisor turns into a recovery) and an unsanitized worker's
# dispatch ladder silently drops it (stall detection recovers instead).
CORRUPT_KIND = 0x6B

FAULT_KINDS = (
    "worker-kill",    # SIGKILL a (stage, lane) worker after batch seq N is fed
    "frame-stall",    # hold the frame for arg seconds before sending
    "frame-drop",     # swallow the frame (never reaches the wire)
    "frame-dup",      # send the frame twice with the same wire seq
    "link-flap",      # link down for arg seconds starting at this frame
    "header-corrupt", # replace the frame's kind byte with CORRUPT_KIND
)


@dataclass(frozen=True)
class FaultEvent:
    """One scripted fault.

    ``seq`` is the 0-based BATCH count on the addressed channel end
    (``hop == FEED_HOP`` → global batch index).  ``stage``/``lane`` are
    only meaningful for ``worker-kill``; ``arg`` holds the duration in
    seconds for ``frame-stall`` / ``link-flap``.
    """

    kind: str
    hop: int = FEED_HOP
    seq: int = 0
    stage: int = -1
    lane: int = 0
    arg: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")


@dataclass(frozen=True)
class FaultPlan:
    """A deterministic, picklable script of faults.

    Its methods return a *new* plan (the dataclass is frozen), so
    plans compose fluently::

        plan = (FaultPlan(seed=7)
                .stall(hop=-1, at_seq=2, for_s=0.3)
                .kill_worker(stage=1, at_seq=4))

    The plan travels inside each ``HopSpec`` to worker processes, so it
    must stay tuples-of-frozen-dataclasses all the way down.
    """

    seed: int = 0
    events: tuple = ()

    def _with(self, ev: FaultEvent) -> "FaultPlan":
        return replace(self, events=self.events + (ev,))

    def kill_worker(self, stage: int, at_seq: int, lane: int = 0) -> "FaultPlan":
        return self._with(FaultEvent("worker-kill", seq=at_seq,
                                     stage=stage, lane=lane))

    def stall(self, hop: int, at_seq: int, for_s: float) -> "FaultPlan":
        return self._with(FaultEvent("frame-stall", hop=hop, seq=at_seq,
                                     arg=float(for_s)))

    def drop(self, hop: int, at_seq: int) -> "FaultPlan":
        return self._with(FaultEvent("frame-drop", hop=hop, seq=at_seq))

    def duplicate(self, hop: int, at_seq: int) -> "FaultPlan":
        return self._with(FaultEvent("frame-dup", hop=hop, seq=at_seq))

    def flap(self, hop: int, at_seq: int, down_s: float) -> "FaultPlan":
        return self._with(FaultEvent("link-flap", hop=hop, seq=at_seq,
                                     arg=float(down_s)))

    def corrupt(self, hop: int, at_seq: int) -> "FaultPlan":
        return self._with(FaultEvent("header-corrupt", hop=hop, seq=at_seq))

    # -- views used by the chaos wrapper and the supervisor ----------------
    def channel_events(self, hop: int) -> dict:
        """seq -> [events] for frame-level faults on one hop."""
        out: dict = {}
        for ev in self.events:
            if ev.kind != "worker-kill" and ev.hop == hop:
                out.setdefault(ev.seq, []).append(ev)
        return out

    def kill_events(self) -> dict:
        """global batch seq -> [worker-kill events]."""
        out: dict = {}
        for ev in self.events:
            if ev.kind == "worker-kill":
                out.setdefault(ev.seq, []).append(ev)
        return out


@dataclass(frozen=True)
class BackoffPolicy:
    """Bounded exponential backoff between supervisor recovery attempts.

    ``delay(a) = min(base_s * factor**a, cap_s)`` for attempt ``a`` in
    ``0..retries-1``; after ``retries`` failed attempts the supervisor
    gives up and surfaces the underlying ``TransportError``.
    """

    base_s: float = 0.05
    factor: float = 2.0
    cap_s: float = 2.0
    retries: int = 5

    def delay(self, attempt: int) -> float:
        return min(self.base_s * self.factor ** attempt, self.cap_s)

    def schedule(self) -> tuple:
        return tuple(self.delay(a) for a in range(self.retries))


# --------------------------------------------------------------------------- #
# Recovery records — drained like sanitizer violations
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class RecoveryRecord:
    """One completed recovery, with the timings the paper's robustness
    story needs: how fast was the failure *detected*, how long did the
    *restart* (respawn + channel rebuild + WARMUP fence) take, how long
    did the in-flight *replay* take, and at what capacity fraction does
    the pipeline run until restaffed.
    """

    kind: str              # "restart" | "failover" | "restaff"
    stage: int             # failed stage (-1 if unknown / whole-pipeline)
    lane: int              # failed replica lane (-1 if not replicated)
    reason: str            # "worker-death" | "worker-error" | "stall" | ...
    detect_s: float        # last-known-alive -> failure detected
    restart_s: float       # teardown + respawn + warmup fence
    replay_s: float        # resubmit of unacked in-flight batches
    batches_replayed: int
    degraded_capacity: float  # min_i r_eff[i]/r[i] after this recovery

    def render(self) -> str:
        return (f"[{self.kind}] stage={self.stage} lane={self.lane} "
                f"({self.reason}): detect={self.detect_s * 1e3:.0f}ms "
                f"restart={self.restart_s * 1e3:.0f}ms "
                f"replay={self.replay_s * 1e3:.0f}ms "
                f"({self.batches_replayed} batches) "
                f"capacity={self.degraded_capacity:.2f}")


_RECOVERIES: list = []
_RLOCK = threading.Lock()


def note_recovery(rec: RecoveryRecord) -> None:
    with _RLOCK:
        _RECOVERIES.append(rec)


def drain_recoveries() -> list:
    """Return and clear all recoveries since the last drain (orchestrator
    process only — recoveries are executed and recorded by the parent).
    """
    with _RLOCK:
        out = list(_RECOVERIES)
        _RECOVERIES.clear()
    return out


@dataclass(frozen=True)
class Injection:
    """A fault that actually fired, for tests asserting the chaos layer
    did its job (visible only in the process that executed the send)."""

    kind: str
    hop: int
    seq: int


_INJECTIONS: list = []
_ILOCK = threading.Lock()


def _note_injection(kind: str, hop: int, seq: int) -> None:
    with _ILOCK:
        _INJECTIONS.append(Injection(kind, hop, seq))


def drain_injections() -> list:
    with _ILOCK:
        out = list(_INJECTIONS)
        _INJECTIONS.clear()
    return out


# --------------------------------------------------------------------------- #
# ChaosChannel — send-side fault injection by composition
# --------------------------------------------------------------------------- #
class ChaosChannel:
    """Wraps a channel's send side and applies its hop's scripted faults.

    Layering: the engine wraps ``maybe_chaos(maybe_sanitize(chan))`` — the
    chaos wrapper sits *outside* the sanitizer so honest traffic is still
    ledgered, while injected wire damage (duplicate frames, corrupt
    headers) goes through ``_raw`` — the innermost transport — bypassing
    the sanitizer's tx checks.  That models a fault below the observation
    point: the *receiver* (wire-seq dedup, kind-range check) has to cope,
    and a clean recovery leaves ``drain_violations()`` empty on the
    orchestrator.

    Only BATCH frames advance the fault seq counter, so plans target batch
    indices regardless of interleaved control tokens.
    """

    def __init__(self, inner, fired: set | None = None):
        self._inner = inner
        self._events = inner.hop.faults.channel_events(inner.hop.index)
        # events that already fired: shared across channel rebuilds (the
        # engine passes one set per pipeline), so a recovery's replayed
        # batches are never re-perturbed by the fault that killed them
        self._fired = fired if fired is not None else set()
        self._seq = 0              # BATCH frames sent through this end
        self._down_until = 0.0     # link-flap outage window (monotonic)

    # -- identity ----------------------------------------------------------
    @property
    def hop(self):
        return self._inner.hop

    @property
    def epoch(self):
        return self._inner.epoch

    @epoch.setter
    def epoch(self, value):
        self._inner.epoch = value

    @property
    def _raw(self):
        """The innermost transport channel (below any sanitizer)."""
        return getattr(self._inner, "_inner", self._inner)

    # -- the perturbed surface --------------------------------------------
    def send(self, payload=None, kind=BATCH):
        now = time.perf_counter()
        if self._down_until > now:          # link still down from a flap
            time.sleep(self._down_until - now)
        if kind != BATCH:
            return self._inner.send(payload, kind=kind)
        seq = self._seq
        self._seq += 1
        events = [ev for ev in self._events.get(seq, ())
                  if ev not in self._fired]
        self._fired.update(events)
        for ev in events:
            _note_injection(ev.kind, ev.hop, seq)
            if ev.kind == "frame-stall":
                time.sleep(ev.arg)
            elif ev.kind == "link-flap":
                self._down_until = time.perf_counter() + ev.arg
                time.sleep(ev.arg)
            elif ev.kind == "frame-drop":
                # The frame "left" the sender but never arrives: burn its
                # wire seq so the receiver sees a gap and fails fast
                # instead of silently misattributing later batches.
                raw = self._raw
                if hasattr(raw, "_tx_seq"):
                    raw._tx_seq += 1
                return None
            elif ev.kind == "header-corrupt":
                # Replace the frame: same payload, out-of-range kind byte.
                return self._send_raw(payload, CORRUPT_KIND)
        out = self._inner.send(payload, kind=kind)
        for ev in events:
            if ev.kind == "frame-dup":
                # Re-send below the sanitizer with the *same* wire seq so
                # the receiver's dedup — not the ledger — has to absorb it.
                self._send_raw(payload, kind, dup=True)
        return out

    def _send_raw(self, payload, kind, dup=False):
        raw = self._raw
        try:
            return raw.send(payload, kind=kind, _dup=dup)
        except TypeError:
            # Transport without wire-seq support (emulated/queue): plain
            # resend — the receiver sees a genuine duplicate.
            return raw.send(payload, kind=kind)

    def recv(self, timeout=None):
        return self._inner.recv(timeout)

    # -- delegated surface (mirrors SanitizedChannel) ----------------------
    def split(self):
        tx, rx = self._inner.split()
        out = ChaosChannel(tx, fired=self._fired)
        out._seq = self._seq
        return out, rx

    def reset_stream(self):
        self._inner.reset_stream()

    def set_codec(self, codec) -> None:
        self._inner.set_codec(codec)

    def close(self) -> None:
        self._inner.close()

    def reap(self) -> None:
        self._inner.reap()

    def drain_records(self):
        return self._inner.drain_records()

    def drain_observations(self):
        return self._inner.drain_observations()

    def __getattr__(self, name):
        inner = self.__dict__.get("_inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)

    def __getstate__(self):
        return dict(self.__dict__)

    def __setstate__(self, state):
        self.__dict__.update(state)

    def __repr__(self):
        return f"ChaosChannel({self._inner!r})"


def maybe_chaos(chan, fired: set | None = None):
    """Wrap ``chan`` in a :class:`ChaosChannel` iff its hop carries a
    fault plan with frame-level events for that hop.  Worker-kill events
    are the supervisor's job and never cause wrapping.  ``fired`` is the
    engine's per-pipeline set of already-executed events; sharing it
    across channel rebuilds keeps recovery replays unperturbed.
    """
    plan = getattr(chan.hop, "faults", None)
    if plan is None or isinstance(chan, ChaosChannel):
        return chan
    if not plan.channel_events(chan.hop.index):
        return chan
    return ChaosChannel(chan, fired=fired)
