"""The live transport-protocol sanitizer (the port of the reference's
``runtime/sanitizer.py``, the live layer under PipeCheck).

``SanitizedChannel`` wraps any :class:`~repro_torch.runtime.transport.Channel`
and validates the in-band token state machine per message, on both the
send and the receive side of the hop:

* **WARMUP-after-RECONFIG** — once a hop has carried a BATCH, every
  RECONFIG must be followed by a WARMUP before the next BATCH (the
  migration protocol's warm-up fence).  Quiescent reconfigs on a hop
  that never saw traffic are exempt.
* **STOP is terminal** — nothing may follow a STOP in either direction
  (repeated STOPs are tolerated: engine teardown is idempotent).
* **RECONFIG payloads are well-formed** — a ``{bounds, codecs}`` dict
  (or the legacy bare bounds tuple) with strictly-increasing integer
  bounds and codec names drawn from the registry.
* **exactly-once token delivery** — the same RECONFIG delivered twice
  back-to-back means a fan-in merge returned a broadcast token once
  per lane instead of once per group.
* **per-lane content order** — while both ends of a hop live in one
  process (thread engine, pre-spawn), batch payload fingerprints are
  queued at ``send`` and matched at ``recv``; a swap or corruption
  surfaces as a ``seq-order`` violation.  The ledger is dropped when an
  end crosses a process boundary.
* **zero-copy lease discipline** — a ``recv`` that hands out a host view
  over memory it does not own (a numpy view with a ``base``, a torch
  view with a ``_base``) leases it until the *next* ``recv``: a canary
  (CRC of head+tail bytes) is stamped on it and re-checked at the next
  ``recv`` entry, so a sender that wrote into a leased slot raises
  instead of silently corrupting a tensor.  A CUDA payload is never a
  view over transport memory, so it is never leased; the socket receive
  copies into tensor-owned memory, so its leases always hold.

Fingerprints and canaries hash tensor bytes on the host: a CUDA payload
is sampled (16 elements from each end; all of it in deep mode) and
copied to the host only while the sanitizer is on.

Violations are appended to a process-global report *and* raised as
:class:`SanitizerError` (a ``TransportError``, so engine error paths
propagate them like any transport failure).  ``drain_violations()``
empties the report; matrix tests assert it stays empty.

Enable per hop with ``HopSpec(sanitize=True)``, per pipeline with
``EdgePipeline(..., sanitize=True)``, or globally with
``REPRO_SANITIZE=1`` in the environment.
"""
from __future__ import annotations

import os
import threading
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.codecs import host_bytes
from .transport import (
    BATCH, RECONFIG, STOP, WARMUP, _KIND_NAMES, TransportError, _dtype_name,
)

__all__ = [
    "SanitizerError", "Violation", "SanitizedChannel",
    "deep_enabled", "drain_violations", "maybe_sanitize", "sanitize_enabled",
]


class SanitizerError(TransportError):
    """A live protocol invariant was violated on a sanitized hop."""


@dataclass(frozen=True)
class Violation:
    """One protocol violation: which rule, on which hop, at which point
    of the stream (seq = messages of that direction seen so far)."""

    rule: str
    hop: int
    seq: int
    kind: int
    message: str

    def render(self) -> str:
        kind = (_KIND_NAMES[self.kind]
                if 0 <= self.kind < len(_KIND_NAMES) else str(self.kind))
        return (f"[{self.rule}] hop {self.hop} seq {self.seq} "
                f"kind {kind}: {self.message}")


_VIOLATIONS: list[Violation] = []
_VLOCK = threading.Lock()


def drain_violations() -> list[Violation]:
    """Return and clear every violation collected in this process."""
    with _VLOCK:
        out = list(_VIOLATIONS)
        _VIOLATIONS.clear()
    return out


def sanitize_enabled(explicit: Optional[bool] = None) -> bool:
    """Resolve a sanitize knob: an explicit True/False wins, otherwise
    the ``REPRO_SANITIZE`` env var ("" / "0" = off)."""
    if explicit is not None:
        return bool(explicit)
    return os.environ.get("REPRO_SANITIZE", "") not in ("", "0")


def maybe_sanitize(chan):
    """Wrap ``chan`` in a SanitizedChannel iff its hop asks for it."""
    if getattr(chan.hop, "sanitize", False) \
            and not isinstance(chan, SanitizedChannel):
        return SanitizedChannel(chan)
    return chan


# --------------------------------------------------------------------------- #
# payload fingerprints
# --------------------------------------------------------------------------- #
_SAMPLE = 16  # elements hashed from each end of a batch


def deep_enabled() -> bool:
    """``REPRO_SANITIZE_DEEP=1``: hash the *full* payload instead of a
    head/tail sample.  Read per call so a test can flip it; the cost is
    one crc32 pass (and, on the card, one device-to-host copy) over
    every batch on every sanitized hop."""
    return os.environ.get("REPRO_SANITIZE_DEEP", "") not in ("", "0")


def _as_tensor(payload) -> Optional[torch.Tensor]:
    """A tensor payload as a tensor (numpy arrays share their memory);
    None for anything else."""
    if isinstance(payload, torch.Tensor):
        return payload.detach()
    if isinstance(payload, np.ndarray):
        return torch.from_numpy(payload)
    return None


def _content_crc(t: torch.Tensor) -> int:
    if deep_enabled():
        return zlib.crc32(host_bytes(t))
    flat = t.reshape(-1)  # a view for contiguous payloads (the common case)
    return zlib.crc32(host_bytes(flat[:_SAMPLE], flat[-_SAMPLE:]))


def _fingerprint(payload, content: bool) -> tuple:
    """(tag, shape, dtype, crc|None) identity of a batch payload.

    ``content=False`` (a coded hop: the codec legitimately rewrites the
    bytes in flight) keeps only the structural identity.
    """
    t = _as_tensor(payload)
    if t is not None:
        key = ("nd", tuple(t.shape), _dtype_name(t.dtype))
        if not content or t.numel() == 0:
            return (*key, None)
        return (*key, _content_crc(t))
    return ("obj", repr(payload)[:200], None, None)


def _leased_view(payload) -> Optional[torch.Tensor]:
    """The payload as a host tensor when it is a non-empty view over
    memory it does not own (what a zero-copy receive hands out), else
    None."""
    if isinstance(payload, np.ndarray):
        view = payload.base is not None
    elif isinstance(payload, torch.Tensor):
        view = payload.device.type == "cpu" and payload._base is not None
    else:
        return None
    t = _as_tensor(payload)
    return t if view and t.numel() else None


class _Ledger:
    """Send→recv fingerprint queue shared by the two wrapped ends of a
    hop while both live in the creating process.  Bounded so a
    recv-less drain (e.g. a closed pipeline) cannot grow it forever."""

    __slots__ = ("fps",)
    _MAX = 4096

    def __init__(self):
        from collections import deque
        self.fps = deque(maxlen=self._MAX)


# --------------------------------------------------------------------------- #
# the wrapper
# --------------------------------------------------------------------------- #
class SanitizedChannel:
    """Protocol-checking wrapper around a concrete Channel.

    Composition, not inheritance: every Channel attribute (``hop``,
    ``link``, observation counters, transport internals) delegates to
    the wrapped instance, so the wrapper is state-free apart from the
    checker itself and can front any transport."""

    def __init__(self, inner, _ledger: Optional[_Ledger] = None):
        self._inner = inner
        self._ledger = _ledger if _ledger is not None else _Ledger()
        # direction-local protocol state
        self._tx_seq = 0
        self._rx_seq = 0
        self._tx_batches = 0
        self._rx_batches = 0
        self._tx_stopped = False
        self._rx_stopped = False
        self._tx_need_warmup = False
        self._rx_need_warmup = False
        self._last_rx_token: Optional[tuple] = None
        self._lease: Optional[tuple] = None  # (crc, view, seq)

    # -- violation plumbing -------------------------------------------------
    def _violate(self, rule: str, seq: int, kind: int, message: str) -> None:
        v = Violation(rule, getattr(self.hop, "index", -1), seq, kind, message)
        with _VLOCK:
            _VIOLATIONS.append(v)
        raise SanitizerError(v.render())

    def _check_kind(self, kind, seq: int) -> None:
        if not isinstance(kind, int) or not 0 <= kind < len(_KIND_NAMES):
            self._violate("kind-range", seq, -1,
                          f"token kind {kind!r} outside the "
                          f"{len(_KIND_NAMES)}-kind protocol")

    def _content_checked(self) -> bool:
        # a coded hop rewrites payload bytes in flight; only structural
        # identity survives the wire
        return getattr(self.hop, "codec", "none") == "none"

    @staticmethod
    def _reconfig_error(payload) -> Optional[str]:
        if isinstance(payload, dict):
            if "bounds" not in payload:
                return "RECONFIG dict carries no 'bounds'"
            bounds, codecs = payload["bounds"], payload.get("codecs")
        elif isinstance(payload, (tuple, list)):
            bounds, codecs = payload, None
        else:
            return (f"RECONFIG payload must be a {{bounds, codecs}} dict or "
                    f"a bounds tuple, got {type(payload).__name__}")
        try:
            b = tuple(int(x) for x in bounds)
        except (TypeError, ValueError):
            return f"bounds is not an integer sequence: {bounds!r}"
        if len(b) < 2 or any(x >= y for x, y in zip(b, b[1:])):
            return f"bounds must be strictly increasing with >=2 edges: {b}"
        if codecs is not None:
            from ..core.codecs import CODECS
            try:
                bad = [c for c in codecs if c not in CODECS]
            except TypeError:
                return f"codecs is not a sequence of names: {codecs!r}"
            if bad:
                return f"unknown codec name(s) {bad} (registry: " \
                       f"{sorted(CODECS)})"
        return None

    # -- the checked surface ------------------------------------------------
    def send(self, payload=None, kind: int = BATCH):
        seq = self._tx_seq
        self._tx_seq += 1
        self._check_kind(kind, seq)
        if self._tx_stopped and kind != STOP:
            self._violate("stop-terminal", seq, kind,
                          "message sent after STOP (STOP is terminal)")
        if kind == STOP:
            self._tx_stopped = True
        elif kind == RECONFIG:
            err = self._reconfig_error(payload)
            if err is not None:
                self._violate("reconfig-payload", seq, kind, err)
            if self._tx_batches:
                self._tx_need_warmup = True
        elif kind == WARMUP:
            self._tx_need_warmup = False
        elif kind == BATCH:
            if self._tx_need_warmup:
                self._violate(
                    "warmup-skipped", seq, kind,
                    "BATCH sent after RECONFIG with no WARMUP fence between")
            self._tx_batches += 1
            if self._ledger is not None:
                self._ledger.fps.append(
                    _fingerprint(payload, self._content_checked()))
        return self._inner.send(payload, kind=kind)

    def recv(self, timeout: Optional[float] = None):
        self._check_lease()
        seq = self._rx_seq
        try:
            kind, payload = self._inner.recv(timeout)
        except TransportError:
            raise
        except Exception as exc:
            # a decode failure (unknown codec byte, mangled frame) comes
            # out of the framer as KeyError/ValueError/struct.error —
            # report it as a frame violation with hop context
            self._violate("frame-decode", seq, -1,
                          f"{type(exc).__name__}: {exc}")
        self._rx_seq += 1
        self._check_kind(kind, seq)
        if self._rx_stopped and kind != STOP:
            self._violate("stop-terminal", seq, kind,
                          "message received after STOP (STOP is terminal)")
        token_id: Optional[tuple] = None
        if kind == STOP:
            self._rx_stopped = True
        elif kind == RECONFIG:
            err = self._reconfig_error(payload)
            if err is not None:
                self._violate("reconfig-payload", seq, kind, err)
            token_id = ("RECONFIG", repr(payload)[:200])
            if token_id == self._last_rx_token:
                self._violate(
                    "token-dup", seq, kind,
                    "identical RECONFIG delivered twice back-to-back — a "
                    "fan-in merge must return each broadcast token exactly "
                    "once per lane group")
            if self._rx_batches:
                self._rx_need_warmup = True
        elif kind == WARMUP:
            self._rx_need_warmup = False
        elif kind == BATCH:
            if self._rx_need_warmup:
                self._violate(
                    "warmup-skipped", seq, kind,
                    "BATCH received after RECONFIG with no WARMUP fence "
                    "between")
            if self._ledger is not None and self._ledger.fps:
                expected = self._ledger.fps.popleft()
                got = _fingerprint(payload, expected[3] is not None)
                if got != expected:
                    self._violate(
                        "seq-order", seq, kind,
                        f"batch out of order or corrupted in flight: "
                        f"expected fingerprint {expected}, got {got}")
            self._rx_batches += 1
            self._arm_lease(payload)
        self._last_rx_token = token_id
        return kind, payload

    # -- zero-copy lease canaries -------------------------------------------
    def _arm_lease(self, payload) -> None:
        self._lease = None
        if not getattr(self.hop, "zero_copy", True):
            return
        view = _leased_view(payload)
        if view is not None:
            self._lease = (_content_crc(view), view, self._rx_batches)

    def _check_lease(self) -> None:
        lease, self._lease = self._lease, None
        if lease is None:
            return
        crc0, view, seq = lease
        try:
            crc = _content_crc(view)
        except Exception:
            return  # buffer already released: nothing left to corrupt
        if crc != crc0:
            self._violate(
                "lease", seq, BATCH,
                "zero-copy view of the previous batch changed under its "
                "lease — a sender wrote into a leased slot (or user code "
                "mutated a stale view); copy before the next recv")

    # -- delegation ---------------------------------------------------------
    @property
    def hop(self):
        return self._inner.hop

    @property
    def epoch(self) -> float:
        return self._inner.epoch

    @epoch.setter
    def epoch(self, value: float) -> None:
        self._inner.epoch = value

    def reset_stream(self) -> None:
        """Start a fresh stream over a reused channel.

        STOP is terminal *per stream*, not per channel: the thread
        engine keeps its inter-stage channels across sessions (a clean
        close leaves them empty), so each ``session_open`` resets the
        protocol state machine.  Cumulative seq counters survive — a
        violation report should still locate the message in the
        channel's lifetime."""
        self._tx_batches = 0
        self._rx_batches = 0
        self._tx_stopped = False
        self._rx_stopped = False
        self._tx_need_warmup = False
        self._rx_need_warmup = False
        self._last_rx_token = None
        self._lease = None
        if self._ledger is not None:
            self._ledger.fps.clear()

    def split(self):
        tx, rx = self._inner.split()
        ledger = _Ledger()
        wrapped_tx = SanitizedChannel(tx, _ledger=ledger)
        if rx is tx:  # in-process pair: one shared end (emulated)
            return wrapped_tx, wrapped_tx
        return wrapped_tx, SanitizedChannel(rx, _ledger=ledger)

    def set_codec(self, name: str) -> None:
        self._inner.set_codec(name)

    def close(self) -> None:
        self._lease = None
        self._inner.close()

    def reap(self) -> None:
        self._inner.reap()

    def drain_records(self):
        return self._inner.drain_records()

    def drain_observations(self):
        return self._inner.drain_observations()

    def __getattr__(self, name: str):
        inner = self.__dict__.get("_inner")
        if inner is None:  # mid-unpickle: nothing to delegate to yet
            raise AttributeError(name)
        return getattr(inner, name)

    # crossing a process boundary drops the in-process-only state (the
    # fingerprint ledger and any armed lease canary); the token state
    # machine itself travels with the end
    def __getstate__(self):
        state = dict(self.__dict__)
        state["_ledger"] = None
        state["_lease"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)

    def __repr__(self) -> str:
        return f"SanitizedChannel({self._inner!r})"
