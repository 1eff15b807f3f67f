"""Pluggable hop transports — the Transport/Channel API under EdgePipeline.

The paper's headline toolchain contribution is *dual communication
backends* whose overheads are measured, not modeled.  This module makes
the hop layer first-class.  The port has the **modeled** half so far:
``emulated`` is the tc-netem analogue (sleep RTT/2 + bytes/bw per
message, ``LinkTrace`` sampling, jitter), with stages as threads in this
process.  The measured ``socket``/``shmem`` process transports of the
reference raise ``NotImplementedError`` until they are ported (ROADMAP
queue 1, item 6); their frame layout (``_FHDR``/``_RREC``) is declared
here already, so both packages share one wire protocol.

Every hop is a ``Channel`` (``send(payload, kind)`` / ``recv()`` /
``close()`` / ``drain_records()``); a ``Transport`` opens one channel
per hop (``open(hop) -> Channel``).  Channels record every data transfer
as a ``TransferRecord``; emulated channels record the *injected* delay.

Payloads are tensors.  A hop's wire codec runs on the tensor's own
device: the sender packs with the CUDA kernels (``core/codecs.py``),
only packed bytes cross to the host, and the receiver unpacks on its
device — so an emulated hop carries the codec's exact accuracy cost and
byte count end to end.

Messages are typed (``BATCH``/``WARMUP``/``PROBE``/``RECONFIG``/
``STATS``/``STOP``/``ERROR``/``CLOCK``/``CANCEL``) and control tokens
flow in-band through the stage chain, so they stay ordered with the
batches around them.
"""
from __future__ import annotations

import pickle
import queue
import struct
import threading
import time
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..core.codecs import codec_for_code, get_codec, host_bytes
from ..core.devices import AnyLink, LinkTrace

# message kinds (in-band, ordered with the batches around them).
# CANCEL is the flush fence: submitted behind canceled in-flight
# batches, forwarded stage to stage, and — when its payload is truthy
# (a flush-cancel) — it closes the out-of-band skip window the engine
# opened, so workers stop short-circuiting compute.
BATCH, WARMUP, PROBE, RECONFIG, STATS, STOP, ERROR, CLOCK, CANCEL = range(9)

_KIND_NAMES = ("BATCH", "WARMUP", "PROBE", "RECONFIG", "STATS", "STOP",
               "ERROR", "CLOCK", "CANCEL")


class TransportError(RuntimeError):
    """A hop or worker host failed (peer closed, worker died, timeout)."""


class TransportTimeout(TransportError):
    """No message arrived within the requested window (retryable)."""


class TransferRecord(NamedTuple):
    """One observed transfer on a hop.  Tuple-compatible with the legacy
    ``(nbytes, elapsed_s, t_s)`` observation triple.

    ``nbytes`` is what crossed the wire (the codec-packed payload when a
    hop codec is active) — the number link estimators fit bandwidth
    against and radio energy charges for.  ``raw_bytes`` is the
    pre-codec tensor size (-1 in unpacked legacy tuples; ``record``
    normalizes it to ``nbytes``)."""

    nbytes: int
    elapsed_s: float
    t_s: float
    raw_bytes: int = -1

    @property
    def wire_bytes(self) -> int:
        return self.nbytes


@dataclass(frozen=True)
class HopSpec:
    """Static description of one hop, consumed by ``Transport.open``.
    (The reference's process-transport fields — send timeouts, zero-copy
    leases, shmem spin and doorbell, pacing, sanitizer and fault plans —
    arrive with those transports.)"""

    index: int                      # hop number (-1 = orchestrator feed)
    link: AnyLink | None = None     # the scenario link this hop models/labels
    framing: str = "raw"            # "raw" (lightweight) | "pickle" (rpc)
    depth: int = 2                  # bounded in-flight messages
    seed: int = 0                   # jitter RNG seed (emulated)
    epoch: float = 0.0              # perf_counter value at pipeline t=0
    # False for the orchestrator's feed/result plumbing: those channels
    # skip TransferRecord logging (nobody drains them, and they are not
    # hops of the scenario being measured)
    scenario_hop: bool = True
    # wire codec applied to float tensor payloads on this hop (a name
    # from ``core.codecs.CODECS``); the sender packs, the receiver
    # decodes off the per-frame codec byte, so a mid-stream RECONFIG
    # can switch codecs without coordinating the two ends
    codec: str = "none"


# --------------------------------------------------------------------------- #
# Wire framing
# --------------------------------------------------------------------------- #
# Wire-layout version: bump when _FHDR/_RREC change shape, and record
# the new format strings in the reference's analysis/manifest.py
# WIRE_LAYOUTS — PipeCheck (rule R5) fails the tree otherwise.
WIRE_LAYOUT_VERSION = 2   # v2: per-frame wire seq for duplicate suppression

# packed socket frame: ftype, kind, dtype code, ndim, codec code,
# meta_len, t_send, payload_len, wire seq, shape[8]; codec code 0 =
# uncoded payload bytes.  The shmem ring's metadata record adds the slot
# index and lease fields.  Both are the reference's layout v2, declared
# here for the process transports still to be ported.
_FHDR = struct.Struct("!BBbBB I d Q Q 8q")
_RREC = struct.Struct("<BBbBB i I I d Q Q 8q")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class _Serializer:
    """RPC-style full serialize/deserialize round trip (the reference's
    ``(shape, dtype name, bytes)`` pickle, so both packages read it)."""

    @staticmethod
    def dumps(x) -> bytes:
        t = torch.as_tensor(x)
        return pickle.dumps((tuple(t.shape), _dtype_name(t.dtype),
                             host_bytes(t)))

    @staticmethod
    def loads(buf: bytes, device) -> torch.Tensor:
        shape, dtype, raw = pickle.loads(buf)
        return get_codec("none").decode(raw, shape, getattr(torch, dtype),
                                        device)


def _decode(meta: tuple, payload: bytes, device):
    tag = meta[0]
    if tag == "R":
        return get_codec("none").decode(payload, meta[1],
                                        getattr(torch, meta[2]), device)
    if tag == "P":
        return _Serializer.loads(payload, device)
    return meta[1]


# --------------------------------------------------------------------------- #
# Packed framing — the tensor case travels as one fixed header plus the
# payload bytes; pickle survives only for exotic metadata and non-tensor
# control payloads.
# --------------------------------------------------------------------------- #
_F_EMPTY, _F_RAW, _F_OBJ, _F_PICKLE = range(4)

# dtypes the packed header can name by code, in the reference's wire
# order (append only); anything else escapes to the pickled-meta path
_DTYPES = ("float32", "float64", "float16", "bfloat16",
           "int8", "int16", "int32", "int64",
           "uint8", "uint16", "uint32", "uint64",
           "bool", "complex64", "complex128")
_TORCH_DTYPES = tuple(getattr(torch, n) for n in _DTYPES)
_DTYPE_CODE = {dt: i for i, dt in enumerate(_TORCH_DTYPES)}
_MAX_NDIM = 8


def _dtype_of(code: int) -> torch.dtype:
    """Resolve a wire dtype code."""
    return _TORCH_DTYPES[code]


def _frame(payload, framing: str,
           codec=None) -> tuple[int, int, tuple, object, bytes, int]:
    """→ (ftype, dtype code, shape, payload buffer, pickled meta,
    codec wire code), field for field what the reference frames for the
    same array.  When a (non-identity) ``codec`` applies — float tensor,
    non-empty, raw framing — the buffer is the codec-packed bytes, packed
    on the tensor's device, and the codec's wire code rides in the frame
    so the receiver can decode statelessly."""
    if payload is None:
        return _F_EMPTY, 0, (), b"", b"", 0
    if isinstance(payload, np.ndarray):
        payload = torch.from_numpy(payload)
    if isinstance(payload, torch.Tensor):
        if framing == "pickle":
            return _F_PICKLE, 0, (), _Serializer.dumps(payload), \
                pickle.dumps(("P",)), 0
        shape = tuple(payload.shape)
        code = _DTYPE_CODE.get(payload.dtype, -1)
        if code >= 0 and payload.dim() <= _MAX_NDIM:
            if (codec is not None and codec.code and payload.numel()
                    and codec.supports(payload.dtype)):
                return (_F_RAW, code, shape, codec.encode(payload), b"",
                        codec.code)
            return _F_RAW, code, shape, host_bytes(payload), b"", 0
        return _F_PICKLE, 0, (), host_bytes(payload), \
            pickle.dumps(("R", shape, _dtype_name(payload.dtype))), 0
    return _F_OBJ, 0, (), pickle.dumps(payload), b"", 0


def _unframe(ftype: int, code: int, shape: tuple, buf, meta_buf,
             ccode: int, device):
    """Inverse of ``_frame`` over received buffers; tensors land on
    ``device`` (codec-packed payloads are unpacked there)."""
    if ftype == _F_EMPTY:
        return None
    if ftype == _F_RAW:
        return codec_for_code(ccode).decode(buf, shape, _dtype_of(code),
                                            device)
    if ftype == _F_OBJ:
        return pickle.loads(buf)
    return _decode(pickle.loads(meta_buf), bytes(buf), device)


# --------------------------------------------------------------------------- #
# Observation bookkeeping (shared by live channels and orchestrator meters)
# --------------------------------------------------------------------------- #
class HopObservations:
    """Per-hop transfer log + lifetime radio accounting."""

    def __init__(self, link: AnyLink | None = None):
        self.link = link
        self._lock = threading.Lock()
        self.observations: list[TransferRecord] = []
        self.total_bytes: int = 0
        self.total_energy_j: float = 0.0
        # lifetime data-transfer counters (nbytes > 0 only): deltas give
        # mean per-transfer wire time over any window *without* draining
        # the observation log out from under the estimators
        self.total_transfers: int = 0
        self.total_elapsed_s: float = 0.0
        # pre-codec bytes (== total_bytes on uncoded hops): the
        # raw-vs-wire gap is the codec's realized saving
        self.total_raw_bytes: int = 0

    def record(self, nbytes: int, elapsed_s: float, t_s: float,
               raw_bytes: int = -1) -> TransferRecord:
        rec = TransferRecord(int(nbytes), float(elapsed_s), float(t_s),
                             int(raw_bytes) if raw_bytes >= 0 else int(nbytes))
        with self._lock:
            self.observations.append(rec)
            self.total_bytes += rec.nbytes
            self.total_raw_bytes += rec.raw_bytes
            if rec.nbytes > 0:
                self.total_transfers += 1
                self.total_elapsed_s += rec.elapsed_s
            if self.link is not None:
                self.total_energy_j += self.link.energy_per_byte_j * rec.nbytes
        return rec

    def drain_observations(self) -> list[TransferRecord]:
        with self._lock:
            obs, self.observations = self.observations, []
        return obs

    # the Channel-API name for the same drain
    drain_records = drain_observations


# --------------------------------------------------------------------------- #
# Channel interface + the emulated backend
# --------------------------------------------------------------------------- #
class Channel(HopObservations, ABC):
    """One hop's message pipe.  ``measured`` says whether records are
    wall-clock truth (process transports) or modeled delay (emulated)."""

    measured: bool = False

    def __init__(self, hop: HopSpec):
        super().__init__(hop.link)
        self.hop = hop
        self.epoch = hop.epoch
        self._codec = None                    # resolved lazily from hop.codec

    @property
    def codec(self):
        """The hop's wire codec object."""
        c = self._codec
        if c is None or c.name != self.hop.codec:
            c = self._codec = get_codec(self.hop.codec)
        return c

    def set_codec(self, name: str) -> None:
        """Point this end at a different wire codec (RECONFIG path).
        Senders start packing with it on the next message; receivers
        need no call at all — they decode off the per-frame codec byte."""
        import dataclasses
        self.hop = dataclasses.replace(self.hop, codec=name)
        self._codec = None

    @abstractmethod
    def send(self, payload=None, kind: int = BATCH) -> TransferRecord | None:
        """Ship ``payload`` downstream; returns the TransferRecord when
        the sending end is the one that measures (emulated), else None."""

    @abstractmethod
    def recv(self, timeout: float | None = None) -> tuple[int, object]:
        """→ (kind, payload).  Raises TransportTimeout if nothing starts
        arriving within ``timeout``; TransportError if the peer is gone."""

    def split(self) -> "tuple[Channel, Channel]":
        """→ (sender end, receiver end) for placement in two hosts.
        In-process channels are their own other half."""
        return self, self

    def close(self) -> None:
        pass

    def reap(self) -> None:
        """Force-release OS resources a hop may have left behind in other
        processes.  No-op for in-process channels."""


class EmulatedChannel(Channel):
    """tc-netem analogue: sleeps RTT/2 + bytes/bw per message, samples
    ``LinkTrace`` hops at the pipeline clock, and hands tensors to the
    next thread through a bounded queue — by reference under the
    lightweight framing (codec round trip aside), through a full
    serialize/deserialize round trip under the rpc framing."""

    measured = False

    def __init__(self, hop: HopSpec, clock: Callable[[], float] | None = None):
        super().__init__(hop)
        if hop.link is None:
            raise ValueError("emulated transport needs a Link/LinkTrace per hop")
        self._clock = clock or (lambda: 0.0)
        self._rng = np.random.default_rng(hop.seed)
        self._q: queue.Queue = queue.Queue(maxsize=max(hop.depth, 1))

    def emulate(self, nbytes: int, raw_bytes: int = -1) -> float:
        """Inject the modeled wire delay for ``nbytes`` and record it."""
        t = self._clock()
        if isinstance(self.link, LinkTrace):
            dt = self.link.transfer_time(nbytes, t, rng=self._rng)
        else:
            dt = self.link.transfer_time(nbytes)
        time.sleep(dt)
        self.record(nbytes, dt, t, raw_bytes=raw_bytes)
        return dt

    def _roundtrip(self, payload: torch.Tensor):
        """Apply the hop codec's exact wire transform in place of real
        packing: pack on the payload's device, bring the packed bytes to
        the host, unpack on the device again.  The next stage computes on
        the degraded tensor, so emulated runs carry the codec's accuracy
        cost end to end.  → (wire bytes, raw bytes, decoded payload)."""
        raw = payload.numel() * payload.element_size()
        codec = self.codec
        if not (codec.code and payload.numel()
                and codec.supports(payload.dtype)):
            return raw, raw, payload
        buf = codec.encode(payload)
        return len(buf), raw, codec.decode(buf, tuple(payload.shape),
                                           payload.dtype, payload.device)

    def send(self, payload=None, kind: int = BATCH):
        if kind == BATCH:
            if self.hop.framing == "pickle":
                buf = _Serializer.dumps(payload)
                nbytes, raw, out = len(buf), len(buf), _Serializer.loads(
                    buf, payload.device)
            else:
                nbytes, raw, out = self._roundtrip(payload)
            dt = self.emulate(nbytes, raw_bytes=raw)
            self._q.put((kind, out))
            return TransferRecord(nbytes, dt, self._clock(), raw)
        if (kind == WARMUP and self.hop.framing != "pickle"
                and isinstance(payload, torch.Tensor)):
            # round-trip (no delay): warms the codec's kernels and hands
            # downstream a representative degraded exemplar
            _, _, payload = self._roundtrip(payload)
            self._q.put((kind, payload))
            return None
        if kind == PROBE:
            # header-only message: charges RTT/2 (+ per-message overhead),
            # recorded as an nbytes=0 observation; the token traverses
            # in-band so a streaming session can forward it hop by hop
            dt = self.emulate(0)
            self._q.put((PROBE, None))
            return TransferRecord(0, dt, self._clock())
        self._q.put((kind, payload))
        return None

    def recv(self, timeout: float | None = None):
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            raise TransportTimeout(f"hop {self.hop.index}: recv timed out") \
                from None


# --------------------------------------------------------------------------- #
# Replica lane groups (fan-out / fan-in).  Stage i with r replicas owns r
# parallel lanes; batches stripe round-robin by seq and every control
# token is broadcast to each lane, then collected once on the far side.
# --------------------------------------------------------------------------- #
class _FanBase:
    def __init__(self, lanes: "Sequence[Channel]"):
        if not lanes:
            raise ValueError("replica fan needs at least one lane")
        self.lanes = list(lanes)

    @property
    def hop(self) -> HopSpec:
        return self.lanes[0].hop

    def set_codec(self, name: str) -> None:
        for ch in self.lanes:
            ch.set_codec(name)


class FanOutChannel(_FanBase):
    """Dispatcher end of a replica lane group: batches (and probes —
    they ride the data stripe so both sides' round-robin counters stay
    aligned) go to lane ``seq % r``; every other kind is a control
    token, broadcast to all lanes in lane order."""

    def __init__(self, lanes: "Sequence[Channel]"):
        super().__init__(lanes)
        self._seq = 0

    def send(self, payload=None, kind: int = BATCH):
        if kind in (BATCH, PROBE):
            ch = self.lanes[self._seq % len(self.lanes)]
            self._seq += 1
            return ch.send(payload, kind)
        rec = None
        for ch in self.lanes:
            rec = ch.send(payload, kind)
        return rec


class FanInChannel(_FanBase):
    """Merge end of a replica lane group: data is consumed strictly in
    the dispatcher's stripe order (lane ``_next``), so ordering needs no
    seq numbers or reorder buffer.  A broadcast token is returned
    exactly once — after collecting every other lane's copy, so no lane
    can run a token ahead of the merge.  A ``TransportTimeout`` while
    collecting leaves the merge state intact: the next ``recv`` resumes
    the collection."""

    def __init__(self, lanes: "Sequence[Channel]"):
        super().__init__(lanes)
        self._next = 0                        # lane owing the next message
        self._tok: tuple | None = None        # pending broadcast token
        self._owed: list[int] = []            # lanes still owing their copy

    def recv(self, timeout: float | None = None):
        if self._tok is not None:
            return self._collect(timeout)
        kind, payload = self.lanes[self._next].recv(timeout)
        if kind in (BATCH, PROBE):
            self._next = (self._next + 1) % len(self.lanes)
            return kind, payload
        if kind == ERROR:
            return kind, payload              # fail fast, skip collection
        self._tok = (kind, payload)
        self._owed = [m for m in range(len(self.lanes)) if m != self._next]
        return self._collect(timeout)

    def _collect(self, timeout: float | None):
        kind, payload = self._tok
        while self._owed:
            k, p = self.lanes[self._owed[0]].recv(timeout)
            if k == ERROR:
                return k, p
            if k != kind:
                raise TransportError(
                    f"hop {self.hop.index}: replica fan-in protocol error "
                    f"— lane {self._owed[0]} sent kind {k} while collecting "
                    f"a broadcast token of kind {kind}")
            self._owed.pop(0)
        self._tok = None                      # _next unchanged: the stripe
        return kind, payload                  # resumes where it left off



# --------------------------------------------------------------------------- #
# Transport registry
# --------------------------------------------------------------------------- #
class Transport(ABC):
    """A way to realize hops: opens one ``Channel`` per ``HopSpec``.
    ``process_based`` says whether stages must live in worker processes
    (socket/shmem) or threads of this process (emulated)."""

    name: str = "?"
    process_based: bool = False

    @abstractmethod
    def open(self, hop: HopSpec) -> Channel:
        ...

    def open_fan(self, hop: HopSpec, n: int) -> list[Channel]:
        """``n`` independent lanes of the same hop — the channel group a
        replicated stage's fan-out/fan-in rides."""
        return [self.open(hop) for _ in range(n)]


class EmulatedTransport(Transport):
    name = "emulated"
    process_based = False

    def __init__(self, clock: Callable[[], float] | None = None):
        self._clock = clock

    def open(self, hop: HopSpec) -> Channel:
        return EmulatedChannel(hop, clock=self._clock)


def _not_ported(name: str) -> Callable[..., Transport]:
    def factory(**_kwargs) -> Transport:
        raise NotImplementedError(
            f"the {name!r} process transport is not ported yet (ROADMAP "
            "queue 1, item 6); use transport='emulated'")
    return factory


TRANSPORTS: dict[str, Callable[..., Transport]] = {
    "emulated": EmulatedTransport,
    "socket": _not_ported("socket"),
    "shmem": _not_ported("shmem"),
}


def register_transport(name: str, factory: Callable[..., Transport]) -> None:
    """Register a backend so scenarios/pipelines can name it."""
    TRANSPORTS[name] = factory


def get_transport(name: str, **kwargs) -> Transport:
    try:
        factory = TRANSPORTS[name]
    except KeyError:
        raise KeyError(f"unknown transport {name!r}; have "
                       f"{sorted(TRANSPORTS)}") from None
    return factory(**kwargs)
