"""Pluggable hop transports — the Transport/Channel API under EdgePipeline.

The paper's headline toolchain contribution is *dual communication
backends* whose overheads are measured, not modeled.  This module makes
the hop layer first-class so backend cost can be either:

  * **modeled** — ``emulated``: the tc-netem analogue (sleep RTT/2 +
    bytes/bw per message, ``LinkTrace`` sampling, jitter), with stages
    as threads in this process; or
  * **measured** — ``socket``: real TCP between spawned worker
    processes on loopback, with the reference's lightweight wire format
    (one packed ``struct`` header + the payload bytes, vectored
    ``sendmsg``, a reusable receive buffer); and ``shmem``: a doorbell
    ring in shared memory (packed metadata records in a control
    segment, a seq-counter publish, an eventfd or socketpair doorbell,
    payload slots that grow on demand).  On the CPU a shmem receive
    hands out a tensor view over the mapped slot; on the card the
    host-to-device copy reads straight from the slot.

Every hop is a ``Channel`` (``send(payload, kind)`` / ``recv()`` /
``close()`` / ``drain_records()``); a ``Transport`` opens one channel
per hop (``open(hop) -> Channel``) and ``Channel.split()`` yields the
(sender, receiver) ends to place in two worker hosts.  Channels record
every data transfer as a ``TransferRecord``: emulated channels record
the *injected* delay, socket channels the *wall-clock* cost seen by the
receiver (the send-start stamp rides in the frame header;
``time.perf_counter`` is the system-wide monotonic clock on Linux).

Payloads are tensors.  A hop's wire codec runs on the tensor's own
device: the sender packs with the CUDA kernels (``core/codecs.py``),
only packed bytes cross to the host and the wire, and the receiver
unpacks on its device — so a hop carries the codec's exact accuracy cost
and byte count end to end, and under ``socket`` and ``shmem`` each
stage's process launches its hops' kernels in its own CUDA context.

Fault injection (``runtime.faults``) rides the same surface: a hop
whose ``HopSpec.faults`` plan scripts frame-level faults is wrapped in a
``ChaosChannel`` on its send side, and the process engine's supervisor
executes the worker kills.

Messages are typed (``BATCH``/``WARMUP``/``PROBE``/``RECONFIG``/
``STATS``/``STOP``/``ERROR``/``CLOCK``/``CANCEL``) and control tokens
flow in-band through the stage chain, so they stay ordered with the
batches around them.  ``_worker_main`` is the per-stage process body:
recv from the ingress channel, execute the stage's block range, send
downstream, and flush stats, observations and kernel launch counts to
the orchestrator over a control pipe when a ``STATS`` token passes.

``record_trace`` turns drained records from a *measured* channel into a
replayable ``LinkTrace``, so real runs can seed the emulator.
"""
from __future__ import annotations

import os
import pickle
import queue
import select
import socket as socketlib
import struct
import threading
import time
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..core.codecs import codec_for_code, get_codec, host_bytes
from ..core.devices import (AnyLink, Link, LinkTrace, attribute_bandwidth,
                            fit_link_params)

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
    """Static description of one hop, consumed by ``Transport.open``."""

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
    send_timeout_s: float = 180.0   # bound on blocking sends
    # zero-copy receive lease: True for hops whose receiver consumes the
    # batch before its next recv() (the worker loop), False where the
    # payload outlives the call (the result drain).  A shmem receive on
    # the CPU hands out a tensor view over the slot, valid until the
    # next recv(); the socket receive and every receive onto the card
    # copy into tensor-owned memory, so there only the sanitizer's lease
    # canary reads it.
    zero_copy: bool = True
    # shmem busy-poll window (µs) before a waiter parks on the doorbell:
    # the default keeps idle waiters cheap, latency microbenches widen
    # it so back-to-back transfers stay on the spin path
    spin_us: float = 80.0
    # shmem doorbell flavor: "eventfd" (one kernel counter), "socketpair"
    # (the portable fallback), or "auto" (eventfd where the platform has
    # it)
    bell: str = "auto"
    # wire codec applied to float tensor payloads on this hop (a name
    # from ``core.codecs.CODECS``); the sender packs, the receiver
    # decodes off the per-frame codec byte, so a mid-stream RECONFIG
    # can switch codecs without coordinating the two ends
    codec: str = "none"
    # WAN-shape a *real* (socket) hop: the sender injects
    # ``pace_link.transfer_time(wire_bytes)`` before each data message,
    # so receiver-measured records carry the modeled WAN cost on top of
    # the true loopback and serialization cost
    pace_link: AnyLink | None = None
    # wrap the opened channel in runtime.sanitizer.SanitizedChannel: the
    # live protocol state machine is checked per message and violations
    # raise SanitizerError.  Engines set this from
    # EdgePipeline(sanitize=...) / the REPRO_SANITIZE env var.
    sanitize: bool = False
    # deterministic fault script for this pipeline (runtime.faults
    # .FaultPlan); engines wrap send ends whose hop has frame-level
    # events in runtime.faults.ChaosChannel and execute worker-kill
    # events from the supervisor.  None = no fault injection.
    faults: object | None = None


# --------------------------------------------------------------------------- #
# Wire framing
# --------------------------------------------------------------------------- #
# Wire-layout version: bump when _FHDR/_RREC change shape, and record
# the new format strings in the reference's analysis/manifest.py
# WIRE_LAYOUTS — PipeCheck (rule R5) fails the tree otherwise.
WIRE_LAYOUT_VERSION = 2   # v2: per-frame wire seq for duplicate suppression

# packed socket frame: ftype, kind, dtype code, ndim, codec code,
# meta_len, t_send, payload_len, wire seq, shape[8] — everything the
# common tensor case needs in one fixed-size read; codec code 0 =
# uncoded payload bytes.  The wire seq stamps every frame from a
# per-end counter so the receiver can drop an already-delivered BATCH.
# The shmem ring's metadata record (``_RREC``, with the slot index and
# the inline lengths) is declared beside it.  Both are the reference's
# layout v2, field for field, so a reference end and a port end share
# one connection or one ring.
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


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


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


def _raw_payload_bytes(ftype: int, code: int, shape, plen: int,
                       ccode: int) -> int:
    """Pre-codec tensor bytes for a received frame (== ``plen`` unless
    a codec packed the payload); feeds ``TransferRecord.raw_bytes``."""
    if ftype != _F_RAW or not ccode:
        return plen
    n = 1
    for s in shape:
        n *= int(s)
    return n * _dtype_of(code).itemsize


def ready_event(payload):
    """For a CUDA tensor: an event recorded on the current stream, after
    the work that produced ``payload`` (the sender's stage and hop round
    trip); else None."""
    if isinstance(payload, torch.Tensor) and payload.is_cuda:
        return torch.cuda.current_stream(payload.device).record_event()
    return None


def await_ready(payload, ready):
    """The receiving side of ``ready_event``: the current stream waits
    for the event, and the caching allocator learns that ``payload`` is
    in use there, so its memory is not handed to the sender's stream
    while this one may still read it."""
    if ready is not None:
        stream = torch.cuda.current_stream(payload.device)
        stream.wait_event(ready)
        payload.record_stream(stream)
    return payload


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

    def extend(self, records: Sequence[tuple]) -> None:
        for r in records:
            self.record(*r)

    def drain_observations(self) -> list[TransferRecord]:
        with self._lock:
            obs, self.observations = self.observations, []
        return obs

    # the Channel-API name for the same drain
    drain_records = drain_observations

    # channels cross process boundaries at spawn; runtime state stays home
    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_lock", None)
        state["observations"] = []
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()
        self.observations = []


class HopMeter(HopObservations):
    """Orchestrator-side mirror of a process hop: harvested records land
    here so ``pipe.nets`` has one observation surface per hop no matter
    where the channel endpoints live."""


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

    def now(self) -> float:
        return time.perf_counter() - self.epoch

    @property
    def codec(self):
        """The hop's wire codec object (resolved lazily, so a channel
        pickles without it and the worker process resolves it — and the
        CUDA library behind it — on its own)."""
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

    def _send_codec(self, kind: int):
        """Codec to apply for a message of ``kind`` — data and warmup
        exemplars pack; control tokens always travel uncoded."""
        return self.codec if kind in (BATCH, WARMUP) else None

    def _pace(self, nbytes: int, kind: int) -> None:
        """Inject the hop's modeled WAN serialization delay (socket
        duress studies).  Runs after framing — the delay scales with
        *wire* bytes, which is exactly the codec's win — and after the
        send stamp, so receiver-measured elapsed includes it."""
        link = self.hop.pace_link
        if link is None or kind not in (BATCH, WARMUP, PROBE):
            return
        if isinstance(link, LinkTrace):
            dt = link.transfer_time(nbytes, self.now())
        else:
            dt = link.transfer_time(nbytes)
        time.sleep(dt)

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

    def _put(self, kind: int, payload) -> None:
        self._q.put((kind, payload, ready_event(payload)))

    def send(self, payload=None, kind: int = BATCH):
        """The round trip runs on the sender's current stream; a CUDA
        payload travels with an event recorded after it (``recv`` makes
        the receiver's stream wait for it)."""
        if kind == BATCH:
            if payload is None:
                # a flush-canceled batch's marker: no payload bytes, as
                # over the process transports (an empty frame)
                nbytes, raw, out = 0, 0, None
            elif self.hop.framing == "pickle":
                buf = _Serializer.dumps(payload)
                nbytes, raw, out = len(buf), len(buf), _Serializer.loads(
                    buf, payload.device)
            else:
                nbytes, raw, out = self._roundtrip(payload)
            dt = self.emulate(nbytes, raw_bytes=raw)
            self._put(kind, out)
            return TransferRecord(nbytes, dt, self._clock(), raw)
        if (kind == WARMUP and self.hop.framing != "pickle"
                and isinstance(payload, torch.Tensor)):
            # round-trip (no delay): warms the codec's kernels and hands
            # downstream a representative degraded exemplar
            _, _, payload = self._roundtrip(payload)
            self._put(kind, payload)
            return None
        if kind == PROBE:
            # header-only message: charges RTT/2 (+ per-message overhead),
            # recorded as an nbytes=0 observation; the token traverses
            # in-band so a streaming session can forward it hop by hop
            dt = self.emulate(0)
            self._put(PROBE, None)
            return TransferRecord(0, dt, self._clock())
        self._put(kind, payload)
        return None

    def recv(self, timeout: float | None = None):
        try:
            kind, payload, ready = self._q.get(timeout=timeout)
        except queue.Empty:
            raise TransportTimeout(f"hop {self.hop.index}: recv timed out") \
                from None
        return kind, await_ready(payload, ready)


class SocketChannel(Channel):
    """Real TCP on loopback with the reference's lightweight wire
    format: one fixed ``struct``-packed header + the payload bytes
    (pickled meta only on the escape path), vectored header+payload
    writes via ``sendmsg``, and a reusable receive buffer.  The
    receiving end measures each data transfer as wall-clock from the
    sender's send-start stamp through full deserialization, the unpack
    on its device included — serialization cost is *in* the number.

    Received tensors land on ``device`` (the receiving stage's); they
    never alias the receive buffer.  ``sock``/``_pair`` take an
    existing connection (one socket for both directions, or a (tx, rx)
    pair), so a reference end and a port end can share one."""

    measured = True

    def __init__(self, hop: HopSpec, sock: socketlib.socket | None = None,
                 _pair: tuple | None = None, device=None):
        super().__init__(hop)
        self.device = torch.device("cpu" if device is None else device)
        if sock is not None:
            self._tx = self._rx = sock
        elif _pair is not None:
            self._tx, self._rx = _pair
        else:
            lst = socketlib.socket()
            lst.bind(("127.0.0.1", 0))
            lst.listen(1)
            tx = socketlib.create_connection(lst.getsockname())
            rx, _ = lst.accept()
            lst.close()
            self._tx, self._rx = tx, rx
        for s in {self._tx, self._rx} - {None}:
            s.setsockopt(socketlib.IPPROTO_TCP, socketlib.TCP_NODELAY, 1)
        self._init_bufs()
        self._tx_seq = 0                      # frames sent from this end
        self._rx_seen = -1                    # highest wire seq delivered

    def _init_bufs(self) -> None:
        self._hbuf = bytearray(_FHDR.size)
        self._rbuf = bytearray(1 << 16)       # reusable payload buffer

    def __setstate__(self, state):
        super().__setstate__(state)
        self._init_bufs()

    def __getstate__(self):
        state = super().__getstate__()
        state.pop("_hbuf", None)
        state.pop("_rbuf", None)
        state["_codec"] = None                # resolved again over there
        return state

    def split(self):
        tx = SocketChannel(self.hop, _pair=(self._tx, None),
                           device=self.device)
        rx = SocketChannel(self.hop, _pair=(None, self._rx),
                           device=self.device)
        return tx, rx

    def send(self, payload=None, kind: int = BATCH, _dup: bool = False):
        if self._tx is None:
            raise TransportError(f"hop {self.hop.index}: receive-only end")
        t0 = time.perf_counter()              # serialization counts
        ftype, code, shape, data, meta, ccode = _frame(
            payload, self.hop.framing, self._send_codec(kind))
        if _dup:                              # chaos re-send: same wire seq
            seq = self._tx_seq - 1
        else:
            seq = self._tx_seq
            self._tx_seq += 1
        hdr = _FHDR.pack(ftype, kind, code, len(shape), ccode, len(meta),
                         t0, len(data), seq, *shape,
                         *((0,) * (_MAX_NDIM - len(shape))))
        self._pace(len(data) + len(meta), kind)
        bufs = [memoryview(hdr)]
        if meta:
            bufs.append(memoryview(meta))
        if len(data):
            bufs.append(memoryview(data))
        # The bounded send is the liveness half of the wire protocol: a
        # peer that stops draining surfaces as TransportTimeout once zero
        # bytes of this frame moved for send_timeout_s (nothing committed
        # — retryable, mirroring recv's first-byte rule), and as
        # TransportError if the stall hits mid-frame.
        sent_any = False
        self._tx.settimeout(self.hop.send_timeout_s)
        try:
            while bufs:
                try:
                    n = self._tx.sendmsg(bufs)  # vectored: no concat copy
                except socketlib.timeout:
                    if not sent_any:
                        raise TransportTimeout(
                            f"hop {self.hop.index}: send timed out after "
                            f"{self.hop.send_timeout_s:.0f}s "
                            f"(peer not draining)") from None
                    raise TransportError(
                        f"hop {self.hop.index}: send stalled mid-frame for "
                        f"{self.hop.send_timeout_s:.0f}s") from None
                except OSError as e:
                    raise TransportError(
                        f"hop {self.hop.index}: peer gone ({e})") from e
                if n:
                    sent_any = True
                while bufs and n >= len(bufs[0]):
                    n -= len(bufs.pop(0))
                if bufs and n:
                    bufs[0] = bufs[0][n:]
        finally:
            if self._tx is not None:
                try:
                    self._tx.settimeout(None)
                except OSError:
                    pass
        return None

    def _read_into(self, view: memoryview, timeout: float | None) -> None:
        """Fill ``view`` exactly; the timeout bounds only the wait for
        the first byte (mid-message reads keep going)."""
        got, n = 0, len(view)
        self._rx.settimeout(timeout)
        while got < n:
            try:
                k = self._rx.recv_into(view[got:])
            except socketlib.timeout:
                if not got:
                    raise TransportTimeout(
                        f"hop {self.hop.index}: recv timed out") from None
                continue                      # mid-message: keep reading
            except OSError as e:
                raise TransportError(
                    f"hop {self.hop.index}: peer gone ({e})") from e
            if not k:
                raise TransportError(f"hop {self.hop.index}: peer closed")
            got += k
            if got < n and self._rx.gettimeout() is not None:
                self._rx.settimeout(None)     # header started arriving

    def recv(self, timeout: float | None = None):
        if self._rx is None:
            raise TransportError(f"hop {self.hop.index}: send-only end")
        while True:
            self._read_into(memoryview(self._hbuf), timeout)
            (ftype, kind, code, ndim, ccode, mlen, t0, plen, seq,
             *shape) = _FHDR.unpack(self._hbuf)
            meta = b""
            if mlen:
                meta = bytearray(mlen)
                self._read_into(memoryview(meta), None)
            if plen > len(self._rbuf):
                self._rbuf = bytearray(_next_pow2(plen))
            view = memoryview(self._rbuf)[:plen]
            if plen:
                self._read_into(view, None)
            if kind == BATCH and seq <= self._rx_seen:
                continue                      # duplicate frame: drop it
            if seq > self._rx_seen + 1:
                raise TransportError(
                    f"hop {self.hop.index}: wire gap — frame(s) lost "
                    f"(seq {seq} after {self._rx_seen})")
            if not 0 <= kind <= CANCEL:
                raise TransportError(
                    f"hop {self.hop.index}: corrupt frame header "
                    f"(kind=0x{kind:02x})")
            self._rx_seen = seq
            break
        payload = _unframe(ftype, code, tuple(shape[:ndim]), view, meta,
                           ccode, self.device)
        if isinstance(payload, torch.Tensor) and payload.is_cuda:
            # the unpack is part of the transfer: measure to its end
            torch.cuda.current_stream(payload.device).synchronize()
        if kind in (BATCH, PROBE) and self.hop.scenario_hop:
            self.record(plen, time.perf_counter() - t0, t0 - self.epoch,
                        raw_bytes=_raw_payload_bytes(
                            ftype, code, shape[:ndim], plen, ccode))
        return kind, payload

    def close(self) -> None:
        for s in (self._tx, self._rx):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self._tx = self._rx = None


# --------------------------------------------------------------------------- #
# Doorbells — the park/wake primitive under the shmem ring.
#
# A doorbell is rung after a counter publish and parked on by the other
# end; wakeup state persists (ring-before-park cannot lose the wake):
# the eventfd counter accumulates until read, and socketpair bytes sit in
# the kernel buffer until recv'd.  Any number of processes may ring the
# same bell (eventfd adds are atomic; concurrent socket sends coalesce).
# --------------------------------------------------------------------------- #
def _rebuild_eventfd_bell(dupfd):
    return _EventFdBell(fd=dupfd.detach())


class _EventFdBell:
    """Futex-style doorbell on a Linux ``eventfd``: ring = one atomic
    8-byte counter add, wait = poll + drain.  Both ends are the same
    kernel object; copies dup the fd across process boundaries
    (``multiprocessing.reduction.DupFd``)."""

    def __init__(self, fd: int | None = None):
        self._fd = os.eventfd(0, os.EFD_NONBLOCK) if fd is None else fd

    def ring(self) -> None:
        try:
            os.eventfd_write(self._fd, 1)
        except (BlockingIOError, InterruptedError):
            pass                              # counter saturated: wake pending

    def wait(self, timeout_s: float) -> None:
        try:
            r, _, _ = select.select([self._fd], [], [], timeout_s)
        except ValueError as e:               # fd closed under us
            raise OSError(str(e)) from None
        if r:
            try:
                os.eventfd_read(self._fd)     # drain coalesced rings
            except (BlockingIOError, InterruptedError):
                pass

    def close(self) -> None:
        fd, self._fd = self._fd, -1
        if fd >= 0:
            try:
                os.close(fd)
            except OSError:
                pass

    def dup(self) -> "_EventFdBell":
        return _EventFdBell(fd=os.dup(self._fd))

    def __reduce__(self):
        from multiprocessing.reduction import DupFd
        if self._fd < 0:
            raise TransportError("cannot ship a closed doorbell")
        return (_rebuild_eventfd_bell, (DupFd(self._fd),))

    @classmethod
    def pair(cls) -> "tuple[_EventFdBell, _EventFdBell]":
        # one eventfd counter, one descriptor per end: closing one end
        # (the parent's copy of a shipped end) must not silence the other
        a = cls()
        return a, a.dup()


class _SocketPairBell:
    """One end of a socketpair doorbell — the portable fallback.
    Sockets cross process boundaries via multiprocessing's standard
    socket reduction."""

    def __init__(self, sock: socketlib.socket):
        self._s = sock

    def ring(self) -> None:
        try:
            self._s.send(b"\0")
        except (BlockingIOError, OSError):
            pass                              # buffered bytes already pending

    def wait(self, timeout_s: float) -> None:
        try:
            self._s.settimeout(timeout_s)
            self._s.recv(4096)                # drain coalesced rings too
        except (socketlib.timeout, BlockingIOError):
            pass

    def close(self) -> None:
        try:
            self._s.close()
        except OSError:
            pass

    def dup(self) -> "_SocketPairBell":
        s = self._s.dup()
        s.settimeout(self._s.gettimeout())
        return _SocketPairBell(s)

    @classmethod
    def pair(cls) -> "tuple[_SocketPairBell, _SocketPairBell]":
        ring_end, wait_end = socketlib.socketpair()
        ring_end.setblocking(False)
        return cls(ring_end), cls(wait_end)


def _bell_pair(flavor: str):
    """→ (ring end, wait end) for a HopSpec ``bell`` declaration."""
    if flavor == "auto":
        flavor = "eventfd" if hasattr(os, "eventfd") else "socketpair"
    if flavor == "eventfd":
        return _EventFdBell.pair()
    if flavor == "socketpair":
        return _SocketPairBell.pair()
    raise ValueError(f"unknown doorbell flavor {flavor!r}; "
                     f"have 'eventfd', 'socketpair', 'auto'")


def _dup_bell(bell):
    """This package's doorbell over another end's descriptor (eventfd or
    socketpair, whichever package made it), or None."""
    if bell is None:
        return None
    fd = getattr(bell, "_fd", None)
    if fd is not None:
        return _EventFdBell(fd=os.dup(fd))
    return _SocketPairBell(bell._s).dup()


# shmem control ring: fixed-stride metadata records packed directly into
# the shared control segment — ftype, kind, dtype code, ndim, codec
# code, slot index (-1 = inline/none), meta_len, inline_len, t_send,
# nbytes, wire seq, shape[8]; the rest of the stride is the inline area
# (pickled meta + small payloads ride in the record itself).  The wire
# seq mirrors the socket header's: per-end send counter, receiver-side
# BATCH dedup.
_STRIDE = 256
_INLINE = _STRIDE - _RREC.size
_BELL_CHUNK_S = 0.05    # re-check cadence while parked on the doorbell


def _ctl_layout(depth: int) -> tuple[int, int, int, int, int, int, int]:
    """Single-lane control layout for ``depth`` in-flight messages →
    (n_slots, cap, fcap, tab_off, free_off, rec_off, size); offsets are
    lane-relative so several lanes can pack into one segment."""
    n_slots = depth + 1                       # +1 backs the zero-copy lease
    cap = _next_pow2(depth + 8)               # data ring: depth + control slack
    fcap = _next_pow2(n_slots)
    tab_off = 256
    free_off = tab_off + 32 * n_slots
    rec_off = -(-(free_off + 8 * fcap) // 64) * 64
    return (n_slots, cap, fcap, tab_off, free_off, rec_off,
            rec_off + _STRIDE * cap)


def _lane_stride(depth: int) -> int:
    """Page-aligned per-lane footprint inside a multi-producer segment."""
    return -(-_ctl_layout(depth)[-1] // 4096) * 4096


# shmem mappings that could not unmap at close() because a tensor view
# handed out by recv() still exports their buffer — kept alive so
# SharedMemory.__del__ never runs; the OS reclaims the pages at exit
_PINNED_MAPPINGS: list = []


def _slot_tensor(view: memoryview, code: int, shape: tuple) -> torch.Tensor:
    """A zero-copy CPU tensor over a received slot: a view (its ``_base``
    the uint8 tensor over the mapping), so the sanitizer leases it."""
    flat = torch.frombuffer(view, dtype=torch.uint8)
    return flat.view(_dtype_of(code)).view(shape)


def _close_mapping(shm) -> None:
    """Unmap a segment, parking it where a tensor view still pins it."""
    try:
        shm.close()
    except BufferError:
        _PINNED_MAPPINGS.append(shm)
    except Exception:
        pass


class ShmemChannel(Channel):
    """Shared-memory ring between processes (the reference's layout, so a
    reference end and a port end share one ring):

      * a single-producer/single-consumer **data ring** of packed
        ``_RREC`` metadata records, published by bumping a seq counter
        (write the record, then the counter);
      * a **free ring** of slot indices flowing back from receiver to
        sender (``depth``-bounded backpressure, slot reuse);
      * a **slot name table** so payload slots can grow on demand (the
        sender replaces a too-small slot and republishes its name).

    Payload bytes land in per-slot ``SharedMemory`` segments (small
    payloads inline in the record itself).  The sender packs on the
    tensor's device and copies the host bytes into the slot once.  The
    receiver decodes onto ``device``: on the CPU an uncoded payload is a
    zero-copy tensor view over the mapped slot, leased — excluded from
    the free ring — until the *next* ``recv`` (one extra slot backs the
    lease); on the card the host-to-device copy reads straight from the
    slot, and the slot is released once that synchronous copy returns.
    Waiters spin for ``hop.spin_us`` and then park on a doorbell,
    re-checking the counters every ``_BELL_CHUNK_S``."""

    measured = True

    def __init__(self, hop: HopSpec, _shared: tuple | None = None,
                 device=None):
        from multiprocessing import shared_memory
        super().__init__(hop)
        self.device = torch.device("cpu" if device is None else device)
        if _shared is None:
            # solo lane: own control segment starting at offset 0
            self._base, self._n_lanes, self._lane_size = 0, 1, 0
            self._layout(max(hop.depth, 1))
            self._lane_size = self._ctl_size
            self._ctl = shared_memory.SharedMemory(create=True,
                                                   size=self._ctl_size)
        else:
            # one lane of a multi-producer segment (ShmemTransport.open_fan)
            self._ctl, self._base, self._n_lanes, self._lane_size = _shared
            self._layout(max(hop.depth, 1))
        self._ctl_name = self._ctl.name
        self._ctl_owner = True                # double unlink is tolerated
        # doorbells: (data send, data recv) + (free send, free recv)
        self._bell_ds, self._bell_dr = _bell_pair(hop.bell)
        self._bell_fs, self._bell_fr = _bell_pair(hop.bell)
        self._pool: dict = {}                 # sender: slot idx -> SharedMemory
        self._attached: dict = {}             # receiver: idx -> (name, shm)
        self._lease: int | None = None        # slot behind the last recv view
        self._role = "both"
        self._tx_seq = 0                      # frames sent from this end
        self._rx_seen = -1                    # highest wire seq delivered
        for i in range(self._n_slots):        # all slots start free (no
            self._push_free(i, ring=False)    # segment until first use)

    @classmethod
    def adopt(cls, end, hop: HopSpec, device=None) -> "ShmemChannel":
        """A port end standing in for ``end``, an end of a ring made by
        either package: the same control segment (attached by name), the
        same doorbells (descriptors duplicated) and the same wire
        counters, with ``hop`` this end's description.  ``end`` keeps its
        own descriptors and close duty."""
        from multiprocessing import shared_memory
        self = cls.__new__(cls)
        Channel.__init__(self, hop)
        self.device = torch.device("cpu" if device is None else device)
        self._base, self._n_lanes = end._base, end._n_lanes
        self._lane_size = end._lane_size
        self._layout(end._depth)
        self._ctl_name = end._ctl_name
        self._ctl = shared_memory.SharedMemory(name=end._ctl_name)
        self._ctl_owner = False
        self._bell_ds, self._bell_dr = (_dup_bell(end._bell_ds),
                                        _dup_bell(end._bell_dr))
        self._bell_fs, self._bell_fr = (_dup_bell(end._bell_fs),
                                        _dup_bell(end._bell_fr))
        self._pool, self._attached, self._lease = {}, {}, None
        self._role = end._role
        self._tx_seq, self._rx_seen = end._tx_seq, end._rx_seen
        return self

    def _layout(self, depth: int) -> None:
        self._depth = depth
        self._spin_s = self.hop.spin_us * 1e-6
        base = getattr(self, "_base", 0)
        (self._n_slots, self._cap, self._fcap,
         tab_off, free_off, rec_off, self._ctl_size) = _ctl_layout(depth)
        # absolute offsets for this lane (counters keep their own cache
        # lines); self._ctl_size stays the lane-relative footprint
        self._DH, self._DT = base + 0, base + 64
        self._FH, self._FT = base + 128, base + 192
        self._tab_off = base + tab_off
        self._free_off = base + free_off
        self._rec_off = base + rec_off

    # -- counters + doorbells ------------------------------------------- #
    def _ld(self, off: int) -> int:
        return struct.unpack_from("<Q", self._ctl.buf, off)[0]

    def _st(self, off: int, v: int) -> None:
        struct.pack_into("<Q", self._ctl.buf, off, v)

    def _wait(self, ready, bell, timeout: float | None, what: str) -> None:
        """Spin briefly, then park on the doorbell until ``ready()``;
        ``TransportTimeout`` once ``timeout`` passes (never unbounded
        while parked: the doorbell wait re-checks every chunk)."""
        if ready():
            return
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        spin_until = time.perf_counter() + self._spin_s
        while True:
            if ready():
                return
            now = time.perf_counter()
            if now < spin_until:
                continue
            if deadline is not None and now >= deadline:
                raise TransportTimeout(f"hop {self.hop.index}: {what}")
            chunk = (_BELL_CHUNK_S if deadline is None
                     else min(deadline - now, _BELL_CHUNK_S))
            try:
                bell.wait(chunk)              # drains coalesced rings too
            except OSError as e:
                raise TransportError(
                    f"hop {self.hop.index}: doorbell gone ({e})") from e

    # -- free ring (receiver -> sender) --------------------------------- #
    def _push_free(self, idx: int, ring: bool = True) -> None:
        fh = self._ld(self._FH)
        struct.pack_into("<Q", self._ctl.buf,
                         self._free_off + (fh % self._fcap) * 8, idx)
        self._st(self._FH, fh + 1)
        if ring:
            self._bell_fs.ring()

    def _pop_free(self) -> int:
        def ready():
            avail = self._ld(self._FH) - self._ld(self._FT)
            return 0 < avail <= self._n_slots  # clamp guards a torn read
        self._wait(ready, self._bell_fr, self.hop.send_timeout_s,
                   f"no free shmem slot for {self.hop.send_timeout_s:.0f}s "
                   f"(receiver not draining)")
        ft = self._ld(self._FT)
        idx = struct.unpack_from(
            "<Q", self._ctl.buf, self._free_off + (ft % self._fcap) * 8)[0]
        self._st(self._FT, ft + 1)
        return int(idx)

    # -- payload slots --------------------------------------------------- #
    def _tab_name(self, idx: int) -> str:
        off = self._tab_off + 32 * idx
        return bytes(self._ctl.buf[off:off + 32]).rstrip(b"\0").decode()

    def _get_slot(self, nbytes: int) -> tuple[int, memoryview]:
        from multiprocessing import shared_memory
        idx = self._pop_free()
        shm = self._pool.get(idx)
        if shm is None and (name := self._tab_name(idx)):
            # a pre-split sender populated this slot; adopt it
            try:
                shm = self._pool[idx] = shared_memory.SharedMemory(name=name)
            except FileNotFoundError:
                shm = None
        if shm is None or shm.size < nbytes:
            if shm is not None:               # outgrown: replace the slot
                try:
                    shm.unlink()
                except FileNotFoundError:
                    pass
                _close_mapping(shm)
            shm = shared_memory.SharedMemory(
                create=True, size=_next_pow2(max(nbytes, 1 << 16)))
            self._pool[idx] = shm
            off = self._tab_off + 32 * idx    # republish before the record
            name = shm.name.encode()
            self._ctl.buf[off:off + 32] = name + b"\0" * (32 - len(name))
        return idx, shm.buf

    def _slot_view(self, idx: int, nbytes: int) -> memoryview:
        from multiprocessing import shared_memory
        name = self._tab_name(idx)
        cached = self._attached.get(idx)
        if cached is None or cached[0] != name:
            if cached is not None:            # stale: the sender grew the slot
                _close_mapping(cached[1])
            try:
                shm = shared_memory.SharedMemory(name=name)
            except FileNotFoundError:
                raise TransportError(
                    f"hop {self.hop.index}: shmem slot {name!r} gone "
                    f"(peer closed)") from None
            cached = self._attached[idx] = (name, shm)
        return cached[1].buf[:nbytes]

    # -- lifecycle across processes / split ------------------------------ #
    def __getstate__(self):
        state = super().__getstate__()
        state.pop("_ctl", None)
        state["_pool"] = {}
        state["_attached"] = {}
        state["_lease"] = None
        state["_codec"] = None                # resolved again over there
        # the shipped copy inherits unlink duty for the control segment;
        # this (parent) copy relinquishes it, so the parent closing its
        # handles on shipped ends cannot yank the segment from under a
        # worker that has not attached yet (double unlink is tolerated)
        state["_ctl_owner"] = True
        self._ctl_owner = False
        return state

    def __setstate__(self, state):
        from multiprocessing import shared_memory
        super().__setstate__(state)
        self._layout(self._depth)
        self._ctl = shared_memory.SharedMemory(name=self._ctl_name)

    def split(self):
        import copy
        tx, rx = copy.copy(self), copy.copy(self)
        tx.__setstate__(tx.__getstate__())    # fresh caches/locks per end
        rx.__setstate__(rx.__getstate__())
        tx._role, rx._role = "send", "recv"
        # each end keeps only its own doorbell fds, so closing one end
        # (the parent's copy of a shipped end) cannot silence the other
        tx._bell_dr = tx._bell_fs = None
        rx._bell_ds = rx._bell_fr = None
        return tx, rx

    # -- hot path --------------------------------------------------------- #
    def send(self, payload=None, kind: int = BATCH, _dup: bool = False):
        t0 = time.perf_counter()              # serialization + copy count
        ftype, code, shape, data, meta, ccode = _frame(
            payload, self.hop.framing, self._send_codec(kind))
        nbytes, mlen = len(data), len(meta)
        self._pace(nbytes + mlen, kind)
        if mlen > _INLINE:
            raise TransportError(
                f"hop {self.hop.index}: {mlen} B of pickled metadata "
                f"exceeds the {_INLINE} B inline area")
        # Reserve ring space *before* claiming a payload slot, so a
        # TransportTimeout here (the retryable liveness signal — receiver
        # not draining) leaves no sender state mutated.  0 <= used: a
        # torn read of the receiver-written tail counter must block the
        # publish, never overwrite an unconsumed record.
        self._wait(lambda: 0 <= self._ld(self._DH) - self._ld(self._DT)
                   < self._cap,
                   self._bell_fr, self.hop.send_timeout_s,
                   f"control ring full for {self.hop.send_timeout_s:.0f}s "
                   f"(receiver not draining)")
        slot, ilen = -1, 0
        if nbytes:
            if mlen + nbytes <= _INLINE:
                ilen = nbytes                 # small payload: ride inline
            else:
                slot, buf = self._get_slot(nbytes)
                buf[:nbytes] = memoryview(data)
        if _dup:                              # chaos re-send: same wire seq
            seq = self._tx_seq - 1
        else:
            seq = self._tx_seq
            self._tx_seq += 1
        head = self._ld(self._DH)
        base = self._rec_off + (head % self._cap) * _STRIDE
        _RREC.pack_into(self._ctl.buf, base, ftype, kind, code, len(shape),
                        ccode, slot, mlen, ilen, t0, nbytes, seq,
                        *shape, *((0,) * (_MAX_NDIM - len(shape))))
        inl = base + _RREC.size
        if mlen:
            self._ctl.buf[inl:inl + mlen] = meta
        if ilen:
            self._ctl.buf[inl + mlen:inl + mlen + ilen] = memoryview(data)
        self._st(self._DH, head + 1)          # publish, then ring
        self._bell_ds.ring()
        return None

    def _consume(self, tail: int) -> None:
        """Retire the record at ``tail``, waking a ring-full sender."""
        was_full = self._ld(self._DH) - tail >= self._cap
        self._st(self._DT, tail + 1)
        if was_full:
            self._bell_fs.ring()

    def recv(self, timeout: float | None = None):
        if self._lease is not None:           # the handed-out view's slot
            self._push_free(self._lease)      # is only reclaimed now
            self._lease = None

        def ready():
            avail = self._ld(self._DH) - self._ld(self._DT)
            return 0 < avail <= self._cap     # clamp guards a torn read
        while True:
            self._wait(ready, self._bell_dr, timeout, "recv timed out")
            tail = self._ld(self._DT)
            base = self._rec_off + (tail % self._cap) * _STRIDE
            (ftype, kind, code, ndim, ccode, slot, mlen, ilen, t0, nbytes,
             seq, *shape) = _RREC.unpack_from(self._ctl.buf, base)
            if kind == BATCH and seq <= self._rx_seen:
                # duplicate frame: recycle its slot, consume the record
                if slot >= 0:
                    self._push_free(slot)
                self._consume(tail)
                continue
            if seq > self._rx_seen + 1:
                raise TransportError(
                    f"hop {self.hop.index}: wire gap — frame(s) lost "
                    f"(seq {seq} after {self._rx_seen})")
            if not 0 <= kind <= CANCEL:
                raise TransportError(
                    f"hop {self.hop.index}: corrupt frame header "
                    f"(kind=0x{kind:02x})")
            break
        self._rx_seen = seq
        shape = tuple(shape[:ndim])
        inl = base + _RREC.size
        meta = bytes(self._ctl.buf[inl:inl + mlen]) if mlen else b""
        if slot >= 0:
            view = self._slot_view(slot, nbytes)
            if (ftype == _F_RAW and not ccode and self.hop.zero_copy
                    and self.device.type == "cpu"):
                payload = _slot_tensor(view, code, shape)
                self._lease = slot            # valid until the next recv
            else:
                # decoded onto the card, or copied into tensor-owned
                # memory: the slot is free again once _unframe returns
                payload = _unframe(ftype, code, shape, view, meta, ccode,
                                   self.device)
                del view
                self._push_free(slot)
        else:
            # inline payloads are copied out — the ring record is reused
            # after one wraparound, sooner than any lease could track
            buf = bytes(self._ctl.buf[inl + mlen:inl + mlen + ilen])
            payload = _unframe(ftype, code, shape, buf, meta, ccode,
                               self.device)
        self._consume(tail)
        if isinstance(payload, torch.Tensor) and payload.is_cuda:
            # the unpack is part of the transfer: measure to its end
            torch.cuda.current_stream(payload.device).synchronize()
        if kind in (BATCH, PROBE) and self.hop.scenario_hop:
            self.record(nbytes, time.perf_counter() - t0, t0 - self.epoch,
                        raw_bytes=_raw_payload_bytes(
                            ftype, code, shape, nbytes, ccode))
        return kind, payload

    def close(self) -> None:
        if self._lease is not None:
            try:
                self._push_free(self._lease)
            except Exception:
                pass
            self._lease = None
        for _, shm in self._attached.values():
            _close_mapping(shm)
        for shm in self._pool.values():
            try:
                shm.unlink()                  # before close: a pinned
            except Exception:                 # mapping must not skip it
                pass
            _close_mapping(shm)
        self._pool.clear()
        self._attached.clear()
        ctl = getattr(self, "_ctl", None)
        if ctl is not None:
            _close_mapping(ctl)
            if self._ctl_owner:
                try:
                    ctl.unlink()
                except Exception:
                    pass
            self._ctl = None
        for bell in (self._bell_ds, self._bell_dr,
                     self._bell_fs, self._bell_fr):
            if bell is not None:
                bell.close()

    def segment_names(self) -> list[str]:
        """The control segment's name and every payload slot named in
        the tables of all its lanes (empty once reaped)."""
        from multiprocessing import shared_memory
        try:
            ctl = shared_memory.SharedMemory(name=self._ctl_name)
        except (FileNotFoundError, OSError):
            return []
        try:
            names = [self._ctl_name]
            for lane in range(self._n_lanes):
                tab = lane * self._lane_size + (self._tab_off - self._base)
                for i in range(self._n_slots):
                    off = tab + 32 * i
                    name = bytes(ctl.buf[off:off + 32]).rstrip(b"\0").decode()
                    if name:
                        names.append(name)
            return names
        finally:
            ctl.close()

    def reap(self) -> None:
        """Unlink the control segment and every slot named in its table
        regardless of ownership or close() state — a SIGKILL'd worker
        never ran close(), and its segments must not outlive the
        pipeline.  Reattaches by name, so it works on any end."""
        from multiprocessing import shared_memory
        # every lane of a shared fan segment names slots in its own table;
        # whichever lane reaps first sweeps them all
        for name in self.segment_names()[::-1]:   # slots, then the ring
            try:
                shm = shared_memory.SharedMemory(name=name)
                shm.close()
                shm.unlink()
            except Exception:
                pass


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

    @property
    def epoch(self) -> float:
        return self.lanes[0].epoch

    @epoch.setter
    def epoch(self, value: float) -> None:
        for ch in self.lanes:
            ch.epoch = value

    def set_codec(self, name: str) -> None:
        for ch in self.lanes:
            ch.set_codec(name)

    def drain_records(self):
        records = []
        for ch in self.lanes:
            records.extend(ch.drain_records())
        return records

    def close(self) -> None:
        for ch in self.lanes:
            ch.close()

    def reap(self) -> None:
        for ch in self.lanes:
            ch.reap()


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

    def evict_lane(self, m: int) -> None:
        """Drop a dead lane from the stripe map; later batches stripe
        round-robin over the survivors, restarting at lane 0.  Only
        valid at quiescence (no data in flight on the group) and must be
        mirrored by ``FanInChannel.evict_lane`` on the same lane so both
        cursors stay aligned."""
        if len(self.lanes) <= 1:
            raise ValueError("cannot evict the last lane of a replica fan")
        if not 0 <= m < len(self.lanes):
            raise IndexError(f"lane {m} of {len(self.lanes)}")
        del self.lanes[m]
        self._seq = 0


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

    def evict_lane(self, m: int) -> None:
        """Drop a dead lane from the merge, mirroring
        ``FanOutChannel.evict_lane``: the stripe cursor restarts at lane
        0 and any pending-token bookkeeping forgets the evicted lane.
        Only valid at quiescence on the group."""
        if len(self.lanes) <= 1:
            raise ValueError("cannot evict the last lane of a replica fan")
        if not 0 <= m < len(self.lanes):
            raise IndexError(f"lane {m} of {len(self.lanes)}")
        del self.lanes[m]
        self._owed = [x - 1 if x > m else x for x in self._owed if x != m]
        self._next = 0


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


class SocketTransport(Transport):
    """Real loopback TCP; receiving ends decode onto ``device`` (the
    CPU unless given)."""

    name = "socket"
    process_based = True

    def __init__(self, device=None):
        self._device = device

    def open(self, hop: HopSpec) -> Channel:
        return SocketChannel(hop, device=self._device)


class ShmemTransport(Transport):
    """The shared-memory ring; receiving ends decode onto ``device``
    (the CPU unless given)."""

    name = "shmem"
    process_based = True

    def __init__(self, device=None):
        self._device = device

    def open(self, hop: HopSpec) -> Channel:
        return ShmemChannel(hop, device=self._device)

    def open_fan(self, hop: HopSpec, n: int) -> list[Channel]:
        if n <= 1:
            return [self.open(hop)]
        from multiprocessing import shared_memory
        # one segment, n page-aligned SPSC lanes: r producers share the
        # ingress mapping without r separate control segments
        stride = _lane_stride(max(hop.depth, 1))
        ctl = shared_memory.SharedMemory(create=True, size=stride * n)
        return [ShmemChannel(hop, device=self._device,
                             _shared=(ctl, m * stride, n, stride))
                for m in range(n)]


TRANSPORTS: dict[str, Callable[..., Transport]] = {
    "emulated": EmulatedTransport,
    "socket": SocketTransport,
    "shmem": ShmemTransport,
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


# --------------------------------------------------------------------------- #
# Worker host process body
# --------------------------------------------------------------------------- #
def _flush_stats(stage: int, worker, ingress: Channel):
    """Drain this stage's compute stats, ingress observations and kernel
    launch counts into one picklable control message, resetting all
    three (delta semantics).  The launch counts are this process's own:
    the orchestrator cannot read a child's counters, so they ride here,
    beside the device the stage computes on."""
    from ..kernels import ops
    from .edge import StageStats, mem_pct
    s = worker.stats
    worker.stats = StageStats()
    records = [tuple(r) for r in ingress.drain_records()]
    return ("stats", stage,
            {"exe_s": s.exe_s, "calls": s.calls, "cpu_s": s.cpu_s,
             "launches": ops.drain_launch_counts(),
             "device": str(worker.device)},
            mem_pct(worker.device), records)


def _worker_main(spec: dict) -> None:
    """One pipeline stage as an OS process: recv → compute → send.

    The spec carries the model as a weightless skeleton plus a numpy
    state dict (a CUDA tensor would travel as an IPC handle tied to the
    parent), the device to rebuild it on, and the parent's numerics
    settings (TF32, cuDNN determinism, intra-op threads), which a fresh
    process would not otherwise share.  The ``ready`` message carries
    the standup split: spawn (``spec["t_spawn"]``, the parent's clock)
    to this body running — the interpreter, ``import torch`` and the
    spec unpickled — and the model rebuilt on its device, the CUDA
    context included."""
    t_entry = time.perf_counter()
    from ..kernels import ops
    from .edge import Worker, apply_numerics, rebuild_model

    stage: int = spec["stage"]
    ctrl = spec["ctrl"]
    stop = spec["stop"]
    ingress: Channel = spec["ingress"]
    egress: Channel = spec["egress"]
    bounds = tuple(spec["bounds"])
    backend = spec["backend"]

    try:
        apply_numerics(spec["numerics"])
        device = torch.device(spec["device"])
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        model = rebuild_model(spec["model"], spec["state"], device)

        def build(bounds):
            return Worker(f"worker{stage + 1}", model, bounds[stage],
                          bounds[stage + 1], backend, device,
                          cpu_clock=time.process_time,
                          pace_s=spec.get("pace_s", 0.0))

        worker = build(bounds)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_built = time.perf_counter()
        ops.reset_launch_counts()
        ctrl.send(("ready", stage, {
            "spawn_s": t_entry - spec.get("t_spawn", t_entry),
            "build_s": t_built - t_entry}))
        # flush-cancel skip window: the parent's out-of-band ("cancel",)
        # ctrl message overtakes the in-band stream, so batches already
        # queued ahead of the CANCEL fence skip compute and travel as
        # empty None markers (preserving arrival accounting).  The fence
        # itself (a truthy CANCEL payload) closes the window.  Purely an
        # optimization: the session drops canceled arrivals either way.
        cancel_target = fence_seen = 0
        while not stop.is_set():
            while ctrl.poll(0):
                msg = ctrl.recv()
                if isinstance(msg, tuple) and msg and msg[0] == "cancel":
                    cancel_target += 1
            try:
                kind, obj = ingress.recv(timeout=0.25)
            except TransportTimeout:
                continue
            if kind == STOP:
                egress.send(None, kind=STOP)
                break
            elif kind == BATCH:
                if obj is None or fence_seen < cancel_target:
                    egress.send(None, kind=BATCH)   # canceled: flush marker
                else:
                    egress.send(worker.run(obj), kind=BATCH)
            elif kind == CANCEL:
                if obj:
                    fence_seen += 1
                egress.send(obj, kind=CANCEL)
            elif kind == WARMUP:
                egress.send(worker.warmup(obj), kind=WARMUP)
            elif kind == PROBE:
                egress.send(None, kind=PROBE)
            elif kind == RECONFIG:
                # payload: legacy bounds tuple, or a dict carrying the
                # bounds plus a per-hop codec vector to switch to
                if isinstance(obj, dict):
                    bounds, codecs = tuple(obj["bounds"]), obj.get("codecs")
                else:
                    bounds, codecs = tuple(obj), None
                if (bounds[stage], bounds[stage + 1]) != (worker.lo, worker.hi):
                    worker = build(bounds)
                if (codecs is not None and egress.hop.scenario_hop
                        and 0 <= egress.hop.index < len(codecs)):
                    egress.set_codec(codecs[egress.hop.index])
                egress.send(obj, kind=RECONFIG)
            elif kind == STATS:
                ctrl.send(_flush_stats(stage, worker, ingress))
                egress.send(obj, kind=STATS)
            elif kind == CLOCK:
                ingress.epoch = egress.epoch = float(obj)
                egress.send(obj, kind=CLOCK)
            elif kind == ERROR:               # propagate towards the sink
                egress.send(obj, kind=ERROR)
    except BaseException as e:  # noqa: BLE001 — reported, then the host exits
        msg = f"stage {stage} ({type(e).__name__}): {e}"
        for report in (lambda: ctrl.send(("error", stage, msg)),
                       lambda: egress.send(msg, kind=ERROR)):
            try:
                report()
            except Exception:
                pass
    finally:
        ingress.close()
        egress.close()


# --------------------------------------------------------------------------- #
# Single-hop microbenchmark: one spawned sink process, receiver-measured
# records — per-hop cost at a sweep of payload sizes
# --------------------------------------------------------------------------- #
def _sink_main(spec: dict) -> None:
    """Receive-only host: drain a channel (unpacking onto its device),
    flush its TransferRecords to the parent over a control pipe on
    STATS, exit on STOP."""
    chan: Channel = spec["chan"]
    ctrl = spec["ctrl"]
    try:
        ctrl.send(("ready",))
        while True:
            try:
                kind, _ = chan.recv(timeout=0.25)
            except TransportTimeout:
                continue
            if kind == STOP:
                break
            if kind == STATS:
                ctrl.send([tuple(r) for r in chan.drain_records()])
            elif kind in (BATCH, WARMUP):
                ctrl.send(0)                  # credit back to the sender
            else:
                # PROBE/RECONFIG/CLOCK/ERROR are not part of the
                # microbench protocol; a stray one means the sender and
                # sink disagree about the wire — fail loudly (R1)
                raise TransportError(
                    f"sink: unexpected {_KIND_NAMES[kind]} token")
    finally:
        chan.close()
        ctrl.close()


def measure_hop(transport: str, sizes: Sequence[int], n_per_size: int = 20,
                warmup: int | None = None, depth: int = 4,
                framing: str = "raw", timeout_s: float = 60.0,
                codec: str = "none", pace_link: AnyLink | None = None,
                full: bool = False, sanitize: bool | None = None,
                device=None) -> dict[int, list]:
    """Stream float32 payloads of each size in ``sizes`` over one real
    hop to a spawned sink process → {nbytes: receiver-measured elapsed
    seconds per transfer}.  The sender packs on ``device`` (the card
    unless the caller names another) and the sink unpacks there.  The
    sink credits each message back over a control pipe and the sender
    waits for the credit, so every transfer measures true per-hop cost
    — without the credit, a fast sender queues messages in the transport
    and later transfers absorb the queueing delay of everything ahead of
    them.  Sizes run smallest-first over one channel, so the sweep also
    grows shmem slots in place; a wide spin window keeps the credit
    round trip on the shmem spin path instead of a scheduler wakeup."""
    import multiprocessing as mp

    from ..models.cnn.zoo import resolve_device
    from .sanitizer import maybe_sanitize, sanitize_enabled
    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..kernels._build import CODEC_PACK
        CODEC_PACK.build()                    # once, before the sink needs it
    if warmup is None:
        # every shmem slot must be grown and first-touched at each size
        # before timing starts
        warmup = depth + 3
    ctx = mp.get_context("spawn")
    chan = get_transport(transport, device=dev).open(
        HopSpec(index=0, framing=framing, depth=depth,
                send_timeout_s=timeout_s, spin_us=500.0, codec=codec,
                pace_link=pace_link, sanitize=sanitize_enabled(sanitize)))
    tx, rx = maybe_sanitize(chan).split()
    parent_c, child_c = ctx.Pipe()
    proc = ctx.Process(target=_sink_main, args=({"chan": rx, "ctrl": child_c},),
                       daemon=True, name=f"hop-sink-{transport}")
    proc.start()
    child_c.close()
    out: dict[int, list] = {}
    try:
        rx.close()                            # parent's copy of the far end
        if not parent_c.poll(timeout_s):
            raise TransportError(f"{transport} sink failed to start")
        parent_c.recv()
        for nbytes in sorted(sizes):
            x = torch.zeros(max(nbytes // 4, 1), dtype=torch.float32,
                            device=dev)
            for i in range(warmup + n_per_size):
                tx.send(x, kind=WARMUP if i < warmup else BATCH)
                if not parent_c.poll(timeout_s):
                    raise TransportError(f"{transport} sink stalled")
                parent_c.recv()
            tx.send(kind=STATS)
            if not parent_c.poll(timeout_s):
                raise TransportError(f"{transport} sink stopped responding")
            recs = [TransferRecord(*r) for r in parent_c.recv()]
            recs = [r for r in recs if r.raw_bytes == x.numel() * 4]
            out[nbytes] = recs if full else [r.elapsed_s for r in recs]
    finally:
        try:
            tx.send(kind=STOP)
        except Exception:
            pass
        proc.join(5.0)
        if proc.is_alive():
            proc.terminate()
            proc.join(1.0)
        tx.close()
        tx.reap()
        parent_c.close()
    return out


# --------------------------------------------------------------------------- #
# Trace recorder: measured records → replayable LinkTrace
# --------------------------------------------------------------------------- #
def record_trace(source, *, name: str = "recorded", bucket_s: float = 0.5,
                 fallback: Link | None = None) -> LinkTrace:
    """Convert drained ``TransferRecord``s from a real (measured)
    channel into a replayable ``LinkTrace`` — measured runs seeding the
    emulator.

    Records are grouped into ``bucket_s`` windows of hop time; per
    bucket the RTT comes from header-only probes (nbytes=0: elapsed ≈
    one-way, so RTT = 2×mean) and the bandwidth from a least-squares
    fit of elapsed = rtt/2 + overhead + nbytes/bw over the bucket's
    data transfers (single-size buckets fall back to per-record
    attribution).  Buckets inherit missing values from their
    predecessor / the ``fallback`` link.

    ``source`` is a Channel/HopObservations (drained) or an iterable of
    ``(nbytes, elapsed_s, t_s)`` records.
    """
    # duck-typed: a SanitizedChannel wrapper delegates drain_records()
    # and link without subclassing HopObservations
    if isinstance(source, HopObservations) or hasattr(source, "drain_records"):
        records = source.drain_records()
        if fallback is None and isinstance(getattr(source, "link", None), Link):
            fallback = source.link
    else:
        records = [TransferRecord(*r) for r in source]
    if not records:
        raise ValueError("record_trace: no records to convert")
    records = sorted(records, key=lambda r: r.t_s)

    rtt = fallback.rtt_s if fallback is not None else None
    overhead = fallback.per_msg_overhead_s if fallback is not None else 0.0
    bw = fallback.bw_bytes_per_s if fallback is not None else None

    knots: list[tuple[float, float, float]] = []
    t0, t_end = records[0].t_s, records[-1].t_s
    n_buckets = max(int((t_end - t0) / bucket_s) + 1, 1)
    for b in range(n_buckets):
        lo, hi = t0 + b * bucket_s, t0 + (b + 1) * bucket_s
        group = [r for r in records
                 if lo <= r.t_s < hi or (b == n_buckets - 1 and r.t_s == hi)]
        if not group:
            continue
        probes = [r.elapsed_s for r in group if r.nbytes <= 0]
        if probes:
            rtt = 2.0 * float(np.mean(probes))
        data = [r for r in group if r.nbytes > 0]
        if data:
            fit = fit_link_params([r.nbytes for r in data],
                                  [r.elapsed_s for r in data], rtt or 0.0)
            if fit is not None:               # joint fit: slope → 1/bw
                bw, overhead = fit
            else:                             # degenerate bucket: attribute
                bw = float(np.mean([
                    attribute_bandwidth(r.nbytes, r.elapsed_s, rtt or 0.0,
                                        overhead) for r in data]))
        if rtt is not None and bw is not None and bw > 0:
            knots.append(((lo + min(hi, t_end)) / 2.0, float(rtt), float(bw)))
    if not knots:
        raise ValueError("record_trace: no bucket yielded both an RTT and "
                         "a bandwidth estimate (need probes or a fallback "
                         "link for the RTT)")
    return LinkTrace(
        name=name, schedule=tuple(knots),
        per_msg_overhead_s=float(overhead),
        energy_per_byte_j=(fallback.energy_per_byte_j
                           if fallback is not None else 0.0),
    )
