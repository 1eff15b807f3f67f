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
    ``sendmsg``, a reusable receive buffer).  The ``shmem`` ring of the
    reference is not ported yet and raises ``NotImplementedError``
    (ROADMAP queue 1, item 6b).

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
and byte count end to end, and under ``socket`` each stage's process
launches its hops' kernels in its own CUDA context.

Messages are typed (``BATCH``/``WARMUP``/``PROBE``/``RECONFIG``/
``STATS``/``STOP``/``ERROR``/``CLOCK``/``CANCEL``) and control tokens
flow in-band through the stage chain, so they stay ordered with the
batches around them.  ``_worker_main`` is the per-stage process body:
recv from the ingress channel, execute the stage's block range, send
downstream, and flush stats, observations and kernel launch counts to
the orchestrator over a control pipe when a ``STATS`` token passes.
"""
from __future__ import annotations

import pickle
import queue
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
    (The reference's shmem fields — spin window and doorbell — and its
    fault plans arrive with those, ROADMAP queue 1, item 6b.)"""

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
    # payload outlives the call (the result drain).  The socket receive
    # always copies into tensor-owned memory, so only the sanitizer's
    # lease canary reads it there.
    zero_copy: bool = True
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
# The shmem ring's metadata record adds the slot index and lease fields
# (declared for item 6b).  Both are the reference's layout v2, field for
# field, so a reference end and a port end share one connection.
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
            if self.hop.framing == "pickle":
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

    def send(self, payload=None, kind: int = BATCH):
        if self._tx is None:
            raise TransportError(f"hop {self.hop.index}: receive-only end")
        t0 = time.perf_counter()              # serialization counts
        ftype, code, shape, data, meta, ccode = _frame(
            payload, self.hop.framing, self._send_codec(kind))
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


class SocketTransport(Transport):
    """Real loopback TCP; receiving ends decode onto ``device`` (the
    CPU unless given)."""

    name = "socket"
    process_based = True

    def __init__(self, device=None):
        self._device = device

    def open(self, hop: HopSpec) -> Channel:
        return SocketChannel(hop, device=self._device)


def _not_ported(name: str) -> Callable[..., Transport]:
    def factory(**_kwargs) -> Transport:
        raise NotImplementedError(
            f"the {name!r} process transport is not ported yet (ROADMAP "
            "queue 1, item 6b); use transport='socket' or 'emulated'")
    return factory


TRANSPORTS: dict[str, Callable[..., Transport]] = {
    "emulated": EmulatedTransport,
    "socket": SocketTransport,
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
    process would not otherwise share."""
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
        ops.reset_launch_counts()
        ctrl.send(("ready", stage))
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
    them."""
    import multiprocessing as mp

    from ..models.cnn.zoo import resolve_device
    from .sanitizer import maybe_sanitize, sanitize_enabled
    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..kernels._build import CODEC_PACK
        CODEC_PACK.build()                    # once, before the sink needs it
    if warmup is None:
        warmup = depth + 3
    ctx = mp.get_context("spawn")
    chan = get_transport(transport, device=dev).open(
        HopSpec(index=0, framing=framing, depth=depth,
                send_timeout_s=timeout_s, codec=codec, pace_link=pace_link,
                sanitize=sanitize_enabled(sanitize)))
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
        parent_c.close()
    return out
