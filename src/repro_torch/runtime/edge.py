"""Executable ParetoPipe pipeline — k-stage orchestrator + workers
(paper Fig. 1 / Alg. 1, generalized past the paper's 2-device testbed).

This is the *measured* half of the reproduction: a real partitioned
pipeline, one worker per stage executing its contiguous block range
``[cuts[i], cuts[i+1])`` on the pipeline's device, with the hop layer
behind the Transport API (``runtime.transport``):

  * ``emulated`` — stages are threads, every hop an ``EmulatedChannel``
    (tc-style: RTT/2 + bytes/bw injected as wall-clock delay, static
    ``Link`` or time-varying ``LinkTrace`` sampled at the pipeline clock
    per transfer).  Backend cost is *modeled*.
  * ``socket`` / ``shmem`` — stages are spawned OS processes, each with
    its own CUDA context on the card, every hop real TCP on loopback or
    a shared-memory doorbell ring, in the reference's wire format.
    Backend cost is *measured* per transfer.

Either way each hop's wire codec packs on the sending stage's device
and unpacks on the receiving stage's, with the CUDA kernels on the
card.  The protocol sanitizer (``runtime.sanitizer``) checks every hop
when asked.  On the process transports a ``FaultPlan``
(``runtime.faults``) injects scripted faults, and the supervisor
(``supervise=``) recovers from them: it detects a dead worker, a
worker-reported error or a stalled stream, rebuilds the worker tier
and has the session replay its unacked batches.

Orthogonally, **dual communication backends per stage** mirror the
paper's PyTorch-RPC vs. custom-socket study:

  - ``lightweight``: one call per stage over its blocks; activations
    cross the hop as tensors (codec-packed where the hop has a codec).
  - ``rpc``: per-*block* call dispatch with a full serialize →
    byte-buffer → deserialize round trip per block plus a per-call
    coordination overhead — the structural costs that made PyTorch RPC
    slow in the paper (Sec. V-C).

Execution is always pipelined: the streaming ``Session`` API
(``EdgePipeline.session``, ``runtime.session``) feeds batches into the
concurrent stage chain and hands results back in order.  ``run_one``
(the paper's lone-batch latency metric) and ``stream`` (steady-state
throughput) are thin shims over one-deep / full-window sessions, and
``measure`` reports both.  On the card each stage runs on a CUDA stream
of its own, with the hop round trip on its output, and its wall time is
read after that stream is synchronised, so it covers the stage's own
device work, not only its enqueue, and not the other stages' kernels.
Tensors cross hops with a CUDA event the consumer's stream waits on
(``transport.ready_event``).
"""
from __future__ import annotations

import copy
import dataclasses
import os
import queue
import resource
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Literal, Sequence

import numpy as np
import torch

from ..core.devices import AnyLink, Link, LinkTrace
from ..core.scenarios import Scenario
from ..models.cnn.zoo import resolve_device
from . import transport as T
from .sanitizer import maybe_sanitize, sanitize_enabled
from .transport import (BATCH, CANCEL, CLOCK, PROBE, RECONFIG, STATS, STOP,
                        WARMUP, ERROR, HopMeter, HopSpec, TransferRecord,
                        TransportError, TransportTimeout, _Serializer,
                        get_transport)

Backend = Literal["lightweight", "rpc"]

# Coordination overhead charged per RPC call (future creation, GIL
# handoff, TensorPipe negotiation ~ O(100us) in the paper's setup).
RPC_PER_CALL_OVERHEAD_S = 200e-6


@dataclass
class StageStats:
    exe_s: float = 0.0
    net_s: float = 0.0
    calls: int = 0
    cpu_s: float = 0.0              # worker CPU time (process clock)
    cpu_pct: float = 0.0
    mem_pct: float = 0.0
    # worker processes only: kernel launches counted in the stage's own
    # process (by ``ops`` wrapper name) and the device it computes on
    launches: dict[str, int] = field(default_factory=dict)
    device: str = ""


def mem_pct(device: torch.device) -> float:
    """Memory share of ``device`` held by this process: PyTorch's
    reserved pool over the card's memory on CUDA, the resident set over
    physical memory on the CPU."""
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        return 100.0 * torch.cuda.memory_reserved(device) / total
    page = os.sysconf("SC_PAGE_SIZE")
    try:
        with open("/proc/self/statm") as f:
            rss = int(f.read().split()[1]) * page
    except OSError:
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return 100.0 * rss / (page * os.sysconf("SC_PHYS_PAGES"))


def numerics() -> dict:
    """This process's settings that decide a stage's bits: TF32, the
    cuDNN algorithm choice, and the intra-op thread count.  A spawned
    worker starts from torch's defaults, so the engine ships these."""
    return {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.deterministic": torch.backends.cudnn.deterministic,
            "cudnn.benchmark": torch.backends.cudnn.benchmark,
            "threads": torch.get_num_threads()}


def apply_numerics(flags: dict) -> None:
    """Set what ``numerics`` read, before any stage computes."""
    torch.backends.cudnn.allow_tf32 = flags["cudnn.allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = flags["matmul.allow_tf32"]
    torch.backends.cudnn.deterministic = flags["cudnn.deterministic"]
    torch.backends.cudnn.benchmark = flags["cudnn.benchmark"]
    torch.set_num_threads(flags["threads"])


def ship_model(model) -> tuple:
    """→ (skeleton, state): ``model`` with every parameter and buffer
    slot emptied, and those tensors as host numpy arrays by state-dict
    name.  Both pickle by value, whatever device the model is on."""
    state = {k: v.detach().cpu().numpy()
             for k, v in model.state_dict().items()}
    tensors = [*model.parameters(), *model.buffers()]
    skeleton = copy.deepcopy(model, memo={id(t): None for t in tensors})
    return skeleton, state


def rebuild_model(skeleton, state: dict, device: torch.device):
    """Inverse of ``ship_model``, the tensors placed on ``device``."""
    for name, arr in state.items():
        path, _, leaf = name.rpartition(".")
        mod = skeleton.get_submodule(path)
        t = torch.from_numpy(arr).to(device)
        if leaf in mod._parameters:
            mod._parameters[leaf] = torch.nn.Parameter(t,
                                                       requires_grad=False)
        else:
            mod._buffers[leaf] = t
    return skeleton.eval()


_STREAM_POOL = 32   # torch's streams a device and priority, handed out in turn


def _own_stream(device: torch.device, taken: Sequence[int]):
    """A stream of torch's pool whose handle is none of ``taken``.  The
    pool hands its streams out in turn, so after enough pipelines or
    RECONFIGs the next one is a live stage's; two stages on one stream
    would be charged with each other's kernels again.  With every
    stream of the pool taken, the stage shares one and a warning says
    so."""
    for _ in range(_STREAM_POOL):
        stream = torch.cuda.Stream(device)
        if stream.cuda_stream not in taken:
            return stream
    warnings.warn(f"more than {_STREAM_POOL} pipeline stages on {device}: "
                  f"stages share CUDA streams, and each one's exe_s "
                  f"includes the other's kernels", RuntimeWarning,
                  stacklevel=3)
    return stream


class Worker:
    """One pipeline stage: executes blocks[lo:hi] of a CNNModel on
    ``device``.  Inputs arriving elsewhere (an rpc round trip, a caller's
    host tensor) are moved to the stage's device first.

    On a CUDA device the worker owns a stream: its blocks run there, and
    ``exe_s`` ends when that stream's work is done (the counterpart of
    the reference's ``block_until_ready`` of the stage's own output), so
    stages sharing the card are not charged with each other's kernels.
    ``run``/``warmup`` take an input that is ready on the caller's current
    stream, and return one that is ready.  On the CPU there is no stream.
    ``taken`` holds the ``cuda_stream`` handles of the stages beside it,
    which its own stream must not be (see ``_own_stream``).

    ``cpu_clock`` attributes host CPU time to this worker (default
    ``process_time``); under threads the attribution is exact whenever
    stages run one at a time (the latency phase), which is where
    ``measure`` reads it."""

    def __init__(self, name: str, model, lo: int, hi: int, backend: Backend,
                 device: torch.device,
                 cpu_clock: Callable[[], float] | None = None,
                 pace_s: float = 0.0, taken: Sequence[int] = ()):
        self.name, self.lo, self.hi, self.backend = name, lo, hi, backend
        self.device = device
        self.stream = (_own_stream(device, taken) if device.type == "cuda"
                       else None)
        self.stats = StageStats()
        self._cpu_clock = cpu_clock or time.process_time
        # per-batch floor on this stage's wall time — device-speed
        # emulation on a host faster than the scenario's hardware, the
        # compute-side twin of EmulatedChannel's link pacing
        self.pace_s = pace_s
        self._layers = list(model.layers[lo:hi])

    @torch.no_grad()
    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.device)
        if self.backend == "rpc":
            for layer in self._layers:
                # serialize/deserialize at every module-call boundary
                x = _Serializer.loads(_Serializer.dumps(x), self.device)
                time.sleep(RPC_PER_CALL_OVERHEAD_S)
                x = layer(x)
            return x
        for layer in self._layers:
            x = layer(x)
        return x

    def _compute(self, x):
        if self.stream is None:
            return self._forward(x)
        caller = torch.cuda.current_stream(self.device)
        if caller != self.stream:             # x is ready on the caller's
            self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            x = self._forward(x)
        self.stream.synchronize()
        return x

    def warmup(self, x):
        return self._compute(x)

    def run(self, x):
        t0 = time.perf_counter()
        c0 = self._cpu_clock()
        x = self._compute(x)
        if self.pace_s > 0.0:
            rem = self.pace_s - (time.perf_counter() - t0)
            if rem > 0:
                time.sleep(rem)
        self.stats.exe_s += time.perf_counter() - t0
        self.stats.cpu_s += self._cpu_clock() - c0
        self.stats.calls += 1
        return x


@dataclass
class PipelineResult:
    backend: str                    # per-stage backends, "+"-joined if mixed
    partition: tuple[int, ...]      # cut vector
    latency_s: float                # lone-batch end-to-end
    throughput: float               # samples/s steady state
    stage_exe_s: tuple[float, ...]  # mean per-batch exe per stage
    net_s: float                    # mean per-batch wire time, all hops
    hop_net_s: tuple[float, ...] = ()   # mean per-batch wire time per hop
    cpu_pct: tuple[float, ...] = ()     # per-worker CPU util while executing
    mem_pct: tuple[float, ...] = ()     # per-stage device (or host) memory share
    # modeled J/batch from *measured* stage times + wire bytes (scenario
    # device power × exe + idle × wire wait + radio × bytes); 0.0 when
    # the pipeline was built from bare links (no device power profile)
    energy_j: float = 0.0
    stage_energy_j: tuple[float, ...] = ()
    transport: str = "emulated"     # per-hop transports, "+"-joined if mixed
    replicas: tuple[int, ...] = ()  # per-stage replica counts ((): all 1)


# --------------------------------------------------------------------------- #
# The thread engine: where the workers live and how batches cross hops
# --------------------------------------------------------------------------- #
class _QueueChan:
    """A ``queue.Queue`` behind the Channel send/recv surface, so the
    thread engine's feed/result ends compose with the replica fan
    wrappers exactly like real channels do."""

    hop = HopSpec(index=-1, scenario_hop=False)

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self.epoch = 0.0

    def send(self, payload=None, kind: int = BATCH):
        self._q.put((kind, payload, T.ready_event(payload)))

    def recv(self, timeout: float | None = None):
        try:
            kind, payload, ready = self._q.get(timeout=timeout)
        except queue.Empty:
            raise TransportTimeout("session: no result arrived") from None
        return kind, T.await_ready(payload, ready)

    def set_codec(self, name: str) -> None:
        pass

    def drain_records(self):
        return []

    def close(self) -> None:
        pass

    def reap(self) -> None:
        pass


class _LaneGroupObs:
    """One per-hop observation surface over a replicated hop's lanes —
    what ``pipe.nets`` exposes when a hop has several emulated lanes."""

    def __init__(self, lanes: Sequence[T.EmulatedChannel]):
        self.lanes = list(lanes)

    @property
    def link(self):
        return self.lanes[0].link

    def drain_observations(self) -> list[TransferRecord]:
        out: list[TransferRecord] = []
        for lane in self.lanes:
            out.extend(lane.drain_observations())
        out.sort(key=lambda r: r.t_s)
        return out

    drain_records = drain_observations

    def _sum(self, attr: str):
        return sum(getattr(l, attr) for l in self.lanes)

    @property
    def observations(self):
        return [r for lane in self.lanes for r in lane.observations]

    @property
    def total_bytes(self):
        return self._sum("total_bytes")

    @property
    def total_raw_bytes(self):
        return self._sum("total_raw_bytes")

    @property
    def total_energy_j(self):
        return self._sum("total_energy_j")

    @property
    def total_transfers(self):
        return self._sum("total_transfers")

    @property
    def total_elapsed_s(self):
        return self._sum("total_elapsed_s")


class _ThreadEngine:
    """Stages as threads of this process, hops as EmulatedChannels —
    the modeled path (and the only one a LinkTrace can drive).  A stage
    with ``replicas[i] == r`` runs as r session threads over a lane
    group of r channels (see ``transport.FanOutChannel``)."""

    def __init__(self, pipe: "EdgePipeline"):
        self.pipe = pipe
        self.chan_groups: list[list[T.EmulatedChannel]] = self._open_chans()
        self.stage_workers: list[list[Worker]] = []
        self._build_workers()

    def _open_chans(self) -> "list[list[T.EmulatedChannel]]":
        pipe = self.pipe
        r = pipe.replicas
        tr = get_transport("emulated", clock=pipe.clock)
        return [
            [maybe_sanitize(c) for c in
             tr.open_fan(HopSpec(index=i, link=link,
                                 framing=("pickle" if pipe.backends[i] == "rpc"
                                          else "raw"),
                                 depth=pipe.queue_depth, seed=pipe.seed + i,
                                 codec=pipe.codecs[i],
                                 sanitize=pipe.sanitize),
                         max(r[i], r[i + 1]))]
            for i, link in enumerate(pipe.links)]

    @property
    def nets(self):
        return [g[0] if len(g) == 1 else _LaneGroupObs(g)
                for g in self.chan_groups]

    @property
    def workers(self) -> list[Worker]:
        """Flat stage-major worker list (replica-free pipelines see the
        historical one-worker-per-stage shape)."""
        return [w for ws in self.stage_workers for w in ws]

    def _new_worker(self, i: int, lo: int, hi: int,
                    beside: Sequence[Worker] = ()) -> Worker:
        """Stage ``i``'s worker on blocks ``[lo, hi)``, on a CUDA stream
        none of ``beside`` (and none of the live stages) runs on."""
        pipe = self.pipe
        taken = {w.stream.cuda_stream
                 for w in [*beside, *self.workers] if w.stream is not None}
        return Worker(f"worker{i + 1}", pipe.model, lo, hi, pipe.backends[i],
                      pipe.device, pace_s=pipe.stage_pace_s[i], taken=taken)

    def _build_workers(self, reuse: Sequence[Worker] = ()) -> None:
        """Instantiate stage workers, reusing any existing worker whose
        (block range, backend) is unchanged."""
        pipe = self.pipe
        pool: dict[tuple, list[Worker]] = {}
        for w in reuse:
            pool.setdefault((w.lo, w.hi, w.backend), []).append(w)
        bounds = pipe.bounds()
        self.stage_workers, built = [], list(reuse)
        for i in range(pipe.n_stages):
            key = (bounds[i], bounds[i + 1], pipe.backends[i])
            ws = []
            for m in range(pipe.replicas[i]):
                cached = pool[key].pop() if pool.get(key) else None
                if cached is None:
                    cached = self._new_worker(i, bounds[i], bounds[i + 1],
                                              beside=built)
                    built.append(cached)
                ws.append(cached)
            self.stage_workers.append(ws)

    def warmup(self, x):
        for ws in self.stage_workers:
            y = None
            for w in ws:                      # every replica warms its stage
                y = w.warmup(x)
            x = y
        return x

    def migrate(self) -> None:
        self._build_workers(reuse=self.workers)
        for i, group in enumerate(self.chan_groups):
            for chan in group:
                chan.set_codec(self.pipe.codecs[i])

    def probe(self) -> None:
        for group in self.chan_groups:
            for chan in group:
                chan.send(kind=PROBE)         # records the RTT sample …
                chan.recv(timeout=5.0)        # … and consumes the token
                                              # (no session thread to)

    def stage_stats(self) -> list[StageStats]:
        out = []
        for ws in self.stage_workers:
            s = StageStats()
            for w in ws:                      # replicas fold into one
                s.exe_s += w.stats.exe_s      # logical stage
                s.net_s += w.stats.net_s
                s.calls += w.stats.calls
                s.cpu_s += w.stats.cpu_s
                s.mem_pct = max(s.mem_pct, w.stats.mem_pct)
            out.append(s)
        return out

    def reset_stats(self) -> None:
        for w in self.workers:
            w.stats = StageStats()

    def set_epoch(self, _epoch: float) -> None:
        pass                                  # channels read pipe.clock live

    # session primitives: persistent stage threads, in-band tokens ------- #
    def session_open(self) -> None:
        pipe = self.pipe
        k, r = pipe.n_stages, pipe.replicas
        for group in self.chan_groups:        # channels outlive sessions:
            for chan in group:                # STOP is terminal per stream
                if hasattr(chan, "reset_stream"):
                    chan.reset_stream()
        self._feed_lanes = [_QueueChan() for _ in range(r[0])]
        self._out_lanes = [_QueueChan() for _ in range(r[k - 1])]
        self._err: queue.Queue = queue.Queue()
        lanes: list[list] = [self._feed_lanes, *self.chan_groups,
                             self._out_lanes]
        self._feed = (T.FanOutChannel(self._feed_lanes)
                      if len(self._feed_lanes) > 1 else self._feed_lanes[0])
        self._result = (T.FanInChannel(self._out_lanes)
                        if len(self._out_lanes) > 1 else self._out_lanes[0])
        self._cancel_epoch = 0                # flush-cancels this session
        self._sthreads = []
        for i in range(k):
            for m in range(r[i]):
                # replica m owns lane m through a replicated region; a
                # solo stage facing a wider group fans out / merges in
                ingress = (lanes[i][m] if r[i] > 1
                           else T.FanInChannel(lanes[i])
                           if len(lanes[i]) > 1 else lanes[i][0])
                egress = (lanes[i + 1][m] if r[i] > 1
                          else T.FanOutChannel(lanes[i + 1])
                          if len(lanes[i + 1]) > 1 else lanes[i + 1][0])
                t = threading.Thread(
                    target=self._stage_loop, args=(i, m, ingress, egress),
                    daemon=True, name=f"session-stage{i}.{m}")
                self._sthreads.append(t)
        for t in self._sthreads:
            t.start()

    def _stage_loop(self, i: int, m: int, ingress, egress) -> None:
        """One pipeline stage replica as a session thread: recv →
        handle → send, every control token flowing in-band with the
        batches around it."""
        pipe = self.pipe
        last = i == pipe.n_stages - 1
        failed = False
        # flush-cancel skip window: ``cancel_flush`` bumps the shared
        # epoch out-of-band (a plain int read — GIL-atomic), so batches
        # still queued ahead of the in-band CANCEL fence skip compute
        # and travel on as empty None markers.  The fence (truthy
        # payload) closes the window.
        fence_seen = 0
        while True:
            # the message and the hop round trip on this replica's output
            # run on its worker's stream (none on the CPU; a RECONFIG may
            # replace the worker, so it is read again for every message)
            w = self.stage_workers[i][m]
            with torch.cuda.stream(w.stream):
                try:
                    # bounded wait (pipecheck R6): a wedged upstream must
                    # not park this thread beyond the doorbell cadence
                    kind, obj = ingress.recv(timeout=1.0)
                except TransportTimeout:
                    continue
                if kind == STOP:
                    egress.send(None, kind=STOP)
                    return
                if failed:                    # drain so upstream never
                    continue                  # blocks on a full queue
                try:
                    fence_seen = self._handle(i, m, w, kind, obj, egress,
                                              last, fence_seen)
                except BaseException as e:    # noqa: BLE001 — reported
                    failed = True
                    # ship the exception object itself, so the session
                    # re-raises the caller's own type with its traceback;
                    # a dedicated error queue keeps lane ordering intact
                    self._err.put((ERROR, e))

    def _handle(self, i: int, m: int, w: Worker, kind: int, obj, egress,
                last: bool, fence_seen: int) -> int:
        """One message at stage ``i`` replica ``m`` (worker ``w``) →
        the flush fences seen so far."""
        if kind == BATCH:
            if obj is None or fence_seen < self._cancel_epoch:
                egress.send(None, kind=BATCH)  # canceled: marker
            else:
                egress.send(w.run(obj), kind=BATCH)
        elif kind == CANCEL:
            if obj:
                fence_seen += 1
            egress.send(obj, kind=CANCEL)
        elif kind == WARMUP:
            egress.send(w.warmup(obj), kind=WARMUP)
        elif kind == RECONFIG:
            if isinstance(obj, dict):         # {"bounds":…, "codecs":…}
                bounds = tuple(obj["bounds"])
                codecs = obj.get("codecs")
            else:                             # legacy bare bounds tuple
                bounds, codecs = tuple(obj), None
            if (bounds[i], bounds[i + 1]) != (w.lo, w.hi):
                self.stage_workers[i][m] = self._new_worker(
                    i, bounds[i], bounds[i + 1])
            if codecs is not None and not last:
                egress.set_codec(codecs[i])
            egress.send(obj, kind=RECONFIG)
        elif kind == PROBE:
            egress.send(None, kind=PROBE)     # emulates 0 bytes per hop
        elif kind in (STATS, CLOCK):          # pass-through tokens
            egress.send(obj, kind=kind)
        else:
            # ERROR never originates upstream of a thread stage (errors
            # ride self._err), so any other kind is a protocol break —
            # fail loudly instead of silently forwarding (pipecheck R1)
            raise TransportError(
                f"stage {i}.{m}: unexpected "
                f"{T._KIND_NAMES[kind] if 0 <= kind < len(T._KIND_NAMES) else kind} "
                f"token in session stream")
        return fence_seen

    def submit(self, x) -> None:
        self._feed.send(x, kind=BATCH)

    def submit_token(self, kind: int, obj=None) -> None:
        self._feed.send(obj, kind=kind)

    def cancel_flush(self) -> None:
        """Open a skip window: batches already in flight short-circuit
        compute until the next flush CANCEL fence passes each stage."""
        self._cancel_epoch += 1

    def poll(self, timeout: float):
        deadline = time.perf_counter() + timeout
        while True:
            try:
                return self._err.get_nowait()
            except queue.Empty:
                pass
            try:
                return self._result.recv(timeout=min(timeout, 0.1))
            except TransportTimeout:
                if time.perf_counter() >= deadline:
                    raise TransportTimeout(
                        "session: no result arrived") from None

    def harvest(self) -> None:
        pass                                  # stats/records are live

    def max_inflight(self) -> int | None:
        return None                           # the feed queues are unbounded

    def session_close(self, failed: bool = False) -> None:
        try:
            self._feed.send(None, kind=STOP)  # broadcast across feed lanes
        except Exception:
            pass
        deadline = time.perf_counter() + 5.0
        for t in self._sthreads:
            t.join(max(deadline - time.perf_counter(), 0.05))
        stragglers = any(t.is_alive() for t in self._sthreads)
        self._sthreads = []
        if stragglers:
            # a stage still computing can push its finished batch (and
            # the forwarded STOP) into the channels *after* this close —
            # orphan them so a later session cannot consume leftovers
            self.chan_groups = self._open_chans()
            return
        # threads are gone: a clean close left the channels empty (STOP
        # reached the result lanes); after a failure, drop what draining
        # left behind
        for group in self.chan_groups:
            for chan in group:
                try:
                    while True:
                        chan._q.get_nowait()
                except queue.Empty:
                    pass

    def mem_pct(self) -> float:
        """Memory share of the pipeline's device (``mem_pct``)."""
        return mem_pct(self.pipe.device)

    def close(self) -> None:
        pass


# how long a blocked orchestrator feed send waits before resurfacing as
# TransportTimeout so the engine can re-check worker liveness
_FEED_SEND_CHUNK_S = 0.5


class _ProcessEngine:
    """Stages as spawned OS processes, hops as real socket or shmem
    channels — the measured path.  The orchestrator feeds stage 0 and
    drains stage k-1 over extra (non-scenario) channels and harvests
    per-stage stats, per-hop TransferRecords and each process's kernel
    launch counts over control pipes whenever a STATS token traverses
    the chain.

    Each worker rebuilds the model from a numpy state dict on the
    pipeline's device, with this process's numerics settings, so on the
    card every stage has a CUDA context of its own (the contexts share
    the card by time-slicing) and packs and unpacks its hops' codecs
    there.  Unsupervised, a dead worker raises ``TransportError``.
    Supervised (``pipe.supervise``), worker death, a worker-reported
    ERROR or a stream stalled past the stall window trigger a recovery
    (``_recover``): the whole worker tier is torn down and spawned
    again (at r−1 on a replicated stage that lost a lane), the WARMUP
    fence is replayed, and the session re-sends its unacked batches;
    each recovery emits a ``RecoveryRecord``.  ``standup`` holds the
    last standup's split: per worker, when its spawn began after the
    first's (``offset_s``), how long ``Process.start`` blocked
    (``start_call_s``: spawn writes the pickled spec into the child's
    pipe, which the child drains as it unpickles), spawn to its body
    running (``spawn_s``: the interpreter, ``import torch``, the spec
    unpickled) and the model rebuilt on its device (``build_s``, the
    CUDA context included); and the whole tier's spawn-to-ready time
    (``total_s``)."""

    results_persist = True      # the worker loop outlives any session

    def __init__(self, pipe: "EdgePipeline"):
        import multiprocessing as mp

        from .faults import BackoffPolicy
        self.pipe = pipe
        self._ctx = mp.get_context("spawn")
        self._stop = self._ctx.Event()
        k = pipe.n_stages
        self._meters = [HopMeter(l) for l in pipe.links]
        self._stats = [StageStats() for _ in range(k)]
        self._procs: list = []
        self._ctrls: list = []
        self._ctrl_stage: list[int] = []      # worker w -> its logical stage
        self._proc_slot: list[tuple[int, int]] = []   # worker w -> (stage, lane)
        self._pairs: list = []                # flat (tx, rx) per lane
        self._groups: list[list] = []         # pairs grouped per channel j
        self._feed = None                     # Channel or FanOutChannel
        self._result = None                   # Channel or FanInChannel
        self._warm_x = None
        self._closed = False
        self.standup: dict = {}
        # -- supervisor state (active when pipe.supervise) -------------- #
        self.supervised = bool(pipe.supervise)
        self._backoff = BackoffPolicy()
        self._down: dict[int, int] = {}       # stage -> evicted lane count
        self._restaff_needed = False
        self._device_loss: list[tuple[int, int]] = []  # undrained (stage, lane)
        self._replay_cb: Callable[[], int] | None = None
        self._recovering = False
        self._recover_count = 0
        self._batch_seq = 0                   # global batches fed (kills key)
        plan = pipe.fault_plan
        self._kills = plan.kill_events() if plan is not None else {}
        self._chaos_fired: set = set()        # events already executed
        self._last_alive = time.perf_counter()
        try:
            self._start(k)
        except BaseException:
            # partial standup must not leak live worker processes,
            # sockets or shmem segments — the caller gets no pipe object
            # to close()
            self.close()
            raise

    def _r_eff(self) -> tuple[int, ...]:
        """Replica counts net of supervisor-evicted lanes (never < 1):
        the staffing the next (re)build runs at until ``restaff``."""
        return tuple(max(r - self._down.get(i, 0), 1)
                     for i, r in enumerate(self.pipe.replicas))

    def _start(self, k: int) -> None:
        from .faults import maybe_chaos
        pipe = self.pipe
        r = self._r_eff()
        if pipe.device.type == "cuda":
            # once here, not in k processes at once at their first pack
            from ..kernels._build import CODEC_PACK
            CODEC_PACK.build()
        # channel j carries stage j-1 -> stage j; j=0 is the orchestrator
        # feed, j=k the result drain (neither is a scenario hop).  A
        # channel touching a replicated stage becomes a lane *group* of
        # max(r_left, r_right) lanes (one shared control segment under
        # shmem)
        chan_names = ([pipe.transports[0], *pipe.transports,
                       pipe.transports[-1]] if k > 1
                      else [pipe.transport_names[0]] * 2)
        trs = {n: get_transport(n, device=pipe.device)
               for n in set(chan_names)}
        for j in range(k + 1):
            internal = 0 < j < k
            framing = ("pickle" if 0 < j and pipe.backends[j - 1] == "rpc"
                       else "raw")
            n_lanes = max(r[j - 1] if j > 0 else 1, r[j] if j < k else 1)
            spec = HopSpec(
                index=j - 1,
                link=pipe.links[j - 1] if internal else None,
                framing=framing,
                # the feed must hold a full stream window, or the
                # orchestrator's send blocks where no liveness check runs
                depth=(pipe.queue_depth if internal
                       else max(pipe.queue_depth * k, 1)),
                seed=pipe.seed + j, epoch=pipe.epoch,
                scenario_hop=internal,
                # the feed send's bound doubles as the orchestrator's
                # liveness cadence: a blocked submit resurfaces every
                # chunk so the engine can poll worker health instead of
                # wedging on a dead peer
                send_timeout_s=(_FEED_SEND_CHUNK_S if j == 0
                                else pipe.timeout_s),
                codec=pipe.codecs[j - 1] if internal else "none",
                # the result drain hands tensors back to user code
                zero_copy=(j != k),
                sanitize=pipe.sanitize,
                faults=pipe.fault_plan)
            # chaos wraps *outside* the sanitizer: honest traffic stays
            # ledgered while injected wire damage enters below the
            # observation point (see runtime.faults.ChaosChannel)
            group = [maybe_chaos(maybe_sanitize(c), self._chaos_fired).split()
                     for c in trs[chan_names[j]].open_fan(spec, n_lanes)]
            self._groups.append(group)
            self._pairs.extend(group)
        g0, gk = self._groups[0], self._groups[k]
        # the fan dispatch/merge is itself sanitized (when enabled): the
        # merge-level wrapper is what catches a broadcast token returned
        # once per lane instead of once per group
        self._feed = (maybe_sanitize(T.FanOutChannel([p[0] for p in g0]))
                      if len(g0) > 1 else g0[0][0])
        self._result = (maybe_sanitize(T.FanInChannel([p[1] for p in gk]))
                        if len(gk) > 1 else gk[0][1])

        skeleton, state = ship_model(pipe.model)
        flags = numerics()
        child_ctrls = []
        starts = []                           # (offset, start() blocked)
        t_spawn = time.perf_counter()
        for i in range(k):
            for m in range(r[i]):
                parent_c, child_c = self._ctx.Pipe()
                self._ctrls.append(parent_c)
                self._ctrl_stage.append(i)
                self._proc_slot.append((i, m))
                child_ctrls.append(child_c)
                ing = self._groups[i]
                egr = self._groups[i + 1]
                # replica m owns lane m through a replicated region; a
                # solo stage facing a wider group merges in / fans out
                ingress = (ing[m][1] if r[i] > 1
                           else maybe_sanitize(
                               T.FanInChannel([p[1] for p in ing]))
                           if len(ing) > 1 else ing[0][1])
                egress = (egr[m][0] if r[i] > 1
                          else maybe_sanitize(
                              T.FanOutChannel([p[0] for p in egr]))
                          if len(egr) > 1 else egr[0][0])
                spec = {"stage": i, "n_stages": k, "model": skeleton,
                        "state": state, "device": str(pipe.device),
                        "numerics": flags, "bounds": pipe.bounds(),
                        "backend": pipe.backends[i],
                        "ingress": ingress, "egress": egress,
                        "ctrl": child_c, "stop": self._stop,
                        "epoch": pipe.epoch,
                        "pace_s": pipe.stage_pace_s[i]}
                name = (f"edge-worker{i}.{m}" if r[i] > 1
                        else f"edge-worker{i}")
                p = self._ctx.Process(target=T._worker_main, args=(spec,),
                                      daemon=True, name=name)
                spec["t_spawn"] = t = time.perf_counter()
                p.start()
                starts.append((t - t_spawn, time.perf_counter() - t))
                self._procs.append(p)
        # parent's copies of shipped endpoints must go away, or a dead
        # worker's socket never reads as closed downstream
        for c in child_ctrls:
            c.close()
        for j in range(k + 1):
            for pair in self._groups[j]:
                if j != 0:
                    pair[0].close()
                if j != k:
                    pair[1].close()
        split = []
        for w in range(len(self._procs)):
            msg = self._ctrl_recv(w)
            if msg[0] != "ready":
                raise TransportError(
                    f"worker {self._ctrl_stage[w]} failed to start: {msg}")
            split.append({**(msg[2] if len(msg) > 2 else {}),
                          "offset_s": starts[w][0],
                          "start_call_s": starts[w][1]})
        self.standup = {"workers": split,
                        "total_s": time.perf_counter() - t_spawn}

    # ------------------------------------------------------------------ #
    @property
    def nets(self):
        return self._meters

    def _dead_workers(self) -> list[int]:
        dead = [w for w, p in enumerate(self._procs) if not p.is_alive()]
        if not dead:
            self._last_alive = time.perf_counter()
        return dead

    def _raise_dead(self, w: int) -> None:
        raise TransportError(
            f"worker process {w} died (exitcode {self._procs[w].exitcode})")

    def _check_alive(self) -> None:
        dead = self._dead_workers()
        if dead:
            self._raise_dead(dead[0])

    def _ctrl_recv(self, i: int, timeout: float | None = None):
        deadline = time.perf_counter() + (timeout or self.pipe.timeout_s)
        while True:
            if self._ctrls[i].poll(0.05):
                msg = self._ctrls[i].recv()
                if msg[0] == "error":
                    raise TransportError(msg[2])
                return msg
            self._check_alive()
            if time.perf_counter() > deadline:
                raise TransportError(f"worker {i}: control channel timeout")

    def _await(self, expected: int):
        deadline = time.perf_counter() + self.pipe.timeout_s
        while True:
            try:
                kind, obj = self._result.recv(timeout=0.25)
            except TransportTimeout:
                self._check_alive()
                if time.perf_counter() > deadline:
                    raise TransportError(
                        f"timed out waiting for "
                        f"{T._KIND_NAMES[expected]}") from None
                continue
            if kind == ERROR:
                raise TransportError(str(obj))
            if kind == expected:
                return obj
            raise TransportError(
                f"protocol error: got {T._KIND_NAMES[kind]} while waiting "
                f"for {T._KIND_NAMES[expected]}")

    def sync(self) -> dict[int, list[TransferRecord]]:
        """Flush every stage's stats + ingress records to the
        orchestrator; → {hop index: new records} for the scenario hops."""
        self._feed.send(kind=STATS)
        self._await(STATS)
        return self.harvest()

    def harvest(self) -> dict[int, list[TransferRecord]]:
        """The control-pipe half of ``sync``: collect the per-worker
        flushes a ``STATS`` token (already seen at the result end)
        caused.  Every worker — each replica separately — sends its
        control message *before* forwarding the token, so all
        ``sum(replicas)`` messages are in flight by the time the token
        exits the chain.  Replica flushes fold into their logical
        stage's counters and their ingress hop's meter."""
        new: dict[int, list[TransferRecord]] = {}
        for w in range(len(self._ctrls)):
            _, stage, d, mem, records = self._ctrl_recv(w)
            acc = self._stats[stage]
            acc.exe_s += d["exe_s"]
            acc.calls += d["calls"]
            acc.cpu_s += d["cpu_s"]
            acc.mem_pct = max(acc.mem_pct, mem)
            acc.device = d["device"]
            for name, n in d["launches"].items():
                if n:
                    acc.launches[name] = acc.launches.get(name, 0) + n
            if stage > 0:                     # stage i's ingress = hop i-1
                self._meters[stage - 1].extend(records)
                new.setdefault(stage - 1, []).extend(
                    TransferRecord(*r) for r in records)
        return new

    # session primitives: the worker loop is already persistent --------- #
    def session_open(self) -> None:
        pass

    def submit(self, x) -> None:
        seq = self._batch_seq
        self._batch_seq += 1
        if self.supervised:
            self._dead_workers()              # a liveness mark for detect_s
        self._send(x, kind=BATCH)
        # scripted worker-kill faults fire the moment their trigger batch
        # has been fed (pop: each fires exactly once — replays go through
        # _feed.send directly and never re-trigger)
        for ev in self._kills.pop(seq, ()):
            self._inject_kill(ev)

    def _inject_kill(self, ev) -> None:
        for w, slot in enumerate(self._proc_slot):
            if slot == (ev.stage, ev.lane) and self._procs[w].is_alive():
                self._procs[w].kill()         # SIGKILL: no cleanup runs
                return

    def submit_token(self, kind: int, obj=None) -> None:
        self._send(obj, kind=kind)

    def cancel_flush(self) -> None:
        """Out-of-band skip command: a ("cancel",) ctrl message to every
        live worker opens its skip window (batches ahead of the next
        flush CANCEL fence short-circuit compute and travel as empty
        markers).  Best-effort — a worker that misses it just computes
        results the session will drop anyway."""
        for w, c in enumerate(self._ctrls):
            try:
                if self._procs[w].is_alive():
                    c.send(("cancel",))
            except (OSError, ValueError):
                pass                          # dying worker: skip is moot

    def _send(self, payload, kind: int) -> None:
        """Feed send with a liveness loop: a blocked send resurfaces
        every ``_FEED_SEND_CHUNK_S`` as TransportTimeout (nothing
        committed — retryable), the engine checks worker health, and —
        when supervised — recovers instead of raising."""
        deadline = time.perf_counter() + self.pipe.timeout_s
        rev = self._recover_count
        attempts = 0
        while True:
            if (self.supervised and kind == BATCH
                    and self._recover_count != rev):
                # a recovery replayed the session's whole pending window,
                # this batch included — re-sending would duplicate it
                return
            err = None
            try:
                self._feed.send(payload, kind=kind)
                return
            except TransportTimeout:
                pass
            except TransportError as e:
                if not self.supervised:
                    raise
                err = e
            dead = self._dead_workers()
            if not self.supervised:
                if dead:
                    self._raise_dead(dead[0])
                if time.perf_counter() > deadline:
                    raise TransportError(
                        f"feed send blocked for {self.pipe.timeout_s:.0f}s "
                        f"with all workers alive (pipeline wedged)")
                continue
            if dead or err is not None:
                if attempts >= self._backoff.retries:
                    raise err or TransportError(
                        "feed send: recovery retries exhausted")
                time.sleep(self._backoff.delay(attempts))
                attempts += 1
                self._recover(dead, reason="worker-death" if dead
                              else "feed-break")
                continue
            if time.perf_counter() > deadline:
                raise TransportError(
                    f"feed send blocked for {self.pipe.timeout_s:.0f}s "
                    f"with all workers alive (pipeline wedged)")

    def poll(self, timeout: float):
        deadline = time.perf_counter() + timeout
        if not self.supervised:
            while True:
                try:
                    return self._result.recv(timeout=0.25)
                except TransportTimeout:
                    self._check_alive()
                    if time.perf_counter() > deadline:
                        raise
        # supervised: worker death, a worker-reported ERROR, or a stream
        # stalled past the stall window all trigger recovery (bounded by
        # the backoff policy's retry cap) instead of failing the session
        stall = self._stall_window()
        quiet0 = time.perf_counter()
        attempts = 0
        while True:
            failure = None
            try:
                kind, obj = self._result.recv(timeout=0.25)
                if kind != ERROR:
                    # each arrival (like each submit) is a liveness
                    # check too, so a recovery's detect_s runs from the
                    # last sign of life before the failure, not from
                    # the last idle wait
                    self._dead_workers()
                    return kind, obj
                failure = TransportError(str(obj))
            except TransportTimeout:
                pass
            except TransportError as e:
                failure = e
            dead = self._dead_workers()
            now = time.perf_counter()
            if dead or failure is not None or now - quiet0 >= stall:
                if attempts >= self._backoff.retries:
                    raise failure or TransportError(
                        f"stream stalled past {stall:.1f}s and recovery "
                        f"retries are exhausted")
                time.sleep(self._backoff.delay(attempts))
                attempts += 1
                self._recover(dead,
                              reason=("worker-death" if dead else
                                      "worker-error" if failure else "stall"))
                quiet0 = time.perf_counter()
                continue
            if now > deadline:
                raise TransportTimeout("session: no result arrived")

    def _stall_window(self) -> float:
        w = self.pipe.stall_timeout_s
        return w if w is not None else min(self.pipe.timeout_s / 3.0, 10.0)

    def max_inflight(self) -> int | None:
        # the feed channel's depth is what the orchestrator can always
        # stuff without blocking, whatever the workers are doing; a
        # submit window beyond it could park the feed send with the
        # result channel full and nobody pumping
        return max(self.pipe.queue_depth * self.pipe.n_stages, 1)

    def session_close(self, failed: bool = False) -> None:
        pass

    # -- supervised recovery -------------------------------------------- #
    def _rebuild(self) -> None:
        """Tear the worker tier down, spawn it again and replay the
        WARMUP fence to every rebuilt stage."""
        self._teardown_workers()
        self._start(self.pipe.n_stages)
        if self._warm_x is not None:
            self._feed.send(self._warm_x, kind=WARMUP)
            self._await(WARMUP)

    def _recover(self, dead: list[int], reason: str = "worker-death") -> None:
        """Stage restart / replica failover: rebuild the worker tier (at
        r−1 on the failed stage when survivors exist), replay the WARMUP
        fence, then let the Session replay its unacked in-flight
        batches.  Emits one RecoveryRecord per recovery."""
        from .faults import RecoveryRecord, note_recovery
        if self._recovering:
            raise TransportError(
                f"recovery failed while already recovering ({reason})")
        if self._stop.is_set() or self._closed:
            raise TransportError(f"engine closing; {reason} not recovered")
        detect_s = time.perf_counter() - self._last_alive
        self._recovering = True
        try:
            kind, stage, lane = "restart", -1, -1
            if len(dead) == 1:
                stage, lane = self._proc_slot[dead[0]]
                if (self.pipe.replicas[stage]
                        - self._down.get(stage, 0)) > 1:
                    # a replicated stage lost one lane: continue degraded
                    # at r−1, restaff at the next quiescent point, and
                    # tell the controller a device is gone
                    kind = "failover"
                    self._down[stage] = self._down.get(stage, 0) + 1
                    self._restaff_needed = True
                    self._device_loss.append((stage, lane))
            t0 = time.perf_counter()
            self._rebuild()
            restart_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            replayed = self._replay_cb() if self._replay_cb is not None else 0
            replay_s = time.perf_counter() - t1
        finally:
            self._recovering = False
        self._recover_count += 1
        self._last_alive = time.perf_counter()
        eff = self._r_eff()
        note_recovery(RecoveryRecord(
            kind=kind, stage=stage, lane=lane, reason=reason,
            detect_s=detect_s, restart_s=restart_s, replay_s=replay_s,
            batches_replayed=replayed,
            degraded_capacity=min(e / r for e, r
                                  in zip(eff, self.pipe.replicas))))

    def restaff(self) -> None:
        """Return a degraded pipeline to full replica strength — called
        by the Session at a quiescent point (no batches or tokens in
        flight), so the rebuild needs no replay."""
        from .faults import RecoveryRecord, note_recovery
        if not self._restaff_needed or self._recovering or self._closed:
            return
        self._restaff_needed = False
        self._down.clear()
        t0 = time.perf_counter()
        self._recovering = True
        try:
            self._rebuild()
        finally:
            self._recovering = False
        self._recover_count += 1
        self._last_alive = time.perf_counter()
        note_recovery(RecoveryRecord(
            kind="restaff", stage=-1, lane=-1, reason="restaff",
            detect_s=0.0, restart_s=time.perf_counter() - t0,
            replay_s=0.0, batches_replayed=0, degraded_capacity=1.0))

    def drain_device_loss(self) -> list[tuple[int, int]]:
        """(stage, lane) pairs evicted since the last drain — the
        Session forwards them to the controller as device-loss events."""
        out, self._device_loss = self._device_loss, []
        return out

    # ------------------------------------------------------------------ #
    def warmup(self, x):
        self._warm_x = x                      # exemplar for migrate's fence
        self._feed.send(x, kind=WARMUP)
        return self._await(WARMUP)

    def migrate(self) -> None:
        self._feed.send(self.pipe.reconfig_payload(), kind=RECONFIG)
        self._await(RECONFIG)
        # the migration protocol's warm-up fence: a WARMUP must reach
        # every (re)built stage before the next BATCH, so the quiescent
        # path replays the last warmup exemplar in-band — what
        # Session.migrate does for the in-flight path
        if self._warm_x is not None:
            self._feed.send(self._warm_x, kind=WARMUP)
            self._await(WARMUP)

    def probe(self) -> None:
        self._feed.send(kind=PROBE)
        self._await(PROBE)
        self.sync()

    def stage_stats(self) -> list[StageStats]:
        return [dataclasses.replace(s, launches=dict(s.launches))
                for s in self._stats]

    def reset_stats(self) -> None:
        self.sync()                           # flush children first
        self._stats = [StageStats() for _ in range(self.pipe.n_stages)]

    def set_epoch(self, epoch: float) -> None:
        self._feed.send(epoch, kind=CLOCK)
        self._await(CLOCK)
        self._feed.epoch = self._result.epoch = epoch

    def mem_pct(self) -> float:
        """The orchestrator's own share (``mem_pct``); each worker
        reports its stage's with its stats."""
        return mem_pct(self.pipe.device)

    def _teardown_workers(self) -> None:
        """Tear the worker tier down — processes, channel pairs, shmem
        segments, control pipes — leaving the engine ready for a fresh
        ``_start``.  Every step is exception-safe and the state lists are
        cleared, so calling it twice (failed recovery, then close) is
        harmless."""
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        deadline = time.perf_counter() + 3.0
        for p in self._procs:
            p.join(max(deadline - time.perf_counter(), 0.1))
        for p in self._procs:
            if p.is_alive():                  # terminate ignored: escalate
                p.kill()
                p.join(1.0)
        # the workers are gone: reclaim the segments a killed worker
        # never cleaned up — before closing this process's ends, since
        # closing a ring's owning end (the feed's sender, the result
        # drain's receiver) unlinks the control segment whose tables
        # name the slots
        for pair in self._pairs:
            try:
                pair[0].reap()
            except Exception:
                pass
        for pair in self._pairs:              # idempotent; includes feed
            for end in pair:                  # and result ends
                try:
                    end.close()
                except Exception:
                    pass
        for c in self._ctrls:
            try:
                c.close()
            except Exception:
                pass
        self._procs, self._ctrls = [], []
        self._ctrl_stage, self._proc_slot = [], []
        self._pairs, self._groups = [], []
        self._feed = self._result = None

    def close(self) -> None:
        if self._closed:                      # idempotent
            return
        self._closed = True
        self._stop.set()
        if self._feed is not None:
            try:
                self._feed.send(kind=STOP)
            except Exception:
                pass
            deadline = time.perf_counter() + 3.0
            for p in self._procs:             # graceful drain first
                p.join(max(deadline - time.perf_counter(), 0.1))
        self._teardown_workers()


# --------------------------------------------------------------------------- #
class EdgePipeline:
    """Orchestrator (paper Alg. 1, k-stage): split the model at a cut
    vector, deploy one worker per scenario device, stream batches
    through per-hop channels, measure.

    ``model``     — a ``CNNModel``; it is moved to ``device``.
    ``cuts``      — interior cut vector (k-1 ints, strictly increasing),
                    or a single int for the classic 2-stage split.
    ``scenario``  — a ``Scenario`` (device chain + per-hop links), a bare
                    ``Link``/``LinkTrace`` (2-stage convenience), or a
                    sequence of per-hop links.
    ``backend``   — one backend for every stage, or a per-stage sequence.
    ``transport`` — hop transport: ``"emulated"`` (threads, modeled
                    wire), ``"socket"`` or ``"shmem"`` (worker
                    processes, measured wire), or a per-hop sequence;
                    defaults to the scenario's ``transports`` else
                    ``"emulated"``.  ``"emulated"`` cannot mix with
                    process transports.
    ``device``    — where every stage computes and every codec packs:
                    ``cuda`` unless the caller passes another device.
    ``sanitize``  — check every hop's token protocol
                    (``runtime.sanitizer``); default: the
                    ``REPRO_SANITIZE`` environment variable.
    ``fault_plan`` — a ``runtime.faults.FaultPlan`` of scripted faults
                    (process transports only).
    ``supervise`` — recover from worker death, worker errors and stalls
                    instead of raising (default: on iff a fault plan is
                    given; process transports only).
    ``stall_timeout_s`` — how long a supervised stream may go without a
                    result before it counts as stalled (default
                    ``min(timeout_s / 3, 10)``).

    The legacy 2-stage keywords ``p=`` and ``link=`` are still accepted.
    Process-backed pipelines hold OS resources — ``close()`` them (or
    use the pipeline as a context manager).
    """

    def __init__(self, model, cuts=None, scenario=None,
                 backend: Backend | Sequence[Backend] = "lightweight",
                 transport: str | Sequence[str] | None = None,
                 codec: str | Sequence[str] | None = None,
                 *, p: int | None = None, link: AnyLink | None = None,
                 queue_depth: int = 2, clock: Callable[[], float] | None = None,
                 seed: int = 0, timeout_s: float = 180.0,
                 replicas: Sequence[int] | None = None,
                 stage_pace_s: "float | Sequence[float] | None" = None,
                 device=None, sanitize: bool | None = None,
                 fault_plan=None, supervise: bool | None = None,
                 stall_timeout_s: float | None = None):
        if p is not None:
            cuts = p
        if link is not None:
            scenario = link
        if cuts is None:
            raise ValueError("need a cut vector (cuts=... or p=...)")
        if scenario is None:
            raise ValueError("need a Scenario, per-hop links, or link=...")

        if isinstance(scenario, Scenario):
            self.scenario: Scenario | None = scenario
            links: tuple[AnyLink, ...] = tuple(scenario.links)
        elif isinstance(scenario, (Link, LinkTrace)):
            self.scenario = None
            links = (scenario,)
        else:
            self.scenario = None
            links = tuple(scenario)

        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.links = links
        self.n_stages = len(links) + 1
        if isinstance(backend, str):
            self.backends: tuple[Backend, ...] = (backend,) * self.n_stages
        else:
            self.backends = tuple(backend)
            if len(self.backends) != self.n_stages:
                raise ValueError(f"{len(self.backends)} backends for "
                                 f"{self.n_stages} stages")

        # per-hop transports: explicit arg > scenario.transports > emulated
        if transport is None:
            transport = (self.scenario.transports
                         if self.scenario is not None
                         and self.scenario.transports is not None
                         else "emulated")
        n_hops = max(self.n_stages - 1, 1)
        if isinstance(transport, str):
            names = (transport,) * n_hops
        else:
            names = tuple(transport)
            if len(names) != n_hops:
                raise ValueError(f"{len(names)} transports for {n_hops} hops")
        # unknown / unported transports raise here
        process_based = {n: get_transport(n).process_based for n in set(names)}
        if len(set(process_based.values())) > 1:
            raise ValueError(
                f"cannot mix the in-process 'emulated' transport with "
                f"process transports in one pipeline: {names}")
        if any(process_based.values()):
            # a measured channel cannot follow a schedule; silently
            # ignoring the trace would mislabel results as degraded
            traced = [l.name for l in links if isinstance(l, LinkTrace)]
            if traced:
                raise ValueError(
                    f"LinkTrace hops {traced} need the 'emulated' "
                    f"transport — real {sorted(set(names))} channels "
                    f"measure the wire, they cannot replay a schedule")
        self.transport_names = names
        self.transports = names[:self.n_stages - 1]   # () for k == 1

        # per-hop wire codecs: explicit arg > scenario.codecs > "none"
        if codec is None:
            codec = (self.scenario.codecs
                     if self.scenario is not None
                     and self.scenario.codecs is not None
                     else "none")
        n_real_hops = self.n_stages - 1
        if isinstance(codec, str):
            codecs = (codec,) * n_real_hops
        else:
            codecs = tuple(codec)
            if len(codecs) != n_real_hops:
                raise ValueError(f"{len(codecs)} codecs for "
                                 f"{n_real_hops} hops")
        from ..core.codecs import get_codec as _get_codec
        self.codecs = tuple(_get_codec(c).name for c in codecs)

        # per-stage replica counts: stage i runs as replicas[i] workers,
        # batches striped round-robin across them.  Fixed for the
        # pipeline's lifetime — migration re-cuts stages, it never
        # re-staffs them.
        k = self.n_stages
        if replicas is None:
            self.replicas: tuple[int, ...] = (1,) * k
        else:
            self.replicas = tuple(int(x) for x in replicas)
            if len(self.replicas) != k:
                raise ValueError(f"{len(self.replicas)} replica counts for "
                                 f"{k} stages")
            if any(x < 1 for x in self.replicas):
                raise ValueError(f"replica counts must be >= 1: "
                                 f"{self.replicas}")
        for a, b in zip(self.replicas, self.replicas[1:]):
            if a != b and min(a, b) != 1:
                raise ValueError(
                    f"adjacent replicated stages need equal counts (r "
                    f"parallel lanes) or a solo stage between fan-out "
                    f"and fan-in: {self.replicas}")

        # per-stage wall-time floor (device-speed emulation; see Worker)
        if stage_pace_s is None:
            self.stage_pace_s: tuple[float, ...] = (0.0,) * k
        elif isinstance(stage_pace_s, (int, float)):
            self.stage_pace_s = (float(stage_pace_s),) * k
        else:
            self.stage_pace_s = tuple(float(t) for t in stage_pace_s)
            if len(self.stage_pace_s) != k:
                raise ValueError(f"{len(self.stage_pace_s)} stage paces "
                                 f"for {k} stages")

        self.queue_depth = queue_depth
        self.timeout_s = timeout_s
        self.seed = seed
        # protocol sanitizer (runtime.sanitizer): explicit arg wins,
        # REPRO_SANITIZE=1 turns it on fleet-wide
        self.sanitize = sanitize_enabled(sanitize)
        # fault tolerance (runtime.faults): a FaultPlan scripts injected
        # failures; supervise turns on the _ProcessEngine supervisor —
        # on by default whenever a plan is given
        self.fault_plan = fault_plan
        self.supervise = (bool(supervise) if supervise is not None
                          else fault_plan is not None)
        self.stall_timeout_s = stall_timeout_s
        if ((self.fault_plan is not None or self.supervise)
                and not any(process_based.values())):
            raise ValueError(
                "fault injection / supervised recovery need a process "
                "transport (socket or shmem) — the emulated transport "
                "has no worker processes to kill or restart")
        self._t0 = time.perf_counter()
        self.epoch = self._t0
        self.clock = clock or (lambda: time.perf_counter() - self._t0)
        self.migrations: list[tuple[float, tuple[int, ...], tuple[int, ...]]] = []
        self.migration_costs_j: list[float] = []   # parallel to migrations
        self._session = None                  # the live Session, if any
        self.cuts = self._check_cuts(cuts)
        self._engine = (_ProcessEngine(self)
                        if any(process_based.values()) else
                        _ThreadEngine(self))

    # ------------------------------------------------------------------ #
    def _check_cuts(self, cuts) -> tuple[int, ...]:
        n = len(self.model.blocks)
        if isinstance(cuts, int):
            cuts = (cuts,)
        cuts = tuple(int(c) for c in cuts)
        if len(cuts) != self.n_stages - 1:
            raise ValueError(f"{len(cuts)} cuts for {self.n_stages} stages; "
                             f"need {self.n_stages - 1}")
        bounds = (0, *cuts, n)
        for a, b in zip(bounds, bounds[1:]):
            if not (0 <= a < b <= n):
                raise ValueError(f"cuts {cuts} invalid for {n} blocks "
                                 "(stages must be non-empty and ordered)")
        return cuts

    def bounds(self) -> tuple[int, ...]:
        return (0, *self.cuts, len(self.model.blocks))

    def reconfig_payload(self) -> dict:
        """The in-band RECONFIG message: stage bounds plus the per-hop
        codec vector (workers re-split on the former and retune their
        egress codec from the latter)."""
        return {"bounds": self.bounds(), "codecs": self.codecs}

    # observation surface + legacy accessors ---------------------------- #
    @property
    def nets(self):
        """Per-hop observation surface: one object per hop with
        ``.link``/``drain_observations()``/``total_bytes``/
        ``total_energy_j``."""
        return self._engine.nets

    @property
    def workers(self) -> list[Worker]:
        if not isinstance(self._engine, _ThreadEngine):
            raise AttributeError("workers live in their own processes under "
                                 f"transport={self.transport!r}")
        return self._engine.workers

    @property
    def p(self) -> int:
        return self.cuts[0]

    @property
    def backend(self) -> str:
        return "+".join(sorted(set(self.backends)))

    @property
    def transport(self) -> str:
        return "+".join(sorted(set(self.transport_names)))

    def reset_clock(self) -> None:
        """Restart the pipeline clock (trace time 0) — call before a run
        that should experience a LinkTrace from its beginning."""
        self._assert_idle("reset_clock")
        self._t0 = time.perf_counter()
        self.epoch = self._t0
        self._engine.set_epoch(self._t0)

    def _assert_idle(self, what: str) -> None:
        if self._session is not None and not self._session.closed:
            raise RuntimeError(
                f"{what}() needs the pipeline to itself, but a Session is "
                f"open — drive the stream through the session (or close "
                f"it) instead")

    # the streaming entrypoint ------------------------------------------ #
    def session(self, controller=None, *, inflight: int | None = None,
                policy: str = "drain", window: int = 16,
                keep_results: bool = True, record_cap: int | None = None):
        """Open a streaming :class:`~repro_torch.runtime.session.Session`
        — the one always-pipelined entrypoint ``run_one``/``stream`` are
        shims over.

        ``controller`` — a ``Controller`` (default ``PinnedController``:
        record, never migrate); ``inflight`` — max batches in the
        pipeline at once (default ``queue_depth × n_stages``);
        ``policy`` — mid-stream migration policy, ``"drain"`` (flush
        first) or ``"drop"`` (in-band ``RECONFIG`` chases the in-flight
        batches); ``keep_results=False`` discards outputs (throughput
        runs)."""
        self._assert_idle("session")
        from .session import Session
        return Session(self, controller, inflight=inflight, policy=policy,
                       window=window, keep_results=keep_results,
                       record_cap=record_cap)

    def _note_migration(self, new_cuts: tuple[int, ...],
                        cost_j: float = 0.0) -> None:
        """Shared migration bookkeeping (sessions reconfigure in-band
        and only need the log + cut flip)."""
        self.migrations.append((self.clock(), self.cuts, new_cuts))
        self.cuts = new_cuts
        self.migration_costs_j.append(cost_j)

    # lifecycle --------------------------------------------------------- #
    def close(self) -> None:
        """Close a live session, if any, and tear down worker processes
        and channels (threads hold no OS resources)."""
        if self._session is not None and not self._session.closed:
            try:
                self._session.close()
            except Exception:
                pass
        self._engine.close()

    def __enter__(self) -> "EdgePipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ #
    def migrate(self, new_cuts, cost_s: float = 0.0,
                codecs: Sequence[str] | None = None) -> tuple[int, ...]:
        """Live migration: re-deploy the workers at ``new_cuts``.

        ``cost_s`` is the one-off redeploy cost (weights moving to their
        new hosts) charged as wall-clock time.  ``codecs`` optionally
        retunes the per-hop wire codecs in the same reconfiguration.
        Hop state (clock, traces, observations) survives the migration.

        This is the *quiescent* path; mid-stream migration (batches in
        flight) goes through ``Session.migrate`` with an explicit
        drain-vs-drop policy."""
        self._assert_idle("migrate")
        new_cuts = self._check_cuts(new_cuts)
        if codecs is not None:
            from ..core.codecs import get_codec as _get_codec
            codecs = tuple(_get_codec(c).name for c in codecs)
            if len(codecs) != self.n_stages - 1:
                raise ValueError(f"{len(codecs)} codecs for "
                                 f"{self.n_stages - 1} hops")
            self.codecs = codecs
        if cost_s > 0.0:
            time.sleep(cost_s)
        self._note_migration(new_cuts)
        self._engine.migrate()
        return self.cuts

    # ------------------------------------------------------------------ #
    def warmup(self, x):
        self._assert_idle("warmup")
        return self._engine.warmup(x)

    def probe(self) -> None:
        """Send a header-only message down every hop: emulated hops
        charge RTT/2 — a compute-free RTT sample (an nbytes=0
        observation) for the estimators."""
        self._assert_idle("probe")
        self._engine.probe()

    def stage_stats(self) -> list[StageStats]:
        """Per-stage compute counters (snapshot)."""
        return self._engine.stage_stats()

    def _reset_stats(self) -> None:
        self._engine.reset_stats()

    def run_one(self, x) -> tuple[torch.Tensor, float, tuple[float, ...]]:
        """One batch through the empty pipeline →
        (out, end-to-end latency, per-hop wire times).

        Compatibility shim: a lone batch is a one-deep Session."""
        self._assert_idle("run_one")
        wire0 = [(n.total_transfers, n.total_elapsed_s) for n in self.nets]
        with self.session(inflight=1) as s:
            seq = s.submit(x)
            (y,) = s.drain()
            s.checkpoint(probe=False)
            latency = s.latency_of(seq)
        hop_net = tuple(
            (n.total_elapsed_s - e0) / max(n.total_transfers - t0, 1)
            for n, (t0, e0) in zip(self.nets, wire0))
        return y, latency, hop_net

    def stream(self, x, n_batches: int) -> float:
        """Push ``n_batches`` copies of ``x`` through all stages
        concurrently (bounded in-flight window) → total wall time."""
        self._assert_idle("stream")
        with self.session(keep_results=False) as s:
            t0 = time.perf_counter()
            for _ in range(n_batches):
                s.submit(x)
            s.drain()
            total = time.perf_counter() - t0
            s.checkpoint(probe=False)
        return total

    def stage_energy_model(self, stage_exe_s: Sequence[float],
                           hop_net_s: Sequence[float],
                           hop_bytes: Sequence[float],
                           ) -> tuple[float, tuple[float, ...]]:
        """Modeled J/batch from measured per-stage compute times: device
        active power × exe, idle power while its outbound hop drains, and
        each hop's radio cost × bytes.  Needs a Scenario (device power
        profiles); bare-link pipelines report 0."""
        if self.scenario is None:
            return 0.0, ()
        from ..core.costmodel import _stage_energy
        nets = self.nets
        per_stage = tuple(
            _stage_energy(dev, stage_exe_s[i],
                          hop_net_s[i] if i < len(hop_net_s) else 0.0,
                          hop_bytes[i] if i < len(hop_bytes) else 0.0,
                          nets[i].link if i < len(nets) else None)
            for i, dev in enumerate(self.scenario.devices))
        return sum(per_stage), per_stage

    # ------------------------------------------------------------------ #
    def measure(self, make_batch: Callable[[], torch.Tensor],
                n_batches: int = 10, warmup: int = 1) -> PipelineResult:
        self._assert_idle("measure")
        x = make_batch()
        self.warmup(x)
        self._reset_stats()
        # warmup (cuDNN set-up, first kernel builds) can take seconds —
        # restart trace time so a LinkTrace scenario is measured from
        # its beginning, not mid-ramp
        self.reset_clock()

        # --- latency: lone batches ---------------------------------- #
        lat: list[float] = []
        hop_t: list[tuple[float, ...]] = []
        for _ in range(max(warmup, 1)):
            self.run_one(x)
        bytes0 = [net.total_bytes for net in self.nets]
        for _ in range(max(n_batches // 3, 2)):
            _, l, hops = self.run_one(x)
            lat.append(l)
            hop_t.append(hops)
        hop_bytes = [(net.total_bytes - b0) / len(lat)
                     for net, b0 in zip(self.nets, bytes0)]
        # per-worker host CPU utilisation while executing (lone batches
        # run stages one at a time, so attribution is exact)
        lat_stats = self.stage_stats()
        cpu_pct = tuple(100.0 * s.cpu_s / max(s.exe_s, 1e-9)
                        for s in lat_stats)

        # --- throughput: streamed, stages overlap -------------------- #
        self._reset_stats()
        self.reset_clock()
        total = self.stream(x, n_batches)
        stats = self.stage_stats()
        batch = x.shape[0]
        hop_net = tuple(float(np.mean([h[i] for h in hop_t]))
                        for i in range(len(self.nets)))
        stage_exe = tuple(s.exe_s / max(s.calls, 1) for s in stats)
        mem = self._engine.mem_pct()
        mem_pct = tuple(s.mem_pct if s.mem_pct > 0 else mem for s in stats)
        energy, stage_energy = self.stage_energy_model(stage_exe, hop_net,
                                                       hop_bytes)
        return PipelineResult(
            backend=self.backend, partition=self.cuts,
            latency_s=float(np.mean(lat)),
            throughput=n_batches * batch / total,
            stage_exe_s=stage_exe,
            net_s=float(sum(hop_net)),
            hop_net_s=hop_net,
            cpu_pct=cpu_pct,
            mem_pct=mem_pct,
            energy_j=energy,
            stage_energy_j=stage_energy,
            transport=self.transport,
            replicas=(self.replicas if any(r > 1 for r in self.replicas)
                      else ()),
        )
