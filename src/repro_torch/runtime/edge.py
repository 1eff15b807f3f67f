"""Executable ParetoPipe pipeline — k-stage orchestrator + workers
(paper Fig. 1 / Alg. 1, generalized past the paper's 2-device testbed).

This is the *measured* half of the reproduction: a real partitioned
pipeline, one worker per stage executing its contiguous block range
``[cuts[i], cuts[i+1])`` on the pipeline's device, with the hop layer
behind the Transport API (``runtime.transport``).  The port runs the
``emulated`` transport: stages are threads, every hop an
``EmulatedChannel`` (tc-style: RTT/2 + bytes/bw injected as wall-clock
delay, static ``Link`` or time-varying ``LinkTrace`` sampled at the
pipeline clock per transfer), and each hop's wire codec packs and
unpacks on the card with the CUDA kernels.  The reference's worker-
process transports (``socket``/``shmem``), its protocol sanitizer and
its fault injection are not ported yet (ROADMAP queue 1, item 6) and
raise ``NotImplementedError``.

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
``measure`` reports both.  A stage's wall time is read after
``torch.cuda.synchronize``, so it covers the device work, not only its
enqueue.
"""
from __future__ import annotations

import os
import queue
import resource
import threading
import time
from dataclasses import dataclass
from typing import Callable, Literal, Sequence

import numpy as np
import torch

from ..core.devices import AnyLink, Link, LinkTrace
from ..core.scenarios import Scenario
from ..models.cnn.zoo import resolve_device
from . import transport as T
from .transport import (BATCH, CANCEL, CLOCK, PROBE, RECONFIG, STATS, STOP,
                        WARMUP, ERROR, HopSpec, TransferRecord,
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


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Worker:
    """One pipeline stage: executes blocks[lo:hi] of a CNNModel on
    ``device``.  Inputs arriving elsewhere (an rpc round trip, a caller's
    host tensor) are moved to the stage's device first.

    ``cpu_clock`` attributes host CPU time to this worker (default
    ``process_time``); under threads the attribution is exact whenever
    stages run one at a time (the latency phase), which is where
    ``measure`` reads it."""

    def __init__(self, name: str, model, lo: int, hi: int, backend: Backend,
                 device: torch.device,
                 cpu_clock: Callable[[], float] | None = None,
                 pace_s: float = 0.0):
        self.name, self.lo, self.hi, self.backend = name, lo, hi, backend
        self.device = device
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

    def warmup(self, x):
        x = self._forward(x)
        _synchronize(self.device)
        return x

    def run(self, x):
        t0 = time.perf_counter()
        c0 = self._cpu_clock()
        x = self._forward(x)
        _synchronize(self.device)
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
        self._q.put((kind, payload))

    def recv(self, timeout: float | None = None):
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            raise TransportTimeout("session: no result arrived") from None

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
            tr.open_fan(HopSpec(index=i, link=link,
                                framing=("pickle" if pipe.backends[i] == "rpc"
                                         else "raw"),
                                depth=pipe.queue_depth, seed=pipe.seed + i,
                                codec=pipe.codecs[i]),
                        max(r[i], r[i + 1]))
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

    def _new_worker(self, i: int, lo: int, hi: int) -> Worker:
        pipe = self.pipe
        return Worker(f"worker{i + 1}", pipe.model, lo, hi, pipe.backends[i],
                      pipe.device, pace_s=pipe.stage_pace_s[i])

    def _build_workers(self, reuse: Sequence[Worker] = ()) -> None:
        """Instantiate stage workers, reusing any existing worker whose
        (block range, backend) is unchanged."""
        pipe = self.pipe
        pool: dict[tuple, list[Worker]] = {}
        for w in reuse:
            pool.setdefault((w.lo, w.hi, w.backend), []).append(w)
        bounds = pipe.bounds()
        self.stage_workers = []
        for i in range(pipe.n_stages):
            key = (bounds[i], bounds[i + 1], pipe.backends[i])
            ws = []
            for m in range(pipe.replicas[i]):
                cached = pool[key].pop() if pool.get(key) else None
                ws.append(cached or self._new_worker(i, bounds[i],
                                                     bounds[i + 1]))
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
            try:
                # bounded wait (pipecheck R6): a wedged upstream must not
                # park this thread beyond the doorbell cadence
                kind, obj = ingress.recv(timeout=1.0)
            except TransportTimeout:
                continue
            if kind == STOP:
                egress.send(None, kind=STOP)
                return
            if failed:                        # drain so upstream never
                continue                      # blocks on a full queue
            try:
                if kind == BATCH:
                    if obj is None or fence_seen < self._cancel_epoch:
                        egress.send(None, kind=BATCH)  # canceled: marker
                    else:
                        egress.send(self.stage_workers[i][m].run(obj),
                                    kind=BATCH)
                elif kind == CANCEL:
                    if obj:
                        fence_seen += 1
                    egress.send(obj, kind=CANCEL)
                elif kind == WARMUP:
                    egress.send(self.stage_workers[i][m].warmup(obj),
                                kind=WARMUP)
                elif kind == RECONFIG:
                    if isinstance(obj, dict):   # {"bounds":…, "codecs":…}
                        bounds = tuple(obj["bounds"])
                        codecs = obj.get("codecs")
                    else:                       # legacy bare bounds tuple
                        bounds, codecs = tuple(obj), None
                    w = self.stage_workers[i][m]
                    if (bounds[i], bounds[i + 1]) != (w.lo, w.hi):
                        self.stage_workers[i][m] = self._new_worker(
                            i, bounds[i], bounds[i + 1])
                    if codecs is not None and not last:
                        egress.set_codec(codecs[i])
                    egress.send(obj, kind=RECONFIG)
                elif kind == PROBE:
                    egress.send(None, kind=PROBE)  # emulates 0 bytes per hop
                elif kind in (STATS, CLOCK):  # pass-through tokens
                    egress.send(obj, kind=kind)
                else:
                    # ERROR never originates upstream of a thread stage
                    # (errors ride self._err), so any other kind is a
                    # protocol break — fail loudly instead of silently
                    # forwarding (pipecheck R1)
                    raise TransportError(
                        f"stage {i}.{m}: unexpected "
                        f"{T._KIND_NAMES[kind] if 0 <= kind < len(T._KIND_NAMES) else kind} "
                        f"token in session stream")
            except BaseException as e:        # noqa: BLE001 — reported
                failed = True
                # ship the exception object itself, so the session
                # re-raises the caller's own type with its traceback; a
                # dedicated error queue keeps lane ordering intact
                self._err.put((ERROR, e))

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
        """Memory share of the pipeline's device: PyTorch's reserved
        pool over the card's memory on CUDA, peak resident set over
        physical memory on the CPU."""
        dev = self.pipe.device
        if dev.type == "cuda":
            total = torch.cuda.get_device_properties(dev).total_memory
            return 100.0 * torch.cuda.memory_reserved(dev) / total
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        phys = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        return 100.0 * rss / phys

    def close(self) -> None:
        pass


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
    ``transport`` — ``"emulated"`` (threads, modeled wire); the
                    reference's ``"socket"``/``"shmem"`` are not ported
                    yet and raise ``NotImplementedError``.
    ``device``    — where every stage computes and every codec packs:
                    ``cuda`` unless the caller passes another device.

    The legacy 2-stage keywords ``p=`` and ``link=`` are still accepted.
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
                 fault_plan=None):
        if sanitize or fault_plan is not None:
            raise NotImplementedError(
                "the protocol sanitizer and fault injection are not ported "
                "yet (ROADMAP queue 1, item 6)")
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
        for n in set(names):
            get_transport(n)                  # unknown / unported: raise
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
        self._t0 = time.perf_counter()
        self.epoch = self._t0
        self.clock = clock or (lambda: time.perf_counter() - self._t0)
        self.migrations: list[tuple[float, tuple[int, ...], tuple[int, ...]]] = []
        self.migration_costs_j: list[float] = []   # parallel to migrations
        self._session = None                  # the live Session, if any
        self.cuts = self._check_cuts(cuts)
        self._engine = _ThreadEngine(self)

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
        """Close a live session, if any (threads hold no OS resources)."""
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
