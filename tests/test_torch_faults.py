"""The port's fault layer (``repro_torch.runtime.faults``) and its
supervisor on the CPU, case for case with the reference's
``tests/test_faults.py``: plan methods and views, the pinned backoff
schedule, fan-lane eviction, chaos fire-once semantics, bounded sends,
liveness without a supervisor, teardown after a recovery, the shmem leak
check after a SIGKILLed replica, and recovery timings.  The fault matrix
is in ``test_torch_faults_matrix_*.py``, the wire damage in
``test_torch_faults_wire.py``.

Outputs are held to the reference's ``CNNModel.apply`` within 1e-5
(``_torch_tiny``).  One case holds the port's ``ChaosChannel`` to the
reference's: the same plan fires the same injections and delivers the
same frames.
"""
import os
import time

import pytest
import torch
from _torch_tiny import batches, check, run_with_plan, tiny_models

from repro.runtime import edge as RE
from repro.runtime import faults as RF
from repro.runtime import transport as RT
from repro_torch.core import scenarios
from repro_torch.core.devices import LAN_PI_GPU
from repro_torch.runtime import (BackoffPolicy, EdgePipeline, FaultPlan,
                                 TransportError, TransportTimeout,
                                 drain_injections, drain_recoveries,
                                 get_transport)
from repro_torch.runtime.edge import _ProcessEngine, _QueueChan
from repro_torch.runtime.faults import ChaosChannel, FaultEvent
from repro_torch.runtime.transport import (BATCH, FanInChannel, FanOutChannel,
                                           HopSpec)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    return tiny_models()


# --------------------------------------------------------------------------- #
# FaultPlan / FaultEvent units
# --------------------------------------------------------------------------- #
def test_fault_plan_methods_compose_and_views_split():
    plan = (FaultPlan(seed=7)
            .kill_worker(stage=1, at_seq=4, lane=1)
            .stall(hop=-1, at_seq=2, for_s=0.3)
            .drop(hop=0, at_seq=5)
            .duplicate(hop=-1, at_seq=2)
            .flap(hop=-1, at_seq=6, down_s=0.5)
            .corrupt(hop=0, at_seq=1))
    assert len(plan.events) == 6
    feed = plan.channel_events(-1)
    assert sorted(feed) == [2, 6]
    assert [e.kind for e in feed[2]] == ["frame-stall", "frame-dup"]
    hop0 = plan.channel_events(0)
    assert sorted(hop0) == [1, 5]
    kills = plan.kill_events()
    assert list(kills) == [4]
    assert (kills[4][0].stage, kills[4][0].lane) == (1, 1)
    # the methods are pure: the intermediate plans are untouched
    assert FaultPlan(seed=7).events == ()


def test_fault_plan_is_picklable_and_frozen():
    import pickle
    plan = FaultPlan(seed=3).drop(hop=-1, at_seq=2)
    clone = pickle.loads(pickle.dumps(plan))
    assert clone == plan
    with pytest.raises(Exception):
        plan.seed = 9                         # frozen dataclass


def test_fault_event_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultEvent("brownout")


def test_named_fault_plans_registry():
    for name in scenarios.FAULT_PLANS:
        plan = scenarios.get_fault_plan(name)
        assert isinstance(plan, FaultPlan) and plan.events
    with pytest.raises(KeyError, match="unknown fault plan"):
        scenarios.get_fault_plan("nope")


def test_fault_plans_need_a_process_transport(models):
    _, _, port = models
    with pytest.raises(ValueError, match="process transport"):
        EdgePipeline(port, 2, [LAN_PI_GPU], device="cpu",
                     fault_plan=FaultPlan().kill_worker(stage=1, at_seq=0))
    with pytest.raises(ValueError, match="process transport"):
        EdgePipeline(port, 2, [LAN_PI_GPU], device="cpu", supervise=True)


# --------------------------------------------------------------------------- #
# BackoffPolicy: the pinned retry schedule and caps
# --------------------------------------------------------------------------- #
def test_backoff_schedule_is_pinned():
    p = BackoffPolicy()
    assert p.schedule() == (0.05, 0.1, 0.2, 0.4, 0.8)
    assert p.retries == 5                     # the supervisor's retry cap
    assert p.delay(10) == p.cap_s == 2.0      # bounded, never unbounded
    assert len(p.schedule()) == p.retries


# --------------------------------------------------------------------------- #
# Fan-lane eviction (in-process units)
# --------------------------------------------------------------------------- #
def _queue_lanes(n):
    return [_QueueChan() for _ in range(n)]


def _drain_lane(lane):
    got = []
    while True:
        try:
            got.append(lane.recv(timeout=0.01))
        except Exception:
            return got


def test_fanout_evict_lane_restripes_survivors():
    lanes = _queue_lanes(3)
    out = FanOutChannel(lanes)
    out.evict_lane(1)
    for i in range(4):
        out.send(i, kind=BATCH)
    assert [v for _, v in _drain_lane(lanes[0])] == [0, 2]
    assert [v for _, v in _drain_lane(lanes[2])] == [1, 3]
    assert _drain_lane(lanes[1]) == []        # dead lane gets nothing


def test_fanin_evict_lane_preserves_merge_order():
    lanes = _queue_lanes(2)
    out, inn = FanOutChannel(lanes), FanInChannel(lanes)
    out.evict_lane(1)
    inn.evict_lane(1)
    for i in range(4):
        out.send(i, kind=BATCH)
    got = [inn.recv(timeout=1.0)[1] for _ in range(4)]
    assert got == [0, 1, 2, 3]


def test_evict_last_lane_is_refused():
    out = FanOutChannel(_queue_lanes(1))
    with pytest.raises(ValueError):
        out.evict_lane(0)
    with pytest.raises(IndexError):
        FanOutChannel(_queue_lanes(2)).evict_lane(5)


# --------------------------------------------------------------------------- #
# Chaos fire-once semantics, and parity with the reference's chaos layer
# --------------------------------------------------------------------------- #
def test_chaos_events_fire_exactly_once_across_rebuilds():
    drain_injections()
    plan = FaultPlan().drop(hop=0, at_seq=1)
    fired: set = set()
    for rebuild in range(2):                  # same fired set, fresh chan
        inner = _QueueChan()
        inner.hop = HopSpec(index=0, faults=plan)
        chaos = ChaosChannel(inner, fired=fired)
        for i in range(3):
            chaos.send(i, kind=BATCH)
        got = [v for _, v in _drain_lane(inner)]
        if rebuild == 0:
            assert got == [0, 2]              # seq 1 swallowed
        else:
            assert got == [0, 1, 2]           # replay: not re-perturbed
    assert [i.kind for i in drain_injections()] == ["frame-drop"]


def _scripted(pkg):
    """One plan touching every frame-level fault kind on hop 0."""
    return (pkg.FaultPlan(seed=9)
            .stall(hop=0, at_seq=1, for_s=0.01)
            .drop(hop=0, at_seq=2)
            .duplicate(hop=0, at_seq=3)
            .corrupt(hop=0, at_seq=4)
            .flap(hop=0, at_seq=5, down_s=0.01)
            .duplicate(hop=1, at_seq=0)       # another hop: never fires
            .kill_worker(stage=0, at_seq=1))  # the supervisor's, not chaos'


def test_chaos_channel_fires_what_the_reference_fires():
    """The same plan through each package's ChaosChannel over a queue
    channel: the same injections (kind, hop, seq) in the same order, and
    the same frames (kind, payload) reach the inner channel — a plain
    re-send for the duplicate (a queue has no wire seq), the corrupt
    kind byte for the damaged header, nothing for the drop."""
    from repro.runtime.transport import HopSpec as RHopSpec
    from repro_torch.runtime import faults as F
    runs = []
    for pkg, chan, hop in ((RF, RE._QueueChan, RHopSpec), (F, _QueueChan,
                                                           HopSpec)):
        pkg.drain_injections()
        inner = chan()
        inner.hop = hop(index=0, faults=_scripted(pkg))
        chaos = pkg.maybe_chaos(inner, set())
        assert isinstance(chaos, pkg.ChaosChannel)
        for i in range(7):
            chaos.send(i, kind=BATCH)
            chaos.send(None, kind=RT.PROBE)   # control kinds never count
        frames = [(k, v) for k, v in _drain_lane(inner)]
        runs.append(([(i.kind, i.hop, i.seq) for i in pkg.drain_injections()],
                     frames))
    assert runs[0] == runs[1]
    injections, frames = runs[1]
    assert [k for k, _, _ in injections] == [
        "frame-stall", "frame-drop", "frame-dup", "header-corrupt",
        "link-flap"]
    assert (F.CORRUPT_KIND, 4) in frames and (BATCH, 2) not in frames
    assert frames.count((BATCH, 3)) == 2


# --------------------------------------------------------------------------- #
# TransportTimeout send bounds (no peer draining)
# --------------------------------------------------------------------------- #
def test_shmem_send_times_out_when_receiver_not_draining():
    chan = get_transport("shmem").open(
        HopSpec(index=0, depth=1, send_timeout_s=0.2))
    try:
        with pytest.raises(TransportTimeout, match="not draining"):
            # payloads big enough to claim real slots (not inlined):
            # depth+1 slots are never recycled without a receiver
            for _ in range(8):
                chan.send(torch.zeros(100_000), kind=BATCH)
    finally:
        chan.close()


def test_socket_send_is_bounded_when_peer_not_draining():
    chan = get_transport("socket").open(
        HopSpec(index=0, send_timeout_s=0.2))
    try:
        # far larger than loopback socket buffers: the vectored send
        # cannot complete without a reader, and must not hang
        with pytest.raises(TransportError):
            chan.send(torch.zeros(16 << 20, dtype=torch.uint8), kind=BATCH)
    finally:
        chan.close()


# --------------------------------------------------------------------------- #
# Liveness: dead workers must fail fast, not hang
# --------------------------------------------------------------------------- #
def test_unsupervised_submit_fails_fast_when_workers_die(models):
    _, _, port = models
    x = torch.from_numpy(batches(1)[0])
    pipe = EdgePipeline(port, 2, [LAN_PI_GPU], transport="shmem",
                        timeout_s=60, device="cpu")
    with pipe:
        pipe.warmup(x)
        eng = pipe._engine
        for p in eng._procs:
            p.kill()
        for p in eng._procs:
            p.join(10)
        t0 = time.perf_counter()
        with pytest.raises(TransportError, match="died"):
            for _ in range(64):               # ring fills; send must not hang
                eng.submit(x)
        assert time.perf_counter() - t0 < 30  # bounded by liveness polling


# --------------------------------------------------------------------------- #
# Teardown idempotence and shmem hygiene after SIGKILL
# --------------------------------------------------------------------------- #
def test_close_is_idempotent_after_recovery(models):
    drain_recoveries()
    outs, refs = run_with_plan(
        models, "shmem", FaultPlan().kill_worker(stage=1, at_seq=2), n=4)
    check(outs, refs, "shmem/kill")
    assert [r.kind for r in drain_recoveries()] == ["restart"]


def test_double_close_and_close_with_inflight(models):
    _, _, port = models
    xs = [torch.from_numpy(x) for x in batches(3)]
    pipe = EdgePipeline(port, 2, [LAN_PI_GPU], transport="shmem",
                        supervise=True, timeout_s=60, device="cpu")
    pipe.warmup(xs[0])
    eng = pipe._engine
    for x in xs:
        eng.submit(x)                         # abandon in-flight batches
    pipe.close()
    pipe.close()                              # second close is a no-op
    eng.close()                               # engine close too
    assert eng._procs == []


def test_sigkilled_replicated_stage_leaves_no_shmem_leaks(models,
                                                          monkeypatch):
    """A replica SIGKILLed mid-stream: failover at r−1, restaff at the
    first quiescent point, exact results — and every segment this
    pipeline created (each tier's control segments and every slot named
    in their tables, read just before the tier is torn down) is gone
    after close().  Only this pipeline's own names are checked, so other
    tests' segments coming and going in parallel cannot disturb it."""
    from multiprocessing import shared_memory
    names: set = set()
    teardown = _ProcessEngine._teardown_workers

    def spy(self):
        for pair in self._pairs:
            for end in pair:
                names.update(end.segment_names())
        teardown(self)
    monkeypatch.setattr(_ProcessEngine, "_teardown_workers", spy)
    drain_recoveries()
    outs, refs = run_with_plan(
        models, "shmem", FaultPlan().kill_worker(stage=1, at_seq=2, lane=1),
        replicas=(1, 2), n=6)
    check(outs, refs, "shmem/lane-kill")
    kinds = [r.kind for r in drain_recoveries()]
    assert kinds[0] == "failover"             # degraded to r-1 first
    assert "restaff" in kinds                 # restaffed at quiescence
    # three tiers (start, failover, restaff), each with its own segments
    assert len(names) >= 3 * 3
    left = []
    for name in sorted(names):
        try:
            shm = shared_memory.SharedMemory(name=name)
        except FileNotFoundError:
            continue
        shm.close()
        left.append(name)
    assert left == []
    if os.path.isdir("/dev/shm"):
        assert not set(n.lstrip("/") for n in names) & set(
            os.listdir("/dev/shm"))


@pytest.mark.slow
def test_recovery_records_carry_timings(models):
    drain_recoveries()
    run_with_plan(models, "shmem",
                  FaultPlan().kill_worker(stage=1, at_seq=3), n=6)
    (rec,) = drain_recoveries()
    assert rec.kind == "restart" and rec.stage >= -1
    assert rec.detect_s >= 0 and rec.restart_s > 0 and rec.replay_s >= 0
    assert rec.batches_replayed >= 1          # in-flight window resubmitted
    assert rec.degraded_capacity == 1.0       # full restart, no degradation
    assert "restart=" in rec.render() and "replay=" in rec.render()


def test_detect_time_runs_from_the_last_result(models):
    """``detect_s`` spans the last sign of life before the failure to
    its detection.  The reference marks liveness only when a wait times
    out, so on a healthy stream its ``detect_s`` runs from the standup
    and holds the whole standup; the port's supervisor also marks it at
    every submit and every result, so detection is a fraction of the
    rebuild — whether results came before the kill or not."""
    for at_seq in (0, 5):
        drain_recoveries()
        run_with_plan(models, "shmem",
                      FaultPlan().kill_worker(stage=1, at_seq=at_seq), n=8)
        (rec,) = drain_recoveries()
        assert rec.kind == "restart"
        assert rec.detect_s < rec.restart_s / 2, rec.render()


def test_recovery_replays_the_submitted_tensors_themselves(models):
    """The session retains the caller's tensor as it is (no copy) and
    the replay re-feeds exactly that object."""
    _, _, port = models
    x = torch.from_numpy(batches(1)[0])
    with EdgePipeline(port, 2, [LAN_PI_GPU], transport="shmem",
                      supervise=True, timeout_s=60, device="cpu") as pipe:
        with pipe.session() as s:
            s.submit(x)
            assert s._retain and s._pending[0][3] is x
            assert pipe._engine._replay_cb == s._replay_for_recovery
            s.drain()
        assert pipe._engine._replay_cb is None


def test_rebuild_reaps_the_result_ring_of_a_killed_last_stage(models,
                                                              monkeypatch):
    """A results ring whose payloads ride in slots (batch 8: 320 B, past
    the inline area), its sender — the last stage — SIGKILLed: the
    rebuild must reap that ring's slots before the orchestrator's own
    end, the ring's owner, unlinks the control segment the slot names
    are read from.  (The reference closes the ends first, and leaks
    them.)"""
    from multiprocessing import shared_memory
    _, _, port = models
    names: set = set()
    teardown = _ProcessEngine._teardown_workers

    def spy(self):
        for pair in self._pairs:
            for end in pair:
                names.update(end.segment_names())
        teardown(self)
    monkeypatch.setattr(_ProcessEngine, "_teardown_workers", spy)
    drain_recoveries()
    xs = [torch.from_numpy(x) for x in batches(6, batch=8)]
    with EdgePipeline(port, 2, [LAN_PI_GPU], transport="shmem",
                      fault_plan=FaultPlan().kill_worker(stage=1, at_seq=3),
                      stall_timeout_s=2.0, timeout_s=120,
                      device="cpu") as pipe:
        pipe.warmup(xs[0])
        with pipe.session() as s:
            for x in xs:
                s.submit(x)
            assert len(s.drain()) == len(xs)
    assert [r.kind for r in drain_recoveries()] == ["restart"]
    slots = [n for n in names if n.startswith("psm_")]
    assert len(slots) > 6                     # the result rings' slots too
    left = []
    for name in sorted(names):
        try:
            shm = shared_memory.SharedMemory(name=name)
        except FileNotFoundError:
            continue
        shm.close()
        left.append(name)
    assert left == []
