"""The port's shared-memory ring (``repro_torch.runtime.transport``,
``ShmemChannel``) on the CPU, case for case with the reference's shmem
cases in ``tests/test_transport.py``, ``test_transport_fastpath.py``,
``test_replicas.py`` (doorbells, multi-producer segments),
``test_codecs.py`` and ``test_sanitizer.py``.

Payloads are tensors made from seeded numpy arrays; every message kind
and both framings must cross the ring bit for bit, through ring
wraparound and slot growth.  On the CPU an uncoded receive is a
zero-copy tensor view over the slot, leased until the next ``recv``: a
sender that writes into the leased slot must raise the sanitizer's
``lease`` rule.  Segment hygiene is checked by the names each test's own
channels created, so other tests' segments coming and going in parallel
cannot disturb it.
"""
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import codecs as C
from repro_torch.core.devices import LOOPBACK
from repro_torch.runtime import SanitizedChannel, drain_violations
from repro_torch.runtime.sanitizer import SanitizerError
from repro_torch.runtime.transport import (BATCH, CLOCK, ERROR, PROBE,
                                           RECONFIG, STATS, STOP, WARMUP,
                                           HopSpec, ShmemChannel,
                                           _EventFdBell, _bell_pair,
                                           get_transport, measure_hop)

torch.set_num_threads(1)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))      # keeps a 0-d shape


def _exists(name: str) -> bool:
    from multiprocessing import shared_memory
    try:
        shm = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return False
    shm.close()
    return True


def _payload_cases():
    return [
        ("f32", np.arange(24, dtype=np.float32).reshape(2, 3, 4)),
        ("f64", np.linspace(0, 1, 7, dtype=np.float64)),
        ("i64", np.arange(-4, 4, dtype=np.int64).reshape(2, 4)),
        ("u8", np.frombuffer(bytes(range(256)), dtype=np.uint8).copy()),
        ("bool", np.array([[True, False], [False, True]])),
        ("scalar0d", np.float32(3.5) * np.ones((), np.float32)),
        ("big", np.arange(1 << 16, dtype=np.float32)),      # slot path
        ("tiny", np.ones(3, dtype=np.float32)),             # inline path
        ("empty", np.zeros((0, 4), dtype=np.float32)),
        ("ndim9", np.arange(8, dtype=np.float32).reshape((1,) * 8 + (8,))),
    ]


# --------------------------------------------------------------------------- #
# Channel level: wire format, records, slot growth (in-process, cheap)
# --------------------------------------------------------------------------- #
def test_channel_roundtrip_and_records():
    chan = get_transport("shmem").open(HopSpec(index=0, link=LOOPBACK))
    try:
        x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
        chan.send(x, kind=BATCH)
        kind, y = chan.recv(timeout=5.0)
        assert kind == BATCH and torch.equal(x, y)       # raw bytes: exact
        chan.send(kind=PROBE)
        kind, _ = chan.recv(timeout=5.0)
        assert kind == PROBE
        recs = chan.drain_records()
        assert len(recs) == 2
        assert recs[0].nbytes == x.numel() * 4 and recs[0].elapsed_s > 0
        assert recs[1].nbytes == 0                       # header-only probe
        assert chan.drain_records() == []                # drained
        assert chan.total_bytes == x.numel() * 4         # lifetime counter
    finally:
        chan.close()


def test_shmem_slot_growth():
    chan = get_transport("shmem").open(HopSpec(index=0, link=LOOPBACK))
    try:
        small = torch.zeros(16)
        big = torch.zeros(1 << 18)                       # > initial 64 KiB slot
        for payload in (small, big, small, big):
            chan.send(payload, kind=BATCH)
            _, y = chan.recv(timeout=5.0)
            assert y.numel() * y.element_size() == payload.numel() * 4
    finally:
        chan.close()


@pytest.mark.parametrize("name", ["socket", "shmem"])
@pytest.mark.parametrize("framing", ["raw", "pickle"])
def test_packed_framing_bit_parity(name, framing):
    chan = get_transport(name).open(HopSpec(index=0, framing=framing))
    try:
        for label, x in _payload_cases():
            chan.send(_t(x), kind=BATCH)
            kind, y = chan.recv(timeout=5.0)
            assert kind == BATCH
            assert y.numpy().dtype == x.dtype, (label, y.dtype)
            assert tuple(y.shape) == x.shape, (label, y.shape)
            # bit-identical, not just allclose
            assert y.numpy().tobytes() == x.tobytes(), label
    finally:
        chan.close()


@pytest.mark.parametrize("name", ["socket", "shmem"])
def test_control_tokens_roundtrip(name):
    """Non-tensor control payloads ride the same packed records."""
    cases = [(STOP, None), (PROBE, None), (CLOCK, 123.456),
             (RECONFIG, (0, 5, 12, 17)), (STATS, None),
             (ERROR, "stage 1 (ValueError): boom " + "x" * 500),
             (WARMUP, torch.ones(2, 2))]
    chan = get_transport(name).open(HopSpec(index=0))
    try:
        for kind, payload in cases:
            chan.send(payload, kind=kind)
            k, got = chan.recv(timeout=5.0)
            assert k == kind
            if isinstance(payload, torch.Tensor):
                assert torch.equal(got, payload)
            else:
                assert got == payload
        # only BATCH/PROBE transfers are recorded
        recs = chan.drain_records()
        assert len(recs) == 1 and recs[0].nbytes == 0
    finally:
        chan.close()


def test_ring_wraparound():
    """Many more messages than the control ring holds: seq counters keep
    running past the ring capacity and every payload survives."""
    chan = get_transport("shmem").open(HopSpec(index=0, depth=2))
    try:
        n = 4 * chan._cap + 3
        for i in range(n):
            x = torch.full((5 + (i % 7),), i, dtype=torch.int32)
            chan.send(x, kind=BATCH)
            _, y = chan.recv(timeout=5.0)
            assert torch.equal(x, y), i
        assert len(chan.drain_records()) == n
    finally:
        chan.close()


def test_slot_growth_under_backpressure():
    """Fill every slot with growing payloads before draining any: each
    send pops a freed slot, outgrows it, and replaces it in the name
    table — the drain must still see every payload bit-exact."""
    depth = 3
    chan = get_transport("shmem").open(HopSpec(index=0, depth=depth))
    try:
        xs = [torch.arange((1 << 14) << i).to(torch.uint8)
              for i in range(depth)]
        for x in xs:                          # no recv in between
            chan.send(x, kind=BATCH)
        for x in xs:
            _, y = chan.recv(timeout=5.0)
            assert torch.equal(x, y)
        # second wave reuses (some grown) slots
        for x in reversed(xs):
            chan.send(x, kind=BATCH)
            _, y = chan.recv(timeout=5.0)
            assert torch.equal(x, y)
    finally:
        chan.close()


def _slot_ptrs(chan) -> set[int]:
    """Base addresses of the receiver's mapped slots."""
    ptrs = set()
    for _, shm in chan._attached.values():
        probe = torch.frombuffer(shm.buf, dtype=torch.uint8)
        ptrs.add(probe.data_ptr())
        del probe
    return ptrs


def test_zero_copy_view_vs_copy_mode():
    """Default recv hands out a tensor view over the mapped slot
    (zero-copy); ``zero_copy=False`` buys an owning copy that survives
    the next recv."""
    x = torch.arange(1 << 12, dtype=torch.float32)  # the slot path
    chan = get_transport("shmem").open(HopSpec(index=0))
    try:
        chan.send(x, kind=BATCH)
        _, view = chan.recv(timeout=5.0)
        assert view._base is not None         # a view over the slot …
        assert view.data_ptr() in _slot_ptrs(chan)
        assert torch.equal(view, x)
        del view
    finally:
        chan.close()
    chan = get_transport("shmem").open(HopSpec(index=0, zero_copy=False))
    try:
        chan.send(x, kind=BATCH)
        _, own = chan.recv(timeout=5.0)
        assert own.data_ptr() not in _slot_ptrs(chan)   # tensor-owned
        chan.send(torch.zeros_like(x), kind=BATCH)   # reuses the slot
        chan.recv(timeout=5.0)
        assert torch.equal(own, x)            # copy was defensive
    finally:
        chan.close()


def test_held_view_survives_slot_replacement():
    """A zero-copy view handed out earlier must stay valid (its mapping
    pinned) even after the sender outgrows and replaces that slot, and
    close() must not crash on the pinned mappings."""
    chan = get_transport("shmem").open(HopSpec(index=0, depth=1))
    try:
        a = torch.arange(1 << 12).to(torch.uint8)
        chan.send(a, kind=BATCH)
        _, va = chan.recv(timeout=5.0)        # leases the slot
        held = []
        for i in range(4):                    # grow the same slots repeatedly
            big = torch.full((1 << (16 + i),), i, dtype=torch.uint8)
            chan.send(big, kind=BATCH)
            _, vb = chan.recv(timeout=5.0)
            held.append(vb)
        assert torch.equal(va, a)             # old view still readable
        for i, vb in enumerate(held[:-1]):
            assert int(vb[0]) == i
    finally:
        chan.close()
    assert torch.equal(va, a)                 # readable after close too


def test_shmem_teardown_unlinks_all_segments():
    """close() must unlink the control segment and every pooled slot,
    including slots replaced by growth."""
    chan = get_transport("shmem").open(HopSpec(index=0, depth=3))
    names = set(chan.segment_names())
    sizes = [1 << 12, 1 << 18, 1 << 12, 1 << 20, 1 << 14]
    for n in sizes:                           # growth replaces segments
        chan.send(torch.zeros(n, dtype=torch.uint8), kind=BATCH)
        chan.recv(timeout=5.0)
        names.update(chan.segment_names())
    assert len(names) >= 3 and all(_exists(n) for n in chan.segment_names())
    chan.close()
    assert [n for n in names if _exists(n)] == []


def test_shmem_fan_teardown_reaps_every_lane():
    """open_fan lanes pack into one control segment: close() on every
    lane end plus one reap() must unlink the shared segment and all
    per-lane payload slots — the supervisor's rebuild path after a
    SIGKILLed replica depends on it."""
    lanes = get_transport("shmem").open_fan(HopSpec(index=0, depth=3), 2)
    for m, lane in enumerate(lanes):          # slot traffic on every lane
        lane.send(torch.full((1 << 16,), m, dtype=torch.uint8), kind=BATCH)
        lane.recv(timeout=5.0)
    names = set(lanes[0].segment_names())
    assert len(names) == 1 + 2                # one segment, a slot a lane
    for lane in lanes:
        lane.close()
    lanes[0].reap()                           # idempotent vs close()
    assert [n for n in names if _exists(n)] == []


def test_shmem_vectored_large_payload_with_concurrent_reader():
    """8 MiB through one slot, the reader in another thread."""
    chan = get_transport("shmem").open(HopSpec(index=0))
    x = torch.arange(2 << 20, dtype=torch.float32)
    out = {}

    def reader():
        kind, y = chan.recv(timeout=30.0)
        out["msg"] = (kind, y.clone())
    try:
        t = threading.Thread(target=reader)
        t.start()
        chan.send(x, kind=BATCH)
        t.join(30.0)
        assert not t.is_alive()
        kind, y = out["msg"]
        assert kind == BATCH and torch.equal(x, y)
    finally:
        chan.close()


# --------------------------------------------------------------------------- #
# The zero-copy lease on a real ring
# --------------------------------------------------------------------------- #
def test_sender_write_into_leased_slot_raises_lease():
    inner = get_transport("shmem").open(HopSpec(index=0, sanitize=True))
    ch = SanitizedChannel(inner)
    drain_violations()
    try:
        x = torch.arange(1 << 12, dtype=torch.float32)
        ch.send(x, kind=BATCH)
        _, view = ch.recv(timeout=5.0)        # leases the slot
        assert inner._lease is not None and view._base is not None
        ch.send(x + 1, kind=BATCH)            # another slot: lease holds
        inner._pool[inner._lease].buf[:4] = b"\xff" * 4   # sender scribbles
        with pytest.raises(SanitizerError):
            ch.recv(timeout=5.0)
        assert [v.rule for v in drain_violations()] == ["lease"]
        del view
    finally:
        ch.close()


def test_untouched_lease_on_a_real_ring_is_silent():
    ch = SanitizedChannel(get_transport("shmem").open(
        HopSpec(index=0, sanitize=True)))
    drain_violations()
    try:
        for i in range(4):
            ch.send(torch.full((1 << 12,), float(i)), kind=BATCH)
            _, view = ch.recv(timeout=5.0)
            assert float(view[0]) == i
        del view
        assert drain_violations() == []
    finally:
        ch.close()


# --------------------------------------------------------------------------- #
# Doorbells and multi-producer segments
# --------------------------------------------------------------------------- #
def test_bell_pair_flavors_ring_and_wait():
    flavors = ["socketpair", "auto"]
    if hasattr(os, "eventfd"):
        flavors.append("eventfd")
    for flavor in flavors:
        ring, wait = _bell_pair(flavor)
        ring.ring()
        ring.ring()                           # coalesced rings must not block
        wait.wait(0.5)
        wait.wait(0.01)                       # drained: times out quietly
        ring.close()
        wait.close()
        wait.close()                          # idempotent
    with pytest.raises(ValueError):
        _bell_pair("smoke-signals")


@pytest.mark.skipif(not hasattr(os, "eventfd"),
                    reason="no eventfd on this platform")
def test_eventfd_pair_ends_close_independently():
    a, b = _EventFdBell.pair()
    a.close()                                 # closing one end …
    b.wait(0.01)                              # … must not break the other
    b.close()


def test_shmem_hops_work_with_either_bell():
    for bell in ("socketpair", "auto"):
        ch = ShmemChannel(HopSpec(index=0, depth=2, spin_us=0, bell=bell))
        x = torch.arange(4096, dtype=torch.float32)
        ch.send(x)
        kind, y = ch.recv(timeout=5)
        assert kind == BATCH and torch.equal(y.reshape(-1), x)
        del y
        ch.close()
        ch.reap()


def test_shmem_open_fan_packs_lanes_into_one_segment():
    lanes = get_transport("shmem").open_fan(
        HopSpec(index=0, depth=4, spin_us=50), 3)
    try:
        assert len({c._ctl_name for c in lanes}) == 1
        assert all(c._n_lanes == 3 for c in lanes)
        for m, c in enumerate(lanes):         # per-lane SPSC rings stay
            c.send(torch.full((2000,), float(m)))     # independent
        for m, c in enumerate(lanes):
            kind, v = c.recv(timeout=5)
            assert kind == BATCH and float(v[0]) == m
    finally:
        for c in lanes:
            c.close()
        lanes[0].reap()


def test_shmem_fan_reap_sweeps_every_lane():
    from multiprocessing import shared_memory
    lanes = get_transport("shmem").open_fan(
        HopSpec(index=0, depth=2, spin_us=50), 2)
    # force a payload slot into lane 1's table, then reap via lane 0
    lanes[1].send(torch.zeros(100_000))
    lanes[1].recv(timeout=5)
    slot = lanes[1]._tab_name(0) or lanes[1]._tab_name(1)
    assert slot, "expected a named payload slot on lane 1"
    for c in lanes:
        c.close()
    lanes[0].reap()
    with pytest.raises(FileNotFoundError):
        shared_memory.SharedMemory(name=slot)


# --------------------------------------------------------------------------- #
# Cross-process: the single-hop microbenchmark's spawned sink
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("codec", ["none", "int8"])
def test_measure_hop_over_shmem(codec):
    """Receiver-measured per-transfer times at two payload sizes (the
    larger one on the slot path, grown in place), the sink process
    unpacking each frame; the wire bytes are the codec's."""
    sizes = [1024, 65536]
    out = measure_hop("shmem", sizes, n_per_size=5, codec=codec,
                      full=True, device="cpu")
    assert sorted(out) == sizes
    for nbytes, recs in out.items():
        assert len(recs) == 5 and all(r.elapsed_s > 0 for r in recs)
        assert all(r.raw_bytes == nbytes for r in recs)
        assert all(r.nbytes == C.get_codec(codec).wire_bytes(nbytes // 4)
                   for r in recs)


def test_codec_byte_survives_framing_cross_process():
    """A coded shmem hop to a spawned sink: receiver-side records carry
    both the raw payload size (decoded from the codec byte + shape) and
    the packed wire size."""
    nbytes = 64 * 1024
    out = measure_hop("shmem", [nbytes], n_per_size=4, codec="int8",
                      full=True, device="cpu")
    recs = out[nbytes]
    assert recs, "sink returned no matching records"
    for r in recs:
        assert r.raw_bytes == nbytes
        assert r.nbytes == 4 + nbytes // 4     # scale header + int8 payload
        assert r.wire_bytes == r.nbytes
        assert r.raw_bytes / r.nbytes >= 3.5   # acceptance ratio on the wire


@pytest.mark.slow
def test_sanitizer_overhead_is_small():
    """Measured hop-µs with and without the wrapper on a real shmem hop
    at 64 KiB; loose bound (50% + scheduler slack): a real regression
    (per-message deep copies, full-payload hashing) shows as 2-10x."""
    size = 65536
    base = measure_hop("shmem", [size], n_per_size=40, sanitize=False,
                       device="cpu")[size]
    sani = measure_hop("shmem", [size], n_per_size=40, sanitize=True,
                       device="cpu")[size]
    assert drain_violations() == []
    m_base = float(np.median(base))
    m_sani = float(np.median(sani))
    assert m_sani <= m_base * 1.5 + 100e-6, \
        f"sanitizer overhead too high: {m_base*1e6:.1f}µs -> {m_sani*1e6:.1f}µs"


@pytest.mark.slow
def test_shmem_beats_socket_at_1mib():
    """Cross-process, credit-paced, receiver-measured: the shmem ring's
    median per-hop cost at 1 MiB must not exceed loopback TCP's."""
    n = 1 << 20
    shmem = measure_hop("shmem", [n], n_per_size=30, device="cpu")[n]
    sock = measure_hop("socket", [n], n_per_size=30, device="cpu")[n]
    assert shmem and sock
    med_m, med_s = float(np.median(shmem)), float(np.median(sock))
    assert med_m <= med_s, \
        f"shmem {med_m * 1e6:.0f}us > socket {med_s * 1e6:.0f}us at 1 MiB"
