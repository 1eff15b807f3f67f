"""The port's live protocol sanitizer (``repro_torch.runtime.sanitizer``).

Mirrors the reference's ``tests/test_sanitizer.py`` case for case over
torch tensors: every deliberately broken Channel double must raise
``SanitizerError`` and leave exactly one matching entry in the violation
report, a clean token stream must sanitize silently, deep mode is read
from the environment on each call, and the wrapper's cost on a real
socket hop stays small.  Then a sanitized socket pipeline (worker
processes on the CPU) migrates mid-stream and ends with no violation.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.devices import Link
from repro_torch.models.cnn import layers as L
from repro_torch.models.cnn import zoo as Z
from repro_torch.runtime import (EdgePipeline, SanitizedChannel,
                                 SanitizerError, drain_violations)
from repro_torch.runtime.transport import (BATCH, CLOCK, RECONFIG, STATS,
                                           STOP, WARMUP)

torch.set_num_threads(1)


# --------------------------------------------------------------------------- #
# Channel doubles
# --------------------------------------------------------------------------- #
class _Hop:
    """Just enough HopSpec surface for the wrapper."""

    def __init__(self, index=0, codec="none", zero_copy=True):
        self.index = index
        self.codec = codec
        self.zero_copy = zero_copy
        self.sanitize = True


class _Loopback:
    """In-process FIFO channel: recv() returns what send() queued.
    ``script`` entries (exceptions or (kind, payload) tuples) are
    served before the queue — the mutation hook."""

    def __init__(self, hop=None, script=None):
        self.hop = hop if hop is not None else _Hop()
        self.q = []
        self.script = list(script or [])

    def send(self, payload=None, kind=BATCH):
        self.q.append((kind, payload))

    def recv(self, timeout=None):
        if self.script:
            item = self.script.pop(0)
            if isinstance(item, BaseException):
                raise item
            return item
        return self.q.pop(0)


class _SwapLoopback(_Loopback):
    """Delivers queued messages newest-first: a reordering transport."""

    def recv(self, timeout=None):
        if self.script:
            return super().recv(timeout)
        return self.q.pop()


def _wrap(inner=None, **hop_kw):
    chan = inner if inner is not None else _Loopback(_Hop(**hop_kw))
    drain_violations()                        # isolate each test
    return SanitizedChannel(chan)


def _assert_raises_with_rule(rule, fn):
    with pytest.raises(SanitizerError):
        fn()
    bad = drain_violations()
    assert [v.rule for v in bad] == [rule], bad


# --------------------------------------------------------------------------- #
# the mutation doubles
# --------------------------------------------------------------------------- #
def test_skipped_warmup_on_send_raises():
    ch = _wrap()
    ch.send(torch.ones(4), kind=BATCH)
    ch.send({"bounds": (0, 2, 5)}, kind=RECONFIG)
    _assert_raises_with_rule(
        "warmup-skipped", lambda: ch.send(torch.ones(4), kind=BATCH))


def test_skipped_warmup_on_recv_raises():
    x = torch.ones(4)
    ch = _wrap(_Loopback(script=[
        (BATCH, x),
        (RECONFIG, {"bounds": (0, 2, 5)}),
        (BATCH, x),                           # no WARMUP fence: violation
    ]))
    ch.recv()
    ch.recv()
    _assert_raises_with_rule("warmup-skipped", ch.recv)


def test_warmup_fence_clears_the_obligation():
    ch = _wrap()
    x = torch.ones(4)
    for kind in (BATCH, RECONFIG, WARMUP, BATCH):
        payload = {"bounds": (0, 2)} if kind == RECONFIG else x
        ch.send(payload, kind=kind)
        ch.recv()
    assert drain_violations() == []


def test_duplicated_fanin_token_raises():
    tok = {"bounds": (0, 2, 5), "codecs": ("none", "none")}
    ch = _wrap(_Loopback(script=[(RECONFIG, tok), (RECONFIG, tok)]))
    ch.recv()
    _assert_raises_with_rule("token-dup", ch.recv)


def test_distinct_reconfigs_are_not_duplicates():
    ch = _wrap(_Loopback(script=[
        (RECONFIG, {"bounds": (0, 2, 5)}),
        (WARMUP, None),
        (RECONFIG, {"bounds": (0, 3, 5)}),    # a different cut: legitimate
    ]))
    ch.recv(), ch.recv(), ch.recv()
    assert drain_violations() == []


def test_reordered_seq_raises():
    ch = _wrap(_SwapLoopback(_Hop()))
    a = torch.arange(8, dtype=torch.float32)
    ch.send(a, kind=BATCH)
    ch.send(-a, kind=BATCH)                   # transport delivers -a first
    _assert_raises_with_rule("seq-order", ch.recv)


def test_write_into_leased_slot_raises():
    slab = torch.zeros(64)
    view = slab[:32]                          # a view: its _base is the slab
    assert view._base is not None
    ch = _wrap(_Loopback(script=[(BATCH, view), (BATCH, torch.ones(2))]))
    ch.recv()                                 # leases the view
    slab[:4] = 7.0                            # sender scribbles on the slot
    _assert_raises_with_rule("lease", ch.recv)


def test_write_into_leased_numpy_slot_raises():
    """A numpy view over transport memory (what a shmem slot hands out)
    is leased the same way."""
    slab = np.zeros(64, np.float32)
    ch = _wrap(_Loopback(script=[(BATCH, slab[:32]), (BATCH, np.ones(2))]))
    ch.recv()
    slab[:4] = 7.0
    _assert_raises_with_rule("lease", ch.recv)


def test_untouched_lease_is_silent():
    slab = torch.zeros(64)
    ch = _wrap(_Loopback(script=[(BATCH, slab[:32]),
                                 (BATCH, torch.ones(2))]))
    ch.recv()
    ch.recv()                                 # canary intact: no violation
    assert drain_violations() == []


def test_owned_payload_and_copying_hop_arm_no_lease():
    """A tensor that owns its memory, or any payload on a hop that
    copies before handing it out (``zero_copy=False``), is not leased:
    writing into its source afterwards is no violation."""
    slab = torch.zeros(64)
    owned = slab[:32].clone()
    ch = _wrap(_Loopback(script=[(BATCH, owned), (BATCH, torch.ones(2))]))
    ch.recv()
    owned[:4] = 7.0
    ch.recv()
    ch = _wrap(_Loopback(_Hop(zero_copy=False),
                         script=[(BATCH, slab[:32]), (BATCH, torch.ones(2))]))
    ch.recv()
    slab[:4] = 7.0
    ch.recv()
    assert drain_violations() == []


def test_bad_codec_byte_raises_frame_decode():
    # an unknown codec wire byte surfaces from the framer as a KeyError
    ch = _wrap(_Loopback(script=[KeyError(9)]))
    _assert_raises_with_rule("frame-decode", ch.recv)


def test_stop_is_terminal_both_directions():
    ch = _wrap()
    ch.send(None, kind=STOP)
    _assert_raises_with_rule(
        "stop-terminal", lambda: ch.send(torch.ones(2), kind=BATCH))
    ch2 = _wrap(_Loopback(script=[(STOP, None), (STATS, {})]))
    ch2.recv()
    _assert_raises_with_rule("stop-terminal", ch2.recv)


def test_repeated_stop_is_tolerated():
    ch = _wrap()
    ch.send(None, kind=STOP)
    ch.send(None, kind=STOP)                  # idempotent teardown
    assert drain_violations() == []


@pytest.mark.parametrize("payload", [
    {"codecs": ("none",)},                    # no bounds
    {"bounds": (5, 2)},                       # not increasing
    {"bounds": (3,)},                         # too few edges
    {"bounds": (0, 2), "codecs": ("gzip9",)},  # unregistered codec
    "0:5",                                    # wrong type entirely
], ids=["no-bounds", "decreasing", "one-edge", "unknown-codec", "string"])
def test_malformed_reconfig_payloads_raise(payload):
    ch = _wrap()
    _assert_raises_with_rule(
        "reconfig-payload", lambda: ch.send(payload, kind=RECONFIG))


def test_out_of_range_kind_raises():
    ch = _wrap()
    _assert_raises_with_rule("kind-range", lambda: ch.send(None, kind=42))


def test_coded_hop_checks_structure_not_bytes():
    # an int8 hop rewrites payload bytes in flight: the ledger must only
    # compare structural identity, so a lossy round trip stays silent
    inner = _Loopback(_Hop(codec="int8"))
    ch = _wrap(inner)
    x = torch.linspace(-1, 1, 32)
    ch.send(x, kind=BATCH)
    inner.q[0] = (BATCH, x * 0.98)            # quantized echo
    ch.recv()
    assert drain_violations() == []


def test_clean_stream_is_silent():
    ch = _wrap()
    x = torch.arange(16, dtype=torch.float32)
    for kind in (WARMUP, BATCH, BATCH, STATS, CLOCK, STOP):
        ch.send(x if kind in (WARMUP, BATCH) else None, kind=kind)
        ch.recv()
    assert drain_violations() == []


def test_sanitizer_overhead_is_small():
    """Measured hop-µs with and without the wrapper on a real socket hop
    at 64 KiB (the sink a spawned process, on the CPU).  The bound is
    the reference's: 50 % plus 100 µs of scheduler slack — a real
    regression (per-message deep copies, full-payload hashing) shows up
    as 2-10x, not 1.2x.  The two are measured in alternating rounds of
    10 hops (plain, sanitized, sanitized, plain, twice over), 40 hops
    each in all, so that a change of load on the host during the test
    falls on both alike."""
    from repro_torch.runtime.transport import measure_hop
    size = 65536
    drain_violations()
    hops = {False: [], True: []}
    for sanitize in (False, True, True, False) * 2:
        hops[sanitize] += measure_hop("socket", [size], n_per_size=10,
                                      sanitize=sanitize, device="cpu")[size]
    base, sani = hops[False], hops[True]
    assert len(base) == len(sani) == 40
    assert drain_violations() == []
    m_base = float(np.median(base))
    m_sani = float(np.median(sani))
    assert m_sani <= m_base * 1.5 + 100e-6, \
        f"sanitizer overhead too high: {m_base*1e6:.1f}µs -> {m_sani*1e6:.1f}µs"


# --------------------------------------------------------------------------- #
# deep mode: full-payload fingerprints (REPRO_SANITIZE_DEEP=1)
# --------------------------------------------------------------------------- #
def test_shallow_sample_misses_interior_corruption(monkeypatch):
    """The default fingerprint hashes a head/tail sample — corruption
    strictly between the samples passes (the control for the next
    test)."""
    monkeypatch.delenv("REPRO_SANITIZE_DEEP", raising=False)
    inner = _Loopback(_Hop())
    ch = _wrap(inner)
    ch.send(torch.arange(64, dtype=torch.float32), kind=BATCH)
    inner.q[0][1][32] = -1.0                  # flip one interior element
    ch.recv()
    assert drain_violations() == []


def test_deep_sanitize_catches_interior_corruption(monkeypatch):
    """``REPRO_SANITIZE_DEEP=1`` crc32s the whole payload, so the same
    interior flip the sampled fingerprint missed above now raises."""
    monkeypatch.setenv("REPRO_SANITIZE_DEEP", "1")
    inner = _Loopback(_Hop())
    ch = _wrap(inner)
    ch.send(torch.arange(64, dtype=torch.float32), kind=BATCH)
    inner.q[0][1][32] = -1.0
    _assert_raises_with_rule("seq-order", ch.recv)


def test_deep_enabled_reads_env_per_call(monkeypatch):
    from repro_torch.runtime.sanitizer import deep_enabled
    monkeypatch.delenv("REPRO_SANITIZE_DEEP", raising=False)
    assert not deep_enabled()
    monkeypatch.setenv("REPRO_SANITIZE_DEEP", "0")
    assert not deep_enabled()
    monkeypatch.setenv("REPRO_SANITIZE_DEEP", "1")
    assert deep_enabled()


def test_sanitize_enabled_reads_the_environment(monkeypatch):
    from repro_torch.runtime.sanitizer import sanitize_enabled
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert sanitize_enabled() and not sanitize_enabled(False)
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    assert not sanitize_enabled() and sanitize_enabled(True)


# --------------------------------------------------------------------------- #
# end to end: a sanitized socket pipeline stays clean
# --------------------------------------------------------------------------- #
def test_sanitized_socket_pipeline_has_no_violations():
    blocks = [
        ("conv0", L.Sequential([L.Conv2D(3, 8, 3, 1, 1), L.ReLU()])),
        ("pool", L.Pool("max", 2, 2)),
        ("head", L.Sequential([L.Flatten(), L.Linear(8 * 16 * 16, 10)])),
    ]
    model = Z.CNNModel("tiny3", blocks, input_hw=32).init(
        torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    link = Link("fast", rtt_s=2e-5, bw_bytes_per_s=1e10)
    drain_violations()
    with EdgePipeline(model, 1, [link], transport="socket", codec="int8",
                      sanitize=True, device="cpu") as pipe:
        pipe.warmup(x)
        y, _, _ = pipe.run_one(x)
        with pipe.session(inflight=3, policy="drop") as s:
            for i in range(6):
                s.submit(x)
                if i == 2:
                    s.migrate(2, codecs=("fp8",))
            got = s.drain()
            s.checkpoint()
    assert len(got) == 6 and y.shape == (2, 10)
    bad = drain_violations()
    assert bad == [], "\n".join(v.render() for v in bad)
