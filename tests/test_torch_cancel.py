"""The port's CANCEL protocol: flush fences, selective cancels,
resubmit-or-skip bookkeeping and cancel mid-flight over the process
transports.

Mirrors the reference's ``tests/test_cancel.py`` case for case on the
``tinycnn`` of ``tests/_torch_tiny.py``, on the CPU.  Every surviving
output is held to the reference's ``CNNModel.apply`` within ``ATOL`` and
to the port's own ``CNNModel.apply`` bit for bit (a redelivered batch
is the same computation, not a near one).
"""
import numpy as np
import pytest
import torch

from _torch_tiny import ATOL, batches, references, tiny_models
from repro_torch.core.devices import LAN_PI_GPU
from repro_torch.runtime import CancelRecord, EdgePipeline, drain_violations

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    return tiny_models()


def _inputs(models, n):
    xs = batches(n)
    return [torch.from_numpy(x) for x in xs], references(models, xs)


def _held(y, want, port, x):
    """``y`` within ATOL of the reference and equal to the port's own
    forward pass of ``x``."""
    assert np.allclose(y.numpy(), want, rtol=0, atol=ATOL)
    assert torch.equal(y, port.apply(x))


def _pipe(port, **kw):
    return EdgePipeline(port, 2, [LAN_PI_GPU], sanitize=True, device="cpu",
                        **kw)


# --------------------------------------------------------------------------- #
# manifest: CANCEL is an append-only extension
# --------------------------------------------------------------------------- #
def test_cancel_kind_appended_to_manifest():
    """The port's CANCEL rides as kind 8, after CLOCK, at the code the
    reference's manifest gives it."""
    from repro.analysis.manifest import TOKEN_KINDS
    from repro_torch.runtime import transport as T
    assert TOKEN_KINDS[-1] == "CANCEL"
    assert TOKEN_KINDS.index("CANCEL") == T.CANCEL == 8
    assert TOKEN_KINDS[:8] == ("BATCH", "WARMUP", "PROBE", "RECONFIG",
                               "STATS", "STOP", "ERROR", "CLOCK")
    assert len(T._KIND_NAMES) == len(TOKEN_KINDS)


# --------------------------------------------------------------------------- #
# thread engine (emulated): semantics
# --------------------------------------------------------------------------- #
def test_cancel_flush_and_selective_emulated(tiny):
    port = tiny[2]
    xs, refs = _inputs(tiny, 8)
    pipe = _pipe(port)
    pipe.warmup(xs[0])
    with pipe.session(inflight=4) as s:
        for i in range(4):
            s.submit(xs[i])
        canceled = s.cancel()                 # flush the whole window
        assert canceled == [0, 1, 2, 3]
        s4, s5 = s.submit(xs[4]), s.submit(xs[5])
        sel = s.cancel([s5])                  # selective: still computes
        assert sel == [s5]
        assert s.cancel([s5]) == []           # already canceled: silent
        with pytest.raises(ValueError, match="never submitted"):
            s.cancel([99])
        out = s.drain()
        recs = s.drain_cancels()
    # only the one surviving batch reaches results()
    assert len(out) == 1
    _held(out[0], refs[4], port, xs[4])
    assert s4 == 4
    # five records, every flushed arrival accounted for
    assert [r.seq for r in recs] == [0, 1, 2, 3, s5]
    assert all(isinstance(r, CancelRecord) and r.flushed for r in recs)
    assert all(r.flush for r in recs[:4]) and not recs[4].flush
    assert all(r.action == "skip" and r.resubmitted_as == -1 for r in recs)
    assert s.drain_cancels() == []            # return-and-clear
    assert drain_violations() == []
    pipe.close()


def test_cancel_resubmit_redelivers_bit_identical(tiny):
    port = tiny[2]
    xs, refs = _inputs(tiny, 4)
    pipe = _pipe(port)
    pipe.warmup(xs[0])
    with pipe.session(inflight=4) as s:
        for x in xs:
            s.submit(x)
        canceled = s.cancel(resubmit=True)
        assert canceled == [0, 1, 2, 3]
        out = s.drain()
        recs = s.drain_cancels()
    # every payload re-fed at the back of the queue, in order
    assert len(out) == 4
    for x, ref, y in zip(xs, refs, out):
        _held(y, ref, port, x)
    assert [r.resubmitted_as for r in recs] == [4, 5, 6, 7]
    assert all(r.action == "resubmit" and r.flushed for r in recs)
    assert drain_violations() == []
    pipe.close()


def test_cancel_skips_already_emitted(tiny):
    port = tiny[2]
    xs, refs = _inputs(tiny, 3)
    pipe = _pipe(port)
    pipe.warmup(xs[0])
    with pipe.session(inflight=3) as s:
        for x in xs:
            s.submit(x)
        it = s.results()
        first = next(it)                      # seq 0 emitted
        assert s.cancel([0]) == []            # emitted: silently skipped
        assert s.cancel([1]) == [1]
        rest = list(it)
    _held(first, refs[0], port, xs[0])
    assert len(rest) == 1                     # seq 2 only
    _held(rest[0], refs[2], port, xs[2])
    assert drain_violations() == []
    pipe.close()


def test_set_inflight_clamps_and_applies(tiny):
    port = tiny[2]
    pipe = EdgePipeline(port, 2, [LAN_PI_GPU], device="cpu")
    with pipe.session(inflight=4) as s:
        assert s.set_inflight(2) == 2
        assert s.inflight == 2
        assert s.set_inflight(0) == 1         # floor
        cap = pipe._engine.max_inflight()
        if cap is not None:
            assert s.set_inflight(10 ** 6) == cap
    pipe.close()


# --------------------------------------------------------------------------- #
# process engines: cancel mid-flight over real transports
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("transport", ["socket", "shmem"])
def test_cancel_mid_flight_process(tiny, transport):
    """Flush-cancel while batches are in flight inside worker processes:
    the ctrl-pipe skip window plus the in-band fence flush every pending
    batch, and the one uncanceled batch afterwards comes back right —
    all under the live sanitizer."""
    port = tiny[2]
    xs, refs = _inputs(tiny, 6)
    pipe = _pipe(port, transport=transport, timeout_s=120)
    with pipe:
        pipe.warmup(xs[0])
        with pipe.session(inflight=4) as s:
            for i in range(4):
                s.submit(xs[i])
            canceled = s.cancel()             # mid-flight flush
            s4, s5 = s.submit(xs[4]), s.submit(xs[5])
            sel = s.cancel([s4])
            out = s.drain()
            recs = s.drain_cancels()
        assert canceled == [0, 1, 2, 3] and sel == [s4]
        assert len(out) == 1
        _held(out[0], refs[5], port, xs[5])
        assert all(r.flushed for r in recs)
    assert drain_violations() == []
