"""The cross-package ring: the JAX reference's ``ShmemChannel`` and the
port's share one shared-memory ring.  CPU only (both packages in one
test process).

A reference ring is opened and split; one of its ends is then replaced
by a port end that adopts it (``ShmemChannel.adopt``: the same control
segment, attached by name, the same doorbells, the same wire counters),
both ways.  For every case of ``test_torch_mixed_pipeline.py`` (every
framing and every codec):

  * the ``_RREC`` record the sender publishes — every field but the send
    stamp — and its slot or inline bytes equal what the other package
    writes for the same input on a ring of its own;
  * what the receiving end decodes equals, bit for bit, what the
    sender's own package decodes from its frame;
  * a second message crosses too: the wire seq counters advance in
    step.
"""
import numpy as np
import pytest
import torch
from test_torch_mixed_pipeline import CASES, _own, _port_payload, _same

from repro.runtime import transport as RT
from repro_torch.runtime import transport as T

torch.set_num_threads(1)

TIMEOUT_S = 30.0


def _published(chan, head: int) -> tuple:
    """The record at ring position ``head`` of ``chan``'s lane and its
    payload bytes → (fields without the send stamp, inline bytes, slot
    bytes).  Slot bytes are read through a fresh mapping by name."""
    from multiprocessing import shared_memory
    base = chan._rec_off + (head % chan._cap) * T._STRIDE
    fields = T._RREC.unpack_from(chan._ctl.buf, base)
    slot, mlen, ilen, nbytes = fields[5], fields[6], fields[7], fields[9]
    inl = base + T._RREC.size
    inline = bytes(chan._ctl.buf[inl:inl + mlen + ilen])
    data = b""
    if slot >= 0:
        shm = shared_memory.SharedMemory(name=chan._tab_name(slot))
        data = bytes(shm.buf[:nbytes])
        shm.close()
    return fields[:8] + fields[9:], inline, data


def _own_record(pkg, framing, codec, payload, kind) -> tuple:
    """What ``pkg`` publishes for ``payload`` on a ring of its own."""
    chan = pkg.ShmemChannel(pkg.HopSpec(index=0, framing=framing,
                                        codec=codec))
    try:
        chan.send(payload, kind=kind)
        return _published(chan, 0)
    finally:
        chan.close()


def _ring(framing, codec):
    """A reference ring split into (tx, rx), and the port's HopSpec."""
    ring = RT.ShmemChannel(RT.HopSpec(index=0, framing=framing, codec=codec))
    tx, rx = ring.split()
    return ring, tx, rx, T.HopSpec(index=0, framing=framing, codec=codec)


def _close(*ends):
    for end in ends:
        end.close()
    ends[0].reap()


@pytest.mark.parametrize("name,framing,codec,kind,payload", CASES,
                         ids=[c[0] for c in CASES])
def test_reference_sender_port_receiver(name, framing, codec, kind, payload):
    ring, tx, rx, hop = _ring(framing, codec)
    port_rx = T.ShmemChannel.adopt(rx, hop)
    try:
        own_ref = RT._unframe(*_own(RT, tx.hop, payload, kind))
        tx.send(payload, kind=kind)
        assert _published(port_rx, 0) == _own_record(
            T, framing, codec, _port_payload(payload), kind)
        k, got = port_rx.recv(timeout=TIMEOUT_S)
        assert k == kind and _same(got, own_ref)
        del got
        tx.send(payload, kind=kind)           # the counters advance in step
        assert port_rx.recv(timeout=TIMEOUT_S)[0] == kind
        if kind in (T.BATCH, T.PROBE):
            recs = port_rx.drain_records()
            assert len(recs) == 2 and all(r.elapsed_s > 0 for r in recs)
    finally:
        _close(port_rx, tx, rx, ring)


@pytest.mark.parametrize("name,framing,codec,kind,payload", CASES,
                         ids=[c[0] for c in CASES])
def test_port_sender_reference_receiver(name, framing, codec, kind, payload):
    ring, tx, rx, hop = _ring(framing, codec)
    port_tx = T.ShmemChannel.adopt(tx, hop)
    try:
        own_port = T._unframe(*_own(T, hop, _port_payload(payload), kind),
                              "cpu")
        port_tx.send(_port_payload(payload), kind=kind)
        assert _published(port_tx, 0) == _own_record(
            RT, framing, codec, payload, kind)
        k, back = rx.recv(timeout=TIMEOUT_S)
        assert k == kind and _same(own_port, back)
        del back
        port_tx.send(_port_payload(payload), kind=kind)
        assert rx.recv(timeout=TIMEOUT_S)[0] == kind
        if kind in (T.BATCH, T.PROBE):
            recs = rx.drain_records()
            assert len(recs) == 2 and all(r.elapsed_s > 0 for r in recs)
    finally:
        _close(port_tx, tx, rx, ring)


def test_adopted_end_grows_and_reuses_the_reference_slots():
    """Past the first slot: a port sender outgrows a slot the reference
    receiver has mapped, republishes it in the shared name table, and
    the reference end follows; then the roles swap on a second ring."""
    x_small = np.arange(1 << 10, dtype=np.float32)
    x_big = np.arange(1 << 18, dtype=np.float32)
    ring, tx, rx, hop = _ring("raw", "none")
    port_tx = T.ShmemChannel.adopt(tx, hop)
    try:
        for x in (x_small, x_big, x_small, x_big):
            port_tx.send(torch.from_numpy(x), kind=T.BATCH)
            _, y = rx.recv(timeout=TIMEOUT_S)
            assert np.array_equal(np.asarray(y), x)
        del y
    finally:
        _close(port_tx, tx, rx, ring)
    ring, tx, rx, hop = _ring("raw", "none")
    port_rx = T.ShmemChannel.adopt(rx, hop)
    try:
        for x in (x_small, x_big, x_small, x_big):
            tx.send(x, kind=T.BATCH)
            _, y = port_rx.recv(timeout=TIMEOUT_S)
            assert y.numpy().tobytes() == x.tobytes()
        del y
    finally:
        _close(port_rx, tx, rx, ring)
