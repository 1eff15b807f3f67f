"""The port's socket transport and process engine on the CPU.

Mirrors the reference's socket cases (``tests/test_transport.py``,
``test_transport_fastpath.py``) on the ``tinycnn`` of
``test_torch_pipeline.py`` with ``device="cpu"``: stages are spawned
worker processes, hops real loopback TCP.  Tolerances:

  * socket against emulated: bit for bit (``torch.equal``) for every
    codec — the same weights, cuts and wire transform, with the numerics
    settings (here one intra-op thread) shipped to every worker;
  * uncoded socket against the reference's ``CNNModel.apply``: 1e-5, the
    per-block parity of ``test_torch_cnn.py`` (fp32 sums in a different
    order).

Mid-stream migration, worker death and replicas over socket live in
``test_torch_socket_session.py``.
"""
import threading

import jax
import numpy as np
import pytest
import torch

from repro.models.cnn import layers as RL
from repro.models.cnn import zoo as RZ
from repro_torch.core import codecs as C
from repro_torch.core import scenarios
from repro_torch.core.devices import LOOPBACK, Link
from repro_torch.models.cnn import layers as L
from repro_torch.models.cnn import zoo as Z
from repro_torch.runtime import EdgePipeline, drain_violations
from repro_torch.runtime.transport import (BATCH, PROBE, HopSpec,
                                           SocketChannel, get_transport,
                                           measure_hop)

# one intra-op thread: the suite runs in parallel worker processes, and
# every pipeline stage is a process of its own (it inherits the setting)
torch.set_num_threads(1)

FAST = dict(name="fast", rtt_s=2e-5, bw_bytes_per_s=1e10)
ATOL = 1e-5


def _tiny(lib, zoo):
    blocks = [
        ("conv0", lib.Sequential([lib.Conv2D(3, 8, 3, 1, 1), lib.ReLU()])),
        ("conv1", lib.Sequential([lib.Conv2D(8, 8, 3, 1, 1), lib.ReLU()])),
        ("pool", lib.Pool("max", 2, 2)),
        ("conv2", lib.Sequential([lib.Conv2D(8, 16, 3, 1, 1), lib.ReLU()])),
        ("head", lib.Sequential([lib.Flatten(), lib.Linear(16 * 16 * 16, 10)])),
    ]
    return zoo.CNNModel("tinycnn", blocks, input_hw=32)


@pytest.fixture(scope="module")
def models():
    ref = _tiny(RL, RZ)
    params = ref.init(jax.random.PRNGKey(0))
    port = _tiny(L, Z).from_reference(jax.tree.map(np.asarray, params))
    return ref, params, port


def _batch(seed=100, batch=2, hw=32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, hw, hw, 3)).astype(np.float32)


# --------------------------------------------------------------------------- #
# Channel level (in-process, cheap)
# --------------------------------------------------------------------------- #
def test_channel_roundtrip_and_records():
    chan = get_transport("socket").open(HopSpec(index=0, link=LOOPBACK))
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


def test_channel_pickle_framing_roundtrip():
    hop = HopSpec(index=0, link=LOOPBACK, framing="pickle")
    chan = get_transport("socket").open(hop)
    try:
        x = torch.ones(4, 5)
        chan.send(x, kind=BATCH)
        _, y = chan.recv(timeout=5.0)
        assert torch.equal(x, y)
        (rec,) = chan.drain_records()
        assert rec.nbytes > x.numel() * 4                # pickle framing pays
    finally:
        chan.close()


def test_socket_vectored_send_large_payload():
    """8 MiB through sendmsg: the partial-write loop must hold up well
    past the kernel socket buffers (needs a concurrent reader)."""
    chan = get_transport("socket").open(HopSpec(index=0))
    x = torch.arange(2 << 20, dtype=torch.float32)  # 8 MiB
    out = {}

    def reader():
        out["msg"] = chan.recv(timeout=30.0)
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


def test_pace_link_charges_the_modeled_wire_to_the_measured_record():
    """A socket hop WAN-shaped by ``pace_link``: the sender sleeps the
    link's time for the *wire* bytes after its send stamp, so the
    receiver's record carries it on top of the loopback cost."""
    link = Link("paced", rtt_s=0.04, bw_bytes_per_s=1e6)
    chan = get_transport("socket").open(
        HopSpec(index=0, codec="int8", pace_link=link))
    try:
        x = torch.randn(4096)
        chan.send(x, kind=BATCH)
        chan.recv(timeout=5.0)
        (rec,) = chan.drain_records()
        wire = C.get_codec("int8").wire_bytes(x.numel())
        assert rec.nbytes == wire
        assert rec.elapsed_s >= link.transfer_time(wire)
    finally:
        chan.close()


def test_pickled_end_drops_its_buffers_and_codec():
    """An end crossing to a worker process carries neither its receive
    buffers nor the resolved codec object; both come back on arrival."""
    import pickle
    tx, rx = SocketChannel(HopSpec(index=0, codec="int8")).split()
    try:
        assert tx.codec.name == "int8"
        state = rx.__getstate__()
        assert "_rbuf" not in state and "_hbuf" not in state
        assert tx.__getstate__()["_codec"] is None
        sock, rx._rx = rx._rx, None            # sockets do not pickle here
        sock.close()
        back = pickle.loads(pickle.dumps(rx))
        assert len(back._rbuf) == 1 << 16 and back.codec.name == "int8"
    finally:
        tx.close()


# --------------------------------------------------------------------------- #
# Pipeline-level declarations (rejected before any worker is spawned)
# --------------------------------------------------------------------------- #
def test_mixed_emulated_and_process_transports_rejected(models):
    _, _, port = models
    with pytest.raises(ValueError, match="mix"):
        EdgePipeline(port, (1, 3), [Link(**FAST)] * 2, device="cpu",
                     transport=("emulated", "socket"))


def test_linktrace_rejected_on_process_transports(models):
    """A measured channel cannot replay a schedule: a LinkTrace hop
    under socket must be rejected loudly, not silently ignored."""
    _, _, port = models
    with pytest.raises(ValueError, match="LinkTrace"):
        EdgePipeline(port, (1, 3), scenarios.get("pi_pi_gpu_wan_ramp"),
                     transport="socket", device="cpu")


# --------------------------------------------------------------------------- #
# Transport parity: socket against emulated, every codec, one standup
# --------------------------------------------------------------------------- #
def test_socket_pipeline_matches_emulated_for_every_codec(models):
    """One 3-stage socket pipeline switches its codec in place (a
    quiescent migrate with the cuts unchanged) through none, int8, fp8
    and topk; each output equals the emulated pipeline's bit for bit,
    each hop's wire and raw bytes equal the emulated records, and the
    uncoded output equals the reference's apply."""
    ref, params, port = models
    x = _batch()
    want = np.asarray(ref.apply(params, x))
    cuts, links = (1, 3), [Link(**FAST)] * 2
    drain_violations()
    with EdgePipeline(port, cuts, links, transport="socket", device="cpu",
                      sanitize=True) as pipe:
        assert pipe.transport == "socket"
        with pytest.raises(AttributeError, match="own processes"):
            pipe.workers
        pipe.warmup(torch.from_numpy(x))
        for codec in ("none", "int8", "fp8", "topk"):
            if codec != "none":
                pipe.migrate(cuts, codecs=(codec, codec))
            emu = EdgePipeline(port, cuts, links, codec=codec, device="cpu")
            got, lat, hops = pipe.run_one(torch.from_numpy(x))
            alone, _, _ = emu.run_one(torch.from_numpy(x))
            assert lat > 0 and len(hops) == 2 and all(h > 0 for h in hops)
            assert torch.equal(got, alone), codec
            if codec == "none":
                np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                           atol=ATOL)
            for net, enet in zip(pipe.nets, emu.nets):
                (rec,) = [r for r in net.drain_observations() if r.nbytes]
                (erec,) = [r for r in enet.drain_observations() if r.nbytes]
                assert (rec.nbytes, rec.raw_bytes) \
                    == (erec.nbytes, erec.raw_bytes)
                assert rec.nbytes == C.get_codec(codec).wire_bytes(
                    rec.raw_bytes // 4)
        stats = pipe.stage_stats()
        assert [s.device for s in stats] == ["cpu"] * 3
        assert all(s.launches == {} for s in stats)   # plain route, uncounted
        res = pipe.measure(lambda: torch.from_numpy(x), n_batches=4)
        assert res.transport == "socket" and res.partition == cuts
        assert res.latency_s > 0 and res.throughput > 0
        assert len(res.stage_exe_s) == 3 and all(t > 0 for t in res.stage_exe_s)
        assert len(res.hop_net_s) == 2 and all(0 < m < 100 for m in res.mem_pct)
    assert drain_violations() == []


# --------------------------------------------------------------------------- #
# Single-hop microbenchmark
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("codec", ["none", "int8"])
def test_measure_hop_over_socket(codec):
    """Receiver-measured per-transfer times at two payload sizes, the
    sink process unpacking each frame; wire bytes are the codec's."""
    sizes = [1024, 65536]
    out = measure_hop("socket", sizes, n_per_size=5, codec=codec,
                      full=True, device="cpu")
    assert sorted(out) == sizes
    for nbytes, recs in out.items():
        assert len(recs) == 5 and all(r.elapsed_s > 0 for r in recs)
        assert all(r.raw_bytes == nbytes for r in recs)
        assert all(r.nbytes == C.get_codec(codec).wire_bytes(nbytes // 4)
                   for r in recs)
