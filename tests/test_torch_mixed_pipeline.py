"""The end-to-end parity test the port is held to: the JAX reference and
the PyTorch port speak one wire protocol, so their socket ends and their
worker processes interoperate.  CPU only (both packages in one test
process, JAX on the CPU).

  * **Frames.**  A reference ``SocketChannel`` end and a port end share
    one TCP connection and exchange frames both ways, for every framing
    (raw, pickle, object, empty) and every codec (none, int8, fp8,
    topk).  Each package's frame for the same input is read off the
    wire: every header field but the send stamp, and every payload byte,
    must be equal.  What each end decodes must equal, bit for bit, what
    the sender's own package decodes from its frame.
  * **Pipeline.**  A two-stage ``tinycnn``: one stage is the reference's
    ``_worker_main`` in a spawned process, the other the port's, with
    this test as the orchestrator; then the stages swap.  The output
    equals the reference's ``CNNModel.apply`` within 1e-5 (fp32 sums in
    a different order, as in ``test_torch_cnn.py``).
"""
import multiprocessing as mp
import socket

import jax
import numpy as np
import pytest
import torch

from repro.models.cnn import layers as RL
from repro.models.cnn import zoo as RZ
from repro.runtime import transport as RT
from repro_torch.models.cnn import layers as L
from repro_torch.models.cnn import zoo as Z
from repro_torch.runtime import edge as E
from repro_torch.runtime import transport as T

torch.set_num_threads(1)

ATOL = 1e-5
TIMEOUT_S = 60.0


def _connection() -> tuple[socket.socket, socket.socket]:
    """Both ends of one loopback TCP connection."""
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    a = socket.create_connection(lst.getsockname())
    b, _ = lst.accept()
    lst.close()
    return a, b


def _read_exact(sock: socket.socket, n: int) -> bytes:
    out = bytearray()
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        assert chunk, "peer closed mid-frame"
        out += chunk
    return bytes(out)


def _on_the_wire(end, payload, kind) -> tuple:
    """Send ``payload`` from ``end`` (a fresh channel end whose socket is
    one side of a connection) and read the frame raw off the other side
    → (header fields without the send stamp, meta bytes, payload
    bytes)."""
    tx, raw = _connection()
    raw.settimeout(TIMEOUT_S)
    end._tx = tx
    tx.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    try:
        end.send(payload, kind=kind)
        hdr = T._FHDR.unpack(_read_exact(raw, T._FHDR.size))
        (ftype, k, code, ndim, ccode, mlen, _t0, plen, seq, *shape) = hdr
        meta = _read_exact(raw, mlen) if mlen else b""
        data = _read_exact(raw, plen) if plen else b""
    finally:
        tx.close()
        raw.close()
    return (ftype, k, code, ndim, ccode, mlen, plen, seq, *shape), meta, data


def _ends(framing: str, codec: str):
    """(reference end, port end) on one connection, the hop's framing
    and codec on both."""
    a, b = _connection()
    ref = RT.SocketChannel(RT.HopSpec(index=0, framing=framing, codec=codec),
                           sock=a)
    port = T.SocketChannel(T.HopSpec(index=0, framing=framing, codec=codec),
                           sock=b)
    return ref, port


X = np.random.default_rng(3).standard_normal((2, 5, 7)).astype(np.float32)
# (name, framing, codec, kind, payload as numpy/plain object)
CASES = [
    *[(f"raw-{c}", "raw", c, T.BATCH, X) for c in ("none", "int8", "fp8",
                                                    "topk")],
    ("raw-int32", "raw", "int8", T.BATCH, np.arange(12, dtype=np.int32)),
    ("pickle", "pickle", "none", T.BATCH, X),
    ("object", "raw", "none", T.RECONFIG,
     {"bounds": (0, 2, 5), "codecs": ("int8",)}),
    ("empty", "raw", "none", T.PROBE, None),
]


def _port_payload(p):
    return torch.from_numpy(p) if isinstance(p, np.ndarray) else p


def _same(got, want) -> bool:
    """Bit-for-bit equality of a decoded payload (tensor or array) with
    the other package's, or plain equality for objects."""
    if want is None or isinstance(want, dict):
        return got == want
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return (got.shape == want.shape and got.dtype == want.dtype
            and got.tobytes() == want.tobytes())


@pytest.mark.parametrize("name,framing,codec,kind,payload", CASES,
                         ids=[c[0] for c in CASES])
def test_frames_equal_on_the_wire(name, framing, codec, kind, payload):
    ref_hop = RT.HopSpec(index=0, framing=framing, codec=codec)
    port_hop = T.HopSpec(index=0, framing=framing, codec=codec)
    ref_frame = _on_the_wire(RT.SocketChannel(ref_hop, _pair=(None, None)),
                             payload, kind)
    port_frame = _on_the_wire(T.SocketChannel(port_hop, _pair=(None, None)),
                              _port_payload(payload), kind)
    assert port_frame == ref_frame


@pytest.mark.parametrize("name,framing,codec,kind,payload", CASES,
                         ids=[c[0] for c in CASES])
def test_frames_decode_across_packages_both_ways(name, framing, codec, kind,
                                                 payload):
    ref, port = _ends(framing, codec)
    try:
        # what each package decodes from its own frame
        own_ref = RT._unframe(*_own(RT, ref.hop, payload, kind))
        own_port = T._unframe(*_own(T, port.hop, _port_payload(payload),
                                    kind), "cpu")
        ref.send(payload, kind=kind)
        k, got = port.recv(timeout=TIMEOUT_S)
        assert k == kind and _same(got, own_ref)
        port.send(_port_payload(payload), kind=kind)
        k, back = ref.recv(timeout=TIMEOUT_S)
        assert k == kind and _same(own_port, back)
        # a second round: the wire seq counters advance in step
        ref.send(payload, kind=kind)
        assert port.recv(timeout=TIMEOUT_S)[0] == kind
        if kind in (T.BATCH, T.PROBE):
            recs = port.drain_records() + ref.drain_records()
            assert len(recs) == 3 and all(r.elapsed_s > 0 for r in recs)
    finally:
        ref.close()
        port.close()


def _own(pkg, hop, payload, kind) -> tuple:
    """A package's frame for ``payload`` as ``_unframe``'s arguments."""
    codec = (pkg.SocketChannel(hop, _pair=(None, None))._send_codec(kind))
    ftype, code, shape, data, meta, ccode = pkg._frame(payload, hop.framing,
                                                       codec)
    return ftype, code, tuple(shape), bytes(data), meta, ccode


# --------------------------------------------------------------------------- #
# A two-stage pipeline of one reference and one port worker process
# --------------------------------------------------------------------------- #
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
    params_np = jax.tree.map(np.asarray, params)
    port = _tiny(L, Z).from_reference(params_np)
    return ref, params, params_np, port


def _hop_end(pkg, index: int, sock, tx: bool):
    """One end of channel ``index`` (-1: feed, 1: result) in ``pkg``."""
    hop = pkg.HopSpec(index=index, scenario_hop=index == 0)
    return pkg.SocketChannel(hop, _pair=(sock, None) if tx else (None, sock))


@pytest.mark.parametrize("order", [("ref", "port"), ("port", "ref")],
                         ids=["ref-then-port", "port-then-ref"])
def test_mixed_two_stage_pipeline_matches_reference(models, order):
    ref_model, params, params_np, port_model = models
    pkgs = {"ref": RT, "port": T}
    cut, n = 2, len(port_model.blocks)
    x = np.random.default_rng(7).standard_normal((2, 32, 32, 3)) \
        .astype(np.float32)
    want = np.asarray(ref_model.apply(params, x))
    # channel j carries stage j-1 -> stage j; the test feeds stage 0 and
    # drains stage 1, each end in the package of the stage it touches
    owners = [("test", order[0]), order, (order[1], "test")]
    pairs = []
    for j, (left, right) in enumerate(owners):
        a, b = _connection()
        pairs.append((
            _hop_end(pkgs[order[0]] if left == "test" else pkgs[left],
                     j - 1, a, tx=True),
            _hop_end(T if right == "test" else pkgs[right], j - 1, b,
                     tx=False)))
    ctx = mp.get_context("spawn")
    stop = ctx.Event()
    procs, ctrls = [], []
    skeleton, state = E.ship_model(port_model)
    for i, who in enumerate(order):
        parent_c, child_c = ctx.Pipe()
        spec = {"stage": i, "n_stages": 2, "bounds": (0, cut, n),
                "backend": "lightweight", "ctrl": child_c, "stop": stop,
                "ingress": pairs[i][1], "egress": pairs[i + 1][0],
                "pace_s": 0.0}
        if who == "ref":
            spec.update(model=ref_model, params=params_np)
        else:
            spec.update(model=skeleton, state=state, device="cpu",
                        numerics=E.numerics())
        p = ctx.Process(target=pkgs[who]._worker_main, args=(spec,),
                        daemon=True, name=f"mixed-{who}{i}")
        p.start()
        child_c.close()
        procs.append(p)
        ctrls.append(parent_c)
    feed, result = pairs[0][0], pairs[2][1]
    for j, (tx, rx) in enumerate(pairs):      # the children own these now
        if j != 0:
            tx.close()
        if j != 2:
            rx.close()
    try:
        for c in ctrls:
            assert c.poll(TIMEOUT_S), "a stage failed to start"
            assert c.recv()[0] == "ready"
        feed_x = x if order[0] == "ref" else torch.from_numpy(x)
        feed.send(feed_x, kind=T.WARMUP)
        assert result.recv(timeout=TIMEOUT_S)[0] == T.WARMUP
        feed.send(feed_x, kind=T.BATCH)
        kind, y = result.recv(timeout=TIMEOUT_S)
        assert kind == T.BATCH and tuple(y.shape) == want.shape
        np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=ATOL)
        feed.send(kind=T.STATS)
        assert result.recv(timeout=TIMEOUT_S)[0] == T.STATS
        for i, c in enumerate(ctrls):
            assert c.poll(TIMEOUT_S)
            tag, stage, d, _, records = c.recv()
            assert (tag, stage, d["calls"]) == ("stats", i, 1)
            if i == 1:                        # the mixed hop, receiver-measured
                assert [r[0] for r in records] == [2 * 32 * 32 * 8 * 4]
        feed.send(kind=T.STOP)
        assert result.recv(timeout=TIMEOUT_S)[0] == T.STOP
        for p in procs:
            p.join(TIMEOUT_S)
            assert p.exitcode == 0
    finally:
        stop.set()
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        feed.close()
        result.close()
        for c in ctrls:
            c.close()
    assert not any(p.is_alive() for p in procs)
