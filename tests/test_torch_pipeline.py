"""The port's ``EdgePipeline`` on the CPU against the reference's.

Both pipelines run the reference tests' ``tinycnn`` with the same
weights (``from_reference``) over fast emulated links.  Tolerances:

  * ``codec="none"``: rtol 1e-4, atol 1e-5 — the per-block parity of
    ``test_torch_cnn.py`` (fp32 sums in a different order);
  * lossy codecs: equal top-1 on every sample, and the worst output
    difference at most 0.5 % of the largest output magnitude.  Both
    packages apply the same wire transform, but to activations that
    differ in their last bits, so a value near a rounding boundary can
    land one quantization step (about max|a|/127 for int8) away, or a
    near-tie can swap which elements top-k keeps.  On these inputs no
    such flip happens and the difference is about 5e-7 of the output.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.devices import Link as RLink
from repro.models.cnn import layers as RL
from repro.models.cnn import zoo as RZ
from repro.runtime import EdgePipeline as RefPipeline
from repro_torch.core import codecs as C
from repro_torch.core.devices import Link
from repro_torch.models.cnn import layers as L
from repro_torch.models.cnn import zoo as Z
from repro_torch.runtime import EdgePipeline
from repro_torch.runtime import transport as T

# one intra-op thread: the suite runs in parallel worker processes,
# and torch's default of one thread per core oversubscribes the host
torch.set_num_threads(1)

FAST = dict(name="fast", rtt_s=2e-5, bw_bytes_per_s=1e10)
RTOL, ATOL = 1e-4, 1e-5
LOSSY_REL = 5e-3


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


def _batches(n, batch=2, hw=32, seed=100):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, hw, hw, 3)).astype(np.float32)
            for _ in range(n)]


def _pipes(models, cuts, codec, backend="lightweight"):
    ref, params, port = models
    k = len(cuts)
    ref_pipe = RefPipeline(ref, params, cuts, [RLink(**FAST)] * k,
                           backend=backend, codec=codec)
    pipe = EdgePipeline(port, cuts, [Link(**FAST)] * k, backend=backend,
                        codec=codec, device="cpu")
    return ref_pipe, pipe


def _check(got: torch.Tensor, want, codec: str) -> None:
    want = np.asarray(want)
    got = got.numpy()
    if codec == "none":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        return
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    assert np.abs(got - want).max() <= LOSSY_REL * np.abs(want).max()


@pytest.mark.parametrize("codec", ["none", "int8", "fp8", "topk"])
def test_run_one_matches_reference(models, codec):
    ref_pipe, pipe = _pipes(models, (1, 3), codec)
    (x,) = _batches(1)
    want, _, _ = ref_pipe.run_one(x)
    got, lat, hops = pipe.run_one(torch.from_numpy(x))
    assert lat > 0 and len(hops) == 2
    _check(got, want, codec)


def test_one_codec_per_hop_and_wire_accounting(models):
    """The slice's shape: a different codec on every hop; each record's
    wire bytes are the codec's analytic size, below the raw bytes."""
    codecs = ("int8", "fp8", "topk")
    ref_pipe, pipe = _pipes(models, (1, 2, 3), codecs)
    xs = _batches(3)
    for x in xs:
        want, _, _ = ref_pipe.run_one(x)
        got, _, _ = pipe.run_one(torch.from_numpy(x))
        _check(got, want, "lossy")
    for net, ref_net, name in zip(pipe.nets, ref_pipe.nets, codecs):
        recs = [r for r in net.drain_observations() if r.nbytes > 0]
        ref_recs = [r for r in ref_net.drain_observations() if r.nbytes > 0]
        assert len(recs) == len(xs)
        assert [(r.nbytes, r.raw_bytes) for r in recs] \
            == [(r.nbytes, r.raw_bytes) for r in ref_recs]
        for r in recs:
            assert r.raw_bytes >= r.nbytes
            assert r.nbytes == C.get_codec(name).wire_bytes(r.raw_bytes // 4)


def test_session_results_in_order_match_reference(models):
    ref_pipe, pipe = _pipes(models, (2,), "int8")
    xs = _batches(5, seed=7)
    with ref_pipe.session(inflight=3) as s:
        for x in xs:
            s.submit(x)
        want = s.drain()
    with pipe.session(inflight=3) as s:
        for x in xs:
            s.submit(torch.from_numpy(x))
        got = s.drain()
        assert [r.batch_idx for r in s.records] == list(range(len(xs)))
    assert len(got) == len(want) == len(xs)
    for g, w in zip(got, want):
        _check(g, w, "int8")


@pytest.mark.parametrize("policy", ["drain", "drop"])
def test_session_migrates_mid_stream_losing_nothing(models, policy):
    """A migration with batches in flight (and a codec switch) loses,
    duplicates and reorders nothing: every result equals the batch run
    alone under the cut vector it was submitted with."""
    _, pipe = _pipes(models, (1,), "none")
    xs = [torch.from_numpy(x) for x in _batches(6, seed=11)]
    with pipe.session(inflight=3, policy=policy) as s:
        for i, x in enumerate(xs):
            s.submit(x)
            if i == 2:
                s.migrate((3,), codecs=("int8",))
        got = s.drain()
        cuts = [r.cuts for r in s.records]
    assert len(got) == len(xs) and cuts[0] == (1,) and cuts[-1] == (3,)
    for g, x, c in zip(got, xs, cuts):
        _, alone = _pipes(models, c, "none" if c == (1,) else "int8")
        assert torch.equal(g, alone.run_one(x)[0])


def test_measure_reports_every_stage(models):
    _, pipe = _pipes(models, (1, 3), ("fp8", "topk"))
    (x,) = _batches(1, seed=3)
    res = pipe.measure(lambda: torch.from_numpy(x), n_batches=4)
    assert res.partition == (1, 3) and res.transport == "emulated"
    assert len(res.stage_exe_s) == 3 and all(t > 0 for t in res.stage_exe_s)
    assert res.latency_s > 0 and res.throughput > 0
    assert len(res.hop_net_s) == 2 and all(0 < m < 100 for m in res.mem_pct)


def test_rpc_backend_matches_lightweight(models):
    _, light = _pipes(models, (1, 3), "none")
    _, rpc = _pipes(models, (1, 3), "none", backend="rpc")
    (x,) = _batches(1, seed=4)
    a, _, _ = light.run_one(torch.from_numpy(x))
    b, _, _ = rpc.run_one(torch.from_numpy(x))
    assert torch.equal(a, b)
    assert rpc.backend == "rpc"
    rec = [r for r in rpc.nets[0].drain_observations() if r.nbytes > 0]
    assert rec and rec[0].nbytes > 2 * 32 * 32 * 8 * 4    # pickled frame


def test_replicated_stage_keeps_order(models):
    """A stage staffed twice: batches stripe over two lanes and merge
    back in submit order."""
    ref, params, port = models
    pipe = EdgePipeline(port, (1, 3), [Link(**FAST)] * 2,
                        replicas=(1, 2, 1), codec="fp8", device="cpu")
    xs = _batches(4, seed=9)
    with pipe.session(inflight=4) as s:
        for x in xs:
            s.submit(torch.from_numpy(x))
        got = s.drain()
    for g, x in zip(got, xs):
        alone, _, _ = _pipes(models, (1, 3), "fp8")[1].run_one(
            torch.from_numpy(x))
        assert torch.equal(g, alone)
    assert len(pipe.workers) == 4 and pipe.nets[0].total_transfers == 4


def test_quiescent_migrate(models):
    ref_pipe, pipe = _pipes(models, (1,), "none")
    (x,) = _batches(1, seed=5)
    before, _, _ = pipe.run_one(torch.from_numpy(x))
    assert pipe.migrate((3,), codecs=("int8",)) == (3,)
    assert pipe.codecs == ("int8",) and pipe.migrations[-1][1:] == ((1,), (3,))
    after, _, _ = pipe.run_one(torch.from_numpy(x))
    ref_pipe.migrate((3,), codecs=("int8",))
    want, _, _ = ref_pipe.run_one(x)
    _check(after, want, "int8")
    assert pipe.migrate((1,), codecs=("none",)) == (1,)
    again, _, _ = pipe.run_one(torch.from_numpy(x))
    assert torch.equal(before, again)


def test_default_device_without_cuda_raises(models):
    """The pipeline runs on the card unless the caller asks for the CPU:
    where CUDA is not available, the default device raises instead of
    falling back."""
    _, _, port = models
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            EdgePipeline(port, (2,), [Link(**FAST)])


def test_cpu_worker_owns_no_stream_and_times_as_before(models):
    """On the CPU a stage has no CUDA stream and no hop event: ``run``
    computes its blocks, counts the call and charges its wall time (its
    pace floor included), as before stages had streams."""
    _, _, port = models
    _, pipe = _pipes(models, (1, 3), "int8")
    assert [w.stream for w in pipe.workers] == [None] * 3
    w = pipe.workers[1]
    w.pace_s = 0.02
    x = port.apply_range(torch.from_numpy(_batches(1, seed=6)[0]), 0, 1)
    assert torch.equal(w.run(x), port.apply_range(x, 1, 3))
    assert w.stats.calls == 1 and w.stats.exe_s >= 0.02
    assert T.ready_event(x) is None and T.await_ready(x, None) is x
