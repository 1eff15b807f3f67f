"""Sessions over the port's socket transport on the CPU: mid-stream
migration, worker death and replicated stages, with every hop sanitized.

Mirrors the reference's ``tests/test_session.py`` (migration matrix,
worker death) and ``tests/test_replicas.py`` (process replica matrix,
r = 2) on the ``tinycnn`` of ``test_torch_pipeline.py``, stages as
spawned worker processes.  Each result is held to the reference's
``CNNModel.apply`` within 1e-5 (fp32 sums in a different order, as in
``test_torch_cnn.py``); a lost, duplicated or reordered batch fails it
by far more.  Each test shares one pipeline standup between its cases.
"""
import time

import jax
import numpy as np
import pytest
import torch

from repro.models.cnn import layers as RL
from repro.models.cnn import zoo as RZ
from repro_torch.core.devices import LAN_PI_GPU
from repro_torch.models.cnn import layers as L
from repro_torch.models.cnn import zoo as Z
from repro_torch.runtime import EdgePipeline, TransportError, drain_violations

torch.set_num_threads(1)

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
def tiny():
    ref = _tiny(RL, RZ)
    params = ref.init(jax.random.PRNGKey(0))
    port = _tiny(L, Z).from_reference(jax.tree.map(np.asarray, params))
    xs = [np.random.default_rng(s).standard_normal((2, 32, 32, 3))
          .astype(np.float32) for s in range(10)]
    refs = [np.asarray(ref.apply(params, x)) for x in xs]
    return port, xs, refs


def _check(got, refs, what):
    assert len(got) == len(refs), f"lost/duplicated under {what}"
    for i, (y, want) in enumerate(zip(got, refs)):
        assert np.allclose(y.numpy(), want, rtol=0, atol=ATOL), \
            f"batch {i} wrong under {what} (reordered?)"


def test_migration_mid_stream_loses_nothing(tiny):
    """migrate() firing with batches in flight loses, duplicates and
    reorders nothing on worker processes, under the flush-first and the
    in-band-token policy, with the sanitizer armed on every hop."""
    port, xs, refs = tiny
    drain_violations()
    with EdgePipeline(port, 2, [LAN_PI_GPU], transport="socket",
                      sanitize=True, device="cpu") as pipe:
        pipe.warmup(torch.from_numpy(xs[0]))
        for policy, (a, b) in (("drain", (2, 3)), ("drop", (3, 2))):
            with pipe.session(inflight=4, policy=policy) as s:
                for x in xs[:4]:
                    s.submit(torch.from_numpy(x))  # fill the pipeline …
                s.migrate(b, cost_s=0.0)           # … then move the cut
                for x in xs[4:]:
                    s.submit(torch.from_numpy(x))
                got = s.drain()
            assert pipe.cuts == (b,)
            _check(got, refs, f"socket/{policy}")
        assert len(pipe.migrations) == 2
    bad = drain_violations()
    assert bad == [], "\n".join(v.render() for v in bad)


def test_worker_death_mid_stream_raises_from_results(tiny):
    """A worker process killed (SIGKILL) with batches in flight surfaces
    as TransportError from the session, within the liveness window, not
    a hang; close() leaves no live worker behind."""
    port, xs, _ = tiny
    x = torch.from_numpy(xs[0])
    pipe = EdgePipeline(port, (2, 3), [LAN_PI_GPU] * 2, transport="socket",
                        device="cpu", timeout_s=60.0)
    procs = list(pipe._engine._procs)
    try:
        pipe.warmup(x)
        t0 = time.perf_counter()
        with pytest.raises(TransportError, match="died|closed|gone"):
            with pipe.session(inflight=4) as s:
                s.submit(x)
                list(s.results())             # healthy round first
                procs[1].kill()
                procs[1].join(5.0)
                for _ in range(8):
                    s.submit(x)
                list(s.results())
        assert time.perf_counter() - t0 < 30.0
    finally:
        pipe.close()
    assert len(procs) == 3 and not any(p.is_alive() for p in procs)


def test_process_replica_matrix(tiny):
    """socket × drain/drop at r = 2: zero lost/dup/reordered results
    through a replicated middle stage, re-cut mid-stream, sanitized
    (the fan-in merge returns each broadcast token once)."""
    port, xs, refs = tiny
    drain_violations()
    with EdgePipeline(port, (2, 3), [LAN_PI_GPU] * 2, transport="socket",
                      replicas=(1, 2, 1), sanitize=True,
                      device="cpu") as pipe:
        pipe.warmup(torch.from_numpy(xs[0]))
        for policy in ("drain", "drop"):
            with pipe.session(inflight=4, policy=policy) as s:
                for x in xs[:4]:
                    s.submit(torch.from_numpy(x))  # fill the replica lanes …
                s.migrate((2, 4))                  # … re-cut mid-stream
                for x in xs[4:]:
                    s.submit(torch.from_numpy(x))
                got = s.drain()
            _check(got, refs, f"socket/r=2/{policy}")
            pipe.migrate((2, 3))              # restore for the next policy
        pipe.probe()                          # flushes stats and records
        stats = pipe.stage_stats()
        # both replicas' records fold into their ingress hop (a re-cut
        # stage starts its counters anew: only stage 0 kept its bounds)
        assert stats[0].calls == len(xs) * 2
        assert [n.total_transfers for n in pipe.nets] == [len(xs) * 2] * 2
    assert [s.device for s in stats] == ["cpu"] * 3
    bad = drain_violations()
    assert bad == [], "\n".join(v.render() for v in bad)
