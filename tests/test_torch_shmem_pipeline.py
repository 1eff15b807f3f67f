"""Pipelines over the port's ``shmem`` transport on the CPU: stages are
spawned worker processes, hops shared-memory doorbell rings.

Mirrors the reference's shmem pipeline cases: transport parity
(``tests/test_transport.py``, here against the port's own emulated
pipeline, every codec), worker death (``test_transport.py:191``,
``test_session.py:165``), the mid-stream migration matrix
(``test_session.py:131``) and the process replica matrix at r = 2 and 3
(``test_replicas.py:417``), every hop sanitized where the reference
sanitizes.  Tolerances:

  * shmem against emulated: bit for bit (``torch.equal``) for every
    codec — the same weights, cuts and wire transform;
  * results against the reference's ``CNNModel.apply``: 1e-5
    (``_torch_tiny``); a lost, duplicated or reordered batch misses it
    by far more.
"""
import time

import pytest
import torch
from _torch_tiny import batches, check, references, tiny_models

from repro_torch.core import codecs as C
from repro_torch.core.devices import LAN_PI_GPU, Link
from repro_torch.runtime import EdgePipeline, TransportError, drain_violations

torch.set_num_threads(1)

FAST = dict(name="fast", rtt_s=2e-5, bw_bytes_per_s=1e10)


@pytest.fixture(scope="module")
def models():
    return tiny_models()


@pytest.fixture(scope="module")
def stream(models):
    xs = batches(10)
    return [torch.from_numpy(x) for x in xs], references(models, xs)


def test_shmem_pipeline_matches_emulated_for_every_codec(models, stream):
    """One 3-stage shmem pipeline switches its codec in place (a
    quiescent migrate with the cuts unchanged) through none, int8, fp8
    and topk; each output equals the emulated pipeline's bit for bit,
    each hop's wire and raw bytes equal the emulated records, and the
    uncoded output equals the reference's apply."""
    _, _, port = models
    xs, refs = stream
    cuts, links = (1, 3), [Link(**FAST)] * 2
    drain_violations()
    with EdgePipeline(port, cuts, links, transport="shmem", device="cpu",
                      sanitize=True) as pipe:
        assert pipe.transport == "shmem"
        pipe.warmup(xs[0])
        for codec in ("none", "int8", "fp8", "topk"):
            if codec != "none":
                pipe.migrate(cuts, codecs=(codec, codec))
            emu = EdgePipeline(port, cuts, links, codec=codec, device="cpu")
            got, lat, hops = pipe.run_one(xs[0])
            alone, _, _ = emu.run_one(xs[0])
            assert lat > 0 and len(hops) == 2 and all(h > 0 for h in hops)
            assert torch.equal(got, alone), codec
            if codec == "none":
                check([got], refs[:1], "shmem/none")
            for net, enet in zip(pipe.nets, emu.nets):
                (rec,) = [r for r in net.drain_observations() if r.nbytes]
                (erec,) = [r for r in enet.drain_observations() if r.nbytes]
                assert (rec.nbytes, rec.raw_bytes) \
                    == (erec.nbytes, erec.raw_bytes)
                assert rec.nbytes == C.get_codec(codec).wire_bytes(
                    rec.raw_bytes // 4)
        stats = pipe.stage_stats()
        assert [s.device for s in stats] == ["cpu"] * 3
        res = pipe.measure(lambda: xs[0], n_batches=4)
        assert res.transport == "shmem" and res.partition == cuts
        assert res.latency_s > 0 and res.throughput > 0
        assert len(res.stage_exe_s) == 3 and all(t > 0 for t in res.stage_exe_s)
        standup = pipe._engine.standup
        assert len(standup["workers"]) == 3 and standup["total_s"] > 0
        assert all(w["spawn_s"] > 0 and w["build_s"] >= 0
                   for w in standup["workers"])
    assert drain_violations() == []


def test_worker_process_death_raises_not_hangs(models, stream):
    """A worker process dying mid-stream must surface as TransportError
    within the liveness window, not hang the orchestrator: the shmem path
    has no EOF, so liveness polling and the bounded slot wait are all
    there is."""
    _, _, port = models
    xs, _ = stream
    pipe = EdgePipeline(port, (2, 3), [LAN_PI_GPU] * 2, transport="shmem",
                        device="cpu", timeout_s=60.0)
    try:
        pipe.warmup(xs[0])
        pipe._engine._procs[1].terminate()
        pipe._engine._procs[1].join(5.0)
        t0 = time.perf_counter()
        with pytest.raises(TransportError, match="died|closed|gone"):
            pipe.stream(xs[0], n_batches=6)
        assert time.perf_counter() - t0 < 30.0
    finally:
        pipe.close()


def test_migration_mid_stream_loses_nothing(models, stream):
    """migrate() firing with batches in flight loses, duplicates and
    reorders nothing over shmem, under the flush-first and the
    in-band-token policy, with the sanitizer armed on every hop."""
    _, _, port = models
    xs, refs = stream
    drain_violations()
    with EdgePipeline(port, 2, [LAN_PI_GPU], transport="shmem",
                      sanitize=True, device="cpu") as pipe:
        pipe.warmup(xs[0])
        for policy, b in (("drain", 3), ("drop", 2)):
            with pipe.session(inflight=4, policy=policy) as s:
                for x in xs[:4]:
                    s.submit(x)               # fill the pipeline …
                s.migrate(b, cost_s=0.0)      # … then move the cut
                for x in xs[4:]:
                    s.submit(x)
                got = s.drain()
            assert pipe.cuts == (b,)
            check(got, refs, f"shmem/{policy}")
        assert len(pipe.migrations) == 2
    bad = drain_violations()
    assert bad == [], "\n".join(v.render() for v in bad)


def test_worker_death_mid_stream_raises_from_results(models, stream):
    """A worker process dying with batches in flight must surface as
    TransportError from the session (submit backpressure or results()),
    not hang; close() leaves no live worker."""
    _, _, port = models
    xs, _ = stream
    pipe = EdgePipeline(port, (2, 3), [LAN_PI_GPU] * 2, transport="shmem",
                        device="cpu", timeout_s=60.0)
    procs = list(pipe._engine._procs)
    try:
        pipe.warmup(xs[0])
        t0 = time.perf_counter()
        with pytest.raises(TransportError, match="died|closed|gone"):
            with pipe.session(inflight=4) as s:
                s.submit(xs[0])
                list(s.results())             # healthy round first
                procs[1].terminate()
                procs[1].join(5.0)
                for _ in range(8):
                    s.submit(xs[0])
                list(s.results())
        assert time.perf_counter() - t0 < 30.0
    finally:
        pipe.close()
    assert not any(p.is_alive() for p in procs)


@pytest.mark.parametrize("r", [2, 3])
def test_process_replica_matrix(models, stream, r):
    """shmem × drain/drop × r: zero lost/dup/reordered results through a
    replicated middle stage (its lanes packed into one control segment),
    re-cut mid-stream, sanitized — both policies share one standup."""
    _, _, port = models
    xs, refs = stream
    drain_violations()
    with EdgePipeline(port, (2, 3), [LAN_PI_GPU] * 2, transport="shmem",
                      replicas=(1, r, 1), sanitize=True,
                      device="cpu") as pipe:
        pipe.warmup(xs[0])
        for policy in ("drain", "drop"):
            with pipe.session(inflight=4, policy=policy) as s:
                for x in xs[:4]:
                    s.submit(x)               # fill the replica lanes …
                s.migrate((2, 4))             # … re-cut mid-stream
                for x in xs[4:]:
                    s.submit(x)
                got = s.drain()
            check(got, refs, f"shmem/r={r}/{policy}")
            pipe.migrate((2, 3))              # restore for the next policy
    bad = drain_violations()
    assert bad == [], "\n".join(v.render() for v in bad)
