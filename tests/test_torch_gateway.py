"""The port's serving gateway on the emulated transport, on the CPU.

Mirrors the reference's ``tests/test_gateway.py`` (QoS decomposition,
SLO-aware AIMD, fleet objectives, cancellation through the CANCEL
fence, the deep-sanitize tier, the tenant-mix registry, bad requests)
on the ``tinycnn`` of ``tests/_torch_tiny.py``; the {socket, shmem}
matrix and the worker kill are in ``test_torch_gateway_matrix.py``.
Every tenant's results must be bit-identical (``torch.equal``) to a
solo run of the same requests through the port, and each solo result
is held to the reference's ``CNNModel.apply`` within ``ATOL``.

Two cases go beyond the reference's file: the same requests through the
JAX ``Gateway`` and the port's coalesce into the same micro-batches
(equal ``QoSRecord`` bookkeeping, results within 1e-5), and a hop with a
lossy codec, whose per-tensor scale couples the rows of a batch, still
gives every tenant its solo bits.
"""
import numpy as np
import pytest
import torch

from _torch_tenants import (MAX_BATCH, N_REQS, NAMES, assert_solo_bits,
                            requests, solo, tensors)
from _torch_tiny import ATOL, tiny_models
from repro_torch.core import scenarios
from repro_torch.core.autosplit import AdaptiveSplitter
from repro_torch.core.devices import LAN_PI_GPU
from repro_torch.runtime import (EdgePipeline, FleetController, Gateway,
                                 QoSRecord, drain_qos, drain_violations)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    return tiny_models()


def _pipe(port, **kw):
    return EdgePipeline(port, 2, [LAN_PI_GPU], sanitize=True, device="cpu",
                        **kw)


@pytest.fixture(scope="module")
def solo_refs(models):
    """The bit-identity baseline: every tenant alone (emulated), each
    result held to the reference's forward pass of its request."""
    ref, params, port = models
    reqs = requests()
    pipe = _pipe(port)
    ts = tensors(reqs)
    pipe.warmup(ts[NAMES[0]][0])
    refs = solo(pipe, ts)
    pipe.close()
    for n in NAMES:
        for x, (_, y) in zip(reqs[n], refs[n]):
            assert np.allclose(y.numpy(), np.asarray(ref.apply(params, x)),
                               rtol=0, atol=ATOL)
    assert drain_violations() == []
    return ts, refs


# --------------------------------------------------------------------------- #
# QoS decomposition
# --------------------------------------------------------------------------- #
def test_qos_records_decompose_latency(models):
    port = models[2]
    reqs = tensors(requests())
    drain_qos()
    pipe = _pipe(port)
    pipe.warmup(reqs[NAMES[0]][0])
    mix = scenarios.get_tenant_mix("duo_uniform")
    with Gateway(pipe, mix, max_batch=MAX_BATCH, batch_window_s=0.0) as gw:
        for j in range(N_REQS):
            for t in mix.tenants:
                gw.submit(t.name, reqs[t.name][j])
        gw.drain()
        qos = gw.drain_qos()
    assert len(qos) == 2 * N_REQS
    for r in qos:
        assert isinstance(r, QoSRecord)
        assert r.queue_s >= 0 and r.service_s > 0
        assert r.latency_s == pytest.approx(r.queue_s + r.service_s)
        assert 0 <= r.wire_s <= r.service_s + 1e-9
        assert r.rows == 1 and 1 <= r.coalesced <= MAX_BATCH
        assert 0 < r.occupancy <= 1
        assert r.slo_s == gw.tenants[r.tenant].slo_s
        assert r.violated == (r.latency_s > r.slo_s)
    # gateway-scoped drain already claimed them: the global log is clean
    assert drain_qos() == []
    assert drain_violations() == []
    pipe.close()


# --------------------------------------------------------------------------- #
# SLO-aware AIMD admission
# --------------------------------------------------------------------------- #
def test_aimd_window_throttles_then_recovers(models):
    """An SLO-violating tenant drives multiplicative decrease down to a
    1-batch window; clean traffic afterwards grows it back additively."""
    port = models[2]
    reqs = tensors(requests())
    pipe = _pipe(port)
    pipe.warmup(reqs[NAMES[0]][0])
    tenants = [scenarios.TenantSpec("hot", slo_s=1e-9),   # always violates
               scenarios.TenantSpec("cool", slo_s=30.0)]  # never does
    with Gateway(pipe, tenants, max_batch=MAX_BATCH, batch_window_s=0.0,
                 inflight=4, ai_every=1) as gw:
        cap = gw.inflight_window
        assert cap >= 2
        for j in range(N_REQS):               # phase 1: violations
            gw.submit("hot", reqs[NAMES[0]][j])
            gw.drain()
        assert gw.inflight_window == 1        # halved to the floor
        assert gw.session.inflight == 1       # applied to the session
        for j in range(N_REQS * 2):           # phase 2: clean traffic
            gw.submit("cool", reqs[NAMES[1]][j % N_REQS])
            gw.drain()
        assert gw.inflight_window > 1         # additive recovery
        assert gw.inflight_window <= cap
        # history records both directions of the excursion
        wins = [w for _, w in gw.window_history]
        assert min(wins) == 1 and wins[0] == cap and wins[-1] > 1
        qos = gw.drain_qos()
        assert all(r.violated for r in qos if r.tenant == "hot")
        assert not any(r.violated for r in qos if r.tenant == "cool")
    assert drain_violations() == []
    pipe.close()


# --------------------------------------------------------------------------- #
# fleet-level objectives
# --------------------------------------------------------------------------- #
def test_fleet_controller_aggregates_and_steers(models):
    port = models[2]
    reqs = tensors(requests())
    scen = scenarios.get("pi_pi_gpu")
    graph = port.block_graph(input_hw=32)
    # hysteresis ~1: the fleet axis steers the policy, but no migration
    # fires — delivery determinism is owned by the matrix tests
    splitter = AdaptiveSplitter(graph, scen, batch=MAX_BATCH,
                                policy="throughput", hysteresis=0.99)
    splitter.current = splitter.solve()
    ctrl = FleetController(splitter, check_every=2, probe=False)
    pipe = EdgePipeline(port, splitter.current.partition, scen,
                        sanitize=True, device="cpu")
    pipe.warmup(reqs[NAMES[0]][0])
    mix = scenarios.get_tenant_mix("octet_mixed_slo")
    with Gateway(pipe, mix, controller=ctrl, max_batch=MAX_BATCH,
                 batch_window_s=0.005) as gw:
        for j in range(N_REQS):
            for t in mix.tenants:
                gw.submit(t.name, reqs[t.name][j])
        gw.drain()
        obj = ctrl.fleet_objectives()
        assert obj is not None
        assert obj.n == len(gw.qos_recent)
        assert obj.p99_s >= obj.p50_s > 0
        assert obj.aggregate_ips > 0
        assert obj.j_per_request >= 0
        assert 0 <= obj.violation_rate <= 1
        assert obj.strictest_slo_s == min(t.slo_s for t in mix.tenants)
        assert obj.policy in ("latency", "throughput")
        assert obj.policy == splitter.policy  # the steer was applied
        assert ctrl.fleet_history             # one per control decision
        gw.drain_qos()
    assert drain_violations() == []
    pipe.close()


# --------------------------------------------------------------------------- #
# cancellation through the gateway
# --------------------------------------------------------------------------- #
def test_gateway_cancel_resubmit_and_skip(models, solo_refs):
    reqs, refs = solo_refs
    port = models[2]
    pipe = _pipe(port)
    pipe.warmup(reqs[NAMES[0]][0])
    mix = scenarios.get_tenant_mix("duo_uniform")
    names = [t.name for t in mix.tenants]
    with Gateway(pipe, mix, max_batch=4, batch_window_s=0.0) as gw:
        clients = {n: gw.client(n) for n in names}
        for j in range(N_REQS):
            for n in names:
                clients[n].submit(reqs[n][j])
        flushed = gw.cancel_inflight(action="resubmit")
        got = {n: clients[n].drain() for n in names}
        # every flushed request redelivered, in order, bit-identical
        # (max_batch 4 pads to a different batch shape than the solo
        # runs' 8; the port's CPU convolutions give the same bits)
        assert_solo_bits(got, refs, names, "cancel-resubmit")
        # skip: flushed requests surface as (req_id, None) placeholders
        for n in names:
            clients[n].submit(reqs[n][0])
        flushed2 = gw.cancel_inflight(action="skip")
        got2 = {n: clients[n].drain() for n in names}
        skipped = [rv for n in names for rv in got2[n] if rv[1] is None]
        assert len(skipped) == flushed2
        assert flushed >= 0 and flushed2 >= 0
        # per-tenant order holds across the skip: ids run on from N_REQS
        for n in names:
            assert [r for r, _ in got2[n]] == [N_REQS]
        # the fence is async: pump the discarded arrivals home, then
        # every CancelRecord must show its batch flushed
        gw.session.drain()
        cancels = gw.session.drain_cancels()
        assert all(c.flushed for c in cancels)
    assert drain_violations() == []
    pipe.close()


# --------------------------------------------------------------------------- #
# deep sanitize tier, end to end
# --------------------------------------------------------------------------- #
def test_gateway_clean_under_deep_sanitize(models, solo_refs, monkeypatch):
    """``REPRO_SANITIZE_DEEP=1``: full-payload crc32 fingerprints on
    every sanitized hop.  A clean mixed run must stay silent — and still
    be bit-identical to solo."""
    reqs, refs = solo_refs
    port = models[2]
    monkeypatch.setenv("REPRO_SANITIZE_DEEP", "1")
    pipe = _pipe(port)
    pipe.warmup(reqs[NAMES[0]][0])
    mix = scenarios.get_tenant_mix("duo_uniform")
    names = [t.name for t in mix.tenants]
    with Gateway(pipe, mix, max_batch=MAX_BATCH, batch_window_s=0.0) as gw:
        clients = {n: gw.client(n) for n in names}
        for j in range(N_REQS):
            for n in names:
                clients[n].submit(reqs[n][j])
        got = {n: clients[n].drain() for n in names}
    assert_solo_bits(got, refs, names, "deep sanitize")
    assert drain_violations() == []
    pipe.close()


# --------------------------------------------------------------------------- #
# tenant-mix specs
# --------------------------------------------------------------------------- #
def test_tenant_mix_registry_and_validation():
    for name in ("duo_uniform", "duo_bursty", "octet_uniform",
                 "octet_bursty", "octet_mixed_slo"):
        mix = scenarios.get_tenant_mix(name)
        assert mix.n_tenants in (2, 8)
        assert len({t.name for t in mix.tenants}) == mix.n_tenants
        assert all(t.slo_s > 0 and t.weight > 0 and t.burst >= 1
                   for t in mix.tenants)
    with pytest.raises(KeyError):
        scenarios.get_tenant_mix("nope")
    with pytest.raises(ValueError):
        scenarios.TenantSpec("t", slo_s=-1.0)
    mix = scenarios.get_tenant_mix("octet_mixed_slo")
    assert mix.spec("tenant0").slo_s != mix.spec("tenant7").slo_s


def test_gateway_rejects_bad_requests(models):
    port = models[2]
    pipe = EdgePipeline(port, 2, [LAN_PI_GPU], device="cpu")
    with Gateway(pipe, [scenarios.TenantSpec("a")], max_batch=2) as gw:
        with pytest.raises(KeyError, match="unknown tenant"):
            gw.submit("nope", torch.zeros((1, 32, 32, 3)))
        with pytest.raises(ValueError, match="exceeds"):
            gw.submit("a", torch.zeros((3, 32, 32, 3)))
        with pytest.raises(ValueError, match="batched"):
            gw.submit("a", np.float32(1.0))
    with pytest.raises(ValueError, match="at least one tenant"):
        Gateway(pipe, [])
    pipe.close()


# --------------------------------------------------------------------------- #
# beyond the reference's file
# --------------------------------------------------------------------------- #
def test_same_requests_coalesce_alike_in_both_packages(models):
    """The same seeded requests, in the same order, with
    ``batch_window_s=0`` and a 2-batch window, through the JAX gateway
    and the port's: the same micro-batches (each record's req_id, seq,
    rows, coalesced and occupancy equal, tenant by tenant) and results
    within 1e-5.  Lax SLOs keep AIMD out of it, so admission depends on
    the order of calls alone."""
    from repro.core import scenarios as RS
    from repro.core.devices import LAN_PI_GPU as R_LAN
    from repro.runtime import EdgePipeline as REdgePipeline
    from repro.runtime import Gateway as RGateway
    from repro.runtime import drain_qos as r_drain_qos
    ref, params, port = models
    reqs = requests()
    order = [(n, j) for j in range(N_REQS) for n in NAMES[:3]]
    weights = {NAMES[0]: 1.0, NAMES[1]: 2.0, NAMES[2]: 1.0}

    def run(pipe, gateway_cls, spec_cls, as_input):
        specs = [spec_cls(n, slo_s=60.0, weight=w) for n, w in weights.items()]
        with gateway_cls(pipe, specs, max_batch=4, batch_window_s=0.0,
                         inflight=2) as gw:
            for n, j in order:
                gw.submit(n, as_input(reqs[n][j]))
            got = gw.drain()
            qos = gw.drain_qos()
        return got, {(r.tenant, r.req_id): r for r in qos}

    rpipe = REdgePipeline(ref, params, 2, [R_LAN])
    rpipe.warmup(reqs[NAMES[0]][0])
    r_got, r_qos = run(rpipe, RGateway, RS.TenantSpec, lambda x: x)
    rpipe.close()
    r_drain_qos()
    pipe = _pipe(port)
    pipe.warmup(torch.from_numpy(reqs[NAMES[0]][0]))
    got, qos = run(pipe, Gateway, scenarios.TenantSpec, torch.from_numpy)
    pipe.close()
    assert sorted(qos) == sorted(r_qos) == sorted(
        (n, j) for n in weights for j in range(N_REQS))
    for key, r in r_qos.items():
        mine = qos[key]
        assert (mine.req_id, mine.seq, mine.rows, mine.coalesced,
                mine.occupancy) == (r.req_id, r.seq, r.rows, r.coalesced,
                                    r.occupancy), key
    assert max(r.coalesced for r in qos.values()) >= 2
    for n in weights:
        assert [r for r, _ in got[n]] == [r for r, _ in r_got[n]]
        for (_, y), (_, want) in zip(got[n], r_got[n]):
            assert np.allclose(y.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert drain_violations() == []


def test_coded_hop_keeps_solo_bits(models):
    """A lossy codec packs a whole batch with one abs-max scale, so a
    request coalesced beside others crosses the hop with other bits than
    alone (shown below on the session).  Deterministic serving on such a
    hop gives each request a micro-batch of its own: every tenant of an
    8-tenant mix gets its solo bits, and no record shows coalescing."""
    port = models[2]
    reqs = tensors(requests())
    pipe = _pipe(port, codec="int8")
    pipe.warmup(reqs[NAMES[0]][0])
    a, b = reqs[NAMES[0]][0], reqs[NAMES[1]][0]
    pad = torch.zeros((MAX_BATCH - 2, 32, 32, 3))
    with pipe.session() as s:
        s.submit(torch.cat([a, b, pad]))
        s.submit(torch.cat([a, torch.zeros((MAX_BATCH - 1, 32, 32, 3))]))
        beside, alone = s.drain()
    assert not torch.equal(beside[:1], alone[:1])
    refs = solo(pipe, reqs)
    with Gateway(pipe, scenarios.get_tenant_mix("octet_uniform"),
                 max_batch=MAX_BATCH, batch_window_s=0.005) as gw:
        clients = {n: gw.client(n) for n in NAMES}
        for j in range(N_REQS):
            for n in NAMES:
                clients[n].submit(reqs[n][j])
        got = {n: clients[n].drain() for n in NAMES}
        qos = gw.drain_qos()
    assert_solo_bits(got, refs, NAMES, "an int8 hop")
    assert {r.coalesced for r in qos} == {1}
    assert {r.occupancy for r in qos} == {1 / MAX_BATCH}
    assert drain_violations() == []
    pipe.close()
