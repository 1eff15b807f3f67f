"""The port's serving gateway over the process transports, on the CPU.

The reference's fairness/ordering matrix (``tests/test_gateway.py``):
{socket, shmem} x {duo, octet} x {uniform, bursty} — every tenant's
results in per-tenant submit order, bit-identical (``torch.equal``) to
a solo run of the same requests on the emulated transport, every
request in the QoS log under its tenant, no sanitizer violation — and
the supervised worker kill with per-tenant replay isolation.  One
pipeline a transport serves its four mixes (a gateway opens a session
of its own on it each time).
"""
import pytest
import torch

from _torch_tenants import (MAX_BATCH, N_REQS, NAMES, assert_solo_bits,
                            requests, solo, tensors)
from _torch_tiny import tiny_models
from repro_torch.core import scenarios
from repro_torch.core.devices import LAN_PI_GPU
from repro_torch.runtime import (EdgePipeline, FaultPlan, Gateway,
                                 drain_recoveries, drain_violations)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def port():
    return tiny_models()[2]


@pytest.fixture(scope="module")
def solo_refs(port):
    reqs = tensors(requests())
    pipe = EdgePipeline(port, 2, [LAN_PI_GPU], sanitize=True, device="cpu")
    pipe.warmup(reqs[NAMES[0]][0])
    refs = solo(pipe, reqs)
    pipe.close()
    return reqs, refs


@pytest.fixture(scope="module", params=["socket", "shmem"])
def proc_pipe(request, port):
    pipe = EdgePipeline(port, 2, [LAN_PI_GPU], transport=request.param,
                        sanitize=True, timeout_s=120, device="cpu")
    with pipe:
        pipe.warmup(torch.zeros((MAX_BATCH, 32, 32, 3)))
        yield pipe


def _submit_mix(clients, names, reqs, bursty: bool) -> None:
    if bursty:
        for n in names:                       # whole burst back-to-back
            for x in reqs[n]:
                clients[n].submit(x)
    else:
        for j in range(N_REQS):               # round-robin interleave
            for n in names:
                clients[n].submit(reqs[n][j])


@pytest.mark.parametrize("mix_name", ["duo_uniform", "duo_bursty",
                                      "octet_uniform", "octet_bursty"])
def test_gateway_matrix_bit_identical_to_solo(proc_pipe, solo_refs,
                                              mix_name):
    reqs, refs = solo_refs
    mix = scenarios.get_tenant_mix(mix_name)
    names = [t.name for t in mix.tenants]
    with Gateway(proc_pipe, mix, max_batch=MAX_BATCH,
                 batch_window_s=0.005) as gw:
        clients = {n: gw.client(n) for n in names}
        _submit_mix(clients, names, reqs, mix.arrival == "bursty")
        got = {n: clients[n].drain() for n in names}
        qos = gw.drain_qos()
    assert drain_violations() == []
    assert_solo_bits(got, refs, names,
                     f"{proc_pipe.transport}/{mix_name}")
    # every request is accounted for in QoS, attributed to its tenant
    assert sorted((r.tenant, r.req_id) for r in qos) == \
        sorted((n, j) for n in names for j in range(N_REQS))
    if len(names) == 8:                       # octet: coalescing happened
        assert max(r.coalesced for r in qos) >= 2


def test_gateway_survives_worker_kill_bit_identical(port, solo_refs):
    """A SIGKILLed stage mid-stream: supervised recovery replays the
    retained (padded) micro-batches, and every tenant still gets its
    full result stream bit-identical to solo — a fault on a shared batch
    never bleeds across the tenants riding it."""
    reqs, refs = solo_refs
    drain_recoveries()
    mix = scenarios.get_tenant_mix("duo_uniform")
    names = [t.name for t in mix.tenants]
    plan = FaultPlan().kill_worker(stage=1, at_seq=2)
    pipe = EdgePipeline(port, 2, [LAN_PI_GPU], transport="shmem",
                        fault_plan=plan, stall_timeout_s=2.0,
                        timeout_s=120, sanitize=True, device="cpu")
    with pipe:
        pipe.warmup(reqs[names[0]][0])
        with Gateway(pipe, mix, max_batch=MAX_BATCH,
                     batch_window_s=0.0) as gw:
            clients = {n: gw.client(n) for n in names}
            _submit_mix(clients, names, reqs, bursty=False)
            got = {n: clients[n].drain() for n in names}
    assert [r.kind for r in drain_recoveries()] == ["restart"]
    assert drain_violations() == []
    assert_solo_bits(got, refs, names, "a worker kill")
