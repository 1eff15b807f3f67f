"""The port's ``AdaptiveRuntime`` (the closed measure → estimate →
re-solve → migrate loop) on the CPU.

Mirrors the reference's ``AdaptiveRuntime`` runs: records per ``run``
(``tests/test_kway_runtime.py:238``), energy on every record (``:278``),
migration when a ``LinkTrace`` degrades hop 0 (``:391``), the same with
batches in flight (``tests/test_session.py:203``) and over measured
socket hops (``tests/test_transport.py:221``), on MobileNetV2 at 32x32
with the reference's weights.  The loop's first deployment is solved at
nominal conditions, so it must be the reference's own; what follows
depends on the host's timing, in both packages, and is held to the same
properties the reference's tests hold.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.core import scenarios
from repro_torch.core.devices import DURESS
from repro_torch.models.cnn import zoo
from repro_torch.runtime import AdaptiveRuntime

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mobilenet():
    """(reference model, its params, the port's model with them)."""
    from repro.models.cnn import zoo as RZ
    ref = RZ.get("mobilenetv2")
    params = ref.init(jax.random.PRNGKey(0))
    port = zoo.get("mobilenetv2").from_reference(
        jax.tree.map(np.asarray, params))
    return ref, params, port


def _x(batch=2, hw=32):
    return torch.from_numpy(np.random.default_rng(1).standard_normal(
        (batch, hw, hw, 3)).astype(np.float32))


def _reference_deploy(ref, scen_name, batch, **kw):
    """The cut vector the reference's loop deploys at (solved at
    nominal conditions, as ``AdaptiveRuntime._deploy`` does)."""
    from repro.core import scenarios as RS
    from repro.core.autosplit import AdaptiveSplitter
    scen = RS.get(scen_name)
    for name, value in kw.items():
        scen = getattr(RS, name)(scen, **value)
    sp = AdaptiveSplitter(ref.block_graph(input_hw=32), scen, batch=batch,
                          policy="throughput", include_io=False)
    return sp.solve().partition


def test_adaptive_run_returns_only_new_records(mobilenet):
    ref, _, port = mobilenet
    x = _x()
    rt = AdaptiveRuntime(port, scenarios.get("pi_pi_gpu"),
                         graph=port.block_graph(input_hw=32),
                         batch=x.shape[0], check_every=2, device="cpu")
    assert rt.pipe.cuts == _reference_deploy(ref, "pi_pi_gpu", x.shape[0])
    first = rt.run(lambda: x, n_batches=3)
    second = rt.run(lambda: x, n_batches=3)
    assert len(first) == 3 and len(second) == 3
    assert len(rt.records) == 6
    assert [r.batch_idx for r in rt.records] == list(range(6))
    rt.close()


def test_adaptive_records_carry_energy(mobilenet):
    port = mobilenet[2]
    x = _x()
    rt = AdaptiveRuntime(port, scenarios.get("pi_pi_gpu"),
                         graph=port.block_graph(input_hw=32),
                         batch=x.shape[0], check_every=2,
                         energy_budget_j=1e6, device="cpu")
    recs = rt.run(lambda: x, n_batches=3)
    for r in recs:
        assert r.energy_j > 0              # measured-exe modeled joules
        assert r.predicted_energy_j > 0    # the splitter's model view
    assert rt.splitter.energy_budget_j == 1e6


def _ramp():
    # the ramp starts almost immediately: once it bites, the emulated
    # RTT sleeps pace the loop into the degraded regime, so the test
    # does not depend on how fast this host runs the compute
    return scenarios.wan_ramp(scenarios.get("pi_pi_gpu"), hop=0,
                              t_start=0.05, t_end=0.4, jitter=0.05)


@pytest.mark.parametrize("inflight,policy,check_every",
                         [(1, "drain", 2), (3, "drop", 3)])
def test_adaptive_loop_migrates_when_trace_degrades(mobilenet, inflight,
                                                    policy, check_every):
    """A LinkTrace degrades hop 0 mid-run: the closed loop moves the
    pipeline to a cheaper-wire cut vector, live — batch-synchronous
    (``inflight=1``) and with batches in flight under the ``drop``
    policy."""
    ref, params, port = mobilenet
    x = _x()
    with AdaptiveRuntime(port, _ramp(), batch=x.shape[0],
                         policy="throughput", check_every=check_every,
                         migration_cost_s=0.02, alpha=0.6,
                         device="cpu") as rt:
        recs = rt.run(lambda: x, n_batches=12, inflight=inflight,
                      migration_policy=policy)
        assert len(recs) == 12
        assert [r.batch_idx for r in recs] == list(range(12))
        assert len(rt.pipe.migrations) >= 1
        start, final = recs[0].cuts, rt.pipe.cuts
        assert start == _reference_deploy(
            ref, "pi_pi_gpu", x.shape[0],
            wan_ramp=dict(hop=0, t_start=0.05, t_end=0.4, jitter=0.05))
        assert final != start
        graph = rt.graph
        # no graph was passed: the loop models the served resolution
        assert graph.input_bytes == x.numel() // x.shape[0] * 4
        assert graph.cut_bytes(final[0]) <= graph.cut_bytes(start[0])
        mig = [r for r in recs if r.migration_cost_s > 0]
        assert mig and all(r.migration_cost_j >= 0 for r in mig)
        assert rt.cut_history[0] == start
        assert rt.pipe.migrations[0][1] == start
        assert rt.pipe.migrations[-1][2] == final
        if inflight > 1:                      # pipelined: measured rate
            assert any(r.throughput > 0 for r in recs)
        # the migrated pipeline still computes the model
        y, _, _ = rt.pipe.run_one(x)
    assert np.allclose(y.numpy(), np.asarray(ref.apply(params, x.numpy())),
                       rtol=0, atol=1e-5)


def test_adaptive_loop_closes_over_measured_socket_costs(mobilenet):
    """Nominal planning says every hop is under duress; the *measured*
    loopback transfers say otherwise, and the closed loop migrates the
    cut vector on real worker processes."""
    ref, params, port = mobilenet
    x = _x()
    scen = (scenarios.get("pi_pi_gpu").with_link(0, DURESS)
            .with_link(1, DURESS).with_transport("socket"))
    with AdaptiveRuntime(port, scen, graph=port.block_graph(input_hw=32),
                         batch=x.shape[0], policy="throughput",
                         check_every=2, migration_cost_s=0.01,
                         alpha=0.8, device="cpu") as rt:
        recs = rt.run(lambda: x, n_batches=10)
        assert len(recs) == 10
        assert any(r.migrated for r in recs)
        assert len(rt.pipe.migrations) >= 1
        # estimates moved off the duress prior toward the measured wire
        assert rt.estimators[0].rtt_s < DURESS.rtt_s / 2
        assert rt.estimators[0].bw_bytes_per_s > DURESS.bw_bytes_per_s
        # and outputs stay correct on the migrated process pipeline
        y, _, _ = rt.pipe.run_one(x)
    assert np.allclose(y.numpy(), np.asarray(ref.apply(params, x.numpy())),
                       rtol=0, atol=1e-5)
