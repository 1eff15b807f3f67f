"""The reference's fault matrix (``tests/test_faults.py``) over the
port's ``shmem`` transport on the CPU: {drain, drop} x {worker-kill,
frame-stall, link-flap, lane-kill at r=2}, injected mid-stream into a
supervised, sanitized 2-stage ``tinycnn`` pipeline.  Every cell must
recover without intervention, return every result in order within 1e-5
of the reference's ``CNNModel.apply`` (zero lost, duplicated or
reordered batches), record the expected recoveries and drain zero
sanitizer violations.  The other transport's cells are in
``test_torch_faults_matrix_socket.py``.
"""
import pytest
import torch
from _torch_tiny import check, run_with_plan, tiny_models

from repro_torch.runtime import FaultPlan, drain_recoveries, drain_violations

torch.set_num_threads(1)

TRANSPORT = "shmem"

_FAULTS = {
    "worker-kill": (lambda: FaultPlan().kill_worker(stage=1, at_seq=3),
                    None, ["restart"]),
    "frame-stall": (lambda: FaultPlan().stall(hop=-1, at_seq=2, for_s=0.3),
                    None, []),
    "link-flap": (lambda: FaultPlan().flap(hop=-1, at_seq=2, down_s=0.5),
                  None, []),
    "lane-kill": (lambda: FaultPlan().kill_worker(stage=1, at_seq=3, lane=1),
                  (1, 2), None),              # failover path varies by
                                              # transport death reporting
}


@pytest.fixture(scope="module")
def models():
    return tiny_models()


@pytest.mark.slow
@pytest.mark.parametrize("policy", ["drain", "drop"])
@pytest.mark.parametrize("fault", sorted(_FAULTS))
def test_fault_matrix_recovers_exactly(models, policy, fault):
    build, replicas, expect_kinds = _FAULTS[fault]
    drain_recoveries()
    drain_violations()
    outs, refs = run_with_plan(models, TRANSPORT, build(),
                               replicas=replicas, policy=policy)
    check(outs, refs, f"{TRANSPORT}/{policy}/{fault}")
    kinds = [r.kind for r in drain_recoveries()]
    if expect_kinds is not None:
        assert kinds == expect_kinds
    else:
        assert kinds                          # some recovery happened
    assert drain_violations() == []           # sanitized end to end
