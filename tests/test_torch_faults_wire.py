"""Wire damage on the port's feed hop (the reference's
``test_wire_damage_recovers_exactly``): a dropped, a duplicated and a
corrupted frame on ``socket`` and ``shmem``, below the sanitizer.  The
duplicate is absorbed by the receiver's wire-seq dedup with no recovery;
a gap or a corrupt header is detected at the receiver and healed by a
restart and a replay.  Results are held to the reference's
``CNNModel.apply`` within 1e-5, in order, with no sanitizer violation.
"""
import pytest
import torch
from _torch_tiny import check, run_with_plan, tiny_models

from repro_torch.runtime import (FaultPlan, drain_injections,
                                 drain_recoveries, drain_violations)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    return tiny_models()


@pytest.mark.slow
@pytest.mark.parametrize("transport", ["socket", "shmem"])
@pytest.mark.parametrize("fault", ["drop", "dup", "corrupt"])
def test_wire_damage_recovers_exactly(models, transport, fault):
    plan = {
        "drop": FaultPlan().drop(hop=-1, at_seq=2),
        "dup": FaultPlan().duplicate(hop=-1, at_seq=2),
        "corrupt": FaultPlan().corrupt(hop=-1, at_seq=2),
    }[fault]
    drain_recoveries()
    drain_violations()
    drain_injections()
    outs, refs = run_with_plan(models, transport, plan)
    check(outs, refs, f"{transport}/{fault}")
    assert [i.kind for i in drain_injections()]
    if fault == "dup":
        # receiver-side wire-seq dedup absorbs it: no recovery needed
        assert drain_recoveries() == []
    else:
        # a gap / corrupt header is detected at the receiver and healed
        # by restart + replay
        assert [r.kind for r in drain_recoveries()] == ["restart"]
    assert drain_violations() == []
