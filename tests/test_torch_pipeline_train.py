"""The port's pipelined train step (``runtime.pipeline``: GPipe over 2
stages and 2 microbatches, single process) against the JAX reference's
pipelined train step, for all six families at even cuts: the CE within
1e-5 and every gradient leaf, in the reference's (K, l_max, ...) layout,
within 1e-4 of its largest.  The reference runs once for the module in
a subprocess with 8 forced host devices (``_torch_pipeline_ref.py``);
the uneven cuts and the checkpoints are in
``test_torch_pipeline_train_uneven.py``, so the two reference runs go
to two workers.
"""
import pytest
import torch

from _torch_pipeline_fixture import TRAIN_CASES, check_train_case, run_reference

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("train", tmp_path_factory.mktemp("pipeline_even"),
                         "even")


@pytest.mark.parametrize("case,arch,depth,cuts", TRAIN_CASES["even"])
def test_pipelined_train_step_matches_reference(reference, case, arch, depth,
                                                cuts):
    check_train_case(reference[case], arch, depth, cuts)
