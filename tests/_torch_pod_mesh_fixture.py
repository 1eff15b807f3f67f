"""Shared by the pod mesh's rank tests (``test_torch_pod_mesh_train.py``,
``test_torch_pod_mesh_train_uneven.py``, ``test_torch_pod_mesh_serve.py``):
the port's pipelined steps in eight gloo ranks at the reference's own
``(pod 2, data 2, model 2)`` mesh (``_torch_sharded_ranks.py``'s
``pod-train`` and ``pod-serve`` kinds, through ``run_ranks``), started
from the weights and batches the reference's run draws first, while its
pipelined steps compile and run in their subprocesses
(``_torch_pipeline_ref.py``, 8 forced host devices) → (the port's
results, the reference's), each {case: tree}."""
import pathlib

from _torch_pipeline_fixture import run_reference
from _torch_sharded_fixture import run_ranks

MESH = [2, 2, 2]
PARTS = 3


def run_both(mode: str, cases: list[dict], out_dir: pathlib.Path,
             kind: str = "") -> tuple[dict, dict]:
    """``cases`` (``_torch_sharded_ranks.py``'s, their weights left out;
    the reference's, in its order, and any more ``from`` one of them) in
    the ranks, from
    the weights and batches the reference's ``mode`` run (of ``kind``)
    draws first, while it compiles and runs its steps (in ``PARTS``
    processes, each every ``PARTS``-th case)."""
    def inputs(i):
        return out_dir / f"inputs.{i}.npz"
    names = [c["case"] for c in cases]
    cases = [{**c, "weights": str(inputs(
        names.index(c.get("from", c["case"])) % PARTS))} for c in cases]
    port: dict = {}
    ref = run_reference(mode, out_dir, *([kind] if kind else []),
                        inputs=inputs, parts=PARTS, then=lambda: port.update(
                            run_ranks(cases, 8, out_dir, "ranks")))
    return port, ref
