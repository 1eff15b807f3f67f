"""Meshes: stage placement for the pod pipeline, and the ``(data,
model)`` mesh of the ranks (counterpart of ``src/repro/launch/mesh.py``).

The reference's pipeline is one single-controller SPMD program: a
``shard_map`` manual over the mesh's ``pod`` axis, each pod holding its
stage's layers, the hop between stages a ``ppermute``.  The port runs
the same schedule from one process: stage ``k`` and its layers live on
``devices[k]``, and the hop is ``y.to(devices[k + 1])``, a copy autograd
differentiates, so the backward crosses the stages on its own.  One
process needs no collective, and it works where the ranks could not: on
a machine with one card every stage shares it (two NCCL ranks on one
device are refused).  ``plan_pipeline`` is the launchers' one way to a
pipeline: its cuts (priced for the H100s its stages run on), its mesh,
the model placed.

The ``data`` and ``model`` axes are ``torch.distributed`` ranks, each a
real device: ``spawn_ranks`` starts them as processes of one command
(or ``torchrun`` does), ``join`` puts a process in their group (gloo on
the CPU, NCCL on ``cuda:{local rank}``) and ``make_host_mesh`` inside a
rank gives their ``DeviceMesh``.  The rendezvous is a ``FileStore`` in a
fresh temporary directory (``REPRO_TORCH_STORE``), or ``torchrun``'s
``MASTER_ADDR``/``MASTER_PORT``: never a fixed port.

The reference's ``(pod, data, model)`` mesh is ranks too
(``pod_mesh``): rank ``r`` sits at ``(r // (data·model), (r // model) %
data, r % model)``, so a pod's ranks are contiguous.  Each rank holds
one stage of the pod pipeline, sharded on its pod's ``(data, model)``
sub-mesh (``stage_mesh``), and an activation crosses to the next stage
as a point-to-point send to the rank at the same ``(data, model)``
point of the next pod (``pod_neighbours``).  With one pod the ranks'
mesh stays the ``(data, model)`` one.
"""
from __future__ import annotations

import os
import subprocess
import tempfile
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..models.blocks_adapter import choose_pipeline_cuts
from ..models.cnn.zoo import resolve_device


@dataclass(frozen=True)
class PodMesh:
    """The pipeline axis: stage ``k`` runs on ``devices[k]``."""
    devices: tuple[torch.device, ...]

    @property
    def n_pods(self) -> int:
        return len(self.devices)


def make_host_mesh(n_pods: int = 1, data: int = 1, model: int = 1,
                   device=None):
    """``n_pods`` stages on ``device``'s kind (``cuda`` unless the caller
    names another): on the card, stage ``k`` on ``cuda:{k % count}``, so
    that one card holds every stage and four cards one each; on the CPU
    every stage on the CPU.  For ranks (``data`` x ``model`` > 1, or a
    process that is a rank) → the ranks' ``DeviceMesh`` instead: ``(pod,
    data, model)`` with several pods (``pod_mesh``), else ``(data,
    model)`` (``rank_mesh``)."""
    if n_pods < 1:
        raise ValueError(f"n_pods {n_pods}")
    ranks = data * model > 1 or in_rank() or dist.is_initialized()
    if n_pods > 1 and ranks:
        return pod_mesh(n_pods, data, model, device)
    if ranks:
        return rank_mesh(data, model, device)
    dev = resolve_device(device)
    if dev.type != "cuda":
        return PodMesh((dev,) * n_pods)
    count = torch.cuda.device_count()
    return PodMesh(tuple(torch.device("cuda", k % count)
                         for k in range(n_pods)))


def make_production_mesh(multi_pod: bool = False, device_type: str = "cpu"):
    """The reference's production mesh over the ranks of the current
    process group (the dry run's fake one): ``(data, model)`` 16 x 16
    over 256, or with ``multi_pod`` ``(pod, data, model)`` 2 x 16 x 16
    over 512."""
    if multi_pod:
        return init_device_mesh(device_type, (2, 16, 16),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(device_type, (16, 16),
                            mesh_dim_names=("data", "model"))


def pod_mesh(n_pods: int, data: int, model: int, device=None):
    """The ranks' ``(pod, data, model)`` ``DeviceMesh``, rank ``r`` at
    ``(r // (data·model), (r // model) % data, r % model)``, joining the
    group first if this process has not.  The pod group makes its first
    collective here, with every rank in it: NCCL asks that of a group's
    first batched point-to-point call, which the pipeline's hops are."""
    dev = join(device)
    world = dist.get_world_size()
    if world != n_pods * data * model:
        raise ValueError(f"pods {n_pods} x data {data} x model {model} is "
                         f"not the {world} ranks of the group")
    mesh = init_device_mesh(dev.type, (n_pods, data, model),
                            mesh_dim_names=("pod", "data", "model"))
    dist.all_reduce(torch.zeros(1, device=dev), group=mesh.get_group("pod"))
    return mesh


def is_pod_mesh(mesh) -> bool:
    """Whether ``mesh`` is the ranks' ``(pod, data, model)`` mesh."""
    return "pod" in (getattr(mesh, "mesh_dim_names", None) or ())


def stage_mesh(mesh):
    """A pod mesh's ``(data, model)`` sub-mesh of this rank's pod: where
    its stage's tensors live.  Sliced once and kept on the mesh, so a
    step that asks for it again runs no tensor op for it (the dry run
    counts every tensor a step makes)."""
    sub = getattr(mesh, "_repro_stage_mesh", None)
    if sub is None:
        sub = mesh._repro_stage_mesh = mesh["data", "model"]
    return sub


def pod_index(mesh) -> int:
    """This rank's pod, the stage it runs."""
    return mesh.get_local_rank("pod")


def pod_rank(mesh, k: int) -> int:
    """The global rank at this rank's ``(data, model)`` point of pod
    ``k``."""
    return dist.get_global_rank(mesh.get_group("pod"), k)


def pod_neighbours(mesh) -> tuple[int | None, int | None]:
    """The global ranks at this rank's ``(data, model)`` point of the
    pods before and after its own (None past either end)."""
    k, n = pod_index(mesh), mesh.size(0)
    return (pod_rank(mesh, k - 1) if k > 0 else None,
            pod_rank(mesh, k + 1) if k < n - 1 else None)


def in_rank() -> bool:
    """Whether this process is one of a group's ranks (``spawn_ranks``'s
    or ``torchrun``'s environment)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def join(device=None) -> torch.device:
    """Put this process in its ranks' group, as its environment names it
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``; ``REPRO_TORCH_STORE`` or
    ``MASTER_ADDR``/``MASTER_PORT``): gloo on the CPU, NCCL on
    ``cuda:{LOCAL_RANK}``, which becomes the current device → this
    rank's device."""
    if not in_rank():
        raise RuntimeError("not a rank: start the ranks with spawn_ranks "
                           "or torchrun (RANK and WORLD_SIZE unset)")
    dev = resolve_device(device)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    kw = {"rank": rank, "world_size": world}
    store = os.environ.get("REPRO_TORCH_STORE")
    if store:
        kw["store"] = dist.FileStore(store, world)
    else:
        kw["init_method"] = "env://"
    if dev.type == "cuda":
        kw["device_id"] = dev
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", **kw)
    return dev


def rank_mesh(data: int, model: int, device=None):
    """The ranks' ``(data, model)`` ``DeviceMesh``, rank ``r`` at ``(r //
    model, r % model)``, joining the group first if this process has
    not."""
    dev = join(device)
    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(f"data {data} x model {model} is not the "
                         f"{world} ranks of the group")
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))


def spawn_ranks(cmd: list[str], world: int, env: dict | None = None,
                grace_s: float = 30.0, timeout_s: float | None = None) -> int:
    """Run ``cmd`` as ``world`` ranks of one group (``RANK`` and
    ``LOCAL_RANK`` ``r``, a fresh ``FileStore``) and wait for them →
    the group's exit code: of the ranks that ended by themselves, rank
    0's if it failed, else the first failed rank's; else 0.  Once a rank
    has failed, the others get ``grace_s`` to end before they are killed
    (one left in a collective would wait for ever), and after
    ``timeout_s`` every rank is; none outlives the call."""
    with tempfile.TemporaryDirectory(prefix="repro_ranks_") as tmp:
        base = {**os.environ, **(env or {}), "WORLD_SIZE": str(world),
                "LOCAL_WORLD_SIZE": str(world),
                "REPRO_TORCH_STORE": os.path.join(tmp, "store")}
        procs = [subprocess.Popen(cmd, env={**base, "RANK": str(r),
                                            "LOCAL_RANK": str(r)})
                 for r in range(world)]
        failed_at, killed = None, set()
        t0 = time.monotonic()
        try:
            while any(p.poll() is None for p in procs):
                now = time.monotonic()
                if failed_at is None and any(p.returncode for p in procs):
                    failed_at = now
                if failed_at is not None and now - failed_at > grace_s \
                        or timeout_s is not None and now - t0 > timeout_s:
                    break
                time.sleep(0.05)
        finally:
            for r, p in enumerate(procs):
                if p.poll() is None:
                    p.kill()
                    killed.add(r)
                p.wait()
    own = [p.returncode for r, p in enumerate(procs) if r not in killed]
    return next((c for c in own if c), 0) or (-9 if killed else 0)


def cards_per_pod(mesh) -> int:
    """The cards one pipeline stage runs on: ``data × model`` of the ranks'
    ``(pod, data, model)`` mesh, else 1 (the host mesh, a card a
    stage)."""
    if mesh is not None and is_pod_mesh(mesh):
        return mesh.size(1) * mesh.size(2)
    return 1


def plan_pipeline(cfg, model, pods: int, microbatches: int, *, seq: int,
                  batch: int, auto_partition: bool, train: bool, mesh=None):
    """``model`` placed on ``pods`` stages → (PipelineConfig, mesh): on
    ``mesh`` (a rank's ``pod_mesh``) when one is given, else on its
    device's kind.  The cuts are even, or with ``auto_partition``
    ParetoPipe's (its pick kept as the config's ``plan``), priced for ``cards_per_pod(mesh)`` H100s a stage (D·M
    on a pod mesh, one on the host mesh) and NVLink between stages, and
    printed with the plan's predicted latency and throughput as the
    reference's launcher prints them (by rank 0 alone).  On a machine
    with fewer cards than stages the stages share them, but the plan is
    still priced for the mesh asked for, a card (or D·M) a stage."""
    from ..runtime.pipeline import PipelineConfig, place_stages
    if auto_partition:
        cuts, pick, _ = choose_pipeline_cuts(
            cfg, seq, pods, cards_per_pod(mesh), batch=batch, train=train)
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(f"[paretopipe] cuts={cuts} predicted latency="
                  f"{pick.latency_s*1e3:.2f}ms thr={pick.throughput:.1f}/s",
                  flush=True)
        pcfg = PipelineConfig(pods, microbatches, cuts, plan=pick)
    else:
        pcfg = PipelineConfig.even(cfg.n_layers, pods, microbatches)
    if mesh is None:
        mesh = make_host_mesh(pods, device=model.device)
    place_stages(cfg, model, pcfg, mesh)
    return pcfg, mesh
