"""Stage placement for the pod pipeline (counterpart of
``src/repro/launch/mesh.py``).

The reference's pipeline is one single-controller SPMD program: a
``shard_map`` manual over the mesh's ``pod`` axis, each pod holding its
stage's layers, the hop between stages a ``ppermute``.  The port runs
the same schedule from one process: stage ``k`` and its layers live on
``devices[k]``, and the hop is ``y.to(devices[k + 1])``, a copy autograd
differentiates, so the backward crosses the stages on its own.  One
process needs no collective, and it works where the ranks could not: on
a machine with one card every stage shares it (two NCCL ranks on one
device are refused).  ``torch.distributed`` belongs to the ``data`` and
``model`` axes, where each rank is a real device (ROADMAP queue 1, item
12b); until their port, asking for either is an error.  ``plan_pipeline``
is the launchers' one way to a pipeline: its cuts, its mesh, the model
placed.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.blocks_adapter import choose_pipeline_cuts
from ..models.cnn.zoo import resolve_device
from ..runtime.pipeline import PipelineConfig, place_stages


@dataclass(frozen=True)
class PodMesh:
    """The pipeline axis: stage ``k`` runs on ``devices[k]``."""
    devices: tuple[torch.device, ...]

    @property
    def n_pods(self) -> int:
        return len(self.devices)


def make_host_mesh(n_pods: int = 1, data: int = 1, model: int = 1,
                   device=None) -> PodMesh:
    """``n_pods`` stages on ``device``'s kind (``cuda`` unless the caller
    names another): on the card, stage ``k`` on ``cuda:{k % count}``, so
    that one card holds every stage and four cards one each; on the CPU
    every stage on the CPU."""
    if data * model > 1:
        raise NotImplementedError(
            f"data {data} x model {model}: the data and model axes wait for "
            "the port of sharding/api.py (ROADMAP queue 1, item 12b)")
    if n_pods < 1:
        raise ValueError(f"n_pods {n_pods}")
    dev = resolve_device(device)
    if dev.type != "cuda":
        return PodMesh((dev,) * n_pods)
    count = torch.cuda.device_count()
    return PodMesh(tuple(torch.device("cuda", k % count)
                         for k in range(n_pods)))


def plan_pipeline(cfg, model, pods: int, microbatches: int, *, seq: int,
                  batch: int, auto_partition: bool, train: bool):
    """``model`` placed on ``pods`` stages on its device's kind →
    (PipelineConfig, mesh).  The cuts are even, or with
    ``auto_partition`` ParetoPipe's for ``seq`` and ``batch`` (training
    or serving), printed as the reference's launcher prints them."""
    if auto_partition:
        cuts, pick, _ = choose_pipeline_cuts(cfg, seq, pods, batch=batch,
                                             train=train)
        print(f"[paretopipe] cuts={cuts} predicted latency="
              f"{pick.latency_s*1e3:.2f}ms thr={pick.throughput:.1f}/s",
              flush=True)
        pcfg = PipelineConfig(pods, microbatches, cuts)
    else:
        pcfg = PipelineConfig.even(cfg.n_layers, pods, microbatches)
    mesh = make_host_mesh(pods, device=model.device)
    place_stages(cfg, model, pcfg, mesh)
    return pcfg, mesh
