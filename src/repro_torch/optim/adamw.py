"""AdamW with global-norm clipping and a cosine schedule (counterpart of
``src/repro/optim/adamw.py``).

Plain functions over named tensors (``dict(model.named_parameters())``),
run under ``torch.no_grad``, with the reference's arithmetic in its
order: fp32 moments whatever the parameter's dtype; the gradients scaled
by ``min(1, clip / (gnorm + 1e-9))``; bias correction by the step
``count``; weight decay added to the step of the reference's leaves of
``ndim >= 2`` only, which, since the reference stacks its blocks on a
layer axis, are the matrices and every leaf of a stacked block (a norm
scale of ``layers.3`` is decayed, ``final_norm``'s is not); the update
in fp32, cast back to the parameter's dtype.  This is
not ``torch.optim.AdamW``, which keeps its moments in the parameter's
dtype and decays the parameter before the step.  The parameters and
the moments are updated in place (the reference returns new ones, which
at full size would hold a second copy of both moments); the count is
new.  The step count, the learning rate and the gradient norm stay
device tensors: nothing here waits on the device.  The parameters may
lie on several devices (the stages of ``runtime.pipeline``): the norm is
summed on the first one's, and each step's scalars are copied to each
parameter's device.

Under a mesh (``runtime.steps``' ZeRO-1) the parameters are DTensors in
their own placements and the gradients and moments DTensors in the
ZeRO-1 placements: each rank updates its shard of the moments and of
the parameter with the same arithmetic on its local tensors, then the
parameter's new shards are gathered back into its placements.  The
norm sums each rank's local squares, a replicated shard counted on one
rank only, in one all-reduce over the ranks.
"""
from __future__ import annotations

import math
from collections.abc import Callable, Mapping
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..sharding.api import local, replica_rank, to_placements


@dataclass(frozen=True)
class OptConfig:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def lr_at(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine
    down to ``floor · peak`` at ``total``: step (int tensor) → fp32 lr."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak * step / max(warmup, 1)
        prog = ((step - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return fn


def zeros_like_in(p: torch.Tensor, placements=None) -> torch.Tensor:
    """fp32 zeros of ``p``'s shape on its device, or, with
    ``placements``, a DTensor of them in those on ``p``'s mesh."""
    if placements is None:
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return DTensor.from_local(
        torch.zeros(to_placements(p.detach(), placements).to_local().shape,
                    dtype=torch.float32, device=p.device),
        p.device_mesh, placements, run_check=False)


def init_opt_state(params: Mapping[str, torch.Tensor],
                   placements: Mapping | None = None) -> dict:
    """fp32 zero moments of every parameter (in ``placements``' entry for
    its name, when given: ZeRO-1's), and the step count."""
    def zeros():
        return {n: zeros_like_in(p, placements and placements[n])
                for n, p in params.items()}
    device = next(iter(params.values())).device
    return {"m": zeros(), "v": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every tensor's fp32 squares, on the first
    tensor's device; of DTensors, the whole tensors' (each rank's local
    squares, a replicated shard on one rank only, summed over the
    ranks)."""
    first = next(iter(tree.values()))
    dev = first.device
    if not isinstance(first, DTensor):
        return torch.sqrt(sum(torch.sum(torch.square(
            t.to(torch.float32))).to(dev) for t in tree.values()))
    total = sum(torch.sum(torch.square(local(t).to(torch.float32)))
                for t in tree.values() if replica_rank(t))
    total = torch.as_tensor(total, dtype=torch.float32, device=dev).clone()
    dist.all_reduce(total)
    return torch.sqrt(total)


def reference_leaf(name: str) -> tuple[str, bool]:
    """The reference's leaf that a port parameter is part of:
    ``layers.3.ln1.scale`` (an index after the first part) is one block
    of the stacked leaf ``layers.ln1.scale`` → (that leaf, True); any
    other name is a leaf of its own → (name, False)."""
    parts = name.split(".")
    if len(parts) > 2 and parts[1].isdigit():
        return ".".join([parts[0], *parts[2:]]), True
    return name, False


def _reference_ndim(name: str, p: torch.Tensor) -> int:
    """The rank of the reference's leaf: a stacked one has the layer
    axis too, so every leaf of the blocks counts as a matrix for the
    decay, norm scales and biases included."""
    return p.dim() + reference_leaf(name)[1]


@torch.no_grad()
def apply_gradients(params: Mapping[str, torch.Tensor],
                    grads: Mapping[str, torch.Tensor], state: dict,
                    cfg: OptConfig, gnorm: torch.Tensor | None = None
                    ) -> tuple[dict, dict]:
    """One AdamW step: ``params`` and ``state``'s moments updated in
    place → (the state with its new count, metrics ``{"grad_norm",
    "lr"}``, fp32 device tensors).  ``gnorm`` is the gradient's global
    norm where the caller knows more of it than ``grads`` (a pipeline
    rank's stage): ``global_norm(grads)`` by default."""
    count = state["count"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / (gnorm + 1e-9), 1.0) \
        if cfg.clip_norm > 0 else 1.0
    lr = cfg.lr_at(count)
    bc1 = 1.0 - torch.pow(cfg.b1, count.to(torch.float32))
    bc2 = 1.0 - torch.pow(cfg.b2, count.to(torch.float32))
    scalars = {}                       # (scale, lr, bc1, bc2) by device
    for name, p in params.items():
        if p.device not in scalars:
            scalars[p.device] = [t.to(p.device) if isinstance(t, torch.Tensor)
                                 else t for t in (scale, lr, bc1, bc2)]
        scale_d, lr_d, bc1_d, bc2_d = scalars[p.device]
        m_t = state["m"][name]
        # under a mesh: this rank's shard of p in the moments' placements
        p_z = to_placements(p.detach(), m_t.placements) \
            if isinstance(m_t, DTensor) else p
        p_l = local(p_z)
        g = local(grads[name]).to(torch.float32) * scale_d
        # b1·m + (1 - b1)·g, each product rounded before the sum
        m = local(m_t).mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v = local(state["v"][name]).mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        step = (m / bc1_d) / (torch.sqrt(v / bc2_d) + cfg.eps)
        if cfg.weight_decay > 0 and _reference_ndim(name, p) >= 2:
            step = step + cfg.weight_decay * p_l.to(torch.float32)
        new = (p_l.to(torch.float32) - lr_d * step).to(p.dtype)
        if isinstance(m_t, DTensor):
            new = to_placements(DTensor.from_local(
                new, p.device_mesh, m_t.placements, run_check=False),
                p.placements)
        local(p).copy_(local(new))
    return ({"m": state["m"], "v": state["v"], "count": count},
            {"grad_norm": gnorm, "lr": lr})
