"""Error-feedback int8 gradient compression (counterpart of
``src/repro/optim/compress.py``).

Each gradient leaf, plus its carried error, is quantized to ``bits``-bit
symmetric levels with one scale (its max magnitude over the levels); a
leaf is the reference's, so the blocks of a stacked tree
(``layers.0.attn.wq``, ``layers.1.attn.wq``, …) share one scale, as the
reference's stacked ``layers.attn.wq`` has one; what the quantization
lost is carried into the next step, so the compressed stream loses no
mass, it only delays it.  ``torch.round``
rounds half to even, as ``jnp.round`` does.  On one device nothing
crosses a wire: the convergence behaviour is the compressed scheme's,
and ``compressed_bytes`` credits the wire bytes analytically, in the
codecs' layout.

Under a mesh the gradients and the error state are DTensors in the
ZeRO-1 placements (``runtime.steps``), the data axis's sum already
taken: each rank quantizes its shard, and a leaf's scale is the max
over every rank's pieces of it (one all-reduce of every leaf's local
max a step), so every rank quantizes into the leaf's one grid, as the
reference's one device does.
"""
from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..core.codecs import quantized_wire_bytes
from ..sharding.api import local
from .adamw import reference_leaf, zeros_like_in


@dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = False
    bits: int = 8

    @property
    def levels(self) -> int:
        return 2 ** (self.bits - 1) - 1


def init_error_state(params: Mapping[str, torch.Tensor],
                     placements: Mapping | None = None) -> dict:
    """fp32 zeros of every parameter's shape (in ``placements``' entry for
    its name, when given)."""
    return {n: zeros_like_in(p, placements and placements[n])
            for n, p in params.items()}


def _leaves(names) -> dict[str, list[str]]:
    """The port's parameter names grouped by the reference's leaf: the
    blocks of a stacked leaf share its one scale."""
    groups: dict[str, list[str]] = {}
    for n in names:
        groups.setdefault(reference_leaf(n)[0], []).append(n)
    return groups


@torch.no_grad()
def compress_gradients(grads: Mapping[str, torch.Tensor], err_state: dict,
                       cfg: CompressionConfig) -> tuple[dict, dict]:
    """→ (the dequantized gradients, fp32, and the new error state); the
    inputs themselves when compression is off.  One scale a reference
    leaf: the max magnitude over all its blocks."""
    if not cfg.enabled:
        return grads, err_state
    groups = list(_leaves(grads).values())
    g = {n: local(grads[n]).to(torch.float32) + local(err_state[n])
         for names in groups for n in names}
    amax = torch.stack([
        torch.stack([g[n].abs().max() if g[n].numel() else
                     g[n].new_zeros(()) for n in names]).max()
        for names in groups])
    sharded = isinstance(next(iter(grads.values())), DTensor)
    if sharded:
        dist.all_reduce(amax, dist.ReduceOp.MAX)
    deq, err = {}, {}
    for names, top in zip(groups, amax):
        scale = torch.clamp_min(top, 1e-12) / cfg.levels
        for n in names:
            t = g[n]
            q = torch.clamp(torch.round(t / scale), -cfg.levels, cfg.levels)
            deq[n], err[n] = q * scale, t - q * scale
            if sharded:
                mesh, pl = grads[n].device_mesh, grads[n].placements
                deq[n], err[n] = (DTensor.from_local(x, mesh, pl,
                                                     run_check=False)
                                  for x in (deq[n], err[n]))
    return deq, err


def compressed_bytes(params: Mapping[str, torch.Tensor],
                     cfg: CompressionConfig) -> int:
    """Wire bytes of one gradient exchange: fp32 without compression,
    else each reference leaf's scale header and packed levels
    (``core.codecs.quantized_wire_bytes``, the packed codecs' layout)."""
    if not cfg.enabled:
        return int(sum(p.numel() for p in params.values()) * 4)
    return int(sum(
        quantized_wire_bytes(sum(params[n].numel() for n in names),
                             bits=cfg.bits)
        for names in _leaves(params).values()))
