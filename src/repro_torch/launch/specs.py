"""Cell definitions (arch × input shape) and the dry run's abstract
inputs (counterpart of ``src/repro/launch/specs.py``).

The reference's four LM shapes; ``long_500k`` is decode-only and runs
only for the sub-quadratic archs (ssm, hybrid): pure full-attention
archs skip it.  Where the reference gives ``ShapeDtypeStruct``s with
``NamedSharding``s, every spec here is a ``models.common.LeafSpec``:
shape, dtype, and under a mesh (a ``sharding.api.MeshContext``) its
PartitionSpec and DTensor placements.  ``materialize`` turns a tree of
them into tensors (each rank allocating only its shard), which the dry
run (``launch/dryrun.py``) does inside ``FakeTensorMode``, where no
storage is ever allocated.

The trees keep the port's own layouts, those its steps take: the
parameters as ``lm.build_params`` lists each stacked tree's blocks (a
block's spec is the reference's stacked leaf's without the leading,
unsplit ``layers`` dim); the moments keyed by parameter name in
``runtime.steps.zero1_placements``' ZeRO-1 layout, which holds the
reference device's bytes of each leaf; the cache as ``models.lm``
builds it (``lm.cache_names``: the self-attention k/v by
``kv_cache_names``, split along the sequence where ``model`` does not
divide the kv heads).  A pipelined spec (``pcfg``, on the ``(pod, data,
model)`` mesh) is the rank's own stage, as ``runtime.pipeline`` places
it: its pod's layers (the others' blocks empty), the pod-replicated
parts whole, the cache ``{"stage": its layers' cache, "pos"}``, each
leaf laid out on the pod's ``(data, model)`` sub-mesh.  The stages'
blocks, stacked in the reference's (K, l_max, ...) layout with ``pod``
on the stage dim, are the reference's pipelined specs.
"""
from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..data.pipeline import make_batch_specs
from ..models import lm
from ..models.common import (DTYPES, AbstractBuilder, LeafSpec,
                             abstract_params, named_leaves)
from ..models.config import ArchConfig
from ..sharding.api import MeshContext, Shard, use_mesh_context


@dataclass(frozen=True)
class ShapeSpec:
    """One cell's shape: ``seq`` tokens (the cache length, for decode)
    of ``batch`` sequences, for a step of ``kind``."""
    name: str
    seq: int
    batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and not cfg.supports_long_context:
        return False, ("skip: pure full-attention arch at 524k context "
                       "(sub-quadratic required; see DESIGN.md §4)")
    return True, ""


def stage_of(ctx, cfg, pcfg, pod: int | None = None):
    """The context and layers of a pipelined spec's stage → (the pod's
    ``(data, model)`` context, the layers of ``pod``: by default the
    rank's own on a ``DeviceMesh``, else pod 0); (ctx, None) without
    ``pcfg``."""
    if pcfg is None:
        return ctx, None
    mesh = ctx.mesh
    if isinstance(mesh, DeviceMesh):
        sub = MeshContext(mesh["data", "model"])
        pod = mesh.get_local_rank("pod") if pod is None else pod
    else:
        sub = MeshContext(SimpleNamespace(axis_names=ctx.axis_names[1:],
                                          devices=mesh.devices[0]))
    return sub, pcfg.ranges(cfg.n_layers)[pod or 0]


def _leaf(ctx, shape, dtype, axes) -> LeafSpec:
    return AbstractBuilder(ctx, dtype)(shape, axes=axes)


def spec_of(placements: tuple, axis_names: tuple, ndim: int) -> tuple:
    """The PartitionSpec of DTensor ``placements`` on a mesh of
    ``axis_names``: per tensor dim None, the one mesh dim that splits it,
    or a tuple of them in mesh order."""
    out: list = [[] for _ in range(ndim)]
    for axis, p in zip(axis_names, placements):
        if isinstance(p, Shard):
            out[p.dim].append(axis)
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in out)


# --------------------------------------------------------------------------- #
# Param / optimizer / cache specs
# --------------------------------------------------------------------------- #
def param_specs(cfg: ArchConfig, ctx, pcfg=None, pod=None) -> dict:
    """The parameter tree (``lm.build_params``' layout) of ``LeafSpec``s
    in ``cfg.dtype``; with ``pcfg`` a stage's (``stage_of``)."""
    sub, layers = stage_of(ctx, cfg, pcfg, pod)
    tree = abstract_params(cfg, sub)
    if layers is not None:
        key = "dec_layers" if cfg.family == "encdec" else "layers"
        tree[key] = [b if i in layers else {}
                     for i, b in enumerate(tree[key])]
    return tree


def train_state_specs(cfg: ArchConfig, ctx, pcfg=None, pod=None) -> dict:
    """The train state's specs in the port's layout: ``params`` (the
    module's tree), ``opt`` (fp32 moments ``m``, ``v`` keyed by parameter
    name in ZeRO-1's placements, and ``count``) and ``step``; with
    ``pcfg`` a stage's."""
    from ..runtime.steps import zero1_placements
    params = param_specs(cfg, ctx, pcfg, pod)
    sub = stage_of(ctx, cfg, pcfg, pod)[0]
    z1 = None if ctx is None else zero1_placements(cfg, sub)

    def f32_zero1(name, s):
        if z1 is None:
            return LeafSpec(s.shape, torch.float32)
        pl = z1[name]
        return LeafSpec(s.shape, torch.float32,
                        spec_of(pl, sub.axis_names, len(s.shape)), pl)

    named = list(named_leaves(params))
    scalar = _leaf(ctx, (), torch.int32, ())
    return {"params": params,
            "opt": {"m": {n: f32_zero1(n, s) for n, s in named},
                    "v": {n: f32_zero1(n, s) for n, s in named},
                    "count": scalar},
            "step": scalar}


def cache_specs(cfg: ArchConfig, B: int, S: int, ctx, pcfg=None,
                pod=None) -> dict:
    """The decode step's cache (``lm.forward_prefill``'s layout, a cache
    of ``S`` positions), each leaf laid out by ``lm.cache_names``;
    ``pos`` is the reference's int32 scalar (the port's steps take it as
    a Python int, which ``materialize`` puts in its place).  With
    ``pcfg`` a stage's: ``{"stage": its layers' leaves, "pos"}``."""
    sub, layers = stage_of(ctx, cfg, pcfg, pod)
    layers = range(cfg.n_layers) if layers is None else layers
    dt = DTYPES[cfg.dtype]
    L, KV, hd = len(layers), cfg.n_kv_heads, cfg.hd
    shapes: dict[str, tuple] = {}
    if cfg.family in ("dense", "vlm", "moe", "encdec"):
        shapes["k"] = shapes["v"] = (L, B, S, KV, hd)
    if cfg.family == "encdec":
        shapes["ck"] = shapes["cv"] = (L, B, cfg.enc_frames, KV, hd)
    if cfg.family == "ssm":
        shapes["conv"] = (L, B, cfg.ssm_conv - 1, cfg.d_inner)
        shapes["h"] = (L, B, cfg.d_inner, cfg.ssm_state)
    if cfg.family == "hybrid":
        shapes["conv"] = (L, B, cfg.ssm_conv - 1,
                          cfg.d_inner + 2 * cfg.ssm_state)
        shapes["h"] = (L, B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
        shapes["ak"] = shapes["av"] = (lm.n_apps(cfg, layers), B, S, KV, hd)
    if not shapes:
        raise ValueError(cfg.family)
    with use_mesh_context(None if sub is None else sub.mesh):
        out = {k: _leaf(sub, shape, torch.float32 if k == "h" else dt,
                        lm.cache_names(cfg, k))
               for k, shape in shapes.items()}
    pos = _leaf(ctx, (), torch.int32, ())
    return {"stage": out, "pos": pos} if pcfg is not None else \
        {**out, "pos": pos}


def input_specs(cfg: ArchConfig, shape_name: str | ShapeSpec, ctx,
                pcfg=None, pod=None) -> dict:
    """All inputs of the cell's step (a name of ``SHAPES``, or a shape of
    one's own), as ``LeafSpec``s (with ``pcfg``, of pod ``pod``'s stage:
    ``stage_of``):

    train  → {"state": ..., "batch": ...}
    prefill→ {"params": ..., "inputs": ...}
    decode → {"params": ..., "token": ..., "cache": ...}
    """
    sh = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if sh.kind == "train":
        return {"state": train_state_specs(cfg, ctx, pcfg, pod),
                "batch": make_batch_specs(cfg, sh.batch, sh.seq, ctx,
                                          "train")}
    if sh.kind == "prefill":
        return {"params": param_specs(cfg, ctx, pcfg, pod),
                "inputs": make_batch_specs(cfg, sh.batch, sh.seq, ctx,
                                           "prefill")}
    # decode: one new token against a cache of sh.seq
    return {"params": param_specs(cfg, ctx, pcfg, pod),
            "token": _leaf(ctx, (sh.batch, 1), torch.int32,
                           ("batch", "seq")),
            "cache": cache_specs(cfg, sh.batch, sh.seq, ctx, pcfg, pod)}


# --------------------------------------------------------------------------- #
# Specs → tensors
# --------------------------------------------------------------------------- #
def materialize(tree, mesh, device, *, zeros: bool = False, whole=(),
                pos: int | None = None):
    """A tree of ``LeafSpec``s as tensors on ``device`` (uninitialised,
    or zero-filled with ``zeros``): a leaf with placements a DTensor on
    ``mesh`` holding only this rank's shard; the subtrees named in
    ``whole`` (and every leaf without a mesh) plain tensors holding the
    whole leaf, as the port's steps take their batch and token; a
    cache's ``pos`` the Python int ``pos``.  Inside ``FakeTensorMode``
    nothing is allocated."""
    import torch.distributed.tensor as dtensor

    def make(s: LeafSpec, plain: bool):
        if mesh is None or s.placements is None or plain:
            fn = torch.zeros if zeros else torch.empty
            return fn(s.shape, dtype=s.dtype, device=device)
        fn = dtensor.zeros if zeros else dtensor.empty
        return fn(*s.shape, dtype=s.dtype, device_mesh=mesh,
                  placements=s.placements)

    def walk(node, plain: bool):
        if isinstance(node, dict):
            return {k: pos if k == "pos" and pos is not None
                    else walk(v, plain or k in whole)
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, plain) for v in node]
        return make(node, plain)
    return walk(tree, False)
