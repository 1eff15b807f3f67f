"""Logical-axis sharding on a ``DeviceMesh`` (counterpart of
``src/repro/sharding/api.py``).

Tensors are annotated with *logical* axis names; a ``MeshContext`` maps
them onto the mesh's named dims (``("data", "model")``) through one
rules table, with the reference's divisibility guard: a dim that does
not divide by the mesh dim's size is replicated, never sharded
unevenly.  ``spec`` gives the reference's PartitionSpec (one mesh-dim
name or ``None`` a tensor dim); ``placements`` gives the DTensor
placements of the same layout (one ``Shard``/``Replicate`` a mesh dim),
and is the one place that converts between the two.  The same mapping
places the parameters (``models.common.param_placements``) and, through
``shard``, the activations inside the steps, so they can never
disagree.

Where the reference's ``with_sharding_constraint`` asks the compiler
for a layout, ``shard`` redistributes a DTensor to it: a ``Partial``
operand becomes an all-reduce or a reduce-scatter, a ``Replicate`` one
a local slice, a ``Shard`` on another dim an all-gather or an
all-to-all.  Outside a mesh, and for a plain tensor, it is the
identity, so the one-device code is the code under a mesh.

``on_shards`` runs a function on the local shards of its DTensor
arguments, for the ops that have no DTensor sharding rule or whose rule
would gather: the caller states each input's placements, its gradient's
where that differs, and the outputs'.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

# logical axis -> preferred mesh axis (None = replicate)
RULES: dict[str, str | None] = {
    "batch": "data",
    "moe_group": "data",
    "stage": "pod",
    # tensor-parallel axes
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "experts": "model",
    "d_inner": "model",
    "conv_dim": "model",
    "ssm_heads": "model",
    # replicated / unsharded
    "embed": None,
    "seq": None,
    "frames": None,
    "head_dim": None,
    "state": None,
    "kernel": None,
    "capacity": None,
    "layers": None,
    "dt_rank": None,
    "patches": None,
    "expert_ff": None,   # ff inside an expert: 'model' is taken by experts

    # fallback sequence sharding (used by cache helpers)
    "seq_model": "model",
    # sequence-parallel residual stream (train/prefill layer boundaries)
    "seq_sp": "model",
    # row-parallel attention projections (archs whose head count does not
    # divide the TP axis): shard the contraction dim instead of heads
    "embed_rp": "model",
    "head_dim_rp": "model",
}

Spec = tuple  # one mesh-dim name or None a tensor dim


@dataclass
class MeshContext:
    """A mesh with named dims: a ``DeviceMesh`` (``mesh_dim_names``), or
    anything with ``axis_names`` and a ``devices`` array (the reference's
    ``Mesh``, or a stand-in that only has their shape)."""
    mesh: Any

    @property
    def axis_names(self) -> tuple[str, ...]:
        names = getattr(self.mesh, "mesh_dim_names", None)
        return tuple(names if names is not None else self.mesh.axis_names)

    @property
    def shape(self) -> tuple[int, ...]:
        devices = getattr(self.mesh, "devices", None)
        if devices is not None:
            return tuple(devices.shape)
        return tuple(self.mesh.shape)

    @property
    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def size(self, mesh_axis: str) -> int:
        return self.axis_sizes.get(mesh_axis, 1)

    # ------------------------------------------------------------------ #
    def spec(self, logical: tuple[str | None, ...],
             shape: tuple[int, ...] | None = None) -> Spec:
        """Map logical names to a PartitionSpec, replicating any dim that
        is absent from the mesh or not divisible."""
        out = []
        for i, name in enumerate(logical):
            axis = RULES.get(name) if name else None
            if axis is None or axis not in self.axis_names:
                out.append(None)
                continue
            if shape is not None and shape[i] % self.size(axis) != 0:
                out.append(None)
                continue
            out.append(axis)
        return tuple(out)

    def placements_of(self, spec: Spec) -> tuple:
        """A PartitionSpec (per tensor dim) as DTensor placements (per
        mesh dim): ``Shard(i)`` on the mesh dim that tensor dim ``i``
        names, ``Replicate()`` on a mesh dim that no tensor dim names,
        and on one of size 1 (the same layout; a shard there would only
        bind the views DTensor allows)."""
        out = []
        for axis in self.axis_names:
            dims = [i for i, a in enumerate(spec) if a == axis]
            if len(dims) > 1:
                raise ValueError(f"spec {spec} names mesh axis {axis!r} "
                                 "twice")
            out.append(Shard(dims[0]) if dims and self.size(axis) > 1
                       else Replicate())
        return tuple(out)

    def placements(self, logical: tuple[str | None, ...],
                   shape: tuple[int, ...] | None = None) -> tuple:
        return self.placements_of(self.spec(logical, shape))


@dataclass(frozen=True)
class Layout:
    """Where a whole tensor goes: ``placements`` on ``mesh`` (a leaf of
    the specs tree ``checkpoint.reshard_tree`` takes)."""
    mesh: Any
    placements: tuple


_tls = threading.local()


def set_context(ctx: MeshContext | None):
    _tls.ctx = ctx


def get_context() -> MeshContext | None:
    return getattr(_tls, "ctx", None)


class use_mesh_context:
    """``with use_mesh_context(mesh): ...`` — enables logical sharding
    annotations for everything inside (nothing with ``None``); the
    context outside comes back on exit."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._outer = None

    def __enter__(self):
        self._outer = get_context()
        if self.mesh is not None:
            set_context(MeshContext(self.mesh))
        return get_context()

    def __exit__(self, *exc):
        set_context(self._outer)
        return False


def in_context(fn):
    """``fn`` run under the context current now, from whatever thread
    later calls it: a rematerialised function is called again in the
    backward pass, which autograd may run on another thread."""
    ctx = get_context()

    def run(*args, **kwargs):
        outer = get_context()
        set_context(ctx)
        try:
            return fn(*args, **kwargs)
        finally:
            set_context(outer)
    return run


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def shard(x, *logical: str | None):
    """Annotate an activation with logical axes: a DTensor is
    redistributed to their layout, and so is its gradient in the
    backward pass, as the reference's constraint binds the cotangent
    too (no-op outside a mesh, and for a plain tensor)."""
    ctx = get_context()
    if ctx is None:
        return x
    if len(logical) != x.ndim:
        raise ValueError(f"{len(logical)} names for rank-{x.ndim} tensor")
    if not isinstance(x, DTensor):
        return x
    placements = ctx.placements(tuple(logical), tuple(x.shape))
    if x.requires_grad:
        return _Constrain.apply(x, placements)
    return to_placements(x, placements)


class _Constrain(torch.autograd.Function):
    """``x`` in ``placements``, and its gradient in them too."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return to_placements(x, placements).view_as(x)

    @staticmethod
    def backward(ctx, g):
        return to_placements(g, ctx.placements), None


def to_placements(x: DTensor, placements) -> DTensor:
    """``x`` redistributed to ``placements`` on its own mesh (itself when
    it has them)."""
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def zero1_spec(spec: Spec, shape: tuple[int, ...]) -> Spec:
    """ZeRO-1: extend a param PartitionSpec with 'data' on the first
    still-unsharded, divisible dim — optimizer moments and gradient
    accumulators shard over data×model instead of replicating over
    data.  The data axis's gradient all-reduce becomes a reduce-scatter
    and, at the update, an all-gather of the parameter."""
    ctx = get_context()
    if ctx is None or "data" not in ctx.axis_names:
        return spec
    used = set(a for a in spec if a is not None)
    if "data" in used:
        return spec
    dp = ctx.size("data")
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (ax, dim) in enumerate(zip(parts, shape)):
        if ax is None and dim % dp == 0 and dim >= dp:
            parts[i] = "data"
            return tuple(parts)
    return spec


def shard_zero1(x, spec: Spec):
    """A gradient/moment leaf in ``zero1_spec``'s layout."""
    ctx = get_context()
    if ctx is None or not isinstance(x, DTensor):
        return x
    return to_placements(x, ctx.placements_of(zero1_spec(spec, x.shape)))


def attn_q_names(n_heads: int) -> tuple[str, ...]:
    """q activations: shard heads over 'model' when divisible (classic
    TP); otherwise shard the *query sequence* (context parallelism) so
    replicated-head archs (36H/48H on 16-way TP) don't blow up the
    attention workspace and FLOPs by the TP degree."""
    ctx = get_context()
    if ctx is not None and n_heads % max(ctx.size("model"), 1) != 0:
        return ("batch", "seq_sp", "heads", "head_dim")
    return ("batch", "seq", "heads", "head_dim")


def kv_cache_names(kv_heads: int, hd: int) -> tuple[str, ...]:
    """Cache (layers, batch, seq, kv, hd): shard kv heads over 'model'
    when divisible, else shard the sequence (flash-decoding style) —
    resolved against the active mesh."""
    ctx = get_context()
    if ctx is not None and kv_heads % max(ctx.size("model"), 1) != 0:
        return ("layers", "batch", "seq_model", "kv_heads", "head_dim")
    return ("layers", "batch", "seq", "kv_heads", "head_dim")


# --------------------------------------------------------------------------- #
# Local shards
# --------------------------------------------------------------------------- #
def on_shards(fn, out_placements, args, in_placements, grad_placements=None):
    """``fn`` on the local shards of ``args`` under a mesh: each DTensor
    argument is redistributed to its ``in_placements`` entry (``None``
    keeps a non-tensor or plain argument as it is) and handed over as
    its local tensor, whose gradient carries the ``grad_placements``
    entry (the input's placements by default; ``Partial()`` where each
    rank's local gradient is a share of the sum); every output is
    wrapped with its ``out_placements`` entry.  Without a DTensor
    argument ``fn`` runs on ``args`` as they are.  (torch's ``local_map``
    does the same but hands gradients across as strided views, which
    DTensor's reshapes then refuse to view; here they cross
    contiguous.)"""
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)),
                None)
    if mesh is None:
        return fn(*args)
    grad_placements = grad_placements or (None,) * len(args)
    local = []
    for a, p, g in zip(args, in_placements, grad_placements):
        if isinstance(a, DTensor):
            a = to_placements(a, p).to_local(grad_placements=g)
            if a.requires_grad:
                a = _ContiguousGrad.apply(a)
        local.append(a)
    out = fn(*local)
    if isinstance(out, tuple):
        return tuple(o if p is None else _wrap(o, mesh, p)
                     for o, p in zip(out, out_placements))
    return _wrap(out, mesh, out_placements)


def _wrap(t, mesh, placements) -> DTensor:
    if t.requires_grad:
        t = _ContiguousGrad.apply(t)
    return DTensor.from_local(t, mesh, placements, run_check=False)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient goes on contiguous: into the local
    graph (a shard of a redistributed gradient may be a strided view)
    and out of it (DTensor's reshape would ``view`` a strided one)."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def shares(placements, over) -> tuple:
    """``placements`` with ``Partial()`` on every mesh dim that ``over``
    shards: the gradient placements of a whole input that each rank
    reads against its own shard of another (a share of the sum over
    that other's shards)."""
    return tuple(Partial() if isinstance(o, Shard) else p
                 for p, o in zip(placements, over))


def full(t):
    """A DTensor gathered whole on every rank (a collective: every rank
    calls it); any other value as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def local(t):
    """A DTensor's local shard; any other value as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def whole_along(t, dims=()) -> tuple:
    """``t``'s placements with every ``Partial`` and every ``Shard`` of a
    dim in ``dims`` (negative ones count from the end) made
    ``Replicate``: the layout in which a function of the local shards
    sees those dims whole (a kernel that reduces over them)."""
    nd = t.ndim
    dims = {d % nd for d in dims}
    return tuple(Replicate() if isinstance(p, Partial)
                 or isinstance(p, Shard) and p.dim % nd in dims else p
                 for p in t.placements)


def shard_start(t, dim: int) -> int:
    """The global index of this rank's first element along ``dim`` of a
    DTensor split evenly there (0 for a dim it holds whole, and for a
    plain tensor); mesh dims that split the same dim nest in mesh
    order."""
    if not isinstance(t, DTensor):
        return 0
    mesh, start, size = t.device_mesh, 0, t.shape[dim]
    coord = mesh.get_coordinate()
    for md, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == dim:
            size //= mesh.size(md)
            start += coord[md] * size
    return start


def select(t, i: int):
    """``t[i]`` along a leading dim that no mesh dim splits (a cache's
    layers): for a DTensor a DTensor over a view of the local shard, so
    that writes into its local shard land in ``t``'s."""
    if not isinstance(t, DTensor):
        return t[i]
    if any(isinstance(p, Shard) and p.dim == 0 for p in t.placements):
        raise ValueError(f"select: dim 0 of {tuple(t.shape)} is split "
                         f"({t.placements})")
    pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
               for p in t.placements)
    return DTensor.from_local(t.to_local()[i], t.device_mesh, pl,
                              run_check=False)


def put(dst, src):
    """Write ``src`` into ``dst`` in place → ``dst``; a DTensor ``src`` is
    redistributed to ``dst``'s placements first, so each rank copies
    into its own shard."""
    if not isinstance(dst, DTensor):
        return dst.copy_(src)
    dst.to_local().copy_(to_placements(src, dst.placements).to_local())
    return dst


def new_like(like, shape, dtype, names, zeros: bool = False):
    """A new tensor of ``shape`` beside ``like``: for a DTensor ``like``
    a DTensor on its mesh laid out by the logical ``names`` (each rank
    allocates its shard alone), else a plain tensor on its device;
    zero-filled with ``zeros``."""
    if not isinstance(like, DTensor):
        fn = torch.zeros if zeros else torch.empty
        return fn(shape, dtype=dtype, device=like.device)
    import torch.distributed.tensor as dtensor
    mesh = like.device_mesh
    fn = dtensor.zeros if zeros else dtensor.empty
    return fn(*shape, dtype=dtype, device_mesh=mesh,
              placements=MeshContext(mesh).placements(tuple(names),
                                                      tuple(shape)))


def replica_rank(t) -> bool:
    """Whether this rank holds the copy of ``t``'s shard that counts: the
    first along every mesh dim ``t`` is replicated on (True for a plain
    tensor).  Summing the local values of the ranks where this holds
    counts a replicated dim once."""
    if not isinstance(t, DTensor):
        return True
    coord = t.device_mesh.get_coordinate()
    return all(c == 0 for c, p in zip(coord, t.placements)
               if not isinstance(p, (Shard, Partial)))


def split_batch(ctx, b: dict) -> dict:
    """Each tensor of ``b``, whole on every rank, split over ``data``
    along its leading (batch) dim under ``ctx``; ``b`` itself without a
    mesh."""
    if ctx is None:
        return b
    return {k: distribute_tensor(v, ctx.mesh, ctx.placements(
        ("batch",) + (None,) * (v.ndim - 1), tuple(v.shape)),
        src_data_rank=None) for k, v in b.items()}


def greedy_tokens(logits):
    """The argmax of the last dim as int32.  Of a DTensor on each rank's
    shards: where a mesh dim splits the vocabulary, each rank's best of
    its slice and the slices' best, the first among equal maxima as
    ``argmax`` takes it (an all-gather of (B, 1) values and indices over
    that dim, not of the logits)."""
    if not is_dtensor(logits):
        return logits.argmax(dim=-1).to(torch.int32)
    last = logits.ndim - 1
    lp = whole_along(logits)
    split = [md for md, p in enumerate(lp) if p == Shard(last)]
    out = tuple(Replicate() if p == Shard(last) else p for p in lp)
    start = shard_start(logits, last)
    group = logits.device_mesh.get_group(split[0]) if split else None

    def local(lg):
        best, idx = lg.max(dim=-1)
        idx = (idx + start).to(torch.int32)
        if group is None:
            return idx
        n = dist.get_world_size(group)
        # all_gather_single is all_gather_into_tensor's newer name
        gather = getattr(dist, "all_gather_single",
                         dist.all_gather_into_tensor)
        every = []
        for t in (best, idx):
            dst = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                              device=t.device)
            gather(dst, t.contiguous(), group=group)
            every.append(dst.view(n, *t.shape))
        pick = every[0].argmax(dim=0, keepdim=True)
        return every[1].gather(0, pick)[0]
    return on_shards(local, out, (logits,), (lp,))
