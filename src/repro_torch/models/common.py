"""Shared LM machinery: norms, activations, RoPE, embedding, logits and
seeded weight init (counterpart of ``src/repro/models/common.py``).

The reference declares every weight through a ``Builder`` (real arrays,
abstract shapes with shardings, partition specs).  Here a leaf function
takes the same declaration (shape, init, scale, dtype and the logical
``axes``): ``Init`` draws each leaf directly from a ``torch.Generator``
with the reference builder's shapes and scales, and ``AbstractBuilder``
(the reference's ``AbstractBuilder`` and ``SpecBuilder`` in one) gives
its ``LeafSpec`` — shape, dtype, and under a mesh its PartitionSpec and
DTensor placements — with no storage, for the dry run
(``launch/specs.py``) and for ``param_specs``, ``param_shapes`` and
``param_placements``.  Under a mesh ``Init`` still draws every leaf
whole, on every rank, and ``lm.shard_params`` then keeps each rank's
shard, so a sharded run starts from the one-device run's weights
exactly.  A ``torch.Generator`` gives other numbers than ``jax.random``
from the same seed: parity loads the reference's weights
(``lm.from_reference``) instead.  The tree itself keeps the reference's keys and leaf shapes
(``Leaves``).

Host arrays: numpy has no bfloat16 without ``ml_dtypes``, which the
port does not import, so ``host_array`` hands a bf16 tensor over as its
raw 16-bit patterns in a ``|V2`` void array, the bytes the reference's
``np.savez`` writes for a bf16 leaf and ``np.load`` gives back;
``from_host`` reads such an array (or an ``ml_dtypes`` bfloat16 one)
back exactly.

Numerics mirror the reference: norms and RoPE compute in fp32 and cast
back; SiLU rounds the fp32 sigmoid to the working dtype before the
product; GELU is the tanh approximation (``jax.nn.gelu``'s default);
softplus is ``jax.nn.softplus``'s formula; logits are fp32 from
working-dtype operands.

Under a mesh the embedding, the logits and the CE carry the reference's
``shard`` points.  The CE over a vocabulary sharded on ``model`` is
computed on each rank's slice of the logits: the max and the sum of
the log-sum-exp, and the label's logit, reduce over ``model``
(``_lse_minus_label``), so no rank holds a whole row of logits.
"""
from __future__ import annotations

import math
from collections.abc import Callable
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..kernels import ops
from ..sharding.api import (Partial, Replicate, Shard, get_context,
                            in_context, is_dtensor, on_shards, shard,
                            use_mesh_context, whole_along)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


# --------------------------------------------------------------------------- #
# Weight init and the parameter tree
# --------------------------------------------------------------------------- #
class Init:
    """Draws leaves as the reference's ``InitBuilder.leaf`` shapes and
    scales them: ``"normal"`` is N(0, 1) in fp32 times ``scale``
    (default 1/sqrt(fan_in), fan_in = shape[0] for a matrix, the length
    of a vector), cast to the leaf's dtype; ``"ones"``/``"zeros"`` are
    constant; a callable ``init(shape, dtype, device)`` makes the leaf
    itself.  A leaf's ``dtype`` defaults to the model's.  Draws come
    from ``generator`` in call order."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device):
        self.generator, self.dtype, self.device = generator, dtype, device

    def __call__(self, shape: tuple[int, ...],
                 init: str | Callable = "normal",
                 scale: float | None = None,
                 dtype: torch.dtype | None = None,
                 axes: tuple = ()) -> torch.Tensor:
        dtype = dtype or self.dtype
        if callable(init):
            return init(shape, dtype, self.device)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=self.device)
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if init != "normal":
            raise ValueError(init)
        if scale is None:
            fan_in = shape[0] if len(shape) >= 2 else shape[-1]
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        w = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                        device=self.device)
        return (w * scale).to(dtype)


@dataclass(frozen=True)
class LeafSpec:
    """A tensor without storage: its shape and dtype and, under a mesh,
    its PartitionSpec (one mesh-dim name, a tuple of them, or None a
    tensor dim) and the DTensor placements of that layout (None without
    a mesh)."""
    shape: tuple[int, ...]
    dtype: torch.dtype
    spec: tuple | None = None
    placements: tuple | None = None

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


class AbstractBuilder:
    """The abstract builder (the reference's ``AbstractBuilder``, whose
    ``SpecBuilder`` is its ``spec`` field): a leaf function that gives
    each leaf's ``LeafSpec``, its logical ``axes`` mapped through the
    rules table under ``ctx`` (None: no mesh).  A leaf's ``dtype``
    defaults to ``dtype``."""

    def __init__(self, ctx, dtype: torch.dtype = torch.bfloat16):
        self.ctx, self.dtype = ctx, dtype

    def __call__(self, shape, init="normal", scale=None, dtype=None,
                 axes=()) -> LeafSpec:
        shape = tuple(shape)
        if self.ctx is None:
            return LeafSpec(shape, dtype or self.dtype)
        spec = self.ctx.spec(tuple(axes), shape)
        return LeafSpec(shape, dtype or self.dtype, spec,
                        self.ctx.placements_of(spec))


def abstract_params(cfg, ctx) -> dict:
    """``lm.build_params`` through ``AbstractBuilder`` in ``cfg.dtype``:
    the parameter tree of ``LeafSpec``s.  The builders run under ``ctx``
    (when one is given), as attention's row-parallel choice reads it."""
    from . import lm
    with use_mesh_context(None if ctx is None else ctx.mesh):
        return lm.build_params(cfg, AbstractBuilder(ctx, DTYPES[cfg.dtype]))


def param_specs(cfg, ctx) -> dict:
    """Every parameter's PartitionSpec under ``ctx``, keyed by the port's
    names (``layers.3.attn.wq``): a block's is its stacked reference
    leaf's without the leading ``layers`` dim (always replicated)."""
    return {n: leaf.spec for n, leaf in
            named_leaves(abstract_params(cfg, ctx))}


def param_shapes(cfg) -> dict:
    """Every parameter's shape, keyed by the port's names."""
    return {n: leaf.shape for n, leaf in
            named_leaves(abstract_params(cfg, None))}


def named_leaves(tree, prefix=""):
    """(``layers.3.attn.wq``, leaf) of a parameter tree (dicts, and the
    stacked trees' lists of blocks), in the tree's order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def param_placements(cfg, ctx) -> dict:
    """Every parameter's DTensor placements under ``ctx``."""
    return {n: leaf.placements for n, leaf in
            named_leaves(abstract_params(cfg, ctx))}


class Leaves(nn.Module):
    """One node of the reference's parameter tree: every tensor of
    ``tree`` becomes a ``Parameter`` under its key, every dict a child
    node, so ``node.attn.wq`` reads ``params["attn"]["wq"]``.  The
    parameters start frozen, as serving wants them; ``requires_grad_()``
    (``nn.Module``'s) makes a tree trainable, as
    ``runtime.steps.init_train_state`` does."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, Leaves(value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))


def host_array(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor as a host numpy array (a view of a CPU tensor
    would change under a later in-place step); bf16 as its bits in
    ``|V2``."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view("V2")
    return t.numpy()


def from_host(a, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A host array (numpy, or a tensor) as a tensor on ``device``.  A
    ``|V2`` array, or an ``ml_dtypes`` bfloat16 one, is bf16; ``dtype``,
    when given, must be what the array holds (a checkpoint's manifest
    names it)."""
    if isinstance(a, torch.Tensor):
        t = a
    else:
        a = np.asarray(a)
        if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
            if a.dtype.itemsize != 2:
                raise TypeError(f"a {a.dtype} host array is not bfloat16")
            t = torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"host array holds {t.dtype}, expected {dtype}")
    return t.to(device)


# --------------------------------------------------------------------------- #
# Normalization / activations (fp32 internals, cast back)
# --------------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def norm(cfg, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """RMSNorm as ``cfg.attn_impl`` selects it: ``"pallas"`` → the fused
    kernel (``ops.fused_rmsnorm``; under a mesh on each rank's rows),
    ``"xla"`` → the plain ``rms_norm``."""
    if cfg.attn_impl == "pallas":
        def kernel(x, scale):
            return ops.fused_rmsnorm(x, scale, eps=cfg.norm_eps)
        if is_dtensor(x):
            # on each rank's rows, the normalised dim gathered if split
            xp = whole_along(x, (-1,))
            return on_shards(kernel, xp, (x, scale),
                             (xp, (Replicate(),) * len(xp)))
        return kernel(x, scale)
    return rms_norm(x, scale, cfg.norm_eps)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x.to(torch.float32)).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``'s formula, ``log1p(exp(-|x|)) + max(x, 0)``
    (``F.softplus`` switches to ``x`` above a threshold instead)."""
    return torch.log1p(torch.exp(-x.abs())) + x.clamp_min(0)


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #
def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  The
    split-halves form, angles in fp32 from the positions."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs      # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# Embedding / head / loss
# --------------------------------------------------------------------------- #
def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return shard(F.embedding(tokens, table), "batch", "seq", "embed")


def lm_logits(x: torch.Tensor, table: torch.Tensor,
              head: torch.Tensor | None) -> torch.Tensor:
    """x: (B, S, D) → (B, S, V) fp32.  ``head`` is the untied (D, V)
    weight; tied models use ``table.T``.  The product takes x's dtype
    for both operands and accumulates and returns fp32, as the
    reference's ``preferred_element_type=f32`` does (a bf16 product
    upcast afterwards would round each logit to bf16 first)."""
    if x.ndim == 3:
        # under a mesh the rows come whole along the sequence
        x = shard(x, "batch", "seq", "embed")
    w = (head if head is not None else table.t()).to(x.dtype)
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32:
        out = x2 @ w
    elif x.is_cuda:
        out = _fp32_product(x2, w)
    else:
        # products of two bf16/fp16 values are exact in fp32, so an fp32
        # product of the upcast operands is the same function
        out = x2.to(torch.float32) @ w.to(torch.float32)
    out = out.reshape(*x.shape[:-1], w.shape[-1])
    if out.ndim == 3:
        out = shard(out, "batch", "seq", "vocab")
    return out


def _fp32_product(x2, w):
    """``_Fp32Product`` of (rows, D) ``x2`` and (D, V) ``w``; under a mesh
    on the local shards (``torch.mm``'s ``out_dtype`` has no DTensor
    rule): ``x2``'s rows sharded (on ``data``) or whole, ``w``'s columns
    sharded (on ``model``) or whole.  Each rank's product is its block
    of the logits; its gradient of ``x2`` is a share of the sum over the
    vocabulary's shards, of ``w`` one over the rows'."""
    if not is_dtensor(x2):
        return _Fp32Product.apply(x2, w)
    xp, wp = tuple(x2.placements), tuple(w.placements)
    out, gx, gw = [], [], []
    for a, b in zip(xp, wp):
        rows, cols = a == Shard(0), b == Shard(1)
        if (not rows and a != Replicate()) or (not cols and b != Replicate()) \
                or rows and cols:
            raise ValueError(f"no local product for x {xp} @ w {wp}")
        out.append(Shard(0) if rows else Shard(1) if cols else Replicate())
        gx.append(Partial() if cols else a)
        gw.append(Partial() if rows else b)
    return on_shards(_Fp32Product.apply, tuple(out), (x2, w), (xp, wp),
                     (tuple(gx), tuple(gw)))


class _Fp32Product(torch.autograd.Function):
    """``x2 @ w`` of two bf16/fp16 matrices with fp32 accumulation and
    output (cuBLAS through ``torch.mm``'s ``out_dtype``, which has no
    derivative of its own).  The backward is the reference's transpose:
    the fp32 cotangent times the other operand upcast to fp32 (exact),
    each product fp32 and rounded to its operand's dtype only at the
    end, the gradient of the CPU branch's upcast product."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(torch.float32)
        return ((g @ w.t().to(torch.float32)).to(x2.dtype),
                (x2.t().to(torch.float32) @ g).to(w.dtype))


def _lse_minus_label(logits: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """Per-token ``logsumexp - logit[label]`` of (..., V) fp32 logits,
    the reference's max-shifted form; under a mesh on each rank's slice
    of the vocabulary (``_vocab_parallel``)."""
    if is_dtensor(logits):
        ctx = get_context()
        names = ("batch",) + ("seq",) * (logits.ndim - 2)
        lp = ctx.placements((*names, "vocab"), tuple(logits.shape))
        tp = ctx.placements(names, tuple(labels.shape))
        fn = _lse_minus_label
        if "model" in ctx.axis_names and ctx.size("model") > 1 \
                and lp[ctx.axis_names.index("model")] != Replicate():
            mesh = ctx.mesh
            fn = _VocabParallel(mesh.get_group("model"),
                                mesh.get_local_rank("model"))
        return on_shards(fn, tp, (logits, labels), (lp, tp))
    m = logits.amax(dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
    lab = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - lab


class SumOver(torch.autograd.Function):
    """The sum of every rank's tensor over ``group`` (an all-reduce),
    whose gradient on each rank is the output's: each rank's tensor is a
    share of a sum that every rank then uses whole."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.clone()
        torch.distributed.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


class _VocabParallel:
    """``_lse_minus_label`` of one rank's (..., V/tp) slice of the logits
    (the ``model`` dim's ``rank``-th): the max, the exponentials' sum and
    the label's logit (from the rank that holds it, 0 elsewhere) reduce
    over ``group``.  The max is a shift that cancels in the value and
    its gradient; it is taken without one."""

    def __init__(self, group, rank: int):
        self.group, self.rank = group, rank

    def __call__(self, logits, labels):
        V = logits.shape[-1]
        m = logits.detach().amax(dim=-1, keepdim=True)
        torch.distributed.all_reduce(m, torch.distributed.ReduceOp.MAX,
                                     group=self.group)
        s = SumOver.apply(torch.exp(logits - m).sum(dim=-1), self.group)
        lse = m[..., 0] + torch.log(s)
        lab = labels.long() - self.rank * V
        inside = (lab >= 0) & (lab < V)
        picked = torch.gather(logits, -1, lab.clamp(0, V - 1)[..., None])
        picked = torch.where(inside, picked[..., 0], 0.0)
        return lse - SumOver.apply(picked, self.group)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """logits: (B, S, V) fp32; labels: (B, S) → the mean loss (over the
    tokens ``mask`` keeps, when given)."""
    nll = _lse_minus_label(logits, labels)
    if mask is not None:
        nll = nll * mask
        return nll.sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


def _chunk_ce_sum(x: torch.Tensor, table: torch.Tensor,
                  head: torch.Tensor | None,
                  labels: torch.Tensor) -> torch.Tensor:
    return _lse_minus_label(lm_logits(x, table, head), labels).sum()


def chunked_cross_entropy(x: torch.Tensor, table: torch.Tensor,
                          head: torch.Tensor | None, targets: torch.Tensor,
                          chunk: int) -> torch.Tensor:
    """The mean CE of ``x`` (B, S, D), the final hidden states, against
    ``targets`` (B, S) without holding the (B, S, V) fp32 logits: chunks
    of ``chunk`` tokens along S, each rematerialised in the backward
    pass (``torch.utils.checkpoint``, as the reference's
    ``jax.checkpoint``), so the peak holds one (B, chunk, V) block.  The
    dense logits are taken where the reference takes them: ``chunk <=
    0``, ``S <= chunk`` or S not a multiple of ``chunk``."""
    B, S, _ = x.shape
    if chunk <= 0 or S <= chunk or S % chunk:
        return cross_entropy(lm_logits(x, table, head), targets)
    # under a mesh the chunks cut the sequence, so it comes whole
    x = shard(x, "batch", "seq", "embed")
    total = None
    for c0 in range(0, S, chunk):
        c = slice(c0, c0 + chunk)
        part = torch.utils.checkpoint.checkpoint(
            in_context(_chunk_ce_sum), x[:, c], table, head, targets[:, c],
            use_reentrant=False, preserve_rng_state=False)
        total = part if total is None else total + part
    return total / (B * S)
