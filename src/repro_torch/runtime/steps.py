"""Step functions: train, prefill and greedy decode (counterpart of
``src/repro/runtime/steps.py``).

The reference's steps are the units ``jax.jit`` compiles; PyTorch runs
eagerly, so here they are plain closures over the config.  The training
state keeps the reference's keys, with the module in place of the
parameter tree: ``{"model": LM (trainable), "opt": {"m", "v"} fp32
moments keyed by parameter name and "count", "step"}`` and, under
compression, ``"err"``.  A train step updates the model and the moments
in place and returns the state with its new counts, and metrics (``loss``,
``ce``, ``aux``, ``grad_norm``, ``lr``) as device tensors: read them on
the host only when logging, as the reference's loop does.  Training runs
the plain route (``cfg.attn_impl="xla"``), as the reference's always
does: the kernels have no backward, and ``kernels.ops`` raises if
autograd would record one.

Under a mesh (``sharding.api.use_mesh_context`` around
``make_train_step`` and ``train_state``, the model placed by
``lm.shard_params``) the step is the reference's under its mesh: the
batch, whole on every rank, is split over ``data``; the model runs on
DTensors with the reference's ``shard`` points; each gradient's sum over
``data`` is redistributed straight into its ZeRO-1 placements
(``sharding.api.zero1_spec``: a reduce-scatter), where the fp32
accumulator (``grad_accum``), the error feedback (compression) and the
moments live; AdamW updates each rank's shard and gathers the parameter
back.  The reference's ZeRO-1 dim is its stacked leaf's, often
``layers``; here each block's parameter takes ``zero1_spec`` of its own
spec, so each rank holds the same bytes of every leaf's moments as the
reference's device does wherever a block's dims divide.  The metrics
come back whole, plain tensors on every rank (their gather is a
collective of the step, which every rank makes).
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from ..launch.mesh import is_pod_mesh, stage_mesh
from ..models import lm
from ..models.common import (chunked_cross_entropy, param_placements,
                             param_shapes, param_specs)
from ..optim import (CompressionConfig, OptConfig, apply_gradients,
                     compress_gradients, init_error_state, init_opt_state)
from ..optim.adamw import reference_leaf
from ..sharding.api import (Layout, MeshContext, Replicate, Shard, full,
                            get_context, greedy_tokens, is_dtensor,
                            split_batch, to_placements, use_mesh_context,
                            zero1_spec)
from .pipeline import (PipelineConfig, gather_named, place_stages,
                       repack_params, unpack_params)


def loss_fn(cfg, model: lm.LM, batch: dict):
    """CE through the seq-chunked head (the (B, S, V) logits are never
    held; dense for a short S, as in the reference) plus 1e-2 · the moe
    family's load-balance term → (loss, {"ce", "aux"})."""
    x, aux = lm.hidden_train(cfg, model, batch)
    head = model.lm_head.w if model.lm_head is not None else None
    ce = chunked_cross_entropy(x, model.embed.table, head, batch["targets"],
                               cfg.ce_chunk)
    return ce + 1e-2 * aux, {"ce": ce, "aux": aux}


def zero1_placements(cfg, ctx) -> dict:
    """Every parameter's ZeRO-1 placements under ``ctx``: its spec with
    ``data`` on the first free dim that divides (``zero1_spec``).  A
    block whose dims are all taken or do not divide, of a stack whose
    depth does divide ``data`` (where the reference's stacked leaf puts
    ``data`` on its ``layers`` dim), splits its ``model``-sharded dim
    over ``data`` too, where that divides: each rank then holds the
    reference device's bytes of the leaf."""
    shapes = param_shapes(cfg)
    dp, tp = ctx.size("data"), ctx.size("model")
    out = {}
    with use_mesh_context(ctx.mesh):
        for n, spec in param_specs(cfg, ctx).items():
            shape = shapes[n]
            z1 = zero1_spec(spec, shape)
            depth = getattr(cfg, lm.STACKS.get(n.partition(".")[0], ""), 0)
            both = [i for i, a in enumerate(spec) if a == "model"
                    and shape[i] % (dp * tp) == 0]
            if z1 == spec and dp > 1 and depth and depth % dp == 0 and both:
                out[n] = tuple(Shard(both[0]) if a in ("data", "model")
                               and ctx.size(a) > 1 else Replicate()
                               for a in ctx.axis_names)
            else:
                out[n] = ctx.placements_of(z1)
    return out


def make_train_step(cfg, opt: OptConfig,
                    comp: CompressionConfig | None = None,
                    grad_accum: int = 1):
    """→ ``train_step(state, batch) -> (state, metrics)``.  ``grad_accum``
    > 1 runs the batch as that many microbatches, summing their
    gradients in fp32 (the reference's scan): the activations shrink by
    the factor at the cost of reading the weights once a microbatch.
    Made under a mesh, the step runs under it (the module's docstring)
    with the batch given whole on every rank."""
    comp = comp or CompressionConfig()
    ctx = get_context()
    z1 = zero1_placements(cfg, ctx) if ctx is not None else None

    def placed(b):
        return split_batch(ctx, b)

    def _z1(name, g):
        return g if z1 is None else to_placements(g, z1[name])

    def _grads(model, batch):
        names, params = zip(*model.named_parameters())

        def grads_of(b):
            loss, parts = loss_fn(cfg, model, placed(b))
            g = torch.autograd.grad(loss, params, materialize_grads=True)
            return loss.detach(), parts, dict(zip(names, g))

        if grad_accum <= 1:
            loss, parts, g = grads_of(batch)
            return loss, parts, {n: _z1(n, t) for n, t in g.items()}
        mbs = {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                            *v.shape[1:]) for k, v in batch.items()}
        gsum = None
        lsum = 0.0
        for i in range(grad_accum):
            loss, parts, g = grads_of({k: v[i] for k, v in mbs.items()})
            g = {n: _z1(n, t.to(torch.float32)) for n, t in g.items()}
            gsum = g if gsum is None else \
                {n: gsum[n] + g[n] for n in names}
            lsum = lsum + loss
        grads = {n: g / grad_accum for n, g in gsum.items()}
        return lsum / grad_accum, parts, grads      # the last microbatch's parts

    def train_step(state: dict, batch: dict):
        model = state["model"]
        with _scope(ctx):
            loss, parts, grads = _grads(model, batch)
            if comp.enabled:
                grads, err = compress_gradients(grads, state["err"], comp)
            params = dict(model.named_parameters())
            opt_state, om = apply_gradients(params, grads, state["opt"], opt)
            loss = full(loss)
            parts = {k: full(v.detach()) for k, v in parts.items()}
        new_state = {"model": model, "opt": opt_state,
                     "step": state["step"] + 1}
        if comp.enabled:
            new_state["err"] = err
        return new_state, {"loss": loss, **parts, **om}

    return train_step


def _scope(ctx):
    """``_mesh_scope(ctx)``, or nothing without a mesh."""
    return contextlib.nullcontext() if ctx is None else _mesh_scope(ctx)


@contextlib.contextmanager
def _mesh_scope(ctx):
    """The mesh's context, with plain tensors (positions, masks, the
    scalars of the loss) taken as replicated on it."""
    with use_mesh_context(ctx.mesh), implicit_replication():
        yield


def make_prefill_step(cfg, cache_len: int | None = None,
                      with_logits: bool = False):
    """→ ``prefill_step(model, inputs) -> (tokens (B, 1) int32, cache)``,
    and the fp32 (B, 1, V) logits too with ``with_logits``.  Made under
    a mesh, the step runs under it on the model ``lm.shard_params``
    placed: the inputs, whole on every rank, are split over ``data``;
    the cache comes back in its sharded layout (``lm.cache_names``), the
    tokens and logits whole on every rank (a gather every rank makes)."""
    ctx = get_context()

    def prefill_step(model, inputs):
        with _scope(ctx):
            logits, cache = lm.forward_prefill(
                cfg, model, split_batch(ctx, inputs), cache_len)
            return _greedy(logits, cache, with_logits)
    return prefill_step


def make_decode_step(cfg, with_logits: bool = False):
    """→ ``decode_step(model, token, cache) -> (tokens, cache)`` (and the
    logits with ``with_logits``): one greedy step on ``token`` (B, 1),
    writing into ``cache``; under a mesh as ``make_prefill_step``, the
    token whole on every rank and the cache as prefill laid it out."""
    ctx = get_context()

    def decode_step(model, token, cache):
        with _scope(ctx):
            logits, cache = lm.forward_decode(
                cfg, model, split_batch(ctx, {"t": token})["t"], cache)
            return _greedy(logits, cache, with_logits)
    return decode_step


def _greedy(logits, cache, with_logits: bool):
    tok = full(greedy_tokens(logits))
    return (tok, cache, full(logits)) if with_logits else (tok, cache)


def init_train_state(cfg, generator: torch.Generator,
                     comp: CompressionConfig | None = None,
                     device=None) -> dict:
    """A fresh state: random weights in ``cfg.dtype`` from ``generator``
    (on ``device``, ``cuda`` unless the caller names another),
    trainable; zero moments and counts; zero error feedback under
    compression.  Under a mesh every rank draws the whole weights and
    keeps its shards (``train_state``)."""
    return train_state(lm.init(cfg, generator, device), comp)


def train_state(model: lm.LM, comp: CompressionConfig | None = None) -> dict:
    """A fresh state around ``model``, made trainable: zero moments and
    counts on its device; zero error feedback under compression.  Under
    a mesh the model is placed on it first (``lm.shard_params``, unless
    it is), and the moments and the error feedback are DTensors in the
    ZeRO-1 placements."""
    z1 = _placed(model)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    state = {"model": model, "opt": init_opt_state(params, z1),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=model.device)}
    if comp is not None and comp.enabled:
        state["err"] = init_error_state(params, z1)
    return state


def _placed(model: lm.LM) -> dict | None:
    """Under a mesh, ``model`` placed on it (if it is not) → the ZeRO-1
    placements of its parameters; None without a mesh."""
    ctx = get_context()
    if ctx is None:
        return None
    if not is_dtensor(model.embed.table):
        lm.shard_params(model.cfg, model, ctx)
    return zero1_placements(model.cfg, ctx)


def reference_layouts(cfg, ctx, comp: CompressionConfig | None = None
                      ) -> dict:
    """The layouts of a state in the reference's tree under ``ctx`` (the
    specs tree ``checkpoint.load_checkpoint`` takes): every parameter in
    its placements, the moments and the error feedback in ZeRO-1's, a
    stacked leaf's with its blocks' placements one dim further in."""
    def tree_of(placements: dict) -> dict:
        tree: dict = {}
        for name, pl in placements.items():
            leaf, stacked = reference_leaf(name)
            if stacked:
                pl = tuple(Shard(p.dim + 1) if isinstance(p, Shard) else p
                           for p in pl)
            lm._put(tree, leaf.split("."), Layout(ctx.mesh, pl))
        return tree
    z1 = tree_of(zero1_placements(cfg, ctx))
    tree = {"params": tree_of(param_placements(cfg, ctx)),
            "opt": {"m": z1, "v": z1}}
    if comp is not None and comp.enabled:
        tree["err"] = z1
    return tree


def _relaid(tree: dict, fn) -> dict:
    """``tree`` with ``fn`` applied to its pipelined stack (``layers``, or
    the enc-dec family's ``dec_layers``)."""
    key = "dec_layers" if "dec_layers" in tree else "layers"
    return {**tree, key: fn(tree[key])}


def reference_state(state: dict, pcfg: PipelineConfig | None = None,
                    keep: bool = True) -> dict | None:
    """The state as the reference's tree of host arrays (``params``,
    ``opt``, ``step``, ``err``), each stacked tree's blocks stacked on
    the layer axis: what a checkpoint holds.  A pipelined state
    (``pcfg``) has its layers, and their moments, in the reference's
    pipeline layout (K, l_max, ...), zero pads included.  Under a mesh
    every rank gathers; only a rank that ``keep``s the tree (the one
    that writes it) copies it to the host, the others get None.  On the
    ranks' pod mesh each stage's leaves come from their pod, and rank 0
    keeps them."""
    model = state["model"]
    pods = model.pod_mesh

    def tree_of(named):
        if pods is not None:
            named = gather_named(model.cfg, pcfg, pods, named, keep)
        tree = lm.reference_tree(named, keep)
        if pcfg is None or not keep:
            return tree
        return _relaid(tree, lambda t: repack_params(
            t, pcfg, next(_leaves(t)).shape[0]))
    tree = {"params": tree_of(dict(model.named_parameters())),
            "opt": {"m": tree_of(state["opt"]["m"]),
                    "v": tree_of(state["opt"]["v"]),
                    "count": state["opt"]["count"]},
            "step": state["step"]}
    if "err" in state:
        tree["err"] = tree_of(state["err"])
    return tree if keep else None


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def state_from_reference(cfg, tree: dict, device=None,
                         pcfg: PipelineConfig | None = None,
                         mesh=None) -> dict:
    """The inverse of ``reference_state``: a reference-layout state (a
    checkpoint's, of either package) as a port state on ``device``, its
    model trainable; a pipelined one (``pcfg``, its layers in the
    reference's pipeline layout) with its stages placed on ``mesh``; on
    the ranks' pod mesh each rank keeps its stage and the pod-replicated
    leaves, the moments in ZeRO-1's placements on its pod's sub-mesh.
    Under a mesh (``sharding.api.use_mesh_context``) every rank keeps
    its shards: the parameters in their placements, the moments and the
    error feedback in ZeRO-1's; leaves already placed there (a
    checkpoint loaded with ``reference_layouts``) stay as they are."""
    def named(t):
        if pcfg is not None:
            t = _relaid(t, lambda s: unpack_params(s, pcfg, cfg.n_layers))
        return t
    model = lm.from_reference(cfg, named(tree["params"]), device)
    model.requires_grad_(True)
    dev = model.device
    opt = tree["opt"]
    state = {"model": model,
             "opt": {"m": lm.named_from_reference(cfg, named(opt["m"]), dev),
                     "v": lm.named_from_reference(cfg, named(opt["v"]), dev),
                     "count": torch.as_tensor(opt["count"]).to(dev)},
             "step": torch.as_tensor(tree["step"]).to(dev)}
    if "err" in tree:
        state["err"] = lm.named_from_reference(cfg, named(tree["err"]), dev)
    if pcfg is not None and is_pod_mesh(mesh):
        place_stages(cfg, model, pcfg, mesh)
        sub = stage_mesh(mesh)
        z1 = zero1_placements(cfg, MeshContext(sub))
        own = dict(model.named_parameters())
        for part in (state["opt"]["m"], state["opt"]["v"],
                     state.get("err", {})):
            for n in list(part):
                if n in own:
                    part[n] = distribute_tensor(part[n], sub, z1[n],
                                                src_data_rank=None)
                else:
                    del part[n]
        return state
    z1 = _placed(model)
    if z1 is not None:
        mesh = get_context().mesh
        for part in (state["opt"]["m"], state["opt"]["v"],
                     state.get("err", {})):
            for n, t in part.items():
                if not is_dtensor(t):
                    part[n] = distribute_tensor(t, mesh, z1[n],
                                                src_data_rank=None)
    if pcfg is not None:
        place_stages(cfg, model, pcfg, mesh)
        params = dict(model.named_parameters())
        for key in ("m", "v"):
            state["opt"][key] = {n: t.to(params[n].device)
                                 for n, t in state["opt"][key].items()}
    return state
