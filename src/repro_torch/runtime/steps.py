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
autograd would record one.  The ZeRO-1 sharding of the gradient
accumulator waits for sharding (ROADMAP queue 1, item 12b); with one
device it is the identity, as in the reference without a mesh.
"""
from __future__ import annotations

import torch

from ..models import lm
from ..models.common import chunked_cross_entropy
from ..optim import (CompressionConfig, OptConfig, apply_gradients,
                     compress_gradients, init_error_state, init_opt_state)
from .pipeline import (PipelineConfig, place_stages, repack_params,
                       unpack_params)


def loss_fn(cfg, model: lm.LM, batch: dict):
    """CE through the seq-chunked head (the (B, S, V) logits are never
    held; dense for a short S, as in the reference) plus 1e-2 · the moe
    family's load-balance term → (loss, {"ce", "aux"})."""
    x, aux = lm.hidden_train(cfg, model, batch)
    head = model.lm_head.w if model.lm_head is not None else None
    ce = chunked_cross_entropy(x, model.embed.table, head, batch["targets"],
                               cfg.ce_chunk)
    return ce + 1e-2 * aux, {"ce": ce, "aux": aux}


def make_train_step(cfg, opt: OptConfig,
                    comp: CompressionConfig | None = None,
                    grad_accum: int = 1):
    """→ ``train_step(state, batch) -> (state, metrics)``.  ``grad_accum``
    > 1 runs the batch as that many microbatches, summing their
    gradients in fp32 (the reference's scan): the activations shrink by
    the factor at the cost of reading the weights once a microbatch."""
    comp = comp or CompressionConfig()

    def _grads(model, batch):
        names, params = zip(*model.named_parameters())

        def grads_of(b):
            loss, parts = loss_fn(cfg, model, b)
            g = torch.autograd.grad(loss, params, materialize_grads=True)
            return loss.detach(), parts, dict(zip(names, g))

        if grad_accum <= 1:
            return grads_of(batch)
        mbs = {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                            *v.shape[1:]) for k, v in batch.items()}
        gsum = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in zip(names, params)}
        lsum = 0.0
        for i in range(grad_accum):
            loss, parts, g = grads_of({k: v[i] for k, v in mbs.items()})
            for n in names:
                gsum[n] += g[n].to(torch.float32)
            lsum = lsum + loss
        grads = {n: g / grad_accum for n, g in gsum.items()}
        return lsum / grad_accum, parts, grads      # the last microbatch's parts

    def train_step(state: dict, batch: dict):
        model = state["model"]
        loss, parts, grads = _grads(model, batch)
        if comp.enabled:
            grads, err = compress_gradients(grads, state["err"], comp)
        params = dict(model.named_parameters())
        opt_state, om = apply_gradients(params, grads, state["opt"], opt)
        new_state = {"model": model, "opt": opt_state,
                     "step": state["step"] + 1}
        if comp.enabled:
            new_state["err"] = err
        parts = {k: v.detach() for k, v in parts.items()}
        return new_state, {"loss": loss, **parts, **om}

    return train_step


def make_prefill_step(cfg, cache_len: int | None = None):
    def prefill_step(model, inputs):
        logits, cache = lm.forward_prefill(cfg, model, inputs, cache_len)
        return logits.argmax(dim=-1).to(torch.int32), cache
    return prefill_step


def make_decode_step(cfg):
    def decode_step(model, token, cache):
        logits, cache = lm.forward_decode(cfg, model, token, cache)
        return logits.argmax(dim=-1).to(torch.int32), cache
    return decode_step


def init_train_state(cfg, generator: torch.Generator,
                     comp: CompressionConfig | None = None,
                     device=None) -> dict:
    """A fresh state: random weights in ``cfg.dtype`` from ``generator``
    (on ``device``, ``cuda`` unless the caller names another),
    trainable; zero moments and counts; zero error feedback under
    compression."""
    return train_state(lm.init(cfg, generator, device), comp)


def train_state(model: lm.LM, comp: CompressionConfig | None = None) -> dict:
    """A fresh state around ``model``, made trainable: zero moments and
    counts on its device; zero error feedback under compression."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    state = {"model": model, "opt": init_opt_state(params),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=model.device)}
    if comp is not None and comp.enabled:
        state["err"] = init_error_state(params)
    return state


def _relaid(tree: dict, fn) -> dict:
    """``tree`` with ``fn`` applied to its pipelined stack (``layers``, or
    the enc-dec family's ``dec_layers``)."""
    key = "dec_layers" if "dec_layers" in tree else "layers"
    return {**tree, key: fn(tree[key])}


def reference_state(state: dict, pcfg: PipelineConfig | None = None) -> dict:
    """The state as the reference's tree of host arrays (``params``,
    ``opt``, ``step``, ``err``), each stacked tree's blocks stacked on
    the layer axis: what a checkpoint holds.  A pipelined state
    (``pcfg``) has its layers, and their moments, in the reference's
    pipeline layout (K, l_max, ...), zero pads included."""
    def tree_of(named):
        tree = lm.reference_tree(named)
        if pcfg is None:
            return tree
        return _relaid(tree, lambda t: repack_params(
            t, pcfg, next(_leaves(t)).shape[0]))
    tree = {"params": tree_of(dict(state["model"].named_parameters())),
            "opt": {"m": tree_of(state["opt"]["m"]),
                    "v": tree_of(state["opt"]["v"]),
                    "count": state["opt"]["count"]},
            "step": state["step"]}
    if "err" in state:
        tree["err"] = tree_of(state["err"])
    return tree


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
    reference's pipeline layout) with its stages placed on ``mesh``."""
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
    if pcfg is not None:
        place_stages(cfg, model, pcfg, mesh)
        params = dict(model.named_parameters())
        for key in ("m", "v"):
            state["opt"][key] = {n: t.to(params[n].device)
                                 for n, t in state["opt"][key].items()}
    return state
