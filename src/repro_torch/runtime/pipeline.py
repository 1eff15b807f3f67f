"""Multi-pod pipeline parallelism, ParetoPipe's split scaled to pods
(counterpart of ``src/repro/runtime/pipeline.py``).

The partitioner (``models.blocks_adapter.choose_pipeline_cuts``) assigns
a contiguous layer range to each stage; cuts may be uneven, which is the
paper's point.  The reference runs the stages as one SPMD program over
the mesh's ``pod`` axis; the port runs the same schedule from one
process (``launch.mesh``): stage ``k``'s layers live on
``mesh.devices[k]`` (``place_stages``), and an activation crosses to the
next stage as ``y.to(devices[k + 1])``, which autograd differentiates.
On one card every stage shares it.

Inside a stage the port calls the unpipelined trunk over the stage's
layer range (``lm.trunk_train``/``trunk_prefill``/``trunk_decode`` and
the decoder's), so a pipelined serve runs the same kernels on the same
tensors in the same order as the unpipelined one: its tokens and logits
are equal to it bit for bit.  The reference pads every stage to the
deepest (``l_max``) and computes its pad layers only to discard them
(``where(li < count, y, x)``); the port does not run them, which gives
the same result.  Its caches hold only a stage's own layers (and the
hybrid's applications, at the reference's slot index);
``reference_cache`` pads them to the reference's (K, l_max, ...) layout.

Train (K stages, M microbatches, T = M + K - 1 ticks, the reference's
GPipe schedule): at tick t stage k runs microbatch t - k.  The embedding
(and the enc-dec family's encoder, once for the batch) runs on stage 0's
device; the final norm and the chunked CE over the whole batch on the
last stage's.  The loss is the CE alone: the moe family's load-balance
term is dropped, as the reference drops it.  On several cards the host
issues a tick's stages one after another and each card runs its own, so
their work overlaps; on one card it runs in turn.

Parameters stay the port's (an ``LM``, one module a layer); the
reference's pipelined tree stacks a stage's layers as (K, l_max, ...),
zero-padded: ``repack_params``/``unpack_params`` convert the stacked
layouts, and ``runtime.steps.reference_state`` writes a pipelined state
in it.
"""
from __future__ import annotations

import math
import types
from dataclasses import dataclass

import numpy as np
import torch

from ..models import lm
from ..models.common import chunked_cross_entropy, embed_lookup, lm_logits
from ..optim import OptConfig, apply_gradients


# --------------------------------------------------------------------------- #
# Stage layout / param repacking
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class PipelineConfig:
    n_stages: int
    microbatches: int
    cuts: tuple[int, ...]            # interior layer cuts, len = n_stages-1

    @staticmethod
    def even(n_layers: int, n_stages: int, microbatches: int) -> "PipelineConfig":
        base = n_layers // n_stages
        rem = n_layers % n_stages
        counts = [base + (1 if i < rem else 0) for i in range(n_stages)]
        cuts = tuple(np.cumsum(counts)[:-1].tolist())
        return PipelineConfig(n_stages, microbatches, cuts)

    def layout(self, n_layers: int):
        """→ (starts (K,), counts (K,), l_max)."""
        bounds = (0, *self.cuts, n_layers)
        starts = np.array(bounds[:-1])
        counts = np.diff(bounds)
        if (counts < 0).any():
            raise ValueError(f"bad cuts {self.cuts}")
        return starts, counts, int(counts.max())

    def ranges(self, n_layers: int) -> list[range]:
        """Each stage's layers."""
        starts, counts, _ = self.layout(n_layers)
        return [range(int(s), int(s + c)) for s, c in zip(starts, counts)]


class PipelineBuilder:
    """A leaf function (``common.Init``'s signature) that declares layer
    leaves with ``lead`` axes in front ((n_stages, l_max) for the
    pipeline, (n_layers,) for a stacked tree) through ``base``, each
    scaled by its own layer's fan-in, as the reference's builders do."""

    def __init__(self, base, lead: tuple[int, ...]):
        self.base, self.lead = base, lead

    def __call__(self, shape, init="normal", scale=None, dtype=None,
                 axes=()):
        if init == "normal" and scale is None:
            fan_in = shape[0] if len(shape) >= 2 else shape[-1]
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        if callable(init):
            orig, n = init, len(self.lead)
            init = lambda s, d, dev: orig(s[n:], d, dev).expand(s).clone()
        return self.base((*self.lead, *shape), init, scale, dtype,
                         axes=(*(None,) * len(self.lead), *axes))


def build_pipeline_params(cfg, leaf, pcfg: PipelineConfig) -> dict:
    """The reference's ``build_pipeline_params`` tree, drawn through the
    leaf function ``leaf`` (a ``common.Init``): ``lm.build_params``' tree
    with the layers (the enc-dec family's decoder layers) stacked in
    pipeline layout and the encoder's on a layer axis."""
    encdec = cfg.family == "encdec"
    tree: dict = {"embed": {"table": leaf((cfg.vocab, cfg.d_model),
                                          scale=0.02)},
                  "final_norm": lm._norm_params(leaf, cfg.d_model, encdec)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": leaf((cfg.d_model, cfg.vocab))}
    pb = PipelineBuilder(leaf, (pcfg.n_stages, pcfg.layout(cfg.n_layers)[2]))
    if encdec:
        tree["enc_layers"] = lm._attn_block_params(
            cfg, PipelineBuilder(leaf, (cfg.n_enc_layers,)), True)
        tree["enc_final_norm"] = lm._norm_params(leaf, cfg.d_model, True)
        tree["dec_layers"] = {**lm._attn_block_params(cfg, pb, True),
                              "ln_x": lm._norm_params(pb, cfg.d_model, True),
                              "xattn": lm.attn_params(cfg, pb)}
        return tree
    tree["layers"] = lm.layer_params(cfg, pb)
    if cfg.family == "hybrid":
        tree["shared"] = lm._attn_block_params(cfg, leaf)
    return tree


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def repack_params(stacked_layers, pcfg: PipelineConfig, n_layers: int):
    """(L, ...) canonical → (K, l_max, ...) pipeline layout (zero-padded);
    numpy arrays or tensors, a leaf or a tree of them."""
    starts, counts, l_max = pcfg.layout(n_layers)

    def repack(leaf):
        if isinstance(leaf, torch.Tensor):
            out = leaf.new_zeros((pcfg.n_stages, l_max, *leaf.shape[1:]))
        else:
            out = np.zeros((pcfg.n_stages, l_max, *leaf.shape[1:]),
                           leaf.dtype)
        for s in range(pcfg.n_stages):
            out[s, :counts[s]] = leaf[starts[s]:starts[s] + counts[s]]
        return out
    return _tree_map(repack, stacked_layers)


def unpack_params(pipeline_layers, pcfg: PipelineConfig, n_layers: int):
    """Inverse of repack_params (for elastic resharding / checkpoints)."""
    _, counts, _ = pcfg.layout(n_layers)

    def unpack(leaf):
        parts = [leaf[s, :counts[s]] for s in range(pcfg.n_stages)]
        if isinstance(leaf, torch.Tensor):
            return torch.cat(parts, 0)
        return np.concatenate(parts, axis=0)
    return _tree_map(unpack, pipeline_layers)


# --------------------------------------------------------------------------- #
# Stage placement
# --------------------------------------------------------------------------- #
def _stack(cfg, model: lm.LM):
    return model.dec_layers if cfg.family == "encdec" else model.layers


def place_stages(cfg, model: lm.LM, pcfg: PipelineConfig, mesh) -> lm.LM:
    """Moves stage k's layers to ``mesh.devices[k]``, the embedding (and
    the encoder, the hybrid's shared block) to the first stage's device,
    the final norm and an untied head to the last's; in place → model.
    Make a training state after this, so its moments sit beside their
    parameters."""
    devs = mesh.devices
    if len(devs) != pcfg.n_stages:
        raise ValueError(f"{len(devs)} devices for {pcfg.n_stages} stages")
    stack = _stack(cfg, model)
    for dev, layers in zip(devs, pcfg.ranges(cfg.n_layers)):
        for i in layers:
            stack[i].to(dev)
    for name in ("embed", "enc_layers", "enc_final_norm", "shared"):
        if getattr(model, name, None) is not None:
            getattr(model, name).to(devs[0])
    for name in ("final_norm", "lm_head"):
        if getattr(model, name) is not None:
            getattr(model, name).to(devs[-1])
    return model


def _check_placed(cfg, model: lm.LM, pcfg: PipelineConfig, devs) -> None:
    """A stage runs where it was placed, never elsewhere: raise if a
    layer's weights are not on its stage's device."""
    stack = _stack(cfg, model)
    for k, layers in enumerate(pcfg.ranges(cfg.n_layers)):
        for i in layers:
            dev = next(stack[i].parameters()).device
            if dev != devs[k]:
                raise RuntimeError(f"layer {i} of stage {k} lies on {dev}, "
                                   f"not on {devs[k]}: place_stages first")


def _on(node, device):
    """A ``Leaves`` node as it lives on ``device``: the node itself if it
    is there, else a copy of its tree that autograd differentiates (its
    gradient flows back to the one set of parameters)."""
    if next(node.parameters()).device == device:
        return node
    kids = {n: _on(c, device) for n, c in node.named_children()}
    leaves = {n: p.to(device) for n, p in node.named_parameters(recurse=False)}
    return types.SimpleNamespace(**kids, **leaves)


def _head(model: lm.LM, device):
    """(table, head) for the logits on ``device``: a tied table is one
    parameter, used by the embedding on the first stage and copied here,
    so that its gradient sums both uses."""
    head = model.lm_head.w if model.lm_head is not None else None
    return model.embed.table.to(device), head


# --------------------------------------------------------------------------- #
# Pipelined train step
# --------------------------------------------------------------------------- #
def pipeline_loss(cfg, pcfg: PipelineConfig, mesh, model: lm.LM,
                  batch: dict) -> torch.Tensor:
    """The CE of ``batch`` through the stages, differentiable: GPipe over
    ``pcfg.microbatches`` microbatches (the reference's ``loss_fn``)."""
    K, M, devs = pcfg.n_stages, pcfg.microbatches, mesh.devices
    ranges = pcfg.ranges(cfg.n_layers)
    _check_placed(cfg, model, pcfg, devs)
    inputs = {k: v for k, v in batch.items() if k != "targets"}
    x = lm.embed_inputs(cfg, model, inputs)
    B, S, _ = x.shape
    if B % M:
        raise ValueError(f"batch {B} % microbatches {M}")
    xs = x.split(B // M)
    encs = None
    if cfg.family == "encdec":
        encs = lm.encode(cfg, model, inputs["frames"]).split(B // M)
    shared = [_on(model.shared, d) if cfg.family == "hybrid" else None
              for d in devs]
    positions = [torch.arange(S, device=d) for d in devs]
    buf = [None] * K                 # the activation waiting at each stage
    out = [None] * M
    for t in range(M + K - 1):
        # the last stage first, so each stage reads its input before the
        # stage behind it sends the next one
        for k in reversed(range(K)):
            m = t - k
            if not 0 <= m < M:
                continue
            h = xs[m] if k == 0 else buf[k]
            if cfg.family == "encdec":
                y = lm.decoder_train(cfg, model, h, encs[m].to(devs[k]),
                                     positions[k], ranges[k])
            else:
                y = lm.trunk_train(cfg, model, h, positions[k], ranges[k],
                                   shared[k])[0]
            if k < K - 1:
                buf[k + 1] = y.to(devs[k + 1])
            else:
                out[m] = y
    h = lm.final_hidden(cfg, model, torch.cat(out))
    table, head = _head(model, devs[-1])
    return chunked_cross_entropy(h, table, head,
                                 batch["targets"].to(devs[-1]), cfg.ce_chunk)


def make_pipeline_train_step(cfg, pcfg: PipelineConfig, opt: OptConfig,
                             mesh):
    """→ ``train_step(state, batch) -> (state, metrics)`` over the stages
    of ``mesh`` (the model placed by ``place_stages``): the loss is the
    CE alone, metrics ``{"loss", "ce", "grad_norm", "lr"}`` as device
    tensors, AdamW as ``runtime.steps``' plain step applies it."""
    if mesh.n_pods != pcfg.n_stages:
        raise ValueError(f"{mesh.n_pods} devices for {pcfg.n_stages} stages")

    def train_step(state: dict, batch: dict):
        model = state["model"]
        names, params = zip(*model.named_parameters())
        loss = pipeline_loss(cfg, pcfg, mesh, model, batch)
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
        opt_state, om = apply_gradients(dict(zip(names, params)),
                                        dict(zip(names, grads)),
                                        state["opt"], opt)
        loss = loss.detach()
        return ({"model": model, "opt": opt_state, "step": state["step"] + 1},
                {"loss": loss, "ce": loss, **om})

    return train_step


# --------------------------------------------------------------------------- #
# Pipelined serving steps (prefill / decode)
# --------------------------------------------------------------------------- #
@torch.no_grad()
def forward_prefill(cfg, pcfg: PipelineConfig, mesh, model: lm.LM,
                    inputs: dict, cache_len: int | None = None):
    """The request batch through the stages in turn, each filling its own
    cache → (last-token logits fp32 (B, 1, V), cache ``{"stages": [one
    cache a stage, on its device], "pos"}``)."""
    devs = mesh.devices
    _check_placed(cfg, model, pcfg, devs)
    x = lm.embed_inputs(cfg, model, inputs)
    S = x.shape[1]
    enc = None
    if cfg.family == "encdec":
        enc = lm.encode(cfg, model, inputs["frames"])
    stages = []
    for k, layers in enumerate(pcfg.ranges(cfg.n_layers)):
        x = x.to(devs[k])
        positions = torch.arange(S, device=devs[k])
        if enc is not None:
            x, c = lm.decoder_prefill(cfg, model, x, enc.to(devs[k]),
                                      positions, cache_len or S, layers)
        else:
            shared = _on(model.shared, devs[k]) \
                if cfg.family == "hybrid" else None
            x, c = lm.trunk_prefill(cfg, model, x, positions, cache_len or S,
                                    layers, shared)
        del c["pos"]
        stages.append(c)
    x = lm.final_hidden(cfg, model, x[:, -1:])
    return lm_logits(x, *_head(model, devs[-1])), {"stages": stages, "pos": S}


@torch.no_grad()
def forward_decode(cfg, pcfg: PipelineConfig, mesh, model: lm.LM,
                   token: torch.Tensor, cache: dict):
    """token: (B, 1) int → (logits fp32 (B, 1, V), cache): the token
    embeds on the first stage and flows through every stage, each
    writing its step into its own cache in place."""
    devs = mesh.devices
    _check_placed(cfg, model, pcfg, devs)
    pos = cache["pos"]
    x = embed_lookup(model.embed.table, token.to(devs[0]))
    for k, layers in enumerate(pcfg.ranges(cfg.n_layers)):
        x = x.to(devs[k])
        c = {**cache["stages"][k], "pos": pos}
        if cfg.family == "encdec":
            x, _ = lm.decoder_decode(cfg, model, x, c, layers)
        else:
            shared = _on(model.shared, devs[k]) \
                if cfg.family == "hybrid" else None
            x, _ = lm.trunk_decode(cfg, model, x, c, layers, shared)
    x = lm.final_hidden(cfg, model, x)
    return (lm_logits(x, *_head(model, devs[-1])),
            {"stages": cache["stages"], "pos": pos + 1})


def make_pipeline_prefill_step(cfg, pcfg: PipelineConfig, mesh,
                               cache_len: int | None = None):
    """→ ``prefill(model, inputs) -> (argmax tokens int32 (B, 1), cache)``."""
    def prefill(model, inputs):
        logits, cache = forward_prefill(cfg, pcfg, mesh, model, inputs,
                                        cache_len)
        return logits.argmax(dim=-1).to(torch.int32), cache
    return prefill


def make_pipeline_decode_step(cfg, pcfg: PipelineConfig, mesh):
    """→ ``decode(model, token, cache) -> (argmax tokens, cache)``."""
    def decode(model, token, cache):
        logits, cache = forward_decode(cfg, pcfg, mesh, model, token, cache)
        return logits.argmax(dim=-1).to(torch.int32), cache
    return decode


# --------------------------------------------------------------------------- #
# The reference's cache layout
# --------------------------------------------------------------------------- #
def n_attn_slots(cfg, l_max: int) -> int:
    """Shared-attention KV slots per pipeline stage in the reference's
    layout (slot-compressed: one per application site, not one per
    layer)."""
    return l_max // cfg.shared_attn_every + 2


def _empty_stage_cache(cfg, l_max, B, clen, dtype, device=None) -> dict:
    """One stage's zero cache in the reference's layout."""
    KVh, hd = cfg.n_kv_heads, cfg.hd

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)
    if cfg.family == "encdec":
        return {"k": z(l_max, B, clen, KVh, hd), "v": z(l_max, B, clen, KVh, hd),
                "ck": z(l_max, B, cfg.enc_frames, KVh, hd),
                "cv": z(l_max, B, cfg.enc_frames, KVh, hd)}
    if cfg.family in ("dense", "vlm", "moe"):
        return {"k": z(l_max, B, clen, KVh, hd), "v": z(l_max, B, clen, KVh, hd)}
    if cfg.family == "ssm":
        return {"conv": z(l_max, B, cfg.ssm_conv - 1, cfg.d_inner),
                "h": z(l_max, B, cfg.d_inner, cfg.ssm_state, dt=torch.float32)}
    if cfg.family == "hybrid":
        ns = n_attn_slots(cfg, l_max)
        return {"conv": z(l_max, B, cfg.ssm_conv - 1,
                          cfg.d_inner + 2 * cfg.ssm_state),
                "h": z(l_max, B, cfg.ssm_heads, cfg.ssm_head_dim,
                       cfg.ssm_state, dt=torch.float32),
                "ak": z(ns, B, clen, KVh, hd), "av": z(ns, B, clen, KVh, hd)}
    raise ValueError(cfg.family)


def reference_cache(cfg, pcfg: PipelineConfig, cache: dict) -> dict:
    """A pipelined cache in the reference's layout, on the host: each
    leaf (K, l_max, B, ...) with zero pad layers (the hybrid's ``ak``/
    ``av`` (K, n_attn_slots, ...)), and ``pos``."""
    _, _, l_max = pcfg.layout(cfg.n_layers)
    out = []
    for c in cache["stages"]:
        any_leaf = next(iter(c.values()))
        B = any_leaf.shape[1]
        clen = c["ak"].shape[2] if "ak" in c else \
            c["k"].shape[2] if "k" in c else 0
        full = _empty_stage_cache(cfg, l_max, B, clen, any_leaf.dtype)
        for key, t in c.items():
            full[key][:t.shape[0]] = t.cpu()
        out.append(full)
    tree = {k: torch.stack([s[k] for s in out]) for k in out[0]}
    return {**tree, "pos": cache["pos"]}
