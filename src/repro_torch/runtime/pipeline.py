"""Multi-pod pipeline parallelism, ParetoPipe's split scaled to pods
(counterpart of ``src/repro/runtime/pipeline.py``).

The partitioner (``models.blocks_adapter.choose_pipeline_cuts``) assigns
a contiguous layer range to each stage; cuts may be uneven, which is the
paper's point.  The reference runs the stages as one SPMD program: a
``shard_map`` manual over the mesh's ``pod`` axis, ``data`` and
``model`` sharded automatically inside each stage.  The port runs the
same schedule on either of two meshes (``launch.mesh``):

* one process (``PodMesh``): stage ``k``'s layers live on
  ``mesh.devices[k]`` (``place_stages``), and an activation crosses to
  the next stage as ``y.to(devices[k + 1])``, which autograd
  differentiates.  On one card every stage shares it.
* the ranks' ``(pod, data, model)`` mesh (``pod_mesh``): each rank keeps
  only its pod's stage, its parameters DTensors on the pod's ``(data,
  model)`` sub-mesh (``common.param_placements``), so every ``shard``
  point inside the families works as under the ``(data, model)`` mesh.
  An activation's local shard crosses to the rank at the same ``(data,
  model)`` point of the next pod (``dist.batch_isend_irecv``), which
  wraps it in the same placements on its own sub-mesh.  The parts the
  reference keeps on every pod (the embedding and its tied table, the
  final norm and the head, the hybrid's shared block, the enc-dec
  encoder) are on every rank, and their gradients are summed over the
  pods in fp32, as the reference psums their cotangents.

Inside a stage the port calls the unpipelined trunk over the stage's
layer range (``lm.trunk_train``/``trunk_prefill``/``trunk_decode`` and
the decoder's), so a pipelined serve runs the same kernels on the same
tensors in the same order as the unpipelined one: in one process its
tokens and logits are equal to it bit for bit.  The reference pads
every stage to the deepest (``l_max``) and computes its pad layers only
to discard them (``where(li < count, y, x)``); the port does not run
them, which gives the same result.  Its caches hold only a stage's own
layers (and the hybrid's applications, at the reference's slot index);
``reference_cache`` pads them to the reference's (K, l_max, ...) layout.

Train (K stages, M microbatches, the reference's GPipe schedule): stage
``k`` runs microbatch ``m`` after stage ``k - 1`` has.  The embedding
(and the enc-dec family's encoder) runs on stage 0; the final norm and
the chunked CE over the whole batch on the last stage.  The loss is the
CE alone: the moe family's load-balance term is dropped, as the
reference drops it.  In one process autograd crosses the stages back;
on several cards the host issues a tick's stages one after another and
each card runs its own, so their work overlaps.  On the ranks the
backward is explicit, so that every neighbouring pair of ranks runs its
sends and receives in one order (NCCL's point-to-point calls block
otherwise): the last stage backpropagates its CE once and sends the
gradients of its M inputs back, last microbatch first; every other
stage receives them in that order, backpropagates that microbatch
through itself and sends its own input's gradient on.  The enc-dec
family's encoder runs once a microbatch on pod 0; its output is
broadcast over the pods in fp32 and each stage's gradient of it summed
back there.  The step's loss is broadcast from the last pod, and the
gradient norm sums each stage's leaves once and each pod-replicated
leaf once, so every rank clips by the same factor.

Parameters stay the port's (an ``LM``, one module a layer); the
reference's pipelined tree stacks a stage's layers as (K, l_max, ...),
zero-padded: ``repack_params``/``unpack_params`` convert the stacked
layouts, and ``runtime.steps.reference_state`` writes a pipelined state
in it (on the ranks, gathered to rank 0: ``gather_pods``).
"""
from __future__ import annotations

import contextlib
import math
import types
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.tensor as dtensor
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..launch.mesh import (is_pod_mesh, pod_index, pod_neighbours, pod_rank,
                           stage_mesh)
from ..models import lm
from ..models.common import (Leaves, abstract_params, chunked_cross_entropy,
                             embed_lookup, lm_logits, named_leaves)
from ..optim import OptConfig, apply_gradients
from ..sharding.api import (MeshContext, full, greedy_tokens, local,
                            replica_rank, split_batch, to_placements,
                            use_mesh_context)


# --------------------------------------------------------------------------- #
# Stage layout / param repacking
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class PipelineConfig:
    n_stages: int
    microbatches: int
    cuts: tuple[int, ...]            # interior layer cuts, len = n_stages-1
    # the ParetoPipe pick that chose the cuts (``launch.mesh.
    # plan_pipeline``), None for cuts given; not part of the layout
    plan: object = field(default=None, compare=False, repr=False)

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
    On the ranks' pod mesh: keeps this rank's pod's stage alone (the
    other layers' weights dropped) and every pod-replicated part, each
    parameter a DTensor on the pod's sub-mesh.  Make a training state
    after this (on the ranks under ``stage_context``), so its moments
    sit beside their parameters."""
    if is_pod_mesh(mesh):
        return _place_on_ranks(cfg, model, pcfg, mesh)
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
    tensors, AdamW as ``runtime.steps``' plain step applies it.  On the
    ranks' pod mesh each rank steps its own stage's parameters and the
    pod-replicated ones, ZeRO-1 over ``data`` inside its pod (the state
    made under ``stage_context``), the batch given whole on every rank;
    the metrics come back whole on every rank."""
    if is_pod_mesh(mesh):
        return _rank_train_step(cfg, pcfg, opt, mesh)
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
                               cache_len: int | None = None,
                               with_logits: bool = False):
    """→ ``prefill(model, inputs) -> (argmax tokens int32 (B, 1), cache)``,
    and the fp32 (B, 1, V) logits too with ``with_logits``.  On the
    ranks' pod mesh the inputs are whole on every rank, each rank's
    cache holds its stage's layers (``{"stage", "pos"}``, laid out by
    ``lm.cache_names`` on its sub-mesh), and the tokens (and logits) come
    back whole on every rank."""
    def prefill(model, inputs):
        if is_pod_mesh(mesh):
            tok, cache, logits = _rank_prefill(cfg, pcfg, mesh, model,
                                               inputs, cache_len, with_logits)
        else:
            logits, cache = forward_prefill(cfg, pcfg, mesh, model, inputs,
                                            cache_len)
            tok = logits.argmax(dim=-1).to(torch.int32)
        return (tok, cache, logits) if with_logits else (tok, cache)
    return prefill


def make_pipeline_decode_step(cfg, pcfg: PipelineConfig, mesh,
                              with_logits: bool = False):
    """→ ``decode(model, token, cache) -> (argmax tokens, cache)`` (and
    the logits with ``with_logits``), on the ranks as the prefill's."""
    def decode(model, token, cache):
        if is_pod_mesh(mesh):
            tok, cache, logits = _rank_decode(cfg, pcfg, mesh, model, token,
                                              cache, with_logits)
        else:
            logits, cache = forward_decode(cfg, pcfg, mesh, model, token,
                                           cache)
            tok = logits.argmax(dim=-1).to(torch.int32)
        return (tok, cache, logits) if with_logits else (tok, cache)
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


def reference_cache(cfg, pcfg: PipelineConfig, cache: dict, mesh=None,
                    keep: bool = True) -> dict | None:
    """A pipelined cache in the reference's layout, on the host: each
    leaf (K, l_max, B, ...) with zero pad layers (the hybrid's ``ak``/
    ``av`` (K, n_attn_slots, ...)), and ``pos``.  A rank's cache on the
    pod ``mesh`` (``{"stage", "pos"}``): every rank gathers, and rank 0,
    which ``keep``s it, gets the tree (the others None)."""
    _, _, l_max = pcfg.layout(cfg.n_layers)
    stages = cache.get("stages")
    if stages is None:
        k, keys = pod_index(mesh), sorted(cache["stage"])
        got = gather_pods(mesh, {(k, key): cache["stage"][key]
                                 for key in keys},
                          {(j, key): j for j in range(pcfg.n_stages)
                           for key in keys}, keep)
        if not keep:
            return None
        stages = [{key: got[j, key] for key in keys}
                  for j in range(pcfg.n_stages)]
    out = []
    for c in stages:
        any_leaf = next(iter(c.values()))
        B = any_leaf.shape[1]
        clen = c["ak"].shape[2] if "ak" in c else \
            c["k"].shape[2] if "k" in c else 0
        full_c = _empty_stage_cache(cfg, l_max, B, clen, any_leaf.dtype)
        for key, t in c.items():
            full_c[key][:t.shape[0]] = t.cpu()
        out.append(full_c)
    tree = {k: torch.stack([s[k] for s in out]) for k in out[0]}
    return {**tree, "pos": cache["pos"]}


# --------------------------------------------------------------------------- #
# The ranks' pod mesh: one stage a pod
# --------------------------------------------------------------------------- #
# the parts every pod holds (the reference's pod-replicated inputs of its
# shard_map); their gradients are summed over the pods in fp32
POD_REPLICATED = ("embed", "final_norm", "lm_head", "shared", "enc_layers",
                  "enc_final_norm")


def pod_replicated(name: str) -> bool:
    """Whether parameter ``name`` is one that every pod holds."""
    return name.partition(".")[0] in POD_REPLICATED


def stage_context(mesh):
    """The mesh a pipelined state's tensors live on: a pod mesh's
    ``(data, model)`` sub-mesh; None for one process."""
    return stage_mesh(mesh) if is_pod_mesh(mesh) else None


def _place_on_ranks(cfg, model: lm.LM, pcfg: PipelineConfig, mesh):
    if mesh.size(0) != pcfg.n_stages:
        raise ValueError(f"{mesh.size(0)} pods for {pcfg.n_stages} stages")
    own = pcfg.ranges(cfg.n_layers)[pod_index(mesh)]
    stack = _stack(cfg, model)
    for i in range(cfg.n_layers):
        if i not in own:
            stack[i] = Leaves({})
    with use_mesh_context(stage_mesh(mesh)) as ctx:
        lm.shard_params(cfg, model, ctx)
    model.pod_mesh = mesh
    return model


@contextlib.contextmanager
def _rank_scope(mesh):
    """The stage's sub-mesh as the mesh context, plain tensors taken as
    replicated on it → (sub-mesh, its MeshContext)."""
    sub = stage_mesh(mesh)
    with use_mesh_context(sub) as ctx, implicit_replication():
        yield sub, ctx


def _checked(model: lm.LM, mesh) -> None:
    if model.pod_mesh is not mesh:
        raise RuntimeError("the model is not placed on this pod mesh: "
                           "place_stages first")


def _p2p(op, t: torch.Tensor, peer: int, group) -> None:
    for work in dist.batch_isend_irecv([dist.P2POp(op, t, peer, group)]):
        work.wait()


def _hop_names(cfg, train: bool) -> tuple[str, ...]:
    """The logical axes an activation crosses between stages in: the
    layer-boundary residual's in training (``lm._shard_residual``)."""
    return ("batch", "seq_sp" if train and cfg.seq_parallel else "seq",
            "embed")


def _send(x: DTensor, names, peer: int, group) -> DTensor:
    """``x``'s local shard, laid out by ``names``, to ``peer`` → ``x`` in
    that layout (what the gradient that comes back is of)."""
    x = to_placements(x, MeshContext(x.device_mesh).placements(
        names, tuple(x.shape)))
    _p2p(dist.isend, local(x).contiguous(), peer, group)
    return x


def _recv(shape, dtype, names, sub, peer: int, group,
          grad: bool = False) -> tuple[DTensor, torch.Tensor]:
    """The local shard of a ``shape`` tensor laid out by ``names`` on
    ``sub``, from ``peer`` → (it as a DTensor on ``sub``, the local
    tensor: with ``grad`` a leaf whose gradient is the one to send
    back)."""
    pl = MeshContext(sub).placements(names, tuple(shape))
    buf = dtensor.empty(*shape, dtype=dtype, device_mesh=sub,
                        placements=pl).to_local()
    _p2p(dist.irecv, buf, peer, group)
    buf.requires_grad_(grad)
    return DTensor.from_local(buf, sub, pl, run_check=False), buf


def _rows(ts) -> DTensor:
    """DTensors split alike, their local shards laid end to end along dim
    0: the microbatches' rows as one batch (the rows of each rank in
    microbatch order, which a mean over rows does not see)."""
    return DTensor.from_local(torch.cat([local(t) for t in ts]),
                              ts[0].device_mesh, ts[0].placements,
                              run_check=False)


def _broadcast(t: torch.Tensor, mesh, src_pod: int) -> torch.Tensor:
    """``t`` of pod ``src_pod`` to the same ``(data, model)`` point of
    every pod, in place → t."""
    dist.broadcast(t, pod_rank(mesh, src_pod), group=mesh.get_group("pod"))
    return t


def _encodings(cfg, model: lm.LM, mesh, frames: list, grad: bool):
    """The enc-dec encoder's output of each microbatch's ``frames``:
    computed on pod 0, broadcast over the pods in fp32 (the reference's
    boundary dtype) → (each as a DTensor in the model's dtype, the fp32
    local leaves every stage's gradient is of, pod 0's outputs)."""
    k, sub = pod_index(mesh), stage_mesh(mesh)
    dtype = model.embed.table.dtype
    names = ("batch", "frames", "embed")
    encs, leaves, outs = [], [], []
    for f in frames:
        shape = (f.shape[0], cfg.enc_frames, cfg.d_model)
        pl = MeshContext(sub).placements(names, shape)
        if k == 0:
            e = to_placements(lm.encode(cfg, model, f), pl)
            buf = local(e).detach().to(torch.float32).contiguous()
            outs.append(e)
        else:
            buf = dtensor.empty(*shape, dtype=torch.float32, device_mesh=sub,
                                placements=pl).to_local()
        _broadcast(buf, mesh, 0)
        buf.requires_grad_(grad)
        leaves.append(buf)
        encs.append(DTensor.from_local(buf.to(dtype), sub, pl,
                                       run_check=False))
    return encs, leaves, outs


def _stage_train(cfg, model, h, enc, positions, layers):
    if cfg.family == "encdec":
        return lm.decoder_train(cfg, model, h, enc, positions, layers)
    return lm.trunk_train(cfg, model, h, positions, layers)[0]


def _rank_grads(cfg, pcfg: PipelineConfig, mesh, model: lm.LM, batch: dict,
                z1: dict):
    """This rank's stage of the GPipe step (the module's docstring) → (the
    CE, whole on every rank; {name: gradient} of its parameters, fp32 in
    their ZeRO-1 placements ``z1``, the pod-replicated ones summed over
    the pods)."""
    K, M = pcfg.n_stages, pcfg.microbatches
    k = pod_index(mesh)
    prev, nxt = pod_neighbours(mesh)
    group = mesh.get_group("pod")
    layers = pcfg.ranges(cfg.n_layers)[k]
    B = batch["targets"].shape[0]
    if B % M:
        raise ValueError(f"batch {B} % microbatches {M}")
    mb = B // M
    names, params = zip(*model.named_parameters())
    P = len(params)
    dtype = model.embed.table.dtype
    hop = _hop_names(cfg, True)
    with _rank_scope(mesh) as (sub, ctx):
        mbs = [split_batch(ctx, {n: v[i * mb:(i + 1) * mb]
                                 for n, v in batch.items()})
               for i in range(M)]
        S = mbs[0]["tokens"].shape[1] + (cfg.n_patches
                                         if cfg.family == "vlm" else 0)
        shape = (mb, S, cfg.d_model)
        positions = torch.arange(S, device=params[0].device)
        encs, enc_leaves, enc_outs = ([None] * M, [], [])
        if cfg.family == "encdec":
            encs, enc_leaves, enc_outs = _encodings(
                cfg, model, mesh, [b["frames"] for b in mbs], True)
        ins, outs = [], []
        for m in range(M):
            if k == 0:
                h = lm.embed_inputs(cfg, model, {
                    n: v for n, v in mbs[m].items() if n != "targets"})
            else:
                h, leaf = _recv(shape, dtype, hop, sub, prev, group, True)
                ins.append(leaf)
            y = _stage_train(cfg, model, h, encs[m], positions, layers)
            outs.append(y if nxt is None else _send(y, hop, nxt, group))

        def z1_of(g):
            return [to_placements(t, z1[n]).to(torch.float32)
                    for n, t in zip(names, g[:P])]
        if nxt is None:
            # the last stage: the CE over the whole batch, one backward
            h = lm.final_hidden(cfg, model, _rows(outs))
            head = model.lm_head.w if model.lm_head is not None else None
            ce = chunked_cross_entropy(h, model.embed.table, head,
                                       _rows([b["targets"] for b in mbs]),
                                       cfg.ce_chunk)
            g = torch.autograd.grad(ce, [*params, *ins, *enc_leaves],
                                    materialize_grads=True)
            grads = z1_of(g)
            for m in reversed(range(len(ins))):
                _p2p(dist.isend, g[P + m].contiguous(), prev, group)
            enc_g = list(g[P + len(ins):])
            loss = full(ce.detach()).to(torch.float32).reshape(())
        else:
            grads, enc_g = None, [None] * len(enc_leaves)
            for m in reversed(range(M)):
                gy, _ = _recv(shape, dtype, hop, sub, nxt, group)
                wrt = [*params, *ins[m:m + 1], *enc_leaves[m:m + 1]]
                g = torch.autograd.grad(outs[m], wrt, grad_outputs=gy,
                                        materialize_grads=True)
                gm = z1_of(g)
                grads = gm if grads is None else \
                    [a + b for a, b in zip(grads, gm)]
                if prev is not None:
                    _p2p(dist.isend, g[P].contiguous(), prev, group)
                if enc_leaves:
                    enc_g[m] = g[-1]
            loss = torch.zeros((), dtype=torch.float32,
                               device=params[0].device)
        grads = dict(zip(names, grads))
        if enc_leaves:
            _encoder_backward(model, mesh, enc_outs, enc_g, grads, z1)
        for n, g in grads.items():
            if pod_replicated(n) and K > 1:
                t = local(g).contiguous()
                dist.all_reduce(t, group=group)
                grads[n] = DTensor.from_local(t, g.device_mesh, g.placements,
                                              run_check=False)
    return _broadcast(loss.contiguous(), mesh, K - 1), grads


def _encoder_backward(model, mesh, outs, enc_g, grads, z1) -> None:
    """Every stage's gradient of the encoder's outputs summed on pod 0 in
    fp32, and pod 0's backward through the encoder into ``grads``."""
    for g in enc_g:
        dist.all_reduce(g, group=mesh.get_group("pod"))
    if pod_index(mesh) != 0:
        return
    enc = {n: p for n, p in model.named_parameters()
           if n.partition(".")[0] in ("enc_layers", "enc_final_norm")}
    ge = torch.autograd.grad(
        outs, list(enc.values()),
        grad_outputs=[DTensor.from_local(g.to(e.dtype), e.device_mesh,
                                         e.placements, run_check=False)
                      for e, g in zip(outs, enc_g)],
        materialize_grads=True)
    for n, g in zip(enc, ge):
        grads[n] = grads[n] + to_placements(g, z1[n]).to(torch.float32)


def _pod_norm(grads: dict, mesh) -> torch.Tensor:
    """The global norm of the whole model's gradient: each rank's local
    squares, a sub-mesh-replicated shard counted on one rank of the pod
    and a pod-replicated leaf on pod 0 alone, summed over every rank."""
    first = pod_index(mesh) == 0
    dev = next(iter(grads.values())).device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for n, g in grads.items():
        if replica_rank(g) and (first or not pod_replicated(n)):
            total = total + torch.sum(torch.square(local(g)))
    dist.all_reduce(total)
    return torch.sqrt(total)


def _rank_train_step(cfg, pcfg: PipelineConfig, opt: OptConfig, mesh):
    from .steps import zero1_placements
    z1 = zero1_placements(cfg, MeshContext(stage_mesh(mesh)))

    def train_step(state: dict, batch: dict):
        model = state["model"]
        _checked(model, mesh)
        loss, grads = _rank_grads(cfg, pcfg, mesh, model, batch, z1)
        opt_state, om = apply_gradients(dict(model.named_parameters()),
                                        grads, state["opt"], opt,
                                        gnorm=_pod_norm(grads, mesh))
        return ({"model": model, "opt": opt_state, "step": state["step"] + 1},
                {"loss": loss, "ce": loss, **om})

    return train_step


def _emit(cfg, model: lm.LM, mesh, x, B: int, with_logits: bool):
    """The last stage's greedy tokens (and fp32 logits) of its hidden
    states ``x`` (B, 1, D), sent from every other stage on to the next,
    broadcast over the pods → (tokens (B, 1) int32, logits (B, 1, V) or
    None), whole on every rank."""
    K = mesh.size(0)
    nxt = pod_neighbours(mesh)[1]
    dev = model.embed.table.device
    logits = None
    if nxt is None:
        head = model.lm_head.w if model.lm_head is not None else None
        lg = lm_logits(lm.final_hidden(cfg, model, x), model.embed.table,
                       head)
        tok = full(greedy_tokens(lg)).contiguous()
        if with_logits:
            logits = full(lg).contiguous()
    else:
        _send(x, _hop_names(cfg, False), nxt, mesh.get_group("pod"))
        tok = torch.empty((B, 1), dtype=torch.int32, device=dev)
        if with_logits:
            logits = torch.empty((B, 1, cfg.vocab), dtype=torch.float32,
                                 device=dev)
    _broadcast(tok, mesh, K - 1)
    if with_logits:
        _broadcast(logits, mesh, K - 1)
    return tok, logits


def _stage_input(cfg, model, mesh, shape, sub, embed):
    """Stage 0's embedding (``embed()``), or the activation the stage
    before sent."""
    if pod_index(mesh) == 0:
        return embed()
    return _recv(shape, model.embed.table.dtype, _hop_names(cfg, False), sub,
                 pod_neighbours(mesh)[0], mesh.get_group("pod"))[0]


@torch.no_grad()
def _rank_prefill(cfg, pcfg: PipelineConfig, mesh, model: lm.LM,
                  inputs: dict, cache_len: int | None, with_logits: bool):
    _checked(model, mesh)
    layers = pcfg.ranges(cfg.n_layers)[pod_index(mesh)]
    with _rank_scope(mesh) as (sub, ctx):
        inputs = split_batch(ctx, inputs)
        B = inputs["tokens"].shape[0]
        S = inputs["tokens"].shape[1] + (cfg.n_patches
                                         if cfg.family == "vlm" else 0)
        # every pod takes the encoder's output before any hop: pod 0
        # broadcasts it before it sends its stage's output on
        enc = _encodings(cfg, model, mesh, [inputs["frames"]], False)[0] \
            if cfg.family == "encdec" else None
        x = _stage_input(cfg, model, mesh, (B, S, cfg.d_model), sub,
                         lambda: lm.embed_inputs(cfg, model, inputs))
        positions = torch.arange(S, device=model.embed.table.device)
        if enc is not None:
            x, c = lm.decoder_prefill(cfg, model, x, enc[0], positions,
                                      cache_len or S, layers)
        else:
            x, c = lm.trunk_prefill(cfg, model, x, positions, cache_len or S,
                                    layers)
        del c["pos"]
        x = x[:, -1:] if pod_neighbours(mesh)[1] is None else x
        tok, logits = _emit(cfg, model, mesh, x, B, with_logits)
    return tok, {"stage": c, "pos": S}, logits


@torch.no_grad()
def _rank_decode(cfg, pcfg: PipelineConfig, mesh, model: lm.LM,
                 token: torch.Tensor, cache: dict, with_logits: bool):
    _checked(model, mesh)
    layers = pcfg.ranges(cfg.n_layers)[pod_index(mesh)]
    pos = cache["pos"]
    with _rank_scope(mesh) as (sub, ctx):
        B = token.shape[0]
        x = _stage_input(cfg, model, mesh, (B, 1, cfg.d_model), sub,
                         lambda: embed_lookup(model.embed.table, split_batch(
                             ctx, {"t": token})["t"]))
        c = {**cache["stage"], "pos": pos}
        if cfg.family == "encdec":
            x, _ = lm.decoder_decode(cfg, model, x, c, layers)
        else:
            x, _ = lm.trunk_decode(cfg, model, x, c, layers)
        tok, logits = _emit(cfg, model, mesh, x, B, with_logits)
    return tok, {"stage": cache["stage"], "pos": pos + 1}, logits


# --------------------------------------------------------------------------- #
# Gathering a pod mesh's stages
# --------------------------------------------------------------------------- #
_WIRE_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32,
                torch.int64)


def _send_whole(t: torch.Tensor, dst: int) -> None:
    """``t`` to rank ``dst``, its dtype and shape first."""
    head = torch.zeros(8, dtype=torch.int64, device=t.device)
    head[0], head[1] = _WIRE_DTYPES.index(t.dtype), t.ndim
    head[2:2 + t.ndim] = torch.tensor(t.shape, dtype=torch.int64)
    dist.send(head, dst)
    dist.send(t.contiguous(), dst)


def _recv_whole(src: int, device) -> torch.Tensor:
    head = torch.empty(8, dtype=torch.int64, device=device)
    dist.recv(head, src)
    dt, nd, *shape = head.tolist()
    t = torch.empty(shape[:nd], dtype=_WIRE_DTYPES[dt], device=device)
    dist.recv(t, src)
    return t


def gather_pods(mesh, mine: dict, owners: dict, keep: bool) -> dict:
    """Tensors held by pods, whole on the host of rank 0: ``owners`` maps
    every key to the pod that holds it, in one order on every rank;
    ``mine`` holds this rank's pod's (DTensors on its sub-mesh).  Each is
    gathered whole on its pod (a collective of the pod's ranks) and sent
    to rank 0 by the pod's first rank → {key: host tensor} on rank 0,
    which ``keep``s them; {} on the others."""
    if keep != (dist.get_rank() == 0):
        raise ValueError("rank 0, and it alone, keeps a pod mesh's tree")
    k = pod_index(mesh)
    first = [int(mesh.mesh[j].flatten()[0]) for j in range(mesh.size(0))]
    dev = next(iter(mine.values())).device if mine else torch.device("cpu")
    out = {}
    for key, j in owners.items():
        if j == k:
            t = full(mine[key].detach())
            if keep:
                out[key] = t.cpu()
            elif dist.get_rank() == first[j] and j != 0:
                _send_whole(t, 0)
        elif keep:
            out[key] = _recv_whole(first[j], dev).cpu()
    return out


def gather_named(cfg, pcfg: PipelineConfig, mesh, named: dict,
                 keep: bool) -> dict:
    """A pod mesh's tensors keyed by the whole model's parameter names
    (its parameters, or a moment of each; ``named`` this rank's own) →
    every one, whole on rank 0's host (``gather_pods``): each layer's
    from its stage, the pod-replicated ones from pod 0."""
    stage_of = {i: j for j, r in enumerate(pcfg.ranges(cfg.n_layers))
                for i in r}
    owners = {}
    for n, _ in named_leaves(abstract_params(cfg, None)):
        top, _, rest = n.partition(".")
        owners[n] = 0 if pod_replicated(n) else \
            stage_of[int(rest.partition(".")[0])]
    return gather_pods(mesh, named, owners, keep)
