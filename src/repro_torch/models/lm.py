"""LM, served and trained: the dense, vlm, moe, ssm (Mamba-1), hybrid
(Mamba-2 with a shared attention block) and encdec (whisper) families
(counterpart of ``src/repro/models/lm.py``).

The reference stacks per-layer params on a leading ``layers`` axis and
scans over it; here the layers are an ``nn.ModuleList`` walked by a
Python loop, each block a ``Leaves`` node with the reference's keys and
leaf shapes, so ``from_reference`` only unstacks that axis (of
``layers``, or of ``enc_layers`` and ``dec_layers``).  The hybrid's
``shared`` block has no layer axis: one ``Leaves`` node, applied before
every ``shared_attn_every``-th layer.

Caches (serving), zero past the prompt where they have a ``cache_len``
axis:
  dense/vlm/moe : {"k", "v": (L, B, cache_len, KV, hd), "pos"}
  ssm           : {"conv": (L, B, K-1, di), "h": (L, B, di, N) fp32,
                   "pos"}; ``cache_len`` unused, as in the reference
  hybrid        : {"conv": (L, B, K-1, di+2N), "h": (L, B, H, P, N) fp32,
                   "ak", "av": (n_attn_apps, B, cache_len, KV, hd), "pos"}
  encdec        : {"k", "v": (L, B, cache_len, KV, hd), "ck", "cv": (L, B,
                   F, KV, hd) (cross-attention, computed once at
                   prefill), "pos"}
``pos`` stays a Python int on the host, so no decode step waits on the
device to read it.
Decode writes the new k/v rows, or the new conv window and state, into
the cache tensors in place (the reference returns updated copies): the
cache passed to ``forward_decode`` is the one it returns, with ``pos``
advanced.

``cfg.attn_impl`` picks the kernels: ``"pallas"`` runs attention, the
selective scan and every RMSNorm through ``kernels.ops``, ``"xla"``
through the plain copies of the reference's routes.  Layer norms (the
encdec family's) and Mamba-2's SSD are plain on both routes: the
reference has no kernel for either.  A moe block's MLP is
``mlp.moe_mlp`` (``cfg.moe_impl="sort"``) or ``mlp.moe_mlp_gshard``
(``"gshard"``) on either route; serving discards its load-balance term,
as the reference's prefill and decode do.

Training (``forward_train``, ``trunk_train``, ``decoder_train``) needs
``cfg.attn_impl="xla"``, the plain route, which is all the reference's
``value_and_grad`` ever differentiates: the kernels have no backward,
so under ``"pallas"`` ``kernels.ops`` raises where autograd would
record one (``launch.train`` sets ``"xla"``).  Under ``cfg.remat`` (and only while autograd records) each
layer's body goes through ``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` of its scan body.  ``to_reference`` gives the
reference's stacked tree back, for checkpoints and tests.

The trunks (``trunk_prefill``, ``trunk_decode``, ``trunk_train`` and the
decoder's) take a ``layers`` range, the whole stack by default: a
pipeline stage (``runtime.pipeline``) runs its own range through the
same per-layer functions, its caches holding only its layers (the
hybrid's ``ak``/``av`` its applications, at slot ``i // every - start //
every``, the reference's), and passes the hybrid's ``shared`` block as it
lives on the stage's device.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn
from torch.distributed.tensor import distribute_tensor

from .attention import (attend_decode, attend_prefill, attn_params,
                        cache_update, o_project, qkv_project, write_rows)
from .cnn.zoo import resolve_device
from .common import (DTYPES, Init, Leaves, embed_lookup, from_host,
                     host_array, layer_norm, lm_logits, norm,
                     param_placements)
from ..sharding.api import (full, in_context, is_dtensor, kv_cache_names,
                            new_like, put, select, shard)
from .mlp import mlp, mlp_params, moe_mlp, moe_mlp_gshard, moe_params
from .ssm import mamba1_block, mamba1_params, mamba2_block, mamba2_params

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")
# the stacked trees of the reference, each with its depth
STACKS = {"layers": "n_layers", "enc_layers": "n_enc_layers",
          "dec_layers": "n_layers"}


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: unknown family {cfg.family!r} (the port serves "
            f"the {', '.join(FAMILIES)} families)")


# --------------------------------------------------------------------------- #
# Parameters
# --------------------------------------------------------------------------- #
def _norm_params(leaf, d: int, bias: bool = False) -> dict:
    p = {"scale": leaf((d,), "ones", axes=("embed",))}
    if bias:
        p["bias"] = leaf((d,), "zeros", axes=("embed",))
    return p


def _attn_block_params(cfg, leaf, bias_norm: bool = False) -> dict:
    """The reference's ``_attn_block_params``: pre-norms (with a bias for
    the encdec family's layer norms), attention and a dense MLP."""
    return {"ln1": _norm_params(leaf, cfg.d_model, bias_norm),
            "attn": attn_params(cfg, leaf),
            "ln2": _norm_params(leaf, cfg.d_model, bias_norm),
            "mlp": mlp_params(cfg, leaf)}


def layer_params(cfg, leaf) -> dict:
    """One block: the reference's ``_attn_block_params`` (dense/vlm), its
    moe layer (the same with a routed MLP) or its ssm / hybrid layer (a
    norm and a Mamba-1 / Mamba-2 mixer)."""
    if cfg.family in ("ssm", "hybrid"):
        mixer = mamba1_params if cfg.family == "ssm" else mamba2_params
        return {"ln": _norm_params(leaf, cfg.d_model),
                "mamba": mixer(cfg, leaf)}
    if cfg.family == "moe":
        return {"ln1": _norm_params(leaf, cfg.d_model),
                "attn": attn_params(cfg, leaf),
                "ln2": _norm_params(leaf, cfg.d_model),
                "moe": moe_params(cfg, leaf)}
    return _attn_block_params(cfg, leaf)


def build_params(cfg, leaf) -> dict:
    """The reference's ``build_params`` tree, with each stacked tree
    (``layers``; ``enc_layers`` and ``dec_layers`` for encdec) a list of
    per-layer trees instead of one stacked tree."""
    _check_family(cfg)
    encdec = cfg.family == "encdec"
    tree: dict = {"embed": {"table": leaf((cfg.vocab, cfg.d_model),
                                          scale=0.02,
                                          axes=("vocab", "embed"))}}
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": leaf((cfg.d_model, cfg.vocab),
                                     axes=("embed", "vocab"))}
    tree["final_norm"] = _norm_params(leaf, cfg.d_model, encdec)
    if encdec:
        tree["enc_layers"] = [_attn_block_params(cfg, leaf, True)
                              for _ in range(cfg.n_enc_layers)]
        tree["dec_layers"] = [
            {**_attn_block_params(cfg, leaf, True),
             "ln_x": _norm_params(leaf, cfg.d_model, True),
             "xattn": attn_params(cfg, leaf)}
            for _ in range(cfg.n_layers)]
        tree["enc_final_norm"] = _norm_params(leaf, cfg.d_model, True)
        return tree
    tree["layers"] = [layer_params(cfg, leaf) for _ in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        tree["shared"] = _attn_block_params(cfg, leaf)
    return tree


class LM(nn.Module):
    """Embedding, blocks, final norm and the optional untied head, as
    frozen parameters (plus the hybrid's ``shared`` block, or the encdec
    family's ``enc_layers``, ``dec_layers`` and ``enc_final_norm``); the
    forward functions below run it."""

    def __init__(self, cfg, tree: dict):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.embed = Leaves(tree["embed"])
        for name, depth in STACKS.items():
            if name not in tree:
                continue
            n = getattr(cfg, depth)
            if len(tree[name]) != n:
                raise ValueError(f"{len(tree[name])} {name} for "
                                 f"{cfg.name}'s {n}")
            setattr(self, name, nn.ModuleList(Leaves(p) for p in tree[name]))
        self.final_norm = Leaves(tree["final_norm"])
        for name in ("lm_head", "shared", "enc_final_norm"):
            setattr(self, name, Leaves(tree[name]) if name in tree else None)
        # the ranks' pod mesh, once ``runtime.pipeline.place_stages`` has
        # kept one stage of it here
        self.pod_mesh = None

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())


def init(cfg, generator: torch.Generator, device=None) -> LM:
    """Random weights drawn from ``generator`` (which must live on the
    target device) with the reference's shapes and scales, in
    ``cfg.dtype``, on ``device`` (``cuda`` unless the caller names
    another)."""
    dev = resolve_device(device)
    return LM(cfg, build_params(cfg, Init(generator, DTYPES[cfg.dtype], dev)))


def shard_params(cfg, model: LM, ctx) -> LM:
    """``model`` with every parameter replaced, in place, by its DTensor
    on ``ctx``'s mesh in ``common.param_placements``: each rank keeps its
    shard of the whole tensor it holds, with no communication (every
    rank drew, or loaded, the same weights)."""
    placements = param_placements(cfg, ctx)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        model.get_submodule(owner).register_parameter(leaf, nn.Parameter(
            distribute_tensor(p.detach(), ctx.mesh, placements[name],
                              src_data_rank=None),
            requires_grad=p.requires_grad))
    return model


def from_reference(cfg, params_np: dict, device=None) -> LM:
    """The reference's params (``jax.tree.map(np.asarray, params)``, or
    ``to_reference``'s tree, or a checkpoint's tensors) as a port ``LM``
    on ``device``: each stacked tree's layer axis is split into
    per-block nodes (a moe block's expert stacks included); the
    hybrid's ``shared`` block, which has none, converts whole.  Every
    leaf keeps its shape and dtype (a moe router stays fp32 in a bf16
    tree); a bf16 leaf may arrive as numpy's ``bfloat16`` extension type
    or as its bits in a ``|V2`` array (``common.from_host``)."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return from_host(node, dev)

    def layer(node, i):
        if isinstance(node, dict):
            return {k: layer(v, i) for k, v in node.items()}
        return from_host(node[i], dev)

    tree = {k: convert(v) for k, v in params_np.items() if k not in STACKS}
    for name, depth in STACKS.items():
        if name in params_np:
            tree[name] = [layer(params_np[name], i)
                          for i in range(getattr(cfg, depth))]
    # register the leaves in ``build_params``' order, as ``init`` does, so
    # that a restored model lists its parameters as a fresh one does
    return LM(cfg, _in_order(tree, build_params(cfg, lambda *a, **k: None)))


def _in_order(tree, template):
    if isinstance(template, dict):
        if set(tree) != set(template):
            raise ValueError(f"parameter keys {sorted(tree)} are not the "
                             f"model's {sorted(template)}")
        return {k: _in_order(tree[k], v) for k, v in template.items()}
    if isinstance(template, list):
        return [_in_order(t, v) for t, v in zip(tree, template)]
    return tree


def to_reference(model: LM) -> dict:
    """The inverse of ``from_reference``: the model's parameters as the
    reference's tree of host numpy arrays (bf16 as ``|V2`` bits), each
    stacked tree's blocks stacked back on its leading layer axis."""
    return reference_tree(dict(model.named_parameters()))


def reference_tree(named: dict, keep: bool = True) -> dict | None:
    """Tensors keyed by the port's parameter names (``layers.3.attn.wq``;
    the model's own, or an optimizer moment of each) → the reference's
    nested tree of host arrays, the blocks of ``layers``/``enc_layers``/
    ``dec_layers`` stacked in layer order (on the host, so the device
    holds no second copy).  A DTensor is gathered whole first, one at a
    time: under a mesh every rank calls this, and a rank that does not
    ``keep`` the tree drops each gathered leaf at once and gets None."""
    tree: dict = {}
    stacked: dict[tuple[str, str], dict[int, torch.Tensor]] = {}
    for name, t in named.items():
        t = full(t.detach())            # a collective under a mesh
        if not keep:
            continue
        top, _, rest = name.partition(".")
        if top in STACKS:
            i, _, rest = rest.partition(".")
            stacked.setdefault((top, rest), {})[int(i)] = t.cpu()
            continue
        _put(tree, name.split("."), host_array(t))
    for (top, rest), layers in stacked.items():
        leaf = torch.stack([layers[i] for i in range(len(layers))])
        _put(tree, [top, *rest.split(".")], host_array(leaf))
    return tree if keep else None


def _put(tree: dict, path: list[str], leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def named_from_reference(cfg, tree: dict, device=None) -> dict:
    """A tree of the params' shape in the reference's layout (an
    optimizer moment, the compression error state) → tensors on
    ``device`` keyed by the port's parameter names."""
    return {name: p.detach() for name, p in
            from_reference(cfg, tree, device).named_parameters()}


# --------------------------------------------------------------------------- #
# Blocks and trunk
# --------------------------------------------------------------------------- #
def _pre_norm(cfg, x, q, bias_norm: bool):
    """A block's pre-norm: the encdec family's layer norm with a bias
    (plain on both routes), else RMSNorm as ``cfg.attn_impl`` picks it."""
    if bias_norm:
        return layer_norm(x, q.scale, q.bias, cfg.norm_eps)
    return norm(cfg, x, q.scale)


def _attention(cfg, p, x, positions, kv_cache, pos, bias_norm=False):
    """The pre-norm causal self-attention half of a block → (x, (k, v)):
    the prompt's k/v in prefill, the updated caches in decode."""
    h = _pre_norm(cfg, x, p.ln1, bias_norm)
    q, k, v = qkv_project(cfg, p.attn, h, positions)
    if kv_cache is not None:
        kc, vc = cache_update(*kv_cache, k, v, pos)
        o = attend_decode(cfg, q, kc, vc, pos)
        new_kv = (kc, vc)
    else:
        o = attend_prefill(cfg, q, k, v, causal=True)
        new_kv = (k, v)
    return x + o_project(p.attn, o), new_kv


def attn_mlp_block(cfg, p, x, positions, *, kv_cache=None, pos=None,
                   bias_norm=False, with_mlp=True):
    """Standard pre-norm transformer block (the reference's
    ``_attn_mlp_block``): RMSNorm, or with ``bias_norm`` the layer norm
    with a bias; ``with_mlp=False`` stops after the attention (the
    reference passes a tree without ``mlp``).  Returns (x, (k, v)): the
    prompt's k/v in prefill, the updated caches in decode."""
    x, new_kv = _attention(cfg, p, x, positions, kv_cache, pos, bias_norm)
    if not with_mlp:
        return x, new_kv
    h2 = _pre_norm(cfg, x, p.ln2, bias_norm)
    return x + mlp(cfg, p.mlp, h2), new_kv


def moe_block(cfg, p, x, positions, *, kv_cache=None, pos=None):
    """The reference's ``_moe_block``: attention, then the routed MLP of
    ``cfg.moe_impl``.  Returns (x, (k, v), aux)."""
    x, new_kv = _attention(cfg, p, x, positions, kv_cache, pos)
    h2 = shard(norm(cfg, x, p.ln2.scale), "batch", "seq", "embed")
    moe_fn = moe_mlp_gshard if cfg.moe_impl == "gshard" else moe_mlp
    y, aux = moe_fn(cfg, p.moe, h2)
    return x + y, new_kv, aux


def _serving_block(cfg, p, x, positions, **kw):
    """An attention family's block for serving → (x, (k, v)); a moe
    block's aux is discarded."""
    if cfg.family == "moe":
        return moe_block(cfg, p, x, positions, **kw)[:2]
    return attn_mlp_block(cfg, p, x, positions, **kw)


def ssm_block(cfg, p, x, cache=None, h_out=None):
    """Pre-norm Mamba-1 (ssm) or Mamba-2 (hybrid) block (the reference's
    ``_ssm_block``).  Returns (x, {"conv", "h"}); the state goes into
    ``h_out`` when given."""
    h = shard(norm(cfg, x, p.ln.scale), "batch", "seq", "embed")
    block = mamba1_block if cfg.family == "ssm" else mamba2_block
    y, new_cache = block(cfg, p.mamba, h, cache, h_out)
    return x + y, new_cache


def cache_names(cfg, key: str) -> tuple[str, ...]:
    """The logical axes of the serving cache's leaf ``key`` (the
    reference's: ``kv_cache_names`` for the self-attention k/v, under
    the current mesh, as ``src/repro/models/lm.py:259-260`` shards them;
    the axes of ``launch/specs.py:cache_specs`` for the rest)."""
    if key in ("k", "v"):
        return kv_cache_names(cfg.n_kv_heads, cfg.hd)
    if key == "conv":
        return ("layers", "batch", "kernel",
                "d_inner" if cfg.family == "ssm" else "conv_dim")
    if key == "h":
        return (("layers", "batch", "d_inner", "state")
                if cfg.family == "ssm" else
                ("layers", "batch", "ssm_heads", "head_dim", "state"))
    return {"ck": ("layers", "batch", "frames", "kv_heads", "head_dim"),
            "ak": ("layers", "batch", "seq", "kv_heads", "head_dim")}[
        {"cv": "ck", "av": "ak"}.get(key, key)]


def _new_cache(cfg, key: str, x, shape, dtype=None, zeros=False):
    """Cache leaf ``key`` of ``shape`` beside the activations ``x``: a
    DTensor in ``cache_names``' layout under a mesh (each rank allocates
    its shard), else a plain tensor on x's device."""
    return new_like(x, shape, dtype or x.dtype, cache_names(cfg, key),
                    zeros)


def _ssm_cache(cfg, L: int, B: int, x) -> dict:
    """Empty conv windows and fp32 states of ``L`` layers of an ssm or
    hybrid trunk beside ``x``, for prefill to fill."""
    K = cfg.ssm_conv
    if cfg.family == "ssm":
        conv, state = cfg.d_inner, (cfg.d_inner, cfg.ssm_state)
    else:
        conv = cfg.d_inner + 2 * cfg.ssm_state
        state = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    return {"conv": _new_cache(cfg, "conv", x, (L, B, K - 1, conv)),
            "h": _new_cache(cfg, "h", x, (L, B, *state), torch.float32)}


def _ssm_layer(cfg, p, x, cache: dict, li: int, decode: bool):
    """Layer ``li`` of an ssm or hybrid trunk: its block, reading the
    cache's conv window and state in decode, its new ones written into
    the cache (the state in place through the block's ``h_out``, or
    under a mesh into each rank's shard) → x."""
    conv, h = select(cache["conv"], li), select(cache["h"], li)
    mesh = is_dtensor(h)
    x, new = ssm_block(cfg, p, x, {"conv": conv, "h": h} if decode else None,
                       h_out=None if mesh else h)
    if mesh:
        put(h, new["h"])
    put(conv, new["conv"])
    return x


def n_apps(cfg, layers: range) -> int:
    """The hybrid's ``ak``/``av`` slots for a range of layers: slot ``i //
    every - start // every`` for each layer ``i`` the shared block
    precedes (the reference's ``_stage_prefill_hybrid`` indexing), so
    ``cfg.n_attn_apps`` for the whole stack."""
    every = cfg.shared_attn_every
    if not layers:
        return 0
    return layers[-1] // every - layers.start // every + 1


def trunk_prefill(cfg, model: LM, x, positions, cache_len: int,
                  layers: range | None = None, shared=None):
    """x: (B, S, D) → (hidden, cache) over ``layers`` (all by default),
    the cache holding those layers in order; ``cache_len >= S`` (unused
    by ssm).  The hybrid runs ``shared`` (the model's shared block by
    default) before every ``shared_attn_every``-th layer, its k/v into
    that application's slot of ``ak``/``av``."""
    B, S, _ = x.shape
    layers = range(cfg.n_layers) if layers is None else layers
    if cfg.family in ("ssm", "hybrid"):
        cache = _ssm_cache(cfg, len(layers), B, x)
        every = cfg.shared_attn_every
        if cfg.family == "hybrid":
            shared = model.shared if shared is None else shared
            shape = (n_apps(cfg, layers), B, cache_len, cfg.n_kv_heads,
                     cfg.hd)
            for key in ("ak", "av"):
                cache[key] = _new_cache(cfg, key, x, shape, zeros=True)
        for li, i in enumerate(layers):
            if cfg.family == "hybrid" and i % every == 0:
                x, (k, v) = attn_mlp_block(cfg, shared, x, positions)
                slot = i // every - layers.start // every
                write_rows(select(cache["ak"], slot), k, 0)
                write_rows(select(cache["av"], slot), v, 0)
            x = _ssm_layer(cfg, model.layers[i], x, cache, li, False)
        return x, {**cache, "pos": S}
    shape = (len(layers), B, cache_len, cfg.n_kv_heads, cfg.hd)
    ks = _new_cache(cfg, "k", x, shape, zeros=True)
    vs = _new_cache(cfg, "v", x, shape, zeros=True)
    for li, i in enumerate(layers):
        x, (k, v) = _serving_block(cfg, model.layers[i], x, positions)
        write_rows(select(ks, li), k, 0)
        write_rows(select(vs, li), v, 0)
    return x, {"k": ks, "v": vs, "pos": S}


def trunk_decode(cfg, model: LM, x, cache: dict,
                 layers: range | None = None, shared=None):
    """x: (B, 1, D) → (hidden, cache) over ``layers`` (all by default;
    ``cache`` holds those layers, as ``trunk_prefill`` made it) with the
    new row written at ``cache["pos"]`` of every layer (ssm, hybrid: each
    layer's conv window and state updated in place; the hybrid's shared
    block writes its row into its application's ``ak``/``av``)."""
    pos = cache["pos"]
    positions = torch.arange(pos, pos + 1, device=x.device)
    layers = range(cfg.n_layers) if layers is None else layers
    if cfg.family in ("ssm", "hybrid"):
        every = cfg.shared_attn_every
        shared = model.shared if shared is None else shared
        for li, i in enumerate(layers):
            if cfg.family == "hybrid" and i % every == 0:
                slot = i // every - layers.start // every
                x, _ = attn_mlp_block(
                    cfg, shared, x, positions,
                    kv_cache=(select(cache["ak"], slot),
                              select(cache["av"], slot)), pos=pos)
            x = _ssm_layer(cfg, model.layers[i], x, cache, li, True)
        return x, {**cache, "pos": pos + 1}
    for li, i in enumerate(layers):
        x, _ = _serving_block(cfg, model.layers[i], x, positions,
                              kv_cache=(select(cache["k"], li),
                                        select(cache["v"], li)),
                              pos=pos)
    return x, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def _maybe_remat(fn, cfg):
    """``fn`` through ``torch.utils.checkpoint`` under ``cfg.remat`` while
    autograd records (the reference's ``jax.checkpoint`` of a scan
    body): its activations are recomputed in the backward pass instead
    of kept, under the mesh of the forward (``sharding.api.in_context``).
    Serving (no autograd) calls ``fn`` itself."""
    if not cfg.remat:
        return fn

    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(
            in_context(fn), *args, use_reentrant=False,
            preserve_rng_state=False)
    return remat


def _shard_residual(x, cfg):
    """The layer-boundary residual constraint: with ``cfg.seq_parallel``
    the residual (and so each remat'd layer's saved input) shards its
    seq dim over ``model`` (Megatron-SP), as in the reference."""
    return shard(x, "batch", "seq_sp" if cfg.seq_parallel else "seq",
                 "embed")


def trunk_train(cfg, model: LM, x, positions, layers: range | None = None,
                shared=None):
    """x: (B, S, D) → (hidden, aux) with autograd: the block of every
    layer of ``layers`` (all by default; remat'd under ``cfg.remat``),
    no cache.  The moe family's aux is the Switch load-balance term
    summed over the layers and divided by ``cfg.n_layers``; the hybrid
    applies ``shared`` (the model's shared block by default) before
    every ``shared_attn_every``-th layer, inside that layer's body (the
    reference's ``lax.cond``), so its gradient sums over the
    applications."""
    fam = cfg.family
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    every = cfg.shared_attn_every
    layers = range(cfg.n_layers) if layers is None else layers
    shared = model.shared if shared is None else shared

    def body(p, i, x):
        x = _shard_residual(x, cfg)
        if fam == "moe":
            y, _, a = moe_block(cfg, p, x, positions)
            return _shard_residual(y, cfg), a
        if fam in ("ssm", "hybrid"):
            if fam == "hybrid" and i % every == 0:
                x, _ = attn_mlp_block(cfg, shared, x, positions)
            return _shard_residual(ssm_block(cfg, p, x)[0], cfg), None
        y = attn_mlp_block(cfg, p, x, positions)[0]
        return _shard_residual(y, cfg), None

    for i in layers:
        p = model.layers[i]
        x, a = _maybe_remat(lambda x, p=p, i=i: body(p, i, x), cfg)(x)
        if a is not None:
            aux = aux + a
    if fam == "moe":
        aux = aux / cfg.n_layers
    return x, aux


def embed_inputs(cfg, model: LM, inputs: dict) -> torch.Tensor:
    tok = embed_lookup(model.embed.table, inputs["tokens"])
    if cfg.family == "vlm":
        img = inputs["img"].to(tok.dtype)           # (B, P, D) stub
        img = shard(img, "batch", "patches", "embed")
        tok = torch.cat([img, tok], dim=1)
    return tok


def final_hidden(cfg, model: LM, x):
    fn = model.final_norm
    if cfg.family == "encdec":
        return layer_norm(x, fn.scale, fn.bias, cfg.norm_eps)
    return norm(cfg, x, fn.scale)


def _logits(model: LM, x):
    head = model.lm_head.w if model.lm_head is not None else None
    return lm_logits(x, model.embed.table, head)


# --------------------------------------------------------------------------- #
# Whisper enc-dec
# --------------------------------------------------------------------------- #
def encode(cfg, model: LM, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, F, D), the stub conv frontend's output → the encoder's
    hidden states: non-causal pre-layer-norm blocks (RoPE on q/k, as in
    the reference; remat'd under ``cfg.remat`` in training), then
    ``enc_final_norm``."""
    x = frames.to(torch.bfloat16 if cfg.dtype == "bfloat16"
                  else torch.float32)
    x = shard(x, "batch", "frames", "embed")
    positions = torch.arange(x.shape[1], device=x.device)

    def body(p, x):
        x = _shard_residual(x, cfg)
        h = layer_norm(x, p.ln1.scale, p.ln1.bias, cfg.norm_eps)
        q, k, v = qkv_project(cfg, p.attn, h, positions)
        x = x + o_project(p.attn, attend_prefill(cfg, q, k, v, causal=False))
        h2 = layer_norm(x, p.ln2.scale, p.ln2.bias, cfg.norm_eps)
        return _shard_residual(x + mlp(cfg, p.mlp, h2), cfg)

    for p in model.enc_layers:
        x = _maybe_remat(lambda x, p=p: body(p, x), cfg)(x)
    fn = model.enc_final_norm
    return layer_norm(x, fn.scale, fn.bias, cfg.norm_eps)


def _cross_attention(cfg, p, x, enc_or_ckv):
    """A decoder layer's cross-attention (no RoPE): its k/v from the
    encoder's hidden states, or the cached ``(ck, cv)`` → (x, (ck, cv)).
    It goes through prefill attention, non-causal, also for the one
    query row of a decode step, as in the reference."""
    h = shard(layer_norm(x, p.ln_x.scale, p.ln_x.bias, cfg.norm_eps),
              "batch", "seq", "embed")
    q = torch.einsum("bsd,dhk->bshk", h, p.xattn.wq)
    if isinstance(enc_or_ckv, tuple):
        ck, cv = enc_or_ckv
    else:
        enc = shard(enc_or_ckv, "batch", "frames", "embed")
        ck = torch.einsum("bfd,dhk->bfhk", enc, p.xattn.wk)
        cv = torch.einsum("bfd,dhk->bfhk", enc, p.xattn.wv)
    o = attend_prefill(cfg, q, ck, cv, causal=False)
    return x + o_project(p.xattn, o), (ck, cv)


def dec_layer(cfg, p, x, enc_or_ckv, positions, kv_cache=None, pos=None):
    """The reference's ``_dec_layer``: causal self-attention, cross-
    attention, the MLP, each behind its layer norm → (x, (k, v), (ck,
    cv))."""
    x, new_kv = attn_mlp_block(cfg, p, x, positions, kv_cache=kv_cache,
                               pos=pos, bias_norm=True, with_mlp=False)
    x, ckv = _cross_attention(cfg, p, x, enc_or_ckv)
    h2 = layer_norm(x, p.ln2.scale, p.ln2.bias, cfg.norm_eps)
    return x + mlp(cfg, p.mlp, h2), new_kv, ckv


def decoder_train(cfg, model: LM, x, enc, positions,
                  layers: range | None = None):
    """x: (B, S, D), the embedded tokens; enc: (B, F, D) → the hidden
    states after ``layers`` (all by default), before the final norm,
    every layer remat'd under ``cfg.remat``."""
    layers = range(cfg.n_layers) if layers is None else layers
    for i in layers:
        p = model.dec_layers[i]
        x = _maybe_remat(lambda x, p=p: _shard_residual(dec_layer(
            cfg, p, _shard_residual(x, cfg), enc, positions)[0], cfg),
            cfg)(x)
    return x


def decoder_prefill(cfg, model: LM, x, enc, positions, cache_len: int,
                    layers: range | None = None):
    """x: (B, S, D), the embedded tokens; enc: (B, F, D) → (hidden before
    the final norm, cache) over ``layers`` (all by default); the cross
    k/v of every layer are cached once, here."""
    B, S, _ = x.shape
    layers = range(cfg.n_layers) if layers is None else layers
    L, F, KV, hd = len(layers), enc.shape[1], cfg.n_kv_heads, cfg.hd
    cache = {key: _new_cache(cfg, key, x, (L, B, cache_len, KV, hd),
                             zeros=True) for key in ("k", "v")}
    cache.update({key: _new_cache(cfg, key, x, (L, B, F, KV, hd))
                  for key in ("ck", "cv")})
    for li, i in enumerate(layers):
        x, (k, v), (ck, cv) = dec_layer(cfg, model.dec_layers[i], x, enc,
                                        positions)
        write_rows(select(cache["k"], li), k, 0)
        write_rows(select(cache["v"], li), v, 0)
        put(select(cache["ck"], li), ck)
        put(select(cache["cv"], li), cv)
    return x, {**cache, "pos": S}


def decoder_decode(cfg, model: LM, x, cache: dict,
                   layers: range | None = None):
    """x: (B, 1, D), the embedded token → (hidden before the final norm,
    cache) over ``layers`` (all by default) with the step's
    self-attention k/v written in place at ``cache["pos"]``."""
    pos = cache["pos"]
    positions = torch.arange(pos, pos + 1, device=x.device)
    layers = range(cfg.n_layers) if layers is None else layers
    for li, i in enumerate(layers):
        x, _, _ = dec_layer(cfg, model.dec_layers[i], x,
                            (select(cache["ck"], li),
                             select(cache["cv"], li)), positions,
                            kv_cache=(select(cache["k"], li),
                                      select(cache["v"], li)),
                            pos=pos)
    return x, {**cache, "pos": pos + 1}


# --------------------------------------------------------------------------- #
# Entry points
# --------------------------------------------------------------------------- #
def hidden_train(cfg, model: LM, inputs: dict):
    """→ (the final hidden states (B, S, D), after the final norm, and
    aux), differentiable: the one family dispatch of ``forward_train``
    and ``runtime.steps.loss_fn``."""
    _check_family(cfg)
    x = embed_inputs(cfg, model, inputs)
    positions = torch.arange(x.shape[1], device=x.device)
    if cfg.family == "encdec":
        enc = encode(cfg, model, inputs["frames"])
        x = decoder_train(cfg, model, x, enc, positions)
        return (final_hidden(cfg, model, x),
                torch.zeros((), dtype=torch.float32, device=x.device))
    x, aux = trunk_train(cfg, model, x, positions)
    return final_hidden(cfg, model, x), aux


def forward_train(cfg, model: LM, inputs: dict):
    """→ (logits fp32 (B, S, V), aux), differentiable: the full
    sequence's logits (``runtime.steps.loss_fn`` takes the chunked CE
    from the hidden states instead)."""
    x, aux = hidden_train(cfg, model, inputs)
    return _logits(model, x), aux


@torch.no_grad()
def forward_prefill(cfg, model: LM, inputs: dict,
                    cache_len: int | None = None):
    """→ (last-token logits fp32 (B, 1, V), cache)."""
    _check_family(cfg)
    x = embed_inputs(cfg, model, inputs)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    if cfg.family == "encdec":
        enc = encode(cfg, model, inputs["frames"])
        x, cache = decoder_prefill(cfg, model, x, enc, positions,
                                   cache_len or S)
    else:
        x, cache = trunk_prefill(cfg, model, x, positions, cache_len or S)
    x = final_hidden(cfg, model, x[:, -1:])
    return _logits(model, x), cache


@torch.no_grad()
def forward_decode(cfg, model: LM, token: torch.Tensor, cache: dict):
    """token: (B, 1) int → (logits fp32 (B, 1, V), cache).  Writes the
    step's k/v (or state) into ``cache``'s tensors in place."""
    _check_family(cfg)
    x = embed_lookup(model.embed.table, token)
    if cfg.family == "encdec":
        x, cache = decoder_decode(cfg, model, x, cache)
    else:
        x, cache = trunk_decode(cfg, model, x, cache)
    x = final_hidden(cfg, model, x)
    return _logits(model, x), cache
