"""Dense MLP (gated SwiGLU / plain GELU) and the capacity-based MoE
(counterpart of ``src/repro/models/mlp.py``).

Weight layouts are the reference's: ``w_up``/``w_gate`` (D, F) and
``w_down`` (F, D); the MoE's ``router`` (D, E) in fp32 whatever the
model's dtype, ``w_gate``/``w_up`` (E, D, F) and ``w_down`` (E, F, D).

The MoE has the reference's two formulations, both capacity-dropped
over token groups and both returning ``(y, aux)`` with the Switch
load-balance term: ``moe_mlp`` sorts the (token, choice) slots by
expert (a stable sort, so the slots past an expert's capacity are the
latest in (t, k) order) and gathers them into an (experts, capacity)
buffer; ``moe_mlp_gshard`` dispatches and combines with one-hot
einsums.  Both share the routing (``route``) and the expert products
(``_experts``).  The reference's ``shard`` constraints are dropped: the
port has no mesh.  Products, softmax, top-k, sort and gathers stay
library calls, as they are plain XLA outside any kernel in the
reference; every expert's product runs, picked by a token or not, as
there.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..sharding.api import (Partial, Replicate, Shard, get_context,
                            is_dtensor, on_shards, shard)
from .common import gelu, silu


# --------------------------------------------------------------------------- #
# Dense MLP
# --------------------------------------------------------------------------- #
def mlp_params(cfg, leaf) -> dict:
    """``leaf``: a ``common.Init`` (or anything that maps a shape to a
    tensor)."""
    D, F_ = cfg.d_model, cfg.d_ff
    p = {"w_up": leaf((D, F_), axes=("embed", "ff")),
         "w_down": leaf((F_, D), axes=("ff", "embed"))}
    if cfg.gated_mlp:
        p["w_gate"] = leaf((D, F_), axes=("embed", "ff"))
    return p


def mlp(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) → (B, S, D).  ``p``: the ``mlp`` node of a block.
    Under a mesh x is gathered whole along the sequence first."""
    x = shard(x, "batch", "seq", "embed")
    up = torch.einsum("bsd,df->bsf", x, p.w_up)
    up = shard(up, "batch", "seq", "ff")
    if cfg.gated_mlp:
        gate = torch.einsum("bsd,df->bsf", x, p.w_gate)
        h = silu(gate) * up
    else:
        h = gelu(up)
    y = torch.einsum("bsf,fd->bsd", h, p.w_down)
    return shard(y, "batch", "seq", "embed")


# --------------------------------------------------------------------------- #
# MoE
# --------------------------------------------------------------------------- #
def moe_params(cfg, leaf) -> dict:
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    e_ax, f_ax = _expert_axes(cfg)
    return {"router": leaf((D, E), dtype=torch.float32,
                           axes=("embed", None)),
            "w_gate": leaf((E, D, F_), axes=(e_ax, "embed", f_ax)),
            "w_up": leaf((E, D, F_), axes=(e_ax, "embed", f_ax)),
            "w_down": leaf((E, F_, D), axes=(e_ax, f_ax, "embed"))}


def _expert_axes(cfg) -> tuple:
    """The expert weights' (experts, ff) logical axes: expert-TP
    (``cfg.moe_shard == "etp"``) splits every expert's FFN over
    ``model`` and keeps the expert axis whole; else the experts shard
    (expert parallelism)."""
    if cfg.moe_shard == "etp":
        return None, "ff"
    return "experts", "expert_ff"


def _capacity(tokens_per_group: int, cfg) -> int:
    c = int(tokens_per_group * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(-(-c // 4) * 4, 4)


def groups(x: torch.Tensor, group: int) -> torch.Tensor:
    """x: (B, S, D) → (G, Tg, D) with Tg = min(group, B·S).  Raises where
    the reference's reshape fails: more tokens than a group that do not
    split into whole groups (nothing is padded or dropped)."""
    B, S, D = x.shape
    T = B * S
    Tg = min(group, T)
    if T % Tg:
        raise ValueError(f"{T} tokens do not split into MoE groups of {Tg}")
    return x.reshape(T // Tg, Tg, D)


class Routing(NamedTuple):
    logits: torch.Tensor    # (G, Tg, E) fp32
    top_w: torch.Tensor     # (G, Tg, K) fp32, renormalized over the k
    top_e: torch.Tensor     # (G, Tg, K) int64, descending probability
    aux: torch.Tensor       # () fp32, the Switch load-balance term


def route(cfg, p, xg: torch.Tensor) -> Routing:
    """The router on grouped tokens ``xg`` (G, Tg, D): fp32 logits,
    softmax and top-k, whatever ``xg``'s dtype."""
    E, K = cfg.n_experts, cfg.top_k
    logits = torch.einsum("gtd,de->gte", xg.to(torch.float32), p.router)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, K, dim=-1)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    density = F.one_hot(top_e[..., 0], E).to(torch.float32).mean(dim=1)
    aux = (density * probs.mean(dim=1)).mean() * E * E
    return Routing(logits, top_w, top_e, aux)


def _experts(cfg, p, buf: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU on its (G, E, C, D) slots; under a mesh the
    experts (or, expert-TP, their FFN) shard over ``model``."""
    e_ax, f_ax = _expert_axes(cfg)
    buf = shard(buf, "moe_group", e_ax, "capacity", "embed")
    gate = torch.einsum("gecd,edf->gecf", buf, p.w_gate)
    up = torch.einsum("gecd,edf->gecf", buf, p.w_up)
    h = shard(silu(gate) * up, "moe_group", e_ax, "capacity", f_ax)
    y = torch.einsum("gecf,efd->gecd", h, p.w_down)
    return shard(y, "moe_group", e_ax, "capacity", "embed")


class _Router(NamedTuple):
    router: torch.Tensor


def _grouped_tokens(x: torch.Tensor, group: int):
    """``groups(x, group)`` with the reference's ``moe_group`` constraint
    → (the groups, the logical names of x's layout for the way back).
    Under a mesh the groups shard over ``data``; the batch is gathered
    first where their count does not divide it."""
    names = ("batch", "seq", "embed")
    if is_dtensor(x):
        B, S, D = x.shape
        T = B * S
        if get_context().spec(("moe_group",), (T // min(group, T),))[0] \
                is None:
            names = (None, "seq", "embed")
        x = shard(x, *names)
    return shard(groups(x, group), "moe_group", "seq", "embed"), names


def _routed(cfg, p, xg: torch.Tensor, plan, n_plan: int):
    """``route`` and ``plan(top_e)`` → (top_w, aux, *plan's ``n_plan``
    tensors).  Under
    a mesh every rank routes its own groups (top-k, the one-hot, the
    sort and ``searchsorted`` have no DTensor rule; each group routes
    alone): the router's gradient is then a share of the sum over the
    groups' shards, and aux, the mean over the groups, one of the
    mean."""
    G = xg.shape[0]

    def local(xg, router):
        r = route(cfg, _Router(router), xg)
        return (r.top_w, r.aux * (xg.shape[0] / G), *plan(r.top_e))

    if not is_dtensor(xg):
        r = route(cfg, p, xg)
        return (r.top_w, r.aux, *plan(r.top_e))
    tok = tuple(xg.placements)
    split = tuple(Partial() if q == Shard(0) else Replicate() for q in tok)
    whole = (Replicate(),) * len(tok)
    return on_shards(local, (tok, split, *(tok,) * n_plan),
                     (xg, p.router), (tok, whole), (tok, split))


class SortSlots(NamedTuple):
    tok_src: torch.Tensor   # (G, E·C) the token filling each buffer slot
    valid: torch.Tensor     # (G, E, C) whether a token fills it
    flat_idx: torch.Tensor  # (G, Tg·K) each kept choice's buffer slot, 0 if dropped
    kept: torch.Tensor      # (G, Tg·K) whether the choice fits its expert


def sort_slots(top_e: torch.Tensor, n_experts: int, C: int) -> SortSlots:
    """The sort formulation's plan: the (t, k) choices stably sorted by
    expert; the first ``C`` of each expert fill its buffer rows."""
    G, Tg, K = top_e.shape
    E, TK, dev = n_experts, Tg * K, top_e.device
    e_flat = top_e.reshape(G, TK)
    tok_of_slot = torch.arange(Tg, device=dev).repeat_interleave(K)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    e_sorted = torch.gather(e_flat, -1, order)
    tok_sorted = tok_of_slot[order]
    # first sorted index of each expert → (G, E)
    starts = torch.searchsorted(
        e_sorted, torch.arange(E, device=dev).expand(G, E).contiguous())
    # buffer slot (e, c) is filled by sorted slot j = starts[e] + c
    j_idx = starts[:, :, None] + torch.arange(C, device=dev)
    nxt = torch.cat([starts[:, 1:], torch.full((G, 1), TK, device=dev)], 1)
    valid = j_idx < nxt[:, :, None]                       # c < count_e
    j_safe = j_idx.clamp_max(TK - 1).reshape(G, E * C)
    tok_src = torch.gather(tok_sorted, -1, j_safe)
    # the unsort map; each choice's position within its expert
    inv_order = torch.argsort(order, dim=-1)
    pos_sorted = torch.arange(TK, device=dev) - torch.gather(starts, -1,
                                                             e_sorted)
    pos = torch.gather(pos_sorted, -1, inv_order)
    kept = pos < C
    flat_idx = torch.where(kept, e_flat * C + pos, 0)
    return SortSlots(tok_src, valid, flat_idx, kept)


def _dispatch(xg, tok_src, valid, E: int, C: int):
    """(G, Tg, D) tokens → (G, E, C, D) buffer rows, unfilled ones 0."""
    G, _, D = xg.shape
    buf = torch.gather(xg, 1, tok_src[..., None].expand(G, E * C, D))
    return buf.reshape(G, E, C, D) * valid[..., None].to(xg.dtype)


def _combine(ybuf, flat_idx, kept, w_flat, K: int):
    """(G, E, C, D) expert outputs → (G, Tg, D): each token's kept
    choices, weighted, summed over its k."""
    G, E, C, D = ybuf.shape
    ybuf = ybuf.reshape(G, E * C, D)
    TK = flat_idx.shape[1]
    y_slot = torch.gather(ybuf, 1, flat_idx[..., None].expand(G, TK, D))
    y_slot = y_slot * kept[..., None].to(ybuf.dtype) * w_flat[..., None]
    return y_slot.reshape(G, TK // K, K, D).sum(dim=2)


def moe_mlp(cfg, p, x: torch.Tensor):
    """x: (B, S, D) → (y (B, S, D), aux): the sort-and-gather formulation
    over groups of ``cfg.moe_group_size`` tokens.  Under a mesh the
    gathers run on each rank's groups, the combine's with every
    expert's outputs gathered over ``model``."""
    B, S, D = x.shape
    xg, names = _grouped_tokens(x, cfg.moe_group_size)
    G, Tg, _ = xg.shape
    E, K, C = cfg.n_experts, cfg.top_k, _capacity(Tg, cfg)
    top_w, aux, *s = _routed(cfg, p, xg, lambda e: sort_slots(e, E, C), 4)
    tok_src, valid, flat_idx, kept = s
    w_flat = top_w.reshape(G, Tg * K).to(x.dtype)
    tok = tuple(xg.placements) if is_dtensor(xg) else None
    buf = on_shards(lambda *a: _dispatch(*a, E, C), tok,
                    (xg, tok_src, valid), (tok,) * 3)
    ybuf = _experts(cfg, p, buf)
    yg = on_shards(lambda *a: _combine(*a, K), tok,
                   (ybuf, flat_idx, kept, w_flat), (tok,) * 4)
    yg = shard(yg, "moe_group", "seq", "embed")
    return shard(yg.reshape(B, S, D), *names), aux


def gshard_slots(top_e: torch.Tensor, n_experts: int, C: int):
    """The one-hot formulation's plan → (onehots (G, Tg, K, E), pos_oh
    (G, Tg, K, C), keep (G, Tg, K)): each choice's position within its
    expert is a running count over the (t, k) order; a position past
    ``C`` has a zero one-hot row (``jax.nn.one_hot``'s out-of-range
    case, where ``F.one_hot`` would raise)."""
    G, Tg, K = top_e.shape
    onehots = F.one_hot(top_e, n_experts).to(torch.float32)
    flat = onehots.reshape(G, Tg * K, n_experts)
    pos = flat.cumsum(dim=1) - flat
    pos = (pos * flat).sum(dim=-1).reshape(G, Tg, K)
    pos_oh = (pos[..., None] == torch.arange(C, device=top_e.device)).to(
        torch.float32)
    return onehots, pos_oh, pos < C


def moe_mlp_gshard(cfg, p, x: torch.Tensor):
    """x: (B, S, D) → (y, aux): GShard's one-hot dispatch and combine
    einsums over groups of ``cfg.moe_gshard_group`` tokens."""
    B, S, D = x.shape
    xg, names = _grouped_tokens(x, cfg.moe_gshard_group)
    Tg = xg.shape[1]
    C = _capacity(Tg, cfg)
    top_w, aux, onehots, pos_oh, keep = _routed(
        cfg, p, xg, lambda e: gshard_slots(e, cfg.n_experts, C), 3)
    disp = torch.einsum("gtke,gtkc->gtec", onehots * keep[..., None], pos_oh)
    comb = torch.einsum("gtk,gtke,gtkc->gtec", top_w * keep, onehots,
                        pos_oh)
    buf = torch.einsum("gtec,gtd->gecd", disp.to(x.dtype), xg)
    yg = torch.einsum("gtec,gecd->gtd", comb.to(x.dtype),
                      _experts(cfg, p, buf))
    yg = shard(yg, "moe_group", "seq", "embed")
    return shard(yg.reshape(B, S, D), *names), aux
