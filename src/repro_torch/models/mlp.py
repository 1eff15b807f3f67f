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

from .common import gelu, silu


# --------------------------------------------------------------------------- #
# Dense MLP
# --------------------------------------------------------------------------- #
def mlp_params(cfg, leaf) -> dict:
    """``leaf``: a ``common.Init`` (or anything that maps a shape to a
    tensor)."""
    D, F_ = cfg.d_model, cfg.d_ff
    p = {"w_up": leaf((D, F_)), "w_down": leaf((F_, D))}
    if cfg.gated_mlp:
        p["w_gate"] = leaf((D, F_))
    return p


def mlp(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) → (B, S, D).  ``p``: the ``mlp`` node of a block."""
    up = torch.einsum("bsd,df->bsf", x, p.w_up)
    if cfg.gated_mlp:
        gate = torch.einsum("bsd,df->bsf", x, p.w_gate)
        h = silu(gate) * up
    else:
        h = gelu(up)
    return torch.einsum("bsf,fd->bsd", h, p.w_down)


# --------------------------------------------------------------------------- #
# MoE
# --------------------------------------------------------------------------- #
def moe_params(cfg, leaf) -> dict:
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": leaf((D, E), dtype=torch.float32),
            "w_gate": leaf((E, D, F_)), "w_up": leaf((E, D, F_)),
            "w_down": leaf((E, F_, D))}


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


def _experts(p, buf: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU on its (G, E, C, D) slots."""
    gate = torch.einsum("gecd,edf->gecf", buf, p.w_gate)
    up = torch.einsum("gecd,edf->gecf", buf, p.w_up)
    return torch.einsum("gecf,efd->gecd", silu(gate) * up, p.w_down)


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


def moe_mlp(cfg, p, x: torch.Tensor):
    """x: (B, S, D) → (y (B, S, D), aux): the sort-and-gather formulation
    over groups of ``cfg.moe_group_size`` tokens."""
    B, S, D = x.shape
    xg = groups(x, cfg.moe_group_size)
    G, Tg, _ = xg.shape
    r = route(cfg, p, xg)
    E, K, C = cfg.n_experts, cfg.top_k, _capacity(Tg, cfg)
    s = sort_slots(r.top_e, E, C)
    w_flat = r.top_w.reshape(G, Tg * K).to(x.dtype)

    buf = torch.gather(xg, 1, s.tok_src[..., None].expand(G, E * C, D))
    buf = buf.reshape(G, E, C, D) * s.valid[..., None].to(x.dtype)
    ybuf = _experts(p, buf).reshape(G, E * C, D)

    y_slot = torch.gather(ybuf, 1, s.flat_idx[..., None].expand(G, Tg * K, D))
    y_slot = y_slot * s.kept[..., None].to(x.dtype) * w_flat[..., None]
    return y_slot.reshape(G, Tg, K, D).sum(dim=2).reshape(B, S, D), r.aux


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
    xg = groups(x, cfg.moe_gshard_group)
    Tg = xg.shape[1]
    r = route(cfg, p, xg)
    onehots, pos_oh, keep = gshard_slots(r.top_e, cfg.n_experts,
                                         _capacity(Tg, cfg))
    disp = torch.einsum("gtke,gtkc->gtec", onehots * keep[..., None], pos_oh)
    comb = torch.einsum("gtk,gtke,gtkc->gtec", r.top_w * keep, onehots,
                        pos_oh)
    buf = torch.einsum("gtec,gtd->gecd", disp.to(x.dtype), xg)
    yg = torch.einsum("gtec,gecd->gtd", comb.to(x.dtype), _experts(p, buf))
    return yg.reshape(B, S, D), r.aux
