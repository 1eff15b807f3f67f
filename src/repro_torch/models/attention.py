"""GQA attention: projections, RoPE, prefill and cached decode
(counterpart of ``src/repro/models/attention.py``).

``cfg.attn_impl`` selects the route, as the reference's config declares
(``models/config.py``): ``"pallas"`` sends prefill and decode attention
to the port's kernels (``ops.flash_attention``/``ops.decode_attention``,
CUDA on the card, their plain versions on the CPU); ``"xla"`` takes the
plain copies of the reference's own routes below — the chunked
online-softmax prefill and the masked dense decode.  (The reference
declares the switch but its model code always takes the ``"xla"``
route.)

Weight layouts are the reference's: ``wq (D,H,hd)``, ``wk/wv
(D,KV,hd)``, ``wo (H,hd,D)``.  Query head ``h`` reads KV head
``h // (H // KV)``.
"""
from __future__ import annotations

import math

import torch

from ..kernels import ops
from ..sharding.api import (attn_q_names, get_context, is_dtensor,
                            on_shards, shard)
from .common import apply_rope, norm


def attn_params(cfg, leaf) -> dict:
    """``leaf``: a ``common.Init`` (or ``common.Specs``).  Shapes, scales
    and logical axes of the reference's ``attn_params`` (``wo``'s fan-in
    is its first axis, H, as there).  Under a mesh whose ``model`` dim
    does not divide the heads, the projections shard their contraction
    dims instead (row-parallel: D for q/k/v, head_dim for o), the
    reference's build-time choice."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ctx = get_context()
    tp = ctx.size("model") if ctx is not None else 1
    row_par = tp > 1 and H % tp != 0
    qe = "embed_rp" if row_par else "embed"
    od = "head_dim_rp" if row_par else "head_dim"
    p = {"wq": leaf((D, H, hd), axes=(qe, "heads", "head_dim")),
         "wk": leaf((D, KV, hd), axes=(qe, "kv_heads", "head_dim")),
         "wv": leaf((D, KV, hd), axes=(qe, "kv_heads", "head_dim")),
         "wo": leaf((H, hd, D), axes=("heads", od, "embed"))}
    if cfg.qk_norm:
        p["q_norm"] = leaf((hd,), "ones", axes=("head_dim",))
        p["k_norm"] = leaf((hd,), "ones", axes=("head_dim",))
    return p


def qkv_project(cfg, p, x: torch.Tensor, positions: torch.Tensor, *,
                rope: bool = True):
    """x: (B, S, D) → q (B,S,H,hd), k/v (B,S,KV,hd).  ``p``: the ``attn``
    node of a block.  Under a mesh x is gathered whole along the
    sequence first (it may arrive as the sequence-parallel residual)."""
    x = shard(x, "batch", "seq", "embed")
    # q's product in its own layout, whatever attention then takes: its
    # gradient then reaches the product whole along the sequence
    q = shard(torch.einsum("bsd,dhk->bshk", x, p.wq),
              "batch", "seq", "heads", "head_dim")
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv)
    if cfg.qk_norm:
        q = norm(cfg, q, p.q_norm)
        k = norm(cfg, k, p.k_norm)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = shard(q, *attn_q_names(cfg.n_heads))
    k = shard(k, "batch", "seq", "kv_heads", "head_dim")
    v = shard(v, "batch", "seq", "kv_heads", "head_dim")
    return q, k, v


def o_project(p, attn_out: torch.Tensor) -> torch.Tensor:
    # under a mesh the sequence comes whole (q may have been split on it)
    attn_out = shard(attn_out, "batch", "seq", "heads", "head_dim")
    y = torch.einsum("bshk,hkd->bsd", attn_out, p.wo)
    return shard(y, "batch", "seq", "embed")


# --------------------------------------------------------------------------- #
# Prefill attention
# --------------------------------------------------------------------------- #
def _block_attn(q, k, v, bias, scale):
    """One (q-chunk × kv-chunk) block. q:(B,c,KV,G,hd) k/v:(B,j,KV,hd)
    → (scores_max, exp_scores@v, exp_sum) in fp32."""
    s = torch.einsum("bckgd,bjkd->bkgcj", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if bias is not None:
        s = s + bias
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    ev = torch.einsum("bkgcj,bjkd->bckgd", e, v.to(torch.float32))
    return m, ev, e.sum(dim=-1)


def _causal_bias(n_q: int, n_k: int, device) -> torch.Tensor:
    pos_q = torch.arange(n_q, device=device)[:, None]
    pos_k = torch.arange(n_k, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(pos_q >= pos_k, zero, float("-inf"))


def _attend_on_shards(cfg, q, k, v, causal: bool):
    """``attend_prefill_chunked`` of DTensors on each rank's shards: the
    batch over ``data``, the kv heads (and their query heads) over
    ``model`` where it divides them, the sequence whole (q's is gathered
    if it came split); the heads whole on every rank where ``model``
    does not divide the kv heads."""
    ctx = get_context()
    heads = "heads" if k.shape[2] % ctx.size("model") == 0 else None
    kv = "kv_heads" if heads else None
    qp = ctx.placements(("batch", "seq", heads, "head_dim"), tuple(q.shape))
    kp = ctx.placements(("batch", "seq", kv, "head_dim"), tuple(k.shape))
    return on_shards(lambda q, k, v: attend_prefill_chunked(
        cfg, q, k, v, causal=causal), qp, (q, k, v), (qp, kp, kp))


def attend_prefill_chunked(cfg, q, k, v, *, causal: bool = True):
    """The reference's plain prefill (``attention.py:90-150``): queries
    in chunks of ``cfg.attn_chunk``, each against the kv chunks up to
    the diagonal with an online-softmax carry; one full block when the
    shapes do not divide the chunk.  q: (B,S,H,hd); k,v: (B,T,KV,hd).
    Under a mesh on each rank's shards (``_attend_on_shards``)."""
    if is_dtensor(q):
        return _attend_on_shards(cfg, q, k, v, causal)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, S, KV, G, hd)

    chunk = cfg.attn_chunk
    if S % chunk != 0 or T % chunk != 0 or S != T and causal:
        chunk = 0
    if chunk == 0 or S <= chunk:
        bias = _causal_bias(S, T, q.device) if causal else None
        m, ev, l = _block_attn(qg, k, v, bias, scale)
        out = ev / l.movedim(-1, 1)[..., None]
        return out.reshape(B, S, H, hd).to(q.dtype)

    nq, nk = S // chunk, T // chunk
    tri = _causal_bias(chunk, chunk, q.device)
    outs = []
    for i in range(nq):
        qi = qg[:, i * chunk:(i + 1) * chunk]
        m_run = torch.full((B, KV, G, chunk), float("-inf"),
                           dtype=torch.float32, device=q.device)
        l_run = torch.zeros((B, KV, G, chunk), dtype=torch.float32,
                            device=q.device)
        acc = torch.zeros((B, chunk, KV, G, hd), dtype=torch.float32,
                          device=q.device)
        for j in range(i + 1 if causal else nk):
            kj = k[:, j * chunk:(j + 1) * chunk]
            vj = v[:, j * chunk:(j + 1) * chunk]
            bias = tri if causal and j == i else None
            m_j, ev_j, l_j = _block_attn(qi, kj, vj, bias, scale)
            m_new = torch.maximum(m_run, m_j)
            a_run = torch.exp(m_run - m_new)
            a_j = torch.exp(m_j - m_new)
            l_run = l_run * a_run + l_j * a_j
            # m/l are (B,KV,G,c); acc is (B,c,KV,G,hd)
            acc = (acc * a_run.movedim(-1, 1)[..., None]
                   + ev_j * a_j.movedim(-1, 1)[..., None])
            m_run = m_new
        outs.append(acc / l_run.movedim(-1, 1)[..., None])
    out = torch.cat(outs, dim=1)
    return out.reshape(B, S, H, hd).to(q.dtype)


def attend_prefill(cfg, q, k, v, *, causal: bool = True):
    """q: (B,S,H,hd); k,v: (B,T,KV,hd) → (B,S,H,hd)."""
    if cfg.attn_impl == "pallas":
        return ops.flash_attention(q, k, v, causal=causal)
    return attend_prefill_chunked(cfg, q, k, v, causal=causal)


# --------------------------------------------------------------------------- #
# Decode attention against a KV cache
# --------------------------------------------------------------------------- #
def attend_decode_dense(q, k_cache, v_cache, pos: int):
    """The reference's plain decode (``attention.py:156``): scores over
    the whole cache, positions past ``pos`` masked."""
    B, _, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32),
                     k_cache.to(torch.float32)) * scale
    mask = torch.arange(Smax, device=q.device) <= pos
    s = s.masked_fill(~mask, float("-inf"))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, v_cache.to(torch.float32))
    return out.reshape(B, 1, H, hd).to(q.dtype)


def attend_decode(cfg, q, k_cache, v_cache, pos: int):
    """q: (B,1,H,hd); caches: (B,Smax,KV,hd); pos: index of the current
    token (the cache already holds it) → (B,1,H,hd)."""
    if cfg.attn_impl == "pallas":
        B, _, H, hd = q.shape
        out = ops.decode_attention(q.reshape(B, H, hd), k_cache, v_cache,
                                   pos)
        return out.reshape(B, 1, H, hd)
    return attend_decode_dense(q, k_cache, v_cache, pos)


def cache_update(k_cache, v_cache, k_new, v_new, pos: int):
    """Write (B,1,KV,hd) at position ``pos`` of the (B,Smax,KV,hd)
    caches.  Unlike the reference, which returns updated copies, this
    writes the caches in place and returns them: a serving step then
    moves one row per layer, not the whole cache."""
    k_cache[:, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v_new[:, 0].to(v_cache.dtype)
    return k_cache, v_cache
