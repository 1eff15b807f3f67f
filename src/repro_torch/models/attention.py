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
from ..sharding.api import (Partial, Replicate, Shard, attn_q_names,
                            get_context, is_dtensor, on_shards, shard,
                            shard_start, to_placements)
from .common import SumOver, apply_rope, norm


def attn_params(cfg, leaf) -> dict:
    """``leaf``: a ``common.Init`` (or ``common.AbstractBuilder``).
    Shapes, scales and logical axes of the reference's ``attn_params``
    (``wo``'s fan-in is its first axis, H, as there).  Under a mesh whose ``model`` dim
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
    if is_dtensor(p.wo) and Shard(1) in p.wo.placements:
        y = _row_parallel_o(attn_out, p.wo)
    else:
        y = torch.einsum("bshk,hkd->bsd", attn_out, p.wo)
    return shard(y, "batch", "seq", "embed")


def _row_parallel_o(attn_out, wo):
    """The output projection of a row-parallel ``wo`` (H, hd, D), its
    head_dim split over ``model`` (``head_dim_rp``), on each rank's
    shards: each rank's slice of head_dim against its rows of ``wo``, the
    partial products summed over that mesh dim (an all-reduce, whose
    gradient is the output's on every rank).  DTensor's own rule would
    meet head_dim split inside the flattened (H·hd) contraction and
    fail."""
    wp = tuple(wo.placements)
    split = wp.index(Shard(1))
    ap = tuple(Shard(3) if md == split else
               p if isinstance(p, Shard) and p.dim == 0 else Replicate()
               for md, p in enumerate(attn_out.placements))
    out = tuple(Shard(0) if p == Shard(0) else Replicate() for p in ap)
    group = wo.device_mesh.get_group(split)

    def local(a, w):
        return SumOver.apply(torch.einsum("bshk,hkd->bsd", a, w), group)
    return on_shards(local, out, (attn_out, wo), (ap, wp),
                     (ap, tuple(Partial() if p == Shard(0) else q
                                for p, q in zip(ap, wp))))


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


def _attend_on_shards(cfg, q, k, v, causal: bool, fn=None):
    """Prefill attention of DTensors on each rank's shards, by ``fn(q,
    k, v)`` (``attend_prefill_chunked`` by default): the batch over
    ``data``, the kv heads (and their query heads) over ``model`` where
    it divides them, the sequences whole (q's is gathered if it came
    split); the heads whole on every rank where ``model`` does not
    divide the kv heads."""
    ctx = get_context()
    heads = "heads" if k.shape[2] % ctx.size("model") == 0 else None
    kv = "kv_heads" if heads else None
    qp = ctx.placements(("batch", "seq", heads, "head_dim"), tuple(q.shape))
    kp = ctx.placements(("batch", "seq", kv, "head_dim"), tuple(k.shape))
    fn = fn or (lambda q, k, v: attend_prefill_chunked(cfg, q, k, v,
                                                       causal=causal))
    return on_shards(fn, qp, (q, k, v), (qp, kp, kp))


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
        def kernel(q, k, v):
            return ops.flash_attention(q, k, v, causal=causal)
        if is_dtensor(q):
            return _attend_on_shards(cfg, q, k, v, causal, kernel)
        return kernel(q, k, v)
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


def _decode_part(cfg, q, k_cache, v_cache, pos: int):
    """Decode attention of q (B,1,H,hd) over the positions ``0..pos`` of
    the caches (B,Smax,KV,hd) → (out (B,1,H,hd), fp32 (B,H) log-sum-exp
    of their scaled scores): the kernel under ``"pallas"``, else the
    plain masked softmax.  A ``pos`` below 0 holds no position: a zero
    output of weight ``-inf``."""
    B, _, H, hd = q.shape
    if pos < 0:
        return (torch.zeros_like(q),
                torch.full((B, H), float("-inf"), dtype=torch.float32,
                           device=q.device))
    pos = min(pos, k_cache.shape[1] - 1)
    if cfg.attn_impl == "pallas":
        out, lse = ops.decode_attention(q.reshape(B, H, hd), k_cache,
                                        v_cache, pos, with_lse=True)
        return out.reshape(B, 1, H, hd), lse
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32),
                     k_cache.to(torch.float32)) / math.sqrt(hd)
    s = s.masked_fill(torch.arange(Smax, device=q.device) > pos,
                      float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    w = torch.exp(s - lse[..., None])
    out = torch.einsum("bkgs,bskd->bkgd", w, v_cache.to(torch.float32))
    return out.reshape(B, 1, H, hd).to(q.dtype), lse.reshape(B, H)


class _MergeOver:
    """Decode attention over a cache split along its sequence on one
    mesh dim: each rank attends over its own positions (``_decode_part``
    at its shard's offset) and the parts merge by their log-sum-exps
    over the dim's group (three all-reduces of (B,H)-sized or (B,H,hd)
    tensors; no rank gathers the cache)."""

    def __init__(self, cfg, pos: int, start: int, group):
        self.cfg, self.pos, self.start, self.group = cfg, pos, start, group

    def __call__(self, q, k_cache, v_cache):
        import torch.distributed as dist
        out, lse = _decode_part(self.cfg, q, k_cache, v_cache,
                                self.pos - self.start)
        m = lse.clone()
        dist.all_reduce(m, dist.ReduceOp.MAX, group=self.group)
        w = torch.exp(lse - m)                            # 0 for no positions
        num = out[:, 0].to(torch.float32) * w[..., None]
        dist.all_reduce(num, group=self.group)
        dist.all_reduce(w, group=self.group)
        return (num / w[..., None])[:, None].to(q.dtype)


def _decode_on_shards(cfg, q, k_cache, v_cache, pos: int):
    """``attend_decode`` of DTensors on each rank's shards, the caches
    as they lie: the batch over ``data``; the kv heads (and their query
    heads) over ``model`` where the cache splits them; where it splits
    the sequence instead (``kv_cache_names``' ``seq_model``), the heads
    whole and the ranks' parts merged (``_MergeOver``)."""
    kp = tuple(k_cache.placements)
    qp = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
               for p in kp)
    split = [md for md, p in enumerate(kp) if p == Shard(1)]
    if not split:
        def fn(q, k, v):
            return _decode_part(cfg, q, k, v, pos)[0]
    else:
        mesh = k_cache.device_mesh
        fn = _MergeOver(cfg, pos, shard_start(k_cache, 1),
                        mesh.get_group(split[0]))
    return on_shards(fn, qp, (q, k_cache, v_cache), (qp, kp, kp))


def attend_decode(cfg, q, k_cache, v_cache, pos: int):
    """q: (B,1,H,hd); caches: (B,Smax,KV,hd); pos: index of the current
    token (the cache already holds it) → (B,1,H,hd).  Under a mesh on
    each rank's shards (``_decode_on_shards``)."""
    if is_dtensor(q):
        return _decode_on_shards(cfg, q, k_cache, v_cache, pos)
    if cfg.attn_impl == "pallas":
        B, _, H, hd = q.shape
        out = ops.decode_attention(q.reshape(B, H, hd), k_cache, v_cache,
                                   pos)
        return out.reshape(B, 1, H, hd)
    return attend_decode_dense(q, k_cache, v_cache, pos)


def write_rows(cache, new, start: int):
    """Write ``new`` (B,n,KV,hd) into rows ``start..start+n`` of ``cache``
    (B,Smax,KV,hd), in place → ``cache``.  A DTensor cache keeps its
    layout: ``new`` takes the cache's split of the batch and kv heads,
    whole along the sequence, and where the cache splits the sequence
    each rank writes only the rows its shard holds."""
    n = new.shape[1]
    if not is_dtensor(cache):
        cache[:, start:start + n] = new.to(cache.dtype)
        return cache
    lp = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
               for p in cache.placements)
    rows = to_placements(new, lp).to_local()
    dst = cache.to_local()
    lo = shard_start(cache, 1)
    a, b = max(start, lo), min(start + n, lo + dst.shape[1])
    if a < b:
        dst[:, a - lo:b - lo] = rows[:, a - start:b - start].to(dst.dtype)
    return cache


def cache_update(k_cache, v_cache, k_new, v_new, pos: int):
    """Write (B,1,KV,hd) at position ``pos`` of the (B,Smax,KV,hd)
    caches (``write_rows``).  Unlike the reference, which returns
    updated copies, this writes the caches in place and returns them: a
    serving step then moves one row per layer, not the whole cache."""
    return write_rows(k_cache, k_new, pos), write_rows(v_cache, v_new, pos)
