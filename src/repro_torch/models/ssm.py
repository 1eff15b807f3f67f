"""Selective state-space blocks: Mamba-1 (falcon-mamba) and Mamba-2
(zamba2) (counterpart of ``src/repro/models/ssm.py``).

``cfg.attn_impl`` picks the route of Mamba-1's recurrence, as it does for
attention and RMSNorm: ``"pallas"`` runs every chunk, and the decode
step, through ``ops.mamba1_scan_chunk`` (the CUDA kernel on the card, its
plain version on the CPU), which also takes the dt softplus, the D-skip
and the gate, carrying the state from one chunk to the next; ``"xla"``
runs the plain copy of the reference's own route, a log-depth
associative scan within each chunk (at decode a chunk of one step, which
is the reference's one-step formula), with those steps as separate
tensor ops.  (The reference declares the switch but always takes the
latter.)

Mamba-2's SSD (``_ssd_chunk``) is the reference's chunked matrix form in
plain tensor ops on both routes, as the reference computes it in plain
jnp and has no kernel for it; its decode step is the reference's
one-step formula.  Under ``"pallas"`` only its gated RMSNorm changes
route (``common.norm``, the fused kernel).

Chunking is the reference's: ``L = min(cfg.ssm_chunk, S)``, and ``L =
S`` when ``S`` is not a multiple of it.  Dtypes follow the reference
along the block: projections and the conv in the working dtype, ``dt``
and the state in fp32, the gate rounded back to the working dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..sharding.api import (Partial, Replicate, Shard, get_context,
                            is_dtensor, on_shards, shard, shares)
from .common import norm, silu, softplus


# --------------------------------------------------------------------------- #
# Causal depthwise conv1d
# --------------------------------------------------------------------------- #
def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                carry: torch.Tensor | None = None):
    """x: (B, S, C); w: (C, K); → (y (B, S, C), new carry (B, K-1, C)).
    The reference's depthwise cross-correlation of ``concat(carry, x)``
    (no flip); the new carry is the last ``K-1`` inputs, before the
    conv.  Under a mesh each rank convolves its own channels (the conv
    has no DTensor rule for a depthwise weight sharded on them), from
    its shard of the carry in decode."""
    if is_dtensor(x):
        ctx = get_context()
        xp = ctx.placements(("batch", "seq", "conv_dim"), tuple(x.shape))
        wp = ctx.placements(("conv_dim", "kernel"), tuple(w.shape))
        bp = ctx.placements(("conv_dim",), tuple(b.shape))
        if carry is not None:
            return on_shards(causal_conv, (xp, xp), (x, w, b, carry),
                             (xp, wp, bp, xp))
        # each rank's weight gradient sums over its rows of the batch only
        batch = [q == Shard(0) for q in xp]
        return on_shards(causal_conv, (xp, xp), (x, w, b), (xp, wp, bp),
                         (xp, *(tuple(Partial() if s else q
                                      for s, q in zip(batch, t))
                                for t in (wp, bp))))
    B, S, C = x.shape
    K = w.shape[1]
    if carry is None:
        carry = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([carry, x], dim=1)                     # (B, S+K-1, C)
    y = F.conv1d(xp.transpose(1, 2), w[:, None, :], groups=C)
    if torch.is_grad_enabled() and (y.requires_grad or b.requires_grad):
        # autograd records no op with out=
        out = y.transpose(1, 2) + b
    else:
        # the bias lands in a (B, S, C) buffer with C contiguous, the
        # layout the projections and the scan read
        out = torch.add(y.transpose(1, 2), b,
                        out=torch.empty((B, S, C), dtype=y.dtype,
                                        device=y.device))
    new_carry = xp[:, -(K - 1):] if K > 1 else carry
    return out, new_carry


# --------------------------------------------------------------------------- #
# Mamba-1
# --------------------------------------------------------------------------- #
def mamba1_params(cfg, leaf) -> dict:
    """``leaf``: a ``common.Init``.  The reference's leaves, shapes,
    scales and dtypes: ``A_log`` (``log(1..N)`` for every channel) and
    ``D`` are fp32 in any model."""
    D, di, N, R, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                      cfg.ssm_conv)

    def a_init(shape, dtype, device):
        a = torch.arange(1, N + 1, dtype=torch.float32, device=device)
        return torch.log(a).repeat(di, 1).to(dtype)

    f32 = torch.float32
    return {"in_proj": leaf((D, 2 * di), axes=("embed", "d_inner")),
            "conv_w": leaf((di, K), axes=("d_inner", "kernel")),
            "conv_b": leaf((di,), "zeros", axes=("d_inner",)),
            "x_proj": leaf((di, R + 2 * N), axes=("d_inner", None)),
            "dt_proj": leaf((R, di), axes=("dt_rank", "d_inner")),
            "dt_bias": leaf((di,), "zeros", axes=("d_inner",)),
            "A_log": leaf((di, N), a_init, dtype=f32,
                          axes=("d_inner", "state")),
            "D": leaf((di,), "ones", dtype=f32, axes=("d_inner",)),
            "out_proj": leaf((di, D), axes=("d_inner", "embed"))}


def _scan_dt(cfg, p, xc: torch.Tensor):
    """xc: (B, S, di) → (dt (B,S,di) raw, before bias and softplus, B_
    and C_ (B,S,N): the dt_proj output and column views of the x_proj
    output, all in the working dtype; A (di,N) fp32)."""
    N, R = cfg.ssm_state, cfg.dt_rank
    proj = torch.einsum("bsc,cr->bsr", xc, p.x_proj)
    dt_low, B_, C_ = proj.split([R, N, N], dim=-1)
    dt = torch.einsum("bsr,rc->bsc", dt_low, p.dt_proj)
    A = -torch.exp(p.A_log.float())
    return dt, B_, C_, A


def _associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan over axis 1 with ``(a, b) ∘ (c, d) = (a·c, b·c + d)``
    (the reference's operator), Hillis-Steele: log2(L) rounds, each
    combining every element with the one ``off`` steps before it."""
    L, off = a.shape[1], 1
    while off < L:
        a_cur, b_cur = a[:, off:], b[:, off:]
        b = torch.cat([b[:, :off], b[:, :-off] * a_cur + b_cur], dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a_cur], dim=1)
        off *= 2
    return a, b


def _plain_chunk(dt_c, B_c, C_c, x_c, A, h):
    """One chunk of the reference's route: associative scan of
    ``(exp(dt·A), dt·B·x)`` over the chunk, plus ``dec·h0``."""
    f32 = torch.float32
    dA = torch.exp(dt_c[..., None] * A)                   # (B,L,di,N)
    dBx = dt_c[..., None] * B_c[:, :, None, :].to(f32) \
        * x_c[..., None].to(f32)
    dA = shard(dA, "batch", None, "d_inner", "state")
    dBx = shard(dBx, "batch", None, "d_inner", "state")
    dec, hs = _associative_scan(dA, dBx)
    hs = hs + dec * h[:, None]
    y = torch.einsum("blcn,bln->blc", hs, C_c.to(f32))
    return y, hs[:, -1]


def _mamba1_inner(cfg, p, xc: torch.Tensor, z: torch.Tensor,
                  h0: torch.Tensor | None, h_out: torch.Tensor | None = None):
    """Scan core.  xc: (B, S, di) after conv and SiLU; z: the gate; h0:
    (B, di, N) fp32, or None for a zero state under a mesh → (y (B, S,
    di), h).  The final state is written into ``h_out`` when one is
    given (it may be ``h0``).  ``"pallas"`` runs the kernel
    (``_kernel_scan``), else the plain scan; under a mesh either on each
    rank's shards (``_scan_on_shards``)."""
    S = xc.shape[1]
    dt, B_, C_, A = _scan_dt(cfg, p, xc)
    L = min(cfg.ssm_chunk, S)
    if S % L != 0:
        L = S
    scan = _kernel_scan if cfg.attn_impl == "pallas" else _plain_scan
    if is_dtensor(xc):
        return _scan_on_shards(scan, dt, B_, C_, xc, z, A, p.dt_bias, p.D, L,
                               h0)
    return scan(dt, B_, C_, xc, z, A, p.dt_bias, p.D, L, h0, h_out)


def _kernel_scan(dt, B_, C_, xc, z, A, dt_bias, D, L: int, h0, h_out=None):
    """The kernel's scan over chunks of ``L`` (``ops.mamba1_scan_chunk``:
    softplus, D-skip and gate run inside it) → (y, h)."""
    B, S, di = xc.shape
    y = torch.empty((B, S, di), dtype=xc.dtype, device=xc.device)
    h = h0
    for c0 in range(0, S, L):
        c = slice(c0, c0 + L)
        _, h = ops.mamba1_scan_chunk(dt[:, c], dt_bias, xc[:, c], z[:, c],
                                     B_[:, c], C_[:, c], A, D, h, y=y[:, c],
                                     h_out=h_out)
        h_out = h                       # later chunks update it in place
    return y, h


def _plain_scan(dt, B_, C_, xc, z, A, dt_bias, D, L: int, h0, h_out=None):
    """The plain route's scan over chunks of ``L`` → (y, h)."""
    S = xc.shape[1]
    dt = softplus(dt.float() + dt_bias.float())
    h = h0.float()
    ys = []
    for c0 in range(0, S, L):
        c = slice(c0, c0 + L)
        y_c, h = _plain_chunk(dt[:, c], B_[:, c], C_[:, c], xc[:, c], A, h)
        ys.append(y_c)
    y = torch.cat(ys, dim=1)
    if h_out is not None:
        h = h_out.copy_(h)
    y = y + xc.float() * D
    y = (y * silu(z).float()).to(xc.dtype)
    return y, h


def _scan_on_shards(scan, dt, B_, C_, xc, z, A, dt_bias, D, L: int,
                    h0=None):
    """``scan`` (``_plain_scan`` or ``_kernel_scan``) of DTensors on each
    rank's rows (``data``) and channels (``model``, the reference's
    ``d_inner`` layout) from ``h0``, or a zero state: the scan runs
    along each channel alone.  B and C come whole, each rank reading
    them against its channels."""
    ctx = get_context()
    B, S, di = xc.shape
    N = A.shape[1]
    rows = ctx.placements(("batch", "seq", "d_inner"), (B, S, di))
    bc = ctx.placements(("batch", "seq", None), tuple(B_.shape))
    a = ctx.placements(("d_inner", "state"), tuple(A.shape))
    vec = ctx.placements(("d_inner",), (di,))
    hp = ctx.placements(("batch", "d_inner", "state"), (B, di, N))
    chans = tuple(q if ax == "model" else Replicate()
                  for ax, q in zip(ctx.axis_names, rows))
    batch = tuple(q if ax == "data" else Replicate()
                  for ax, q in zip(ctx.axis_names, rows))

    def local(dt, B_, C_, xc, z, A, dt_bias, D, h0):
        if h0 is None:
            h0 = torch.zeros((xc.shape[0], xc.shape[2], N),
                             dtype=torch.float32, device=xc.device)
        return scan(dt, B_, C_, xc, z, A, dt_bias, D, L, h0)
    return on_shards(local, (rows, hp),
                     (dt, B_, C_, xc, z, A, dt_bias, D, h0),
                     (rows, bc, bc, rows, rows, a, vec, vec, hp),
                     (rows, shares(bc, chans), shares(bc, chans), rows, rows,
                      shares(a, batch), shares(vec, batch),
                      shares(vec, batch), hp))


def mamba1_block(cfg, p, x: torch.Tensor, cache: dict | None = None,
                 h_out: torch.Tensor | None = None):
    """x: (B, S, D).  ``cache``: None (prefill from scratch) or
    ``{"conv": (B,K-1,di), "h": (B,di,N)}`` for a one-token decode step.
    → (out (B, S, D), {"conv", "h"}).  The new state is written into
    ``h_out`` when one is given (the trunk passes the cache's own slot,
    so decode updates the state in place)."""
    B, S, _ = x.shape
    di, N = cfg.d_inner, cfg.ssm_state
    xz = torch.einsum("bsd,de->bse", x, p.in_proj)
    xz = shard(xz, "batch", "seq", "d_inner")
    xr, z = xz.chunk(2, dim=-1)
    conv_in = cache["conv"] if cache is not None else None
    xc, conv_out = causal_conv(xr, p.conv_w, p.conv_b, conv_in)
    xc = silu(xc)
    if cache is not None:
        h0 = cache["h"]
    elif is_dtensor(x):
        h0 = None                       # each rank's shard starts at zero
    else:
        h0 = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
    # a decode step is one chunk of L = 1: through the kernel under
    # "pallas"; under "xla" the scan of one element is the reference's
    # one-step formula, dA·h0 + dt·B·x
    y, h = _mamba1_inner(cfg, p, xc, z, h0, h_out)
    out = torch.einsum("bsc,cd->bsd", y, p.out_proj)
    out = shard(out, "batch", "seq", "embed")
    return out, {"conv": conv_out, "h": h}


# --------------------------------------------------------------------------- #
# Mamba-2 (SSD)
# --------------------------------------------------------------------------- #
def mamba2_params(cfg, leaf) -> dict:
    """``leaf``: a ``common.Init``.  The reference's leaves, shapes,
    scales and dtypes: ``in_proj`` projects to ``z | x B C | dt``, the
    conv runs over the ``di + 2N`` channels of ``x B C``; ``A_log``
    (``log(linspace(1, 16, H))``), ``D`` and ``dt_bias`` are per head and
    fp32 in any model; ``norm`` scales the gated RMSNorm."""
    D, di, N, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    H = cfg.ssm_heads
    d_xbc = di + 2 * N

    def a_init(shape, dtype, device):
        a = torch.linspace(1.0, 16.0, H, dtype=torch.float32, device=device)
        return torch.log(a).to(dtype)

    f32 = torch.float32
    return {"in_proj": leaf((D, 2 * di + 2 * N + H),
                            axes=("embed", "d_inner")),
            "conv_w": leaf((d_xbc, K), axes=("conv_dim", "kernel")),
            "conv_b": leaf((d_xbc,), "zeros", axes=("conv_dim",)),
            "A_log": leaf((H,), a_init, dtype=f32, axes=("ssm_heads",)),
            "D": leaf((H,), "ones", dtype=f32, axes=("ssm_heads",)),
            "dt_bias": leaf((H,), "zeros", dtype=f32, axes=("ssm_heads",)),
            "norm": leaf((di,), "ones", axes=("d_inner",)),
            "out_proj": leaf((di, D), axes=("d_inner", "embed"))}


def _ssd_decay(Scum: torch.Tensor, C_c: torch.Tensor, B_c: torch.Tensor,
               tri: torch.Tensor) -> torch.Tensor:
    """A chunk's intra-chunk weights ``att[b,t,s,h] = exp(S_t - S_s) ·
    (C_t · B_s)`` for ``s <= t``, 0 above the diagonal.  The mask goes in
    before the exp, as in the reference (an upper-triangle exponent is
    positive and would overflow)."""
    f32 = torch.float32
    cb = torch.einsum("btn,bsn->bts", C_c.to(f32), B_c.to(f32))
    dec = Scum[:, :, None, :] - Scum[:, None, :, :]          # (B,t,s,H)
    dec = shard(dec, "batch", None, None, "ssm_heads")
    w = torch.exp(torch.where(tri, dec, float("-inf")))
    return shard(cb[..., None] * w, "batch", None, None, "ssm_heads")


def _ssd_carry(h: torch.Tensor, Scum: torch.Tensor, C_c: torch.Tensor,
               B_c: torch.Tensor, dtx: torch.Tensor):
    """The state's share of a chunk: the carry-in term ``exp(S_t) · (C_t
    · h)`` of every step's y, and the new carry ``exp(S_L) · h + Σ_s
    exp(S_L - S_s) B_s ⊗ dtx_s`` → (y_in (B,L,H,P), h (B,H,P,N))."""
    f32 = torch.float32
    y_in = torch.einsum("btn,bhpn->bthp", C_c.to(f32), h) \
        * torch.exp(Scum)[..., None]
    wL = torch.exp(Scum[:, -1:, :] - Scum)                    # (B,L,H)
    h_new = h * torch.exp(Scum[:, -1])[..., None, None] + torch.einsum(
        "bsn,bshp,bsh->bhpn", B_c.to(f32), dtx, wL)
    return y_in, h_new


def _ssd_chunk(cfg, dt: torch.Tensor, zlog: torch.Tensor, x: torch.Tensor,
               B_: torch.Tensor, C_: torch.Tensor, h0: torch.Tensor):
    """Chunked SSD (the reference's ``_ssd_chunk``).  dt: (B,S,H) fp32
    input scale; zlog = dt·A <= 0, the decay exponent; x: (B,S,H,P);
    B_, C_: (B,S,N); h0: (B,H,P,N) → (y (B,S,H,P) fp32, h (B,H,P,N)
    fp32).  Within a chunk the recurrence is the matrix form: weights
    from the cumulative decay ``Scum`` (fp32) times ``dt·x``; across
    chunks the state carries."""
    Bb, S, H, P = x.shape
    L = min(cfg.ssm_chunk, S)
    if S % L != 0:
        L = S
    tri = torch.ones((L, L), dtype=torch.bool,
                     device=x.device).tril()[None, :, :, None]
    h = h0.to(torch.float32)
    ys = []
    for c0 in range(0, S, L):
        c = slice(c0, c0 + L)
        C_c, B_c = C_[:, c], B_[:, c]
        Scum = torch.cumsum(zlog[:, c], dim=1)                # (B,L,H)
        att = _ssd_decay(Scum, C_c, B_c, tri)
        dtx = dt[:, c, :, None] * x[:, c].to(torch.float32)   # (B,L,H,P)
        y_in, h = _ssd_carry(h, Scum, C_c, B_c, dtx)
        ys.append(torch.einsum("btsh,bshp->bthp", att, dtx) + y_in)
    return torch.cat(ys, dim=1), h


def _ssd_on_shards(cfg, dt, zlog, x, B_, C_):
    """``_ssd_chunk`` of DTensors on each rank's rows (``data``) and heads
    (``model``, the reference's ``ssm_heads`` layout) from a zero state:
    each head's recurrence runs alone.  B and C come whole, each rank
    reading them against its heads."""
    ctx = get_context()
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    heads = ctx.placements(("batch", "seq", "ssm_heads"), (Bb, S, H))
    xp = ctx.placements(("batch", "seq", "ssm_heads", None), (Bb, S, H, P))
    bc = ctx.placements(("batch", "seq", None), tuple(B_.shape))
    hp = ctx.placements(("batch", "ssm_heads", None, None), (Bb, H, P, N))
    over = tuple(q if ax == "model" else Replicate()
                 for ax, q in zip(ctx.axis_names, heads))

    def local(dt, zlog, x, B_, C_):
        h0 = torch.zeros((x.shape[0], x.shape[2], P, N), dtype=torch.float32,
                         device=x.device)
        return _ssd_chunk(cfg, dt, zlog, x, B_, C_, h0)
    return on_shards(local, (xp, hp), (dt, zlog, x, B_, C_),
                     (heads, heads, xp, bc, bc),
                     (heads, heads, xp, shares(bc, over), shares(bc, over)))


def mamba2_block(cfg, p, x: torch.Tensor, cache: dict | None = None,
                 h_out: torch.Tensor | None = None):
    """x: (B, S, D).  ``cache``: None (prefill from scratch) or
    ``{"conv": (B,K-1,di+2N), "h": (B,H,P,N)}`` for a one-token decode
    step.  → (out (B, S, D), {"conv", "h"}); the state goes into
    ``h_out`` when one is given.  The SSD is the same plain code on both
    routes (the reference has no kernel for it); under ``"pallas"`` the
    gated RMSNorm runs the fused kernel."""
    B, S, _ = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    f32 = torch.float32
    zxbcdt = torch.einsum("bsd,de->bse", x, p.in_proj)
    zxbcdt = shard(zxbcdt, "batch", "seq", "d_inner")
    z, xBC, dt_raw = zxbcdt.split([di, di + 2 * N, H], dim=-1)
    conv_in = cache["conv"] if cache is not None else None
    xBC, conv_out = causal_conv(xBC, p.conv_w, p.conv_b, conv_in)
    xBC = silu(xBC)
    xr, B_, C_ = xBC.split([di, N, N], dim=-1)
    xh = xr.reshape(B, S, H, P)
    A = -torch.exp(p.A_log.to(f32))                           # (H,)
    dt = softplus(dt_raw.to(f32) + p.dt_bias)                 # (B,S,H)
    zlog = dt * A                                             # decay exponent
    h0 = cache["h"] if cache is not None else torch.zeros(
        (B, H, P, N), dtype=f32, device=x.device)
    if S == 1 and cache is not None:
        # decode: one recurrence step
        dA = torch.exp(zlog[:, 0])                            # (B,H)
        dtx = dt[:, 0, :, None] * xh[:, 0].to(f32)            # (B,H,P)
        h = h0 * dA[..., None, None] + torch.einsum(
            "bn,bhp->bhpn", B_[:, 0].to(f32), dtx)
        y = torch.einsum("bn,bhpn->bhp", C_[:, 0].to(f32), h)[:, None]
    elif is_dtensor(xh):
        y, h = _ssd_on_shards(cfg, dt, zlog, xh, B_, C_)
    else:
        y, h = _ssd_chunk(cfg, dt, zlog, xh, B_, C_, h0)
    if h_out is not None:
        h = h_out.copy_(h)
    y = (y + xh.to(f32) * p.D[:, None]).reshape(B, S, di)
    # y·silu(z) is rounded to the working dtype before the norm
    y = norm(cfg, (y * silu(z).to(f32)).to(x.dtype), p.norm)
    out = torch.einsum("bsc,cd->bsd", y, p.out_proj)
    out = shard(out, "batch", "seq", "embed")
    return out, {"conv": conv_out, "h": h}
