"""Selective state-space blocks: Mamba-1 (falcon-mamba) (counterpart of
``src/repro/models/ssm.py``).

``cfg.attn_impl`` picks the route of the recurrence, as it does for
attention and RMSNorm: ``"pallas"`` runs every chunk, and the decode
step, through ``ops.mamba1_scan_chunk`` (the CUDA kernel on the card, its
plain version on the CPU), which also takes the dt softplus, the D-skip
and the gate, carrying the state from one chunk to the next; ``"xla"``
runs the plain copy of the reference's own route, a log-depth
associative scan within each chunk (at decode a chunk of one step, which
is the reference's one-step formula), with those steps as separate
tensor ops.  (The reference declares the switch but always takes the
latter.)

Chunking is the reference's: ``L = min(cfg.ssm_chunk, S)``, and ``L =
S`` when ``S`` is not a multiple of it.  Dtypes follow the reference
along the block: projections and the conv in the working dtype, ``dt``
and the state in fp32, the gate rounded back to the working dtype.

Mamba-2 (the hybrid family, zamba2) is not ported yet (ROADMAP queue 1,
item 10).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import silu, softplus


# --------------------------------------------------------------------------- #
# Causal depthwise conv1d
# --------------------------------------------------------------------------- #
def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                carry: torch.Tensor | None = None):
    """x: (B, S, C); w: (C, K); → (y (B, S, C), new carry (B, K-1, C)).
    The reference's depthwise cross-correlation of ``concat(carry, x)``
    (no flip); the new carry is the last ``K-1`` inputs, before the
    conv."""
    B, S, C = x.shape
    K = w.shape[1]
    if carry is None:
        carry = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([carry, x], dim=1)                     # (B, S+K-1, C)
    y = F.conv1d(xp.transpose(1, 2), w[:, None, :], groups=C)
    # the bias lands in a (B, S, C) buffer with C contiguous, the layout
    # the projections and the scan read
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
    return {"in_proj": leaf((D, 2 * di)),
            "conv_w": leaf((di, K)),
            "conv_b": leaf((di,), "zeros"),
            "x_proj": leaf((di, R + 2 * N)),
            "dt_proj": leaf((R, di)),
            "dt_bias": leaf((di,), "zeros"),
            "A_log": leaf((di, N), a_init, dtype=f32),
            "D": leaf((di,), "ones", dtype=f32),
            "out_proj": leaf((di, D))}


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
    dec, hs = _associative_scan(dA, dBx)
    hs = hs + dec * h[:, None]
    y = torch.einsum("blcn,bln->blc", hs, C_c.to(f32))
    return y, hs[:, -1]


def _mamba1_inner(cfg, p, xc: torch.Tensor, z: torch.Tensor,
                  h0: torch.Tensor, h_out: torch.Tensor | None = None):
    """Scan core.  xc: (B, S, di) after conv and SiLU; z: the gate; h0:
    (B, di, N) fp32 → (y (B, S, di), h).  The final state is written
    into ``h_out`` when one is given (it may be ``h0``)."""
    B, S, di = xc.shape
    dt, B_, C_, A = _scan_dt(cfg, p, xc)
    L = min(cfg.ssm_chunk, S)
    if S % L != 0:
        L = S
    if cfg.attn_impl == "pallas":
        # softplus, D-skip and gate run inside the kernel
        y = torch.empty((B, S, di), dtype=xc.dtype, device=xc.device)
        h = h0
        for c0 in range(0, S, L):
            c = slice(c0, c0 + L)
            _, h = ops.mamba1_scan_chunk(dt[:, c], p.dt_bias, xc[:, c],
                                         z[:, c], B_[:, c], C_[:, c], A, p.D,
                                         h, y=y[:, c], h_out=h_out)
            h_out = h                   # later chunks update it in place
        return y, h
    dt = softplus(dt.float() + p.dt_bias.float())
    h = h0.float()
    ys = []
    for c0 in range(0, S, L):
        c = slice(c0, c0 + L)
        y_c, h = _plain_chunk(dt[:, c], B_[:, c], C_[:, c], xc[:, c], A, h)
        ys.append(y_c)
    y = torch.cat(ys, dim=1)
    if h_out is not None:
        h = h_out.copy_(h)
    y = y + xc.float() * p.D
    y = (y * silu(z).float()).to(xc.dtype)
    return y, h


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
    xr, z = xz.chunk(2, dim=-1)
    conv_in = cache["conv"] if cache is not None else None
    xc, conv_out = causal_conv(xr, p.conv_w, p.conv_b, conv_in)
    xc = silu(xc)
    h0 = cache["h"] if cache is not None else torch.zeros(
        (B, di, N), dtype=torch.float32, device=x.device)
    # a decode step is one chunk of L = 1: through the kernel under
    # "pallas"; under "xla" the scan of one element is the reference's
    # one-step formula, dA·h0 + dt·B·x
    y, h = _mamba1_inner(cfg, p, xc, z, h0, h_out)
    out = torch.einsum("bsc,cd->bsd", y, p.out_proj)
    return out, {"conv": conv_out, "h": h}


# --------------------------------------------------------------------------- #
# Mamba-2 (SSD): not ported yet
# --------------------------------------------------------------------------- #
def _mamba2_not_ported():
    raise NotImplementedError("Mamba-2 (the hybrid family) is not ported "
                              "yet (ROADMAP queue 1, item 10)")


def mamba2_params(cfg, leaf) -> dict:
    _mamba2_not_ported()


def _ssd_chunk(cfg, dt, zlog, x, B_, C_, h0):
    _mamba2_not_ported()


def mamba2_block(cfg, p, x, cache=None):
    _mamba2_not_ported()
