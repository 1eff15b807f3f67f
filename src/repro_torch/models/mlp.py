"""Dense MLP: gated SwiGLU or plain GELU (counterpart of the dense half of
``src/repro/models/mlp.py``).

Weight layouts are the reference's: ``w_up``/``w_gate`` (D, F) and
``w_down`` (F, D).  The products stay ``torch.einsum``: plain matrix
products, which the reference leaves to XLA outside any kernel.  The
capacity-based MoE is not ported yet (ROADMAP queue 1, item 10).
"""
from __future__ import annotations

import torch

from .common import gelu, silu

_MOE = ("the MoE MLP is not ported yet (ROADMAP queue 1, item 10: LM model "
        "stack, MoE half)")


def mlp_params(cfg, leaf) -> dict:
    """``leaf``: a ``common.Init`` (or anything that maps a shape to a
    tensor)."""
    D, F = cfg.d_model, cfg.d_ff
    p = {"w_up": leaf((D, F)), "w_down": leaf((F, D))}
    if cfg.gated_mlp:
        p["w_gate"] = leaf((D, F))
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


def moe_params(*args, **kwargs):
    raise NotImplementedError(_MOE)


def moe_mlp(*args, **kwargs):
    raise NotImplementedError(_MOE)
