"""Plain PyTorch versions of the wire-codec kernels (the ground truth).

``ops`` takes these for tensors on the CPU; ``chip_smoke.py`` and the
``cuda``-marked tests hold each CUDA kernel in ``csrc/codec_pack.cu``
to them on the card.  Each repeats its kernel's arithmetic step for
step, because the wire carries the kernel's bytes:

  * the scale is ``max(max|x|, 1e-12) * fp32(1/127)`` (``1/448`` for
    fp8).  The reference writes ``/ 127.0``, but XLA folds a division by
    a constant into a multiply by its fp32 reciprocal, and that product
    is what reaches the reference's wire;
  * the quantizer multiplies by ``inv = 1 / scale`` (IEEE division), as
    the Pallas kernel does — the reference's own ``kernels/ref.py``
    divides by the scale instead, which differs in the last bit;
  * top-k keeps the lower index among equal magnitudes, as
    ``lax.top_k`` does (a stable descending sort).
"""
from __future__ import annotations

import torch

EPS = 1e-12


def _flat32(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1).to(torch.float32)


def _scale(flat: torch.Tensor, q_max: float) -> torch.Tensor:
    # a Python scalar enters an fp32 op as an fp32 value: 1e-12 and
    # 1/q_max round exactly as the reference's weakly typed constants
    return flat.abs().amax().clamp_min(EPS) * (1.0 / q_max)


def int8_pack_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantize → (int8 flat[n], fp32 scale)."""
    flat = _flat32(x)
    if not flat.numel():
        return (flat.to(torch.int8),
                torch.tensor(EPS / 127.0, dtype=torch.float32,
                             device=flat.device))
    scale = _scale(flat, 127.0)
    q = torch.round(flat * (1.0 / scale)).clamp(-127.0, 127.0)
    return q.to(torch.int8), scale


def int8_unpack_ref(q: torch.Tensor, scale) -> torch.Tensor:
    """``scale``: an fp32 0-d tensor or a Python float holding an fp32
    value (the wire's); either way the product is an fp32 multiply."""
    return q.to(torch.float32) * scale


def fp8_pack_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Scaled e4m3 cast (round to nearest even, no saturation) →
    (float8_e4m3fn flat[n], fp32 scale)."""
    flat = _flat32(x)
    if not flat.numel():
        return (flat.to(torch.float8_e4m3fn),
                torch.tensor(EPS / 448.0, dtype=torch.float32,
                             device=flat.device))
    scale = _scale(flat, 448.0)
    return (flat * (1.0 / scale)).to(torch.float8_e4m3fn), scale


def fp8_unpack_ref(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale


def topk_select_ref(x: torch.Tensor, *, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """k largest-|x| entries of the flat tensor, ties to the lower index
    → (int32 indices ascending — the wire's uint32 bits, fp32 values)."""
    flat = _flat32(x)
    order = torch.sort(flat.abs(), descending=True, stable=True).indices
    idx = torch.sort(order[:k]).values
    return idx.to(torch.int32), flat[idx]
