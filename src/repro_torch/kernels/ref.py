"""Plain PyTorch versions of the port's kernels (the ground truth).

``ops`` takes these for tensors on the CPU; ``chip_smoke.py`` and the
``cuda``-marked tests hold each CUDA kernel in ``csrc/codec_pack.cu``,
``csrc/lm_kernels.cu`` and ``csrc/ssm_scan.cu`` to them on the card.

The LM kernels' versions (attention and RMSNorm) follow the reference's
``kernels/ref.py``: dense score matrices in fp32, cast back to the
input's dtype.  Unlike the reference's Pallas kernels they take any
``S``, ``T`` and ``Smax``.  The selective scan's is the reference's
sequential recurrence in fp32, one time step at a time; the gated scan's
(``mamba1_scan_chunk_ref``) wraps it in the Mamba-1 block's softplus,
D-skip and SiLU gate, from the model's own ``softplus`` and ``silu``.

The codec versions repeat their kernel's arithmetic step for step,
because the wire carries the kernel's bytes:

  * the scale is ``max(max|x|, 1e-12) * fp32(1/127)`` (``1/448`` for
    fp8).  The reference writes ``/ 127.0``, but XLA folds a division by
    a constant into a multiply by its fp32 reciprocal, and that product
    is what reaches the reference's wire;
  * the quantizer multiplies by ``inv = 1 / scale`` (IEEE division), as
    the Pallas kernel does — the reference's own ``kernels/ref.py``
    divides by the scale instead, which differs in the last bit;
  * a NaN anywhere makes the scale NaN (``max`` propagates it), and a
    NaN product quantizes to int8 0, as XLA converts it;
  * top-k orders magnitudes by their bits, ``bits(x) & 0x7FFFFFFF``,
    and keeps the lower index among equal keys, as ``lax.top_k`` does (a
    stable descending sort).  For finite values and inf that is the
    order of ``|x|``; NaNs rank above inf, by payload.
"""
from __future__ import annotations

import math

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
    # float -> int8 of NaN is undefined in C; the wire says 0
    return q.nan_to_num(0.0).to(torch.int8), scale


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
    key = flat.view(torch.int32) & 0x7FFFFFFF
    order = torch.sort(key, descending=True, stable=True).indices
    idx = torch.sort(order[:k]).values
    return idx.to(torch.int32), flat[idx]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,hd); k,v: (B,T,KV,hd) → (B,S,H,hd).  Query head ``h``
    reads KV head ``h // (H // KV)``; causal masking aligns the last
    query with the last key (query ``i`` sees keys ``<= i + T - S``)."""
    S, H, hd = q.shape[1], q.shape[2], q.shape[3]
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    kk = k.repeat_interleave(G, dim=2).to(torch.float32)
    vv = v.repeat_interleave(G, dim=2).to(torch.float32)
    s = torch.einsum("bshd,bthd->bhst", q.to(torch.float32), kk) \
        / math.sqrt(hd)
    if causal:
        mask = torch.ones(S, T, dtype=torch.bool, device=q.device) \
            .tril(diagonal=T - S)
        s = s.masked_fill(~mask, float("-inf"))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", w, vv).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos: int, *,
                         with_lse: bool = False):
    """q: (B,H,hd); caches: (B,Smax,KV,hd); attends positions ``<= pos``
    → (B,H,hd), and with ``with_lse`` the fp32 (B,H) log-sum-exp of the
    scaled scores over those positions."""
    H, hd = q.shape[1], q.shape[2]
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    kk = k_cache.repeat_interleave(G, dim=2).to(torch.float32)
    vv = v_cache.repeat_interleave(G, dim=2).to(torch.float32)
    s = torch.einsum("bhd,bshd->bhs", q.to(torch.float32), kk) \
        / math.sqrt(hd)
    mask = torch.arange(Smax, device=q.device) <= pos
    s = s.masked_fill(~mask, float("-inf"))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", w, vv).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if with_lse else out


def decode_attention_split_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, pos: int,
                               splits: int) -> torch.Tensor:
    """``decode_attention_ref`` computed as the split kernel does: the
    positions ``0..pos`` cut into ``splits`` ranges of
    ``ceil((pos + 1) / splits)`` (the last ones empty when there are
    more ranges than that needs), a softmax state (m, l, unnormalised o)
    per range, then merged: ``m = max m_i``, ``l = sum l_i e^(m_i - m)``,
    ``o = sum o_i e^(m_i - m) / l``; an empty range adds nothing.  For
    tests and the card's checks only."""
    H, hd = q.shape[1], q.shape[2]
    KV = k_cache.shape[2]
    G = H // KV
    n = pos + 1
    kk = k_cache[:, :n].repeat_interleave(G, dim=2).to(torch.float32)
    vv = v_cache[:, :n].repeat_interleave(G, dim=2).to(torch.float32)
    s = torch.einsum("bhd,bshd->bhs", q.to(torch.float32), kk) \
        / math.sqrt(hd)
    chunk = -(-n // splits)
    ms, ls, os_ = [], [], []
    for i in range(splits):
        a, e = min(i * chunk, n), min((i + 1) * chunk, n)
        if a == e:
            ms.append(torch.full(s.shape[:2], float("-inf"),
                                 device=q.device))
            ls.append(torch.zeros(s.shape[:2], device=q.device))
            os_.append(torch.zeros(q.shape, device=q.device))
            continue
        m = s[..., a:e].amax(dim=-1)
        p = torch.exp(s[..., a:e] - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        os_.append(torch.einsum("bhs,bshd->bhd", p, vv[:, a:e]))
    m = torch.stack(ms).amax(dim=0)
    w = [torch.where(mi == float("-inf"), torch.zeros_like(mi),
                     torch.exp(mi - m)) for mi in ms]
    l_tot = sum(li * wi for li, wi in zip(ls, w))
    o = sum(oi * wi[..., None] for oi, wi in zip(os_, w))
    return (o / l_tot[..., None]).to(q.dtype)


def ssm_scan_chunk_ref(dt: torch.Tensor, x: torch.Tensor, Bc: torch.Tensor,
                       Cc: torch.Tensor, A: torch.Tensor, h0: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the Mamba-1 recurrence, step by step in fp32.

    dt, x: (B, L, di) (dt already softplus'ed); Bc, Cc: (B, L, N);
    A: (di, N) (negative); h0: (B, di, N) →
    (y (B, L, di) fp32, h (B, di, N) fp32), with
    ``h = exp(dt·A)·h + (dt·x)⊗B`` and ``y = h·C`` at every step."""
    f32 = torch.float32
    dt, x = dt.to(f32), x.to(f32)
    Bc, Cc, A = Bc.to(f32), Cc.to(f32), A.to(f32)
    h = h0.to(f32)
    ys = []
    for t in range(dt.shape[1]):
        dA = torch.exp(dt[:, t, :, None] * A)                  # (B, di, N)
        h = dA * h + (dt[:, t] * x[:, t])[:, :, None] * Bc[:, t, None, :]
        ys.append((h * Cc[:, t, None, :]).sum(dim=-1))         # (B, di)
    y = torch.stack(ys, dim=1) if ys else dt.new_zeros(dt.shape)
    return y, h


def mamba1_scan_chunk_ref(dt: torch.Tensor, dt_bias: torch.Tensor,
                          x: torch.Tensor, z: torch.Tensor, Bc: torch.Tensor,
                          Cc: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                          h0: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the Mamba-1 block's scan with what surrounds it, in
    the plain route's pieces and order (``models/ssm.py``):
    ``dt = softplus(fp32(dt) + fp32(dt_bias))``, the recurrence, then
    ``y + fp32(x)·D`` times ``fp32(silu(z))``, cast to x's dtype.

    dt (raw), x, z: (B, L, di) and dt_bias: (di,) in the working dtype;
    Bc, Cc: (B, L, N); A: (di, N), D: (di,), h0: (B, di, N) fp32 →
    (y (B, L, di) in x's dtype, h (B, di, N) fp32)."""
    # imported here: models.common imports ops, which imports this module
    from ..models.common import silu, softplus
    f32 = torch.float32
    dt = softplus(dt.to(f32) + dt_bias.to(f32))
    y, h = ssm_scan_chunk_ref(dt, x, Bc, Cc, A, h0)
    y = y + x.to(f32) * D
    return (y * silu(z).to(f32)).to(x.dtype), h


def fused_rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *,
                      eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d); scale: (d,) → ``x * rsqrt(mean(x²) + eps) * scale``
    per row, in fp32, cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)
            * scale.to(torch.float32)).to(x.dtype)
