"""The port's LM kernels' plain versions against the JAX reference.

On the CPU ``repro_torch.kernels.ops`` takes the plain PyTorch versions
(``kernels/ref.py``) of the CUDA kernels in ``csrc/lm_kernels.cu``; here
they are held to the reference's Pallas kernels run in interpret mode,
at a few of ``tests/test_kernels.py``'s sweep shapes, and — at ragged
shapes the Pallas kernels refuse — to the reference's pure-jnp oracles.
Tolerances are ``tests/test_kernels.py``'s: 2e-5 in fp32, 2e-2 in bf16.
The CUDA kernels are held to the same plain versions on the card by
``test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro import configs as RCFG
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.models.attention import attend_prefill as r_attend_prefill
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models.attention import attend_decode_dense, attend_prefill

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(dtype: str) -> dict:
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _pair(x: np.ndarray, dtype: str):
    """The same values in both packages, rounded once to ``dtype``."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _close(mine: torch.Tensor, ref, dtype: str) -> None:
    assert_allclose(mine.to(torch.float32).numpy(),
                    np.asarray(ref, np.float32), **tol(dtype))


# --------------------------------------------------------------------------- #
# against the reference's Pallas kernels in interpret mode
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("B,S,H,KV,hd,causal", [
    (1, 128, 4, 4, 64, True),        # MHA
    (1, 128, 8, 1, 128, True),       # MQA, granite-style head_dim
    (2, 128, 4, 2, 96, False),       # GQA, phi3-vision head_dim
    (1, 128, 36, 4, 128, True),      # starcoder2-7b's group, G = 9
    (1, 128, 24, 2, 128, True),      # starcoder2-3b's group, G = 12
    (1, 128, 48, 1, 128, True),      # granite-20b's MQA group, G = 48
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas(B, S, H, KV, hd, causal, dtype):
    q, tq = _pair(_normal((B, S, H, hd), 0), dtype)
    k, tk = _pair(_normal((B, S, KV, hd), 1), dtype)
    v, tv = _pair(_normal((B, S, KV, hd), 2), dtype)
    exp = rops.flash_attention(q, k, v, causal=causal, block_q=64,
                               block_k=64, interpret=True)
    out = ops.flash_attention(tq, tk, tv, causal=causal)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _close(out, exp, dtype)


@pytest.mark.parametrize("B,H,KV,hd,Smax,pos", [
    (2, 4, 2, 64, 512, 317),
    (1, 8, 1, 128, 256, 0),          # first token
    (2, 4, 4, 96, 256, 255),         # full cache
    (1, 36, 4, 128, 256, 200),       # starcoder2-7b's group, G = 9
    (2, 24, 2, 128, 256, 129),       # starcoder2-3b's group, G = 12
    (1, 48, 1, 128, 256, 255),       # granite-20b's MQA group, G = 48
    (2, 32, 32, 96, 256, 131),       # phi-3-vision's 32 heads of 96 (MHA)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_pallas(B, H, KV, hd, Smax, pos, dtype):
    q, tq = _pair(_normal((B, H, hd), 3), dtype)
    kc, tkc = _pair(_normal((B, Smax, KV, hd), 4), dtype)
    vc, tvc = _pair(_normal((B, Smax, KV, hd), 5), dtype)
    exp = rops.decode_attention(q, kc, vc, pos, block_s=128, interpret=True)
    out = ops.decode_attention(tq, tkc, tvc, pos)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _close(out, exp, dtype)


@pytest.mark.parametrize("shape", [(4, 128), (2, 33, 128), (1, 7, 5, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_rmsnorm_matches_pallas(shape, dtype):
    x, tx = _pair(_normal(shape, 6), dtype)
    sc = _normal((shape[-1],), 7)
    exp = rops.fused_rmsnorm(x, jnp.asarray(sc), interpret=True)
    out = ops.fused_rmsnorm(tx, torch.from_numpy(sc))
    assert out.dtype == tx.dtype and out.shape == tx.shape
    _close(out, exp, dtype)


# --------------------------------------------------------------------------- #
# ragged shapes, against the reference's oracles
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("S,T,causal", [(100, 100, True), (24, 75, False),
                                        (24, 75, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ragged_matches_oracle(S, T, causal, dtype):
    q, tq = _pair(_normal((2, S, 4, 16), 8), dtype)
    k, tk = _pair(_normal((2, T, 2, 16), 9), dtype)
    v, tv = _pair(_normal((2, T, 2, 16), 10), dtype)
    _close(ops.flash_attention(tq, tk, tv, causal=causal),
           rref.flash_attention_ref(q, k, v, causal=causal), dtype)


@pytest.mark.parametrize("pos", [0, 5, 76])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_ragged_matches_oracle(pos, dtype):
    q, tq = _pair(_normal((2, 6, 16), 11), dtype)
    kc, tkc = _pair(_normal((2, 77, 3, 16), 12), dtype)
    vc, tvc = _pair(_normal((2, 77, 3, 16), 13), dtype)
    _close(ops.decode_attention(tq, tkc, tvc, pos),
           rref.decode_attention_ref(q, kc, vc, pos), dtype)


@pytest.mark.parametrize("d", [3, 2048])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_rmsnorm_ragged_matches_oracle(d, dtype):
    x, tx = _pair(_normal((5, d), 14), dtype)
    sc = _normal((d,), 15)
    _close(ops.fused_rmsnorm(tx, torch.from_numpy(sc), eps=1e-5),
           rref.fused_rmsnorm_ref(x, jnp.asarray(sc), eps=1e-5), dtype)


# --------------------------------------------------------------------------- #
# the model's two prefill routes
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_prefill_matches_reference_model_attention(causal):
    """The port's ``"xla"`` route (the reference's chunked online softmax,
    two chunks of 32 at S = 64) against the reference's own, and the
    ``"pallas"`` route against both."""
    B, S, H, KV, hd = 2, 64, 4, 2, 16
    q = _normal((B, S, H, hd), 16)
    k = _normal((B, S, KV, hd), 17)
    v = _normal((B, S, KV, hd), 18)
    rcfg = RCFG.reduced("qwen3-1.7b")
    assert rcfg.attn_chunk == 32
    exp = r_attend_prefill(rcfg, jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(v), causal=causal)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    cfg = configs.reduced("qwen3-1.7b")
    xla = attend_prefill(cfg.replace(attn_impl="xla"), *t, causal=causal)
    pallas = attend_prefill(cfg.replace(attn_impl="pallas"), *t,
                            causal=causal)
    assert_allclose(xla.numpy(), np.asarray(exp), rtol=2e-5, atol=2e-5)
    assert_allclose(pallas.numpy(), np.asarray(exp), rtol=2e-5, atol=2e-5)


def test_dense_decode_matches_the_kernel_oracle():
    q = torch.from_numpy(_normal((2, 1, 4, 16), 19))
    kc = torch.from_numpy(_normal((2, 40, 2, 16), 20))
    vc = torch.from_numpy(_normal((2, 40, 2, 16), 21))
    a = attend_decode_dense(q, kc, vc, 17)
    b = ops.decode_attention(q.reshape(2, 4, 16), kc, vc, 17)
    assert_allclose(a.reshape(2, 4, 16).numpy(), b.numpy(), rtol=2e-5,
                    atol=2e-5)
