"""The CUDA codec kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports no jax, so it runs on the GPU machine without the repository's
``conftest.py`` (which imports jax):

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_kernels_cuda.py
"""
import math

import pytest
import torch

from repro_torch.core import codecs as C
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(n, cuda):
    g = torch.Generator(device=cuda).manual_seed(n)
    return (torch.randn(n, generator=g, device=cuda) * 3.0,
            # few distinct magnitudes: top-k ties go to the lower index
            torch.randint(-4, 5, (n,), generator=g, device=cuda).float())


@pytest.mark.parametrize("n", [1, 7, 127, 129, 1_000_003])
def test_pack_unpack_kernels_are_bit_exact(n, cuda):
    for x in _inputs(n, cuda):
        for pack in ("int8_pack", "fp8_pack"):
            q, s = getattr(ops, pack)(x)
            q_ref, s_ref = getattr(ref, pack + "_ref")(x)
            assert torch.equal(q.view(torch.uint8), q_ref.view(torch.uint8))
            assert torch.equal(s.view(torch.int32), s_ref.view(torch.int32))
            unpack = pack.replace("pack", "unpack")
            assert torch.equal(getattr(ops, unpack)(q, float(s)),
                               getattr(ref, unpack + "_ref")(q, s))


@pytest.mark.parametrize("n", [1, 7, 127, 129, 1_000_003])
def test_topk_kernel_is_bit_exact(n, cuda):
    for x in _inputs(n, cuda):
        k = math.ceil(n / 8)
        i, v = ops.topk_select(x, k=k)
        i_ref, v_ref = ref.topk_select_ref(x, k=k)
        assert torch.equal(i, i_ref) and torch.equal(v, v_ref)


@pytest.mark.parametrize("codec", ["int8", "fp8", "topk"])
def test_card_and_cpu_put_the_same_bytes_on_the_wire(codec, cuda):
    x = _inputs(4099, cuda)[0].reshape(1, 4099)
    c = C.get_codec(codec)
    buf = c.encode(x)
    assert buf == c.encode(x.cpu())
    assert torch.equal(c.decode(buf, (1, 4099), torch.float32, cuda).cpu(),
                       c.decode(buf, (1, 4099), torch.float32, "cpu"))


def test_launches_are_counted(cuda):
    ops.reset_launch_counts()
    x = _inputs(1000, cuda)[0]
    C.roundtrip("int8", x)
    C.roundtrip("topk", x)
    counts = ops.launch_counts()
    assert counts["int8_pack"] == counts["int8_unpack"] == 1
    assert counts["topk_select"] == 1 and counts["fp8_pack"] == 0
