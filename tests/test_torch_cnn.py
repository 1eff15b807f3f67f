"""CNN parity between the PyTorch port and the JAX reference.

The analytic side (``param_count``, ``block_graph``) must be identical
for all six zoo models, since the partitioner plans from it.  The
numeric side loads the reference's weights into the port
(``from_reference``) and compares every block's output on the same
input.  Tolerance rtol 1e-4, atol 1e-5: both compute in fp32, but
convolution and matmul sums run in a different order (XLA:CPU against
oneDNN), and rsqrt may differ in its last bits.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.models.cnn import layers as RL
from repro.models.cnn import zoo as RZ
from repro_torch.models.cnn import layers as L
from repro_torch.models.cnn import zoo as Z

# one intra-op thread: the suite runs in parallel worker processes,
# and torch's default of one thread per core oversubscribes the host
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _ref_params(model, seed=0):
    """Seeded numpy weights in the reference's param pytree (shapes from
    ``jax.eval_shape`` of its ``init``, so no PRNG kernels compile):
    fan-in-scaled weights and non-trivial BN statistics."""
    rng = np.random.default_rng(seed)

    def leaf(path, spec):
        name = path[-1].key
        z = rng.standard_normal(spec.shape).astype(np.float32)
        if name == "w":
            return z / np.float32(math.sqrt(math.prod(spec.shape[:-1])))
        if name == "scale":
            return 1.0 + 0.1 * z
        if name == "var":
            return 1.0 + 0.1 * np.abs(z)
        return 0.1 * z                          # conv/linear b, BN bias/mean

    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _tiny(lib, zoo):
    """The reference tests' 5-block fixture (tests/test_session.py)."""
    blocks = [
        ("conv0", lib.Sequential([lib.Conv2D(3, 8, 3, 1, 1), lib.ReLU()])),
        ("conv1", lib.Sequential([lib.Conv2D(8, 8, 3, 1, 1), lib.ReLU()])),
        ("pool", lib.Pool("max", 2, 2)),
        ("conv2", lib.Sequential([lib.Conv2D(8, 16, 3, 1, 1), lib.ReLU()])),
        ("head", lib.Sequential([lib.Flatten(), lib.Linear(16 * 16 * 16, 10)])),
    ]
    return zoo.CNNModel("tinycnn", blocks, input_hw=32)


@pytest.mark.parametrize("name", sorted(RZ.ZOO))
def test_param_count_and_block_graph_match(name):
    ref, port = RZ.get(name), Z.get(name)
    assert port.param_count() == ref.param_count()
    assert [n for n, _ in port.blocks] == [n for n, _ in ref.blocks]
    for hw in (None, 64):
        assert dataclasses.asdict(port.block_graph(hw)) \
            == dataclasses.asdict(ref.block_graph(hw))
    assert port.out_shape(2) == ref.out_shape(2)


@pytest.mark.parametrize("name,hw", [("tinycnn", 32), ("mobilenetv2", 64),
                                     ("resnet50", 64)])
def test_apply_range_matches_reference_per_block(name, hw):
    if name == "tinycnn":
        ref, port = _tiny(RL, RZ), _tiny(L, Z)
    else:
        ref, port = RZ.get(name), Z.get(name)
    params = _ref_params(ref, seed=3)
    port.from_reference(params)
    a = _x((2, hw, hw, 3), seed=1)
    for b in range(len(ref.blocks)):
        block = jax.jit(lambda p, x, b=b: ref.apply_range(p, x, b, b + 1))
        want = np.asarray(block(params, a))
        got = port.apply_range(torch.tensor(a), b, b + 1)
        assert tuple(got.shape) == want.shape, ref.blocks[b][0]
        _close(got, want)
        a = want
    # and end to end, through the port's whole-model entry point
    x = _x((2, hw, hw, 3), seed=2)
    _close(port.apply(torch.from_numpy(x)), jax.jit(ref.apply)(params, x))


def _layer_pair(make, in_shape, seed=0):
    ref, port = make(RL), make(L)
    p = _ref_params(ref, seed)
    port.load_reference(p)
    x = _x(in_shape, seed=seed + 1)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    want = ref.apply(p, x)
    assert tuple(got.shape) == ref.out_shape(in_shape) == np.shape(want)
    _close(got, want)
    assert port.param_count() == ref.param_count()
    assert port.flops(in_shape) == ref.flops(in_shape)


LAYERS = {
    "grouped_conv": (lambda lib: lib.Conv2D(8, 12, 3, 2, 1, groups=4),
                     (2, 9, 9, 8)),
    "depthwise_conv": (lambda lib: lib.Conv2D(6, 6, (1, 3), 1, (0, 1),
                                              groups=6, bias=False),
                       (1, 5, 7, 6)),
    "same_conv": (lambda lib: lib.Conv2D(3, 4, 3, 2, "SAME"), (2, 9, 8, 3)),
    "bn": (lambda lib: lib.BatchNorm(5), (2, 3, 3, 5)),
    "relu6": (lambda lib: lib.ReLU(cap=6.0), (2, 4, 4, 3)),
    "max_pool_padded": (lambda lib: lib.Pool("max", 3, 2, 1), (2, 9, 9, 4)),
    "avg_pool_padded": (lambda lib: lib.Pool("avg", 3, 1, 1), (2, 7, 7, 4)),
    "adaptive_nondivisible": (lambda lib: lib.AdaptiveAvgPool((3, 2)),
                              (2, 7, 5, 3)),
    "adaptive_upsample": (lambda lib: lib.AdaptiveAvgPool(6), (1, 4, 4, 2)),
    "adaptive_global": (lambda lib: lib.AdaptiveAvgPool(1), (2, 5, 5, 3)),
    "parallel": (lambda lib: lib.Parallel([
        lib.conv_bn_relu(4, 3, 1),
        lib.Sequential([lib.Pool("avg", 3, 1, 1), lib.Conv2D(4, 2, 1)]),
        lib.Pool("max", 3, 1, 1)]), (2, 6, 6, 4)),
    "flatten_linear": (lambda lib: lib.Sequential([
        lib.AdaptiveAvgPool(3), lib.Flatten(), lib.Linear(3 * 3 * 5, 7)]),
        (2, 6, 6, 5)),
    "residual_projection": (lambda lib: lib.Residual(
        lib.Sequential([lib.Conv2D(4, 8, 3, 2, 1, bias=False),
                        lib.BatchNorm(8)]),
        lib.Sequential([lib.Conv2D(4, 8, 1, 2, bias=False),
                        lib.BatchNorm(8)])), (2, 8, 8, 4)),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layer_matches_reference(case):
    make, shape = LAYERS[case]
    _layer_pair(make, shape)


def test_flatten_keeps_nhwc_order():
    x = torch.arange(2 * 2 * 3 * 4, dtype=torch.float32).reshape(2, 2, 3, 4)
    flat = L.Flatten()(x)
    want = np.asarray(RL.Flatten().apply({}, x.numpy()))
    assert np.array_equal(flat.numpy(), want)


def test_pool_ignores_ceil_mode_like_the_reference():
    """``Pool.apply`` ignores ``ceil_mode`` (only ``out_shape`` honours
    it); the port mirrors the reference's computation."""
    x = _x((1, 6, 6, 2))
    ref, port = RL.Pool("max", 3, 2, 0, ceil_mode=True), \
        L.Pool("max", 3, 2, 0, ceil_mode=True)
    want = np.asarray(ref.apply({}, x))
    _close(port(torch.from_numpy(x)), want)
    assert port.out_shape(x.shape) == ref.out_shape(x.shape) == (1, 3, 3, 2)
    assert want.shape == (1, 2, 2, 2)


def test_init_is_seeded_and_device_explicit():
    a = Z.get("mobilenetv2").init(torch.Generator().manual_seed(0), "cpu")
    b = Z.get("mobilenetv2").init(torch.Generator().manual_seed(0), "cpu")
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert a.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Z.get("resnet18").init(torch.Generator().manual_seed(0))
