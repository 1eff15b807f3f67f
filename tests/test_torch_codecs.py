"""Wire-codec parity between the PyTorch port and the JAX reference.

The port's plain codec ops (the CPU path of ``repro_torch.kernels.ops``)
must reproduce the reference's Pallas kernels (run in interpret mode)
bit for bit — quantized bytes, scale bits, top-k indices — because the
wire carries those bytes: a frame packed by either package must decode
identically in the other.  The CUDA kernels are held to the same plain
versions on the card by ``test_torch_kernels_cuda.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codecs as RC
from repro.kernels import ops as rops
from repro.runtime import transport as RT
from repro_torch.core import codecs as C
from repro_torch.kernels import ops
from repro_torch.runtime import transport as T

# one intra-op thread: the suite runs in parallel worker processes,
# and torch's default of one thread per core oversubscribes the host
torch.set_num_threads(1)

# the reference's codec shapes (tests/test_codecs.py): 0-d, empty, odd
# sizes that do not fill a Pallas lane, multi-dim
SHAPES = [(), (0,), (1,), (7,), (127,), (128,), (129,), (3, 5, 7), (2, 1000)]
FLOAT_DTYPES = [np.float16, np.float32, np.float64]
LOSSY = ("int8", "fp8", "topk")


def _sample(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return np.asarray(rng.standard_normal(size=shape or ()) * 3.0,
                      dtype=dtype)


def _ties(n=4000, seed=5):
    """Few distinct magnitudes: top-k must break ties by lower index."""
    rng = np.random.default_rng(seed)
    return rng.integers(-3, 4, size=n).astype(np.float32)


def _nan(payload: int) -> np.float32:
    return np.array([payload], np.uint32).view(np.float32)[0]


# NaNs of rising payload at rising indices: top-k orders them by their
# bits, so k = 1 must pick the last, not the first
NAN_PAYLOADS = np.array([0.5, _nan(0x7FC00000), 1.0, _nan(0x7FC00001), -2.0,
                         _nan(0x7FC00002), 0.0, 3.0], np.float32)
# a NaN makes the scale NaN; an inf makes it inf and its own product NaN
PACK_SPECIALS = {"nan": np.array([1.0, np.nan, -2.0, 0.5], np.float32),
                 "inf": np.array([1.0, np.inf, -2.0, 0.5, -np.inf, -0.0],
                                 np.float32)}


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


# --------------------------------------------------------------------------- #
# plain ops vs the reference's Pallas kernels (interpret mode)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", FLOAT_DTYPES)
@pytest.mark.parametrize("shape", SHAPES + sorted(PACK_SPECIALS))
@pytest.mark.parametrize("pack", ["int8_pack", "fp8_pack"])
def test_plain_pack_is_bit_exact_with_reference(pack, shape, dtype):
    """``shape`` names a shape of seeded normal values, or one of
    ``PACK_SPECIALS`` (cast to ``dtype``)."""
    if isinstance(shape, str):
        x = PACK_SPECIALS[shape].astype(dtype)
    else:
        x = _sample(shape, dtype, seed=1)
    q_ref, s_ref = getattr(rops, pack)(jnp.asarray(x), interpret=True)
    q, s = getattr(ops, pack)(torch.from_numpy(x))
    assert np.asarray(q_ref).view(np.uint8).tobytes() == _bits(q)
    assert np.float32(s_ref).tobytes() == _bits(s)
    unpack = pack.replace("pack", "unpack")
    y_ref = np.asarray(getattr(rops, unpack)(q_ref, s_ref, interpret=True))
    y = getattr(ops, unpack)(q, s).numpy()
    # a NaN decodes to NaN in both, but its payload is the platform's
    # (numpy and torch widen the e4m3 NaN byte to different fp32 NaNs)
    nan = np.isnan(y_ref)
    assert np.array_equal(nan, np.isnan(y))
    assert y_ref[~nan].tobytes() == y[~nan].tobytes()


# inputs whose NaN payloads or signs the platforms treat differently: the
# reference's scale keeps the last NaN's payload (XLA's reduction order
# on this host), the port's is torch's NaN; a negative NaN's own product
# keeps its sign in one and not the other
NAN_WIRE = {
    "one payload": np.array([1.0, _nan(0x7FC00001), -2.0, 0.5], np.float32),
    "rising payloads": NAN_PAYLOADS,
    "falling payloads": np.array([_nan(0x7FC00003), 1.0, _nan(0x7FC00001),
                                  2.0], np.float32),
    "negative NaN": np.array([1.0, _nan(0xFFC00000), -2.0, 0.5,
                              _nan(0xFFC00005)], np.float32),
}


@pytest.mark.parametrize("case", sorted(NAN_WIRE))
@pytest.mark.parametrize("pack", ["int8_pack", "fp8_pack"])
def test_nan_payloads_on_the_wire_are_the_platforms(pack, case):
    """A NaN input's wire: the scale is NaN in both packages, every byte
    of a non-NaN input equals the reference's, and a NaN input's byte is
    an e4m3 NaN (0x7F or 0xFF, sign the platform's) in fp8 and 0 in int8.
    The payload and sign bits themselves are the platform's."""
    x = NAN_WIRE[case]
    q_ref, s_ref = getattr(rops, pack)(jnp.asarray(x), interpret=True)
    q, s = getattr(ops, pack)(torch.from_numpy(x))
    assert np.isnan(np.float32(s_ref)) and bool(torch.isnan(s))
    got = q.view(torch.uint8).numpy()
    want = np.asarray(q_ref).view(np.uint8)
    nan = np.isnan(x)
    assert nan.any() and np.array_equal(got[~nan], want[~nan])
    if pack == "int8_pack":
        assert not got[nan].any() and not want[nan].any()
    else:
        assert set(got[nan]) <= {0x7F, 0xFF} and set(want[nan]) <= {0x7F,
                                                                    0xFF}


@pytest.mark.parametrize("case", ["normal", "ties", "fp16", "fp64",
                                  "nan_payload"])
def test_plain_topk_is_bit_exact_with_reference(case):
    x = {"normal": _sample((2, 1000), np.float32, seed=3),
         "ties": _ties(),
         "fp16": _sample((3, 5, 7), np.float16, seed=4),
         "fp64": _sample((129,), np.float64, seed=6),
         "nan_payload": NAN_PAYLOADS}[case]
    k = 1 if case == "nan_payload" else math.ceil(x.size / 8)
    i_ref, v_ref = rops.topk_select(jnp.asarray(x), k=k, interpret=True)
    i, v = ops.topk_select(torch.from_numpy(x), k=k)
    assert np.array_equal(np.asarray(i_ref), i.numpy().astype(np.uint32))
    assert np.asarray(v_ref).tobytes() == _bits(v)


def test_plain_versions_follow_the_kernel_not_the_reference_ref():
    """The reference's ``kernels/ref.py`` divides by the scale; its
    kernel (and so its wire) multiplies by the reciprocal.  Find an input
    where the two differ and check the port sides with the kernel."""
    # scale = 3 * fp32(1/127); x / scale sits on a rounding half where
    # x * (1 / scale) lands one ulp lower: the two give -119 and -118
    x = np.array([3.0, -2.799212694168091], np.float32)
    flat = torch.from_numpy(x)
    s = flat.abs().amax() * (1.0 / 127.0)
    by_div = torch.round(flat / s).clamp(-127, 127).to(torch.int8)
    by_mul = torch.round(flat * (1.0 / s)).clamp(-127, 127).to(torch.int8)
    assert not torch.equal(by_div, by_mul)
    q_ref, _ = rops.int8_pack(jnp.asarray(x), interpret=True)
    q, _ = ops.int8_pack(flat)
    assert np.array_equal(np.asarray(q_ref), q.numpy())
    assert torch.equal(q, by_mul) and not torch.equal(q, by_div)


# --------------------------------------------------------------------------- #
# the wire: bytes, both directions, byte model, frames
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("shape,dtype",
                         [(s, np.float32) for s in SHAPES if math.prod(s)]
                         + [((3, 5, 7), np.float16), ((3, 5, 7), np.float64)])
@pytest.mark.parametrize("codec", LOSSY)
def test_encode_bytes_identical_across_packages(codec, shape, dtype):
    x = _sample(shape, dtype, seed=7)
    assert C.get_codec(codec).encode(torch.from_numpy(x)) \
        == RC.get_codec(codec).encode(x)


@pytest.mark.parametrize("codec", ("none",) + LOSSY)
def test_bytes_decode_across_packages_both_ways(codec):
    x = _sample((2, 1000), np.float32, seed=8)
    tc, rc = C.get_codec(codec), RC.get_codec(codec)
    from_ref = tc.decode(rc.encode(x), x.shape, torch.float32, "cpu")
    from_port = rc.decode(tc.encode(torch.from_numpy(x)), x.shape,
                          np.dtype(np.float32))
    expect = np.asarray(rc.decode(rc.encode(x), x.shape,
                                  np.dtype(np.float32)))
    assert _bits(from_ref) == expect.tobytes()
    assert np.asarray(from_port).tobytes() == expect.tobytes()
    assert from_ref.shape == x.shape and from_ref.dtype == torch.float32


@pytest.mark.parametrize("codec", ("none",) + LOSSY)
def test_wire_byte_model_equal(codec):
    for n in (1, 7, 128, 129, 4096, 602112):
        for itemsize in (2, 4, 8):
            assert C.get_codec(codec).wire_bytes(n, itemsize) \
                == RC.get_codec(codec).wire_bytes(n, itemsize)
            assert C.codec_wire_bytes(codec, n * itemsize, itemsize) \
                == RC.codec_wire_bytes(codec, n * itemsize, itemsize)


@pytest.mark.parametrize("codec", ("none",) + LOSSY)
def test_frame_fields_match_reference(codec):
    x = _sample((3, 5, 7), np.float32, seed=9)
    got = T._frame(torch.from_numpy(x), "raw", C.get_codec(codec))
    want = RT._frame(x, "raw", RC.get_codec(codec))
    ftype, code, shape, buf, meta, ccode = got
    assert (ftype, code, shape, bytes(buf), meta, ccode) \
        == (want[0], want[1], want[2], bytes(want[3]), want[4], want[5])
    # the reference's frame unframes in the port and the reverse
    y = T._unframe(want[0], want[1], want[2], bytes(want[3]), want[4],
                   want[5], "cpu")
    y_ref = RT._unframe(ftype, code, shape, bytes(buf), meta, ccode)
    assert _bits(y) == np.asarray(y_ref).tobytes()


def test_frame_passes_non_float_and_tokens_uncoded():
    xi = np.arange(12, dtype=np.int32).reshape(3, 4)
    got = T._frame(torch.from_numpy(xi), "raw", C.get_codec("int8"))
    want = RT._frame(xi, "raw", RC.get_codec("int8"))
    assert got[:3] == want[:3] and bytes(got[3]) == bytes(want[3])
    assert got[5] == want[5] == 0
    assert T._frame(None, "raw") == (T._F_EMPTY, 0, (), b"", b"", 0)
    ftype, *_ = T._frame({"bounds": (0, 2, 5)}, "raw")
    assert ftype == T._F_OBJ


def test_serializer_reads_the_reference_pickle():
    x = _sample((4, 6), np.float32, seed=10)
    y = T._Serializer.loads(RT._Serializer.dumps(x), "cpu")
    assert _bits(y) == x.tobytes() and tuple(y.shape) == x.shape
    back = RT._Serializer.loads(T._Serializer.dumps(torch.from_numpy(x)))
    assert np.array_equal(back, x)


def test_codec_registry_matches_manifest():
    for name, code in (("none", 0), ("int8", 1), ("fp8", 2), ("topk", 3)):
        assert C.get_codec(name).code == code == RC.get_codec(name).code
        assert C.codec_for_code(code).name == name
    assert not C.get_codec("int8").supports(torch.int32)
    assert C.get_codec("fp8").supports(torch.bfloat16)


def test_calibrate_codecs_runs_on_the_port_model():
    from repro_torch.models.cnn.layers import (Conv2D, Flatten, Linear,
                                               Sequential)
    from repro_torch.models.cnn.zoo import CNNModel
    m = CNNModel("mini", [("c", Conv2D(3, 4, 3, 1, 1)),
                          ("head", Sequential([Flatten(),
                                               Linear(8 * 8 * 4, 5)]))],
                 input_hw=8).init(torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(_sample((4, 8, 8, 3), np.float32, seed=11))
    cal = C.calibrate_codecs(m, x)
    for name in LOSSY:
        assert 0.0 <= cal.accuracy(1, name) <= 1.0
        assert cal.max_abs_err(1, name) >= 0.0
    assert cal.accuracy(1, "none") == 1.0
