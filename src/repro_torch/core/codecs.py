"""Per-hop wire codecs: registry, analytic byte model, calibration.

A ``Codec`` is a lossy (or identity) transform applied to activation
payloads at a hop, declared per hop the way ``Scenario.transports``
declares backends.  The same object serves three layers:

  * **runtime** — ``encode`` runs the pack kernel (``kernels/ops.py``)
    on the tensor's own device, so only the packed bytes come back to
    the host; ``decode`` copies the packed bytes to the target device
    and runs the unpack kernel there.  The transport calls them from
    ``_frame``/``_unframe`` and ships the packed payload with the
    codec's wire code in the frame header;
  * **analytic** — ``wire_bytes`` predicts the packed payload size
    exactly (header + packed elements), so the partitioner's predicted
    hop bytes agree with the measured ``TransferRecord.wire_bytes``;
  * **accuracy** — a calibration pass (``calibrate_codecs``) measures
    per-cut per-codec output degradation (top-1 agreement and
    max-abs-err on a held batch) for the cost model's fourth Pareto
    axis; ``nominal_accuracy`` is the placeholder used when no
    calibration is supplied.

Wire layouts (little-endian, shared by encode/decode/wire_bytes, and
byte-identical with the JAX reference package):

  ===========  =====================================================
  ``none``     raw bytes, unchanged (codec byte 0 on the wire)
  ``int8``     4 B fp32 scale + n × int8            (≈4× for fp32)
  ``fp8``      4 B fp32 scale + n × float8_e4m3fn   (≈4× for fp32)
  ``topk``     8 B header (uint32 k, reserved) + k × uint32 index +
               k × fp32 value, k = ⌈n/8⌉            (≈4× for fp32)
  ===========  =====================================================

Codecs apply to float tensors only (``supports``); everything else —
control tokens, integer tensors, empty payloads — passes through
unchanged with codec byte 0, which is also why the ``none`` codec is
bit-exact with pre-codec framing.
"""
from __future__ import annotations

import math
import struct
from dataclasses import dataclass
from typing import Mapping, Sequence

import torch

_FLOAT_DTYPES = frozenset({torch.float16, torch.float32, torch.float64,
                           torch.bfloat16})
_SCALE = struct.Struct("<f")
_TOPK_HDR = struct.Struct("<II")


def host_bytes(*parts: torch.Tensor) -> bytes:
    """The tensors' bytes, concatenated in order, as one host buffer.
    Device tensors are joined on the device first, so a packed frame
    costs one device-to-host copy."""
    flat = [p.detach().contiguous().reshape(-1).view(torch.uint8)
            for p in parts]
    joined = flat[0] if len(flat) == 1 else torch.cat(flat)
    return joined.cpu().numpy().tobytes()


def device_bytes(buf, device) -> torch.Tensor:
    """A received buffer as a uint8 tensor on ``device``.  For the CPU,
    one host copy into torch-owned memory (the buffer is reused after
    the call).  For another device, one synchronous host-to-device copy
    that reads the buffer where it lies (a socket's receive buffer, a
    shmem slot); a read-only buffer is copied into writable memory
    first."""
    device = torch.device(device)
    view = memoryview(buf)
    if device.type == "cpu" or view.readonly:
        return torch.frombuffer(bytearray(view), dtype=torch.uint8).to(device)
    return torch.frombuffer(view, dtype=torch.uint8).to(device)


class Codec:
    """Identity codec (``none``): payload bytes untouched."""

    name: str = "none"
    code: int = 0              # wire byte; 0 = uncoded (append-only space)
    # output degradation assumed when no calibration measured it — the
    # identity codec is exact, lossy subclasses override
    nominal_accuracy: float = 1.0
    # each row of a batch crosses the hop as it would alone; the lossy
    # codecs couple rows (one abs-max scale a tensor, one global top-k)
    row_local: bool = True

    def supports(self, dtype: torch.dtype) -> bool:
        return True

    def wire_bytes(self, n_elems: int, itemsize: int = 4) -> int:
        """Packed payload size for ``n_elems`` elements of ``itemsize``."""
        return int(n_elems) * int(itemsize)

    def encode(self, t: torch.Tensor) -> bytes:
        return host_bytes(t)

    def decode(self, buf, shape: tuple, dtype: torch.dtype,
               device) -> torch.Tensor:
        if not len(buf):
            return torch.empty(shape, dtype=dtype, device=device)
        return device_bytes(buf, device).view(dtype).reshape(shape)


class _LossyCodec(Codec):
    """Shared float-only gate + fp32 staging for the lossy codecs."""

    row_local = False

    def supports(self, dtype: torch.dtype) -> bool:
        return dtype in _FLOAT_DTYPES

    @staticmethod
    def _restore(flat: torch.Tensor, shape: tuple, dtype: torch.dtype):
        out = flat.reshape(shape)
        return out if dtype == out.dtype else out.to(dtype)


class Int8Codec(_LossyCodec):
    """Symmetric per-tensor int8: 4 B scale header + one byte/element."""

    name = "int8"
    code = 1
    nominal_accuracy = 0.99

    def wire_bytes(self, n_elems: int, itemsize: int = 4) -> int:
        return _SCALE.size + int(n_elems)

    def encode(self, t: torch.Tensor) -> bytes:
        from ..kernels import ops
        q, scale = ops.int8_pack(t)
        return host_bytes(scale, q)

    def decode(self, buf, shape: tuple, dtype: torch.dtype,
               device) -> torch.Tensor:
        from ..kernels import ops
        scale = _SCALE.unpack_from(buf)[0]
        q = device_bytes(buf, device)[_SCALE.size:].view(torch.int8)
        return self._restore(ops.int8_unpack(q, scale), shape, dtype)


class Fp8Codec(_LossyCodec):
    """Scaled e4m3 cast: 4 B scale header + one byte/element (~3 bit
    mantissa keeps relative error where int8 keeps absolute error)."""

    name = "fp8"
    code = 2
    nominal_accuracy = 0.995

    def wire_bytes(self, n_elems: int, itemsize: int = 4) -> int:
        return _SCALE.size + int(n_elems)

    def encode(self, t: torch.Tensor) -> bytes:
        from ..kernels import ops
        q, scale = ops.fp8_pack(t)
        return host_bytes(scale, q)

    def decode(self, buf, shape: tuple, dtype: torch.dtype,
               device) -> torch.Tensor:
        from ..kernels import ops
        scale = _SCALE.unpack_from(buf)[0]
        q = device_bytes(buf, device)[_SCALE.size:].view(torch.float8_e4m3fn)
        return self._restore(ops.fp8_unpack(q, scale), shape, dtype)


class TopKCodec(_LossyCodec):
    """Magnitude top-k sparsification with packed uint32 indices; the
    dropped (1 - 1/density) tail decodes to zeros."""

    name = "topk"
    code = 3
    nominal_accuracy = 0.97
    density = 8                # keep 1 in `density` elements

    def _k(self, n_elems: int) -> int:
        return max(1, math.ceil(int(n_elems) / self.density))

    def wire_bytes(self, n_elems: int, itemsize: int = 4) -> int:
        return _TOPK_HDR.size + 8 * self._k(n_elems)

    def encode(self, t: torch.Tensor) -> bytes:
        from ..kernels import ops
        k = self._k(t.numel())
        idx, vals = ops.topk_select(t, k=k)
        return _TOPK_HDR.pack(k, 0) + host_bytes(idx, vals)

    def decode(self, buf, shape: tuple, dtype: torch.dtype,
               device) -> torch.Tensor:
        k = _TOPK_HDR.unpack_from(buf)[0]
        off = _TOPK_HDR.size
        body = device_bytes(memoryview(buf)[off:off + 8 * k], device)
        # uint32 on the wire; every index is < 2**31 (ops.topk_select
        # refuses larger tensors), so the int32 view reads it exactly
        idx = body[:4 * k].view(torch.int32).long()
        vals = body[4 * k:].view(torch.float32)
        flat = torch.zeros(math.prod(shape), dtype=torch.float32,
                           device=device)
        flat[idx] = vals
        return self._restore(flat, shape, dtype)


CODECS: dict[str, Codec] = {}
_BY_CODE: dict[int, Codec] = {}


def register_codec(codec: Codec) -> None:
    """Register a codec instance under its ``name`` and wire ``code``.
    Wire codes are append-only protocol space: reusing a live code or
    code 0 (uncoded) would misdecode in-flight frames."""
    if codec.code in _BY_CODE and _BY_CODE[codec.code].name != codec.name:
        raise ValueError(f"wire code {codec.code} already taken by "
                         f"{_BY_CODE[codec.code].name!r}")
    CODECS[codec.name] = codec
    _BY_CODE[codec.code] = codec


for _c in (Codec(), Int8Codec(), Fp8Codec(), TopKCodec()):
    register_codec(_c)


def get_codec(name: str | Codec | None) -> Codec:
    if isinstance(name, Codec):
        return name
    try:
        return CODECS[name or "none"]
    except KeyError:
        raise KeyError(f"unknown codec {name!r}; have "
                       f"{sorted(CODECS)}") from None


def codec_for_code(code: int) -> Codec:
    try:
        return _BY_CODE[code]
    except KeyError:
        raise KeyError(f"unknown codec wire code {code}") from None


def codec_wire_bytes(codec: str | Codec | None, raw_bytes: float,
                     itemsize: int = 4) -> float:
    """Analytic packed size for a raw payload of ``raw_bytes`` — the
    cost model's Link-bytes credit, exact against the runtime framing."""
    c = get_codec(codec)
    if c.code == 0 or raw_bytes <= 0:
        return raw_bytes
    return float(c.wire_bytes(int(raw_bytes) // itemsize, itemsize))


def quantized_wire_bytes(n_elems: int, bits: int = 8) -> int:
    """Wire bytes for one symmetrically-quantized tensor: scale header
    + ceil(n·bits/8) packed element bytes."""
    return _SCALE.size + -(-int(n_elems) * bits // 8)


# --------------------------------------------------------------------------- #
# Accuracy calibration — degradation per (cut, codec) on a held batch
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class CodecAccuracy:
    """Measured output degradation for one (cut, codec) pair."""

    top1_agreement: float      # fraction of held batch keeping its argmax
    max_abs_err: float         # worst output-logit perturbation


@dataclass(frozen=True)
class CodecCalibration:
    """Per-cut per-codec degradation table for one model/input shape.
    ``accuracy`` is what the cost model multiplies per hop; unmeasured
    pairs fall back to the codec's ``nominal_accuracy``."""

    table: Mapping[tuple[int, str], CodecAccuracy]

    def accuracy(self, cut: int, codec: str | Codec | None) -> float:
        c = get_codec(codec)
        if c.code == 0:
            return 1.0
        entry = self.table.get((int(cut), c.name))
        return entry.top1_agreement if entry is not None \
            else c.nominal_accuracy

    def max_abs_err(self, cut: int, codec: str | Codec | None) -> float:
        c = get_codec(codec)
        if c.code == 0:
            return 0.0
        entry = self.table.get((int(cut), c.name))
        return entry.max_abs_err if entry is not None else float("nan")


def nominal_accuracy(codec: str | Codec | None) -> float:
    return get_codec(codec).nominal_accuracy


def roundtrip(codec: str | Codec, t: torch.Tensor) -> torch.Tensor:
    """Encode→decode through the exact wire transform (calibration and
    tests measure what the transport will actually do to the tensor);
    the result lands on ``t``'s device."""
    c = get_codec(codec)
    if c.code == 0 or not t.numel() or not c.supports(t.dtype):
        return t
    return c.decode(c.encode(t), tuple(t.shape), t.dtype, t.device)


@torch.no_grad()
def calibrate_codecs(model, x: torch.Tensor,
                     codecs: Sequence[str] = ("int8", "fp8", "topk"),
                     cuts: Sequence[int] | None = None) -> CodecCalibration:
    """Measure per-cut per-codec output degradation on a held batch.

    ``model`` needs the ``CNNModel`` surface: ``apply_range(a, lo, hi)``
    plus ``blocks``.  For every cut the clean activation is round-tripped
    through each codec's wire transform and the remainder of the network
    is re-run; degradation is scored as top-1 agreement with the clean
    output plus the worst output perturbation.
    """
    n = len(model.blocks)
    cuts = tuple(cuts) if cuts is not None else tuple(range(1, n))
    acts = {0: x}
    a = x
    for b in range(n):
        a = model.apply_range(a, b, b + 1)
        acts[b + 1] = a
    clean = acts[n]
    base = clean.reshape(clean.shape[0], -1).argmax(dim=-1)

    table: dict[tuple[int, str], CodecAccuracy] = {}
    for cut in cuts:
        act = acts[cut]
        for name in codecs:
            c = get_codec(name)
            if c.code == 0:
                table[(cut, c.name)] = CodecAccuracy(1.0, 0.0)
                continue
            out = model.apply_range(roundtrip(c, act), cut, n)
            top1 = out.reshape(out.shape[0], -1).argmax(dim=-1)
            table[(cut, c.name)] = CodecAccuracy(
                top1_agreement=float((top1 == base).float().mean()),
                max_abs_err=float((out - clean).abs().max()),
            )
    return CodecCalibration(table)
