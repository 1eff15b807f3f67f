"""Python side of the CUDA wire-codec kernels (``csrc/codec_pack.cu``).

The five kernels replace the reference's Pallas pack/unpack kernels
(``src/repro/kernels/codec_pack.py``).  They are compiled with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, at the
first call that hands them a CUDA tensor, and bound through ``ctypes``
(no PyTorch headers, so the build takes seconds).  Importing this module
needs neither ``nvcc`` nor a card.

Each wrapper takes CUDA tensors only, checks device, dtype and
contiguity, allocates its outputs with ``torch.empty``, launches on
``torch.cuda.current_stream()`` without synchronising, and raises if the
launch was refused.  ``ops`` routes CPU tensors to ``ref`` instead.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "codec_pack.cu"
BUILD_DIR = Path(__file__).resolve().parent / "build"
LIBRARY = BUILD_DIR / "libcodec_pack.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: building the codec kernels needs "
                           "the CUDA toolkit")
    return found


def build(force: bool = False) -> Path:
    """Compile ``codec_pack.cu`` unless an up-to-date library exists;
    → the library's path.  The compiler's output is kept in
    ``build/nvcc.log`` beside the library."""
    if (not force and LIBRARY.exists()
            and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime):
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    (BUILD_DIR / "nvcc.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn in ("codec_int8_pack", "codec_fp8_pack"):
                getattr(lib, fn).argtypes = [_P, ctypes.c_int64, _P, _P, _P]
            for fn in ("codec_int8_unpack", "codec_fp8_unpack"):
                getattr(lib, fn).argtypes = [_P, ctypes.c_float, _P,
                                             ctypes.c_int64, _P]
            lib.codec_topk_keys.argtypes = [_P, ctypes.c_int64, _P, _P]
            for fn in ("codec_int8_pack", "codec_fp8_pack",
                       "codec_int8_unpack", "codec_fp8_unpack",
                       "codec_topk_keys"):
                getattr(lib, fn).restype = ctypes.c_int
            lib.codec_error_string.argtypes = [ctypes.c_int]
            lib.codec_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what}: the CUDA kernel needs a CUDA tensor, got "
                         f"one on {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _launch(fn: str, t: torch.Tensor, *args) -> None:
    lib = library()
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = getattr(lib, fn)(*args, _P(stream))
    if err:
        raise RuntimeError(f"{fn}: CUDA error {err}: "
                           f"{lib.codec_error_string(err).decode()}")


def _flat32(x: torch.Tensor, what: str) -> torch.Tensor:
    if not x.is_cuda:
        raise ValueError(f"{what}: the CUDA kernel needs a CUDA tensor, got "
                         f"one on {x.device}")
    if not x.is_floating_point():
        raise TypeError(f"{what}: expected a float tensor, got {x.dtype}")
    return x.reshape(-1).to(torch.float32).contiguous()


def _pack(fn: str, x: torch.Tensor, qdtype: torch.dtype
          ) -> tuple[torch.Tensor, torch.Tensor]:
    flat = _flat32(x, fn)
    q = torch.empty(flat.numel(), dtype=qdtype, device=flat.device)
    aux = torch.empty(2, dtype=torch.float32, device=flat.device)
    _launch(fn, flat, _P(flat.data_ptr()), flat.numel(), _P(q.data_ptr()),
            _P(aux.data_ptr()))
    return q, aux[1]


def int8_pack(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA float tensor (n >= 1) → (int8 flat[n], fp32 scale)."""
    return _pack("codec_int8_pack", x, torch.int8)


def fp8_pack(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA float tensor (n >= 1) → (float8_e4m3fn flat[n], fp32 scale)."""
    return _pack("codec_fp8_pack", x, torch.float8_e4m3fn)


def _unpack(fn: str, q: torch.Tensor, qdtype: torch.dtype,
            scale: float) -> torch.Tensor:
    _check(q, qdtype, fn)
    out = torch.empty(q.numel(), dtype=torch.float32, device=q.device)
    _launch(fn, q, _P(q.data_ptr()), float(scale), _P(out.data_ptr()),
            q.numel())
    return out


def int8_unpack(q: torch.Tensor, scale: float) -> torch.Tensor:
    """(CUDA int8 flat[n], scale) → fp32 flat[n] = q * scale."""
    return _unpack("codec_int8_unpack", q, torch.int8, scale)


def fp8_unpack(q: torch.Tensor, scale: float) -> torch.Tensor:
    """(CUDA float8_e4m3fn flat[n], scale) → fp32 flat[n] = q * scale."""
    return _unpack("codec_fp8_unpack", q, torch.float8_e4m3fn, scale)


def topk_keys(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel half of ``topk_select``: → (fp32 flat[n], int64
    keys[n]), key = bits(|x|) << 32 | (0xFFFFFFFF - i)."""
    flat = _flat32(x, "codec_topk_keys")
    if flat.numel() >= 2 ** 31:
        raise ValueError("topk_select: the wire's uint32 indices need "
                         "fewer than 2**31 elements")
    keys = torch.empty(flat.numel(), dtype=torch.int64, device=flat.device)
    _launch("codec_topk_keys", flat, _P(flat.data_ptr()), flat.numel(),
            _P(keys.data_ptr()))
    return flat, keys


def topk_select(x: torch.Tensor, *, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """k largest-|x| entries, ties to the lower index → (int32 indices
    ascending — the wire's uint32 bits, fp32 values).  The key pass is
    the kernel; the selection is ``torch.topk`` over the unique keys and
    an index sort, where the reference ran ``lax.top_k`` outside Pallas."""
    flat, keys = topk_keys(x)
    top = torch.topk(keys, k, sorted=False).values
    idx = torch.sort(0xFFFFFFFF - (top & 0xFFFFFFFF)).values
    return idx.to(torch.int32), flat[idx]
