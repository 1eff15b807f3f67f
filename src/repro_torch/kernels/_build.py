"""Build and bind the port's CUDA sources (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at the first call that hands one of
its kernels a CUDA tensor, and bound through ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries go to the git-ignored
``kernels/build/``; the compiler's output is kept beside each as
``<name>.nvcc.log``.  A build holds an exclusive ``flock`` on
``<name>.lock`` there, so pipeline stages in several processes that
reach an unbuilt library at once run one ``nvcc`` between them.
Importing this module needs neither ``nvcc`` nor a card.

Every entry point of a source takes its pointers and the stream as
``c_void_p``, returns ``cudaGetLastError()`` as an ``int``, and
``launch`` raises on a non-zero code.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_int64
F32 = ctypes.c_float


@contextlib.contextmanager
def _file_lock(path: Path):
    """Hold an exclusive ``flock`` on ``path`` (released when the
    holder exits, even killed, so a stale lock file never blocks)."""
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit")
    return found


class KernelLibrary:
    """One ``csrc/<name>.cu`` and the shared library built from it.

    ``functions`` maps each C entry point to its argument types, the
    trailing stream excluded; ``error_fn`` names the entry point that
    turns a CUDA error code into its message."""

    def __init__(self, name: str, functions: dict[str, list],
                 error_fn: str):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.path = BUILD_DIR / f"lib{name}.so"
        self.log = BUILD_DIR / f"{name}.nvcc.log"
        self.lock = BUILD_DIR / f"{name}.lock"
        self.functions = functions
        self.error_fn = error_fn
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None

    def build(self, force: bool = False) -> Path:
        """Compile the source unless an up-to-date library exists;
        → the library's path.  Threads of one process wait on a lock,
        processes on the file lock; a waiter that finds the library
        built meanwhile does not build it again."""
        with self._lock:
            if not force and self._fresh():
                return self.path
            self.lock.parent.mkdir(parents=True, exist_ok=True)
            with _file_lock(self.lock):
                if not force and self._fresh():
                    return self.path
                return self._compile()

    def _fresh(self) -> bool:
        return (self.path.exists() and self.path.stat().st_mtime
                >= self.source.stat().st_mtime)

    def _compile(self) -> Path:
        """Run nvcc into a temporary file, then move it into place."""
        tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        self.log.write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, self.path)
        return self.path

    def library(self) -> ctypes.CDLL:
        """The loaded library, built on first use."""
        if self._lib is None:
            path = self.build()
            with self._lock:
                if self._lib is None:
                    lib = ctypes.CDLL(str(path))
                    for fn, argtypes in self.functions.items():
                        getattr(lib, fn).argtypes = [*argtypes, P]
                        getattr(lib, fn).restype = I32
                    err = getattr(lib, self.error_fn)
                    err.argtypes = [I32]
                    err.restype = ctypes.c_char_p
                    self._lib = lib
        return self._lib

    def launch(self, fn: str, device: torch.device, *args) -> None:
        """Call entry point ``fn`` on ``device``'s current stream (no
        synchronisation); raise if the launch was refused."""
        lib = self.library()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(lib, fn)(*args, P(stream))
        if err:
            msg = getattr(lib, self.error_fn)(err).decode()
            raise RuntimeError(f"{fn}: CUDA error {err}: {msg}")


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on a CUDA device (checked before
    anything is built, so no ``nvcc`` is needed to see the refusal)."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{what}: the CUDA kernel needs a CUDA tensor, "
                             f"got one on {t.device}")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with its data 16-byte aligned, as the kernels'
    16-byte loads need (a view that starts mid-allocation is copied)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


CODEC_PACK = KernelLibrary("codec_pack", {
    # x, n, q, aux, aux words, forced grid (0: the kernel picks)
    "codec_int8_pack": [P, I64, P, P, I64, I32],
    "codec_fp8_pack": [P, I64, P, P, I64, I32],
    "codec_int8_unpack": [P, F32, P, I64],
    "codec_fp8_unpack": [P, F32, P, I64],
    # x, n, k, indices, values, scratch, scratch words, forced grid
    "codec_topk_select": [P, I64, I64, P, P, P, I64, I32],
}, error_fn="codec_error_string")

# dtype codes of lm_kernels.cu's and ssm_scan.cu's entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LM_KERNELS = KernelLibrary("lm_kernels", {
    # q, k, v, out, B, S, T, H, KV, hd, causal, scale: bf16 on the tensor
    # cores, fp32 on the FMA kernel
    "lm_flash_attention_bf16": [P, P, P, P, I32, I32, I32, I32, I32, I32,
                                I32, F32],
    "lm_flash_attention_f32": [P, P, P, P, I32, I32, I32, I32, I32, I32,
                               I32, F32],
    # q, k_cache, v_cache, out, part_o, part_ml, B, H, KV, Smax, hd, pos,
    # splits, scale, dtype
    "lm_decode_attention": [P, P, P, P, P, P, I32, I32, I32, I32, I32, I32,
                            I32, F32, I32],
    # x, scale, out, rows, d, eps, x dtype, scale dtype
    "lm_rmsnorm": [P, P, P, I64, I32, F32, I32, I32],
}, error_fn="lm_error_string")

SSM_SCAN = KernelLibrary("ssm_scan", {
    # dt, x, Bc, Cc, A, h0, y, h_out, B, L, di, N, the (batch, time)
    # strides of dt, x, Bc, Cc and y, x/B/C dtype
    "ssm_scan_chunk": [P, P, P, P, P, P, P, P, I32, I32, I32, I32,
                       I64, I64, I64, I64, I64, I64, I64, I64, I64, I64,
                       I32],
    # dt, dt_bias, x, z, Bc, Cc, A, D, h0, y, h_out, B, L, di, N, the
    # (batch, time) strides of dt, x, z, Bc, Cc and y, dtype
    "mamba1_scan_chunk": [P, P, P, P, P, P, P, P, P, P, P, I32, I32, I32,
                          I32, I64, I64, I64, I64, I64, I64, I64, I64, I64,
                          I64, I64, I64, I32],
}, error_fn="ssm_error_string")

LIBRARIES = (CODEC_PACK, LM_KERNELS, SSM_SCAN)
