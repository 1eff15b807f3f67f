#!/usr/bin/env python
"""Where the cooperative codec kernels' time goes (needs one CUDA card).

``fp8_pack`` and ``topk_select`` (``src/repro_torch/kernels/csrc/
codec_pack.cu``) are one cooperative launch each.  At the CNN slice's hop
sizes their bytes take a few microseconds, so fixed costs set their pace:
the launch, each grid sync, and the chains of dependent loads between
syncs.  This script times, with ``chip_smoke.device_ms`` (CUDA events over
back-to-back launches, the stream held while the host enqueues):

1. an empty kernel launched plainly and cooperatively, and cooperative
   kernels that only cross 1 and 5 grid syncs, on one CTA of 512 threads
   an SM (``topk_select_kernel``'s grid);
2. ``topk_select_kernel`` whole and cut after each of its phases (a copy
   of the source that returns there; its output is not used) at the topk
   hop (n = 602,112, k = 75,264, random normal values) and at n = 4,096;
3. ``pack_fused_kernel`` whole at the fp8 hop (n = 1,605,632), at the
   int8 hop (n = 3,211,264, past what the grid keeps in registers) and
   at n = 4,096, for each of its two instances.

It prints one JSON line a measurement, then the card's name and power
limit.  The copies are built beside the shipped library in the
git-ignored build directory.

    PYTHONPATH=src python tools/codec_phases.py
"""
from __future__ import annotations

import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_REPO))
sys.path.insert(0, str(_REPO / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build, codec_pack  # noqa: E402

TOPK_N, TOPK_K, FP8_N, INT8_N, SMALL_N = (602_112, 75_264, 1_605_632,
                                          3_211_264, 4_096)
ITERS = 200

# (label, the line of topk_select_kernel after which the copy returns,
# a use of what came before it, so that the compiler keeps that work)
CUTS = [
    ("launch + load", "  load_span(xb, warp_span(cs, min(cs + kTile, ce), "
     "warp), lane, res);\n", "  if (res[0] == 0xFFFFFFFFu) idx_out[0] = 1;"),
    ("+ zero, histogram 1, sync", "  grid.sync();                        "
     "          // the zeroed histograms\n",
     "  if (s_hist[0] == 0xFFFFFFFFu) idx_out[0] = 1;"),
    ("+ merge 1, sync, select 1", "  select_digit<kBins1>(g1, k, s_a, "
     "s_sel);\n", "  idx_out[0] = s_sel[0];"),
    ("+ pass 2", "  select_digit<kBins2>(g2, krem, s_a, s_sel);\n",
     "  idx_out[0] = s_sel[0];"),
    ("+ pass 3", "  const unsigned r = s_sel[1];\n", "  idx_out[0] = T + r;"),
    ("+ counts, sync", "    counts[2 * b + 1] = eq;\n  }\n  grid.sync();\n",
     "  idx_out[0] = T;"),
]

SYNC_SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
template <int S>
__global__ void syncs_kernel(int* out) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
#pragma unroll 1
  for (int i = 0; i < S; ++i) grid.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) *out = S;
}
extern "C" {
int launch_syncs(int syncs, int coop, int grid, int threads, void* out,
                 void* stream) {
  const void* k = syncs == 0 ? (const void*)syncs_kernel<0>
                : syncs == 1 ? (const void*)syncs_kernel<1>
                             : (const void*)syncs_kernel<5>;
  void* args[] = {&out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = coop ? cudaLaunchCooperativeKernel(k, grid, threads, args,
                                                     0, s)
                       : cudaLaunchKernel(k, grid, threads, args, 0, s);
  cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}
const char* sync_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
}
"""


def library(name: str, text: str, functions: dict, error_fn: str
            ) -> _build.KernelLibrary:
    lib = _build.KernelLibrary(name, functions, error_fn)
    lib.source = _build.BUILD_DIR / f"{name}.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib.source.write_text(text)
    return lib


def topk_cuts() -> list[tuple[str, str]]:
    """(label, source) of codec_pack.cu cut after each phase of
    topk_select_kernel."""
    text = _build.CODEC_PACK.source.read_text()
    out = []
    for label, line, use in CUTS:
        if text.count(line) != 1:
            raise RuntimeError(f"codec_pack.cu: the line after which "
                               f"'{label}' cuts moved: {line!r}")
        out.append((label, text.replace(line, f"{line}{use}\n  return;\n")))
    return out


def main() -> int:
    cuts = topk_cuts()
    if not torch.cuda.is_available():
        print("codec_phases: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = {label: library(f"codec_pack_cut{i}", text,
                           _build.CODEC_PACK.functions, "codec_error_string")
            for i, (label, text) in enumerate(cuts)}
    libs["whole"] = _build.CODEC_PACK
    syncs = library("coop_syncs", SYNC_SOURCE,
                    {"launch_syncs": [_build.I32] * 4 + [_build.P]},
                    "sync_error_string")
    with ThreadPoolExecutor(len(libs) + 1) as pool:
        list(pool.map(lambda lib: lib.build(force=True),
                      [*libs.values(), syncs]))

    def report(what: str, n: int | None, fn) -> None:
        ms = chip_smoke.device_ms(torch, what, fn, ITERS)
        print(json.dumps({"what": what, "n": n, "ms": ms}), flush=True)

    P = _build.P
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for what, n_syncs, coop in (("empty kernel, plain launch", 0, 0),
                                ("empty kernel, cooperative launch", 0, 1),
                                ("1 grid sync, cooperative", 1, 1),
                                ("5 grid syncs, cooperative", 5, 1)):
        report(what, None, lambda: syncs.launch(
            "launch_syncs", dev, n_syncs, coop, sms, 512, P(out.data_ptr())))

    gen = torch.Generator(device=dev).manual_seed(0)
    scratch = torch.empty(codec_pack.topk_scratch_words(), dtype=torch.int32,
                          device=dev)
    for n, k in ((TOPK_N, TOPK_K), (SMALL_N, SMALL_N // 8)):
        x = torch.randn(n, generator=gen, device=dev)
        idx = torch.empty(k, dtype=torch.int32, device=dev)
        vals = torch.empty(k, dtype=torch.float32, device=dev)
        for label, lib in libs.items():
            report(f"topk_select_kernel: {label}", n, lambda: lib.launch(
                "codec_topk_select", dev, P(x.data_ptr()), n, k,
                P(idx.data_ptr()), P(vals.data_ptr()),
                P(scratch.data_ptr()), scratch.numel(), 0))
    for n in (FP8_N, INT8_N, SMALL_N):
        x = torch.randn(n, generator=gen, device=dev)
        for codec in ("fp8", "int8"):
            pack = getattr(codec_pack, f"{codec}_pack")
            report(f"pack_fused_kernel ({codec}): whole", n,
                   lambda: pack(x))
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
