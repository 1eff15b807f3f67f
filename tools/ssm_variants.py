#!/usr/bin/env python
"""What the selective-scan kernel's design choices buy (needs one CUDA
card).

``ssm_scan_kernel`` (``src/repro_torch/kernels/csrc/ssm_scan.cu``) keeps
eight states a lane and the accurate softplus and sigmoid of the
reference.  This script builds copies of the source with one change
each, beside the shipped library in the git-ignored build directory:

1. ``four states a lane``: ``kPerLane`` 4 (twice the threads, each step's
   loads and shuffles shared by half the states);
2. ``no softplus``: the gated prologue without its softplus, and
3. ``no sigmoid``: the gated epilogue without its sigmoid (timing only:
   their outputs are wrong), to show what those transcendentals cost;

and times each copy and the source as it is with ``chip_smoke.device_ms``
(CUDA events over back-to-back launches): ``ops.ssm_scan_chunk`` and
``ops.mamba1_scan_chunk`` at falcon-mamba-7b's prefill chunk (8, 256,
8192, 16) and decode step (8, 1, 8192, 16), bf16, on ``chip_smoke``'s
inputs.  It prints one JSON line a copy (its registers a thread from
ptxas, its times), then the card's name and power limit.

    PYTHONPATH=src python tools/ssm_variants.py
"""
from __future__ import annotations

import itertools
import json
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_REPO))
sys.path.insert(0, str(_REPO / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import ssm_scan as kssm  # noqa: E402

# (label, a line of ssm_scan.cu, what the copy has in its place)
CHANGES = [
    ("four states a lane",
     "constexpr int kPerLane = 8;",
     "constexpr int kPerLane = 4;"),
    ("no softplus",
     "        if constexpr (Gated) dtv = softplus(__fadd_rn(dtv, bias));",
     "        if constexpr (Gated) dtv = __fadd_rn(dtv, bias);"),
    ("no sigmoid",
     "          const float sg = to_f32(from_f32<T>(1.0f / (1.0f + "
     "expf(-zv))));",
     "          const float sg = zv;"),
]


def copies() -> dict[str, str]:
    """The source of each copy, by its label."""
    text = _build.SSM_SCAN.source.read_text()
    out = {}
    for label, line, repl in CHANGES:
        if text.count(line) != 1:
            raise RuntimeError(f"ssm_scan.cu: the line that '{label}' "
                               f"changes moved: {line!r}")
        out[label] = text.replace(line, repl)
    return out


def library(i: int, text: str) -> _build.KernelLibrary:
    lib = _build.KernelLibrary(f"ssm_scan_v{i}", _build.SSM_SCAN.functions,
                               _build.SSM_SCAN.error_fn)
    lib.source = _build.BUILD_DIR / f"ssm_scan_v{i}.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib.source.write_text(text)
    return lib


def main() -> int:
    texts = copies()
    if not torch.cuda.is_available():
        print("ssm_variants: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = {"as built": _build.SSM_SCAN}
    libs.update((label, library(i, text))
                for i, (label, text) in enumerate(texts.items()))
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(force=True), libs.values()))
    inputs = {}
    for what, L, n_sets in (("prefill", chip_smoke.SSM_L, 1),
                            ("decode", 1, 24)):
        for name, make in (("ssm_scan_chunk", chip_smoke.scan_inputs),
                           ("mamba1_scan_chunk", chip_smoke.gated_inputs)):
            inputs[name, what] = [
                make(torch, dev, chip_smoke.SSM_B, L, chip_smoke.SSM_DI,
                     chip_smoke.SSM_N, torch.bfloat16, 7 + i)
                for i in range(n_sets)]
    for label, lib in libs.items():
        kssm.SSM_SCAN = lib
        row = {"variant": label, "registers": sorted(set(
            int(r) for r in re.findall(r"Used (\d+) registers",
                                       lib.log.read_text())))}
        for (name, what), sets in inputs.items():
            fn, cyc = getattr(ops, name), itertools.cycle(sets)
            row[f"{name} {what} ms"] = chip_smoke.device_ms(
                torch, f"{label}: {name} {what}", lambda: fn(*next(cyc)),
                20 if what == "prefill" else 96)
        print(json.dumps(row), flush=True)
    kssm.SSM_SCAN = _build.SSM_SCAN
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
