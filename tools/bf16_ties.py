#!/usr/bin/env python
"""Where a deep bf16 model's two serving routes part at the prefill
argmax, and how far each lies from fp32 as depth grows (needs one CUDA
card with room for about 60 GB).

For each weight seed, granite-20b (or ``--arch``) at full width and
depth, bf16, serves one prefill of ``chip_smoke.py``'s phase 37 (batch 8,
prompt 1024) through the kernel route (``attn_impl="pallas"``: the
flash, decode and RMSNorm kernels) and the plain ``"xla"`` route; one
line a row prints both routes' argmax, each route's gap between its two
largest logits and the routes' largest difference in that row.  Then,
for each depth of ``--depths`` (weights from seed 0), both bf16 routes
against an fp32 plain run of the same weights: each route's mean and
largest |error| and how many of the batch's argmaxes equal fp32's.
Last, the card's name and power limit.

    PYTHONPATH=src python tools/bf16_ties.py [--arch granite-20b] \\
        [--seeds 0 1 2] [--depths 4 13 26]
"""
from __future__ import annotations

import argparse
import copy
import gc
import subprocess
import sys
from pathlib import Path

import torch

_REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_REPO / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import lm  # noqa: E402

B, S, NEW = 8, 1024, 8       # chip_smoke.py's phase 37


def top2(logits):
    """→ (argmax, gap between the two largest) of each row."""
    v, i = logits.float().topk(2, dim=-1)
    return i[..., 0], v[..., 0] - v[..., 1]


def prefill(cfg, model, inputs):
    with torch.no_grad():
        out = lm.forward_prefill(cfg, model, inputs, S + NEW)[0]
    return out[:, 0].float()


def free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-20b")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--depths", type=int, nargs="+", default=[4, 13, 26])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bf16_ties: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.LM_KERNELS.library()
    dev = torch.device("cuda")
    full = configs.get(args.arch).replace(attn_impl="pallas")

    def batch(cfg, seed):
        data = SyntheticLM(cfg, DataConfig(B, S, seed), device=dev)
        return {k: v for k, v in next(data).items() if k != "targets"}

    for seed in args.seeds:
        model = lm.init(full, torch.Generator(device=dev).manual_seed(seed),
                        dev)
        inputs = batch(full, seed)
        kern = prefill(full, model, inputs)
        plain = prefill(full.replace(attn_impl="xla"), model, inputs)
        del model
        free()
        (ik, gk), (ip, gp) = top2(kern), top2(plain)
        diff = (kern - plain).abs().amax(-1)
        print(f"seed {seed}, {full.n_layers} layers, bf16: routes' largest "
              f"|diff| {float(diff.max()):.4f}", flush=True)
        for r in range(B):
            print(f"  row {r}: argmax kernel {int(ik[r])} plain "
                  f"{int(ip[r])}{' DIFFER' if ik[r] != ip[r] else ''}; top-2 "
                  f"gap kernel {float(gk[r]):.4f} plain {float(gp[r]):.4f}; "
                  f"routes' largest |diff| {float(diff[r]):.4f}", flush=True)

    inputs = batch(full, 0)
    for depth in args.depths:
        cfg = full.replace(n_layers=depth)
        model = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        out = {"kernel": prefill(cfg, model, inputs),
               "plain": prefill(cfg.replace(attn_impl="xla"), model, inputs)}
        model = copy.deepcopy(model).float()
        free()
        ref = prefill(cfg.replace(dtype="float32", attn_impl="xla"), model,
                      inputs)
        del model
        free()
        for name, o in out.items():
            err = (o - ref).abs()
            same = int((o.argmax(-1) == ref.argmax(-1)).sum())
            print(f"{depth} layers, {name} route against fp32: mean |err| "
                  f"{float(err.mean()):.5f}, largest {float(err.max()):.4f}, "
                  f"argmax equal for {same} of {B}", flush=True)
        same = int((out["kernel"].argmax(-1) == out["plain"].argmax(-1))
                   .sum())
        print(f"{depth} layers, kernel against plain route: largest |diff| "
              f"{float((out['kernel'] - out['plain']).abs().max()):.4f}, "
              f"argmax equal for {same} of {B}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
