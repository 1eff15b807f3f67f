#!/usr/bin/env python
"""How the bf16 prefill-attention kernel's rounding of P moves qwen3-1.7b's
prefill argmax, over several weight seeds (needs one CUDA card).

``flash_attention_tc_kernel`` (``src/repro_torch/kernels/csrc/lm_kernels.cu``)
feeds the softmax weights P to the P.V product as two bf16 parts, P_hi =
bf16(P) and P_lo = bf16(P - P_hi).  This script builds the shipped source
and a copy without the P_lo product (P rounded to bf16 alone, as SDPA's
kernels do) and, for each seed, serves one prefill of ``chip_smoke.py``'s
LM slice (qwen3-1.7b, bf16, batch 8, prompt 1024, random weights from the
seed) through each build and through the plain ``"xla"`` route.  It prints
one JSON line a (seed, build): the logits' largest distance from the plain
route, how many of the batch's argmaxes equal the plain route's, and the
plain route's smallest gap between its two largest logits (a near-tie).
Then it times both builds' flash kernel at that slice's shape (q
(8,1024,16,128), causal) with CUDA events, in the order split, bf16, bf16,
split, one JSON line each; and prints the card's name and power limit.

    PYTHONPATH=src python tools/flash_p_rounding.py [--seeds 0 1 2]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
from pathlib import Path

import torch

_REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_REPO / "src"))

from repro_torch.kernels import _build, flash_attention  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402

P_LO_PRODUCT = "      wgmma_rs<1>(o, p_lo + 4 * kk, dv, 1);\n"


def p_hi_library() -> _build.KernelLibrary:
    """``lm_kernels.cu`` without the P_lo.V product, built beside the
    shipped library in the git-ignored build directory."""
    text = _build.LM_KERNELS.source.read_text()
    if text.count(P_LO_PRODUCT) != 1:
        raise RuntimeError("lm_kernels.cu: the P_lo.V product line moved")
    lib = _build.KernelLibrary("lm_kernels_p_hi", _build.LM_KERNELS.functions,
                               _build.LM_KERNELS.error_fn)
    lib.source = _build.BUILD_DIR / "lm_kernels_p_hi.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib.source.write_text(text.replace(P_LO_PRODUCT, ""))
    return lib


def flash_ms(q, k, v, iters: int = 50) -> float:
    """Mean ms of one causal flash-attention launch, back to back."""
    for _ in range(5):
        flash_attention.flash_attention(q, k, v, causal=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        flash_attention.flash_attention(q, k, v, causal=True)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_p_rounding: needs a CUDA card", file=sys.stderr)
        return 1
    builds = {"p_split": _build.LM_KERNELS, "p_bf16": p_hi_library()}
    threads = [threading.Thread(target=b.library) for b in builds.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for b in builds.values():
        b.library()                       # raises here if a build failed
    for seed in args.seeds:
        sargs = serve.parse_args([
            "--arch", "qwen3-1.7b", "--batch", "8", "--prompt-len", "1024",
            "--new-tokens", "32", "--seed", str(seed)])
        cfg, model, inputs, cache_len = serve.setup(sargs)
        with torch.no_grad():
            plain = lm.forward_prefill(cfg.replace(attn_impl="xla"), model,
                                       inputs, cache_len)[0].float()
            plain = plain.reshape(plain.shape[0], -1)     # (B, vocab)
            top2 = plain.topk(2, dim=-1).values
            gap = float((top2[:, 0] - top2[:, 1]).min())
            for name, lib in builds.items():
                flash_attention.LM_KERNELS = lib
                out = lm.forward_prefill(cfg, model, inputs, cache_len)[0]
                out = out.float().reshape(plain.shape)
                agree = int((out.argmax(-1) == plain.argmax(-1)).sum())
                print(json.dumps({
                    "seed": seed, "build": name,
                    "max_abs_diff": float((out - plain).abs().max()),
                    "argmax_equal": agree, "rows": out.shape[0],
                    "plain_top2_gap_min": gap}), flush=True)
        flash_attention.LM_KERNELS = _build.LM_KERNELS
        del model, inputs
        torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(8, 1024, h, 128, generator=g, device="cuda",
                           dtype=torch.bfloat16) for h in (16, 8, 8))
    for name in ("p_split", "p_bf16", "p_bf16", "p_split"):
        flash_attention.LM_KERNELS = builds[name]
        print(json.dumps({"build": name, "flash_ms": flash_ms(q, k, v)}),
              flush=True)
    flash_attention.LM_KERNELS = _build.LM_KERNELS
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
