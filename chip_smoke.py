#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits non-zero):

1. setup   — print torch's version and the card (``nvidia-smi``), turn
             TF32 off and cuDNN deterministic, build the CUDA codec
             kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
2. plan    — MobileNetV2 (224x224, 10 classes, batch 8) on the
             ``pi_chain4`` scenario with one codec per hop (int8, fp8,
             topk); the port's own ``solve`` picks the cuts;
3. kernels — every kernel against its plain PyTorch version on the card
             (bit-exact) at n in {1, 7, 127, 129, 1_000_003} and at the
             slice's cut sizes, then timed at its hop's activation;
4. slice   — ``EdgePipeline(..., device="cuda")``: ``run_one`` and
             ``measure`` with the launch counters reset just before; the
             output must equal a stage-by-stage replay that uses the
             plain codec round trip, and a codec-free pipeline must match
             ``CNNModel.apply``;
5. profile — one lone batch under ``torch.profiler``: device busy time
             by kernel against the batch's wall time (full table in
             ``chiprun_out/smoke_profile.txt``).

The last two lines of standard output are the kernel table (JSON) and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, the script fails before printing a result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

BATCH, HW, CLASSES = 8, 224, 10
CODECS = ("int8", "fp8", "topk")
CHECK_SIZES = (1, 7, 127, 129, 1_000_003)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/codec_pack.cu"
# the __global__ functions of codec_pack.cu, as the profiler names them
CUDA_KERNELS = ("absmax_kernel", "int8_pack_kernel", "fp8_pack_kernel",
                "int8_unpack_kernel", "fp8_unpack_kernel", "topk_keys_kernel")
# file:line of the Pallas kernel body each CUDA kernel replaces
REPLACES = {
    "int8_pack": "src/repro/kernels/codec_pack.py:51",
    "int8_unpack": "src/repro/kernels/codec_pack.py:56",
    "fp8_pack": "src/repro/kernels/codec_pack.py:60",
    "fp8_unpack": "src/repro/kernels/codec_pack.py:65",
    "topk_select": "src/repro/kernels/codec_pack.py:141",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, what: str, fn, iters: int) -> float:
    """Mean device time of ``fn`` in ms.  A sleep kernel holds the
    stream while the host enqueues all ``iters`` calls, so the events
    bracket back-to-back device work, not the host's launch overhead
    (a note says when the enqueue outlasted the sleep)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    hold = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)             # ~0.1 s at H100 clocks
    hold.record()
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if hold.elapsed_time(start) > 0.05:
        log(f"  (note: {what}: the enqueue ({enqueue_ms:.1f} ms) outlasted "
            f"the sleep; this time includes host gaps)")
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.core import best_throughput, scenarios, solve
    from repro_torch.kernels import codec_pack, ops, ref
    from repro_torch.models.cnn import zoo
    from repro_torch.runtime import EdgePipeline

    # ---------------------------------------------------------------- setup
    smi = nvidia_smi()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"card: {smi}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    log(f"flags: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.deterministic={torch.backends.cudnn.deterministic} "
        f"cudnn.benchmark={torch.backends.cudnn.benchmark}")
    t0 = time.perf_counter()
    lib = codec_pack.build(force=True)
    log(f"built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    for line in (codec_pack.BUILD_DIR / "nvcc.log").read_text().splitlines():
        if "Compiling entry" in line or "registers" in line:
            log("  ptxas " + line.split("ptxas info")[-1].strip(" :"))
    codec_pack.library()
    dev = torch.device("cuda")

    # ----------------------------------------------------------------- plan
    model = zoo.get("mobilenetv2", CLASSES).init(
        torch.Generator().manual_seed(0), "cuda")
    scen = scenarios.get("pi_chain4").with_codec(CODECS)
    best = best_throughput(solve(model.block_graph(), scen, batch=BATCH))
    cuts = tuple(best.partition)
    bounds = (0, *cuts, len(model.blocks))
    cut_shapes = []
    s = (BATCH, HW, HW, 3)
    for b, (_, layer) in enumerate(model.blocks):
        s = layer.out_shape(s)
        if b + 1 in cuts:
            cut_shapes.append(s)
    log(f"plan: {scen.name} codecs={scen.codecs} cuts={cuts} "
        f"cut shapes={cut_shapes}")
    hop_n = {c: math.prod(sh) for c, sh in zip(scen.codecs, cut_shapes)}

    # -------------------------------------------------------------- kernels
    gen = torch.Generator(device=dev).manual_seed(0)
    sizes = sorted(set(CHECK_SIZES) | {math.prod(sh) for sh in cut_shapes})
    err = {name: 0.0 for name in REPLACES}

    def bits(t):
        return t.reshape(-1).view(torch.uint8)

    def diff(a, b):
        if a.numel() == 0:
            return 0.0
        return float((a.float() - b.float()).abs().max())

    def same(name, a, b):
        if not torch.equal(bits(a), bits(b)):
            raise AssertionError(f"{name}: kernel and plain version differ")

    for n in sizes:
        inputs = [torch.randn(n, generator=gen, device=dev) * 3.0,
                  # tie-heavy: few distinct magnitudes
                  torch.randint(-4, 5, (n,), generator=gen,
                                device=dev).float()]
        for x in inputs:
            for pack, unpack in (("int8_pack", "int8_unpack"),
                                 ("fp8_pack", "fp8_unpack")):
                q, sc = getattr(ops, pack)(x)
                qr, scr = getattr(ref, pack + "_ref")(x)
                same(pack, q, qr)
                same(pack + " scale", sc, scr)
                err[pack] = max(err[pack], diff(q, qr))
                y = getattr(ops, unpack)(q, float(sc))
                yr = getattr(ref, unpack + "_ref")(q, sc)
                same(unpack, y, yr)
                err[unpack] = max(err[unpack], diff(y, yr))
            k = max(1, math.ceil(n / 8))
            idx, vals = ops.topk_select(x, k=k)
            idr, valr = ref.topk_select_ref(x, k=k)
            same("topk_select indices", idx, idr)
            same("topk_select values", vals, valr)
            err["topk_select"] = max(err["topk_select"], diff(vals, valr))
    torch.cuda.synchronize()
    log(f"kernels: bit-exact against the plain versions at n={sizes} "
        f"(normal and tie-heavy inputs)")

    # timing at each kernel's own hop activation (the main path's shapes)
    timings = {}
    for codec, (pack, unpack) in (("int8", ("int8_pack", "int8_unpack")),
                                  ("fp8", ("fp8_pack", "fp8_unpack"))):
        n = hop_n[codec]
        x = torch.randn(n, generator=gen, device=dev)
        q, sc = getattr(ops, pack)(x)
        scale = float(sc)
        pk, upk = getattr(ops, pack), getattr(ops, unpack)
        pr, upr = getattr(ref, pack + "_ref"), getattr(ref, unpack + "_ref")
        timings[pack] = dict(
            n=n, ms=device_ms(torch, pack, lambda: pk(x), 50),
            plain_ms=device_ms(torch, pack + " plain", lambda: pr(x), 50),
            library_ms=device_ms(
                torch, "vector_norm(inf)",
                lambda: torch.linalg.vector_norm(x, float("inf")), 50),
            bytes=5 * n + 4)
        lib_unpack = None
        if codec == "int8":
            lib_unpack = device_ms(torch, "torch.mul", lambda: torch.mul(q, scale),
                                   50)
        timings[unpack] = dict(
            n=n, ms=device_ms(torch, unpack, lambda: upk(q, scale), 50),
            plain_ms=device_ms(torch, unpack + " plain",
                              lambda: upr(q, scale), 50),
            library_ms=lib_unpack, bytes=5 * n)
    n = hop_n["topk"]
    k = max(1, math.ceil(n / 8))
    x = torch.randn(n, generator=gen, device=dev)
    mag = x.abs()
    timings["topk_select"] = dict(
        n=n, ms=device_ms(torch, "topk_select",
                          lambda: ops.topk_select(x, k=k), 20),
        plain_ms=device_ms(torch, "topk_select plain",
                          lambda: ref.topk_select_ref(x, k=k), 20),
        library_ms=device_ms(torch, "torch.topk",
                            lambda: torch.topk(mag, k), 20),
        bytes=4 * n + 8 * k)
    for name, t in timings.items():
        t["bound_ms"] = t["bytes"] / HBM_BYTES_PER_S * 1e3
        lib_ms = ("n/a" if t["library_ms"] is None
                  else f"{t['library_ms']:.4f}")
        log(f"  {name:12s} n={t['n']:>8d} kernel {t['ms']:.4f} ms  "
            f"bound {t['bound_ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  "
            f"library {lib_ms} ms")
    log(f"kernels (check-phase launches): {json.dumps(ops.launch_counts())}")

    # ---------------------------------------------------------------- slice
    xgen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(BATCH, HW, HW, 3, generator=xgen, device=dev)
    pipe = EdgePipeline(model, cuts, scen, device="cuda")
    ops.reset_launch_counts()
    y, lat, hop_t = pipe.run_one(x)
    res = pipe.measure(lambda: x, n_batches=10)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"slice: run_one latency {lat * 1e3:.2f} ms, per-hop wire "
        f"{[round(h * 1e3, 3) for h in hop_t]} ms")
    log(f"slice: measure latency {res.latency_s * 1e3:.2f} ms, throughput "
        f"{res.throughput:.2f} samples/s, stage exe_s "
        f"{[round(e * 1e3, 3) for e in res.stage_exe_s]} ms, hop net "
        f"{[round(h * 1e3, 3) for h in res.hop_net_s]} ms")
    for i, net in enumerate(pipe.nets):
        log(f"  hop {i} ({pipe.codecs[i]}): {net.total_transfers} transfers, "
            f"wire {net.total_bytes} B, raw {net.total_raw_bytes} B "
            f"(per batch: wire {net.total_bytes // net.total_transfers} B, "
            f"raw {net.total_raw_bytes // net.total_transfers} B)")
    log(f"slice: launches {json.dumps(launches)}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    if y.shape != (BATCH, CLASSES) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"bad output: shape {tuple(y.shape)}")

    # replay stage by stage with the plain codec round trip between stages
    def plain_roundtrip(codec, a):
        if codec == "int8":
            q, sc = ref.int8_pack_ref(a)
            return ref.int8_unpack_ref(q, sc).reshape(a.shape)
        if codec == "fp8":
            q, sc = ref.fp8_pack_ref(a)
            return ref.fp8_unpack_ref(q, sc).reshape(a.shape)
        idx, vals = ref.topk_select_ref(a, k=max(1, math.ceil(a.numel() / 8)))
        flat = torch.zeros(a.numel(), dtype=torch.float32, device=a.device)
        flat[idx.long()] = vals
        return flat.reshape(a.shape)

    a = x
    for i in range(len(bounds) - 1):
        a = model.apply_range(a, bounds[i], bounds[i + 1])
        if i < len(cuts):
            a = plain_roundtrip(pipe.codecs[i], a)
    if not torch.equal(a, y):
        raise AssertionError(f"pipeline output differs from the plain "
                             f"replay by {diff(a, y)}")
    log("slice: pipeline output == stage-by-stage plain replay (torch.equal)")

    plain_pipe = EdgePipeline(model, cuts, scen, codec="none", device="cuda")
    y0, _, _ = plain_pipe.run_one(x)
    ref_out = model.apply(x)
    if not torch.allclose(y0, ref_out, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"codec-free pipeline differs from "
                             f"CNNModel.apply by {diff(y0, ref_out)}")
    top1 = float((y.argmax(-1) == y0.argmax(-1)).float().mean())
    log(f"slice: codec-free pipeline allclose to CNNModel.apply "
        f"(rtol=atol=1e-5, max diff {diff(y0, ref_out):.3g}); coded vs "
        f"uncoded top-1 agreement {top1:.3f}, max |diff| {diff(y, y0):.4g}")

    # -------------------------------------------------------------- profile
    # one lone batch under torch.profiler: device busy time by kernel
    # against the batch's wall time (the rest is emulated wire sleeps,
    # host-side codec copies and thread hand-offs)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.run_one(x)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [r for r in prof.key_averages()
            if r.device_type == DeviceType.CUDA and r.self_device_time_total]
    busy_ms = sum(r.self_device_time_total for r in rows) / 1e3
    if rows:
        codec_ms = sum(r.self_device_time_total for r in rows
                       if any(k in r.key for k in CUDA_KERNELS)) / 1e3
        log(f"profile: lone batch wall {wall_ms:.2f} ms, device busy "
            f"{busy_ms:.3f} ms (idle share {1 - busy_ms / wall_ms:.4f}), "
            f"codec kernels {codec_ms:.3f} ms")
        for r in sorted(rows, key=lambda r: -r.self_device_time_total)[:8]:
            log(f"  {r.self_device_time_total / 1e3:8.3f} ms  x{r.count:<4d} "
                f"{r.key[:90]}")
        out_dir = os.path.join(ROOT, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "smoke_profile.txt"), "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=60))
    else:
        log(f"profile: lone batch wall {wall_ms:.2f} ms; the profiler saw "
            f"no device time (device busy share not measured)")

    # --------------------------------------------------------------- report
    rows = []
    for name in REPLACES:
        t = timings[name]
        rows.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
