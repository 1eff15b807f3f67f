#!/usr/bin/env python
"""Times of one source tree of the port, for comparing two trees on one
card (needs one CUDA card).

For the ``repro_torch`` package under ``--src`` (default: this
repository's ``src``), it times with ``chip_smoke.device_ms`` (CUDA
events over back-to-back launches):

1. ``ops.int8_pack`` and ``ops.fp8_pack`` at the CNN slice's int8 and
   fp8 hops (n = 3,211,264 and 1,605,632), each beside
   ``torch.linalg.vector_norm(x, inf)``;
2. ``ops.fused_rmsnorm`` (bf16 rows and scale) at every row shape of the
   qwen3-1.7b and falcon-mamba-7b serving paths, and the host's wall
   time a call over 2000 calls;
3. two pipeline ``Worker``s at once on two threads, one heavy and one
   light (``chip_smoke.concurrent_stages``): each one's mean ``exe_s``;
4. ``ops.ssm_scan_chunk`` and ``ops.mamba1_scan_chunk`` (null where the
   tree has no such wrapper) at falcon-mamba-7b's prefill chunk (8, 256,
   8192, 16) and decode step (8, 1, 8192, 16) in bf16, on
   ``chip_smoke``'s inputs; then falcon-mamba-7b at full width and 4
   layers, served as ``serve.serve`` does (batch 8, prompt 1024, 32 new
   tokens): prefill ms, decode ms/token, and one prefill under
   ``torch.profiler``: device busy time, the scan kernels' and the
   elementwise kernels' time and launches a layer;

then runs the CNN slice (MobileNetV2-224, batch 8, ``pi_chain4``, codecs
int8, fp8, topk, the cuts ``solve`` picks) through
``EdgePipeline.measure`` (10 batches) and streams 20 batches under
``torch.profiler`` (``chip_smoke.streamed_stages``): lone-batch
latency, throughput, each stage's ``exe_s``, their sum over the
streamed run and the device's busy time in that run; and last serves
qwen3-1.7b and falcon-mamba-7b as ``chip_smoke.py`` does (bf16, batch 8,
prompt 1024, 32 new tokens): prefill ms and decode ms/token.

It prints one JSON line a measurement, each tagged with ``--tag``, then
the card's name and power limit.  Run it for two trees in turns (A, B,
B, A) in one call to compare them:

    python tools/ab_times.py --src scratch_tree/parent/src --tag parent
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

import torch

_REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_REPO))

import chip_smoke  # noqa: E402

INT8_N, FP8_N = 3_211_264, 1_605_632
SSM_LAYERS = 4                 # falcon-mamba-7b's depth cut to 4 layers


def host_us(torch, fn, calls: int = 2000) -> float:
    """Wall time a call of ``fn``, in us, over back-to-back calls that
    end in a synchronise: the host's cost a call wherever the kernel is
    shorter than it (the decode steps' rows)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def ssm_reduced_depth(torch, emit, dev) -> None:
    """falcon-mamba-7b at full width and ``SSM_LAYERS`` layers, random
    weights from seed 0: ``serve.serve``'s prefill and decode times, then
    one prefill under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.runtime.steps import make_prefill_step
    B, S, new = chip_smoke.SSM_B, chip_smoke.SSM_S, chip_smoke.SSM_NEW
    cfg = configs.get("falcon-mamba-7b").replace(attn_impl="pallas",
                                                 n_layers=SSM_LAYERS)
    model = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    inputs = {k: v for k, v in next(SyntheticLM(
        cfg, DataConfig(B, S, 0), device=dev)).items() if k != "targets"}
    res = serve.serve(cfg, model, inputs, S + new, new)
    emit("falcon-mamba serve", layers=SSM_LAYERS,
         prefill_ms=res["prefill_s"] * 1e3,
         decode_ms_per_token=res["decode_s"] / res["decode_steps"] * 1e3)
    prefill = make_prefill_step(cfg, S + new)
    prefill(model, inputs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prefill(model, inputs)
        torch.cuda.synchronize()
    rows = [r for r in prof.key_averages()
            if r.device_type == DeviceType.CUDA and r.self_device_time_total]

    def ms(sel):
        return sum(r.self_device_time_total for r in sel) / 1e3
    elem = [r for r in rows if "elementwise" in r.key]
    scan = [r for r in rows if "ssm_scan_kernel" in r.key]
    emit("falcon-mamba prefill profile", layers=SSM_LAYERS,
         busy_ms=ms(rows), scan_ms=ms(scan),
         scan_launches=sum(r.count for r in scan), elementwise_ms=ms(elem),
         elementwise_launches_per_layer=sum(r.count for r in elem)
         / SSM_LAYERS)
    del model


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(_REPO / "src"))
    ap.add_argument("--tag", default="this tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_times: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch import configs
    from repro_torch.core import best_throughput, scenarios, solve
    from repro_torch.kernels import ops
    from repro_torch.models.cnn import zoo
    from repro_torch.runtime import EdgePipeline
    from repro_torch.runtime.edge import Worker

    def emit(what: str, **fields) -> None:
        print(json.dumps({"tag": args.tag, "what": what, **fields}),
              flush=True)

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    for pack, n in (("int8_pack", INT8_N), ("fp8_pack", FP8_N)):
        x = torch.randn(n, generator=gen, device=dev)
        fn = getattr(ops, pack)
        emit(pack, n=n, ms=chip_smoke.device_ms(
            torch, pack, lambda: fn(x), 200),
            library_ms=chip_smoke.device_ms(
                torch, "vector_norm", lambda: torch.linalg.vector_norm(
                    x, float("inf")), 200))
    rows_of = [chip_smoke.rms_shapes(configs.get(arch), b, s, new)
               for arch, b, s, new in (
                   ("qwen3-1.7b", chip_smoke.LM_B, chip_smoke.LM_S,
                    chip_smoke.LM_NEW),
                   ("falcon-mamba-7b", chip_smoke.SSM_B, chip_smoke.SSM_S,
                    chip_smoke.SSM_NEW))]
    for rows, d in sorted({sh for p in rows_of for sh in p},
                          key=lambda sh: -sh[0] * sh[1]):
        xs = torch.randn(rows, d, generator=gen, device=dev).to(torch.bfloat16)
        sc = torch.randn(d, generator=gen, device=dev).to(torch.bfloat16)
        emit("fused_rmsnorm", shape=[rows, d], ms=chip_smoke.device_ms(
            torch, "fused_rmsnorm", lambda: ops.fused_rmsnorm(xs, sc),
            50 if rows * d > 1 << 20 else 200),
            host_us=host_us(torch, lambda: ops.fused_rmsnorm(xs, sc)))

    for what, L, n_sets, iters in (("prefill", chip_smoke.SSM_L, 1, 20),
                                   ("decode", 1, 24, 96)):
        for name, make in (("ssm_scan_chunk", chip_smoke.scan_inputs),
                           ("mamba1_scan_chunk", chip_smoke.gated_inputs)):
            fn = getattr(ops, name, None)
            shape = [chip_smoke.SSM_B, L, chip_smoke.SSM_DI, chip_smoke.SSM_N]
            if fn is None:
                emit(name, step=what, shape=shape, ms=None)
                continue
            sets = [make(torch, dev, *shape, torch.bfloat16, 7 + i)
                    for i in range(n_sets)]
            cyc = itertools.cycle(sets)
            emit(name, step=what, shape=shape, ms=chip_smoke.device_ms(
                torch, name, lambda: fn(*next(cyc)), iters))
            del sets
    ssm_reduced_depth(torch, emit, dev)

    emit("concurrent stages", **{
        f"{w.name}_exe_ms": w.stats.exe_s / w.stats.calls * 1e3
        for w in chip_smoke.concurrent_stages(torch, Worker, dev)})

    model = zoo.get("mobilenetv2", chip_smoke.CLASSES).init(
        torch.Generator().manual_seed(0), "cuda")
    scen = scenarios.get("pi_chain4").with_codec(chip_smoke.CODECS)
    cuts = tuple(best_throughput(solve(model.block_graph(), scen,
                                       batch=chip_smoke.BATCH)).partition)
    xb = torch.randn(chip_smoke.BATCH, chip_smoke.HW, chip_smoke.HW, 3,
                     generator=torch.Generator(device=dev).manual_seed(1),
                     device=dev)
    pipe = EdgePipeline(model, cuts, scen, device="cuda", timeout_s=60.0)
    res = pipe.measure(lambda: xb, n_batches=10)
    emit("cnn measure", cuts=list(cuts), latency_ms=res.latency_s * 1e3,
         throughput=res.throughput,
         stage_exe_ms=[e * 1e3 for e in res.stage_exe_s])
    emit("cnn streamed", batches=chip_smoke.STREAM_BATCHES,
         **chip_smoke.streamed_stages(torch, pipe, xb))
    del pipe, model
    from repro_torch.launch import serve
    for argv in (chip_smoke.LM_ARGS, chip_smoke.SSM_ARGS):
        torch.cuda.empty_cache()
        res = serve.main(argv)
        emit("serve", arch=argv[1], prefill_ms=res["prefill_ms"],
             decode_ms_per_token=res["decode_ms_per_token"])
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
