#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits non-zero):

1. setup   — print torch's version and the card (``nvidia-smi``), turn
             TF32 off and cuDNN deterministic, build the three CUDA sources
             of ``src/repro_torch/kernels/csrc`` with nvcc, in parallel;
2. plan    — MobileNetV2 (224x224, 10 classes, batch 8) on the
             ``pi_chain4`` scenario with one codec per hop (int8, fp8,
             topk); the port's own ``solve`` picks the cuts;
3. kernels — every kernel against its plain PyTorch version on the card
             (bit-exact) at n in {1, 7, 127, 129, 1_000_003} and at the
             slice's cut sizes, on normal, tie-heavy and special inputs
             (NaNs of several payloads, +-inf and -0.0, all equal, all
             zeros), the packs also on a view off 16-byte alignment,
             top-k at k = 1, ceil(n/8) and n; once more at n =
             40_000_003, past what the cooperative grids keep on chip,
             and the packs at n = 0; fp8 of [1, inf, -2, 0.5, -inf, -0.0]
             on the card against the CPU (every byte off the NaN bytes
             equal; both byte strings printed); then each kernel timed at
             its hop's activation;
4. slice   — ``EdgePipeline(..., device="cuda")``: ``run_one`` and
             ``measure`` with the launch counters reset just before; the
             output must equal a stage-by-stage replay that uses the
             plain codec round trip, and a codec-free pipeline must match
             ``CNNModel.apply``;
5. profile — one lone batch under ``torch.profiler``: device busy time
             by kernel against the batch's wall time (full table in
             ``chiprun_out/smoke_profile.txt``).
             Each hop must have run its codec's kernels once
             (``HOP_KERNELS``: the two ``pack_fused_kernel`` instances told
             apart by name), and no library sort or top-k;
5b. streams — a heavy and a light stage at once on two threads: the
             light one's ``exe_s`` must stay under a quarter of the heavy
             one's; then the slice streamed (20 batches, every stage on its
             own CUDA stream, the three codec hops concurrent) under the
             profiler and a watchdog: the stages' summed ``exe_s`` beside
             the device's busy time;
5c. socket — the slice again with ``transport="socket"`` and the
             sanitizer on: four spawned worker processes, each with its
             own CUDA context, hops over loopback TCP.  ``run_one``'s
             output must equal the emulated pipeline's (phase 4) bit for
             bit; each process's launch counts (sent with its STATS
             flush) must show its hops' pack and unpack kernels once a
             batch (``hop_launches``), for the lone batch and for 20
             streamed ones, each stage on a CUDA device; no sanitizer
             violation.  ``measure`` (20 batches) is printed beside phase
             4's, with each hop's receiver-measured wire time and wire /
             raw bytes; then stage 1 is SIGKILLed mid-stream: the
             session must raise ``TransportError`` within its timeout and
             ``close()`` leave no live worker; then ``measure_hop`` over
             socket at the hops' activation sizes, codec none and int8,
             the sink unpacking on the card (median us a transfer);
5d. shmem — the slice again with ``transport="shmem"``, the sanitizer
             on: stages as processes, hops shared-memory doorbell rings
             whose receiving card copies straight from the slot.  Output
             ``torch.equal`` to the emulated run; each process's launches
             equal ``hop_launches`` (1 and 20 batches), every stage on a
             CUDA device, no violation; ``measure`` beside phases 4 and
             5c; each hop's wire time and bytes; the standup split (per
             worker: spawn to ``import torch`` done, the model rebuilt on
             the card with its CUDA context; the tier's spawn to ready);
             ``measure_hop`` over shmem beside socket's; after
             ``close()`` no live worker and none of the pipeline's
             segments in /dev/shm;
5e. recovery — the slice supervised over shmem, sanitizer on, under a
             watchdog: eight batches from seed 0 with stage 1 SIGKILLed
             after batch 3 must come out equal (``torch.equal``, in
             order) to an unfaulted run's (phase 5d's pipeline), with
             exactly one ``restart`` record that replayed at least one
             batch (its ``detect_s``, ``restart_s`` and ``replay_s``
             printed, and the rebuilt tier's standup); then with the
             feed's batch 2 sent twice: equal outputs, no recovery, one
             ``frame-dup`` injection and launches exactly
             ``hop_launches`` a batch; no violation, worker or segment
             left after either;
6. lm kernels — flash attention (bf16 on the tensor-core kernel, fp32 on
             the FMA kernel), decode attention (split and combine kernels)
             and RMSNorm against their plain versions on the card, fp32 and
             bf16, at the LM slice's shapes and ragged ones (S = T = 1000,
             non-causal S = 64 / T = 1500, every registry head dim: 64, 96,
             112, 128, the reduced configs' 16, granite-20b's MQA group G =
             48, causal S < T; Smax = 1056 at pos 0/1/511/1055 and forced
             split counts 1, 2, 7 and more than positions at pos 0 and
             1055, held also to the plain split-and-combine; RMSNorm rows
             of d = 128, 2048 and 3, and of the SSM slice's d = 4096 at
             prefill and decode), within rtol = atol = 2e-5 (fp32) / 2e-2
             (bf16); then timed at the slice's shapes beside their bound,
             their plain version and one PyTorch call; RMSNorm also at
             every row shape of both serving paths beside the scalar
             kernel it replaced and ``F.rms_norm``, with each path's
             launch-weighted totals;
7. lm slice — ``repro_torch.launch.serve.main`` on qwen3-1.7b at full
             width and depth, bf16, batch 8, prompt 1024, 32 new tokens
             (cache 1056), with the launch counters reset just before; each
             kernel's count must be what the path implies (0 for those
             off it);
8. lm parity — the same weights and prompt through the model's plain
             ``"xla"`` route: bf16 prefill logits within 5e-2 and the same
             argmax, four teacher-forced decode steps within 5e-2; then
             fp32 with TF32 off, full width, 2 layers, within 2e-4 with
             the same argmax and final cache;
9. lm profile — one prefill and one decode step under ``torch.profiler``:
             device busy time and the largest kernels against each
             step's wall time; the bf16 prefill must run
             ``flash_attention_tc_kernel`` and not the FMA
             ``flash_attention_kernel``, the decode step
             ``decode_split_kernel`` and ``decode_combine_kernel``;
10. ssm kernel — both entry points of the selective-scan kernel against
             their plain versions on the card: ``ssm_scan_chunk`` (dt
             softplus'ed, fp32 y) within rtol = atol = 1e-4 and
             ``mamba1_scan_chunk`` (raw dt, D-skip and gate folded in, y in
             the working dtype) within 1e-4 (fp32) and one bf16 ulp, rtol =
             atol = 1e-2, on y with 1e-4 on the state (bf16): at the SSM
             slice's prefill chunk (8, 256, 8192, 16) and decode step (8,
             1, 8192, 16) in bf16, at the reference sweep's fp32 shapes, at
             a ragged di = 200, N = 8 and 16, two chained chunks (views, z
             a view of the in_proj output, the state in place) against one
             long plain call; then each timed at the prefill chunk and at
             decode beside its bound and its plain version;
11. ssm slice — ``serve.main`` on falcon-mamba-7b at full width and depth,
             bf16, batch 8, prompt 1024, 32 new tokens, with the launch
             counters reset just before; each kernel's count must be what
             the path implies (2560 gated scans and no ungated one, 2210
             RMSNorms, no attention);
12. ssm parity — the same weights and prompt through the plain ``"xla"``
             route, as in phase 8 but with bf16 logits within 2e-1 (64
             layers round to bf16 independently on each route), the
             argmax agreement printed and the final state within 1e-3;
             the kernel route's mean error
             against an fp32 run of the same weights at most 1.1x the
             plain route's; then faults planted in the gated scan (A off
             by 2^-8 of itself, the D-skip dropped, B and C swapped, the
             state not carried in) read against every gate of both runs,
             as a control;
13. ssm profile — one prefill and one decode step under ``torch.profiler``:
             each must run the gated scan instance
             (``ssm_scan_kernel<16, __nv_bfloat16, true>``) and not the
             ungated one; the device time left in elementwise kernels is
             printed beside the scan's.

The kernel table's rows for the two scan entries carry their
prefill-chunk times; the decode-step times are printed in phase 10.  The
last three lines of
standard output are the kernel table (JSON), the
card's name and power limit, and ``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, the script fails before printing a result.
"""
from __future__ import annotations

import copy
import gc
import itertools
import json
import math
import os
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

BATCH, HW, CLASSES = 8, 224, 10
CODECS = ("int8", "fp8", "topk")
CHECK_SIZES = (1, 7, 127, 129, 1_000_003)
# past what fp8_pack's and topk_select's resident grids keep on chip
BIG_CHECK = 40_000_003
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
FP32_FLOP_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
# expf on the special-function units: 16 a clock per SM (CUDA programming
# guide, compute capability 9.0), 132 SMs at the 1.98 GHz boost clock
SFU_OPS_PER_S = 132 * 16 * 1.98e9
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/codec_pack.cu"
LM_SOURCE = "src/repro_torch/kernels/csrc/lm_kernels.cu"
SSM_SOURCE = "src/repro_torch/kernels/csrc/ssm_scan.cu"
SSM_REPLACES = "src/repro/kernels/ssm_scan.py:28"
# the SSM slice: falcon-mamba-7b, batch 8, prompt 1024, 32 new tokens
SSM_B, SSM_S, SSM_NEW = 8, 1024, 32
# its widths: d_model, d_inner, state size, chunk length and dt_rank
SSM_D, SSM_DI, SSM_N, SSM_L, SSM_R = 4096, 8192, 16, 256, 256
SSM_ARGS = ["--arch", "falcon-mamba-7b", "--batch", str(SSM_B),
            "--prompt-len", str(SSM_S), "--new-tokens", str(SSM_NEW),
            "--seed", "0"]
SCAN_TOL = 1e-4                # tests/test_kernels.py's for the scan
# the gated scan's y in bf16: one bf16 ulp (its state stays at SCAN_TOL)
GATED_BF16_TOL = 1e-2
# kernel route against plain route, bf16, 64 layers: each route's logits
# lie up to 0.13 from an fp32 run of the same weights (one bf16 ulp of
# difference a layer, accumulated), so the two routes differ by as much
SSM_BF16_TOL = 2e-1
# their final states (fp32) lie 5.2e-5 apart in that run; a gate there
# reads the scan's own output, not through 64 layers of bf16 rounding
SSM_STATE_TOL = 1e-3
# the LM slice: qwen3-1.7b, batch 8, prompt 1024, 32 new tokens
LM_B, LM_S, LM_NEW = 8, 1024, 32
LM_ARGS = ["--arch", "qwen3-1.7b", "--batch", str(LM_B), "--prompt-len",
           str(LM_S), "--new-tokens", str(LM_NEW), "--seed", "0"]
LM_REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:30",
    "decode_attention": "src/repro/kernels/decode_attention.py:26",
    "fused_rmsnorm": "src/repro/kernels/fused_rmsnorm.py:16",
}
# the SSM steps: the gated scan instance, never the ungated one (each
# name a tuple of parts of the profiler's kernel name)
SSM_STEP_KERNELS = {
    step: ((("ssm_scan_kernel<", "true>"),), (("ssm_scan_kernel<", "false>"),))
    for step in ("prefill", "decode step")}
# the kernels each LM step must run on the card, by the profiler's names,
# and those it must not
LM_STEP_KERNELS = {
    "prefill": (("flash_attention_tc_kernel",), ("flash_attention_kernel",)),
    "decode step": (("decode_split_kernel", "decode_combine_kernel"), ()),
}
# the __global__ functions of codec_pack.cu (each template instance on
# its own), by the parts of the profiler's name that tell them apart
CUDA_KERNELS = {
    "pack_fused_kernel<Int8Sym>": ("pack_fused_kernel", "Int8Sym"),
    "pack_fused_kernel<Fp8E4M3>": ("pack_fused_kernel", "Fp8E4M3"),
    "int8_unpack_kernel": ("int8_unpack_kernel",),
    "fp8_unpack_kernel": ("fp8_unpack_kernel",),
    "topk_select_kernel": ("topk_select_kernel",),
}
# the kernels a lone batch of the CNN slice runs for each codec's hop
# (one cooperative launch each pack and top-k)
HOP_KERNELS = {"int8": ("pack_fused_kernel<Int8Sym>", "int8_unpack_kernel"),
               "fp8": ("pack_fused_kernel<Fp8E4M3>", "fp8_unpack_kernel"),
               "topk": ("topk_select_kernel",)}
# the streamed-stage phase: batches, the session's wait for a result, and
# a watchdog that ends the process if the phase hangs past its limit
STREAM_BATCHES, STREAM_TIMEOUT_S, STREAM_WATCHDOG_S = 20, 60.0, 180.0
# the recovery phase: batches (from seed 0), the pipeline's timeout (the
# workers' ready handshake included) and stall window, each over one
# standup of four workers on the card (25-29 s), and a watchdog over a
# standup, one rebuild and the stream
RECOVERY_BATCHES, RECOVERY_TIMEOUT_S, RECOVERY_STALL_S = 8, 90.0, 45.0
RECOVERY_WATCHDOG_S = 300.0
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


def is_kernel(key: str, name: str) -> bool:
    """Whether the profiler's kernel name ``key`` is ``CUDA_KERNELS``'
    ``name``."""
    return all(part in key for part in CUDA_KERNELS[name])


def special_inputs(torch, n: int, gen, dev) -> dict:
    """Inputs of ``n`` fp32 elements that the codec kernels must treat as
    their plain versions do: NaNs of different payloads and signs, and
    +-inf and -0.0, among normal values; all values equal; all zeros
    (+0 and -0)."""
    base = torch.randn(n, generator=gen, device=dev) * 3.0
    m = max(1, n // 997)
    pos = torch.randperm(n, generator=gen, device=dev)
    nan = base.clone()
    # quiet NaNs with varied payloads, the sign bit set on two in three
    payload = [(0x7FC00000 | (j * 7919) % 0x400000) - (2 ** 31 if j % 3
               else 0) for j in range(m)]
    nan.view(torch.int32)[pos[:m]] = torch.tensor(payload, dtype=torch.int32,
                                                  device=dev)
    inf = base.clone()
    inf[pos[:m]] = float("inf")
    inf[pos[m:2 * m]] = float("-inf")
    inf[pos[2 * m:3 * m]] = -0.0
    zeros = torch.zeros(n, device=dev)
    zeros[::2] = -0.0
    return {"NaN payloads": nan, "inf and -0.0": inf,
            "all equal": torch.full((n,), -1.5, device=dev),
            "all zeros": zeros}


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


def fp8_inf_bytes(torch, ops, ref, dev) -> None:
    """fp8 of ``[1, inf, -2, 0.5, -inf, -0.0]`` on the card and with the
    plain version on the CPU: the scale is inf, so +-inf times its
    reciprocal 0 is NaN, and that NaN's byte (0x7F or 0xFF) is the
    platform's; every other byte, and the scale, must agree."""
    vals = [1.0, math.inf, -2.0, 0.5, -math.inf, -0.0]
    x = torch.tensor(vals, dtype=torch.float32)
    q, s = ops.fp8_pack(x.to(dev))
    q_cpu, s_cpu = ref.fp8_pack_ref(x)
    card = bytes(q.view(torch.uint8).cpu().tolist())
    cpu = bytes(q_cpu.view(torch.uint8).tolist())
    log(f"fp8 of {vals}: card {card.hex(' ')} (scale {float(s)}), cpu "
        f"{cpu.hex(' ')} (scale {float(s_cpu)})")

    def nan(b):
        return b & 0x7F == 0x7F
    if ([nan(b) for b in card] != [nan(b) for b in cpu]
            or any(a != b for a, b in zip(card, cpu) if not nan(b))
            or s.cpu().view(torch.int32) != s_cpu.view(torch.int32)):
        raise AssertionError("fp8 of +-inf: the card and the CPU differ "
                             "off the NaN bytes")
    same = "equal too" if card == cpu else "different (each platform's NaN)"
    log(f"fp8 of +-inf: card and CPU agree off the NaN bytes; the NaN bytes "
        f"are {same}")


def concurrent_stages(torch, Worker, dev) -> tuple:
    """Two ``Worker``s driven at once from two threads: a heavy one (20
    fp32 products of 4096 x 4096 a batch, 5 batches) and a light one (an
    elementwise op on 64 floats, 50 batches) → (heavy, light) with their
    stats of those batches alone.  On their own streams the light one's
    ``exe_s`` ends with its own kernels, not the heavy one's."""
    import threading
    a = torch.randn(4096, 4096, device=dev)

    def heavy(x):
        for _ in range(20):
            x = (a @ x).clamp_(-1.0, 1.0)
        return x

    workers = [Worker(name, types.SimpleNamespace(layers=[fn]), 0, 1,
                      "lightweight", dev)
               for name, fn in (("heavy", heavy), ("light", lambda x: x * 2))]
    inputs = [torch.randn(4096, 4096, device=dev), torch.randn(64, device=dev)]
    for w, x in zip(workers, inputs):            # warm up, then count anew
        w.warmup(x)
        w.stats.exe_s = w.stats.calls = 0
    torch.cuda.synchronize()
    go = threading.Event()

    def drive(w, x, n):
        go.wait()
        for _ in range(n):
            w.run(x)
    threads = [threading.Thread(target=drive, args=(w, x, n), daemon=True)
               for w, x, n in zip(workers, inputs, (5, 50))]
    for t in threads:
        t.start()
    go.set()
    for t in threads:
        t.join(STREAM_WATCHDOG_S)
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"concurrent stages still ran after "
                             f"{STREAM_WATCHDOG_S} s")
    return tuple(workers)


def streamed_stages(torch, pipe, x) -> dict:
    """``pipe`` (the CNN slice, every hop with its codec) streamed under
    torch.profiler → the wall time, each stage's ``exe_s`` and their
    sum, the device's busy time (the union of the kernels' spans) and
    the kernels' summed time, in ms.  A watchdog ends the process if the
    run hangs (the cooperative codec kernels share the card with other
    streams' kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dog = watchdog(STREAM_WATCHDOG_S, "the streamed run")
    try:
        pipe.warmup(x)
        pipe.run_one(x)
        pipe._reset_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pipe.stream(x, STREAM_BATCHES)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        stats = pipe.stage_stats()
    finally:
        dog.cancel()
    if [s.calls for s in stats] != [STREAM_BATCHES] * len(stats):
        raise AssertionError(f"streamed stages ran {[s.calls for s in stats]}"
                             f" batches, expected {STREAM_BATCHES} each")
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    exe = [s.exe_s * 1e3 for s in stats]
    return dict(wall_ms=wall_ms, stage_exe_ms=exe, sum_exe_ms=sum(exe),
                busy_ms=busy_us / 1e3, spans=len(spans),
                kernel_sum_ms=sum(b - a for a, b in spans) / 1e3)


def hop_launches(codecs) -> list[dict[str, int]]:
    """The ``ops`` kernels each stage's process must launch for one
    batch of the CNN slice: stage i packs hop i's codec, stage i + 1
    unpacks it (top-k unpacks by a scatter, with no kernel)."""
    pack = {"int8": "int8_pack", "fp8": "fp8_pack", "topk": "topk_select"}
    unpack = {"int8": "int8_unpack", "fp8": "fp8_unpack"}
    want = [{} for _ in range(len(codecs) + 1)]
    for i, codec in enumerate(codecs):
        want[i][pack[codec]] = 1
        if codec in unpack:
            want[i + 1][unpack[codec]] = 1
    return want


def socket_phase(torch, model, cuts, scen, x, emu_y, emu_res, smi) -> dict:
    """The CNN slice with every stage a spawned worker process on the
    card, every hop loopback TCP, the sanitizer on: the output against
    the emulated pipeline's ``emu_y`` bit for bit, each process's
    launch counts against ``hop_launches``, ``measure`` beside the
    emulated ``emu_res``, ``measure_hop`` at the hops' sizes, then one
    stage SIGKILLed mid-stream → ``measure``'s result and the
    ``measure_hop`` medians (us a transfer by codec and size)."""
    from repro_torch.runtime import EdgePipeline, drain_violations
    from repro_torch.runtime.transport import TransportError, measure_hop
    drain_violations()
    t0 = time.perf_counter()
    pipe = EdgePipeline(model, cuts, scen, transport="socket", device="cuda",
                        sanitize=True, timeout_s=STREAM_TIMEOUT_S)
    procs = list(pipe._engine._procs)
    try:
        log(f"socket [{smi}]: {len(procs)} worker processes up in "
            f"{time.perf_counter() - t0:.2f} s")
        pipe.warmup(x)
        pipe._reset_stats()
        y, lat, hop_t = pipe.run_one(x)
        lone = pipe.stage_stats()
        want = hop_launches(pipe.codecs)
        for i, st in enumerate(lone):
            log(f"  stage {i} on {st.device}: launches {json.dumps(st.launches)}")
        if [s.launches for s in lone] != want:
            raise AssertionError(f"socket: per-process launches "
                                 f"{[s.launches for s in lone]}, expected "
                                 f"{want}")
        if not all(s.device.startswith("cuda") for s in lone):
            raise AssertionError(f"socket: stage devices "
                                 f"{[s.device for s in lone]}")
        if not torch.equal(y, emu_y):
            raise AssertionError(f"socket: output differs from the emulated "
                                 f"pipeline's by {float((y - emu_y).abs().max())}")
        log(f"socket [{smi}]: run_one output == the emulated pipeline's "
            f"(torch.equal); latency {lat * 1e3:.3f} ms, per-hop wire "
            f"{[round(h * 1e3, 4) for h in hop_t]} ms")
        res = pipe.measure(lambda: x, n_batches=STREAM_BATCHES)
        streamed = pipe.stage_stats()
        warm = sorted(pipe.run_one(x)[1] * 1e3 for _ in range(6))
        log(f"socket [{smi}]: lone-batch latency after measure, 6 run_one: "
            f"{[round(w, 3) for w in warm]} ms (median "
            f"{(warm[2] + warm[3]) / 2:.3f})")
        many = [{k: v * STREAM_BATCHES for k, v in w.items()} for w in want]
        if [s.launches for s in streamed] != many:
            raise AssertionError(f"socket: streamed launches "
                                 f"{[s.launches for s in streamed]}, expected "
                                 f"{many}")
        log(f"socket [{smi}]: measure latency {res.latency_s * 1e3:.3f} ms, "
            f"throughput {res.throughput:.3f} samples/s, stage exe_s "
            f"{[round(e * 1e3, 3) for e in res.stage_exe_s]} ms, hop net "
            f"{[round(h * 1e3, 4) for h in res.hop_net_s]} ms, mem "
            f"{[round(m, 3) for m in res.mem_pct]} %")
        log(f"  emulated (slice phase): measure latency "
            f"{emu_res.latency_s * 1e3:.3f} ms, throughput "
            f"{emu_res.throughput:.3f} samples/s, stage exe_s "
            f"{[round(e * 1e3, 3) for e in emu_res.stage_exe_s]} ms, hop net "
            f"{[round(h * 1e3, 4) for h in emu_res.hop_net_s]} ms")
        for i, net in enumerate(pipe.nets):
            n = net.total_transfers
            log(f"  hop {i} ({pipe.codecs[i]}): {n} transfers, receiver-"
                f"measured wire {net.total_elapsed_s / n * 1e3:.4f} ms a "
                f"transfer, wire {net.total_bytes // n} B, raw "
                f"{net.total_raw_bytes // n} B a transfer")
        bad = drain_violations()
        if bad:
            raise AssertionError("socket: sanitizer violations: "
                                 + "; ".join(v.render() for v in bad))
        log(f"socket: launches in the stage processes, {STREAM_BATCHES} "
            f"streamed batches: {json.dumps([s.launches for s in streamed])}; "
            f"no sanitizer violation")

        # one stage SIGKILLed mid-stream: results() raises, nothing hangs
        t1 = time.perf_counter()
        try:
            with pipe.session(inflight=4) as s:
                s.submit(x)
                list(s.results())
                procs[1].kill()
                procs[1].join(5.0)
                for _ in range(8):
                    s.submit(x)
                list(s.results())
            raise AssertionError("socket: a killed stage raised nothing")
        except TransportError as e:
            waited = time.perf_counter() - t1
            if waited > STREAM_TIMEOUT_S:
                raise AssertionError(f"socket: the killed stage took "
                                     f"{waited:.1f} s to surface") from e
            log(f"socket: stage 1 SIGKILLed: TransportError after "
                f"{waited:.3f} s ({e})")
    finally:
        pipe.close()
    alive = [p.name for p in procs if p.is_alive()]
    if alive:
        raise AssertionError(f"socket: live workers after close: {alive}")
    log("socket: close() left no live worker process")

    # one hop alone, at the slice's three activation sizes
    sizes = sorted({net.total_raw_bytes // net.total_transfers
                    for net in pipe.nets})
    return {"measure": res,
            "hop_us": hop_medians(measure_hop, "socket", sizes, smi)}


def hop_medians(measure_hop, transport, sizes, smi, beside=None) -> dict:
    """``measure_hop`` over ``transport`` at ``sizes``, codec none and
    int8, the sink unpacking on the card → {codec: {size: median us a
    transfer}}, each printed beside ``beside``'s (another transport's)."""
    out = {}
    for codec in ("none", "int8"):
        got = measure_hop(transport, sizes, n_per_size=STREAM_BATCHES,
                          codec=codec, device="cuda")
        med = out[codec] = {n: sorted(v)[len(v) // 2] * 1e6
                            for n, v in got.items()}
        log(f"measure_hop [{smi}] {transport} codec={codec}, sink unpacking "
            f"on the card: median us a transfer "
            f"{json.dumps({n: round(m, 1) for n, m in med.items()})}")
        if beside is not None:
            log(f"  socket (phase 5c) codec={codec}: "
                f"{json.dumps({n: round(m, 1) for n, m in beside[codec].items()})}")
    return out


def shm_names(pipe) -> set[str]:
    """Every shared-memory segment of ``pipe``'s live tier: each ring's
    control segment and every payload slot named in its tables."""
    return {name for pair in pipe._engine._pairs for end in pair
            for name in end.segment_names()}


def spy_segments(pipe) -> tuple[set, list]:
    """Record the segments and worker processes of every tier ``pipe``
    tears down (a recovery reaps the old tier) → (names, processes),
    filled as tiers go; the live tier's are read at the caller's end."""
    eng, names, procs = pipe._engine, set(), list(pipe._engine._procs)
    teardown = eng._teardown_workers

    def spied():
        names.update(shm_names(pipe))
        procs.extend(p for p in eng._procs if p not in procs)
        teardown()
    eng._teardown_workers = spied
    return names, procs


def left_behind(what, names, procs) -> None:
    """Raise if a worker of ``procs`` lives or a segment of ``names``
    is still in /dev/shm."""
    alive = [p.name for p in procs if p.is_alive()]
    left = sorted(n for n in names if os.path.exists(f"/dev/shm/{n}"))
    if alive or left:
        raise AssertionError(f"{what}: live workers {alive}, segments left "
                             f"{left}")
    log(f"{what}: close() left no live worker ({len(procs)} spawned) and "
        f"none of the pipeline's {len(names)} shared-memory segments")


def standup_split(what, eng, t_total=None) -> None:
    """Print the last standup of ``eng`` (``_ProcessEngine.standup``):
    per worker, when its spawn began, how long ``Process.start``
    blocked, spawn to its body running (interpreter, ``import torch``,
    spec unpickled) and the model rebuilt on the card (CUDA context
    included); and the tier's spawn to the last ready."""
    split = eng.standup

    def col(key):
        return [round(w[key], 3) for w in split["workers"]]
    log(f"{what}: standup {split['total_s']:.3f} s spawn to the last "
        f"ready" + (f" (constructor {t_total:.3f} s)" if t_total else ""))
    log(f"  per worker: spawn began at {col('offset_s')} s, "
        f"Process.start blocked {col('start_call_s')} s, spawn->body "
        f"(interpreter, import torch, spec unpickled) {col('spawn_s')} s, "
        f"model rebuilt on the card (CUDA context) {col('build_s')} s")


def watchdog(seconds: float, what: str):
    """A started timer that ends the process if ``what`` still runs
    after ``seconds`` (cancel it when done)."""
    import threading

    def hung():
        print(f"chip_smoke: {what} still ran after {seconds} s",
              file=sys.stderr, flush=True)
        os._exit(3)
    dog = threading.Timer(seconds, hung)
    dog.daemon = True
    dog.start()
    return dog


def shmem_phase(torch, model, cuts, scen, x, emu_y, emu_res, sock, smi,
                xs) -> list:
    """Phase 5d: the CNN slice over the shared-memory ring, sanitizer
    on: the output against the emulated pipeline's ``emu_y`` bit for
    bit, each process's launches against ``hop_launches`` (1 and 20
    batches), ``measure`` beside the emulated and socket runs, the
    standup split, ``measure_hop`` beside socket's, and no worker or
    segment left → the outputs of the unfaulted ``xs`` (phase 5e's
    reference)."""
    from repro_torch.runtime import EdgePipeline, drain_violations
    from repro_torch.runtime.transport import measure_hop
    drain_violations()
    t0 = time.perf_counter()
    pipe = EdgePipeline(model, cuts, scen, transport="shmem", device="cuda",
                        sanitize=True, timeout_s=STREAM_TIMEOUT_S)
    procs = list(pipe._engine._procs)
    try:
        standup_split(f"shmem [{smi}]", pipe._engine,
                      time.perf_counter() - t0)
        pipe.warmup(x)
        pipe._reset_stats()
        y, lat, hop_t = pipe.run_one(x)
        lone = pipe.stage_stats()
        want = hop_launches(pipe.codecs)
        for i, st in enumerate(lone):
            log(f"  stage {i} on {st.device}: launches {json.dumps(st.launches)}")
        if [s.launches for s in lone] != want:
            raise AssertionError(f"shmem: per-process launches "
                                 f"{[s.launches for s in lone]}, expected "
                                 f"{want}")
        if not all(s.device.startswith("cuda") for s in lone):
            raise AssertionError(f"shmem: stage devices "
                                 f"{[s.device for s in lone]}")
        if not torch.equal(y, emu_y):
            raise AssertionError(f"shmem: output differs from the emulated "
                                 f"pipeline's by {float((y - emu_y).abs().max())}")
        log(f"shmem [{smi}]: run_one output == the emulated pipeline's "
            f"(torch.equal); latency {lat * 1e3:.3f} ms, per-hop wire "
            f"{[round(h * 1e3, 4) for h in hop_t]} ms")
        res = pipe.measure(lambda: x, n_batches=STREAM_BATCHES)
        streamed = pipe.stage_stats()
        # lone batches again, now that every slot of the feed ring has
        # been created and touched (measure's lone batches are the
        # feed ring's first ones: each grows a fresh slot)
        warm = sorted(pipe.run_one(x)[1] * 1e3 for _ in range(6))
        many = [{k: v * STREAM_BATCHES for k, v in w.items()} for w in want]
        if [s.launches for s in streamed] != many:
            raise AssertionError(f"shmem: streamed launches "
                                 f"{[s.launches for s in streamed]}, expected "
                                 f"{many}")
        for label, r in (("shmem", res), ("  socket (phase 5c)",
                                          sock["measure"]),
                         ("  emulated (slice phase)", emu_res)):
            log(f"{label} [{smi}]: measure latency {r.latency_s * 1e3:.3f} "
                f"ms, throughput {r.throughput:.3f} samples/s, stage exe_s "
                f"{[round(e * 1e3, 3) for e in r.stage_exe_s]} ms, hop net "
                f"{[round(h * 1e3, 4) for h in r.hop_net_s]} ms")
        log(f"shmem [{smi}]: lone-batch latency with the feed ring's slots "
            f"warm, 6 run_one: {[round(w, 3) for w in warm]} ms (median "
            f"{(warm[2] + warm[3]) / 2:.3f})")
        for i, net in enumerate(pipe.nets):
            n = net.total_transfers
            log(f"  hop {i} ({pipe.codecs[i]}): {n} transfers, receiver-"
                f"measured wire {net.total_elapsed_s / n * 1e3:.4f} ms a "
                f"transfer, wire {net.total_bytes // n} B, raw "
                f"{net.total_raw_bytes // n} B a transfer")
        bad = drain_violations()
        if bad:
            raise AssertionError("shmem: sanitizer violations: "
                                 + "; ".join(v.render() for v in bad))
        log(f"shmem: launches in the stage processes, {STREAM_BATCHES} "
            f"streamed batches: {json.dumps([s.launches for s in streamed])}; "
            f"no sanitizer violation")
        # phase 5e's reference: the same batches through an unfaulted run
        with pipe.session() as s:
            for xb in xs:
                s.submit(xb)
            unfaulted = s.drain()
        names = shm_names(pipe)
    finally:
        pipe.close()
    left_behind("shmem", names, procs)
    sizes = sorted({net.total_raw_bytes // net.total_transfers
                    for net in pipe.nets})
    hop_medians(measure_hop, "shmem", sizes, smi, beside=sock["hop_us"])
    return unfaulted


def recovery_phase(torch, model, cuts, scen, xs, unfaulted, smi) -> None:
    """Phase 5e: the slice supervised over shmem, sanitizer on, under a
    watchdog sized for one rebuild: stage 1 SIGKILLed after batch 3 —
    the outputs equal the unfaulted run's bit for bit, with exactly one
    ``restart`` recovery that replayed at least one batch — then the
    feed's batch 2 sent twice — equal outputs, no recovery, one
    ``frame-dup`` injection and exactly ``hop_launches`` a batch.  No
    violation, no worker and no segment left after either."""
    from repro_torch.runtime import (EdgePipeline, FaultPlan,
                                     drain_injections, drain_recoveries,
                                     drain_violations)
    runs = {"kill": FaultPlan().kill_worker(stage=1, at_seq=3),
            "dup": FaultPlan().duplicate(hop=-1, at_seq=2)}
    for what, plan in runs.items():
        drain_recoveries()
        drain_violations()
        drain_injections()
        dog = watchdog(RECOVERY_WATCHDOG_S, f"the recovery phase ({what})")
        try:
            pipe = EdgePipeline(model, cuts, scen, transport="shmem",
                                device="cuda", sanitize=True, fault_plan=plan,
                                timeout_s=RECOVERY_TIMEOUT_S,
                                stall_timeout_s=RECOVERY_STALL_S)
            names, procs = spy_segments(pipe)
            try:
                pipe.warmup(xs[0])
                pipe._reset_stats()
                t0 = time.perf_counter()
                with pipe.session() as s:
                    for xb in xs:
                        s.submit(xb)
                    outs = s.drain()
                    s.checkpoint(probe=False)
                wall = time.perf_counter() - t0
                launches = [st.launches for st in pipe.stage_stats()]
                names |= shm_names(pipe)
                procs.extend(p for p in pipe._engine._procs
                             if p not in procs)
                eng = pipe._engine
            finally:
                pipe.close()
        finally:
            dog.cancel()
        if len(outs) != len(unfaulted) or not all(
                torch.equal(a, b) for a, b in zip(outs, unfaulted)):
            raise AssertionError(f"recovery ({what}): outputs differ from "
                                 f"the unfaulted run")
        recs, injected = drain_recoveries(), drain_injections()
        bad = drain_violations()
        if bad:
            raise AssertionError(f"recovery ({what}): sanitizer violations: "
                                 + "; ".join(v.render() for v in bad))
        log(f"recovery [{smi}] ({what}): {len(outs)} outputs == the unfaulted "
            f"run's (torch.equal, in order) in {wall:.3f} s; recoveries "
            f"{[r.render() for r in recs]}; injections "
            f"{[(i.kind, i.hop, i.seq) for i in injected]}; no sanitizer "
            f"violation")
        if what == "kill":
            if [r.kind for r in recs] != ["restart"] \
                    or recs[0].batches_replayed < 1:
                raise AssertionError(f"recovery (kill): records {recs}")
            r = recs[0]
            log(f"recovery [{smi}]: detect_s {r.detect_s:.6f} restart_s "
                f"{r.restart_s:.6f} replay_s {r.replay_s:.6f} "
                f"({r.batches_replayed} batches replayed, reason "
                f"{r.reason}, stage {r.stage})")
            standup_split("  rebuilt tier", eng)
        else:
            want = [{k: v * len(xs) for k, v in w.items()}
                    for w in hop_launches(pipe.codecs)]
            if recs or [(i.kind, i.hop) for i in injected] \
                    != [("frame-dup", -1)] or launches != want:
                raise AssertionError(f"recovery (dup): records {recs}, "
                                     f"injections {injected}, launches "
                                     f"{launches} (expected {want})")
            log(f"recovery (dup): the duplicate was absorbed by the "
                f"receiver's wire-seq dedup; launches {json.dumps(launches)}")
        left_behind(f"recovery ({what})", names, procs)


def lm_tol(torch, dtype) -> float:
    """rtol = atol of tests/test_kernels.py:14-15 for ``dtype``."""
    return 2e-2 if dtype == torch.bfloat16 else 2e-5


def check_lm_kernels(torch, ops, ref, dev) -> dict[str, float]:
    """Each LM kernel against its plain version, fp32 and bf16, at the
    slice's shapes and ragged ones → max |kernel - plain| per kernel."""
    gen = torch.Generator(device=dev).manual_seed(2)
    err = {name: 0.0 for name in LM_REPLACES}
    by_dtype = {}

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def hold(name, out, exp, what):
        tol = lm_tol(torch, exp.dtype)
        d = (out.float() - exp.float()).abs()
        bad = (out.shape != exp.shape or out.dtype != exp.dtype
               or not bool(torch.isfinite(out).all())
               or bool((d > tol + tol * exp.float().abs()).any()))
        worst = float(d.max()) if d.numel() else 0.0
        if bad:
            raise AssertionError(f"{name} {what} {exp.dtype}: kernel and "
                                 f"plain version differ (max {worst})")
        err[name] = max(err[name], worst)
        key = (name, str(exp.dtype).split(".")[-1])
        by_dtype[key] = max(by_dtype.get(key, 0.0), worst)

    from repro_torch.kernels import decode_attention as dk
    H, KV, hd = 16, 8, 128
    for dtype in (torch.float32, torch.bfloat16):
        # the slice's heads, ragged S and T, every registry head dim (64
        # whisper, 96 phi-3-vision, 112 zamba2, 128 the rest; 16 the
        # reduced configs), granite-20b's MQA group, causal S < T
        for B, S, T, h, kv, d, causal in (
                (LM_B, LM_S, LM_S, H, KV, hd, True),
                (2, 1000, 1000, H, KV, hd, True),
                (2, 64, 1500, H, KV, hd, False),
                (1, 300, 300, 4, 2, 64, True),
                (1, 300, 300, 4, 4, 96, True),
                (1, 300, 300, 4, 4, 112, False),
                (2, 200, 200, 4, 2, 16, True),
                (1, 256, 256, 48, 1, hd, True),
                (1, 77, 300, 4, 2, hd, True)):
            q = randn((B, S, h, d), dtype)
            k, v = randn((B, T, kv, d), dtype), randn((B, T, kv, d), dtype)
            hold("flash_attention", ops.flash_attention(q, k, v, causal=causal),
                 ref.flash_attention_ref(q, k, v, causal=causal),
                 f"B={B} S={S} T={T} H={h} KV={kv} hd={d} causal={causal}")
        smax = LM_S + LM_NEW
        q = randn((LM_B, H, hd), dtype)
        kc = randn((LM_B, smax, KV, hd), dtype)
        vc = randn((LM_B, smax, KV, hd), dtype)
        for pos in (0, 1, 511, smax - 1):
            hold("decode_attention", ops.decode_attention(q, kc, vc, pos),
                 ref.decode_attention_ref(q, kc, vc, pos),
                 f"Smax={smax} pos={pos}")
        # forced split counts, empty splits included, against the plain
        # version and the plain split-and-combine
        for pos in (0, smax - 1):
            for splits in (1, 2, 7, pos + 3):
                out = dk.decode_attention(q, kc, vc, pos, splits=splits)
                for exp in (ref.decode_attention_ref(q, kc, vc, pos),
                            ref.decode_attention_split_ref(q, kc, vc, pos,
                                                           splits)):
                    hold("decode_attention", out, exp,
                         f"Smax={smax} pos={pos} splits={splits}")
        # the LM slice's rows (d_model, q/k heads) at prefill and decode,
        # the SSM slice's (d_model) and a ragged width
        for shape in ((LM_B * LM_S, 2048), (LM_B * LM_S * H, hd),
                      (LM_B, 2048), (LM_B * H, hd), (SSM_B * SSM_S, SSM_D),
                      (SSM_B, SSM_D), (1000, 3)):
            x, sc = randn(shape, dtype), randn((shape[-1],), dtype)
            hold("fused_rmsnorm", ops.fused_rmsnorm(x, sc),
                 ref.fused_rmsnorm_ref(x, sc), f"shape={shape}")
    torch.cuda.synchronize()
    log("lm kernels: within rtol = atol = 2e-5 (fp32) / 2e-2 (bf16) of the "
        "plain versions; max |diff| "
        + ", ".join(f"{n} {d} {e:.3g}" for (n, d), e in by_dtype.items()))
    return err


def time_lm_kernels(torch, ops, ref, dev) -> dict[str, dict]:
    """Each LM kernel at the slice's bf16 shapes: ms, bound, plain ms and
    one PyTorch call's ms.  Decode rotates over three caches (three times
    the 50 MB L2), as its layers do on the path."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(3)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    B, S, H, KV, hd = LM_B, LM_S, 16, 8, 128
    rows = {}
    q, k, v = randn(B, S, H, hd), randn(B, S, KV, hd), randn(B, S, KV, hd)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    flops = 4 * B * H * S * S * hd / 2
    nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    rows["flash_attention"] = dict(
        shape=f"q ({B},{S},{H},{hd}) k/v ({B},{S},{KV},{hd}) causal bf16",
        ms=device_ms(torch, "flash_attention",
                     lambda: ops.flash_attention(q, k, v), 10),
        plain_ms=device_ms(torch, "flash_attention plain",
                           lambda: ref.flash_attention_ref(q, k, v), 5),
        library_ms=device_ms(
            torch, "scaled_dot_product_attention",
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                   enable_gqa=True), 10),
        flops=flops, bytes=nbytes)
    del q, k, v, qt, kt, vt

    smax, pos = LM_S + LM_NEW, LM_S + LM_NEW - 1
    q = randn(B, H, hd)
    caches = [(randn(B, smax, KV, hd), randn(B, smax, KV, hd))
              for _ in range(3)]
    lib_caches = [tuple(c[:, :pos + 1].transpose(1, 2).contiguous()
                        for c in pair) for pair in caches]
    q4 = q[:, :, None]
    cyc, pcyc, lcyc = (itertools.cycle(c) for c in (caches, caches,
                                                    lib_caches))
    rows["decode_attention"] = dict(
        shape=f"q ({B},{H},{hd}) caches ({B},{smax},{KV},{hd}) pos {pos} bf16",
        ms=device_ms(torch, "decode_attention",
                     lambda: ops.decode_attention(q, *next(cyc), pos), 30),
        plain_ms=device_ms(torch, "decode_attention plain",
                           lambda: ref.decode_attention_ref(q, *next(pcyc),
                                                            pos), 30),
        library_ms=device_ms(
            torch, "scaled_dot_product_attention",
            lambda: F.scaled_dot_product_attention(q4, *next(lcyc),
                                                   enable_gqa=True), 30),
        flops=4 * B * H * (pos + 1) * hd,
        bytes=2 * (2 * B * (pos + 1) * KV * hd + 2 * B * H * hd))
    del caches, lib_caches

    rows_n, d = B * S, 2048
    x, sc = randn(rows_n, d), randn(d)
    rows["fused_rmsnorm"] = dict(
        shape=f"x ({rows_n},{d}) scale ({d},) bf16",
        ms=device_ms(torch, "fused_rmsnorm",
                     lambda: ops.fused_rmsnorm(x, sc), 50),
        plain_ms=device_ms(torch, "fused_rmsnorm plain",
                           lambda: ref.fused_rmsnorm_ref(x, sc), 50),
        library_ms=device_ms(torch, "F.rms_norm",
                             lambda: F.rms_norm(x, (d,), sc, eps=1e-6), 50),
        flops=4 * rows_n * d, bytes=2 * (2 * rows_n * d + d))
    for name, t in rows.items():
        by_ops = t["flops"] / BF16_FLOP_PER_S
        by_bytes = t["bytes"] / HBM_BYTES_PER_S
        t["bound_ms"] = max(by_ops, by_bytes) * 1e3
        t["bound_by"] = "operations" if by_ops > by_bytes else "bytes"
        log(f"  {name:16s} {t['shape']}: kernel {t['ms']:.4f} ms  bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']})  plain "
            f"{t['plain_ms']:.4f} ms  library {t['library_ms']:.4f} ms")
    return rows


def rms_shapes(cfg, B: int, S: int, new: int) -> dict[tuple, int]:
    """Each row shape the serving path hands RMSNorm → its launches over
    the slice: two prefills (d_model rows of every token, the q and k
    heads' rows with qk-norm; the final norm of the last token) and
    ``new`` decode steps (the same for one token)."""
    D, L = cfg.d_model, cfg.n_layers
    per_layer = 1 if cfg.family == "ssm" else 2
    out: dict[tuple, int] = {}

    def add(shape, n):
        out[shape] = out.get(shape, 0) + n
    for tokens, times in ((B * S, 2), (B, new)):
        add((tokens, D), per_layer * L * times)
        if cfg.qk_norm:
            add((tokens * cfg.n_heads, cfg.hd), L * times)
            add((tokens * cfg.n_kv_heads, cfg.hd), L * times)
    add((B, D), 2 + new)                      # the final norms
    return out


def time_rmsnorm_shapes(torch, ops, dev, paths) -> dict[str, dict]:
    """RMSNorm (bf16 rows and scale) at every row shape of each serving
    path in ``paths`` ({name: {shape: launches}}): the kernel, the scalar
    kernel it replaced (still the path for rows it cannot take, here
    reached through a view of x one element into its storage, off 16
    bytes) and ``F.rms_norm``, each ms beside the shape's byte bound;
    then each path's launch-weighted totals."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(9)
    bf = torch.bfloat16
    times = {}
    for shape in sorted({sh for p in paths.values() for sh in p},
                        key=lambda sh: -sh[0] * sh[1]):
        rows, d = shape
        x_off = torch.randn(rows * d + 1, generator=gen, device=dev).to(bf)
        x = x_off[:-1].view(rows, d)
        x_off = x_off[1:].view(rows, d)
        sc = torch.randn(d, generator=gen, device=dev).to(bf)
        iters = 50 if rows * d > 1 << 20 else 200
        t = times[shape] = dict(
            ms=device_ms(torch, f"fused_rmsnorm {shape}",
                         lambda: ops.fused_rmsnorm(x, sc), iters),
            scalar_ms=device_ms(torch, f"fused_rmsnorm scalar {shape}",
                                lambda: ops.fused_rmsnorm(x_off, sc),
                                iters),
            library_ms=device_ms(torch, f"F.rms_norm {shape}",
                                 lambda: F.rms_norm(x, (d,), sc, eps=1e-6),
                                 iters),
            bound_ms=2 * (2 * rows * d + d) / HBM_BYTES_PER_S * 1e3)
        log(f"  fused_rmsnorm ({rows},{d}) bf16: kernel {t['ms']:.5f} ms  "
            f"scalar kernel {t['scalar_ms']:.5f} ms  F.rms_norm "
            f"{t['library_ms']:.5f} ms  bound {t['bound_ms']:.5f} ms (bytes)")
        del x, x_off, sc
    out = {}
    for name, shapes in paths.items():
        tot = {k: sum(n * times[sh][k] for sh, n in shapes.items())
               for k in ("ms", "scalar_ms", "library_ms", "bound_ms")}
        out[name] = dict(launches=sum(shapes.values()), **tot)
        log(f"  fused_rmsnorm over the {name} slice ({out[name]['launches']} "
            f"launches): kernel {tot['ms']:.4f} ms  scalar kernel "
            f"{tot['scalar_ms']:.4f} ms  F.rms_norm {tot['library_ms']:.4f} "
            f"ms  bound {tot['bound_ms']:.4f} ms")
    return out


def rms_counted(launches: dict[str, int], shapes: dict[tuple, int],
                name: str) -> None:
    """The RMSNorm launches a serve counted must be those its row shapes
    were weighted with."""
    if launches["fused_rmsnorm"] != sum(shapes.values()):
        raise AssertionError(f"{name}: {launches['fused_rmsnorm']} RMSNorm "
                             f"launches, the row shapes count "
                             f"{sum(shapes.values())}")


def lm_expect(cfg, args) -> dict[str, int]:
    """The LM kernels' launches on the dense serving path: two prefills
    (warm-up + timed) and ``new_tokens`` decode steps (warm-up + the
    timed rest); per prefill or step 4 norms a layer (ln1, ln2, q_norm,
    k_norm) and the final one."""
    steps = 2 + args.new_tokens
    return {"flash_attention": 2 * cfg.n_layers,
            "decode_attention": cfg.n_layers * args.new_tokens,
            "fused_rmsnorm": (4 * cfg.n_layers + 1) * steps}


def ssm_expect(cfg, args) -> dict[str, int]:
    """The same for the SSM path: per prefill one gated scan a chunk a
    layer (the model's chunking), per decode step one a layer, and no
    ungated scan; one norm a layer and the final one per prefill or
    step."""
    S = args.prompt_len
    L = min(cfg.ssm_chunk, S)
    n_chunks = S // L if S % L == 0 else 1
    return {"mamba1_scan_chunk": cfg.n_layers * (2 * n_chunks
                                                 + args.new_tokens),
            "fused_rmsnorm": (cfg.n_layers + 1) * (2 + args.new_tokens)}


def serve_slice(torch, ops, serve, name, argv, expect_of) -> dict[str, int]:
    """A serving path through its entry point, counters reset just
    before; each kernel's count must be ``expect_of(cfg, args)``'s, 0
    where that names none; → the launch counts of that run."""
    from repro_torch import configs
    args = serve.parse_args(argv)
    cfg = (configs.reduced if args.reduced else configs.get)(args.arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serve.main(argv)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    expect = {k: 0 for k in launches}
    expect.update(expect_of(cfg, args))
    log(f"{name} slice: prefill {res['prefill_ms']:.2f} ms "
        f"({res['prefill_tok_s']:.0f} tok/s), decode "
        f"{res['decode_ms_per_token']:.3f} ms/token "
        f"({res['decode_tok_s']:.1f} tok/s aggregate), peak allocated "
        f"{peak / 2**30:.3f} GiB ({peak} B)")
    log(f"{name} slice: launches {json.dumps(launches)}")
    wrong = {k: (launches[k], n) for k, n in expect.items()
             if launches[k] != n}
    if wrong:
        raise AssertionError(f"{name} kernel launches (got, expected): "
                             f"{wrong}")
    toks = res["tokens"]
    if tuple(toks.shape) != (args.batch, args.new_tokens) or not res["valid"]:
        raise AssertionError(f"bad generated tokens: {tuple(toks.shape)}")
    return launches


def route_logits(lm, cfg, model, inputs, cache_len, feed):
    """Prefill logits, then one decode step's logits for each token of
    ``feed`` (teacher-forced); and the final cache."""
    logits, cache = lm.forward_prefill(cfg, model, inputs, cache_len)
    out = [logits]
    for tok in feed:
        logits, cache = lm.forward_decode(cfg, model, tok, cache)
        out.append(logits)
    return out, cache


def held_to(torch, gate, out, cache) -> dict[str, tuple]:
    """A kernel route's logits ``out`` and final ``cache`` against the
    plain route's in ``gate`` → {check: (max |diff| or the number of
    equal prefill argmaxes, whether the check fails)}."""
    tol, plain = gate["tol"], gate["plain"]
    res = {"logits": (
        max(float((a - b).abs().max()) for a, b in zip(out, plain)),
        not all(torch.allclose(a, b, rtol=tol, atol=tol)
                for a, b in zip(out, plain)))}
    agree = int((out[0].argmax(-1) == plain[0].argmax(-1)).sum())
    res["argmax equal"] = (agree,
                           gate["argmax"] and agree != out[0].shape[0])
    for k, t in gate["cache_tol"].items():
        a, b = cache[k].float(), gate["plain_cache"][k].float()
        res[f"cache {k}"] = (float((a - b).abs().max()),
                             not torch.allclose(a, b, rtol=t, atol=t))
    return res


def parity(torch, serve, lm, dev, name, argv, bf16_tol, bf16_argmax,
           bf16_cache_tol=None):
    """Kernel route against the plain ``"xla"`` route on the same weights:
    prefill logits and 4 teacher-forced decode steps at full depth in the
    working dtype within ``bf16_tol`` (with the same prefill argmax when
    ``bf16_argmax``, and each final-cache entry named in
    ``bf16_cache_tol`` within its limit); then fp32, TF32 off, full
    width, 2 layers, within 2e-4 with the same argmax and final cache.
    → the full-depth model, its inputs, the decode feed, and for each of
    the two runs its gate: config, model, each route's logits, the plain
    route's final cache and the limits."""
    def routes(cfg, model, tol, argmax, cache_tol, label):
        kern, ck = route_logits(lm, cfg, model, inputs, cache_len, feed)
        plain, cp = route_logits(lm, cfg.replace(attn_impl="xla"), model,
                                 inputs, cache_len, feed)
        if cache_tol is None:
            cache_tol = {k: tol for k, v in cp.items() if torch.is_tensor(v)}
        gate = dict(cfg=cfg, model=model, label=label, tol=tol,
                    argmax=argmax, cache_tol=cache_tol, kern=kern,
                    plain=plain, plain_cache=cp)
        diffs = [float((a - b).abs().max()) for a, b in zip(kern, plain)]
        cache = {k: float((v.float() - cp[k].float()).abs().max())
                 for k, v in ck.items() if torch.is_tensor(v)}
        res = held_to(torch, gate, kern, ck)
        log(f"{name} parity ({label}): kernel vs plain route max |diff| of "
            f"logits, prefill then 4 decode steps: "
            f"{[f'{d:.3g}' for d in diffs]} (rtol = atol = {tol}); final "
            f"cache {', '.join(f'{k} {d:.3g}' for k, d in cache.items())} "
            f"(held: {', '.join(f'{k} {t}' for k, t in cache_tol.items())}"
            f"); prefill argmax agrees for {res['argmax equal'][0]} of "
            f"{feed.shape[1]}")
        failed = [k for k, (_, bad) in res.items() if bad]
        if failed:
            raise AssertionError(f"{name} parity ({label}): the routes "
                                 f"differ in {failed}")
        return gate

    args = serve.parse_args(argv)
    cfg, model, inputs, cache_len = serve.setup(args)
    g = torch.Generator(device=dev).manual_seed(4)
    feed = torch.randint(0, cfg.vocab, (4, args.batch, 1), generator=g,
                         device=dev, dtype=torch.int32)
    gates = [routes(cfg, model, bf16_tol, bf16_argmax, bf16_cache_tol or {},
                    f"{cfg.dtype}, {cfg.n_layers} layers")]
    cfg32 = cfg.replace(n_layers=2, dtype="float32")
    model32 = lm.init(cfg32, torch.Generator(device=dev).manual_seed(0), dev)
    gates.append(routes(cfg32, model32, 2e-4, True, None,
                        "float32, 2 layers"))
    return cfg, model, inputs, cache_len, feed, gates


def named(key: str, name) -> bool:
    """Whether the profiler's kernel name ``key`` holds ``name``, a string
    or a tuple of its parts."""
    return all(p in key for p in ((name,) if isinstance(name, str) else name))


def lm_profile(torch, cfg, model, inputs, cache_len, label="lm",
               expect=None) -> None:
    """One prefill and one decode step under torch.profiler: device busy
    time by kernel, and that of the elementwise kernels, against the
    step's wall time.  ``expect`` maps each step to the kernel names
    (see ``named``) it must run and those it must not."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    prefill, decode = make_prefill_step(cfg, cache_len), make_decode_step(cfg)
    tok, cache = prefill(model, inputs)
    torch.cuda.synchronize()
    for what in ("prefill", "decode step"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if what == "prefill":
                prefill(model, inputs)
            else:
                decode(model, tok, cache)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [r for r in prof.key_averages()
                if r.device_type == DeviceType.CUDA
                and r.self_device_time_total]
        if not rows:
            log(f"{label} profile ({what}): wall {wall_ms:.2f} ms; the "
                f"profiler saw no device time (busy share not measured)")
            if expect:
                raise AssertionError(f"{label} {what}: no kernel names to "
                                     f"check")
            continue
        busy_ms = sum(r.self_device_time_total for r in rows) / 1e3
        log(f"{label} profile ({what}): wall {wall_ms:.2f} ms under the "
            f"profiler, device busy {busy_ms:.3f} ms (idle share "
            f"{1 - busy_ms / wall_ms:.4f})")
        for r in sorted(rows, key=lambda r: -r.self_device_time_total)[:12]:
            log(f"  {r.self_device_time_total / 1e3:8.3f} ms  x{r.count:<5d} "
                f"{r.key[:90]}")
        elem = [r for r in rows if "elementwise" in r.key]
        log(f"  elementwise kernels: {sum(r.count for r in elem)} launches, "
            f"{sum(r.self_device_time_total for r in elem) / 1e3:.3f} ms "
            f"of the device's busy time")
        if expect:
            need, forbid = expect[what]
            for name in need:
                ran = [r for r in rows if named(r.key, name)]
                if not ran:
                    raise AssertionError(f"{label} {what}: {name} did not run")
                for r in ran:
                    log(f"  ran {r.self_device_time_total / 1e3:8.3f} ms  "
                        f"x{r.count:<5d} {r.key[:90]}")
            wrong = [r.key for r in rows
                     if any(named(r.key, n) for n in forbid)]
            if wrong:
                raise AssertionError(f"{label} {what}: ran {wrong}")


def scan_inputs(torch, dev, B, L, di, N, dtype, seed):
    """The reference sweep's distributions: dt softplus'ed, A negative;
    x, B, C in ``dtype``, the rest fp32."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    dt = torch.nn.functional.softplus(randn(B, L, di))
    A = -torch.exp(randn(di, N) * 0.5)
    return (dt, randn(B, L, di).to(dtype), randn(B, L, N).to(dtype),
            randn(B, L, N).to(dtype), A, randn(B, di, N))


def gated_inputs(torch, dev, B, L, di, N, dtype, seed):
    """Raw dt, dt_bias, x, z, B, C in ``dtype``; A negative, D and h0
    fp32 (``ops.mamba1_scan_chunk``'s order)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    A = -torch.exp(randn(di, N, scale=0.5))
    return (randn(B, L, di).to(dtype), randn(di, scale=0.5).to(dtype),
            randn(B, L, di).to(dtype), randn(B, L, di).to(dtype),
            randn(B, L, N).to(dtype), randn(B, L, N).to(dtype), A,
            randn(di), randn(B, di, N))


def check_ssm_kernel(torch, ops, ref, dev) -> dict[str, float]:
    """Both scan entries against their plain versions → max |kernel -
    plain| of each (bf16 outputs within GATED_BF16_TOL, the rest within
    SCAN_TOL)."""
    bf, f32 = torch.bfloat16, torch.float32
    err = {"ssm_scan_chunk": 0.0, "mamba1_scan_chunk": 0.0}

    def hold(name, what, got, exp):
        for a, b in zip(got, exp):
            tol = GATED_BF16_TOL if a.dtype == bf else SCAN_TOL
            d = float((a.float() - b.float()).abs().max())
            if (a.shape != b.shape or a.dtype != b.dtype
                    or not torch.allclose(a.float(), b.float(), rtol=tol,
                                          atol=tol)):
                raise AssertionError(f"{name} {what}: kernel and plain "
                                     f"version differ (max {d})")
            err[name] = max(err[name], d)

    di, N, L2 = SSM_DI, SSM_N, 2 * SSM_L
    for B, L, dd, n, dtype in ((SSM_B, SSM_L, di, N, bf),
                               (SSM_B, 1, di, N, bf), (2, 64, 128, 16, f32),
                               (1, 32, 256, 8, f32), (2, 16, 64, 16, f32),
                               (3, 40, 200, 8, f32), (2, 33, 200, 16, bf),
                               (2, 33, 200, 8, bf)):
        what = f"({B},{L},{dd},{n}) {dtype}"
        args = scan_inputs(torch, dev, B, L, dd, n, dtype, L + dd)
        hold("ssm_scan_chunk", what, ops.ssm_scan_chunk(*args),
             ref.ssm_scan_chunk_ref(*args))
        args = gated_inputs(torch, dev, B, L, dd, n, dtype, L + dd + 1)
        hold("mamba1_scan_chunk", what, ops.mamba1_scan_chunk(*args),
             ref.mamba1_scan_chunk_ref(*args))
    # two chunks as views of one (B, 2L, .) input, B/C column slices of
    # one projection (dt_rank columns first), z the second half of one
    # in_proj output, y into one buffer, the state in place
    g = torch.Generator(device=dev).manual_seed(6)
    proj = torch.randn(SSM_B, L2, SSM_R + 2 * N, generator=g,
                       device=dev).to(bf)
    Bc, Cc = proj[..., SSM_R:SSM_R + N], proj[..., SSM_R + N:]
    xz = torch.randn(SSM_B, L2, 2 * di, generator=g, device=dev).to(bf)
    dt, x, _, _, A, h0 = scan_inputs(torch, dev, SSM_B, L2, di, N, bf, 5)
    raw, bias, _, _, _, _, _, D, _ = gated_inputs(torch, dev, SSM_B, L2, di,
                                                  N, bf, 8)
    z = xz[..., di:]
    cases = (
        ("ssm_scan_chunk", torch.empty(x.shape, device=dev),
         lambda c, h, y: ops.ssm_scan_chunk(dt[:, c], x[:, c], Bc[:, c],
                                            Cc[:, c], A, h, y=y, h_out=h),
         lambda: ref.ssm_scan_chunk_ref(dt, x, Bc, Cc, A, h0)),
        ("mamba1_scan_chunk", torch.empty_like(x),
         lambda c, h, y: ops.mamba1_scan_chunk(
             raw[:, c], bias, x[:, c], z[:, c], Bc[:, c], Cc[:, c], A, D, h,
             y=y, h_out=h),
         lambda: ref.mamba1_scan_chunk_ref(raw, bias, x, z, Bc, Cc, A, D,
                                           h0)))
    for name, y, chunk, whole in cases:
        h = h0.clone()
        for c in (slice(0, SSM_L), slice(SSM_L, L2)):
            if chunk(c, h, y[:, c])[1] is not h:
                raise AssertionError(f"{name}: h_out was not used")
        hold(name, "two chained chunks, state in place", (y, h), whole())
    torch.cuda.synchronize()
    log(f"ssm kernel: both entries within their limits of the plain "
        f"versions (rtol = atol = {SCAN_TOL}; the gated entry's bf16 y "
        f"{GATED_BF16_TOL}) at the prefill chunk, the decode step, the "
        f"sweep, ragged di = 200, N = 8 and 16 and two chained chunks in "
        f"place; max |diff| {json.dumps(err)}")
    return err


def scan_cost(name: str, B: int, L: int, di: int, N: int, item: int):
    """One call of the scan entry ``name`` with x/B/C of ``item`` bytes →
    (bytes, each input read once and each output written once;
    special-function operations; fp32 operations).  The gated entry
    reads raw dt, x and z and writes y in the working dtype, and adds a
    softplus (exp, log1p) and a sigmoid (exp, reciprocal) a (b, t, d)."""
    elems = B * L * di
    state = 2 * 4 * B * di * N + 4 * di * N + 2 * item * B * L * N
    if name == "ssm_scan_chunk":
        return (state + (4 + item + 4) * elems, elems * N,
                elems * (6 * N + 1))
    return (state + 4 * item * elems + (item + 4) * di, elems * (N + 4),
            elems * (6 * N + 9))


def time_ssm_kernel(torch, ops, ref, dev) -> dict[str, dict]:
    """Both scan entries at the slice's prefill chunk and decode step
    (bf16 x/B/C): ms, bound and plain ms, by entry and step.  Decode
    rotates over 24 states (100 MB, twice the L2), as its 64 layers'
    slots do on the path."""
    entries = (("ssm_scan_chunk", scan_inputs, ops.ssm_scan_chunk,
                ref.ssm_scan_chunk_ref),
               ("mamba1_scan_chunk", gated_inputs, ops.mamba1_scan_chunk,
                ref.mamba1_scan_chunk_ref))
    rows = {name: {} for name, *_ in entries}
    for what, L, n_sets, iters in (("prefill", SSM_L, 1, 20),
                                   ("decode", 1, 24, 96)):
        for name, make, fn, plain in entries:
            sets = [make(torch, dev, SSM_B, L, SSM_DI, SSM_N,
                         torch.bfloat16, 7 + i) for i in range(n_sets)]
            cyc, pcyc = itertools.cycle(sets), itertools.cycle(sets)
            nbytes, sfu, flops = scan_cost(name, SSM_B, L, SSM_DI, SSM_N, 2)
            by = {"bytes": nbytes / HBM_BYTES_PER_S,
                  "operations": max(flops / FP32_FLOP_PER_S,
                                    sfu / SFU_OPS_PER_S)}
            bound_by = max(by, key=by.get)
            t = rows[name][what] = dict(
                shape=f"({SSM_B},{L},{SSM_DI},{SSM_N}) bf16",
                ms=device_ms(torch, f"{name} {what}",
                             lambda: fn(*next(cyc)), iters),
                plain_ms=device_ms(torch, f"{name} {what} plain",
                                   lambda: plain(*next(pcyc)),
                                   3 if L > 1 else iters),
                library_ms=None, bound_ms=by[bound_by] * 1e3,
                bound_by=bound_by)
            log(f"  {name} {what} {t['shape']}: kernel {t['ms']:.5f} ms  "
                f"bound {t['bound_ms']:.5f} ms ({bound_by}; {nbytes} B, "
                f"{sfu} special-function ops, {flops} flop)  plain "
                f"{t['plain_ms']:.5f} ms  library none")
            del sets
    return rows


def ssm_truth(torch, lm, inputs, feed, gates):
    """Both bf16 routes against an fp32 run of the same weights on the
    plain route: the kernel route's mean error must be at most 1.1x the
    plain route's.  Then faults planted in the scan on the kernel route,
    each read against every gate of both runs (a control of the gates'
    power, printed and not asserted)."""
    bf = gates[0]
    cfg_f32 = bf["cfg"].replace(dtype="float32", attn_impl="xla")
    model_f32 = copy.deepcopy(bf["model"]).float()
    truth, _ = route_logits(lm, cfg_f32, model_f32, inputs, None, feed)
    del model_f32
    torch.cuda.empty_cache()

    def mean_err(out):
        return float(torch.stack([(a - b).abs()
                                  for a, b in zip(out, truth)]).mean())

    err = {n: mean_err(bf[n]) for n in ("kern", "plain")}
    worst = {n: float(max((a - b).abs().max() for a, b in zip(bf[n], truth)))
             for n in err}
    log(f"ssm parity ({bf['label']}) against fp32 from the same weights: "
        + "; ".join(f"{r} route max {worst[n]:.4g} mean {err[n]:.4g}"
                    for r, n in (("kernel", "kern"), ("plain", "plain"))))
    if err["kern"] > 1.1 * err["plain"]:
        raise AssertionError("ssm parity: the kernel route is less "
                             "accurate than the plain route")

    from repro_torch.kernels import ops
    from repro_torch.models import ssm
    scan = ops.mamba1_scan_chunk
    faults = {
        "A off by 2^-8 of itself":
            lambda dt, bias, x, z, B, C, A, D, h0, **kw: scan(
                dt, bias, x, z, B, C, A * (1 + 2 ** -8), D, h0, **kw),
        # (dt_bias and the conv bias start at zero: dropping them would
        # change nothing)
        "D-skip dropped":
            lambda dt, bias, x, z, B, C, A, D, h0, **kw: scan(
                dt, bias, x, z, B, C, A, torch.zeros_like(D), h0, **kw),
        "B and C swapped":
            lambda dt, bias, x, z, B, C, A, D, h0, **kw: scan(
                dt, bias, x, z, C, B, A, D, h0, **kw),
        "state not carried in":
            lambda dt, bias, x, z, B, C, A, D, h0, **kw: scan(
                dt, bias, x, z, B, C, A, D, torch.zeros_like(h0), **kw),
    }
    # planted where the model looks the wrapper up, so that the wrapper
    # itself (and its launch count) stays as it is
    for what, faulty in faults.items():
        for gate in gates:
            ssm.ops = types.SimpleNamespace(mamba1_scan_chunk=faulty)
            try:
                out, cache = route_logits(lm, gate["cfg"], gate["model"],
                                          inputs, None, feed)
            finally:
                ssm.ops = ops
            res = held_to(torch, gate, out, cache)
            if gate is bf:
                e = mean_err(out)
                res["mean error"] = (e / err["plain"],
                                     e > 1.1 * err["plain"])
            log(f"ssm parity control ({what}; {gate['label']}): "
                + ", ".join(f"{k} {v:.4g}{' FAILS' if bad else ''}"
                            for k, (v, bad) in res.items()))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.core import best_throughput, scenarios, solve
    from repro_torch.kernels import _build, ops, ref
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
    with ThreadPoolExecutor(len(_build.LIBRARIES)) as pool:
        built = list(pool.map(lambda lib: lib.build(force=True),
                              _build.LIBRARIES))
    log(f"built {[str(p.relative_to(ROOT)) for p in built]} in parallel in "
        f"{time.perf_counter() - t0:.1f} s")
    for lib in _build.LIBRARIES:
        for line in lib.log.read_text().splitlines():
            if "Compiling entry" in line or "registers" in line:
                log("  ptxas " + line.split("ptxas info")[-1].strip(" :"))
        lib.library()
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

    def nan_diff(a, b):
        # after same(): the NaNs sit at the same places in both
        a, b = a.float(), b.float()
        keep = ~torch.isnan(a)
        return diff(a[keep], b[keep])

    def check(x):
        # the pack kernels also on a view 4 bytes past a 16-byte boundary
        for view in (x, x[1:]) if x.numel() > 1 else (x,):
            for pack, unpack in (("int8_pack", "int8_unpack"),
                                 ("fp8_pack", "fp8_unpack")):
                q, sc = getattr(ops, pack)(view)
                qr, scr = getattr(ref, pack + "_ref")(view)
                same(pack, q, qr)
                same(pack + " scale", sc, scr)
                err[pack] = max(err[pack], nan_diff(q, qr))
                y = getattr(ops, unpack)(q, float(sc))
                yr = getattr(ref, unpack + "_ref")(q, sc)
                same(unpack, y, yr)
                err[unpack] = max(err[unpack], nan_diff(y, yr))
        n = x.numel()
        for k in sorted({1, max(1, math.ceil(n / 8)), n}):
            idx, vals = ops.topk_select(x, k=k)
            idr, valr = ref.topk_select_ref(x, k=k)
            same(f"topk_select indices (k={k})", idx, idr)
            same(f"topk_select values (k={k})", vals, valr)
            err["topk_select"] = max(err["topk_select"], nan_diff(vals, valr))

    for n in sizes:
        check(torch.randn(n, generator=gen, device=dev) * 3.0)
        # tie-heavy: few distinct magnitudes
        check(torch.randint(-4, 5, (n,), generator=gen, device=dev).float())
        for x in special_inputs(torch, n, gen, dev).values():
            check(x)
    # past what the resident grid keeps on chip: the kernels read again
    big = torch.randn(BIG_CHECK, generator=gen, device=dev)
    for pack in ("int8_pack", "fp8_pack"):
        q, sc = getattr(ops, pack)(big)
        qr, scr = getattr(ref, pack + "_ref")(big)
        same(f"{pack} (n={BIG_CHECK})", q, qr)
        same(f"{pack} scale (n={BIG_CHECK})", sc, scr)
    k = math.ceil(BIG_CHECK / 8)
    idx, vals = ops.topk_select(big, k=k)
    idr, valr = ref.topk_select_ref(big, k=k)
    same(f"topk_select indices (n={BIG_CHECK})", idx, idr)
    same(f"topk_select values (n={BIG_CHECK})", vals, valr)
    del big, q, qr, idx, vals, idr, valr
    for pack in ("int8_pack", "fp8_pack"):
        empty = torch.empty(0, device=dev)
        q, sc = getattr(ops, pack)(empty)
        qr, scr = getattr(ref, pack + "_ref")(empty)
        if q.numel() or q.dtype != qr.dtype:
            raise AssertionError(f"{pack} of an empty tensor: {q}")
        same(f"{pack} scale (n=0)", sc, scr)
    torch.cuda.synchronize()
    log(f"kernels: bit-exact against the plain versions at n={sizes} "
        f"(normal, tie-heavy, NaN payloads, +-inf and -0.0, all equal, all "
        f"zeros; packs also at a view off 16-byte alignment; top-k at k = 1, "
        f"ceil(n/8), n), at n={BIG_CHECK} (normal) and, the packs, at n=0")
    fp8_inf_bytes(torch, ops, ref, dev)

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
    missing = [k for k in REPLACES if launches[k] <= 0]
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
                       if any(is_kernel(r.key, k) for k in CUDA_KERNELS)) / 1e3
        log(f"profile: lone batch wall {wall_ms:.2f} ms, device busy "
            f"{busy_ms:.3f} ms (idle share {1 - busy_ms / wall_ms:.4f}), "
            f"codec kernels {codec_ms:.3f} ms")
        for r in sorted(rows, key=lambda r: -r.self_device_time_total)[:8]:
            log(f"  {r.self_device_time_total / 1e3:8.3f} ms  x{r.count:<4d} "
                f"{r.key[:90]}")
        # each hop ran its codec's kernels once, and no library sort or
        # top-k ran beside them
        seen = {name: sum(r.count for r in rows if is_kernel(r.key, name))
                for name in CUDA_KERNELS}
        want = dict.fromkeys(CUDA_KERNELS, 0)
        for codec in pipe.codecs:
            for name in HOP_KERNELS[codec]:
                want[name] += 1
        library = [r.key[:90] for r in rows
                   if ("sort" in r.key.lower() or "topk" in r.key.lower())
                   and "topk_select_kernel" not in r.key]
        log(f"profile: codec kernel launches {json.dumps(seen)}")
        if seen != want or library:
            raise AssertionError(f"profile: codec kernels {seen}, expected "
                                 f"{want}; library sort/top-k {library}")
        out_dir = os.path.join(ROOT, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "smoke_profile.txt"), "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=60))
    else:
        log(f"profile: lone batch wall {wall_ms:.2f} ms; the profiler saw "
            f"no device time (device busy share not measured)")

    # ------------------------------------------------------ streamed stages
    from repro_torch.runtime.edge import Worker
    heavy, light = concurrent_stages(torch, Worker, dev)
    heavy_ms, light_ms = (w.stats.exe_s / w.stats.calls * 1e3
                          for w in (heavy, light))
    log(f"concurrent stages: light exe_s {light_ms:.3f} ms a batch beside a "
        f"heavy stage's {heavy_ms:.3f} ms, each on its own stream")
    if heavy.stream == light.stream or not light_ms < heavy_ms / 4:
        raise AssertionError("concurrent stages: the light stage was charged "
                             "with the heavy stage's kernels")
    pipe = EdgePipeline(model, cuts, scen, device="cuda",
                        timeout_s=STREAM_TIMEOUT_S)
    if len({w.stream.cuda_stream for w in pipe.workers}) != len(pipe.workers):
        raise AssertionError("streamed stages: stages share a stream")
    st = streamed_stages(torch, pipe, x)
    pipe.close()
    log(f"streamed stages: {STREAM_BATCHES} batches in {st['wall_ms']:.2f} ms "
        f"under the profiler; sum of stage exe_s {st['sum_exe_ms']:.3f} ms "
        f"(per stage {[round(e, 3) for e in st['stage_exe_ms']]}); device "
        f"busy {st['busy_ms']:.3f} ms (the union of {st['spans']} kernel "
        f"spans; their sum {st['kernel_sum_ms']:.3f} ms, so "
        f"{st['kernel_sum_ms'] - st['busy_ms']:.3f} ms ran beside each other "
        f"on different streams)")

    # --------------------------------------------------------------- socket
    sock = socket_phase(torch, model, cuts, scen, x, y, res, smi)

    # ---------------------------------------------------- shmem, recovery
    rgen = torch.Generator(device=dev).manual_seed(0)
    xs = [torch.randn(BATCH, HW, HW, 3, generator=rgen, device=dev)
          for _ in range(RECOVERY_BATCHES)]
    unfaulted = shmem_phase(torch, model, cuts, scen, x, y, res, sock, smi,
                            xs)
    recovery_phase(torch, model, cuts, scen, xs, unfaulted, smi)

    # ---------------------------------------------------------- lm kernels
    from repro_torch.launch import serve
    from repro_torch.models import lm
    lm_err = check_lm_kernels(torch, ops, ref, dev)
    lm_timings = time_lm_kernels(torch, ops, ref, dev)
    from repro_torch import configs
    rms_paths = {
        "lm": rms_shapes(configs.get("qwen3-1.7b"), LM_B, LM_S, LM_NEW),
        "ssm": rms_shapes(configs.get("falcon-mamba-7b"), SSM_B, SSM_S,
                          SSM_NEW)}
    time_rmsnorm_shapes(torch, ops, dev, rms_paths)
    log(f"lm kernels (check-phase launches): {json.dumps(ops.launch_counts())}")

    # ------------------------------------------------------------ lm slice
    lm_launches = serve_slice(torch, ops, serve, "lm", LM_ARGS, lm_expect)
    rms_counted(lm_launches, rms_paths["lm"], "lm")

    # ----------------------------------------------------- lm parity, profile
    lm_profile(torch, *parity(torch, serve, lm, dev, "lm", LM_ARGS, 5e-2,
                              True)[:4], expect=LM_STEP_KERNELS)

    # ---------------------------------------------------------- ssm kernel
    gc.collect()                       # the qwen3 model is unreferenced now
    torch.cuda.empty_cache()
    ssm_err = check_ssm_kernel(torch, ops, ref, dev)
    ssm_timing = time_ssm_kernel(torch, ops, ref, dev)
    log(f"ssm kernel (check-phase launches): "
        f"{json.dumps(ops.launch_counts())}")

    # ----------------------------------------------------------- ssm slice
    gc.collect()
    torch.cuda.empty_cache()
    ssm_launches = serve_slice(torch, ops, serve, "ssm", SSM_ARGS,
                               ssm_expect)
    rms_counted(ssm_launches, rms_paths["ssm"], "ssm")

    # ---------------------------------------------------- ssm parity, profile
    gc.collect()
    torch.cuda.empty_cache()
    cfg, model, inputs, cache_len, feed, gates = parity(
        torch, serve, lm, dev, "ssm", SSM_ARGS, SSM_BF16_TOL, False,
        {"h": SSM_STATE_TOL})
    ssm_truth(torch, lm, inputs, feed, gates)
    del gates
    lm_profile(torch, cfg, model, inputs, cache_len, label="ssm",
               expect=SSM_STEP_KERNELS)

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
    for name, t in lm_timings.items():
        rows.append({
            "name": name, "route": "cuda", "source": LM_SOURCE,
            "replaces": LM_REPLACES[name], "launches": lm_launches[name],
            "max_abs_err": lm_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    for name, steps in ssm_timing.items():
        t = steps["prefill"]
        rows.append({
            "name": name, "route": "cuda", "source": SSM_SOURCE,
            "replaces": SSM_REPLACES, "launches": ssm_launches[name],
            "max_abs_err": ssm_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
