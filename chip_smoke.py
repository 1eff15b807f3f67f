#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits non-zero):

1. setup   — print torch's version and the card (``nvidia-smi``), read
             each card's idle draw for phase 36, turn TF32 off and cuDNN
             deterministic, build the three CUDA sources of
             ``src/repro_torch/kernels/csrc`` with nvcc, in parallel;
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
5f. gateway — the serving gateway, the adaptive loop and the profiler on
             the slice.  Every block of MobileNetV2-224 must give each of
             8 rows the bits it gives that row alone at row 0 of a
             zero-padded batch; each tenant of ``octet_uniform`` (3
             requests of 1 x 224 x 224 x 3, each from its own seed) is
             served alone through a ``Gateway`` over phase 4's coded and
             uncoded emulated pipelines (the codec kernels' launches,
             reset just before, exactly one pack and unpack a request).
             Inside phase 5d, on its shmem workers, sanitizer on:
             ``octet_uniform`` and ``duo_bursty`` through gateways, every
             tenant ``torch.equal`` to its solo run in submit order —
             coded (a lossy hop couples a batch's rows, so each request
             rides alone; each process's launches ``hop_launches`` a
             micro-batch), then with the hops switched to no codec
             (requests coalesce up to 8) — with the QoS split printed
             (queue, service and wire p50/p99, occupancy, req/s); then
             ``cancel_inflight("resubmit")`` redelivers every request
             ``torch.equal`` to solo and ``cancel_inflight("skip")``
             surfaces each flushed request as ``(req_id, None)`` in
             order.  After phase 5e, under watchdogs: closed-loop
             tenants on the emulated slice while hop 0 rides
             ``congestion_spike`` under a ``FleetController`` (the AIMD
             window must halve and grow back, at least one fleet
             decision; the timeline printed); ``AdaptiveRuntime`` on a
             ``wan_ramp`` of ``pi_pi_gpu`` at batch 8 (``n_batches``
             reckoned from the modeled hop-0 wire; at least one
             migration, toward less hop-0 wire; the cut history
             printed); ``profile_wallclock`` over the blocks at batch 8
             with CUDA events (each block's ms, their coefficient of
             variation);
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
             printed beside the scan's;
14. moe kernels — phase 6's checks at the MoE slice's shapes (flash q
             (8,1024,32,128) over k/v (8,1024,4,128) causal, decode over
             (8,1056,4,128) at pos 0/1/511/1055 and forced split counts,
             RMSNorm at every row shape of its path, d = 2048 and 128),
             fp32 and bf16 within 2e-5 / 2e-2, then timed beside their
             bound and SDPA / ``F.rms_norm``;
15. moe slice — ``serve.main`` on qwen3-moe-30b-a3b at full width and
             depth (48 layers, 128 experts top-8, 61 GB of bf16 weights),
             batch 8, prompt 1024, 32 new tokens, counters reset just
             before: exactly 96 flash, 1536 decode and 6562 RMSNorm
             launches, no other kernel; prefill ms, decode ms/token,
             tokens/s and peak allocated memory printed;
16. moe parity — (a) ``moe_mlp`` and ``moe_mlp_gshard`` at one group
             size (128) on one full-width layer and 8192 tokens: fp32
             within rtol = atol = 2e-4, bf16 within 2e-2 of |y| max (the
             sort form rounds each weighted slot to bf16 before the sum
             over k), the same dropped slots, the same aux; (b) fp32, TF32
             off, full width, 2 layers, qwen3-moe-30b-a3b and
             phi3.5-moe-42b-a6.6b: the kernel route within 2e-4 of the
             ``"xla"`` route (logits, argmax, final cache) with every
             layer's expert choices equal (a flip is printed with the
             k-th/(k+1)-th gap beside the routes' logit difference); (c)
             bf16 at full depth on both routes: the largest logit
             difference, the argmax agreement and each layer's share of
             differing expert choices printed; at 8 layers each bf16 route
             against an fp32 plain run of the same weights, the kernel
             route's mean logit error at most 1.1x the plain route's;
17. moe profile — one prefill and one decode step of the full-depth
             model under ``torch.profiler``: prefill must run
             ``flash_attention_tc_kernel``, decode both decode kernels;
             the device time inside the expert products (and their
             matrix products), the router and the rest of the routed MLP
             (sort, gathers, weighting), beside each step's busy time and
             idle share;
18. hybrid/enc-dec kernels — phase 6's checks at the shapes of the two
             slices below (flash: zamba2's shared block q (8,1024,32,112)
             causal, whisper's encoder (8,1500,12,64) non-causal, decoder
             (8,416,12,64) causal, cross-attention (8,416,12,64) over
             (8,1500,12,64) and at decode one query row over 1500; decode
             over (8,1056,32,112) at pos 0/1/511/1055 and (8,448,12,64) at
             pos 0/1/447, with forced split counts; RMSNorm at every row
             shape of the hybrid path, d = 3584 and 7168), fp32 and bf16
             within 2e-5 / 2e-2, then each shape timed beside its bound and
             SDPA / ``F.rms_norm``;
19. hybrid slice — ``serve.main`` on zamba2-7b at full width and depth
             (81 Mamba-2 layers, d_model 3584, 112 SSD heads of 64, N 64,
             the shared attention+MLP block at every 6th layer: 14
             applications; about 13.5 GB of bf16 weights), batch 8, prompt
             1024, 32 new tokens (cache 1056), counters reset just before:
             exactly 28 flash, 448 decode and 6494 RMSNorm launches, no
             scan; prefill ms, decode ms/token, tokens/s and peak
             allocated memory printed;
20. hybrid parity — the same weights and prompt through the ``"xla"``
             route in bf16 at full depth (the largest logit difference and
             the argmax agreement printed); fp32, TF32 off, full width, 8
             layers (the shared block at layers 0 and 6): logits, argmax
             and the final conv/h/ak/av within 2e-4; at 8 layers each bf16
             route against an fp32 plain run of the same weights, the kernel
             route's mean logit error at most 1.1x the plain route's;
21. enc-dec slice — ``serve.main`` on whisper-small (12 + 12 layers,
             d_model 768, 12 heads of 64, vocab 51865, tied head), batch 8,
             the published 1500 encoder frames, prompt 416, 32 new tokens
             (cache 448, whisper's decoder context): exactly 456 flash,
             384 decode and no RMSNorm launches; the same numbers printed;
22. enc-dec parity — as phase 8: bf16 at full depth within 5e-2 with the
             same argmax, then fp32 at full depth within 2e-4 with the same
             argmax and final k/v/ck/cv;
23. hybrid/enc-dec profile — one prefill and one decode step of each
             model under ``torch.profiler``: zamba2's prefill must run
             ``flash_attention_tc_kernel`` and its decode both decode
             kernels (no scan in either), with the device time in the SSD
             (mask/exp, carry, the rest), the Mamba-2 blocks, the shared
             block and RMSNorm; whisper's with the encoder, the decoder's
             self-attention and the cross-attention (decode also runs
             flash for its one-row cross-attention; no RMSNorm); busy time
             and idle share beside each;
24. train parity — the port's training step (``runtime.steps``: the
             chunked CE, AdamW with clipping and the cosine schedule) on
             the card held to the same step on the CPU from the same
             weights (drawn on the CPU, then copied) and batch: qwen3-1.7b
             at full width, 2 layers, fp32, batch 2, seq 256 (the loss and
             metrics within 1e-5, every gradient leaf within 1e-4 of its
             largest magnitude, every parameter within 1e-2 of the
             learning rate but for at most 1e-3 of a leaf's elements,
             none beyond 2 lr), then every family's reduced config, held
             alike; no kernel launches; a train step of a config with
             ``attn_impl="pallas"`` must raise on the card before anything
             launches; bf16 at 2 layers against fp32, the loss within
             5e-2; the bf16 head's backward at those 2 layers against the
             reference's fp32 transpose (each gradient the fp32 product
             rounded to bf16 but for 1e-3 of its elements, all within one
             ulp);
25. train slice — qwen3-1.7b at full width and depth through the
             launcher's own ``setup`` and numerics (``launch.train``:
             from phase 24 on, torch's deterministic algorithms, with
             cuBLAS's workspace set at the top of the script), bf16, remat on,
             batch 8, seq 2048 (two CE chunks of 1024), one warm-up and
             three timed steps on one batch: every loss finite and the last
             below the first, no kernel launched; step ms (median),
             tokens/s, model FLOPs a step and their share of 989 TFLOP/s,
             peak allocated memory and the optimizer's share of the step
             printed (the batch halves if the warm-up passes 75 GiB);
26. resume drill — ``python -m repro_torch.launch.train --reduced
             --device cuda`` as three processes of six steps:
             uninterrupted and crashed at step 4 (exit 42) side by side,
             then resumed from step 4: the resumed
             losses must be the uninterrupted run's bit for bit; then a
             bf16 checkpoint of qwen3-1.7b at full width and 2 layers,
             after one step, restores every leaf ``torch.equal``;
27. train profile — one full-depth train step under ``torch.profiler``:
             device busy against wall time, the idle share, the device ms
             in matrix products and elementwise kernels, in the forward,
             the backward and the remat recompute inside it, and by span
             in the optimizer, the CE chunks and the blocks; the CE alone
             timed with CUDA events (full table in
             ``chiprun_out/train_profile.txt``).
28. pipeline serve — the pod pipeline (``runtime.pipeline``; every
             stage on the one card) through ``launch.serve --pods``:
             qwen3-1.7b at 2 stages (the ParetoPipe cuts for serving,
             priced for a card a stage, (17,)) and 4 (even), zamba2-7b
             at 2 (cuts (41,)), batch 8,
             prompt 1024, 8 new tokens, each beside
             its unpipelined serve in the same run: the kernels' launches
             equal, every token ``torch.equal``, and every step's logits
             of a greedy run ``torch.equal``; prefill ms, decode ms/token
             and peak printed beside the unpipelined ones.
29. pipeline train parity — the pipelined loss and gradients (GPipe
             over the microbatches) held to the plain step's over the
             same microbatches, averaged: qwen3-1.7b at full width, 2
             layers, fp32, cut (1,), 4 microbatches, and every family's
             reduced config at 2 stages and 2 microbatches; the CE within
             1e-5 (relative), every gradient leaf within 1e-4 of its
             largest; no kernel launched.
30. pipeline train — phase 25's run through ``launch.train --pods 2
             --microbatches 4 --auto-partition``, one warm-up and three
             timed steps: the cuts must be (16,), priced for a card a
             stage; step ms, tokens/s and each card's peak printed beside
             phase 25's, and beside the planner's predicted step (its
             pick's latency and throughput, as a GPipe step of the same
             batch); the warm-up loss within 1e-2 of phase 25's on the
             same batch.
31. sharded parity — the data and model axes (``sharding.api``:
             DTensor on a ``(data, model)`` mesh of NCCL ranks, one card
             a rank, spawned from this script by
             ``launch.mesh.spawn_ranks`` with the training numerics on in
             each): on the largest mesh the cards allow ((2, 2) with four
             or more, (1, 2) with two or three, the world-1 mesh (1, 1)
             with one) one sharded train step against the one-card plain
             step on the same weights and batch, in rank 0: qwen3-1.7b
             at full width, 2 layers, fp32, batch 8, seq 512 (the loss
             within 1e-5 relative, every gradient leaf, recovered from the
             gathered first moment, within 1e-4 of its largest, both
             moments within 1e-5 of theirs, compared on the card by the
             reference's leaf; its collectives recorded on rank 0 by
             ``launch.hlo_analysis.CollectiveRecorder``; each rank's
             moment bytes
             printed beside 1/(data x model) of the one-card bytes), then
             every family's reduced config at batch 4, seq 32 (the loss
             and gradients alike, the moments within the gradients' 1e-4
             and 2e-4); whether the world-1 step was ``torch.equal``; no
             kernel launched;
32. sharded train — qwen3-1.7b at full width and depth through
             ``launch.train``'s ``setup`` in each rank with
             ``--data-par D --model-par M``, phase 25's flags (bf16, remat,
             batch 8, seq 2048): one warm-up and three timed steps, the
             median step ms, tokens/s and each card's peak printed beside
             phase 25's, the warm-up loss within 1e-2 of phase 25's on the
             same batch; at (2, 2) and (4, 1) with four or more cards,
             (1, 2) and (2, 1) with two or three; with one card no mesh
             (phase 25 is that step): one line names the card count and
             the meshes not run (phases 33, 35, 31 and 32, in that order,
             run in one spawn of ranks: every mesh has as many);
33. sharded serve — prefill and decode on phase 31's mesh (NCCL ranks
             spawned as there): qwen3-1.7b at full width, 2 layers, fp32,
             TF32 off, batch 8, prompt 256, a prefill and four greedy
             decode steps on the kernel route (flash, decode attention
             and RMSNorm on each rank's shards), held to the one-card
             serve of the same weights and prompt in rank 0: every step's
             logits within phase 8's 2e-4, the tokens ``torch.equal``,
             the gathered k/v caches within 2e-4 and laid out by
             ``kv_cache_names``; then phase 7's serve (full width and
             depth, bf16, batch 8, prompt 1024) with phase 28's 8 new
             tokens through
             ``launch.serve`` with ``--data-par D --model-par M`` in the
             ranks: prefill ms, decode ms/token and each card's peak
             beside phase 7's; each rank's flash, decode-attention and
             RMSNorm launches those the path implies (a rank runs every
             kernel call of one card, at its local shapes);
34. dry run — ``launch.dryrun.measure`` (the step in
             ``FakeTensorMode`` on fake CUDA tensors, as rank 0 of a fake
             group for a mesh), run from the setup on in a process of its
             own (``python3 chip_smoke.py --predict OUT CARDS``): phase
             25's step on one card (its peak, counted FLOPs and the
             analytic roofline bound printed beside phase 25's peak,
             model FLOPs and median step); phase 31's full-width step on
             phase 31's mesh, whose collectives (count and bytes by kind)
             must equal those rank 0 of phase 31's real step issued; phase
             32's step at each of its meshes, rank 0's predicted peak
             printed beside each card's measured one; phase 35a's
             pipelined step at each of its meshes, as rank 0 of a fake
             group of that mesh's ranks, whose collectives by kind,
             split into those that cross a pod and those that do not
             (``CollectiveRecorder``'s ``pod_size``), must equal those
             rank 0 of phase 35a's real step issued.
35. pod mesh — the pod pipeline over ranks (``runtime.pipeline`` on
             ``launch.mesh.pod_mesh``: each pod's stage a DTensor on its
             ``(data, model)`` sub-mesh, the hop a point-to-point send
             between ranks at one ``(data, model)`` point), in the spawn
             of phases 31-33, on the meshes the cards allow: (pod 2,
             data 1, model 2) and (2, 2, 1) with four or more, (2, 1, 1)
             with two or three, the world-1 mesh (1, 1, 1) with one (a
             line names the card count and the meshes not run).  (b)
             phase 33's parity case through the stages (kernel route on
             each rank's shards, cut after layer 1): every step's logits
             within 2e-4, the tokens ``torch.equal``, the caches gathered
             to rank 0 in the reference's (K, l_max, ...) layout within
             2e-4 of the one-card cache repacked, each rank's flash,
             decode-attention and RMSNorm launches those its stage
             implies; (a) phase 31's full-width case (2 layers, fp32,
             batch 8, seq 512, 2 microbatches, cut after layer 1) against
             the one-card step: the loss within 1e-5, every gradient leaf
             within 1e-4 and both moments within 1e-5 of their largest,
             from the state gathered to rank 0 in the reference's
             pipelined layout; at the world-1 mesh (one microbatch) the
             step ``torch.equal`` to the ``(1, 1)`` mesh's (phase 31's)
             step; no kernel launched; (c) with two or more cards, phase
             30's run on the ranks at (2, 1, 2) or (2, 1, 1) through
             ``launch.train``'s ``setup`` (one warm-up and three timed
             steps): the cuts (16,), priced for D x M cards a stage, the
             warm-up loss within 1e-2 of phase 25's, the median step ms,
             tokens/s and each card's peak printed beside phases 25, 30
             and 32 and the planner's predicted step;
36. card — the card as the planner's device, run right after the
             setup: each card's name, power limit, total memory and idle
             draw (``nvidia-smi power.draw`` before the first kernel) and
             the timed stage hop (a decode step's activation to the next
             stage's card plus one launch there, host to done: on one
             card the launch and sync alone, with two or more cuda:0 ->
             cuda:1) printed beside ``core.devices.H100_SXM``'s
             constants; fails if ``H100_SXM.mem_bytes`` passes a card's
             total memory, if the hop between cards is more than 3x off
             ``H100_SXM.stage_overhead_s`` or if one card's launch and
             sync passes it;
37. registry — run after phase 23 and before phase 24: the rest of the
             dense and vlm registry on one card, smallest first:
             starcoder2-3b (30 layers, d_model 3072, 24 / 2 heads of 128,
             G = 12, GELU MLP), starcoder2-7b (32, 4608, 36 / 4, G = 9),
             phi-3-vision-4.2b (32, 3072, 32 / 32 heads of 96; its
             prompt of 1024 positions is the stub image's 576 patches and
             448 tokens, as the reference's) and granite-20b (52,
             6144, MQA 48 / 1, G = 48; about 40 GB of bf16 weights).  (a)
             phase 6's checks at the shapes their serves give the kernels
             (flash over each prefill; decode over each cache at
             positions 0, 511, the first decode step's and the last
             (1024-1031), with forced split counts; RMSNorm at every row
             shape of the four paths), fp32 and bf16 within 2e-5 / 2e-2;
             decode timed at each arch's last step and flash at
             granite-20b's and phi-3-vision-4.2b's prefill, beside their
             bound and SDPA; (b) for each arch ``serve.main`` at full
             width and depth, bf16, batch 8, prompt 1024, 8 new tokens
             (cache 1032; 1608 for the vlm), counters reset just before:
             launches exactly ``lm_expect``'s (2 norms a layer, no
             qk-norm), RMSNorm's those of its row shapes; prefill ms,
             decode ms/token and peak printed; then phase 8's parity
             (bf16 at full depth within 5e-2 with the same prefill
             argmax but for near-ties: a row may differ only where the
             plain route's two largest logits lie closer than the two
             routes' logits do in that row, each such row printed; fp32,
             TF32 off, 2 layers within 2e-4 with the same argmax and
             final cache); granite-20b's bf16 routes at 4
             layers against fp32 from the same weights, the kernel
             route's mean error at most 1.1x the plain route's; each
             model freed before the next, and at most 2 GiB left
             allocated on the card after the last.

The kernel table's LM rows count the launches of every LM serving path
(phases 7, 11, 15, 19, 21 and the four of phase 37, the pipelined
serves of phase 28, rank 0's sharded serve of phase 33, and rank 0's
pod-mesh serves of phase 35b);
every row's ``train_launches`` counts those of the training slices
(phases 25, 30 and 32; phase 35's, asserted 0 there), 0 for each:
training runs the plain route.  The rows for the two scan entries carry their
prefill-chunk times; the decode-step times are printed in phase 10.  The
last three lines of
standard output are the kernel table (JSON), the
card's name and power limit, and ``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, the script fails before printing a result.
"""
from __future__ import annotations

import bisect
import contextlib
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

# the training launcher's cuBLAS workspace (``launch.train.CUBLAS_WORKSPACE``),
# without which torch's deterministic algorithms refuse cuBLAS; cuBLAS
# reads it when CUDA starts, so it is set before anything touches the card
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

BATCH, HW, CLASSES = 8, 224, 10
CODECS = ("int8", "fp8", "topk")
CHECK_SIZES = (1, 7, 127, 129, 1_000_003)
# past what fp8_pack's and topk_select's resident grids keep on chip
BIG_CHECK = 40_000_003
# the H100 SXM's device-memory rate and dense bf16 tensor-core peak: the
# dry run's roofline constants
from repro_torch.launch.roofline import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS as BF16_FLOP_PER_S)
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
# the MoE slice: qwen3-moe-30b-a3b at full width and depth (about 61 GB
# of bf16 weights) at the LM slice's batch and lengths, so that phase 6's
# timings take its shapes
MOE_B, MOE_S, MOE_NEW = LM_B, LM_S, LM_NEW
MOE_ARGS = ["--arch", "qwen3-moe-30b-a3b", "--batch", str(MOE_B),
            "--prompt-len", str(MOE_S), "--new-tokens", str(MOE_NEW),
            "--seed", "0"]
# the two formulations held to each other at one group size, so that
# both drop the same (t, k) slots
MOE_GROUP = 128
# the fp32 two-layer parity's archs, and the depth at which each bf16
# route is held against an fp32 run of the same weights (about 20 GB)
MOE_PARITY_ARCHS = ("qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b")
MOE_TRUTH_LAYERS = 8
# the hybrid slice: zamba2-7b at full width and depth (81 Mamba-2 layers,
# the shared block at 14 of them; about 13.5 GB of bf16 weights), batch
# 8, prompt 1024 (a multiple of the SSD chunk: a ragged prompt would be
# one chunk of 8 x 1000 x 1000 x 112 fp32 weights, 3.6 GB), 32 new tokens
HYB_B, HYB_S, HYB_NEW = 8, 1024, 32
HYB_ARGS = ["--arch", "zamba2-7b", "--batch", str(HYB_B), "--prompt-len",
            str(HYB_S), "--new-tokens", str(HYB_NEW), "--seed", "0"]
# fp32 parity and bf16 accuracy at 8 layers: two applications of the
# shared block (before layers 0 and 6)
HYB_LAYERS = 8
# the enc-dec slice: whisper-small, batch 8, the published 1500 encoder
# frames, prompt 416 and 32 new tokens: a cache of 448, whisper's
# published decoder context
ENC_B, ENC_S, ENC_NEW = 8, 416, 32
ENC_ARGS = ["--arch", "whisper-small", "--batch", str(ENC_B), "--prompt-len",
            str(ENC_S), "--new-tokens", str(ENC_NEW), "--seed", "0"]
# the training phases: qwen3-1.7b, the LM slice's model, trained on the
# plain route (the kernels have no backward) with AdamW, clipping and the
# cosine schedule at a peak learning rate of 3e-4
TRAIN_ARCH, TRAIN_LR = "qwen3-1.7b", 3e-4
# phase 24: the card's train step held to the CPU's at full width, 2
# layers, fp32, batch 2, seq 256 (the CPU side takes seconds), and at
# every family's reduced size; a gradient leaf within 1e-4 of its largest
# magnitude (fp32 sums in other orders: over the 151936-word vocabulary
# and d_model 2048 at full width, through the SSD's exponentials of
# cumulative sums in the hybrid); bf16 at 2 layers against fp32, the loss
# (about 12.4) within 5e-2
TRAIN_PARITY_LAYERS, TRAIN_PARITY_B, TRAIN_PARITY_S = 2, 2, 256
TRAIN_GRAD_FRAC, TRAIN_BF16_TOL = 1e-4, 5e-2
# the bf16 head's backward: each gradient the reference's fp32 product
# rounded to bf16 in all but this share of its elements
TRAIN_PRODUCT_SHARE = 1e-3
TRAIN_FAMILIES = {"dense": "qwen3-1.7b", "vlm": "phi-3-vision-4.2b",
                  "moe": "qwen3-moe-30b-a3b", "ssm": "falcon-mamba-7b",
                  "hybrid": "zamba2-7b", "encdec": "whisper-small"}
# phase 25: full width and depth, bf16, remat on, batch 8, seq 2048 (two
# CE chunks of 1024: at 1024 the CE would take the dense (8, 1024,
# 151936) fp32 logits), one warm-up and three timed steps on one batch
# (every later training run takes as many); the
# batch halves if the warm-up's peak passes 75 GiB
TRAIN_B, TRAIN_S, TRAIN_WARM, TRAIN_STEPS = 8, 2048, 1, 3
TRAIN_PEAK_GIB = 75
TRAIN_ARGS = ["--arch", TRAIN_ARCH, "--seq", str(TRAIN_S), "--lr",
              str(TRAIN_LR), "--warmup", "1", "--seed", "0",
              "--device", "cuda"]
# phase 26: the launcher's crash drill on the card (reduced qwen3-1.7b,
# compression on), killed at step 4 of 6 and resumed from step 4
DRILL_STEPS, DRILL_FAIL = 6, 4
DRILL_ARGS = ["--arch", TRAIN_ARCH, "--reduced", "--device", "cuda",
              "--steps", str(DRILL_STEPS), "--batch", "4", "--seq", "64",
              "--ckpt-every", "2", "--log-every", "1", "--compress-grads"]
# phase 28: the pod pipeline served, each path's pipelined variants
# (launcher flags) beside its unpipelined serve, 8 new tokens (its own
# serves, not phase 7's or 19's: the decode steps past the first few add
# no check); the ParetoPipe cuts for serving qwen3-1.7b and zamba2-7b at
# prompt 1024 on 2 pods
PIPE_NEW = ["--new-tokens", "8"]
PIPE_SERVE = (("lm", LM_ARGS + PIPE_NEW, (["--pods", "2", "--auto-partition"],
                                          ["--pods", "4"])),
              ("hybrid", HYB_ARGS + PIPE_NEW,
               (["--pods", "2", "--auto-partition"],)))
PIPE_SERVE_CUTS = {("lm", 2): (17,), ("lm", 4): (7, 14, 21),
                   ("hybrid", 2): (41,)}
# phase 29: the pipelined train step held to the card's plain step:
# qwen3-1.7b at full width, 2 layers, fp32, batch 4 (four microbatches),
# seq 256, cut after layer 1; every family's reduced config at 2 stages
# and 2 microbatches, batch 2, seq 32; the loss within 1e-5 (relative),
# a gradient leaf within 1e-4 of its largest magnitude (phase 24's gates)
PIPE_PARITY_B, PIPE_PARITY_M = 4, 4
# phase 30: phase 25's run through the pod pipeline (2 stages, 4
# microbatches of 2, the ParetoPipe cuts for training at seq 2048, priced
# for a card a stage: (16,));
# the warm-up step's bf16 loss within 1e-2 of phase 25's on the same
# batch (the microbatches' sums round in another order)
PIPE_TRAIN_FLAGS = ["--pods", "2", "--microbatches", "4", "--auto-partition"]
PIPE_TRAIN_CUTS, PIPE_TRAIN_LOSS_TOL = (16,), 1e-2
# phase 31: the sharded step held to the one-card step (phase 24's
# gates; the moments of the full-width case within 1e-5 of their largest,
# those of the reduced families within the gradients' 1e-4, and 2e-4 for
# the second, the gradient's square: the hybrid's SSD brings its A_log
# gradient to about 5e-5); its cases: (label, arch, full width, batch,
# seq)
SHARD_PARITY_CASES = [("full", TRAIN_ARCH, True, 8, 512)] + [
    (fam, arch, False, 4, 32) for fam, arch in TRAIN_FAMILIES.items()]
SHARD_MOMENT_FRAC = 1e-5
# phase 32: phase 25's run on the ranks, each mesh (data, model) the cards
# allow; the warm-up loss within 1e-2 of phase 25's, as phase 30's
SHARD_TRAIN_LOSS_TOL = 1e-2
# a spawn of ranks that runs past this fails its phase (every rank killed)
SHARD_TIMEOUT_S = 540
# phase 33: the sharded serve's parity case (layers, batch, prompt, greedy
# decode steps): qwen3-1.7b at full width, fp32, held to the one-card
# serve within phase 8's 2e-4; its timing is phase 7's serve on the ranks,
# with phase 28's 8 new tokens
SHARD_SERVE_PARITY = (2, 8, 256, 4)
SHARD_SERVE_ARGS = LM_ARGS + PIPE_NEW
# phase 35: the pod pipeline over ranks, each stage on its pod's (data,
# model) sub-mesh.  (a) the train parity case (layers, batch, seq,
# microbatches, cut): phase 31's, 2 microbatches, cut after layer 1, held
# by phase 31's gates; (b) the serve parity case (layers, batch, prompt,
# greedy decode steps): phase 33's, held by its 2e-4; (c) phase 30's run
# on the ranks: phase 25's flags with --pods 2 --microbatches 4
# --auto-partition, the cuts (16,) and the warm-up loss within phase 30's
# 1e-2 of phase 25's
POD_PARITY = (2, 8, 512, 2, (1,))
POD_SERVE_PARITY = (2, 8, 256, 4)
# phase 34: the predictions, made beside phases 2-33 in a process of their
# own, must be in by then plus this
PREDICT_TIMEOUT_S = 300
# each serving path's numbers, by name (serve_slice)
SERVED: dict[str, dict] = {}
# phase 30's numbers, and phase 32's median step ms by mesh, for phase 35
PIPE30: dict = {}
SHARD32: dict[str, float] = {}
# phase 36: the stage hop timed (a decode step's activation of the LM
# slice, LM_B x 1 x 2048 bf16, to the next stage's card plus one launch
# there, host to done), this many times after as many warm-up hops; with
# two cards its median within HOP_TOL x of H100_SXM.stage_overhead_s, on
# one card (the launch and sync alone) below it
HOP_N, HOP_WARM, HOP_D, HOP_TOL = 200, 100, 2048, 3.0
# each slice's attention shapes (B, S, T, H, KV, hd, causal) and decode
# positions
HYB_FLASH = {"hybrid shared block": (HYB_B, HYB_S, HYB_S, 32, 32, 112, True)}
ENC_FLASH = {"whisper encoder": (ENC_B, 1500, 1500, 12, 12, 64, False),
             "whisper decoder": (ENC_B, ENC_S, ENC_S, 12, 12, 64, True),
             "whisper cross": (ENC_B, ENC_S, 1500, 12, 12, 64, False),
             "whisper cross at decode": (ENC_B, 1, 1500, 12, 12, 64, False)}
HYB_POSITIONS = (0, 1, 511, HYB_S + HYB_NEW - 1)
ENC_POSITIONS = (0, 1, ENC_S + ENC_NEW - 1)
# phase 37: the rest of the dense and vlm registry served at full width
# and depth, smallest first, at the LM slice's batch and prompt with
# phase 28's 8 new tokens (a vlm's cache also holds its 576 image
# patches); granite-20b's bf16 routes also held against fp32 at 4 layers
REG_ARCHS = ("starcoder2-3b", "starcoder2-7b", "phi-3-vision-4.2b",
             "granite-20b")
REG_B, REG_S, REG_NEW = LM_B, LM_S, 8
REG_TRUTH_LAYERS = {"granite-20b": 4}
# what the card may still hold once phase 37 has freed its models
REG_LEFT_GIB = 2
# the parts of a profiler kernel name that mark a matrix product (cuBLAS)
GEMM_PARTS = ("nvjet", "gemm", "cutlass")
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
# the hybrid runs no scan kernel (its SSD is plain code); the enc-dec no
# RMSNorm (its norms are layer norms) and its decode step also flash, for
# the cross-attention's one query row
HYB_STEP_KERNELS = {step: (need, (*forbid, "ssm_scan_kernel"))
                    for step, (need, forbid) in LM_STEP_KERNELS.items()}
ENC_STEP_KERNELS = {
    "prefill": (("flash_attention_tc_kernel",),
                ("flash_attention_kernel", "rmsnorm")),
    "decode step": (("decode_split_kernel", "decode_combine_kernel",
                     "flash_attention_tc_kernel"), ("rmsnorm",)),
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
# the gateway phase: requests a tenant (each 1 x 224 x 224 x 3 from its
# own seed), the mixes served over shmem, and their admission deadline
GW_REQS, GW_MIXES, GW_WINDOW_S = 3, ("octet_uniform", "duo_bursty"), 0.005
# AIMD under congestion_spike (clean to 2 s, 200 ms / 5 Mbit by 4 s, clean
# again by 7 s): closed-loop tenants and their SLO (a lone batch of the
# slice takes 0.12-0.17 s, so a request queued behind one other about 0.3
# s; near the peak one hop-0 transfer alone takes 0.2 s of RTT and, at the
# slice's cuts, seconds of int8 bytes), the admission window, how long the
# loop runs past the spike, the timeline's bucket and a watchdog
AIMD_TENANTS, AIMD_SLO_S, AIMD_INFLIGHT = 4, 0.5, 2
AIMD_T_END_S, AIMD_BUCKET_S, AIMD_WATCHDOG_S = 12.0, 1.0, 240.0
# AdaptiveRuntime on a wan_ramp of pi_pi_gpu: the ramp (trace seconds),
# the modeled hop-0 wire seconds the run may spend past the ramp at the
# duress optimum (with the batches that reach the ramp's end at healthy
# speed, this sets n_batches), its bounds and a watchdog
ADAPT_RAMP_S, ADAPT_WIRE_BUDGET_S = (0.5, 3.0), 20.0
ADAPT_BATCHES, ADAPT_WATCHDOG_S = (12, 64), 300.0
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


def smi_power_w(field: str) -> list[float]:
    """``nvidia-smi``'s ``power.draw`` or ``power.limit`` of every card, in
    W (a reading that is not a number raises)."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return [float(x) for x in out.stdout.split()]


def stage_hop_ms(torch, src, dst) -> float:
    """The median host-to-done ms of one stage hop from ``src`` to
    ``dst``: the pipeline's ``y.to(next card)`` of a decode step's
    activation, plus the next stage's first launch."""
    y = torch.randn(LM_B, 1, HOP_D, device=src, dtype=torch.bfloat16)
    times = []
    for i in range(HOP_WARM + HOP_N):
        torch.cuda.synchronize(src)
        torch.cuda.synchronize(dst)
        t0 = time.perf_counter()
        z = y.to(dst) + 1
        torch.cuda.synchronize(dst)
        if i >= HOP_WARM:
            times.append((time.perf_counter() - t0) * 1e3)
    del z
    times.sort()
    return times[len(times) // 2]


def card_phase(torch, smi, idle_w: list[float]) -> None:
    """Phase 36: the card as the planner's device.  Each card's name,
    power limit, total memory and idle draw (``idle_w``, read before the
    first kernel) and the stage hop printed beside ``H100_SXM``'s
    constants; fails if ``H100_SXM`` believes in more memory than a card
    has, if the hop between two cards is more than ``HOP_TOL`` x off
    ``stage_overhead_s``, or if one card's launch and sync alone (a hop
    whose ``y.to`` moves nothing, the stages sharing the card) passes
    it."""
    from repro_torch.core.devices import H100_SXM, NVLINK4
    count = torch.cuda.device_count()
    limits = smi_power_w("power.limit")
    totals = [torch.cuda.get_device_properties(i).total_memory
              for i in range(count)]
    for i in range(count):
        log(f"card (phase 36) cuda:{i} {torch.cuda.get_device_name(i)}: "
            f"power limit {limits[i]:.2f} W (H100_SXM.active_w "
            f"{H100_SXM.active_w}), total memory {totals[i]} B "
            f"(H100_SXM.mem_bytes {H100_SXM.mem_bytes}), idle draw "
            f"{idle_w[i]:.2f} W (H100_SXM.idle_w {H100_SXM.idle_w})")
    const = H100_SXM.stage_overhead_s * 1e3
    hop_bytes = LM_B * HOP_D * 2
    cards = [torch.device("cuda", i) for i in range(min(count, 2))]
    one = stage_hop_ms(torch, cards[0], cards[0])
    log(f"  launch and sync on one card, cuda:0 -> cuda:0 (median of "
        f"{HOP_N}): {one:.4f} ms (H100_SXM.stage_overhead_s {const:.4f} "
        f"ms, a hop between cards)")
    hop = None
    if count > 1:
        hop = stage_hop_ms(torch, *cards)
        log(f"  stage hop cuda:0 -> cuda:1 ({hop_bytes} B, median of "
            f"{HOP_N}): {hop:.4f} ms, {hop / const:.3f}x "
            f"H100_SXM.stage_overhead_s (within {HOP_TOL}x); NVLINK4's "
            f"bytes {NVLINK4.transfer_time(hop_bytes) * 1e3:.6f} ms")
    log(f"  spec peaks, not read: {H100_SXM.flops_per_s:.4g} FLOP/s, "
        f"{H100_SXM.mem_bw:.4g} B/s, NVLINK4 {NVLINK4.bw_bytes_per_s:.4g} "
        f"B/s; on {smi}")
    if H100_SXM.mem_bytes > min(totals):
        raise AssertionError(f"H100_SXM.mem_bytes {H100_SXM.mem_bytes} "
                             f"passes a card's total memory {min(totals)}")
    if not one <= const:
        raise AssertionError(f"one card's launch and sync {one:.4f} ms "
                             f"passes H100_SXM's stage hop {const:.4f} ms")
    if hop is not None and not 1 / HOP_TOL <= hop / const <= HOP_TOL:
        raise AssertionError(f"the stage hop {hop:.4f} ms is more than "
                             f"{HOP_TOL}x off H100_SXM's {const:.4f} ms")


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
                xs, gw) -> list:
    """Phase 5d: the CNN slice over the shared-memory ring, sanitizer
    on: the output against the emulated pipeline's ``emu_y`` bit for
    bit, each process's launches against ``hop_launches`` (1 and 20
    batches), ``measure`` beside the emulated and socket runs, the
    standup split, the gateway's runs of phase 5f on the same workers
    (``gateway_over_shmem``, against the solo baselines ``gw``),
    ``measure_hop`` beside socket's, and no worker or segment left → the
    outputs of the unfaulted ``xs`` (phase 5e's reference)."""
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
        gateway_over_shmem(torch, pipe, gw, smi)
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


def gateway_requests(torch, dev, names) -> dict:
    """``GW_REQS`` requests a tenant, (1, 224, 224, 3) on the card, each
    from its own seed (1000 + 10 * tenant + request)."""
    def one(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(1, HW, HW, 3, generator=gen, device=dev)
    return {n: [one(1000 + 10 * i + j) for j in range(GW_REQS)]
            for i, n in enumerate(names)}


def gateway_solo(torch, pipe, reqs) -> dict:
    """Each tenant alone through a gateway of its own on ``pipe``, padded
    to ``BATCH`` rows → {tenant: [(req_id, y)]} (the bit-identity
    baseline of every mixed run)."""
    from repro_torch.core import scenarios
    from repro_torch.runtime import Gateway, drain_qos
    refs = {}
    for n, xs in reqs.items():
        with Gateway(pipe, [scenarios.TenantSpec(n)], max_batch=BATCH,
                     batch_window_s=0.0) as gw:
            for x in xs:
                gw.submit(n, x)
            refs[n] = gw.client(n).drain()
        if [r for r, _ in refs[n]] != list(range(len(xs))):
            raise AssertionError(f"gateway solo {n}: ids {refs[n]}")
    drain_qos()
    return refs


def same_as_solo(torch, got, refs, names, what) -> None:
    """Every tenant of ``names``: its requests in submit order, each
    ``torch.equal`` to its solo result."""
    for n in names:
        if [r for r, _ in got[n]] != [r for r, _ in refs[n]]:
            raise AssertionError(f"{what}: {n} got ids "
                                 f"{[r for r, _ in got[n]]}")
        for (r, y), (_, want) in zip(got[n], refs[n]):
            if y is None or not torch.equal(y, want):
                err = "None" if y is None else \
                    f"{float((y - want).abs().max()):.3g}"
                raise AssertionError(f"{what}: {n} request {r} differs "
                                     f"from its solo run ({err})")


def qos_split(qos, wall_s) -> str:
    """The QoS split of a run: queue, service and wire p50/p99 (ms),
    occupancy, requests a second."""
    import numpy as np

    def pct(key):
        v = np.asarray([getattr(r, key) for r in qos]) * 1e3
        return f"{np.percentile(v, 50):.3f}/{np.percentile(v, 99):.3f}"
    occ = sum(r.occupancy for r in qos) / len(qos)
    return (f"{len(qos)} requests in {len({r.seq for r in qos})} "
            f"micro-batches, {wall_s:.3f} s, {len(qos) / wall_s:.2f} req/s; "
            f"latency p50/p99 {pct('latency_s')} ms = queue {pct('queue_s')} "
            f"+ service {pct('service_s')} ms (wire {pct('wire_s')}); "
            f"occupancy {occ:.4f}, coalesced up to "
            f"{max(r.coalesced for r in qos)}")


def row_invariance(torch, model, x) -> None:
    """Each block of ``model`` on a batch of ``BATCH`` rows against the
    same block on each row alone at row 0 of a zero-padded batch: every
    row's output must be bit for bit the same (what a coalesced request
    needs to keep its solo bits)."""
    broke = []
    a = x
    with torch.no_grad():
        for b, (name, layer) in enumerate(model.blocks):
            full = layer(a)
            for k in range(a.shape[0]):
                alone = torch.zeros_like(a)
                alone[0] = a[k]
                if not torch.equal(layer(alone)[0], full[k]):
                    broke.append((b, name, k))
            a = full
    if broke:
        raise AssertionError(f"row-position invariance breaks at (block, "
                             f"name, row) {broke[:12]}")
    log(f"gateway: every block of {model.name} gives each of {x.shape[0]} "
        f"rows the bits it gives that row alone at row 0 (torch.equal, "
        f"cuDNN deterministic, TF32 off)")


def gateway_refs(torch, pipe, plain_pipe, model, ops, dev, smi) -> dict:
    """Phase 5f's baseline on the emulated slice: the row-position check,
    then every tenant of ``GW_MIXES`` alone over the coded pipeline (the
    codec kernels' launches counted around it: one pack and unpack a
    micro-batch) and over the uncoded one."""
    from repro_torch.core import scenarios
    names = sorted({t.name for m in GW_MIXES
                    for t in scenarios.get_tenant_mix(m).tenants})
    reqs = gateway_requests(torch, dev, names)
    row_invariance(torch, model, torch.cat([r[0] for r in reqs.values()]))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    coded = gateway_solo(torch, pipe, reqs)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    n = len(names) * GW_REQS
    want = {k: 0 for k in REPLACES}
    for w in hop_launches(pipe.codecs):
        for k, v in w.items():
            want[k] += v * n
    log(f"gateway [{smi}]: {len(names)} tenants alone over the emulated "
        f"slice, {n} requests in {wall:.3f} s; launches {json.dumps(launches)}")
    if {k: launches.get(k, 0) for k in REPLACES} != want:
        raise AssertionError(f"gateway solo: launches {launches}, expected "
                             f"{want}")
    plain = gateway_solo(torch, plain_pipe, reqs)
    return {"reqs": reqs, "coded": coded, "plain": plain}


def gateway_mixes(torch, pipe, gw, refs, what, smi) -> int:
    """``GW_MIXES`` through gateways over ``pipe`` (uniform mixes
    interleaved, bursty ones tenant by tenant), sanitizer on: every
    tenant's results ``torch.equal`` to ``refs`` → micro-batches run."""
    from repro_torch.core import scenarios
    from repro_torch.runtime import Gateway, drain_violations
    batches = 0
    for mix_name in GW_MIXES:
        mix = scenarios.get_tenant_mix(mix_name)
        names = [t.name for t in mix.tenants]
        order = ([(n, j) for n in names for j in range(GW_REQS)]
                 if mix.arrival == "bursty" else
                 [(n, j) for j in range(GW_REQS) for n in names])
        t0 = time.perf_counter()
        with Gateway(pipe, mix, max_batch=BATCH,
                     batch_window_s=GW_WINDOW_S) as g:
            clients = {n: g.client(n) for n in names}
            for n, j in order:
                clients[n].submit(gw["reqs"][n][j])
            got = {n: clients[n].drain() for n in names}
            qos = g.drain_qos()
        wall = time.perf_counter() - t0
        same_as_solo(torch, got, refs, names, f"gateway {what} {mix_name}")
        bad = drain_violations()
        if bad:
            raise AssertionError(f"gateway {what}: sanitizer violations: "
                                 + "; ".join(v.render() for v in bad))
        batches += len({r.seq for r in qos})
        log(f"gateway [{smi}] {what} {mix_name}: every tenant == its solo "
            f"run (torch.equal, submit order), no sanitizer violation; "
            f"{qos_split(qos, wall)}")
    return batches


def gateway_cancel(torch, pipe, gw, smi) -> None:
    """``cancel_inflight`` over ``pipe``: resubmit redelivers every
    request ``torch.equal`` to its solo run, in order; skip surfaces each
    flushed request as ``(req_id, None)`` in its tenant's order."""
    from repro_torch.core import scenarios
    from repro_torch.runtime import Gateway, drain_violations
    mix = scenarios.get_tenant_mix(GW_MIXES[0])
    names = [t.name for t in mix.tenants]
    refs = gw["plain"]
    with Gateway(pipe, mix, max_batch=BATCH, batch_window_s=0.0) as g:
        clients = {n: g.client(n) for n in names}
        for j in range(GW_REQS):
            for n in names:
                clients[n].submit(gw["reqs"][n][j])
        flushed = g.cancel_inflight(action="resubmit")
        got = {n: clients[n].drain() for n in names}
        same_as_solo(torch, got, refs, names, "gateway cancel-resubmit")
        for n in names:
            clients[n].submit(gw["reqs"][n][0])
        skipped = g.cancel_inflight(action="skip")
        got = {n: clients[n].drain() for n in names}
        nones = sum(y is None for n in names for _, y in got[n])
        for n in names:
            ids = [r for r, _ in got[n]]
            y = got[n][0][1] if got[n] else None
            if ids != [GW_REQS] or (y is not None
                                    and not torch.equal(y, refs[n][0][1])):
                raise AssertionError(f"gateway cancel-skip: {n} got "
                                     f"{got[n]}")
        g.session.drain()
        cancels = g.session.drain_cancels()
    if nones != skipped or not all(c.flushed for c in cancels):
        raise AssertionError(f"gateway cancel-skip: {nones} None results "
                             f"for {skipped} flushed; cancel records "
                             f"{cancels}")
    bad = drain_violations()
    if bad:
        raise AssertionError("gateway cancel: sanitizer violations: "
                             + "; ".join(v.render() for v in bad))
    log(f"gateway [{smi}] cancel: resubmit flushed {flushed} requests and "
        f"redelivered all {len(names) * GW_REQS} == solo (torch.equal, in "
        f"order); skip flushed {skipped}, each surfaced as (req_id, None) "
        f"in its tenant's order; every CancelRecord flushed")


def gateway_over_shmem(torch, pipe, gw, smi) -> None:
    """Phase 5f over phase 5d's shmem pipeline: ``GW_MIXES`` on the coded
    slice (a lossy hop couples a batch's rows, so each request rides
    alone), each process's launches ``hop_launches`` a micro-batch; then
    the hops uncoded (a quiescent codec switch): the mixes coalesced,
    every row's bits its solo run's, and ``cancel_inflight``."""
    pipe._reset_stats()
    batches = gateway_mixes(torch, pipe, gw, gw["coded"], "shmem coded", smi)
    pipe._engine.sync()
    launches = [st.launches for st in pipe.stage_stats()]
    want = [{k: v * batches for k, v in w.items()}
            for w in hop_launches(pipe.codecs)]
    if launches != want:
        raise AssertionError(f"gateway shmem: launches {launches}, expected "
                             f"{want}")
    log(f"gateway: launches in the stage processes over {batches} "
        f"micro-batches: {json.dumps(launches)}")
    pipe.migrate(pipe.cuts, codecs=("none",) * len(pipe.codecs))
    gateway_mixes(torch, pipe, gw, gw["plain"], "shmem uncoded", smi)
    gateway_cancel(torch, pipe, gw, smi)


def aimd_phase(torch, model, scen, dev, smi) -> None:
    """Closed-loop tenants on the emulated slice while hop 0 rides
    ``congestion_spike``, under a ``FleetController``: the AIMD window
    must halve at least once and grow back, and at least one fleet
    decision must be recorded; the timeline is printed."""
    import numpy as np
    from repro_torch.core import scenarios
    from repro_torch.core.autosplit import AdaptiveSplitter
    from repro_torch.runtime import (EdgePipeline, FleetController, Gateway,
                                     drain_violations)
    spiky = scenarios.with_trace(scen, "congestion_spike")
    splitter = AdaptiveSplitter(model.block_graph(input_hw=HW), spiky,
                                batch=BATCH,
                                policy="throughput", hysteresis=0.10,
                                migration_cost_s=0.05, include_io=False,
                                amortize_horizon_s=30.0)
    splitter.current = splitter.solve()
    ctrl = FleetController(splitter, check_every=8, probe=False)
    tenants = [scenarios.TenantSpec(f"tenant{i}", slo_s=AIMD_SLO_S)
               for i in range(AIMD_TENANTS)]
    xs = gateway_requests(torch, dev, [t.name for t in tenants])
    dog = watchdog(AIMD_WATCHDOG_S, "the gateway's AIMD run")
    try:
        pipe = EdgePipeline(model, splitter.current.partition, spiky,
                            device=dev, sanitize=True,
                            timeout_s=STREAM_TIMEOUT_S)
        pipe.warmup(torch.cat([xs[t.name][0] for t in tenants]
                              * (BATCH // AIMD_TENANTS)))
        pipe.reset_clock()
        timeline, bucket, edge, served = [], [], AIMD_BUCKET_S, 0
        with Gateway(pipe, tenants, controller=ctrl, max_batch=BATCH,
                     batch_window_s=0.01, inflight=AIMD_INFLIGHT) as g:
            for t in tenants:
                g.submit(t.name, xs[t.name][0])
            while pipe.clock() < AIMD_T_END_S:
                for name, req_id, _ in g.poll(block=True):
                    served += 1
                    g.submit(name, xs[name][(req_id + 1) % GW_REQS])
                bucket.extend(g.drain_qos())
                while pipe.clock() >= edge:
                    lats = [r.latency_s for r in bucket] or [0.0]
                    timeline.append((edge, len(bucket),
                                     float(np.percentile(lats, 99)),
                                     sum(r.violated for r in bucket),
                                     g.inflight_window, splitter.policy,
                                     pipe.cuts))
                    bucket, edge = [], edge + AIMD_BUCKET_S
            served += sum(len(v) for v in g.drain().values())
            wins = [w for _, w in g.window_history]
            history = list(g.window_history)
        migrations = list(pipe.migrations)
        pipe.close()
    finally:
        dog.cancel()
    log(f"gateway AIMD [{smi}]: {AIMD_TENANTS} closed-loop tenants (SLO "
        f"{AIMD_SLO_S} s) on {spiky.name}, {served} requests served; "
        f"timeline (t, req/s, p99 ms, violations, window, policy, cuts):")
    for t, n, p99, vio, win, policy, cuts in timeline:
        log(f"  {t:5.1f} s {n / AIMD_BUCKET_S:7.2f} {p99 * 1e3:9.2f} {vio:3d} "
            f"{win:2d} {policy:>10s} {cuts}")
    log(f"  window (t, w): {[(round(t, 3), w) for t, w in history]}; fleet "
        f"decisions {len(ctrl.fleet_history)}, policies "
        f"{sorted({o.policy for o in ctrl.fleet_history})}; migrations "
        f"{[(round(t, 3), a, b) for t, a, b in migrations]}")
    down = min(range(len(wins)), key=lambda i: (wins[i], i))
    if not (wins[down] < wins[0] and max(wins[down:]) > wins[down]):
        raise AssertionError(f"gateway AIMD: window {wins} did not halve "
                             f"and grow back")
    if not ctrl.fleet_history:
        raise AssertionError("gateway AIMD: no fleet decision recorded")
    bad = drain_violations()
    if bad:
        raise AssertionError("gateway AIMD: sanitizer violations: "
                             + "; ".join(v.render() for v in bad))


def adaptive_phase(torch, model, dev, smi) -> None:
    """``AdaptiveRuntime`` on the card: MobileNetV2-224, batch 8, on a
    ``wan_ramp`` of ``pi_pi_gpu``; ``n_batches`` reckoned from the
    modeled hop-0 wire seconds at full duress; at least one migration,
    toward less hop-0 wire; the cut history printed."""
    from repro_torch.core import devices, scenarios
    from repro_torch.core.autosplit import AdaptiveSplitter
    from repro_torch.runtime import AdaptiveRuntime
    base = scenarios.get("pi_pi_gpu")
    ramp = scenarios.wan_ramp(base, hop=0, t_start=ADAPT_RAMP_S[0],
                              t_end=ADAPT_RAMP_S[1], jitter=0.05)
    graph = model.block_graph(input_hw=HW)
    deploy = AdaptiveSplitter(graph, ramp, batch=BATCH, policy="throughput",
                              include_io=False).solve().partition
    duress = AdaptiveSplitter(graph, scenarios.duress(base), batch=BATCH,
                              policy="throughput",
                              include_io=False).solve().partition
    wire = {c: [devices.link_at(ramp.links[0], t).transfer_time(
                    BATCH * graph.cut_bytes(c[0]))
                for t in (0.0, ADAPT_RAMP_S[1])] for c in (deploy, duress)}
    n = min(max(math.ceil(ADAPT_RAMP_S[1] / wire[deploy][0])
                + int(ADAPT_WIRE_BUDGET_S / wire[duress][1]),
                ADAPT_BATCHES[0]), ADAPT_BATCHES[1])
    log(f"adaptive [{smi}]: {ramp.name} (hop 0 LAN -> 200 ms / 5 Mbit over "
        f"{ADAPT_RAMP_S} s); hop-0 wire a batch at the deploy cuts {deploy}: "
        f"{wire[deploy][0]:.4f} s healthy, {wire[deploy][1]:.4f} s at full "
        f"duress; at the duress optimum {duress}: {wire[duress][1]:.4f} s; "
        f"{ADAPT_RAMP_S[1]} s of healthy batches and {ADAPT_WIRE_BUDGET_S} "
        f"s at the optimum make {n} batches")
    x = torch.randn(BATCH, HW, HW, 3,
                    generator=torch.Generator(device=dev).manual_seed(2),
                    device=dev)
    dog = watchdog(ADAPT_WATCHDOG_S, "the AdaptiveRuntime run")
    try:
        t0 = time.perf_counter()
        with AdaptiveRuntime(model, ramp, batch=BATCH, policy="throughput",
                             check_every=2, migration_cost_s=0.05,
                             alpha=0.6, device=dev) as rt:
            recs = rt.run(lambda: x, n_batches=n)
            migrations = list(rt.pipe.migrations)
        wall = time.perf_counter() - t0
    finally:
        dog.cancel()
    for r in recs:
        if r.migrated and r.migration_cost_s:
            log(f"  t={r.t_s:7.3f} s batch {r.batch_idx:2d} cuts={r.cuts} "
                f"latency {r.latency_s * 1e3:9.3f} ms (model "
                f"{r.predicted_latency_s * 1e3:9.3f}) << migrated")
    hist = rt.cut_history
    log(f"adaptive [{smi}]: {len(recs)} batches in {wall:.3f} s, "
        f"{len(migrations)} migrations, cut history "
        f"{' -> '.join(map(str, hist))}; hop-0 bytes a sample "
        f"{graph.cut_bytes(hist[0][0])} -> {graph.cut_bytes(rt.pipe.cuts[0])}")
    if (len(recs) != n or not migrations or recs[0].cuts != deploy
            or graph.cut_bytes(rt.pipe.cuts[0]) > graph.cut_bytes(deploy[0])):
        raise AssertionError(f"adaptive: {len(recs)} records, migrations "
                             f"{migrations}, cuts {deploy} -> {rt.pipe.cuts}")


def profiler_phase(torch, model, dev, smi) -> None:
    """``profile_wallclock`` over MobileNetV2-224's blocks at batch 8 on
    the card (CUDA events): each block's ms and their coefficient of
    variation."""
    from repro_torch.core import profiler
    names, fns = model.block_fns()
    x = torch.randn(BATCH, HW, HW, 3,
                    generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev)
    table = profiler.profile_wallclock("h100", fns, names, lambda _: x,
                                       repeats=10, warmup=2)
    ms = [table.get("h100", n) * 1e3 for n in names]
    if not all(t > 0 for t in ms):
        raise AssertionError(f"profiler: block times {ms}")
    log(f"profiler [{smi}]: {model.name} blocks at batch {BATCH}, CUDA "
        f"events, mean of 10: {json.dumps(dict(zip(names, [round(t, 4) for t in ms])))}")
    log(f"profiler: sum {sum(ms):.4f} ms, coefficient of variation "
        f"{profiler.coefficient_of_variation(ms):.4f}")


def lm_tol(torch, dtype) -> float:
    """rtol = atol of tests/test_kernels.py:14-15 for ``dtype``."""
    return 2e-2 if dtype == torch.bfloat16 else 2e-5


def lm_cases(H: int, KV: int, hd: int = 128) -> tuple[tuple, tuple]:
    """The LM slice's flash case (batch, prompt; ``H`` query over ``KV``
    heads of ``hd``) and its decode case over the slice's cache at
    positions 0, 1, 511 and the last."""
    smax = LM_S + LM_NEW
    return ((LM_B, LM_S, LM_S, H, KV, hd, True),
            (LM_B, smax, H, KV, hd, (0, 1, 511, smax - 1)))


def check_lm_kernels(torch, ops, ref, dev, flash_cases=None,
                     decode_cases=None, rms_rows=None,
                     label="lm kernels") -> dict[str, float]:
    """Each LM kernel against its plain version, fp32 and bf16 → max
    |kernel - plain| per kernel.  ``flash_cases`` are (B, S, T, H, KV,
    hd, causal); ``decode_cases`` (B, Smax, H, KV, hd, positions), each
    also at forced split counts at its first and last position;
    ``rms_rows`` the RMSNorm row shapes.  Unnamed, they are the LM
    slice's shapes and ragged ones."""
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
    lm_flash, lm_decode = lm_cases(16, 8)
    hd = 128
    # unless another slice's shapes were named: the slice's heads, ragged
    # S and T, every registry head dim (64 whisper, 96 phi-3-vision, 112
    # zamba2, 128 the rest; 16 the reduced configs), the registry's query
    # groups G = 9 (starcoder2-7b, 36 / 4), 12 (starcoder2-3b, 24 / 2)
    # and 48 (granite-20b's MQA), causal S < T
    flash_cases = flash_cases or (
        lm_flash, (2, 1000, 1000, 16, 8, hd, True),
        (2, 64, 1500, 16, 8, hd, False), (1, 300, 300, 4, 2, 64, True),
        (1, 300, 300, 4, 4, 96, True), (1, 300, 300, 4, 4, 112, False),
        (2, 200, 200, 4, 2, 16, True), (1, 256, 256, 48, 1, hd, True),
        (1, 300, 300, 36, 4, hd, True), (2, 200, 200, 24, 2, hd, True),
        (1, 77, 300, 4, 2, hd, True))
    # and decode at those groups (a ragged Smax each) and at
    # phi-3-vision's 32 heads of 96 past position 1024
    decode_cases = decode_cases or (
        lm_decode, (2, 300, 36, 4, hd, (0, 150, 299)),
        (2, 333, 24, 2, hd, (0, 1, 332)), (2, 1056, 48, 1, hd, (0, 1055)),
        (2, 1111, 32, 32, 96, (0, 1025, 1110)))
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, T, h, kv, d, causal in flash_cases:
            q = randn((B, S, h, d), dtype)
            k, v = randn((B, T, kv, d), dtype), randn((B, T, kv, d), dtype)
            hold("flash_attention", ops.flash_attention(q, k, v, causal=causal),
                 ref.flash_attention_ref(q, k, v, causal=causal),
                 f"B={B} S={S} T={T} H={h} KV={kv} hd={d} causal={causal}")
            del q, k, v
        for B, smax, h, kv, d, positions in decode_cases:
            q = randn((B, h, d), dtype)
            kc = randn((B, smax, kv, d), dtype)
            vc = randn((B, smax, kv, d), dtype)
            for pos in positions:
                hold("decode_attention", ops.decode_attention(q, kc, vc, pos),
                     ref.decode_attention_ref(q, kc, vc, pos),
                     f"Smax={smax} H={h} KV={kv} hd={d} pos={pos}")
                # the log-sum-exp a sequence-split cache merges by, read
                # from the split kernel's partial states
                out, lse = ops.decode_attention(q, kc, vc, pos,
                                                with_lse=True)
                want, want_lse = ref.decode_attention_ref(q, kc, vc, pos,
                                                          with_lse=True)
                hold("decode_attention", out, want,
                     f"Smax={smax} H={h} KV={kv} hd={d} pos={pos} with_lse")
                hold("decode_attention", lse, want_lse,
                     f"Smax={smax} H={h} KV={kv} hd={d} pos={pos} lse")
            # forced split counts, empty splits included, against the
            # plain version and the plain split-and-combine
            for pos in (positions[0], positions[-1]):
                for splits in (1, 2, 7, pos + 3):
                    out = dk.decode_attention(q, kc, vc, pos, splits=splits)
                    for exp in (ref.decode_attention_ref(q, kc, vc, pos),
                                ref.decode_attention_split_ref(q, kc, vc, pos,
                                                               splits)):
                        hold("decode_attention", out, exp,
                             f"Smax={smax} H={h} KV={kv} hd={d} pos={pos} "
                             f"splits={splits}")
        # the LM slice's rows (d_model, q/k heads) at prefill and decode,
        # the SSM slice's (d_model) and a ragged width
        for shape in rms_rows or ((LM_B * LM_S, 2048), (LM_B * LM_S * 16, hd),
                                  (LM_B, 2048), (LM_B * 16, hd),
                                  (SSM_B * SSM_S, SSM_D), (SSM_B, SSM_D),
                                  (1000, 3)):
            x, sc = randn(shape, dtype), randn((shape[-1],), dtype)
            hold("fused_rmsnorm", ops.fused_rmsnorm(x, sc),
                 ref.fused_rmsnorm_ref(x, sc), f"shape={shape}")
    torch.cuda.synchronize()
    log(f"{label}: within rtol = atol = 2e-5 (fp32) / 2e-2 (bf16) of the "
        "plain versions; max |diff| "
        + ", ".join(f"{n} {d} {e:.3g}" for (n, d), e in by_dtype.items()))
    return err


def with_bound(name: str, t: dict) -> dict:
    """``t`` (a timed row with its ``flops`` and ``bytes``) with its bound
    (the larger of operations at the bf16 tensor-core peak and bytes at
    HBM's rate), logged beside the times."""
    by_ops = t["flops"] / BF16_FLOP_PER_S
    by_bytes = t["bytes"] / HBM_BYTES_PER_S
    t["bound_ms"] = max(by_ops, by_bytes) * 1e3
    t["bound_by"] = "operations" if by_ops > by_bytes else "bytes"
    log(f"  {name:16s} {t['shape']}: kernel {t['ms']:.4f} ms  bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']})  plain "
        f"{t['plain_ms']:.4f} ms  library {t['library_ms']:.4f} ms")
    return t


def time_flash(torch, ops, ref, dev, B, S, T, H, KV, hd, causal) -> dict:
    """Flash attention at one bf16 shape: ms, plain ms, SDPA's ms and the
    bound (the score pairs that the causal mask leaves, counted)."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = randn(B, S, H, hd), randn(B, T, KV, hd), randn(B, T, KV, hd)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pairs = S * (T - S) + S * (S + 1) // 2 if causal else S * T
    iters = 10 if B * H * pairs * hd > 1 << 28 else 100
    return with_bound("flash_attention", dict(
        shape=f"q ({B},{S},{H},{hd}) k/v ({B},{T},{KV},{hd}) "
              f"{'causal' if causal else 'non-causal'} bf16",
        ms=device_ms(torch, "flash_attention",
                     lambda: ops.flash_attention(q, k, v, causal=causal),
                     iters),
        plain_ms=device_ms(torch, "flash_attention plain",
                           lambda: ref.flash_attention_ref(q, k, v,
                                                           causal=causal), 5),
        library_ms=device_ms(
            torch, "scaled_dot_product_attention",
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), iters),
        flops=4 * B * H * pairs * hd,
        bytes=2 * (2 * B * S * H * hd + 2 * B * T * KV * hd)))


def time_decode(torch, ops, ref, dev, B, smax, H, KV, hd, pos) -> dict:
    """Decode attention at one bf16 cache shape and ``pos``: ms, plain
    ms, SDPA's over rows ``0..pos`` and the bound.  It rotates over three
    caches (three times the 50 MB L2 at the LM slice's), as its layers do
    on the path."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    q = randn(B, H, hd)
    caches = [(randn(B, smax, KV, hd), randn(B, smax, KV, hd))
              for _ in range(3)]
    lib_caches = [tuple(c[:, :pos + 1].transpose(1, 2).contiguous()
                        for c in pair) for pair in caches]
    q4 = q[:, :, None]
    cyc, pcyc, lcyc = (itertools.cycle(c) for c in (caches, caches,
                                                    lib_caches))
    return with_bound("decode_attention", dict(
        shape=f"q ({B},{H},{hd}) caches ({B},{smax},{KV},{hd}) pos {pos} "
              "bf16",
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
        bytes=2 * (2 * B * (pos + 1) * KV * hd + 2 * B * H * hd)))


def time_lm_kernels(torch, ops, ref, dev, heads=(16, 8)) -> dict[str, dict]:
    """Each LM kernel at the LM slice's bf16 shapes (``heads``: its query
    and KV heads): ms, bound, plain ms and one PyTorch call's ms."""
    import torch.nn.functional as F
    flash, (B, smax, H, KV, hd, positions) = lm_cases(*heads)
    rows = {"flash_attention": time_flash(torch, ops, ref, dev, *flash),
            "decode_attention": time_decode(torch, ops, ref, dev, B, smax,
                                            H, KV, hd, positions[-1])}
    gen = torch.Generator(device=dev).manual_seed(3)
    rows_n, d = LM_B * LM_S, 2048
    x = torch.randn(rows_n, d, generator=gen, device=dev).to(torch.bfloat16)
    sc = torch.randn(d, generator=gen, device=dev).to(torch.bfloat16)
    rows["fused_rmsnorm"] = with_bound("fused_rmsnorm", dict(
        shape=f"x ({rows_n},{d}) scale ({d},) bf16",
        ms=device_ms(torch, "fused_rmsnorm",
                     lambda: ops.fused_rmsnorm(x, sc), 50),
        plain_ms=device_ms(torch, "fused_rmsnorm plain",
                           lambda: ref.fused_rmsnorm_ref(x, sc), 50),
        library_ms=device_ms(torch, "F.rms_norm",
                             lambda: F.rms_norm(x, (d,), sc, eps=1e-6), 50),
        flops=4 * rows_n * d, bytes=2 * (2 * rows_n * d + d)))
    return rows


def rms_shapes(cfg, B: int, S: int, new: int) -> dict[tuple, int]:
    """Each row shape the serving path hands RMSNorm → its launches over
    the slice: two prefills (d_model rows of every position of the
    prompt, a vlm's image patches among them: its synthetic prompt of
    ``S`` positions is ``n_patches`` patches and ``S - n_patches``
    tokens, as the reference's; the q and k heads' rows with qk-norm,
    the hybrid's d_inner rows; the final norm of the last token) and
    ``new`` decode steps (the same for one token)."""
    D, L = cfg.d_model, cfg.n_layers
    per_layer = 1 if cfg.family in ("ssm", "hybrid") else 2
    out: dict[tuple, int] = {}

    def add(shape, n):
        out[shape] = out.get(shape, 0) + n
    for tokens, times in ((B * S, 2), (B, new)):
        add((tokens, D), per_layer * L * times)
        if cfg.family == "hybrid":
            # the shared block's two pre-norms at each application; each
            # Mamba-2 layer's gated norm over d_inner
            add((tokens, D), 2 * cfg.n_attn_apps * times)
            add((tokens, cfg.d_inner), L * times)
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
    """The LM kernels' launches on the dense, vlm and moe serving paths:
    two prefills (warm-up + timed) and ``new_tokens`` decode steps
    (warm-up + the timed rest); per prefill or step 2 norms a layer (ln1,
    ln2), 2 more with qk-norm (q_norm, k_norm), and the final one."""
    steps = 2 + args.new_tokens
    per_layer = 2 + 2 * cfg.qk_norm
    return {"flash_attention": 2 * cfg.n_layers,
            "decode_attention": cfg.n_layers * args.new_tokens,
            "fused_rmsnorm": (per_layer * cfg.n_layers + 1) * steps}


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


def hybrid_expect(cfg, args) -> dict[str, int]:
    """The same for the hybrid path: the shared block's attention at
    each of its applications, flash in a prefill and decode attention
    in a step; per prefill or step one pre-norm and one gated norm a
    Mamba-2 layer, two norms an application and the final one."""
    steps, apps = 2 + args.new_tokens, cfg.n_attn_apps
    return {"flash_attention": 2 * apps,
            "decode_attention": apps * args.new_tokens,
            "fused_rmsnorm": (2 * cfg.n_layers + 2 * apps + 1) * steps}


def encdec_expect(cfg, args) -> dict[str, int]:
    """The same for the enc-dec path: a prefill's flash for every encoder
    layer and for each decoder layer's self- and cross-attention; a
    decode step's decode attention and its cross-attention (through
    flash, one query row) for each decoder layer; no RMSNorm (its norms
    are layer norms)."""
    L = cfg.n_layers
    return {"flash_attention": 2 * (cfg.n_enc_layers + 2 * L)
            + L * args.new_tokens,
            "decode_attention": L * args.new_tokens}


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
    SERVED[name] = {"prefill_ms": res["prefill_ms"],
                    "decode_ms": res["decode_ms_per_token"], "peak": peak}
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


def near_ties(kern, plain) -> list[tuple[int, float, float]]:
    """The rows whose argmax differs between two routes' logits (B, 1, V)
    → [(row, the plain route's gap between its two largest logits, the
    routes' largest difference in that row)]."""
    top = plain.float().topk(2, dim=-1).values
    gap = (top[..., 0] - top[..., 1]).reshape(-1)
    diff = (kern.float() - plain.float()).abs().amax(-1).reshape(-1)
    rows = (kern.argmax(-1) != plain.argmax(-1)).reshape(-1)
    return [(r, float(gap[r]), float(diff[r]))
            for r in rows.nonzero().flatten().tolist()]


def held_to(torch, gate, out, cache) -> dict[str, tuple]:
    """A kernel route's logits ``out`` and final ``cache`` against the
    plain route's in ``gate`` → {check: (max |diff| or the number of
    equal prefill argmaxes, whether the check fails)}; a ``tol`` of None
    holds the logits to nothing.  ``gate["argmax"]`` True holds every
    prefill argmax equal; ``"ties"`` lets a row's differ only where the
    plain route's two largest logits lie closer than the routes do in
    that row (a near-tie, which rounding may turn either way)."""
    tol, plain = gate["tol"], gate["plain"]
    res = {"logits": (
        max(float((a - b).abs().max()) for a, b in zip(out, plain)),
        tol is not None and not all(torch.allclose(a, b, rtol=tol, atol=tol)
                                    for a, b in zip(out, plain)))}
    agree = int((out[0].argmax(-1) == plain[0].argmax(-1)).sum())
    if gate["argmax"] == "ties":
        bad = any(gap >= d for _, gap, d in near_ties(out[0], plain[0]))
    else:
        bad = gate["argmax"] and agree != out[0].shape[0]
    res["argmax equal"] = (agree, bad)
    for k, t in gate["cache_tol"].items():
        a, b = cache[k].float(), gate["plain_cache"][k].float()
        res[f"cache {k}"] = (float((a - b).abs().max()),
                             not torch.allclose(a, b, rtol=t, atol=t))
    return res


def parity(torch, serve, lm, dev, name, argv, bf16_tol, bf16_argmax,
           bf16_cache_tol=None, fp32_layers=2):
    """Kernel route against the plain ``"xla"`` route on the same weights:
    prefill logits and 4 teacher-forced decode steps at full depth in the
    working dtype within ``bf16_tol`` (None: printed, not held; with the
    same prefill argmax when ``bf16_argmax``, but for near-ties when it
    is ``"ties"`` (``held_to``), and each final-cache entry
    named in ``bf16_cache_tol`` within its limit); then fp32, TF32 off,
    full width, ``fp32_layers`` layers (None: full depth), within 2e-4
    with the same argmax and final cache.  → the full-depth model, its
    inputs, the decode feed, and for each of the two runs its gate:
    config, model, each route's logits, the plain route's final cache
    and the limits."""
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
            f"{[f'{d:.3g}' for d in diffs]} ("
            + (f"rtol = atol = {tol}" if tol is not None
               else "printed, not held") + "); final "
            f"cache {', '.join(f'{k} {d:.3g}' for k, d in cache.items())} "
            f"(held: {', '.join(f'{k} {t}' for k, t in cache_tol.items())}"
            f"); prefill argmax agrees for {res['argmax equal'][0]} of "
            f"{feed.shape[1]}"
            + "".join(f"; row {r} differs: the plain route's top-2 gap "
                      f"{gap:.4g}, the routes' largest difference there "
                      f"{d:.4g}" for r, gap, d in near_ties(kern[0],
                                                             plain[0])))
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
    cfg32 = cfg.replace(n_layers=fp32_layers or cfg.n_layers,
                        dtype="float32")
    model32 = lm.init(cfg32, torch.Generator(device=dev).manual_seed(0), dev)
    gates.append(routes(cfg32, model32, 2e-4, True, None,
                        f"float32, {cfg32.n_layers} layers"))
    return cfg, model, inputs, cache_len, feed, gates


def named(key: str, name) -> bool:
    """Whether the profiler's kernel name ``key`` holds ``name``, a string
    or a tuple of its parts."""
    return all(p in key for p in ((name,) if isinstance(name, str) else name))


def span_times(prof, labels) -> dict[str, tuple[float, float]]:
    """The device ms of the kernels that ran inside each labelled span's
    GPU-side ranges → {label: (all kernels, the matrix-product kernels
    among them)}; (0, 0) where the profiler recorded no range."""
    from torch.autograd import DeviceType
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in dev if e.name not in labels)
    starts = [k[0] for k in kernels]
    out = {}
    for lab in sorted(labels):
        total = gemm = 0.0
        for r in (e.time_range for e in dev if e.name == lab):
            i = bisect.bisect_left(starts, r.start)
            while i < len(kernels) and kernels[i][0] < r.end:
                t0, t1, name = kernels[i]
                if t1 <= r.end:
                    total += t1 - t0
                    gemm += (t1 - t0) * any(p in name for p in GEMM_PARTS)
                i += 1
        out[lab] = (total / 1e3, gemm / 1e3)
    return out


@contextlib.contextmanager
def spans_on(torch, spans):
    """While open, each function ``module.attr`` of ``spans`` ((module,
    attr, label) triples) runs inside ``record_function(label)``; the
    functions are put back on exit."""
    saved = [(m, a, getattr(m, a)) for m, a, _ in spans]

    def wrapped(fn, label):
        def run(*args, **kw):
            with torch.profiler.record_function(label):
                return fn(*args, **kw)
        return run
    for (m, a, fn), (_, _, label) in zip(saved, spans):
        setattr(m, a, wrapped(fn, label))
    try:
        yield
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)


def lm_profile(torch, cfg, model, inputs, cache_len, label="lm",
               expect=None, spans=()) -> dict[str, dict[str, float]]:
    """One prefill and one decode step under torch.profiler: device busy
    time by kernel, and that of the elementwise kernels, against the
    step's wall time.  ``expect`` maps each step to the kernel names
    (see ``named``) it must run and those it must not; ``spans`` (see
    ``spans_on``) are timed by the kernels that ran inside each (see
    ``span_times``) → {step: {span label: (ms, matrix-product ms),
    "busy": the step's device busy ms, "wall": its wall ms, "rmsnorm":
    the RMSNorm kernels' device ms}}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    prefill, decode = make_prefill_step(cfg, cache_len), make_decode_step(cfg)
    tok, cache = prefill(model, inputs)
    torch.cuda.synchronize()
    labels = {lab for _, _, lab in spans}
    by_span = {}
    for what in ("prefill", "decode step"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof, \
                spans_on(torch, spans):
            t0 = time.perf_counter()
            if what == "prefill":
                prefill(model, inputs)
            else:
                decode(model, tok, cache)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # (a span's GPU-side range is no kernel of its own)
        rows = [r for r in prof.key_averages()
                if r.device_type == DeviceType.CUDA
                and r.self_device_time_total and r.key not in labels]
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
        if spans:
            by_span[what] = dict(
                span_times(prof, labels), busy=busy_ms, wall=wall_ms,
                rmsnorm=sum(r.self_device_time_total for r in rows
                            if "rmsnorm" in r.key) / 1e3)
            log("  device ms in each span (all kernels / matrix products): "
                + ", ".join(f"{lab} {t[0]:.3f} / {t[1]:.3f}"
                            for lab, t in by_span[what].items()
                            if lab in labels))
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
    return by_span


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


def moe_kernels(torch, ops, ref, dev):
    """Phase 14: phase 6's checks and timings at the MoE slice's shapes
    (32 query heads over 4 KV heads; RMSNorm at every row shape of its
    path) → (max |kernel - plain| per kernel, the path's RMSNorm row
    shapes with their launches)."""
    from repro_torch import configs
    cfg = configs.get("qwen3-moe-30b-a3b")
    heads = (cfg.n_heads, cfg.n_kv_heads)
    shapes = rms_shapes(cfg, MOE_B, MOE_S, MOE_NEW)
    flash, decode = lm_cases(*heads)
    err = check_lm_kernels(torch, ops, ref, dev, (flash,), (decode,),
                           sorted(shapes), "moe kernels")
    log("moe kernels, timed (bf16):")
    time_lm_kernels(torch, ops, ref, dev, heads)
    time_rmsnorm_shapes(torch, ops, dev, {"moe": shapes})
    return err, shapes


def moe_formulations(torch, dev) -> None:
    """Phase 16a: ``moe_mlp`` and ``moe_mlp_gshard`` at one group size
    (``MOE_GROUP``) on one layer of qwen3-moe-30b-a3b's full-width
    weights and 8192 tokens: fp32 within rtol = atol = 2e-4, bf16 within
    2e-2 of the output's largest magnitude, with the same dropped (t, k)
    slots and the same aux.  (In bf16 the sort formulation rounds each
    weighted slot to bf16 before the sum over k, as the reference does,
    and GShard's combine sums in fp32 and rounds once; where the k terms
    cancel, an element's own magnitude is no scale for that rounding.)"""
    from repro_torch import configs
    from repro_torch.models import mlp
    from repro_torch.models.common import Init, Leaves
    cfg = configs.get("qwen3-moe-30b-a3b").replace(
        moe_group_size=MOE_GROUP, moe_gshard_group=MOE_GROUP)
    p32 = mlp.moe_params(cfg, Init(torch.Generator(device=dev).manual_seed(11),
                                   torch.float32, dev))
    x32 = torch.randn(MOE_B, MOE_S, cfg.d_model, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(12))
    C = mlp._capacity(MOE_GROUP, cfg)
    for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
        p = Leaves({k: v if k == "router" else v.to(dtype)
                    for k, v in p32.items()})
        x = x32.to(dtype)
        y_s, aux_s = mlp.moe_mlp(cfg, p, x)
        y_g, aux_g = mlp.moe_mlp_gshard(cfg, p, x)
        r = mlp.route(cfg, p, mlp.groups(x, MOE_GROUP))
        kept_s = mlp.sort_slots(r.top_e, cfg.n_experts, C).kept
        kept_g = mlp.gshard_slots(r.top_e, cfg.n_experts, C)[2]
        same_slots = torch.equal(kept_s.reshape(kept_g.shape), kept_g)
        d = float((y_s.float() - y_g.float()).abs().max())
        scale = float(y_g.float().abs().max())
        close = (torch.allclose(y_s, y_g, rtol=tol, atol=tol)
                 if dtype == torch.float32 else d <= tol * scale)
        log(f"moe formulations ({str(dtype).split('.')[-1]}, groups of "
            f"{MOE_GROUP}, capacity {C}): sort vs gshard max |diff| {d:.4g} "
            f"(|y| max {scale:.4g}; held at "
            + (f"rtol = atol = {tol}" if dtype == torch.float32
               else f"{tol} x |y| max") + f"); dropped slots "
            f"{int((~kept_s).sum())} of {kept_s.numel()}, the same in both: "
            f"{same_slots}; aux {float(aux_s):.6g} / {float(aux_g):.6g}")
        if not (same_slots and close and torch.equal(aux_s, aux_g)):
            raise AssertionError(f"moe formulations ({dtype}) disagree")
        del p, x, y_s, y_g, r
    del p32, x32
    torch.cuda.empty_cache()


@contextlib.contextmanager
def routes_logged(mlp, calls: list):
    """While open, each ``mlp.route`` call appends its (logits, top_e)
    to ``calls``: per forward, one call a layer in order."""
    route = mlp.route

    def logged(cfg, p, xg):
        r = route(cfg, p, xg)
        calls.append((r.logits, r.top_e))
        return r
    mlp.route = logged
    try:
        yield calls
    finally:
        mlp.route = route


def moe_route_pair(torch, lm, cfg, model, inputs, cache_len, feed) -> dict:
    """The kernel and plain routes on one model's weights, prefill then
    the teacher-forced ``feed``, each layer's routing logged → {"kern",
    "plain": (logits, final cache, routing calls)}."""
    from repro_torch.models import mlp
    runs = {}
    for name, c in (("kern", cfg), ("plain", cfg.replace(attn_impl="xla"))):
        with routes_logged(mlp, []) as calls:
            logits, cache = route_logits(lm, c, model, inputs, cache_len,
                                         feed)
        runs[name] = (logits, cache, calls)
    return runs


def choice_flips(torch, kern, plain, K: int):
    """One routing call of each route → (the share of (token, k) choices
    whose expert the other route did not choose; a (tokens, 3) tensor
    with a row for each token with such a choice: on the plain route the
    gap between its k-th and (k+1)-th probability and logit, and the
    largest difference of its router logits between the routes).  Two
    experts can trade places only where the logit gap is at most twice
    that difference."""
    (lk, ek), (lp, ep) = kern, plain
    E = lp.shape[-1]

    def chosen(e):
        return torch.nn.functional.one_hot(e, E).sum(-2)
    missing = K - (chosen(ek) * chosen(ep)).sum(-1)          # (G, Tg)
    lk, lp = lk[missing > 0], lp[missing > 0]                # (flipped, E)
    logit = lp.topk(K + 1).values
    prob = torch.softmax(lp, -1).topk(K + 1).values
    flips = torch.stack([prob[:, K - 1] - prob[:, K],
                         logit[:, K - 1] - logit[:, K],
                         (lk - lp).abs().amax(-1)], -1)
    return float(missing.sum()) / (missing.numel() * K), flips


def moe_inputs(torch, cfg, dev):
    """The slice's synthetic prompts for ``cfg`` (``serve.setup``'s, seed
    0), its cache length and phase 8's four decode tokens."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    data = SyntheticLM(cfg, DataConfig(MOE_B, MOE_S, 0), device=dev)
    inputs = {k: v for k, v in next(data).items() if k != "targets"}
    g = torch.Generator(device=dev).manual_seed(4)
    feed = torch.randint(0, cfg.vocab, (4, MOE_B, 1), generator=g,
                         device=dev, dtype=torch.int32)
    return inputs, MOE_S + MOE_NEW, feed


def moe_fp32_parity(torch, lm, dev) -> None:
    """Phase 16b: fp32, TF32 off, full width, 2 layers, for each of
    ``MOE_PARITY_ARCHS``: the kernel route within 2e-4 of the plain
    route (logits of the prefill and 4 decode steps, final cache) with
    the same argmax, and every layer's expert choices equal; a flip is
    printed with its gaps, and one at a logit gap wider than the routes'
    difference allows is named a fault."""
    from repro_torch import configs
    for arch in MOE_PARITY_ARCHS:
        cfg = configs.get(arch).replace(n_layers=2, dtype="float32",
                                        attn_impl="pallas")
        model = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        inputs, cache_len, feed = moe_inputs(torch, cfg, dev)
        runs = moe_route_pair(torch, lm, cfg, model, inputs, cache_len, feed)
        gate = dict(tol=2e-4, argmax=True, plain=runs["plain"][0],
                    cache_tol={"k": 2e-4, "v": 2e-4},
                    plain_cache=runs["plain"][1])
        res = held_to(torch, gate, *runs["kern"][:2])
        flips, shares = [], []
        for call, (a, b) in enumerate(zip(runs["kern"][2], runs["plain"][2])):
            share, f = choice_flips(torch, a, b, cfg.top_k)
            shares.append(share)
            flips += [(call % cfg.n_layers, *x) for x in f.tolist()]
        faults = [f for f in flips if f[2] > 2 * f[3]]
        res["expert choices equal"] = (len(runs["kern"][2]) - sum(
            s > 0 for s in shares), bool(flips))
        log(f"moe parity ({arch}, float32, 2 layers, {cfg.n_experts} "
            f"experts top-{cfg.top_k}): "
            + ", ".join(f"{k} {v:.4g}{' FAILS' if bad else ''}"
                        for k, (v, bad) in res.items())
            + f" (of {len(shares)} routing calls)")
        for layer, pgap, lgap, diff in flips[:10]:
            log(f"  flip in layer {layer}: k-th minus (k+1)-th probability "
                f"{pgap:.4g}, logit {lgap:.4g}; the routes' logits differ "
                f"by {diff:.4g}{' FAULT' if lgap > 2 * diff else ''}")
        if faults:
            raise AssertionError(f"moe parity ({arch}): {len(faults)} expert "
                                 f"choices flipped at a gap wider than the "
                                 f"routes' difference")
        failed = [k for k, (_, bad) in res.items() if bad]
        if failed:
            raise AssertionError(f"moe parity ({arch}, float32): the routes "
                                 f"differ in {failed}")
        del model, runs, gate
        torch.cuda.empty_cache()


def moe_full_depth(torch, serve, lm, dev):
    """Phase 16c, first half: the slice's bf16 model at full depth on
    both routes (prefill and 4 teacher-forced steps): the largest logit
    difference, the argmax agreement and each layer's share of expert
    choices that differ, printed → the model, its inputs, cache length
    and feed."""
    args = serve.parse_args(MOE_ARGS)
    cfg, model, inputs, cache_len = serve.setup(args)
    feed = moe_inputs(torch, cfg, dev)[2]
    runs = moe_route_pair(torch, lm, cfg, model, inputs, cache_len, feed)
    (kern, _, kcalls), (plain, _, pcalls) = runs["kern"], runs["plain"]
    diffs = [float((a - b).abs().max()) for a, b in zip(kern, plain)]
    agree = [int((a.argmax(-1) == b.argmax(-1)).sum())
             for a, b in zip(kern, plain)]
    L = cfg.n_layers
    shares = [choice_flips(torch, a, b, cfg.top_k)[0]
              for a, b in zip(kcalls, pcalls)]
    prefill, decode = shares[:L], shares[L:]
    log(f"moe parity ({cfg.dtype}, {L} layers): kernel vs plain route max "
        f"|diff| of logits, prefill then 4 decode steps: "
        f"{[f'{d:.4g}' for d in diffs]}; argmax agrees for {agree} of "
        f"{args.batch} each")
    log(f"  share of expert choices that differ between the routes, prefill, "
        f"by layer: {[round(x, 5) for x in prefill]}")
    log(f"  the same over the 4 decode steps, by layer: "
        f"{[round(sum(decode[i::L]) / 4, 5) for i in range(L)]}")
    del runs, kern, plain, kcalls, pcalls
    torch.cuda.empty_cache()
    return cfg, model, inputs, cache_len, feed


def truth(torch, lm, name, cfg, inputs, cache_len, feed, dev,
          layers) -> None:
    """At full width and ``layers`` layers (fresh weights from seed 0),
    each bf16 route against an fp32 plain run of the same weights; the
    kernel route's mean logit error must be at most 1.1x the plain
    route's (phases 16c and 20)."""
    cfg = cfg.replace(n_layers=layers)
    model = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    out = {n: route_logits(lm, c, model, inputs, cache_len, feed)[0]
           for n, c in (("kern", cfg), ("plain", cfg.replace(attn_impl="xla")))}
    model = copy.deepcopy(model).float()
    ref_out = route_logits(lm, cfg.replace(dtype="float32", attn_impl="xla"),
                           model, inputs, cache_len, feed)[0]
    del model
    torch.cuda.empty_cache()
    err = {n: float(torch.stack([(a - b).abs() for a, b in zip(o, ref_out)]
                                ).mean()) for n, o in out.items()}
    worst = {n: max(float((a - b).abs().max()) for a, b in zip(o, ref_out))
             for n, o in out.items()}
    log(f"{name} parity (bfloat16, {layers} layers) against fp32 from the "
        f"same weights: "
        + "; ".join(f"{r} route max {worst[n]:.4g} mean {err[n]:.4g}"
                    for r, n in (("kernel", "kern"), ("plain", "plain")))
        + f"; mean ratio {err['kern'] / max(err['plain'], 1e-30):.4f} "
        f"(held at 1.1)")
    if err["kern"] > 1.1 * err["plain"]:
        raise AssertionError(f"{name} parity: the kernel route is less "
                             f"accurate than the plain route")


def moe_profile(torch, lm, cfg, model, inputs, cache_len) -> None:
    """Phase 17: one prefill and one decode step of the full-depth bf16
    model under torch.profiler (the kernels ``LM_STEP_KERNELS`` names
    must run), with the device time in the router, the expert products
    and the rest of the routed MLP (the sort, its searches and the
    gathers of indices and activations, and the weighting)."""
    from repro_torch.models import mlp
    routed, router, experts = ("moe: routed MLP", "moe: router",
                               "moe: expert products")
    spans = ((lm, "moe_mlp", routed), (mlp, "route", router),
             (mlp, "_experts", experts))
    by_span = lm_profile(torch, cfg, model, inputs, cache_len, label="moe",
                         expect=LM_STEP_KERNELS, spans=spans)
    for what, t in by_span.items():
        rest = t[routed][0] - t[router][0] - t[experts][0]
        log(f"moe profile ({what}), device ms over {cfg.n_layers} layers: "
            f"expert products {t[experts][0]:.3f} (matrix products "
            f"{t[experts][1]:.3f}, the rest the einsums' permute copies and "
            f"the SiLU), sort/gather/index and weighting {rest:.3f}, router "
            f"{t[router][0]:.3f}; the routed MLP {t[routed][0]:.3f} of the "
            f"step's busy {t['busy']:.3f}")


def hybrid_encdec_kernels(torch, ops, ref, dev):
    """Phase 18: phase 6's checks at the hybrid and enc-dec slices'
    shapes (``HYB_FLASH``/``ENC_FLASH``, decode over each slice's cache
    at ``HYB_POSITIONS``/``ENC_POSITIONS`` and forced split counts,
    RMSNorm at every row shape of the hybrid path), fp32 and bf16 within
    2e-5 / 2e-2; then each shape timed beside its bound and SDPA /
    ``F.rms_norm`` → (max |kernel - plain| per kernel, the hybrid path's
    RMSNorm row shapes with their launches)."""
    from repro_torch import configs
    hyb, enc = configs.get("zamba2-7b"), configs.get("whisper-small")
    shapes = rms_shapes(hyb, HYB_B, HYB_S, HYB_NEW)
    decode = {
        "hybrid": (HYB_B, HYB_S + HYB_NEW, hyb.n_heads, hyb.n_kv_heads,
                   hyb.hd, HYB_POSITIONS),
        "enc-dec": (ENC_B, ENC_S + ENC_NEW, enc.n_heads, enc.n_kv_heads,
                    enc.hd, ENC_POSITIONS)}
    flash = {**HYB_FLASH, **ENC_FLASH}
    err = check_lm_kernels(torch, ops, ref, dev, tuple(flash.values()),
                           tuple(decode.values()), sorted(shapes),
                           "hybrid/enc-dec kernels")
    log("hybrid/enc-dec kernels, timed (bf16):")
    for what, case in flash.items():
        log(f" {what}:")
        time_flash(torch, ops, ref, dev, *case)
    for what, (B, smax, H, KV, hd, positions) in decode.items():
        log(f" {what} decode:")
        time_decode(torch, ops, ref, dev, B, smax, H, KV, hd, positions[-1])
    time_rmsnorm_shapes(torch, ops, dev, {"hybrid": shapes})
    return err, shapes


def hybrid_profile(torch, lm, cfg, model, inputs, cache_len) -> None:
    """Phase 23, hybrid half: one prefill and one decode step of the
    full-depth bf16 zamba2 under torch.profiler (prefill must run
    ``flash_attention_tc_kernel``, decode both decode kernels, neither
    the scan), with the device time in the SSD (its intra-chunk mask and
    exp, its carry, and the rest: the products, dt·x, the cumulative
    sum), in the Mamba-2 blocks, in the shared block and in RMSNorm."""
    from repro_torch.models import ssm
    ssd, decay, carry, blocks, shared = (
        "hybrid: SSD", "hybrid: SSD mask/exp", "hybrid: SSD carry",
        "hybrid: Mamba-2 blocks", "hybrid: shared block")
    spans = ((ssm, "_ssd_chunk", ssd), (ssm, "_ssd_decay", decay),
             (ssm, "_ssd_carry", carry), (lm, "mamba2_block", blocks),
             (lm, "attn_mlp_block", shared))
    by_span = lm_profile(torch, cfg, model, inputs, cache_len, label="hybrid",
                         expect=HYB_STEP_KERNELS, spans=spans)
    for what, t in by_span.items():
        rest = t[ssd][0] - t[decay][0] - t[carry][0]
        log(f"hybrid profile ({what}), device ms over {cfg.n_layers} layers: "
            f"SSD {t[ssd][0]:.3f} (mask/exp {t[decay][0]:.3f}, carry "
            f"{t[carry][0]:.3f}, products and the rest {rest:.3f}); Mamba-2 "
            f"blocks {t[blocks][0]:.3f} (matrix products {t[blocks][1]:.3f}); "
            f"shared block {t[shared][0]:.3f} (matrix products "
            f"{t[shared][1]:.3f}) over {cfg.n_attn_apps} applications; "
            f"RMSNorm {t['rmsnorm']:.3f}; busy {t['busy']:.3f} of wall "
            f"{t['wall']:.2f} (idle share {1 - t['busy'] / t['wall']:.4f})")


def encdec_profile(torch, lm, cfg, model, inputs, cache_len) -> None:
    """Phase 23, enc-dec half: one prefill and one decode step of
    whisper-small under torch.profiler (prefill must run
    ``flash_attention_tc_kernel``; decode both decode kernels and flash
    for the cross-attention; no RMSNorm), with the device time in the
    encoder, the decoder's self-attention and its cross-attention."""
    encoder, self_attn, cross = ("whisper: encoder",
                                 "whisper: decoder self-attention",
                                 "whisper: cross-attention")
    spans = ((lm, "encode", encoder), (lm, "attn_mlp_block", self_attn),
             (lm, "_cross_attention", cross))
    by_span = lm_profile(torch, cfg, model, inputs, cache_len,
                         label="enc-dec", expect=ENC_STEP_KERNELS,
                         spans=spans)
    for what, t in by_span.items():
        log(f"enc-dec profile ({what}), device ms: encoder {t[encoder][0]:.3f}"
            f" (matrix products {t[encoder][1]:.3f}); decoder self-attention "
            f"{t[self_attn][0]:.3f}; cross-attention {t[cross][0]:.3f} "
            f"(matrix products {t[cross][1]:.3f}); busy {t['busy']:.3f} of "
            f"wall {t['wall']:.2f} (idle share "
            f"{1 - t['busy'] / t['wall']:.4f})")


def hybrid_encdec_phases(torch, ops, ref, serve, lm, dev):
    """Phases 18-23 → (max |kernel - plain| at their shapes, the hybrid
    and the enc-dec slices' launch counts)."""
    t_new = time.perf_counter()
    new_err, hyb_rows = hybrid_encdec_kernels(torch, ops, ref, dev)
    log(f"hybrid/enc-dec kernels (check-phase launches): "
        f"{json.dumps(ops.launch_counts())}")

    # --------------------------------------------------------- hybrid slice
    gc.collect()
    torch.cuda.empty_cache()
    hyb_launches = serve_slice(torch, ops, serve, "hybrid", HYB_ARGS,
                               hybrid_expect)
    rms_counted(hyb_launches, hyb_rows, "hybrid")

    # ------------------------------------------------- hybrid parity, profile
    gc.collect()
    torch.cuda.empty_cache()
    cfg, model, inputs, cache_len, feed, gates = parity(
        torch, serve, lm, dev, "hybrid", HYB_ARGS, None, False,
        fp32_layers=HYB_LAYERS)
    del gates
    hybrid_profile(torch, lm, cfg, model, inputs, cache_len)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    truth(torch, lm, "hybrid", cfg, inputs, cache_len, feed, dev, HYB_LAYERS)

    # -------------------------------------------------------- enc-dec slice
    gc.collect()
    torch.cuda.empty_cache()
    enc_launches = serve_slice(torch, ops, serve, "enc-dec", ENC_ARGS,
                               encdec_expect)

    # ------------------------------------------------ enc-dec parity, profile
    gc.collect()
    torch.cuda.empty_cache()
    cfg, model, inputs, cache_len, feed, gates = parity(
        torch, serve, lm, dev, "enc-dec", ENC_ARGS, 5e-2, True,
        fp32_layers=None)
    del gates
    encdec_profile(torch, lm, cfg, model, inputs, cache_len)
    log(f"hybrid/enc-dec phases 18-23 took {time.perf_counter() - t_new:.1f} "
        f"s; max |kernel - plain| at their shapes {json.dumps(new_err)}; the "
        f"slices' launches: hybrid {json.dumps(hyb_launches)}, enc-dec "
        f"{json.dumps(enc_launches)}")
    return new_err, hyb_launches, enc_launches


# --------------------------------------------------------------------------- #
# Phase 37: the rest of the dense and vlm registry
# --------------------------------------------------------------------------- #
def reg_args(arch: str) -> list[str]:
    """Phase 37's serving flags for ``arch``."""
    return ["--arch", arch, "--batch", str(REG_B), "--prompt-len",
            str(REG_S), "--new-tokens", str(REG_NEW), "--seed", "0"]


def registry_kernels(torch, ops, ref, dev):
    """Phase 37a: phase 6's checks at the shapes the four archs' serves
    give the kernels (flash over each prefill; decode over each cache at
    positions 0, 511, the first decode step's and the last, with forced
    split counts; RMSNorm at every row shape of the four paths), fp32 and
    bf16 within 2e-5 / 2e-2; then decode timed at each arch's last step
    and flash at granite-20b's and phi-3-vision-4.2b's prefill, beside
    their bound and SDPA → (max |kernel - plain| per kernel, {arch: the
    path's RMSNorm row shapes with their launches})."""
    from repro_torch import configs
    flash, decode, shapes = {}, {}, {}
    for arch in REG_ARCHS:
        cfg = configs.get(arch)
        # a vlm's cache also takes its patches (serve.setup, as the
        # reference's), though its prompt already holds them
        smax = REG_S + REG_NEW + (cfg.n_patches if cfg.family == "vlm"
                                  else 0)
        heads = (cfg.n_heads, cfg.n_kv_heads, cfg.hd)
        flash[arch] = (REG_B, REG_S, REG_S, *heads, True)
        decode[arch] = (REG_B, smax, *heads,
                        (0, 511, REG_S, REG_S + REG_NEW - 1))
        shapes[arch] = rms_shapes(cfg, REG_B, REG_S, REG_NEW)
    rows = sorted({sh for p in shapes.values() for sh in p})
    err = check_lm_kernels(torch, ops, ref, dev, tuple(flash.values()),
                           tuple(decode.values()), rows, "registry kernels")
    log("registry kernels, timed (bf16):")
    for arch in ("granite-20b", "phi-3-vision-4.2b"):
        log(f" {arch} prefill:")
        time_flash(torch, ops, ref, dev, *flash[arch])
    for arch, (B, smax, H, KV, hd, positions) in decode.items():
        log(f" {arch} decode:")
        time_decode(torch, ops, ref, dev, B, smax, H, KV, hd, positions[-1])
    return err, shapes


def registry_phases(torch, ops, ref, serve, lm, dev):
    """Phase 37 → (max |kernel - plain| at its shapes, {arch: the slice's
    launch counts})."""
    t_reg = time.perf_counter()
    err, shapes = registry_kernels(torch, ops, ref, dev)
    log(f"registry kernels (check-phase launches): "
        f"{json.dumps(ops.launch_counts())}")
    launched = {}
    for arch in REG_ARCHS:
        t_arch = time.perf_counter()
        argv = reg_args(arch)
        gc.collect()
        torch.cuda.empty_cache()
        launched[arch] = serve_slice(torch, ops, serve, arch, argv, lm_expect)
        rms_counted(launched[arch], shapes[arch], arch)
        gc.collect()
        torch.cuda.empty_cache()
        cfg, model, inputs, cache_len, feed, gates = parity(
            torch, serve, lm, dev, arch, argv, 5e-2, "ties")
        del model, gates
        gc.collect()
        torch.cuda.empty_cache()
        if arch in REG_TRUTH_LAYERS:
            truth(torch, lm, arch, cfg, inputs, cache_len, feed, dev,
                  REG_TRUTH_LAYERS[arch])
        del cfg, inputs, cache_len, feed
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{arch} (phase 37) took {time.perf_counter() - t_arch:.1f} s; "
            f"the card holds {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
            f"after it")
    left = torch.cuda.memory_allocated()
    if left > REG_LEFT_GIB * 2**30:
        raise AssertionError(f"phase 37 left {left} B allocated on the card")
    log(f"registry phase 37 took {time.perf_counter() - t_reg:.1f} s; max "
        f"|kernel - plain| at its shapes {json.dumps(err)}; the slices' "
        f"launches "
        + ", ".join(f"{a} flash {n['flash_attention']}, decode "
                    f"{n['decode_attention']}, rmsnorm {n['fused_rmsnorm']}"
                    for a, n in launched.items()))
    return err, launched


# --------------------------------------------------------------------------- #
# Phases 24-27: training
# --------------------------------------------------------------------------- #
def train_pair(torch, steps, cfg, model_cpu, batch_cpu, dev, opt) -> list:
    """The same weights and batch on the CPU and on the card: loss_fn's
    loss and gradients, then one ``make_train_step`` from fresh copies →
    [CPU, card], each {"loss", "grads", "metrics", "params"} on the host.
    The kernels' launch counts must not move on either device."""
    from repro_torch.kernels import ops
    out = []
    for d in (torch.device("cpu"), dev):
        batch = {k: v.to(d) for k, v in batch_cpu.items()}
        model = copy.deepcopy(model_cpu).to(d).requires_grad_(True)
        names, params = zip(*model.named_parameters())
        ops.reset_launch_counts()
        loss, _ = steps.loss_fn(cfg, model, batch)
        grads = torch.autograd.grad(loss, params)
        res = {"loss": loss.item(),
               "grads": {n: g.detach().cpu() for n, g in zip(names, grads)}}
        del grads, loss
        state, m = steps.make_train_step(cfg, opt)(
            steps.train_state(model), batch)
        res["metrics"] = {k: v.item() for k, v in m.items()}
        res["params"] = {n: p.detach().cpu()
                         for n, p in state["model"].named_parameters()}
        moved = {k: n for k, n in ops.launch_counts().items() if n}
        if moved:
            raise AssertionError(f"a training step on {d} launched kernels: "
                                 f"{moved}")
        out.append(res)
        del state, model
    return out


def held_pair(torch, what, cpu, card, lr, grad_frac, loss_rtol) -> None:
    """The card's step against the CPU's: the loss and the metrics within
    ``loss_rtol``; every gradient leaf within ``grad_frac`` of its
    largest magnitude; every parameter within 1e-2 of the learning rate
    but for at most 1e-3 of a leaf's elements (an element whose gradient
    is near Adam's eps moves by lr times its gradient's relative error),
    and none further than 2 lr."""
    worst = {"loss": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])}
    for k, v in cpu["metrics"].items():
        worst[k] = abs(card["metrics"][k] - v) / max(abs(v), 1e-30)
    g_err, p_share, p_max = 0.0, 0.0, 0.0
    for n, g in cpu["grads"].items():
        top = float(g.abs().max())
        g_err = max(g_err, float((card["grads"][n] - g).abs().max())
                    / max(top, 1e-30))
    for n, p in cpu["params"].items():
        diff = (card["params"][n].float() - p.float()).abs()
        p_share = max(p_share, float((diff > 1e-2 * lr).float().mean()))
        p_max = max(p_max, float(diff.max()))
    rel = {k: float(f"{v:.3e}") for k, v in worst.items()}
    log(f"  {what}: loss {card['loss']:.7f} (CPU {cpu['loss']:.7f}); "
        f"relative errors {json.dumps(rel)}; "
        f"gradients max |card - CPU| / max |g| {g_err:.3e} over "
        f"{len(cpu['grads'])} leaves; params: share beyond 1e-2 lr "
        f"{p_share:.2e}, max |card - CPU| {p_max:.3e} (lr {lr:.1e})")
    bad = {k: v for k, v in worst.items() if v > loss_rtol}
    if bad or g_err > grad_frac or p_share > 1e-3 or p_max > 2 * lr:
        raise AssertionError(f"{what}: the card's train step is not the "
                             f"CPU's ({bad}, gradients {g_err:.3e}, params "
                             f"{p_share:.2e} / {p_max:.3e})")


def train_parity(torch, dev) -> None:
    """Phase 24: the card's train step held to the CPU's, qwen3-1.7b at
    full width and 2 layers in fp32 and every family's reduced config;
    then bf16 against fp32 at 2 layers."""
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import lm
    from repro_torch.optim import OptConfig, cosine_schedule
    from repro_torch.runtime import steps
    t0 = time.perf_counter()
    opt = OptConfig(lr=cosine_schedule(TRAIN_LR, 1, 10))
    cases = [(TRAIN_ARCH, configs.get(TRAIN_ARCH).replace(
        n_layers=TRAIN_PARITY_LAYERS, dtype="float32"), TRAIN_PARITY_B,
        TRAIN_PARITY_S)]
    cases += [(name, configs.reduced(name), 2, 32)
              for name in TRAIN_FAMILIES.values()]
    for i, (name, cfg, B, S) in enumerate(cases):
        cfg = cfg.replace(attn_impl="xla")
        model = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
        batch = SyntheticLM(cfg, DataConfig(B, S, 0), device="cpu").batch_at(0)
        cpu, card = train_pair(torch, steps, cfg, model, batch, dev, opt)
        held_pair(torch, f"{cfg.name} ({cfg.family}, {cfg.n_layers} layers, "
                  f"fp32, batch {B}, seq {S})", cpu, card, TRAIN_LR,
                  TRAIN_GRAD_FRAC, 1e-5)
        if i == 0:                     # the full-width case
            full_model, full_batch = model, batch
            fp32_loss = card["loss"]
        del cpu, card
    # a train step of a config that asks for the kernels raises on the
    # card before anything launches: the kernels have no backward
    from repro_torch.kernels import ops
    cfg = configs.reduced(TRAIN_ARCH).replace(attn_impl="pallas")
    state = steps.init_train_state(cfg, torch.Generator(device=dev)
                                   .manual_seed(0), device=dev)
    batch = SyntheticLM(cfg, DataConfig(2, 32, 0), device=dev).batch_at(0)
    ops.reset_launch_counts()
    try:
        steps.make_train_step(cfg, opt)(state, batch)
    except RuntimeError as e:
        log(f"  {cfg.name} with attn_impl='pallas' on the card raised: {e}")
    else:
        raise AssertionError("a train step on the kernel route ran")
    if any(ops.launch_counts().values()):
        raise AssertionError(f"the refused step launched: "
                             f"{ops.launch_counts()}")
    del state
    # bf16 at 2 layers, the same weights rounded, against the fp32 loss
    cfg = cases[0][1].replace(dtype="bfloat16", attn_impl="xla")
    model = copy.deepcopy(full_model).to(dev, torch.bfloat16)
    with torch.no_grad():
        bf16_loss = steps.loss_fn(
            cfg, model, {k: v.to(dev) for k, v in full_batch.items()})[0].item()
    log(f"  {cfg.name} bf16 (2 layers): loss {bf16_loss:.7f} against fp32 "
        f"{fp32_loss:.7f}: |diff| {abs(bf16_loss - fp32_loss):.3e} (within "
        f"{TRAIN_BF16_TOL})")
    if not abs(bf16_loss - fp32_loss) <= TRAIN_BF16_TOL:
        raise AssertionError("bf16 train loss too far from fp32")
    fp32_product_check(torch, cfg, model, full_batch, dev)
    del model, full_model
    log(f"train parity (phase 24) took {time.perf_counter() - t0:.1f} s")


def fp32_product_check(torch, cfg, model, batch_cpu, dev) -> None:
    """The bf16 head's backward on the card (``common._Fp32Product``)
    against the reference's transpose computed here in fp32: the logits'
    fp32 cotangent times each operand upcast.  At the 2-layer model's
    final hidden states and its tied table, each gradient must be that
    fp32 product rounded to bf16 in all but ``TRAIN_PRODUCT_SHARE`` of
    its elements (cuBLAS may sum in another order) and within one bf16
    ulp everywhere.  A cotangent rounded to bf16 first, printed beside,
    would round about a third of them the other way."""
    from repro_torch.models import common, lm
    batch = {k: v.to(dev) for k, v in batch_cpu.items()}
    with torch.no_grad():
        x2 = lm.hidden_train(cfg, model, batch)[0]
        x2 = x2.reshape(-1, x2.shape[-1])
    w = model.embed.table.detach().t()
    labels = batch["targets"].reshape(-1)
    # the fp32 cotangent of the logits, from the upcast product
    logits = (x2.float() @ w.float()).requires_grad_(True)
    g, = torch.autograd.grad(common._lse_minus_label(logits, labels).sum(),
                             logits)
    want = {"x": g @ w.t().float(), "table": (x2.t().float() @ g).t()}
    xg, wg = x2.clone().requires_grad_(True), w.clone().requires_grad_(True)
    common._Fp32Product.apply(xg, wg).backward(g)
    got = {"x": xg.grad, "table": wg.grad.t()}
    g16 = g.to(torch.bfloat16)
    rounded = {"x": g16 @ w.t(), "table": (x2.t() @ g16).t()}
    for k, r in want.items():
        share = float((got[k] != r.to(torch.bfloat16)).float().mean())
        ulp = (r.abs() * 2.0 ** -7).clamp_min(float(r.abs().max()) * 2e-13)
        ulps = float(((got[k].float() - r).abs() / ulp).max())
        old = float((rounded[k] != r.to(torch.bfloat16)).float().mean())
        log(f"  bf16 head backward, d{k} {tuple(r.shape)}: {got[k].dtype}, "
            f"share not the fp32 product rounded {share:.3e} (a bf16 "
            f"cotangent: {old:.3e}), max {ulps:.3f} ulp")
        if got[k].dtype != torch.bfloat16 or share > TRAIN_PRODUCT_SHARE \
                or ulps > 1.0:
            raise AssertionError(f"the bf16 head's backward (d{k}) is not "
                                 "the reference's fp32 transpose")


def model_flops(cfg, n_params: int, B: int, S: int) -> float:
    """Model FLOPs of one train step, without the recompute: 6 N T for
    the weights (the tied table counted once, as the head) plus the
    causal attention's products, 3 x 2 x 2 B S^2/2 H hd a layer."""
    attn = 6 * cfg.n_layers * B * S * S * cfg.n_heads * cfg.hd
    return 6.0 * n_params * B * S + attn


def planned_step(pcfg, mesh, B: int) -> dict:
    """The planner's prediction for a pipelined training run of batch
    ``B`` on ``mesh``: the pick that chose ``pcfg``'s cuts
    (``pcfg.plan``, priced for the mesh's cards a stage by
    ``launch.mesh.plan_pipeline``) → its cards a stage, latency (one
    batch through every stage, no overlap), each stage's ms on the batch,
    and the step: B / throughput (the slowest stage on the batch) times
    GPipe's fill, (M + K - 1) / M."""
    from repro_torch.launch.mesh import cards_per_pod
    pick, K, M = pcfg.plan, pcfg.n_stages, pcfg.microbatches
    return {"cards": cards_per_pod(mesh), "latency_ms": pick.latency_s * 1e3,
            "stage_ms": [st.compute_s * 1e3 for st in pick.stages],
            "step_ms": B / pick.throughput * 1e3 * (M + K - 1) / M}


def plan_line(plan: dict, med: float) -> str:
    """``planned_step``'s prediction beside the measured median step."""
    return (f"the planner's prediction ({plan['cards']} H100 a stage): "
            f"latency {plan['latency_ms']:.2f} ms, stages "
            f"{[round(t, 2) for t in plan['stage_ms']]} ms on the batch, "
            f"step {plan['step_ms']:.2f} ms; measured {med:.2f} ms, "
            f"{med / plan['step_ms']:.2f}x the predicted step")


def train_slice(torch, dev, smi, extra=(), label="train slice (phase 25)"
                ) -> tuple[dict[str, int], dict]:
    """Phase 25: qwen3-1.7b at full width and depth through the launcher's
    own setup, bf16, remat on, batch 8, seq 2048 (two CE chunks), one
    warm-up and ``TRAIN_STEPS`` timed steps on one batch; with ``extra``
    launcher flags (phase 30: the pod pipeline) the same → the kernels'
    launch counts over the run (all 0: training runs the plain route)
    and the run's numbers (losses, median step ms, tokens/s, peak
    bytes)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.runtime import pipeline as pipeline_mod
    from repro_torch.runtime import steps as steps_mod
    n_steps = TRAIN_WARM + TRAIN_STEPS
    B = TRAIN_B
    while True:
        args = train.parse_args(TRAIN_ARGS + list(extra) + [
            "--batch", str(B), "--steps", str(n_steps)])
        cfg, state, step_fn, data, pipe = train.setup(args)
        n_params = state["model"].param_count()
        batch = data.batch_at(0)
        opt_ms = []
        # the module whose step calls the optimizer
        step_mod = steps_mod if pipe is None else pipeline_mod
        apply = step_mod.apply_gradients

        def timed_opt(*a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = apply(*a, **kw)
            ev[1].record()
            opt_ms.append(ev)
            return out
        torch.cuda.synchronize()
        reset_peaks(torch)
        ops.reset_launch_counts()
        losses, step_ms = [], []
        step_mod.apply_gradients = timed_opt
        try:
            for i in range(n_steps):
                t0 = time.perf_counter()
                state, m = step_fn(state, batch)
                losses.append(m["loss"].item())
                step_ms.append((time.perf_counter() - t0) * 1e3)
                if i == 0 and peak_bytes(torch) \
                        > TRAIN_PEAK_GIB * 2**30 and B > 1:
                    break
        finally:
            step_mod.apply_gradients = apply
        torch.cuda.synchronize()
        peaks = [torch.cuda.max_memory_allocated(i)
                 for i in range(torch.cuda.device_count())]
        peak = max(peaks)
        if len(losses) == n_steps:
            break
        log(f"{label}: the warm-up step's peak {peak / 2**30:.2f} GiB "
            f"passed {TRAIN_PEAK_GIB} GiB at batch {B}: halving the batch")
        del state, step_fn, batch
        gc.collect()
        torch.cuda.empty_cache()
        B //= 2
    launches = ops.launch_counts()
    timed = sorted(step_ms[TRAIN_WARM:])
    med = timed[len(timed) // 2] if len(timed) % 2 else \
        (timed[len(timed) // 2 - 1] + timed[len(timed) // 2]) / 2
    opt_t = sorted(a.elapsed_time(b) for a, b in opt_ms[TRAIN_WARM:])
    opt_med = opt_t[len(opt_t) // 2]
    S = args.seq
    flops = model_flops(cfg, n_params, B, S)
    piped = "" if pipe is None else (
        f", {pipe[0].n_stages} stages at cuts {pipe[0].cuts} on "
        f"{[str(d) for d in pipe[1].devices]}, {pipe[0].microbatches} "
        f"microbatches")
    log(f"{label}: {cfg.name} full width and depth "
        f"({cfg.n_layers} layers, {n_params} parameters), {cfg.dtype}, "
        f"remat {cfg.remat}, batch {B}, seq {S}, ce_chunk {cfg.ce_chunk}"
        f"{piped}, on {smi}")
    log(f"  losses {json.dumps([float(f'{l:.6f}') for l in losses])}")
    log(f"  step ms (each) {json.dumps([round(t, 2) for t in step_ms])}; "
        f"median of the {TRAIN_STEPS} timed {med:.2f} ms, "
        f"{B * S / med * 1e3:.0f} tokens/s")
    log(f"  model FLOPs a step {flops:.4e} (6 N T {6.0 * n_params * B * S:.4e}"
        f" + causal attention; without the recompute): "
        f"{flops / (med / 1e3) / 1e12:.1f} TFLOP/s, "
        f"{flops / (med / 1e3) / BF16_FLOP_PER_S:.4f} of 989 TFLOP/s "
        f"(bound {flops / BF16_FLOP_PER_S * 1e3:.1f} ms)")
    log(f"  peak allocated {peak / 2**30:.3f} GiB ({peak} B); optimizer "
        f"{opt_med:.2f} ms a step (device, median), {opt_med / med:.4f} of "
        f"the step")
    log(f"  launches over the run {json.dumps(launches)}")
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"{label}: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss did not fall: {losses}")
    if any(launches.values()):
        raise AssertionError(f"{label} launched kernels: {launches}")
    del state, step_fn, batch
    return launches, {"losses": losses, "step_ms": med, "batch": B,
                      "tokens_s": B * S / med * 1e3, "peak": peak,
                      "peaks": peaks, "flops": flops,
                      "cuts": None if pipe is None else pipe[0].cuts,
                      "plan": None if pipe is None else planned_step(
                          *pipe, B)}


def resume_drill(torch, dev) -> None:
    """Phase 26: the launcher as a user runs it, three processes:
    uninterrupted and crashed at a step (exit 42), side by side, then
    resumed; the resumed losses must be the uninterrupted run's, bit for
    bit.  Then a bf16
    checkpoint of qwen3-1.7b at full width and 2 layers, after one step,
    must restore every leaf ``torch.equal``."""
    import re
    import tempfile
    from repro_torch import configs
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import lm
    from repro_torch.optim import OptConfig
    from repro_torch.runtime import steps
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

    def run(ckpt, *extra):
        cp = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *DRILL_ARGS,
             "--ckpt-dir", ckpt, *extra], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=300)
        return cp, {int(m[1]): m[2] for m in re.finditer(
            r"^step +(\d+) loss (\S+)", cp.stdout, re.M)}

    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".train_drill_") as d:
        # the uninterrupted and the crashed run at once, each in its own
        # checkpoint directory; then the resume
        with ThreadPoolExecutor(2) as pool:
            first = [pool.submit(run, os.path.join(d, "a")),
                     pool.submit(run, os.path.join(d, "b"), "--fail-at-step",
                                 str(DRILL_FAIL))]
            (whole, ref), (crashed, _) = (f.result() for f in first)
        resumed, mine = run(os.path.join(d, "b"))
        for cp, rc in ((whole, 0), (crashed, 42), (resumed, 0)):
            if cp.returncode != rc:
                raise AssertionError(f"train drill: exit {cp.returncode}, "
                                     f"not {rc}:\n{cp.stdout}\n{cp.stderr}")
        start = re.search(r"^\[resume\] step (\d+)", resumed.stdout, re.M)
        want = {s: ref[s] for s in mine}
        log(f"resume drill (phase 26): crashed at step {DRILL_FAIL}, "
            f"resumed from step {start and start[1]}; uninterrupted "
            f"{json.dumps({s: ref[s] for s in sorted(ref)[-4:]})}, resumed "
            f"{json.dumps({s: mine[s] for s in sorted(mine)[-4:]})}")
        if not start or not mine or mine != want or \
                sorted(mine) != list(range(int(start[1]), DRILL_STEPS)):
            raise AssertionError(f"train drill: resumed losses {mine} are "
                                 f"not the uninterrupted run's {want}")

        cfg = configs.get(TRAIN_ARCH).replace(n_layers=TRAIN_PARITY_LAYERS,
                                              attn_impl="xla")
        state = steps.init_train_state(
            cfg, torch.Generator(device=dev).manual_seed(1), device=dev)
        batch = SyntheticLM(cfg, DataConfig(TRAIN_PARITY_B, TRAIN_PARITY_S,
                                            1), device=dev).batch_at(0)
        state, _ = steps.make_train_step(cfg, OptConfig())(state, batch)
        tw = time.perf_counter()
        path = save_checkpoint(os.path.join(d, "bf16"),
                               steps.reference_state(state), 1)
        tw = time.perf_counter() - tw
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        tr = time.perf_counter()
        tree, manifest = load_checkpoint(path)
        back = steps.state_from_reference(cfg, tree, dev)
        tr = time.perf_counter() - tr
        n_eq = 0
        for name, p in state["model"].named_parameters():
            q = dict(back["model"].named_parameters())[name]
            if p.dtype != q.dtype or not torch.equal(p, q):
                raise AssertionError(f"bf16 checkpoint: {name} differs")
            n_eq += 1
        for k in ("m", "v"):
            for name, t in state["opt"][k].items():
                if not torch.equal(t, back["opt"][k][name]):
                    raise AssertionError(f"bf16 checkpoint: {k} {name}")
                n_eq += 1
        for k in ("count",):
            n_eq += bool(torch.equal(state["opt"][k], back["opt"][k]))
        if not torch.equal(state["step"], back["step"]):
            raise AssertionError("bf16 checkpoint: step differs")
        dtypes = sorted({v["dtype"] for v in manifest["leaves"].values()})
        log(f"  bf16 checkpoint ({cfg.name}, {cfg.n_layers} layers, full "
            f"width): {len(manifest['leaves'])} reference leaves, dtypes "
            f"{dtypes}, {size / 2**30:.3f} GiB written in {tw:.1f} s, "
            f"restored in {tr:.1f} s; {n_eq} port tensors torch.equal")
        del state, back, tree
    log(f"resume drill (phase 26) took {time.perf_counter() - t0:.1f} s")


def train_profile(torch, dev) -> None:
    """Phase 27: one full-depth train step under torch.profiler: device
    busy against wall time and the idle share; device ms in matrix
    products and in elementwise kernels; by span, the optimizer, the
    CE's chunks (forward and recompute) and the blocks; the forward (the
    kernels before the first CE chunk's recompute), the backward (the
    rest but the optimizer) and the remat recompute inside it (the
    blocks that run a second time).  The CE's whole cost (its forward, recompute and
    backward) is timed apart with CUDA events.  The full kernel table
    goes to ``chiprun_out/train_profile.txt``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import train
    from repro_torch.models import common
    from repro_torch.models import lm as lm_mod
    from repro_torch.runtime import steps as steps_mod
    args = train.parse_args(TRAIN_ARGS + ["--batch", str(TRAIN_B),
                                          "--steps", "2"])
    cfg, state, step_fn, data, _ = train.setup(args)
    batch = data.batch_at(0)
    state, _ = step_fn(state, batch)                     # warm-up
    torch.cuda.synchronize()
    spans = [(steps_mod, "apply_gradients", "train: optimizer"),
             (lm_mod, "attn_mlp_block", "train: block"),
             (common, "_chunk_ce_sum", "train: ce chunk")]
    labels = {lab for _, _, lab in spans}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            spans_on(torch, spans):
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [r for r in prof.key_averages()
            if r.device_type == DeviceType.CUDA
            and r.self_device_time_total and r.key not in labels]
    if not rows:
        raise AssertionError("train profile: the profiler saw no device "
                             "time")
    busy = sum(r.self_device_time_total for r in rows) / 1e3
    gemm = sum(r.self_device_time_total for r in rows
               if any(p in r.key for p in GEMM_PARTS)) / 1e3
    elem = [r for r in rows if "elementwise" in r.key]
    elem_ms = sum(r.self_device_time_total for r in elem) / 1e3
    span_ms = span_times(prof, labels)
    # the blocks and CE chunks run once in the forward, then once more
    # each in the backward (the remat recompute), which begins with the
    # first CE chunk's recompute: the forward is every kernel before it
    # (an outer span's GPU-side range is not reliable: one run read 684
    # ms for the forward, the next 35)
    dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = sorted((e.time_range.start, e.time_range.end) for e in dev_ev
                     if e.name not in labels)

    def ranges(label):
        return sorted((e.time_range.start, e.time_range.end) for e in dev_ev
                      if e.name == label)
    blocks, chunks = ranges("train: block"), ranges("train: ce chunk")
    n_chunks = args.seq // cfg.ce_chunk
    bwd_start = chunks[n_chunks][0]
    recompute = sum(t1 - t0 for r0, r1 in blocks[cfg.n_layers:]
                    for t0, t1 in kernels if t0 >= r0 and t1 <= r1) / 1e3
    forward = sum(t1 - t0 for t0, t1 in kernels if t0 < bwd_start) / 1e3
    backward = busy - forward - span_ms["train: optimizer"][0]
    log(f"train profile (phase 27): one step of {cfg.name} (batch "
        f"{TRAIN_B}, seq {args.seq}): wall {wall:.2f} ms under the "
        f"profiler, device busy {busy:.3f} ms (idle share "
        f"{1 - busy / wall:.4f}); matrix products {gemm:.3f} ms, "
        f"elementwise kernels {elem_ms:.3f} ms in "
        f"{sum(r.count for r in elem)} launches, the rest "
        f"{busy - gemm - elem_ms:.3f} ms")
    log("  device ms by span (all kernels / matrix products): "
        + ", ".join(f"{lab} {t[0]:.3f} / {t[1]:.3f}"
                    for lab, t in span_ms.items())
        + f"; the forward {forward:.3f}, the backward {backward:.3f}, of "
          f"it the remat recompute ({len(blocks) - cfg.n_layers} blocks "
          f"run again) {recompute:.3f}")
    for r in sorted(rows, key=lambda r: -r.self_device_time_total)[:12]:
        log(f"  {r.self_device_time_total / 1e3:9.3f} ms  x{r.count:<6d} "
            f"{r.key[:90]}")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "train_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=200))
    # the CE alone on the step's final hidden states: forward, the
    # chunks' recompute and backward
    model = state["model"]
    with torch.no_grad():
        x = lm_mod.final_hidden(cfg, model, lm_mod.trunk_train(
            cfg, model, lm_mod.embed_inputs(cfg, model, batch),
            torch.arange(args.seq, device=dev))[0])
    x.requires_grad_(True)
    table = model.embed.table

    def ce():
        loss = common.chunked_cross_entropy(x, table, None, batch["targets"],
                                            cfg.ce_chunk)
        torch.autograd.grad(loss, (x, table))
    ce_ms = device_ms(torch, "chunked CE", ce, 3)
    log(f"  chunked CE alone (forward, recompute, backward; "
        f"{args.seq // cfg.ce_chunk} chunks of ({TRAIN_B}, {cfg.ce_chunk}, "
        f"{cfg.vocab}) fp32 logits): {ce_ms:.3f} ms, {ce_ms / wall:.4f} "
        f"of the profiled step")
    del state, model, x, table


def reset_peaks(torch) -> None:
    for i in range(torch.cuda.device_count()):
        # a card's allocator starts with its first allocation, and its
        # statistics cannot be reset before
        torch.empty(1, device=torch.device("cuda", i))
        torch.cuda.reset_peak_memory_stats(i)


def peak_bytes(torch) -> int:
    """The largest peak allocated on any card (the pipeline's stages may
    sit on several)."""
    return max(torch.cuda.max_memory_allocated(i)
               for i in range(torch.cuda.device_count()))


def served(torch, ops, serve, argv) -> tuple[dict, dict[str, int], int]:
    """One serve through the launcher's ``main``, the counters reset just
    before → (its result, the launches, the peak allocated bytes)."""
    torch.cuda.empty_cache()
    reset_peaks(torch)
    ops.reset_launch_counts()
    res = serve.main(argv)
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    return res, ops.launch_counts(), peak_bytes(torch)


def greedy_logits(lm, pl, cfg, model, inputs, cache_len, n, pipe=None):
    """Every step's logits of a prefill and ``n - 1`` greedy decode steps,
    unpipelined or, with ``pipe`` = (PipelineConfig, mesh), through the
    stages (the comparison's launches are not counted)."""
    if pipe is None:
        logits, cache = lm.forward_prefill(cfg, model, inputs, cache_len)
    else:
        logits, cache = pl.forward_prefill(cfg, *pipe, model, inputs,
                                           cache_len)
    out = [logits]
    for _ in range(n - 1):
        tok = logits.argmax(-1)
        if pipe is None:
            logits, cache = lm.forward_decode(cfg, model, tok, cache)
        else:
            logits, cache = pl.forward_decode(cfg, *pipe, model, tok, cache)
        out.append(logits)
    return out


def pipeline_serve(torch, ops, serve, lm, dev, smi) -> dict[str, int]:
    """Phase 28: qwen3-1.7b (2 stages at the ParetoPipe cuts, 4 at even
    ones) and zamba2-7b (2 stages, the planner's cuts) served through
    ``launch.serve --pods``, each beside its unpipelined serve in this
    run: the kernels' launches equal, every token and every step's
    logits ``torch.equal`` → the pipelined runs' launches, summed."""
    from repro_torch.launch.mesh import plan_pipeline
    from repro_torch.runtime import pipeline as pl
    total: dict[str, int] = {}
    for name, argv, variants in PIPE_SERVE:
        plain, plain_n, plain_peak = served(torch, ops, serve, argv)
        log(f"pipeline serve (phase 28) {name}, unpipelined: prefill "
            f"{plain['prefill_ms']:.2f} ms, decode "
            f"{plain['decode_ms_per_token']:.3f} ms/token, peak "
            f"{plain_peak / 2**30:.3f} GiB, launches {json.dumps(plain_n)}; "
            f"on {smi}")
        runs = []
        for extra in variants:
            res, n, peak = served(torch, ops, serve, argv + extra)
            pods = int(extra[1])
            if res["cuts"] != PIPE_SERVE_CUTS[name, pods]:
                raise AssertionError(f"{name} at {pods} stages: cuts "
                                     f"{res['cuts']}")
            log(f"  {pods} stages at cuts {res['cuts']}: prefill "
                f"{res['prefill_ms']:.2f} ms, decode "
                f"{res['decode_ms_per_token']:.3f} ms/token, peak "
                f"{peak / 2**30:.3f} GiB ({peak} B), launches "
                f"{json.dumps(n)}")
            if n != plain_n:
                raise AssertionError(f"{name} at {pods} stages launched "
                                     f"{n}, unpipelined {plain_n}")
            if not torch.equal(res["tokens"].to(dev), plain["tokens"]):
                raise AssertionError(f"{name} at {pods} stages: tokens "
                                     "differ from the unpipelined serve")
            for k, v in n.items():
                total[k] = total.get(k, 0) + v
            runs.append(extra)
        # every step's logits, on one copy of the weights: unpipelined
        # first, then placed (on one card the placement moves nothing)
        args = serve.parse_args(argv)
        cfg, model, inputs, cache_len = serve.setup(args)
        want = greedy_logits(lm, pl, cfg, model, inputs, cache_len,
                             args.new_tokens)
        for extra in runs:
            pargs = serve.parse_args(argv + extra)
            pipe = plan_pipeline(cfg, model, pargs.pods, 1,
                                 seq=pargs.prompt_len, batch=pargs.batch,
                                 auto_partition=pargs.auto_partition,
                                 train=False)
            got = greedy_logits(lm, pl, cfg, model, inputs, cache_len,
                                args.new_tokens, pipe)
            same = [torch.equal(a.to(b.device), b) for a, b in zip(got, want)]
            log(f"  {pargs.pods} stages: logits of {sum(same)} of "
                f"{len(same)} steps torch.equal to the unpipelined serve's")
            if not all(same):
                raise AssertionError(f"{name} at {pargs.pods} stages: "
                                     "logits differ")
            del got
        del model, want, inputs
        gc.collect()
        torch.cuda.empty_cache()
    return total


def pipeline_train_parity(torch, dev) -> None:
    """Phase 29: the pipelined train loss and gradients on the card held
    to the card's plain ones over the same microbatches, averaged (the
    CE, without the moe aux term, as the pipelined step drops it; a moe
    routes each microbatch on its own in both): qwen3-1.7b at full width
    and 2 layers in fp32 cut after layer 1 with 4 microbatches, and
    every family's reduced config at 2 stages, 2 microbatches; then one
    pipelined train step of each; no kernel launched."""
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.optim import OptConfig, cosine_schedule
    from repro_torch.runtime import pipeline as pl
    from repro_torch.runtime import steps
    t0 = time.perf_counter()
    cases = [(configs.get(TRAIN_ARCH).replace(
        n_layers=TRAIN_PARITY_LAYERS, dtype="float32"), PIPE_PARITY_B,
        TRAIN_PARITY_S, pl.PipelineConfig(2, PIPE_PARITY_M, (1,)))]
    cases += [(c, 2, 32, pl.PipelineConfig.even(c.n_layers, 2, 2))
              for c in map(configs.reduced, TRAIN_FAMILIES.values())]
    mesh = make_host_mesh(2, device=dev)
    opt = OptConfig(lr=cosine_schedule(TRAIN_LR, 1, 10))
    for cfg, B, S, pcfg in cases:
        cfg = cfg.replace(attn_impl="xla")
        base = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
        batch = {k: v.to(dev) for k, v in SyntheticLM(
            cfg, DataConfig(B, S, 0), device="cpu").batch_at(0).items()}
        ops.reset_launch_counts()
        res = []
        for piped in (False, True):
            model = copy.deepcopy(base).to(dev).requires_grad_(True)
            names, params = zip(*model.named_parameters())
            if piped:
                pl.place_stages(cfg, model, pcfg, mesh)
                ce = pl.pipeline_loss(cfg, pcfg, mesh, model, batch)
                grads = torch.autograd.grad(ce, params)
            else:
                # the plain step over the same microbatches, one at a time
                # (a moe group never spans two), averaged
                M = pcfg.microbatches
                ce, grads = 0.0, [0.0] * len(params)
                for i in range(M):
                    mb = {k: v.chunk(M)[i] for k, v in batch.items()}
                    ce_i = steps.loss_fn(cfg, model, mb)[1]["ce"] / M
                    grads = [a + b for a, b in zip(
                        grads, torch.autograd.grad(ce_i, params))]
                    ce = ce + ce_i.detach()
            res.append((ce.item(), dict(zip(names, grads))))
            if piped:
                _, m = pl.make_pipeline_train_step(cfg, pcfg, opt, mesh)(
                    steps.train_state(model), batch)
                if not math.isclose(m["loss"].item(), ce.item(),
                                    rel_tol=1e-6):
                    raise AssertionError(f"{cfg.name}: the pipelined step's "
                                         f"loss {m['loss'].item()} is not "
                                         f"its CE {ce.item()}")
            del model, grads
        (plain_ce, plain_g), (ce, g) = res
        worst = max(float((g[n].to(dev) - plain_g[n]).abs().max())
                    / max(float(plain_g[n].abs().max()), 1e-30)
                    for n in plain_g)
        loss_err = abs(ce - plain_ce) / abs(plain_ce)
        log(f"  pipelined train (phase 29) {cfg.name} ({cfg.family}, "
            f"{cfg.n_layers} layers, fp32, batch {B}, seq {S}, cuts "
            f"{pcfg.cuts}, {pcfg.microbatches} microbatches): CE {ce:.7f} "
            f"against the plain {plain_ce:.7f} (rel {loss_err:.3e}); worst "
            f"gradient leaf {worst:.3e} of its largest")
        if loss_err > 1e-5 or worst > TRAIN_GRAD_FRAC:
            raise AssertionError(f"{cfg.name}: the pipelined step is not the "
                                 "plain one")
        if any(ops.launch_counts().values()):
            raise AssertionError(f"pipelined training launched kernels: "
                                 f"{ops.launch_counts()}")
        del res, plain_g, g, base
    log(f"pipelined train parity (phase 29) took "
        f"{time.perf_counter() - t0:.1f} s")


def pipeline_train(torch, dev, smi, plain: dict) -> dict[str, int]:
    """Phase 30: phase 25's run through ``launch.train --pods 2
    --microbatches 4 --auto-partition``: the ParetoPipe cuts (16,), the
    step ms, tokens/s and peak beside phase 25's, its warm-up loss
    within ``PIPE_TRAIN_LOSS_TOL`` of phase 25's on the same batch → its
    launches (all 0)."""
    launches, st = train_slice(torch, dev, smi, PIPE_TRAIN_FLAGS,
                               "pipelined train (phase 30)")
    if st["cuts"] != PIPE_TRAIN_CUTS:
        raise AssertionError(f"pipelined train: cuts {st['cuts']}, the "
                             f"planner's are {PIPE_TRAIN_CUTS}")
    PIPE30.update(st)
    diff = abs(st["losses"][0] - plain["losses"][0])
    log(f"  beside phase 25 (unpipelined, batch {plain['batch']}): step "
        f"{st['step_ms']:.2f} against {plain['step_ms']:.2f} ms "
        f"({st['step_ms'] / plain['step_ms']:.4f}x), {st['tokens_s']:.0f} "
        f"against {plain['tokens_s']:.0f} tokens/s, peak "
        f"{st['peak'] / 2**30:.3f} against {plain['peak'] / 2**30:.3f} GiB; "
        f"warm-up loss {st['losses'][0]:.6f} against "
        f"{plain['losses'][0]:.6f} (|diff| {diff:.3e}, within "
        f"{PIPE_TRAIN_LOSS_TOL})")
    log(f"  peak GiB a card {[round(p / 2**30, 3) for p in st['peaks']]}; "
        f"{plan_line(st['plan'], st['step_ms'])}")
    if st["batch"] != plain["batch"] or not diff <= PIPE_TRAIN_LOSS_TOL:
        raise AssertionError("pipelined train: the first loss is not the "
                             "unpipelined one")
    return launches


def shard_meshes(cards: int) -> tuple[tuple, tuple]:
    """The meshes (data, model) the cards allow → (phase 31's, phase
    32's)."""
    if cards >= 4:
        return (2, 2), ((2, 2), (4, 1))
    if cards >= 2:
        return (1, 2), ((1, 2), (2, 1))
    return (1, 1), ()


def spawn_phase(phase: str, spec: dict, world: int, timeout_s: float) -> dict:
    """This script as ``world`` ranks of one NCCL group (``python3
    chip_smoke.py --rank PHASE SPEC OUT``, one card a rank), each running
    ``rank_main`` on ``spec`` → what rank 0 wrote.  A rank's failure, or
    the ranks running past ``timeout_s``, fails ``phase``."""
    import tempfile
    from repro_torch.launch.mesh import spawn_ranks
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        spec_path = os.path.join(tmp, "spec.json")
        out_path = os.path.join(tmp, "out.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        code = spawn_ranks([sys.executable, os.path.abspath(__file__),
                            "--rank", phase, spec_path, out_path], world,
                           timeout_s=timeout_s)
        if code:
            raise AssertionError(f"phase {phase}: the ranks exited {code}")
        with open(out_path) as f:
            return json.load(f)


def sharded_parity_rank(spec: dict) -> dict | None:
    """Phase 31 in one rank: each case's sharded step on the spec's mesh,
    and in rank 0 the one-card plain step first; every rank gathers each
    moment, and rank 0 compares them on the card (in float64, by the
    reference's leaf: the worst |difference| over its blocks against its
    largest magnitude) → in rank 0 the comparisons, with the collectives
    (``launch.hlo_analysis.CollectiveRecorder``) that the full-width
    case's sharded step issued on rank 0."""
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.hlo_analysis import CollectiveRecorder
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import reference_leaf
    from repro_torch.runtime import steps
    from repro_torch.sharding.api import full, local, use_mesh_context
    train.set_numerics()
    mesh = make_host_mesh(1, *spec["mesh"], "cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    rank, world = dist.get_rank(), dist.get_world_size()
    opt = OptConfig(lr=TRAIN_LR)
    ops.reset_launch_counts()
    rows, collectives = [], None

    def grad_scale(gn):
        return min(1.0, opt.clip_norm / (gn + 1e-9)) * (1 - opt.b1)

    for label, arch, full_width, B, S in spec["cases"]:
        t0 = time.perf_counter()
        cfg = (configs.get(arch).replace(n_layers=TRAIN_PARITY_LAYERS,
                                         dtype="float32") if full_width
               else configs.reduced(arch)).replace(attn_impl="xla")
        model = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        batch = SyntheticLM(cfg, DataConfig(B, S, 0), device=dev).batch_at(0)
        if rank == 0:
            st, met = steps.make_train_step(cfg, opt)(
                steps.train_state(copy.deepcopy(model)), batch)
            plain_m = {k: v.item() for k, v in met.items()}
            plain = {k: dict(st["opt"][k]) for k in ("m", "v")}
            one_bytes = sum(t.numel() * 4 for t in st["opt"]["m"].values())
            del st, met
        with use_mesh_context(mesh):
            state = steps.train_state(model)
            step = steps.make_train_step(cfg, opt)
        rec = CollectiveRecorder()
        with rec if full_width else contextlib.nullcontext():
            state, met = step(state, batch)
        if full_width:
            collectives = rec.summary.by_kind()
        held = sum(local(t).numel() * 4 for t in state["opt"]["m"].values())
        every = [None] * world
        dist.all_gather_object(every, held)
        sharded_m = {k: v.item() for k, v in met.items()}
        # per reference leaf: [max |diff| of m, of v, of the gradient;
        # max |one-card m|, v, gradient]
        leaves: dict[str, list] = {}
        equal = sharded_m["loss"] == plain_m["loss"] if rank == 0 else False
        for k in ("m", "v"):
            for n, t in state["opt"][k].items():
                whole = full(t)                    # every rank gathers
                if rank != 0:
                    continue
                a, b = plain[k][n].double(), whole.double()
                acc = leaves.setdefault(reference_leaf(n)[0], [0.0] * 6)
                i = 0 if k == "m" else 1
                acc[i] = max(acc[i], float((b - a).abs().max()))
                acc[i + 3] = max(acc[i + 3], float(a.abs().max()))
                if k == "m":
                    g0 = a / grad_scale(plain_m["grad_norm"])
                    g1 = b / grad_scale(sharded_m["grad_norm"])
                    acc[2] = max(acc[2], float((g1 - g0).abs().max()))
                    acc[5] = max(acc[5], float(g0.abs().max()))
                equal = equal and bool(torch.equal(plain[k][n], whole))
                del whole, a, b
        del state, step, model, met
        if rank == 0:
            del plain
        gc.collect()
        torch.cuda.empty_cache()
        if rank != 0:
            continue

        def worst(i):
            return max(acc[i] / max(acc[i + 3], 1e-30)
                       for acc in leaves.values())
        rows.append({
            "label": label, "name": cfg.name, "family": cfg.family,
            "layers": cfg.n_layers, "batch": B, "seq": S,
            "loss": sharded_m["loss"], "plain_loss": plain_m["loss"],
            "loss_rel": abs(sharded_m["loss"] - plain_m["loss"])
            / abs(plain_m["loss"]),
            "grad": worst(2), "m": worst(0), "v": worst(1), "equal": equal,
            "bytes": every, "one_bytes": one_bytes,
            "s": time.perf_counter() - t0})
    launches = [None] * world
    dist.all_gather_object(launches, ops.launch_counts())
    if rank == 0:
        return {"cases": rows, "launches": launches,
                "collectives": collectives}
    return None


def rank_phases(torch, plain: dict) -> dict:
    """Phases 33, 35, 31 and 32 (every mesh of them: all have phase 31's
    number of ranks) in one spawn of ranks (``shard_meshes``,
    ``pod_meshes``), in that order: the serves before the training
    numerics → rank 0's results by phase."""
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    mesh, meshes32 = shard_meshes(cards)
    pods, timed = pod_meshes(cards)
    assert all(math.prod(m) == mesh[0] * mesh[1] for m in pods)
    spec = {"parts": ["33", "35", "31"], "33": {"mesh": list(mesh)},
            "35": {"meshes": [list(m) for m in pods],
                   "timed": timed and list(timed), "batch": plain["batch"]},
            "31": {"mesh": list(mesh), "cases": SHARD_PARITY_CASES}}
    if meshes32:
        assert all(a * b == mesh[0] * mesh[1] for a, b in meshes32)
        spec["parts"].append("32")
        spec["32"] = {"meshes": [list(m) for m in meshes32],
                      "batch": plain["batch"]}
    gc.collect()
    torch.cuda.empty_cache()
    res = spawn_phase("31-35", spec, mesh[0] * mesh[1], SHARD_TIMEOUT_S)
    log(f"rank phases {', '.join(spec['parts'])} on {mesh[0] * mesh[1]} "
        f"ranks: one spawn, {time.perf_counter() - t0:.1f} s")
    return res


def sharded_parity(torch, smi, res: dict) -> dict:
    """Phase 31: the sharded step held to the one-card step on the mesh
    the cards allow (``shard_meshes``), from rank 0's ``res`` → the
    collectives by kind that the full-width case's sharded step issued
    on rank 0."""
    mesh = shard_meshes(torch.cuda.device_count())[0]
    bad = []
    for r in res["cases"]:
        full = r["label"] == "full"
        m_frac = SHARD_MOMENT_FRAC if full else TRAIN_GRAD_FRAC
        v_frac = m_frac if full else 2 * m_frac
        log(f"  sharded parity (phase 31) {r['name']} ({r['family']}, "
            f"{r['layers']} layers, fp32, batch {r['batch']}, seq "
            f"{r['seq']}) at (data, model) {mesh}: loss {r['loss']:.7f} "
            f"against the one-card {r['plain_loss']:.7f} (rel "
            f"{r['loss_rel']:.3e}); worst gradient leaf {r['grad']:.3e}, m "
            f"{r['m']:.3e}, v {r['v']:.3e} of its largest; torch.equal "
            f"{r['equal']}; moment bytes a rank {r['bytes']} against "
            f"1/{mesh[0] * mesh[1]} of the one-card "
            f"{r['one_bytes'] / (mesh[0] * mesh[1]):.0f}; {r['s']:.1f} s")
        if r["loss_rel"] > 1e-5 or r["grad"] > TRAIN_GRAD_FRAC \
                or r["m"] > m_frac or r["v"] > v_frac:
            bad.append(r["name"])
    moved = [{k: n for k, n in c.items() if n} for c in res["launches"]]
    log(f"sharded parity (phase 31) on {smi}: {len(res['cases'])} cases at "
        f"{mesh}, launches a rank {moved}; took "
        f"{sum(r['s'] for r in res['cases']):.1f} s in the ranks")
    if bad:
        raise AssertionError(f"phase 31: the sharded step is not the "
                             f"one-card step for {bad}")
    if any(moved):
        raise AssertionError(f"phase 31: sharded training launched kernels "
                             f"{moved}")
    return res["collectives"]


def sharded_train_rank(spec: dict) -> dict | None:
    """Phase 32 in one rank: phase 25's run through ``launch.train``'s
    ``setup`` on each of the spec's meshes (all of the group's size) →
    in rank 0 {str(mesh): every rank's numbers}."""
    out = {str(tuple(mesh)): _train_on_mesh(
        ["--data-par", str(mesh[0]), "--model-par", str(mesh[1])],
        spec["batch"]) for mesh in spec["meshes"]}
    return out if out[str(tuple(spec["meshes"][0]))] is not None else None


def _train_on_mesh(flags: list[str], batch_size: int) -> list | None:
    """Phase 25's run through ``launch.train``'s ``setup`` in this rank
    with ``flags`` (the mesh's) → in rank 0 every rank's numbers."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    args = train.parse_args(TRAIN_ARGS + [
        "--batch", str(batch_size), "--steps", str(TRAIN_WARM
                                                   + TRAIN_STEPS), *flags])
    train.set_numerics()
    t0 = time.perf_counter()
    cfg, state, step_fn, data, pipe = train.setup(args)
    setup_s = time.perf_counter() - t0
    batch = data.batch_at(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(TRAIN_WARM + TRAIN_STEPS):
        t0 = time.perf_counter()
        state, met = step_fn(state, batch)
        losses.append(met["loss"].item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    mine = {"step_ms": step_ms, "losses": losses, "setup_s": setup_s,
            "peak": torch.cuda.max_memory_allocated(),
            "launches": ops.launch_counts(),
            "params": state["model"].param_count(),
            "cuts": None if pipe is None else list(pipe[0].cuts),
            "plan": None if pipe is None else planned_step(*pipe,
                                                           args.batch)}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    del state, step_fn, batch
    gc.collect()
    torch.cuda.empty_cache()
    return every if dist.get_rank() == 0 else None


def step_medians(ranks: list) -> tuple[float, float]:
    """Rank 0's median of its timed steps' ms, and the slowest rank's."""
    def median(r):
        t = sorted(r["step_ms"][TRAIN_WARM:])
        return t[len(t) // 2] if len(t) % 2 else \
            (t[len(t) // 2 - 1] + t[len(t) // 2]) / 2
    return median(ranks[0]), max(median(r) for r in ranks)


def sharded_train(torch, smi, plain: dict, ranked: dict | None
                  ) -> tuple[dict[str, int], dict]:
    """Phase 32: phase 25's run on each mesh the cards allow, beside
    phase 25, from the ranks' numbers ``rank_phases`` got ({str(mesh):
    [a rank's numbers]}) → the ranks' kernel launches (all 0) and each
    mesh's peaks a card ({str(mesh): [bytes a rank]})."""
    cards = torch.cuda.device_count()
    meshes = shard_meshes(cards)[1]
    launches: dict[str, int] = {}
    peaks: dict[str, list] = {}
    if not meshes:
        log(f"sharded train (phase 32): {cards} card, no mesh of ranks to "
            f"run ((2, 2) and (4, 1) need four, (1, 2) and (2, 1) two); "
            f"phase 25 ran the one-card step")
        return launches, peaks
    B, S = plain["batch"], TRAIN_S
    for mesh in meshes:
        ranks = ranked[str(mesh)]
        lead = ranks[0]
        med, worst = step_medians(ranks)
        losses = lead["losses"]
        diff = abs(losses[0] - plain["losses"][0])
        log(f"sharded train (phase 32) {TRAIN_ARCH} full width and depth "
            f"({lead['params']} parameters), bf16, remat, batch {B}, seq "
            f"{S} at (data, model) {mesh} on {mesh[0] * mesh[1]} of {cards} "
            f"cards, {smi}: setup {lead['setup_s']:.1f} s")
        log(f"  losses {json.dumps([float(f'{x:.6f}') for x in losses])}")
        log(f"  step ms (rank 0, each) "
            f"{json.dumps([round(t, 2) for t in lead['step_ms']])}; median "
            f"of the {TRAIN_STEPS} timed {med:.2f} ms (slowest "
            f"rank's median {worst:.2f}), {B * S / med * 1e3:.0f} "
            f"tokens/s; peak GiB a card "
            f"{[round(r['peak'] / 2**30, 3) for r in ranks]}")
        log(f"  beside phase 25 (one card, batch {B}): step "
            f"{med:.2f} against {plain['step_ms']:.2f} ms "
            f"({plain['step_ms'] / med:.4f}x), {B * S / med * 1e3:.0f} "
            f"against {plain['tokens_s']:.0f} tokens/s, peak "
            f"{max(r['peak'] for r in ranks) / 2**30:.3f} against "
            f"{plain['peak'] / 2**30:.3f} GiB; warm-up loss {losses[0]:.6f} "
            f"against {plain['losses'][0]:.6f} (|diff| {diff:.3e}, within "
            f"{SHARD_TRAIN_LOSS_TOL})")
        SHARD32[str(mesh)] = med
        peaks[str(mesh)] = [r["peak"] for r in ranks]
        for r in ranks:
            for k, n in r["launches"].items():
                launches[k] = launches.get(k, 0) + n
        if not all(math.isfinite(x) for x in losses) \
                or not losses[-1] < losses[0]:
            raise AssertionError(f"phase 32 at {mesh}: losses {losses}")
        if not diff <= SHARD_TRAIN_LOSS_TOL:
            raise AssertionError(f"phase 32 at {mesh}: the warm-up loss is "
                                 "not the one-card one")
    if any(launches.values()):
        raise AssertionError(f"phase 32 launched kernels: {launches}")
    return launches, peaks


def serve_greedy(steps, cfg, model, inputs, cache_len: int, n: int, mesh):
    """A prefill and ``n`` greedy decode steps through the serving steps
    made under ``mesh`` (None: one card) → (tokens, each step's logits,
    the final cache)."""
    from repro_torch.sharding.api import use_mesh_context
    with use_mesh_context(mesh):
        prefill = steps.make_prefill_step(cfg, cache_len, with_logits=True)
        decode = steps.make_decode_step(cfg, with_logits=True)
    tok, cache, lg = prefill(model, inputs)
    toks, logits = [tok], [lg]
    for _ in range(n):
        tok, cache, lg = decode(model, tok, cache)
        toks.append(tok)
        logits.append(lg)
    return toks, logits, cache


def sharded_serve_rank(spec: dict) -> dict | None:
    """Phase 33 in one rank: the parity case (rank 0's one-card serve
    first, then every rank's sharded serve of the same weights and
    prompt, the final k/v caches gathered), then ``launch.serve``'s
    ``main`` on the ranks with phase 7's flags, the kernels' launches
    counted from just before it → in rank 0 every rank's numbers."""
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.runtime import steps
    from repro_torch.sharding.api import full, use_mesh_context
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    d, m = spec["mesh"]
    mesh = make_host_mesh(1, d, m, "cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    rank, world = dist.get_rank(), dist.get_world_size()
    L, B, S, n = SHARD_SERVE_PARITY
    t0 = time.perf_counter()
    cfg = configs.get(TRAIN_ARCH).replace(n_layers=L, dtype="float32",
                                          attn_impl="pallas")
    model = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    inputs = {k: v for k, v in SyntheticLM(cfg, DataConfig(B, S, 0),
                                           device=dev).batch_at(0).items()
              if k != "targets"}
    cache_len = S + n
    if rank == 0:
        one = serve_greedy(steps, cfg, copy.deepcopy(model), inputs,
                           cache_len, n, None)
    with use_mesh_context(mesh) as ctx:
        lm.shard_params(cfg, model, ctx)
    toks, logits, cache = serve_greedy(steps, cfg, model, inputs, cache_len,
                                       n, mesh)
    laid = {k: str(tuple(cache[k].placements)) for k in ("k", "v")}
    with use_mesh_context(mesh) as ctx:
        placements = {k: str(ctx.placements(lm.cache_names(cfg, k),
                                            tuple(cache[k].shape)))
                      for k in ("k", "v")}
    whole = {k: full(cache[k]) for k in ("k", "v")}    # every rank gathers
    parity = None
    if rank == 0:
        tol = 2e-4                                     # phase 8's
        o_toks, o_logits, o_cache = one
        parity = {
            "logits": [float((a - b).abs().max())
                       for a, b in zip(logits, o_logits)],
            "logits_ok": all(torch.allclose(a, b, rtol=tol, atol=tol)
                             for a, b in zip(logits, o_logits)),
            "tokens_equal": all(torch.equal(a, b)
                                for a, b in zip(toks, o_toks)),
            "cache": {k: float((whole[k] - o_cache[k]).abs().max())
                      for k in ("k", "v")},
            "cache_ok": all(torch.allclose(whole[k], o_cache[k], rtol=tol,
                                           atol=tol) for k in ("k", "v")),
            "placements": laid, "names": placements,
            "s": time.perf_counter() - t0}
        del one, o_toks, o_logits, o_cache
    del model, toks, logits, cache, whole
    gc.collect()
    torch.cuda.empty_cache()
    argv = SHARD_SERVE_ARGS + ["--device", "cuda", "--data-par", str(d),
                               "--model-par", str(m)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serve.main(argv)
    torch.cuda.synchronize()
    fcfg = configs.get(TRAIN_ARCH)
    mine = {"prefill_ms": res["prefill_ms"],
            "decode_ms": res["decode_ms_per_token"],
            "peak": torch.cuda.max_memory_allocated(),
            "launches": ops.launch_counts(),
            "valid": res["valid"],
            "local": {"batch": LM_B // d, "heads": fcfg.n_heads // m,
                      "kv_heads": fcfg.n_kv_heads // m}}
    every = [None] * world
    dist.all_gather_object(every, mine)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return {"parity": parity, "ranks": every} if rank == 0 else None


def pod_meshes(cards: int) -> tuple[list, tuple | None]:
    """Phase 35's ``(pod, data, model)`` meshes the cards allow (all of
    phase 31's number of ranks) → ((a) and (b)'s, (c)'s or None)."""
    if cards >= 4:
        return [(2, 1, 2), (2, 2, 1)], (2, 1, 2)
    if cards >= 2:
        return [(2, 1, 1)], (2, 1, 1)
    return [(1, 1, 1)], None


def pod_pcfg(mesh, microbatches: int):
    """The pipeline of a phase 35 mesh: cut after layer 1 over its two
    pods; the world-1 mesh's one stage (one microbatch, so that its step
    is the ``(1, 1)`` step's)."""
    from repro_torch.runtime.pipeline import PipelineConfig
    if mesh[0] == 1:
        return PipelineConfig(1, 1, ())
    return PipelineConfig(mesh[0], microbatches, POD_PARITY[4])


def pod_train_cfg():
    """(a)'s config: phase 31's full-width case, fp32, the plain route."""
    from repro_torch import configs
    return configs.get(TRAIN_ARCH).replace(
        n_layers=POD_PARITY[0], dtype="float32", attn_impl="xla")


def _moments_held(torch, got: dict, want: dict, gn: float, want_gn: float,
                  opt, dev) -> dict:
    """Two states' moments in the reference's pipelined layout, leaf by
    leaf on the card in float64 → the worst |difference| over each
    leaf's largest magnitude, of m, v and the gradient behind m, and
    whether every leaf is equal."""
    import numpy as np
    from repro_torch.models.common import named_leaves

    def scale(g):
        return min(1.0, opt.clip_norm / (g + 1e-9)) * (1 - opt.b1)
    worst = {"m": 0.0, "v": 0.0, "grad": 0.0}
    equal = True
    for k in ("m", "v"):
        theirs = dict(named_leaves(want["opt"][k]))
        for path, leaf in named_leaves(got["opt"][k]):
            a = torch.as_tensor(np.asarray(theirs[path])).to(dev).double()
            b = torch.as_tensor(np.asarray(leaf)).to(dev).double()
            equal = equal and bool(torch.equal(a, b))
            big = float(a.abs().max())
            if big:
                worst[k] = max(worst[k], float((b - a).abs().max()) / big)
                if k == "m":
                    worst["grad"] = max(worst["grad"], float(
                        (b / scale(gn) - a / scale(want_gn)).abs().max())
                        / (big / scale(want_gn)))
            del a, b
    return {**worst, "equal": equal}


def pod_mesh_rank(spec: dict) -> dict | None:
    """Phase 35 in one rank, on each of the spec's meshes (made once):
    (b) the pipelined serve held to rank 0's one-card serve of the same
    weights and prompt (every rank's launches counted from just before
    it), then, with the training numerics on, (a) the pipelined train
    step held to rank 0's one-card step (the world-1 mesh: to the ``(1,
    1)`` mesh's sharded step, ``torch.equal``), its collectives recorded
    on rank 0; then (c) phase 30's run through ``launch.train``'s
    ``setup`` on the ranks → in rank 0 the comparisons and every rank's
    numbers."""
    import torch
    import torch.distributed as dist
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.hlo_analysis import CollectiveRecorder
    from repro_torch.launch.mesh import make_host_mesh, pod_mesh
    from repro_torch.models import lm
    from repro_torch.optim import OptConfig
    from repro_torch.runtime import pipeline as pl
    from repro_torch.runtime import steps
    from repro_torch.sharding.api import use_mesh_context
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    meshes = {tuple(m): pod_mesh(*m, "cuda") for m in spec["meshes"]}
    dev = torch.device("cuda", torch.cuda.current_device())
    rank, world = dist.get_rank(), dist.get_world_size()
    lead = rank == 0
    out: dict = {"serve": {}, "train": {}}

    # (b) the serve, on the kernel route
    L, B, S, n = POD_SERVE_PARITY
    t0 = time.perf_counter()
    from repro_torch import configs
    scfg = configs.get(TRAIN_ARCH).replace(n_layers=L, dtype="float32",
                                           attn_impl="pallas")
    base = lm.init(scfg, torch.Generator(device=dev).manual_seed(0), dev)
    inputs = {k: v for k, v in SyntheticLM(scfg, DataConfig(B, S, 0),
                                           device=dev).batch_at(0).items()
              if k != "targets"}
    cache_len = S + n
    one = serve_greedy(steps, scfg, copy.deepcopy(base), inputs, cache_len,
                       n, None) if lead else None
    for shape, mesh in meshes.items():
        t1 = time.perf_counter()
        pcfg = pod_pcfg(shape, 1)
        model = pl.place_stages(scfg, copy.deepcopy(base), pcfg, mesh)
        prefill = pl.make_pipeline_prefill_step(scfg, pcfg, mesh, cache_len,
                                                with_logits=True)
        decode = pl.make_pipeline_decode_step(scfg, pcfg, mesh,
                                              with_logits=True)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        tok, cache, lg = prefill(model, inputs)
        toks, logits = [tok], [lg]
        for _ in range(n):
            tok, cache, lg = decode(model, tok, cache)
            toks.append(tok)
            logits.append(lg)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        laid = {k: str(tuple(t.placements)) for k, t in cache["stage"].items()}
        got = pl.reference_cache(scfg, pcfg, cache, mesh, keep=lead)
        every = [None] * world
        dist.all_gather_object(every, {
            "launches": launches, "layers": len(pcfg.ranges(L)[
                mesh.get_local_rank("pod")]),
            "last": mesh.get_local_rank("pod") == shape[0] - 1,
            "placements": laid})
        if lead:
            o_toks, o_logits, o_cache = one
            want = pl.repack_params({k: o_cache[k] for k in ("k", "v")},
                                    pcfg, L)
            tol = 2e-4                                 # phase 8's
            out["serve"][str(shape)] = {
                "logits": [float((a - b).abs().max())
                           for a, b in zip(logits, o_logits)],
                "logits_ok": all(torch.allclose(a, b, rtol=tol, atol=tol)
                                 for a, b in zip(logits, o_logits)),
                "tokens_equal": all(torch.equal(a, b)
                                    for a, b in zip(toks, o_toks)),
                "cache": {k: float((got[k].to(dev) - want[k]).abs().max())
                          for k in ("k", "v")},
                "cache_ok": all(torch.allclose(got[k].to(dev), want[k],
                                               rtol=tol, atol=tol)
                                for k in ("k", "v")),
                "ranks": every, "s": time.perf_counter() - t1}
        del model, cache, toks, logits, got
        gc.collect()
        torch.cuda.empty_cache()
    out["serve_setup_s"] = time.perf_counter() - t0
    del base, one
    gc.collect()
    torch.cuda.empty_cache()

    # (a) the train step
    train.set_numerics()
    ops.reset_launch_counts()
    cfg = pod_train_cfg()
    _, B, S, M, _ = POD_PARITY
    opt = OptConfig(lr=TRAIN_LR)
    base = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batch = SyntheticLM(cfg, DataConfig(B, S, 0), device=dev).batch_at(0)
    wanted: dict = {}             # rank 0's reference state, by pipeline
    for shape, mesh in meshes.items():
        t1 = time.perf_counter()
        pcfg = pod_pcfg(shape, M)
        if lead and pcfg not in wanted:
            if shape[0] == 1:
                # the (1, 1) mesh's sharded step: phase 31's at world 1
                with use_mesh_context(make_host_mesh(1, 1, 1, "cuda")):
                    st = steps.train_state(copy.deepcopy(base))
                    st, met = steps.make_train_step(cfg, opt)(st, batch)
            else:
                st, met = steps.make_train_step(cfg, opt)(
                    steps.train_state(copy.deepcopy(base)), batch)
            wanted[pcfg] = (steps.reference_state(st, pcfg),
                            {k: v.item() for k, v in met.items()})
            del st, met
        model = pl.place_stages(cfg, copy.deepcopy(base), pcfg, mesh)
        with use_mesh_context(pl.stage_context(mesh)):
            state = steps.train_state(model)
        step = pl.make_pipeline_train_step(cfg, pcfg, opt, mesh)
        rec = CollectiveRecorder(world // shape[0])
        with rec:
            state, m = step(state, batch)
        got_m = {k: v.item() for k, v in m.items()}
        got = steps.reference_state(state, pcfg, keep=lead)
        if lead:
            want, want_m = wanted[pcfg]
            held = _moments_held(torch, got, want, got_m["grad_norm"],
                                 want_m["grad_norm"], opt, dev)
            out["train"][str(shape)] = {
                "loss": got_m["loss"], "plain_loss": want_m["loss"],
                "loss_rel": abs(got_m["loss"] - want_m["loss"])
                / abs(want_m["loss"]),
                "loss_equal": got_m["loss"] == want_m["loss"], **held,
                "collectives": rec.summary.by_kind_and_pod(),
                "s": time.perf_counter() - t1}
        del model, state, step, got
        gc.collect()
        torch.cuda.empty_cache()
    launches = [None] * world
    dist.all_gather_object(launches, ops.launch_counts())
    out["train_launches"] = launches
    del base, batch, wanted
    gc.collect()
    torch.cuda.empty_cache()

    # (c) phase 30's run on the ranks
    if spec.get("timed"):
        p, d, m = spec["timed"]
        out["timed"] = _train_on_mesh(
            PIPE_TRAIN_FLAGS + ["--pods", str(p), "--data-par", str(d),
                                "--model-par", str(m)],
            spec["batch"])
    return out if lead else None


def expect_stage(layers: int, last: bool, n: int) -> dict[str, int]:
    """The LM kernels' launches of one stage of (b)'s serve: a prefill
    and ``n`` decode steps over ``layers`` layers (per layer a flash
    launch in the prefill, a decode-attention launch a step, four norms
    each), and the final norm on the last stage."""
    return {"flash_attention": layers, "decode_attention": layers * n,
            "fused_rmsnorm": (4 * layers + int(last)) * (1 + n)}


def pod_mesh_phase(torch, smi, plain: dict, res: dict
                   ) -> tuple[dict[str, int], dict]:
    """Phase 35 from rank 0's ``res`` (``pod_mesh_rank``): (a) and (b) on
    each mesh, (c) beside phases 25, 30 and 32 → (rank 0's kernel
    launches in (b)'s serves, {mesh: (a)'s collectives on rank 0 by kind
    and by crossing a pod})."""
    cards = torch.cuda.device_count()
    meshes, timed = pod_meshes(cards)
    bad = []
    launches: dict[str, int] = {}
    L, B, S, n = POD_SERVE_PARITY
    for mesh in meshes:
        p = res["serve"][str(mesh)]
        log(f"pod mesh (phase 35b) {TRAIN_ARCH} full width, {L} layers, "
            f"fp32, TF32 off, batch {B}, prompt {S}, a prefill and {n} "
            f"greedy decode steps on the kernel route at (pod, data, model) "
            f"{mesh} against the one-card serve: max |diff| of logits "
            f"{[f'{x:.3g}' for x in p['logits']]} (rtol = atol = 2e-4: "
            f"{p['logits_ok']}); tokens torch.equal {p['tokens_equal']}; the "
            f"gathered cache, reference layout, k {p['cache']['k']:.3g}, v "
            f"{p['cache']['v']:.3g} (2e-4: {p['cache_ok']}); {p['s']:.1f} s")
        for r, x in enumerate(p["ranks"]):
            want = expect_stage(x["layers"], x["last"], n)
            got = {k: x["launches"].get(k, 0) for k in want}
            log(f"  rank {r}: stage of {x['layers']} layers"
                f"{' (the last)' if x['last'] else ''}, cache "
                f"{x['placements']}, launches {json.dumps(x['launches'])}; "
                f"the stage implies {json.dumps(want)}")
            if got != want or any(v for k, v in x["launches"].items()
                                  if k not in want):
                bad.append(f"(b) {mesh} rank {r} launches")
        if not (p["logits_ok"] and p["tokens_equal"] and p["cache_ok"]):
            bad.append(f"(b) {mesh}")
        for k, v in p["ranks"][0]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    _, B, S, M, cut = POD_PARITY
    for mesh in meshes:
        a = res["train"][str(mesh)]
        world1 = mesh[0] == 1
        what = ("the (1, 1) mesh's sharded step (phase 31's), torch.equal "
                if world1 else "the one-card step")
        log(f"pod mesh (phase 35a) {TRAIN_ARCH} full width, {POD_PARITY[0]} "
            f"layers, fp32, batch {B}, seq {S}, "
            f"{pod_pcfg(mesh, M).microbatches} microbatches, cuts "
            f"{pod_pcfg(mesh, M).cuts} at (pod, data, model) {mesh} against "
            f"{what}: loss {a['loss']:.7f} against {a['plain_loss']:.7f} (rel "
            f"{a['loss_rel']:.3e}); worst gradient leaf {a['grad']:.3e}, m "
            f"{a['m']:.3e}, v {a['v']:.3e} of its largest; every moment "
            f"torch.equal {a['equal']}; {a['s']:.1f} s")
        counted = {k: (d["count"], d["bytes"])
                   for k, d in a["collectives"].items()}
        log(f"  collectives of rank 0's step, (count, bytes) by kind and "
            f"pod: {json.dumps(counted)}")
        if world1:
            if not (a["loss_equal"] and a["equal"]):
                bad.append(f"(a) {mesh} not torch.equal")
        elif a["loss_rel"] > 1e-5 or a["grad"] > TRAIN_GRAD_FRAC \
                or a["m"] > SHARD_MOMENT_FRAC or a["v"] > SHARD_MOMENT_FRAC:
            bad.append(f"(a) {mesh}")
    moved = [{k: v for k, v in c.items() if v} for c in res["train_launches"]]
    if any(moved):
        bad.append(f"(a) launched kernels {moved}")
    if timed is None:
        log(f"pod mesh (phase 35c): {cards} card, no mesh of two pods to "
            f"run ((2, 1, 2) and (2, 2, 1) need four cards, (2, 1, 1) two); "
            f"phase 30 ran the one-process pipeline")
    else:
        ranks = res["timed"]
        lead = ranks[0]
        med, worst = step_medians(ranks)
        diff = abs(lead["losses"][0] - plain["losses"][0])
        Bt = plain["batch"]
        log(f"pod mesh (phase 35c) {TRAIN_ARCH} full width and depth "
            f"({lead['params']} parameters on rank 0), bf16, remat, batch "
            f"{Bt}, seq {TRAIN_S}, --pods 2 --microbatches 4 "
            f"--auto-partition at (pod, data, model) {timed} on "
            f"{math.prod(timed)} of {cards} cards, {smi}: cuts "
            f"{tuple(lead['cuts'])}, setup {lead['setup_s']:.1f} s")
        losses = [float(f"{x:.6f}") for x in lead["losses"]]
        log(f"  losses {json.dumps(losses)}")
        log(f"  step ms (rank 0, each) "
            f"{json.dumps([round(t, 2) for t in lead['step_ms']])}; median "
            f"of the {TRAIN_STEPS} timed {med:.2f} ms (slowest rank's "
            f"median {worst:.2f}), {Bt * TRAIN_S / med * 1e3:.0f} tokens/s; "
            f"peak GiB a card {[round(r['peak'] / 2**30, 3) for r in ranks]}")
        beside = [f"phase 25 (one card) {plain['step_ms']:.2f} ms, "
                  f"{plain['tokens_s']:.0f} tokens/s, peak "
                  f"{plain['peak'] / 2**30:.3f} GiB"]
        if PIPE30:
            beside.append(f"phase 30 (one process, 2 stages) "
                          f"{PIPE30['step_ms']:.2f} ms, "
                          f"{PIPE30['tokens_s']:.0f} tokens/s, peak "
                          f"{PIPE30['peak'] / 2**30:.3f} GiB")
        beside += [f"phase 32 at {k} {v:.2f} ms" for k, v in SHARD32.items()]
        log(f"  {plan_line(lead['plan'], med)}")
        log(f"  beside {'; '.join(beside)}; warm-up loss "
            f"{lead['losses'][0]:.6f} against phase 25's "
            f"{plain['losses'][0]:.6f} (|diff| {diff:.3e}, within "
            f"{PIPE_TRAIN_LOSS_TOL})")
        if tuple(lead["cuts"]) != PIPE_TRAIN_CUTS:
            bad.append(f"(c) cuts {lead['cuts']}")
        if not diff <= PIPE_TRAIN_LOSS_TOL or \
                not all(math.isfinite(x) for x in lead["losses"]):
            bad.append("(c) the warm-up loss")
        if any(v for r in ranks for v in r["launches"].values()):
            bad.append("(c) launched kernels")
    log(f"pod mesh (phase 35) on {smi}: meshes {meshes}; the serve's "
        f"setup {res['serve_setup_s']:.1f} s in the ranks")
    if bad:
        raise AssertionError(f"phase 35: {bad}")
    return launches, {str(m): res["train"][str(m)]["collectives"]
                      for m in meshes}


RANK_PARTS = {"33": sharded_serve_rank, "31": sharded_parity_rank,
              "32": sharded_train_rank, "35": pod_mesh_rank}


def rank_main(spec: dict, out_path: str) -> None:
    """One rank of ``spawn_phase``: the phases ``spec["parts"]`` names,
    in that order, on one group (one standup for all); rank 0 writes
    {part: its result}."""
    import torch.distributed as dist
    out = {part: RANK_PARTS[part](spec[part]) for part in spec["parts"]}
    if dist.get_rank() == 0:
        with open(out_path, "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def sharded_serve(torch, smi, plain: dict, res: dict) -> dict[str, int]:
    """Phase 33: sharded prefill and decode on the mesh the cards allow
    (``shard_meshes``, phase 31's), from rank 0's ``res``: the parity
    case held to the one-card serve, then phase 7's serve on the ranks
    beside phase 7 (``plain``, its numbers) → rank 0's kernel launches in
    that serve."""
    from repro_torch import configs
    from repro_torch.launch import serve
    mesh = shard_meshes(torch.cuda.device_count())[0]
    world = mesh[0] * mesh[1]
    p = res["parity"]
    L, B, S, n = SHARD_SERVE_PARITY
    log(f"sharded serve (phase 33) parity: {TRAIN_ARCH} full width, {L} "
        f"layers, fp32, TF32 off, batch {B}, prompt {S}, a prefill and {n} "
        f"greedy decode steps on the kernel route at (data, model) {mesh} "
        f"against the one-card serve: max |diff| of logits "
        f"{[f'{x:.3g}' for x in p['logits']]} (rtol = atol = 2e-4: "
        f"{p['logits_ok']}); tokens torch.equal {p['tokens_equal']}; the "
        f"gathered cache k {p['cache']['k']:.3g}, v {p['cache']['v']:.3g} "
        f"(2e-4: {p['cache_ok']}); cache placements {p['placements']} "
        f"(kv_cache_names: {p['names']}); {p['s']:.1f} s")
    lead = res["ranks"][0]
    args = serve.parse_args(SHARD_SERVE_ARGS)
    cfg = configs.get(TRAIN_ARCH)
    expect = {k: 0 for k in lead["launches"]}
    expect.update(lm_expect(cfg, args))
    log(f"sharded serve (phase 33) {TRAIN_ARCH} full width and depth, bf16, "
        f"batch {LM_B}, prompt {LM_S}, {args.new_tokens} new tokens at "
        f"(data, model) {mesh} on {world} of {torch.cuda.device_count()} "
        f"cards, {smi}: prefill {lead['prefill_ms']:.2f} ms, decode "
        f"{lead['decode_ms']:.3f} ms/token (rank 0; slowest rank "
        f"{max(r['decode_ms'] for r in res['ranks']):.3f}); peak GiB a "
        f"card {[round(r['peak'] / 2**30, 3) for r in res['ranks']]}")
    log(f"  beside phase 7 (one card): prefill {plain['prefill_ms']:.2f} ms,"
        f" decode {plain['decode_ms']:.3f} ms/token, peak "
        f"{plain['peak'] / 2**30:.3f} GiB")
    log(f"  rank 0's launches {json.dumps(lead['launches'])} at its local "
        f"shapes (batch {lead['local']['batch']}, heads "
        f"{lead['local']['heads']}, kv heads {lead['local']['kv_heads']}); "
        f"the path implies {json.dumps(lm_expect(cfg, args))}")
    if not (p["logits_ok"] and p["tokens_equal"] and p["cache_ok"]
            and p["placements"] == p["names"]):
        raise AssertionError("phase 33: the sharded serve is not the "
                             "one-card serve")
    wrong = {r: {k: (got[k], v) for k, v in expect.items() if got[k] != v}
             for r, got in enumerate(x["launches"] for x in res["ranks"])}
    if any(wrong.values()) or not all(r["valid"] for r in res["ranks"]):
        raise AssertionError(f"phase 33 launches (got, expected) a rank: "
                             f"{wrong}")
    return lead["launches"]


def predict(out_path: str, cards: int) -> None:
    """Phase 34's predictions, made beside the other phases in a process
    of their own (``python3 chip_smoke.py --predict OUT CARDS``): each
    step run once by ``launch.dryrun.measure`` inside ``FakeTensorMode``
    on fake CUDA tensors, as rank 0 of a fake group for a mesh — phase
    25's one-card step (with the analytic roofline bound of its cell),
    phase 31's full-width step on phase 31's mesh (its collectives) and
    phase 32's step on each of its meshes (rank 0's peak)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.analytic import cell_cost
    from repro_torch.launch.roofline import model_flops as rl_model_flops
    from repro_torch.launch.roofline import roofline_from
    from repro_torch.launch.specs import ShapeSpec
    out: dict = {}

    def on_mesh(shape, cfg, mesh_shape):
        with dryrun.fake_group(mesh_shape[0] * mesh_shape[1]):
            mesh = init_device_mesh("cuda", tuple(mesh_shape),
                                    mesh_dim_names=("data", "model"))
            return dryrun.measure(cfg, shape, mesh, device="cuda",
                                  grad_accum=1)

    def item(key, fn):
        t0 = time.perf_counter()
        try:
            out[key] = fn()
        except Exception as e:              # reported by phase 34
            out[key] = {"error": f"{type(e).__name__}: {e}"}
        out[key]["s"] = time.perf_counter() - t0
        with open(out_path, "w") as f:
            json.dump(out, f)

    cfg25 = configs.get(TRAIN_ARCH).replace(attn_impl="xla")
    shape25 = ShapeSpec("phase 25", TRAIN_S, TRAIN_B, "train")

    def one_card():
        got = dryrun.measure(cfg25, shape25, None, device="cuda",
                             grad_accum=1)
        cost = cell_cost(cfg25, shape25, n_chips=1, dp=1, tp=1,
                         multi_pod=False)
        rl = roofline_from(cost.flops_total, cost.hbm_bytes_per_dev,
                           cost.wire_ici_per_dev, cost.wire_dcn_per_dev,
                           rl_model_flops(cfg25, shape25), 1)
        return {"peak": got["memory"]["peak"], "flops": got["flops"],
                "bound_s": rl.step_time_s, "dominant": rl.dominant,
                "compute_s": rl.compute_s, "memory_s": rl.memory_s}
    item("one_card", one_card)

    _, arch, _, B, S = SHARD_PARITY_CASES[0]
    cfg31 = configs.get(arch).replace(n_layers=TRAIN_PARITY_LAYERS,
                                      dtype="float32", attn_impl="xla")
    mesh31, meshes32 = shard_meshes(cards)

    def p31():
        got = on_mesh(ShapeSpec("phase 31", S, B, "train"), cfg31, mesh31)
        return {"collectives": got["collectives"].by_kind(),
                "peak": got["memory"]["peak"]}
    item("p31", p31)
    for mesh in meshes32:
        item(f"p32 {mesh}", lambda: {"peak": on_mesh(
            shape25, cfg25, mesh)["memory"]["peak"]})
    _, B35, S35, M35, _ = POD_PARITY
    cfg35 = pod_train_cfg()

    def p35(mesh):
        with dryrun.fake_group(math.prod(mesh)):
            dm = init_device_mesh("cuda", tuple(mesh),
                                  mesh_dim_names=("pod", "data", "model"))
            got = dryrun.measure(cfg35, ShapeSpec("phase 35", S35, B35,
                                                  "train"),
                                 dm, device="cuda", grad_accum=1,
                                 pcfg=pod_pcfg(mesh, M35))
        return {"collectives": got["collectives"].by_kind_and_pod(),
                "peak": got["memory"]["peak"]}
    for mesh in pod_meshes(cards)[0]:
        item(f"p35 {mesh}", lambda: p35(mesh))


def dryrun_phase(torch, smi, predictor, plain: dict, p31: dict,
                 p32: dict, p35: dict) -> None:
    """Phase 34: the dry run's predictions (``predict``, run beside the
    earlier phases) against the card: (a) phase 25's peak, FLOPs and
    step beside the one-card prediction, (b) the collectives of phase
    31's full-width step in fake mode held equal, count and bytes by
    kind, to those its rank 0 issued (``p31``), and phase 32's peaks a
    card (``p32``: {mesh: [bytes a rank]}) beside rank 0's prediction at
    each mesh, (c) phase 35a's pipelined step at each of its meshes in
    fake mode, its collectives by kind and by crossing a pod held equal
    to rank 0's (``p35``: {mesh: those})."""
    t0 = time.perf_counter()
    proc, path = predictor
    try:
        proc.wait(timeout=PREDICT_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"phase 34: the predictions ran past "
                             f"{PREDICT_TIMEOUT_S} s")
    with open(path) as f:
        pred = json.load(f)
    errors = {k: v["error"] for k, v in pred.items() if "error" in v}
    if proc.returncode or errors:
        raise AssertionError(f"phase 34: the predictions failed (exit "
                             f"{proc.returncode}): {errors}")
    a = pred["one_card"]
    log(f"dry run (phase 34a) against phase 25 ({TRAIN_ARCH}, full depth, "
        f"bf16, remat, batch {plain['batch']}, seq {TRAIN_S}, one card, "
        f"{smi}; predicted for batch {TRAIN_B} in {a['s']:.1f} s): peak "
        f"{a['peak'] / 2**30:.3f} GiB predicted against "
        f"{plain['peak'] / 2**30:.3f} measured ({a['peak'] / plain['peak']:.4f}"
        f"x); FLOPs counted {a['flops']:.4e} against the model FLOPs "
        f"{plain['flops']:.4e} ({a['flops'] / plain['flops']:.4f}x); roofline "
        f"bound {a['bound_s'] * 1e3:.2f} ms ({a['dominant']}; compute "
        f"{a['compute_s'] * 1e3:.2f}, memory {a['memory_s'] * 1e3:.2f}) "
        f"against the median step {plain['step_ms']:.2f} ms "
        f"({plain['step_ms'] / (a['bound_s'] * 1e3):.2f}x the bound)")
    fake = {k: (d["count"], d["bytes"])
            for k, d in pred["p31"]["collectives"].items()}
    real = {k: (d["count"], d["bytes"]) for k, d in p31.items()}
    log(f"dry run (phase 34b) phase 31's full-width step at (data, model) "
        f"{shard_meshes(torch.cuda.device_count())[0]}, (count, bytes) by "
        f"kind: fake {json.dumps(fake)}, rank 0 of the real step "
        f"{json.dumps(real)}; predicted peak "
        f"{pred['p31']['peak'] / 2**30:.3f} GiB")
    for mesh, peaks in p32.items():
        pp = pred[f"p32 {mesh}"]["peak"]
        gib = [round(b / 2**30, 3) for b in peaks]
        log(f"  phase 32 at {mesh}: predicted peak (rank 0) "
            f"{pp / 2**30:.3f} GiB against {gib} measured a card "
            f"({pp / max(peaks):.4f}x the largest)")
    if fake != real:
        raise AssertionError("phase 34: the dry run's collectives are not "
                             "those of phase 31's real step")
    for mesh, real35 in p35.items():
        fake35 = {k: (d["count"], d["bytes"]) for k, d in
                  pred[f"p35 {mesh}"]["collectives"].items()}
        real35 = {k: (d["count"], d["bytes"]) for k, d in real35.items()}
        log(f"dry run (phase 34c) phase 35a's pipelined step at (pod, data, "
            f"model) {mesh}, (count, bytes) by kind and pod: fake "
            f"{json.dumps(fake35)}, rank 0 of the real step "
            f"{json.dumps(real35)}; predicted peak "
            f"{pred[f'p35 {mesh}']['peak'] / 2**30:.3f} GiB")
        if fake35 != real35:
            raise AssertionError(f"phase 34: the dry run's collectives are "
                                 f"not those of phase 35a's step at {mesh}")
    log(f"dry run (phase 34) took {time.perf_counter() - t0:.1f} s (waiting "
        f"for the predictions included)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    # ---------------------------------------------------------------- setup
    smi = nvidia_smi()
    # phase 36's idle draw: before this process's first kernel
    idle_w = smi_power_w("power.draw")
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
    # phase 34's predictions run on the host beside the phases until then
    import tempfile
    pred_dir = tempfile.mkdtemp(prefix="chip_smoke_predict_")
    pred_path = os.path.join(pred_dir, "predict.json")
    with open(os.path.join(pred_dir, "log.txt"), "w") as pred_log:
        predictor = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--predict",
             pred_path, str(torch.cuda.device_count())],
            stdout=pred_log, stderr=subprocess.STDOUT)
    try:
        return phases(torch, smi, idle_w, (predictor, pred_path))
    finally:
        if predictor.poll() is None:
            predictor.kill()
        predictor.wait()
        import shutil
        shutil.rmtree(pred_dir, ignore_errors=True)


def phases(torch, smi, idle_w, predictor) -> int:
    """Phases 36, 2-23, 37 and 24-35 (``main`` made the setup, read the
    idle draw and started the predictions)."""
    from repro_torch.core import best_throughput, scenarios, solve
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.models.cnn import zoo
    from repro_torch.runtime import EdgePipeline
    for lib in _build.LIBRARIES:
        for line in lib.log.read_text().splitlines():
            if "Compiling entry" in line or "registers" in line:
                log("  ptxas " + line.split("ptxas info")[-1].strip(" :"))
        lib.library()
    dev = torch.device("cuda")

    # ----------------------------------------------------------------- card
    card_phase(torch, smi, idle_w)

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

    # ------------------------------------------- gateway: solo baselines
    gw = gateway_refs(torch, pipe, plain_pipe, model, ops, dev, smi)

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
                            xs, gw)
    recovery_phase(torch, model, cuts, scen, xs, unfaulted, smi)

    # ------------------------------------ gateway, adaptive loop, profiler
    aimd_phase(torch, model, scen, dev, smi)
    adaptive_phase(torch, model, dev, smi)
    profiler_phase(torch, model, dev, smi)

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
    del cfg, model, inputs, cache_len, feed

    # ---------------------------------------------------------- moe kernels
    gc.collect()                       # the falcon-mamba model is unreferenced
    torch.cuda.empty_cache()
    t_moe = time.perf_counter()
    moe_err, moe_rows = moe_kernels(torch, ops, ref, dev)
    log(f"moe kernels (check-phase launches): "
        f"{json.dumps(ops.launch_counts())}")

    # ------------------------------------------------------------ moe slice
    gc.collect()
    torch.cuda.empty_cache()
    # the MoE path launches the dense path's kernels (its router, sort,
    # gathers and expert products are library calls)
    moe_launches = serve_slice(torch, ops, serve, "moe", MOE_ARGS, lm_expect)
    rms_counted(moe_launches, moe_rows, "moe")

    # ---------------------------------------------------- moe parity, profile
    gc.collect()
    torch.cuda.empty_cache()
    moe_formulations(torch, dev)
    moe_fp32_parity(torch, lm, dev)
    cfg, model, inputs, cache_len, feed = moe_full_depth(torch, serve, lm, dev)
    moe_profile(torch, lm, cfg, model, inputs, cache_len)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    truth(torch, lm, "moe", cfg, inputs, cache_len, feed, dev,
          MOE_TRUTH_LAYERS)
    log(f"moe phases 14-17 took {time.perf_counter() - t_moe:.1f} s; max "
        f"|kernel - plain| at the moe shapes {json.dumps(moe_err)}; the "
        f"slice's launches flash {moe_launches['flash_attention']}, decode "
        f"{moe_launches['decode_attention']}, rmsnorm "
        f"{moe_launches['fused_rmsnorm']}")

    # ----------------------------------------------- hybrid and enc-dec slices
    del cfg, inputs, cache_len, feed
    gc.collect()                       # the MoE models are unreferenced now
    torch.cuda.empty_cache()
    new_err, hyb_launches, enc_launches = hybrid_encdec_phases(
        torch, ops, ref, serve, lm, dev)

    # ---------------------------------------- the rest of the registry (37)
    gc.collect()                       # the whisper model is unreferenced
    torch.cuda.empty_cache()
    reg_err, reg_launches = registry_phases(torch, ops, ref, serve, lm, dev)

    # ------------------------------------------------------------ training
    t_train = time.perf_counter()
    # the launcher's numerics from here on (TF32 off, cuDNN deterministic,
    # torch's deterministic algorithms), so the phases time the step that
    # ``python -m repro_torch.launch.train`` runs
    from repro_torch.launch import train
    if os.environ["CUBLAS_WORKSPACE_CONFIG"] != train.CUBLAS_WORKSPACE:
        raise AssertionError("CUBLAS_WORKSPACE_CONFIG is not the launcher's")
    train.set_numerics()
    log(f"training numerics: deterministic algorithms "
        f"{torch.are_deterministic_algorithms_enabled()}, "
        f"CUBLAS_WORKSPACE_CONFIG {os.environ['CUBLAS_WORKSPACE_CONFIG']}")
    for phase in (train_parity, train_slice, resume_drill, train_profile):
        gc.collect()                   # the previous phase's models
        torch.cuda.empty_cache()
        if phase is train_slice:
            train_launches, plain_train = phase(torch, dev, smi)
        else:
            phase(torch, dev)
    log(f"training phases 24-27 took {time.perf_counter() - t_train:.1f} s")

    # --------------------------------------------------------- pod pipeline
    t_pipe = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    pipe_launches = pipeline_serve(torch, ops, serve, lm, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    pipeline_train_parity(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    for k, n in pipeline_train(torch, dev, smi, plain_train).items():
        train_launches[k] += n
    log(f"pod pipeline phases 28-30 took {time.perf_counter() - t_pipe:.1f} s")

    # ------------------------------------------------- data and model axes
    t_shard = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    ranked = rank_phases(torch, plain_train)
    p31_collectives = sharded_parity(torch, smi, ranked["31"])
    shard_launches, p32_peaks = sharded_train(torch, smi, plain_train,
                                              ranked.get("32"))
    for k, n in shard_launches.items():
        train_launches[k] += n
    serve_launches = sharded_serve(torch, smi, SERVED["lm"], ranked["33"])
    pod_launches, p35_collectives = pod_mesh_phase(torch, smi, plain_train,
                                                   ranked["35"])
    log(f"rank phases 31-33 and 35 took {time.perf_counter() - t_shard:.1f} "
        f"s")

    # -------------------------------------------------------------- dry run
    dryrun_phase(torch, smi, predictor, plain_train, p31_collectives,
                 p32_peaks, p35_collectives)

    # --------------------------------------------------------------- report
    # the LM kernels' launches over every LM serving path's run
    lm_paths = (lm_launches, ssm_launches, moe_launches, hyb_launches,
                enc_launches, *reg_launches.values(), pipe_launches,
                serve_launches, pod_launches)
    rows = []
    for name in REPLACES:
        t = timings[name]
        rows.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "train_launches": train_launches[name],
            "max_abs_err": err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t["library_ms"]})
    for name, t in lm_timings.items():
        rows.append({
            "name": name, "route": "cuda", "source": LM_SOURCE,
            "replaces": LM_REPLACES[name],
            "launches": sum(path[name] for path in lm_paths),
            "train_launches": train_launches[name],
            "max_abs_err": max(e[name] for e in (lm_err, moe_err, new_err,
                                                 reg_err)),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    for name, steps in ssm_timing.items():
        t = steps["prefill"]
        rows.append({
            "name": name, "route": "cuda", "source": SSM_SOURCE,
            "replaces": SSM_REPLACES, "launches": ssm_launches[name],
            "train_launches": train_launches[name],
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
    if len(sys.argv) == 5 and sys.argv[1] == "--rank":
        with open(sys.argv[3]) as spec_file:
            spec = json.load(spec_file)
        rank_main(spec, sys.argv[4])
        sys.exit(0)
    if len(sys.argv) == 4 and sys.argv[1] == "--predict":
        predict(sys.argv[2], int(sys.argv[3]))
        sys.exit(0)
    if len(sys.argv) > 1:
        sys.exit(f"usage: {sys.argv[0]}")
    sys.exit(main())
