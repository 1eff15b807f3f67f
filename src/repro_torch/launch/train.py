"""Training launcher: one device or a pod pipeline, checkpoint/restart,
deterministic data resume, gradient compression and a crash drill
(counterpart of ``src/repro/launch/train.py``).

Trains any registered architecture (``--arch``, full or ``--reduced``)
from random weights drawn with ``--seed``, with AdamW, clipping and the
cosine schedule, through the plain route (the kernels have no
backward).  Runs on ``cuda`` unless ``--device`` names another; there
it first sets the port's numerics (TF32 off, cuDNN deterministic,
``torch.use_deterministic_algorithms``), without which a resumed run
could not equal an uninterrupted one bit for bit.  Each logged loss
prints with nine significant digits, which tells every fp32 value
apart, so equal lines are equal bits.

  # a CPU-scale run, checkpointed every 5 steps:
  python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \\
      --device cpu --steps 16 --batch 2 --seq 32 --ckpt-dir runs/q
  # the crash/restart drill: dies at step 9 (exit 42), then resumes
  # from the checkpoint of step 5:
  python -m repro_torch.launch.train ... --fail-at-step 9
  python -m repro_torch.launch.train ...
  # the pod pipeline: GPipe over 2 stages with ParetoPipe's cuts, 2
  # microbatches (stage k on cuda:{k % cards}; every stage on the CPU
  # with --device cpu):
  python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \
      --device cpu --pods 2 --microbatches 2 --auto-partition \
      --steps 16 --batch 2 --seq 32

``--pods K`` (K > 1) trains through ``runtime.pipeline`` with
``--microbatches`` (4 by default) and even cuts, or with
``--auto-partition`` the cuts ``models.blocks_adapter`` picks, printed as
the reference prints them; its checkpoints hold the reference's
pipeline layout.  The data and model axes (``--data-par``,
``--model-par``) wait for the port of sharding (ROADMAP queue 1, item
12b), and the pipelined step takes no gradient compression: asking for
either is an error, never ignored (the reference ignores
``--compress-grads`` under ``--pods``).
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from .. import configs
from ..checkpoint import CheckpointManager
from ..data.pipeline import DataConfig, SyntheticLM
from ..models import lm
from ..models.cnn.zoo import resolve_device
from ..optim import CompressionConfig, OptConfig, cosine_schedule
from ..runtime.edge import apply_numerics
from ..runtime.pipeline import make_pipeline_train_step
from ..runtime.steps import (make_train_step, reference_state,
                             state_from_reference, train_state)
from .mesh import plan_pipeline

# cuBLAS's workspace setting for deterministic results; read when CUDA
# starts, so it is set before the first CUDA call
CUBLAS_WORKSPACE = ":4096:8"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=list(configs.ARCH_NAMES))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (e.g. ~100M-param runs)")
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--fail-at-step", type=int, default=0,
                    help="inject a crash (fault-tolerance drill)")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=None,
                    help="pipeline microbatches (with --pods > 1; 4 by "
                         "default)")
    ap.add_argument("--auto-partition", action="store_true",
                    help="ParetoPipe chooses the pipeline cuts")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.data_par * args.model_par > 1:
        ap.error(f"--data-par {args.data_par} --model-par {args.model_par}: "
                 "the data and model axes wait for the port of "
                 "sharding/api.py (ROADMAP queue 1, item 12b)")
    if args.pods > 1 and args.compress_grads:
        ap.error(f"--compress-grads with --pods {args.pods}: the pipelined "
                 "step takes no gradient compression, as the reference's "
                 "(which ignores the flag; ROADMAP queue 3); compression "
                 "belongs with the data axis (ROADMAP queue 1, item 12b)")
    if args.pods <= 1 and args.microbatches is not None:
        ap.error(f"--microbatches {args.microbatches} without --pods > 1: "
                 "microbatches are the pod pipeline's (runtime/pipeline.py, "
                 "ROADMAP queue 1, item 12a)")
    if args.pods <= 1 and args.auto_partition:
        ap.error("--auto-partition without --pods > 1: the ParetoPipe cuts "
                 "(models/blocks_adapter.py, ROADMAP queue 1, item 10.5) "
                 "split the pod pipeline")
    if args.pods > 1 and args.microbatches is None:
        args.microbatches = 4
    return args


def set_numerics() -> None:
    """The port's training numerics: TF32 off, cuDNN deterministic and
    torch's deterministic algorithms (cuBLAS's workspace set first)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    apply_numerics({"cudnn.allow_tf32": False, "matmul.allow_tf32": False,
                    "cudnn.deterministic": True, "cudnn.benchmark": False,
                    "threads": torch.get_num_threads()})
    torch.use_deterministic_algorithms(True)


def setup(args: argparse.Namespace):
    """→ (cfg, state, step_fn, data, pipe) for ``args``: the config (the
    plain route), a fresh state from ``--seed``, the train step (AdamW,
    clipping, the cosine schedule, compression when asked) and the data
    stream, all on ``--device``; under ``--pods`` the weights (the same
    draws) placed on the stages, the pipelined step, and ``pipe`` =
    (PipelineConfig, mesh), else None."""
    dev = resolve_device(args.device)
    cfg = configs.reduced(args.arch) if args.reduced else configs.get(args.arch)
    over = {}
    if args.d_model:
        over["d_model"] = args.d_model
    if args.n_layers:
        over["n_layers"] = args.n_layers
    cfg = cfg.replace(attn_impl="xla", **over)
    opt = OptConfig(lr=cosine_schedule(args.lr, args.warmup, args.steps))
    comp = CompressionConfig(enabled=args.compress_grads)
    model = lm.init(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                    dev)
    data = SyntheticLM(cfg, DataConfig(args.batch, args.seq, args.seed),
                       device=dev)
    if args.pods <= 1:
        return (cfg, train_state(model, comp), make_train_step(cfg, opt, comp),
                data, None)
    pcfg, mesh = plan_pipeline(cfg, model, args.pods, args.microbatches,
                               seq=args.seq, batch=args.batch,
                               auto_partition=args.auto_partition, train=True)
    return (cfg, train_state(model), make_pipeline_train_step(
        cfg, pcfg, opt, mesh), data, (pcfg, mesh))


def main(argv=None) -> dict:
    """Train as ``argv`` says; prints the reference's lines → {"arch",
    "losses": {step: loss} of the logged steps, "final_loss"}."""
    args = parse_args(argv)
    set_numerics()
    cfg, state, step_fn, data, pipe = setup(args)
    pcfg = None if pipe is None else pipe[0]
    mgr = None
    start = 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
        restored, manifest = mgr.restore()
        if restored is not None:
            state = state_from_reference(cfg, restored,
                                         state["model"].device, *pipe or ())
            start = int(manifest["step"])
            data.load_state_dict(manifest["extra"]["data"])
            print(f"[resume] step {start}")

    t0 = time.time()
    metrics = None
    losses = {}
    for step in range(start, args.steps):
        if args.fail_at_step and step == args.fail_at_step:
            # crash between async checkpoint writes, not during one: the
            # drill tests restart from a durable checkpoint; a torn write
            # is a separate failure the manager survives by never
            # restoring *.tmp dirs
            if mgr is not None:
                mgr.wait()
            print(f"[fault-injection] crashing at step {step}", flush=True)
            os._exit(42)
        batch = data.batch_at(step)
        data.step = step + 1
        state, metrics = step_fn(state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            losses[step] = float(metrics["loss"])
            print(f"step {step:5d} loss {losses[step]:.9g} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if mgr is not None and mgr.should_save(step + 1):
            mgr.save(reference_state(state, pcfg), step + 1,
                     extra={"data": data.state_dict()}, block=False)
    if mgr is not None:
        mgr.save(reference_state(state, pcfg), args.steps,
                 extra={"data": data.state_dict()})
    final = None if metrics is None else float(metrics["loss"])
    print(f"[done] {args.steps} steps, final loss "
          f"{'none' if final is None else format(final, '.9g')}")
    return {"arch": cfg.name, "losses": losses, "final_loss": final}


if __name__ == "__main__":
    main()
