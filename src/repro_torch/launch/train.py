"""Training launcher: one device, the data and model axes, or a pod
pipeline; checkpoint/restart, deterministic data resume, gradient
compression and a crash drill (counterpart of
``src/repro/launch/train.py``).

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
  # the data and model axes: 4 ranks at (data 2, model 2), gloo ranks
  # on the CPU, or one card a rank with --device cuda:
  python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \
      --device cpu --data-par 2 --model-par 2 --steps 16 --batch 4 \
      --seq 32
  # the pod pipeline over ranks: 4 ranks at (pod 2, data 2, model 1),
  # each pod's stage sharded on its (data, model) sub-mesh:
  python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \
      --device cpu --pods 2 --data-par 2 --microbatches 2 \
      --auto-partition --steps 16 --batch 4 --seq 32

``--data-par D --model-par M`` (D x M > 1) trains on a ``(data, model)``
mesh of D x M ranks (``runtime.steps`` under ``sharding.api``): the batch
over ``data``, the rules table's tensor-parallel dims over ``model``,
ZeRO-1 moments, and ``--compress-grads`` on the data axis's gradients.
The command starts the ranks itself, one process each
(``launch.mesh.spawn_ranks``), or is one of them when ``torchrun``'s
environment names its rank.  Each draws the whole weights from
``--seed`` and keeps its shards, so the run starts from the one-device
run's weights.  Rank 0 alone prints and writes checkpoints (every rank
joins the gathers), which hold whole leaves in the reference's layout,
so a run resumes on another mesh, or on one device.  More ranks than
cards is an error, never a smaller mesh or the CPU.

``--pods K`` (K > 1) trains through ``runtime.pipeline`` with
``--microbatches`` (4 by default) and even cuts, or with
``--auto-partition`` the cuts ``models.blocks_adapter`` picks for the
H100s the stages run on (one a stage, or a pod's D x M; qwen3-1.7b at
seq 2048, batch 8: (16,) on 2 stages, (8, 16, 24) on 4), printed as
the reference prints them, with the card's predicted latency and
throughput; its checkpoints hold the reference's pipeline layout.  In one process the stages sit on the cards in turn;
with ``--data-par``/``--model-par`` (or in a rank) the command runs K x
D x M ranks on the ``(pod, data, model)`` mesh, each pod's stage sharded
on its ``(data, model)`` sub-mesh, and a checkpoint of either restores
in the other.  The pipelined step takes no gradient compression: asking
for it is an error, never ignored (the reference ignores
``--compress-grads`` under ``--pods``).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch
import torch.distributed as dist

from .. import configs
from ..checkpoint import CheckpointManager
from ..data.pipeline import DataConfig, SyntheticLM
from ..models import lm
from ..models.cnn.zoo import resolve_device
from ..optim import CompressionConfig, OptConfig, cosine_schedule
from ..runtime.edge import apply_numerics
from ..runtime.pipeline import make_pipeline_train_step, stage_context
from ..runtime.steps import (make_train_step, reference_layouts,
                             reference_state, state_from_reference,
                             train_state)
from ..sharding.api import MeshContext, is_dtensor, use_mesh_context
from .mesh import in_rank, make_host_mesh, plan_pipeline, spawn_ranks

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
    world = ranks_of(args)
    if args.pods > 1 and args.compress_grads:
        ap.error(f"--compress-grads with --pods {args.pods}: the pipelined "
                 "step takes no gradient compression, as the reference's "
                 "(which ignores the flag; ROADMAP queue 3); compression "
                 "runs on the data axis (--data-par; ROADMAP queue 1, item "
                 "12b)")
    if world > 1 and torch.device(args.device).type == "cuda" \
            and not in_rank() and world > torch.cuda.device_count():
        ap.error(f"{mesh_name(args)}: {world} ranks need {world} cards, one "
                 f"a rank; this machine has {torch.cuda.device_count()}")
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


def ranks_of(args) -> int:
    """The ranks a command of ``--pods``/``--data-par``/``--model-par``
    runs in: pods x data x model when the data and model axes are on,
    else 1 (one process, the pods' stages on the cards in turn)."""
    axes = args.data_par * args.model_par
    return args.pods * axes if axes > 1 else 1


def mesh_name(args) -> str:
    """The launcher's words for the ranks' mesh."""
    axes = f"data {args.data_par}, model {args.model_par}"
    return f"(pod {args.pods}, {axes})" if args.pods > 1 else f"({axes})"


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
    (PipelineConfig, mesh), else None.  In a rank of ``--data-par`` x
    ``--model-par`` the same on the ranks' mesh: this rank's card (or
    the CPU), the weights' shards, the sharded step; with ``--pods`` on
    the ``(pod, data, model)`` mesh, this rank's pod's stage."""
    mesh = None
    if args.data_par * args.model_par > 1 or in_rank():
        mesh = make_host_mesh(args.pods, args.data_par, args.model_par,
                              args.device)
        dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
            if mesh.device_type == "cuda" else torch.device("cpu")
    else:
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
        with use_mesh_context(mesh):
            return (cfg, train_state(model, comp),
                    make_train_step(cfg, opt, comp), data, None)
    pcfg, mesh = plan_pipeline(cfg, model, args.pods, args.microbatches,
                               seq=args.seq, batch=args.batch,
                               auto_partition=args.auto_partition, train=True,
                               mesh=mesh)
    with use_mesh_context(stage_context(mesh)):
        state = train_state(model)
    return (cfg, state, make_pipeline_train_step(cfg, pcfg, opt, mesh), data,
            (pcfg, mesh))


def main(argv=None) -> dict:
    """Train as ``argv`` says; prints the reference's lines → {"arch",
    "losses": {step: loss} of the logged steps, "final_loss"}.  With
    ``--data-par`` x ``--model-par`` > 1, outside a rank: starts the
    ranks, each this command, and exits with their code (0 → {"arch",
    "ranks"})."""
    args = parse_args(argv)
    world = ranks_of(args)
    if world > 1 and not in_rank():
        cmd = [sys.executable, "-m", "repro_torch.launch.train",
               *(sys.argv[1:] if argv is None else argv)]
        code = spawn_ranks(cmd, world)
        if code:
            sys.exit(code)
        return {"arch": args.arch, "ranks": world}
    set_numerics()
    cfg, state, step_fn, data, pipe = setup(args)
    pcfg = None if pipe is None else pipe[0]
    table = state["model"].embed.table
    ranks = table.device_mesh if is_dtensor(table) else None
    lead = ranks is None or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    mgr = None
    start = 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
        # the pod mesh's ranks read whole leaves and keep their stage's
        layouts = None if ranks is None or pcfg is not None else \
            reference_layouts(cfg, MeshContext(ranks), CompressionConfig(
                enabled=args.compress_grads))
        restored, manifest = mgr.restore(layouts)
        if restored is not None:
            with use_mesh_context(ranks):
                state = state_from_reference(cfg, restored,
                                             state["model"].device,
                                             *pipe or ())
            start = int(manifest["step"])
            data.load_state_dict(manifest["extra"]["data"])
            say(f"[resume] step {start}")

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
            if ranks is not None:
                dist.barrier()          # every rank's checkpoint is out
            say(f"[fault-injection] crashing at step {step}", flush=True)
            os._exit(42)
        batch = data.batch_at(step)
        data.step = step + 1
        state, metrics = step_fn(state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            losses[step] = float(metrics["loss"])
            say(f"step {step:5d} loss {losses[step]:.9g} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"({time.time() - t0:.1f}s)", flush=True)
        if mgr is not None and mgr.should_save(step + 1):
            _save(mgr, reference_state(state, pcfg, keep=lead), step + 1,
                  {"data": data.state_dict()}, block=False)
    if mgr is not None:
        _save(mgr, reference_state(state, pcfg, keep=lead), args.steps,
              {"data": data.state_dict()})
    final = None if metrics is None else float(metrics["loss"])
    say(f"[done] {args.steps} steps, final loss "
        f"{'none' if final is None else format(final, '.9g')}")
    if ranks is not None:
        dist.destroy_process_group()
    return {"arch": cfg.name, "losses": losses, "final_loss": final}


def _save(mgr, tree: dict | None, step: int, extra: dict,
          block: bool = True) -> None:
    """Rank 0 (or the one device) writes ``tree``, which every rank
    gathered and only rank 0 kept (``reference_state``: None on the
    others)."""
    if tree is not None:
        mgr.save(tree, step, extra=extra, block=block)


if __name__ == "__main__":
    main()
