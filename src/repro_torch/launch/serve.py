"""Serving launcher: batched prefill + greedy decode with KV caches, or
with the conv window and state of an SSM (counterpart of
``src/repro/launch/serve.py``).

Builds a registered arch with random weights from ``--seed``, prefills
a batch of synthetic prompts, decodes ``--new-tokens`` tokens, and
reports prefill latency and decode throughput — the paper's two
metrics, on the LM serving path.  It serves with
``attn_impl="pallas"``: on the card attention, the selective scan and
every RMSNorm run the port's CUDA kernels, on the CPU (``--device
cpu``) their plain versions; a moe arch routes its MLP through the
sort formulation.  A hybrid arch (zamba2) caches its conv windows,
states and one k/v cache per application of its shared attention
block; an encdec arch (whisper) encodes the synthetic batch's stub
frames once per prefill and caches its cross-attention k/v.
``cache_len`` is prompt + new tokens (+ the image patches of a vlm),
as in the reference, and unused by the ssm family.  ``--pods K`` (K > 1)
serves through the pod pipeline (``runtime.pipeline``, stage k on
``cuda:{k % cards}``), with even cuts or, with ``--auto-partition``,
the ParetoPipe cuts for serving (``choose_pipeline_cuts(...,
train=False)``, priced for the H100s the stages run on: qwen3-1.7b at
prompt 1024, batch 8, (17,) on 2 stages); its tokens equal the
unpipelined serve's.
``--data-par D --model-par M`` (D x M > 1) serves on a ``(data, model)``
mesh of D x M ranks, as ``launch.train`` trains on one: the command
starts the ranks (``launch.mesh.spawn_ranks``), or is one of them under
``torchrun``; each draws the whole weights from ``--seed`` and keeps its
shards (``lm.shard_params``), the steps split the batch over ``data``
and run the kernels on each rank's shards, and the cache stays sharded
(``lm.cache_names``).  Rank 0 alone prints.  More ranks than cards is an
error.  ``--pods K`` with ``--data-par``/``--model-par`` serves on K x D
x M ranks, the ``(pod, data, model)`` mesh: pod 0 embeds, each pod's
stage runs sharded on its ``(data, model)`` sub-mesh and keeps its own
cache, the last pod's greedy tokens are broadcast to every rank; its
tokens equal the one-process pipelined serve's.

  python -m repro_torch.launch.serve --arch qwen3-1.7b --reduced \\
      --device cpu --batch 2 --prompt-len 16 --new-tokens 4
  python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --batch 8 --prompt-len 1024 --new-tokens 32        # on the card
  python -m repro_torch.launch.serve --arch falcon-mamba-7b --reduced \\
      --device cpu
  python -m repro_torch.launch.serve --arch falcon-mamba-7b \\
      --batch 8 --prompt-len 1024 --new-tokens 32        # on the card
  python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --reduced \\
      --device cpu
  python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \\
      --batch 8 --prompt-len 1024 --new-tokens 32        # on the card
  python -m repro_torch.launch.serve --arch zamba2-7b --reduced \\
      --device cpu
  python -m repro_torch.launch.serve --arch zamba2-7b \\
      --batch 8 --prompt-len 1024 --new-tokens 32        # on the card
  python -m repro_torch.launch.serve --arch whisper-small --reduced \\
      --device cpu
  python -m repro_torch.launch.serve --arch whisper-small \\
      --batch 8 --prompt-len 416 --new-tokens 32         # on the card
  python -m repro_torch.launch.serve --arch qwen3-1.7b --reduced \\
      --device cpu --pods 2 --auto-partition             # pipelined
  python -m repro_torch.launch.serve --arch qwen3-1.7b --reduced \\
      --device cpu --data-par 2 --model-par 2 --batch 4  # 4 gloo ranks
  python -m repro_torch.launch.serve --arch qwen3-1.7b --reduced \\
      --device cpu --pods 2 --model-par 2 --batch 4      # (2, 1, 2)

``main`` prints the reference's lines and returns the numbers.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.distributed as dist

from .. import configs
from ..data.pipeline import DataConfig, SyntheticLM
from ..models import lm
from ..models.cnn.zoo import resolve_device
from ..runtime.pipeline import (make_pipeline_decode_step,
                                make_pipeline_prefill_step)
from ..runtime.steps import make_decode_step, make_prefill_step
from ..sharding.api import use_mesh_context
from .mesh import in_rank, make_host_mesh, plan_pipeline, spawn_ranks
from .train import mesh_name, ranks_of


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=list(configs.ARCH_NAMES))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pods", type=int, default=1,
                    help="serve through a pipeline of this many stages")
    ap.add_argument("--auto-partition", action="store_true",
                    help="ParetoPipe chooses the pipeline cuts")
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    args = ap.parse_args(argv)
    world = ranks_of(args)
    if world > 1 and torch.device(args.device).type == "cuda" \
            and not in_rank() and world > torch.cuda.device_count():
        ap.error(f"{mesh_name(args)}: {world} ranks need {world} cards, one "
                 f"a rank; this machine has {torch.cuda.device_count()}")
    if args.new_tokens < 2:
        ap.error("--new-tokens must be at least 2 (one warm-up decode step)")
    if args.auto_partition and args.pods <= 1:
        ap.error("--auto-partition without --pods > 1: the ParetoPipe cuts "
                 "split the pod pipeline")
    return args


def setup(args: argparse.Namespace):
    """→ (cfg, model, inputs, cache_len) for ``args``: weights from a
    ``torch.Generator`` on the device seeded with ``--seed``, one
    synthetic batch without its targets."""
    dev = resolve_device(args.device)
    if dev.type == "cuda" and dist.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = configs.reduced(args.arch) if args.reduced else configs.get(args.arch)
    cfg = cfg.replace(attn_impl="pallas")
    model = lm.init(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                    dev)
    data = SyntheticLM(cfg, DataConfig(args.batch, args.prompt_len,
                                       args.seed), device=dev)
    inputs = {k: v for k, v in next(data).items() if k != "targets"}
    cache_len = args.prompt_len + args.new_tokens \
        + (cfg.n_patches if cfg.family == "vlm" else 0)
    return cfg, model, inputs, cache_len


def _sync(device: torch.device) -> None:
    """Wait for the work of every card (a pipeline's stages may sit on
    several); in a rank of a group, for its own card."""
    if device.type != "cuda":
        return
    if dist.is_initialized():
        torch.cuda.synchronize(device)
        return
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def serve(cfg, model, inputs: dict, cache_len: int, new_tokens: int,
          steps: tuple | None = None) -> dict:
    """The reference's schedule: one warm-up prefill, a timed prefill,
    one warm-up decode step, then ``new_tokens - 1`` timed decode steps,
    through ``steps`` (prefill, decode; the unpipelined ones by default).
    → seconds, the step count and the tokens (B, new_tokens): the
    prefill's and the timed steps' (the warm-up step's token is fed on
    but not kept, as in the reference)."""
    dev = model.device
    prefill, decode = steps or (make_prefill_step(cfg, cache_len),
                                make_decode_step(cfg))

    tok, cache = prefill(model, inputs)                 # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    tok, cache = prefill(model, inputs)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    toks = [tok]
    tok, cache = decode(model, tok, cache)              # warm-up decode
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(new_tokens - 1):
        tok, cache = decode(model, tok, cache)
        toks.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {"prefill_s": t_prefill, "decode_s": t_decode,
            "decode_steps": new_tokens - 1,
            "tokens": torch.cat(toks, dim=1)}


def main(argv=None) -> dict:
    """Serve as ``argv`` says; prints the reference's lines → the
    numbers.  With ``--data-par`` x ``--model-par`` > 1, outside a rank:
    starts the ranks, each this command, and exits with their code (0 →
    {"arch", "ranks"})."""
    args = parse_args(argv)
    world = ranks_of(args)
    if world > 1 and not in_rank():
        cmd = [sys.executable, "-m", "repro_torch.launch.serve",
               *(sys.argv[1:] if argv is None else argv)]
        code = spawn_ranks(cmd, world)
        if code:
            sys.exit(code)
        return {"arch": args.arch, "ranks": world}
    ranks = None
    if world > 1 or in_rank():
        ranks = make_host_mesh(args.pods, args.data_par, args.model_par,
                               args.device)
    cfg, model, inputs, cache_len = setup(args)
    pcfg, steps = None, None
    if args.pods > 1:
        pcfg, mesh = plan_pipeline(cfg, model, args.pods, 1,
                                   seq=args.prompt_len, batch=args.batch,
                                   auto_partition=args.auto_partition,
                                   train=False, mesh=ranks)
        steps = (make_pipeline_prefill_step(cfg, pcfg, mesh, cache_len),
                 make_pipeline_decode_step(cfg, pcfg, mesh))
    elif ranks is not None:
        with use_mesh_context(ranks) as ctx:
            lm.shard_params(cfg, model, ctx)
            steps = (make_prefill_step(cfg, cache_len), make_decode_step(cfg))
    res = serve(cfg, model, inputs, cache_len, args.new_tokens, steps)
    B, S = args.batch, args.prompt_len
    n_dec = res["decode_steps"]
    prefill_tok_s = B * S / res["prefill_s"]
    ms_per_token = res["decode_s"] / n_dec * 1e3
    decode_tok_s = B * n_dec / res["decode_s"]
    out = res["tokens"]
    finite = bool((out >= 0).all() and (out < cfg.vocab).all())
    say = print if ranks is None or dist.get_rank() == 0 else \
        (lambda *a, **k: None)
    say(f"arch={cfg.name} batch={B} prompt={S} device={model.device}"
        + ("" if pcfg is None else f" pods={args.pods} cuts={pcfg.cuts}")
        + ("" if ranks is None else f" mesh={mesh_name(args)}"))
    say(f"prefill latency: {res['prefill_s'] * 1e3:.1f} ms "
        f"({prefill_tok_s:.0f} tok/s)")
    say(f"decode: {ms_per_token:.2f} ms/token "
        f"({decode_tok_s:.0f} tok/s aggregate)")
    say(f"generated shape {tuple(out.shape)}, finite={finite}")
    return {"arch": cfg.name, "device": str(model.device),
            "cuts": None if pcfg is None else pcfg.cuts,
            "prefill_ms": res["prefill_s"] * 1e3,
            "prefill_tok_s": prefill_tok_s,
            "decode_ms_per_token": ms_per_token,
            "decode_tok_s": decode_tok_s, "tokens": out, "valid": finite}


if __name__ == "__main__":
    main()
