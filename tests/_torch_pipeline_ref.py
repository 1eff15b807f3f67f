"""The JAX reference's pipelined steps, run for the port's parity tests
(``tests/test_torch_pipeline_train.py``,
``test_torch_pipeline_train_uneven.py``, ``test_torch_lm_pipeline.py``).

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        python tests/_torch_pipeline_ref.py {train|serve} OUT.npz \\
        [even|uneven [CKPT_DIR]]

The reference's pipeline is a ``shard_map`` over a ``pod`` axis, so it
needs a mesh of several devices: 8 forced host devices as (pod 2, data
2, model 2).  The mesh's axes are ``Auto``: on jax 0.9 ``jax.make_mesh``
makes ``Explicit`` axes by default, under which the reference's
``shard()`` asserts inside ``embed_lookup`` (its own pipeline tests fail
that way; ROADMAP queue 3).  Nothing of the reference changes here.

Each case's weights (``lm.build_params`` from ``PRNGKey(0)``, fp32), its
batch and the reference's results go into one npz, keys joined by
``/``.  The reference's ``InitBuilder`` folds ``hash(path)`` into the key,
and Python salts ``str`` hashes per process, so the weights are those of
the process's ``PYTHONHASHSEED`` (``_torch_pipeline_fixture`` fixes it).
With ``REF_INPUTS`` set in the environment, the run first writes just
its cases' ``<case>/params/...`` and ``<case>/batch/...`` (or
``<case>/inputs/...``) there, for the port to start from while the
reference compiles and runs its steps.  With ``REF_PART=i/n`` the run
takes every n-th of its cases, from the i-th.
  train: for the cases of one kind of cut, ``<case>/params/...`` (the
         plain layout), ``<case>/batch/...``, ``<case>/metrics/...`` of
         one pipelined train step and ``<case>/m/...``, its first AdamW
         moment in the pipeline layout; with CKPT_DIR, the state of
         ``CKPT_CASE`` after that step saved there by the reference's
         ``save_checkpoint`` and ``ckpt/loss``, the loss of its next
         step on ``ckpt/batch/...``.
  serve: ``<case>/params/...``, ``<case>/inputs/...``, the prefill's
         tokens and cache and those of two decode steps
         (``prefill/...``, ``decode0/...``, ``decode1/...``).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

import repro.configs as configs
from repro.checkpoint import save_checkpoint
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.models import lm
from repro.models.common import InitBuilder
from repro.optim import OptConfig, init_opt_state
from repro.runtime.pipeline import (PipelineConfig, make_pipeline_decode_step,
                                    make_pipeline_prefill_step,
                                    make_pipeline_train_step, repack_params)
from repro.sharding.api import use_mesh_context

# (case, arch, n_layers or None for the reduced depth, cuts or None for
# even ones); every train case runs K = 2 stages, M = 2 microbatches
TRAIN_CASES = [(f"{arch}-{kind}", arch, depth, cuts)
               for arch, uneven in (("qwen3-1.7b", (3, (1,))),
                                    ("phi-3-vision-4.2b", (3, (2,))),
                                    ("qwen3-moe-30b-a3b", (3, (1,))),
                                    ("falcon-mamba-7b", (3, (2,))),
                                    ("zamba2-7b", (4, (1,))),
                                    ("whisper-small", (3, (1,))))
               for kind, (depth, cuts) in (("even", (None, None)),
                                           ("uneven", uneven))]
CKPT_CASE = "qwen3-1.7b-uneven"
SERVE_CASES = [("qwen3-1.7b-c2", "qwen3-1.7b", 5, (2,)),
               ("qwen3-1.7b-c1", "qwen3-1.7b", 5, (1,)),
               ("qwen3-1.7b-c4", "qwen3-1.7b", 5, (4,)),
               ("zamba2-7b", "zamba2-7b", 5, (3,)),
               ("falcon-mamba-7b", "falcon-mamba-7b", 3, (2,)),
               ("qwen3-moe-30b-a3b", "qwen3-moe-30b-a3b", 3, (1,)),
               ("whisper-small", "whisper-small", 3, (1,))]
PROMPT, CACHE_LEN = 16, 18


def config(arch, depth):
    cfg = configs.reduced(arch)
    return cfg if depth is None else cfg.replace(n_layers=depth)


def pipeline_config(cfg, cuts, microbatches=2):
    if cuts is None:
        return PipelineConfig.even(cfg.n_layers, 2, microbatches)
    return PipelineConfig(2, microbatches, cuts)


def stack_key(cfg):
    return "dec_layers" if cfg.family == "encdec" else "layers"


def put(out, prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(out, f"{prefix}/{k}", v)
    else:
        out[prefix] = np.asarray(tree)


def part(cases):
    i, n = map(int, os.environ.get("REF_PART", "0/1").split("/"))
    return cases[i::n]


def train(out, kind, ckpt_dir):
    for case, arch, depth, cuts in part(TRAIN_CASES):
        if not case.endswith(f"-{kind}"):
            continue
        cfg = config(arch, depth)
        params = lm.build_params(cfg, InitBuilder(jax.random.PRNGKey(0),
                                                  jnp.float32))
        data = SyntheticLM(cfg, DataConfig(batch=4, seq=32))
        batch = next(data)
        pcfg = pipeline_config(cfg, cuts)
        key = stack_key(cfg)
        pparams = dict(params)
        pparams[key] = repack_params(params[key], pcfg, cfg.n_layers)
        with use_mesh_context(MESH):
            state = {"params": pparams, "opt": init_opt_state(pparams),
                     "step": jnp.int32(0)}
            step = jax.jit(make_pipeline_train_step(cfg, pcfg,
                                                    OptConfig(lr=1e-3), MESH))
            state, metrics = step(state, batch)
            put(out, f"{case}/params", params)
            put(out, f"{case}/batch", batch)
            put(out, f"{case}/metrics", metrics)
            put(out, f"{case}/m", state["opt"]["m"])
            out[f"{case}/cuts"] = np.asarray(pcfg.cuts)
            if ckpt_dir and case == CKPT_CASE:
                save_checkpoint(ckpt_dir, jax.tree.map(np.asarray, state), 1)
                nxt = next(data)
                _, m2 = step(state, nxt)
                put(out, "ckpt/batch", nxt)
                out["ckpt/loss"] = np.asarray(m2["loss"])
        print(case, float(metrics["ce"]), flush=True)


def inputs(out, mode, kind):
    train_ = mode == "train"
    cases = [c for c in TRAIN_CASES if c[0].endswith(f"-{kind}")] \
        if train_ else SERVE_CASES
    for case, arch, depth, _ in part(cases):
        cfg = config(arch, depth)
        put(out, f"{case}/params", lm.build_params(
            cfg, InitBuilder(jax.random.PRNGKey(0), jnp.float32)))
        batch = next(SyntheticLM(cfg, DataConfig(
            batch=4, seq=32 if train_ else PROMPT)))
        put(out, f"{case}/{'batch' if train_ else 'inputs'}",
            {k: v for k, v in batch.items() if train_ or k != "targets"})


def serve(out):
    for case, arch, depth, cuts in part(SERVE_CASES):
        cfg = config(arch, depth)
        params = lm.build_params(cfg, InitBuilder(jax.random.PRNGKey(0),
                                                  jnp.float32))
        data = SyntheticLM(cfg, DataConfig(batch=4, seq=PROMPT))
        inputs = {k: v for k, v in next(data).items() if k != "targets"}
        pcfg = pipeline_config(cfg, cuts, 1)
        key = stack_key(cfg)
        pparams = dict(params)
        pparams[key] = repack_params(params[key], pcfg, cfg.n_layers)
        with use_mesh_context(MESH):
            pre = jax.jit(make_pipeline_prefill_step(cfg, pcfg, MESH,
                                                     cache_len=CACHE_LEN))
            dec = jax.jit(make_pipeline_decode_step(cfg, pcfg, MESH))
            tok, cache = pre(pparams, inputs)
            put(out, f"{case}/prefill/tokens", tok)
            put(out, f"{case}/prefill/cache", cache)
            for i in range(2):
                tok, cache = dec(pparams, tok, cache)
                put(out, f"{case}/decode{i}/tokens", tok)
                put(out, f"{case}/decode{i}/cache", cache)
        put(out, f"{case}/params", params)
        put(out, f"{case}/inputs", inputs)
        out[f"{case}/cuts"] = np.asarray(pcfg.cuts)
        print(case, flush=True)


if __name__ == "__main__":
    mode, path = sys.argv[1], sys.argv[2]
    MESH = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    result: dict = {}
    if os.environ.get("REF_INPUTS"):
        drawn: dict = {}
        inputs(drawn, mode, sys.argv[3] if len(sys.argv) > 3 else "")
        np.savez(os.environ["REF_INPUTS"] + ".tmp.npz", **drawn)
        os.replace(os.environ["REF_INPUTS"] + ".tmp.npz",
                   os.environ["REF_INPUTS"])
    if mode == "train":
        train(result, sys.argv[3], sys.argv[4] if len(sys.argv) > 4 else None)
    else:
        serve(result)
    np.savez(path, **result)
