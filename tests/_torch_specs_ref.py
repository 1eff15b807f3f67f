"""The JAX reference's dry-run input specs of every single-pod cell, for
``tests/test_torch_specs.py``.

    XLA_FLAGS=--xla_force_host_platform_device_count=512 JAX_PLATFORMS=cpu \\
        python tests/_torch_specs_ref.py OUT.json

On the reference's 16 x 16 ``(data, model)`` mesh (``AxisType.Auto``
axes, under ``use_mesh_context``) each arch × shape cell's
``cell_supported`` answer and, for a supported cell, every leaf of
``launch/specs.py:input_specs``: {"arch/shape": {"supported", "reason",
"leaves": {path: [shape, dtype, spec]}}}, the path's keys joined by
``/``, the spec one entry a tensor dim (None, a mesh axis, or a list of
them).  Under "pipelined/arch/shape", for one arch of each family,
the same of the pipelined specs (``input_specs(..., pcfg)``) on the
multi-pod 2 x 16 x 16 ``(pod, data, model)`` mesh, ``pcfg`` the
reference dry run's (``PipelineConfig.even(n_layers, 2, mb)``, 8
microbatches for training, 1 for serving).  Nothing of the reference
changes here.
"""
import json
import sys

import jax

import repro.configs as configs
from repro.launch import specs as SP
from repro.runtime.pipeline import PipelineConfig
from repro.sharding.api import use_mesh_context

PIPELINED = ("qwen3-1.7b", "phi-3-vision-4.2b", "qwen3-moe-30b-a3b",
             "falcon-mamba-7b", "zamba2-7b", "whisper-small")


def _spec(s, ndim):
    sh = getattr(s, "sharding", None)
    entries = [] if sh is None else [
        None if e is None else e if isinstance(e, str) else list(e)
        for e in tuple(sh.spec)]
    return entries + [None] * (ndim - len(entries))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _record(cfg, shape, ctx, pcfg=None):
    ok, why = SP.cell_supported(cfg, shape)
    rec = {"supported": ok, "reason": why, "leaves": {}}
    if ok:
        for p, s in _leaves(SP.input_specs(cfg, shape, ctx, pcfg)):
            rec["leaves"][p] = [list(s.shape), str(s.dtype),
                                _spec(s, len(s.shape))]
    return rec


def main(path):
    auto = jax.sharding.AxisType.Auto
    devices = jax.devices()
    mesh = jax.make_mesh((16, 16), ("data", "model"), axis_types=(auto,) * 2,
                         devices=devices[:256])
    out = {}
    with use_mesh_context(mesh) as ctx:
        for arch in configs.ARCH_NAMES:
            cfg = configs.get(arch)
            for shape in SP.SHAPES:
                out[f"{arch}/{shape}"] = _record(cfg, shape, ctx)
    multi = jax.make_mesh((2, 16, 16), ("pod", "data", "model"),
                          axis_types=(auto,) * 3)
    with use_mesh_context(multi) as ctx:
        for arch in PIPELINED:
            cfg = configs.get(arch)
            for shape in SP.SHAPES:
                mb = 8 if SP.SHAPES[shape].kind == "train" else 1
                out[f"pipelined/{arch}/{shape}"] = _record(
                    cfg, shape, ctx, PipelineConfig.even(cfg.n_layers, 2, mb))
    with open(path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
