"""Shared by the rank tests (``test_torch_sharded_train.py``,
``test_torch_sharded_families.py``): run the port's sharded steps in
gloo ranks (``_torch_sharded_ranks.py`` through
``launch.mesh.spawn_ranks``), the reference's in a subprocess with 4
forced host devices (``_torch_sharded_ref.py``), read their npz files
back as nested trees, and the checks both files make."""
import json
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np

from _torch_pipeline_fixture import gradients, leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
CE_TOL, GRAD_FRAC = 1e-5, 1e-4


def _env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                **extra)


def read(path) -> dict:
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def run_ranks(cases: list[dict], world: int, out_dir: pathlib.Path,
              tag: str) -> dict:
    """→ {case: tree} of the port's sharded steps of ``cases`` in
    ``world`` gloo ranks."""
    from repro_torch.launch.mesh import spawn_ranks
    spec = out_dir / f"{tag}.json"
    spec.write_text(json.dumps(cases))
    out = out_dir / f"{tag}.npz"
    code = spawn_ranks([sys.executable, str(ROOT / "tests" /
                                            "_torch_sharded_ranks.py"),
                        str(spec), str(out)], world, env=_env(), grace_s=10)
    assert code == 0, f"{tag}: the ranks exited {code}"
    return read(out)


def run_reference(cases: list[dict], out_dir: pathlib.Path,
                  tag: str) -> dict:
    """→ {case: tree} of the reference's sharded steps of ``cases`` (as
    the ranks take them; ``_torch_sharded_ref.py``)."""
    spec = out_dir / f"{tag}.json"
    spec.write_text(json.dumps(cases))
    out = out_dir / f"{tag}.npz"
    cp = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_sharded_ref.py"),
         str(spec), str(out)],
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        capture_output=True, text=True, timeout=600)
    assert cp.returncode == 0, cp.stdout + "\n" + cp.stderr
    return read(out)


def assert_gradients_close(got: dict, want: dict, flips=None) -> None:
    """Every gradient leaf within ``GRAD_FRAC`` of its largest magnitude;
    with ``flips = (share, bound_frac)`` that share of a leaf's elements
    may lie further, none beyond ``bound_frac`` of the largest (a level
    of the compression's grid: see the compressed case)."""
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        big = np.abs(w).max()
        if big == 0:
            assert not got[path].any(), path
            continue
        diff = np.abs(got[path] - w)
        if flips is None:
            assert diff.max() <= GRAD_FRAC * big, (path, diff.max(), big)
        else:
            share, bound_frac = flips
            assert np.mean(diff > GRAD_FRAC * big) <= share, path
            assert diff.max() <= bound_frac * big, (path, diff.max(), big)


def step_gradients(tree: dict, opt) -> dict:
    """The gradients behind a step's first moment (``gradients`` of the
    pipeline tests), by the reference layout's leaf path."""
    return gradients(tree["m"], tree["metrics"]["grad_norm"], opt)


def assert_zero1_bytes(tree: dict, arch: str, shape: tuple) -> None:
    """ZeRO-1's rule of bytes: every rank holds, of every reference
    leaf's first moment, the bytes of the reference's per-device shard
    under ``zero1_spec`` of the leaf's ``SpecBuilder`` spec on a mesh of
    ``shape``."""
    import jax.numpy as jnp
    import repro.configs as RCFG
    import repro.sharding.api as RS
    from repro.models import lm as RL
    from repro.models.common import AbstractBuilder, SpecBuilder
    cfg = RCFG.reduced(arch)
    ctx = RS.MeshContext(SimpleNamespace(axis_names=("data", "model"),
                                         devices=np.empty(shape, object)))
    RS.set_context(ctx)
    try:
        specs = dict(leaves(RL.build_params(cfg, SpecBuilder(ctx))))
        shapes = dict(leaves(RL.build_params(cfg, AbstractBuilder(
            None, jnp.float32))))
        sizes = dict(zip(("data", "model"), shape))
        want = {}
        for path, spec in specs.items():
            z1 = RS.zero1_spec(spec, shapes[path].shape)
            split = int(np.prod([sizes[a] for a in z1 if a is not None]))
            want[path.replace("/", ".")] = \
                int(np.prod(shapes[path].shape)) * 4 // split
    finally:
        RS.set_context(None)
    got = {k: v for k, v in tree["bytes"].items()}
    assert sorted(got) == sorted(want)
    for leaf, per_rank in got.items():
        assert list(per_rank) == [want[leaf]] * len(per_rank), \
            (leaf, list(per_rank), want[leaf])
