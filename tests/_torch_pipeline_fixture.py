"""Runs the JAX reference's pipelined steps once for a test module
(``tests/_torch_pipeline_ref.py`` in a subprocess with 8 forced host
devices: the reference's pipeline needs a mesh of several, and this
process's jax already has its one) and reads back its npz as nested
trees."""
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _env() -> dict:
    """The reference's environment: 8 forced host devices, and one hash
    seed, so that every run draws the same weights (its ``InitBuilder``
    hashes each leaf's path)."""
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=8",
                PYTHONHASHSEED="0")


def run_reference(mode: str, out_dir: pathlib.Path, *extra: str,
                  inputs=None, then=None, parts: int = 1) -> dict:
    """→ {case: tree} of the reference's ``mode`` run ("train" or
    "serve"), each leaf a numpy array, in ``parts`` processes that share
    its cases out (every ``parts``-th a process).  With ``inputs`` each
    process first writes its cases' weights and batches to
    ``inputs(i)``, and ``then()`` is called as soon as all are in (while
    the reference compiles its steps)."""
    procs, logs = [], []
    try:
        for i in range(parts):
            env = dict(_env(), REF_PART=f"{i}/{parts}")
            if inputs is not None:
                env["REF_INPUTS"] = str(inputs(i))
            logs.append(open(out_dir / f"{mode}.{i}.log", "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "tests" /
                                     "_torch_pipeline_ref.py"),
                 mode, str(out_dir / f"{mode}.{i}.npz"), *extra], env=env,
                stdout=logs[-1], stderr=subprocess.STDOUT))
        if inputs is not None:
            def waiting():
                return [i for i in range(parts) if not inputs(i).exists()]
            while waiting() and all(p.poll() is None for p in procs):
                time.sleep(0.1)
            if not waiting():
                then()
        for proc, log in zip(procs, logs):
            code = proc.wait(timeout=600)
            log.seek(0)
            assert code == 0, log.read()
    finally:
        for proc, log in zip(procs, logs):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    tree: dict = {}
    for i in range(parts):
        with np.load(out_dir / f"{mode}.{i}.npz") as z:
            for key in z.files:
                *parents, leaf = key.split("/")
                node = tree
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = z[key]
    return tree


def leaves(tree: dict, prefix: str = ""):
    """(path, leaf) of a nested tree, in key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# the train cases of ``_torch_pipeline_ref.py``: (case, arch, n_layers or
# None for the reduced depth, cuts or None for even ones), K = 2, M = 2
TRAIN_CASES = {
    "even": [(f"{arch}-even", arch, None, None)
             for arch in ("qwen3-1.7b", "phi-3-vision-4.2b",
                          "qwen3-moe-30b-a3b", "falcon-mamba-7b",
                          "zamba2-7b", "whisper-small")],
    "uneven": [("qwen3-1.7b-uneven", "qwen3-1.7b", 3, (1,)),
               ("phi-3-vision-4.2b-uneven", "phi-3-vision-4.2b", 3, (2,)),
               ("qwen3-moe-30b-a3b-uneven", "qwen3-moe-30b-a3b", 3, (1,)),
               ("falcon-mamba-7b-uneven", "falcon-mamba-7b", 3, (2,)),
               ("zamba2-7b-uneven", "zamba2-7b", 4, (1,)),
               ("whisper-small-uneven", "whisper-small", 3, (1,))]}
CE_TOL, GRAD_FRAC = 1e-5, 1e-4


def port_case(arch, depth, cuts, params):
    """The port's config, model (the reference's weights), pipeline
    config and CPU mesh of a train case, the stages placed."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.runtime import pipeline as PL
    cfg = configs.reduced(arch)
    if depth is not None:
        cfg = cfg.replace(n_layers=depth)
    pcfg = PL.PipelineConfig.even(cfg.n_layers, 2, 2) if cuts is None \
        else PL.PipelineConfig(2, 2, cuts)
    mesh = make_host_mesh(2, device="cpu")
    model = lm.from_reference(cfg, params, "cpu")
    PL.place_stages(cfg, model, pcfg, mesh)
    return cfg, model, pcfg, mesh


def gradients(m_tree, grad_norm, opt):
    """The gradients behind a first AdamW moment: m = (1 - b1) · g ·
    min(1, clip / (|g| + 1e-9))."""
    scale = min(1.0, opt.clip_norm / (float(grad_norm) + 1e-9))
    return {p: np.asarray(v, np.float64) / ((1 - opt.b1) * scale)
            for p, v in leaves(m_tree)}


def assert_matches_reference(metrics: dict, m_tree: dict, ref: dict,
                             opt) -> None:
    """A pipelined train step's metrics (floats) and first moment (in the
    reference's pipeline layout) against the reference's step: the CE
    within ``CE_TOL``, the gradient norm within 1e-4 relative, every
    gradient leaf (pad layers included) within ``GRAD_FRAC`` of its
    largest magnitude."""
    ce, rce = float(metrics["ce"]), float(ref["metrics"]["ce"])
    assert abs(ce - rce) <= CE_TOL, (ce, rce)
    gn, rgn = float(metrics["grad_norm"]), float(ref["metrics"]["grad_norm"])
    assert abs(gn - rgn) <= 1e-4 * rgn, (gn, rgn)
    got = gradients(m_tree, gn, opt)
    want = gradients(ref["m"], rgn, opt)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        big = np.abs(w).max()
        if big == 0:
            assert not got[path].any(), path
        else:
            err = np.abs(got[path] - w).max()
            assert err <= GRAD_FRAC * big, (path, err, big)


def check_train_case(ref, arch, depth, cuts):
    """One pipelined train step of the port against the reference's
    (``assert_matches_reference``), and its CE that of the port's
    unpipelined loss (the MoE's without its aux term)."""
    import torch
    from repro_torch.optim import OptConfig
    from repro_torch.runtime import steps
    from repro_torch.runtime.pipeline import make_pipeline_train_step
    if cuts is not None:
        assert tuple(ref["cuts"]) == cuts
    cfg, model, pcfg, mesh = port_case(arch, depth, cuts, ref["params"])
    batch = {k: torch.from_numpy(np.array(v)) for k, v in ref["batch"].items()}
    with torch.no_grad():
        plain_ce = steps.loss_fn(cfg, model, batch)[1]["ce"].item()
    opt = OptConfig(lr=1e-3)
    state, metrics = make_pipeline_train_step(cfg, pcfg, opt, mesh)(
        steps.train_state(model), batch)
    ce = metrics["ce"].item()
    assert abs(ce - plain_ce) <= CE_TOL, (ce, plain_ce)
    assert metrics["loss"].item() == ce
    assert_matches_reference({k: v.item() for k, v in metrics.items()},
                             steps.reference_state(state, pcfg)["opt"]["m"],
                             ref, opt)
