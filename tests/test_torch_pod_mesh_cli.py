"""The launchers on the ranks' ``(pod, data, model)`` mesh, as a user
runs them on the CPU.

``python -m repro_torch.launch.train --reduced --device cpu --pods 2
--data-par 2 --model-par 1`` starts four gloo ranks; rank 0 alone
prints and writes the checkpoints, which hold the reference's pipelined
layout (K, l_max, ...).  Restored in one process (``--pods 2`` on the
CPU) every leaf comes back ``torch.equal``, and the one-process command
resumes from it; the ranks' losses and the resumed ones are the
uninterrupted one-process run's within 1e-5.
``launch.serve --pods 2 --data-par 1 --model-par 2`` in four ranks gives
the one-process pipelined serve's tokens.
"""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

from _torch_pipeline_fixture import leaves
from _torch_sharded_fixture import run_ranks
from repro_torch import configs
from repro_torch.checkpoint import load_checkpoint
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.runtime import steps
from repro_torch.runtime.pipeline import PipelineConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu", "--batch",
        "4", "--seq", "32", "--log-every", "1", "--pods", "2",
        "--microbatches", "2", "--auto-partition", "--ckpt-every", "3",
        "--steps", "5"]
SERVE = ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu", "--batch",
         "4", "--prompt-len", "16", "--new-tokens", "4", "--pods", "2",
         "--auto-partition"]


def _train(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=180)


def _losses(out: str) -> dict[int, float]:
    return {int(m[1]): float(m[2]) for m in
            re.finditer(r"^step +(\d+) loss (\S+)", out, re.M)}


def test_pod_mesh_checkpoint_resumes_in_one_process(tmp_path):
    ckpt = tmp_path / "ckpt"
    # the ranks' run dies at step 4, after its checkpoint of step 3
    ranks = _train(*ARGS, "--data-par", "2", "--ckpt-dir", str(ckpt),
                   "--fail-at-step", "4")
    assert ranks.returncode == 42, ranks.stdout + ranks.stderr
    assert ranks.stdout.count("[paretopipe] cuts=(1,)") == 1
    tree, manifest = load_checkpoint(ckpt / "step_00000003")
    assert manifest["step"] == 3
    cfg = configs.reduced("qwen3-1.7b").replace(attn_impl="xla")
    pcfg = PipelineConfig(2, 2, (1,))
    l_max = pcfg.layout(cfg.n_layers)[2]
    for part in (tree["params"], tree["opt"]["m"], tree["opt"]["v"]):
        assert part["layers"]["attn"]["wq"].shape[:2] == (2, l_max)
    # restored in one process, every leaf as the ranks wrote it
    state = steps.state_from_reference(cfg, tree, "cpu", pcfg,
                                       make_host_mesh(2, device="cpu"))
    again = dict(leaves(steps.reference_state(state, pcfg)))
    for path, leaf in leaves(tree):
        assert torch.equal(torch.as_tensor(np.asarray(again[path])),
                           torch.as_tensor(np.asarray(leaf))), path
    # the one-process command resumes there, and steps as it would have
    resumed = _train(*ARGS, "--ckpt-dir", str(ckpt))
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr
    assert "[resume] step 3" in resumed.stdout
    whole = _train(*ARGS)
    assert whole.returncode == 0, whole.stdout + whole.stderr
    ref = _losses(whole.stdout)
    got = {**_losses(ranks.stdout), **_losses(resumed.stdout)}
    assert sorted(got) == sorted(ref) == list(range(5))
    for step, loss in ref.items():
        assert abs(got[step] - loss) <= 1e-5 * loss, (step, got, ref)


def test_pod_mesh_serve_gives_the_one_process_tokens(tmp_path):
    want = serve.main(SERVE)["tokens"]
    got = run_ranks([{"case": "cli", "kind": "cli-serve",
                      "argv": SERVE + ["--model-par", "2"]}], 4, tmp_path,
                    "serve")["cli"]["tokens"]
    assert want.shape == (4, 4)
    np.testing.assert_array_equal(got, want.numpy())
