"""The port's launchers through the pod pipeline, as a user runs them on
the CPU: ``python -m repro_torch.launch.train --pods 2 --microbatches 2
--auto-partition`` prints the reference launcher's ``[paretopipe]`` line
(its cuts and the planner's predictions for a card a stage, from the
reference's own solver on the card's chain here), trains, and a run that crashes itself resumes from its
pipelined checkpoint with the uninterrupted run's losses bit for bit;
with ``--data-par 2`` or ``--model-par 2`` the same command runs four
gloo ranks on the ``(pod, data, model)`` mesh, rank 0 alone printing,
its first loss the one-process run's; gradient compression under
``--pods`` is refused.  ``launch.serve --pods`` serves the unpipelined
tokens.
"""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro import configs as RCFG
from repro_torch.launch import serve
from test_torch_card_planning import paretopipe_line, reference_card_plan

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu", "--steps",
        "16", "--batch", "2", "--seq", "32", "--ckpt-every", "5",
        "--log-every", "1", "--pods", "2", "--microbatches", "2",
        "--auto-partition"]


def _train(*args, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=timeout)


def _losses(out: str) -> dict[int, str]:
    return {int(m[1]): m[2] for m in
            re.finditer(r"^step +(\d+) loss (\S+)", out, re.M)}


def test_pipelined_crash_restart_drill_is_bit_exact(tmp_path):
    whole = _train(*ARGS, "--ckpt-dir", str(tmp_path / "a"))
    assert whole.returncode == 0, whole.stdout + whole.stderr
    line = paretopipe_line(*reference_card_plan(RCFG.reduced("qwen3-1.7b"),
                                                32, 2, batch=2))
    assert whole.stdout.splitlines()[0] == line
    crashed = _train(*ARGS, "--ckpt-dir", str(tmp_path / "b"),
                     "--fail-at-step", "9")
    assert crashed.returncode == 42, crashed.stdout + crashed.stderr
    resumed = _train(*ARGS, "--ckpt-dir", str(tmp_path / "b"))
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr
    assert "[resume] step 5" in resumed.stdout
    assert "[done] 16 steps, final loss" in resumed.stdout
    ref, mine = _losses(whole.stdout), _losses(resumed.stdout)
    assert sorted(ref) == list(range(16)) and sorted(mine) == list(range(5, 16))
    assert {s: ref[s] for s in mine} == mine
    last = sorted(p.name for p in (tmp_path / "a").glob("step_*"))
    assert (tmp_path / "a" / last[-1] / "arrays.npz").read_bytes() \
        == (tmp_path / "b" / last[-1] / "arrays.npz").read_bytes()


@pytest.mark.parametrize("flags", [["--data-par", "2"],
                                   ["--model-par", "2"]])
def test_pipeline_runs_on_the_pod_mesh(flags):
    short = ["--steps", "2", "--batch", "4"]
    one = _train(*ARGS, *short)
    ranks = _train(*ARGS, *short, *flags)
    assert ranks.returncode == 0, ranks.stdout + ranks.stderr
    assert ranks.stdout.count("[paretopipe] cuts=(1,)") == 1
    assert ranks.stdout.count("[done] 2 steps") == 1
    got, want = _losses(ranks.stdout), _losses(one.stdout)
    assert sorted(got) == sorted(want) == [0, 1]
    assert abs(float(got[0]) - float(want[0])) <= 1e-5 * float(want[0])


def test_pipeline_refuses_what_it_does_not_run():
    cp = _train(*ARGS, "--compress-grads")
    assert cp.returncode == 2, cp.stdout + cp.stderr
    assert "--compress-grads with --pods 2" in cp.stderr
    assert "step" not in cp.stdout


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-7b"])
def test_pipelined_serve_launcher_gives_the_unpipelined_tokens(arch, capsys):
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "16", "--new-tokens", "4"]
    plain = serve.main(argv)
    piped = serve.main(argv + ["--pods", "2", "--auto-partition"])
    assert plain["cuts"] is None and piped["cuts"] == (1,)
    assert torch.equal(plain["tokens"], piped["tokens"])
    assert "[paretopipe] cuts=(1,)" in capsys.readouterr().out
