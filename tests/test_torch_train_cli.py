"""The port's training launcher, ``python -m repro_torch.launch.train``,
as a user runs it on the CPU (mirrors the reference's drill in
``tests/test_system.py``): a run that crashes itself mid-way (exit 42)
and resumes from its last checkpoint logs the uninterrupted run's
losses bit for bit (the launcher prints nine significant digits, which
tell every fp32 value apart); the flags it refuses here name the
ROADMAP item they belong to; the default device, the card, raises
where there is none.  The data and model axes are in
``test_torch_train_ranks_cli.py``.
"""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu", "--steps",
        "12", "--batch", "2", "--seq", "32", "--ckpt-every", "4",
        "--log-every", "1", "--compress-grads"]


def _train(*args, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=timeout)


def _losses(out: str) -> dict[int, str]:
    return {int(m[1]): m[2] for m in
            re.finditer(r"^step +(\d+) loss (\S+)", out, re.M)}


def test_crash_restart_drill_is_bit_exact(tmp_path):
    whole = _train(*ARGS, "--ckpt-dir", str(tmp_path / "a"))
    assert whole.returncode == 0, whole.stdout + whole.stderr
    crashed = _train(*ARGS, "--ckpt-dir", str(tmp_path / "b"),
                     "--fail-at-step", "10")
    assert crashed.returncode == 42, crashed.stdout + crashed.stderr
    assert "[fault-injection] crashing at step 10" in crashed.stdout
    resumed = _train(*ARGS, "--ckpt-dir", str(tmp_path / "b"))
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr
    assert "[resume] step 8" in resumed.stdout
    assert "[done] 12 steps, final loss" in resumed.stdout
    ref, mine = _losses(whole.stdout), _losses(resumed.stdout)
    assert sorted(ref) == list(range(12)) and sorted(mine) == list(range(8, 12))
    assert {s: ref[s] for s in mine} == mine
    assert _losses(crashed.stdout) == {s: ref[s] for s in range(10)}
    # the drills' last checkpoints hold the same state
    last = sorted(p.name for p in (tmp_path / "a").glob("step_*"))
    assert last == sorted(p.name for p in (tmp_path / "b").glob("step_*"))
    for name in ("arrays.npz",):
        assert (tmp_path / "a" / last[-1] / name).read_bytes() \
            == (tmp_path / "b" / last[-1] / name).read_bytes()


@pytest.mark.parametrize("flags,item", [
    (["--pods", "2"], "item 12"),
    (["--microbatches", "8"], "item 12"),
    (["--auto-partition"], "item 10.5"),
])
def test_multi_device_flags_are_refused(flags, item):
    cp = _train(*ARGS, *flags)
    assert cp.returncode == 2, cp.stdout + cp.stderr
    assert item in cp.stderr and "step" not in cp.stdout


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    cp = _train("--arch", "qwen3-1.7b", "--reduced", "--steps", "1")
    assert cp.returncode != 0
    assert "CUDA is not available" in cp.stderr
