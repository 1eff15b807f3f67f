"""The port's training launcher on the data and model axes, as a user
runs it on the CPU: ``python -m repro_torch.launch.train --data-par 2
--model-par 2`` starts four gloo ranks of itself and rank 0 alone
prints the loss lines; the crash drill at (2, 2) exits 42 and the rerun
resumes bit for bit (nine significant digits tell every fp32 value
apart; the last checkpoints are the same bytes); a checkpoint written at
(2, 2) resumes on one device with the same losses within 1e-5 relative,
and loads in the reference's ``load_checkpoint`` with every leaf equal
to the port's; asking for more ranks than cards exits 2.  The
uninterrupted and the crashed run go at once, then the two resumes.
"""
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as reference_load
from repro_torch.checkpoint import load_checkpoint

ROOT = pathlib.Path(__file__).resolve().parents[1]
ONE = ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu", "--steps", "16",
       "--batch", "4", "--seq", "32", "--ckpt-every", "5", "--log-every", "1"]
RANKS = [*ONE, "--data-par", "2", "--model-par", "2"]


def _start(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *args], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _done(p, timeout=240):
    out, err = p.communicate(timeout=timeout)
    return subprocess.CompletedProcess(p.args, p.returncode, out, err)


def _losses(out: str) -> dict[int, str]:
    return {int(m[1]): m[2] for m in
            re.finditer(r"^step +(\d+) loss (\S+)", out, re.M)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks_cli")
    whole = _start(*RANKS, "--ckpt-dir", str(tmp / "a"))
    crashed = _start(*RANKS, "--ckpt-dir", str(tmp / "b"), "--fail-at-step",
                     "9")
    out = {"whole": _done(whole), "crashed": _done(crashed)}
    shutil.copytree(tmp / "b", tmp / "c")
    resumed = _start(*RANKS, "--ckpt-dir", str(tmp / "b"))
    one = _start(*ONE, "--ckpt-dir", str(tmp / "c"))
    out.update(resumed=_done(resumed), one_device=_done(one), dir=tmp)
    return out


def test_ranks_train_and_rank_zero_prints(runs):
    cp = runs["whole"]
    assert cp.returncode == 0, cp.stdout + cp.stderr
    assert sorted(_losses(cp.stdout)) == list(range(16))
    assert len(re.findall(r"^step +0 loss", cp.stdout, re.M)) == 1
    assert cp.stdout.count("[done] 16 steps, final loss") == 1


def test_crash_drill_on_ranks_resumes_bit_for_bit(runs):
    crashed, resumed = runs["crashed"], runs["resumed"]
    assert crashed.returncode == 42, crashed.stdout + crashed.stderr
    assert crashed.stdout.count("[fault-injection] crashing at step 9") == 1
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr
    assert "[resume] step 5" in resumed.stdout
    ref, mine = _losses(runs["whole"].stdout), _losses(resumed.stdout)
    assert sorted(mine) == list(range(5, 16))
    assert {s: ref[s] for s in mine} == mine
    assert _losses(crashed.stdout) == {s: ref[s] for s in range(9)}
    tmp = runs["dir"]
    last = sorted(p.name for p in (tmp / "a").glob("step_*"))
    assert last == sorted(p.name for p in (tmp / "b").glob("step_*"))
    assert (tmp / "a" / last[-1] / "arrays.npz").read_bytes() \
        == (tmp / "b" / last[-1] / "arrays.npz").read_bytes()


def test_ranks_checkpoint_resumes_on_one_device(runs):
    cp = runs["one_device"]
    assert cp.returncode == 0, cp.stdout + cp.stderr
    assert "[resume] step 5" in cp.stdout
    ref, mine = _losses(runs["whole"].stdout), _losses(cp.stdout)
    assert sorted(mine) == list(range(5, 16))
    for s, loss in mine.items():
        assert abs(float(loss) - float(ref[s])) <= 1e-5 * abs(float(ref[s]))


def test_ranks_checkpoint_loads_in_the_reference(runs):
    path = sorted((runs["dir"] / "a").glob("step_*"))[-1]
    ref, ref_manifest = reference_load(path)
    mine, manifest = load_checkpoint(path)
    assert ref_manifest["step"] == manifest["step"] == 16

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v
    got = dict(flat(mine))
    want = dict(flat(ref))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w),
                                      err_msg=k)


def test_more_ranks_than_cards_exits_2():
    if torch.cuda.device_count() >= 4:
        pytest.skip("four cards: the ranks would run")
    cp = _done(_start("--arch", "qwen3-1.7b", "--reduced", "--device", "cuda",
                      "--data-par", "2", "--model-par", "2", "--steps", "1"),
               timeout=120)
    assert cp.returncode == 2, cp.stdout + cp.stderr
    assert "4 ranks need 4 cards" in cp.stderr and "step" not in cp.stdout
