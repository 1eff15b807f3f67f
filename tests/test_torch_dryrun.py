"""The dry run (``launch.dryrun``): fake against real, and its CLI.

Fake against real: for each family's reduced config, one train cell
(seq 32, batch 4; the dense one with ``grad_accum=2``), one prefill cell
(seq 32, batch 4) and one decode cell (a cache of 32, batch 4) at (data
2, model 2), and the dense config's three pipelined cells at (pod 2,
data 1, model 2), cut after layer 1 (training over 2 microbatches).
``measure`` runs each step once as rank 0 of a fake 4-rank group
inside ``FakeTensorMode`` in this process, and on real, zero-filled
tensors in four gloo ranks (``_torch_sharded_ranks.py``, meanwhile);
rank 0's collectives (count and bytes by kind, and for the pipelined
cells by kind and by crossing a pod or not), FLOPs
(``FlopCounterMode``) and ``MemTracker`` peak must be equal, and no
fake group may be left after each.  The hybrid's train cell is the one
where torch's rule for a CPU mesh would count an all-gather for the
card's all-to-all: ``measure`` counts the all-to-all.

The CLI: ``--arch whisper-small --shape decode_32k --mesh single``
writes a record with status ``ok`` on the full-size 16 x 16 mesh (256
fake ranks); a rerun prints ``[cached]``; ``long_500k`` on a
pure-attention arch is ``skipped`` with the reference's reason; ``--mesh
multi`` records the same cell on the 2 x 16 x 16 ``(pod, data, model)``
mesh (512 fake ranks, pod 0's stage) with status ``ok`` and collectives
crossing the pods, and ``--mesh both`` records both cells; in a sweep a
cell that runs past its time is recorded as failed and the sweep goes
on.
"""
import contextlib
import json
import os
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from _torch_sharded_fixture import run_ranks
from repro_torch import configs
from repro_torch.launch import dryrun as D
from repro_torch.launch.specs import ShapeSpec

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = {"dense": "qwen3-1.7b", "vlm": "phi-3-vision-4.2b",
            "moe": "qwen3-moe-30b-a3b", "ssm": "falcon-mamba-7b",
            "hybrid": "zamba2-7b", "encdec": "whisper-small"}
KINDS = {"train": (32, 4), "prefill": (32, 4), "decode": (32, 4)}
CASES = [f"{fam}-{kind}" for fam in FAMILIES for kind in KINDS]
# the pipelined cells: (pod 2, data 1, model 2), cut after layer 1
POD_MESH = (2, 1, 2)
POD_CASES = [f"pod-{kind}" for kind in KINDS]


def _pcfg(kind):
    from repro_torch.runtime.pipeline import PipelineConfig
    return PipelineConfig(2, 2 if kind == "train" else 1, (1,))


def _accum(case: str) -> int:
    return 2 if case == "dense-train" else 1


def _fake(arch, kind, accum, pcfg=None) -> dict:
    seq, batch = KINDS[kind]
    with D.fake_group(4):
        mesh = init_device_mesh("cpu", POD_MESH,
                                mesh_dim_names=("pod", "data", "model")) \
            if pcfg else init_device_mesh("cpu", (2, 2),
                                          mesh_dim_names=("data", "model"))
        got = D.measure(configs.reduced(arch),
                        ShapeSpec(kind, seq, batch, kind), mesh,
                        grad_accum=accum, pcfg=pcfg)
    summary = got["collectives"]
    return {"flops": got["flops"], "peak": got["memory"]["peak"],
            "coll": {k: {"count": d["count"], "bytes": d["bytes"]}
                     for k, d in summary.by_kind().items()},
            "pod": summary.by_kind_and_pod()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """→ ({case: the fake run's numbers}, {case: the real ranks'})."""
    tmp = tmp_path_factory.mktemp("dryrun")
    cases = [{"case": f"{fam}-{kind}", "kind": "dryrun", "arch": arch,
              "mesh": [2, 2], "shape": [kind, *KINDS[kind]],
              "accum": _accum(f"{fam}-{kind}")}
             for fam, arch in FAMILIES.items() for kind in KINDS]
    cases += [{"case": f"pod-{kind}", "kind": "dryrun",
               "arch": FAMILIES["dense"], "mesh": list(POD_MESH),
               "shape": [kind, *KINDS[kind]], "accum": 1,
               "pcfg": [2, _pcfg(kind).microbatches, [1]]} for kind in KINDS]
    with ThreadPoolExecutor(2) as pool:
        real = [pool.submit(run_ranks, cases[i::2], 4, tmp, f"dryrun{i}")
                for i in range(2)]
        fake = {}
        for case in CASES + POD_CASES:
            fam, kind = case.split("-")
            pcfg = _pcfg(kind) if fam == "pod" else None
            fake[case] = _fake(FAMILIES.get(fam, FAMILIES["dense"]), kind,
                               1 if pcfg else _accum(case), pcfg)
            fake[case]["left"] = dist.is_initialized()
        return fake, {k: v for r in real for k, v in r.result().items()}


def _counted(tree: dict) -> dict:
    return {k: {"count": int(d["count"]), "bytes": int(d["bytes"])}
            for k, d in tree.items()}


@pytest.mark.parametrize("case", CASES + POD_CASES)
def test_fake_step_counts_what_the_real_one_does(runs, case):
    got, want = runs[0][case], runs[1][case]
    assert not got["left"]
    assert got["flops"] == int(want["flops"]) > 0
    assert got["peak"] == int(want["peak"]) > 0
    assert got["coll"] == _counted(want["coll"]), case
    assert got["coll"], case
    if case in POD_CASES:
        pod = {f"{k}/{side}": d for k, sides in want["pod"].items()
               for side, d in sides.items()}
        assert got["pod"] == _counted(pod), case
        # the hops cross the pods; the model axis's collectives do not
        assert got["pod"]["collective-permute/crossing"]["count"] > 0, case
        assert not any(k.startswith("collective-permute/within")
                       for k in got["pod"]), case


def test_cpu_mesh_counts_the_cards_all_to_all(monkeypatch):
    """The cell and the op where DTensor's rule on a CPU mesh is not the
    card's: zamba2-7b's train step (the hybrid, reduced, at (data 2,
    model 2)) moves gradients of its Mamba-2 activations from a
    ``Shard`` of one dim to a ``Shard`` of another on the model dim.  On
    a CUDA mesh that is one ``_dtensor.shard_dim_alltoall``; torch's own
    rule on a CPU mesh is an all-gather of the whole dim and a chunk.
    Inside ``measure`` the CPU mesh takes the card's all-to-all
    (``card_redistribution``), so the inventory holds the all-to-alls
    where torch's CPU rule would count all-gathers of twice their
    bytes; nothing else moves."""
    card = _fake(FAMILIES["hybrid"], "train", 1)
    monkeypatch.setattr(D, "card_redistribution",
                        lambda mesh: contextlib.nullcontext())
    cpu = _fake(FAMILIES["hybrid"], "train", 1)
    a2a = card["coll"].pop("all-to-all")
    assert a2a["count"] > 0 and "all-to-all" not in cpu["coll"]
    gathered = cpu["coll"].pop("all-gather")
    assert gathered["count"] == card["coll"]["all-gather"]["count"] \
        + a2a["count"]
    assert gathered["bytes"] == card["coll"].pop("all-gather")["bytes"] \
        + 2 * a2a["bytes"]
    assert cpu["coll"] == card["coll"]
    assert (cpu["flops"], cpu["peak"]) == (card["flops"], card["peak"])


def _cli(*args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=cwd,
        capture_output=True, text=True, timeout=300)


def test_cli_records_a_cell_and_resumes(tmp_path):
    out = tmp_path / "runs"
    cell = ["--arch", "whisper-small", "--shape", "decode_32k", "--mesh",
            "single", "--out", str(out)]
    cp = _cli(*cell, cwd=tmp_path)
    assert cp.returncode == 0, cp.stdout + cp.stderr
    rec = json.loads((out / "whisper-small__decode_32k__single.json")
                     .read_text())
    assert rec["status"] == "ok", rec
    assert (rec["mesh"], rec["n_chips"], rec["kind"]) == ("16x16", 256,
                                                          "decode")
    assert rec["memory"]["peak_mb"] > rec["memory"]["args_mb"] > 0
    assert rec["collectives"] and rec["counted"]["flops_per_dev"] > 0
    assert rec["roofline"]["step_bound_s"] > 0
    again = _cli(*cell, cwd=tmp_path)
    assert again.returncode == 0
    assert "[cached] whisper-small__decode_32k__single: ok" in again.stdout
    skip = _cli("--arch", "qwen3-1.7b", "--shape", "long_500k", "--mesh",
                "single", "--out", str(out), cwd=tmp_path)
    assert skip.returncode == 0, skip.stderr
    rec = json.loads((out / "qwen3-1.7b__long_500k__single.json")
                     .read_text())
    assert rec["status"] == "skipped"
    assert rec["reason"].startswith("skip: pure full-attention arch")


@pytest.mark.parametrize("mesh", ["multi", "both"])
def test_cli_multi_pod_mesh_records_ok(tmp_path, mesh):
    out = tmp_path / "runs"
    cp = _cli("--arch", "whisper-small", "--shape", "decode_32k", "--mesh",
              mesh, "--out", str(out), cwd=tmp_path)
    assert cp.returncode == 0, cp.stdout + cp.stderr
    tags = {"multi": ["multi"], "both": ["multi", "single"]}[mesh]
    assert sorted(p.name for p in out.glob("*.json")) \
        == [f"whisper-small__decode_32k__{t}.json" for t in tags]
    rec = json.loads((out / "whisper-small__decode_32k__multi.json")
                     .read_text())
    assert rec["status"] == "ok", rec
    assert (rec["mesh"], rec["n_chips"], rec["kind"]) == ("2x16x16", 512,
                                                          "decode")
    assert rec["memory"]["peak_mb"] > rec["memory"]["args_mb"] > 0
    pod = rec["collectives_by_pod"]
    assert pod["collective-permute/crossing"]["bytes"] > 0
    assert rec["counted"]["wire_dcn_per_dev"] > 0
    assert rec["counted"]["wire_ici_per_dev"] > 0
    assert f"[ok     ] whisper-small__decode_32k__multi" in cp.stdout


def test_run_cell_leaves_no_process_group(monkeypatch):
    """A cell that fails inside its fake group (here the step itself) is
    recorded as failed, and the group is gone, on either mesh."""
    worlds = []

    def boom(*a, **k):
        assert dist.is_initialized()
        worlds.append(dist.get_world_size())
        raise RuntimeError("boom")
    monkeypatch.setattr(D, "measure", boom)
    for multi in (False, True):
        rec = D.run_cell("falcon-mamba-7b", "long_500k", multi)
        assert rec["status"] == "failed" and "boom" in rec["error"], rec
        assert rec["mesh"] == ("2x16x16" if multi else "16x16")
        assert not dist.is_initialized()
    assert worlds == [D.WORLD, D.MULTI_WORLD]


def test_sweep_records_a_timed_out_cell_and_goes_on(tmp_path, monkeypatch):
    """In a sweep each cell runs in a process of its own; one that runs
    past ``CELL_TIMEOUT_S`` is a failed cell, and the sweep goes on to
    the next."""
    calls = []

    def slow(cmd, **kw):
        calls.append(cmd[cmd.index("--shape") + 1])
        raise subprocess.TimeoutExpired(cmd, kw["timeout"])
    monkeypatch.setattr(subprocess, "run", slow)
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "qwen3-1.7b",
                                      "--mesh", "single", "--out",
                                      str(tmp_path)])
    assert D.main() == 1
    assert calls == ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    rec = json.loads((tmp_path / "qwen3-1.7b__train_4k__single.json")
                     .read_text())
    assert rec["status"] == "failed"
    assert rec["error"] == f"timed out after {D.CELL_TIMEOUT_S} s"
