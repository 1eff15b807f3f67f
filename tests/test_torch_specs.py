"""The dry run's specs and the jax-free copies of ``launch/`` held to the
JAX reference.

Specs at full size: for all 40 single-pod cells (10 archs × 4 shapes)
on the 16 x 16 ``(data, model)`` mesh, ``cell_supported`` gives the
reference's answer, and every leaf of the port's
``launch.specs.input_specs`` has the shape, dtype and PartitionSpec of
the reference's leaf (``_torch_specs_ref.py``, in a subprocess with 256
forced host devices and an ``Auto`` mesh): the port's per-block
parameters stacked on the reference's ``layers`` axis (unsplit), its
moments (keyed by parameter name) gathered into the reference's
leaves.  A moment whose reference leaf puts ``data`` on that ``layers``
axis (ZeRO-1's first divisible dim, for a depth that divides 16) has no
per-block counterpart; there each rank must hold the reference
device's bytes of it (``runtime.steps.zero1_placements``' rule).  The
pipelined specs on the 2 x 16 x 16 ``(pod, data, model)`` mesh, for one
arch of each family: the union over the two pods of each pod's stage
(``input_specs(..., pcfg, pod)``), its blocks and cache leaves stacked
in the reference's (K, l_max, ...) layout with ``pod`` on the stage
dim, is the reference's pipelined ``input_specs``, the moments by the
same rule.

The copies: ``roofline.model_flops`` equal for every arch × shape,
``roofline_from`` the reference's terms with the H100's constants in
place of the TPU's, ``hlo_analysis._wire_bytes`` and ``by_kind`` equal
on one list of ops, and ``report``'s three tables the same text for the
same manifest dicts.
"""
import json
import math
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import repro.configs as RC
import repro.launch.hlo_analysis as RH
import repro.launch.report as RR
import repro.launch.roofline as RRL
import repro.launch.specs as RS
from repro_torch import configs
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import report as R
from repro_torch.launch import roofline as RL
from repro_torch.launch import specs as SP
from repro_torch.models.common import LeafSpec, named_leaves
from repro_torch.models.lm import STACKS
from repro_torch.optim.adamw import reference_leaf
from repro_torch.runtime.pipeline import n_attn_slots
from repro_torch.sharding import api as S

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH = {"data": 16, "model": 16}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("specs") / "ref.json"
    cp = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_specs_ref.py"),
         str(out)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=512"),
        capture_output=True, text=True, timeout=300)
    assert cp.returncode == 0, cp.stderr
    return json.loads(out.read_text())


def _ctx():
    return S.MeshContext(SimpleNamespace(axis_names=tuple(MESH),
                                         devices=np.empty((16, 16), object)))


def _entry(e):
    return None if e is None else e if isinstance(e, str) else list(e)


def _split(spec) -> int:
    n = 1
    for e in spec:
        for a in ([] if e is None else [e] if isinstance(e, str) else e):
            n *= {**MESH, "pod": 2}[a]
    return n


def _dtype(t) -> str:
    return str(t).replace("torch.", "")


def port_leaves(cfg, shape: str, cell: dict | None = None) -> dict:
    """{reference path: (shape, dtype, spec, bytes a rank)} of the port's
    ``input_specs`` (or of ``cell``, a tree of them): stacked trees
    stacked, moments gathered by their reference leaf."""
    if cell is None:
        cell = SP.input_specs(cfg, shape, _ctx())
    out: dict = {}

    def put(path, shp, dtype, spec, per_rank):
        out[path] = (list(shp), _dtype(dtype), [_entry(e) for e in spec],
                     per_rank)

    def leaf(path, s):
        put(path, s.shape, s.dtype, s.spec or (None,) * len(s.shape),
            s.nbytes // _split(s.spec or ()))

    def stacked(path, blocks):
        specs = {tuple(b.spec) for b in blocks}
        spec = (None, *specs.pop()) if len(specs) == 1 else None
        put(path, (len(blocks), *blocks[0].shape), blocks[0].dtype,
            spec or (None,) * (len(blocks[0].shape) + 1),
            sum(b.nbytes // _split(b.spec) for b in blocks))
        if spec is None:        # the blocks differ: no one stacked spec
            out[path] = (*out[path][:2], None, out[path][3])

    def params(prefix, tree):
        for key, node in tree.items():
            if key in STACKS:
                for sub, _ in named_leaves(node[0]):
                    stacked(f"{prefix}/{key}/{sub.replace('.', '/')}",
                            [dict(named_leaves(b))[sub] for b in node])
            elif isinstance(node, dict):
                params(f"{prefix}/{key}", node)
            else:
                leaf(f"{prefix}/{key}", node)

    def moments(prefix, flat):
        groups: dict = {}
        for name, s in flat.items():
            ref, is_stacked = reference_leaf(name)
            groups.setdefault((ref, is_stacked), []).append(s)
        for (ref, is_stacked), blocks in groups.items():
            path = f"{prefix}/{ref.replace('.', '/')}"
            if is_stacked:
                stacked(path, blocks)
            else:
                leaf(path, blocks[0])

    def walk(prefix, node):
        for key, v in node.items():
            p = f"{prefix}/{key}" if prefix else key
            if key == "params":
                params(p, v)
            elif key in ("m", "v") and prefix.endswith("opt"):
                moments(p, v)
            elif isinstance(v, dict):
                walk(p, v)
            else:
                leaf(p, v)
    walk("", cell)
    return out


def test_cell_supported_matches_reference(reference):
    for arch in configs.ARCH_NAMES:
        for shape in SP.SHAPES:
            ok, why = SP.cell_supported(configs.get(arch), shape)
            want = reference[f"{arch}/{shape}"]
            assert (ok, why) == (want["supported"], want["reason"]), \
                (arch, shape)
    assert len([k for k in reference if not k.startswith("pipelined/")]) \
        == 40
    assert SP.SHAPES == {k: SP.ShapeSpec(*v.__dict__.values())
                         for k, v in RS.SHAPES.items()}


@pytest.mark.parametrize("arch", list(configs.ARCH_NAMES))
def test_input_specs_match_reference(reference, arch):
    cfg = configs.get(arch)
    for shape in SP.SHAPES:
        want = reference[f"{arch}/{shape}"]
        if not want["supported"]:
            continue
        got = port_leaves(cfg, shape)
        assert sorted(got) == sorted(want["leaves"]), (arch, shape)
        for path, (shp, dtype, spec) in want["leaves"].items():
            gshp, gdtype, gspec, per_rank = got[path]
            assert (gshp, gdtype) == (shp, dtype), (arch, shape, path)
            moment = path.split("/")[1:2] == ["opt"] and \
                path.split("/")[2] in ("m", "v")
            if moment and spec and spec[0] is not None:
                # ZeRO-1 on the reference's layers axis: the same bytes
                assert per_rank == math.prod(shp) * 4 // _split(spec), \
                    (arch, shape, path)
            else:
                assert gspec == spec, (arch, shape, path, gspec, spec)


def _pod_ctx():
    return S.MeshContext(SimpleNamespace(
        axis_names=("pod", *MESH), devices=np.empty((2, 16, 16), object)))


def pipelined_leaves(cfg, shape: str, pcfg) -> dict:
    """``port_leaves`` of the union of the two pods' stages: each pod's
    own blocks and cache leaves laid end to end, zero-padded to l_max a
    pod, on a (K, l_max, ...) stack whose stage dim is ``pod``."""
    _, counts, l_max = pcfg.layout(cfg.n_layers)
    cells = [SP.input_specs(cfg, shape, _pod_ctx(), pcfg, pod=k)
             for k in range(2)]
    key = "dec_layers" if cfg.family == "encdec" else "layers"

    def union(tree, other):
        """pod 0's tree with the stack's blocks of pod 1 in its gaps, and
        its stage cache stacked on a leading stage dim."""
        out = {}
        for name, v in tree.items():
            if name == key:
                out[name] = [a or b for a, b in zip(v, other[name])]
            elif name == "stage":
                out.update(stage_cache(v, other["stage"]))
            elif isinstance(v, dict) and name not in ("m", "v"):
                out[name] = union(v, other[name])
            elif name in ("m", "v"):
                out[name] = {**v, **other[name]}
            else:
                out[name] = v
        return out

    def stage_cache(a, b):
        out = {}
        for name, leaf in a.items():
            rows = n_attn_slots(cfg, l_max) if name in ("ak", "av") \
                else l_max
            spec = ("pod", *(leaf.spec or (None,) * len(leaf.shape)))
            out[name] = LeafSpec((2, rows, *leaf.shape[1:]), leaf.dtype,
                                 spec)
            assert b[name].spec == leaf.spec, name
        return out
    got = port_leaves(cfg, shape, union(*cells))
    # the stacks: (K, l_max, ...) with the stage on ``pod``
    for path, (shp, dtype, spec, per_rank) in list(got.items()):
        parts = path.split("/")
        if key in parts and shp[0] == cfg.n_layers:
            got[path] = ([2, int(l_max), *shp[1:]], dtype,
                         None if spec is None else ["pod", *spec],
                         per_rank)
    return got


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "phi-3-vision-4.2b",
                                  "qwen3-moe-30b-a3b", "falcon-mamba-7b",
                                  "zamba2-7b", "whisper-small"])
def test_pipelined_specs_match_reference(reference, arch):
    from repro_torch.runtime.pipeline import PipelineConfig
    cfg = configs.get(arch)
    for shape, sh in SP.SHAPES.items():
        want = reference[f"pipelined/{arch}/{shape}"]
        if not want["supported"]:
            continue
        pcfg = PipelineConfig.even(cfg.n_layers, 2,
                                   8 if sh.kind == "train" else 1)
        got = pipelined_leaves(cfg, shape, pcfg)
        assert sorted(got) == sorted(want["leaves"]), (arch, shape)
        for path, (shp, dtype, spec) in want["leaves"].items():
            gshp, gdtype, gspec, per_rank = got[path]
            assert (gshp, gdtype) == (shp, dtype), (arch, shape, path)
            moment = path.split("/")[1:2] == ["opt"] and \
                path.split("/")[2] in ("m", "v")
            if moment and spec and spec[0] == "pod" and spec[1] is not None:
                # ZeRO-1 on the reference's layers axis: a rank of each pod
                # (l_max layers here) holds the reference device's bytes
                assert per_rank == 2 * (math.prod(shp) * 4 // _split(spec)), \
                    (arch, shape, path)
            elif not moment or gspec is not None:
                assert gspec == spec, (arch, shape, path, gspec, spec)


def test_model_flops_match_reference():
    for arch in configs.ARCH_NAMES:
        for name, shape in SP.SHAPES.items():
            assert RL.model_flops(configs.get(arch), shape) == \
                RRL.model_flops(RC.get(arch), RS.SHAPES[name])


def test_roofline_is_the_reference_formula_with_h100_peaks(monkeypatch):
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.ICI_BW, RL.DCN_BW) == \
        (989e12, 3.35e12, 450e9, 50e9)
    for name, value in (("PEAK_FLOPS", RL.PEAK_FLOPS), ("HBM_BW", RL.HBM_BW),
                        ("ICI_BW", RL.ICI_BW), ("DCN_BW", RL.DCN_BW)):
        monkeypatch.setattr(RRL, name, value)
    for args in ((3.1e15, 2.2e11, 4.5e9, 0.0, 6e17, 256),
                 (1e12, 8e12, 1e8, 2e8, 1e15, 4), (0.0, 0.0, 0.0, 0.0, 0, 1)):
        got, want = RL.roofline_from(*args), RRL.roofline_from(*args)
        assert got == RL.Roofline(**want.__dict__)
        for prop in ("dominant", "step_time_s", "useful_ratio", "mfu_bound"):
            assert getattr(got, prop) == getattr(want, prop), prop


def test_wire_bytes_and_by_kind_match_reference():
    ops = [(k, rb, s, c) for k in H.COLLECTIVES
           for rb, s, c in ((1 << 20, 16, False), (3000, 2, True),
                            (12345, 1, False), (8, 256, False))]
    for kind, rb, s, _ in ops:
        assert H._wire_bytes(kind, rb, s) == RH._wire_bytes(kind, rb, s)
    got = H.CollectiveSummary([H.CollectiveOp(k, rb, s, c,
                                              H._wire_bytes(k, rb, s))
                               for k, rb, s, c in ops])
    want = RH.CollectiveSummary([RH.CollectiveOp(k, rb, s, c,
                                                 RH._wire_bytes(k, rb, s))
                                 for k, rb, s, c in ops])
    assert got.by_kind() == want.by_kind()
    assert (got.total_bytes, got.wire_bytes_ici, got.wire_bytes_dcn) == \
        (want.total_bytes, want.wire_bytes_ici, want.wire_bytes_dcn)


def test_report_tables_match_reference():
    def ok(arch, shape, mesh, peak, bound, scale):
        return {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
                "compile_s": 12.5 * scale, "memory": {"peak_mb": peak},
                "collectives": {"all-gather": {"count": 34, "bytes": 1,
                                               "wire": 1},
                                "all-reduce": {"count": 5, "bytes": 2,
                                               "wire": 3}},
                "roofline": {"compute_s": 0.004 * scale, "memory_s": 12.0,
                             "collective_s": 0.2, "dominant": "memory",
                             "step_bound_s": bound, "mfu_bound": 0.37,
                             "useful_ratio": 0.91}}
    cur = {("a", "train_4k", "16x16"): ok("a", "train_4k", "16x16", 4200.0,
                                          0.28, 1),
           ("a", "long_500k", "16x16"): {"arch": "a", "shape": "long_500k",
                                         "mesh": "16x16", "status": "skipped",
                                         "reason": "skip: pure attention"},
           ("b", "decode_32k", "16x16"): {"status": "failed",
                                          "error": "RuntimeError: boom"},
           ("b", "prefill_32k", "16x16"): ok("b", "prefill_32k", "16x16",
                                             900.0, 11.0, 2)}
    base = {("a", "train_4k", "16x16"): ok("a", "train_4k", "16x16", 6100.0,
                                           0.31, 1)}
    assert R.dryrun_table(cur) == RR.dryrun_table(cur)
    assert R.roofline_table(cur) == RR.roofline_table(cur)
    assert R.perf_compare(base, cur) == RR.perf_compare(base, cur)
    assert R.fmt_s(0.0123) == RR.fmt_s(0.0123)
