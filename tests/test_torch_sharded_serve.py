"""Sharded prefill and decode on the ``(data, model)`` mesh — four gloo
ranks, DTensor, the kernels on each rank's shards — against the JAX
reference's sharded serving steps on the same mesh shape
(``AxisType.Auto`` axes, 4 forced host devices, in a subprocess:
``_torch_sharded_ref.py``) and against the port's one-process serve,
all on the reference's weights (``PRNGKey(0)``) and prompt: every
family's reduced fp32 config at (2, 2), and reduced qwen3-1.7b at (1,
4), where ``model`` does not divide its 2 kv heads and the cache splits
along its sequence (``kv_cache_names``' ``seq_model``).  Batch 4, prompt
16 (8 image patches and 8 tokens for the vlm), a cache of 24, a
prefill and two greedy decode steps, through
``runtime.steps.make_prefill_step`` and ``make_decode_step`` made under
``use_mesh_context``; both routes, ``"pallas"`` (the kernels' plain
versions on the CPU, called on the local shards) and ``"xla"`` (the
plain route, the yardstick).  Every step's logits within 1e-4 of their
largest magnitude and the tokens equal; the prefill cache laid out as
the reference lays it out: the self-attention k/v by
``kv_cache_names`` (the reference's own ``shard``), every other leaf by
the axes of the reference's ``launch/specs.py:cache_specs``.  The
ranks and the reference (in two processes) run at once.
"""
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
import json

import numpy as np
import pytest

import _torch_sharded_ref as REF
from _torch_sharded_fixture import run_ranks, run_reference
from repro_torch.sharding import api as S

FAMILIES = {"dense": "qwen3-1.7b", "vlm": "phi-3-vision-4.2b",
            "moe": "qwen3-moe-30b-a3b", "ssm": "falcon-mamba-7b",
            "hybrid": "zamba2-7b", "encdec": "whisper-small"}
CASES = {**{f"{fam}-2x2": (arch, (2, 2)) for fam, arch in FAMILIES.items()},
         "dense-1x4": ("qwen3-1.7b", (1, 4))}
IMPLS = ("pallas", "xla")
BATCH, PROMPT, CACHE, DECODE = 4, 16, 24, 2
LOGIT_FRAC = 1e-4


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_serve")
    for arch in set(FAMILIES.values()):
        REF.weights(tmp / f"{arch}.npz", arch, BATCH, PROMPT)

    def case(name, arch, mesh, **kw):
        return {"case": name, "kind": "serve", "arch": arch,
                "mesh": list(mesh), "weights": str(tmp / f"{arch}.npz"),
                "cache": CACHE, "decode": DECODE, **kw}
    ref_cases = [case(name, *am) for name, am in CASES.items()]
    port_cases = [case(f"{name}-{impl}", *am, impl=impl, plain=True)
                  for name, am in CASES.items() for impl in IMPLS]
    with ThreadPoolExecutor(3) as pool:
        refs = [pool.submit(run_reference, ref_cases[i::2], tmp,
                            f"reference{i}") for i in range(2)]
        port = pool.submit(run_ranks, port_cases, 4, tmp, "serve")
        return {k: v for r in refs for k, v in r.result().items()}, \
            port.result()


def _close(got: dict, want: dict, what: str) -> None:
    assert sorted(got) == sorted(want), what
    for i in sorted(want, key=int):
        a, b = got[i], want[i]
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        diff = float(np.abs(a - b).max())
        assert diff <= LOGIT_FRAC * float(np.abs(b).max()), (what, i, diff)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_serve_matches_reference(results, case, impl):
    ref, port = results[0][case], results[1][f"{case}-{impl}"]
    np.testing.assert_array_equal(port["tokens"], ref["tokens"])
    _close(port["logits"], ref["logits"], case)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_serve_matches_one_process(results, case, impl):
    port = results[1][f"{case}-{impl}"]
    np.testing.assert_array_equal(port["tokens"], port["plain"]["tokens"])
    _close(port["logits"], port["plain"]["logits"], case)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_cache_layout_is_the_reference_one(results, case):
    """Each prefill cache leaf's placements: k/v those of the reference's
    output sharding and of ``kv_cache_names``; the rest those of
    ``cache_specs``' axes."""
    ref = results[0][case]
    shape = CASES[case][1]
    ctx = S.MeshContext(SimpleNamespace(axis_names=("data", "model"),
                                        devices=np.empty(shape, object)))
    for impl in IMPLS:
        port = results[1][f"{case}-{impl}"]
        assert sorted(port["placements"]) == sorted(
            k for k in ref["spec"] if k != "pos"), case
        for leaf, got in port["placements"].items():
            got = str(got)
            assert got == str(port["names"][leaf]), (case, leaf)
            spec = tuple(json.loads(str(ref["spec"][leaf])))
            assert got == str(ctx.placements_of(spec)), (case, leaf)
            if leaf in ("k", "v"):
                out = tuple(json.loads(str(ref["out_spec"][leaf])))
                assert got == str(ctx.placements_of(out)), (case, leaf)
    if case == "dense-1x4":      # the sequence split: seq_model
        assert str(port["placements"]["k"]) == "(Replicate(), Shard(dim=2))"
