"""The launch expectations ``chip_smoke.py`` holds the card's serves to,
against what the serving path calls on the CPU.

For every dense, vlm and moe arch of the registry at reduced size,
``launch.serve.main`` runs on the CPU with spies on
``ops.flash_attention``, ``ops.decode_attention`` and
``ops.fused_rmsnorm`` (the wrappers that launch a kernel on the card,
here their plain versions).  Their calls, and the row shapes RMSNorm is
handed, must be what ``chip_smoke.lm_expect`` and
``chip_smoke.rms_shapes`` say the path launches: 2 norms a layer, 2 more
with qk-norm; a vlm's prompt holds its image patches, as the reference's
synthetic batch does.  At full size the expectations of the paths the
card serves are pinned: qwen3-1.7b's and qwen3-moe-30b-a3b's as phases 7
and 15 have held them, and those of the four archs of phase 37.
"""
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

ARCHS = [a for a in configs.ARCH_NAMES
         if configs.get(a).family in ("dense", "vlm", "moe")]
B, S, NEW = 2, 16, 3
KERNELS = ("flash_attention", "decode_attention", "fused_rmsnorm")


def _rows(x: torch.Tensor) -> tuple[int, int]:
    return (x.numel() // x.shape[-1], x.shape[-1])


@pytest.fixture
def spied(monkeypatch):
    """→ ({kernel: calls}, {RMSNorm row shape: calls}), counted from here
    on."""
    calls = dict.fromkeys(KERNELS, 0)
    rows: dict[tuple, int] = {}
    for name in KERNELS:
        fn = getattr(ops, name)

        def spy(x, *a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            if _name == "fused_rmsnorm":
                rows[_rows(x)] = rows.get(_rows(x), 0) + 1
            return _fn(x, *a, **kw)
        monkeypatch.setattr(ops, name, spy)
    return calls, rows


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_calls_what_the_card_is_held_to(arch, spied):
    calls, rows = spied
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch",
            str(B), "--prompt-len", str(S), "--new-tokens", str(NEW)]
    res = serve.main(argv)
    assert res["valid"] and tuple(res["tokens"].shape) == (B, NEW)
    cfg = configs.reduced(arch)
    want = chip_smoke.lm_expect(cfg, serve.parse_args(argv))
    assert calls == {k: want.get(k, 0) for k in KERNELS}
    assert rows == chip_smoke.rms_shapes(cfg, B, S, NEW)
    chip_smoke.rms_counted(calls, rows, arch)


@pytest.mark.parametrize("arch,argv,flash,decode,rmsnorm", [
    ("qwen3-1.7b", chip_smoke.LM_ARGS, 56, 896, 3842),
    ("qwen3-moe-30b-a3b", chip_smoke.MOE_ARGS, 96, 1536, 6562),
    *[(a, chip_smoke.reg_args(a), *n) for a, n in (
        ("starcoder2-3b", (60, 240, 610)),
        ("starcoder2-7b", (64, 256, 650)),
        ("phi-3-vision-4.2b", (64, 256, 650)),
        ("granite-20b", (104, 416, 1050)))],
])
def test_full_size_expectations(arch, argv, flash, decode, rmsnorm):
    cfg = configs.get(arch)
    args = serve.parse_args(argv)
    assert chip_smoke.lm_expect(cfg, args) == {
        "flash_attention": flash, "decode_attention": decode,
        "fused_rmsnorm": rmsnorm}
    shapes = chip_smoke.rms_shapes(cfg, args.batch, args.prompt_len,
                                   args.new_tokens)
    assert sum(shapes.values()) == rmsnorm
    # a vlm's prompt holds its image patches (448 tokens after 576)
    prefill_rows = args.batch * args.prompt_len
    assert shapes[(prefill_rows, cfg.d_model)] == 2 * 2 * cfg.n_layers


@pytest.mark.parametrize("gap,held", [(0.004, True), (0.06, False)])
def test_argmax_may_part_only_at_a_near_tie(gap, held):
    """Phase 37's bf16 gate (``chip_smoke.held_to`` with ``"ties"``): a
    row's argmax may differ between the routes only where the plain
    route's two largest logits lie closer than the routes do there."""
    plain = torch.zeros(2, 1, 8)
    plain[:, 0, 3], plain[:, 0, 5] = 1.0, 1.0 - gap
    kern = plain.clone()
    kern[1, 0, 3] -= 0.035
    kern[1, 0, 5] += 0.035             # row 1's argmax parts: 0.07 > gap
    gate = {"tol": 5e-2, "plain": [plain], "argmax": "ties",
            "cache_tol": {}}
    agree, bad = chip_smoke.held_to(torch, gate, [kern], {})["argmax equal"]
    assert agree == 1 and bad is not held
    assert [r for r, _, _ in chip_smoke.near_ties(kern, plain)] == [1]
    gate["argmax"] = True              # the strict gate refuses either
    assert chip_smoke.held_to(torch, gate, [kern], {})["argmax equal"][1]
