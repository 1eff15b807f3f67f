"""The port stands alone: no jax, no reference package, no fallback.

``src/repro_torch`` and ``chip_smoke.py`` must import neither jax (nor
its ``jaxlib``/``ml_dtypes``) nor ``psutil`` (absent on the GPU
machine) nor anything of the ``repro`` reference package, and every
``ops`` wrapper must launch its kernel or raise for a tensor that is
not on the CPU — never quietly run the plain version.
"""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.kernels import codec_pack, ops

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "ml_dtypes", "psutil", "repro"}
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_nothing_forbidden(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_runtime_import_pulls_in_no_jax():
    code = ("import sys; import repro_torch.runtime.edge, "
            "repro_torch.core.codecs; "
            "bad = [m for m in ('jax', 'jaxlib', 'ml_dtypes', 'repro') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


WRAPPERS = {
    "int8_pack": lambda t: ops.int8_pack(t),
    "fp8_pack": lambda t: ops.fp8_pack(t),
    "topk_select": lambda t: ops.topk_select(t, k=2),
    "int8_unpack": lambda t: ops.int8_unpack(t.to(torch.int8), 0.5),
    "fp8_unpack": lambda t: ops.fp8_unpack(t.to(torch.float8_e4m3fn), 0.5),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_raises_instead_of_falling_back(name, monkeypatch):
    """A stub stands in for the CUDA launch (there is no GPU here): the
    wrapper must call it for a non-CPU tensor, let its error through and
    count nothing."""
    calls = []

    def refuse(*args, **kwargs):
        calls.append(args)
        raise RuntimeError("stub: kernel launch refused")

    monkeypatch.setattr(codec_pack, name, refuse)
    ops.reset_launch_counts()
    x = torch.empty(16, device="meta")
    with pytest.raises(RuntimeError, match="stub: kernel launch refused"):
        WRAPPERS[name](x)
    assert len(calls) == 1
    assert ops.launch_counts()[name] == 0


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_kernel_module_refuses_non_cuda_tensors(name):
    """Without the stub the kernel side checks the device before it
    builds anything, so no nvcc is needed to see the refusal."""
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        WRAPPERS[name](torch.empty(16, device="meta"))


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_cpu_tensors_take_the_plain_version_uncounted(name):
    ops.reset_launch_counts()
    WRAPPERS[name](torch.randn(16))
    assert ops.launch_counts()[name] == 0
