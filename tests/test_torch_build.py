"""The kernel build is safe across processes: two processes that reach
an unbuilt library at once (pipeline stages spawned together) run one
compiler between them.  A stub ``nvcc`` on the PATH stands in for the
CUDA toolkit: it records each run, waits a second so the two builds
overlap, and writes its output file."""
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

STUB_NVCC = """#!/bin/sh
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo run >> "$STUB_NVCC_RUNS"
sleep 1
: > "$out"
"""

BUILD = """
import pathlib, sys
from repro_torch.kernels import _build
tmp = pathlib.Path(sys.argv[1])
_build.CSRC, _build.BUILD_DIR = tmp / "csrc", tmp / "build"
lib = _build.KernelLibrary("stub", {}, error_fn="stub_error")
print(lib.build())
"""


def _build_in_two_processes(tmp_path):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "stub.cu").write_text("// stub\n")
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(STUB_NVCC)
    nvcc.chmod(0o755)
    runs = tmp_path / "runs"
    env = {**os.environ, "PATH": f"{bin_dir}:{os.environ['PATH']}",
           "PYTHONPATH": str(ROOT / "src"), "STUB_NVCC_RUNS": str(runs)}
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    return procs, outs, runs


def test_two_processes_build_a_library_once(tmp_path):
    procs, outs, runs = _build_in_two_processes(tmp_path)
    assert [p.returncode for p in procs] == [0, 0], outs
    lib = tmp_path / "build" / "libstub.so"
    assert [o.strip() for o, _ in outs] == [str(lib)] * 2
    assert lib.exists()
    assert runs.read_text().splitlines() == ["run"]   # one nvcc between them
    assert (tmp_path / "build" / "stub.lock").exists()
