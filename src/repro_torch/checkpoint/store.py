"""Checkpoints in the reference's layout (counterpart of
``src/repro/checkpoint/store.py``).

One directory a step:
    step_000042/
      manifest.json     — step, time, every leaf's shape and dtype, and
                          ``extra`` (the data iterator's state)
      arrays.npz        — flat path (``params|layers|attn|wq``) → array

The files are the reference's: the same flat keys over the reference's
state tree (``params/…``, ``opt/m/…``, ``opt/v/…``, ``opt/count``,
``step``, ``err/…``; ``runtime.steps.reference_state`` stacks the
port's blocks back on the layer axis), the same manifest fields, and a
bf16 leaf stored as the reference's ``np.savez`` stores ``ml_dtypes``'
bfloat16: 2-byte records under the descriptor ``<V2``.  A checkpoint of
either package restores in the other.  A restore reads every leaf by
the manifest's dtype, so a bf16 leaf comes back bit for bit without
``ml_dtypes`` (the reference's own restore of one fails: ROADMAP queue
3).  The tree comes back as CPU tensors; ``runtime.steps`` places it.

``CheckpointManager`` keeps the reference's cadence, retention, one
writer at a time that snapshots to the host before it returns (training
then overwrites the tensors in place while the write goes on), and the
rule that a torn ``step_*.tmp`` is never restored and is collected.
Under a mesh every rank gathers the state it saves
(``runtime.steps.reference_state``) and rank 0 alone writes it, so a
checkpoint holds whole leaves whatever the mesh; ``reshard_tree`` (and
``load_checkpoint``/``restore`` with a specs tree) places them on the
current mesh, each rank keeping its shards: a run resumes on any mesh,
or on one device.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
import zipfile
from pathlib import Path

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from ..models.common import from_host, host_array
from ..sharding.api import Layout


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf (tensor, numpy array, Python number) → (host array, the
    reference's dtype name).  A ``|V2`` array holds bf16 bits."""
    if isinstance(leaf, torch.Tensor):
        return host_array(leaf), str(leaf.dtype).removeprefix("torch.")
    a = np.array(leaf)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return a, "bfloat16"
    return a, a.dtype.name


def _snapshot(state) -> dict[str, tuple[np.ndarray, str]]:
    return {k: _host(v) for k, v in _flatten(state).items()}


def _write_npz(path: Path, host: dict[str, tuple[np.ndarray, str]]) -> None:
    """``np.savez``'s archive (stored members ``<key>.npy``), with a bf16
    member's header naming ``<V2`` as ``ml_dtypes``' array writes it."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (a, dtype) in host.items():
            if not a.flags.c_contiguous:   # (a 0-d array stays 0-d)
                a = a.copy(order="C")
            with zf.open(key.replace("/", "|") + ".npy", "w",
                         force_zip64=True) as f:
                if dtype == "bfloat16":
                    np.lib.format.write_array_header_1_0(
                        f, {"descr": "<V2", "fortran_order": False,
                            "shape": a.shape})
                    f.write(a.tobytes())
                else:
                    np.lib.format.write_array(f, a, allow_pickle=False)


def _write(path: Path, host: dict, step: int, extra: dict | None) -> Path:
    tmp = path.with_name(path.name + ".tmp")
    tmp.mkdir(parents=True, exist_ok=True)
    _write_npz(tmp / "arrays.npz", host)
    manifest = {
        "step": int(step),
        "time": time.time(),
        "leaves": {k: {"shape": list(a.shape), "dtype": dtype}
                   for k, (a, dtype) in host.items()},
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)                      # atomic publish
    return path


def save_checkpoint(path: str | Path, state, step: int,
                    extra: dict | None = None) -> Path:
    """Write ``state`` (a nested dict in the reference's layout; leaves
    tensors, numpy arrays or numbers) as ``path``, published by a rename
    of ``path.tmp``."""
    return _write(Path(path), _snapshot(state), step, extra)


def reshard_tree(tree: dict, specs_tree: dict) -> dict:
    """Every leaf of ``tree`` (a whole tensor) that ``specs_tree`` gives a
    ``Layout`` placed on its mesh in its placements, each rank keeping
    its shards with no communication (every rank holds the whole leaf);
    the rest as they are: an elastic restore onto any mesh (the
    reference's ``device_put`` onto each spec's sharding)."""
    specs = {k: v for k, v in _flatten(specs_tree).items()
             if isinstance(v, Layout)}
    return _unflatten({
        k: v if k not in specs else distribute_tensor(
            v.to(specs[k].mesh.device_type), specs[k].mesh,
            specs[k].placements, src_data_rank=None)
        for k, v in _flatten(tree).items()})


def load_checkpoint(path: str | Path,
                    specs_tree: dict | None = None) -> tuple[dict, dict]:
    """→ (state as a nested dict of CPU tensors, manifest); every leaf
    read as the manifest's dtype names it.  With ``specs_tree`` (a tree
    of ``Layout`` leaves) the state is placed on the current mesh
    (``reshard_tree``)."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    leaves = manifest["leaves"]
    with np.load(path / "arrays.npz") as z:
        flat = {}
        for k in z.files:
            key = k.replace("|", "/")
            flat[key] = from_host(z[k], "cpu",
                                  getattr(torch, leaves[key]["dtype"]))
    state = _unflatten(flat)
    if specs_tree is not None:
        state = reshard_tree(state, specs_tree)
    return state, manifest


class CheckpointManager:
    """Cadence + retention + async writes + latest-checkpoint discovery."""

    def __init__(self, root: str | Path, every: int = 50, keep: int = 3):
        self.root = Path(root)
        self.every, self.keep = every, keep
        self.root.mkdir(parents=True, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def _dir(self, step: int) -> Path:
        return self.root / f"step_{step:08d}"

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.every == 0

    def save(self, state, step: int, extra: dict | None = None,
             block: bool = True) -> None:
        """Snapshot ``state`` to the host now, then write it (on a
        background thread unless ``block``)."""
        self.wait()                               # one writer at a time
        if self._dir(step).exists():
            return                                # already checkpointed
        host = _snapshot(state)                   # before training goes on

        def write():
            try:
                _write(self._dir(step), host, step, extra)
                self._gc()
            except Exception as e:                # re-raised by wait()
                self._error = e

        if block:
            write()
            self.wait()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the writer; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _complete(self) -> list[Path]:
        """Published checkpoints only — a crash mid-write leaves a
        ``step_*.tmp`` dir (no manifest) that must never be restored."""
        return sorted(p for p in self.root.glob("step_*")
                      if not p.name.endswith(".tmp")
                      and (p / "manifest.json").exists())

    def _gc(self) -> None:
        for old in self._complete()[:-self.keep]:
            shutil.rmtree(old, ignore_errors=True)
        # torn writes are never restorable; one writer at a time, and the
        # current write's tmp dir was renamed before _gc runs, so every
        # remaining *.tmp is an orphan
        for tmp in self.root.glob("step_*.tmp"):
            shutil.rmtree(tmp, ignore_errors=True)

    def latest(self) -> Path | None:
        self.wait()
        ckpts = self._complete()
        return ckpts[-1] if ckpts else None

    def restore(self, specs_tree: dict | None = None
                ) -> tuple[dict | None, dict | None]:
        p = self.latest()
        if p is None:
            return None, None
        return load_checkpoint(p, specs_tree)
