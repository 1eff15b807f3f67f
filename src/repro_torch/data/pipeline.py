"""Deterministic synthetic LM data (counterpart of
``src/repro/data/pipeline.py``).

Every batch is a pure function of ``(seed, step)``: a ``torch.Generator``
seeded from both draws it.  The keys, shapes, dtypes and the next-token
target shift are the reference's; the numbers are not, because
``torch.Generator`` and ``jax.random`` give different bits from the
same seed.  A test that
feeds both packages makes its inputs with numpy instead.  The iterator's
checkpointable state is the step alone (``state_dict``), so a resumed
run reads the same stream.  Batches are
drawn on the host and moved to ``device`` (``cuda`` unless the caller
names another).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.cnn.zoo import resolve_device
from ..models.common import AbstractBuilder
from ..models.config import ArchConfig


@dataclass(frozen=True)
class DataConfig:
    batch: int
    seq: int
    seed: int = 0


def _token_shapes(cfg: ArchConfig, batch: int, seq: int) -> dict:
    """Logical input shapes for one *training/prefill* batch."""
    shapes: dict[str, tuple] = {}
    if cfg.family == "vlm":
        P = cfg.n_patches
        shapes["tokens"] = (batch, seq - P)
        shapes["img"] = (batch, P, cfg.d_model)
    elif cfg.family == "encdec":
        shapes["tokens"] = (batch, seq)
        shapes["frames"] = (batch, cfg.enc_frames, cfg.d_model)
    else:
        shapes["tokens"] = (batch, seq)
    return shapes


def _axes_for(name: str) -> tuple:
    return {"tokens": ("batch", "seq"),
            "targets": ("batch", "seq"),
            "img": ("batch", "patches", "embed"),
            "frames": ("batch", "frames", "embed")}[name]


def make_batch_specs(cfg: ArchConfig, batch: int, seq: int, ctx,
                     kind: str = "train") -> dict:
    """``LeafSpec``s of a train/prefill batch under ``ctx`` (a
    ``sharding.api.MeshContext``, or None): fp32 image patches and
    frames, int32 tokens and targets, split over ``data`` where the
    batch divides (decode's cache specs live in ``launch.specs``)."""
    shapes = dict(_token_shapes(cfg, batch, seq))
    if kind == "train":
        shapes["targets"] = (batch, seq)
    leaf = AbstractBuilder(ctx)
    return {name: leaf(shape, axes=_axes_for(name), dtype=torch.float32
                       if name in ("img", "frames") else torch.int32)
            for name, shape in shapes.items()}


class SyntheticLM:
    """Synthetic next-token data; batches are functions of the step."""

    def __init__(self, cfg: ArchConfig, data: DataConfig, device=None):
        self.cfg, self.data = cfg, data
        self.device = resolve_device(device)
        self.step = 0

    # -- checkpointable state: one integer, as batches are pure functions
    # of (seed, step)
    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.data.seed}

    def load_state_dict(self, d: dict) -> None:
        self.step = int(d["step"])

    def batch_at(self, step: int) -> dict:
        g = torch.Generator().manual_seed(
            (self.data.seed * 2 ** 32 + step) % 2 ** 63)
        shapes = _token_shapes(self.cfg, self.data.batch, self.data.seq)
        out = {}
        for name, shape in sorted(shapes.items()):
            if name in ("img", "frames"):
                out[name] = torch.randn(shape, generator=g) * 0.02
            else:
                out[name] = torch.randint(0, self.cfg.vocab, shape,
                                          generator=g, dtype=torch.int32)
        out["targets"] = torch.randint(
            0, self.cfg.vocab, (self.data.batch, self.data.seq),
            generator=g, dtype=torch.int32)
        if self.cfg.family != "vlm":
            # make it a real LM task: targets = tokens shifted left
            t = out["tokens"]
            out["targets"] = torch.cat([t[:, 1:], out["targets"][:, :1]],
                                       dim=1)
        return {k: v.to(self.device) for k, v in out.items()}

    def __next__(self) -> dict:
        b = self.batch_at(self.step)
        self.step += 1
        return b
