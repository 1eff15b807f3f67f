"""Serving step functions: prefill and greedy decode (counterpart of the
serving half of ``src/repro/runtime/steps.py``).

The reference's steps are the units ``jax.jit`` compiles; PyTorch runs
eagerly, so here they are plain closures over the config.  Training
steps belong to a later slice (ROADMAP queue 1, item 11).
"""
from __future__ import annotations

import torch

from ..models import lm


def make_prefill_step(cfg, cache_len: int | None = None):
    def prefill_step(model, inputs):
        logits, cache = lm.forward_prefill(cfg, model, inputs, cache_len)
        return logits.argmax(dim=-1).to(torch.int32), cache
    return prefill_step


def make_decode_step(cfg):
    def decode_step(model, token, cache):
        logits, cache = lm.forward_decode(cfg, model, token, cache)
        return logits.argmax(dim=-1).to(torch.int32), cache
    return decode_step
