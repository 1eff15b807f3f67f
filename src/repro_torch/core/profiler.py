"""Block-wise profiling (paper Sec. IV-D / Fig. 2).

(The PyTorch port of the reference's ``core/profiler.py``.)

Three cost sources, all feeding the same ``CostTable``:

  * ``profile_wallclock`` — run each block on the device its input lies
    on and time it (the paper's wall-clock methodology): CUDA events on
    the card, ``perf_counter`` on the CPU.
  * ``profile_analytic``  — per-block FLOPs / device effective rate.
  * ``costs_from_hlo``    — per-block cost from the operations the block
    really runs, without timing it: FLOPs counted by
    ``torch.utils.flop_counter.FlopCounterMode`` (convolutions and
    matmuls; XLA's ``cost_analysis``, which the reference reads, also
    counts elementwise work) and bytes from the tensors' sizes.  The
    name is the reference's, so callers port one to one.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Sequence

import torch

from .blocks import BlockGraph
from .costmodel import CostTable
from .devices import DeviceProfile


def _timed_mean(fn: Callable, x, repeats: int) -> tuple[object, float]:
    """``fn`` applied ``repeats`` times to ``x`` → (last output, mean
    seconds a call), read after the device has finished the calls."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        stream = torch.cuda.current_stream(x.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        for _ in range(repeats):
            y = fn(x)
        end.record(stream)
        end.synchronize()
        return y, start.elapsed_time(end) / 1e3 / repeats
    t0 = time.perf_counter()
    for _ in range(repeats):
        y = fn(x)
    return y, (time.perf_counter() - t0) / repeats


@torch.no_grad()
def profile_wallclock(
    device_name: str,
    block_fns: Sequence[Callable],
    block_names: Sequence[str],
    make_input: Callable[[int], object],
    repeats: int = 5,
    warmup: int = 1,
    table: CostTable | None = None,
) -> CostTable:
    """Measure each block where its input lies.

    ``block_fns[i]`` maps the activation produced by block i-1 to block
    i's output; ``make_input(0)`` builds the model input.  Each block is
    run ``warmup`` times, then ``repeats`` times and averaged, mirroring
    the paper's 5-run mean.
    """
    table = table or CostTable()
    x = make_input(0)
    for name, fn in zip(block_names, block_fns):
        for _ in range(warmup):
            fn(x)
        y, dt = _timed_mean(fn, x, max(repeats, 1))
        table.set(device_name, name, dt)
        x = y
    return table


def profile_analytic(graph: BlockGraph, device: DeviceProfile, batch: int = 1,
                     table: CostTable | None = None) -> CostTable:
    table = table or CostTable()
    per_block_overhead = device.stage_overhead_s / max(graph.n_blocks, 1)
    for b in graph.blocks:
        table.set(device.name, b.name,
                  b.flops * batch / device.flops_per_s + per_block_overhead)
    return table


def _nbytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(_nbytes(o) for o in obj)
    return 0


@torch.no_grad()
def block_costs(fn: Callable, x) -> tuple[float, float]:
    """One run of ``fn`` on ``x`` → (FLOPs of its convolutions and
    matmuls, bytes it must move: the input read once, the output written
    once, and the weights and buffers of ``fn`` if it is a module)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        y = fn(x)
    state = 0
    if isinstance(fn, torch.nn.Module):
        state = sum(_nbytes(t) for t in (*fn.parameters(), *fn.buffers()))
    return float(counter.get_total_flops()), float(_nbytes(x) + _nbytes(y)
                                                   + state)


def costs_from_hlo(
    device: DeviceProfile,
    block_fns: Sequence[Callable],
    block_names: Sequence[str],
    example_inputs: Sequence,
    table: CostTable | None = None,
) -> CostTable:
    """Per-block cost from the counted work: each block runs once under
    ``FlopCounterMode`` (see ``block_costs``) and its FLOPs convert to
    seconds at the device's effective rate, max'ed with the
    memory-bandwidth term."""
    table = table or CostTable()
    for name, fn, x in zip(block_names, block_fns, example_inputs):
        flops, nbytes = block_costs(fn, x)
        table.set(device.name, name, device.compute_time(flops, nbytes))
    return table


def coefficient_of_variation(times: Sequence[float]) -> float:
    """Used to validate Fig 2's finding: block costs are heterogeneous."""
    n = len(times)
    if n == 0:
        return 0.0
    mu = sum(times) / n
    if mu == 0:
        return 0.0
    var = sum((t - mu) ** 2 for t in times) / n
    return math.sqrt(var) / mu
