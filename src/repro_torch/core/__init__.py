"""ParetoPipe core: multi-objective DNN partitioning (the paper's contribution).

Public API:
    Block, BlockGraph, chain          — block-level model abstraction
    DeviceProfile, Link, LinkTrace    — hardware/network models (static +
                                        time-varying links)
    CostTable, evaluate_pipeline      — pipeline performance model
    solve                             — unified scenario-driven search
    sweep_2way, sweep_kway,
    dp_front_kway                     — partition search engines
    Objective, LATENCY, THROUGHPUT,
    ENERGY, resolve_objectives        — the objective-vector protocol
    pareto_front, knee_point,
    hypervolume, dominates            — Pareto machinery (any d, per-axis
                                        min/max sense)
    Scenario, scenarios.get           — named testbeds (paper + TPU pods)
    AdaptiveSplitter, LinkEstimator   — network-aware runtime re-splitting
    profiler                          — block-wise wall-clock (CUDA events
                                        on the card), analytic and counted
                                        (FlopCounterMode) block costs
"""
from .blocks import Block, BlockGraph, chain
from .costmodel import CostTable, PipelineMetrics, StageMetrics, evaluate_pipeline
from .devices import (DeviceProfile, Link, LinkTrace, link_at, ramp_trace,
                      sawtooth_trace, spike_trace, step_trace)
from .pareto import (ENERGY, LATENCY, THROUGHPUT, Objective, dominates,
                     hypervolume, is_on_front, knee_point, pareto_front,
                     resolve_objectives)
from .partitioner import (best_energy, best_latency, best_throughput,
                          dp_front_kway, solve, sweep_2way, sweep_kway)
from .autosplit import AdaptiveSplitter, LinkEstimator
from .scenarios import Scenario
from . import devices, profiler, scenarios

__all__ = [
    "Block", "BlockGraph", "chain",
    "CostTable", "PipelineMetrics", "StageMetrics", "evaluate_pipeline",
    "DeviceProfile", "Link", "LinkTrace", "link_at", "ramp_trace",
    "sawtooth_trace", "spike_trace", "step_trace",
    "Objective", "LATENCY", "THROUGHPUT", "ENERGY", "resolve_objectives",
    "dominates", "hypervolume", "is_on_front", "knee_point", "pareto_front",
    "best_energy", "best_latency", "best_throughput", "dp_front_kway", "solve",
    "sweep_2way", "sweep_kway",
    "AdaptiveSplitter", "LinkEstimator", "Scenario",
    "devices", "scenarios", "profiler",
]
