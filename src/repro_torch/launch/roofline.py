"""Roofline terms from dry-run artifacts (counterpart of
``src/repro/launch/roofline.py``: the same ``Roofline``,
``roofline_from`` and ``model_flops``, with an H100's peaks in place of
the TPU v5e's).

Hardware constants: NVIDIA H100 SXM spec-sheet peaks — 989 TFLOP/s
dense bf16 on the tensor cores a GPU, 3.35 TB/s of HBM3 a GPU; the
intra-node term is NVLink 4, 450 GB/s a direction a GPU (900 GB/s
both ways).  The inter-node fabric is not given; we assume InfiniBand
NDR, one 400 Gb/s port a GPU = 50 GB/s a GPU, and record the
assumption here, as the reference records its DCN figure.  The names
``ICI_BW`` and ``DCN_BW`` keep the reference's: on the card the
"inside a pod" links are NVLink, the "across pods" ones the network.
All four are read from ``core.devices`` (``H100_SXM``, ``NVLINK4``,
``IB_NDR``), the profile the pipeline planner prices with.

All inputs are **per-device** quantities:

  compute term    = flops_per_dev / PEAK_FLOPS
  memory term     = bytes_per_dev / HBM_BW
  collective term = wire_ici_per_dev / ICI_BW + wire_dcn_per_dev / DCN_BW
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.devices import H100_SXM, IB_NDR, NVLINK4

PEAK_FLOPS = H100_SXM.flops_per_s     # bf16 dense FLOP/s per GPU (989e12)
HBM_BW = H100_SXM.mem_bw              # bytes/s per GPU (HBM3, 3.35e12)
ICI_BW = NVLINK4.bw_bytes_per_s       # bytes/s per GPU, one way (450e9)
DCN_BW = IB_NDR.bw_bytes_per_s        # bytes/s per GPU across nodes (50e9)


@dataclass(frozen=True)
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_per_dev: float      # 6·N·D (or 2·N·D inference) / chips
    hlo_flops_per_dev: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Lower bound on step time = max of the three terms (perfect
        overlap assumption)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / executed FLOPs — how much of the computed work is
        'useful' (catches remat/causal-waste/dispatch overheads)."""
        if self.hlo_flops_per_dev == 0:
            return 0.0
        return self.model_flops_per_dev / self.hlo_flops_per_dev

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization *if* the step ran at the roofline bound
        (the score we hillclimb): model_flops / (peak · step_time)."""
        t = self.step_time_s
        if t == 0:
            return 0.0
        return self.model_flops_per_dev / (PEAK_FLOPS * t)


def roofline_from(flops_per_dev: float, bytes_per_dev: float,
                  wire_ici_per_dev: float, wire_dcn_per_dev: float,
                  model_flops_total: float, n_chips: int) -> Roofline:
    return Roofline(
        compute_s=flops_per_dev / PEAK_FLOPS,
        memory_s=bytes_per_dev / HBM_BW,
        collective_s=wire_ici_per_dev / ICI_BW + wire_dcn_per_dev / DCN_BW,
        model_flops_per_dev=model_flops_total / n_chips,
        hlo_flops_per_dev=flops_per_dev,
    )


def model_flops(cfg, shape) -> float:
    """6·N·D for training, 2·N·D for inference forward (N = active params
    for MoE); D = tokens processed by the step."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.batch * shape.seq
    if shape.kind == "prefill":
        return 2.0 * n * shape.batch * shape.seq
    return 2.0 * n * shape.batch  # decode: one token per sequence
