"""Device and link models.

Two kinds of cost sources coexist (mirroring the paper's methodology):

  * **Analytic** — a ``DeviceProfile`` with an *effective* FLOP rate and a
    fixed per-stage-invocation overhead; block time = flops / eff_flops +
    overhead share.  Effective rates for the paper's testbed are
    back-solved from the paper's own Tables II/III (see calibration notes
    below) — the point is to land in the same *regime* (GPU 2–3 orders of
    magnitude faster than a Pi; seconds-scale CNN batches), so frontier
    *structure* reproduces.
  * **Measured** — a ``CostTable`` filled by wall-clock profiling
    (``core.profiler``) or by compiled-HLO cost analysis (the dry-run
    path).  When a CostTable has an entry it overrides the analytic model.

Calibration notes (paper Tables II/III, batch 8; 224²/299² inputs — the
only reading consistent with the reported seconds-scale batch times):
  * Pi 4B: AlexNet full ≈0.83 s/batch over 11.4 GFLOP and VGG16
    ≈13 s over 248 GFLOP → ~10–19 effective GFLOP/s on dense convs; we
    use 10.  MobileNetV2's 1.9 s over 5 GFLOP (~1.3 GFLOP/s) reflects
    depthwise-conv inefficiency, modelled per-block via ``Block.eff``.
  * RTX 4090: AlexNet ≈9 ms/batch → ~1.3 effective TFLOP/s at batch 8
    (launch-bound).  We use 1.5 + 5 ms per-stage overhead.
  * TPU v5e (the reference's scale target): 197 TFLOP/s bf16 peak, 819
    GB/s HBM, ~50 GB/s/link ICI; DCN between pods ~25 GB/s per host
    pair.  The port keeps these as the reference's copies
    (``scenarios.REGISTRY`` must equal the reference's); no launcher of
    the port prices with them.
  * NVIDIA H100 SXM (the port's card, ``H100_SXM``): the spec peaks
    ``launch.roofline`` uses (989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
    NVLink 4 at 450 GB/s one way) and four constants read on the card
    (total memory, power limit, idle draw, one stage hop), each re-read
    by ``chip_smoke.py``'s phase 36.  ``h100_pod``/``NVLINK4`` are what
    ``models.blocks_adapter.choose_pipeline_cuts`` prices the LM
    pipeline's stages and hops with.
"""
from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field
from typing import Union


@dataclass(frozen=True)
class DeviceProfile:
    name: str
    flops_per_s: float            # effective achievable FLOP/s
    mem_bytes: int                # usable memory for weights + activations
    mem_bw: float = 0.0           # bytes/s (used by roofline-style costs)
    stage_overhead_s: float = 0.0  # fixed cost per stage invocation (framework)
    idle_w: float = 0.0           # power draw while waiting (W)
    active_w: float = 0.0         # power draw while computing (W)

    def compute_time(self, flops: float, bytes_moved: float = 0.0) -> float:
        """Roofline-ish time: max of compute and memory terms + overhead."""
        t = flops / self.flops_per_s
        if self.mem_bw > 0 and bytes_moved > 0:
            t = max(t, bytes_moved / self.mem_bw)
        return t + self.stage_overhead_s

    def compute_energy(self, compute_s: float, idle_s: float = 0.0) -> float:
        """Joules for ``compute_s`` seconds busy (+ optional idle tail)."""
        return self.active_w * compute_s + self.idle_w * idle_s


@dataclass(frozen=True)
class Link:
    """Point-to-point link: latency + bandwidth + per-message overhead."""

    name: str
    rtt_s: float                  # round-trip time
    bw_bytes_per_s: float
    per_msg_overhead_s: float = 0.0   # serialization / syscall / RPC overhead
    energy_per_byte_j: float = 0.0    # radio/NIC joules per byte on the wire

    def transfer_time(self, nbytes: float) -> float:
        return self.rtt_s / 2.0 + self.per_msg_overhead_s + nbytes / self.bw_bytes_per_s

    def transfer_energy(self, nbytes: float) -> float:
        """Radio joules to move ``nbytes`` (sender + receiver NICs)."""
        return self.energy_per_byte_j * nbytes


# --------------------------------------------------------------------------- #
# Time-varying links
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class LinkTrace:
    """A link whose RTT/bandwidth follow a piecewise (t, rtt, bw) schedule.

    This is the paper's Sec. V-B duress experiment generalized from a
    step to an arbitrary time profile: the emulator samples the trace at
    every transfer, so a WAN ramp, a congestion spike, or a recovery can
    all play out *while a pipeline is streaming*.

      * ``schedule`` — ascending ``(t_s, rtt_s, bw_bytes_per_s)`` knots.
        Between knots values are linearly interpolated (``interp="linear"``)
        or held at the previous knot (``interp="hold"``); before the first
        / after the last knot the boundary values apply.
      * ``jitter`` — optional relative noise: a caller-supplied RNG draws a
        lognormal factor ``exp(N(0, jitter))`` per transfer, so emulated
        times wobble the way real WANs do while staying positive.
    """

    name: str
    schedule: tuple[tuple[float, float, float], ...]
    per_msg_overhead_s: float = 0.0
    jitter: float = 0.0
    interp: str = "linear"            # "linear" | "hold"
    energy_per_byte_j: float = 0.0    # radio cost is a link property, not
                                      # time-varying: congestion changes
                                      # rtt/bw, not joules per byte sent

    def __post_init__(self):
        if not self.schedule:
            raise ValueError(f"LinkTrace {self.name!r}: empty schedule")
        ts = [k[0] for k in self.schedule]
        if ts != sorted(ts):
            raise ValueError(f"LinkTrace {self.name!r}: knots must be "
                             f"sorted by time, got {ts}")
        if self.interp not in ("linear", "hold"):
            raise ValueError(f"unknown interp {self.interp!r}")

    def _sample(self, t: float) -> tuple[float, float]:
        knots = self.schedule
        if t <= knots[0][0]:
            return knots[0][1], knots[0][2]
        if t >= knots[-1][0]:
            return knots[-1][1], knots[-1][2]
        i = bisect.bisect_right([k[0] for k in knots], t)
        t0, r0, b0 = knots[i - 1]
        t1, r1, b1 = knots[i]
        if self.interp == "hold" or t1 == t0:
            return r0, b0
        w = (t - t0) / (t1 - t0)
        return r0 + w * (r1 - r0), b0 + w * (b1 - b0)

    def at(self, t: float) -> Link:
        """Static snapshot of the link at trace time ``t`` (no jitter)."""
        rtt, bw = self._sample(t)
        return Link(f"{self.name}@{t:.3g}s", rtt_s=rtt, bw_bytes_per_s=bw,
                    per_msg_overhead_s=self.per_msg_overhead_s,
                    energy_per_byte_j=self.energy_per_byte_j)

    def transfer_time(self, nbytes: float, t: float = 0.0, rng=None) -> float:
        """Transfer time at trace time ``t``; with ``rng`` applies jitter.

        ``t`` defaults to 0 so a LinkTrace is a drop-in Link for analytic
        callers that only look at the trace's starting conditions."""
        dt = self.at(t).transfer_time(nbytes)
        if self.jitter > 0.0 and rng is not None:
            dt *= math.exp(rng.normal(0.0, self.jitter))
        return dt

    def transfer_energy(self, nbytes: float) -> float:
        return self.energy_per_byte_j * nbytes


AnyLink = Union[Link, LinkTrace]


def link_at(link: AnyLink, t: float = 0.0) -> Link:
    """Resolve a possibly time-varying link to a static Link at time t."""
    return link.at(t) if isinstance(link, LinkTrace) else link


# --------------------------------------------------------------------------- #
# Fitting the link model to observed transfers.  One home for the
# ``elapsed = rtt/2 + overhead + nbytes/bw`` inversion, shared by the
# runtime estimator (core.autosplit.LinkEstimator) and the trace
# recorder (runtime.transport.record_trace).
# --------------------------------------------------------------------------- #
def fit_link_params(nbytes_list, elapsed_list,
                    rtt_s: float) -> tuple[float, float] | None:
    """Joint least-squares of (bw, overhead) from (nbytes, elapsed)
    pairs: slope → 1/bw, intercept − rtt/2 → per-message overhead.
    Returns None when the sample is degenerate (a single message size
    makes the slope unidentifiable; a non-positive slope means noise
    dominates) — callers fall back to ``attribute_bandwidth``."""
    import numpy as np
    xs = np.asarray(nbytes_list, dtype=float)
    ys = np.asarray(elapsed_list, dtype=float)
    if xs.max() - xs.min() < 1e-9 * max(xs.max(), 1.0):
        return None
    slope, intercept = np.polyfit(xs, ys, 1)
    if slope <= 0.0:
        return None
    return 1.0 / float(slope), max(float(intercept) - rtt_s / 2.0, 0.0)


def fit_link_params_robust(nbytes_list, elapsed_list, rtt_s: float,
                           n_iter: int = 3, k_mad: float = 4.0
                           ) -> tuple[float, float] | None:
    """Outlier-robust variant of ``fit_link_params`` for heavy-tailed
    *measured* records (real socket/shmem transfers pick up scheduler
    preemption and allocator hiccups that a plain least-squares fit
    chases).  MAD-gated: fit, drop samples whose residual exceeds
    ``k_mad`` × 1.4826 × MAD of the window's residuals, refit on the
    survivors; repeat until stable.  A clean window has zero residual
    spread, drops nothing, and degrades exactly to the plain fit."""
    import numpy as np
    xs = np.asarray(nbytes_list, dtype=float)
    ys = np.asarray(elapsed_list, dtype=float)
    fit = fit_link_params(xs, ys, rtt_s)
    if fit is None:
        return None
    for _ in range(n_iter):
        bw, overhead = fit
        resid = ys - (rtt_s / 2.0 + overhead + xs / bw)
        med = float(np.median(resid))
        width = k_mad * 1.4826 * float(np.median(np.abs(resid - med)))
        if width <= 0.0:
            break                              # clean window: nothing to gate
        keep = np.abs(resid - med) <= width
        # never gate the window into degeneracy: the fit needs several
        # samples across more than one message size
        if keep.all() or keep.sum() < 4 or len(np.unique(xs[keep])) < 2:
            break
        refit = fit_link_params(xs[keep], ys[keep], rtt_s)
        if refit is None:
            break
        fit = refit
    return fit


def attribute_bandwidth(nbytes: float, elapsed_s: float, rtt_s: float,
                        overhead_s: float = 0.0) -> float:
    """Single-transfer bandwidth attribution: serviceable time is
    elapsed minus the fixed costs, floored at a fraction of elapsed so
    a jittery small transfer arriving "before" the estimated RTT cannot
    imply near-infinite bandwidth."""
    serv = max(elapsed_s - rtt_s / 2.0 - overhead_s, 0.05 * elapsed_s, 1e-9)
    return nbytes / serv


def ramp_trace(name: str, start: Link, end: Link, t_start: float,
               t_end: float, jitter: float = 0.0) -> LinkTrace:
    """A trace that holds ``start`` until ``t_start``, degrades (or
    recovers) linearly to ``end`` by ``t_end``, then holds ``end``.

    Schedule knots carry (t, rtt, bw) only, so the trace keeps
    ``start``'s per-message overhead and radio energy throughout; pick
    link pairs with matching overheads (all the edge-side links here use
    0.5 ms)."""
    if t_end <= t_start:
        raise ValueError("need t_end > t_start")
    return LinkTrace(
        name=name,
        schedule=((t_start, start.rtt_s, start.bw_bytes_per_s),
                  (t_end, end.rtt_s, end.bw_bytes_per_s)),
        per_msg_overhead_s=start.per_msg_overhead_s,
        jitter=jitter,
        energy_per_byte_j=start.energy_per_byte_j,
    )


def step_trace(name: str, before: Link, after: Link, t_step: float,
               jitter: float = 0.0) -> LinkTrace:
    """The paper's tc-netem duress switch as a trace: ``before`` until
    ``t_step``, ``after`` from then on.  As with ``ramp_trace``, the
    per-message overhead stays at ``before``'s value throughout."""
    eps = 1e-9
    return LinkTrace(
        name=name,
        schedule=((0.0, before.rtt_s, before.bw_bytes_per_s),
                  (t_step, before.rtt_s, before.bw_bytes_per_s),
                  (t_step + eps, after.rtt_s, after.bw_bytes_per_s)),
        per_msg_overhead_s=before.per_msg_overhead_s,
        jitter=jitter,
        interp="hold",
        energy_per_byte_j=before.energy_per_byte_j,
    )


def sawtooth_trace(name: str, good: Link, bad: Link, period_s: float,
                   n_periods: int = 4, duty: float = 0.6,
                   jitter: float = 0.0) -> LinkTrace:
    """LTE-like sawtooth: each period ramps from ``good`` down to ``bad``
    over ``duty`` of the period, then snaps back — the cell-handover /
    scheduler-rotation pattern measured WAN traces show.  Keeps
    ``good``'s per-message overhead and radio energy throughout."""
    if period_s <= 0 or not (0.0 < duty < 1.0):
        raise ValueError("need period_s > 0 and 0 < duty < 1")
    eps = 1e-9
    knots: list[tuple[float, float, float]] = []
    for p in range(n_periods):
        t0 = p * period_s
        knots.append((t0, good.rtt_s, good.bw_bytes_per_s))
        knots.append((t0 + duty * period_s, bad.rtt_s, bad.bw_bytes_per_s))
        knots.append((t0 + duty * period_s + eps,
                      good.rtt_s, good.bw_bytes_per_s))
    knots.append((n_periods * period_s, good.rtt_s, good.bw_bytes_per_s))
    return LinkTrace(name=name, schedule=tuple(knots),
                     per_msg_overhead_s=good.per_msg_overhead_s,
                     jitter=jitter,
                     energy_per_byte_j=good.energy_per_byte_j)


def spike_trace(name: str, base: Link, spike: Link, t_start: float,
                t_peak: float, t_end: float,
                jitter: float = 0.0) -> LinkTrace:
    """Congestion ramp-and-recover: ``base`` until ``t_start``, degrades
    linearly to ``spike`` at ``t_peak``, recovers linearly back to
    ``base`` by ``t_end``, then holds ``base`` — one congestion event
    the adaptive loop should enter *and leave* (migrate out, migrate
    back)."""
    if not (t_start < t_peak < t_end):
        raise ValueError("need t_start < t_peak < t_end")
    return LinkTrace(
        name=name,
        schedule=((t_start, base.rtt_s, base.bw_bytes_per_s),
                  (t_peak, spike.rtt_s, spike.bw_bytes_per_s),
                  (t_end, base.rtt_s, base.bw_bytes_per_s)),
        per_msg_overhead_s=base.per_msg_overhead_s,
        jitter=jitter,
        energy_per_byte_j=base.energy_per_byte_j,
    )


# --------------------------------------------------------------------------- #
# The paper's testbed (calibrated) and the TPU target.
# --------------------------------------------------------------------------- #
GiB = 1024 ** 3

# Calibrated against Tables II/III at the paper's operating point
# (CIFAR-10 upscaled to 224²/299² — the only reading consistent with the
# reported seconds-scale batch times): PyTorch-on-A72 sustains ~10 GFLOP/s
# on dense convs; depthwise convs run at ~10% of that (captured per-block
# via Block.eff, not here).
#
# Power calibration (the energy objective): Pi 4B draws ~2.7 W idle and
# ~6.4 W with all four A72 cores busy (widely measured wall figures); an
# RTX 4090 idles around 22 W and sustains ~320 W under inference load
# (below its 450 W TGP — launch-bound small batches never hit it).  TPU
# v5e per-chip power is not published; ~170 W active / ~60 W idle is the
# regime consistent with its 197 TFLOP/s at "2x perf/W over v4".
PI_4B = DeviceProfile(
    name="pi4b", flops_per_s=10e9, mem_bytes=4 * GiB, mem_bw=4e9,
    stage_overhead_s=5e-3, idle_w=2.7, active_w=6.4,
)

RTX_4090 = DeviceProfile(
    name="rtx4090", flops_per_s=1.5e12, mem_bytes=24 * GiB, mem_bw=1008e9,
    stage_overhead_s=5e-3, idle_w=22.0, active_w=320.0,
)

# This host, as one pipeline "device" per worker *process* — the analytic
# stand-in the partitioner plans with when the runtime deploys real local
# processes (scenarios.local_chain); the measured transports then replace
# the link model with observed transfer costs.  Effective rate is the
# same order as the Pi calibration (shared cores, CPU jax); power is the
# package figure of a small desktop CPU.
HOST_CPU = DeviceProfile(
    name="host_cpu", flops_per_s=20e9, mem_bytes=8 * GiB, mem_bw=10e9,
    stage_overhead_s=1e-3, idle_w=10.0, active_w=45.0,
)

# One TPU v5e chip (peak specs; roofline constants of the assignment).
# The reference's copy: no launcher of the port prices with it (the LM
# pipeline's stages are H100s, ``H100_SXM`` below).
TPU_V5E_CHIP = DeviceProfile(
    name="tpu_v5e", flops_per_s=197e12, mem_bytes=16 * GiB, mem_bw=819e9,
    stage_overhead_s=2e-6, idle_w=60.0, active_w=170.0,
)


def tpu_pod(n_chips: int = 256, name: str | None = None) -> DeviceProfile:
    """A whole pod as one pipeline 'device' (chips cooperate via TP/DP
    inside the stage; the partitioner places layer ranges on pods).  The
    reference's copy, kept for ``scenarios.pods``; the port's stages are
    ``h100_pod``s."""
    return DeviceProfile(
        name=name or f"v5e_pod{n_chips}",
        flops_per_s=TPU_V5E_CHIP.flops_per_s * n_chips,
        mem_bytes=TPU_V5E_CHIP.mem_bytes * n_chips,
        mem_bw=TPU_V5E_CHIP.mem_bw * n_chips,
        stage_overhead_s=5e-6,
        idle_w=TPU_V5E_CHIP.idle_w * n_chips,
        active_w=TPU_V5E_CHIP.active_w * n_chips,
    )


# One NVIDIA H100 SXM, the card the port's pipeline stages run on.  The
# peaks are spec-sheet figures (``launch.roofline`` reads them from here:
# dense bf16 on the tensor cores, HBM3), as ``TPU_V5E_CHIP``'s are.  The
# other four were read on an NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit by ``chip_smoke.py``'s ``card_phase`` (phase 36), which reads
# them again beside these on every run:
#   mem_bytes         ``torch.cuda.get_device_properties(0).total_memory``
#                     (phase 36 fails if a card has less: a planner that
#                     believes in more memory would place stages that do
#                     not fit);
#   stage_overhead_s  one stage hop between two cards of a four-card
#                     host, timed from the host to done: the pipeline's
#                     ``y.to(next card)`` of a decode step's activation
#                     (8 x 1 x 2048 bf16, cuda:0 -> cuda:1) plus one
#                     launch there, the median of 200: 0.0596 ms.  Phase
#                     36 fails if a run with two cards reads the hop more
#                     than 3x off it, or if one card's launch and sync
#                     alone (its ``y.to`` moves nothing) passes it;
#   active_w          the card's power limit (``nvidia-smi power.limit``);
#   idle_w            ``nvidia-smi power.draw`` before the first kernel.
H100_SXM = DeviceProfile(
    name="h100_sxm", flops_per_s=989e12, mem_bytes=85_017_493_504,
    mem_bw=3.35e12, stage_overhead_s=59.6e-6, idle_w=69.41, active_w=700.0,
)


def h100_pod(n_cards: int = 1, name: str | None = None) -> DeviceProfile:
    """A pod's D·M cards as one pipeline 'device' (they run the stage's
    data and model axes; the partitioner places layer ranges on pods),
    the counterpart of ``tpu_pod``.  A hop's fixed cost is the card's
    one stage hop, whatever the pod's size."""
    return DeviceProfile(
        name=name or f"h100_pod{n_cards}",
        flops_per_s=H100_SXM.flops_per_s * n_cards,
        mem_bytes=H100_SXM.mem_bytes * n_cards,
        mem_bw=H100_SXM.mem_bw * n_cards,
        stage_overhead_s=H100_SXM.stage_overhead_s,
        idle_w=H100_SXM.idle_w * n_cards,
        active_w=H100_SXM.active_w * n_cards,
    )


# Links -------------------------------------------------------------------- #
Mbit = 1e6 / 8
Gbit = 1e9 / 8

# Radio/NIC energy per byte (both endpoints): GbE NICs draw ~1.5 W
# sustained at wire rate (125 MB/s) → ~12 nJ/B for the pair; a
# WAN/cellular egress path is orders of magnitude costlier, ~1 J/MB
# (the low end of measured LTE figures) → 1 µJ/B; ICI/DCN move bytes at
# a few W over tens of GB/s, so their per-byte cost is negligible but
# nonzero.
LAN_PI_PI = Link("lan_pi_pi", rtt_s=0.201e-3, bw_bytes_per_s=1 * Gbit,
                 per_msg_overhead_s=0.5e-3, energy_per_byte_j=12e-9)
LAN_PI_GPU = Link("lan_pi_gpu", rtt_s=0.383e-3, bw_bytes_per_s=1 * Gbit,
                  per_msg_overhead_s=0.5e-3, energy_per_byte_j=12e-9)
# Loopback TCP between processes on one host — the analytic stand-in for
# the *measured* socket/shmem transports (typical: tens of µs RTT, a few
# GB/s effective with serialization; no radio).  Planning numbers only —
# the real transports record what the wire actually did.
LOOPBACK = Link("loopback", rtt_s=60e-6, bw_bytes_per_s=2e9,
                per_msg_overhead_s=30e-6, energy_per_byte_j=0.0)
# Paper Sec. V-B: tc netem 200 ms RTT + 5 Mbit/s.
DURESS = Link("duress", rtt_s=200e-3, bw_bytes_per_s=5 * Mbit,
              per_msg_overhead_s=0.5e-3, energy_per_byte_j=1e-6)

ICI_V5E = Link("ici_v5e", rtt_s=2e-6, bw_bytes_per_s=50e9,
               per_msg_overhead_s=1e-6, energy_per_byte_j=1e-11)
# Cross-pod data-center network, aggregated per pod boundary.
DCN = Link("dcn", rtt_s=20e-6, bw_bytes_per_s=25e9, per_msg_overhead_s=5e-6,
           energy_per_byte_j=5e-11)
DCN_CONGESTED = Link("dcn_congested", rtt_s=2e-3, bw_bytes_per_s=2.5e9,
                     per_msg_overhead_s=5e-6, energy_per_byte_j=5e-11)
# ICI_V5E, DCN and DCN_CONGESTED are the reference's copies: no launcher
# of the port prices with them.

# The card's links, at ``launch.roofline``'s rates (its ``ICI_BW`` and
# ``DCN_BW`` read them from here).  A hop's fixed cost is counted once,
# in ``H100_SXM.stage_overhead_s``, which was timed over the whole hop,
# so neither link adds a latency; their joules a byte are not measured
# (the card's power readings cannot tell a copy's share apart).
# NVLink 4 between cards of one host, one direction: the hop between
# stages in every launcher run of the port.
NVLINK4 = Link("nvlink4", rtt_s=0.0, bw_bytes_per_s=450e9)
# Across nodes: InfiniBand NDR, one 400 Gb/s port a GPU (an assumption,
# as the roofline's ``DCN_BW``; no two-node machine to read it on).
IB_NDR = Link("ib_ndr", rtt_s=0.0, bw_bytes_per_s=50e9)
