"""Named deployment scenarios (device chain + links).

The paper's four experimental conditions plus the TPU-scale analogues the
reference deploys on, and the port's own card chain (``card_pods``:
H100s over NVLink, kept out of ``REGISTRY``, which stays equal to the
reference's).  A ``Scenario`` is what the partitioner
*and* the executable runtime consume: an ordered device chain with the
links between consecutive devices.  Links may be static ``Link``s or
time-varying ``LinkTrace``s — ``Scenario.at(t)`` resolves every trace to
its value at time ``t`` for the analytic side, while the runtime samples
traces per transfer.

Every registry entry carries the measured power calibration needed by
the energy objective: Pi 4B 2.7 W idle / 6.4 W active, RTX 4090 22 W /
320 W, v5e 60 W / 170 W per chip (see ``core.devices``), plus per-byte
radio cost on each link (GbE NIC pair ≈ 12 nJ/B; the duress WAN at
cellular-like 1 µJ/B) — so ``solve(..., objectives=("latency",
"throughput", "energy"))`` works on any scenario out of the box.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from . import devices as D


@dataclass(frozen=True)
class Scenario:
    name: str
    devices: tuple[D.DeviceProfile, ...]
    links: tuple[D.AnyLink, ...]
    # per-hop transport names (see runtime.transport.TRANSPORTS): None
    # defers to the pipeline default ("emulated"); "socket"/"shmem" make
    # the hop a *measured* real channel between worker processes
    transports: tuple[str, ...] | None = None
    # per-hop wire codec names (see core.codecs.CODECS): None defers to
    # the pipeline default ("none" everywhere); declared per hop exactly
    # like transports, consumed by both the cost model (packed bytes +
    # accuracy axis) and the runtime (the pack kernels on the wire)
    codecs: tuple[str, ...] | None = None
    # idle devices available for stage replication: solve(replicas="auto")
    # staffs extra replicas of a stage from spares whose profile *name*
    # matches the stage's assigned device (identical copies — same
    # compute model per replica)
    spare_devices: tuple[D.DeviceProfile, ...] = ()

    def __post_init__(self):
        if len(self.links) != len(self.devices) - 1:
            raise ValueError("need len(devices)-1 links")
        if self.transports is not None and \
                len(self.transports) != len(self.links):
            raise ValueError("need one transport per link")
        if self.codecs is not None and len(self.codecs) != len(self.links):
            raise ValueError("need one codec per link")

    @property
    def n_stages(self) -> int:
        return len(self.devices)

    @property
    def time_varying(self) -> bool:
        return any(isinstance(l, D.LinkTrace) for l in self.links)

    @property
    def active_power_w(self) -> float:
        """Chain power with every device busy — the energy model's upper
        envelope (per-partition joules come from ``PipelineMetrics``)."""
        return sum(d.active_w for d in self.devices)

    def with_link(self, i: int, link: D.AnyLink, name: str | None = None) -> "Scenario":
        links = list(self.links)
        links[i] = link
        return Scenario(name or f"{self.name}+{link.name}", self.devices,
                        tuple(links), self.transports, self.codecs,
                        self.spare_devices)

    def with_transport(self, transport: "str | tuple[str, ...]",
                       name: str | None = None) -> "Scenario":
        """Scenario with every hop (or a per-hop tuple) on ``transport``."""
        if isinstance(transport, str):
            transports = (transport,) * len(self.links)
        else:
            transports = tuple(transport)
        return Scenario(name or self.name, self.devices, self.links,
                        transports, self.codecs, self.spare_devices)

    def with_codec(self, codec: "str | tuple[str, ...]",
                   name: str | None = None) -> "Scenario":
        """Scenario with every hop (or a per-hop tuple) on wire ``codec``."""
        if isinstance(codec, str):
            codecs = (codec,) * len(self.links)
        else:
            codecs = tuple(codec)
        return Scenario(name or self.name, self.devices, self.links,
                        self.transports, codecs, self.spare_devices)

    def at(self, t: float = 0.0) -> "Scenario":
        """Static snapshot: every LinkTrace resolved to its link at ``t``."""
        if not self.time_varying:
            return self
        return Scenario(self.name, self.devices,
                        tuple(D.link_at(l, t) for l in self.links),
                        self.transports, self.codecs, self.spare_devices)


# --- the paper's testbed ---------------------------------------------------- #
def pi_to_pi() -> Scenario:
    return Scenario("pi_to_pi", (D.PI_4B, D.PI_4B), (D.LAN_PI_PI,))


def pi_to_gpu() -> Scenario:
    return Scenario("pi_to_gpu", (D.PI_4B, D.RTX_4090), (D.LAN_PI_GPU,))


def pi_pi_gpu() -> Scenario:
    """Three-stage edge chain: two Pis feeding the GPU server — the
    cluster depth the k-way engines reason about, now executable."""
    return Scenario("pi_pi_gpu", (D.PI_4B, D.PI_4B, D.RTX_4090),
                    (D.LAN_PI_PI, D.LAN_PI_GPU))


def pi_cluster(n_spares: int = 1) -> Scenario:
    """The replication testbed: the 3-stage pi_pi_gpu chain plus
    ``n_spares`` idle Pis.  The chain alone pins throughput to the
    slowest Pi stage while the GPU starves; ``solve(replicas="auto")``
    staffs the bottleneck Pi stage from the spares (Parthasarathy &
    Krishnamachari's throughput-max placement).  ``pi_cluster4`` /
    ``pi_cluster5`` in the registry = 4 / 5 devices total."""
    if n_spares < 1:
        raise ValueError("need n_spares >= 1")
    base = pi_pi_gpu()
    return dataclasses.replace(base, name=f"pi_cluster{3 + n_spares}",
                               spare_devices=(D.PI_4B,) * n_spares)


def pi_chain(k: int = 3) -> Scenario:
    """k-1 Pis in a line feeding a GPU — arbitrary-depth edge cluster."""
    if k < 2:
        raise ValueError("need k >= 2 stages")
    devs = (D.PI_4B,) * (k - 1) + (D.RTX_4090,)
    links = (D.LAN_PI_PI,) * (k - 2) + (D.LAN_PI_GPU,)
    return Scenario(f"pi_chain{k}", devs, links)


def pi_only_chain(k: int = 3) -> Scenario:
    """k Pis, no GPU — the battery-bound deployment the energy objective
    is for: every stage costs the same watts, so the (latency,
    throughput, energy) front is decided by balance vs. bytes moved."""
    if k < 2:
        raise ValueError("need k >= 2 stages")
    return Scenario(f"pi_only{k}", (D.PI_4B,) * k,
                    (D.LAN_PI_PI,) * (k - 1))


def duress(base: Scenario) -> Scenario:
    """Paper Sec. V-B: tc-imposed 200 ms RTT + 5 Mbit/s on the first hop."""
    return base.with_link(0, D.DURESS, name=f"{base.name}_duress")


def wan_ramp(base: Scenario, hop: int = 0, t_start: float = 2.0,
             t_end: float = 6.0, jitter: float = 0.05) -> Scenario:
    """Time-varying duress: hop ``hop`` degrades linearly from its
    healthy value to the paper's 200 ms / 5 Mbit WAN between ``t_start``
    and ``t_end`` (trace time), with mild jitter — the condition the
    adaptive loop is built to survive."""
    healthy = D.link_at(base.links[hop], 0.0)
    trace = D.ramp_trace(f"{healthy.name}_wan_ramp", healthy, D.DURESS,
                         t_start, t_end, jitter=jitter)
    return base.with_link(hop, trace, name=f"{base.name}_wan_ramp")


# --- curated WAN trace mini-library ------------------------------------------ #
# Named, replayable time-varying links for adaptive-under-streaming
# studies: each is a factory so every caller gets a fresh (immutable)
# LinkTrace.  ``traces.get(name)`` / the scenario registry's
# ``pi_pi_gpu_<trace>`` entries put them on hop 0 of the 3-stage chain.
TRACES = {
    # healthy LAN until t=3 s, then the paper's tc-netem duress — the
    # Sec. V-B experiment as a trace (sharpest possible degradation)
    "wan_step_drop": lambda: D.step_trace(
        "wan_step_drop", D.LAN_PI_GPU, D.DURESS, t_step=3.0, jitter=0.03),
    # LTE-like sawtooth: 4 s cells, each ramping LAN→duress over 60 %
    # of the period then snapping back (handover recovery)
    "lte_sawtooth": lambda: D.sawtooth_trace(
        "lte_sawtooth", D.LAN_PI_GPU, D.DURESS, period_s=4.0, n_periods=4,
        duty=0.6, jitter=0.05),
    # one congestion event: clean until t=2 s, fully congested by t=4 s,
    # recovered by t=7 s — the loop should migrate out *and back*
    "congestion_spike": lambda: D.spike_trace(
        "congestion_spike", D.LAN_PI_GPU, D.DURESS, t_start=2.0, t_peak=4.0,
        t_end=7.0, jitter=0.05),
    # slow monotone collapse (the registry wan-ramp shape, jittered)
    "wan_slow_ramp": lambda: D.ramp_trace(
        "wan_slow_ramp", D.LAN_PI_GPU, D.DURESS, t_start=2.0, t_end=8.0,
        jitter=0.05),
}


def get_trace(name: str) -> D.LinkTrace:
    try:
        return TRACES[name]()
    except KeyError:
        raise KeyError(f"unknown trace {name!r}; have "
                       f"{sorted(TRACES)}") from None


def with_trace(base: Scenario, trace_name: str, hop: int = 0) -> Scenario:
    """``base`` with the named curated trace on hop ``hop``."""
    return base.with_link(hop, get_trace(trace_name),
                          name=f"{base.name}_{trace_name}")


# --- the real local testbed (measured transports) ---------------------------- #
def local_chain(k: int = 3, transport: str = "socket") -> Scenario:
    """k worker *processes* on this host, every hop a real measured
    channel (loopback TCP by default, ``transport="shmem"`` for the
    shared-memory ring).  The LOOPBACK link is only the analytic
    stand-in the partitioner plans with — the pipeline measures the
    actual wire."""
    if k < 2:
        raise ValueError("need k >= 2 stages")
    return Scenario(f"local{k}_{transport}", (D.HOST_CPU,) * k,
                    (D.LOOPBACK,) * (k - 1),
                    transports=(transport,) * (k - 1))


# --- TPU-scale analogues ----------------------------------------------------- #
# The reference's copies: ``REGISTRY`` keeps them, no launcher of the port
# prices with them (the port's stages are the cards below).
def pods(n_pods: int = 2, chips_per_pod: int = 256,
         link: D.Link = D.DCN) -> Scenario:
    """n pods in a pipeline, DCN links between consecutive pods —
    the multi-pod mesh's ``pod`` axis as a ParetoPipe device chain."""
    devs = tuple(D.tpu_pod(chips_per_pod, name=f"pod{i}") for i in range(n_pods))
    return Scenario(f"pods{n_pods}x{chips_per_pod}", devs, (link,) * (n_pods - 1))


def pods_congested(n_pods: int = 2, chips_per_pod: int = 256) -> Scenario:
    """The duress analogue at datacenter scale: congested DCN."""
    s = pods(n_pods, chips_per_pod, link=D.DCN_CONGESTED)
    return dataclasses.replace(s, name=s.name + "_congested")


def chips_linear(n: int = 4, link: D.Link = D.ICI_V5E) -> Scenario:
    """A few chips in a ring/line over ICI — single-host pipelining."""
    devs = tuple(dataclasses.replace(D.TPU_V5E_CHIP, name=f"chip{i}")
                 for i in range(n))
    return Scenario(f"chips{n}_ici", devs, (link,) * (n - 1))


# --- the port's cards ---------------------------------------------------------- #
def card_pods(n_pods: int = 2, cards_per_pod: int = 1) -> Scenario:
    """n pods of ``cards_per_pod`` H100s in a pipeline, NVLink between
    consecutive pods: the port's ``pod`` axis as a ParetoPipe device
    chain (one card a stage on the host mesh, D·M on the ranks' pod
    mesh), the counterpart of ``pods``."""
    devs = tuple(D.h100_pod(cards_per_pod, name=f"pod{i}")
                 for i in range(n_pods))
    return Scenario(f"cards{n_pods}x{cards_per_pod}", devs,
                    (D.NVLINK4,) * (n_pods - 1))


REGISTRY = {
    "pi_to_pi": pi_to_pi,
    "pi_to_gpu": pi_to_gpu,
    "pi_pi_gpu": pi_pi_gpu,
    "pi_chain4": lambda: pi_chain(4),
    "pi_cluster4": lambda: pi_cluster(1),
    "pi_cluster5": lambda: pi_cluster(2),
    "pi_only3": lambda: pi_only_chain(3),
    "pi_only3_duress": lambda: duress(pi_only_chain(3)),
    "pi_to_pi_duress": lambda: duress(pi_to_pi()),
    "pi_to_gpu_duress": lambda: duress(pi_to_gpu()),
    "pi_to_gpu_wan_ramp": lambda: wan_ramp(pi_to_gpu()),
    "pi_pi_gpu_wan_ramp": lambda: wan_ramp(pi_pi_gpu()),
    "pi_pi_gpu_step_drop": lambda: with_trace(pi_pi_gpu(), "wan_step_drop"),
    "pi_pi_gpu_lte_sawtooth": lambda: with_trace(pi_pi_gpu(), "lte_sawtooth"),
    "pi_pi_gpu_congestion_spike": lambda: with_trace(pi_pi_gpu(),
                                                     "congestion_spike"),
    "local3_socket": lambda: local_chain(3, "socket"),
    "local3_shmem": lambda: local_chain(3, "shmem"),
    "pi_pi_gpu_socket": lambda: pi_pi_gpu().with_transport(
        "socket", name="pi_pi_gpu_socket"),
    "pi_pi_gpu_int8": lambda: pi_pi_gpu().with_codec(
        "int8", name="pi_pi_gpu_int8"),
    "pi_pi_gpu_congestion_spike_int8": lambda: with_trace(
        pi_pi_gpu(), "congestion_spike").with_codec(
        "int8", name="pi_pi_gpu_congestion_spike_int8"),
    "pods2": lambda: pods(2),
    "pods2_congested": lambda: pods_congested(2),
    "pods4": lambda: pods(4),
    "chips4_ici": lambda: chips_linear(4),
}


def get(name: str) -> Scenario:
    try:
        return REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; have {sorted(REGISTRY)}") from None


# --------------------------------------------------------------------------- #
# Named fault plans — chaos scripts for the fault-tolerance matrix.
# Factories import lazily (runtime.faults imports runtime.transport, which
# core must not depend on at module load).  Seqs are global batch indices
# on the feed hop (hop -1); worker kills name (stage, lane).
# --------------------------------------------------------------------------- #
def _plans():
    from ..runtime.faults import FaultPlan
    return {
        # the canonical restart drill: SIGKILL stage 1 mid-stream
        "kill_mid_stream": lambda: FaultPlan(seed=1).kill_worker(
            stage=1, at_seq=3),
        # replica failover: kill one lane of a replicated stage
        "lane_kill": lambda: FaultPlan(seed=2).kill_worker(
            stage=1, at_seq=3, lane=1),
        # WAN under duress: a stall, then a flap, on the feed hop
        "wan_duress": lambda: FaultPlan(seed=3)
            .stall(hop=-1, at_seq=2, for_s=0.3)
            .flap(hop=-1, at_seq=5, down_s=0.5),
        # lossy feed: a dropped and a duplicated frame
        "lossy_feed": lambda: FaultPlan(seed=4)
            .drop(hop=-1, at_seq=2)
            .duplicate(hop=-1, at_seq=5),
        # bit-rot on the wire: one corrupt frame header
        "header_rot": lambda: FaultPlan(seed=5).corrupt(hop=-1, at_seq=2),
    }


FAULT_PLANS = ("kill_mid_stream", "lane_kill", "wan_duress", "lossy_feed",
               "header_rot")


def get_fault_plan(name: str):
    """Build the named :class:`~repro_torch.runtime.faults.FaultPlan`."""
    try:
        return _plans()[name]()
    except KeyError:
        raise KeyError(
            f"unknown fault plan {name!r}; have {sorted(FAULT_PLANS)}") from None


# --------------------------------------------------------------------------- #
# Named tenant mixes — multi-tenant workload specs for the serving
# gateway (runtime/serve.py).  A mix is pure data, like a Scenario: who
# the tenants are, their latency SLOs, and the arrival pattern the
# fairness matrix / bench drive them with.
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant of the serving gateway: its latency SLO and the
    workload shape it contributes to a mix."""

    name: str
    slo_s: float = 0.5              # per-request latency SLO (queue+service)
    weight: float = 1.0             # relative admission share in the mix
    burst: int = 1                  # requests dumped per arrival event

    def __post_init__(self):
        if self.slo_s <= 0:
            raise ValueError(f"tenant {self.name}: need slo_s > 0")
        if self.burst < 1:
            raise ValueError(f"tenant {self.name}: need burst >= 1")


@dataclasses.dataclass(frozen=True)
class TenantMix:
    """A named multi-tenant workload: the tenants plus how their
    requests arrive ("uniform" = one request per tenant per round,
    "bursty" = each tenant dumps its ``burst`` requests per round)."""

    name: str
    tenants: tuple[TenantSpec, ...]
    arrival: str = "uniform"

    def __post_init__(self):
        if self.arrival not in ("uniform", "bursty"):
            raise ValueError(f"unknown arrival pattern {self.arrival!r}")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"mix {self.name}: duplicate tenant names")

    @property
    def n_tenants(self) -> int:
        return len(self.tenants)

    def spec(self, name: str) -> TenantSpec:
        for t in self.tenants:
            if t.name == name:
                return t
        raise KeyError(f"mix {self.name} has no tenant {name!r}")


def _uniform_tenants(n: int, slo_s: float = 0.5) -> tuple[TenantSpec, ...]:
    return tuple(TenantSpec(f"tenant{i}", slo_s=slo_s) for i in range(n))


def _bursty_tenants(n: int, slo_s: float = 0.5,
                    burst: int = 4) -> tuple[TenantSpec, ...]:
    # alternate steady and bursty tenants so the mix actually mixes
    return tuple(TenantSpec(f"tenant{i}", slo_s=slo_s,
                            burst=burst if i % 2 else 1) for i in range(n))


def _mixed_slo_tenants(n: int = 8) -> tuple[TenantSpec, ...]:
    # SLOs spread over an order of magnitude: strict interactive
    # tenants next to lax batch ones, the fleet controller's worst case
    slos = (0.15, 0.3, 0.5, 0.75, 1.0, 1.25, 1.5, 2.0)
    return tuple(TenantSpec(f"tenant{i}", slo_s=slos[i % len(slos)])
                 for i in range(n))


TENANT_MIXES: dict[str, "TenantMix"] = {
    "duo_uniform": TenantMix("duo_uniform", _uniform_tenants(2)),
    "duo_bursty": TenantMix("duo_bursty", _bursty_tenants(2),
                            arrival="bursty"),
    "octet_uniform": TenantMix("octet_uniform", _uniform_tenants(8)),
    "octet_bursty": TenantMix("octet_bursty", _bursty_tenants(8),
                              arrival="bursty"),
    "octet_mixed_slo": TenantMix("octet_mixed_slo", _mixed_slo_tenants(8)),
}


def get_tenant_mix(name: str) -> TenantMix:
    try:
        return TENANT_MIXES[name]
    except KeyError:
        raise KeyError(f"unknown tenant mix {name!r}; "
                       f"have {sorted(TENANT_MIXES)}") from None
