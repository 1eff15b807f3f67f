"""Executable runtime: the measured half of the reproduction.

Public API:
    EdgePipeline, PipelineResult      — k-stage executable pipeline over
                                        emulated (threads) or socket /
                                        shmem (worker processes) hops,
                                        on the card (or the CPU on
                                        request)
    Session, Controller,
    PinnedController,
    AdaptiveController, LoopRecord,
    MigrationPolicy                   — the streaming Session API: one
                                        always-pipelined entrypoint
                                        (``EdgePipeline.session``) with
                                        pluggable controllers and
                                        in-flight drain/drop migration
    AdaptiveRuntime                   — closed measure→estimate→re-solve→
                                        migrate loop (a Session shim)
    Transport, Channel, TransferRecord,
    register_transport, get_transport — the hop transport API
                                        ("emulated" | "socket" | "shmem")
    record_trace                      — measured records → replayable
                                        LinkTrace (seed the emulator)
    SanitizedChannel, SanitizerError,
    Violation, drain_violations       — the live protocol sanitizer
    FaultPlan, FaultEvent,
    ChaosChannel, BackoffPolicy,
    RecoveryRecord, drain_recoveries,
    drain_injections                  — deterministic fault injection
                                        (``EdgePipeline(fault_plan=...)``)
                                        and the supervised-recovery
                                        records it produces
    Gateway, ClientSession,
    QoSRecord, drain_qos,
    FleetController, FleetObjectives,
    CancelRecord                      — the multi-tenant serving gateway
                                        (micro-batching, SLO-aware AIMD
                                        admission, per-request QoS,
                                        CANCEL-fence flush) and the
                                        fleet-objective controller
"""
from .adaptive import AdaptiveRuntime
from .edge import EdgePipeline, PipelineResult, StageStats, Worker
from .faults import (BackoffPolicy, ChaosChannel, FaultEvent, FaultPlan,
                     RecoveryRecord, drain_injections, drain_recoveries)
from .sanitizer import (SanitizedChannel, SanitizerError, Violation,
                        drain_violations)
from .serve import (ClientSession, FleetController, FleetObjectives, Gateway,
                    QoSRecord, drain_qos)
from .session import (AdaptiveController, CancelRecord, Controller,
                      LoopRecord, MigrationPolicy, PinnedController, Session)
from .transport import (Channel, HopSpec, TransferRecord, Transport,
                        TransportError, TransportTimeout, get_transport,
                        record_trace, register_transport)

__all__ = [
    "AdaptiveRuntime", "LoopRecord",
    "Session", "Controller", "PinnedController", "AdaptiveController",
    "MigrationPolicy", "CancelRecord",
    "EdgePipeline", "PipelineResult", "StageStats", "Worker",
    "Channel", "HopSpec", "TransferRecord", "Transport", "TransportError",
    "TransportTimeout", "get_transport", "record_trace", "register_transport",
    "SanitizedChannel", "SanitizerError", "Violation", "drain_violations",
    "FaultPlan", "FaultEvent", "ChaosChannel", "BackoffPolicy",
    "RecoveryRecord", "drain_recoveries", "drain_injections",
    "Gateway", "ClientSession", "QoSRecord", "drain_qos",
    "FleetController", "FleetObjectives",
]
