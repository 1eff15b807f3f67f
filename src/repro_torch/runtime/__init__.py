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

Not ported yet (ROADMAP queue 1): ``AdaptiveRuntime`` (item 7) and the
serving gateway (item 8).
"""
from .edge import EdgePipeline, PipelineResult, StageStats, Worker
from .faults import (BackoffPolicy, ChaosChannel, FaultEvent, FaultPlan,
                     RecoveryRecord, drain_injections, drain_recoveries)
from .sanitizer import (SanitizedChannel, SanitizerError, Violation,
                        drain_violations)
from .session import (AdaptiveController, CancelRecord, Controller,
                      LoopRecord, MigrationPolicy, PinnedController, Session)
from .transport import (Channel, HopSpec, TransferRecord, Transport,
                        TransportError, TransportTimeout, get_transport,
                        record_trace, register_transport)

__all__ = [
    "LoopRecord",
    "Session", "Controller", "PinnedController", "AdaptiveController",
    "MigrationPolicy", "CancelRecord",
    "EdgePipeline", "PipelineResult", "StageStats", "Worker",
    "Channel", "HopSpec", "TransferRecord", "Transport", "TransportError",
    "TransportTimeout", "get_transport", "record_trace", "register_transport",
    "SanitizedChannel", "SanitizerError", "Violation", "drain_violations",
    "FaultPlan", "FaultEvent", "ChaosChannel", "BackoffPolicy",
    "RecoveryRecord", "drain_recoveries", "drain_injections",
]
