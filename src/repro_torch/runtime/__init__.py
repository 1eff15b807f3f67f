"""Executable runtime: the measured half of the reproduction.

Public API:
    EdgePipeline, PipelineResult      — k-stage executable pipeline over
                                        the emulated hop transport, on
                                        the card (or the CPU on request)
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

Not ported yet (ROADMAP queue 1): the socket/shmem process transports,
the sanitizer and fault injection (item 6), ``AdaptiveRuntime`` (item
7) and the serving gateway (item 8).
"""
from .edge import EdgePipeline, PipelineResult, StageStats, Worker
from .session import (AdaptiveController, CancelRecord, Controller,
                      LoopRecord, MigrationPolicy, PinnedController, Session)
from .transport import (Channel, HopSpec, TransferRecord, Transport,
                        TransportError, TransportTimeout, get_transport,
                        register_transport)

__all__ = [
    "LoopRecord",
    "Session", "Controller", "PinnedController", "AdaptiveController",
    "MigrationPolicy", "CancelRecord",
    "EdgePipeline", "PipelineResult", "StageStats", "Worker",
    "Channel", "HopSpec", "TransferRecord", "Transport", "TransportError",
    "TransportTimeout", "get_transport", "register_transport",
]
