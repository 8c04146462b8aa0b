"""Declarative run API of the port (twin of `repro.api`)."""
from repro_torch.api.session import (
    Callback,
    CheckpointCallback,
    EarlyStopCallback,
    ObsCallback,
    ProgressCallback,
    Session,
    SessionResult,
    TraceWriterCallback,
)
from repro_torch.api.spec import (
    SPEC_VERSION,
    AdaptSpec,
    EngineSpec,
    ExchangeSpec,
    LadderSpec,
    PhaseSpec,
    RunSpec,
    ScheduleSpec,
    SystemSpec,
    simple_schedule,
)

__all__ = [
    "SPEC_VERSION",
    "AdaptSpec",
    "Callback",
    "CheckpointCallback",
    "EarlyStopCallback",
    "EngineSpec",
    "ExchangeSpec",
    "LadderSpec",
    "ObsCallback",
    "PhaseSpec",
    "ProgressCallback",
    "RunSpec",
    "ScheduleSpec",
    "Session",
    "SessionResult",
    "SystemSpec",
    "TraceWriterCallback",
    "simple_schedule",
]
