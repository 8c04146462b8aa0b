"""Chunked streaming PT engine (twin of `repro.engine`) on one device, with
the ensemble axis (``n_chains``)."""
from repro_torch.engine.adapt import AdaptConfig, AdaptState
from repro_torch.engine.driver import (
    AdaptInfo,
    ChunkInfo,
    Engine,
    EngineConfig,
    EngineState,
    RunResult,
    StepSpec,
    make_interval_step,
)

__all__ = [
    "AdaptConfig",
    "AdaptInfo",
    "AdaptState",
    "ChunkInfo",
    "Engine",
    "EngineConfig",
    "EngineState",
    "RunResult",
    "StepSpec",
    "make_interval_step",
]
