"""Chunked streaming PT engine (twin of `repro.engine`), one chain, one device."""
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
