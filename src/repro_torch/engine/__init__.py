"""Chunked streaming PT engine (twin of `repro.engine`) on one device or a
mesh of ranks, with the ensemble axis (``n_chains``), and its online
statistics (`repro_torch.engine.stats`, re-exported here as in the JAX
package)."""
from repro_torch.engine.adapt import AdaptConfig, AdaptState
from repro_torch.engine.driver import (
    AdaptInfo,
    ChunkInfo,
    Engine,
    EngineConfig,
    EngineState,
    RunResult,
    StepSpec,
    make_ensemble_step,
    make_interval_step,
    make_sharded_interval_step,
)
from repro_torch.engine.stats import (
    OnlineStats,
    chain_block,
    chain_slice,
    combine_chains,
    init_stats,
    summarize,
    update_stats,
)

__all__ = [
    "AdaptConfig",
    "AdaptInfo",
    "AdaptState",
    "ChunkInfo",
    "Engine",
    "EngineConfig",
    "EngineState",
    "OnlineStats",
    "RunResult",
    "StepSpec",
    "chain_block",
    "chain_slice",
    "combine_chains",
    "init_stats",
    "make_ensemble_step",
    "make_interval_step",
    "make_sharded_interval_step",
    "summarize",
    "update_stats",
]
