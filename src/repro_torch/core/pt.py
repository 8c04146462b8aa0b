"""Parallel-tempering state, its initialization and the monolithic run
(twin of `repro.core.pt`).

`PTConfig`, `init`, `run` and `make_run` are the JAX package's seed API:
``run`` advances ``n_sweeps`` sweeps interval by interval through the
engine's interval step (`repro_torch.engine.driver.make_interval_step`,
the code the chunked engine runs) and returns the whole per-interval
trace, so it is the engine's trajectory from the same state.  JAX's
``shard=`` argument is a GSPMD placement hint with no meaning in PyTorch:
it is refused by name (`NotImplementedError`); the port's multi-device
path is `repro_torch.engine.EngineConfig.mesh`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.core import keys

__all__ = ["PTConfig", "PTState", "init", "init_replicas", "run", "make_run",
           "map_states", "stack_states", "state_device"]


@dataclasses.dataclass
class PTState:
    """Device-resident simulation state of one chain.

    ``states`` is a tensor or a dict of tensors (the JAX pytree's leaves,
    e.g. the EA spin glass's ``{"spins", "jr", "jd"}``), each with a leading
    replica axis.  ``t`` and ``phase`` are () int64 device tensors, so the
    engine advances them without a host sync; ``key`` is the (2,) int64 run
    key.
    """

    states: Any  # (R, ...) tensor, or a dict of them
    energy: torch.Tensor  # (R,) f32, tracked incrementally
    rung: torch.Tensor  # (R,) int32 slot -> rung
    key: torch.Tensor  # (2,) int64 key words
    phase: torch.Tensor  # () int64 swap-phase counter
    t: torch.Tensor  # () int64 sweep counter


def map_states(states, fn: Callable[[torch.Tensor], torch.Tensor]):
    """``fn`` applied to every leaf of a state (a tensor or a dict of them)."""
    if isinstance(states, dict):
        return {k: fn(v) for k, v in states.items()}
    return fn(states)


def stack_states(items: list):
    """Per-replica states stacked along a new leading axis, leaf by leaf."""
    if isinstance(items[0], dict):
        return {k: torch.stack([s[k] for s in items]) for k in items[0]}
    return torch.stack(items)


def state_device(states) -> torch.device:
    """The device of a state's leaves."""
    leaf = next(iter(states.values())) if isinstance(states, dict) else states
    return leaf.device


def init_replicas(system, n_replicas: int, key: torch.Tensor) -> PTState:
    """Initial state exactly as the JAX twin builds it.

    ``k_init, k_run = split(key)``; the states are ``batched_init(system,
    k_init, R)`` and their energies ``batched_energy`` (`repro_torch.core.
    systems`); rungs are the identity; ``k_run`` keys the rest of the run.
    """
    from repro_torch.core.systems import batched_energy, batched_init

    k_init, k_run = keys.split(key)
    states = batched_init(system, k_init, n_replicas)
    energy = batched_energy(system, states)
    dev = state_device(states)
    return PTState(
        states=states,
        energy=energy.to(torch.float32),
        rung=torch.arange(n_replicas, dtype=torch.int32, device=dev),
        key=k_run,
        phase=torch.zeros((), dtype=torch.int64, device=dev),
        t=torch.zeros((), dtype=torch.int64, device=dev),
    )


@dataclasses.dataclass(frozen=True)
class PTConfig:
    """Static PT configuration (see `repro.core.pt.PTConfig`).

    Attributes:
      n_replicas: |R|.
      temps: ladder, cold->hot, a tuple of floats.
      swap_interval: sweeps between swap phases (0 disables swaps).
      criterion: "logistic" (paper) | "metropolis".
      swap_mode: "temp" (rungs move) | "state" (states move).
      record_interval: accepted for the JAX signature; every interval is
        recorded, as in the JAX twin's ``run``.
    """

    n_replicas: int
    temps: tuple
    swap_interval: int = 100
    criterion: str = "logistic"
    swap_mode: str = "temp"
    record_interval: int = 1

    @property
    def betas(self) -> np.ndarray:
        return 1.0 / np.asarray(self.temps, dtype=np.float32)

    def __post_init__(self):
        if len(self.temps) != self.n_replicas:
            raise ValueError(
                f"ladder has {len(self.temps)} rungs != n_replicas={self.n_replicas}"
            )
        if self.swap_mode not in ("temp", "state"):
            raise ValueError(f"bad swap_mode {self.swap_mode!r}")

    def step_spec(self, n_sweeps: int):
        """The engine `StepSpec` and interval count of ``n_sweeps`` sweeps."""
        from repro_torch.engine.driver import StepSpec

        interval = self.swap_interval if self.swap_interval > 0 else n_sweeps
        spec = StepSpec(
            n_replicas=self.n_replicas,
            sweeps_per_interval=interval,
            do_swap=self.swap_interval > 0,
            criterion=self.criterion,
            swap_mode=self.swap_mode,
        )
        return spec, max(n_sweeps // interval, 1)


def _refuse_shard(shard) -> None:
    if shard is not None:
        raise NotImplementedError(
            "shard= is a JAX GSPMD placement hint with no PyTorch meaning; run "
            "multi-device PT through repro_torch.engine.EngineConfig(mesh=MeshSpec(...))"
        )


def init(system, config: PTConfig, key: torch.Tensor, *, shard=None) -> PTState:
    """Seed-compatible `init` (`init_replicas` of ``config.n_replicas``) on
    the key's device."""
    _refuse_shard(shard)
    return init_replicas(system, config.n_replicas, key)


def run(system, config: PTConfig, state: PTState, n_sweeps: int,
        observables: Mapping[str, Callable] | None = None, shard=None):
    """Run ``n_sweeps`` sweeps of PT; returns ``(final_state, trace)``.

    ``trace`` maps ``energy``, each observable (a batched ``(R, ...) ->
    (R,)`` function) and ``swap_accept`` / ``swap_prob`` / ``swap_attempt``
    to ``(intervals, R)`` tensors in rung order, one row an interval, as
    the JAX twin's scan stacks them.  Each interval is one call of the
    engine's interval step, so the trajectory is the engine's from the same
    state; nothing waits for the card between intervals.
    """
    from repro_torch.engine.driver import make_interval_step

    _refuse_shard(shard)
    spec, n_intervals = config.step_spec(n_sweeps)
    step = make_interval_step(system, spec, observables)
    betas = torch.from_numpy(config.betas).to(state.energy.device)
    recs = []
    for _ in range(n_intervals):
        state, rec = step(state, betas)
        recs.append(rec)
    return state, {k: torch.stack([r[k] for r in recs]) for k in recs[0]}


def make_run(system, config: PTConfig, n_sweeps: int, observables=None, shard=None):
    """``state -> run(system, config, state, n_sweeps, observables)``."""
    _refuse_shard(shard)

    def fn(state):
        return run(system, config, state, n_sweeps, observables)

    return fn
