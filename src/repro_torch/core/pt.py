"""Parallel-tempering state and its initialization (twin of `repro.core.pt`)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core import keys

__all__ = ["PTState", "init_replicas", "map_states", "stack_states", "state_device"]


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

    ``k_init, k_run = split(key)``; replica r starts from ``split(k_init,
    R)[r]``, through the system's ``init_state_batched`` where it has one,
    else its per-replica ``init_state`` stacked (JAX's ``vmap``); energies
    are recomputed from the states (``batched_energy``, else per replica);
    rungs are the identity; ``k_run`` keys the rest of the run.
    """
    k_init, k_run = keys.split(key)
    replica_keys = keys.split(k_init, n_replicas)
    batched = getattr(system, "init_state_batched", None)
    if batched is not None:
        states = batched(replica_keys)
    else:
        states = stack_states([system.init_state(k) for k in replica_keys])
    energy_fn = getattr(system, "batched_energy", None)
    if energy_fn is not None:
        energy = energy_fn(states)
    else:
        energy = torch.stack([system.energy(map_states(states, lambda x, i=i: x[i]))
                              for i in range(n_replicas)])
    dev = state_device(states)
    return PTState(
        states=states,
        energy=energy.to(torch.float32),
        rung=torch.arange(n_replicas, dtype=torch.int32, device=dev),
        key=k_run,
        phase=torch.zeros((), dtype=torch.int64, device=dev),
        t=torch.zeros((), dtype=torch.int64, device=dev),
    )
