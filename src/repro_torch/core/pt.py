"""Parallel-tempering state and its initialization (twin of `repro.core.pt`)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import keys

__all__ = ["PTState", "init_replicas"]


@dataclasses.dataclass
class PTState:
    """Device-resident simulation state of one chain.

    ``t`` and ``phase`` are () int64 device tensors, so the engine advances
    them without a host sync; ``key`` is the (2,) int64 run key.
    """

    states: torch.Tensor  # (R, L, L) int8
    energy: torch.Tensor  # (R,) f32, tracked incrementally
    rung: torch.Tensor  # (R,) int32 slot -> rung
    key: torch.Tensor  # (2,) int64 key words
    phase: torch.Tensor  # () int64 swap-phase counter
    t: torch.Tensor  # () int64 sweep counter


def init_replicas(system, n_replicas: int, key: torch.Tensor) -> PTState:
    """Initial state exactly as the JAX twin builds it.

    ``k_init, k_run = split(key)``; replica r starts from ``split(k_init,
    R)[r]``; energies are recomputed from the lattices; rungs are the
    identity; ``k_run`` keys the rest of the run.
    """
    k_init, k_run = keys.split(key)
    states = system.init_state_batched(keys.split(k_init, n_replicas))
    dev = states.device
    return PTState(
        states=states,
        energy=system.batched_energy(states).to(torch.float32),
        rung=torch.arange(n_replicas, dtype=torch.int32, device=dev),
        key=k_run,
        phase=torch.zeros((), dtype=torch.int64, device=dev),
        t=torch.zeros((), dtype=torch.int64, device=dev),
    )
