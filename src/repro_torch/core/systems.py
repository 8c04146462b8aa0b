"""System constructor + named-observable registry (twin of `repro.core.systems`).

The port registers the Ising and q-state Potts models.  Observables are batched: each
factory takes the system and returns a function ``(R, ...) -> (R,)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

from repro_torch.core.ising import IsingSystem, lattice_energy, magnetization
from repro_torch.core.potts import PottsSystem, potts_magnetization

__all__ = ["SystemEntry", "CONSTRUCTORS", "make_system", "named_observables"]

# systems of the JAX package that this port does not run yet
NOT_PORTED = ("gaussian", "ea_spin_glass", "hp_protein")


@dataclasses.dataclass(frozen=True)
class SystemEntry:
    name: str
    build: Callable[..., Any]
    observables: Mapping[str, Callable[[Any], Callable]]


CONSTRUCTORS: dict[str, SystemEntry] = {
    "ising": SystemEntry(
        name="ising",
        build=IsingSystem,
        observables={
            "mag": lambda s: magnetization,
            "absmag": lambda s: (lambda x: magnetization(x).abs()),
            "energy_per_site": lambda s: (
                lambda x: lattice_energy(x, s.j, s.b) / (s.length * s.length)
            ),
        },
    ),
    "potts": SystemEntry(
        name="potts",
        build=PottsSystem,
        observables={
            "pmag": lambda s: (lambda x: potts_magnetization(x, s.q)),
        },
    ),
}


def make_system(name: str, params: Mapping[str, Any] | None = None):
    """Instantiate a registered system from JSON-able params."""
    if name in NOT_PORTED:
        raise NotImplementedError(f"not yet ported: system {name!r}")
    if name not in CONSTRUCTORS:
        raise KeyError(f"unknown system {name!r}; registered: {sorted(CONSTRUCTORS)}")
    return CONSTRUCTORS[name].build(**dict(params or {}))


def named_observables(name: str, system: Any, names: Sequence[str]) -> dict[str, Callable]:
    """Resolve observable names to batched functions for ``system``."""
    avail = CONSTRUCTORS[name].observables
    out = {}
    for obs in names:
        if obs not in avail:
            raise KeyError(
                f"system {name!r} has no observable {obs!r}; registered: {sorted(avail)}"
            )
        out[obs] = avail[obs](system)
    return out
