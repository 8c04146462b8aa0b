"""System constructor + named-observable registry and the validation zoo
(twin of `repro.core.systems`).

The port registers the JAX package's five systems: the Ising and q-state
Potts models, the Gaussian mixture, the EA spin glass and the HP lattice
protein.  Observables are batched: each factory takes the system and
returns a function ``(R, ...) -> (R,)`` (for EA the state is a dict of
``(R, H, W)`` leaves).  `REGISTRY` holds the zoo entries of all five with
the JAX package's params, ladders and schedules.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import torch

from repro_torch.core.gaussian import GaussianMixture
from repro_torch.core.hp import HPChain, radius_of_gyration_sq
from repro_torch.core.ising import IsingSystem, lattice_energy, magnetization
from repro_torch.core.potts import PottsSystem, potts_magnetization
from repro_torch.core.spin_glass import EASpinGlass

__all__ = [
    "SystemEntry",
    "CONSTRUCTORS",
    "make_system",
    "named_observables",
    "RegisteredSystem",
    "REGISTRY",
    "registered",
]

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
    "gaussian": SystemEntry(
        name="gaussian",
        build=GaussianMixture,
        observables={
            "x": lambda s: (lambda x: x),
            "absx": lambda s: torch.abs,
        },
    ),
    "potts": SystemEntry(
        name="potts",
        build=PottsSystem,
        observables={
            "pmag": lambda s: (lambda x: potts_magnetization(x, s.q)),
        },
    ),
    "ea_spin_glass": SystemEntry(
        name="ea_spin_glass",
        build=EASpinGlass,
        observables={
            "absmag": lambda s: (
                lambda x: x["spins"].to(torch.float32).mean(dim=(-2, -1)).abs()
            ),
        },
    ),
    "hp_protein": SystemEntry(
        name="hp_protein",
        build=HPChain,
        observables={
            "rg2": lambda s: radius_of_gyration_sq,
        },
    ),
}


def make_system(name: str, params: Mapping[str, Any] | None = None):
    """Instantiate a registered system from JSON-able params."""
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


# -- validation system zoo -------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RegisteredSystem:
    """One system-zoo entry: a small instance with an exact ground truth.

    Fields and defaults follow `repro.core.systems.RegisteredSystem`:
    ``params`` name the instance through `CONSTRUCTORS`, ``temps`` is the
    initial ladder (cold→hot), the engine runs ``n_chains`` chains with a
    swap every ``swap_interval`` sweeps, ``burn_sweeps`` adapt and
    equilibrate (``adapt_rounds`` retunes), then ``n_batches`` windows of
    ``sweeps_per_batch`` sweeps are measured.  ``slow`` marks an exact
    reference that costs more than ~10 s.
    """

    name: str
    params: Mapping[str, Any]
    observable_names: tuple
    temps: tuple
    swap_interval: int = 2
    n_chains: int = 2
    chunk_intervals: int = 25
    burn_sweeps: int = 1200
    n_batches: int = 8
    sweeps_per_batch: int = 400
    adapt_rounds: int = 2
    slow: bool = False

    def make(self) -> Any:
        """The validation-scale system instance (via the constructor registry)."""
        return make_system(self.name, self.params)

    def observables(self, system: Any) -> dict[str, Callable]:
        """Resolved batched observable fns for ``system``."""
        return named_observables(self.name, system, self.observable_names)


# Glauber per-site acceptance keeps the simultaneous checkerboard update
# strictly stochastic on the tiny validation lattices (the JAX zoo's choice).
REGISTRY: dict[str, RegisteredSystem] = {
    "ising": RegisteredSystem(
        name="ising",
        params={"length": 4, "accept_rule": "glauber"},
        observable_names=("absmag",),
        temps=(1.5, 2.0, 2.6, 3.4, 4.4),
    ),
    "gaussian": RegisteredSystem(
        name="gaussian",
        params={"mus": (-3.0, 3.0), "sigmas": (0.8, 0.8),
                "weights": (0.5, 0.5), "step_size": 1.0},
        observable_names=("absx",),
        temps=(1.0, 1.8, 3.2, 5.6, 10.0),
    ),
    "potts": RegisteredSystem(
        name="potts",
        params={"shape": (4, 4), "q": 3, "accept_rule": "glauber",
                "use_pallas": True},
        observable_names=("pmag",),
        temps=(0.7, 1.0, 1.4, 2.0, 2.9),
        slow=True,  # exact reference enumerates 3^16 ~ 43M states (~20 s)
    ),
    "ea_spin_glass": RegisteredSystem(
        name="ea_spin_glass",
        params={"shape": (4, 4), "disorder_seed": 1, "accept_rule": "glauber"},
        observable_names=("absmag",),
        temps=(0.8, 1.2, 1.8, 2.7, 4.0),
    ),
    "hp_protein": RegisteredSystem(
        name="hp_protein",
        params={"sequence": "HPHPPHHPHH"},
        observable_names=("rg2",),
        temps=(0.6, 0.9, 1.4, 2.2, 3.4),
        # chain moves are serial: a lighter measurement window than the
        # lattice systems' (the JAX zoo's schedule)
        sweeps_per_batch=300,
        burn_sweeps=900,
    ),
}


def registered(name: str) -> RegisteredSystem:
    """The zoo entry ``name`` (`KeyError` for a name the zoo lacks)."""
    if name not in REGISTRY:
        raise KeyError(f"unknown system {name!r}; registered: {sorted(REGISTRY)}")
    return REGISTRY[name]
