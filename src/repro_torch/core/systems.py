"""The `System` interface, the constructor + named-observable registry and
the validation zoo (twin of `repro.core.systems`).

A system is what PT samples.  The port's interface is batched over the
replica axis (the JAX package ``vmap``s per-replica methods instead): see
`System`.  `batched_init` / `batched_energy` build a batch from a key and
price it, falling back to per-replica ``init_state`` / ``energy`` for a
system that has only those.

The port registers the JAX package's five systems: the Ising and q-state
Potts models, the Gaussian mixture, the EA spin glass and the HP lattice
protein.  Observables are batched: each factory takes the system and
returns a function ``(R, ...) -> (R,)`` (for EA the state is a dict of
``(R, H, W)`` leaves).  `REGISTRY` holds the zoo entries of all five with
the JAX package's params, ladders and schedules; `register_constructor` and
`register` add a user's own system to both, after which `repro_torch.api.
RunSpec` names it and `repro_torch.validate` conformance-tests it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Protocol, Sequence, runtime_checkable

import torch

from repro_torch.core import keys
from repro_torch.core.pt import map_states, stack_states

from repro_torch.core.gaussian import GaussianMixture
from repro_torch.core.hp import HPChain, radius_of_gyration_sq
from repro_torch.core.ising import IsingSystem, lattice_energy, magnetization
from repro_torch.core.potts import PottsSystem, potts_magnetization
from repro_torch.core.spin_glass import EASpinGlass

__all__ = [
    "System",
    "batched_init",
    "batched_energy",
    "SystemEntry",
    "CONSTRUCTORS",
    "register_constructor",
    "make_system",
    "named_observables",
    "RegisteredSystem",
    "REGISTRY",
    "register",
    "registered",
]

State = Any  # a tensor with a leading replica axis, or a dict of them


@runtime_checkable
class System(Protocol):
    """What a system exposes to be PT-sampled by the port, batched over R
    replicas (a state is a tensor or a dict of tensors, each ``(R, ...)``).

    ``batched_mcmc_step`` draws replica r's randomness from the JAX
    engine's per-sweep key ``fold_in(fold_in(key, 2t), replica_offset +
    r)`` (`core.keys.replica_keys`); ``replica_offset`` is the first global
    slot of a replica shard on a mesh, 0 on one device.  A system may have
    only per-replica ``init_state(key)`` / ``energy(state)`` instead of the
    batched pair: `batched_init` / `batched_energy` stack them.
    """

    def init_state_batched(self, keys_: torch.Tensor) -> State:
        """R states, replica r from key ``keys_[r]`` (``keys_`` is (R, 2))."""
        ...

    def batched_energy(self, states: State) -> torch.Tensor:
        """(R,) f32 energies; the target density is exp(-beta * E)."""
        ...

    def batched_mcmc_step(self, key: torch.Tensor, t, states: State, betas: torch.Tensor,
                          replica_offset: int = 0):
        """One MH step of every replica at its beta; returns ``(states',
        delta_e (R,) f32, n_accepted (R,) int32)`` with ``delta_e`` the
        exact energy change (the engine tracks energies incrementally)."""
        ...


def batched_init(system, key: torch.Tensor, n_replicas: int) -> State:
    """``n_replicas`` initial states from one key: replica r from
    ``split(key, R)[r]``, through ``init_state_batched`` where the system
    has it, else its per-replica ``init_state`` stacked (JAX's ``vmap`` over
    the same keys).  A system with ``init_state_from_key(key, R)`` draws
    all R from the unsplit key instead (JAX's natively batched
    ``init_state_batched(key, R)``, the LM system's)."""
    whole = getattr(system, "init_state_from_key", None)
    if whole is not None:
        return whole(key, n_replicas)
    replica_keys = keys.split(key, n_replicas)
    fast = getattr(system, "init_state_batched", None)
    if fast is not None:
        return fast(replica_keys)
    return stack_states([system.init_state(k) for k in replica_keys])


def batched_energy(system, states: State) -> torch.Tensor:
    """(R,) energies: ``system.batched_energy``, else per-replica ``energy``."""
    fast = getattr(system, "batched_energy", None)
    if fast is not None:
        return fast(states)
    n = (next(iter(states.values())) if isinstance(states, dict) else states).shape[0]
    return torch.stack([system.energy(map_states(states, lambda x, i=i: x[i]))
                        for i in range(n)])


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


def register_constructor(
    name: str,
    build: Callable[..., Any],
    observables: Mapping[str, Callable[[Any], Callable]] | None = None,
) -> SystemEntry:
    """Make a system family nameable: ``build(**params)`` constructs it and
    each observable factory maps an instance to a batched ``(R, ...) ->
    (R,)`` function.  A name can be registered once."""
    if name in CONSTRUCTORS:
        raise ValueError(f"system constructor {name!r} already registered")
    entry = SystemEntry(name=name, build=build, observables=dict(observables or {}))
    CONSTRUCTORS[name] = entry
    return entry


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


def register(entry: RegisteredSystem) -> RegisteredSystem:
    """Add a zoo entry (its name must be a registered constructor, with an
    exact reference in `repro_torch.validate.conformance.EXACT` for the
    conformance gate).  A name can be registered once."""
    if entry.name in REGISTRY:
        raise ValueError(f"system {entry.name!r} already registered")
    REGISTRY[entry.name] = entry
    return entry


def registered(name: str) -> RegisteredSystem:
    """The zoo entry ``name`` (`KeyError` for a name the zoo lacks)."""
    if name not in REGISTRY:
        raise KeyError(f"unknown system {name!r}; registered: {sorted(REGISTRY)}")
    return REGISTRY[name]
