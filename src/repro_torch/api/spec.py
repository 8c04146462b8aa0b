"""The `RunSpec` tree (twin of `repro.api.spec`): reads the same JSON files.

``spec_version`` 1, strict keys, lists canonicalized to tuples so
``RunSpec.from_json(spec.to_json()) == spec``.  ``engine.mesh`` parses into
a `repro_torch.core.distributed.MeshSpec`.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Mapping

import numpy as np

from repro_torch.core import ladder as ladder_lib
from repro_torch.core import systems as systems_lib
from repro_torch.core.distributed import MeshSpec
from repro_torch.engine import AdaptConfig, EngineConfig
from repro_torch.engine.adapt import ADAPT_MODES
from repro_torch.exchange import available_strategies, make_strategy

__all__ = [
    "SPEC_VERSION",
    "SystemSpec",
    "LadderSpec",
    "EngineSpec",
    "ExchangeSpec",
    "AdaptSpec",
    "PhaseSpec",
    "ScheduleSpec",
    "RunSpec",
    "simple_schedule",
]

SPEC_VERSION = 1


def _freeze(value):
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    if isinstance(value, dict):
        return {k: _freeze(v) for k, v in value.items()}
    return value


def _check_keys(data: Mapping, allowed, what: str):
    unknown = set(data) - set(allowed)
    if unknown:
        raise ValueError(
            f"unknown key(s) {sorted(unknown)} in {what}; allowed: {sorted(allowed)}"
        )


def _fields(cls):
    return [f.name for f in dataclasses.fields(cls)]


def _from_dict(cls, data: Mapping, what: str):
    if not isinstance(data, Mapping):
        raise ValueError(f"{what} must be an object, got {type(data).__name__}")
    _check_keys(data, _fields(cls), what)
    return cls(**{k: _freeze(v) for k, v in data.items()})


def _to_dict(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _to_dict(v) for k, v in obj.items()}
    return obj


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    """Constructor-registry name + JSON-able params."""

    name: str
    params: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "params", _freeze(dict(self.params)))

    def build(self):
        return systems_lib.make_system(self.name, self.params)

    def observables(self, system, names) -> dict:
        return systems_lib.named_observables(self.name, system, names)


@dataclasses.dataclass(frozen=True)
class LadderSpec:
    """Initial ladder, cold→hot: paper / linear / geometric / custom."""

    kind: str = "paper"
    n_replicas: int = 8
    t_min: float = 1.0
    t_max: float = 4.0
    temps: tuple | None = None

    def __post_init__(self):
        if self.kind not in ("paper", "linear", "geometric", "custom"):
            raise ValueError(f"bad ladder kind {self.kind!r}")
        if self.temps is not None:
            object.__setattr__(self, "temps", tuple(float(t) for t in self.temps))
        if self.kind == "custom":
            if not self.temps:
                raise ValueError("custom ladder needs explicit temps")
            if len(self.temps) != self.n_replicas:
                raise ValueError(
                    f"custom ladder has {len(self.temps)} rungs "
                    f"!= n_replicas={self.n_replicas}"
                )
        elif self.temps is not None:
            raise ValueError(f"temps only valid with kind='custom', not {self.kind!r}")
        if self.n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")

    def build(self) -> np.ndarray:
        if self.kind == "custom":
            temps = self.temps
        elif self.kind == "paper":
            temps = ladder_lib.paper_ladder(
                self.n_replicas, self.t_min, self.t_max - self.t_min
            )
        elif self.kind == "linear":
            temps = ladder_lib.linear_ladder(self.n_replicas, self.t_min, self.t_max)
        else:
            temps = ladder_lib.geometric_ladder(self.n_replicas, self.t_min, self.t_max)
        return np.asarray(temps, np.float64)


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Execution knobs (mirror of `EngineConfig` minus n_replicas/exchange).

    ``mesh`` (optional) runs the engine as one rank of an (ensemble x
    replica) mesh: a nested `MeshSpec`, serialized as ``{"ensemble": E,
    "replica": D}``; null keeps the single-device path.
    """

    swap_interval: int = 100
    criterion: str = "logistic"
    swap_mode: str = "temp"
    chunk_intervals: int = 8
    n_chains: int = 1
    record_trace: bool = False
    track_stats: bool = True
    measure_interval: int = 100
    donate: bool = True
    mesh: MeshSpec | None = None

    def __post_init__(self):
        if self.criterion not in ("logistic", "metropolis"):
            raise ValueError(
                f"unknown criterion {self.criterion!r}; allowed: ['logistic', 'metropolis']"
            )
        if self.swap_mode not in ("temp", "state"):
            raise ValueError(
                f"unknown swap_mode {self.swap_mode!r}; allowed: ['state', 'temp']"
            )
        if self.mesh is not None and not isinstance(self.mesh, MeshSpec):
            object.__setattr__(self, "mesh", _from_dict(MeshSpec, self.mesh, "engine.mesh"))

    def build(self, n_replicas: int, exchange=None) -> EngineConfig:
        # asdict flattens the nested MeshSpec; EngineConfig takes the dict form
        return EngineConfig(
            n_replicas=n_replicas, exchange=exchange, **dataclasses.asdict(self)
        )


@dataclasses.dataclass(frozen=True)
class ExchangeSpec:
    """Replica-exchange strategy by name (``window`` only for "windowed")."""

    strategy: str = "deo"
    window: int = 4

    def __post_init__(self):
        if self.strategy not in available_strategies():
            raise ValueError(
                f"unknown exchange strategy {self.strategy!r}; "
                f"allowed: {available_strategies()}"
            )
        if self.window < 2:
            raise ValueError(f"exchange window must be >= 2, got {self.window}")

    def build(self):
        params = {"window": self.window} if self.strategy == "windowed" else {}
        return make_strategy(self.strategy, params)


@dataclasses.dataclass(frozen=True)
class AdaptSpec:
    """Ladder-feedback knobs (mirror of `AdaptConfig`)."""

    target: float = 0.23
    rate: float = 0.5
    min_attempts_per_pair: int = 20
    max_rounds: int | None = None
    mode: str = "acceptance"
    flow_min_visits: int = 100

    def __post_init__(self):
        if self.mode not in ADAPT_MODES:
            raise ValueError(
                f"unknown adapt mode {self.mode!r}; allowed: {list(ADAPT_MODES)}"
            )

    def build(self) -> AdaptConfig:
        return AdaptConfig(**dataclasses.asdict(self))


@dataclasses.dataclass(frozen=True)
class PhaseSpec:
    """One schedule phase: ``n_sweeps`` sweeps, optional adapt / stats reset."""

    name: str
    n_sweeps: int
    adapt: bool = False
    reset_stats: bool = False

    def __post_init__(self):
        if self.n_sweeps < 1:
            raise ValueError(f"phase {self.name!r}: n_sweeps must be >= 1")


@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    """Ordered phases run back to back on one engine state."""

    phases: tuple = ()

    def __post_init__(self):
        phases = tuple(
            p if isinstance(p, PhaseSpec) else _from_dict(PhaseSpec, p, "phase")
            for p in self.phases
        )
        object.__setattr__(self, "phases", phases)
        names = [p.name for p in phases]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate phase names in schedule: {names}")
        if not phases:
            raise ValueError("schedule needs at least one phase")

    @property
    def total_sweeps(self) -> int:
        return sum(p.n_sweeps for p in self.phases)


def simple_schedule(burn_sweeps: int, measure_sweeps: int) -> ScheduleSpec:
    """Adapt + equilibrate, then measure with fresh accumulators."""
    return ScheduleSpec(phases=(
        PhaseSpec(name="burn", n_sweeps=burn_sweeps, adapt=True),
        PhaseSpec(name="measure", n_sweeps=measure_sweeps, reset_stats=True),
    ))


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """Complete serializable description of one PT run."""

    system: SystemSpec
    ladder: LadderSpec
    schedule: ScheduleSpec
    engine: EngineSpec = EngineSpec()
    exchange: ExchangeSpec = ExchangeSpec()
    adapt: AdaptSpec | None = None
    observables: tuple = ()
    seed: int = 0
    spec_version: int = SPEC_VERSION

    def __post_init__(self):
        object.__setattr__(self, "observables", tuple(str(o) for o in self.observables))
        if self.spec_version != SPEC_VERSION:
            raise ValueError(
                f"unsupported spec_version {self.spec_version!r} "
                f"(this build reads version {SPEC_VERSION})"
            )
        interval = (
            self.engine.swap_interval if self.engine.swap_interval > 0
            else self.engine.measure_interval
        )
        for phase in self.schedule.phases:
            if phase.adapt and self.adapt is None:
                raise ValueError(
                    f"phase {phase.name!r} sets adapt=True but the spec has no AdaptSpec"
                )
            if phase.n_sweeps % interval != 0:
                raise ValueError(
                    f"phase {phase.name!r}: n_sweeps={phase.n_sweeps} is not "
                    f"a multiple of the engine interval ({interval} sweeps)"
                )

    def to_dict(self) -> dict:
        return _to_dict(self)

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, data: Mapping) -> "RunSpec":
        if not isinstance(data, Mapping):
            raise ValueError(f"run spec must be an object, got {type(data).__name__}")
        _check_keys(data, _fields(cls), "run spec")
        version = data.get("spec_version", SPEC_VERSION)
        if version != SPEC_VERSION:
            raise ValueError(
                f"unsupported spec_version {version!r} "
                f"(this build reads version {SPEC_VERSION})"
            )
        if "system" not in data or "ladder" not in data or "schedule" not in data:
            raise ValueError("run spec needs 'system', 'ladder' and 'schedule'")
        sched = data["schedule"]
        if not isinstance(sched, Mapping):
            raise ValueError("'schedule' must be an object with a 'phases' list")
        _check_keys(sched, _fields(ScheduleSpec), "schedule")
        adapt = data.get("adapt")
        return cls(
            system=_from_dict(SystemSpec, data["system"], "system"),
            ladder=_from_dict(LadderSpec, data["ladder"], "ladder"),
            schedule=ScheduleSpec(phases=tuple(
                _from_dict(PhaseSpec, p, "phase") for p in sched.get("phases", ())
            )),
            engine=_from_dict(EngineSpec, data.get("engine", {}), "engine"),
            exchange=_from_dict(ExchangeSpec, data.get("exchange", {}), "exchange"),
            adapt=None if adapt is None else _from_dict(AdaptSpec, adapt, "adapt"),
            observables=tuple(data.get("observables", ())),
            seed=int(data.get("seed", 0)),
            spec_version=int(version),
        )

    @classmethod
    def from_json(cls, text) -> "RunSpec":
        """Parse a spec from a JSON string (or an already-decoded dict)."""
        if isinstance(text, Mapping):
            return cls.from_dict(text)
        return cls.from_dict(json.loads(text))
