"""`Session`: compile a `RunSpec` into an `Engine` and run its schedule.

Twin of `repro.api.session`: ``Engine.init(key(seed), ladder)`` then one
``Engine.run`` per phase, with a callback pipeline on the host loop.  The
manifest has the JAX package's layout (per-chain summaries and final
energies with an ensemble).  Checkpoints and resume are not
ported yet.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Sequence

import numpy as np

from repro_torch.api.spec import PhaseSpec, RunSpec
from repro_torch.core import keys
from repro_torch.engine import AdaptInfo, ChunkInfo, Engine, EngineState, RunResult

__all__ = ["Callback", "ProgressCallback", "Session", "SessionResult"]


class Callback:
    """Observer hooks along a Session run; ``on_chunk`` may return truthy to stop."""

    def on_phase_start(self, session: "Session", phase: PhaseSpec) -> None:
        pass

    def on_chunk(self, session: "Session", info: ChunkInfo):
        pass

    def on_adapt(self, session: "Session", info: AdaptInfo) -> None:
        pass

    def on_phase_end(self, session: "Session", phase: PhaseSpec, result: RunResult) -> None:
        pass


class ProgressCallback(Callback):
    """Phase/chunk progress lines on stderr."""

    def __init__(self, every: int = 1, stream=None):
        self.every = max(1, every)
        self.stream = stream if stream is not None else sys.stderr

    def on_phase_start(self, session, phase):
        print(f"[{phase.name}] {phase.n_sweeps} sweeps"
              + (" (adapt)" if phase.adapt else ""), file=self.stream)

    def on_chunk(self, session, info):
        if info.index % self.every == 0 or info.sweeps_done == info.n_sweeps:
            print(f"[{session.current_phase.name}] sweep "
                  f"{info.sweeps_done}/{info.n_sweeps}", file=self.stream)

    def on_adapt(self, session, info):
        print(f"[{session.current_phase.name}] ladder retune #{info.round}: "
              f"T = {np.round(info.temps, 3).tolist()}", file=self.stream)


@dataclasses.dataclass
class SessionResult:
    """Per-phase results + the final engine state."""

    spec: RunSpec
    phases: dict[str, RunResult]
    state: EngineState
    stopped_early: bool = False

    @property
    def final(self) -> RunResult:
        return next(reversed(self.phases.values()))

    def final_energies(self) -> np.ndarray:
        """Final per-rung energies, cold→hot (``(R,)`` or ``(C, R)``)."""
        e = self.state.pt.energy.cpu().numpy()
        rung = self.state.pt.rung.cpu().numpy()
        if e.ndim == 1:
            return e[np.argsort(rung)]
        return np.stack([ec[np.argsort(rc)] for ec, rc in zip(e, rung)])

    def manifest(self) -> dict:
        """JSON-able result manifest, in the JAX package's layout."""
        phases = {}
        for name, res in self.phases.items():
            phases[name] = {
                "n_sweeps": int(res.n_sweeps),
                "stopped_early": bool(res.stopped_early),
                "ladder_history": np.asarray(res.ladder_history, np.float64).tolist(),
                "summary": {
                    k: np.asarray(v, np.float64).tolist() for k, v in res.summary.items()
                },
            }
        betas = self.state.betas.cpu().numpy().astype(np.float64)
        return {
            "spec": self.spec.to_dict(),
            "spec_version": self.spec.spec_version,
            "phases": phases,
            "stopped_early": bool(self.stopped_early),
            "final": {
                "sweep": int(self.state.pt.t.reshape(-1)[0].item()),
                "temps": (1.0 / betas).tolist(),
                "energy": self.final_energies().tolist(),
            },
        }

    def write_manifest(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.manifest(), f, indent=2, sort_keys=True)
        os.replace(tmp, path)
        return path


class Session:
    """Compiled form of a `RunSpec` on one device (``cuda`` by default)."""

    def __init__(self, spec: RunSpec, callbacks: Sequence[Callback] = (),
                 device="cuda"):
        self.spec = spec
        self.callbacks = list(callbacks)
        self.system = spec.system.build()
        self.temps = spec.ladder.build()
        self.observables = spec.system.observables(self.system, spec.observables)
        self._adapt = spec.adapt.build() if spec.adapt is not None else None
        self.engine = Engine(
            self.system,
            spec.engine.build(spec.ladder.n_replicas, exchange=spec.exchange.build()),
            observables=self.observables,
            adapt=self._adapt,
            device=device,
        )
        self.state: EngineState | None = None
        self.current_phase: PhaseSpec | None = None

    def dispatch(self, hook: str, *args):
        stop = False
        for cb in self.callbacks:
            if getattr(cb, hook)(self, *args):
                stop = True
        return stop

    def init_state(self) -> EngineState:
        return self.engine.init(keys.key(self.spec.seed), self.temps)

    def run(self) -> SessionResult:
        """Execute the schedule from a fresh state (or ``self.state`` if set)."""
        if self.state is None:
            self.state = self.init_state()
        results: dict[str, RunResult] = {}
        stopped = False
        for phase in self.spec.schedule.phases:
            self.current_phase = phase
            self.dispatch("on_phase_start", phase)
            if phase.reset_stats:
                self.state = self.engine.reset_stats(self.state)
            self.engine.adapt = self._adapt if phase.adapt else None
            self.state, result = self.engine.run(
                self.state, phase.n_sweeps,
                on_chunk=lambda info: self.dispatch("on_chunk", info),
                on_adapt=lambda info: self.dispatch("on_adapt", info),
            )
            results[phase.name] = result
            self.dispatch("on_phase_end", phase, result)
            if result.stopped_early:
                stopped = True
                break
        self.current_phase = None
        return SessionResult(spec=self.spec, phases=results, state=self.state,
                             stopped_early=stopped)
