"""`Session`: compile a `RunSpec` into an `Engine` and run its schedule.

Twin of `repro.api.session`: ``Engine.init(key(seed), ladder)`` then one
``Engine.run`` per phase, with a callback pipeline on the host loop
(progress, checkpoints, early stop, trace files).  The manifest has the
JAX package's layout (per-chain summaries and final energies with an
ensemble).

Resume: `CheckpointCallback` saves ``spec.json`` once and the
``EngineState`` with the f64 ladder and the adaptation window in the step
meta, in the JAX package's checkpoint format; `Session.from_checkpoint`
rebuilds the Session from the directory alone and ``run()`` replays the
remaining sweeps of the schedule, bit-equal to the uninterrupted run.
Either package resumes the other's checkpoints, and any mesh resumes a
checkpoint that any mesh wrote.  `ObsCallback` attaches a
`repro_torch.obs.Observability` to the engine and writes its timeline and
metrics after every phase; ``strict_kernels`` makes a failed kernel
preparation or launch on a fused or round path an error instead of a
degradation to the per-sweep path on the card.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Sequence

import numpy as np

from repro_torch.api.spec import PhaseSpec, RunSpec
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import keys
from repro_torch.engine import AdaptInfo, ChunkInfo, Engine, EngineState, RunResult
from repro_torch.engine.adapt import AdaptState

__all__ = ["Callback", "CheckpointCallback", "EarlyStopCallback", "ObsCallback",
           "ProgressCallback", "TraceWriterCallback", "Session", "SessionResult"]

_KEEP = object()  # from_checkpoint: keep the checkpointed spec's mesh


class Callback:
    """Observer hooks along a Session run; ``on_chunk`` may return truthy to stop.

    ``consumes_trace = True`` takes ownership of the per-chunk trace: the
    engine then keeps no copy for ``RunResult.trace``.
    """

    consumes_trace = False

    def on_phase_start(self, session: "Session", phase: PhaseSpec) -> None:
        pass

    def on_chunk(self, session: "Session", info: ChunkInfo):
        pass

    def on_adapt(self, session: "Session", info: AdaptInfo) -> None:
        pass

    def on_phase_end(self, session: "Session", phase: PhaseSpec, result: RunResult) -> None:
        pass

    def on_checkpoint(self, session: "Session", step: int) -> None:
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


class CheckpointCallback(Callback):
    """``spec.json`` once, then the state every ``every_chunks`` chunks and at
    every phase end (a phase end right after a chunk's save is skipped)."""

    def __init__(self, directory_or_manager, every_chunks: int = 1, keep: int = 3):
        if isinstance(directory_or_manager, CheckpointManager):
            self.manager = directory_or_manager
        else:
            self.manager = CheckpointManager(str(directory_or_manager), keep=keep)
        self.every_chunks = max(1, every_chunks)
        self._spec_saved = False
        self._last_sweep: int | None = None

    def _save(self, session, state: EngineState):
        """Every rank of a mesh calls this (the state is gathered); rank 0 writes."""
        if not self._spec_saved:
            if session.engine.is_writer:
                self.manager.save_spec(session.spec.to_json())
            self._spec_saved = True
        sweep = int(state.pt.t.reshape(-1)[0].item())
        if sweep == self._last_sweep:
            return
        self._last_sweep = sweep
        # the f64 ladder, never 1/f32(betas): a resumed retune must see the
        # numbers the uninterrupted host loop saw
        temps = session.engine._temps
        if temps is None:
            temps = 1.0 / state.betas.cpu().numpy().astype(np.float64)
        meta = {"temps": np.asarray(temps, np.float64).tolist(),
                "adapt_rounds": session.engine._adapt_rounds}
        if session.engine._adapt_state is not None:
            meta.update(session.engine._adapt_state.to_meta())
        obs = session.engine.obs
        if obs is not None:
            with obs.timeline.span("checkpoint", cat="session", sweep=sweep):
                session.engine.save_checkpoint(self.manager, state, meta)
        else:
            session.engine.save_checkpoint(self.manager, state, meta)
        session.dispatch("on_checkpoint", sweep)

    def on_chunk(self, session, info):
        if info.index % self.every_chunks == 0:
            self._save(session, info.state)

    def on_phase_end(self, session, phase, result):
        self._save(session, session.state)


class EarlyStopCallback(Callback):
    """Stop the run when ``predicate(ChunkInfo)`` is truthy."""

    def __init__(self, predicate):
        self.predicate = predicate

    def on_chunk(self, session, info):
        return self.predicate(info)


class TraceWriterCallback(Callback):
    """Each chunk's trace to ``<dir>/trace_<phase>_<chunk>.npz`` (needs
    ``record_trace``); it consumes the trace, so none is kept in memory."""

    consumes_trace = True

    def __init__(self, directory: str):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)

    def on_chunk(self, session, info):
        if info.trace is None:
            return
        path = os.path.join(self.directory,
                            f"trace_{session.current_phase.name}_{info.index:06d}.npz")
        np.savez(path, **info.trace)


class ObsCallback(Callback):
    """Attach a `repro_torch.obs.Observability` to the run and export it.

    On phase start the bundle is attached to the Session's engine (the
    per-chunk spans and metrics of its host loop), phases land as spans on a
    ``session`` track, and after every phase the timeline and metrics files
    are (re)written atomically, so a run that dies mid-schedule still leaves
    loadable files.

    Args:
      obs: an existing `Observability` to ride on; built fresh when None.
      timeline_path: where `write()` puts the Chrome-trace JSON (skipped
        when None or when the bundle records no timeline).
      metrics_path: where `write()` puts the Prometheus text exposition.
      torch_profile_dir: arm the one-chunk `torch.profiler` window around
        the first engine chunk (only when ``obs`` is built here).
    """

    def __init__(self, obs=None, timeline_path: str | None = None,
                 metrics_path: str | None = None, torch_profile_dir: str | None = None):
        if obs is None:
            from repro_torch.obs import Observability

            obs = Observability.create(timeline=timeline_path is not None,
                                       torch_profile_dir=torch_profile_dir)
        self.obs = obs
        self.timeline_path = timeline_path
        self.metrics_path = metrics_path
        self._phase_t0: dict[str, float] = {}

    def on_phase_start(self, session, phase):
        if session.engine.obs is not self.obs:
            session.engine.obs = self.obs
        self._phase_t0[phase.name] = time.perf_counter()

    def on_phase_end(self, session, phase, result):
        t0 = self._phase_t0.pop(phase.name, None)
        if t0 is not None:
            self.obs.timeline.complete(
                f"phase:{phase.name}", t0, time.perf_counter() - t0,
                cat="session", track="session",
                args={"n_sweeps": int(result.n_sweeps),
                      "stopped_early": bool(result.stopped_early)},
            )
        self.write()

    def write(self) -> dict:
        """Write the requested files (atomic); returns ``{kind: path}``."""
        out = {}
        if self.timeline_path and getattr(self.obs.timeline, "enabled", False):
            out["timeline"] = self.obs.timeline.write(self.timeline_path)
        if self.metrics_path:
            from repro_torch.obs import write_prometheus

            out["metrics"] = write_prometheus(self.obs.metrics, self.metrics_path)
        return out


@dataclasses.dataclass
class SessionResult:
    """Per-phase results + the final engine state (the whole state on a
    mesh, equal on every rank)."""

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
    """Compiled form of a `RunSpec` on one device (``cuda`` by default), or
    on one rank of a mesh when ``spec.engine.mesh`` is set (every rank of
    the process group builds its Session from the same spec and runs it;
    `CheckpointCallback` gathers and rank 0 writes).

    ``strict_kernels`` makes a failed kernel preparation or launch on a
    fused or round path an error; without it the engine degrades to the
    per-sweep path on the same device, with a warning."""

    def __init__(self, spec: RunSpec, callbacks: Sequence[Callback] = (),
                 device="cuda", strict_kernels: bool = False):
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
            strict_kernels=strict_kernels,
        )
        self.state: EngineState | None = None
        self.current_phase: PhaseSpec | None = None
        self._restored_sweeps = 0

    def dispatch(self, hook: str, *args):
        stop = False
        for cb in self.callbacks:
            if getattr(cb, hook)(self, *args):
                stop = True
        return stop

    def init_state(self) -> EngineState:
        return self.engine.init(keys.key(self.spec.seed), self.temps)

    @classmethod
    def from_checkpoint(cls, directory: str, callbacks: Sequence[Callback] = (),
                        device="cuda", strict_kernels: bool = False,
                        mesh=_KEEP) -> "Session":
        """A Session from ``(spec.json, newest checkpoint)`` in ``directory``
        (written by either package, on any mesh), state on ``device``; its
        ``run()`` continues the schedule.  ``mesh`` (a `MeshSpec` or None)
        replaces the spec's ``engine.mesh``: a checkpoint resumes on any
        mesh.  A `CheckpointCallback` on the same directory is appended
        unless ``callbacks`` has one."""
        manager = CheckpointManager(directory)
        data = manager.load_spec()
        if data is None:
            raise FileNotFoundError(f"no spec.json in {directory!r}")
        spec = RunSpec.from_json(data)
        if mesh is not _KEEP:
            spec = dataclasses.replace(spec, engine=dataclasses.replace(spec.engine, mesh=mesh))
        session = cls(spec, callbacks=callbacks, device=device,
                      strict_kernels=strict_kernels)
        out = session.engine.restore(manager)
        if out is None:
            raise FileNotFoundError(f"no restorable checkpoint in {directory!r}")
        state, meta = out
        session.state = state
        session._restored_sweeps = int(state.pt.t.reshape(-1)[0].item())
        session.engine._adapt_rounds = int(meta.get("adapt_rounds", 0))
        if "temps" in meta:
            session.engine._temps = np.asarray(meta["temps"], np.float64)
        restored_adapt = AdaptState.from_meta(meta, rounds=session.engine._adapt_rounds)
        if restored_adapt is not None:
            session.engine._adapt_state = restored_adapt
        if not any(isinstance(cb, CheckpointCallback) for cb in session.callbacks):
            session.callbacks.append(CheckpointCallback(manager))
        return session

    @property
    def remaining_sweeps(self) -> int:
        """Schedule sweeps still to run (0 when a resumed run is complete)."""
        return max(0, self.spec.schedule.total_sweeps - self._restored_sweeps)

    def run(self) -> SessionResult:
        """Execute the schedule from a fresh state, or its remainder after
        `from_checkpoint`."""
        if self.state is None:
            self.state = self.init_state()
        skip = self._restored_sweeps
        self._restored_sweeps = 0
        results: dict[str, RunResult] = {}
        stopped = False
        keep_trace = not any(cb.consumes_trace for cb in self.callbacks)
        for phase in self.spec.schedule.phases:
            if skip >= phase.n_sweeps:
                skip -= phase.n_sweeps  # finished before the checkpoint
                continue
            budget, fresh_phase, skip = phase.n_sweeps - skip, skip == 0, 0
            self.current_phase = phase
            self.dispatch("on_phase_start", phase)
            # mid-phase, the checkpointed accumulators already had their reset
            if phase.reset_stats and fresh_phase:
                self.state = self.engine.reset_stats(self.state)
            self.engine.adapt = self._adapt if phase.adapt else None
            self.state, result = self.engine.run(
                self.state, budget,
                on_chunk=lambda info: self.dispatch("on_chunk", info),
                on_adapt=lambda info: self.dispatch("on_adapt", info),
                keep_trace=keep_trace,
            )
            results[phase.name] = result
            self.dispatch("on_phase_end", phase, result)
            if result.stopped_early:
                stopped = True
                break
        self.current_phase = None
        if not results:
            raise RuntimeError(
                "nothing to run: the checkpointed sweep counter already "
                "covers the whole schedule"
            )
        return SessionResult(spec=self.spec, phases=results,
                             state=self.engine.gathered(self.state), stopped_early=stopped)
