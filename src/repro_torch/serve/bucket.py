"""Shape-bucketed job packing: N same-shaped tenants, one launch a round
(twin of `repro.serve.bucket`).

Jobs whose specs share every shape-relevant field are packed along the
engine's ensemble axis and advanced together: on the round and fused paths
one kernel launch a round (or an interval) carries every tenant's chains,
its grid's second dimension the chain (`repro_torch.engine.driver.
make_ensemble_step`).  The pieces:

* `shape_signature` — the bucket key: the spec's `to_dict()` minus
  ``seed``, canonically serialized and hashed, the JAX package's digest for
  the same spec.  Everything but the seed is shape-relevant: system params
  fix the lattices, the ladder fixes the shared ``(R,)`` betas row
  (`EngineState.betas` has no chain axis), and the engine, exchange and
  phase schedule fix the program;
* `check_servable` — the packing preconditions, refused at submit time: no
  adaptive phases (adaptation pools swap counters over the whole ensemble
  and retunes the shared ladder) and no explicit device mesh;
* `PackedRun` — one live bucket: the packed `EngineState`, the job -> chain
  slot map, the schedule cursor, per-job streaming and failure isolation,
  and checkpoint save and restore for preemption.

**Isolation contract** (pinned by ``tests/test_torch_serve.py`` and
``chip_smoke.py``): chain slot ``c`` of a packed job runs on exactly the
key a solo run uses — ``keys.key(seed)`` for an ``n_chains=1`` spec,
``fold_in(·, c)`` for an ensemble spec (`Engine.init_ensemble`) — and each
chain's slice of a launch computes what a launch on that chain alone does,
so every tenant's energies, states and statistics are bit-equal to running
its spec alone.  Packing changes throughput, never results.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import keys as keys_lib
from repro_torch.engine import stats as stats_lib
from repro_torch.serve.job import Job, JobResult, JobUpdate

__all__ = [
    "shape_signature",
    "check_servable",
    "PackedRun",
    "MANIFEST_NAME",
]

MANIFEST_NAME = "serve.json"


def shape_signature(spec) -> tuple[str, dict]:
    """Bucket key for a `RunSpec`: ``(digest, sans_seed_dict)``.

    Two specs pack into one bucket iff their digests match.  The seed is
    the *only* field excluded — it selects the key stream, which is
    per-chain data, not program shape.
    """
    d = spec.to_dict()
    d.pop("seed", None)
    payload = json.dumps(d, sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(payload.encode()).hexdigest()[:12], d


def check_servable(spec) -> None:
    """Raise ValueError if the spec cannot run under the packing contract."""
    for phase in spec.schedule.phases:
        if phase.adapt:
            raise ValueError(
                f"phase {phase.name!r} sets adapt=True: adaptive ladders "
                "pool swap counters across the whole ensemble and retune "
                "the shared betas row, so one tenant's feedback would "
                "perturb its bucket-mates' trajectories.  Adapt offline "
                "(a solo Session run), then serve the tuned custom ladder."
            )
    if spec.engine.mesh is not None:
        raise ValueError(
            "spec.engine.mesh is set: the serve scheduler owns device "
            "placement; submit specs with mesh=None"
        )


class PackedRun:
    """One live bucket: same-signature jobs packed along the ensemble axis.

    Chain-slot layout is submission order — job ``i`` owns the contiguous
    block ``[offset_i, offset_i + n_chains_i)``.  The engine is built by the
    scheduler with ``n_chains == sum(n_chains_i)`` and is *shared across
    bucket generations* of the same ``(signature, width)``, so a chunk is
    prepared once per shape, not once per bucket.
    """

    def __init__(self, digest: str, template, jobs: Sequence[Job],
                 engine, manager=None, faults=None, name: str | None = None):
        if not jobs:
            raise ValueError("a bucket needs at least one job")
        self.digest = digest
        self.template = template  # any member spec (sans-seed identical)
        self.jobs = list(jobs)
        self.engine = engine
        self.manager = manager  # per-bucket CheckpointManager (or None)
        # fault-injection handle (repro_torch.resilience.FaultPlan; None = off)
        self.faults = faults
        # stable identity across recovery generations (the Supervisor's
        # retry bookkeeping and the quarantine manifest key on this)
        self.name = name if name is not None else digest
        # set by Supervisor watchdog expiry: the host loop observes this at
        # the next chunk boundary and stops without notifying any tenant
        self._abandoned = False
        # restore_latest fallback depth of the generation this bucket was
        # recovered/restored from (recovery telemetry)
        self.restore_fallback_depth = 0
        self.temps = template.ladder.build()
        self._slices: list[tuple[int, int]] = []
        off = 0
        for j in self.jobs:
            self._slices.append((off, j.n_chains))
            off += j.n_chains
        self.n_chains = off
        if engine.config.n_chains != self.n_chains:
            raise ValueError(
                f"engine packs {engine.config.n_chains} chains but the "
                f"bucket holds {self.n_chains}"
            )
        self.total_sweeps = template.schedule.total_sweeps
        self.sweeps_done = 0
        self.state = None
        self.finished = False
        self._failed: set[str] = set()
        # job.id -> {phase name -> summarize() dict}; phases completed before
        # a scheduler restart are absent (same contract as Session resume)
        self._phase_summaries: dict[str, dict[str, dict]] = {}
        self._current_phase = None
        self._base_sweeps = 0

    # -- construction ----------------------------------------------------------
    def chain_keys(self) -> list[torch.Tensor]:
        """Per-slot keys, exactly as each job's solo run derives them."""
        keys = []
        for j in self.jobs:
            base = keys_lib.key(j.seed)
            if j.n_chains == 1:
                keys.append(base)
            else:
                for c in range(j.n_chains):
                    keys.append(keys_lib.fold_in(base, c))
        return keys

    def init(self) -> None:
        self.state = self.engine.init_ensemble(self.chain_keys(), self.temps)

    def write_manifest(self) -> None:
        """Persist the bucket composition next to its checkpoints (atomic).

        ``serve.json`` + the newest step dir is everything
        `PackedRun.restore` / `Scheduler.from_checkpoint` needs to resume
        the bucket after a process restart.
        """
        if self.manager is None:
            return
        payload = {
            "signature": self.digest,
            "template": self.template.to_dict(),
            "jobs": [{"id": j.id, "spec": j.spec.to_dict()} for j in self.jobs],
        }
        path = os.path.join(self.manager.dir, MANIFEST_NAME)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        os.replace(tmp, path)

    @classmethod
    def restore(cls, digest: str, template, jobs: Sequence[Job],
                engine, manager, faults=None,
                name: str | None = None) -> "PackedRun":
        """Rebuild a bucket from its checkpoint directory.

        Restores the newest *intact* packed `EngineState` (bit-equal resume
        — the checkpoint contract; corrupt generations are skipped by
        `CheckpointManager.restore_latest` and their count recorded in
        ``restore_fallback_depth``) and relocates the schedule cursor from
        the state's own sweep counter.  With no restorable step the bucket
        simply starts fresh on its next quantum.
        """
        run = cls(digest, template, jobs, engine, manager=manager,
                  faults=faults, name=name)
        out = engine.restore(manager)
        if out is not None:
            state, meta = out
            run.state = state
            run.restore_fallback_depth = getattr(
                manager, "last_restore_fallback", 0
            )
            if "temps" in meta:
                # authoritative f64 ladder (f32 betas aren't exactly invertible)
                engine._temps = np.asarray(meta["temps"], np.float64)
            run.sweeps_done = int(state.pt.t.reshape(-1)[0].item())
            if run.sweeps_done >= run.total_sweeps:
                # schedule already complete at checkpoint time: deliver now
                run._finalize()
        return run

    # -- supervised recovery ----------------------------------------------------
    def abandon(self) -> None:
        """Cooperative cancellation (Supervisor watchdog expiry): the host
        loop stops at the next chunk boundary, silently — no tenant update,
        stream callback, or result is delivered by an abandoned attempt."""
        self._abandoned = True

    def ensure_compiled(self) -> None:
        """Prepare exactly the chunk the next quantum issues first (so a
        Supervisor compile watchdog can budget it on its own).  The chunk
        length is derived as `Engine.run` derives it: another length would
        prepare a chunk the run never issues."""
        if self.finished:
            return
        if self.state is None:
            self.init()
        phase, _, end = self._locate(self.sweeps_done)
        spi = self.engine.config.spec.sweeps_per_interval
        n_intervals = (end - self.sweeps_done) // spi
        this = min(self.engine.config.chunk_intervals, n_intervals)
        if this > 0:
            self.engine.ensure_compiled(this)

    def recover(self) -> "PackedRun":
        """A fresh generation of this bucket, replayed from the last intact
        checkpoint (or from scratch with no manager / no intact step).

        Bit-equality: preemption and chunk boundaries are invisible to the
        key streams, so the replayed trajectory is identical to the
        fault-free one; summaries of phases that *ended* at or before the
        restore point were computed from the same (uncorrupted) trajectory
        pre-fault and are carried over, so the recovered bucket's final
        `JobResult`s carry every phase — bit-equal to a never-faulted run.
        """
        fresh: "PackedRun"
        try:
            fresh = PackedRun.restore(
                self.digest, self.template, self.jobs, self.engine,
                self.manager, faults=self.faults, name=self.name,
            ) if self.manager is not None else PackedRun(
                self.digest, self.template, self.jobs, self.engine,
                manager=self.manager, faults=self.faults, name=self.name,
            )
        except Exception:
            # a wholly corrupt checkpoint dir: last resort is a clean replay
            # from sweep 0 (still bit-equal — the stream is deterministic)
            fresh = PackedRun(
                self.digest, self.template, self.jobs, self.engine,
                manager=self.manager, faults=self.faults, name=self.name,
            )
            fresh.restore_fallback_depth = len(
                self.manager.steps()) if self.manager is not None else 0
        fresh._failed = set(self._failed)
        for jid, phases in self._phase_summaries.items():
            for pname, summary in phases.items():
                if self._phase_end(pname) <= fresh.sweeps_done:
                    fresh._phase_summaries.setdefault(jid, {})[pname] = summary
        return fresh

    def _phase_end(self, name: str) -> int:
        start = 0
        for phase in self.template.schedule.phases:
            end = start + phase.n_sweeps
            if phase.name == name:
                return end
            start = end
        raise ValueError(f"unknown phase {name!r}")

    def checkpoint(self) -> None:
        if self.manager is None or self.state is None:
            return
        meta = {"temps": [float(t) for t in self.temps]}
        self.manager.save(self.sweeps_done, self.state, meta=meta)

    # -- schedule bookkeeping ---------------------------------------------------
    def _locate(self, sweep: int):
        """The phase containing ``sweep`` and its [start, end) window."""
        start = 0
        for phase in self.template.schedule.phases:
            end = start + phase.n_sweeps
            if sweep < end:
                return phase, start, end
            start = end
        raise ValueError(f"sweep {sweep} beyond the schedule ({start})")

    def live_jobs(self) -> list[Job]:
        return [j for j in self.jobs if j.id not in self._failed]

    # -- execution --------------------------------------------------------------
    def run_quantum(self, max_chunks: int = 1) -> bool:
        """Advance the bucket by at most ``max_chunks`` engine chunks.

        The scheduler's time-slice: the engine host loop is entered with the
        current phase's remaining budget and stopped through the ``on_chunk``
        hook once the quantum is spent, so preemption costs at most one
        chunk.  Quanta never split a chunk, and chunk boundaries are
        invisible to the key streams (keys derive from the state's sweep
        counter), so any preemption pattern yields bit-identical results.
        Returns True when the whole schedule is done (results delivered).
        """
        if self.finished:
            return True
        if self.state is None:
            self.init()
        spent = [0]

        def hook(info):
            if self._abandoned:
                # watchdog expiry: stop at this chunk boundary with no
                # tenant-visible side effects — the recovered generation
                # replays these sweeps bit-equal
                return True
            self._stream(info)
            spent[0] += 1
            return spent[0] >= max_chunks

        while not self._abandoned and self.sweeps_done < self.total_sweeps:
            phase, start, end = self._locate(self.sweeps_done)
            self._current_phase = phase
            if phase.reset_stats and self.sweeps_done == start:
                # entering the phase fresh (also holds when resuming from a
                # checkpoint cut exactly at the boundary — the uninterrupted
                # loop resets at the same point); a mid-phase resume keeps
                # the checkpointed accumulators, as Session.run does
                self.state = self.engine.reset_stats(self.state)
            self._base_sweeps = self.sweeps_done
            self.state, result = self.engine.run(
                self.state,
                end - self.sweeps_done,
                on_chunk=hook,
                keep_trace=False,
            )
            self.sweeps_done += result.n_sweeps
            if self.sweeps_done == end and not self._abandoned:
                self._record_phase(phase)
            if spent[0] >= max_chunks and self.sweeps_done < self.total_sweeps:
                break
        self._current_phase = None
        if self._abandoned:
            return False
        if self.sweeps_done >= self.total_sweeps and not self.finished:
            self._finalize()
        return self.finished

    # -- per-tenant views -------------------------------------------------------
    def _ensemble(self, arr: np.ndarray) -> np.ndarray:
        """Normalize a state/trace leaf to a leading chain axis."""
        return arr[None] if self.n_chains == 1 else arr

    def _job_energy(self, energy: np.ndarray, rung: np.ndarray,
                    index: int) -> np.ndarray:
        """Job ``index``'s rung-ordered (cold->hot) energies: (R,) or (C,R)."""
        off, width = self._slices[index]
        e = self._ensemble(energy)[off:off + width]
        r = self._ensemble(rung)[off:off + width]
        out = np.take_along_axis(e, np.argsort(r, axis=1), axis=1)
        return out[0] if self.jobs[index].n_chains == 1 else out

    def _job_trace(self, trace, index: int):
        if trace is None:
            return None
        off, width = self._slices[index]
        solo = self.jobs[index].n_chains == 1
        out = {}
        for k, v in trace.items():
            block = self._ensemble(v)[off:off + width]
            out[k] = block[0] if solo else block
        return out

    def _stream(self, info) -> None:
        """Fan one engine chunk out to every live tenant's callback.

        A callback exception — or a non-finite energy in the job's own chain
        block — FAILs that job alone; its slots keep simulating as dead lanes
        (the launch's chain axis does not shrink mid-run) and every other
        tenant is untouched.  The energies' copy to the host waits for the
        card: it is the quantum's sync point, which a watchdog times.
        """
        energy = info.state.pt.energy.cpu().numpy()
        rung = info.state.pt.rung.cpu().numpy()
        phase = self._current_phase.name if self._current_phase else ""
        for i, job in enumerate(self.jobs):
            if job.id in self._failed:
                continue
            try:
                if self.faults is not None:
                    # models a tenant callback raising (the failure is
                    # isolated to that job, like any callback exception)
                    self.faults.fire("serve.callback")
                e = self._job_energy(energy, rung, i)
                if not np.all(np.isfinite(e)):
                    raise FloatingPointError(
                        f"non-finite energy in job {job.id} at sweep "
                        f"{self._base_sweeps + info.sweeps_done}"
                    )
                job._notify(JobUpdate(
                    sweeps_done=self._base_sweeps + info.sweeps_done,
                    total_sweeps=self.total_sweeps,
                    phase=phase,
                    energy=e,
                    trace=self._job_trace(info.trace, i),
                ))
            except BaseException as err:  # isolate: never take down the bucket
                self._failed.add(job.id)
                job._fail(err)

    # -- results ----------------------------------------------------------------
    def _job_stats(self, index: int):
        off, width = self._slices[index]
        stats = self.state.stats
        if self.n_chains == 1:
            return stats  # single-slot bucket: leaves are already (R,)
        if self.jobs[index].n_chains == 1:
            return stats_lib.chain_slice(stats, off)
        return stats_lib.chain_block(stats, off, off + width)

    def _record_phase(self, phase) -> None:
        for i, job in enumerate(self.jobs):
            if job.id in self._failed:
                continue
            summary = stats_lib.summarize(self._job_stats(i))
            self._phase_summaries.setdefault(job.id, {})[phase.name] = {
                k: np.asarray(v).copy() for k, v in summary.items()
            }

    def _finalize(self) -> None:
        energy = self.state.pt.energy.cpu().numpy()
        rung = self.state.pt.rung.cpu().numpy()
        for i, job in enumerate(self.jobs):
            if job.id in self._failed:
                continue
            job._deliver(JobResult(
                job_id=job.id,
                spec=job.spec,
                phases=self._phase_summaries.get(job.id, {}),
                final_energy=self._job_energy(energy, rung, i),
                n_sweeps=self.sweeps_done,
            ))
        self.finished = True

    def __repr__(self):
        return (
            f"PackedRun({self.digest}, jobs={len(self.jobs)}, "
            f"chains={self.n_chains}, sweep={self.sweeps_done}/"
            f"{self.total_sweeps})"
        )
