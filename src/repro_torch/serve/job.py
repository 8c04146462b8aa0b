"""Job lifecycle of the serve layer (twin of `repro.serve.job`).

A `Job` is one tenant's `RunSpec` submitted to the
`repro_torch.serve.Scheduler`.  Its lifecycle is

    PENDING ──► RUNNING ◄──► PREEMPTED ──► DONE
                   │                        ▲
                   └──────► FAILED          └─ (bucket schedule complete)

* PENDING    — queued, not yet sealed into a packed bucket;
* RUNNING    — its bucket holds the scheduler quantum;
* PREEMPTED  — its bucket was time-sliced out between quanta (the packed
  engine state stays resident or checkpointed; the job resumes bit-equal);
* DONE       — the bucket finished the schedule; `Job.result()` returns;
* FAILED     — this job's stream callback raised, or its chains went
  non-finite.  The *bucket* keeps running: its chain slots keep simulating
  as dead lanes until the bucket completes (the launch's chain axis does
  not shrink mid-run).

Each job owns its key stream: chain ``c`` of the job with seed ``s`` runs
on exactly the key a solo ``Session`` run of the same spec uses
(``keys.key(s)``, plus ``fold_in(·, c)`` for an ensemble spec).
"""
from __future__ import annotations

import dataclasses
import enum
import threading
from collections import deque
from typing import Any, Callable

import numpy as np

__all__ = [
    "JobState",
    "JobUpdate",
    "JobResult",
    "JobFailedError",
    "QueueFull",
    "SchedulerStopped",
    "Job",
    "JobQueue",
]


class JobState(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    PREEMPTED = "preempted"
    DONE = "done"
    FAILED = "failed"


class JobFailedError(RuntimeError):
    """Raised by `Job.result` when the job ended FAILED."""


class SchedulerStopped(RuntimeError):
    """The scheduler shut down before this PENDING job was ever sealed into
    a bucket — `Scheduler.shutdown` drains such jobs into FAILED with this
    error instead of leaving their `Job.result` callers blocked forever."""


class QueueFull(RuntimeError):
    """`Scheduler.submit` backpressure: the intake queue is at its bounded
    depth (``queue_depth``) and the caller asked not to block."""


@dataclasses.dataclass
class JobUpdate:
    """One streamed observation: this tenant's slice of an engine chunk.

    Attributes:
      sweeps_done: schedule sweeps completed so far (per chain).
      total_sweeps: the spec's full schedule budget.
      phase: name of the schedule phase the chunk ran in.
      energy: per-rung energies, cold->hot — ``(R,)`` for an ``n_chains=1``
        spec, ``(C, R)`` otherwise.  Bit-equal to what a solo run's
        ``ChunkInfo.state`` would show at the same sweep.
      trace: this chunk's per-interval trace slice (only when the spec sets
        ``record_trace=True``), same shapes a solo run streams.
    """

    sweeps_done: int
    total_sweeps: int
    phase: str
    energy: np.ndarray
    trace: dict[str, np.ndarray] | None = None


@dataclasses.dataclass
class JobResult:
    """Final per-tenant outcome, extracted from the bucket's ensemble slice.

    ``phases`` maps phase name -> the `repro_torch.engine.stats.summarize` dict of
    that phase's accumulators, sliced to this job's chains (phases completed
    before a scheduler restart are absent — the same contract as
    `Session.from_checkpoint`).
    """

    job_id: str
    spec: Any  # RunSpec
    phases: dict[str, dict[str, np.ndarray]]
    final_energy: np.ndarray  # (R,) or (C, R), rung order cold->hot
    n_sweeps: int

    def manifest(self) -> dict:
        """JSON-able result manifest (what ``repro_torch serve`` writes per job)."""
        phases = {}
        for name, summary in self.phases.items():
            phases[name] = {
                k: np.asarray(v, np.float64).tolist() for k, v in summary.items()
            }
        return {
            "job": self.job_id,
            "spec": self.spec.to_dict(),
            "n_sweeps": int(self.n_sweeps),
            "phases": phases,
            "final_energy": np.asarray(self.final_energy, np.float64).tolist(),
        }


class Job:
    """Client-side handle for one submitted `RunSpec`.

    ``on_update`` (optional) is called as ``on_update(job, update)`` after
    every engine chunk of the job's bucket — the tenant's view of the
    Session callback pipeline, restricted to its own ensemble slice.  An
    exception raised by the callback FAILs this job only; the bucket and its
    other tenants continue (pinned by ``tests/test_torch_serve.py``).
    """

    def __init__(
        self,
        job_id: str,
        spec,
        on_update: Callable[["Job", JobUpdate], Any] | None = None,
    ):
        self.id = job_id
        self.spec = spec
        self.on_update = on_update
        self.state = JobState.PENDING
        self.error: BaseException | None = None
        self.last_update: JobUpdate | None = None
        self.n_updates = 0
        # monotonic submit timestamp, stamped by Scheduler.submit — feeds
        # the wakeup-latency and time-in-queue histograms (None for jobs
        # restored from a checkpoint, which were never in this queue)
        self.submitted_at: float | None = None
        self._result: JobResult | None = None
        self._finished = threading.Event()

    @property
    def seed(self) -> int:
        return self.spec.seed

    @property
    def n_chains(self) -> int:
        return self.spec.engine.n_chains

    @property
    def total_sweeps(self) -> int:
        return self.spec.schedule.total_sweeps

    def done(self) -> bool:
        return self._finished.is_set()

    def result(self, timeout: float | None = None) -> JobResult:
        """Block until the job finishes; raise `JobFailedError` on FAILED."""
        if not self._finished.wait(timeout):
            raise TimeoutError(
                f"job {self.id} still {self.state.value} after {timeout}s"
            )
        if self.state is JobState.FAILED:
            raise JobFailedError(f"job {self.id} failed: {self.error!r}") \
                from self.error
        assert self._result is not None
        return self._result

    # -- transitions (driven by the scheduler/bucket, not the client) ----------
    def _notify(self, update: JobUpdate) -> None:
        self.last_update = update
        self.n_updates += 1
        if self.on_update is not None:
            self.on_update(self, update)

    def _deliver(self, result: JobResult) -> None:
        self._result = result
        self.state = JobState.DONE
        self._finished.set()

    def _fail(self, error: BaseException) -> None:
        self.error = error
        self.state = JobState.FAILED
        self._finished.set()

    def __repr__(self):
        return f"Job({self.id!r}, {self.state.value}, seed={self.seed})"


class JobQueue:
    """Thread-safe FIFO intake between `submit()` callers and the host loop.

    ``maxsize`` bounds the depth (0 = unbounded): at capacity, `put` either
    raises `QueueFull` immediately or — with ``block=True`` — waits for the
    host loop to drain space, raising `QueueFull` only on timeout.  The
    bound is backpressure against a producer outrunning the service, not a
    fairness mechanism (buckets already round-robin).
    """

    def __init__(self, maxsize: int = 0):
        self.maxsize = maxsize
        self._items: deque[Job] = deque()
        self._cond = threading.Condition()

    def put(self, job: Job, block: bool = False,
            timeout: float | None = None) -> None:
        with self._cond:
            if self.maxsize:
                if not block and len(self._items) >= self.maxsize:
                    raise QueueFull(
                        f"intake queue at bounded depth {self.maxsize}"
                    )
                if block:
                    ok = self._cond.wait_for(
                        lambda: len(self._items) < self.maxsize, timeout
                    )
                    if not ok:
                        raise QueueFull(
                            f"intake queue still at depth {self.maxsize} "
                            f"after {timeout}s"
                        )
            self._items.append(job)
            self._cond.notify_all()

    def poke(self) -> None:
        """Wake every `wait` caller without enqueueing (stop signalling)."""
        with self._cond:
            self._cond.notify_all()

    def drain(self) -> list[Job]:
        """Remove and return every queued job (possibly empty)."""
        with self._cond:
            items = list(self._items)
            self._items.clear()
            # free capacity: wake any producer blocked in put(block=True)
            self._cond.notify_all()
        return items

    def peek(self) -> list[Job]:
        """A snapshot of the queued jobs without removing them."""
        with self._cond:
            return list(self._items)

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the queue is non-empty (True) or timeout (False)."""
        with self._cond:
            if self._items:
                return True
            self._cond.wait(timeout)
            return bool(self._items)

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)
