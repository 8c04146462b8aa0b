"""The multi-tenant PT scheduler: intake, packing, time-slicing, resume
(twin of `repro.serve.scheduler`).

One `Scheduler` owns a `JobQueue`, a cache of packed engines, and a
round-robin deque of live `PackedRun` buckets.  The host loop:

1. **intake** — drain the queue; check each spec (`check_servable`: a bad
   spec FAILs its job at submit time, it never poisons a bucket) and stage
   it under its `shape_signature`;
2. **seal** — once a signature's pack window closes, the staged jobs become
   a `PackedRun`.  The packed engine is cached by ``(signature, total
   chains)``, so bucket generation N+1 of the same shape reuses generation
   N's engine and prepared chunks: one preparation for N jobs;
3. **time-slice** — pop the head bucket, run one quantum (``quantum_chunks``
   engine chunks), checkpoint it, and rotate it to the tail (FIFO requeue
   is round-robin: with B live buckets every bucket runs every B quanta).

On the round and fused paths a bucket of N tenants advances with one
kernel launch a round (an interval) for all of them, the launch's grid
carrying the chain axis; on the per-sweep path each chain's kernels launch
in turn.

Preemption rides the checkpoint machinery: each bucket owns a
`CheckpointManager` subdirectory (``<root>/<signature>-<seq>/``) holding a
``serve.json`` composition manifest plus ordinary engine step dirs, in the
JAX package's formats, and `Scheduler.from_checkpoint` rebuilds every
unfinished bucket bit-equal after a process restart (a JAX scheduler's
directory too).

Every quantum runs under a `repro_torch.resilience.Supervisor`: a transient
failure recovers the bucket from its last intact checkpoint and retries
with backoff; ``max_attempts`` consecutive failures quarantine the bucket
(its jobs FAIL with `BucketQuarantined`, ``quarantine.json`` lands next to
its checkpoints) while every other bucket keeps serving.  ``queue_depth``
bounds the intake queue (`QueueFull`), and `shutdown` fails still-PENDING
jobs with `SchedulerStopped`.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
import time
import warnings
from collections import deque
from typing import Any, Callable

import torch

from repro_torch.api.spec import RunSpec
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.device import resolve_device
from repro_torch.engine import Engine
from repro_torch.resilience import RetryPolicy, Supervisor
from repro_torch.serve.bucket import (
    MANIFEST_NAME,
    PackedRun,
    check_servable,
    shape_signature,
)
from repro_torch.serve.job import (
    Job,
    JobQueue,
    JobResult,
    JobState,
    JobUpdate,
    SchedulerStopped,
)

__all__ = ["Scheduler"]


@dataclasses.dataclass
class _Staged:
    """Jobs of one signature waiting for their pack window to close."""

    template: RunSpec
    jobs: list
    since: float  # monotonic time of first arrival


class Scheduler:
    """PT-as-a-service: submit `RunSpec`s, receive per-tenant `JobResult`s.

    Args:
      checkpoint_dir: root directory for per-bucket checkpoint subdirs;
        None disables preemption persistence (buckets stay memory-resident).
      quantum_chunks: engine chunks per time-slice — the fairness quantum.
      pack_window: seconds a new signature's first job waits for bucket-mates
        before sealing.  0 seals as soon as the loop observes the jobs, which
        still packs everything submitted before the loop runs (the
        batch-submission pattern of `run_until_idle`).
      checkpoint_every_quanta: bucket-checkpoint cadence (0 = only at seal
        and finish).
      keep: checkpoint retention per bucket.
      obs: an optional `repro_torch.obs.Observability` — when given, its
        timeline gains per-bucket quantum lanes and job-lifecycle flow
        arrows (PENDING -> RUNNING -> DONE), and every packed engine is
        attached to it (engine spans land in the same trace).  Metrics are
        *always* recorded into `Scheduler.metrics()`'s registry, obs or not
        — the quantum loop is coarse enough (whole engine chunks) that the
        cost is noise.
      metrics_every: write the Prometheus exposition every N quanta (0 = on
        demand only) to ``metrics_path``.
      metrics_path: destination for the periodic exposition.
      max_attempts: supervised retry budget per quantum — a bucket failing
        this many consecutive attempts is quarantined (``repro_torch serve
        --max-attempts``).
      retry_backoff_s: base of the exponential retry backoff.
      watchdog_s: wall-clock budget per quantum and per first chunk
        preparation (0 = no watchdog threads; ``repro_torch serve
        --watchdog-s``).
      queue_depth: bound on the intake queue (0 = unbounded; ``repro_torch
        serve --queue-depth``) — at capacity `submit` raises `QueueFull` (or
        blocks, with ``submit(..., block=True)``).
      faults: an optional `repro_torch.resilience.FaultPlan` threaded
        through every engine, checkpoint manager and bucket this scheduler
        builds (chaos testing; None in production — zero-cost-off).
      device: where every packed engine runs (``cuda`` by default; ``cpu``
        runs the plain versions of the kernels).
      strict_kernels: packed engines raise instead of degrading a fused or
        round path to the per-sweep path.

    Use either synchronously (``submit(...)`` then ``run_until_idle()``) or
    as a service (``start()`` spawns the host loop thread; ``submit`` is
    thread-safe; ``shutdown()`` stops it).
    """

    def __init__(
        self,
        checkpoint_dir: str | None = None,
        quantum_chunks: int = 1,
        pack_window: float = 0.0,
        checkpoint_every_quanta: int = 0,
        keep: int = 2,
        obs=None,
        metrics_every: int = 0,
        metrics_path: str | None = None,
        max_attempts: int = 3,
        retry_backoff_s: float = 0.05,
        watchdog_s: float = 0.0,
        queue_depth: int = 0,
        faults=None,
        device="cuda",
        strict_kernels: bool = False,
    ):
        if quantum_chunks < 1:
            raise ValueError("quantum_chunks must be >= 1")
        self.queue = JobQueue(maxsize=queue_depth)
        self.quantum_chunks = quantum_chunks
        self.pack_window = pack_window
        self.checkpoint_every_quanta = checkpoint_every_quanta
        self.keep = keep
        self._faults = faults
        self.device = resolve_device(device)
        self.strict_kernels = strict_kernels
        self._supervisor = Supervisor(
            policy=RetryPolicy(
                max_attempts=max_attempts, base_delay_s=retry_backoff_s
            ),
            watchdog_s=watchdog_s,
            compile_watchdog_s=watchdog_s,
        )
        self._root = None
        if checkpoint_dir is not None:
            self._root = CheckpointManager(
                str(checkpoint_dir), keep=keep, faults=faults
            )
        self._staged: dict[str, _Staged] = {}
        self._buckets: deque[PackedRun] = deque()
        # (signature, packed width) -> Engine: one preparation per bucket shape
        self._engines: dict[tuple[str, int], Engine] = {}
        self._job_seq = itertools.count()
        self._bucket_seq = itertools.count()
        self._quanta_run: dict[int, int] = {}  # id(bucket) -> quanta count
        self.quantum_log: list[str] = []  # signature per quantum (fairness)
        self.jobs: dict[str, Job] = {}
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # idle handshake for shutdown(wait=True): the loop notifies after
        # any step that may have drained the last work, so shutdown blocks
        # on a condition instead of polling time.sleep(0.01)
        self._idle_cond = threading.Condition()
        # -- telemetry (repro_torch.obs) ----------------------------------------
        from repro_torch.obs import NULL, MetricsRegistry

        self._obs = obs
        self._timeline = obs.timeline if obs is not None else NULL
        self.metrics_every = metrics_every
        self.metrics_path = metrics_path
        m = obs.metrics if obs is not None else MetricsRegistry()
        self._registry = m
        self._m_queue_depth = m.gauge(
            "serve_queue_depth", "jobs submitted but not yet staged")
        self._m_buckets_live = m.gauge(
            "serve_buckets_live", "sealed buckets in the round-robin")
        self._m_wakeup = m.histogram(
            "serve_wakeup_latency_seconds",
            "submit-to-intake latency (idle-loop responsiveness)")
        self._m_time_in_queue = m.histogram(
            "serve_time_in_queue_seconds",
            "submit-to-seal latency (pack window + loop occupancy)")
        self._m_quantum = m.histogram(
            "serve_quantum_seconds", "wall time per scheduler quantum")
        self._m_quanta = m.counter(
            "serve_quanta_total", "quanta executed")
        self._m_idle_wakeups = m.counter(
            "serve_idle_wakeups_total",
            "loop wakeups that found no work to advance")
        self._m_occupancy = m.gauge(
            "serve_bucket_occupancy", "live jobs packed per bucket",
            labels=("bucket",))
        self._m_packed_per_compile = m.gauge(
            "serve_jobs_packed_per_compile",
            "jobs amortized per mega-step compile")
        self._m_job_sweeps = m.gauge(
            "serve_job_sweeps", "per-tenant sweeps completed", labels=("job",))
        # -- resilience counters --------------------------------------------------
        self._m_faults = m.counter(
            "pt_fault_injected", "injected faults fired, by site",
            labels=("site",))
        self._m_retries = m.counter(
            "pt_retries", "supervised quantum retries (bucket recoveries)")
        self._m_quarantined = m.counter(
            "pt_quarantined", "buckets quarantined after exhausting retries")
        self._m_degraded = m.counter(
            "pt_degraded_kernel",
            "fused/Pallas compile failures degraded to the per-sweep path")
        if faults is not None and faults.on_fire is None:
            faults.on_fire = lambda f: self._m_faults.labels(f.site).inc()

    # -- client API --------------------------------------------------------------
    def submit(
        self,
        spec: RunSpec,
        on_update: Callable[[Job, JobUpdate], Any] | None = None,
        job_id: str | None = None,
        block: bool = False,
        timeout: float | None = None,
    ) -> Job:
        """Enqueue one tenant run; returns immediately with its handle.

        With a bounded ``queue_depth``, a full queue raises `QueueFull` —
        or, with ``block=True``, waits up to ``timeout`` seconds for the
        host loop to drain space.  A rejected submission registers nothing.
        """
        if job_id is None:
            job_id = f"job-{next(self._job_seq):04d}"
        if job_id in self.jobs:
            raise ValueError(f"duplicate job id {job_id!r}")
        job = Job(job_id, spec, on_update=on_update)
        job.submitted_at = time.monotonic()
        # enqueue BEFORE registering: a QueueFull rejection must leave no
        # half-registered handle behind
        self.queue.put(job, block=block, timeout=timeout)
        self.jobs[job_id] = job
        self._m_queue_depth.set(len(self.queue))
        self._timeline.flow_start("job:" + job_id, job_id, track="intake",
                                  seed=job.seed)
        return job

    def result(self, job: Job | str, timeout: float | None = None) -> JobResult:
        """Block for one job's result (`Job.result`); accepts id or handle."""
        if isinstance(job, str):
            job = self.jobs[job]
        return job.result(timeout)

    # -- intake / packing --------------------------------------------------------
    def _intake(self) -> None:
        now = time.monotonic()
        drained = self.queue.drain()
        if drained:
            self._m_queue_depth.set(len(self.queue))
        for job in drained:
            if job.submitted_at is not None:
                self._m_wakeup.observe(now - job.submitted_at)
            try:
                check_servable(job.spec)
            except ValueError as err:
                job._fail(err)
                self._timeline.flow_end("job:" + job.id, job.id,
                                        track="intake", state="failed")
                continue
            digest, _ = shape_signature(job.spec)
            staged = self._staged.get(digest)
            if staged is None:
                staged = self._staged[digest] = _Staged(
                    template=job.spec, jobs=[], since=now
                )
            staged.jobs.append(job)

    def _seal(self, force: bool = False) -> None:
        now = time.monotonic()
        for digest in list(self._staged):
            staged = self._staged[digest]
            if not force and now - staged.since < self.pack_window:
                continue
            del self._staged[digest]
            self._buckets.append(self._make_bucket(digest, staged))

    def _engine_for(self, digest: str, template: RunSpec, width: int) -> Engine:
        key = (digest, width)
        engine = self._engines.get(key)
        if engine is None:
            system = template.system.build()
            config = dataclasses.replace(
                template.engine.build(
                    template.ladder.n_replicas,
                    exchange=template.exchange.build(),
                ),
                n_chains=width,
            )
            engine = Engine(
                system,
                config,
                observables=template.system.observables(
                    system, template.observables
                ),
                device=self.device,
                # packed engines share the scheduler's telemetry bundle, so
                # engine spans (compile, chunk, device_wait) land on the
                # same trace as the quantum lanes
                obs=self._obs,
                faults=self._faults,
                strict_kernels=self.strict_kernels,
                # obs-on engines count degradations themselves (into the
                # same registry); the hook covers the obs-off path only —
                # both would double-count
                on_degrade=(
                    self._m_degraded.inc if self._obs is None else None
                ),
            )
            self._engines[key] = engine
        return engine

    def _bucket_manager(self, name: str):
        return None if self._root is None else self._root.child(name)

    def _make_bucket(self, digest: str, staged: _Staged) -> PackedRun:
        width = sum(j.n_chains for j in staged.jobs)
        engine = self._engine_for(digest, staged.template, width)
        name = f"{digest}-{next(self._bucket_seq):04d}"
        bucket = PackedRun(
            digest, staged.template, staged.jobs, engine,
            manager=self._bucket_manager(name),
            faults=self._faults, name=name,
        )
        bucket.write_manifest()
        now = time.monotonic()
        lane = f"bucket:{digest[:8]}"
        self._m_occupancy.labels(name).set(len(staged.jobs))
        for job in staged.jobs:
            if job.submitted_at is not None:
                self._m_time_in_queue.observe(now - job.submitted_at)
            self._timeline.flow_step("job:" + job.id, job.id, track=lane,
                                     bucket=name)
        self._timeline.instant("seal", cat="serve", track=lane,
                               bucket=name, jobs=len(staged.jobs))
        return bucket

    def _checkpoint_bucket(self, bucket) -> None:
        """Best-effort bucket checkpoint: a failed save (e.g. an injected
        crash at a write seam) is non-fatal — the state is still live in
        memory, the on-disk generations stay intact (atomic rename), and
        the next cadence simply retries."""
        try:
            bucket.checkpoint()
        except Exception as err:
            warnings.warn(
                f"checkpoint save for bucket {bucket.name} failed "
                f"({err!r}); continuing from the in-memory state",
                RuntimeWarning,
            )

    # -- the host loop -----------------------------------------------------------
    def step(self) -> bool:
        """One scheduler step: intake, seal, run one quantum.  True if any
        bucket advanced."""
        self._intake()
        self._seal(force=self.pack_window <= 0)
        self._m_buckets_live.set(len(self._buckets))
        if not self._buckets:
            return False
        bucket = self._buckets.popleft()
        for job in bucket.live_jobs():
            job.state = JobState.RUNNING
        self.quantum_log.append(bucket.digest)
        lane = f"bucket:{bucket.digest[:8]}"
        t0 = time.perf_counter()
        out = self._supervisor.run(bucket, self.quantum_chunks)
        if out.bucket is not bucket:
            # a recovered generation replaced the instance we passed in —
            # move the quantum bookkeeping over with it
            self._quanta_run[id(out.bucket)] = self._quanta_run.pop(
                id(bucket), 0
            )
            bucket = out.bucket
        finished = out.finished
        dt = time.perf_counter() - t0
        self._m_quantum.observe(dt)
        self._m_quanta.inc()
        self._timeline.complete(
            "quantum", t0, dt, cat="serve", track=lane,
            args={"jobs": len(bucket.jobs), "finished": finished,
                  "retries": out.retries, "quarantined": out.quarantined},
        )
        if out.retries:
            self._m_retries.inc(out.retries)
        for rec in out.recoveries:
            self._timeline.complete(
                "recovery", rec["t0"], rec["seconds"], cat="serve",
                track=lane,
                args={"error": rec["error"], "sweep": rec["sweep"],
                      "fallback_depth": rec["fallback_depth"]},
            )
        n = self._quanta_run.get(id(bucket), 0) + 1
        self._quanta_run[id(bucket)] = n
        for job in bucket.jobs:
            if job.last_update is not None:
                self._m_job_sweeps.labels(job.id).set(
                    job.last_update.sweeps_done
                )
        if out.quarantined:
            self._m_quarantined.inc()
            self._quanta_run.pop(id(bucket), None)
            # no final checkpoint: the on-disk generations stay the last
            # *intact* pre-fault states (quarantine.json records the rest)
            for job in bucket.jobs:
                self._timeline.flow_end("job:" + job.id, job.id, track=lane,
                                        state=job.state.value)
        elif finished:
            self._quanta_run.pop(id(bucket), None)
            # final state: restart delivers instantly
            self._checkpoint_bucket(bucket)
            for job in bucket.jobs:
                self._timeline.flow_end("job:" + job.id, job.id, track=lane,
                                        state=job.state.value)
        else:
            if self.checkpoint_every_quanta and (
                n % self.checkpoint_every_quanta == 0
            ):
                self._checkpoint_bucket(bucket)
            for job in bucket.live_jobs():
                job.state = JobState.PREEMPTED
            self._buckets.append(bucket)
        n_compiles = sum(e.n_compiles for e in self._engines.values())
        if n_compiles:
            self._m_packed_per_compile.set(len(self.jobs) / n_compiles)
        if (
            self.metrics_every
            and self.metrics_path
            and len(self.quantum_log) % self.metrics_every == 0
        ):
            self.write_metrics(self.metrics_path)
        return True

    def idle(self) -> bool:
        return not (self._buckets or self._staged or len(self.queue))

    def run_until_idle(self, max_quanta: int | None = None) -> None:
        """Drive the loop synchronously until every submitted job resolves."""
        quanta = 0
        while not self.idle():
            if not self.step():
                continue
            quanta += 1
            if max_quanta is not None and quanta >= max_quanta:
                return

    def start(self) -> None:
        """Run the host loop on a background thread (service mode).

        On CUDA the thread issues its work under ``torch.cuda.device`` of the
        scheduler's device, on that device's current stream of the thread
        (`repro_torch.kernels.build.stream_of`), where the round tickets of
        its launches live."""
        if self._thread is not None:
            raise RuntimeError("scheduler already started")
        self._stop.clear()

        def loop():
            if self.device.type == "cuda":
                with torch.cuda.device(self.device):
                    serve()
            else:
                serve()

        def serve():
            while not self._stop.is_set():
                advanced = self.step()
                if not advanced and self.idle():
                    # possibly the last work just drained: let a blocked
                    # shutdown(wait=True) re-check before we sleep
                    with self._idle_cond:
                        self._idle_cond.notify_all()
                    self._m_idle_wakeups.inc()
                    # nothing live: block until a submission or a stop poke
                    # (both notify the queue condition — no sleep polling)
                    self.queue.wait(timeout=1.0)

        self._thread = threading.Thread(
            target=loop, name="repro-torch-serve", daemon=True
        )
        self._thread.start()

    def shutdown(self, wait: bool = True) -> None:
        """Stop the host loop.  With ``wait``, drain all live work first.

        The drain blocks on the loop's idle notification (condition
        variable), not a sleep poll; the timeout is only a safety net
        against a notify landing between our predicate check and the wait.

        With ``wait=False`` (or work submitted after the drain), jobs still
        PENDING — queued or staged but never sealed — FAIL with a typed
        `SchedulerStopped` instead of leaving their `Job.result` callers
        blocked forever.
        """
        if self._thread is not None:
            if wait:
                with self._idle_cond:
                    while not self.idle():
                        self._idle_cond.wait(timeout=0.5)
            self._stop.set()
            self.queue.poke()  # wake the loop out of its queue wait promptly
            self._thread.join()
            self._thread = None
        self._drain_pending()

    def _drain_pending(self) -> None:
        """FAIL every never-sealed PENDING job (queued or staged)."""
        stopped = [job for job in self.queue.drain()]
        for staged in self._staged.values():
            stopped.extend(staged.jobs)
        self._staged.clear()
        self._m_queue_depth.set(0)
        for job in stopped:
            if job.done():
                continue
            job._fail(SchedulerStopped(
                f"scheduler shut down before job {job.id} was scheduled"
            ))
            self._timeline.flow_end("job:" + job.id, job.id, track="intake",
                                    state="failed")

    # -- introspection -----------------------------------------------------------
    def metrics(self) -> dict:
        """Snapshot of the service metrics registry (`repro_torch.obs.metrics`).

        Always live — queue depth, quantum latency histograms, bucket
        occupancy, jobs-packed-per-compile, per-tenant sweep progress —
        whether or not an `Observability` bundle was attached.  Render with
        `repro_torch.obs.to_prometheus` / `to_json`.
        """
        return self._registry.snapshot()

    def write_metrics(self, path: str) -> str:
        """Write the Prometheus text exposition to ``path`` (atomic)."""
        from repro_torch.obs import write_prometheus

        return write_prometheus(self._registry, path)

    def stats(self) -> dict:
        """Service counters (what ``repro_torch serve`` reports)."""
        return {
            "n_jobs": len(self.jobs),
            "n_buckets_live": len(self._buckets),
            "n_engines": len(self._engines),
            "n_compiles": sum(e.n_compiles for e in self._engines.values()),
            "n_quanta": len(self.quantum_log),
            "states": {
                s.value: sum(1 for j in self.jobs.values() if j.state is s)
                for s in JobState
            },
            "resilience": dict(self._supervisor.totals),
            "faults_fired": (
                0 if self._faults is None else self._faults.fired()
            ),
        }

    # -- restart -----------------------------------------------------------------
    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, **kwargs) -> "Scheduler":
        """Rebuild a scheduler from its checkpoint root after a restart.

        Every subdirectory holding a ``serve.json`` manifest becomes a
        restored bucket: jobs are re-registered (fresh handles — client
        callbacks do not survive a process), engines are rebuilt and the
        newest packed state restored bit-equal.  Buckets whose checkpointed
        sweep counter already covers the schedule deliver their results
        immediately; the rest re-enter the round-robin where they left off.
        Phase summaries recorded before the restart are not replayed — a
        restored `JobResult.phases` only holds phases that *ended* after the
        restore point (the `Session.from_checkpoint` contract).
        """
        sched = cls(checkpoint_dir=checkpoint_dir, **kwargs)
        root = sched._root.dir
        for name in sorted(os.listdir(root)):
            manifest_path = os.path.join(root, name, MANIFEST_NAME)
            if not os.path.isfile(manifest_path):
                continue
            try:
                with open(manifest_path) as f:
                    manifest = json.load(f)
                digest = manifest["signature"]
                template = RunSpec.from_dict(manifest["template"])
                entries = manifest["jobs"]
            except Exception as err:
                # one poisoned bucket dir must not take down the whole
                # restart — every other bucket still resumes bit-equal
                warnings.warn(
                    f"skipping unreadable bucket manifest {manifest_path}: "
                    f"{err!r}",
                    RuntimeWarning,
                )
                continue
            jobs = []
            for entry in entries:
                job = Job(entry["id"], RunSpec.from_dict(entry["spec"]))
                job.state = JobState.PREEMPTED
                sched.jobs[job.id] = job
                jobs.append(job)
            width = sum(j.n_chains for j in jobs)
            bucket = PackedRun.restore(
                digest, template, jobs,
                sched._engine_for(digest, template, width),
                sched._root.child(name),
                faults=sched._faults, name=name,
            )
            # keep the bucket-name sequence ahead of restored dirs
            try:
                seq = int(name.rsplit("-", 1)[1])
                sched._bucket_seq = itertools.count(seq + 1)
            except (IndexError, ValueError):
                pass
            if bucket.finished:
                continue
            sched._buckets.append(bucket)
        return sched
