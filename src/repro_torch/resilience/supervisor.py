"""Supervised execution of scheduler quanta: retry, watchdog, quarantine
(twin of `repro.resilience.supervisor`).

The `Supervisor` sits between `repro_torch.serve.Scheduler.step` and
`PackedRun.run_quantum` and turns a fault into one of two outcomes:

* **recovered** — a transient failure (a launch raise, a torn checkpoint
  write, a failed kernel preparation, a stalled chunk caught by the
  watchdog) rebuilds the bucket from its last *intact* checkpoint
  generation (`CheckpointManager.restore_latest` walks past corrupt steps;
  with no manager, from scratch) and retries the quantum after an
  exponential backoff with deterministic jitter.  The replay is bit-equal
  to the fault-free run: chunk boundaries and preemption are invisible to
  the counter streams, and the summaries of phases that ended before the
  restore point are carried over.
* **quarantined** — after ``RetryPolicy.max_attempts`` consecutive
  failures of one quantum (or a wedged watchdog thread), the bucket's live
  jobs FAIL with a typed `BucketQuarantined` and a failure manifest
  (``quarantine.json``: error, attempts, fired faults) lands next to the
  bucket's checkpoints.  The scheduler keeps serving every other bucket.

Watchdogs are wall-clock: the quantum (and, separately, the first chunk's
preparation) runs on a worker thread joined with a timeout.  Kernel launches
return before the card finishes, so a quantum's time only counts the device
work up to its sync points: `PackedRun` reads every chunk's energies to the
host to stream them, which waits for the card, so a stalled device shows as
a stalled quantum.  On expiry the bucket is *abandoned* (its host loop sees
the flag at the next chunk boundary and stops without delivering updates),
and the supervisor waits ``grace_s`` for the worker before retrying; a
worker that never exits is wedged and the bucket is quarantined.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from typing import Any, Callable

from repro_torch.resilience.faults import FaultError

__all__ = [
    "BucketQuarantined",
    "CompileTimeout",
    "QuantumOutcome",
    "RetryPolicy",
    "Supervisor",
    "WatchdogTimeout",
]

QUARANTINE_NAME = "quarantine.json"


class WatchdogTimeout(FaultError):
    """A supervised step exceeded its wall-clock budget.

    ``wedged`` marks a worker thread that survived the post-abandon grace
    period — retrying would race the stuck thread, so the supervisor
    quarantines immediately instead.
    """

    def __init__(self, msg: str, wedged: bool = False):
        super().__init__(msg)
        self.wedged = wedged


class CompileTimeout(WatchdogTimeout):
    """The first chunk's preparation (the kernel libraries' build and load)
    exceeded its wall-clock budget."""


class BucketQuarantined(RuntimeError):
    """Raised through `Job.result` for every job of a quarantined bucket."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with deterministic jitter.

    The jitter is a pure function of ``(key, attempt)`` (sha256-derived), so
    a replayed fault schedule sleeps the same wall pattern every run — the
    chaos suite stays reproducible while a real fleet still decorrelates
    (every bucket name hashes to a different fraction).
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.25

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")

    def delay(self, key: str, attempt: int) -> float:
        base = min(self.max_delay_s, self.base_delay_s * (2 ** (attempt - 1)))
        u = int.from_bytes(
            hashlib.sha256(f"{key}:{attempt}".encode()).digest()[:8], "big"
        ) / 2.0**64
        return base * (1.0 + self.jitter * u)


@dataclasses.dataclass
class QuantumOutcome:
    """What one supervised quantum did.  ``bucket`` may be a recovered
    replacement for the instance the scheduler passed in."""

    bucket: Any
    finished: bool
    retries: int = 0
    quarantined: bool = False
    error: BaseException | None = None
    # one dict per recovery: {"t0", "seconds", "error", "sweep",
    # "fallback_depth"} — the scheduler turns these into timeline spans
    recoveries: list = dataclasses.field(default_factory=list)


class Supervisor:
    """Typed retry/quarantine around bucket quanta.

    Args:
      policy: retry budget + backoff shape.
      watchdog_s: wall-clock budget per quantum (0 = no watchdog thread —
        the quantum runs inline and only raised exceptions are supervised).
      compile_watchdog_s: separate budget for the first chunk's preparation
        of a bucket (0 = covered by the quantum watchdog, if any).
      grace_s: post-abandon wait for a timed-out worker before declaring
        it wedged.
      sleep: injectable clock for tests.
    """

    def __init__(
        self,
        policy: RetryPolicy | None = None,
        watchdog_s: float = 0.0,
        compile_watchdog_s: float = 0.0,
        grace_s: float = 10.0,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.policy = policy or RetryPolicy()
        self.watchdog_s = watchdog_s
        self.compile_watchdog_s = compile_watchdog_s
        self.grace_s = grace_s
        self._sleep = sleep
        # cumulative service counters
        self.totals = {
            "retries": 0,
            "quarantined_buckets": 0,
            "quarantined_jobs": 0,
            "recovery_seconds": 0.0,
            "fallback_depth": 0,
        }

    # -- execution -------------------------------------------------------------
    def run(self, bucket, quantum_chunks: int) -> QuantumOutcome:
        """Run one quantum under supervision; never raises for bucket-level
        faults (the outcome says what happened)."""
        attempt = 0
        recoveries: list[dict] = []
        while True:
            try:
                finished = self._attempt(bucket, quantum_chunks)
                return QuantumOutcome(
                    bucket=bucket, finished=finished, retries=attempt,
                    recoveries=recoveries,
                )
            except Exception as err:
                attempt += 1
                wedged = isinstance(err, WatchdogTimeout) and err.wedged
                if wedged or attempt >= self.policy.max_attempts:
                    self._quarantine(bucket, err, attempt, recoveries)
                    return QuantumOutcome(
                        bucket=bucket, finished=True, retries=attempt - 1,
                        quarantined=True, error=err, recoveries=recoveries,
                    )
                t0 = time.perf_counter()
                self._sleep(self.policy.delay(
                    getattr(bucket, "name", bucket.digest), attempt
                ))
                bucket = bucket.recover()
                dt = time.perf_counter() - t0
                depth = getattr(bucket, "restore_fallback_depth", 0)
                recoveries.append({
                    "t0": t0,
                    "seconds": dt,
                    "error": repr(err),
                    "sweep": bucket.sweeps_done,
                    "fallback_depth": depth,
                })
                self.totals["retries"] += 1
                self.totals["recovery_seconds"] += dt
                self.totals["fallback_depth"] += depth

    def _attempt(self, bucket, quantum_chunks: int):
        if self.compile_watchdog_s > 0:
            self._watchdogged(
                bucket.ensure_compiled, self.compile_watchdog_s,
                CompileTimeout, bucket, "compile",
            )
        if self.watchdog_s > 0:
            return self._watchdogged(
                lambda: bucket.run_quantum(quantum_chunks), self.watchdog_s,
                WatchdogTimeout, bucket, "quantum",
            )
        return bucket.run_quantum(quantum_chunks)

    def _watchdogged(self, fn, timeout: float, exc_type, bucket, label: str):
        box: dict[str, Any] = {}

        def target():
            try:
                box["value"] = fn()
            except BaseException as e:
                box["error"] = e

        worker = threading.Thread(
            target=target, daemon=True, name=f"repro-supervised-{label}"
        )
        worker.start()
        worker.join(timeout)
        if worker.is_alive():
            # cooperative cancellation: the bucket's host loop checks the
            # abandon flag at every chunk boundary and stops silently — no
            # tenant sees updates from an abandoned attempt
            bucket.abandon()
            worker.join(self.grace_s)
            raise exc_type(
                f"{label} for bucket {getattr(bucket, 'name', bucket.digest)}"
                f" exceeded {timeout}s"
                + (" and never drained (wedged)" if worker.is_alive() else ""),
                wedged=worker.is_alive(),
            )
        if "error" in box:
            raise box["error"]
        return box.get("value")

    # -- quarantine -------------------------------------------------------------
    def _quarantine(self, bucket, err, attempts: int, recoveries: list) -> None:
        qerr = BucketQuarantined(
            f"bucket {getattr(bucket, 'name', bucket.digest)} quarantined "
            f"after {attempts} attempt(s): {err!r}"
        )
        qerr.__cause__ = err
        jobs = bucket.live_jobs()
        for job in jobs:
            job._fail(qerr)
        bucket.finished = True  # drop from rotation; a stray requeue no-ops
        self.totals["quarantined_buckets"] += 1
        self.totals["quarantined_jobs"] += len(jobs)
        manager = getattr(bucket, "manager", None)
        if manager is None:
            return
        manifest = {
            "bucket": getattr(bucket, "name", bucket.digest),
            "signature": bucket.digest,
            "jobs": [j.id for j in bucket.jobs],
            "failed_jobs": sorted(bucket._failed),
            "attempts": attempts,
            "error": repr(err),
            "sweeps_done": bucket.sweeps_done,
            "recoveries": recoveries,
            "time": time.time(),
        }
        faults = getattr(bucket, "faults", None)
        if faults is not None:
            manifest["fired_faults"] = [list(x) for x in faults.log]
        path = os.path.join(manager.dir, QUARANTINE_NAME)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
