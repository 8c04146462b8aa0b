"""PT as a service: multi-tenant scheduling with shape-bucketed job packing
(twin of `repro.serve`).

Many small PT runs share one card by packing same-shaped `RunSpec`s along
the engine's ensemble axis — N tenants, one kernel launch a round on the
round and fused paths — while a round-robin host loop time-slices the live
buckets in chunk-sized quanta:

* `repro_torch.serve.job`       — `Job` lifecycle, streamed `JobUpdate`s,
  the thread-safe intake `JobQueue`;
* `repro_torch.serve.bucket`    — `shape_signature` bucketing, the
  `check_servable` preconditions, and `PackedRun` (per-tenant key streams,
  streaming, failure isolation, checkpointed preemption);
* `repro_torch.serve.scheduler` — the `Scheduler`: ``submit()`` /
  ``result()``, pack-window sealing, the engine cache, and
  `Scheduler.from_checkpoint` restart.

The isolation contract: a packed job's results are bit-equal to running its
spec alone — packing changes throughput, never results.

    >>> from dataclasses import replace
    >>> from repro_torch.serve import Scheduler
    >>> sched = Scheduler(device="cuda")
    >>> handles = [sched.submit(replace(spec, seed=s)) for s in range(8)]
    >>> sched.run_until_idle()
    >>> results = [h.result() for h in handles]

CLI front door: ``python -m repro_torch serve spec.json --jobs 8``.
"""
from repro_torch.resilience.supervisor import BucketQuarantined
from repro_torch.serve.bucket import PackedRun, check_servable, shape_signature
from repro_torch.serve.job import (
    Job,
    JobFailedError,
    JobQueue,
    JobResult,
    JobState,
    JobUpdate,
    QueueFull,
    SchedulerStopped,
)
from repro_torch.serve.scheduler import Scheduler

__all__ = [
    "BucketQuarantined",
    "Job",
    "JobFailedError",
    "JobQueue",
    "JobResult",
    "JobState",
    "JobUpdate",
    "PackedRun",
    "QueueFull",
    "Scheduler",
    "SchedulerStopped",
    "check_servable",
    "shape_signature",
]
