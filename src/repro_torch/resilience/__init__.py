"""Fault injection, supervised recovery and graceful degradation (twin of
`repro.resilience`).

* `repro_torch.resilience.faults` — a seeded `FaultPlan` arming named sites
  in the engine's host loop, the checkpoint writer and the serve scheduler;
  disarmed (``faults=None``) every site is one ``is None`` test;
* `repro_torch.resilience.supervisor` — `Supervisor`: typed retry with
  exponential backoff and deterministic jitter, wall-clock watchdogs,
  bit-equal bucket recovery from the last intact checkpoint, quarantine
  with a failure manifest;
* graceful degradation lives at its call sites: a failed kernel build or
  launch on a fused or round path falls back to the per-sweep path *on the
  card* (`repro_torch.engine.driver`; never to the CPU or to a plain
  version, and an error with ``strict_kernels``), corrupt checkpoint
  generations fall back to the newest intact one
  (`repro_torch.checkpoint.manager`), and the serve intake queue refuses
  past a bounded depth (`repro_torch.serve.job.QueueFull`).

Under any injected fault schedule every job either completes bit-equal to
its fault-free run or fails with a typed error, and the checkpoints on
disk stay loadable.
"""
from repro_torch.resilience.faults import (
    RECOVERABLE_SITES,
    SITES,
    Fault,
    FaultError,
    FaultPlan,
    InjectedCrash,
    InjectedFault,
)
from repro_torch.resilience.supervisor import (
    BucketQuarantined,
    CompileTimeout,
    QuantumOutcome,
    RetryPolicy,
    Supervisor,
    WatchdogTimeout,
)

__all__ = [
    "BucketQuarantined",
    "CompileTimeout",
    "Fault",
    "FaultError",
    "FaultPlan",
    "InjectedCrash",
    "InjectedFault",
    "QuantumOutcome",
    "RECOVERABLE_SITES",
    "RetryPolicy",
    "SITES",
    "Supervisor",
    "WatchdogTimeout",
]
