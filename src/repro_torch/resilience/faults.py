"""Deterministic fault injection: a seeded `FaultPlan` arming named sites
(twin of `repro.resilience.faults`).

The sites sit on the port's host paths (`repro_torch.engine.driver`,
`repro_torch.checkpoint.manager`, `repro_torch.serve`).  Every component
holds a ``faults`` handle that is ``None`` in production, and every site
costs one ``is None`` test when disarmed: nothing is constructed, and the
engine issues the same kernel launches with the plan armed or absent.

A `Fault` arms one site at given *occurrence indices* of that site
(0-based, counted per plan), so "the second checkpoint write tears" or
"chunk launch 3 raises" replays exactly.  `FaultPlan.from_seed` draws a
whole schedule from one integer with numpy, the same schedule as the JAX
package's for the same seed.

===================================   ========================================
site                                  behaviour when armed
===================================   ========================================
``checkpoint.write.torn``             staged arrays file truncated to half
                                      (a torn write that still got renamed)
``checkpoint.write.corrupt``          one byte flipped in the staged arrays
                                      (silent media corruption; digests
                                      catch it)
``checkpoint.write.crash_before_rename``  `InjectedCrash` with the staging
                                      dir left behind, step dir never
                                      created (process death mid-save)
``checkpoint.write.crash_after_rename``   `InjectedCrash` after the atomic
                                      swap landed (step dir is whole)
``engine.compile``                    `InjectedFault` where the engine
                                      prepares a chunk (loads its kernel
                                      libraries; degrades a fused or round
                                      path to the per-sweep path on the
                                      card, supervisor retry otherwise)
``engine.chunk.launch``               `InjectedFault` before a chunk is
                                      issued (transient launch error)
``engine.chunk.stall``                ``time.sleep(duration)`` before the
                                      chunk (a hung chunk; trips watchdogs)
``engine.energy.nonfinite``           one chain's device energies set to NaN
                                      after a chunk (a failing lane; the
                                      owning tenant FAILs typed, bucket
                                      mates are untouched)
``serve.callback``                    `InjectedFault` from inside a tenant's
                                      stream callback (per-job failure
                                      isolation)
===================================   ========================================
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

__all__ = [
    "SITES",
    "Fault",
    "FaultError",
    "FaultPlan",
    "InjectedCrash",
    "InjectedFault",
]

SITES = frozenset({
    "checkpoint.write.torn",
    "checkpoint.write.corrupt",
    "checkpoint.write.crash_before_rename",
    "checkpoint.write.crash_after_rename",
    "engine.compile",
    "engine.chunk.launch",
    "engine.chunk.stall",
    "engine.energy.nonfinite",
    "serve.callback",
})

# sites a Supervisor-recovered bucket replays through bit-equal (transient);
# the rest fail exactly one tenant cleanly instead of poisoning the bucket
RECOVERABLE_SITES = frozenset({
    "checkpoint.write.torn",
    "checkpoint.write.corrupt",
    "checkpoint.write.crash_before_rename",
    "checkpoint.write.crash_after_rename",
    "engine.compile",
    "engine.chunk.launch",
    "engine.chunk.stall",
})


class FaultError(RuntimeError):
    """Base class for every injected failure (typed: chaos assertions and
    retry classification match on this, never on bare RuntimeError)."""


class InjectedFault(FaultError):
    """A transient injected error (launch/compile/callback raise)."""


class InjectedCrash(FaultError):
    """Simulated process death at a crash site (checkpoint write seams)."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """Arm ``site`` at the given 0-based occurrence indices.

    ``duration`` is the stall length for ``engine.chunk.stall``; ``chain``
    selects the poisoned ensemble slot for ``engine.energy.nonfinite``
    (taken modulo the live chain count at the site).
    """

    site: str
    at: tuple[int, ...] = (0,)
    duration: float = 0.0
    chain: int = 0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; known: {sorted(SITES)}"
            )


class FaultPlan:
    """A deterministic schedule of injected faults over named sites.

    Components call ``check(site)`` (returns the armed `Fault` or None and
    advances that site's occurrence counter) or ``fire(site)`` (raises
    `InjectedFault` when armed).  Counters are plan-global and thread-safe,
    so one plan threaded through a whole scheduler — engines, checkpoint
    managers, buckets — produces one reproducible interleaving per
    single-threaded host loop.

    ``on_fire`` (optional, settable after construction) is called with the
    `Fault` each time a site actually fires — the scheduler hangs its
    ``pt_fault_injected`` counter here.
    """

    def __init__(self, faults, on_fire=None):
        self.faults = [
            f if isinstance(f, Fault) else Fault(**f) for f in faults
        ]
        self.on_fire = on_fire
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()
        # (site, occurrence) of every fault that actually fired, in order —
        # quarantine manifests and the chaos suite read this
        self.log: list[tuple[str, int]] = []

    @classmethod
    def from_seed(cls, seed: int, n_faults: int = 3, sites=None,
                  max_occurrence: int = 4, on_fire=None) -> "FaultPlan":
        """A random-but-reproducible schedule: ``n_faults`` draws of
        (site, occurrence) from ``sites`` (default: every known site)."""
        rng = np.random.RandomState(seed)
        pool = sorted(sites if sites is not None else SITES)
        faults = []
        for _ in range(n_faults):
            site = pool[rng.randint(len(pool))]
            faults.append(Fault(
                site=site,
                at=(int(rng.randint(max_occurrence)),),
                duration=0.0,
                chain=int(rng.randint(8)),
            ))
        return cls(faults, on_fire=on_fire)

    def check(self, site: str) -> Fault | None:
        """Advance ``site``'s occurrence counter; return the armed `Fault`
        for this occurrence, or None."""
        with self._lock:
            n = self._counts.get(site, 0)
            self._counts[site] = n + 1
            hit = None
            for f in self.faults:
                if f.site == site and n in f.at:
                    hit = f
                    break
            if hit is not None:
                self.log.append((site, n))
        if hit is not None and self.on_fire is not None:
            self.on_fire(hit)
        return hit

    def fire(self, site: str) -> None:
        """`check` and raise `InjectedFault` when armed (raise-type sites)."""
        f = self.check(site)
        if f is not None:
            raise InjectedFault(
                f"injected fault at {site} (occurrence "
                f"{self._counts[site] - 1})"
            )

    def fired(self, site: str | None = None) -> int:
        """How many faults have fired (at ``site``, or in total)."""
        with self._lock:
            if site is None:
                return len(self.log)
            return sum(1 for s, _ in self.log if s == site)

    def __repr__(self):
        return f"FaultPlan({self.faults!r}, fired={len(self.log)})"
