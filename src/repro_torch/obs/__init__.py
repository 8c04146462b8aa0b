"""Observability: metrics registry + Perfetto timelines + exporters (twin of
`repro.obs`).

* `repro_torch.obs.metrics`  — thread-safe labeled counters, gauges and
  histograms with cheap snapshots;
* `repro_torch.obs.timeline` — span recorder emitting Chrome trace-event
  JSON (per-thread and virtual tracks, flow arrows);
* `repro_torch.obs.export`   — Prometheus text and canonical JSON
  exposition, and the snapshot digest.

`Observability` bundles one registry and one timeline into the handle that
instrumented components accept (`Engine(obs=...)`, `Scheduler(obs=...)`,
`ObsCallback`).  The overhead contract:

* **off is structurally free** — components hold ``obs=None`` and guard
  every instrumentation site with one ``is None`` test; the engine issues
  the same kernel launches (`repro_torch.kernels.build.launches`) and no
  host sync between chunk boundaries;
* **on is cheap** — a span is one dict append, a metric one locked float op;
  the engine synchronises the card once per chunk for an honest
  ``device_seconds``.

``torch_profile_dir`` arms a one-chunk `torch.profiler` window: the first
engine chunk after arming runs under the profiler (CPU, and CUDA where the
card is there) and its Chrome trace lands in the directory.  A profiler
that fails to start is an instant on the timeline, never a failed run.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

from repro_torch.obs.export import (
    snapshot_digest,
    to_json,
    to_prometheus,
    write_json,
    write_prometheus,
)
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.timeline import NULL, NullTimeline, Timeline

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Timeline",
    "NullTimeline",
    "NULL",
    "Observability",
    "to_prometheus",
    "to_json",
    "snapshot_digest",
    "write_prometheus",
    "write_json",
]

# the file a torch.profiler window writes into ``torch_profile_dir``
PROFILE_NAME = "torch_profile.trace.json"


@dataclasses.dataclass
class Observability:
    """One registry + one timeline: the handle instrumented code accepts.

    ``torch_profile_dir`` arms the one-chunk `torch.profiler` window (the
    JAX package's ``jax_profile_dir``): one chunk only, so the profiler's
    own cost stays out of the rest of the timeline.
    """

    metrics: MetricsRegistry
    timeline: Timeline | NullTimeline
    torch_profile_dir: str | None = None
    _profiler: Any = dataclasses.field(default=None, repr=False)

    @classmethod
    def create(cls, timeline: bool = True,
               torch_profile_dir: str | None = None) -> "Observability":
        return cls(
            metrics=MetricsRegistry(),
            timeline=Timeline() if timeline else NULL,
            torch_profile_dir=torch_profile_dir,
        )

    # -- one-chunk torch.profiler window ----------------------------------------
    def start_torch_profile(self) -> bool:
        """Open the profiler window if armed and unused; True if opened."""
        if self.torch_profile_dir is None or self._profiler is not None:
            return False
        import torch

        try:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            os.makedirs(self.torch_profile_dir, exist_ok=True)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        except Exception as e:  # profiler backends vary; never kill the run
            self.timeline.instant("torch_profile_failed", error=repr(e))
            self.torch_profile_dir = None
            return False
        self._profiler = prof
        self.timeline.instant("torch_profile_start", dir=self.torch_profile_dir)
        return True

    def stop_torch_profile(self) -> str | None:
        """Close the window and write its Chrome trace; returns its path."""
        prof = self._profiler
        if prof is None:
            return None
        path = os.path.join(self.torch_profile_dir, PROFILE_NAME)
        try:
            prof.stop()
            prof.export_chrome_trace(path)
        finally:
            self._profiler = None
            # disarm: the window is one chunk, ever
            self.torch_profile_dir = None
        self.timeline.instant("torch_profile_stop", path=path)
        return path
