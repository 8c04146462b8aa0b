"""Span recorder emitting Chrome trace-event JSON (twin of
`repro.obs.timeline`).

`Timeline` records spans, instants, counter series and flow arrows in the
Trace Event Format that Perfetto (ui.perfetto.dev) and ``chrome://tracing``
load:

* **tracks** — every event lands on a named track: the current thread by
  default, or a virtual lane given as ``track=`` (one per serve bucket, one
  per scheduler phase), mapped to small ``tid``s with ``thread_name``
  metadata events;
* **complete events** — spans are single ``"ph": "X"`` records (timestamp +
  duration), so a crashed run still yields a loadable file of everything
  that finished;
* **flow events** — ``"ph": "s"/"t"/"f"`` arrows stitch one serve job
  (PENDING → RUNNING → DONE) across tracks;
* **recording cost** — one dict append under a lock per event; components
  with observability off hold no recorder at all (`Engine.obs is None`).

Timestamps are `time.perf_counter()` microseconds relative to the
Timeline's creation: host time.  Device time comes from the engine's
synchronised ``device_wait`` spans and the one-chunk `torch.profiler`
window (`repro_torch.obs.Observability`).  `write()` lands atomically and
the file passes `repro_torch.obs.check_trace`.
"""
from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["Timeline", "NullTimeline", "NULL"]


class _Span:
    """Context manager recording one complete ("X") event on exit."""

    __slots__ = ("_tl", "name", "cat", "track", "args", "_t0")

    def __init__(self, tl: "Timeline", name, cat, track, args):
        self._tl = tl
        self.name = name
        self.cat = cat
        self.track = track
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def annotate(self, **kv) -> "_Span":
        """Attach extra args to the span before it closes."""
        if self.args is None:
            self.args = {}
        self.args.update(kv)
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        if exc_type is not None:
            self.annotate(error=exc_type.__name__)
        self._tl.complete(
            self.name, self._t0, t1 - self._t0,
            cat=self.cat, track=self.track, args=self.args,
        )
        return False


class Timeline:
    """Accumulates trace events; `write()` emits Perfetto-loadable JSON."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._t0 = time.perf_counter()
        self._pid = os.getpid()
        self._tracks: dict[str, int] = {}  # track name -> tid
        self.enabled = True

    # -- track bookkeeping -----------------------------------------------------
    def _tid(self, track: str | None) -> int:
        if track is None:
            track = threading.current_thread().name
        tid = self._tracks.get(track)
        if tid is None:
            with self._lock:
                tid = self._tracks.get(track)
                if tid is None:
                    tid = self._tracks[track] = len(self._tracks) + 1
                    self._events.append({
                        "name": "thread_name", "ph": "M", "pid": self._pid,
                        "tid": tid, "args": {"name": track},
                    })
        return tid

    def _ts(self, t: float | None = None) -> float:
        return ((time.perf_counter() if t is None else t) - self._t0) * 1e6

    def _emit(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)

    # -- recording API ---------------------------------------------------------
    def span(self, name: str, cat: str = "engine", track: str | None = None,
             **args) -> _Span:
        """``with timeline.span("chunk", index=3): ...`` — one X event."""
        return _Span(self, name, cat, track, args or None)

    def complete(self, name: str, start: float, duration: float, *,
                 cat: str = "engine", track: str | None = None,
                 args: dict | None = None) -> None:
        """Record a finished span from explicit perf_counter start/duration
        (for begin/end pairs that cross callback boundaries, e.g. phases)."""
        ev = {
            "name": name, "ph": "X", "cat": cat, "pid": self._pid,
            "tid": self._tid(track), "ts": self._ts(start),
            "dur": max(duration, 0.0) * 1e6,
        }
        if args:
            ev["args"] = args
        self._emit(ev)

    def instant(self, name: str, cat: str = "engine",
                track: str | None = None, **args) -> None:
        ev = {
            "name": name, "ph": "i", "s": "t", "cat": cat, "pid": self._pid,
            "tid": self._tid(track), "ts": self._ts(),
        }
        if args:
            ev["args"] = args
        self._emit(ev)

    def counter(self, name: str, values: dict, track: str | None = None,
                cat: str = "engine") -> None:
        """A counter ("C") sample — renders as a stacked area chart."""
        self._emit({
            "name": name, "ph": "C", "cat": cat, "pid": self._pid,
            "tid": self._tid(track), "ts": self._ts(),
            "args": {k: float(v) for k, v in values.items()},
        })

    def _flow(self, ph: str, name: str, flow_id, track, args) -> None:
        ev = {
            "name": name, "ph": ph, "cat": "flow", "pid": self._pid,
            "tid": self._tid(track), "ts": self._ts(), "id": str(flow_id),
        }
        if ph == "f":
            ev["bp"] = "e"  # bind to the enclosing slice's end
        if args:
            ev["args"] = args
        self._emit(ev)

    def flow_start(self, name: str, flow_id, track: str | None = None, **args):
        self._flow("s", name, flow_id, track, args)

    def flow_step(self, name: str, flow_id, track: str | None = None, **args):
        self._flow("t", name, flow_id, track, args)

    def flow_end(self, name: str, flow_id, track: str | None = None, **args):
        self._flow("f", name, flow_id, track, args)

    # -- output ----------------------------------------------------------------
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def to_dict(self) -> dict:
        return {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {"producer": "repro_torch.obs.timeline"},
        }

    def write(self, path: str) -> str:
        """Atomically write the Chrome-trace JSON; returns the path.

        Safe to call repeatedly mid-run (each call rewrites the full file),
        which is how `ObsCallback` keeps a loadable timeline on disk even if
        the process dies between phases.
        """
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{path}.{self._pid}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f)
        os.replace(tmp, path)
        return path


class _NullSpan:
    """Reusable no-op span: no allocation per `span()` call."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **kv):
        return self


_NULL_SPAN = _NullSpan()


class NullTimeline:
    """API-compatible no-op recorder.

    Components that *sometimes* record can hold this instead of branching on
    None at every site; every method returns immediately and `span()` hands
    back one shared reusable object — structurally zero per-call allocation.
    (The engine host loop goes further and holds no recorder at all when
    observability is off.)
    """

    enabled = False

    def span(self, name, cat="engine", track=None, **args):
        return _NULL_SPAN

    def complete(self, *a, **k):
        pass

    def instant(self, *a, **k):
        pass

    def counter(self, *a, **k):
        pass

    def flow_start(self, *a, **k):
        pass

    def flow_step(self, *a, **k):
        pass

    def flow_end(self, *a, **k):
        pass

    def events(self):
        return []

    def __len__(self):
        return 0

    def to_dict(self):
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def write(self, path):
        raise RuntimeError(
            "NullTimeline records nothing; construct the Observability with "
            "timeline=True to write a trace file"
        )


NULL = NullTimeline()
