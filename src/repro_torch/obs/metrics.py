"""Thread-safe labeled metrics registry (twin of `repro.obs.metrics`).

One `MetricsRegistry` holds every counter/gauge/histogram a process
exports.  It sits inside the engine's host loop and the serve scheduler's
quantum loop, which shape it:

* **hot-path cost is a dict lookup + a lock + a float add.**  Metric
  families cache their labeled children, so steady-state `inc()`/`set()`/
  `observe()` never allocates.
* **cheap snapshot semantics** — `snapshot()` returns a plain, JSON-able
  dict copied under the locks (O(series), no device traffic, no references
  into live state), so exporters (`repro_torch.obs.export`) serialize
  without racing writers.
* **no global state.**  Registries are plain objects handed around
  explicitly (`Engine(obs=...)`, `Scheduler(obs=...)`).

The same sequence of registry operations gives the same snapshot as the
JAX package's registry, so the exporters' bytes and digests agree.
"""
from __future__ import annotations

import threading
from typing import Sequence

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_BUCKETS",
]

# Seconds-oriented log-ish buckets: wide enough for µs spans (a metrics
# write) through multi-second compiles.  Prometheus convention: upper bounds,
# +Inf implicit.
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class _Family:
    """One named metric family: labeled children cached by label values."""

    kind = "untyped"

    def __init__(self, name: str, help: str, label_names: Sequence[str]):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], object] = {}

    def labels(self, *values, **kv):
        """The child at these label values (created on first use, cached)."""
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by name")
            values = tuple(str(kv[k]) for k in self.label_names)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: got {len(values)} label values for "
                f"labels {self.label_names}"
            )
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.setdefault(values, self._make_child())
        return child

    def _default_child(self):
        """The label-less child (families declared with no labels)."""
        if self.label_names:
            raise ValueError(
                f"{self.name} is labeled {self.label_names}; use .labels(...)"
            )
        return self.labels()

    def _make_child(self):
        raise NotImplementedError

    def samples(self) -> list[dict]:
        """Plain-data samples for `MetricsRegistry.snapshot` (thread-safe)."""
        with self._lock:
            items = list(self._children.items())
        out = []
        for values, child in items:
            out.append(
                {"labels": dict(zip(self.label_names, values)),
                 **child.sample()}
            )
        return out


class _CounterChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def sample(self) -> dict:
        return {"value": self.value}


class Counter(_Family):
    kind = "counter"

    def _make_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class _GaugeChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def sample(self) -> dict:
        return {"value": self.value}


class Gauge(_Family):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class _HistogramChild:
    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds: tuple[float, ...]):
        self._lock = threading.Lock()
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # last slot = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        # linear scan: bucket lists are short (~16) and the loop is cheaper
        # than bisect's call overhead at this size
        i = 0
        for b in self._bounds:
            if value <= b:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def sample(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, count = self._sum, self._count
        cum, buckets = 0, []
        for b, c in zip(self._bounds, counts):
            cum += c
            buckets.append([b, cum])
        buckets.append(["+Inf", count])
        return {"buckets": buckets, "sum": total, "count": count}

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name, help, label_names, buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, label_names)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("a histogram needs at least one bucket bound")

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._default_child().observe(value)

    @property
    def count(self) -> int:
        return self._default_child().count

    @property
    def sum(self) -> float:
        return self._default_child().sum


_NAME_OK = set("abcdefghijklmnopqrstuvwxyz_:0123456789")


class MetricsRegistry:
    """A process-local set of metric families, keyed by name.

    Declaring the same name twice returns the *same* family (and raises if
    the second declaration disagrees on kind or labels) — instrumentation
    sites can therefore declare-and-use locally without coordinating on a
    central schema module.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _declare(self, cls, name, help, labels, **kw):
        if not name or name[0].isdigit() or not set(name.lower()) <= _NAME_OK:
            raise ValueError(f"bad metric name {name!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = cls(name, help, tuple(labels), **kw)
                return fam
        if not isinstance(fam, cls) or fam.label_names != tuple(labels):
            raise ValueError(
                f"metric {name!r} re-declared as {cls.kind}{tuple(labels)} "
                f"but exists as {fam.kind}{fam.label_names}"
            )
        return fam

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Counter:
        return self._declare(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Gauge:
        return self._declare(Gauge, name, help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._declare(Histogram, name, help, labels, buckets=buckets)

    def snapshot(self) -> dict:
        """Plain JSON-able view: name -> {type, help, label_names, samples}.

        Copied under the per-family locks — safe against concurrent writers,
        never holds references into live metric state.
        """
        with self._lock:
            families = list(self._families.items())
        out = {}
        for name, fam in sorted(families):
            out[name] = {
                "type": fam.kind,
                "help": fam.help,
                "label_names": list(fam.label_names),
                "samples": fam.samples(),
            }
        return out
