"""Metric exposition: Prometheus text format + JSON snapshots (twin of
`repro.obs.export`).

Consumes `MetricsRegistry.snapshot()` (plain data: the registry is never
touched while serializing) and renders:

* `to_prometheus` — the Prometheus text exposition format (0.0.4): # HELP /
  # TYPE headers, labeled samples, `_bucket`/`_sum`/`_count` expansion for
  histograms;
* `to_json` / `snapshot_digest` — canonical JSON of the snapshot and its
  short sha1, the provenance stamp of a run's metrics.

Both give the JAX package's bytes for the same snapshot.  Writers are
atomic (tmp + rename): a scrape never reads a half-written file.
"""
from __future__ import annotations

import hashlib
import json
import os

__all__ = [
    "to_prometheus",
    "to_json",
    "snapshot_digest",
    "write_prometheus",
    "write_json",
]


def _escape(value: str) -> str:
    return (
        str(value).replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')
    )


def _labels_str(labels: dict, extra: dict | None = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(items.items()))
    return "{" + inner + "}"


def _fmt(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def to_prometheus(snapshot: dict) -> str:
    """Render a registry snapshot as Prometheus text exposition."""
    lines: list[str] = []
    for name, fam in snapshot.items():
        if fam.get("help"):
            lines.append(f"# HELP {name} {_escape(fam['help'])}")
        lines.append(f"# TYPE {name} {fam['type']}")
        for sample in fam["samples"]:
            labels = sample.get("labels", {})
            if fam["type"] == "histogram":
                for le, cum in sample["buckets"]:
                    lines.append(
                        f"{name}_bucket{_labels_str(labels, {'le': le})} {cum}"
                    )
                lines.append(f"{name}_sum{_labels_str(labels)} {_fmt(sample['sum'])}")
                lines.append(f"{name}_count{_labels_str(labels)} {sample['count']}")
            else:
                lines.append(f"{name}{_labels_str(labels)} {_fmt(sample['value'])}")
    return "\n".join(lines) + "\n"


def to_json(snapshot: dict, **meta) -> str:
    """Canonical JSON of a snapshot (sorted keys, compact separators)."""
    payload = {"metrics": snapshot}
    if meta:
        payload.update(meta)
    return json.dumps(payload, sort_keys=True, separators=(",", ":"))


def snapshot_digest(snapshot: dict) -> str:
    """Short sha1 of the canonical snapshot JSON — the provenance stamp."""
    return hashlib.sha1(to_json(snapshot).encode()).hexdigest()[:12]


def _atomic_write(path: str, text: str) -> str:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
    return path


def write_prometheus(registry, path: str) -> str:
    """Snapshot ``registry`` and write Prometheus text to ``path`` (atomic)."""
    return _atomic_write(path, to_prometheus(registry.snapshot()))


def write_json(registry, path: str, **meta) -> str:
    """Snapshot ``registry`` and write canonical JSON to ``path`` (atomic)."""
    return _atomic_write(path, to_json(registry.snapshot(), **meta))
