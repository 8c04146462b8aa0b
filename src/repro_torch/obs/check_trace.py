"""Schema check for Chrome trace-event JSON files (twin of
`repro.obs.check_trace`).

Perfetto silently drops malformed events, so "the file loads" is no
regression gate.  This validator pins the structural contract:

* top level: ``traceEvents`` list (JSON object form);
* every event: ``ph``/``pid``/``tid``/``name`` present with sane types;
  ``X`` events carry numeric ``ts`` >= 0 and ``dur`` >= 0; flow events
  (``s``/``t``/``f``) carry an ``id``; metadata (``M``) events are exempt
  from timestamp rules;
* flow arrows balance: every flow id that starts also finishes (only when
  asked: a preempted run legitimately has open flows);
* optional ``--require-span NAME`` assertions: the named span must appear as
  at least one ``X`` event.

Usable as a library (`validate_trace`, raises `TraceError`) or a CLI::

    python -m repro_torch.obs.check_trace out.trace.json \
        --require-span compile --require-span chunk
"""
from __future__ import annotations

import argparse
import json
import sys

__all__ = ["TraceError", "validate_trace", "main"]

_KNOWN_PH = {"X", "B", "E", "i", "I", "C", "M", "s", "t", "f", "b", "e", "n"}


class TraceError(ValueError):
    """A structural violation of the trace-event contract."""


def validate_trace(
    data: dict,
    require_spans: list[str] | None = None,
    require_balanced_flows: bool = False,
) -> dict:
    """Validate a parsed trace file; returns summary stats.

    Raises `TraceError` on any structural violation.  The summary maps
    ``n_events`` / ``n_spans`` / ``span_names`` / ``tracks`` /
    ``open_flows`` — the CI step prints it next to the artifact upload.
    """
    if not isinstance(data, dict) or "traceEvents" not in data:
        raise TraceError("top level must be an object with 'traceEvents'")
    events = data["traceEvents"]
    if not isinstance(events, list) or not events:
        raise TraceError("'traceEvents' must be a non-empty list")

    span_names: dict[str, int] = {}
    tracks: dict[int, str] = {}
    flow_open: dict[str, str] = {}
    n_spans = 0
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            raise TraceError(f"{where}: event is not an object")
        ph = ev.get("ph")
        if ph not in _KNOWN_PH:
            raise TraceError(f"{where}: unknown or missing ph {ph!r}")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                raise TraceError(f"{where}: {key} missing or non-integer")
        name = ev.get("name")
        if not isinstance(name, str) or not name:
            raise TraceError(f"{where}: name missing or empty")
        if ph == "M":
            if name == "thread_name":
                tracks[ev["tid"]] = ev.get("args", {}).get("name", "")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise TraceError(f"{where}: ts missing or negative ({ts!r})")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise TraceError(f"{where}: X event dur missing or negative")
            n_spans += 1
            span_names[name] = span_names.get(name, 0) + 1
        if ph in ("s", "t", "f"):
            fid = ev.get("id")
            if fid is None:
                raise TraceError(f"{where}: flow event without id")
            if ph == "s":
                flow_open[str(fid)] = name
            elif ph == "f":
                flow_open.pop(str(fid), None)
        if ph == "C" and not isinstance(ev.get("args"), dict):
            raise TraceError(f"{where}: counter event without args dict")

    for want in require_spans or []:
        if want not in span_names:
            raise TraceError(
                f"required span {want!r} absent; spans present: "
                f"{sorted(span_names)}"
            )
    if require_balanced_flows and flow_open:
        raise TraceError(f"unfinished flows: {sorted(flow_open.items())}")
    return {
        "n_events": len(events),
        "n_spans": n_spans,
        "span_names": dict(sorted(span_names.items())),
        "tracks": [tracks[t] for t in sorted(tracks)],
        "open_flows": len(flow_open),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="path to a .trace.json file")
    ap.add_argument("--require-span", action="append", default=[],
                    metavar="NAME", help="fail unless an X event named NAME exists")
    ap.add_argument("--require-balanced-flows", action="store_true",
                    help="fail if any flow id starts but never finishes")
    args = ap.parse_args(argv)
    try:
        with open(args.trace) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"FAIL: cannot parse {args.trace}: {e}", file=sys.stderr)
        return 1
    try:
        summary = validate_trace(
            data,
            require_spans=args.require_span,
            require_balanced_flows=args.require_balanced_flows,
        )
    except TraceError as e:
        print(f"FAIL: {args.trace}: {e}", file=sys.stderr)
        return 1
    print(
        f"OK: {args.trace}: {summary['n_events']} events, "
        f"{summary['n_spans']} spans over tracks {summary['tracks']}; "
        f"spans: {summary['span_names']}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
