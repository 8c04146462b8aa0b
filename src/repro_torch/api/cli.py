"""``python -m repro_torch`` — run RunSpec JSON files on the port.

Subcommands:

  run SPEC.json [--out DIR] [--device cuda|cpu]
                  execute the spec end to end and write ``DIR/manifest.json``
                  (default device: cuda; cpu runs the plain PyTorch versions)
  list-systems    registered systems and their observables

``resume``, ``validate`` and ``serve`` are not ported yet.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from repro_torch.api.session import ProgressCallback, Session
from repro_torch.api.spec import RunSpec

__all__ = ["main"]


def _cmd_run(args) -> int:
    with open(args.spec) as f:
        spec = RunSpec.from_json(f.read())
    out = args.out or os.path.join(
        "runs", os.path.splitext(os.path.basename(args.spec))[0]
    )
    os.makedirs(out, exist_ok=True)
    callbacks = [] if args.quiet else [ProgressCallback()]
    result = Session(spec, callbacks=callbacks, device=args.device).run()
    path = result.write_manifest(os.path.join(out, "manifest.json"))
    if not args.quiet:
        temps = 1.0 / result.state.betas.cpu().numpy().astype(np.float64)
        print(f"final ladder: {np.round(temps, 4).tolist()}", file=sys.stderr)
    print(path)
    return 0


def _cmd_list_systems(args) -> int:
    from repro_torch.core.systems import CONSTRUCTORS

    for name, entry in sorted(CONSTRUCTORS.items()):
        print(f"{name}: observables {sorted(entry.observables)}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m repro_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="execute a RunSpec JSON")
    run.add_argument("spec")
    run.add_argument("--out", default=None, help="output directory")
    run.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    run.add_argument("--quiet", action="store_true")
    run.set_defaults(fn=_cmd_run)
    ls = sub.add_parser("list-systems", help="registered systems")
    ls.set_defaults(fn=_cmd_list_systems)
    args = parser.parse_args(argv)
    return args.fn(args)
