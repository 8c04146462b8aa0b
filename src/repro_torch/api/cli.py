"""``python -m repro_torch`` — run RunSpec JSON files on the port.

Subcommands:

  run SPEC.json [--out DIR] [--device cuda|cpu]
                  execute the spec end to end and write ``DIR/manifest.json``
                  (default device: cuda; cpu runs the plain PyTorch versions)
  validate SYSTEM [--seed N] [--exchange deo] [--fused] [--out DIR]
                  [--device cuda|cpu]
                  conformance-run a system-zoo entry (``ising``, ``potts``)
                  against its exact reference; exit 1 on failure, 2 for a
                  system or option the port lacks; ``--fused`` runs the
                  interval-fused kernel path
  list-systems    registered systems and their observables

``resume`` and ``serve`` are not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
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


def _cmd_validate(args) -> int:
    # validate builds on the api layer, so it is imported here, not at the top
    from repro_torch.core import systems
    from repro_torch.validate import assert_conforms, run_conformance

    try:
        entry = systems.registered(args.system)
    except (KeyError, NotImplementedError) as err:
        print(err.args[0], file=sys.stderr)
        return 2
    if args.exchange != "deo":
        print(f"not yet ported: exchange strategy {args.exchange!r} on the "
              "strategy path", file=sys.stderr)
        return 2
    # use_pallas rides along as in the JAX CLI; the port ignores it
    system_params = {"use_fused": True, "use_pallas": True} if args.fused else None
    report = run_conformance(entry, seed=args.seed, exchange=args.exchange,
                             system_params=system_params, device=args.device)
    worst_series, worst_z = report.worst()
    kernel = " fused" if args.fused else ""
    print(f"{args.system} [{args.exchange}{kernel}]: {report.n_batches} batch means, "
          f"ladder retuned {report.n_retunes}x, "
          f"worst |z| = {worst_z:.2f} ({worst_series})")
    for k in sorted(report.means):
        for r, t in enumerate(report.temps):
            print(f"  T={t:7.3f}  <{k}> = {report.means[k][r]: .5f} "
                  f"(exact {report.exact[k][r]: .5f}, |z|={abs(report.z[k][r]):.2f})")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, f"validate_{args.system}.json")
        payload = {"system": args.system, "seed": args.seed,
                   "exchange": args.exchange, "fused": bool(args.fused),
                   "device": args.device}
        for f in dataclasses.fields(report):
            v = getattr(report, f.name)
            if isinstance(v, dict):
                v = {k: np.asarray(a, np.float64).tolist() for k, a in v.items()}
            elif isinstance(v, np.ndarray):
                v = v.tolist()
            payload[f.name] = v
        with open(path, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
        print(path)
    try:
        assert_conforms(report)
    except AssertionError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print("PASS: all observables within tolerance of the exact reference")
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
    val = sub.add_parser("validate",
                         help="conformance-run a zoo system vs its exact reference")
    val.add_argument("system", help="registry name (ising, potts)")
    val.add_argument("--seed", type=int, default=0)
    val.add_argument("--exchange", default="deo", help="replica-exchange strategy")
    val.add_argument("--fused", action="store_true",
                     help="run the interval-fused kernel path (use_fused=True)")
    val.add_argument("--out", default=None, help="also write the report JSON here")
    val.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    val.set_defaults(fn=_cmd_validate)
    ls = sub.add_parser("list-systems", help="registered systems")
    ls.set_defaults(fn=_cmd_list_systems)
    args = parser.parse_args(argv)
    return args.fn(args)
