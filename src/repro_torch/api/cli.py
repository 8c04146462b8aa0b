"""``python -m repro_torch`` — run RunSpec JSON files on the port.

Subcommands:

  run SPEC.json [--out DIR] [--device cuda|cpu] [--checkpoint-every N]
                  execute the spec end to end and write ``DIR/manifest.json``
                  (default device: cuda; cpu runs the plain PyTorch versions),
                  checkpointing into ``DIR/checkpoints`` every N chunks
  resume DIR [--device cuda|cpu]
                  continue a ``run`` output directory (of either package)
                  from ``DIR/checkpoints``; writes ``DIR/manifest.json``
  validate SYSTEM [--seed N] [--exchange NAME] [--fused] [--out DIR]
                  [--device cuda|cpu]
                  conformance-run a system-zoo entry (``ising``,
                  ``gaussian``, ``potts``, ``ea_spin_glass``, ``hp_protein``)
                  against its exact reference; exit 1 on failure, 2 for an
                  unknown system or strategy; ``--fused`` runs the
                  interval-fused kernel path (Ising and Potts)
  list-systems    registered systems and their observables
  list-strategies registered replica-exchange strategies

``serve`` is not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

from repro_torch.api.session import CheckpointCallback, ProgressCallback, Session
from repro_torch.api.spec import RunSpec

__all__ = ["main"]


def _cmd_run(args) -> int:
    with open(args.spec) as f:
        spec = RunSpec.from_json(f.read())
    out = args.out or os.path.join(
        "runs", os.path.splitext(os.path.basename(args.spec))[0]
    )
    os.makedirs(out, exist_ok=True)
    callbacks = [] if args.quiet else [ProgressCallback(every=args.progress_every)]
    callbacks.append(CheckpointCallback(os.path.join(out, "checkpoints"),
                                        every_chunks=args.checkpoint_every))
    result = Session(spec, callbacks=callbacks, device=args.device).run()
    path = result.write_manifest(os.path.join(out, "manifest.json"))
    if not args.quiet:
        temps = 1.0 / result.state.betas.cpu().numpy().astype(np.float64)
        print(f"final ladder: {np.round(temps, 4).tolist()}", file=sys.stderr)
    print(path)
    return 0


def _cmd_resume(args) -> int:
    ckdir = os.path.join(args.dir, "checkpoints")
    callbacks = [] if args.quiet else [ProgressCallback(every=args.progress_every)]
    callbacks.append(CheckpointCallback(ckdir, every_chunks=args.checkpoint_every))
    session = Session.from_checkpoint(ckdir, callbacks=callbacks, device=args.device)
    if session.remaining_sweeps == 0:
        print(f"nothing to resume: the checkpointed run already covers all "
              f"{session.spec.schedule.total_sweeps} scheduled sweeps", file=sys.stderr)
        return 0
    result = session.run()
    print(result.write_manifest(os.path.join(args.dir, "manifest.json")))
    return 0


def _cmd_validate(args) -> int:
    # validate builds on the api layer, so it is imported here, not at the top
    from repro_torch.core import systems
    from repro_torch.validate import assert_conforms, run_conformance

    try:
        entry = systems.registered(args.system)
    except KeyError as err:
        print(err.args[0], file=sys.stderr)
        return 2
    from repro_torch.exchange import available_strategies

    if args.exchange not in available_strategies():
        print(f"unknown exchange strategy {args.exchange!r}; registered: "
              f"{available_strategies()}", file=sys.stderr)
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


def _cmd_list_strategies(args) -> int:
    from repro_torch import exchange

    for name in exchange.available_strategies():
        print(f"{name}")
        print(f"  {exchange.strategy_help(name)}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m repro_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="execute a RunSpec JSON")
    run.add_argument("spec")
    run.add_argument("--out", default=None, help="output directory")
    run.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    run.add_argument("--checkpoint-every", type=int, default=10,
                     help="chunks between checkpoints")
    run.add_argument("--progress-every", type=int, default=10,
                     help="chunks between progress lines")
    run.add_argument("--quiet", action="store_true")
    run.set_defaults(fn=_cmd_run)
    res = sub.add_parser("resume", help="continue a checkpointed run directory")
    res.add_argument("dir", help="a previous `run` output dir")
    res.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    res.add_argument("--checkpoint-every", type=int, default=10,
                     help="chunks between checkpoints")
    res.add_argument("--progress-every", type=int, default=10)
    res.add_argument("--quiet", action="store_true")
    res.set_defaults(fn=_cmd_resume)
    val = sub.add_parser("validate",
                         help="conformance-run a zoo system vs its exact reference")
    val.add_argument("system", help="registry name (ising, gaussian, potts, ea_spin_glass, hp_protein)")
    val.add_argument("--seed", type=int, default=0)
    val.add_argument("--exchange", default="deo",
                     help="replica-exchange strategy (see list-strategies)")
    val.add_argument("--fused", action="store_true",
                     help="run the interval-fused kernel path (use_fused=True)")
    val.add_argument("--out", default=None, help="also write the report JSON here")
    val.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    val.set_defaults(fn=_cmd_validate)
    ls = sub.add_parser("list-systems", help="registered systems")
    ls.set_defaults(fn=_cmd_list_systems)
    lst = sub.add_parser("list-strategies", help="registered replica-exchange strategies")
    lst.set_defaults(fn=_cmd_list_strategies)
    args = parser.parse_args(argv)
    return args.fn(args)
