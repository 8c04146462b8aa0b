"""``python -m repro_torch`` — run RunSpec JSON files on the port.

Subcommands:

  run SPEC.json [--out DIR] [--device cuda|cpu] [--checkpoint-every N]
                  [--mesh-chains E] [--mesh-replicas D]
                  [--timeline OUT.trace.json] [--metrics-out OUT.prom]
                  [--torch-profile DIR] [--strict-kernels]
                  execute the spec end to end and write ``DIR/manifest.json``
                  (default device: cuda; cpu runs the plain PyTorch versions),
                  checkpointing into ``DIR/checkpoints`` every N chunks; the
                  obs flags write a Perfetto timeline, the Prometheus
                  metrics and a one-chunk torch.profiler trace;
                  --strict-kernels fails where a fused or round path would
                  degrade to the per-sweep path; the mesh flags run the spec
                  on an E x D mesh (overriding ``engine.mesh``), one process
                  a rank: ``torchrun --nproc-per-node E*D -m repro_torch run
                  ...`` (RANK / WORLD_SIZE / LOCAL_RANK bring up the process
                  group: NCCL on cuda, gloo on cpu; rank 0 writes the
                  checkpoints and the manifest)
  resume DIR [--device cuda|cpu] [--mesh-chains E] [--mesh-replicas D]
                  continue a ``run`` output directory (of either package,
                  from any mesh) from ``DIR/checkpoints``; writes
                  ``DIR/manifest.json``
  validate SYSTEM [--seed N] [--exchange NAME] [--fused] [--out DIR]
                  [--device cuda|cpu]
                  conformance-run a system-zoo entry (``ising``,
                  ``gaussian``, ``potts``, ``ea_spin_glass``, ``hp_protein``)
                  against its exact reference; exit 1 on failure, 2 for an
                  unknown system or strategy; ``--fused`` runs the
                  interval-fused kernel path (Ising and Potts)
  serve SPEC.json... [--jobs N] [--seed0 S] [--out DIR] [--device cuda|cpu]
                  [--quantum-chunks N] [--pack-window SEC]
                  [--checkpoint-dir DIR] [--checkpoint-every N]
                  [--metrics-every N] [--metrics-out OUT.prom]
                  [--timeline OUT.trace.json] [--max-attempts N]
                  [--watchdog-s SEC] [--queue-depth N]
                  pack N seed variants of each spec into shared buckets
                  (`repro_torch.serve.Scheduler`) and write
                  ``DIR/serve_results.json``; exit 1 if any job failed
  list-systems    registered systems and their observables
  list-strategies registered replica-exchange strategies
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

import numpy as np

from repro_torch.api.session import (
    CheckpointCallback,
    ObsCallback,
    ProgressCallback,
    Session,
)
from repro_torch.api.spec import RunSpec

__all__ = ["main"]


def _with_mesh(spec: RunSpec, args) -> RunSpec:
    """``spec`` with the command line's mesh (``--mesh-chains`` /
    ``--mesh-replicas``, 0 = keep the spec's) in ``engine.mesh``."""
    if args.mesh_chains > 0 or args.mesh_replicas > 0:
        from repro_torch.core.distributed import MeshSpec

        mesh = MeshSpec(ensemble=max(args.mesh_chains, 1), replica=max(args.mesh_replicas, 1))
        spec = dataclasses.replace(spec, engine=dataclasses.replace(spec.engine, mesh=mesh))
    return spec


def _ranks(spec: RunSpec, device: str):
    """Under a launcher that sets ``WORLD_SIZE`` (torchrun), the process
    group a mesh spec runs on, for a ``with`` (brought up from the
    environment and ended after the run: `repro_torch.core.distributed.
    launcher_group`); otherwise nothing.  Yields whether this process
    writes results: rank 0, or the only process."""
    if spec.engine.mesh is None or "WORLD_SIZE" not in os.environ:
        return contextlib.nullcontext(True)
    from repro_torch.core.distributed import launcher_group

    return launcher_group(device)


def _cmd_run(args) -> int:
    with open(args.spec) as f:
        spec = _with_mesh(RunSpec.from_json(f.read()), args)
    out = args.out or os.path.join(
        "runs", os.path.splitext(os.path.basename(args.spec))[0]
    )
    with _ranks(spec, args.device) as writer:
        os.makedirs(out, exist_ok=True)
        callbacks = [] if args.quiet else [ProgressCallback(every=args.progress_every)]
        callbacks.append(CheckpointCallback(os.path.join(out, "checkpoints"),
                                            every_chunks=args.checkpoint_every))
        obs_cb = None
        if args.timeline or args.metrics_out or args.torch_profile:
            obs_cb = ObsCallback(timeline_path=args.timeline, metrics_path=args.metrics_out,
                                 torch_profile_dir=args.torch_profile)
            callbacks.append(obs_cb)
        result = Session(spec, callbacks=callbacks, device=args.device,
                         strict_kernels=args.strict_kernels).run()
    if not writer:
        return 0
    path = result.write_manifest(os.path.join(out, "manifest.json"))
    if obs_cb is not None:
        for kind, p in sorted(obs_cb.write().items()):
            if not args.quiet:
                print(f"{kind}: {p}", file=sys.stderr)
    if not args.quiet:
        temps = 1.0 / result.state.betas.cpu().numpy().astype(np.float64)
        print(f"final ladder: {np.round(temps, 4).tolist()}", file=sys.stderr)
    print(path)
    return 0


def _cmd_resume(args) -> int:
    ckdir = os.path.join(args.dir, "checkpoints")
    callbacks = [] if args.quiet else [ProgressCallback(every=args.progress_every)]
    callbacks.append(CheckpointCallback(ckdir, every_chunks=args.checkpoint_every))
    from repro_torch.checkpoint import CheckpointManager

    data = CheckpointManager(ckdir).load_spec()
    if data is None:
        raise FileNotFoundError(f"no spec.json in {ckdir!r}")
    spec = _with_mesh(RunSpec.from_json(data), args)
    with _ranks(spec, args.device) as writer:
        session = Session.from_checkpoint(ckdir, callbacks=callbacks, device=args.device,
                                          mesh=spec.engine.mesh)
        if session.remaining_sweeps == 0:
            print(f"nothing to resume: the checkpointed run already covers all "
                  f"{session.spec.schedule.total_sweeps} scheduled sweeps", file=sys.stderr)
            return 0
        result = session.run()
    if writer:
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


def _cmd_serve(args) -> int:
    # the serve layer builds on the api layer: imported here, not at the top
    from repro_torch.serve import JobFailedError, Scheduler

    out = args.out or "runs/serve"
    obs = None
    if args.timeline:
        from repro_torch.obs import Observability

        obs = Observability.create(timeline=True)
    metrics_path = args.metrics_out or os.path.join(out, "metrics.prom")
    sched = Scheduler(
        checkpoint_dir=args.checkpoint_dir,
        quantum_chunks=args.quantum_chunks,
        pack_window=args.pack_window,
        checkpoint_every_quanta=args.checkpoint_every,
        obs=obs,
        metrics_every=args.metrics_every,
        metrics_path=metrics_path if args.metrics_every else None,
        max_attempts=args.max_attempts,
        watchdog_s=args.watchdog_s,
        queue_depth=args.queue_depth,
        device=args.device,
    )
    handles = []
    for path in args.specs:
        with open(path) as f:
            spec = RunSpec.from_json(f.read())
        stem = os.path.splitext(os.path.basename(path))[0]
        for i in range(args.jobs):
            tenant = dataclasses.replace(spec, seed=args.seed0 + i)
            handles.append(sched.submit(tenant, job_id=f"{stem}-seed{args.seed0 + i}"))
    sched.run_until_idle()
    stats = sched.stats()
    results, failed = {}, {}
    for job in handles:
        try:
            results[job.id] = sched.result(job, timeout=0).manifest()
        except JobFailedError as e:
            failed[job.id] = repr(e)
    os.makedirs(out, exist_ok=True)
    sched.write_metrics(metrics_path)
    if obs is not None:
        obs.timeline.write(args.timeline)
        if not args.quiet:
            print(f"timeline: {args.timeline}", file=sys.stderr)
    if not args.quiet:
        print(f"metrics: {metrics_path}", file=sys.stderr)
    path = os.path.join(out, "serve_results.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"scheduler": stats, "results": results, "failed": failed},
                  f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    if not args.quiet:
        print(f"{stats['n_jobs']} jobs, {stats['n_engines']} packed engine(s), "
              f"{stats['n_compiles']} compile(s), {stats['n_quanta']} quanta",
              file=sys.stderr)
    print(path)
    return 1 if failed else 0


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


def _mesh_flags(p) -> None:
    p.add_argument("--mesh-chains", type=int, default=0, metavar="E",
                   help="shard whole chains over E ranks (MeshSpec ensemble axis; "
                        "overrides the spec's engine.mesh)")
    p.add_argument("--mesh-replicas", type=int, default=0, metavar="D",
                   help="shard the replica axis over D ranks (MeshSpec replica axis; "
                        "overrides the spec's engine.mesh)")


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
    _mesh_flags(run)
    run.add_argument("--timeline", default=None, metavar="OUT.trace.json",
                     help="record a Perfetto/Chrome trace of the run (compile, "
                          "chunk, device_wait, adapt, checkpoint spans)")
    run.add_argument("--metrics-out", default=None, metavar="OUT.prom",
                     help="write the run's metrics (Prometheus text format)")
    run.add_argument("--torch-profile", default=None, metavar="DIR",
                     help="wrap one engine chunk in torch.profiler and write "
                          "its Chrome trace under DIR")
    run.add_argument("--strict-kernels", action="store_true",
                     help="fail if a fused or round path's kernels cannot be "
                          "prepared or launched, instead of degrading to the "
                          "per-sweep path on the same device")
    run.add_argument("--quiet", action="store_true")
    run.set_defaults(fn=_cmd_run)
    res = sub.add_parser("resume", help="continue a checkpointed run directory")
    res.add_argument("dir", help="a previous `run` output dir")
    res.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    res.add_argument("--checkpoint-every", type=int, default=10,
                     help="chunks between checkpoints")
    res.add_argument("--progress-every", type=int, default=10)
    _mesh_flags(res)
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
    srv = sub.add_parser("serve", help="pack seed-variant jobs of each spec into "
                                       "shared buckets (repro_torch.serve)")
    srv.add_argument("specs", nargs="+", help="spec JSONs; same-shaped specs share "
                                              "one packed engine")
    srv.add_argument("--jobs", type=int, default=4,
                     help="seed variants submitted per spec (default 4)")
    srv.add_argument("--seed0", type=int, default=0, help="first tenant seed")
    srv.add_argument("--out", default=None,
                     help="output dir for serve_results.json (default runs/serve)")
    srv.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    srv.add_argument("--quantum-chunks", type=int, default=1,
                     help="engine chunks per scheduler time-slice")
    srv.add_argument("--pack-window", type=float, default=0.0,
                     help="seconds to hold a new shape open for bucket-mates")
    srv.add_argument("--checkpoint-dir", default=None,
                     help="enable preemption persistence under this root")
    srv.add_argument("--checkpoint-every", type=int, default=0,
                     help="quanta between bucket checkpoints (0 = seal/finish only)")
    srv.add_argument("--metrics-every", type=int, default=0, metavar="N",
                     help="rewrite the Prometheus metrics file every N quanta "
                          "(0 = only once at the end)")
    srv.add_argument("--metrics-out", default=None, metavar="OUT.prom",
                     help="metrics destination (default <out>/metrics.prom)")
    srv.add_argument("--timeline", default=None, metavar="OUT.trace.json",
                     help="record a Perfetto trace of the scheduler (quantum "
                          "lanes, job flows, engine spans)")
    srv.add_argument("--max-attempts", type=int, default=3,
                     help="supervised retries per quantum before the bucket "
                          "is quarantined")
    srv.add_argument("--watchdog-s", type=float, default=0.0,
                     help="wall-clock budget per quantum and first chunk "
                          "preparation; 0 disables the watchdog threads")
    srv.add_argument("--queue-depth", type=int, default=0,
                     help="bound the intake queue (QueueFull backpressure); "
                          "0 = unbounded")
    srv.add_argument("--quiet", action="store_true")
    srv.set_defaults(fn=_cmd_serve)
    ls = sub.add_parser("list-systems", help="registered systems")
    ls.set_defaults(fn=_cmd_list_systems)
    lst = sub.add_parser("list-strategies", help="registered replica-exchange strategies")
    lst.set_defaults(fn=_cmd_list_strategies)
    args = parser.parse_args(argv)
    return args.fn(args)
