"""Production PT sampling driver (twin of `repro.launch.sample`).

The paper's experiment: the 300x300 Ising model with 1536 replicas on the
paper's ladder, logistic DEO swaps every 100 sweeps.  It runs through the
chunked engine (`repro_torch.engine.Engine`, the interval step that
`repro_torch.core.pt.run` is built on) on one card, or, under a launcher
that sets ``WORLD_SIZE`` (torchrun), on a ``1 x WORLD_SIZE`` mesh with the
replica axis split over the ranks (one card a rank, ``cuda:{LOCAL_RANK}``;
rank 0 prints and writes the checkpoints).  ``--smoke`` is a reduced run
(L=32, 16 replicas, 500 sweeps); ``--device cpu`` runs the plain PyTorch
versions of the kernels.

    PYTHONPATH=src python -m repro_torch.launch.sample --smoke --device cpu
    torchrun --nproc-per-node 2 -m repro_torch.launch.sample --smoke --device cpu

Each chunk prints the cold and hot rungs' |m| and replica-sweeps/s; the run
ends with the swap acceptance of the coldest pairs.  ``--ckpt-dir`` saves
the engine state every ``--ckpt-every`` intervals and resumes from the
newest step there, as the JAX driver does.
"""
from __future__ import annotations

import argparse
import os
import time


def _mesh():
    """``MeshSpec(1, WORLD_SIZE)`` under a launcher, else None."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return None
    from repro_torch.core.distributed import MeshSpec

    return MeshSpec(ensemble=1, replica=world)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.sample")
    ap.add_argument("--replicas", type=int, default=1536)  # paper: 1500 (padded to mesh)
    ap.add_argument("--length", type=int, default=300)  # paper: 300x300 spins
    ap.add_argument("--sweeps", type=int, default=2000)
    ap.add_argument("--swap-interval", type=int, default=100)
    ap.add_argument("--swap-mode", default="temp", choices=["temp", "state"])
    ap.add_argument("--smoke", action="store_true", help="reduced run")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0, help="intervals between checkpoints")
    args = ap.parse_args(argv)

    if args.smoke:
        args.replicas, args.length, args.sweeps = 16, 32, 500

    mesh = _mesh()
    if mesh is None:
        return _sample(args, None)
    from repro_torch.core.distributed import launcher_group

    with launcher_group(args.device):
        return _sample(args, mesh)


def _sample(args, mesh) -> int:
    import numpy as np

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import diagnostics, ising, keys, ladder
    from repro_torch.engine import Engine, EngineConfig

    system = ising.IsingSystem(length=args.length, j=1.0, b=0.0)
    interval = args.swap_interval if args.swap_interval > 0 else args.sweeps
    chunk = args.ckpt_every * interval if args.ckpt_every else args.sweeps
    cfg = EngineConfig(
        n_replicas=args.replicas, swap_interval=args.swap_interval,
        criterion="logistic", swap_mode=args.swap_mode, chunk_intervals=max(chunk // interval, 1),
        measure_interval=interval, record_trace=True, track_stats=False, mesh=mesh,
    )
    engine = Engine(system, cfg, observables={"am": lambda s: ising.magnetization(s).abs()},
                    device=args.device)
    state = engine.init(keys.key(0), ladder.paper_ladder(args.replicas))
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    say = print if engine.is_writer else (lambda *a, **k: None)
    if mgr is not None:
        restored = engine.restore(mgr)
        if restored:
            state, _ = restored
            say(f"[restart] resumed at sweep {int(state.pt.t.reshape(-1)[0])}")

    done, trace = 0, None
    t0 = time.time()
    while done < args.sweeps:
        n = min(chunk, args.sweeps - done)
        state, result = engine.run(state, n, checkpoint=mgr,
                                   checkpoint_every_chunks=1 if mgr is not None else 0)
        trace = result.trace
        done += n
        m = np.asarray(trace["am"])[-1]
        say(f"sweep {done:7d}  cold|m|={m[0]:.3f} hot|m|={m[-1]:.3f}  "
            f"{done * args.replicas / (time.time() - t0):.0f} replica-sweeps/s")
    if mgr is not None:
        mgr.wait()
    acc = diagnostics.swap_acceptance_rate(trace)
    say(f"final swap acceptance (cold pairs): {acc[:4]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
