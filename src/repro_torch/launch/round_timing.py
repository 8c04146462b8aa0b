"""Wall time per interval of the whole-round path through ``Session``, on the
card, for one source tree of the port: run it once per tree to compare two.

    python src/repro_torch/launch/round_timing.py --src src
    python src/repro_torch/launch/round_timing.py --src OTHER_CHECKOUT/src

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (a
checkout, or ``git archive`` of one with its ``pyproject.toml``, so that its
kernels build beside it).  Only the public API is used, so an earlier tree
runs it unchanged.  For each configuration (Ising L=32 R=1500 swapping
every sweep, the same with ``pack_bits``, Potts 32x32 q=3 the same, and the
paper's Ising L=300 R=1500 S=100) it runs the spec once to warm up, then
``--repeats`` times from a fresh state, each ended by a synchronise, and
prints the wall time per interval of each run, the host CPU time this
process spent per interval (``time.process_time``: less moved by other
processes on a shared host than the wall clock, and what a host-bound
interval costs), the kernel launches of one run (``build.launches``) and
the card's name and power limit.  Adaptation is off and the observables
are ``chip_smoke.py``'s (absmag, energy per site; pmag for Potts), so an
interval is one round launch plus the engine's own per-interval work.

Then, for the round op alone (``ops.ising_round_fused`` / ``potts_round_fused``,
``n_rounds=1``, as the engine calls it once an interval), calls back to back
at L=300 R=1500 S=100, S=2 and L=32 R=1500 S=1, each fed the last call's
state, rung and energy, ended by a synchronise: the wall and host CPU time
per call, ``--repeats`` times, and the device time per call by the
profiler (all device work of a call, and that of the round's own kernels:
the sweep kernel, and kernel B where the tree has it).
"""
from __future__ import annotations

import argparse
import functools
import subprocess
import sys
import time
from pathlib import Path

# name -> (system, params, sweeps per interval, intervals, observables)
CONFIGS = {
    "ising L=32 R=1500 S=1": ("ising", {"length": 32}, 1, 2000, ("absmag", "energy_per_site")),
    "ising L=32 R=1500 S=1 pack_bits": ("ising", {"length": 32, "pack_bits": True}, 1, 2000,
                                        ("absmag", "energy_per_site")),
    "potts 32x32 q=3 R=1500 S=1": ("potts", {"shape": (32, 32), "q": 3}, 1, 2000, ("pmag",)),
    "ising L=300 R=1500 S=100": ("ising", {"length": 300}, 100, 6, ("absmag", "energy_per_site")),
}


# round op alone: name -> (system, keyword arguments of the op, side, sweeps
# a round, calls a timed pass, calls a profiled pass)
OPS = {
    f"op {op} {shape} S={s}{tag}": (system, kw, side, s, n_calls, n_prof)
    for side, s, n_calls, n_prof in ((300, 100, 6, 3), (300, 2, 100, 20), (32, 1, 2000, 200))
    for op, system, kw, tag in (("ising_round_fused", "ising", {}, ""),
                                ("ising_round_fused", "ising", {"pack_bits": True}, " pack_bits"),
                                ("potts_round_fused", "potts", {"q": 3}, ""))
    for shape in ([f"L={side} R=1500" if system == "ising" else f"{side}x{side} q=3 R=1500"])
}
# the round's own kernels (profiler names): the sweep launch and kernel B
ROUND_KERNELS = ("ising_fused_kernel", "ising_packed_kernel", "potts_fused_kernel",
                 "exchange_kernel")


def device_ms(torch, fn, reps: int) -> tuple[float, float]:
    """(all device time, the round kernels' device time) per call of ``fn``
    over ``reps`` calls, by the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)  # the tracer runs before fn starts
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(float(e.self_device_time_total) for e in rows)
    own = sum(float(e.self_device_time_total) for e in rows
              if any(k in e.key for k in ROUND_KERNELS))
    return total / reps / 1e3, own / reps / 1e3


def time_op(torch, name: str, repeats: int):
    """Wall and host CPU ms per call of round op ``name`` (see the module
    docstring), ``repeats`` times after one warm-up pass, and the profiler's
    (all, round kernels') device ms per call."""
    from repro_torch.core import keys
    from repro_torch.kernels import ops

    system, kw, side, n_sweeps, n_calls, n_prof = OPS[name]
    r, dev = 1500, torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    if system == "ising":
        states = 2 * torch.randint(0, 2, (r, side, side), generator=g, device=dev,
                                   dtype=torch.int8) - 1
        op = functools.partial(ops.ising_round_fused, **kw)
    else:
        states = torch.randint(0, kw["q"], (r, side, side), generator=g, device=dev,
                               dtype=torch.int8)
        op = functools.partial(ops.potts_round_fused, **kw)
    rung = torch.randperm(r, generator=g, device=dev).to(torch.int32)
    energy = torch.zeros(r, device=dev)
    betas = 1.0 / torch.linspace(1.0, 4.0, r, device=dev)
    key = keys.key(0, device=dev)
    t0 = torch.zeros((), dtype=torch.int64, device=dev)
    carry = [states, rung, energy]

    def call():
        carry[:] = op(carry[0], key, t0, t0, carry[1], carry[2], betas, n_sweeps=n_sweeps,
                      rule="glauber")[:3]

    walls, cpus = [], []
    for rep in range(repeats + 1):  # the first pass warms up
        torch.cuda.synchronize()
        t, c = time.perf_counter(), time.process_time()
        for _ in range(n_calls):
            call()
        torch.cuda.synchronize()
        if rep:
            walls.append(1e3 * (time.perf_counter() - t) / n_calls)
            cpus.append(1e3 * (time.process_time() - c) / n_calls)
    return walls, cpus, device_ms(torch, call, n_prof)


def make_spec(name: str):
    """The RunSpec of configuration ``name`` (round path, glauber, no
    adaptation, one phase of its intervals)."""
    from repro_torch.api import (
        EngineSpec, LadderSpec, PhaseSpec, RunSpec, ScheduleSpec, SystemSpec,
    )

    system, params, interval, n_int, observables = CONFIGS[name]
    params = {**params, "accept_rule": "glauber", "use_fused": True, "use_fused_round": True}
    ladder = (LadderSpec(kind="paper", n_replicas=1500, t_min=1.0, t_max=4.0)
              if system == "ising"
              else LadderSpec(kind="geometric", n_replicas=1500, t_min=0.7, t_max=2.9))
    phase = PhaseSpec(name="run", n_sweeps=interval * n_int)
    return RunSpec(system=SystemSpec(system, params), ladder=ladder,
                   engine=EngineSpec(swap_interval=interval, chunk_intervals=min(n_int, 100)),
                   schedule=ScheduleSpec(phases=(phase,)), observables=observables, seed=0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, required=True,
                    help="src directory to import repro_torch from")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--only", nargs="*", default=[*CONFIGS, *OPS], help="configuration names")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.src.resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("round_timing needs a CUDA card")
    from repro_torch.api import Session
    from repro_torch.kernels import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"tree {args.src.resolve()} [{card}]")
    for name in args.only:
        if name in OPS:
            build.reset_launches()
            walls, cpus, (dev_all, dev_own) = time_op(torch, name, args.repeats)
            print(f"  {name}: ms/call " + " / ".join(f"{w:.4f}" for w in walls)
                  + f" (min {min(walls):.4f}), host CPU ms/call "
                  + " / ".join(f"{x:.4f}" for x in cpus) + f" (min {min(cpus):.4f}), "
                  f"device ms/call {dev_all:.5f} (round kernels {dev_own:.5f}); "
                  f"launches {({k: v for k, v in build.launches.items() if v})}", flush=True)
            continue
        spec, n_int = make_spec(name), CONFIGS[name][3]
        walls, cpus, launches = [], [], None
        for rep in range(args.repeats + 1):  # the first run warms up
            session = Session(spec, device="cuda")
            session.state = session.init_state()
            torch.cuda.synchronize()
            build.reset_launches()
            t, c = time.perf_counter(), time.process_time()
            session.run()
            torch.cuda.synchronize()
            if rep:
                walls.append(1e3 * (time.perf_counter() - t) / n_int)
                cpus.append(1e3 * (time.process_time() - c) / n_int)
                launches = {k: v for k, v in build.launches.items() if v}
        print(f"  {name}: {n_int} intervals a run, ms/interval "
              + " / ".join(f"{w:.4f}" for w in walls)
              + f" (min {min(walls):.4f}), host CPU ms/interval "
              + " / ".join(f"{x:.4f}" for x in cpus)
              + f" (min {min(cpus):.4f}); launches a run {launches}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
