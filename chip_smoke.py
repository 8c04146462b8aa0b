#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):

1. device name and power limit, then the nvcc build of every kernel;
2. kernel A (``csrc/ising_fused.cu``) against its plain PyTorch version on
   the card: the main path's L=300 R=1500 (S=2), then L=300 R=32 S=4,
   L=64 R=64 S=10 and a j=0.7 b=0.3 case under metropolis and glauber;
3. kernel B (``csrc/exchange.cu``) against the plain ``exchange_step`` at
   R=1500, DEO/SEO x logistic/metropolis over 8 phases;
4. the main path at full width through ``repro_torch.api.Session``: Ising
   L=300, glauber, whole-round fused kernels, paper ladder R=1500, swap
   interval 100, logistic DEO, adaptation in burn, 300 + 300 sweeps; launch
   counts must equal the interval count and the incremental energy must
   equal the recomputed lattice energy exactly;
   the same run again, warm, and once more under ``torch.profiler``, which
   says where the device time goes, the device's idle share and the host
   syncs of the run;
5. the same spec on the interval-fused path (kernel A + torch DEO swap) at
   200 sweeps; 3 intervals of each path with every host sync an error
   (``torch.cuda.set_sync_debug_mode``); and a small spec run on the card
   and on the CPU, which must agree;
6. a JSON line per kernel (launches, error, times, bound), the card line,
   and the result line ``{"ok": true, "device": {...}}`` last.

It imports nothing of JAX or of the JAX package.  Without a CUDA device, or
without the repository's ``src/`` beside it, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks at 700 W.  HBM: NVIDIA's data sheet.  32-bit integer issue
# rate, which Threefry's adds, xors and funnel-shift rotates run at: 64 INT32
# lanes per SM (NVIDIA H100 Tensor Core GPU Architecture whitepaper) x 132
# SMs x the 1.98 GHz boost clock behind the data sheet's 67 TFLOP/s fp32
# (132 x 128 lanes x 2 x 1.98e9) = 16.7e12 operations/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit operations of one Threefry-2x32-20 block: 2 key adds, 20 rounds of
# (add, funnel-shift rotate, xor), 5 injections of 3 adds.  Kernel A hashes
# one block per site update, kernel B one per rung (+3 per launch).
THREEFRY_OPS = 2 + 20 * 3 + 5 * 3
F32_EPS = 2.0 ** -23


def card_line(torch) -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()
        return out[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit: unavailable"


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms (CUDA events around ``reps`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_a(r: int, length: int, sweeps: int) -> tuple[float, str]:
    """Least time of kernel A's work: lattice in + out vs Threefry ops."""
    t_bytes = 2.0 * r * length * length / HBM_BYTES_PER_S
    t_ops = r * length * length * sweeps * THREEFRY_OPS / INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def bound_b(r: int) -> tuple[float, str]:
    """Least time of kernel B's work: 30 B per rung vs its Threefry ops."""
    t_bytes = 30.0 * r / HBM_BYTES_PER_S
    t_ops = (r + 3) * THREEFRY_OPS / INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def check_kernel_a(torch, np, isk, keys, cases, device):
    """Phase 2: kernel A == plain version on the card; returns (max err, timing)."""
    max_err = 0.0
    for n, (length, r, sweeps, j, b, rule) in enumerate(cases):
        rng = np.random.default_rng(100 + n)
        spins = torch.from_numpy(
            rng.choice(np.array([-1, 1], np.int8), size=(r, length, length))
        ).to(device)
        temps = 1.0 + np.arange(r) * 3.0 / r
        betas = torch.from_numpy((1.0 / temps).astype(np.float32)).to(device)
        rung = torch.from_numpy(rng.permutation(r).astype(np.int32)).to(device)
        words = keys.key(int(rng.integers(1 << 31)), device=device)
        t0 = torch.tensor(int(rng.integers(1 << 20)), dtype=torch.int64, device=device)
        kw = dict(n_sweeps=sweeps, j=j, b=b, rule=rule, replica_offset=3)
        got = isk.ising_sweep_fused_kernel(spins, words, t0, betas, rung, **kw)
        want = isk.ising_sweep_fused_plain(spins, words, t0, betas, rung, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got[0], want[0]) or not torch.equal(got[2], want[2]):
            raise AssertionError(f"kernel A spins/nacc differ from plain: case {n}")
        err = (got[1] - want[1]).abs().max().item()
        if j == 1.0 and b == 0.0:
            # every ΔE is an integer: the sums are exact in any order
            if err != 0.0:
                raise AssertionError(f"kernel A ΔE differs at j=1,b=0: {err}")
        else:
            # only the order inside each colour's f32 sum differs: 4 ulps of
            # the largest magnitude a partial sum can reach
            scale = want[2].double() * abs(2 * (4 * abs(j) + abs(b)))
            tol = 4 * F32_EPS * scale
            if bool(((got[1] - want[1]).abs().double() > tol).any()):
                raise AssertionError(f"kernel A ΔE beyond 4 ulps: case {n}, {err}")
        max_err = max(max_err, err)
        print(f"  kernel A case L={length} R={r} S={sweeps} j={j} b={b} {rule}: "
              f"equal spins/nacc, max |dE err| {err}")
    return max_err


def check_kernel_b(torch, np, isk, keys, prng, device, r=1500):
    """Phase 3: kernel B == plain exchange_step on the card; returns max |dp|."""
    rng = np.random.default_rng(7)
    temps = 1.0 + np.arange(r) * 3.0 / r
    betas = torch.from_numpy((1.0 / temps).astype(np.float32)).to(device)
    words = keys.key(11, device=device)
    max_err = 0.0
    n_prob_diff = 0
    for pairing in ("deo", "seo"):
        for criterion in ("logistic", "metropolis"):
            for phase in range(8):
                rung = torch.from_numpy(rng.permutation(r).astype(np.int32)).to(device)
                # rung-ordered energies ~ an equilibrated ladder, so Δβ·ΔE is
                # O(1) and the probabilities are not all saturated
                by_rung = -180000 + 100 * np.arange(r) + rng.integers(-400, 400, r)
                energy = torch.from_numpy(
                    by_rung[rung.cpu().numpy()].astype(np.float32)).to(device)
                de = torch.from_numpy(
                    (4 * rng.integers(-50, 50, r)).astype(np.float32)).to(device)
                ph0 = torch.tensor(1000 + phase, dtype=torch.int64, device=device)
                kw = dict(pairing=pairing, criterion=criterion, phase_add=phase)
                got = isk.exchange_kernel(rung, energy, de, betas, words, ph0, **kw)
                want = isk.exchange_plain(rung, energy, de, betas, words, ph0, **kw)
                torch.cuda.synchronize()
                u = prng.swap_uniforms(words, ph0 + phase, r)
                lo = torch.minimum(got[3], want[3])
                hi = torch.maximum(got[3], want[3])
                in_gap = (u >= lo) & (u < hi)
                prob_diff = got[3] != want[3]
                acc_diff = got[2] != want[2]
                if bool((prob_diff & ~in_gap).any()) or bool((acc_diff & ~in_gap).any()):
                    raise AssertionError(
                        f"kernel B prob/accept differ outside the ulp gap: "
                        f"{pairing}/{criterion} phase {phase}")
                if not torch.equal(got[4], want[4]) or not torch.equal(got[1], want[1]):
                    raise AssertionError(f"kernel B attempt/energy differ: {pairing}/{criterion}")
                if not bool(acc_diff.any()) and not torch.equal(got[0], want[0]):
                    raise AssertionError(f"kernel B rung differs: {pairing}/{criterion}")
                n_prob_diff += int(prob_diff.sum().item())
                max_err = max(max_err, (got[3] - want[3]).abs().max().item())
    return max_err, n_prob_diff


def check_no_host_sync(torch, session, make_interval_step, update_stats, n: int) -> None:
    """Phase 5: ``n`` intervals of the session's path with every host sync an error.

    Runs the engine's own interval step and stats update (what `Engine.run`
    issues between two chunk boundaries) under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any stream
    or device synchronisation and any blocking host<->device copy.
    """
    eng = session.engine
    step = make_interval_step(eng.system, eng.config.spec, eng.observables)
    state = session.init_state()
    pt, stats = step(state.pt, state.betas)[0], state.stats  # warm-up launch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(n):
            pt, rec = step(pt, state.betas)
            stats = update_stats(stats, rec, pt.rung)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def profile_breakdown(torch, run, n_int: int, card: str) -> str:
    """Where one main-path run's device time goes, from ``torch.profiler``.

    Sums the device time of every kernel and copy (device-side events only,
    not the host ops that launched them); ``idle`` is the share of the
    profiled wall time with no device work (an upper bound on the true idle
    share: the profiler itself slows the host).  Host syncs are counted
    over the whole run, chunk and phase boundaries included.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    rows = prof.key_averages()
    dev_us = {e.key: float(e.self_device_time_total) for e in rows
              if e.device_type == DeviceType.CUDA}
    busy_ms = sum(dev_us.values()) / 1e3
    if busy_ms == 0.0:
        return f"phase 4 profile [{card}]: not measured (the profiler saw no device time)"
    syncs = sum(e.count for e in rows if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize"))

    def part(*names):
        return sum(v for k, v in dev_us.items() if any(n in k for n in names)) / 1e3

    a_ms, b_ms = part("ising_fused_kernel"), part("exchange_kernel")
    other = sorted(((v, k) for k, v in dev_us.items()
                    if v and "ising_fused_kernel" not in k and "exchange_kernel" not in k),
                   reverse=True)
    top = "; ".join(f"{k[:50]} {v / 1e3 / n_int:.3f}" for v, k in other[:4])
    return (f"phase 4 profile [{card}]: {n_int} intervals in {wall_ms:.1f} ms wall "
            f"(profiled), device busy {busy_ms:.1f} ms, idle share "
            f"{1 - busy_ms / wall_ms:.3f}; per interval: kernel A {a_ms / n_int:.3f} ms, "
            f"kernel B {b_ms / n_int:.4f} ms, other device work "
            f"{(busy_ms - a_ms - b_ms) / n_int:.3f} ms (top: {top}), "
            f"host syncs {syncs} in the run ({syncs / n_int:.2f} per interval)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs "
              "a CUDA card", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.api import (
        AdaptSpec, EngineSpec, LadderSpec, PhaseSpec, RunSpec, ScheduleSpec,
        Session, SystemSpec,
    )
    from repro_torch.core import keys
    from repro_torch.core.ising import lattice_energy
    from repro_torch.engine.driver import make_interval_step
    from repro_torch.engine.stats import update_stats
    from repro_torch.kernels import build, prng
    from repro_torch.kernels import ising_sweep as isk

    t_start = time.perf_counter()
    device = torch.device("cuda")
    card = card_line(torch)
    print(f"phase 1 device: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.build_all()
    print(f"phase 1 build: {time.perf_counter() - t0:.2f} s (nvcc, all sources in parallel)")

    # -- phase 2: kernel A against its plain version -------------------------
    # the main path's own shapes (L=300, R=1500; S cut to 2 for the plain
    # version), then smaller lattices over more sweeps and a j, b != 1, 0 case
    cases = [(300, 1500, 2, 1.0, 0.0, "glauber")]
    for rule in ("metropolis", "glauber"):
        cases += [(300, 32, 4, 1.0, 0.0, rule), (64, 64, 10, 1.0, 0.0, rule),
                  (64, 16, 3, 0.7, 0.3, rule)]
    err_a = check_kernel_a(torch, np, isk, keys, cases, device)
    print(f"phase 2 kernel A: {len(cases)} cases equal to plain (spins, nacc; "
          f"ΔE exact at j=1,b=0, <= 4 ulps otherwise), max |ΔE err| {err_a}")

    # -- phase 3: kernel B against its plain version -------------------------
    err_b, n_prob_diff = check_kernel_b(torch, np, isk, keys, prng, device)
    print(f"phase 3 kernel B: 32 exchanges at R=1500 equal to plain (rung, "
          f"accept, attempt), prob max |err| {err_b}, {n_prob_diff} prob "
          "differences, all inside the u ulp gap")

    # same-input timings: kernel vs plain at the main path's shapes
    rng = np.random.default_rng(5)
    r2, l2, s2 = 1500, 300, 2
    spins = torch.from_numpy(rng.choice(np.array([-1, 1], np.int8), size=(r2, l2, l2))).to(device)
    betas = torch.from_numpy((1.0 / (1.0 + np.arange(r2) * 3.0 / r2)).astype(np.float32)).to(device)
    rung = torch.arange(r2, dtype=torch.int32, device=device)
    words = keys.key(3, device=device)
    t0d = torch.zeros((), dtype=torch.int64, device=device)
    kw = dict(n_sweeps=s2, rule="glauber")
    a_ms = cuda_ms(torch, lambda: isk.ising_sweep_fused_kernel(spins, words, t0d, betas, rung, **kw), 20)
    a_plain_ms = cuda_ms(torch, lambda: isk.ising_sweep_fused_plain(spins, words, t0d, betas, rung, **kw), 2)
    a_bound, a_by = bound_a(r2, l2, s2)
    rb = 1500
    rung_b = torch.from_numpy(rng.permutation(rb).astype(np.int32)).to(device)
    energy_b = torch.from_numpy(-rng.integers(0, 180000, rb).astype(np.float32)).to(device)
    de_b = torch.zeros(rb, dtype=torch.float32, device=device)
    betas_b = torch.from_numpy((1.0 / (1.0 + np.arange(rb) * 3.0 / rb)).astype(np.float32)).to(device)
    ph = torch.zeros((), dtype=torch.int64, device=device)
    xw = dict(pairing="deo", criterion="logistic")
    b_ms = cuda_ms(torch, lambda: isk.exchange_kernel(rung_b, energy_b, de_b, betas_b, words, ph, **xw), 200)
    b_plain_ms = cuda_ms(torch, lambda: isk.exchange_plain(rung_b, energy_b, de_b, betas_b, words, ph, **xw), 50)
    b_bound, b_by = bound_b(rb)
    print(f"phase 3 times [{card}]: kernel A {a_ms:.4f} ms vs plain {a_plain_ms:.4f} ms "
          f"(L=300 R=1500 S=2, bound {a_bound:.5f} ms by {a_by}); kernel B "
          f"{b_ms:.4f} ms vs plain {b_plain_ms:.4f} ms (R=1500, bound "
          f"{b_bound:.6f} ms by {b_by}); library_ms: none")

    # -- phase 4: the main path at full width --------------------------------
    length, n_rep, interval = 300, 1500, 100
    base = dict(
        ladder=LadderSpec(kind="paper", n_replicas=n_rep, t_min=1.0, t_max=4.0),
        engine=EngineSpec(swap_interval=interval, chunk_intervals=1),
        adapt=AdaptSpec(target=0.23, min_attempts_per_pair=1, max_rounds=2),
        observables=("absmag", "energy_per_site"),
        seed=0,
    )
    params = {"length": length, "accept_rule": "glauber", "use_fused": True}
    spec_round = RunSpec(
        system=SystemSpec("ising", {**params, "use_fused_round": True}),
        schedule=ScheduleSpec(phases=(
            PhaseSpec(name="burn", n_sweeps=300, adapt=True),
            PhaseSpec(name="measure", n_sweeps=300, reset_stats=True),
        )),
        **base,
    )

    def drive(spec, what):
        session = Session(spec, device="cuda")
        t = time.perf_counter()
        session.state = session.init_state()  # set-up, timed apart from the run
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        isk.reset_launches()
        t = time.perf_counter()
        result = session.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = dict(isk.launches)
        st = result.state.pt
        n_int = spec.schedule.total_sweeps // interval
        if not torch.equal(st.energy, lattice_energy(st.states, 1.0, 0.0)):
            raise AssertionError(f"{what}: incremental energy != lattice energy")
        if st.states.shape != (n_rep, length, length) or not bool(torch.isfinite(st.energy).all()):
            raise AssertionError(f"{what}: bad final state")
        if sorted(st.rung.cpu().tolist()) != list(range(n_rep)):
            raise AssertionError(f"{what}: rung map is not a permutation")
        if int(st.t.item()) != spec.schedule.total_sweeps:
            raise AssertionError(f"{what}: sweep counter {int(st.t.item())}")
        for res in result.phases.values():
            for k, v in res.summary.items():
                if not np.all(np.isfinite(v)):
                    raise AssertionError(f"{what}: non-finite summary {k}")
        return result, counts, wall, n_int, init_s

    result, counts_round, wall, n_int, init_s = drive(spec_round, "round path")
    if counts_round != {"ising_fused": n_int, "exchange": n_int}:
        raise AssertionError(f"round path launches {counts_round} != {n_int} intervals each")
    retunes = len(result.phases["burn"].ladder_history) - 1
    acc = result.phases["measure"].summary["swap_acceptance"]
    # per-kernel device time at the main path's shapes (not counted launches)
    st = result.state.pt
    a_main = cuda_ms(torch, lambda: isk.ising_sweep_fused_kernel(
        st.states, st.key, st.t, result.state.betas, st.rung, n_sweeps=interval,
        rule="glauber"), 2)
    b_main = cuda_ms(torch, lambda: isk.exchange_kernel(
        st.rung, st.energy, de_b, result.state.betas, st.key, st.phase, **xw), 200)
    a_main_bound, _ = bound_a(n_rep, length, interval)
    sweeps = spec_round.schedule.total_sweeps
    print(f"phase 4 main path [{card}]: Session L=300 R=1500 round path, "
          f"init {init_s:.3f} s, then {sweeps} sweeps in {wall:.3f} s = "
          f"{sweeps / wall:.2f} sweeps/s "
          f"({sweeps * n_rep / wall:.1f} replica-sweeps/s), "
          f"{1e3 * wall / n_int:.2f} ms/interval, launches {counts_round} == "
          f"{n_int} intervals, {retunes} retunes, mean swap acceptance "
          f"{float(np.mean(acc)):.4f}; kernel A {a_main:.3f} ms/launch (S=100, "
          f"bound {a_main_bound:.3f} ms), kernel B {b_main:.4f} ms/launch; "
          "energy == lattice_energy exactly; library_ms: none")
    # the same run again in this warm process: the first run also pays
    # one-time costs (first allocations, first use of each torch kernel)
    session = Session(spec_round, device="cuda")
    session.state = session.init_state()
    torch.cuda.synchronize()
    t = time.perf_counter()
    session.run()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t
    print(f"phase 4 warm run [{card}]: the same spec again: {sweeps / warm:.2f} "
          f"sweeps/s ({sweeps * n_rep / warm:.1f} replica-sweeps/s), "
          f"{1e3 * warm / n_int:.2f} ms/interval")
    session = Session(spec_round, device="cuda")
    session.state = session.init_state()
    torch.cuda.synchronize()
    print(profile_breakdown(torch, session.run, n_int, card))

    # -- phase 5: interval-fused path, and card == CPU on a small spec --------
    spec_fused = RunSpec(
        system=SystemSpec("ising", params),
        schedule=ScheduleSpec(phases=(
            PhaseSpec(name="burn", n_sweeps=100, adapt=True),
            PhaseSpec(name="measure", n_sweeps=100, reset_stats=True),
        )),
        **base,
    )
    _, counts_fused, wall_f, n_int_f, _ = drive(spec_fused, "fused path")
    if counts_fused != {"ising_fused": n_int_f, "exchange": 0}:
        raise AssertionError(f"fused path launches {counts_fused}")
    for spec, what in ((spec_round, "round"), (spec_fused, "fused")):
        check_no_host_sync(torch, Session(spec, device="cuda"),
                           make_interval_step, update_stats, 3)
    print(f"phase 5 no host sync [{card}]: 3 intervals of the round and of the "
          "fused path at L=300 R=1500 under set_sync_debug_mode('error')")
    small = RunSpec(
        system=SystemSpec("ising", {"length": 8, "accept_rule": "glauber",
                                    "use_fused": True, "use_fused_round": True}),
        ladder=LadderSpec(kind="paper", n_replicas=8),
        engine=EngineSpec(swap_interval=10, chunk_intervals=10),
        adapt=AdaptSpec(target=0.25, min_attempts_per_pair=5, max_rounds=2),
        schedule=ScheduleSpec(phases=(
            PhaseSpec(name="burn", n_sweeps=400, adapt=True),
            PhaseSpec(name="measure", n_sweeps=400, reset_stats=True),
        )),
        observables=("absmag", "energy_per_site"),
    )
    on_card = Session(small, device="cuda").run().manifest()
    on_cpu = Session(small, device="cpu").run().manifest()
    for name in on_cpu["phases"]:
        for key in ("swap_attempts", "swap_acceptance", "round_trips", "mean_energy"):
            if on_card["phases"][name]["summary"][key] != on_cpu["phases"][name]["summary"][key]:
                raise AssertionError(f"small spec: card != CPU in {name}.{key}")
    if on_card["final"] != on_cpu["final"]:
        raise AssertionError("small spec: card != CPU final state")
    print(f"phase 5 fused path [{card}]: {spec_fused.schedule.total_sweeps} sweeps "
          f"in {wall_f:.3f} s, launches {counts_fused} == {n_int_f} intervals; "
          "small spec (L=8 R=8, round path) equal on card and CPU")

    # -- phase 6: kernel summary ---------------------------------------------
    kernels = [
        {"name": "ising_fused", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ising_fused.cu",
         "replaces": "src/repro/kernels/ising_sweep.py:377",
         "launches": counts_round["ising_fused"], "max_abs_err": err_a,
         "ms": a_ms, "plain_ms": a_plain_ms, "bound_ms": a_bound,
         "bound_by": a_by, "library_ms": None,
         "shape": "L=300 R=1500 S=2", "main_ms": a_main,
         "main_bound_ms": a_main_bound, "main_shape": "L=300 R=1500 S=100",
         "fused_path_launches": counts_fused["ising_fused"]},
        {"name": "exchange", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/exchange.cu",
         "replaces": "src/repro/kernels/ising_sweep.py:517",
         "launches": counts_round["exchange"], "max_abs_err": err_b,
         "ms": b_ms, "plain_ms": b_plain_ms, "bound_ms": b_bound,
         "bound_by": b_by, "library_ms": None,
         "shape": "R=1500", "main_ms": b_main},
    ]
    print(f"phase 6 done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
