#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one line each or more (any failure raises and exits non-zero):

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
6. kernels #1 and #4 (``csrc/sweep.cu``), #5 (``csrc/potts_fused.cu``) and
   the per-sweep ``jax.random`` draw (``csrc/jax_uniform.cu``) against their
   plain versions on the card, at L=300 R=1500 and smaller cases, and each
   one timed beside its plain version at the shapes its path gives it;
7. the per-sweep (default) Ising path at full width: L=300 R=1500, S=100,
   glauber, paper ladder, 3 intervals (200 burn with adaptation + 100
   measure); launches must be one ``jax_uniform`` and one kernel #1 per
   sweep, the incremental energy the lattice energy exactly; then once more
   under ``torch.profiler``;
8. the Potts per-sweep and round paths at full width: 300x300, q=3,
   R=1500, S=100, glauber, geometric ladder 0.7-2.9, 3 intervals each, with
   the same checks (round path: one kernel #5 and one kernel B per
   interval), the round path once more under the profiler;
9. 3 intervals of the Ising per-sweep path and of the Potts per-sweep,
   fused and round paths at full width with every host sync an error; and
   ``examples/specs/ising_small.json`` and a small Potts spec on each of its
   three paths, run on the card and on the CPU, which must agree;
10. kernel #2p (``csrc/ising_packed.cu``, ``pack_bits``) against its plain
    version and against kernel A at L=300 R=1500 S=2 and at small odd R, at
    its default group width and at 8 and 3 replicas a block; timed at S=2
    and S=100 beside kernel A and its bound, at 8 a block too, and at
    R=2112, where both kernels put 16 replicas on every SM;
11. the packed round and fused paths through ``Session`` at full width (the
    phase 4 and 5 specs with ``pack_bits``): manifests equal to the unpacked
    runs', sweeps/s, ms/interval, launch counts, and the round path once
    more under ``torch.profiler``;
12. ``n_chains=2`` at full width on the packed round path: each chain equal
    to its solo run from ``fold_in(key, c)``, no host sync in 3 intervals,
    and a small two-chain spec equal on the card and the CPU;
13. the Ising conformance entry (4x4, 5 rungs, 2 chains) on the round path
    with ``pack_bits`` on the card: |z| <= 4 and Geweke <= 4; the same on
    the interval-fused path; and a shortened entry whose report equals the
    CPU's;
14. a JSON line per kernel (launches, error, times, bound), the card line,
    and the result line ``{"ok": true, "device": {...}}`` last.

It imports nothing of JAX or of the JAX package.  Without a CUDA device, or
without the repository's ``src/`` beside it, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks at 700 W.  HBM: NVIDIA's data sheet.  32-bit integer
# instructions (Threefry's adds, xors and funnel-shift rotates): each SM
# issues at most one warp instruction per scheduler per clock, 4 x 32 = 128
# lanes, and integer adds run on the FMA pipe too (as IMAD), so the issue
# rate is the ceiling: 132 SMs x 128 lanes x the 1.98 GHz boost clock behind
# the data sheet's 67 TFLOP/s fp32 (which counts an FMA as 2) = 33.5e12/s.
# (The 64-lane INT32 pipe alone, 16.7e12/s, is no bound: jax_uniform beats it.)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9
# 32-bit instructions of one Threefry-2x32-20 block once its key schedule is
# set: 2 counter adds, 20 rounds of (add, funnel-shift rotate, xor), 5 key
# injections of 2 adds (the injection count folds into the key word).
# Kernel A hashes one block per site update, kernel #5 two, kernel B one per
# rung (+3 per launch), jax_uniform one per uniform.
THREEFRY_OPS = 2 + 20 * 3 + 5 * 2
F32_EPS = 2.0 ** -23
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet, outside the tensor cores


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


def bound_sweep(cells: int, bytes_per_cell: int) -> tuple[float, str]:
    """Least time of kernel #1 / #4: lattice in + out and the uniforms read
    once, against one f32 compare per site."""
    t_bytes = bytes_per_cell * cells / HBM_BYTES_PER_S
    t_ops = cells / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def bound_threefry(blocks: float, n_bytes: float) -> tuple[float, str]:
    """Least time of work that hashes ``blocks`` Threefry blocks and moves
    ``n_bytes`` (kernels A, B, #5 and jax_uniform): A and #5 read and write
    the lattice once (2 B per cell), B ~30 B per rung, jax_uniform writes
    its f32 output."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = blocks * THREEFRY_OPS / INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def expect_launches(counts: dict, what: str, **want) -> None:
    """Every kernel launched exactly as ``want`` says, every other never."""
    full = {k: want.get(k, 0) for k in counts}
    if counts != full:
        raise AssertionError(f"{what}: launches {counts} != {full}")


def assert_de(got, want, nacc, exact: bool, per_site: float, what: str) -> float:
    """ΔE exact when every term is an integer, else within 4 ulps of the
    largest magnitude a partial sum can reach (nacc x the largest |ΔE|)."""
    err = (got - want).abs()
    if exact:
        if bool((err != 0).any()):
            raise AssertionError(f"{what}: ΔE differs at j=1: {err.max().item()}")
    elif bool((err.double() > 4 * F32_EPS * nacc.double() * per_site).any()):
        raise AssertionError(f"{what}: ΔE beyond 4 ulps: {err.max().item()}")
    return err.max().item()


def card_equals_cpu(Session, spec, what: str) -> None:
    """The spec's run on the card and on the CPU give equal manifests."""
    on_card = Session(spec, device="cuda").run().manifest()
    on_cpu = Session(spec, device="cpu").run().manifest()
    for name in on_cpu["phases"]:
        for key in ("swap_attempts", "swap_acceptance", "round_trips", "mean_energy"):
            if on_card["phases"][name]["summary"][key] != on_cpu["phases"][name]["summary"][key]:
                raise AssertionError(f"{what}: card != CPU in {name}.{key}")
    if on_card["final"] != on_cpu["final"]:
        raise AssertionError(f"{what}: card != CPU final state")


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


def check_packed(torch, np, isk, keys, cases, device):
    """Phase 10: kernel #2p == kernel A (spins, ΔE, nacc bit for bit) at its
    default group width and at 8 and 3 replicas a block, and == its plain
    version (spins, nacc; ΔE as kernel A's); returns max |ΔE err| against
    the plain version."""
    max_err = 0.0
    for n, (length, r, sweeps, j, b, rule) in enumerate(cases):
        rng = np.random.default_rng(200 + n)
        spins = torch.from_numpy(
            rng.choice(np.array([-1, 1], np.int8), size=(r, length, length))).to(device)
        temps = 1.0 + np.arange(r) * 3.0 / r
        betas = torch.from_numpy((1.0 / temps).astype(np.float32)).to(device)
        rung = torch.from_numpy(rng.permutation(r).astype(np.int32)).to(device)
        words = keys.key(int(rng.integers(1 << 31)), device=device)
        t0 = torch.tensor(int(rng.integers(1 << 20)), dtype=torch.int64, device=device)
        kw = dict(n_sweeps=sweeps, j=j, b=b, rule=rule, replica_offset=5)
        got = isk.ising_sweep_packed_kernel(spins, words, t0, betas, rung, **kw)
        kernel_a = isk.ising_sweep_fused_kernel(spins, words, t0, betas, rung, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(g, a) for g, a in zip(got, kernel_a)):
            raise AssertionError(f"kernel #2p differs from kernel A: case {n}")
        for group in (8, 3):  # full bytes with a partial last one, and odd groups
            other = isk.ising_sweep_packed_kernel(spins, words, t0, betas, rung, **kw,
                                                  group=group)
            torch.cuda.synchronize()
            if not all(torch.equal(g, a) for g, a in zip(other, kernel_a)):
                raise AssertionError(f"kernel #2p group {group} differs from kernel A: case {n}")
            del other
        del kernel_a
        want = isk.ising_sweep_packed_plain(spins, words, t0, betas, rung, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got[0], want[0]) or not torch.equal(got[2], want[2]):
            raise AssertionError(f"kernel #2p spins/nacc differ from plain: case {n}")
        what = f"kernel #2p L={length} R={r} S={sweeps} j={j} b={b} {rule}"
        err = assert_de(got[1], want[1], want[2], j == 1.0 and b == 0.0,
                        2 * (4 * abs(j) + abs(b)), what)
        max_err = max(max_err, err)
        print(f"  {what}: equal to kernel A and to plain, max |dE err| vs plain {err}")
        del got, want, spins
        torch.cuda.empty_cache()
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


def profile_breakdown(torch, build, run, n_int: int, card: str, label: str,
                      kernels: dict) -> str:
    """Where one path's device time goes, from ``torch.profiler``.

    Sums the device time of every kernel and copy (device-side events only,
    not the host ops that launched them); ``kernels`` maps a label to a
    substring of a kernel's symbol and its key in ``build.launches``.  The
    breakdown counts only if the profiler saw every launch that the counters
    saw in the same run; else it says "not measured".  ``idle`` is the share
    of the profiled wall time with no device work (an upper bound on the true
    idle share: the profiler itself slows the host).  Host syncs are counted
    over the whole run, chunk and phase boundaries included.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # one small op first, so that the tracer is running when the path starts
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        build.reset_launches()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
        counts = dict(build.launches)
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    seen = {lab: sum(e.count for e in rows if sub in e.key)
            for lab, (sub, _) in kernels.items()}
    lost = [f"{lab} {seen[lab]} of {counts[key]}" for lab, (_, key) in kernels.items()
            if seen[lab] != counts[key]]
    if lost:
        return (f"{label} profile [{card}]: not measured (the profiler saw "
                f"{', '.join(lost)} launches)")
    dev_us = {e.key: float(e.self_device_time_total) for e in rows}
    busy_ms = sum(dev_us.values()) / 1e3
    syncs = sum(e.count for e in prof.key_averages() if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize"))
    named = {lab: sum(v for k, v in dev_us.items() if sub in k) / 1e3
             for lab, (sub, _) in kernels.items()}
    subs = [sub for sub, _ in kernels.values()]
    other = sorted(((v, k) for k, v in dev_us.items()
                    if v and not any(sub in k for sub in subs)), reverse=True)
    top = "; ".join(f"{k[:50]} {v / 1e3 / n_int:.3f}" for v, k in other[:4])
    parts = ", ".join(f"{lab} {ms / n_int:.4f} ms" for lab, ms in named.items())
    return (f"{label} profile [{card}]: {n_int} intervals in {wall_ms:.1f} ms wall "
            f"(profiled), device busy {busy_ms:.1f} ms, idle share "
            f"{1 - busy_ms / wall_ms:.3f}; per interval: {parts}, other device work "
            f"{(busy_ms - sum(named.values())) / n_int:.3f} ms (top: {top}), "
            f"host syncs {syncs} in the run ({syncs / n_int:.2f} per interval); "
            f"launches seen {seen}")


def check_sweep_kernels(torch, np, isk, pk, ju, ref, prng, keys, device):
    """Phase 6: kernels #1, #4, #5 and jax_uniform == plain on the card.

    Returns the largest |ΔE| error of each kernel (0.0 for jax_uniform,
    whose values must be bit-equal)."""
    errs = {"ising_sweep": 0.0, "potts_sweep": 0.0, "potts_fused": 0.0, "jax_uniform": 0.0}
    rng = np.random.default_rng(60)
    for length, r, j, b, rule in ((300, 1500, 1.0, 0.0, "glauber"),
                                  (300, 32, 1.0, 0.0, "metropolis"),
                                  (64, 64, 0.7, 0.3, "glauber"),
                                  (8, 6, 0.7, 0.3, "metropolis")):
        spins = torch.from_numpy(
            rng.choice(np.array([-1, 1], np.int8), size=(r, length, length))).to(device)
        u = torch.rand((r, 2, length, length), device=device)
        betas = torch.from_numpy((1.0 / np.linspace(1.0, 4.0, r)).astype(np.float32)).to(device)
        got = isk.ising_sweep_kernel(spins, u, betas, j=j, b=b, rule=rule)
        want = ref.ising_sweep(spins, u, betas, j=j, b=b, rule=rule)
        torch.cuda.synchronize()
        what = f"kernel #1 L={length} R={r} j={j} b={b} {rule}"
        if not torch.equal(got[0], want[0]) or not torch.equal(got[2], want[2]):
            raise AssertionError(f"{what}: spins/nacc differ from plain")
        errs["ising_sweep"] = max(errs["ising_sweep"], assert_de(
            got[1], want[1], want[2], j == 1.0 and b == 0.0, 2 * (4 * abs(j) + abs(b)), what))
    for h, w, r, q, j, rule, sweeps in ((300, 300, 1500, 3, 1.0, "glauber", 1),
                                        (300, 300, 16, 5, 0.7, "metropolis", 4),
                                        (64, 48, 32, 3, 1.0, "metropolis", 6),
                                        (8, 6, 6, 5, 0.7, "glauber", 10)):
        states = torch.from_numpy(rng.integers(0, q, (r, h, w)).astype(np.int8)).to(device)
        betas = torch.from_numpy((1.0 / np.geomspace(0.7, 2.9, r)).astype(np.float32)).to(device)
        u = torch.rand((r, 2, 2, h, w), device=device)
        got = pk.potts_sweep_kernel(states, u, betas, q=q, j=j, rule=rule)
        want = ref.potts_sweep(states, u, betas, q=q, j=j, rule=rule)
        torch.cuda.synchronize()
        what = f"kernel #4 {h}x{w} R={r} q={q} j={j} {rule}"
        if not torch.equal(got[0], want[0]) or not torch.equal(got[2], want[2]):
            raise AssertionError(f"{what}: colours/nacc differ from plain")
        errs["potts_sweep"] = max(errs["potts_sweep"], assert_de(
            got[1], want[1], want[2], j == 1.0, 4 * abs(j), what))
        del u, got, want
        rung = torch.from_numpy(rng.permutation(r).astype(np.int32)).to(device)
        args = (states, prng.key_words(keys.key(int(rng.integers(1 << 31)), device=device)),
                torch.tensor(int(rng.integers(1 << 20)), device=device), betas, rung)
        kw = dict(n_sweeps=sweeps, q=q, j=j, rule=rule, replica_offset=3, t_add=2)
        got = pk.potts_sweep_fused_kernel(*args, **kw)
        want = pk.potts_sweep_fused_plain(*args, **kw)
        torch.cuda.synchronize()
        what = f"kernel #5 {h}x{w} R={r} S={sweeps} q={q} j={j} {rule}"
        if not torch.equal(got[0], want[0]) or not torch.equal(got[2], want[2]):
            raise AssertionError(f"{what}: colours/nacc differ from plain")
        errs["potts_fused"] = max(errs["potts_fused"], assert_de(
            got[1], want[1], want[2], j == 1.0, 4 * abs(j), what))
        del got, want
        torch.cuda.empty_cache()
    for shape, r in (((2, 300, 300), 1500), ((2, 2, 300, 300), 1500),
                     ((2, 8, 8), 8), ((2, 2, 6, 4), 5)):
        key = keys.key(int(rng.integers(1 << 31)), device=device)
        t = torch.tensor(int(rng.integers(1 << 31)), device=device)
        got = ju.jax_uniform_kernel(key, t, r, shape)
        # keys.uniform holds several int64 copies: a subset of the replicas at L=300
        ids = torch.tensor(sorted({0, 1, r // 2, r - 1}), device=device)
        if not torch.equal(got[ids], ju.jax_uniform_plain(key, t, ids, shape)):
            raise AssertionError(f"jax_uniform {shape} x {r} differs from keys.uniform")
        del got
    torch.cuda.empty_cache()
    return errs


def time_sweep_kernels(torch, np, isk, pk, ju, ref, prng, keys, device):
    """Phase 6 times: each kernel and its plain version on the same inputs at
    the shapes its main path gives it (L=300, R=1500)."""
    rng = np.random.default_rng(61)
    r, length = 1500, 300
    out = {}
    spins = torch.from_numpy(rng.choice(np.array([-1, 1], np.int8), size=(r, length, length))).to(device)
    betas = torch.from_numpy((1.0 / (1.0 + np.arange(r) * 3.0 / r)).astype(np.float32)).to(device)
    key, t = keys.key(3, device=device), torch.zeros((), dtype=torch.int64, device=device)
    ising_shape, potts_shape = (2, length, length), (2, 2, length, length)
    ms = cuda_ms(torch, lambda: ju.jax_uniform_kernel(key, t, r, ising_shape), 20)
    ms_potts = cuda_ms(torch, lambda: ju.jax_uniform_kernel(key, t, r, potts_shape), 10)
    ids = torch.arange(r, device=device)
    plain = cuda_ms(torch, lambda: ju.jax_uniform_plain(key, t, ids, ising_shape), 1)
    torch.cuda.empty_cache()
    n = r * 2 * length * length
    out["jax_uniform"] = dict(ms=ms, plain_ms=plain, potts_ms=ms_potts,
                              bound=bound_threefry(n, 4.0 * n),
                              potts_bound=bound_threefry(2 * n, 8.0 * n))
    u = ju.jax_uniform_kernel(key, t, r, ising_shape)
    kw = dict(j=1.0, b=0.0, rule="glauber")
    out["ising_sweep"] = dict(
        ms=cuda_ms(torch, lambda: isk.ising_sweep_kernel(spins, u, betas, **kw), 20),
        plain_ms=cuda_ms(torch, lambda: ref.ising_sweep(spins, u, betas, **kw), 3),
        bound=bound_sweep(r * length * length, 10))
    del u, spins
    torch.cuda.empty_cache()
    states = torch.from_numpy(rng.integers(0, 3, (r, length, length)).astype(np.int8)).to(device)
    betas = torch.from_numpy((1.0 / np.geomspace(0.7, 2.9, r)).astype(np.float32)).to(device)
    u = ju.jax_uniform_kernel(key, t, r, potts_shape)
    kw = dict(q=3, j=1.0, rule="glauber")
    out["potts_sweep"] = dict(
        ms=cuda_ms(torch, lambda: pk.potts_sweep_kernel(states, u, betas, **kw), 20),
        plain_ms=cuda_ms(torch, lambda: ref.potts_sweep(states, u, betas, **kw), 3),
        bound=bound_sweep(r * length * length, 18))
    del u
    torch.cuda.empty_cache()
    words = prng.key_words(key)
    rung = torch.arange(r, dtype=torch.int32, device=device)
    fkw = dict(q=3, rule="glauber")
    sites = r * length * length
    out["potts_fused"] = dict(
        ms=cuda_ms(torch, lambda: pk.potts_sweep_fused_kernel(
            states, words, t, betas, rung, n_sweeps=2, **fkw), 10),
        plain_ms=cuda_ms(torch, lambda: pk.potts_sweep_fused_plain(
            states, words, t, betas, rung, n_sweeps=2, **fkw), 1),
        bound=bound_threefry(2 * 2 * sites, 2.0 * sites),
        main_ms=cuda_ms(torch, lambda: pk.potts_sweep_fused_kernel(
            states, words, t, betas, rung, n_sweeps=100, **fkw), 2),
        main_bound=bound_threefry(2 * 100 * sites, 2.0 * sites))
    torch.cuda.empty_cache()
    return out


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
    from repro_torch.core.systems import REGISTRY
    from repro_torch.engine.driver import make_interval_step
    from repro_torch.engine.stats import chain_slice, update_stats
    from repro_torch.kernels import build, prng, ref
    from repro_torch.validate import assert_conforms, run_conformance
    from repro_torch.kernels import ising_sweep as isk
    from repro_torch.kernels import jax_uniform as ju
    from repro_torch.kernels import potts_sweep as pk

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
    a_bound, a_by = bound_threefry(r2 * l2 * l2 * s2, 2.0 * r2 * l2 * l2)
    rb = 1500
    rung_b = torch.from_numpy(rng.permutation(rb).astype(np.int32)).to(device)
    energy_b = torch.from_numpy(-rng.integers(0, 180000, rb).astype(np.float32)).to(device)
    de_b = torch.zeros(rb, dtype=torch.float32, device=device)
    betas_b = torch.from_numpy((1.0 / (1.0 + np.arange(rb) * 3.0 / rb)).astype(np.float32)).to(device)
    ph = torch.zeros((), dtype=torch.int64, device=device)
    xw = dict(pairing="deo", criterion="logistic")
    b_ms = cuda_ms(torch, lambda: isk.exchange_kernel(rung_b, energy_b, de_b, betas_b, words, ph, **xw), 200)
    b_plain_ms = cuda_ms(torch, lambda: isk.exchange_plain(rung_b, energy_b, de_b, betas_b, words, ph, **xw), 50)
    b_bound, b_by = bound_threefry(rb + 3, 30.0 * rb)
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

    def drive(spec, what, shape=(length, length)):
        """Run ``spec`` from a fresh state with every launch count at 0 just
        before the run; check the final state; return the counts after it."""
        session = Session(spec, device="cuda")
        t = time.perf_counter()
        session.state = session.init_state()  # set-up, timed apart from the run
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        build.reset_launches()
        t = time.perf_counter()
        result = session.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = dict(build.launches)
        st = result.state.pt
        n_int = spec.schedule.total_sweeps // interval
        if not torch.equal(st.energy, session.engine.system.batched_energy(st.states)):
            raise AssertionError(f"{what}: incremental energy != lattice energy")
        if st.states.shape != (n_rep, *shape) or not bool(torch.isfinite(st.energy).all()):
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
    expect_launches(counts_round, "round path", ising_fused=n_int, exchange=n_int)
    manifest_round = result.manifest()
    retunes = len(result.phases["burn"].ladder_history) - 1
    acc = result.phases["measure"].summary["swap_acceptance"]
    # per-kernel device time at the main path's shapes (not counted launches)
    st = result.state.pt
    a_main = cuda_ms(torch, lambda: isk.ising_sweep_fused_kernel(
        st.states, st.key, st.t, result.state.betas, st.rung, n_sweeps=interval,
        rule="glauber"), 2)
    b_main = cuda_ms(torch, lambda: isk.exchange_kernel(
        st.rung, st.energy, de_b, result.state.betas, st.key, st.phase, **xw), 200)
    a_main_bound, _ = bound_threefry(n_rep * length * length * interval,
                                     2.0 * n_rep * length * length)
    sweeps = spec_round.schedule.total_sweeps
    print(f"phase 4 main path [{card}]: Session L=300 R=1500 round path, "
          f"init {init_s:.3f} s, then {sweeps} sweeps in {wall:.3f} s = "
          f"{sweeps / wall:.2f} sweeps/s "
          f"({sweeps * n_rep / wall:.1f} replica-sweeps/s), "
          f"{1e3 * wall / n_int:.2f} ms/interval, launches A {counts_round['ising_fused']}, "
          f"B {counts_round['exchange']} == {n_int} intervals, {retunes} retunes, mean swap acceptance "
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
    print(profile_breakdown(torch, build, session.run, n_int, card, "phase 4",
                            {"kernel A": ("ising_fused_kernel", "ising_fused"),
                             "kernel B": ("exchange_kernel", "exchange")}))

    # -- phase 5: interval-fused path, and card == CPU on a small spec --------
    spec_fused = RunSpec(
        system=SystemSpec("ising", params),
        schedule=ScheduleSpec(phases=(
            PhaseSpec(name="burn", n_sweeps=100, adapt=True),
            PhaseSpec(name="measure", n_sweeps=100, reset_stats=True),
        )),
        **base,
    )
    result_f, counts_fused, wall_f, n_int_f, _ = drive(spec_fused, "fused path")
    expect_launches(counts_fused, "fused path", ising_fused=n_int_f)
    manifest_fused = result_f.manifest()
    del result_f
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
    card_equals_cpu(Session, small, "small spec")
    print(f"phase 5 fused path [{card}]: {spec_fused.schedule.total_sweeps} sweeps "
          f"in {wall_f:.3f} s, launches A {counts_fused['ising_fused']} == "
          f"{n_int_f} intervals; small spec (L=8 R=8, round path) equal on card and CPU")

    # -- phase 6: kernels #1, #4, #5 and jax_uniform against plain -------------
    errs = check_sweep_kernels(torch, np, isk, pk, ju, ref, prng, keys, device)
    print(f"phase 6 kernels #1, #4, #5, jax_uniform: equal to plain at L=300 R=1500 "
          f"and 3 smaller cases each (spins/colours, nacc; ΔE exact at j=1, <= 4 ulps "
          f"otherwise; uniforms bit-equal), max |ΔE err| {errs}")
    times = time_sweep_kernels(torch, np, isk, pk, ju, ref, prng, keys, device)
    for name, tm in times.items():
        print(f"phase 6 times [{card}]: {name} {tm['ms']:.4f} ms vs plain "
              f"{tm['plain_ms']:.4f} ms, bound {tm['bound'][0]:.5f} ms by {tm['bound'][1]}"
              + (f"; at S=100 {tm['main_ms']:.3f} ms, bound {tm['main_bound'][0]:.3f} ms"
                 if "main_ms" in tm else "")
              + (f"; Potts shape {tm['potts_ms']:.4f} ms, bound {tm['potts_bound'][0]:.4f} ms"
                 if "potts_ms" in tm else "")
              + "; library_ms: none")

    # -- phase 7: the per-sweep Ising path at full width -------------------------
    three = ScheduleSpec(phases=(
        PhaseSpec(name="burn", n_sweeps=200, adapt=True),
        PhaseSpec(name="measure", n_sweeps=100, reset_stats=True),
    ))
    spec_sweep = RunSpec(system=SystemSpec("ising", {"length": length, "accept_rule": "glauber"}),
                         schedule=three, **base)
    _, counts_sweep, wall_s, n_int_s, init_s = drive(spec_sweep, "per-sweep path")
    n_sw = spec_sweep.schedule.total_sweeps
    expect_launches(counts_sweep, "per-sweep path", jax_uniform=n_sw, ising_sweep=n_sw)
    print(f"phase 7 per-sweep Ising path [{card}]: Session L=300 R=1500 S=100, init "
          f"{init_s:.3f} s, then {n_sw} sweeps in {wall_s:.3f} s = {n_sw / wall_s:.2f} "
          f"sweeps/s ({n_sw * n_rep / wall_s:.1f} replica-sweeps/s), "
          f"{1e3 * wall_s / n_int_s:.2f} ms/interval, launches jax_uniform "
          f"{counts_sweep['jax_uniform']} and #1 {counts_sweep['ising_sweep']} == {n_sw} "
          "sweeps; energy == lattice energy exactly")
    session = Session(spec_sweep, device="cuda")
    session.state = session.init_state()
    torch.cuda.synchronize()
    print(profile_breakdown(torch, build, session.run, n_int_s, card, "phase 7",
                            {"jax_uniform": ("jax_uniform_kernel", "jax_uniform"),
                             "kernel #1": ("ising_sweep_kernel", "ising_sweep")}))

    # -- phase 8: the Potts per-sweep and round paths at full width ---------------
    potts = dict(shape=(length, length), q=3, accept_rule="glauber")
    pbase = dict(base, ladder=LadderSpec(kind="geometric", n_replicas=n_rep, t_min=0.7, t_max=2.9),
                 observables=("pmag",))
    spec_psweep = RunSpec(system=SystemSpec("potts", potts), schedule=three, **pbase)
    spec_pfused = RunSpec(system=SystemSpec("potts", {**potts, "use_fused": True}),
                          schedule=three, **pbase)
    spec_pround = RunSpec(system=SystemSpec("potts", {**potts, "use_fused": True,
                                                      "use_fused_round": True}),
                          schedule=three, **pbase)
    _, counts_psweep, wall_ps, n_int_ps, _ = drive(spec_psweep, "Potts per-sweep path")
    expect_launches(counts_psweep, "Potts per-sweep path", jax_uniform=n_sw, potts_sweep=n_sw)
    _, counts_pround, wall_pr, n_int_pr, _ = drive(spec_pround, "Potts round path")
    expect_launches(counts_pround, "Potts round path", potts_fused=n_int_pr, exchange=n_int_pr)
    for what, wall_x, counts_x in (("per-sweep", wall_ps, counts_psweep),
                                   ("round", wall_pr, counts_pround)):
        print(f"phase 8 Potts {what} path [{card}]: Session 300x300 q=3 R=1500 S=100, "
              f"{n_sw} sweeps in {wall_x:.3f} s = {n_sw / wall_x:.2f} sweeps/s, "
              f"{1e3 * wall_x / n_int_ps:.2f} ms/interval, launches "
              f"{ {k: v for k, v in counts_x.items() if v} }; energy == potts energy exactly")
    session = Session(spec_pround, device="cuda")
    session.state = session.init_state()
    torch.cuda.synchronize()
    print(profile_breakdown(torch, build, session.run, n_int_pr, card, "phase 8 Potts round",
                            {"kernel #5": ("potts_fused_kernel", "potts_fused"),
                             "kernel B": ("exchange_kernel", "exchange")}))

    # -- phase 9: no host sync on the new paths; card == CPU ----------------------
    for spec in (spec_sweep, spec_psweep, spec_pfused, spec_pround):
        check_no_host_sync(torch, Session(spec, device="cuda"),
                           make_interval_step, update_stats, 3)
    print(f"phase 9 no host sync [{card}]: 3 intervals of the Ising per-sweep path and "
          "of the Potts per-sweep, fused and round paths at L=300 R=1500 under "
          "set_sync_debug_mode('error')")
    card_equals_cpu(Session, RunSpec.from_json((ROOT / "examples" / "specs"
                                                / "ising_small.json").read_text()),
                    "ising_small.json")
    for path in ("sweep", "fused", "round"):
        small_potts = RunSpec(
            system=SystemSpec("potts", {"shape": (6, 4), "q": 3, "accept_rule": "glauber",
                                        "use_fused": path != "sweep",
                                        "use_fused_round": path == "round"}),
            ladder=LadderSpec(kind="geometric", n_replicas=6, t_min=0.7, t_max=2.9),
            engine=EngineSpec(swap_interval=5, chunk_intervals=4),
            adapt=AdaptSpec(target=0.3, min_attempts_per_pair=3, max_rounds=2),
            schedule=ScheduleSpec(phases=(
                PhaseSpec(name="burn", n_sweeps=100, adapt=True),
                PhaseSpec(name="measure", n_sweeps=100, reset_stats=True),
            )),
            observables=("pmag",), seed=3,
        )
        card_equals_cpu(Session, small_potts, f"small Potts spec ({path})")
    print(f"phase 9 card == CPU [{card}]: examples/specs/ising_small.json (per-sweep path) "
          "and a 6x4 q=3 R=6 Potts spec on its per-sweep, fused and round paths")

    # -- phase 10: kernel #2p against its plain version and kernel A -----------
    packed_cases = [(300, 1500, 2, 1.0, 0.0, "glauber"), (8, 5, 3, 1.0, 0.0, "glauber"),
                    (30, 13, 4, 0.7, 0.3, "metropolis"), (64, 33, 6, 1.0, 0.3, "glauber")]
    err_p = check_packed(torch, np, isk, keys, packed_cases, device)
    blocks, threads, group = isk.packed_launch_shape(n_rep)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(9)
    spins = torch.from_numpy(rng.choice(np.array([-1, 1], np.int8), size=(r2, l2, l2))).to(device)
    main_kw = dict(n_sweeps=interval, rule="glauber")

    def packed(sweep_kw, group=None):
        return lambda: isk.ising_sweep_packed_kernel(spins, words, t0d, betas, rung,
                                                     **sweep_kw, group=group)

    def unpacked(sweep_kw):
        return lambda: isk.ising_sweep_fused_kernel(spins, words, t0d, betas, rung, **sweep_kw)

    # in turns within this process: A, #2p, #2p at 8 a block, and back
    a_ms2 = cuda_ms(torch, unpacked(kw), 20)
    p_ms = cuda_ms(torch, packed(kw), 20)
    p8_ms = cuda_ms(torch, packed(kw, 8), 20)
    a_main2 = cuda_ms(torch, unpacked(main_kw), 3)
    p_main = cuda_ms(torch, packed(main_kw), 3)
    p8_main = cuda_ms(torch, packed(main_kw, 8), 3)
    a_main3 = cuda_ms(torch, unpacked(main_kw), 3)
    p_plain_ms = cuda_ms(torch, lambda: isk.ising_sweep_packed_plain(
        spins, words, t0d, betas, rung, **kw), 2)
    # 2112 = 2 x 132 x 8 replicas: 16 per SM for both kernels, no quantisation
    r_bal = 2 * n_sms * 8
    spins = torch.from_numpy(rng.choice(np.array([-1, 1], np.int8), size=(r_bal, l2, l2))).to(device)
    betas_bal = torch.from_numpy((1.0 / (1.0 + np.arange(r_bal) * 3.0 / r_bal)).astype(np.float32)).to(device)
    rung_bal = torch.arange(r_bal, dtype=torch.int32, device=device)
    a_bal = cuda_ms(torch, lambda: isk.ising_sweep_fused_kernel(
        spins, words, t0d, betas_bal, rung_bal, **main_kw), 3)
    p_bal = cuda_ms(torch, lambda: isk.ising_sweep_packed_kernel(
        spins, words, t0d, betas_bal, rung_bal, **main_kw, group=8), 3)
    del spins
    torch.cuda.empty_cache()
    print(f"phase 10 kernel #2p: {len(packed_cases)} cases equal to kernel A (spins, nacc, ΔE "
          f"bit for bit, at its default group width and at 8 and 3 a block) and to plain "
          f"(spins, nacc; ΔE exact at j=1,b=0, <= 4 ulps otherwise), max |ΔE err| vs "
          f"plain {err_p}")
    print(f"phase 10 times [{card}]: L=300 R=1500 S=2: kernel #2p {p_ms:.4f} ms "
          f"({blocks} blocks of {group} replicas x {threads} threads on {n_sms} SMs), "
          f"{p8_ms:.4f} ms at 8 a block ({-(-n_rep // 8)} blocks), kernel A {a_ms2:.4f} ms, "
          f"plain {p_plain_ms:.4f} ms, bound {a_bound:.5f} ms by {a_by}; S=100: #2p "
          f"{p_main:.3f} ms, at 8 a block {p8_main:.3f} ms, kernel A {a_main2:.3f} / "
          f"{a_main3:.3f} ms (before / after), bound {a_main_bound:.3f} ms; R={r_bal} "
          f"S=100 (16 replicas on every SM for both): #2p at 8 a block {p_bal:.3f} ms vs "
          f"kernel A {a_bal:.3f} ms; library_ms: none")

    # -- phase 11: the packed round and fused paths at full width -------------------
    def with_pack_bits(spec):
        d = json.loads(spec.to_json())
        d["system"]["params"]["pack_bits"] = True
        return RunSpec.from_json(d)

    def same_run(packed, unpacked, what):
        """Manifests equal but for the spec's pack_bits."""
        if packed["spec"]["system"]["params"].pop("pack_bits") is not True:
            raise AssertionError(f"{what}: spec lost pack_bits")
        if packed != unpacked:
            raise AssertionError(f"{what}: packed manifest != unpacked manifest")

    spec_round_p, spec_fused_p = with_pack_bits(spec_round), with_pack_bits(spec_fused)
    result, counts_pround_i, wall_p, _, _ = drive(spec_round_p, "packed round path")
    expect_launches(counts_pround_i, "packed round path", ising_packed=n_int, exchange=n_int)
    same_run(result.manifest(), manifest_round, "packed round path")
    result, counts_pfused_i, wall_pf, _, _ = drive(spec_fused_p, "packed fused path")
    expect_launches(counts_pfused_i, "packed fused path", ising_packed=n_int_f)
    same_run(result.manifest(), manifest_fused, "packed fused path")
    del result
    torch.cuda.empty_cache()
    for what, wall_x, sw, ni, cx in (("round", wall_p, sweeps, n_int, counts_pround_i),
                                     ("fused", wall_pf, spec_fused.schedule.total_sweeps,
                                      n_int_f, counts_pfused_i)):
        print(f"phase 11 packed {what} path [{card}]: Session L=300 R=1500 S=100 pack_bits, "
              f"{sw} sweeps in {wall_x:.3f} s = {sw / wall_x:.2f} sweeps/s "
              f"({sw * n_rep / wall_x:.1f} replica-sweeps/s), {1e3 * wall_x / ni:.2f} "
              f"ms/interval, launches { {k: v for k, v in cx.items() if v} }; manifest == "
              "the unpacked run's")
    session = Session(spec_round_p, device="cuda")
    session.state = session.init_state()
    torch.cuda.synchronize()
    print(profile_breakdown(torch, build, session.run, n_int, card, "phase 11 packed round",
                            {"kernel #2p": ("ising_packed_kernel", "ising_packed"),
                             "kernel B": ("exchange_kernel", "exchange")}))
    del session
    torch.cuda.empty_cache()

    # -- phase 12: two chains at full width on the packed round path ----------------
    spec_chains = RunSpec(
        system=SystemSpec("ising", {**params, "use_fused_round": True, "pack_bits": True}),
        ladder=base["ladder"], engine=EngineSpec(swap_interval=interval, chunk_intervals=1,
                                                 n_chains=2),
        schedule=ScheduleSpec(phases=(PhaseSpec(name="run", n_sweeps=300),)),
        observables=base["observables"], seed=0,
    )
    session = Session(spec_chains, device="cuda")
    session.state = session.init_state()
    torch.cuda.synchronize()
    build.reset_launches()
    t = time.perf_counter()
    ens = session.run()
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t
    counts_chains = dict(build.launches)
    n_int_c = spec_chains.schedule.total_sweeps // interval
    expect_launches(counts_chains, "two-chain path", ising_packed=2 * n_int_c,
                    exchange=2 * n_int_c)
    est = ens.state
    if tuple(est.pt.states.shape) != (2, n_rep, length, length):
        raise AssertionError(f"two-chain path: state shape {tuple(est.pt.states.shape)}")
    solo_spec = RunSpec.from_json({**json.loads(spec_chains.to_json()),
                                   "engine": {**json.loads(spec_chains.to_json())["engine"],
                                              "n_chains": 1}})
    for c in range(2):
        solo = Session(solo_spec, device="cuda")
        solo.state = solo.engine.init(keys.fold_in(keys.key(0), c), solo.temps)
        sst = solo.run().state
        for name in ("states", "rung", "energy", "t", "phase", "key"):
            if not torch.equal(getattr(est.pt, name)[c], getattr(sst.pt, name)):
                raise AssertionError(f"two-chain path: chain {c} {name} != its solo run")
        mine = chain_slice(est.stats, c)
        for name in ("swap_attempts", "swap_accepts", "round_trips", "n_records"):
            if not torch.equal(getattr(mine, name), getattr(sst.stats, name)):
                raise AssertionError(f"two-chain path: chain {c} stats {name} != solo")
        if not torch.equal(mine.mean["energy"], sst.stats.mean["energy"]):
            raise AssertionError(f"two-chain path: chain {c} mean energy != solo")
        del solo, sst
    state, _ = session.engine.advance(est, 1)  # warm-up of the advance itself
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = session.engine.advance(state, 3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    del ens, est, state, session
    torch.cuda.empty_cache()
    small_chains = json.loads(small.to_json())
    small_chains["engine"]["n_chains"] = 2
    small_chains["system"]["params"]["pack_bits"] = True
    card_equals_cpu(Session, RunSpec.from_json(small_chains), "small two-chain spec")
    sw_c = spec_chains.schedule.total_sweeps
    print(f"phase 12 two chains [{card}]: Session L=300 R=1500 n_chains=2 packed round path, "
          f"{sw_c} sweeps per chain in {wall_c:.3f} s = {sw_c / wall_c:.2f} sweeps/s per chain "
          f"({2 * sw_c * n_rep / wall_c:.1f} replica-sweeps/s over both), "
          f"{1e3 * wall_c / n_int_c:.2f} ms/interval, launches "
          f"{ {k: v for k, v in counts_chains.items() if v} } (host loop over chains); each "
          "chain == its solo run from fold_in(key, c); no host sync in 3 intervals; small "
          "two-chain spec equal on card and CPU")

    # -- phase 13: the Ising conformance entry on the card --------------------------
    round_packed = {"use_fused": True, "use_pallas": True, "use_fused_round": True,
                    "pack_bits": True}
    entry = REGISTRY["ising"]
    build.reset_launches()
    t = time.perf_counter()
    report = run_conformance(entry, seed=0, system_params=round_packed, device="cuda")
    wall_v = time.perf_counter() - t
    counts_conf = dict(build.launches)
    assert_conforms(report, z_max=4.0, geweke_max=4.0)
    if report.n_retunes != entry.adapt_rounds:
        raise AssertionError(f"conformance: {report.n_retunes} retunes")
    worst_series, worst_z = report.worst()
    t = time.perf_counter()
    fused_report = run_conformance(entry, seed=0, device="cuda",
                                   system_params={"use_fused": True, "use_pallas": True})
    wall_vf = time.perf_counter() - t
    assert_conforms(fused_report, z_max=4.0, geweke_max=4.0)
    short = dataclasses.replace(entry, burn_sweeps=150, n_batches=4, sweeps_per_batch=100)
    on_card = run_conformance(short, seed=0, system_params=round_packed, device="cuda")
    on_cpu = run_conformance(short, seed=0, system_params=round_packed, device="cpu")
    for f in ("temps", "means", "mcse", "exact", "z"):
        a, b = getattr(on_card, f), getattr(on_cpu, f)
        same = (np.array_equal(a, b) if isinstance(a, np.ndarray)
                else all(np.array_equal(a[k], b[k]) for k in b))
        if not same:
            raise AssertionError(f"short conformance entry: card != CPU in {f}")
    print(f"phase 13 conformance [{card}]: ising 4x4 R=5 n_chains=2 round path + pack_bits, "
          f"{entry.burn_sweeps + entry.n_batches * entry.sweeps_per_batch} sweeps per chain "
          f"in {wall_v:.2f} s, launches { {k: v for k, v in counts_conf.items() if v} }, "
          f"{report.n_batches} batch means, {report.n_retunes} retunes, worst |z| "
          f"{worst_z:.3f} ({worst_series}) <= 4, max |geweke| "
          f"{max(float(np.abs(g).max()) for g in report.geweke.values()):.3f} <= 4; the "
          f"fused path (validate --fused) in {wall_vf:.2f} s, worst |z| "
          f"{fused_report.worst()[1]:.3f} ({fused_report.worst()[0]}) <= 4; short "
          "entry report equal on card and CPU")

    # -- phase 14: kernel summary ---------------------------------------------
    def row(name, source, replaces, launches, **extra):
        tm = times[name]
        return {"name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": errs[name],
                "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound"][0],
                "bound_by": tm["bound"][1], "library_ms": None, **extra}

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
        {"name": "ising_packed", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ising_packed.cu",
         "replaces": "src/repro/kernels/ising_sweep.py:269",
         "launches": counts_pround_i["ising_packed"], "max_abs_err": err_p,
         "ms": p_ms, "plain_ms": p_plain_ms, "bound_ms": a_bound,
         "bound_by": a_by, "library_ms": None,
         "shape": "L=300 R=1500 S=2", "main_ms": p_main,
         "main_bound_ms": a_main_bound, "main_shape": "L=300 R=1500 S=100",
         "kernel_a_ms": a_ms2, "kernel_a_main_ms": a_main2,
         "grid": f"{blocks}x{threads}", "group": group,
         "group8_ms": p8_ms, "group8_main_ms": p8_main,
         "balanced_r": r_bal, "balanced_main_ms": p_bal,
         "balanced_kernel_a_main_ms": a_bal,
         "fused_path_launches": counts_pfused_i["ising_packed"],
         "two_chain_launches": counts_chains["ising_packed"],
         "conformance_launches": counts_conf["ising_packed"]},
        {"name": "exchange", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/exchange.cu",
         "replaces": "src/repro/kernels/ising_sweep.py:517",
         "launches": counts_round["exchange"], "max_abs_err": err_b,
         "ms": b_ms, "plain_ms": b_plain_ms, "bound_ms": b_bound,
         "bound_by": b_by, "library_ms": None,
         "shape": "R=1500", "main_ms": b_main,
         "potts_round_launches": counts_pround["exchange"]},
        row("ising_sweep", "sweep.cu", "src/repro/kernels/ising_sweep.py:121",
            counts_sweep["ising_sweep"], shape="L=300 R=1500"),
        row("potts_sweep", "sweep.cu", "src/repro/kernels/potts_sweep.py:109",
            counts_psweep["potts_sweep"], shape="300x300 q=3 R=1500"),
        row("potts_fused", "potts_fused.cu", "src/repro/kernels/potts_sweep.py:245",
            counts_pround["potts_fused"], shape="300x300 q=3 R=1500 S=2",
            main_ms=times["potts_fused"]["main_ms"],
            main_bound_ms=times["potts_fused"]["main_bound"][0],
            main_shape="300x300 q=3 R=1500 S=100",
            also_replaces="src/repro/kernels/potts_sweep.py:372 (with exchange)"),
        row("jax_uniform", "jax_uniform.cu",
            "none: XLA's jax.random.uniform (src/repro/engine/driver.py:171)",
            counts_sweep["jax_uniform"], shape="R=1500 x (2,300,300)",
            potts_path_launches=counts_psweep["jax_uniform"],
            potts_ms=times["jax_uniform"]["potts_ms"],
            potts_bound_ms=times["jax_uniform"]["potts_bound"][0]),
    ]
    print(f"phase 14 done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
