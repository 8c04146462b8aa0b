#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one line each or more (any failure raises and exits non-zero):

1. device name and power limit, then the nvcc build of every kernel;
2. kernel A (``csrc/ising_fused.cu``) against its plain PyTorch version on
   the card: the main path's L=300 R=1500 (S=2), then L=300 R=32 S=4,
   L=64 R=64 S=10 and a j=0.7 b=0.3 case under metropolis and glauber, and
   the shapes its row walk must get right at R=13 (L=2 and 4, L=30 and 66,
   no multiple of a warp's lanes, and L=470 near the shared-memory limit),
   at integer and non-integer j, b under both rules;
3. the round exchange (``csrc/exchange.cuh``, run by the last block of a
   round launch of kernel A, #2p or #5) against the plain ``exchange_step``
   at R=1500, DEO/SEO x logistic/metropolis over 8 phases, through a round
   launch of each of the three kernels with no sweep; one round launch of
   each at the main path's shapes (L=300 R=1500 S=2; #5 on 300x300 q=3),
   in place, against the plain sweeps then the plain exchange; the tail (a
   round launch less the same launch without the exchange, profiler device
   time) at L=32 R=1500 S=1 and L=300 R=1500 S=2;
4. the main path at full width through ``repro_torch.api.Session``: Ising
   L=300, glauber, whole-round fused kernels, paper ladder R=1500, swap
   interval 100, logistic DEO, adaptation in burn, 300 + 300 sweeps; one
   launch and one exchange per interval, and the incremental energy must
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
   plain versions on the card, at L=300 R=1500 and smaller cases (#5 also at
   2x2, 4x4, 8x6, 64x48, 30x66 and 470x470 with R=13, q in {2, 3, 64}, both
   rules, j=1 and 0.7), and each one timed beside its plain version at the
   shapes its path gives it;
7. the per-sweep (default) Ising path at full width: L=300 R=1500, S=100,
   glauber, paper ladder, 3 intervals (200 burn with adaptation + 100
   measure); launches must be one ``jax_uniform`` and one kernel #1 per
   sweep, the incremental energy the lattice energy exactly; then once more
   under ``torch.profiler``;
8. the Potts per-sweep and round paths at full width: 300x300, q=3,
   R=1500, S=100, glauber, geometric ladder 0.7-2.9, 3 intervals each, with
   the same checks (round path: one kernel #5 launch and one exchange per
   interval), the round path once more under the profiler;
9. 3 intervals of the Ising per-sweep path and of the Potts per-sweep,
   fused and round paths at full width with every host sync an error; and
   ``examples/specs/ising_small.json`` and a small Potts spec on each of its
   three paths, run on the card and on the CPU, which must agree;
10. kernel #2p (``csrc/ising_packed.cu``, ``pack_bits``) against kernel A
    (spins, counts and ΔE bit for bit) and against its plain version
    (spins and counts; ΔE exact where every term is an integer, else within
    4 ulps) at L=300 R=1500 S=2 (j=1 b=0 and j=0.7 b=0.3), at small odd R,
    and at the shapes phase 2 gives A's row walk (L=2, 4, 30, 66, 470 at
    R=13), at its default group width and at 1, 3 and 8 replicas a block;
    timed at S=2 and S=100 beside kernel A and its bound, at 8 a block too,
    and at R=2112, where both kernels put 16 replicas on every SM, in turns;
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
14. kernel #7 (``csrc/wkv6.cu``, the RWKV-6 recurrence) against its plain
    version at the serving shapes of rwkv6-7b with B=4 (BH=256, dk=dv=64:
    prefill T=512 from zero state, decode T=1 from a carried state), at
    the JAX package's small shapes, at rows that are no multiple of 16
    bytes (dk, dv in 1, 5, 63) and over several 32-step stages (T=33,
    T=1000); state threading (two launches equal one, bit for bit, split at
    a stage boundary and off one) and the w=1, k=0 identity; timed at both
    serving shapes beside its plain version, by CUDA events and by the
    profiler's device time;
15. rwkv6-7b at full width and depth in bf16 (7.53e9 parameters drawn on
    the card from a seeded generator): ``prefill_logits`` on (4, 512)
    tokens, then ``launch.serve_lm.generate`` for B=4 over 64 tokens at
    temperature 0.8 (ms/token against the HBM floor of streaming every
    weight once), wkv6 launches equal to 32 per forward, peak memory, and
    the prefill and the decode loop once more under ``torch.profiler``;
16. decode logits of 16 steps against the full forward's at each position
    at full width in f32 (30 GB of weights), within the JAX package's rtol
    = atol = 3e-2 (step 0 within 1e-4); a reduced f32 model's prefill
    logits and sampled tokens equal on the card and the CPU;
17. checkpoint and resume: the paper's Ising spec on the round path
    (L=300, R=1500, S=100, glauber, logistic DEO, 200 burn sweeps with
    adaptation + 200 measure, a chunk an interval) run through, and run
    again with a ``CheckpointCallback`` every chunk and an
    ``EarlyStopCallback`` at sweep 300, then finished by
    ``Session.from_checkpoint``: every leaf of the final engine state and
    the f64 ladder equal bit for bit, one round launch and one exchange per
    resumed interval, tickets 0, the checkpoint's bytes and the seconds of
    a save and of the restore; the same on the packed round path (#2p) at
    L=64, and a small Potts round spec resumed mid-measure on the card
    equal to its uninterrupted CPU run;
18. the exchange strategies at full width (L=300 R=1500 S=100, two
    intervals each): SEO, windowed (window 4), VMPT and DEO with
    ``swap_mode="state"`` on the interval-fused path (kernel A), and state
    mode on the per-sweep path (#1 + ``jax_uniform``): rung maps are
    permutations (the identity in state mode), the incremental energy is
    the lattice energy exactly, 3 more intervals run with every host sync
    an error; ms per interval, and the ms of a proposal call at R=1500;
19. card == CPU on L=8 R=8 specs: SEO, windowed, VMPT, state mode (fused
    and per-sweep) and flow adaptation (which must retune), and the phase 5
    round spec resumed on the card from a checkpoint at sweep 600;
20. the rest of the system zoo: both kernels of ``csrc/serial_chain.cu``
    (HP moves, Ising single_flip) against their plain versions bit for bit
    (12 cases: N from 3 to 20, odd L, 1 / 7 / 300 flips, both rules) and
    timed beside them at full width; through ``Session`` at R=1500, S=100:
    the EA spin glass at 300x300 on the per-sweep path in temp and state
    mode (one ``jax_uniform`` a sweep, kernel #1 never), HP on the 20-mer
    of ``benchmarks/systems_bench.py`` (one kernel launch a sweep), Ising
    single_flip at L=300 with 300 flips a step and the Gaussian mixture,
    ms per interval, EA and HP once more under the profiler; the zoo's EA,
    Gaussian and HP conformance entries at full schedule; small specs of the
    four paths on the card against the CPU;
21. a JSON line per kernel (launches, error, times, bound), the card line,
    and the result line ``{"ok": true, "device": {...}}`` last.

After every phase each round launch's ticket must read 0 again (one that
faulted would leave its ticket set).  It imports nothing of JAX or of the
JAX package.  Without a CUDA device, or
without the repository's ``src/`` beside it, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
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
# Kernel A hashes one block per site update, kernel #5 two, the round
# exchange one per rung (+3 per launch), jax_uniform one per uniform.
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


def card_equals_cpu(Session, spec, what: str, mean_rtol: float = 0.0) -> dict:
    """The spec's run on the card and on the CPU give equal manifests;
    returns the card's."""
    on_card = Session(spec, device="cuda").run().manifest()
    manifests_equal(on_card, Session(spec, device="cpu").run().manifest(), what, mean_rtol)
    return on_card


def manifests_equal(on_card: dict, on_cpu: dict, what: str, mean_rtol: float = 0.0) -> None:
    """Counters and the final state exact; the mean energy exact, or within
    ``mean_rtol`` relative where it is weighted by swap probabilities (VMPT:
    the card's and the CPU's sigmoid may differ in the last ulps)."""
    for name in on_card["phases"]:
        got, want = on_card["phases"][name]["summary"], on_cpu["phases"][name]["summary"]
        for key in ("swap_attempts", "swap_acceptance", "round_trips", "mean_energy"):
            if key == "mean_energy" and mean_rtol:
                a, b = (sum(x, []) if isinstance(x[0], list) else x
                        for x in (got[key], want[key]))
                if any(abs(u - v) > mean_rtol * abs(v) for u, v in zip(a, b)):
                    raise AssertionError(f"{what}: card != CPU in {name}.{key}")
            elif got[key] != want[key]:
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
    """Phase 10: kernel #2p == kernel A (spins, nacc and ΔE bit for bit:
    each replica's partial sums add A's terms in A's order) at its default
    group width and at 1, 3 and 8 replicas a block, and == its plain version
    (spins, nacc; ΔE exact at integer terms, else within 4 ulps: the walk
    sums a colour in another order than the plain version); returns max
    |ΔE err| against the plain version."""
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
        exact = j == 1.0 and b == 0.0  # integer terms: every order sums exactly
        got = isk.ising_sweep_packed_kernel(spins, words, t0, betas, rung, **kw)
        kernel_a = isk.ising_sweep_fused_kernel(spins, words, t0, betas, rung, **kw)
        torch.cuda.synchronize()

        def same_as_a(out):
            return all(torch.equal(x, y) for x, y in zip(out, kernel_a))

        if not same_as_a(got):
            raise AssertionError(f"kernel #2p differs from kernel A: case {n}")
        for group in (1, 3, 8):  # kernel A's update, odd groups, full bytes
            other = isk.ising_sweep_packed_kernel(spins, words, t0, betas, rung, **kw,
                                                  group=group)
            torch.cuda.synchronize()
            if not same_as_a(other):
                raise AssertionError(f"kernel #2p group {group} differs from kernel A: case {n}")
            del other
        want = isk.ising_sweep_packed_plain(spins, words, t0, betas, rung, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got[0], want[0]) or not torch.equal(got[2], want[2]):
            raise AssertionError(f"kernel #2p spins/nacc differ from plain: case {n}")
        what = f"kernel #2p L={length} R={r} S={sweeps} j={j} b={b} {rule}"
        per_site = 2 * (4 * abs(j) + abs(b))
        assert_de(kernel_a[1], want[1], want[2], exact, per_site, what + " (kernel A)")
        err = assert_de(got[1], want[1], want[2], exact, per_site, what)
        del kernel_a
        max_err = max(max_err, err)
        print(f"  {what}: spins, nacc and ΔE equal to kernel A at 4 widths, spins/nacc to "
              f"plain, max |dE err| vs plain {err}")
        del got, want, spins
        torch.cuda.empty_cache()
    return max_err


def check_round_exchange(torch, isk, pk, prng, cases):
    """Phase 3: the round exchange == plain exchange_step on the card.

    Each case (`fused_probe.exchange_cases`: 32 exchanges at R=1500) runs
    through a round launch of kernel A, #2p and #5 with no sweep (S=0, so
    each slot's ΔE is 0) on ``energy + de``: the three launches' rows must
    be equal bit for bit, and equal to ``exchange_plain`` on (energy, de) in
    rung, energy and attempt, and in prob and accept except where u lies
    between the two p.  Returns (max |dp|, prob differences)."""
    max_err = 0.0
    n_prob_diff = 0
    for c in cases:
        r = c["rung"].shape[0]
        dev = c["rung"].device
        spins = torch.ones((r, 2, 2), dtype=torch.int8, device=dev)
        t0 = torch.zeros((), dtype=torch.int64, device=dev)
        what = f"{c['pairing']}/{c['criterion']} phase {c['phase']}"
        kw = dict(pairing=c["pairing"], criterion=c["criterion"], phase_add=c["phase"],
                  n_sweeps=0)
        args = (c["words"], t0, c["ph0"], c["betas"], c["rung"], c["energy"] + c["de"])
        outs = [isk.ising_round_kernel(spins, *args, **kw),
                isk.ising_round_kernel(spins, *args, pack_bits=True, **kw),
                pk.potts_round_kernel(spins * 0, *args, q=3, **kw)]
        rows = [(o[1], o[2], o[4], o[5], o[6]) for o in outs]
        torch.cuda.synchronize()
        for other, name in zip(rows[1:], ("#2p", "#5")):
            if not all(torch.equal(x, y) for x, y in zip(rows[0], other)):
                raise AssertionError(f"round exchange: kernel {name}'s rows != kernel A's: {what}")
        got = rows[0]
        want = isk.exchange_plain(c["rung"], c["energy"], c["de"], c["betas"], c["words"],
                                  c["ph0"], pairing=c["pairing"], criterion=c["criterion"],
                                  phase_add=c["phase"])
        u = prng.swap_uniforms(c["words"], c["ph0"] + c["phase"], r)
        lo = torch.minimum(got[3], want[3])
        hi = torch.maximum(got[3], want[3])
        in_gap = (u >= lo) & (u < hi)
        prob_diff = got[3] != want[3]
        acc_diff = got[2] != want[2]
        if bool((prob_diff & ~in_gap).any()) or bool((acc_diff & ~in_gap).any()):
            raise AssertionError(f"round exchange prob/accept differ outside the ulp gap: {what}")
        if not torch.equal(got[4], want[4]) or not torch.equal(got[1], want[1]):
            raise AssertionError(f"round exchange attempt/energy differ: {what}")
        if not bool(acc_diff.any()) and not torch.equal(got[0], want[0]):
            raise AssertionError(f"round exchange rung differs: {what}")
        n_prob_diff += int(prob_diff.sum().item())
        max_err = max(max_err, (got[3] - want[3]).abs().max().item())
    return max_err, n_prob_diff


def check_rounds_at_full_width(torch, np, isk, pk, keys, prng, device, r=1500,
                               length=300) -> list:
    """Phase 3: one round launch each of kernels A, #2p (its default group)
    and #5 at the main path's shapes (L=300 R=1500 S=2 glauber; #5 on
    300x300 colours, q=3), on a permuted rung and energies near an
    equilibrated ladder, every output written in place over its input,
    against the plain sweeps then ``exchange_plain`` on the same inputs:
    spins, counts, energy' and attempt bit-equal, prob and accept equal but
    where u lies between the two p, rung' equal where no decision differs.
    So every one of the launch's blocks hands its ΔE to the last block's
    exchange at the grid the main path launches.  Returns one (kernel,
    exchange, accepted swaps, prob differences, max |dp|) a launch."""
    n_sweeps = 2
    rng = np.random.default_rng(9)
    betas = torch.from_numpy((1.0 / (1.0 + np.arange(r) * 3.0 / r)).astype(np.float32)).to(device)
    words = keys.key(13, device=device)
    t0 = torch.tensor(40, dtype=torch.int64, device=device)
    ph0 = torch.tensor(7, dtype=torch.int64, device=device)
    spins = torch.from_numpy(rng.choice(np.array([-1, 1], np.int8),
                                        size=(r, length, length))).to(device)
    colours = torch.from_numpy(rng.integers(0, 3, (r, length, length)).astype(np.int8)).to(device)
    runs = (("A", spins, isk.ising_sweep_fused_plain, isk.ising_round_kernel, {}, {},
             "deo", "logistic"),
            ("#2p", spins, isk.ising_sweep_packed_plain, isk.ising_round_kernel, {},
             {"pack_bits": True}, "seo", "logistic"),
            ("#5", colours, pk.potts_sweep_fused_plain, pk.potts_round_kernel, {"q": 3},
             {"q": 3}, "deo", "metropolis"))
    out = []
    for name, states, plain, kernel, plain_kw, round_kw, pairing, criterion in runs:
        rung = torch.from_numpy(rng.permutation(r).astype(np.int32)).to(device)
        by_rung = -180000 + 100 * np.arange(r) + rng.integers(-400, 400, r)
        energy = torch.from_numpy(by_rung.astype(np.float32)).to(device)[rung.long()]
        xw = dict(pairing=pairing, criterion=criterion)
        want_states, de, nacc = plain(states, words, t0, betas, rung, n_sweeps=n_sweeps,
                                      rule="glauber", t_add=3, **plain_kw)
        want = isk.exchange_plain(rung, energy, de, betas, words, ph0, phase_add=2, **xw)
        del de
        st, rg, en = states.clone(), rung.clone(), energy.clone()
        rows = [torch.empty(r, dtype=d, device=device)
                for d in (torch.bool, torch.float32, torch.bool)]
        got = kernel(st, words, t0, ph0, betas, rg, en, n_sweeps=n_sweeps, rule="glauber",
                     t_add=3, phase_add=2, out=(st, rg, en, *rows), **round_kw, **xw)
        torch.cuda.synchronize()
        what = f"round launch of kernel {name} at full width ({pairing}/{criterion})"
        if not torch.equal(got[0], want_states) or not torch.equal(got[3], nacc):
            raise AssertionError(f"{what}: spins/nacc differ from the plain sweeps")
        if not torch.equal(got[2], want[1]) or not torch.equal(got[6], want[4]):
            raise AssertionError(f"{what}: energy'/attempt differ from exchange_plain")
        u = prng.swap_uniforms(words, ph0 + 2, r)
        lo, hi = torch.minimum(got[5], want[3]), torch.maximum(got[5], want[3])
        in_gap = (u >= lo) & (u < hi)
        diff = (got[4] != want[2]) | (got[5] != want[3])
        if bool((diff & ~in_gap).any()):
            raise AssertionError(f"{what}: prob/accept differ outside the ulp gap")
        if not bool(diff.any()) and not torch.equal(got[1], want[0]):
            raise AssertionError(f"{what}: rung' differs from exchange_plain")
        out.append((name, f"{pairing}/{criterion}", int(got[4].sum().item()),
                    int((got[5] != want[3]).sum().item()),
                    (got[5] - want[3]).abs().max().item()))
        del want_states, nacc, want, got, st, rg, en, rows
        torch.cuda.empty_cache()
    return out


def counts_now(build) -> dict:
    """Launches by kernel since the last reset, and under ``exchange`` the
    round exchanges run (inside launches of A, #2p or #5, none of their own)."""
    return {**build.launches, **build.epilogues}


def check_tickets(build, what: str) -> None:
    """Every round ticket reads 0: no round launch was left half done."""
    dirty = build.dirty_tickets()
    if dirty:
        raise AssertionError(f"{what}: round tickets left set: {dirty}")


def round_tail(torch, isk, spins, words, t0, betas, rung, energy, n_sweeps, reps,
               pack_bits=False):
    """Device time (profiler) of a round launch of kernel A (#2p with
    ``pack_bits``) and of the same launch without the exchange, in turns
    (sweeps, round, round, sweeps); returns (round ms, sweeps ms), each the
    lower of its two readings."""
    name = "ising_packed_kernel" if pack_bits else "ising_fused_kernel"
    sweep = isk.ising_sweep_packed_kernel if pack_bits else isk.ising_sweep_fused_kernel
    ph0 = torch.zeros((), dtype=torch.int64, device=spins.device)
    kw = dict(n_sweeps=n_sweeps, rule="glauber")

    def sweeps_only():
        sweep(spins, words, t0, betas, rung, **kw)

    def one_round():
        isk.ising_round_kernel(spins, words, t0, ph0, betas, rung, energy, pairing="deo",
                               criterion="logistic", pack_bits=pack_bits, **kw)

    times = {fn: [] for fn in (sweeps_only, one_round)}
    for fn in (sweeps_only, one_round, one_round, sweeps_only):
        times[fn].append(profiler_ms(torch, fn, reps, name)[0])
    return min(times[one_round]), min(times[sweeps_only])


def check_no_host_sync(torch, session, make_interval_step, update_stats, n: int) -> float:
    """Phase 5: ``n`` intervals of the session's path with every host sync an error.

    Runs the engine's own interval step and stats update (what `Engine.run`
    issues between two chunk boundaries) under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any stream
    or device synchronisation and any blocking host<->device copy.  Returns
    the wall seconds of the ``n`` intervals (after a warm-up interval, to a
    final synchronisation).
    """
    eng = session.engine
    step = make_interval_step(eng.system, eng.config.spec, eng.observables)
    state = session.init_state()
    pt, stats = step(state.pt, state.betas)[0], state.stats  # warm-up launch
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(n):
            pt, rec = step(pt, state.betas)
            stats = update_stats(stats, rec, pt.rung)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return time.perf_counter() - t


def resume_equals_uninterrupted(torch, np, build, api, ckpt, spec, stop: int, what: str,
                                launch: str) -> dict:
    """Phase 17: ``spec`` run through, and run again with a checkpoint every
    chunk and an early stop at sweep ``stop``, then finished by
    ``Session.from_checkpoint``; the two final states must be equal bit for
    bit (every leaf of the engine state, the f64 ladder) and the resumed run
    must launch ``launch`` once a round with one exchange in it.  Returns
    the resumed run's launches, the checkpoint's bytes and the seconds of
    one save and of the restore."""
    full = api.Session(spec, device="cuda")
    full.state = full.init_state()
    full.run()
    with tempfile.TemporaryDirectory() as d:
        part = api.Session(spec, device="cuda", callbacks=[
            api.CheckpointCallback(d),
            api.EarlyStopCallback(lambda i: int(i.state.pt.t.reshape(-1)[0].item()) >= stop)])
        part.state = part.init_state()
        if not part.run().stopped_early:
            raise AssertionError(f"{what}: the early stop did not fire")
        del part
        torch.cuda.synchronize()
        t = time.perf_counter()
        resumed = api.Session.from_checkpoint(d, device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        if resumed.remaining_sweeps != spec.schedule.total_sweeps - stop:
            raise AssertionError(f"{what}: {resumed.remaining_sweeps} sweeps left")
        build.reset_launches()
        result = resumed.run()
        torch.cuda.synchronize()
        counts = counts_now(build)
        check_tickets(build, what)
        n_int = (spec.schedule.total_sweeps - stop) // spec.engine.swap_interval
        expect_launches(counts, what, **{launch: n_int, "exchange": n_int})
        got, want = ckpt.to_arrays(result.state), ckpt.to_arrays(full.state)
        diff = [k for k in want if not np.array_equal(got[k], want[k])]
        if diff or not np.array_equal(resumed.engine._temps, full.engine._temps):
            raise AssertionError(f"{what}: resumed != uninterrupted in {diff or 'the ladder'}")
        newest = ckpt.CheckpointManager(d)._step_dir(ckpt.CheckpointManager(d).steps()[-1])
        n_bytes = sum(os.path.getsize(os.path.join(newest, f)) for f in os.listdir(newest))
    with tempfile.TemporaryDirectory() as d:
        torch.cuda.synchronize()
        t = time.perf_counter()
        ckpt.CheckpointManager(d).save(spec.schedule.total_sweeps, result.state,
                                       meta={"temps": list(resumed.engine._temps)})
        save_s = time.perf_counter() - t
    return dict(counts=counts, n_int=n_int, bytes=n_bytes, save_s=save_s,
                restore_s=restore_s)


def profile_breakdown(torch, build, run, n_int: int, card: str, label: str,
                      kernels: dict, groups: dict | None = None,
                      unit: str = "interval") -> str:
    """Where one path's device time goes, from ``torch.profiler``.

    Sums the device time of every kernel and copy (device-side events only,
    not the host ops that launched them); ``kernels`` maps a label to a
    substring of a kernel's symbol and its key in ``build.launches``.  The
    breakdown counts only if the profiler saw every launch that the counters
    saw in the same run; else it says "not measured".  ``idle`` is the share
    of the profiled wall time with no device work (an upper bound on the true
    idle share: the profiler itself slows the host).  Host syncs are counted
    over the whole run, chunk and phase boundaries included.  ``groups`` maps
    a label to substrings of kernel names (e.g. cuBLAS's GEMMs) whose device
    time is summed and reported as a share of the wall, with no launch
    count to check; ``unit`` names what ``n_int`` counts.
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

    def in_group(k, subs_g):
        return any(g in k.lower() for g in subs_g) and not any(sub in k for sub in subs)

    grouped = {lab: sum(v for k, v in dev_us.items() if in_group(k, subs_g)) / 1e3
               for lab, subs_g in (groups or {}).items()}
    all_g = [g for subs_g in (groups or {}).values() for g in subs_g]
    other = sorted(((v, k) for k, v in dev_us.items()
                    if v and not any(sub in k for sub in subs) and not in_group(k, all_g)),
                   reverse=True)
    top = "; ".join(f"{k[:50]} {v / 1e3 / n_int:.3f}" for v, k in other[:4])
    parts = ", ".join(f"{lab} {ms / n_int:.4f} ms ({ms / wall_ms:.3f} of the wall)"
                      for lab, ms in {**named, **grouped}.items())
    rest = busy_ms - sum(named.values()) - sum(grouped.values())
    return (f"{label} profile [{card}]: {n_int} {unit}s in {wall_ms:.1f} ms wall "
            f"(profiled), device busy {busy_ms:.1f} ms, idle share "
            f"{1 - busy_ms / wall_ms:.3f}; per {unit}: {parts}, other device work "
            f"{rest / n_int:.3f} ms (top: {top}), "
            f"host syncs {syncs} in the run ({syncs / n_int:.2f} per {unit}); "
            f"launches seen {seen}")


def check_sweep_kernels(torch, np, isk, pk, ju, ref, prng, keys, device):
    """Phase 6: kernels #1, #4, #5 and jax_uniform == plain on the card.

    Returns the largest |ΔE| error of each kernel (0.0 for jax_uniform,
    whose values must be bit-equal)."""
    errs = {"ising_sweep": 0.0, "potts_sweep": 0.0, "potts_fused": 0.0, "jax_uniform": 0.0}
    rng = np.random.default_rng(60)

    def check_fused(states, betas, h, w, r, q, j, rule, sweeps):
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
        check_fused(states, betas, h, w, r, q, j, rule, sweeps)
    # kernel #5's row walk at its edges: smallest lattices, H != W, sides no
    # multiple of 32, near the shared-memory limit; R=13, q in {2, 3, 64}
    for h, w, sweeps in ((2, 2, 5), (4, 4, 5), (8, 6, 4), (64, 48, 4), (30, 66, 4),
                         (470, 470, 2)):
        for q, j, rule in ((2, 1.0, "metropolis"), (3, 0.7, "glauber"),
                           (64, 1.0, "glauber"), (64, 0.7, "metropolis")):
            states = torch.from_numpy(rng.integers(0, q, (13, h, w)).astype(np.int8)).to(device)
            betas = torch.from_numpy((1.0 / np.geomspace(0.7, 2.9, 13)).astype(np.float32)).to(device)
            check_fused(states, betas, h, w, 13, q, j, rule, sweeps)
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


def wkv6_inputs(torch, np, bh, t, dk, dv, seed, device, state=False):
    """r, k, v, w, u and (with ``state``) an initial state from a numpy seed,
    as the JAX package's wkv6 tests draw them (w = sigmoid(normal))."""
    rng = np.random.default_rng(seed)
    r, k = (rng.normal(size=(bh, t, dk)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(bh, t, dv)).astype(np.float32)
    w = (1.0 / (1.0 + np.exp(-rng.normal(size=(bh, t, dk))))).astype(np.float32)
    u = rng.normal(size=(bh, dk)).astype(np.float32)
    s0 = rng.normal(size=(bh, dk, dv)).astype(np.float32) if state else None
    return [None if x is None else torch.from_numpy(x).to(device)
            for x in (r, k, v, w, u, s0)]


def wkv6_bound(bh, t, dk, dv, state: bool) -> tuple[float, str]:
    """Least time of kernel #7: r, k, w, v read and o written once, u read
    once, the final state written once and the initial state read once when
    there is one (``state``), against ~4·dk·dv + 3·dk + 2·dv f32 flops per
    slab and step at the 67e12/s fp32 rate."""
    n_state = (2 if state else 1) * bh * dk * dv
    n_bytes = 4.0 * (bh * t * (3 * dk + 2 * dv) + n_state + bh * dk)
    flops = float(bh * t * (4 * dk * dv + 3 * dk + 2 * dv))
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def check_wkv6(torch, np, wk, ref, device) -> float:
    """Phase 14: kernel #7 == its plain version on the card; returns max |err|.

    Tolerance: the rounding bound of the recurrence, 2·(dk + T)·eps times the
    same recurrence run on |r|, |k|, |v|, w, |u|, |S0| (each output is a
    dk-term dot product over a state that sums up to T decayed terms, and
    the two versions add them in other orders); and, at the JAX package's
    own small shapes, also its rtol = atol = 3e-5.
    """
    max_err = 0.0
    cases = [((256, 512, 64, 64), False, "prefill"), ((256, 1, 64, 64), True, "decode"),
             ((4, 33, 8, 8), False, "small"), ((2, 16, 16, 8), True, "small"),
             ((1, 8, 4, 4), False, "small"), ((3, 64, 64, 64), True, "small"),
             # rows that are no multiple of 16 bytes (4-byte copies), several stages
             ((2, 33, 1, 5), True, "unaligned"), ((3, 33, 63, 5), False, "unaligned"),
             ((2, 33, 5, 63), True, "unaligned"), ((2, 1000, 63, 1), True, "stages"),
             ((2, 1000, 5, 63), False, "stages"), ((4, 1000, 64, 64), True, "stages")]
    for n, ((bh, t, dk, dv), state, what) in enumerate(cases):
        args = wkv6_inputs(torch, np, bh, t, dk, dv, 300 + n, device, state)
        got = wk.wkv6_kernel(*args)
        want = ref.wkv6(*args)
        mag = ref.wkv6(*(None if x is None else x.abs() for x in args))
        torch.cuda.synchronize()
        for g, w_, m, name in zip(got, want, mag, ("o", "state")):
            err = (g - w_).abs()
            tol = 2 * (dk + t) * F32_EPS * m
            if bool((err > tol).any()):
                raise AssertionError(f"kernel #7 {what} {(bh, t, dk, dv)}: {name} beyond "
                                     f"the rounding bound, max err {err.max().item()}")
            if what == "small" and not torch.allclose(g, w_, rtol=3e-5, atol=3e-5):
                raise AssertionError(f"kernel #7 {(bh, t, dk, dv)}: {name} beyond 3e-5")
            max_err = max(max_err, err.max().item())
    # state threading: two launches == one, bit for bit: T=32 in halves, and
    # splits off the kernel's 32-step stages, with aligned and unaligned rows
    for n, (t, split, dk, dv) in enumerate(((32, 16, 8, 8), (100, 45, 64, 64),
                                            (1000, 333, 64, 64), (70, 1, 5, 63))):
        r, k, v, w, u, s0 = wkv6_inputs(torch, np, 3, t, dk, dv, 320 + n, device, state=True)
        o_full, s_full = wk.wkv6_kernel(r, k, v, w, u, s0)
        o1, s1 = wk.wkv6_kernel(*(x[:, :split].contiguous() for x in (r, k, v, w)), u, s0)
        o2, s2 = wk.wkv6_kernel(*(x[:, split:].contiguous() for x in (r, k, v, w)), u, s1)
        torch.cuda.synchronize()
        if not (torch.equal(o_full, torch.cat([o1, o2], 1)) and torch.equal(s_full, s2)):
            raise AssertionError(f"kernel #7: T={t} split at {split} != one run")
    # w=1, k=0 leaves the state unchanged and gives o = r @ S
    s0 = torch.arange(16, dtype=torch.float32, device=device).reshape(1, 4, 4)
    ones, zeros = (torch.full((1, 2, 4), f, device=device) for f in (1.0, 0.0))
    o, s = wk.wkv6_kernel(ones, zeros, zeros, ones, torch.zeros((1, 4), device=device), s0)
    if not torch.equal(s, s0) or not torch.allclose(o[0, 0], ones[0, 0] @ s0[0]):
        raise AssertionError("kernel #7: w=1, k=0 is not the identity")
    return max_err


def profiler_ms(torch, fn, reps: int, name: str) -> tuple[float, int]:
    """Mean device time in ms of one launch of the kernels whose name holds
    ``name``, over ``reps`` calls of ``fn`` under ``torch.profiler`` (no
    host time in it), and how many launches the profiler saw."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # one small op first, so that the tracer is running when fn starts
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and name in e.key]
    seen = sum(e.count for e in rows)
    if seen == 0:
        raise AssertionError(f"the profiler saw no {name} launch")
    return sum(float(e.self_device_time_total) for e in rows) / seen / 1e3, seen


def time_wkv6(torch, np, wk, ref, device) -> dict:
    """Phase 14 times: kernel #7 and its plain version on the same inputs at
    the serving path's shapes (rwkv6-7b, B=4: BH=256, dk=dv=64), prefill
    T=512 from zero state and decode T=1 from a carried state; CUDA events
    around back-to-back launches (the wrapper's host time included where it
    exceeds the kernel's) and the profiler's device time per launch."""
    out = {}
    for name, t, state, reps, plain_reps in (("prefill", 512, False, 50, 2),
                                             ("decode", 1, True, 500, 100)):
        args = wkv6_inputs(torch, np, 256, t, 64, 64, 330, device, state)
        out[name] = dict(
            ms=cuda_ms(torch, lambda: wk.wkv6_kernel(*args), reps),
            device=profiler_ms(torch, lambda: wk.wkv6_kernel(*args), 50, "wkv6"),
            plain_ms=cuda_ms(torch, lambda: ref.wkv6(*args), plain_reps),
            bound=wkv6_bound(256, t, 64, 64, state))
    return out


def rwkv_phases(torch, np, build, ref, device, card: str) -> dict:
    """Phases 14-16: kernel #7 against its plain version, rwkv6-7b serving at
    full width and depth, decode == full forward, and a reduced model on the
    card == CPU.  Returns what the kernel summary needs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.launch import serve_lm
    from repro_torch.launch.rwkv_rounding import decode_vs_forward
    from repro_torch.models import model as model_lib

    # -- phase 14: kernel #7 (wkv6) against its plain version ------------------------
    torch.cuda.empty_cache()
    err_w = check_wkv6(torch, np, wk, ref, device)
    wkv_times = time_wkv6(torch, np, wk, ref, device)
    print(f"phase 14 kernel #7 (wkv6): equal to plain at the prefill (BH=256 T=512 dk=dv=64), "
          f"decode (BH=256 T=1, carried state), 4 small shapes, 3 with dk or dv in 1, 5, 63 "
          f"(T=33) and 3 of T=1000 within 2(dk+T)·eps·|terms| (and 3e-5 at the small ones); "
          f"two launches == one at T=32 split 16, T=100 split 45, T=1000 split 333, T=70 "
          f"split 1 (dk=5, dv=63); w=1, k=0 the identity; max |err| {err_w}")
    for name, tm in wkv_times.items():
        dev_ms, seen = tm["device"]
        print(f"phase 14 times [{card}]: wkv6 {name} {tm['ms']:.4f} ms (CUDA events), "
              f"{dev_ms:.5f} ms device time (profiler, {seen} of 50 launches seen) vs plain "
              f"{tm['plain_ms']:.4f} ms, bound {tm['bound'][0]:.5f} ms by {tm['bound'][1]}, "
              f"bound/device time {tm['bound'][0] / dev_ms:.3f}; library_ms: none")

    # -- phase 15: rwkv6-7b serving at full width and depth, bf16 --------------------
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the f32 checks below need full f32")
    cfg = get_config("rwkv6_7b")
    per_forward = cfg.n_layers  # one wkv6 launch per layer and forward
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    lm = model_lib.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    torch.cuda.synchronize()
    init_lm_s = time.perf_counter() - t
    n_params = sum(q.numel() for q in lm.parameters())
    # ModelConfig.n_params (the JAX package's analytic count) leaves out nine
    # d-vectors a layer: the seven mu lerp weights, w0 and ln_scale
    if n_params != cfg.n_params + 9 * cfg.d_model * cfg.n_layers:
        raise AssertionError(f"rwkv6-7b: {n_params} parameters, ModelConfig {cfg.n_params}")
    w_bytes = sum(q.numel() * q.element_size() for q in lm.parameters())
    floor_ms = 1e3 * w_bytes / HBM_BYTES_PER_S  # a decode step streams every weight once
    batch, seq, n_gen = 4, 512, 64
    tokens = torch.randint(0, cfg.vocab, (batch, seq), device=device,
                           generator=torch.Generator(device=device).manual_seed(1))
    with torch.inference_mode():
        model_lib.prefill_logits(lm, cfg, {"tokens": tokens})  # first use of each op
        torch.cuda.synchronize()
        build.reset_launches()
        logits = model_lib.prefill_logits(lm, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
        counts_prefill = dict(build.launches)
        t = time.perf_counter()
        for _ in range(3):
            model_lib.prefill_logits(lm, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t) / 3
    expect_launches(counts_prefill, "prefill", wkv6=per_forward)
    if (tuple(logits.shape) != (batch, cfg.vocab) or logits.dtype != torch.float32
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} {logits.dtype} not finite")
    serve_lm.generate(lm, cfg, batch, 4, device)  # first use of the decode ops
    torch.cuda.synchronize()
    build.reset_launches()
    t = time.perf_counter()
    seqs = serve_lm.generate(lm, cfg, batch, n_gen, device)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    counts_gen = dict(build.launches)
    expect_launches(counts_gen, "decode loop", wkv6=per_forward * n_gen)
    if (tuple(seqs.shape) != (batch, n_gen + 1) or not bool((seqs[:, 0] == 1).all())
            or not bool(((seqs >= 0) & (seqs < cfg.vocab)).all())):
        raise AssertionError(f"generate: bad token ids {seqs[:, :8].tolist()}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms_token = 1e3 * gen_s / n_gen
    print(f"phase 15 rwkv6-7b [{card}]: full width and depth (32 layers, d_model 4096, 64 "
          f"heads x 64, d_ff 14336, vocab 65536, bf16), {n_params} parameters "
          f"({w_bytes / 1e9:.3f} GB) initialised on the card in {init_lm_s:.3f} s; prefill "
          f"(4, 512): {prefill_ms:.2f} ms = {batch * seq / prefill_ms * 1e3:.1f} tokens/s, "
          f"wkv6 launches {counts_prefill['wkv6']} == {per_forward}; generate B=4 x {n_gen} "
          f"tokens at temperature {serve_lm.TEMPERATURE}: {ms_token:.3f} ms/token = "
          f"{batch * n_gen / gen_s:.1f} tokens/s, {ms_token / floor_ms:.2f}x the "
          f"{floor_ms:.3f} ms HBM floor (weight bytes / 3.35 TB/s), wkv6 launches "
          f"{counts_gen['wkv6']} == {per_forward} x {n_gen}; peak memory {peak_gb:.3f} GB; "
          f"first sampled ids {seqs[0, :8].tolist()}")
    gemms = {"matmul": ("gemm", "gemv", "xmma", "cutlass", "nvjet", "splitk")}
    with torch.inference_mode():
        print(profile_breakdown(
            torch, build, lambda: model_lib.prefill_logits(lm, cfg, {"tokens": tokens}), 1,
            card, "phase 15 prefill (4, 512)", {"wkv6": ("wkv6_kernel", "wkv6")},
            groups=gemms, unit="forward"))
    print(profile_breakdown(
        torch, build, lambda: serve_lm.generate(lm, cfg, batch, 16, device), 16, card,
        "phase 15 decode loop", {"wkv6": ("wkv6_kernel", "wkv6")}, groups=gemms,
        unit="token"))

    # -- phase 16: decode == full forward at full width; reduced model card == CPU ----
    # Tolerance: the JAX package's own decode test's rtol = atol = 3e-2, in f32.
    # The deviation comes from summation order (GEMM shapes, wkv6's T), which
    # the 32 random layers amplify; in bf16 that amplified rounding alone is
    # larger than 3e-2 (`repro_torch.launch.rwkv_rounding` measures it, PERF.md).
    n_dec = 16
    del lm
    torch.cuda.empty_cache()
    with torch.inference_mode():
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        lm32 = model_lib.init_params(cfg32, torch.Generator(device=device).manual_seed(0),
                                     device=device)
        build.reset_launches()
        steps32, full32 = decode_vs_forward(lm32, cfg32, tokens, n_dec)
        torch.cuda.synchronize()
        counts_dec = dict(build.launches)
        del lm32
        torch.cuda.empty_cache()
    expect_launches(counts_dec, "f32 decode vs forward", wkv6=per_forward * (1 + n_dec))
    dev32 = (steps32 - full32).abs()
    if not bool(torch.isfinite(steps32).all()) or bool((dev32 > 3e-2 + 3e-2 * full32.abs()).any()):
        raise AssertionError(f"f32 decode != full forward at full width: {dev32.max().item()}")
    if bool((dev32[:, 0] > 1e-4 + 1e-4 * full32[:, 0].abs()).any()):
        raise AssertionError(f"f32 decode step 0 != forward position 0: {dev32[:, 0].max().item()}")
    print(f"phase 16 decode == full forward [{card}]: rwkv6-7b at full width, {n_dec} steps, "
          f"f32 weights: max |decode - forward| {dev32.max().item():.3e} (step 0: "
          f"{dev32[:, 0].max().item():.3e} <= 1e-4) within rtol = atol = 3e-2 (logits up "
          f"to {full32.abs().max().item():.3f}), wkv6 launches {counts_dec['wkv6']} == "
          f"{per_forward} x (1 + {n_dec})")
    small = dataclasses.replace(get_config("rwkv6_7b", reduced=True), dtype="float32")
    with torch.inference_mode():
        lm_cpu = model_lib.init_params(small, 0, device="cpu")
        lm_card = copy.deepcopy(lm_cpu).to(device)
        toks = torch.from_numpy(np.random.default_rng(2).integers(0, small.vocab, (2, 12)))
        on_card = model_lib.prefill_logits(lm_card, small, {"tokens": toks.to(device)}).cpu()
        on_cpu = model_lib.prefill_logits(lm_cpu, small, {"tokens": toks})
    if not torch.allclose(on_card, on_cpu, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"reduced f32 prefill: card != CPU, "
                             f"{(on_card - on_cpu).abs().max().item()}")
    seq_card = serve_lm.generate(lm_card, small, 4, 32, device).cpu()
    seq_cpu = serve_lm.generate(lm_cpu, small, 4, 32, "cpu")
    if not torch.equal(seq_card, seq_cpu):
        raise AssertionError("reduced f32 generate: card tokens != CPU tokens")
    print(f"phase 16 reduced rwkv6 [{card}]: f32, 2 layers d_model 128: prefill logits on the "
          f"card == CPU within 1e-4 (max |dev| {(on_card - on_cpu).abs().max().item():.3e}); "
          f"generate B=4 x 32 tokens equal on card and CPU")
    del lm_card
    torch.cuda.empty_cache()

    return {"err": err_w, "times": wkv_times, "prefill_launches": counts_prefill["wkv6"],
            "decode_launches": counts_gen["wkv6"]}


# 72 instructions a Threefry block (THREEFRY_OPS), ~4 cycles each in one
# thread's dependent chain (Hopper's integer ALU latency) at 1.98 GHz: the
# latency floor of a serial chain, whatever the issue rate
CHAIN_CYCLES_PER_INSTRUCTION = 4
CLOCK_HZ = 1.98e9
# instructions a monomer costs the HP contact scan (loads, the occupancy
# test and two Manhattan tests), and a flip its site arithmetic
HP_SCAN_OPS = 12
FLIP_SITE_OPS = 20


def bound_hp(work: dict, moves: int, n: int) -> tuple[float, str, float]:
    """Least time of ``hp_moves_kernel`` for the work its data needs: 6
    Threefry blocks a move (next key, site key, randint's two keys and two
    words), 5 more an end move (direction), 2 more a tested move (the
    uniform) and the chain scan of a move to a new site, at the issue rate;
    the bytes (chains in and out) are negligible.  Also returns the latency
    floor of one chain (ms): its blocks in series at
    ``CHAIN_CYCLES_PER_INSTRUCTION``, taking each replica as the average."""
    blocks = 6 * moves + 5 * work["ends"] + 2 * work["tested"]
    ops = blocks * THREEFRY_OPS + HP_SCAN_OPS * n * work["evaluated"]
    r = work["replicas"]
    chain = (blocks / r) * THREEFRY_OPS * CHAIN_CYCLES_PER_INSTRUCTION / CLOCK_HZ
    return 1e3 * ops / INT32_OPS_PER_S, "operations", 1e3 * chain


def bound_flips(r: int, flips: int) -> tuple[float, str, float]:
    """Least time of ``single_flip_kernel``: 10 Threefry blocks a flip (next
    key, site key, randint's two keys and four words, uniform key and word)
    and its site arithmetic, at the issue rate, against the lattice copy
    (read and written once, L^2 bytes a replica, counted by the caller);
    and one chain's latency floor (ms)."""
    ops = r * flips * (10 * THREEFRY_OPS + FLIP_SITE_OPS)
    chain = flips * 10 * THREEFRY_OPS * CHAIN_CYCLES_PER_INSTRUCTION / CLOCK_HZ
    return 1e3 * ops / INT32_OPS_PER_S, "operations", 1e3 * chain


def check_serial_chains(torch, np, sc, keys, device):
    """Phase 20: both serial-chain kernels == their plain versions on the
    card, bit for bit (states, ΔE, counts), over several launches each
    continuing the last; returns the number of cases."""
    from repro_torch.core.hp import HPChain

    rng = np.random.default_rng(200)
    n_cases = 0
    hp_cases = (("HPH", 13, 1.0), ("HHPPHPH", 64, 0.7), ("HPHPPHHPHH", 13, 1.0),
                ("HPHPPHHPHHPHPHHPPHPH", 1500, 1.0), ("HPHPPHHPHHPHPHHPPHPH", 7, 1.3))
    for seq, r, eps in hp_cases:
        chain = HPChain(seq, eps=eps)
        pos = chain.init_state_batched(keys.split(keys.key(int(rng.integers(1 << 30)),
                                                           device=device), r))
        betas = torch.from_numpy(rng.uniform(0.2, 3.0, r).astype(np.float32)).to(device)
        key = keys.key(int(rng.integers(1 << 30)), device=device)
        t = torch.tensor(int(rng.integers(1 << 20)), device=device)
        hmask = torch.tensor([c == "H" for c in seq], device=device)
        for _ in range(4):  # later launches start from folded chains
            got = sc.hp_moves_kernel(pos, key, t, betas, hmask=hmask, eps=eps, n_moves=len(seq))
            want = sc.hp_moves_plain(pos, key, t, betas, hmask=hmask, eps=eps,
                                     n_moves=len(seq))
            for g, w, what in zip(got, want, ("positions", "ΔE", "nacc")):
                if not torch.equal(g, w):
                    raise AssertionError(f"hp_moves N={len(seq)} R={r}: {what} != plain")
            pos, t = got[0], t + 1
        n_cases += 1
    flip_cases = ((5, 13, 1, "metropolis", 1.0, 0.0), (5, 13, 7, "glauber", 0.7, 0.3),
                  (7, 13, 300, "metropolis", 1.0, 0.3), (6, 64, 300, "glauber", 1.0, 0.0),
                  (301, 64, 300, "glauber", 1.0, 0.0), (300, 1500, 300, "glauber", 1.0, 0.0),
                  (300, 1500, 7, "metropolis", 0.7, 0.3))
    for length, r, flips, rule, j, b in flip_cases:
        spins = torch.from_numpy(rng.choice(np.array([-1, 1], np.int8),
                                            size=(r, length, length))).to(device)
        betas = torch.from_numpy(rng.uniform(0.2, 2.0, r).astype(np.float32)).to(device)
        key = keys.key(int(rng.integers(1 << 30)), device=device)
        t = torch.tensor(int(rng.integers(1 << 20)), device=device)
        for _ in range(2):
            kw = dict(j=j, b=b, rule=rule, flips=flips)
            got = sc.single_flip_kernel(spins, key, t, betas, **kw)
            want = sc.single_flip_plain(spins, key, t, betas, **kw)
            for g, w, what in zip(got, want, ("spins", "ΔE", "nacc")):
                if not torch.equal(g, w):
                    raise AssertionError(f"single_flip L={length} R={r} flips={flips} "
                                         f"{rule}: {what} != plain")
            spins, t = got[0], t + 1
        n_cases += 1
    torch.cuda.synchronize()
    return n_cases, len(hp_cases), len(flip_cases)


def time_serial_chains(torch, np, sc, keys, device, seq: str):
    """Each serial-chain kernel at its path's full width beside its plain
    version (CUDA events): HP ``seq`` at R=1500 (N moves), single_flip at
    L=300 R=1500, 300 flips."""
    from repro_torch.core.hp import HPChain

    r = 1500
    out = {}
    chain = HPChain(seq)
    pos = chain.init_state_batched(keys.split(keys.key(7, device=device), r))
    betas = torch.linspace(1 / 0.6, 1 / 3.4, r, device=device)
    key, t = keys.key(3, device=device), torch.tensor(5, device=device)
    hmask = torch.tensor([c == "H" for c in seq], device=device)
    n = len(seq)
    for _ in range(20):  # fold the rods first: the work of a chain in its run
        pos = sc.hp_moves_kernel(pos, key, t, betas, hmask=hmask, eps=1.0, n_moves=n)[0]
        t = t + 1
    kw = dict(hmask=hmask, eps=1.0, n_moves=n)
    work = {"replicas": r}
    sc.hp_moves_plain(pos, key, t, betas, work=work, **kw)
    work = {k: int(v) for k, v in work.items()}
    ms = cuda_ms(torch, lambda: sc.hp_moves_kernel(pos, key, t, betas, **kw), 50, 3)
    dev_ms, _ = profiler_ms(torch, lambda: sc.hp_moves_kernel(pos, key, t, betas, **kw), 20,
                            "hp_moves_kernel")
    plain = cuda_ms(torch, lambda: sc.hp_moves_plain(pos, key, t, betas, **kw), 2)
    bound, by, floor = bound_hp(work, r * n, n)
    out["hp_moves"] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain, "bound": (bound, by),
                       "latency_floor": floor, "work": work}
    length, flips = 300, 300
    spins = torch.from_numpy(np.random.default_rng(9).choice(
        np.array([-1, 1], np.int8), size=(r, length, length))).to(device)
    kw = dict(j=1.0, b=0.0, rule="glauber", flips=flips)
    ms = cuda_ms(torch, lambda: sc.single_flip_kernel(spins, key, t, betas, **kw), 20, 2)
    dev_ms, _ = profiler_ms(torch, lambda: sc.single_flip_kernel(spins, key, t, betas, **kw),
                            10, "single_flip_kernel")
    plain = cuda_ms(torch, lambda: sc.single_flip_plain(spins, key, t, betas, **kw), 1)
    bound, by, floor = bound_flips(r, flips)
    t_bytes = 2.0 * r * length * length / HBM_BYTES_PER_S * 1e3
    if t_bytes > bound:
        bound, by = t_bytes, "bytes"
    out["single_flip"] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain,
                          "bound": (bound, by), "latency_floor": floor}
    return out


def zoo_phases(torch, np, build, keys, sc, api, device, card) -> dict:
    """Phase 20: the rest of the system zoo on the card.

    The two serial-chain kernels against their plain versions; the EA spin
    glass (the paper's widths, 300x300 R=1500, per-sweep path, temp and
    state mode), HP on the 20-mer of ``benchmarks/systems_bench.py`` at
    R=1500, Ising ``single_flip`` at L=300 R=1500 (300 flips a step) and the
    Gaussian mixture at R=1500 through ``Session``, each with its launches
    counted from 0 just before its run; the zoo's EA, Gaussian and HP
    conformance entries at their full schedules; small specs of the four
    paths on the card against the CPU.  Returns the kernel rows' numbers.
    """
    from repro_torch.core.systems import REGISTRY
    from repro_torch.validate import assert_conforms, run_conformance

    AdaptSpec, EngineSpec, LadderSpec = api.AdaptSpec, api.EngineSpec, api.LadderSpec
    PhaseSpec, RunSpec, ScheduleSpec = api.PhaseSpec, api.RunSpec, api.ScheduleSpec
    Session, SystemSpec = api.Session, api.SystemSpec
    build.reset_launches()
    n_cases, n_hp, n_flip = check_serial_chains(torch, np, sc, keys, device)
    expect_launches(counts_now(build), "phase 20 kernel checks", hp_moves=4 * n_hp,
                    single_flip=2 * n_flip)
    print(f"phase 20 serial chains: {n_cases} cases equal to plain bit for bit (positions / "
          f"spins, ΔE, nacc): hp_moves at N = 3, 7, 10, 20 (R up to 1500, eps 0.7-1.3, 4 "
          f"launches each from folded chains), single_flip at L = 5, 6, 7, 300, 301 (R up "
          f"to 1500; 1, 7 and 300 flips; metropolis and glauber; j=0.7 b=0.3 too)")
    seq20 = "HPHPPHHPHHPHPHHPPHPH"  # benchmarks/systems_bench.py
    times = time_serial_chains(torch, np, sc, keys, device, seq20)
    for name, tm in times.items():
        print(f"phase 20 times [{card}]: {name} {tm['ms']:.4f} ms by CUDA events (the "
              f"wrapper's host time included), {tm['device_ms']:.4f} ms device time "
              f"(profiler), vs plain "
              f"{tm['plain_ms']:.4f} ms (bound {tm['bound'][0]:.5f} ms, {tm['bound'][1]}; one "
              f"chain's latency floor {tm['latency_floor']:.4f} ms)"
              + (f", work {tm['work']}" if "work" in tm else ""))

    n_rep, interval = 1500, 100
    ladder = LadderSpec(kind="paper", n_replicas=n_rep, t_min=1.0, t_max=4.0)

    def run_path(what, system, observables, n_sweeps, want, swap_mode="temp",
                 ladder_spec=ladder):
        spec = RunSpec(system=system, ladder=ladder_spec,
                       engine=EngineSpec(swap_interval=interval, chunk_intervals=1,
                                         swap_mode=swap_mode),
                       schedule=ScheduleSpec(phases=(PhaseSpec(name="run",
                                                               n_sweeps=n_sweeps),)),
                       observables=observables, seed=0)
        session = Session(spec, device="cuda")
        session.state = session.init_state()
        torch.cuda.synchronize()
        build.reset_launches()
        t = time.perf_counter()
        result = session.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = counts_now(build)
        expect_launches(counts, what, **want)
        st = result.state.pt
        n_int = n_sweeps // interval
        energy = session.engine.system.batched_energy(st.states)
        exact = system.name != "gaussian"  # integer energies: exact sums
        if exact and not torch.equal(st.energy, energy):
            raise AssertionError(f"{what}: incremental energy != recomputed energy")
        if not exact and not torch.allclose(st.energy, energy, rtol=1e-4, atol=1e-3):
            raise AssertionError(f"{what}: incremental energy drifted")
        if sorted(st.rung.cpu().tolist()) != list(range(n_rep)) or int(st.t) != n_sweeps:
            raise AssertionError(f"{what}: bad rung map or sweep counter")
        if swap_mode == "state" and st.rung.cpu().tolist() != list(range(n_rep)):
            raise AssertionError(f"{what}: rungs moved in state mode")
        for k, v in result.phases["run"].summary.items():
            if not np.all(np.isfinite(v)):
                raise AssertionError(f"{what}: non-finite summary {k}")
        acc = float(np.mean(result.phases["run"].summary["swap_acceptance"]))
        return {"ms": 1e3 * wall / n_int, "counts": counts, "n_int": n_int, "acc": acc,
                "session": session}

    ea = SystemSpec("ea_spin_glass", {"shape": (300, 300), "disorder_seed": 1,
                                      "accept_rule": "glauber"})
    paths = {}
    for mode in ("temp", "state"):
        paths[f"EA {mode}"] = run_path(f"EA 300x300 {mode} mode", ea, ("absmag",), 200,
                                       {"jax_uniform": 200}, swap_mode=mode)
    paths["HP"] = run_path("HP 20-mer", SystemSpec("hp_protein", {"sequence": seq20}),
                           ("rg2",), 200, {"hp_moves": 200},
                           ladder_spec=LadderSpec(kind="geometric", n_replicas=n_rep, t_min=0.3,
                                            t_max=3.4))
    paths["single_flip"] = run_path(
        "Ising single_flip L=300", SystemSpec("ising", {
            "length": 300, "update": "single_flip", "flips_per_step": 300,
            "accept_rule": "glauber"}), ("absmag",), 100, {"single_flip": 100})
    paths["Gaussian"] = run_path(
        "Gaussian mixture", SystemSpec("gaussian", dict(REGISTRY["gaussian"].params)),
        ("absx", "x"), 200, {}, ladder_spec=LadderSpec(kind="geometric", n_replicas=n_rep,
                                                       t_min=1.0, t_max=10.0))
    print(f"phase 20 zoo at full width [{card}]: Session R=1500, S=100, ms/interval (first "
          "run in this process, Session.run, host clock): " + "; ".join(
              f"{k} {v['ms']:.2f} ({v['n_int']} intervals, launches "
              f"{ {n: c for n, c in v['counts'].items() if c} }, mean swap acceptance "
              f"{v['acc']:.4f})" for k, v in paths.items())
          + "; EA 300x300 (135 MB of spins, 1.08 GB of coupling planes, 1.08 GB of uniforms "
          "a sweep): kernel #1 launched 0 times, jax_uniform once a sweep; every incremental "
          "energy == its recomputed energy (the Gaussian's within 1e-4)")
    for what, sub, key in (("EA temp", None, "jax_uniform"), ("HP", "hp_moves_kernel",
                                                               "hp_moves")):
        session = paths[what]["session"]
        kernels = ({"jax_uniform": ("jax_uniform_kernel", "jax_uniform")} if sub is None
                   else {"hp_moves": (sub, key)})
        for _ in range(2):  # once more if the profiler lost a launch
            session.state = session.init_state()
            torch.cuda.synchronize()
            line = profile_breakdown(torch, build, session.run, paths[what]["n_int"], card,
                                     f"phase 20 {what}", kernels)
            if "not measured" not in line:
                break
        print(line)
    for v in paths.values():
        del v["session"]
    torch.cuda.empty_cache()

    conf = {}
    for name in ("ea_spin_glass", "gaussian", "hp_protein"):
        entry = REGISTRY[name]
        build.reset_launches()
        t = time.perf_counter()
        report = run_conformance(entry, seed=0, device="cuda")
        wall_c = time.perf_counter() - t
        counts = counts_now(build)
        sweeps = entry.n_chains * (entry.burn_sweeps + entry.n_batches * entry.sweeps_per_batch)
        want = {"ea_spin_glass": {"jax_uniform": sweeps}, "gaussian": {},
                "hp_protein": {"hp_moves": sweeps}}[name]
        expect_launches(counts, f"conformance {name}", **want)
        assert_conforms(report, z_max=4.0, geweke_max=4.0)
        if report.n_retunes != entry.adapt_rounds:
            raise AssertionError(f"conformance {name}: {report.n_retunes} retunes")
        conf[name] = (report, wall_c, counts)
    print(f"phase 20 conformance [{card}]: the zoo's entries at full schedule on the card, "
          "assert_conforms(z_max=4, geweke_max=4): " + "; ".join(
              f"{name} in {w:.2f} s, {r.n_batches} batch means, {r.n_retunes} retunes, worst "
              f"|z| {r.worst()[1]:.3f} ({r.worst()[0]}), max |geweke| "
              f"{max(float(np.abs(g).max()) for g in r.geweke.values()):.3f}, launches "
              f"{ {k: v for k, v in c.items() if v} }" for name, (r, w, c) in conf.items()))

    small = {
        "EA": (SystemSpec("ea_spin_glass", {"shape": (4, 6), "disorder_seed": 2,
                                            "accept_rule": "glauber"}), ("absmag",), "temp"),
        "EA state mode": (SystemSpec("ea_spin_glass", {"shape": (4, 4), "disorder_seed": 1}),
                          ("absmag",), "state"),
        "HP": (SystemSpec("hp_protein", {"sequence": "HPHPPHHPHH"}), ("rg2",), "temp"),
        "single_flip": (SystemSpec("ising", {"length": 5, "update": "single_flip",
                                             "flips_per_step": 7,
                                             "accept_rule": "glauber"}), ("absmag",), "temp"),
        "Gaussian": (SystemSpec("gaussian", dict(REGISTRY["gaussian"].params)), ("absx",),
                     "temp"),
    }
    for what, (system, obs, mode) in small.items():
        spec = RunSpec(
            system=system, ladder=LadderSpec(kind="geometric", n_replicas=6, t_min=0.8,
                                             t_max=4.0),
            engine=EngineSpec(swap_interval=5, chunk_intervals=4, swap_mode=mode),
            adapt=AdaptSpec(target=0.3, min_attempts_per_pair=3, max_rounds=2),
            schedule=ScheduleSpec(phases=(PhaseSpec(name="burn", n_sweeps=100, adapt=True),
                                          PhaseSpec(name="measure", n_sweeps=100,
                                                    reset_stats=True))),
            observables=obs, seed=3)
        on_card = Session(spec, device="cuda").run().manifest()
        on_cpu = Session(spec, device="cpu").run().manifest()
        if what == "Gaussian":  # exp/log on the card and the CPU differ in ulps
            for name in on_card["phases"]:
                got = on_card["phases"][name]["summary"]
                want = on_cpu["phases"][name]["summary"]
                for key in ("swap_attempts", "swap_acceptance", "round_trips"):
                    if got[key] != want[key]:
                        raise AssertionError(f"small Gaussian spec: card != CPU in {key}")
                if not np.allclose(got["mean_energy"], want["mean_energy"], rtol=1e-5,
                                   atol=1e-5):
                    raise AssertionError("small Gaussian spec: mean energy card != CPU")
            if not np.allclose(on_card["final"]["energy"], on_cpu["final"]["energy"],
                               rtol=1e-5, atol=1e-5):
                raise AssertionError("small Gaussian spec: final energies card != CPU")
        else:
            manifests_equal(on_card, on_cpu, f"small {what} spec")
    print(f"phase 20 card == CPU [{card}]: R=6 specs of EA 4x6 (and 4x4 in state mode), HP "
          "N=10, Ising single_flip L=5 (7 flips) and the Gaussian, 100 burn (adapt) + 100 "
          "measure sweeps: equal manifests (the Gaussian's energies within 1e-5: the card's "
          "and the CPU's exp and log differ in ulps)")
    return {"times": times, "paths": paths,
            "conformance_launches": conf["hp_protein"][2]["hp_moves"]}


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

    from repro_torch import api
    from repro_torch import checkpoint as ckpt
    from repro_torch.api import (
        AdaptSpec, EngineSpec, ExchangeSpec, LadderSpec, PhaseSpec, RunSpec, ScheduleSpec,
        Session, SystemSpec,
    )
    from repro_torch.exchange import make_strategy
    from repro_torch.core import keys
    from repro_torch.core.systems import REGISTRY
    from repro_torch.engine.driver import make_interval_step
    from repro_torch.engine.stats import chain_slice, update_stats
    from repro_torch.kernels import build, prng, ref
    from repro_torch.validate import assert_conforms, run_conformance
    from repro_torch.kernels import ising_sweep as isk
    from repro_torch.kernels import jax_uniform as ju
    from repro_torch.kernels import potts_sweep as pk
    from repro_torch.kernels import serial_chain as sc
    from repro_torch.launch import fused_probe

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
        # the row walk's edges: smallest lattices, sides no multiple of 32,
        # near the shared-memory limit; R=13 is a multiple of nothing
        for length, sweeps in ((2, 5), (4, 5), (30, 4), (66, 4), (470, 3)):
            cases += [(length, 13, sweeps, 1.0, 0.0, rule), (length, 13, sweeps, 0.7, 0.3, rule)]
    err_a = check_kernel_a(torch, np, isk, keys, cases, device)
    print(f"phase 2 kernel A: {len(cases)} cases equal to plain (spins, nacc; "
          f"ΔE exact at j=1,b=0, <= 4 ulps otherwise), max |ΔE err| {err_a}")

    # -- phase 3: the round exchange against its plain version --------------
    build.reset_launches()
    err_b, n_prob_diff = check_round_exchange(torch, isk, pk, prng,
                                              list(fused_probe.exchange_cases(device)))
    expect_launches(counts_now(build), "phase 3", ising_fused=32, ising_packed=32,
                    potts_fused=32, exchange=96)
    check_tickets(build, "phase 3")
    print(f"phase 3 round exchange: 32 exchanges at R=1500 through round launches of "
          f"kernels A, #2p and #5 (S=0), rows equal across the three and to plain (rung, "
          f"energy, attempt; accept and prob but inside the u ulp gap), prob max |err| "
          f"{err_b}, {n_prob_diff} prob differences, one exchange per launch")
    build.reset_launches()
    full = check_rounds_at_full_width(torch, np, isk, pk, keys, prng, device)
    expect_launches(counts_now(build), "phase 3 full width", ising_fused=1, ising_packed=1,
                    potts_fused=1, exchange=3)
    check_tickets(build, "phase 3 full width")
    err_b = max(err_b, *(e for *_, e in full))
    print("phase 3 round launches at full width: L=300 R=1500 S=2 (A, #2p) and 300x300 q=3 "
          "(#5), permuted rung, every output in place, equal to the plain sweeps + "
          "exchange_plain (spins, nacc, energy', attempt; rung', accept and prob but inside "
          "the u ulp gap): " + "; ".join(
              f"{name} {x} {n_acc} swaps accepted, {n_diff} prob differences, max |dp| {e}"
              for name, x, n_acc, n_diff, e in full))

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
    b_plain_ms = cuda_ms(torch, lambda: isk.exchange_plain(rung_b, energy_b, de_b, betas_b, words, ph, **xw), 50)
    b_bound, b_by = bound_threefry(rb + 3, 30.0 * rb)
    # the exchange's tail: a round launch less the same launch without it,
    # at short rounds (L=32, S=1) and at the main path's S=2
    spins32 = torch.from_numpy(rng.choice(np.array([-1, 1], np.int8), size=(rb, 32, 32))).to(device)
    tails = {}
    for what, st, n_sw, reps in (("L=32 R=1500 S=1", spins32, 1, 200),
                                 ("L=300 R=1500 S=2", spins, s2, 20)):
        tails[what] = round_tail(torch, isk, st, words, t0d, betas_b, rung_b, energy_b,
                                 n_sw, reps)
    del spins32
    check_tickets(build, "phase 3 times")
    b_ms = tails["L=32 R=1500 S=1"][0] - tails["L=32 R=1500 S=1"][1]
    print(f"phase 3 times [{card}]: kernel A {a_ms:.4f} ms vs plain {a_plain_ms:.4f} ms "
          f"(L=300 R=1500 S=2, bound {a_bound:.5f} ms by {a_by}); round exchange tail "
          + "; ".join(f"{what}: round launch {rd:.5f} ms, sweeps alone {sw:.5f} ms, tail "
                      f"{rd - sw:.5f} ms" for what, (rd, sw) in tails.items())
          + f" (profiler device time, lower of two turns each); plain exchange "
          f"{b_plain_ms:.4f} ms (R=1500, bound {b_bound:.6f} ms by {b_by}); library_ms: none")

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
        counts = counts_now(build)
        check_tickets(build, what)
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
    # one launch a round, which runs the round's exchange
    expect_launches(counts_round, "round path", ising_fused=n_int, exchange=n_int)
    manifest_round = result.manifest()
    retunes = len(result.phases["burn"].ladder_history) - 1
    acc = result.phases["measure"].summary["swap_acceptance"]
    # per-kernel device time at the main path's shapes (not counted launches)
    st = result.state.pt
    a_main = cuda_ms(torch, lambda: isk.ising_sweep_fused_kernel(
        st.states, st.key, st.t, result.state.betas, st.rung, n_sweeps=interval,
        rule="glauber"), 2)
    round_main = cuda_ms(torch, lambda: isk.ising_round_kernel(
        st.states, st.key, st.t, st.phase, result.state.betas, st.rung, st.energy,
        n_sweeps=interval, rule="glauber", **xw), 2)
    a_main_bound, _ = bound_threefry(n_rep * length * length * interval,
                                     2.0 * n_rep * length * length)
    sweeps = spec_round.schedule.total_sweeps
    print(f"phase 4 main path [{card}]: Session L=300 R=1500 round path, "
          f"init {init_s:.3f} s, then {sweeps} sweeps in {wall:.3f} s = "
          f"{sweeps / wall:.2f} sweeps/s "
          f"({sweeps * n_rep / wall:.1f} replica-sweeps/s), "
          f"{1e3 * wall / n_int:.2f} ms/interval, launches A {counts_round['ising_fused']} "
          f"and exchanges {counts_round['exchange']} == {n_int} intervals, {retunes} retunes, "
          f"mean swap acceptance {float(np.mean(acc)):.4f}; kernel A {a_main:.3f} ms/launch "
          f"(S=100, bound {a_main_bound:.3f} ms), a round launch (A + exchange) "
          f"{round_main:.3f} ms; energy == lattice_energy exactly; library_ms: none")
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
                            {"kernel A": ("ising_fused_kernel", "ising_fused")}))
    check_tickets(build, "phase 4")

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
    check_tickets(build, "phase 5")
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
    check_tickets(build, "phase 5 small spec")
    print(f"phase 5 fused path [{card}]: {spec_fused.schedule.total_sweeps} sweeps "
          f"in {wall_f:.3f} s, launches A {counts_fused['ising_fused']} == "
          f"{n_int_f} intervals; small spec (L=8 R=8, round path) equal on card and CPU")

    # -- phase 6: kernels #1, #4, #5 and jax_uniform against plain -------------
    errs = check_sweep_kernels(torch, np, isk, pk, ju, ref, prng, keys, device)
    print(f"phase 6 kernels #1, #4, #5, jax_uniform: equal to plain at L=300 R=1500 "
          f"and 3 smaller cases each, #5 also in 24 walk-edge cases (spins/colours, nacc; "
          f"ΔE exact at j=1, <= 4 ulps otherwise; uniforms bit-equal), max |ΔE err| {errs}")
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
                            {"kernel #5": ("potts_fused_kernel", "potts_fused")}))
    check_tickets(build, "phase 8")

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
    check_tickets(build, "phase 9")
    print(f"phase 9 card == CPU [{card}]: examples/specs/ising_small.json (per-sweep path) "
          "and a 6x4 q=3 R=6 Potts spec on its per-sweep, fused and round paths")

    # -- phase 10: kernel #2p against its plain version and kernel A -----------
    packed_cases = [(300, 1500, 2, 1.0, 0.0, "glauber"), (300, 1500, 2, 0.7, 0.3, "glauber"),
                    (8, 5, 3, 1.0, 0.0, "glauber"), (30, 13, 4, 0.7, 0.3, "metropolis"),
                    (64, 33, 6, 1.0, 0.3, "glauber")]
    for rule in ("metropolis", "glauber"):  # phase 2's row-walk edges
        for side, n_sw in ((2, 5), (4, 5), (30, 4), (66, 4), (470, 3)):
            packed_cases += [(side, 13, n_sw, 1.0, 0.0, rule), (side, 13, n_sw, 0.7, 0.3, rule)]
    err_p = check_packed(torch, np, isk, keys, packed_cases, device)
    blocks, threads, group = isk.packed_launch_shape(n_rep, length)
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
    def balanced(fn):
        return lambda: fn(spins, words, t0d, betas_bal, rung_bal, **main_kw)

    # in turns: A, #2p, #2p, A
    a_bal = cuda_ms(torch, balanced(isk.ising_sweep_fused_kernel), 3)
    p_bal = cuda_ms(torch, balanced(isk.ising_sweep_packed_kernel), 3)
    p_bal2 = cuda_ms(torch, balanced(isk.ising_sweep_packed_kernel), 3)
    a_bal2 = cuda_ms(torch, balanced(isk.ising_sweep_fused_kernel), 3)
    bal_group = isk.packed_launch_shape(r_bal, length)[2]
    del spins
    torch.cuda.empty_cache()
    print(f"phase 10 kernel #2p: {len(packed_cases)} cases equal to kernel A (spins, nacc "
          f"and ΔE bit for bit, at its default group width and at 1, 3 and 8 a block) and "
          f"to plain (spins, nacc; ΔE exact at j=1,b=0, <= 4 ulps otherwise), max |ΔE err| "
          f"vs plain {err_p}")
    print(f"phase 10 times [{card}]: L=300 R=1500 S=2: kernel #2p {p_ms:.4f} ms "
          f"({blocks} blocks of {group} replicas x {threads} threads on {n_sms} SMs), "
          f"{p8_ms:.4f} ms at 8 a block ({-(-n_rep // 8)} blocks), kernel A {a_ms2:.4f} ms, "
          f"plain {p_plain_ms:.4f} ms, bound {a_bound:.5f} ms by {a_by}; S=100: #2p "
          f"{p_main:.3f} ms, at 8 a block {p8_main:.3f} ms, kernel A {a_main2:.3f} / "
          f"{a_main3:.3f} ms (before / after), bound {a_main_bound:.3f} ms; R={r_bal} "
          f"S=100 (16 replicas on every SM for both): #2p at {bal_group} a block {p_bal:.3f} / "
          f"{p_bal2:.3f} ms vs kernel A {a_bal:.3f} / {a_bal2:.3f} ms (in turns); "
          f"library_ms: none")

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
                            {"kernel #2p": ("ising_packed_kernel", "ising_packed")}))
    check_tickets(build, "phase 11")
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
    counts_chains = counts_now(build)
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
    check_tickets(build, "phase 12")
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
    counts_conf = counts_now(build)
    # one launch of #2p a round, per chain, each running the round's exchange
    conf_rounds = entry.n_chains * (entry.burn_sweeps + entry.n_batches
                                    * entry.sweeps_per_batch) // entry.swap_interval
    expect_launches(counts_conf, "conformance", ising_packed=conf_rounds, exchange=conf_rounds)
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
    check_tickets(build, "phase 13")
    print(f"phase 13 conformance [{card}]: ising 4x4 R=5 n_chains=2 round path + pack_bits, "
          f"{entry.burn_sweeps + entry.n_batches * entry.sweeps_per_batch} sweeps per chain "
          f"in {wall_v:.2f} s, launches { {k: v for k, v in counts_conf.items() if v} }, "
          f"{report.n_batches} batch means, {report.n_retunes} retunes, worst |z| "
          f"{worst_z:.3f} ({worst_series}) <= 4, max |geweke| "
          f"{max(float(np.abs(g).max()) for g in report.geweke.values()):.3f} <= 4; the "
          f"fused path (validate --fused) in {wall_vf:.2f} s, worst |z| "
          f"{fused_report.worst()[1]:.3f} ({fused_report.worst()[0]}) <= 4; short "
          "entry report equal on card and CPU")

    rw = rwkv_phases(torch, np, build, ref, device, card)

    # -- phase 17: checkpoint and resume, bit-equal to an uninterrupted run ------
    spec_resume = RunSpec(
        system=SystemSpec("ising", {**params, "use_fused_round": True}),
        schedule=ScheduleSpec(phases=(
            PhaseSpec(name="burn", n_sweeps=200, adapt=True),
            PhaseSpec(name="measure", n_sweeps=200, reset_stats=True),
        )),
        **base,
    )
    resume_main = resume_equals_uninterrupted(torch, np, build, api, ckpt, spec_resume, 300,
                                              "resume round path", "ising_fused")
    print(f"phase 17 resume [{card}]: Session L=300 R=1500 S=100 round path, 200 burn "
          f"(adapt) + 200 measure, a checkpoint every chunk, stopped at sweep 300 and "
          f"finished by Session.from_checkpoint: every engine-state leaf (spins, rung, "
          f"energy, key words, t, phase, stats) and the f64 ladder equal to the "
          f"uninterrupted run bit for bit; resumed launches "
          f"{ {k: v for k, v in resume_main['counts'].items() if v} } == "
          f"{resume_main['n_int']} rounds, tickets 0; checkpoint {resume_main['bytes']} "
          f"bytes, one save {resume_main['save_s']:.3f} s, from_checkpoint "
          f"{resume_main['restore_s']:.3f} s")
    spec_resume_p = RunSpec.from_json({**json.loads(spec_resume.to_json()), "system": {
        "name": "ising", "params": {**params, "length": 64, "use_fused_round": True,
                                    "pack_bits": True}}})
    resume_packed = resume_equals_uninterrupted(torch, np, build, api, ckpt, spec_resume_p,
                                                300, "resume packed round path",
                                                "ising_packed")
    potts_round_small = RunSpec(
        system=SystemSpec("potts", {"shape": (6, 4), "q": 3, "accept_rule": "glauber",
                                    "use_fused": True, "use_fused_round": True}),
        ladder=LadderSpec(kind="geometric", n_replicas=6, t_min=0.7, t_max=2.9),
        engine=EngineSpec(swap_interval=5, chunk_intervals=4),
        adapt=AdaptSpec(target=0.3, min_attempts_per_pair=3, max_rounds=2),
        schedule=ScheduleSpec(phases=(
            PhaseSpec(name="burn", n_sweeps=100, adapt=True),
            PhaseSpec(name="measure", n_sweeps=100, reset_stats=True),
        )),
        observables=("pmag",), seed=3,
    )

    def resumed_on_card(spec, stop):
        with tempfile.TemporaryDirectory() as d:
            Session(spec, device="cuda", callbacks=[
                api.CheckpointCallback(d),
                api.EarlyStopCallback(lambda i: int(i.state.pt.t.reshape(-1)[0].item()) >= stop),
            ]).run()
            return Session.from_checkpoint(d, device="cuda").run().manifest()

    manifests_equal(resumed_on_card(potts_round_small, 140),
                    Session(potts_round_small, device="cpu").run().manifest(),
                    "small Potts round spec resumed mid-measure")
    check_tickets(build, "phase 17")
    print(f"phase 17 resume [{card}]: the packed round path (#2p) at L=64 R=1500, the same "
          f"schedule: equal bit for bit, launches "
          f"{ {k: v for k, v in resume_packed['counts'].items() if v} }; a 6x4 q=3 R=6 Potts "
          "round spec stopped at sweep 140 (mid-measure) and resumed on the card == its "
          "uninterrupted CPU run")

    # -- phase 18: the exchange strategies and state mode at full width ---------
    run200 = ScheduleSpec(phases=(PhaseSpec(name="run", n_sweeps=200),))
    per_sweep = {"length": length, "accept_rule": "glauber"}
    eng1 = dict(swap_interval=interval, chunk_intervals=1)
    strategy_runs = (
        ("SEO", params, EngineSpec(**eng1), ExchangeSpec("seo")),
        ("windowed (4)", params, EngineSpec(**eng1), ExchangeSpec("windowed", 4)),
        ("VMPT", params, EngineSpec(**eng1), ExchangeSpec("vmpt")),
        ("DEO swap_mode=state", params, EngineSpec(**eng1, swap_mode="state"), ExchangeSpec()),
        ("per-sweep DEO swap_mode=state", per_sweep, EngineSpec(**eng1, swap_mode="state"),
         ExchangeSpec()),
    )
    strategy_ms, counts_strategy = {}, {}
    for what, sys_params, eng, ex in strategy_runs:
        spec = RunSpec(system=SystemSpec("ising", sys_params), engine=eng, exchange=ex,
                       schedule=run200, ladder=base["ladder"],
                       observables=base["observables"], seed=0)
        result, counts_x, wall_x, n_int_x, _ = drive(spec, what)
        if "per-sweep" in what:
            expect_launches(counts_x, what, jax_uniform=200, ising_sweep=200)
        else:
            expect_launches(counts_x, what, ising_fused=n_int_x)
        if eng.swap_mode == "state" and not torch.equal(
                result.state.pt.rung, torch.arange(n_rep, dtype=torch.int32, device=device)):
            raise AssertionError(f"{what}: rungs moved in state mode")
        del result
        warm = check_no_host_sync(torch, Session(spec, device="cuda"), make_interval_step,
                                  update_stats, 3)
        strategy_ms[what] = (1e3 * wall_x / n_int_x, 1e3 * warm / 3)
        counts_strategy[what] = counts_x
        torch.cuda.empty_cache()
    check_tickets(build, "phase 18")
    print(f"phase 18 strategies [{card}]: Session L=300 R=1500 S=100, 2 intervals each "
          "(kernel A + the strategy in torch; the last on #1 + jax_uniform): every rung map "
          "a permutation (the identity in state mode), incremental energy == lattice energy "
          "exactly, 3 more intervals with no host sync; ms/interval (first 2 through "
          "Session, then 3 warm): " + "; ".join(
              f"{what} {a:.2f} / {b:.2f}" for what, (a, b) in strategy_ms.items()))
    k1 = keys.key(1, device=device)
    propose_ms = {}
    for name, prm in (("deo", {}), ("seo", {}), ("windowed", {"window": 4})):
        strat = make_strategy(name, prm)
        for ph in range(2):
            p = strat.propose_pairs(k1, torch.tensor(ph, device=device), n_rep)
            if not torch.equal(p[p], torch.arange(n_rep, device=device)):
                raise AssertionError(f"{name}: proposal is not an involution")
        phase_t = torch.zeros((), dtype=torch.int64, device=device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(20):
            strat.propose_pairs(k1, phase_t, n_rep)
        torch.cuda.synchronize()
        propose_ms[name] = 1e3 * (time.perf_counter() - t) / 20
    print(f"phase 18 proposals [{card}]: R=1500, wall ms a call (host clock, 20 calls, "
          "synchronised): " + ", ".join(f"{k} {v:.3f}" for k, v in propose_ms.items())
          + " (windowed: 750 windows of both tilings in one batch)")

    # -- phase 19: card == CPU on small specs ----------------------------------------
    small_fused = json.loads(small.to_json())
    small_fused["system"]["params"]["use_fused_round"] = False
    small_cases = {
        "SEO": {"exchange": {"strategy": "seo"}},
        "windowed (4)": {"exchange": {"strategy": "windowed", "window": 4}},
        "VMPT": {"exchange": {"strategy": "vmpt"}},
        "swap_mode=state": {"engine": {**small_fused["engine"], "swap_mode": "state"}},
        "per-sweep swap_mode=state": {
            "engine": {**small_fused["engine"], "swap_mode": "state"},
            "system": {"name": "ising", "params": {"length": 8, "accept_rule": "glauber"}}},
        "flow adaptation": {
            "ladder": {"kind": "geometric", "n_replicas": 8, "t_min": 1.0, "t_max": 4.0},
            "adapt": {"mode": "flow", "rate": 0.5, "flow_min_visits": 10, "max_rounds": 2},
            "schedule": {"phases": [{"name": "burn", "n_sweeps": 400, "adapt": True},
                                    {"name": "measure", "n_sweeps": 200,
                                     "reset_stats": True}]}},
    }
    for what, edits in small_cases.items():
        m = card_equals_cpu(Session, RunSpec.from_json({**small_fused, **edits}),
                            f"small spec, {what}", mean_rtol=1e-6 if what == "VMPT" else 0.0)
        if what == "flow adaptation" and len(m["phases"]["burn"]["ladder_history"]) < 2:
            raise AssertionError("small flow spec: no retune")
    manifests_equal(resumed_on_card(small, 600), Session(small, device="cpu").run().manifest(),
                    "small round spec resumed mid-measure")
    check_tickets(build, "phase 19")
    print(f"phase 19 card == CPU [{card}]: L=8 R=8 fused-path specs with SEO, windowed (4), "
          "VMPT (mean energy within 1e-6 relative: swap probabilities weight it), state mode "
          "(fused and per-sweep) and flow adaptation (retuned), and the round spec stopped "
          "at sweep 600 and resumed on the card: equal manifests")

    # -- phase 20: the rest of the system zoo ----------------------------------
    zoo = zoo_phases(torch, np, build, keys, sc, api, device, card)
    check_tickets(build, "phase 20")

    # -- phase 21: kernel summary ---------------------------------------------
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
         "fused_path_launches": counts_fused["ising_fused"],
         "resume_launches": resume_main["counts"]["ising_fused"],
         "strategy_path_launches": {what: c["ising_fused"] for what, c in
                                    counts_strategy.items() if "per-sweep" not in what}},
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
         "balanced_r": r_bal, "balanced_main_ms": min(p_bal, p_bal2),
         "balanced_kernel_a_main_ms": min(a_bal, a_bal2),
         "fused_path_launches": counts_pfused_i["ising_packed"],
         "two_chain_launches": counts_chains["ising_packed"],
         "conformance_launches": counts_conf["ising_packed"],
         "resume_launches": resume_packed["counts"]["ising_packed"]},
        # the round exchange runs inside the round launches of A, #2p and #5:
        # "launches" counts the exchanges run, "ms" is its tail (a round launch
        # less the same launch without it, profiler device time) at L=32 S=1
        {"name": "exchange", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/exchange.cuh",
         "replaces": "src/repro/kernels/ising_sweep.py:517",
         "launches": counts_round["exchange"], "max_abs_err": err_b,
         "ms": b_ms, "plain_ms": b_plain_ms, "bound_ms": b_bound,
         "bound_by": b_by, "library_ms": None,
         "shape": "R=1500, in a round launch of kernel A at L=32 S=1",
         "tail_ms": {what: rd - sw for what, (rd, sw) in tails.items()},
         "round_launch_ms": {what: rd for what, (rd, _) in tails.items()},
         "main_round_launch_ms": round_main,
         "also_replaces": "src/repro/kernels/potts_sweep.py:372 (in kernel #5)",
         "potts_round_exchanges": counts_pround["exchange"],
         "packed_round_exchanges": counts_pround_i["exchange"],
         "resume_exchanges": resume_main["counts"]["exchange"]},
        row("ising_sweep", "sweep.cu", "src/repro/kernels/ising_sweep.py:121",
            counts_sweep["ising_sweep"], shape="L=300 R=1500",
            state_mode_launches=counts_strategy["per-sweep DEO swap_mode=state"]["ising_sweep"]),
        row("potts_sweep", "sweep.cu", "src/repro/kernels/potts_sweep.py:109",
            counts_psweep["potts_sweep"], shape="300x300 q=3 R=1500"),
        row("potts_fused", "potts_fused.cu", "src/repro/kernels/potts_sweep.py:245",
            counts_pround["potts_fused"], shape="300x300 q=3 R=1500 S=2",
            main_ms=times["potts_fused"]["main_ms"],
            main_bound_ms=times["potts_fused"]["main_bound"][0],
            main_shape="300x300 q=3 R=1500 S=100",
            also_replaces="src/repro/kernels/potts_sweep.py:372 (with the exchange)"),
        row("jax_uniform", "jax_uniform.cu",
            "none: XLA's jax.random.uniform (src/repro/engine/driver.py:171)",
            counts_sweep["jax_uniform"], shape="R=1500 x (2,300,300)",
            potts_path_launches=counts_psweep["jax_uniform"],
            potts_ms=times["jax_uniform"]["potts_ms"],
            potts_bound_ms=times["jax_uniform"]["potts_bound"][0],
            state_mode_launches=counts_strategy["per-sweep DEO swap_mode=state"]["jax_uniform"]),
        {"name": "wkv6", "route": "cuda", "source": "src/repro_torch/kernels/csrc/wkv6.cu",
         "replaces": "src/repro/kernels/wkv6.py:54",
         "launches": rw["decode_launches"], "max_abs_err": rw["err"],
         "ms": rw["times"]["decode"]["ms"], "plain_ms": rw["times"]["decode"]["plain_ms"],
         "bound_ms": rw["times"]["decode"]["bound"][0],
         "bound_by": rw["times"]["decode"]["bound"][1], "library_ms": None,
         "shape": "BH=256 T=1 dk=dv=64 (decode, carried state)",
         "device_ms": rw["times"]["decode"]["device"][0],
         "prefill_ms": rw["times"]["prefill"]["ms"],
         "prefill_device_ms": rw["times"]["prefill"]["device"][0],
         "prefill_plain_ms": rw["times"]["prefill"]["plain_ms"],
         "prefill_bound_ms": rw["times"]["prefill"]["bound"][0],
         "prefill_bound_by": rw["times"]["prefill"]["bound"][1],
         "prefill_shape": "BH=256 T=512 dk=dv=64", "prefill_launches": rw["prefill_launches"]},
    ]
    zt = zoo["times"]
    for name, line, path, shape in (
            ("hp_moves", "src/repro/core/hp.py:154", "HP", "N=20 R=1500, 20 moves"),
            ("single_flip", "src/repro/core/ising.py:184", "single_flip",
             "L=300 R=1500, 300 flips")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/serial_chain.cu",
            "replaces": f"none: XLA's lax.fori_loop ({line})",
            "launches": zoo["paths"][path]["counts"][name], "max_abs_err": 0.0,
            "ms": zt[name]["ms"], "plain_ms": zt[name]["plain_ms"],
            "bound_ms": zt[name]["bound"][0], "bound_by": zt[name]["bound"][1],
            "library_ms": None, "shape": shape,
            "latency_floor_ms": zt[name]["latency_floor"], "device_ms": zt[name]["device_ms"],
            "path_ms_per_interval": zoo["paths"][path]["ms"]})
    kernels[-2]["conformance_launches"] = zoo["conformance_launches"]
    print(f"phase 21 done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
