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
12. ``n_chains=2`` at full width on the packed round path (one launch a
    round for both chains, two exchanges): each chain equal to its solo run
    from ``fold_in(key, c)``, no host sync in 3 intervals, and a small
    two-chain spec equal on the card and the CPU;
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
    ms per interval, EA and HP once more under the profiler; the zoo's EA
    and HP conformance entries at full schedule and the Gaussian's with its
    batches cut to 100 sweeps (host-bound: 148 s at full schedule); small
    specs of the four paths on the card against the CPU;
22. the chain axis and the serve layer: one launch of kernels A, #2p and
    #5 over C chains (sweeps alone and a whole round) against C launches of
    one chain, bit for bit, at C in {1, 2, 5}, L in {8, 32, 300}, R in {8,
    1500}, S in {1, 100}, one launch and C exchanges counted, tickets 0; each
    kernel's round launch timed at L=300 R=1500 S=100 at C=1 and C=8; then
    `repro_torch.serve.Scheduler` on the card: a bucket of 8 tenants of the
    paper's round spec (L=300 R=1500 S=100, 4 intervals), the same with
    ``pack_bits`` (#2p), and 4 Potts 300x300 q=3 round tenants, each
    tenant's results, streamed energies, final spins and rungs equal to its
    solo ``Session`` run, round launches equal to the intervals (not 8x),
    obs on and off (equal launches, no host sync between chunk boundaries,
    the timeline through ``check_trace``, the engine and serve series in
    the Prometheus text), ms per interval, replica-sweeps/s and jobs/s; a
    burst of 32 tenants of ``examples/specs/ising_serve.json`` on the round
    path and as it is (per-sweep), equal to 32 solo runs, jobs/s and p50 /
    p99 latency, the one-chunk ``torch.profiler`` window's trace; seeded
    fault plans over the burst (every job done bit-equal or failed typed,
    checkpoints verify or are caught corrupt), and an injected
    ``engine.compile`` fault degrading a round spec to the per-sweep path on
    the card (bit-equal to a never-fused run), fatal with ``strict_kernels``;
23. the mesh over ``torch.distributed`` (``repro_torch.core.distributed``):
    the standalone exchange launch (``csrc/exchange_step.cu``, the sharded
    round path's exchange on the gathered rows, its rows in shared memory,
    past 19,368 rungs in global scratch) at R from 1 to 19,369, C in {1, 2,
    3}, every pairing and criterion, equal to a round launch's exchange bit
    for bit and to plain ``exchange_step``, with the rank slice and the next
    phase it writes; ``exchange_rows`` one device op (the profiler);
    ``jax_uniform`` and both serial chains at replica offsets 0 and 750
    equal to plain and to the unsharded launch's rows; timed beside bounds
    (the exchange by CUDA events and the profiler at R=1500, C=1 and 8, the
    bound's parts printed); then the paper's round configuration
    (L=300 R=1500 S=100, glauber, logistic DEO, 3 intervals) through
    ``Session`` unsharded, on a one-rank NCCL group (``MeshSpec(1, 1)``) and
    on two spawned ranks sharing the card over gloo (``MeshSpec(1, 2)`` and,
    with two chains, ``(2, 1)``), each equal to the unsharded run (digests of
    the final state and of the rung map after every interval, manifests),
    one launch of A and one standalone exchange an interval on each rank
    and no round launch, ms an interval and the bytes a rank all-gathers an
    interval; a checkpoint saved on (1, 2) restored on one device, one saved
    unsharded restored on (2, 1); the per-sweep, ``pack_bits`` fused, Potts
    round, HP and ``single_flip`` paths on (1, 2), each equal to its
    unsharded run; the round path at L=32 R=1500 swapping every sweep on
    (1, 1), equal to its unsharded run, ms an interval.  No run here holds
    two GPUs;
24. training (``repro_torch.train``): kernel #7b (``csrc/wkv6_bwd.cu``,
    the wkv6 gradient) against its plain version (the gradient of
    ``ref.wkv6`` under autograd) at the training shape (BH=512, T=512,
    dk=dv=64) from zero and from a carried state, at T=1, 33, 100, 1000
    and dk, dv < 64; #7 and #7b timed there beside their plain versions and
    bounds; the reduced rwkv6-7b in f32, 3 train steps on the card == the
    CPU with and without remat (launches a step: one #7 and one #7b a
    layer, two #7 with remat); rwkv6-7b at full width with its depth cut to
    8 of 32 layers (f32 masters, bf16 compute, remat, logit_chunk 512), 5
    steps on ``SyntheticLM`` batches of (8, 512): ms a warm step, tokens/s,
    peak memory, each loss finite, and one step and AdamW alone under
    ``torch.profiler``;
25. parallel tempering over LM sequences (``repro_torch.core.ptlm``) and
    the dense family: (a) rwkv6-7b at full width and depth (bf16, seeded as
    phase 15), R=8 sequences of 64 tokens past an 8-token prompt, a
    geometric ladder 1-8, a swap every 5 steps, 40 MH steps through
    ``core.pt``: kernel #7 launched exactly 32 x (1 + 3 x 40) times (a
    forward at init, three a step), the tracked energies equal to a fresh
    ``batched_energy``, at most one token moved a replica and step; ms a
    step, scored tokens/s, MH and swap acceptance, and a profile (idle
    share); (b) gemma-2b at full width and depth (bf16): prefill (4, 512),
    64 decode steps against the HBM floor, decode == full forward in f32,
    and the same PT-LM run, with no hand-written kernel launched; (c)
    reduced f32 gemma and rwkv6 PT-LM runs (30 steps) on the card and the
    CPU with TF32 off: tokens, rungs, every MH acceptance and swap decision
    equal;
26. the hybrid and moe families (``hybrid_moe_phases``, callable alone):
    recurrentgemma-9b at full width and depth (bf16, 9,396,408,320
    parameters): prefill (4, 512), 64 decode steps against the HBM floor,
    profiles, the RG-LRU scan alone, a (1, 4096) prefill through
    ``attend_chunked`` with the 2048 window held against the masked dense
    path in f32 at full width and depth, decode == forward in f32 on one
    group; mixtral-8x22b and qwen3-moe-235b-a22b at full width with 4
    layers: prefill (4, 512), 64 / 16 decode steps against the bytes a step
    reads, ``router_load``'s dropped share, two qwen3 prefills bit-equal,
    profiles and one MoE layer's dispatch / expert GEMMs / combine; the
    three reduced configs in f32 on the card == the CPU (logits, 12 decode
    steps, the loss, MoE expert assignments); no hand-written kernel is
    launched;
27. the vlm and encdec families (``vlm_encdec_phases``, callable alone):
    llama-3.2-vision-11b at full width and depth (bf16, 9,775,157,256
    parameters, the 8 cross layers' gates set to 1.0, a (4, 1601, 4096)
    seeded image): prefill (4, 512), 32 decode steps against a floor of
    max(bytes, flops) that counts the cross K/V recomputed from the image
    every step, logits with the gates at 0 equal for two images and apart
    from the gates at 1.0, profiles, the cross layers alone, decode ==
    forward in f32 on one group; whisper-medium at full width and depth
    (24 + 24 layers, (4, 1500, 1024) seeded frames): ``encode``, prefill
    (4, 448), 32 decode steps against the same floor (set by the flops),
    the cross K/V recompute's share of a step's device time, decode ==
    forward in f32; both reduced configs in f32 on the card == the CPU;
    no hand-written kernel is launched;
28. the LM placement layer (``placement_phases``, callable alone): two
    spawned ranks over gloo share the card (``comm.eager_collectives``);
    gemma-2b at full width, serving in f32 on a (2, 1) and a (1, 2) mesh
    (prefill (4, 128), 16 teacher-forced decode steps with the KV cache's
    sequence on 'model') and training 2 of 18 layers with ``cast_shardings``
    / ``grad_shardings``; rwkv6-7b at full width and depth in f32 on (1, 2),
    kernel #7 on each rank's heads, 32 launches a forward a rank;
    qwen3-moe-235b, 2 of 94 layers, token-stationary prefill on (2, 1); PT-LM
    over gemma-2b on ``MeshSpec(1, 2)``; each against the unsharded run on
    the card (logits within 3e-2 of their scale, greedy tokens and routing
    equal, rwkv's tokens but at near-ties, PT-LM against a replay of the two
    halves), resident bytes and the training step's cast all-gather and
    grads reduce-scatter equal to the specs' arithmetic; times (contention
    of two ranks on one card, not scaling);
29. the hybrid, vlm and encdec families placed and the dry run
    (``family_phases``): (a) two ranks over gloo sharing the card serve
    recurrentgemma-9b on (1, 2) and (2, 1), llama-3.2-vision-11b on (1, 2)
    over a seeded image (gates 1.0) and whisper-medium on (2, 1) and (1, 2)
    in f32 (prefill (4, 64), 4 teacher-forced decode steps), and train one
    bf16 step of each on one mesh, full width, depth cut; each against the
    unsharded run (logits within 1e-4 of their scale, the training limits
    of phase 28 and its planted faults read again); (b) every placed program
    of phases 28 and 29(a) run again on meta tensors over a fake process
    group of its mesh's size (``repro_torch.launch.dryrun``), in a process
    started with the script: its collective bytes by phase, collective and
    mesh axis and the resident bytes a rank equal to the ranks' readings
    exactly; gemma-2b prefill (4, 512)'s roofline terms beside phase 25's
    time; (c) ``python -m repro_torch.launch.dryrun --arch all --shape all
    --mesh both`` and ``dryrun_ising --mesh both``, also started with the
    script (CPU only): every cell ok or skipped with JAX's reason;
30. a JSON line per kernel (launches, error, times, bound), the card line,
    and the result line ``{"ok": true, "device": {...}}`` last.

Every ``Session`` runs with ``strict_kernels=True`` but phase 22's injected
fault: a fused or round path that cannot prepare or launch its kernels
fails instead of degrading to the per-sweep path.

After every phase each round launch's ticket must read 0 again (one that
faulted would leave its ticket set).  It imports nothing of JAX or of the
JAX package.  Without a CUDA device, or
without the repository's ``src/`` beside it, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
import types
import warnings
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
BF16_FLOPS_PER_S = 989e12  # H100 SXM data sheet, dense bf16 on the tensor cores


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
    ``n_bytes`` (kernels A, B, #5, jax_uniform and the standalone exchange):
    A and #5 read and write the lattice once (2 B per cell), B ~30 B per
    rung, the standalone exchange 22 B per rung (no ΔE in, no energy out),
    jax_uniform writes its f32 output."""
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
    averages = prof.key_averages()  # slow on a long trace: read once
    rows = [e for e in averages if e.device_type == DeviceType.CUDA]
    seen = {lab: sum(e.count for e in rows if sub in e.key)
            for lab, (sub, _) in kernels.items()}
    lost = [f"{lab} {seen[lab]} of {counts[key]}" for lab, (_, key) in kernels.items()
            if seen[lab] != counts[key]]
    if lost:
        return (f"{label} profile [{card}]: not measured (the profiler saw "
                f"{', '.join(lost)} launches)")
    dev_us = {e.key: float(e.self_device_time_total) for e in rows}
    busy_ms = sum(dev_us.values()) / 1e3
    syncs = sum(e.count for e in averages if e.key in (
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
    as the JAX package's wkv6 tests draw them (w = sigmoid(normal));
    ``state="zero"`` passes a zero initial state."""
    rng = np.random.default_rng(seed)
    r, k = (rng.normal(size=(bh, t, dk)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(bh, t, dv)).astype(np.float32)
    w = (1.0 / (1.0 + np.exp(-rng.normal(size=(bh, t, dk))))).astype(np.float32)
    u = rng.normal(size=(bh, dk)).astype(np.float32)
    s0 = rng.normal(size=(bh, dk, dv)).astype(np.float32) if state else None
    if state == "zero":
        s0 = np.zeros((bh, dk, dv), np.float32)
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
    # "ptlm": every forward of PT-LM over rwkv6-7b (R=8 x 64 heads, 64 tokens, zero state);
    # "placed": phase 28's rwkv6-7b, a rank's 4 x 32 heads (prefill of 64 tokens from the
    # zero state it makes, a decode step from a carried one) and the unsharded run's 4 x 64
    cases = [((256, 512, 64, 64), False, "prefill"), ((256, 1, 64, 64), True, "decode"),
             ((512, 64, 64, 64), False, "ptlm"), ((128, 64, 64, 64), "zero", "placed"),
             ((128, 1, 64, 64), True, "placed"), ((256, 64, 64, 64), False, "placed"),
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
    host time in it), and how many launches the profiler saw.  A window in
    which the tracer saw none of them is read again, up to six times (late
    in the script the tracer has lost three windows in a row); each window
    leads and ends with 50 ms of idle device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # one small op first, so that the tracer is running when fn starts
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            time.sleep(0.05)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and name in e.key]
        seen = sum(e.count for e in rows)
        if seen:
            return sum(float(e.self_device_time_total) for e in rows) / seen / 1e3, seen
    raise AssertionError(f"the profiler saw no {name} launch in six windows")


def device_ops_of_calls(torch, fn, name: str, calls: int) -> tuple[dict, int]:
    """The device ops of ``calls`` back-to-back calls of ``fn``, as
    ``torch.profiler`` keys and counts them, and how many calls of ``fn``
    were made in all.  A window in which the tracer saw no kernel whose name
    holds ``name`` is read again, up to six times (the tracer has lost whole
    short windows on the card, three in a row once); each window waits
    50 ms with the device idle before the calls, so that the tracer is
    running when they start, and after them, and holds no other device
    work.  The first
    window that saw one is the answer, whatever else it saw."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for window in range(1, 7):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
        seen = {e.key: e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA}
        if any(name in k for k in seen):
            return seen, window * calls
    raise AssertionError(f"the profiler saw no {name} launch in six windows")


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
          f"decode (BH=256 T=1, carried state), PT-LM's forward (BH=512 T=64), phase 28's "
          f"placed rwkv6-7b (a rank's BH=128 T=64 from a zero state and T=1 carried, the "
          f"unsharded BH=256 T=64), 4 small "
          f"shapes, 3 with dk or dv in 1, 5, 63 (T=33) and 3 of T=1000 within "
          f"2(dk+T)·eps·|terms| (and 3e-5 at the small ones); "
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


def wkv6_bwd_bound(bh, t, dk, dv, state: bool) -> tuple[float, str]:
    """Least time of kernel #7b: r, k, w, v and do read once and dr, dk, dw,
    dv written once, u read and du written once, with an initial state
    (``state``) it and d(final state) read and d(initial state) written
    once; against its f32 flops, each once a slab and step: the forward
    state's update (3·dk·dv), dS's update (3·dk·dv), dr, dk, dw and dv's
    products (2·dk·dv each) and the bonus terms (~12·dk + 4·dv), at the
    67e12/s fp32 rate."""
    n_state = (3 if state else 0) * bh * dk * dv
    n_bytes = 4.0 * (bh * t * (3 * dk + 2 * dv) + bh * t * (3 * dk + dv) + n_state
                     + 2 * bh * dk)
    flops = float(bh * t * (14 * dk * dv + 12 * dk + 4 * dv))
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def wkv6_bwd_inputs(torch, np, bh, t, dk, dv, seed, device, state=False):
    """`wkv6_inputs` and the two cotangents: do (BH, T, dv) and, with
    ``state``, d(final state) (BH, dk, dv), normal from the same seed."""
    args = wkv6_inputs(torch, np, bh, t, dk, dv, seed, device, state)
    rng = np.random.default_rng(seed + 1)
    d_o = torch.from_numpy(rng.normal(size=(bh, t, dv)).astype(np.float32)).to(device)
    d_s = (torch.from_numpy(rng.normal(size=(bh, dk, dv)).astype(np.float32)).to(device)
           if state else None)
    return args, d_o, d_s


def check_wkv6_bwd(torch, np, wk, device) -> float:
    """Phase 24 (a): kernel #7b == its plain version (the gradient of
    ``ref.wkv6`` under autograd) on the card; returns max |err|.

    Tolerance: 4·(T + dk + dv)·eps times the same gradient taken on the
    inputs' magnitudes (|r|, |k|, |v|, w, |u|, |S0|, |do|, |dS_T|): each
    gradient sums products of inputs over up to T steps and dk or dv lanes,
    in other orders than autograd's."""
    max_err = 0.0
    cases = [((512, 512, 64, 64), False), ((512, 512, 64, 64), True),
             ((8, 1, 64, 64), True), ((8, 33, 64, 64), False), ((4, 33, 64, 64), True),
             ((4, 100, 48, 48), True), ((3, 33, 5, 63), True), ((3, 70, 63, 5), False),
             ((2, 1000, 64, 64), True)]
    for n, ((bh, t, dk, dv), state) in enumerate(cases):
        args, d_o, d_s = wkv6_bwd_inputs(torch, np, bh, t, dk, dv, 500 + n, device, state)
        got = wk.wkv6_bwd_kernel(*args, d_o, d_s)
        want = wk.wkv6_bwd_plain(*args, d_o, d_s)
        mag = wk.wkv6_bwd_plain(*(None if x is None else x.abs() for x in (*args, d_o, d_s)))
        torch.cuda.synchronize()
        for g, w_, m, name in zip(got, want, mag, ("dr", "dk", "dv", "dw", "du", "ds0")):
            err = (g - w_).abs()
            if not bool(torch.isfinite(g).all()) or bool(
                    (err > 4 * (t + dk + dv) * F32_EPS * m).any()):
                raise AssertionError(f"kernel #7b {(bh, t, dk, dv)} state={state}: {name} "
                                     f"beyond the rounding bound, max err {err.max().item()}")
            max_err = max(max_err, err.max().item())
        del got, want, mag
        torch.cuda.empty_cache()
    return max_err


def time_wkv6_train(torch, np, wk, device) -> dict:
    """Phase 24 (a) times at the training shape (rwkv6-7b, B=8: BH=512,
    T=512, dk=dv=64, zero initial state): #7 and #7b by CUDA events and by
    the profiler's device time, each beside its plain version (the plain
    recurrence; the gradient of it under autograd) on the same inputs."""
    args, d_o, _ = wkv6_bwd_inputs(torch, np, 512, 512, 64, 64, 540, device)
    fwd = dict(ms=cuda_ms(torch, lambda: wk.wkv6_kernel(*args), 20),
               device=profiler_ms(torch, lambda: wk.wkv6_kernel(*args), 20, "wkv6_kernel"),
               plain_ms=cuda_ms(torch, lambda: wk.wkv6_plain(*args), 1),
               bound=wkv6_bound(512, 512, 64, 64, False))
    bwd = dict(ms=cuda_ms(torch, lambda: wk.wkv6_bwd_kernel(*args, d_o, None), 5),
               device=profiler_ms(torch, lambda: wk.wkv6_bwd_kernel(*args, d_o, None), 5,
                                  "wkv6_bwd"),
               plain_ms=cuda_ms(torch, lambda: wk.wkv6_bwd_plain(*args, d_o, None), 1),
               bound=wkv6_bwd_bound(512, 512, 64, 64, False))
    torch.cuda.empty_cache()
    return {"wkv6": fwd, "wkv6_bwd": bwd}


def host_arrays(tree: dict) -> dict:
    return {n: x.detach().cpu().numpy().copy() for n, x in tree.items()}


def adam_direction(np, mu, nu, count: int, opt):
    """AdamW's update direction ``(m / c1) / (sqrt(v / c2) + eps)`` in f32
    from the moments after step ``count``."""
    c1 = np.float32(1.0) - np.float32(opt.b1) ** np.float32(count)
    c2 = np.float32(1.0) - np.float32(opt.b2) ** np.float32(count)
    return (mu / c1) / (np.sqrt(nu / c2) + np.float32(opt.eps))


def grow_master_bound(np, bound: dict, opt, lr: float, count: int, p: dict, mine: tuple,
                      ref: tuple) -> dict:
    """How far two runs' f32 masters may lie apart after one more AdamW
    step, element by element: the last bound grown by the decay, plus lr
    times the distance of the two runs' directions (each from its own
    moments after the step, ``mine`` and ``ref`` as ``(mu, nu)``), plus four
    f32 roundings of the update (``p``: the masters before it).  A gradient
    near 0 whose sign is the last bits' moves it by up to 2 lr; elsewhere it
    grows by a few roundings, so a last update left out lies far outside."""
    eps32 = float(np.finfo(np.float32).eps)
    out = {}
    for n, pn in p.items():
        da = adam_direction(np, *(m[n] for m in mine), count, opt)
        db = adam_direction(np, *(m[n] for m in ref), count, opt)
        out[n] = (bound.get(n, 0.0) * (1 + lr * opt.weight_decay) + lr * np.abs(da - db)
                  + 4 * eps32 * (np.abs(pn) + lr * (1 + np.abs(da))))
    return out


def master_reading(np, mine: dict, ref: dict, bound: dict) -> float:
    """The largest ``|mine - ref| / (1e-6 + bound)``: at most 1 where the
    masters agree as the bound says."""
    return max(float(np.max(np.abs(mine[n] - ref[n]) / (1e-6 + bound[n]))) for n in mine)


def train_phases(torch, np, build, device, card: str) -> dict:
    """Phase 24: training on the card.  (a) kernel #7b against its plain
    version, and #7 and #7b timed at the training shape; (b) the reduced
    rwkv6-7b in f32, 3 train steps on the card == the CPU, with and without
    remat, and the launches a step; (c) rwkv6-7b at full width, depth cut to
    8 of 32 layers (2.29e9 parameters: f32 masters, gradients and two Adam
    moments take 16 B a parameter, ~37 GB, the whole 32 layers ~121 GB), bf16
    compute, remat, logit_chunk 512, 5 steps on `SyntheticLM` batches of
    (8, 512): ms a warm step, tokens/s, peak memory, each loss finite, and
    one step and the optimizer alone under the profiler."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import init_state, make_train_step

    t_phase = time.perf_counter()
    # -- (a) kernel #7b ------------------------------------------------------------
    torch.cuda.empty_cache()
    err = check_wkv6_bwd(torch, np, wk, device)
    times = time_wkv6_train(torch, np, wk, device)
    print(f"phase 24 kernel #7b (wkv6_bwd): equal to the plain gradient (dr, dk, dv, dw, du, "
          f"d state) at the training shape (BH=512 T=512 dk=dv=64) from zero and from a "
          f"carried state, at T=1, T=33, T=100 (dk=dv=48), T=1000, dk, dv in 5, 63, within "
          f"4(T+dk+dv)·eps·|terms|; max |err| {err}")
    for name, tm in times.items():
        dev_ms, seen = tm["device"]
        dev = (f"{dev_ms:.5f} ms device time (profiler, {seen} launches seen), bound/device "
               f"time {tm['bound'][0] / dev_ms:.3f}")
        print(f"phase 24 times [{card}]: {name} at BH=512 T=512 dk=dv=64 {tm['ms']:.4f} ms "
              f"(CUDA events), plain {tm['plain_ms']:.4f} ms, bound {tm['bound'][0]:.5f} ms "
              f"by {tm['bound'][1]}; {dev}; library_ms: none")

    # -- (b) the reduced model: card == CPU, launches a step ------------------------
    opt = opt_lib.AdamWConfig(warmup_steps=2, total_steps=10)
    per_step = {}
    for remat in (False, True):
        cfg = dataclasses.replace(get_config("rwkv6_7b", reduced=True), dtype="float32",
                                  remat=remat)
        on_cpu, on_card = init_state(cfg, 0, device="cpu"), init_state(cfg, 0, device="cpu")
        on_card.params = {n: p.to(device) for n, p in on_card.params.items()}
        on_card.opt = opt_lib.init(on_card.params)
        on_card.step = on_card.step.to(device)
        step = make_train_step(cfg, opt)
        data = SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=4)
        bound, dev_loss = {}, 0.0
        for i in range(3):
            b = {k: torch.from_numpy(v) for k, v in data.batch(i).items()}
            before = host_arrays(on_card.params)
            on_cpu, m_cpu = step(on_cpu, b)
            build.reset_launches()
            on_card, m_card = step(on_card, {k: v.to(device) for k, v in b.items()})
            torch.cuda.synchronize()
            counts = dict(build.launches)
            expect_launches(counts, f"reduced train step (remat={remat})",
                            wkv6=(2 if remat else 1) * cfg.n_layers, wkv6_bwd=cfg.n_layers)
            lc, lg = float(m_cpu["loss"]), float(m_card["loss"])
            if abs(lc - lg) > 1e-5 * abs(lc):
                raise AssertionError(f"reduced train step {i}: loss card {lg} != CPU {lc}")
            dev_loss = max(dev_loss, abs(lc - lg) / abs(lc))
            bound = grow_master_bound(
                np, bound, opt, float(m_cpu["lr"]), i + 1, before,
                (host_arrays(on_card.opt.mu), host_arrays(on_card.opt.nu)),
                (host_arrays(on_cpu.opt.mu), host_arrays(on_cpu.opt.nu)))
        want = host_arrays(on_cpu.params)
        reading = master_reading(np, host_arrays(on_card.params), want, bound)
        skipped = master_reading(np, before, want, bound)
        if reading > 1.0 or skipped <= 100.0:
            raise AssertionError(f"reduced train steps (remat={remat}): masters card != CPU, "
                                 f"reading {reading} of the bound (the card's step-2 masters "
                                 f"read {skipped})")
        per_step[remat] = {k: v for k, v in counts.items() if v}
        print(f"phase 24 reduced rwkv6 [{card}]: f32, 2 layers d_model 128, remat={remat}: 3 "
              f"train steps on the card == CPU (loss within 1e-5 relative, max "
              f"{dev_loss:.2e}; masters within the bound the two runs' Adam directions "
              f"explain, reading {reading:.4f}, the card's step-2 masters {skipped:.1f}); "
              f"launches a step {per_step[remat]}")
    del on_cpu, on_card
    torch.cuda.empty_cache()

    # -- (c) rwkv6-7b at full width, 8 layers, bf16 compute ----------------------------
    cfg = dataclasses.replace(get_config("rwkv6_7b"), n_layers=8)
    batch, seq, n_steps = 8, 512, 5
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    state = init_state(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in state.params.values())
    step = make_train_step(cfg, opt_lib.AdamWConfig(warmup_steps=20, total_steps=100))
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in data.batch(i).items()}
               for i in range(n_steps + 1)]
    losses = []
    build.reset_launches()
    t = time.perf_counter()
    state, m = step(state, batches[0])
    losses.append(m["loss"])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    t = time.perf_counter()
    for b in batches[1:n_steps]:
        state, m = step(state, b)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    warm_ms = 1e3 * (time.perf_counter() - t) / (n_steps - 1)
    counts = dict(build.launches)
    expect_launches(counts, "rwkv6-7b 8-layer train steps", wkv6=2 * cfg.n_layers * n_steps,
                    wkv6_bwd=cfg.n_layers * n_steps)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)) or int(state.step) != n_steps:
        raise AssertionError(f"rwkv6-7b train steps: losses {losses}, step {int(state.step)}")
    tokens_s = batch * seq / warm_ms * 1e3
    # 6 flops a parameter and token for the matrix products (forward 2, backward
    # 4; the embedding is a gather), 2 more for remat's second forward
    n_mm = n_params - cfg.vocab * cfg.d_model - 9 * cfg.d_model * cfg.n_layers
    mfu = 6 * n_mm * batch * seq / (warm_ms / 1e3) / BF16_FLOPS_PER_S
    print(f"phase 24 rwkv6-7b training [{card}]: full width (d_model 4096, 64 heads x 64, "
          f"d_ff 14336, vocab 65536), 8 of 32 layers, {n_params} parameters (f32 masters, "
          f"bf16 compute, remat full, logit_chunk 512), initialised on the card in "
          f"{init_s:.2f} s; SyntheticLM batches (8, 512): first step {first_s * 1e3:.1f} ms, "
          f"warm steps {warm_ms:.1f} ms = {tokens_s:.1f} tokens/s (6·N·tokens at "
          f"{mfu:.3f} of the bf16 peak, N = {n_mm} matmul parameters), peak memory "
          f"{peak_gb:.2f} GB, losses {[round(x, 4) for x in losses]}; launches in "
          f"{n_steps} steps {{'wkv6': {counts['wkv6']}, 'wkv6_bwd': {counts['wkv6_bwd']}}} "
          f"(2 and 1 a layer and step)")
    gemms = {"matmul": ("gemm", "gemv", "xmma", "cutlass", "nvjet", "splitk"),
             "elementwise": ("elementwise",), "reductions": ("reduce",)}
    wkv = {"wkv6": ("wkv6_kernel", "wkv6"), "wkv6_bwd": ("wkv6_bwd_kernel", "wkv6_bwd")}
    print(profile_breakdown(torch, build, lambda: step(state, batches[n_steps]), 1, card,
                            "phase 24 rwkv6-7b train step (8, 512)", wkv, groups=gemms,
                            unit="step"))
    # the optimizer alone: the masters as their own gradients (no extra memory)
    print(profile_breakdown(
        torch, build,
        lambda: opt_lib.apply(opt_lib.AdamWConfig(), state.params, dict(state.params),
                              state.opt), 1, card, "phase 24 AdamW alone", {},
        groups={k: gemms[k] for k in ("elementwise", "reductions")}, unit="step"))
    del state, batches, step
    torch.cuda.empty_cache()
    print(f"phase 24 done in {time.perf_counter() - t_phase:.1f} s")
    return {"err": err, "times": times, "launches": counts, "per_step": per_step,
            "warm_ms": warm_ms, "tokens_s": tokens_s, "peak_gb": peak_gb}


# -- phase 25: parallel tempering over LM sequences, and the dense family ------------
PTLM_R, PTLM_SEQ, PTLM_PROMPT, PTLM_STEPS, PTLM_SWAP = 8, 64, 8, 40, 5
PTLM_SMALL_STEPS = 30  # the reduced runs, card against CPU
# tracked energies (a sum of per-step differences) against a fresh
# batched_energy, relative to the energies' magnitude (~2e2-2e3 nats here):
# each accepted step adds one f32 rounding, and a replica's forward does not
# depend on the other rows of its batch
PTLM_ENERGY_RTOL = 1e-4


class CheckedLM:
    """A bound LM system whose MH steps are checked and counted on the card:
    how many tokens each step moved (at most one a replica), the moves
    accepted, and each step's acceptances (kept for card == CPU).  Nothing
    waits for the card; everything else is the system's own."""

    def __init__(self, torch, system):
        self.system = system
        dev = system.model.embed.device
        self.too_many = torch.zeros((), dtype=torch.int64, device=dev)
        self.accepted = torch.zeros((), dtype=torch.int64, device=dev)
        self.steps = []

    def __getattr__(self, name):
        return getattr(self.system, name)

    def batched_mcmc_step(self, key, t, tokens, betas, replica_offset=0):
        new, de, acc = self.system.batched_mcmc_step(key, t, tokens, betas, replica_offset)
        self.too_many += ((new != tokens).sum(dim=1) > 1).sum()
        self.accepted += acc.sum()
        self.steps.append(acc)
        return new, de, acc


def ptlm_run(torch, np, build, model, cfg, what: str, r=PTLM_R, seq=PTLM_SEQ,
             prompt=PTLM_PROMPT, steps=PTLM_STEPS, seed=4) -> dict:
    """PT over ``model``'s sequences through `core.pt.init` / `run`: R
    replicas of ``seq`` tokens past a ``prompt``-token prompt, a geometric
    ladder from 1 to 8, a swap every 5 steps.  The launch counts are 0 just
    before init and read just after the run; the tracked energies must
    equal a fresh ``batched_energy`` within `PTLM_ENERGY_RTOL` of their
    magnitude and no step may move two tokens of a replica."""
    from repro_torch.core import keys, ladder
    from repro_torch.core import pt as pt_lib
    from repro_torch.core.ptlm import LMSystem

    dev = model.embed.device
    system = CheckedLM(torch, LMSystem(cfg=cfg, seq_len=seq, prompt_len=prompt).bind(model))
    temps = tuple(float(t) for t in ladder.geometric_ladder(r, 1.0, 8.0))
    ptc = pt_lib.PTConfig(n_replicas=r, temps=temps, swap_interval=PTLM_SWAP)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    build.reset_launches()
    t = time.perf_counter()
    st = pt_lib.init(system, ptc, keys.key(seed, device=dev))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    e0 = st.energy[torch.argsort(st.rung)].clone()
    t = time.perf_counter()
    st, trace = pt_lib.run(system, ptc, st, steps)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = dict(build.launches)
    fresh = system.batched_energy(st.states)
    dev_e = (st.energy - fresh).abs().max().item()
    if (not bool(torch.isfinite(st.energy).all())
            or dev_e > PTLM_ENERGY_RTOL * fresh.abs().max().item()):
        raise AssertionError(f"{what}: tracked energies != batched_energy ({dev_e})")
    if int(system.too_many) != 0:
        raise AssertionError(f"{what}: a step moved more than one token of a replica")
    if (tuple(st.states.shape) != (r, seq) or st.states.dtype != torch.int32
            or not bool(((st.states >= 0) & (st.states < cfg.vocab)).all())):
        raise AssertionError(f"{what}: bad tokens")
    if sorted(st.rung.cpu().tolist()) != list(range(r)) or int(st.t) != steps:
        raise AssertionError(f"{what}: bad rungs or step counter")
    att = int(trace["swap_attempt"].sum())
    return {"state": st, "trace": trace, "counts": counts, "init_s": init_s, "wall": wall,
            "ms_step": 1e3 * wall / steps, "tokens_s": 3 * r * seq * steps / wall,
            "accept": int(system.accepted) / (r * steps),
            "swap_rate": int(trace["swap_accept"].sum()) / max(att, 1), "energy_dev": dev_e,
            "cold": (e0[0].item(), trace["energy"][-1, 0].item()),
            "acc_steps": torch.stack(system.steps).cpu(), "system": system, "ptc": ptc,
            "shape": (r, seq, prompt, steps)}


def ptlm_line(res: dict, label: str, card: str) -> str:
    r, seq, prompt, steps = res["shape"]
    return (f"{label} [{card}]: R={r} x {seq} tokens (prompt {prompt}), "
            f"geometric ladder 1-8, a swap every {PTLM_SWAP} steps, {steps} MH steps: "
            f"init {1e3 * res['init_s']:.2f} ms, {res['ms_step']:.2f} ms a MH step (three "
            f"forwards), {res['tokens_s']:.1f} scored tokens/s (3 x R x S a step), MH "
            f"acceptance {res['accept']:.4f}, swap acceptance {res['swap_rate']:.4f}, cold "
            f"rung NLL {res['cold'][0]:.2f} -> {res['cold'][1]:.2f}, tracked energies == "
            f"batched_energy within {res['energy_dev']:.3e} (<= {PTLM_ENERGY_RTOL:g} of "
            f"their magnitude), at most one token moved a replica and step")


def ptlm_phases(torch, np, build, device, card: str) -> dict:
    """Phase 25: PT-LM over rwkv6-7b at full width and depth (kernel #7 in
    every forward), gemma-2b at full width (prefill, decode, decode ==
    full forward, PT-LM) and reduced PT-LM runs card == CPU.  Returns what
    the kernel summary needs."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve_lm
    from repro_torch.launch.rwkv_rounding import decode_vs_forward
    from repro_torch.models import model as model_lib

    t_phase = time.perf_counter()

    def stamp() -> str:
        return f"[{time.perf_counter() - t_phase:.1f} s] "

    def one_step(res):
        """One MH step of every replica (three forwards) from the run's final
        state, for the profiler (its trace of a whole interval takes the host
        tens of seconds to read)."""
        system, st = res["system"], res["state"]
        betas = torch.from_numpy(res["ptc"].betas).to(device)[st.rung.long()]
        return lambda: system.batched_mcmc_step(st.key, st.t, st.states, betas)

    gemms = {"matmul": ("gemm", "gemv", "xmma", "cutlass", "nvjet", "splitk")}
    out = {}

    # -- (a) rwkv6-7b at full width and depth, bf16, seeded as phase 15 ---------------
    cfg = get_config("rwkv6_7b")
    torch.cuda.empty_cache()
    lm = model_lib.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    ptlm_run(torch, np, build, lm, cfg, "phase 25 rwkv6-7b warm-up", steps=PTLM_SWAP)
    res = ptlm_run(torch, np, build, lm, cfg, "phase 25 rwkv6-7b PT-LM")
    want = cfg.n_layers * (1 + 3 * PTLM_STEPS)  # one forward at init, three a step
    expect_launches(res["counts"], "phase 25 rwkv6-7b PT-LM", wkv6=want)
    print(stamp() + ptlm_line(res, "phase 25 rwkv6-7b PT-LM (full width and depth, bf16, "
                              "15 GB)", card)
          + f"; wkv6 launches {res['counts']['wkv6']} == 32 x (1 + 3 x {PTLM_STEPS})")
    print(stamp() + profile_breakdown(torch, build, one_step(res), 1, card,
                                      "phase 25 rwkv6-7b PT-LM",
                                      {"wkv6": ("wkv6_kernel", "wkv6")}, groups=gemms,
                                      unit="MH step"))
    out["rwkv"] = {k: res[k] for k in ("ms_step", "tokens_s", "accept", "swap_rate",
                                       "energy_dev", "counts")}
    del lm, res
    torch.cuda.empty_cache()

    # -- (b) gemma-2b at full width and depth, bf16 --------------------------------------
    cfg = get_config("gemma_2b")
    lm = model_lib.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    n_params = sum(q.numel() for q in lm.parameters())
    if n_params != cfg.n_params:
        raise AssertionError(f"gemma-2b: {n_params} parameters, ModelConfig {cfg.n_params}")
    w_bytes = sum(q.numel() * q.element_size() for q in lm.parameters())
    floor_ms = 1e3 * w_bytes / HBM_BYTES_PER_S  # a decode step streams every weight once
    batch, seq, n_gen = 4, 512, 64
    tokens = torch.randint(0, cfg.vocab, (batch, seq), device=device,
                           generator=torch.Generator(device=device).manual_seed(1))
    with torch.inference_mode():
        model_lib.prefill_logits(lm, cfg, {"tokens": tokens})  # first use of each op
        torch.cuda.synchronize()
        build.reset_launches()
        t = time.perf_counter()
        for _ in range(3):
            logits = model_lib.prefill_logits(lm, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t) / 3
        expect_launches(dict(build.launches), "phase 25 gemma-2b prefill")
    if (tuple(logits.shape) != (batch, cfg.vocab) or logits.dtype != torch.float32
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"gemma-2b prefill logits {tuple(logits.shape)} not finite")
    serve_lm.generate(lm, cfg, batch, 4, device)  # first use of the decode ops
    torch.cuda.synchronize()
    build.reset_launches()
    t = time.perf_counter()
    seqs = serve_lm.generate(lm, cfg, batch, n_gen, device)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    expect_launches(dict(build.launches), "phase 25 gemma-2b decode loop")
    if (tuple(seqs.shape) != (batch, n_gen + 1)
            or not bool(((seqs >= 0) & (seqs < cfg.vocab)).all())):
        raise AssertionError(f"gemma-2b generate: bad token ids {seqs[:, :8].tolist()}")
    ms_token = 1e3 * gen_s / n_gen
    print(stamp() + f"phase 25 gemma-2b [{card}]: full width and depth (18 layers, d_model 2048, 8 "
          f"heads x 256, MQA, GeGLU d_ff 16384, vocab 256000, tied embeddings, bf16), "
          f"{n_params} parameters ({w_bytes / 1e9:.3f} GB); prefill (4, 512): "
          f"{prefill_ms:.2f} ms = {batch * seq / prefill_ms * 1e3:.1f} tokens/s; generate "
          f"B=4 x {n_gen} tokens: {ms_token:.3f} ms/token = {batch * n_gen / gen_s:.1f} "
          f"tokens/s, {ms_token / floor_ms:.2f}x the {floor_ms:.3f} ms HBM floor (weight "
          f"bytes / 3.35 TB/s); no hand-written kernel launched (attention is einsum and "
          f"an f32 softmax, GEMMs cuBLAS)")
    with torch.inference_mode():
        print(stamp() + profile_breakdown(
            torch, build, lambda: model_lib.prefill_logits(lm, cfg, {"tokens": tokens}), 1,
            card, "phase 25 gemma-2b prefill (4, 512)", {}, groups=gemms, unit="forward"))
    print(stamp() + profile_breakdown(
        torch, build, lambda: serve_lm.generate(lm, cfg, batch, 4, device), 4, card,
        "phase 25 gemma-2b decode loop", {}, groups=gemms, unit="token"))
    res = ptlm_run(torch, np, build, lm, cfg, "phase 25 gemma-2b warm-up", steps=PTLM_SWAP)
    res = ptlm_run(torch, np, build, lm, cfg, "phase 25 gemma-2b PT-LM")
    expect_launches(res["counts"], "phase 25 gemma-2b PT-LM")
    print(stamp() + ptlm_line(res, "phase 25 gemma-2b PT-LM (full width and depth, bf16)",
                              card))
    print(stamp() + profile_breakdown(torch, build, one_step(res), 1, card,
                                      "phase 25 gemma-2b PT-LM", {}, groups=gemms,
                                      unit="MH step"))
    out["gemma"] = {"prefill_tokens_s": batch * seq / prefill_ms * 1e3, "ms_token": ms_token,
                    "floor_ms": floor_ms, **{k: res[k] for k in (
                        "ms_step", "tokens_s", "accept", "swap_rate", "energy_dev")}}
    del lm, res, logits
    torch.cuda.empty_cache()
    # decode == full forward at full width in f32 (10 GB of weights), with the
    # tolerance of phase 16 (rtol = atol = 3e-2; step 0 within 1e-4)
    n_dec = 16
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with torch.inference_mode():
        lm32 = model_lib.init_params(cfg32, torch.Generator(device=device).manual_seed(0),
                                     device=device)
        steps32, full32 = decode_vs_forward(lm32, cfg32, tokens, n_dec)
        torch.cuda.synchronize()
        del lm32
        torch.cuda.empty_cache()
    dev32 = (steps32 - full32).abs()
    if not bool(torch.isfinite(steps32).all()) or bool((dev32 > 3e-2 + 3e-2 * full32.abs()).any()):
        raise AssertionError(f"gemma-2b f32 decode != full forward: {dev32.max().item()}")
    if bool((dev32[:, 0] > 1e-4 + 1e-4 * full32[:, 0].abs()).any()):
        raise AssertionError(f"gemma-2b f32 decode step 0 != forward: {dev32[:, 0].max().item()}")
    print(stamp() + f"phase 25 gemma-2b decode == full forward [{card}]: full width, "
          f"{n_dec} steps, "
          f"f32 weights: max |decode - forward| {dev32.max().item():.3e} (step 0: "
          f"{dev32[:, 0].max().item():.3e} <= 1e-4) within rtol = atol = 3e-2 (logits up to "
          f"{full32.abs().max().item():.3f})")
    out["gemma"]["decode_dev"] = dev32.max().item()
    del steps32, full32, dev32, tokens
    torch.cuda.empty_cache()

    # -- (c) reduced f32 PT-LM runs: the card against the CPU ---------------------------
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: card == CPU needs full f32")
    for arch in ("gemma_2b", "rwkv6_7b"):
        small = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
        with torch.inference_mode():
            lm_cpu = model_lib.init_params(small, 0, device="cpu")
            lm_card = copy.deepcopy(lm_cpu).to(device)
        kw = dict(r=4, seq=12, prompt=1, steps=PTLM_SMALL_STEPS)
        on_card = ptlm_run(torch, np, build, lm_card, small, f"phase 25 reduced {arch} card",
                           **kw)
        want = ({"wkv6": small.n_layers * (1 + 3 * PTLM_SMALL_STEPS)} if arch == "rwkv6_7b"
                else {})
        expect_launches(on_card["counts"], f"phase 25 reduced {arch} card", **want)
        on_cpu = ptlm_run(torch, np, build, lm_cpu, small, f"phase 25 reduced {arch} CPU", **kw)
        for name, a, b in (
                ("tokens", on_card["state"].states.cpu(), on_cpu["state"].states),
                ("rungs", on_card["state"].rung.cpu(), on_cpu["state"].rung),
                ("MH acceptances", on_card["acc_steps"], on_cpu["acc_steps"]),
                ("swap decisions", on_card["trace"]["swap_accept"].cpu(),
                 on_cpu["trace"]["swap_accept"])):
            if not torch.equal(a, b):
                raise AssertionError(f"phase 25 reduced {arch}: {name} card != CPU")
        e_dev = (on_card["trace"]["energy"].cpu() - on_cpu["trace"]["energy"]).abs().max().item()
        print(stamp() + f"phase 25 reduced {arch} [{card}]: f32, R=4 x 12 tokens, "
              f"{PTLM_SMALL_STEPS} MH "
              f"steps, TF32 off: tokens, rungs, every step's MH acceptances and every swap "
              f"decision equal on the card and the CPU; energies within {e_dev:.3e}")
        del lm_card, on_card
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 25 done in {out['seconds']:.1f} s")
    return out


# -- phase 26: the hybrid and moe families at full width ------------------------------
# recurrentgemma-9b (38 layers) and mixtral-8x22b / qwen3-moe-235b-a22b at full
# width with their depth cut to 4 layers, bf16 on seeded weights; no
# hand-written kernel is on these paths (the RG-LRU scan, the conv, the MoE
# dispatch and combine are torch ops, the products cuBLAS).  Tolerances:
# the (1, 4096) prefill through attend_chunked with the 2048 window against
# the masked dense path (attn_chunk=0) in f32 at full width and depth, rtol
# = atol = 1e-3 on the last position's logits (the two paths differ by the
# online softmax's f32 roundings; in bf16 the comparison is printed, with
# rounding flips amplified by 38 random layers); decode == forward in f32 as
# phase 25 (rtol = atol = 3e-2, step 0 within 1e-4); reduced f32 models on
# the card against the CPU with TF32 off: logits rtol = atol = 1e-4, the
# loss within 1e-5 relative, MoE expert assignments equal.
HYBRID_MOE_CHUNK_TOL = 1e-3
RECURRENTGEMMA_HELD = 9_396_408_320  # what the model holds (param_count says 9,975,459,840)


def _profiled(torch, fn, reps: int, read, shapes: bool = False):
    """What ``read(prof)`` (a tuple led by the device ops seen, or None)
    gives for a `torch.profiler` window of ``reps`` calls of ``fn``.  The
    tracer drops device events now and then and never adds any (one window
    saw 2 of a combine's 17 ops), so three windows that saw ops are read, up
    to six in all, and the one with the most ops is kept."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=shapes) as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            time.sleep(0.05)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
        got = read(prof)
        if got is not None:
            seen.append(got)
            if len(seen) == 3:
                break
    if not seen:
        raise AssertionError("the profiler saw no device op in six windows")
    return max(seen)


def _device_rows(prof) -> tuple[int, float]:
    """Device ops (less the tracer's first) and their busy ms in a window."""
    from torch.autograd import DeviceType

    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.count for e in rows) - 1,
            sum(float(e.self_device_time_total) for e in rows) / 1e3)


def device_busy_ms(torch, fn, reps: int = 1) -> tuple[float, int]:
    """Device time in ms of every kernel and copy that one call of ``fn``
    issues (``torch.profiler``, the mean over ``reps`` calls) and the device
    ops a call."""
    def read(prof):
        ops, busy = _device_rows(prof)
        return (ops, busy) if ops > 0 else None

    ops, busy = _profiled(torch, fn, reps, read)
    return busy / reps, ops // reps


def gemm_pick(rows: int, inner: int, cols: int):
    """Picks the host op of a (rows, inner) x (inner, cols) product by its
    input shapes (`torch.einsum` lowers one to `aten::bmm` of a batch of 1)."""
    want = [[rows, inner], [inner, cols]]

    def pick(e) -> bool:
        if e.name not in ("aten::bmm", "aten::mm") or len(e.input_shapes) != 2:
            return False
        return [list(s[1:]) if len(s) == 3 and s[0] == 1 else list(s)
                for s in e.input_shapes] == want
    return pick


def device_part_ms(torch, fn, pick) -> tuple[float, int, float, int]:
    """One call of ``fn`` in one profiler window: its device ms and ops (as
    `device_busy_ms`), and the device ms of the kernels issued under the
    host ops that ``pick`` selects and how many it selected."""
    from torch.autograd import DeviceType

    def read(prof):
        ops, busy = _device_rows(prof)
        picked = [e for e in prof.events() if e.device_type == DeviceType.CPU and pick(e)]
        part = sum(float(e.device_time_total) for e in picked) / 1e3
        return (ops, busy, part, len(picked)) if ops > 0 and part > 0 else None

    ops, busy, part, n_picked = _profiled(torch, fn, 1, read, shapes=True)
    return busy, ops, part, n_picked


class MoERecorder:
    """Wraps `repro_torch.models.moe.moe_ffn` while in use: every call's
    routing (``expert_idx``), ``router_load`` of its input and, for the
    first call, the input itself."""

    def __init__(self, moe_lib, keep_input: bool = False):
        self.moe_lib, self.keep_input = moe_lib, keep_input
        self.calls, self.first_input = [], None

    def __enter__(self):
        orig = self.orig = self.moe_lib.moe_ffn

        def recorded(p, cfg, x, trace=None):
            t = {} if trace is None else trace
            y = orig(p, cfg, x, trace=t)
            counts, dropped = self.moe_lib.router_load(cfg, x, p)
            self.calls.append({"expert_idx": t["expert_idx"], "counts": counts,
                               "dropped": dropped})
            if self.keep_input and self.first_input is None:
                self.first_input = (p, x.detach().clone())
            return y

        self.moe_lib.moe_ffn = recorded
        return self

    def __exit__(self, *exc):
        self.moe_lib.moe_ffn = self.orig


def serve_full_width(torch, build, model_lib, serve_lm, lm, cfg, what: str, n_gen: int,
                     floor_bytes: float, device, *, seq: int = 512, extra: dict | None = None,
                     ctx=None, floor_flops: float = 0.0) -> dict:
    """Prefill (4, ``seq``) (first use, then 3 timed) and ``generate`` B=4 x
    ``n_gen`` tokens (after 4 of first use), with no hand-written kernel
    launched; finite logits and token ids in the vocabulary.  ``extra``
    joins the prefill batch (the family's context: ``img``, ``frames``),
    ``ctx`` is the decode steps' context.  The floor is the larger of
    ``floor_bytes`` at 3.35 TB/s and ``floor_flops`` at the bf16 peak."""
    batch = 4
    tokens = torch.randint(0, cfg.vocab, (batch, seq), device=device,
                           generator=torch.Generator(device=device).manual_seed(1))
    inputs = {"tokens": tokens, **(extra or {})}
    with torch.inference_mode():
        model_lib.prefill_logits(lm, cfg, inputs)
        torch.cuda.synchronize()
        build.reset_launches()
        t = time.perf_counter()
        for _ in range(3):
            logits = model_lib.prefill_logits(lm, cfg, inputs)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t) / 3
    expect_launches(dict(build.launches), f"{what} prefill")
    if (tuple(logits.shape) != (batch, cfg.vocab) or logits.dtype != torch.float32
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"{what} prefill logits {tuple(logits.shape)} not finite")
    serve_lm.generate(lm, cfg, batch, 4, device, ctx=ctx)
    torch.cuda.synchronize()
    build.reset_launches()
    t = time.perf_counter()
    seqs = serve_lm.generate(lm, cfg, batch, n_gen, device, ctx=ctx)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    expect_launches(dict(build.launches), f"{what} decode loop")
    if (tuple(seqs.shape) != (batch, n_gen + 1)
            or not bool(((seqs >= 0) & (seqs < cfg.vocab)).all())):
        raise AssertionError(f"{what} generate: bad token ids {seqs[:, :8].tolist()}")
    bytes_ms = 1e3 * floor_bytes / HBM_BYTES_PER_S
    flops_ms = 1e3 * floor_flops / BF16_FLOPS_PER_S
    floor_ms = max(bytes_ms, flops_ms)
    ms_token = 1e3 * gen_s / n_gen
    return {"tokens": tokens, "seq": seq, "logits": logits, "prefill_ms": prefill_ms,
            "prefill_tokens_s": batch * seq / prefill_ms * 1e3, "ms_token": ms_token,
            "floor_ms": floor_ms, "floor_bytes_ms": bytes_ms, "floor_flops_ms": flops_ms,
            "floor_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "x_floor": ms_token / floor_ms, "decode_tokens_s": batch * n_gen / gen_s}


def serve_line(res: dict, n_gen: int) -> str:
    return (f"prefill (4, {res['seq']}): {res['prefill_ms']:.2f} ms = "
            f"{res['prefill_tokens_s']:.1f} tokens/s; generate B=4 x {n_gen} tokens: "
            f"{res['ms_token']:.3f} ms/token = {res['decode_tokens_s']:.1f} tokens/s, "
            f"{res['x_floor']:.2f}x the {res['floor_ms']:.3f} ms floor")


def hybrid_moe_phases(torch, np, build, device, card: str) -> dict:
    """Phase 26: the hybrid family (recurrentgemma-9b at full width and
    depth) and the moe family (mixtral-8x22b and qwen3-moe-235b-a22b at
    full width, 4 layers each) on the card, and their reduced configs card
    == CPU.  Returns the numbers PERF.md keeps."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve_lm
    from repro_torch.launch.rwkv_rounding import decode_vs_forward
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import rglru as rglru_lib
    from repro_torch.models import transformer as tf

    t_phase = time.perf_counter()

    def stamp() -> str:
        return f"[{time.perf_counter() - t_phase:.1f} s] "

    def seeded(cfg):
        return model_lib.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                                     device=device)

    def free():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the f32 checks below need full f32")
    gemms = {"matmul": ("gemm", "gemv", "xmma", "cutlass", "nvjet", "splitk")}
    out = {}

    # -- (a) recurrentgemma-9b at full width and depth, bf16 ----------------------------
    cfg = get_config("recurrentgemma_9b")
    torch.cuda.reset_peak_memory_stats()
    lm = seeded(cfg)
    held = sum(q.numel() for q in lm.parameters())
    if held != RECURRENTGEMMA_HELD or cfg.n_params == held:
        raise AssertionError(f"recurrentgemma-9b holds {held} parameters (param_count "
                             f"{cfg.n_params})")
    w_bytes = sum(q.numel() * q.element_size() for q in lm.parameters())
    n_gen = 64
    # tied embeddings: a step reads every weight once (the table is the unembedding)
    res = serve_full_width(torch, build, model_lib, serve_lm, lm, cfg, "recurrentgemma-9b",
                           n_gen, w_bytes, device)
    print(stamp() + f"phase 26 recurrentgemma-9b [{card}]: full width and depth (38 layers: "
          f"12 x (rglru, rglru, attn_local) + 2 rglru, d_model 4096, lru 4096, MQA 16 x 256, "
          f"window 2048, GeGLU 12288, vocab 256000, tied, bf16), {held} parameters "
          f"({w_bytes / 1e9:.3f} GB; param_count {cfg.n_params}); " + serve_line(res, n_gen)
          + " (weight bytes / 3.35 TB/s)")
    tokens = res["tokens"]
    with torch.inference_mode():
        print(stamp() + profile_breakdown(
            torch, build, lambda: model_lib.prefill_logits(lm, cfg, {"tokens": tokens}), 1,
            card, "phase 26 recurrentgemma-9b prefill (4, 512)", {}, groups=gemms,
            unit="forward"))
    print(stamp() + profile_breakdown(
        torch, build, lambda: serve_lm.generate(lm, cfg, 4, 4, device), 4, card,
        "phase 26 recurrentgemma-9b decode loop", {}, groups=gemms, unit="token"))
    # the RG-LRU scan alone (gates and the associative scan) at the layer's inputs
    mix = lm.layers[0].mix
    scan = {}
    with torch.inference_mode():
        for b, s in ((4, 512), (1, 4096)):
            u = torch.randn((b, s, cfg.lru_width), device=device,
                            generator=torch.Generator(device=device).manual_seed(2)
                            ).to(cfg.compute_dtype)
            busy, ops = device_busy_ms(torch, lambda: rglru_lib.rglru_scan(mix, cfg, u), 3)
            scan[(b, s)] = {"ms": cuda_ms(torch, lambda: rglru_lib.rglru_scan(mix, cfg, u), 5),
                            "device_ms": busy, "ops": ops}
    n_rec = tf.layer_kinds(cfg).count("rglru")
    print(stamp() + f"phase 26 RG-LRU scan [{card}]: gates + associative scan of one layer "
          + "; ".join(f"({b}, {s}): {v['ms']:.3f} ms (CUDA events), {v['device_ms']:.3f} ms "
                      f"device in {v['ops']} device ops, x {n_rec} layers = "
                      f"{v['device_ms'] * n_rec:.1f} ms a forward" for (b, s), v in scan.items()))
    # (1, 4096): attend_chunked with the 2048 window, and the scan at 4096 steps
    long = torch.randint(0, cfg.vocab, (1, 4096), device=device,
                         generator=torch.Generator(device=device).manual_seed(3))
    dense_cfg = dataclasses.replace(cfg, attn_chunk=0)
    with torch.inference_mode():
        model_lib.prefill_logits(lm, cfg, {"tokens": long})
        torch.cuda.synchronize()
        t = time.perf_counter()
        chunked = model_lib.prefill_logits(lm, cfg, {"tokens": long})
        torch.cuda.synchronize()
        long_ms = 1e3 * (time.perf_counter() - t)
        dense = model_lib.prefill_logits(lm, dense_cfg, {"tokens": long})
        torch.cuda.synchronize()
    if not (bool(torch.isfinite(chunked).all()) and bool(torch.isfinite(dense).all())):
        raise AssertionError("recurrentgemma-9b (1, 4096) prefill: logits not finite")
    bf16_dev = (chunked - dense).abs().max().item()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    out["recurrentgemma"] = {**{k: res[k] for k in ("prefill_ms", "prefill_tokens_s",
                                                    "ms_token", "floor_ms", "x_floor")},
                             "long_ms": long_ms, "bf16_chunked_vs_dense": bf16_dev,
                             "scan": {f"{b}x{s}": v for (b, s), v in scan.items()},
                             "peak_gb": peak_gb}
    del lm, mix, res, chunked, dense
    free()
    # the same comparison in f32 at full width and depth (37.6 GB of weights)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with torch.inference_mode():
        lm32 = seeded(cfg32)
        chunked = model_lib.prefill_logits(lm32, cfg32, {"tokens": long})
        dense = model_lib.prefill_logits(lm32, dataclasses.replace(cfg32, attn_chunk=0),
                                         {"tokens": long})
        torch.cuda.synchronize()
        del lm32
        free()
    dev32 = (chunked - dense).abs()
    tol = HYBRID_MOE_CHUNK_TOL
    if not bool(torch.isfinite(chunked).all()) or bool((dev32 > tol + tol * dense.abs()).any()):
        raise AssertionError(f"recurrentgemma-9b f32 chunked != dense: {dev32.max().item()}")
    print(stamp() + f"phase 26 recurrentgemma-9b (1, 4096) [{card}]: attend_chunked (2 chunks "
          f"of 2048, window 2048) and the RG-LRU scan over 4096 steps: bf16 prefill "
          f"{long_ms:.2f} ms = {4096 / long_ms * 1e3:.1f} tokens/s; last-position logits "
          f"against the masked dense path (attn_chunk=0, (1, 1, 16, 4096, 4096) f32 scores a "
          f"layer): f32 max |dev| {dev32.max().item():.3e} within rtol = atol = {tol} (logits "
          f"up to {dense.abs().max().item():.3f}); bf16 max |dev| {bf16_dev:.3e} (not held: "
          f"bf16 rounding flips); peak memory {peak_gb:.3f} GB")
    out["recurrentgemma"]["f32_chunked_vs_dense"] = dev32.max().item()
    del chunked, dense, dev32
    free()
    # decode == full forward in f32 at full width, one group (rglru, rglru, attn_local)
    n_dec = 16
    cfg3 = dataclasses.replace(cfg32, n_layers=3)
    with torch.inference_mode():
        lm3 = seeded(cfg3)
        steps32, full32 = decode_vs_forward(lm3, cfg3, tokens, n_dec)
        torch.cuda.synchronize()
        del lm3
        free()
    dev = (steps32 - full32).abs()
    if not bool(torch.isfinite(steps32).all()) or bool((dev > 3e-2 + 3e-2 * full32.abs()).any()):
        raise AssertionError(f"recurrentgemma-9b f32 decode != forward: {dev.max().item()}")
    if bool((dev[:, 0] > 1e-4 + 1e-4 * full32[:, 0].abs()).any()):
        raise AssertionError(f"recurrentgemma-9b f32 decode step 0: {dev[:, 0].max().item()}")
    print(stamp() + f"phase 26 recurrentgemma-9b decode == full forward [{card}]: full width, "
          f"one group (rglru, rglru, attn_local), f32, {n_dec} steps: max |decode - forward| "
          f"{dev.max().item():.3e} (step 0: {dev[:, 0].max().item():.3e} <= 1e-4) within "
          f"rtol = atol = 3e-2 (logits up to {full32.abs().max().item():.3f})")
    out["recurrentgemma"]["decode_dev"] = dev.max().item()
    del steps32, full32, dev, tokens
    free()

    # -- (b), (c) mixtral-8x22b and qwen3-moe-235b-a22b, 4 layers at full width -------
    moe_runs = (("mixtral_8x22b", "mixtral-8x22b", 10_418_903_040, 64,
                 "48 heads x 128, GQA 8, SWA 4096, 8 experts top-2 of d_ff 16384, "
                 "vocab 32768"),
                ("qwen3_moe_235b", "qwen3-moe-235b-a22b", 11_195_683_840, 16,
                 "64 heads x 128, GQA 4, qk-norm, 128 experts top-8 of d_ff 1536, "
                 "vocab 151936"))
    for arch, name, want_held, n_gen, shape in moe_runs:
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=4)
        lm = seeded(cfg)
        held = sum(q.numel() for q in lm.parameters())
        if held != want_held or held != cfg.n_params:
            raise AssertionError(f"{name}: {held} parameters, param_count {cfg.n_params}")
        w_bytes = sum(q.numel() * q.element_size() for q in lm.parameters())
        # a decode step reads every weight but the embedding table (4 rows of
        # it): the experts' batched products read all E experts; and the KV
        # caches of max_seq = n_gen + 8 positions
        kv_bytes = (2 * cfg.n_layers * 4 * cfg.n_kv_heads * (n_gen + 8) * cfg.head_dim
                    * lm.embed.element_size())
        step_bytes = (w_bytes - lm.embed.numel() * lm.embed.element_size()
                      + 4 * cfg.d_model * lm.embed.element_size() + kv_bytes)
        res = serve_full_width(torch, build, model_lib, serve_lm, lm, cfg, name, n_gen,
                               step_bytes, device)
        tokens = res["tokens"]
        with torch.inference_mode(), MoERecorder(moe_lib, keep_input=True) as rec:
            logits = model_lib.prefill_logits(lm, cfg, {"tokens": tokens})
        dropped = [float(c["dropped"]) for c in rec.calls]
        cap = moe_lib.capacity(cfg, tokens.numel())
        line = (f"phase 26 {name} [{card}]: full width ({shape}, d_model {cfg.d_model}), depth "
                f"cut to 4 of {full.n_layers} layers, bf16, {held} parameters "
                f"({w_bytes / 1e9:.3f} GB), active {cfg.n_active_params}; " + serve_line(res, n_gen)
                + f" (the {step_bytes / 1e9:.3f} GB a step reads / 3.35 TB/s: every weight but "
                f"the embedding table, all {cfg.n_experts} experts, the KV caches); router_load "
                f"at prefill (T = 2048, capacity {cap}): dropped share a layer "
                f"{[round(d, 5) for d in dropped]}")
        out[arch] = {**{k: res[k] for k in ("prefill_ms", "prefill_tokens_s", "ms_token",
                                            "floor_ms", "x_floor")}, "dropped": dropped}
        if arch == "qwen3_moe_235b":  # the ordered combine: prefill twice, bit-equal
            with torch.inference_mode():
                again = model_lib.prefill_logits(lm, cfg, {"tokens": tokens})
                p0, x0 = rec.first_input
                y1 = moe_lib.moe_ffn(p0, cfg, x0)
                y2 = moe_lib.moe_ffn(p0, cfg, x0)
            if not (torch.equal(again, logits) and torch.equal(y1, y2)):
                raise AssertionError(f"{name}: two prefills (or MoE layers) on the same inputs "
                                     "differ")
            line += "; two prefills on the same inputs bit-equal (logits and layer 0's MoE)"
        print(stamp() + line)
        with torch.inference_mode():
            print(stamp() + profile_breakdown(
                torch, build, lambda: model_lib.prefill_logits(lm, cfg, {"tokens": tokens}), 1,
                card, f"phase 26 {name} prefill (4, 512)", {}, groups=gemms, unit="forward"))
        print(stamp() + profile_breakdown(
            torch, build, lambda: serve_lm.generate(lm, cfg, 4, 4, device), 4, card,
            f"phase 26 {name} decode loop", {}, groups=gemms, unit="token"))
        # one layer's MoE by stage, at the prefill's layer-0 input and at one decode step's
        p0, x0 = rec.first_input
        stages = {}
        with torch.inference_mode():
            for label, x in (("prefill", x0.reshape(-1, cfg.d_model)),
                             ("decode", x0.reshape(-1, cfg.d_model)[:4])):
                x_g, slots, idx = moe_lib.route(p0, cfg, x)
                y_g = moe_lib.experts(p0, cfg, x_g)
                calls = {"route": lambda: moe_lib.route(p0, cfg, x),
                         "experts": lambda: moe_lib.experts(p0, cfg, x_g),
                         "combine": lambda: moe_lib.combine(y_g, slots, idx)}
                # CUDA events beside the profiler: a profiler window can drop device ops
                stages[label] = {k: (cuda_ms(torch, f, 20, 2), *device_busy_ms(torch, f, 3))
                                 for k, f in calls.items()}
        print(stamp() + f"phase 26 {name} MoE stages [{card}]: one layer, ms by CUDA events "
              "(device time by the profiler, device ops it saw): " + "; ".join(
                  f"{label} (T={4 * 512 if label == 'prefill' else 4}): dispatch (router, "
                  f"top-k, sort, searchsorted, scatters, gather) {v['route'][0]:.4f} "
                  f"({v['route'][1]:.4f}, {v['route'][2]}), expert GEMMs "
                  f"{v['experts'][0]:.4f} ({v['experts'][1]:.4f}, {v['experts'][2]}), combine "
                  f"{v['combine'][0]:.4f} ({v['combine'][1]:.4f}, {v['combine'][2]})"
                  for label, v in stages.items()))
        out[arch]["stages"] = {k: {s: v[s][:2] for s in v} for k, v in stages.items()}
        del lm, res, tokens, logits, rec, p0, x0, x_g, slots, idx, y_g
        free()

    # -- (d) the reduced configs: the card against the CPU (f32, TF32 off) --------------
    for arch in ("recurrentgemma_9b", "mixtral_8x22b", "qwen3_moe_235b"):
        small = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
        lm_cpu = model_lib.init_params(small, 0, device="cpu")
        lm_card = copy.deepcopy(lm_cpu).to(device)
        toks = torch.from_numpy(np.random.default_rng(4).integers(0, small.vocab, (2, 16)))
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
        got = {}
        for where, lm_, dev in (("card", lm_card, device), ("cpu", lm_cpu, "cpu")):
            b = {k: v.to(dev) for k, v in batch.items()}
            with torch.inference_mode(), MoERecorder(moe_lib) as rec:
                logits = model_lib.prefill_logits(lm_, small, b)
                loss = model_lib.forward_loss(lm_, small, b)
                state = model_lib.init_decode_state(small, 2, 12, device=dev)
                steps = []
                for pos in range(12):
                    lg, state = model_lib.decode_step(lm_, small, state,
                                                      b["tokens"][:, pos:pos + 1], pos)
                    steps.append(lg)
            got[where] = {"logits": logits.cpu(), "loss": loss.item(),
                          "steps": torch.stack(steps, 1).cpu(),
                          "routes": [c["expert_idx"].cpu() for c in rec.calls]}
        a, b = got["card"], got["cpu"]
        for key in ("logits", "steps"):
            if not torch.allclose(a[key], b[key], rtol=1e-4, atol=1e-4):
                raise AssertionError(f"phase 26 reduced {arch}: {key} card != CPU, "
                                     f"{(a[key] - b[key]).abs().max().item()}")
        if abs(a["loss"] - b["loss"]) > 1e-5 * abs(b["loss"]):
            raise AssertionError(f"phase 26 reduced {arch}: loss {a['loss']} != {b['loss']}")
        if len(a["routes"]) != len(b["routes"]) or not all(
                torch.equal(x, y) for x, y in zip(a["routes"], b["routes"])):
            raise AssertionError(f"phase 26 reduced {arch}: MoE expert assignments differ")
        print(stamp() + f"phase 26 reduced {arch} [{card}]: f32, TF32 off: prefill logits, 12 "
              f"decode steps (max |dev| {(a['steps'] - b['steps']).abs().max().item():.3e}) "
              f"and forward_loss ({a['loss']:.6f}) on the card == CPU; "
              f"{len(a['routes'])} MoE calls with equal expert assignments")
        del lm_card
        free()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 26 done in {out['seconds']:.1f} s")
    return out


# -- phase 27: the vlm and encdec families at full width -------------------------------
# llama-3.2-vision-11b (40 layers, 8 of them gated cross-attention layers) and
# whisper-medium (24 + 24 layers) at full width and depth, bf16 on seeded
# weights; no hand-written kernel is on these paths (cross-attention is
# einsums and an f32 softmax, the products cuBLAS).  The vlm's gates are set
# to 1.0 after init: JAX makes them 0, and a zero gate adds exactly 0.  Decode
# floors: max(the bytes a step reads / 3.35 TB/s, its flops / 989e12) where
# each cross layer projects its K/V from the whole context again every step,
# as JAX's decode does (no cross K/V cache).  Tolerances: decode == forward in
# f32 as phase 26 (rtol = atol = 3e-2, step 0 within 1e-4); reduced f32 configs
# on the card against the CPU with TF32 off: logits and decode steps rtol =
# atol = 1e-4, the loss within 1e-5 relative.
VLM_HELD = 9_775_157_256  # param_count says 9,775,190,016 (each gate counted as d)
WHISPER_HELD = 810_987_520  # param_count says 810,986,496 (no enc_norm)


def decode_vs_forward_ctx(torch, model_lib, forward, model, cfg, tokens, n_steps: int, ctx):
    """Decode logits of ``n_steps`` steps over ``ctx`` and the full
    forward's (``forward(tokens) -> hidden``) at each position: (B, n, V)."""
    from repro_torch.models import transformer as tf

    hidden = forward(tokens[:, :n_steps])
    full = torch.stack([tf.last_logits(model, cfg, hidden[:, :p + 1])
                        for p in range(n_steps)], 1)
    state = model_lib.init_decode_state(cfg, tokens.shape[0], n_steps, device=tokens.device)
    steps = []
    for p in range(n_steps):
        logits, state = model_lib.decode_step(model, cfg, state, tokens[:, p:p + 1], p, ctx=ctx)
        steps.append(logits)
    return torch.stack(steps, 1), full


def check_decode_vs_forward(torch, steps, full, what: str) -> float:
    dev = (steps - full).abs()
    if not bool(torch.isfinite(steps).all()) or bool((dev > 3e-2 + 3e-2 * full.abs()).any()):
        raise AssertionError(f"{what} f32 decode != forward: {dev.max().item()}")
    if bool((dev[:, 0] > 1e-4 + 1e-4 * full[:, 0].abs()).any()):
        raise AssertionError(f"{what} f32 decode step 0: {dev[:, 0].max().item()}")
    return dev.max().item()


def decode_step_work(lm, cfg, role, n_ctx: int, batch: int, cache_len: int, n_cross: int,
                     n_self: int) -> dict:
    """The bytes a decode step of B=``batch`` must read and the flops it
    must do: every weight but the embedding table (its B rows), the KV
    caches of ``cache_len`` positions of the ``n_self`` self-attention
    layers, and the context of ``n_ctx`` positions once for each of the
    ``n_cross`` cross layers, whose K/V projections (``wk``, ``wv``) run
    over that context again every step; the rest of the products run over
    the B tokens.  ``role(name)`` is "cross" for a cross layer's K/V
    projection, "skip" for a tensor the step never reads, else "token"."""
    esz = lm.embed.element_size()
    d, hd, h, kv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    read = tok_params = ctx_params = 0
    for name, p in lm.named_parameters():
        kind = role(name)
        if kind == "skip":
            continue
        if name == "embed":
            read += batch * d * esz
            continue
        read += p.numel() * p.element_size()
        if p.dim() >= 2:
            if kind == "cross":
                ctx_params += p.numel()
            else:
                tok_params += p.numel()
    read += n_cross * batch * n_ctx * d * esz  # the context, once a cross layer
    read += n_self * 2 * batch * kv * cache_len * hd * esz  # the KV caches
    flops = (2 * batch * tok_params + 2 * batch * n_ctx * ctx_params
             + n_cross * 4 * batch * h * hd * n_ctx  # cross scores and values
             + n_self * 4 * batch * h * hd * cache_len)  # self scores over the cache
    return {"bytes": read, "flops": flops,
            "cross_kv_flops": 2 * batch * n_ctx * ctx_params}


def vlm_encdec_phases(torch, np, build, device, card: str) -> dict:
    """Phase 27: the vlm family (llama-3.2-vision-11b) and the encdec
    family (whisper-medium) at full width and depth on the card, and their
    reduced configs card == CPU.  Returns the numbers PERF.md keeps."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve_lm
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer as tf
    from repro_torch.models import whisper

    t_phase = time.perf_counter()

    def stamp() -> str:
        return f"[{time.perf_counter() - t_phase:.1f} s] "

    def seeded(cfg):
        return model_lib.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                                     device=device)

    def normal(shape, seed, dtype=torch.float32):
        return torch.randn(shape, device=device,
                           generator=torch.Generator(device=device).manual_seed(seed)).to(dtype)

    def free():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def open_gates(lm, value=1.0):
        with torch.no_grad():
            for layer in lm.layers:
                if isinstance(layer, tf.CrossBlock):
                    layer.attn.gate.fill_(value)

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the f32 checks below need full f32")
    gemms = {"matmul": ("gemm", "gemv", "xmma", "cutlass", "nvjet", "splitk")}
    out = {}
    n_dec = 16

    # -- (a) llama-3.2-vision-11b at full width and depth, bf16 -------------------------
    cfg = get_config("llama32_vision_11b")
    torch.cuda.reset_peak_memory_stats()
    lm = seeded(cfg)
    held = sum(q.numel() for q in lm.parameters())
    if held != VLM_HELD or cfg.n_params != 9_775_190_016:
        raise AssertionError(f"llama-3.2-vision-11b holds {held} parameters (param_count "
                             f"{cfg.n_params})")
    kinds = tf.layer_kinds(cfg)
    cross_at = [i for i, k in enumerate(kinds) if k == "cross"]
    open_gates(lm)
    w_bytes = sum(q.numel() * q.element_size() for q in lm.parameters())
    img = normal((4, cfg.img_tokens, cfg.d_model), 2, cfg.compute_dtype)
    n_gen = 32

    def vlm_role(name):
        parts = name.split(".")
        if parts[0] == "layers" and int(parts[1]) in cross_at and parts[-1] in ("wk", "wv"):
            return "cross"
        return "token"

    work = decode_step_work(lm, cfg, vlm_role, cfg.img_tokens, 4, n_gen + 8, len(cross_at),
                            len(kinds) - len(cross_at))
    res = serve_full_width(torch, build, model_lib, serve_lm, lm, cfg, "llama-3.2-vision-11b",
                           n_gen, work["bytes"], device, extra={"img": img}, ctx=img,
                           floor_flops=work["flops"])
    tokens = res["tokens"]
    print(stamp() + f"phase 27 llama-3.2-vision-11b [{card}]: full width and depth (40 layers, "
          f"cross-attention at {cross_at}, gates 1.0; d_model 4096, 32 heads x 128, GQA 8, "
          f"SwiGLU 14336, vocab 128256, bf16), {held} parameters ({w_bytes / 1e9:.3f} GB; "
          f"param_count {cfg.n_params}), image context (4, {cfg.img_tokens}, {cfg.d_model}); "
          + serve_line(res, n_gen) + f" (max of {work['bytes'] / 1e9:.3f} GB a step / 3.35 "
          f"TB/s = {res['floor_bytes_ms']:.3f} ms: every weight but the embedding table, the "
          f"KV caches, the context once a cross layer; and {work['flops'] / 1e12:.4f} TFLOP / "
          f"989e12 = {res['floor_flops_ms']:.3f} ms, of it the cross K/V recompute "
          f"{work['cross_kv_flops'] / 1e12:.4f} TFLOP; set by {res['floor_by']})")
    # the gates decide: at 0 every cross layer adds exactly 0
    with torch.inference_mode():
        open_gates(lm, 0.0)
        shut = model_lib.prefill_logits(lm, cfg, {"tokens": tokens, "img": img})
        other = model_lib.prefill_logits(lm, cfg, {"tokens": tokens, "img": normal(
            img.shape, 5, cfg.compute_dtype)})
        open_gates(lm, 1.0)
        opened = model_lib.prefill_logits(lm, cfg, {"tokens": tokens, "img": img})
    gate_dev = (opened - shut).abs().max().item()
    if not torch.equal(shut, other) or not gate_dev > 1e-2 or not torch.equal(opened,
                                                                             res["logits"]):
        raise AssertionError(f"llama-3.2-vision-11b: the gates do not decide (|1.0 - 0| "
                             f"{gate_dev}, gates 0 image-free {torch.equal(shut, other)})")
    print(stamp() + f"phase 27 llama-3.2-vision-11b gates [{card}]: prefill logits with the "
          f"gates at 0 equal for two images (a cross layer adds exactly 0) and differ from "
          f"the gates at 1.0 by up to {gate_dev:.4f}")
    with torch.inference_mode():
        print(stamp() + profile_breakdown(
            torch, build, lambda: model_lib.prefill_logits(lm, cfg, {"tokens": tokens,
                                                                     "img": img}), 1,
            card, "phase 27 llama-3.2-vision-11b prefill (4, 512)", {}, groups=gemms,
            unit="forward"))
        h = normal((4, 512, cfg.d_model), 6, cfg.compute_dtype)
        crosses = [lm.layers[i].attn for i in cross_at]

        def cross_prefill():
            for a in crosses:
                attn_lib.cross_attention(a, cfg, h, img, gated=True)

        # one call a profiler window: a window's trace of a decode step's ~3,000
        # device ops (and their host ops) takes the host seconds to read.  The
        # cross K/V recompute is read from the decode step's own window: the
        # kernels under its GEMMs' host ops, picked by their shapes
        ca_ms, ca_ops = device_busy_ms(torch, cross_prefill)
        state = model_lib.init_decode_state(cfg, 4, n_gen + 8, device=device)
        tok = tokens[:, :1]
        step_ms, step_ops, kv_ms, kv_n = device_part_ms(
            torch, lambda: model_lib.decode_step(lm, cfg, state, tok, 0, ctx=img),
            gemm_pick(4 * cfg.img_tokens, cfg.d_model, cfg.n_kv_heads * cfg.head_dim))
        del state
    print(stamp() + f"phase 27 llama-3.2-vision-11b cross-attention [{card}]: the 8 cross "
          f"layers' cross_attention at the prefill's shapes (4, 512) over (4, 1601) "
          f"{ca_ms:.3f} ms device time ({ca_ops} device ops); one decode step "
          f"{step_ms:.3f} ms device time ({step_ops} device ops), of it the cross K/V "
          f"recompute {kv_ms:.3f} ms ({kv_n} GEMMs, the same profiler window) = "
          f"{kv_ms / step_ms:.3f} (its flops floor "
          f"{1e3 * work['cross_kv_flops'] / BF16_FLOPS_PER_S:.3f} ms)")
    if kv_n != 2 * len(cross_at):
        raise AssertionError(f"llama-3.2-vision-11b: {kv_n} cross K/V GEMMs in a decode step")
    print(stamp() + profile_breakdown(
        torch, build, lambda: serve_lm.generate(lm, cfg, 4, 4, device, ctx=img), 4, card,
        "phase 27 llama-3.2-vision-11b decode loop", {}, groups=gemms, unit="token"))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    out["llama32_vision"] = {**{k: res[k] for k in (
        "prefill_ms", "prefill_tokens_s", "ms_token", "floor_ms", "floor_bytes_ms",
        "floor_flops_ms", "x_floor")}, "gate_dev": gate_dev, "cross_prefill_ms": ca_ms,
        "cross_kv_ms": kv_ms, "step_device_ms": step_ms, "peak_gb": peak_gb}
    del lm, res, shut, other, opened, h, crosses
    free()
    # decode == full forward in f32 at full width, one group (attn x 3, cross, attn)
    cfg5 = dataclasses.replace(cfg, n_layers=5, dtype="float32")
    with torch.inference_mode():
        lm5 = seeded(cfg5)
        open_gates(lm5)
        img32 = img.float()
        steps32, full32 = decode_vs_forward_ctx(
            torch, model_lib, lambda t: tf.backbone(lm5, cfg5, t, ctx=img32), lm5, cfg5,
            tokens, n_dec, img32)
        torch.cuda.synchronize()
        del lm5
        free()
    dev = check_decode_vs_forward(torch, steps32, full32, "llama-3.2-vision-11b")
    print(stamp() + f"phase 27 llama-3.2-vision-11b decode == full forward [{card}]: full "
          f"width, one group (attn, attn, attn, cross, attn; gate 1.0), f32, {n_dec} steps "
          f"over the image: max |decode - forward| {dev:.3e} (step 0: "
          f"{(steps32 - full32)[:, 0].abs().max().item():.3e} <= 1e-4) within rtol = atol = "
          f"3e-2 (logits up to {full32.abs().max().item():.3f})")
    out["llama32_vision"]["decode_dev"] = dev
    del steps32, full32, img, img32, tokens
    free()

    # -- (b) whisper-medium at full width and depth, bf16 ---------------------------------
    cfg = get_config("whisper_medium")
    torch.cuda.reset_peak_memory_stats()
    lm = seeded(cfg)
    held = sum(q.numel() for q in lm.parameters())
    if held != WHISPER_HELD or cfg.n_params != 810_986_496:
        raise AssertionError(f"whisper-medium holds {held} parameters (param_count "
                             f"{cfg.n_params})")
    w_bytes = sum(q.numel() * q.element_size() for q in lm.parameters())
    frames = normal((4, cfg.enc_seq, cfg.d_model), 2)
    with torch.inference_mode():
        enc_ms = cuda_ms(torch, lambda: whisper.encode(lm, cfg, frames), 5)
        enc_out = whisper.encode(lm, cfg, frames)
    if (tuple(enc_out.shape) != (4, cfg.enc_seq, cfg.d_model)
            or not bool(torch.isfinite(enc_out).all())):
        raise AssertionError(f"whisper-medium encode: {tuple(enc_out.shape)} not finite")
    n_gen = 32

    def whisper_role(name):
        parts = name.split(".")
        if parts[0] in ("enc", "enc_norm"):
            return "skip"  # the encoder ran once, before the decode loop
        if parts[0] == "dec" and parts[2] == "cross" and parts[-1] in ("wk", "wv"):
            return "cross"
        return "token"

    work = decode_step_work(lm, cfg, whisper_role, cfg.enc_seq, 4, n_gen + 8, cfg.n_layers,
                            cfg.n_layers)
    res = serve_full_width(torch, build, model_lib, serve_lm, lm, cfg, "whisper-medium",
                           n_gen, work["bytes"], device, seq=448, extra={"frames": frames},
                           ctx=enc_out, floor_flops=work["flops"])
    tokens = res["tokens"]
    print(stamp() + f"phase 27 whisper-medium [{card}]: full width and depth (24 encoder + "
          f"24 decoder layers, d_model 1024, MHA 16 x 64, GELU 4096, vocab 51865, bf16), "
          f"{held} parameters ({w_bytes / 1e9:.3f} GB; param_count {cfg.n_params}), frames "
          f"(4, {cfg.enc_seq}, {cfg.d_model}); encode {enc_ms:.3f} ms (CUDA events, 5 calls) "
          f"= {4 * cfg.enc_seq / enc_ms * 1e3:.1f} frames/s; " + serve_line(res, n_gen)
          + f" (prefill includes the encoder; max of {work['bytes'] / 1e9:.4f} GB a step / "
          f"3.35 TB/s = {res['floor_bytes_ms']:.3f} ms: the decoder's weights but the "
          f"embedding table, the KV caches, the encoder output once a cross layer; and "
          f"{work['flops'] / 1e12:.4f} TFLOP / 989e12 = {res['floor_flops_ms']:.3f} ms, of it "
          f"the cross K/V recompute {work['cross_kv_flops'] / 1e12:.4f} TFLOP; set by "
          f"{res['floor_by']})")
    with torch.inference_mode():
        print(stamp() + profile_breakdown(
            torch, build, lambda: model_lib.prefill_logits(lm, cfg, {"tokens": tokens,
                                                                     "frames": frames}), 1,
            card, "phase 27 whisper-medium prefill (4, 448) with the encoder", {},
            groups=gemms, unit="forward"))
        state = model_lib.init_decode_state(cfg, 4, n_gen + 8, device=device)
        tok = tokens[:, :1]
        step_ms, step_ops, kv_ms, kv_n = device_part_ms(
            torch, lambda: model_lib.decode_step(lm, cfg, state, tok, 0, ctx=enc_out),
            gemm_pick(4 * cfg.enc_seq, cfg.d_model, cfg.n_kv_heads * cfg.head_dim))
        del state
    print(stamp() + f"phase 27 whisper-medium decode step [{card}]: {step_ms:.3f} ms device "
          f"time ({step_ops} device ops) a step, of it the 24 cross layers' K/V recompute "
          f"from the encoder output {kv_ms:.3f} ms ({kv_n} GEMMs, the same profiler "
          f"window) = {kv_ms / step_ms:.3f} of the step's device time (its flops floor "
          f"{1e3 * work['cross_kv_flops'] / BF16_FLOPS_PER_S:.3f} ms)")
    if kv_n != 2 * cfg.n_layers:
        raise AssertionError(f"whisper-medium: {kv_n} cross K/V GEMMs in a decode step")
    print(stamp() + profile_breakdown(
        torch, build, lambda: serve_lm.generate(lm, cfg, 4, 4, device, ctx=enc_out), 4, card,
        "phase 27 whisper-medium decode loop", {}, groups=gemms, unit="token"))
    out["whisper"] = {**{k: res[k] for k in (
        "prefill_ms", "prefill_tokens_s", "ms_token", "floor_ms", "floor_bytes_ms",
        "floor_flops_ms", "x_floor")}, "encode_ms": enc_ms, "cross_kv_ms": kv_ms,
        "step_device_ms": step_ms, "cross_kv_share": kv_ms / step_ms,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del lm, res, enc_out
    free()
    # decode == full forward in f32 at full width and depth (3.2 GB of weights)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with torch.inference_mode():
        lm32 = seeded(cfg32)
        enc32 = whisper.encode(lm32, cfg32, frames)
        steps32, full32 = decode_vs_forward_ctx(
            torch, model_lib, lambda t: whisper.decoder(lm32, cfg32, t, enc32), lm32, cfg32,
            tokens, n_dec, enc32)
        torch.cuda.synchronize()
        del lm32, enc32
        free()
    dev = check_decode_vs_forward(torch, steps32, full32, "whisper-medium")
    print(stamp() + f"phase 27 whisper-medium decode == full forward [{card}]: full width "
          f"and depth, f32, {n_dec} steps over the encoded frames: max |decode - forward| "
          f"{dev:.3e} (step 0: {(steps32 - full32)[:, 0].abs().max().item():.3e} <= 1e-4) "
          f"within rtol = atol = 3e-2 (logits up to {full32.abs().max().item():.3f})")
    out["whisper"]["decode_dev"] = dev
    del steps32, full32, frames, tokens
    free()

    # -- (c) the reduced configs: the card against the CPU (f32, TF32 off) --------------
    for arch in ("llama32_vision_11b", "whisper_medium"):
        small = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
        lm_cpu = model_lib.init_params(small, 0, device="cpu")
        if small.family == "vlm":
            open_gates(lm_cpu)
        lm_card = copy.deepcopy(lm_cpu).to(device)
        rng = np.random.default_rng(4)
        toks = torch.from_numpy(rng.integers(0, small.vocab, (2, 16)))
        n = small.img_tokens if small.family == "vlm" else small.enc_seq
        ctx_np = rng.normal(size=(2, n, small.d_model)).astype(np.float32)
        key = "img" if small.family == "vlm" else "frames"
        got = {}
        for where, lm_, dev in (("card", lm_card, device), ("cpu", lm_cpu, "cpu")):
            b = {"tokens": toks.to(dev), "labels": torch.roll(toks, -1, dims=1).to(dev),
                 key: torch.from_numpy(ctx_np).to(dev)}
            with torch.inference_mode():
                logits = model_lib.prefill_logits(lm_, small, b)
                loss = model_lib.forward_loss(lm_, small, b)
                ctx = b[key] if key == "img" else whisper.encode(lm_, small, b[key])
                state = model_lib.init_decode_state(small, 2, 12, device=dev)
                steps = []
                for pos in range(12):
                    lg, state = model_lib.decode_step(lm_, small, state,
                                                      b["tokens"][:, pos:pos + 1], pos, ctx=ctx)
                    steps.append(lg)
            got[where] = {"logits": logits.cpu(), "loss": loss.item(),
                          "steps": torch.stack(steps, 1).cpu()}
        a, b = got["card"], got["cpu"]
        for k in ("logits", "steps"):
            if not torch.allclose(a[k], b[k], rtol=1e-4, atol=1e-4):
                raise AssertionError(f"phase 27 reduced {arch}: {k} card != CPU, "
                                     f"{(a[k] - b[k]).abs().max().item()}")
        if abs(a["loss"] - b["loss"]) > 1e-5 * abs(b["loss"]):
            raise AssertionError(f"phase 27 reduced {arch}: loss {a['loss']} != {b['loss']}")
        print(stamp() + f"phase 27 reduced {arch} [{card}]: f32, TF32 off"
              + (", gates 1.0" if small.family == "vlm" else "") + f", a {key} context: "
              f"prefill logits, 12 decode steps (max |dev| "
              f"{(a['steps'] - b['steps']).abs().max().item():.3e}) and forward_loss "
              f"({a['loss']:.6f}) on the card == CPU")
        del lm_card
        free()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 27 done in {out['seconds']:.1f} s")
    return out


# The serial chains' latency floor.  Only the key chain is serial whatever
# the design: step m+1's key is fold_in(step m's key, 0), one Threefry
# block, and the draws of a step hang off its key.  A block's dependent
# chain is THREEFRY_DEPTH instructions (each round's add then xor, the
# rotate issuing beside the add; one add a key injection) of its 72, ~4
# cycles each (Hopper's integer ALU latency) at 1.98 GHz.
THREEFRY_DEPTH = 2 * 20 + 5
CHAIN_CYCLES_PER_INSTRUCTION = 4
CLOCK_HZ = 1.98e9
# instructions a monomer costs the HP contact scan (loads, the occupancy
# test and two Manhattan tests), and a flip its site arithmetic
HP_SCAN_OPS = 12
FLIP_SITE_OPS = 20


def chain_floor_ms(steps: int) -> float:
    """Least time of one chain of ``steps`` keys: the key walk's blocks in
    series at ``CHAIN_CYCLES_PER_INSTRUCTION``."""
    return 1e3 * steps * THREEFRY_DEPTH * CHAIN_CYCLES_PER_INSTRUCTION / CLOCK_HZ


def serial_bound(ops: float, n_bytes: float, steps: int) -> tuple:
    """(ms, bound by, parts): the least time the card could take, the
    largest of the operations at the issue rate, the bytes at HBM rate and
    one chain's key walk of ``steps`` keys (operations too, in series), and
    each of the three (ms)."""
    parts = {"operations": 1e3 * ops / INT32_OPS_PER_S,
             "bytes": 1e3 * n_bytes / HBM_BYTES_PER_S, "key walk": chain_floor_ms(steps)}
    least = max(parts.values())
    return least, "bytes" if least == parts["bytes"] else "operations", parts


def bound_text(bound: tuple) -> str:
    """`serial_bound`'s result for a print line."""
    return (f"bound {bound[0]:.5f} ms by {bound[1]}, the most of " + ", ".join(
        f"{what} {ms:.5f}" for what, ms in bound[2].items()))


def bound_hp(work: dict, moves: int, n: int, steps: int) -> tuple:
    """`serial_bound` of ``hp_moves_kernel`` for the work its data needs: 6
    Threefry blocks a move (next key, site key, randint's two keys and two
    words), 5 more an end move (direction), 2 more a tested move (the
    uniform) and the chain scan of a move to a new site, at the issue rate;
    the chains in and out, the per-replica p rows and the outputs; and a
    chain's ``steps`` keys (its moves)."""
    r = work["replicas"]
    blocks = 6 * moves + 5 * work["ends"] + 2 * work["tested"]
    ops = blocks * THREEFRY_OPS + HP_SCAN_OPS * n * work["evaluated"]
    n_bytes = r * (2 * 8 * n + 4 * 7 + 4 + 4) + n + 4 * 7
    return serial_bound(ops, n_bytes, steps)


def bound_flips(r: int, flips: int, length: int) -> tuple:
    """`serial_bound` of ``single_flip_kernel``: 10 Threefry blocks a flip
    (next key, site key, randint's two keys and four words, uniform key and
    word) and its site arithmetic at the issue rate; the lattice read and
    written once (L^2 bytes a replica each way), the p rows and the outputs;
    and one chain's ``flips`` keys."""
    ops = r * flips * (10 * THREEFRY_OPS + FLIP_SITE_OPS)
    n_bytes = r * (2 * length * length + 4 * 10 + 4 + 4) + 4 * 10
    return serial_bound(ops, n_bytes, flips)


def check_serial_chains(torch, np, sc, keys, device):
    """Phase 20: both serial-chain kernels == their plain versions on the
    card, bit for bit (states, ΔE, counts), over several launches each
    continuing the last; returns the number of cases."""
    from repro_torch.core.hp import HPChain

    rng = np.random.default_rng(200)
    n_cases = 0
    # N > 32 puts several monomers on a lane; R = 1, 33, 1501 leave a block's
    # warps idle (four replicas a block)
    seq20 = "HPHPPHHPHHPHPHHPPHPH"
    hp_cases = (("HPH", 13, 1.0), ("HHPPHPH", 64, 0.7), ("HPHPPHHPHH", 13, 1.0),
                (seq20, 1500, 1.0), (seq20, 7, 1.3), (seq20, 1, 1.0),
                ((seq20 * 2)[:33], 33, 1.0), ((seq20 * 3)[:48], 1501, 0.8))
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
    # flip counts around a 128-flip tile; L=5 (and 2) with 300 flips, where
    # every flip collides with an earlier one
    flip_cases = ((5, 13, 1, "metropolis", 1.0, 0.0), (5, 13, 7, "glauber", 0.7, 0.3),
                  (7, 13, 300, "metropolis", 1.0, 0.3), (6, 64, 300, "glauber", 1.0, 0.0),
                  (301, 64, 300, "glauber", 1.0, 0.0), (300, 1500, 300, "glauber", 1.0, 0.0),
                  (300, 1500, 7, "metropolis", 0.7, 0.3), (5, 33, 300, "metropolis", 1.0, 0.0),
                  (2, 33, 300, "glauber", 0.7, 0.3), (9, 33, 128, "metropolis", 1.0, 0.3),
                  (9, 1, 129, "glauber", 0.7, 0.0), (9, 1, 255, "glauber", 1.0, 0.0),
                  (9, 1501, 256, "metropolis", 0.7, 0.3), (10, 33, 257, "glauber", 1.0, 0.3),
                  (31, 33, 1000, "glauber", 0.7, 0.3), (300, 1, 1000, "metropolis", 1.0, 0.0))
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
    out["hp_moves"] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain,
                       "bound": bound_hp(work, r * n, n, n), "work": work}
    length, flips = 300, 300
    spins = torch.from_numpy(np.random.default_rng(9).choice(
        np.array([-1, 1], np.int8), size=(r, length, length))).to(device)
    kw = dict(j=1.0, b=0.0, rule="glauber", flips=flips)
    ms = cuda_ms(torch, lambda: sc.single_flip_kernel(spins, key, t, betas, **kw), 20, 2)
    dev_ms, _ = profiler_ms(torch, lambda: sc.single_flip_kernel(spins, key, t, betas, **kw),
                            10, "single_flip_kernel")
    plain = cuda_ms(torch, lambda: sc.single_flip_plain(spins, key, t, betas, **kw), 1)
    out["single_flip"] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain,
                          "bound": bound_flips(r, flips, length)}
    # one chain's critical path a step, read directly: R=1, 10000 steps
    # (single_flip at L=300; HP's 20-mer, from the folded chains), by CUDA
    # events: a launch takes 1.5-4 ms, which hides the wrapper's host time
    # (the profiler's device time dropped a launch's duration once)
    steps = 10000
    one = {"single_flip": lambda: sc.single_flip_kernel(
               spins[:1].contiguous(), key, t, betas[:1], **dict(kw, flips=steps)),
           "hp_moves": lambda: sc.hp_moves_kernel(
               pos[:1].contiguous(), key, t, betas[:1], hmask=hmask, eps=1.0, n_moves=steps)}
    for name, fn in one.items():
        out[name]["step_us"] = 1e3 * cuda_ms(torch, fn, 5) / steps
    return out


# The Gaussian conformance entry is host-bound (the torch Threefry's launches:
# 148 s at its full 1200 + 8 x 400 sweeps a chain).  Its batches are cut to
# 100 sweeps (1200 + 8 x 100), the burn and its two retunes kept: the run is
# the CPU's, which passes it at seeds 0-3 (worst |z| 1.00-1.53, Geweke
# <= 1.74); a burn of 600 fails Geweke (4.10 at seed 0).
GAUSSIAN_CUT = {"sweeps_per_batch": 100}


CONFORMANCE_ENTRIES = ("ea_spin_glass", "gaussian", "hp_protein")


def conformance_entry(registry, name: str):
    entry = registry[name]
    return dataclasses.replace(entry, **GAUSSIAN_CUT) if name == "gaussian" else entry


def conformance_child(index: int, names: tuple, outdir: str) -> None:
    """Phase 20's conformance entry ``names[index]`` on the card, in a
    spawned process: its report, wall seconds and launch counts pickled to
    ``OUTDIR/<name>.pkl``.  A failed kernel preparation or launch raises,
    as in the main process."""
    sys.path.insert(0, str(SRC))
    import pickle

    import torch

    from repro_torch.core.systems import REGISTRY
    from repro_torch.kernels import build
    from repro_torch.validate import run_conformance

    warnings.filterwarnings("error", message="kernel preparation or launch failed")
    torch.cuda.set_device(0)
    name = names[index]
    build.reset_launches()
    t = time.perf_counter()
    report = run_conformance(conformance_entry(REGISTRY, name), seed=0, device="cuda")
    wall = time.perf_counter() - t
    with open(os.path.join(outdir, f"{name}.pkl"), "wb") as f:
        pickle.dump((report, wall, counts_now(build)), f)


def zoo_phases(torch, np, build, keys, sc, api, device, card) -> dict:
    """Phase 20: the rest of the system zoo on the card.

    The two serial-chain kernels against their plain versions; the EA spin
    glass (the paper's widths, 300x300 R=1500, per-sweep path, temp and
    state mode), HP on the 20-mer of ``benchmarks/systems_bench.py`` at
    R=1500, Ising ``single_flip`` at L=300 R=1500 (300 flips a step) and the
    Gaussian mixture at R=1500 through ``Session``, each with its launches
    counted from 0 just before its run; the zoo's EA and HP conformance
    entries at their full schedules and the Gaussian's at `GAUSSIAN_CUT`,
    side by side in spawned processes (`conformance_child`); small specs of the four paths on the card against the CPU.  Returns the
    kernel rows' numbers.
    """
    from repro_torch.core.systems import REGISTRY
    from repro_torch.validate import assert_conforms

    AdaptSpec, EngineSpec, LadderSpec = api.AdaptSpec, api.EngineSpec, api.LadderSpec
    PhaseSpec, RunSpec, ScheduleSpec = api.PhaseSpec, api.RunSpec, api.ScheduleSpec
    Session, SystemSpec = api.Session, api.SystemSpec
    build.reset_launches()
    n_cases, n_hp, n_flip = check_serial_chains(torch, np, sc, keys, device)
    expect_launches(counts_now(build), "phase 20 kernel checks", hp_moves=4 * n_hp,
                    single_flip=2 * n_flip)
    print(f"phase 20 serial chains: {n_cases} cases equal to plain bit for bit (positions / "
          f"spins, ΔE, nacc): hp_moves at N = 3, 7, 10, 20, 33, 48 (R = 1, 7, 13, 33, 64, "
          f"1500, 1501; eps 0.7-1.3; 4 launches each from folded chains), single_flip at "
          f"L = 2, 5, 6, 7, 9, 10, 31, 300, 301 (R = 1 to 1501; 1, 7, 128, 129, 255, 256, 257, "
          f"300 and 1000 flips; metropolis and glauber; j=0.7 b=0.3 too; 2 launches each)")
    seq20 = "HPHPPHHPHHPHPHHPPHPH"  # benchmarks/systems_bench.py
    times = time_serial_chains(torch, np, sc, keys, device, seq20)
    for name, tm in times.items():
        print(f"phase 20 times [{card}]: {name} {tm['ms']:.4f} ms by CUDA events (the "
              f"wrapper's host time included), {tm['device_ms']:.4f} ms device time "
              f"(profiler), vs plain "
              f"{tm['plain_ms']:.4f} ms ({bound_text(tm['bound'])}; device time / bound "
              f"{tm['device_ms'] / tm['bound'][0]:.3f}); one chain at R=1, 10000 "
              f"steps: {tm['step_us']:.5f} µs a step (CUDA events / 10000; key walk "
              f"{1e3 * chain_floor_ms(1):.5f} µs a step)"
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

    # the three entries are host-bound (tiny systems, a few launches a sweep): each runs in
    # a spawned process of its own, side by side on the card
    import pickle
    import shutil

    import torch.multiprocessing as mp

    work = Path(tempfile.mkdtemp(prefix="conf_", dir=ROOT / "build"))
    t = time.perf_counter()
    mp.start_processes(conformance_child, args=(CONFORMANCE_ENTRIES, str(work)),
                       nprocs=len(CONFORMANCE_ENTRIES), start_method="spawn")
    conf_s = time.perf_counter() - t
    conf = {}
    for name in CONFORMANCE_ENTRIES:
        entry = conformance_entry(REGISTRY, name)
        with open(work / f"{name}.pkl", "rb") as f:
            report, wall_c, counts = pickle.load(f)
        sweeps = entry.n_chains * (entry.burn_sweeps + entry.n_batches * entry.sweeps_per_batch)
        want = {"ea_spin_glass": {"jax_uniform": sweeps}, "gaussian": {},
                "hp_protein": {"hp_moves": sweeps}}[name]
        expect_launches(counts, f"conformance {name}", **want)
        assert_conforms(report, z_max=4.0, geweke_max=4.0)
        if report.n_retunes != entry.adapt_rounds:
            raise AssertionError(f"conformance {name}: {report.n_retunes} retunes")
        conf[name] = (report, wall_c, counts)
    shutil.rmtree(work, ignore_errors=True)
    print(f"phase 20 conformance [{card}]: the zoo's entries on the card (EA and HP at full "
          f"schedule, the Gaussian at {GAUSSIAN_CUT}), each in a process of its own, side by "
          f"side ({conf_s:.2f} s for the three with their start), "
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


# -- phase 22: the chain axis, and serving on the card -------------------------

# (C, L, R, S) of the chain-axis checks: every C in {1, 2, 5}, L in {8, 32,
# 300}, R in {8, 1500} and S in {1, 100} appears
CHAIN_CASES = ((1, 8, 8, 100), (2, 32, 1500, 1), (5, 8, 1500, 1), (5, 32, 8, 100),
               (2, 300, 1500, 1), (2, 300, 8, 100), (1, 300, 1500, 1))


def chain_inputs(torch, np, keys, kernel, c, length, r, seed, device):
    """Random (C, R, L, L) states, a shared (R,) ladder, per-chain rung
    permutations, energies, keys and counters for a chain-axis launch."""
    rng = np.random.default_rng(seed)
    # the lattices are drawn on the card: numpy takes seconds for a 1e9-site ensemble
    gen = torch.Generator(device=device).manual_seed(seed)
    st = torch.randint(0, 3 if kernel == "potts_fused" else 2, (c, r, length, length),
                       generator=gen, device=device, dtype=torch.int8)
    if kernel != "potts_fused":
        st = 2 * st - 1
    betas = (1.0 / np.geomspace(1.0, 4.0, r)).astype(np.float32)
    rung = np.stack([rng.permutation(r) for _ in range(c)]).astype(np.int32)
    energy = -rng.integers(0, 2 * length * length, (c, r)).astype(np.float32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    words = torch.stack([keys.key(seed + i, device=device) for i in range(c)])
    t0 = to(rng.integers(0, 1000, c).astype(np.int64))
    ph0 = to(rng.integers(0, 1000, c).astype(np.int64))
    return st, to(betas), to(rung), to(energy), words, t0, ph0


def chain_launchers(isk, pk, kernel):
    """``(sweeps, round)`` wrappers of one kernel, same keywords each."""
    if kernel == "potts_fused":
        return (lambda *a, **k: pk.potts_sweep_fused_kernel(*a, q=3, **k),
                lambda *a, **k: pk.potts_round_kernel(*a, q=3, **k))
    packed = kernel == "ising_packed"
    sweeps = isk.ising_sweep_packed_kernel if packed else isk.ising_sweep_fused_kernel
    return sweeps, lambda *a, **k: isk.ising_round_kernel(*a, pack_bits=packed, **k)


def check_chain_axis(torch, np, isk, pk, keys, build) -> int:
    """Phase 22a: one launch over C chains equals C launches of one chain
    each, bit for bit, for the sweeps and the round launches of kernels A,
    #2p and #5 (spins, ΔE, counts; rung', energy', accept, prob and attempt
    rows), with one launch (and C exchanges) counted and every ticket 0
    after it; returns the cases run."""
    device = torch.device("cuda")
    n = 0
    for kernel in ("ising_fused", "ising_packed", "potts_fused"):
        sweeps, one_round = chain_launchers(isk, pk, kernel)
        for c, length, r, s in CHAIN_CASES:
            st, betas, rung, energy, words, t0, ph0 = chain_inputs(
                torch, np, keys, kernel, c, length, r, 7 + n, device)
            kw = dict(n_sweeps=s, rule="glauber")
            xw = dict(pairing="seo" if n % 2 else "deo", criterion="logistic")
            what = f"phase 22 {kernel} C={c} L={length} R={r} S={s}"
            build.reset_launches()
            got = sweeps(st, words, t0, betas, rung, **kw)
            expect_launches(counts_now(build), what + " sweeps", **{kernel: 1})
            got_round = one_round(st, words, t0, ph0, betas, rung, energy, **kw, **xw)
            expect_launches(counts_now(build), what + " round", **{kernel: 2}, exchange=c)
            check_tickets(build, what)
            for i in range(c):
                want = sweeps(st[i], words[i], t0[i], betas, rung[i], **kw)
                want_round = one_round(st[i], words[i], t0[i], ph0[i], betas, rung[i],
                                       energy[i], **kw, **xw)
                for x, y in zip((*got, *got_round), (*want, *want_round)):
                    if not torch.equal(x[i], y):
                        raise AssertionError(f"{what}: chain {i} != its own launch")
            check_tickets(build, what + " per chain")
            n += 1
        del st, got, got_round
        torch.cuda.empty_cache()
    return n


def time_chain_axis(torch, np, isk, pk, keys) -> dict:
    """Phase 22a times: each kernel's round launch at L=300 R=1500 S=100, at
    C=1 and at C=8 chains (CUDA events)."""
    device = torch.device("cuda")
    out = {}
    for kernel in ("ising_fused", "ising_packed", "potts_fused"):
        _, one_round = chain_launchers(isk, pk, kernel)
        for c, reps in ((1, 3), (8, 1)):
            st, betas, rung, energy, words, t0, ph0 = chain_inputs(
                torch, np, keys, kernel, c, 300, 1500, 3, device)
            if c == 1:
                st, rung, energy, words, t0, ph0 = st[0], rung[0], energy[0], words[0], t0[0], ph0[0]
            out[kernel, c] = cuda_ms(torch, lambda: one_round(
                st, words, t0, ph0, betas, rung, energy, n_sweeps=100, rule="glauber",
                pairing="deo", criterion="logistic"), reps)
            del st
            torch.cuda.empty_cache()
    return out


def run_bucket(torch, build, api, serve, specs, obs=None, faults=None, ckdir=None,
               strict=True, on_update=None, **kw):
    """Serve ``specs`` (one tenant each) through one `Scheduler` on the card
    with the launches counted from 0 just before; returns ``(scheduler, jobs,
    buckets, counts, wall seconds, {job id: seconds from submit to its
    last update})``."""
    sched = serve.Scheduler(device="cuda", obs=obs, faults=faults, checkpoint_dir=ckdir,
                            strict_kernels=strict, **kw)
    made = []
    make = sched._make_bucket
    sched._make_bucket = lambda digest, staged: made.append(make(digest, staged)) or made[-1]
    done_at = {}

    def note(job, update):
        done_at[job.id] = time.monotonic() - job.submitted_at
        if on_update is not None:
            on_update(job, update)

    torch.cuda.synchronize()
    build.reset_launches()
    t_sub = time.perf_counter()
    jobs = [sched.submit(spec, on_update=note, job_id=f"s{spec.seed}") for spec in specs]
    sched.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_sub
    return sched, jobs, made, counts_now(build), wall, done_at


def solo_runs(torch, api, specs, device="cuda"):
    """Each spec alone through `Session`: its result and its rung-ordered
    energies after every chunk."""
    out = {}
    for spec in specs:
        seen = []

        class Energies(api.Callback):
            def on_chunk(self, session, info):
                e = info.state.pt.energy.cpu().numpy()
                seen.append(e[info.state.pt.rung.cpu().numpy().argsort()])

        res = api.Session(spec, callbacks=[Energies()], device=device,
                          strict_kernels=True).run()
        out[spec.seed] = (res, seen)
    return out


def bucket_equals_solo(np, jobs, buckets, solo, updates, what: str, states=True) -> None:
    """Every tenant's `JobResult` (summaries, final energies), its streamed
    energies and (with ``states``) its chain's final spins and rung map
    equal its solo run's bit for bit."""
    for job in jobs:
        res = job.result(timeout=0)
        ref, seen = solo[job.seed]
        if not np.array_equal(res.final_energy, ref.final_energies()):
            raise AssertionError(f"{what}: {job.id} final energies != solo")
        for name, summary in res.phases.items():
            for k, v in summary.items():
                if not np.array_equal(np.asarray(v), np.asarray(ref.phases[name].summary[k])):
                    raise AssertionError(f"{what}: {job.id} {name}.{k} != solo")
        got = updates[job.id]
        if len(got) != len(seen) or not all(np.array_equal(a, b) for a, b in zip(got, seen)):
            raise AssertionError(f"{what}: {job.id} streamed energies != solo chunk energies")
        if states:
            (bucket,) = buckets
            c = bucket.jobs.index(job)
            st = bucket.state.pt
            if not (bool((st.states[c] == ref.state.pt.states).all())
                    and bool((st.rung[c] == ref.state.pt.rung).all())):
                raise AssertionError(f"{what}: {job.id} final spins or rungs != solo")


def serve_phases(torch, np, build, keys, isk, pk, api, device, card) -> dict:
    """Phase 22: the chain axis of kernels A, #2p and #5, and the serve
    layer on the card (see the module docstring); returns the kernel rows'
    numbers."""
    from repro_torch import obs as obs_lib
    from repro_torch import serve
    from repro_torch.checkpoint import CheckpointCorrupt, CheckpointManager
    from repro_torch.engine import Engine
    from repro_torch.obs.check_trace import validate_trace
    from repro_torch.resilience import (
        BucketQuarantined, FaultPlan, InjectedCrash, InjectedFault, WatchdogTimeout,
    )

    EngineSpec, LadderSpec, PhaseSpec = api.EngineSpec, api.LadderSpec, api.PhaseSpec
    RunSpec, ScheduleSpec, SystemSpec = api.RunSpec, api.ScheduleSpec, api.SystemSpec
    t22 = time.perf_counter()
    n_cases = check_chain_axis(torch, np, isk, pk, keys, build)
    print(f"phase 22 chain axis: {n_cases} cases (A, #2p, #5 x {len(CHAIN_CASES)}: C in 1, 2, "
          "5; L in 8, 32, 300; R in 8, 1500; S in 1, 100), the sweeps and the round launch "
          "over C chains equal to C launches of one chain bit for bit (spins, ΔE, nacc, "
          "rung', energy', accept, prob, attempt), one launch and C exchanges counted, "
          "tickets 0")
    chain_ms = time_chain_axis(torch, np, isk, pk, keys)
    print(f"phase 22 chain-axis times [{card}]: round launch at L=300 R=1500 S=100 (Potts "
          "300x300 q=3), CUDA events: " + "; ".join(
              f"{k} C=1 {chain_ms[k, 1]:.3f} ms, C=8 {chain_ms[k, 8]:.3f} ms "
              f"({chain_ms[k, 8] / 8:.3f} ms a chain)"
              for k in ("ising_fused", "ising_packed", "potts_fused")))

    # -- full-width buckets: 8 (4 Potts) tenants of the paper's round spec ----------
    two = ScheduleSpec(phases=(PhaseSpec(name="burn", n_sweeps=200),
                               PhaseSpec(name="measure", n_sweeps=200, reset_stats=True)))
    paper = dict(ladder=LadderSpec(kind="paper", n_replicas=1500, t_min=1.0, t_max=4.0),
                 engine=EngineSpec(swap_interval=100, chunk_intervals=1), schedule=two,
                 observables=("absmag", "energy_per_site"))
    ising = {"length": 300, "accept_rule": "glauber", "use_fused": True,
             "use_fused_round": True}
    buckets = {
        "A": [RunSpec(system=SystemSpec("ising", ising), seed=s, **paper) for s in range(8)],
        "#2p": [RunSpec(system=SystemSpec("ising", {**ising, "pack_bits": True}), seed=s,
                        **paper) for s in range(8)],
        "#5": [RunSpec(system=SystemSpec("potts", {"shape": (300, 300), "q": 3,
                                                   "accept_rule": "glauber", "use_fused": True,
                                                   "use_fused_round": True}),
                       seed=s, **{**paper, "observables": ("pmag",),
                                  "ladder": LadderSpec(kind="geometric", n_replicas=1500,
                                                       t_min=0.7, t_max=2.9)})
               for s in range(4)],
    }
    kname = {"A": "ising_fused", "#2p": "ising_packed", "#5": "potts_fused"}
    out = {"chain_ms": {f"{k}/C={c}": v for (k, c), v in chain_ms.items()}, "buckets": {}}
    for what, specs in buckets.items():
        updates = {f"s{s.seed}": [] for s in specs}
        record = lambda job, u: updates[job.id].append(u.energy)  # noqa: E731
        sched, jobs, made, counts, wall, _ = run_bucket(torch, build, api, serve, specs,
                                                        on_update=record)
        n_int = 4
        expect_launches(counts, f"phase 22 bucket {what}", **{kname[what]: n_int},
                        exchange=n_int * len(specs))
        check_tickets(build, f"phase 22 bucket {what}")
        if sched.stats()["n_compiles"] != 1 or len(made) != 1:
            raise AssertionError(f"phase 22 bucket {what}: {sched.stats()}")
        # obs on: the same bucket, equal launches and results, one chunk a span
        ob = obs_lib.Observability.create(timeline=True)
        updates_on = {f"s{s.seed}": [] for s in specs}
        sched_on, jobs_on, made_on, counts_on, wall_on, _ = run_bucket(
            torch, build, api, serve, specs, obs=ob,
            on_update=lambda job, u: updates_on[job.id].append(u.energy))
        if counts_on != counts:
            raise AssertionError(f"phase 22 bucket {what}: launches obs on {counts_on} != "
                                 f"off {counts}")
        chunk = ob.metrics.snapshot()["engine_chunk_seconds"]["samples"][0]
        ms_int = 1e3 * chunk["sum"] / chunk["count"]
        # the obs-off engine between two chunk boundaries: no host sync
        eng = made[0].engine
        st0 = made[0].state
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.advance(st0, 1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        del st0
        solo = solo_runs(torch, api, specs)
        bucket_equals_solo(np, jobs, made, solo, updates, f"phase 22 bucket {what}")
        bucket_equals_solo(np, jobs_on, made_on, solo, updates_on,
                           f"phase 22 bucket {what} obs on")
        r_sw = len(specs) * 1500 * 400
        out["buckets"][what] = {"launches": counts[kname[what]], "wall_s": wall,
                                "ms_per_interval": ms_int, "jobs_per_s": len(specs) / wall,
                                "replica_sweeps_per_s": r_sw / (chunk["sum"])}
        print(f"phase 22 bucket {what} [{card}]: {len(specs)} tenants of the paper's round "
              f"spec ({'300x300 q=3 Potts' if what == '#5' else 'L=300'} R=1500 S=100, 200 "
              f"burn + 200 measure, 4 intervals) in one bucket: every JobResult (summaries, "
              f"final energies), the streamed energies after every chunk and each chain's "
              f"final spins and rungs equal to its solo Session run, obs on and off; "
              f"launches {kname[what]}={counts[kname[what]]} (4 intervals, not "
              f"{4 * len(specs)}), exchanges {counts['exchange']}; one preparation; "
              f"{ms_int:.2f} ms per interval (obs-on chunk spans, synchronised), "
              f"{r_sw / chunk['sum']:.4g} replica-sweeps/s, {len(specs) / wall:.3f} jobs/s "
              f"({wall:.2f} s obs off incl. init, {wall_on:.2f} s obs on)")
        del sched, jobs, made, sched_on, jobs_on, made_on, solo, eng
        torch.cuda.empty_cache()
        if what == "A":
            # the timeline and the Prometheus text of an obs-on bucket
            summary = validate_trace(ob.timeline.to_dict(),
                                     require_spans=["compile", "chunk", "device_wait",
                                                    "quantum"])
            prom = obs_lib.to_prometheus(ob.metrics.snapshot())
            for series in ("engine_chunks_total", "engine_device_seconds_total",
                           "serve_quanta_total", "serve_jobs_packed_per_compile",
                           "pt_swap_acceptance"):
                if series not in prom:
                    raise AssertionError(f"phase 22: {series} missing from the metrics")
            print(f"phase 22 obs [{card}]: the obs-on bucket's timeline passes check_trace "
                  f"({summary['n_events']} events, spans {sorted(summary['span_names'])}); "
                  f"the Prometheus text holds the engine and serve series; the obs-off "
                  f"engine's interval under set_sync_debug_mode('error') made no host sync")

    # -- a burst of 32 small tenants ---------------------------------------------
    base = RunSpec.from_json((ROOT / "examples" / "specs" / "ising_serve.json").read_text())
    small = dict(base.system.params)
    bursts = {"round": [dataclasses.replace(base, seed=s, system=SystemSpec(
                  "ising", {**small, "use_fused": True, "use_fused_round": True}))
                        for s in range(32)],
              "per-sweep": [dataclasses.replace(base, seed=s) for s in range(32)]}
    out["bursts"] = {}
    for what, specs in bursts.items():
        updates = {f"s{s.seed}": [] for s in specs}
        sched, jobs, made, counts, wall, done_at = run_bucket(
            torch, build, api, serve, specs,
            on_update=lambda job, u: updates[job.id].append(u.energy))
        n_int = base.schedule.total_sweeps // base.engine.swap_interval
        n_sw = base.schedule.total_sweeps
        if what == "round":
            expect_launches(counts, f"phase 22 burst {what}", ising_fused=n_int,
                            exchange=32 * n_int)
        else:
            expect_launches(counts, f"phase 22 burst {what}", jax_uniform=32 * n_sw,
                            ising_sweep=32 * n_sw)
        # the one-chunk torch.profiler window, once (its start costs seconds)
        prof_dir = ROOT / "build" / "phase22_profile" if what == "round" else None
        ob = obs_lib.Observability.create(
            timeline=True, torch_profile_dir=None if prof_dir is None else str(prof_dir))
        updates_on = {f"s{s.seed}": [] for s in specs}
        _, jobs_on, made_on, counts_on, wall_on, _ = run_bucket(
            torch, build, api, serve, specs, obs=ob,
            on_update=lambda job, u: updates_on[job.id].append(u.energy))
        if counts_on != counts:
            raise AssertionError(f"phase 22 burst {what}: launches obs on {counts_on} != off")
        if prof_dir is not None and not (prof_dir / obs_lib.PROFILE_NAME).is_file():
            raise AssertionError(f"phase 22 burst {what}: no torch.profiler trace in {prof_dir}")
        validate_trace(ob.timeline.to_dict(), require_spans=["chunk", "quantum"])
        eng, st0 = made[0].engine, made[0].state
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.advance(st0, 1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        solo = solo_runs(torch, api, specs)
        bucket_equals_solo(np, jobs, made, solo, updates, f"phase 22 burst {what}")
        bucket_equals_solo(np, jobs_on, made_on, solo, updates_on, f"phase 22 burst {what} obs on")
        lat = np.array(sorted(done_at.values()))
        p50, p99 = np.percentile(lat, 50), np.percentile(lat, 99)
        per_round = (counts["ising_fused"] / n_int if what == "round"
                     else counts["ising_sweep"] / n_sw)
        out["bursts"][what] = {"jobs_per_s": 32 / wall, "p50_s": p50, "p99_s": p99,
                               "launches": counts, "launches_per_round": per_round}
        print(f"phase 22 burst {what} [{card}]: 32 tenants of examples/specs/ising_serve.json"
              f"{' with use_fused_round' if what == 'round' else ''} (L=8 R=8, "
              f"{n_sw} sweeps) in one bucket, every tenant equal to its solo Session run "
              f"(obs on and off; timeline passes check_trace; "
              + ("the one-chunk torch.profiler window wrote its trace; " if prof_dir else "")
              + f"no host sync between chunk boundaries); "
              f"{32 / wall:.2f} jobs/s, latency p50 {p50:.3f} s p99 {p99:.3f} s ({wall:.2f} s "
              f"in all, obs on {wall_on:.2f} s); launches {counts} = {per_round:g} "
              f"{'launch a round' if what == 'round' else 'sweep launches a sweep'} for the "
              "32 tenants")
        del sched, jobs, made, jobs_on, made_on, eng, st0

    # -- faults on the card ---------------------------------------------------------
    specs = bursts["round"]
    _, base_jobs, _, _, _, _ = run_bucket(torch, build, api, serve, specs)
    baseline = {j.id: j.result(timeout=0) for j in base_jobs}
    typed = (InjectedFault, InjectedCrash, BucketQuarantined, FloatingPointError,
             WatchdogTimeout)
    fired = []
    for seed in (0, 1, 2):
        plan = FaultPlan.from_seed(seed, n_faults=4)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as ck:
            _, fjobs, _, _, _, _ = run_bucket(torch, build, api, serve, specs, faults=plan,
                                             ckdir=ck, checkpoint_every_quanta=1,
                                             retry_backoff_s=0.001)
            n_done = 0
            for j in fjobs:
                if j.state is serve.JobState.DONE:
                    ref, got = baseline[j.id], j.result(timeout=0)
                    if not np.array_equal(got.final_energy, ref.final_energy) or any(
                            not np.array_equal(np.asarray(v), np.asarray(ref.phases[p][k]))
                            for p in ref.phases for k, v in got.phases[p].items()):
                        raise AssertionError(f"phase 22 faults seed {seed}: {j.id} != fault-free")
                    n_done += 1
                elif not isinstance(j.error, typed):
                    raise AssertionError(f"phase 22 faults seed {seed}: {j.id} {j.error!r}")
            for sub in Path(ck).iterdir():
                if sub.is_dir():
                    m = CheckpointManager(str(sub))
                    for step in m.steps():
                        try:
                            m._verify(step)
                        except CheckpointCorrupt:  # a torn or flipped write, caught typed
                            pass
            fired.append((seed, plan.log, n_done))
    check_tickets(build, "phase 22 faults")
    # an injected engine.compile fault on a round spec: the per-sweep path on the card
    spec = bursts["round"][0]

    def engine_run(system, **kw):
        eng = Engine(system, spec.engine.build(spec.ladder.n_replicas,
                                               exchange=spec.exchange.build()),
                     observables=spec.system.observables(system, spec.observables),
                     device="cuda", **kw)
        state = eng.init(keys.key(spec.seed, device=device), spec.ladder.build())
        return eng.run(state, spec.schedule.total_sweeps)

    system = spec.system.build()
    ref_state, ref = engine_run(dataclasses.replace(
        system, use_fused=False, use_fused_round=False), strict_kernels=True)
    ob = obs_lib.Observability.create(timeline=False)
    build.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got_state, got = engine_run(system, obs=ob,
                                    faults=FaultPlan([{"site": "engine.compile"}]))
    degraded = ob.metrics.snapshot()["pt_degraded_kernel"]["samples"][0]["value"]
    if degraded != 1 or not any("degrading" in str(w.message) for w in caught):
        raise AssertionError(f"phase 22 degrade: pt_degraded_kernel {degraded}")
    counts = counts_now(build)
    expect_launches(counts, "phase 22 degrade", jax_uniform=spec.schedule.total_sweeps,
                    ising_sweep=spec.schedule.total_sweeps)
    if got_state.pt.states.device.type != "cuda" or not all(
            torch.equal(a, b) for a, b in zip(
                (got_state.pt.states, got_state.pt.rung, got_state.pt.energy),
                (ref_state.pt.states, ref_state.pt.rung, ref_state.pt.energy))) or any(
            not np.array_equal(v, ref.summary[k]) for k, v in got.summary.items()):
        raise AssertionError("phase 22 degrade: not equal to the never-fused run on the card")
    try:
        engine_run(system, strict_kernels=True, faults=FaultPlan([{"site": "engine.compile"}]))
    except InjectedFault:
        pass
    else:
        raise AssertionError("phase 22: strict_kernels did not raise on the compile fault")
    print(f"phase 22 faults [{card}]: FaultPlan.from_seed 0, 1, 2 (4 faults each) over the "
          f"32-tenant round burst with checkpoints every quantum: every job done equal to "
          f"its fault-free run or failed typed, every checkpoint verifies or is caught "
          f"corrupt (fired, done: {[(s, log, d) for s, log, d in fired]}); an injected "
          f"engine.compile fault on the round spec degraded its Engine to the per-sweep path "
          f"on the card (pt_degraded_kernel 1, launches {counts}), its final state and "
          f"summary equal to the never-fused run's; with strict_kernels it raised")
    out["seconds"] = time.perf_counter() - t22
    print(f"phase 22 done in {out['seconds']:.1f} s")
    return out


# -- phase 23: the mesh (torch.distributed) on the card --------------------------

MESH_SEQ20 = "HPHPPHHPHHPHPHHPPHPH"  # benchmarks/systems_bench.py


def mesh_spec_dicts() -> dict:
    """name -> (RunSpec JSON, mesh (E, D)) of phase 23's runs at full width:
    the paper's round configuration (L=300, R=1500 paper ladder, S=100,
    glauber, logistic DEO) on (1, 2), and with two chains on (2, 1); then
    the per-sweep, ``pack_bits`` fused and Potts round paths on (1, 2), and
    HP and ``single_flip`` at phase 20's widths over fewer sweeps; and the
    round path at L=32 swapping every sweep on (1, 1)."""
    paper = {"kind": "paper", "n_replicas": 1500, "t_min": 1.0, "t_max": 4.0}

    def spec(system, params, n_sweeps, interval=100, ladder=paper, observables=(), **engine):
        return {"spec_version": 1, "system": {"name": system, "params": params},
                "ladder": ladder,
                "engine": {"swap_interval": interval, "chunk_intervals": 1, **engine},
                "schedule": {"phases": [{"name": "run", "n_sweeps": n_sweeps}]},
                "observables": list(observables), "seed": 0}

    ising = {"length": 300, "accept_rule": "glauber"}
    rnd = {**ising, "use_fused": True, "use_fused_round": True}
    return {
        "paper": (spec("ising", rnd, 300, observables=("absmag", "energy_per_site")), (1, 2)),
        "paper_chains": (spec("ising", rnd, 300, observables=("absmag",), n_chains=2), (2, 1)),
        "per_sweep": (spec("ising", ising, 100, observables=("absmag",)), (1, 2)),
        "packed_fused": (spec("ising", {**ising, "use_fused": True, "pack_bits": True}, 200,
                              observables=("absmag",)), (1, 2)),
        "potts_round": (spec("potts", {"shape": [300, 300], "q": 3, "accept_rule": "glauber",
                                       "use_fused": True, "use_fused_round": True}, 100,
                             ladder={"kind": "geometric", "n_replicas": 1500, "t_min": 0.7,
                                     "t_max": 2.9}, observables=("pmag",)), (1, 2)),
        "hp": (spec("hp_protein", {"sequence": MESH_SEQ20}, 40, interval=20,
                    ladder={"kind": "geometric", "n_replicas": 1500, "t_min": 0.3,
                            "t_max": 3.4}), (1, 2)),
        "single_flip": (spec("ising", {"length": 300, "update": "single_flip",
                                       "flips_per_step": 300, "accept_rule": "glauber"}, 10,
                             interval=5, observables=("absmag",)), (1, 2)),
        # short rounds (a swap every sweep), in this process on (1, 1)
        "short": (spec("ising", {**rnd, "length": 32}, 200, interval=1,
                       observables=("absmag", "energy_per_site"), chunk_intervals=100), (1, 1)),
    }


# launches per rank (and of the unsharded run) of each phase 23 run, per interval
MESH_LAUNCHES = {
    "paper": ({"ising_fused": 1, "exchange_step": 1}, {"ising_fused": 1, "exchange": 1}),
    "paper_chains": ({"ising_fused": 1, "exchange_step": 1}, {"ising_fused": 1, "exchange": 2}),
    "per_sweep": ({"jax_uniform": 100, "ising_sweep": 100}, None),
    "packed_fused": ({"ising_packed": 1}, None),
    "potts_round": ({"potts_fused": 1, "exchange_step": 1}, {"potts_fused": 1, "exchange": 1}),
    "hp": ({"hp_moves": 20}, None),
    "single_flip": ({"single_flip": 5}, None),
    "short": ({"ising_fused": 1, "exchange_step": 1}, {"ising_fused": 1, "exchange": 1}),
}


def state_digest(state) -> str:
    """sha256 of a whole engine state's chain leaves and swap counters."""
    import hashlib

    h = hashlib.sha256()
    pt = state.pt
    for x in (pt.states, pt.energy, pt.rung, pt.t, pt.phase, state.stats.swap_accepts,
              state.stats.swap_attempts, state.stats.round_trips, state.betas):
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def mesh_session_run(name: str, data: dict, mesh, device: str, ckpt_dir: str | None = None,
                     restore_dir: str | None = None) -> dict:
    """Run phase 23's ``name`` (RunSpec JSON ``data``) through `Session` on ``mesh`` (E, D) or
    unsharded (None), strict, with every launch count at 0 just before the
    run; returns launch counts, ms an interval (the phase, host clock, the
    card synchronised), the bytes each replica-axis all-gather of the run
    returned (counted at the communicator, the layout's collective), digests
    of the whole final state and of the rung map after every interval, and
    the manifest.  ``ckpt_dir`` saves the final state there (gathered, rank 0
    writes); ``restore_dir`` restores a checkpoint onto this mesh afterwards."""
    import torch

    from repro_torch.api import Callback, RunSpec, Session
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import build

    if mesh is not None:
        data = {**data, "engine": {**data["engine"],
                                   "mesh": {"ensemble": mesh[0], "replica": mesh[1]}}}
    spec = RunSpec.from_json(data)
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    class Watch(Callback):
        """Times the phase and gathers the rung map after every chunk (not
        counted); counts the bytes of the run's own gathers."""

        def __init__(self):
            self.bytes, self.rungs, self.counting, self.t0, self.wall = [], [], False, 0.0, 0.0

        def wrap(self, layout):
            fn = layout.gather_replicas

            def counted(x, dim=-1):
                out = fn(x, dim)
                if self.counting:
                    self.bytes.append(out.numel() * out.element_size())
                return out

            layout.gather_replicas = counted

        def on_phase_start(self, session, phase):
            sync()
            self.t0, self.counting = time.perf_counter(), True

        def on_chunk(self, session, info):
            self.counting = False
            rung = info.state.pt.rung
            layout = session.engine.layout
            if layout is not None:
                rung = layout.gather_replicas(rung)
                if rung.dim() == 2 and session.spec.engine.n_chains > 1:
                    rung = layout.gather_chains(rung)
            self.rungs.append(rung.cpu().numpy())
            self.counting = True

        def on_phase_end(self, session, phase, result):
            sync()
            self.counting, self.wall = False, time.perf_counter() - self.t0

    # one untimed interval first: the process's first launches of each
    # kernel and the group's first collective (NCCL makes its communicator
    # there) stay out of the timed run
    warm = {**data, "schedule": {"phases": [{"name": "run",
                                             "n_sweeps": spec.engine.swap_interval}]}}
    Session(RunSpec.from_json(warm), device=device, strict_kernels=True).run()
    watch = Watch()
    session = Session(spec, callbacks=[watch], device=device, strict_kernels=True)
    if session.engine.layout is not None:
        watch.wrap(session.engine.layout)
    session.state = session.init_state()
    sync()
    build.reset_launches()
    result = session.run()
    counts = counts_now(build)
    check_tickets(build, f"phase 23 {name}")
    n_int = spec.schedule.total_sweeps // spec.engine.swap_interval
    st = result.state.pt
    if not bool(torch.isfinite(st.energy).all()):
        raise AssertionError(f"phase 23 {name}: non-finite energies")
    manifest = result.manifest()
    manifest["spec"]["engine"]["mesh"] = None
    out = {"counts": counts, "n_int": n_int, "ms": 1e3 * watch.wall / n_int,
           "bytes": watch.bytes, "digest": state_digest(result.state),
           "rungs": hashlib_of(watch.rungs), "manifest": manifest}
    if ckpt_dir is not None:
        meta = {"temps": [float(t) for t in session.engine._temps]}
        t = time.perf_counter()
        session.engine.save_checkpoint(CheckpointManager(ckpt_dir), session.state, meta)
        out["save_s"] = time.perf_counter() - t
    if restore_dir is not None:
        for k in ("restore_s", "restore2_s"):  # the second read finds the page cache warm
            t = time.perf_counter()
            restored, _ = session.engine.restore(CheckpointManager(restore_dir))
            sync()
            out[k] = time.perf_counter() - t
        out["restored_digest"] = state_digest(session.engine.gathered(restored))
    return out


def hashlib_of(arrays) -> str:
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()


def mesh_rank(rank: int, world: int, outdir: str, jobs: list, device: str = "cuda:0") -> None:
    """One of the spawned ranks sharing the card over gloo: every phase 23
    job ``(name, spec JSON, mesh, ckpt_dir, restore_dir)`` on its mesh,
    results to ``outdir/rank{rank}.json``."""
    sys.path.insert(0, str(SRC))
    import datetime

    import torch
    import torch.distributed as dist

    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(outdir, "store"), world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    results = {}
    for name, data, mesh, ckpt_dir, restore_dir in jobs:
        results[name] = mesh_session_run(name, data, mesh, device, ckpt_dir, restore_dir)
        if rank != 0:
            del results[name]["manifest"]
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


# (R, C) of phase 23's standalone exchange cases: unaligned chain rows (C=3,
# R not a multiple of 4), the largest R whose rows fit a block's shared
# memory and R past it (the global-scratch variant)
SHARED_MAX_R = 19368
EXCHANGE_CASES = ((6, 1), (6, 3), (1500, 1), (1500, 3), (1, 3), (3, 3), (1501, 3),
                  (SHARED_MAX_R, 1), (SHARED_MAX_R + 1, 2))
# dependent instructions of a pair's p (its argument, libdevice's expf, 1 + e
# and the IEEE division)
P_DEPTH = 20


def exchange_bound(r: int, c: int, width: int) -> tuple:
    """(ms, bound by, parts) of the standalone exchange over C chains of R
    rungs (DEO at an even phase: R // 2 pairs a chain), slices ``width``
    wide: the most of its operations at the issue rate (a Threefry block a
    pair and 3 a chain, ~20 more a pair for p), its bytes (rung, energy in
    and rung, accept, prob, attempt out a chain, 18 B a rung; the shared
    betas row once; the slice, phase, key words), and one block's dependent
    chain (ss, wk, u and p in series)."""
    pairs = r // 2
    ops = c * ((pairs + 3) * THREEFRY_OPS + P_DEPTH * pairs)
    n_bytes = 4 * r + c * (18 * r + 4 * width + 32)
    parts = {"operations": 1e3 * ops / INT32_OPS_PER_S,
             "bytes": 1e3 * n_bytes / HBM_BYTES_PER_S,
             "dependent chain": 1e3 * (3 * THREEFRY_DEPTH + P_DEPTH)
             * CHAIN_CYCLES_PER_INSTRUCTION / CLOCK_HZ}
    least = max(parts.values())
    return least, "bytes" if least == parts["bytes"] else "operations", parts


def exchange_inputs(torch, np, keys, rng, r: int, c: int, device):
    """(C, R) rung maps and energies near a paper ladder's, (R,) betas, (C,)
    phases, (C, 2) key words."""
    temps = 1.0 + np.arange(r) * 3.0 / r
    betas = torch.from_numpy((1.0 / temps).astype(np.float32)).to(device)
    rung = torch.from_numpy(np.stack([rng.permutation(r) for _ in range(c)])
                            .astype(np.int32)).to(device)
    by_rung = (-180000 + 100 * np.arange(r) + rng.integers(-400, 400, (c, r))).astype(np.float32)
    energy = torch.from_numpy(np.take_along_axis(
        by_rung, rung.cpu().numpy().astype(np.int64), 1)).to(device)
    phase = torch.from_numpy(rng.integers(0, 1 << 20, c)).to(device)
    words = torch.stack([keys.key(int(rng.integers(1 << 30)), device=device) for _ in range(c)])
    return rung, energy, betas, phase, words


def check_mesh_kernels(torch, np, xk, isk, ju, sc, keys, prng, build, device) -> dict:
    """Phase 23 (a): the standalone exchange launch (``exchange_step.cu``)
    over all pairings and criteria at `EXCHANGE_CASES` (both variants, the
    shared-memory one and past it the global-scratch one): rows equal bit
    for bit to a round launch's exchange (kernel A at S=0, chain by chain)
    and to the plain ``exchange_step`` in rung and attempt, in prob and
    accept but where u lies between the two p; the rank slice and the next
    phase it also writes; one call of ``exchange_rows`` one device op (the
    profiler); ``jax_uniform``, ``hp_moves`` and ``single_flip`` at replica
    offsets 0 and R/2 equal to their plain versions and to the unsharded
    launch's rows; times (CUDA events, the profiler) beside bounds."""
    rng = np.random.default_rng(23)
    n_cases, max_err, n_prob_diff = 0, 0.0, 0
    if not (xk.shared_fits(SHARED_MAX_R) and not xk.shared_fits(SHARED_MAX_R + 1)):
        raise AssertionError(f"phase 23: {SHARED_MAX_R} is not the last R in shared memory")
    build.reset_launches()
    for r, c in EXCHANGE_CASES:
        for pairing in ("deo", "seo"):
            for criterion in ("logistic", "metropolis"):
                rung, energy, betas, phase, words = exchange_inputs(torch, np, keys, rng, r, c,
                                                                    device)
                what = f"R={r} C={c} {pairing}/{criterion}"
                start = r // 2 if r > 1 else 0
                got = xk.exchange_step_kernel(rung, energy, betas, phase, words,
                                              pairing=pairing, criterion=criterion,
                                              block=(start, r))
                if not torch.equal(got[4], got[0][:, start:]) or not torch.equal(
                        got[5], phase + 1):
                    raise AssertionError(f"phase 23 exchange {what}: rank slice or next phase "
                                         "!= new_rung[:, start:stop], phase + 1")
                for i in range(c):
                    spins = torch.ones((r, 2, 2), dtype=torch.int8, device=device)
                    zero = torch.zeros((), dtype=torch.int64, device=device)
                    rd = isk.ising_round_kernel(
                        spins, words[i], zero, phase[i], betas, rung[i], energy[i],
                        n_sweeps=0, pairing=pairing, criterion=criterion)
                    rows = (rd[1], rd[4], rd[5], rd[6])
                    if not all(torch.equal(g[i], w) for g, w in zip(got, rows)):
                        raise AssertionError(f"phase 23 exchange {what} chain {i}: "
                                             "!= the round launch's exchange")
                    want = xk.exchange_step(rung[i], energy[i], betas, phase[i], words[i],
                                            pairing=pairing, criterion=criterion)
                    u = prng.swap_uniforms(words[i], phase[i], r)
                    lo = torch.minimum(got[2][i], want[2])
                    hi = torch.maximum(got[2][i], want[2])
                    in_gap = (u >= lo) & (u < hi)
                    prob_diff = got[2][i] != want[2]
                    acc_diff = got[1][i] != want[1]
                    if bool((prob_diff & ~in_gap).any()) or bool((acc_diff & ~in_gap).any()):
                        raise AssertionError(f"phase 23 exchange {what}: prob/accept "
                                             "differ from plain outside the u gap")
                    if not torch.equal(got[3][i], want[3]) or (
                            not bool(acc_diff.any()) and not torch.equal(got[0][i], want[0])):
                        raise AssertionError(f"phase 23 exchange {what}: rung/attempt "
                                             "!= plain")
                    n_prob_diff += int(prob_diff.sum().item())
                    max_err = max(max_err, (got[2][i] - want[2]).abs().max().item())
                n_cases += 1
    n_x = 4 * len(EXCHANGE_CASES)
    counts = counts_now(build)
    if counts["exchange_step"] != n_x:
        raise AssertionError(f"phase 23: {counts['exchange_step']} exchange launches != {n_x}")
    # the offsets: a shard's draws are the unsharded launch's rows [off, off + r)
    r, shape = 1500, (2, 300, 300)
    key, t = keys.key(21, device=device), torch.tensor(2**31 + 5, device=device)
    whole = ju.jax_uniform_kernel(key, t, r, shape)
    for off in (0, r // 2):
        part = ju.jax_uniform_kernel(key, t, r // 2, shape, off)
        if not torch.equal(part, whole[off:off + r // 2]):
            raise AssertionError(f"phase 23 jax_uniform offset {off} != unsharded rows")
        ids = torch.tensor([0, 1, 377, r // 2 - 1], device=device)
        if not torch.equal(part[ids], ju.jax_uniform_plain(key, t, ids + off, shape)):
            raise AssertionError(f"phase 23 jax_uniform offset {off} != plain")
        n_cases += 1
    from repro_torch.core.hp import HPChain

    chain = HPChain(MESH_SEQ20)
    n = len(MESH_SEQ20)
    pos = chain.init_state_batched(keys.split(keys.key(7, device=device), r))
    hb = torch.linspace(1 / 0.6, 1 / 3.4, r, device=device)
    hmask = torch.tensor([ch == "H" for ch in MESH_SEQ20], device=device)
    hkw = dict(hmask=hmask, eps=1.0, n_moves=n)
    full_hp = sc.hp_moves_kernel(pos, key, t, hb, **hkw)
    spins = torch.from_numpy(rng.choice(np.array([-1, 1], np.int8),
                                        size=(r, 300, 300))).to(device)
    fkw = dict(j=1.0, b=0.0, rule="glauber", flips=30)
    full_flip = sc.single_flip_kernel(spins, key, t, hb, **fkw)
    for off in (0, r // 2):
        blk = slice(off, off + r // 2)
        for fn_k, fn_p, x, kw, full, what in (
                (sc.hp_moves_kernel, sc.hp_moves_plain, pos, hkw, full_hp, "hp_moves"),
                (sc.single_flip_kernel, sc.single_flip_plain, spins, fkw, full_flip,
                 "single_flip")):
            got = fn_k(x[blk], key, t, hb[blk], replica_offset=off, **kw)
            want = fn_p(x[blk], key, t, hb[blk], replica_offset=off, **kw)
            for g, w, f in zip(got, want, full):
                if not torch.equal(g, w) or not torch.equal(g, f[blk]):
                    raise AssertionError(f"phase 23 {what} offset {off} != plain / unsharded")
            n_cases += 1
    torch.cuda.synchronize()
    # times at the sharded paper path's shapes: R=1500 gathered rows, one
    # chain (as the paper's sharded step: (R,) rows, a rank block of 750) and
    # 8 chains; the global-scratch variant at R=19369
    xkw = dict(pairing="deo", criterion="logistic")
    x_times = {}
    for c, rows in ((1, r), (8, r), (1, SHARED_MAX_R + 1)):
        rung_c, energy_c, betas_c, _, words_c = exchange_inputs(torch, np, keys, rng, rows, c,
                                                                device)
        phase_c = torch.zeros(c, dtype=torch.int64, device=device)
        args = (rung_c, energy_c, betas_c, phase_c, words_c)
        if c == 1:
            args = (rung_c[0], energy_c[0], betas_c, phase_c[0], words_c[0])
        width = rows - rows // 2
        fn = functools.partial(xk.exchange_step_kernel, *args, block=(rows // 2, rows), **xkw)
        rows_fn = functools.partial(xk.exchange_rows, *args, block=(rows // 2, rows), **xkw)
        name = "exchange_shared" if rows == r else "exchange_global"
        x_times[f"C={c} R={rows}"] = {
            "ms": cuda_ms(torch, fn, 200, 5), "rows_ms": cuda_ms(torch, rows_fn, 200, 5),
            "device_ms": profiler_ms(torch, fn, 200, name)[0],
            "plain_ms": cuda_ms(torch, lambda: [xk.exchange_step(
                rung_c[i], energy_c[i], betas_c, phase_c[i], words_c[i], **xkw)
                for i in range(c)], 20, 2),
            "bound": exchange_bound(rows, c, width)}
        if c == 1 and rows == r:
            # one call of exchange_rows on the kernel's types is one device op:
            # one launch a call by the counter, and the profiler sees no
            # device op but the exchange kernel, at most once a call
            # (windows of 100 calls: the tracer lost six windows of 10 in a row once)
            n0 = build.launches["exchange_step"]
            ops, n_calls = device_ops_of_calls(torch, rows_fn, "exchange_shared_kernel", 100)
            n_launched = build.launches["exchange_step"] - n0
            if (n_launched != n_calls or len(ops) != 1
                    or "exchange_shared_kernel" not in next(iter(ops))
                    or next(iter(ops.values())) > 100):
                raise AssertionError(f"phase 23: {n_calls} calls of exchange_rows launched "
                                     f"{n_launched} times and ran {ops}, not one launch a call")
            rung, energy, betas, words, phase = (rung_c, energy_c, betas_c, words_c,
                                                 phase_c)
    half = r // 2
    u_ms = cuda_ms(torch, lambda: ju.jax_uniform_kernel(key, t, half, shape, half), 20)
    u_plain = cuda_ms(torch, lambda: ju.jax_uniform_plain(
        key, t, half + torch.arange(half, device=device), shape), 1)
    u_bound = bound_threefry(half * 2 * 300 * 300, 4.0 * half * 2 * 300 * 300)
    # the serial chains on the block at offset 750, at the offset check's widths
    blk = slice(half, r)
    hp_work = {"replicas": half}
    sc.hp_moves_plain(pos[blk], key, t, hb[blk], replica_offset=half, work=hp_work, **hkw)
    hp_work = {k: int(v) for k, v in hp_work.items()}
    serial = {}
    for name, fn_k, fn_p, x, kw, bound in (
            ("hp_moves_offset", sc.hp_moves_kernel, sc.hp_moves_plain, pos, hkw,
             bound_hp(hp_work, half * hkw["n_moves"], n, hkw["n_moves"])),
            ("single_flip_offset", sc.single_flip_kernel, sc.single_flip_plain, spins, fkw,
             bound_flips(half, fkw["flips"], 300))):
        serial[name] = {
            "ms": cuda_ms(torch, lambda: fn_k(x[blk], key, t, hb[blk], replica_offset=half,
                                              **kw), 20, 2),
            "plain_ms": cuda_ms(torch, lambda: fn_p(x[blk], key, t, hb[blk],
                                                    replica_offset=half, **kw), 1),
            "bound": bound}
    # #2p's round tail at L=32 R=1500 S=1 (a round launch less the same
    # launch without the exchange, profiler device time, in turns): the
    # device time of a launch is the mean over the launches the profiler
    # saw, whose count this run may not equal the 200 made (it is printed)
    spins32 = torch.from_numpy(rng.choice(np.array([-1, 1], np.int8),
                                          size=(r, 32, 32))).to(device)
    t0 = torch.zeros((), dtype=torch.int64, device=device)
    pkw = dict(n_sweeps=1, rule="glauber")
    fns = {"sweeps": lambda: isk.ising_sweep_packed_kernel(spins32, words[0], t0, betas,
                                                          rung[0], **pkw),
           "round": lambda: isk.ising_round_kernel(spins32, words[0], t0, phase[0], betas,
                                                   rung[0], energy[0], pack_bits=True,
                                                   **xkw, **pkw)}
    reads = {"sweeps": [], "round": []}
    seen = {"sweeps": [], "round": []}
    for what in ("sweeps", "round", "round", "sweeps", "sweeps", "round"):
        ms, n = profiler_ms(torch, fns[what], 200, "ising_packed_kernel")
        reads[what].append(ms)
        seen[what].append(n)
    packed_tail = (min(reads["round"]), min(reads["sweeps"]))
    return {"n_cases": n_cases, "packed_tail": packed_tail, "packed_seen": seen, "n_exchange": n_x, "max_err": max_err,
            "n_prob_diff": n_prob_diff,
            "times": {"exchange_step": x_times["C=1 R=1500"], "exchange_step_c8": x_times["C=8 R=1500"],
                      "exchange_step_global": x_times[f"C=1 R={SHARED_MAX_R + 1}"],
                      "jax_uniform_offset": {"ms": u_ms, "plain_ms": u_plain,
                                             "bound": u_bound}, **serial}}


def mesh_phases(torch, np, build, keys, prng, device, card) -> dict:
    """Phase 23: the mesh on the card.  (a) `check_mesh_kernels`; (b) the
    paper's round configuration through `Session` unsharded, on a one-rank
    NCCL group (`MeshSpec(1, 1)`, this process) and on two ranks sharing the
    card over gloo, spawned (`MeshSpec(1, 2)`: slot offsets 0 and 750; and
    `MeshSpec(2, 1)` with two chains), each equal to the unsharded run from
    the same seed (digests of the whole final state and of the rung map
    after every interval, manifests), with one launch of A and one
    standalone exchange an interval on each rank and no round launch; a
    checkpoint saved on (1, 2) restored on one device, and one saved
    unsharded restored on (2, 1); (c) the per-sweep, ``pack_bits`` fused,
    Potts round, HP and ``single_flip`` paths on (1, 2), each equal to its
    unsharded run."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import exchange as xk
    from repro_torch.kernels import ising_sweep as isk
    from repro_torch.kernels import jax_uniform as ju
    from repro_torch.kernels import serial_chain as sc

    t_phase = time.perf_counter()
    kern = check_mesh_kernels(torch, np, xk, isk, ju, sc, keys, prng, build, device)
    print(f"phase 23 kernels: {kern['n_exchange']} standalone exchange launches ((R, C) in "
          f"{EXCHANGE_CASES}, R={SHARED_MAX_R + 1} the global-scratch variant; DEO/SEO x "
          f"logistic/metropolis) equal to the round launch's exchange bit for bit and to plain "
          f"(rung, attempt; accept and prob but inside the u gap: {kern['n_prob_diff']} prob "
          f"differences, max |dp| {kern['max_err']}), each with its rank slice and phase + 1; "
          f"exchange_rows one device op; jax_uniform, hp_moves and single_flip at replica "
          f"offsets 0 and 750 equal to plain and to the unsharded launch's rows; "
          f"{kern['n_cases']} cases")
    tm = kern["times"]
    print(f"phase 23 standalone exchange times [{card}]: " + "; ".join(
        f"{what}: device {x['device_ms']:.5f} ms (profiler), {x['ms']:.5f} ms by CUDA events "
        f"back to back (exchange_rows {x['rows_ms']:.5f}), plain {x['plain_ms']:.4f} ms, "
        f"{bound_text(x['bound'])}"
        for what, x in (("R=1500 C=1", tm["exchange_step"]), ("R=1500 C=8", tm["exchange_step_c8"]),
                        (f"global variant R={SHARED_MAX_R + 1} C=1", tm["exchange_step_global"])))
          + "; the bound is far below any launch")
    print(f"phase 23 kernel times [{card}]:"
          f" jax_uniform 750 replicas at offset 750, (2,300,300): "
          f"{tm['jax_uniform_offset']['ms']:.4f} ms vs plain "
          f"{tm['jax_uniform_offset']['plain_ms']:.2f} ms (bound "
          f"{tm['jax_uniform_offset']['bound'][0]:.4f} ms); "
          + "".join(f"{name[:-7]} 750 replicas at offset 750 {tm[name]['ms']:.4f} ms vs plain "
                    f"{tm[name]['plain_ms']:.2f} ms ({bound_text(tm[name]['bound'])}); "
                    for name in ("hp_moves_offset", "single_flip_offset"))
          + f"#2p round tail at L=32 R=1500 "
          f"S=1: round launch {kern['packed_tail'][0]:.5f} ms, sweeps alone "
          f"{kern['packed_tail'][1]:.5f} ms, tail "
          f"{kern['packed_tail'][0] - kern['packed_tail'][1]:.5f} ms (profiler device time a "
          f"launch, the lowest of 3 turns each; launches the profiler saw of the 200 made: "
          f"round {kern['packed_seen']['round']}, sweeps {kern['packed_seen']['sweeps']}); "
          f"library_ms: none")

    work = Path(tempfile.mkdtemp(prefix="mesh_", dir=ROOT / "build"))
    specs = mesh_spec_dicts()
    ref = {}
    for name in specs:
        ckpt = str(work / "ckpt_ref_chains") if name == "paper_chains" else None
        ref[name] = mesh_session_run(name, specs[name][0], None, "cuda", ckpt_dir=ckpt)
        want = MESH_LAUNCHES[name][1] or MESH_LAUNCHES[name][0]
        expect_launches(ref[name]["counts"], f"phase 23 unsharded {name}",
                        **{k: v * ref[name]["n_int"] for k, v in want.items()})
    # (1, 1) on a one-rank NCCL group in this process
    one = mesh_session_run("paper", specs["paper"][0], (1, 1), "cuda")
    short = mesh_session_run("short", specs["short"][0], (1, 1), "cuda")
    if dist.get_backend() != "nccl":
        raise AssertionError(f"phase 23: the one-rank group is {dist.get_backend()}, not nccl")
    dist.destroy_process_group()
    # two ranks sharing the card over gloo (spawned, not forked)
    jobs = [("paper", specs["paper"][0], (1, 2), str(work / "ckpt_mesh"), None),
            ("paper_chains", specs["paper_chains"][0], (2, 1), None,
             str(work / "ckpt_ref_chains"))]
    jobs += [(name, data, mesh, None, None) for name, (data, mesh) in specs.items()
             if name not in ("paper", "paper_chains") and mesh != (1, 1)]
    t = time.perf_counter()
    mp.start_processes(mesh_rank, args=(2, str(work), jobs), nprocs=2, start_method="spawn")
    spawn_s = time.perf_counter() - t
    ranks = [json.loads((work / f"rank{k}.json").read_text()) for k in range(2)]

    def same(got: dict, name: str, what: str):
        want = ref[name]
        for k in ("digest", "rungs"):
            if got[k] != want[k]:
                raise AssertionError(f"phase 23 {name} {what}: {k} != the unsharded run's")
        if "manifest" in got and got["manifest"] != want["manifest"]:
            raise AssertionError(f"phase 23 {name} {what}: manifest != the unsharded run's")

    for name, run in (("paper", one), ("short", short)):
        same(run, name, "MeshSpec(1, 1) nccl")
        expect_launches(run["counts"], f"phase 23 {name} (1, 1)",
                        **{k: v * run["n_int"] for k, v in MESH_LAUNCHES[name][0].items()})
    lines = []
    for name, _, mesh, *_ in jobs:
        for k, res in enumerate(ranks):
            got = res[name]
            same(got, name, f"{mesh} rank {k}")
            expect_launches(got["counts"], f"phase 23 {name} {mesh} rank {k}",
                            **{kk: v * got["n_int"] for kk, v in MESH_LAUNCHES[name][0].items()})
        g = ranks[0][name]
        lines.append(f"{name} {tuple(mesh)} {g['ms']:.2f} ms/interval (unsharded "
                     f"{ref[name]['ms']:.2f}), {sum(g['bytes']) // g['n_int']} B gathered a "
                     f"rank and interval")
    restored = ranks[0]["paper_chains"]["restored_digest"]
    if restored != ref["paper_chains"]["digest"]:
        raise AssertionError("phase 23: the unsharded checkpoint restored on (2, 1) differs")
    from repro_torch.api import RunSpec, Session

    eng = Session(RunSpec.from_json(specs["paper"][0]), device="cuda").engine
    restore_s = []
    for _ in range(2):  # the second read finds the page cache warm
        t = time.perf_counter()
        back, _ = eng.restore(CheckpointManager(str(work / "ckpt_mesh")))
        torch.cuda.synchronize()
        restore_s.append(time.perf_counter() - t)
    if state_digest(back) != ref["paper"]["digest"]:
        raise AssertionError("phase 23: the (1, 2) checkpoint restored on one device differs")
    check_tickets(build, "phase 23")
    pb = ranks[0]["paper"]
    print(f"phase 23 paper round path [{card}]: L=300 R=1500 S=100, 3 intervals, equal to the "
          f"unsharded run (final state, rung map after every interval, manifest): unsharded "
          f"{ref['paper']['ms']:.2f} ms/interval; MeshSpec(1, 1) on one NCCL rank "
          f"{one['ms']:.2f} ms/interval, {sum(one['bytes']) // one['n_int']} B gathered an "
          f"interval; MeshSpec(1, 2) two gloo ranks on the one card (offsets 0, 750) "
          f"{pb['ms']:.2f} ms/interval, {sum(pb['bytes']) // pb['n_int']} B gathered a rank "
          f"and interval (energy, rung and 2 observable rows of 1500 x 4 B, staged through "
          f"host memory by gloo); each rank 1 launch of A and 1 standalone exchange an "
          f"interval, no round launch; save on (1, 2) {pb['save_s']:.3f} s, restored on one "
          f"device in {restore_s[0]:.3f} s (again {restore_s[1]:.3f} s), equal; the unsharded "
          f"two-chain checkpoint restored on (2, 1) in "
          f"{ranks[0]['paper_chains']['restore_s']:.3f} s (again "
          f"{ranks[0]['paper_chains']['restore2_s']:.3f} s), equal")
    print(f"phase 23 short rounds [{card}]: L=32 R=1500 S=1, 200 intervals, equal to the "
          f"unsharded run: unsharded {ref['short']['ms']:.4f} ms/interval, MeshSpec(1, 1) on "
          f"one NCCL rank {short['ms']:.4f} ms/interval (1 launch of A and 1 standalone "
          f"exchange an interval)")
    print(f"phase 23 all layouts [{card}]: " + "; ".join(lines)
          + f"; the two ranks' run {spawn_s:.1f} s with their start; no run held two GPUs")
    import shutil

    shutil.rmtree(work, ignore_errors=True)
    print(f"phase 23 done in {time.perf_counter() - t_phase:.1f} s")
    return {"kernels": kern, "one": one, "short": short, "ranks": ranks, "ref": ref,
            "restore_s": restore_s, "spawn_s": spawn_s}


# -- phase 28: the LM placement layer (DTensor) on two ranks sharing the card ----------
# Two spawned ranks join over gloo and share cuda:0; the models' tensors are
# DTensors on a ("data", "model") DeviceMesh under the rules of
# repro_torch.launch.sharding.  Every run is held against the unsharded run
# of the same seeds on the card, made in this process before the spawn: the
# greedy tokens and the MoE routing equal (the decode is teacher-forced: both
# runs read the unsharded run's tokens, so one flip would not carry), the
# logits within PLACE_LOGITS_RTOL of their scale (serving in f32; qwen3-moe
# in bf16 on (2, 1) splits no sum), the losses within PLACE_LOSS_RTOL, and
# each rank's blocks of the masters, mu and nu after the last step within
# PLACE_STATE_RTOL of the unsharded state's (`state_gap`); PT-LM on
# MeshSpec(1, 2) equal to a one-process run that steps the batch's two
# halves at replica offsets 0 and R/2; the grad norms within
# PLACE_GRADNORM_RTOL.  The limits lie between the sound runs' readings
# (PERF.md §6) and two planted faults', which the phase reads on the card
# each time and requires past them: every gradient halved (clipping at norm
# 1 hides it from the state; the grad norm shows it) and one leaf's gradient
# times -1/2 (the masters, mu and nu show it).  Two ranks on one card
# measure contention, not scaling.  gloo moves ~0.3 GB/s through the host
# between two ranks on one NVIDIA H100 80GB HBM3 (700.00 W) and DTensor adds
# ~0.25 ms a dispatched op there, so the shapes are cut to keep the phase
# near two minutes; the widths are the configs'
PLACE_B, PLACE_S, PLACE_DECODE = 4, 128, 16
PLACE_RWKV_S, PLACE_RWKV_DECODE = 64, 4
PLACE_TRAIN_LAYERS, PLACE_TRAIN_B, PLACE_TRAIN_S, PLACE_TRAIN_STEPS = 2, 4, 128, 2
PLACE_MOE_LAYERS, PLACE_MOE_S = 2, 256
# The sound readings on one NVIDIA H100 80GB HBM3 (700.00 W), and the planted faults':
# logits of their scale: gemma-2b f32 ~8e-7, rwkv6-7b f32 ~1.9e-3 (random weights
# amplify rounding), qwen3-moe 0; losses <= 3.3e-5 relative; grad norms <= 1.5e-4
# (every gradient halved: 0.5); the state after 2 steps (one leaf's gradient times
# -1/2: masters 2, mu 1.5, nu 0.75): masters <= 0.098 of the update's norm (a
# near-zero gradient's sign, which bf16 rounding can flip, sets its AdamW update's
# sign), mu <= 0.016, nu <= 0.023 of their leaf's largest
PLACE_LOGITS_RTOL = {"gemma": 1e-4, "rwkv": 1e-2, "moe": 1e-4}
PLACE_LOSS_RTOL = 1e-3
PLACE_GRADNORM_RTOL = 1e-2
PLACE_STATE_RTOL = {"masters": 0.4, "mu": 0.15, "nu": 0.15}
PLACE_PTLM_R, PLACE_PTLM_SEQ, PLACE_PTLM_PROMPT, PLACE_PTLM_STEPS = 4, 32, 8, 10
PLACE_MESHES = ((2, 1), (1, 2))


class HalvesLM:
    """A bound LM system whose MH step runs the batch's two halves as two
    ranks of ``MeshSpec(1, 2)`` do: rows [0, R/2) at replica offset 0 and
    [R/2, R) at offset R/2, each its own forward."""

    def __init__(self, torch, system):
        self.torch, self.system = torch, system

    def __getattr__(self, name):
        return getattr(self.system, name)

    def batched_mcmc_step(self, key, t, tokens, betas, replica_offset=0):
        h = tokens.shape[0] // 2
        outs = [self.system.batched_mcmc_step(key, t, tokens[s], betas[s], replica_offset=o)
                for s, o in ((slice(0, h), 0), (slice(h, None), h))]
        return tuple(self.torch.cat(parts) for parts in zip(*outs))


def place_cfgs():
    """(name, config) of phase 28's models (full width).  Serving is held in
    f32: with random weights one bf16 ulp moves rwkv6-7b's logits by ~4
    (PR 14's `rwkv_rounding`), so the TP split's reassociation in bf16 would
    hide any fault; training and PT-LM keep bf16 compute."""
    from repro_torch.configs import get_config

    gemma = get_config("gemma_2b")
    return {"gemma_serve": dataclasses.replace(gemma, dtype="float32"), "gemma": gemma,
            "gemma_train": dataclasses.replace(gemma, n_layers=PLACE_TRAIN_LAYERS),
            "rwkv": dataclasses.replace(get_config("rwkv6_7b"), dtype="float32"),
            "moe": dataclasses.replace(get_config("qwen3_moe_235b"), n_layers=PLACE_MOE_LAYERS,
                                       moe_token_stationary=True)}


def place_tokens(torch, cfg, b, s, seed, device):
    """(b, s) seeded token ids on ``device`` (on ``meta``: their shape, for
    phase 29's dry run of the same programs)."""
    if torch.device(device).type == "meta":
        return torch.empty((b, s), dtype=torch.int64, device="meta")
    return torch.randint(0, cfg.vocab, (b, s), device=device,
                         generator=torch.Generator(device=device).manual_seed(seed))


def counted_bytes(counter) -> dict:
    """A `CollectiveCounter`'s bytes by "phase.collective.axis"."""
    return {f"{phase}.{name}.{axis}": n for (phase, name, axis), n in counter.by_axis.items()}


def local_bytes(tensors) -> int:
    """The bytes of this rank's blocks of DTensors (or of plain tensors)."""
    return sum((t.to_local() if hasattr(t, "to_local") else t).numel() * t.element_size()
               for t in tensors)


def sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def place_serve(torch, build, model_lib, sharding, lm, cfg, mesh, forced, device,
                seq: int | None = None, n_decode: int | None = None):
    """Prefill (B, seq) then ``n_decode`` decode steps teacher-forced on
    ``forced`` (B, n_decode) (None: greedy, the unsharded run); by default
    PLACE_S and PLACE_DECODE; over the family's context (`family_context`:
    the vlm's image, whisper's frames and their encoding).  Returns whole
    f32 host logits, the argmax tokens, ms and the wkv6 launches; on a
    ``mesh`` also this rank's resident bytes and the collective bytes of
    the prefill and of the decode loop.  On ``meta`` (phase 29's dry run)
    it runs the same calls and returns those counts alone."""
    from repro_torch.launch import comm
    from repro_torch.models import placed, whisper

    seq, n_decode = seq or PLACE_S, n_decode or PLACE_DECODE
    meta = torch.device(device).type == "meta"
    tokens = place_tokens(torch, cfg, PLACE_B, seq, 1, device)

    def put(x, specs):
        return x if mesh is None else sharding.place(x, specs(x), mesh)

    def counter():
        return comm.CollectiveCounter(mesh) if mesh is not None else contextlib.nullcontext()

    batch = put({"tokens": tokens, **family_context(torch, cfg, device)},
                lambda b: sharding.batch_shardings(mesh, b))
    counters = {"prefill": counter(), "decode": counter()}
    # no_grad, not inference_mode: in inference mode DTensor (torch 2.11) takes
    # its uncached sharding propagation for every composite op (einsum, matmul)
    with torch.no_grad():
        model_lib.prefill_logits(lm, cfg, batch)  # first use of each op
        sync(torch, device)
        build.reset_launches()
        t = time.perf_counter()
        with counters["prefill"]:
            pre = sharding.gather(model_lib.prefill_logits(lm, cfg, batch))
        sync(torch, device)
        prefill_ms = 1e3 * (time.perf_counter() - t)
        prefill_launches = dict(build.launches)
        ctx = batch.get("img")
        if cfg.family == "encdec":
            with placed.implicit(lm, inputs=batch["frames"]):
                ctx = whisper.encode(lm, cfg, batch["frames"])
        # a cache of exactly the decoded positions: its sequence divides the
        # model axis, so decode_state_shardings shards it there
        state = model_lib.init_decode_state(cfg, PLACE_B, n_decode, device=device)
        state = put(state, lambda st: sharding.decode_state_shardings(mesh, st, cfg))
        token = tokens[:, :1]
        logits, greedy = [], []
        build.reset_launches()
        t = time.perf_counter()
        with counters["decode"]:
            for pos in range(n_decode):
                step_in = put(token, lambda x: sharding.batch_shardings(mesh, x))
                lg, state = model_lib.decode_step(lm, cfg, state, step_in, pos, ctx=ctx)
                lg = sharding.gather(lg)
                greedy.append(torch.argmax(lg, dim=-1))
                logits.append(lg if meta else lg.cpu())
                token = (greedy[-1] if forced is None else forced[:, pos].to(device))[:, None]
        sync(torch, device)
        decode_ms = 1e3 * (time.perf_counter() - t) / n_decode
        decode_launches = dict(build.launches)
    out = {}
    if mesh is not None:
        out["resident"] = local_bytes(list(lm.parameters()))
        out["counts"] = {k: counted_bytes(c) for k, c in counters.items()}
    if meta:
        return out
    return {**out, "seq": seq, "n_decode": n_decode, "prefill": pre.cpu(),
            "decode": torch.stack(logits), "tokens": torch.stack(greedy, dim=1).cpu(),
            "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "prefill_launches": prefill_launches, "decode_launches": decode_launches}


def place_train(torch, sharding, comm, ts, opt_lib, cfg, mesh, device, ref=None, keep=None):
    """PLACE_TRAIN_STEPS steps on one seeded batch: the losses, grad norms,
    ms a warm step and, on ``mesh`` (masters and moments in the FSDP
    layout), this rank's resident bytes and the arithmetic's, one step's
    collective bytes and the gap (`state_gap`) of this rank's blocks of the
    masters, mu and nu from the unsharded steps, run in this process first.

    Unsharded, it also runs two planted faults and reads each one's gap
    from the sound run: every gradient halved (a reduce-scatter that
    averages where it should sum; clipping at norm 1 hides it from the
    state, so the grad norm reads it) and one leaf's gradient times -1/2 (a
    wrong gradient, which the masters, mu and nu read).  The limits lie
    below.  ``keep`` (unsharded; a predicate on names) adds the sound run's
    initial masters and its masters, mu and nu of those leaves as
    ``out["ref"]``; a rank given that ``ref`` reads its gap on them alone
    and runs no unsharded steps (phase 29: two whole states of a full-width
    model would not fit the card beside the placed ones)."""
    if torch.device(device).type == "meta":  # phase 29's dry run: the placed steps' counts
        return train_steps(torch, sharding, comm, ts, opt_lib, cfg, mesh, device)[1]
    if mesh is not None and ref is not None:
        state, out = train_steps(torch, sharding, comm, ts, opt_lib, cfg, mesh, device)
        want = types.SimpleNamespace(params=ref["masters"], opt=types.SimpleNamespace(
            mu=ref["mu"], nu=ref["nu"]))
        out["gap"] = state_gap(torch, sharding, state, want, ref["init"],
                               sharding.param_shardings(mesh, state.params, cfg, fsdp=True),
                               mesh)
        return out
    init = ts.init_state(cfg, 0, device=device).params
    open_gates(init)
    sound, out = train_steps(torch, sharding, comm, ts, opt_lib, cfg, None, device)
    if keep is not None:  # the ranks' reference; the planted runs read the same leaves
        ref = out["ref"] = {tree: {n: t.cpu() for n, t in leaves.items() if keep(n)}
                            for tree, leaves in (("init", init), ("masters", sound.params),
                                                 ("mu", sound.opt.mu), ("nu", sound.opt.nu))}
        # two whole states of a full-width model beside AdamW's temporaries do not fit
        sound = types.SimpleNamespace(params=ref["masters"], opt=types.SimpleNamespace(
            mu=ref["mu"], nu=ref["nu"]))
        init = ref["init"]
        torch.cuda.empty_cache()
    if mesh is not None:
        state, out = train_steps(torch, sharding, comm, ts, opt_lib, cfg, mesh, device)
        out["gap"] = state_gap(torch, sharding, state, sound, init,
                               sharding.param_shardings(mesh, state.params, cfg, fsdp=True),
                               mesh)
        return out
    one = next(n for n in sound.params if n.startswith(("layers.0.", "enc.0.")))
    inner = opt_lib.apply
    out["planted"] = {}
    for fault, names, factor in (("every gradient halved", None, 0.5),
                                 (f"{one}'s gradient times -1/2", [one], -0.5)):
        def apply(opt_cfg, params, grads, opt_state, names=names, factor=factor):
            for n in names or list(grads):
                grads[n] = factor * grads[n]
            return inner(opt_cfg, params, grads, opt_state)

        opt_lib.apply = apply
        try:
            bad, bad_out = train_steps(torch, sharding, comm, ts, opt_lib, cfg, None, device)
        finally:
            opt_lib.apply = inner
        gap = state_gap(torch, sharding, bad, sound, init)
        gap["grad_norm"] = max(abs(a - b) / abs(b)
                               for a, b in zip(bad_out["grad_norms"], out["grad_norms"]))
        out["planted"][fault] = gap
    return out


def train_steps(torch, sharding, comm, ts, opt_lib, cfg, mesh, device):
    """(the state after PLACE_TRAIN_STEPS steps, `place_train`'s numbers;
    the collective bytes are the last step's).  On ``meta``, the steps'
    counts alone."""
    meta = torch.device(device).type == "meta"
    kw, resident = {}, {}
    counter = None
    if mesh is None:
        state = ts.init_state(cfg, 0, device=device)
        open_gates(state.params)
    else:
        import torch.distributed as dist

        for turn in range(dist.get_world_size()):  # one whole state on the card at a time
            if turn == dist.get_rank():
                state = ts.init_state(cfg, 0, device=device)
                open_gates(state.params)
                fsdp = sharding.param_shardings(mesh, state.params, cfg, fsdp=True)
                state = ts.place_state(state, fsdp, mesh)
                if torch.device(device).type == "cuda":
                    torch.cuda.empty_cache()
            dist.barrier()
        resident = {"got": sum(t.to_local().numel() * t.element_size()
                               for tree in (state.params, state.opt.mu, state.opt.nu)
                               for t in tree.values()),
                    "specs": 3 * sum(sharding.spec_bytes(t.shape, 4, fsdp[n], mesh)
                                     for n, t in state.params.items())}
        counter = comm.CollectiveCounter(mesh)
        kw = dict(cast_shardings=sharding.param_shardings(mesh, state.params, cfg),
                  grad_shardings=fsdp, counter=counter)
    step = ts.make_train_step(cfg, opt_lib.AdamWConfig(warmup_steps=1), **kw)
    tokens = place_tokens(torch, cfg, PLACE_TRAIN_B, PLACE_TRAIN_S, 2, device)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1),
             **family_context(torch, cfg, device, PLACE_TRAIN_B)}
    steps = 1 if cfg.family in FAMILY_ONE_STEP else PLACE_TRAIN_STEPS
    losses, norms, times = [], [], []
    for i in range(steps):
        sync(torch, device)
        t = time.perf_counter()
        if counter is not None and i == steps - 1:
            with counter:
                state, metrics = step(state, batch)
        else:
            state, metrics = step(state, batch)
        if not meta:
            losses.append(float(sharding.gather(metrics["loss"])))
            norms.append(float(sharding.gather(metrics["grad_norm"])))
        sync(torch, device)
        times.append(1e3 * (time.perf_counter() - t))
    out = {"losses": losses, "grad_norms": norms, "ms": min(times[1:] or times),
           "resident": resident}
    if counter is not None:
        out["bytes"] = counted_bytes(counter)
        out["collective_s"] = {f"{phase}.{name}": round(v, 4)
                               for (phase, name), v in counter.seconds.items()}
    return state, out


def state_gap(torch, sharding, state, ref, init, specs=None, mesh=None) -> dict:
    """The gap of ``state``'s tensors (a rank's blocks, under ``specs`` on
    ``mesh``) from ``ref``'s (whole; the same blocks cut from them), the
    largest over leaves: for mu and nu max |a - b| / max |b|; for the
    masters ||a - b|| / ||b - init||, against the update the steps made
    (AdamW moves a weight by ~lr whatever its gradient's size, so a
    near-zero gradient element that rounding flips moves its weight by
    ~2 lr: no bound on the largest element, and a share of the update's
    norm)."""
    out = {}
    for tree, got, want in (("masters", state.params, ref.params),
                            ("mu", state.opt.mu, ref.opt.mu), ("nu", state.opt.nu, ref.opt.nu)):
        worst = 0.0
        for n, a in got.items():
            if n not in want:  # a subset of the leaves (`place_train`'s ref)
                continue
            b, b0 = want[n].to(a.device), init[n].to(a.device)
            if mesh is not None:
                a = a.to_local()
                b, b0 = (sharding.place({n: x}, {n: specs[n]}, mesh)[n].to_local()
                         for x in (b, b0))
            if tree == "masters":
                err, scale = (a - b).norm().item(), (b - b0).norm().item()
            else:
                err, scale = (a - b).abs().max().item(), b.abs().max().item()
            worst = max(worst, err / scale if scale > 0 else err)
        out[tree] = worst
    return out


def place_step_arithmetic(torch, sharding, ts, cfg, mesh) -> int:
    """A training step's cast all-gather bytes over 'data' from the specs
    (each leaf from its FSDP block to its TP block, in the dtype the step
    casts it to), which is also its gradients' reduce-scatter."""
    from repro_torch.models import model as model_lib

    meta = dict(model_lib.model_class(cfg)(cfg, None, device="meta").named_parameters())
    cast = ts.cast_params(cfg, {n: p.to(torch.float32) for n, p in meta.items()})
    fsdp = sharding.param_shardings(mesh, meta, cfg, fsdp=True)
    d = mesh.size(mesh.mesh_dim_names.index("data"))
    return sum((d - 1) * sharding.spec_bytes(p.shape, cast[n].element_size(), fsdp[n], mesh)
               for n, p in meta.items() if d > 1 and "data" in fsdp[n])


def place_moe(torch, model_lib, sharding, lm, cfg, mesh, device):
    """A prefill (B, PLACE_MOE_S) and the routing of each MoE layer; on a
    ``mesh`` also its collective bytes and this rank's resident bytes (on
    ``meta``, those alone)."""
    from repro_torch.launch import comm
    from repro_torch.models import moe

    meta = torch.device(device).type == "meta"
    tokens = place_tokens(torch, cfg, PLACE_B, PLACE_MOE_S, 3, device)
    batch = {"tokens": tokens}
    if mesh is not None:
        batch = sharding.place(batch, sharding.batch_shardings(mesh, batch), mesh)
    log = []
    inner = moe.dispatch

    def dispatch(cfg_, expert_idx, gate_vals):
        log.append(expert_idx if meta else expert_idx.cpu())
        return inner(cfg_, expert_idx, gate_vals)

    counter = comm.CollectiveCounter(mesh) if mesh is not None else contextlib.nullcontext()
    moe.dispatch = dispatch
    try:
        with torch.no_grad():
            sync(torch, device)
            t = time.perf_counter()
            with counter:
                logits = sharding.gather(model_lib.prefill_logits(lm, cfg, batch))
            sync(torch, device)
            ms = 1e3 * (time.perf_counter() - t)
    finally:
        moe.dispatch = inner
    out = {}
    if mesh is not None:
        out = {"resident": local_bytes(list(lm.parameters())),
               "counts": {"prefill": counted_bytes(counter)}}
    if meta:
        return out
    return {**out, "prefill": logits.cpu(), "routing": torch.stack(log), "ms": ms}


def place_ptlm(torch, model_lib, lm, cfg, mesh_spec, device, halves: bool):
    from repro_torch.core import keys, ladder
    from repro_torch.core.ptlm import LMSystem
    from repro_torch.engine import Engine, EngineConfig

    system = LMSystem(cfg=cfg, seq_len=PLACE_PTLM_SEQ, prompt_len=PLACE_PTLM_PROMPT).bind(lm)
    if halves:
        system = HalvesLM(torch, system)
    eng = Engine(system, EngineConfig(n_replicas=PLACE_PTLM_R, swap_interval=5,
                                      mesh=mesh_spec), device=device)
    temps = ladder.geometric_ladder(PLACE_PTLM_R, 1.0, 8.0)
    st = eng.init(keys.key(4), temps)
    torch.cuda.synchronize()
    t = time.perf_counter()
    st, _ = eng.run(st, PLACE_PTLM_STEPS)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t) / PLACE_PTLM_STEPS
    if mesh_spec is not None:
        st = eng.gathered(st)
    return {"states": st.pt.states.cpu(), "rung": st.pt.rung.cpu(),
            "energy": st.pt.energy.cpu(), "attempts": st.stats.swap_attempts.cpu(),
            "accepts": st.stats.swap_accepts.cpu(), "ms_step": ms}


def placed_lm(torch, cfg, mesh, device):
    """The config's model from the seed 0 (the vlm's gates opened), on
    ``mesh`` placed under ``param_shardings``: ranks sharing the card make
    their whole model in turn, so one whole model is on the card at a time."""
    import gc

    from repro_torch.launch import sharding
    from repro_torch.models import model as model_lib

    if mesh is None:
        lm = model_lib.init_params(cfg, 0, device=device)  # seeded on the device
        open_gates(dict(lm.named_parameters()))
        return lm
    import torch.distributed as dist

    lm = None
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            lm = model_lib.init_params(cfg, 0, device=device)
            open_gates(dict(lm.named_parameters()))
            sharding.place_module(lm, sharding.param_shardings(mesh, lm, cfg), mesh)
            gc.collect()
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    return lm


def placement_runs(torch, np, build, device, mesh_for, forced: dict | None) -> dict:
    """Every run of phase 28: unsharded where ``mesh_for`` gives None (this
    process), else on the mesh it gives (a spawned rank).  ``out["seconds"]``
    holds each part's wall time."""
    import gc

    from repro_torch.core.distributed import MeshSpec
    from repro_torch.launch import comm, sharding
    from repro_torch.models import model as model_lib
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts

    cfgs = place_cfgs()
    out = {"seconds": {}}
    ranks = mesh_for((1, 2)) is not None
    t_last = [time.perf_counter()]

    def done(part):
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        now = time.perf_counter()
        out["seconds"][part] = now - t_last[0]
        t_last[0] = now

    def model(cfg, mesh=None):
        return placed_lm(torch, cfg, mesh, device)

    for shape in PLACE_MESHES if ranks else (None,):
        mesh = None if shape is None else mesh_for(shape)
        key = "unsharded" if shape is None else "x".join(map(str, shape))
        cfg = cfgs["gemma_serve"]
        lm = model(cfg, mesh)
        done(f"gemma init {key}")
        res = place_serve(torch, build, model_lib, sharding, lm, cfg, mesh,
                          None if forced is None else forced["gemma"], device)
        if mesh is not None:
            specs = sharding.param_shardings(mesh, lm, cfg)
            res["resident"] = {
                "got": sum(p.to_local().numel() * p.element_size() for p in lm.parameters()),
                "specs": sum(sharding.spec_bytes(p.shape, p.element_size(), specs[n], mesh)
                             for n, p in lm.named_parameters())}
        out[f"gemma_serve_{key}"] = res
        del lm
        done(f"gemma serve {key}")
        res = place_train(torch, sharding, comm, ts, opt_lib, cfgs["gemma_train"], mesh, device)
        if mesh is not None:
            res["arithmetic"] = place_step_arithmetic(torch, sharding, ts, cfgs["gemma_train"],
                                                      mesh)
        out[f"gemma_train_{key}"] = res
        done(f"gemma train {key}")

    lm = model(cfgs["rwkv"], mesh_for((1, 2)))
    done("rwkv6-7b init")
    out["rwkv"] = place_serve(torch, build, model_lib, sharding, lm, cfgs["rwkv"],
                              mesh_for((1, 2)), None if forced is None else forced["rwkv"],
                              device, seq=PLACE_RWKV_S, n_decode=PLACE_RWKV_DECODE)
    del lm
    done("rwkv6-7b serve")
    lm = model(cfgs["moe"], mesh_for((2, 1)))
    out["moe"] = place_moe(torch, model_lib, sharding, lm, cfgs["moe"], mesh_for((2, 1)), device)
    del lm
    done("qwen3-moe prefill")
    if device.type == "meta":  # the dry run: PT-LM's gathers are the PT mesh's, not DTensor's
        return out
    lm = model(cfgs["gemma"])
    out["ptlm"] = place_ptlm(torch, model_lib, lm, cfgs["gemma"],
                             MeshSpec(1, 2) if ranks else None, device, halves=not ranks)
    del lm
    done("PT-LM")
    return out


def placement_rank(rank: int, world: int, outdir: str, device: str = "cuda:0",
                   runs: str = "placement") -> None:
    """One of phase 28's (``runs="placement"``: `placement_runs`) or phase
    29's (``"family"``: `family_runs`) two ranks sharing the card over gloo:
    every run on its mesh; rank 0 saves the arrays, both their numbers."""
    sys.path.insert(0, str(SRC))
    import datetime
    import faulthandler

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import build
    from repro_torch.launch import comm, sharding
    from repro_torch.launch import mesh as mesh_lib

    faulthandler.enable()
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(outdir, "store"), world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    if device.startswith("cuda"):
        comm.eager_collectives()  # gloo's functional collectives crash on CUDA tensors
    forced = {k: torch.from_numpy(v)
              for k, v in np.load(os.path.join(outdir, "forced.npz")).items()}
    try:
        meshes = functools.lru_cache(None)(
            lambda shape: mesh_lib.device_mesh(shape, ("data", "model"), device))
        # a process's first placement imports much of torch (with the ranks placing in
        # turn, phase 28's first part took 16.7-25.6 s on one NVIDIA H100 80GB HBM3,
        # 700.00 W): both ranks pay it here at once, not in turn in `placement_runs`
        sharding.place(torch.zeros(2, device=device), (None,), meshes((2, 1)))
        if runs == "family":
            ref = torch.load(os.path.join(outdir, "ref.pt"))
            out = family_runs(torch, np, build, torch.device(device), meshes, forced, ref)
        else:
            out = placement_runs(torch, np, build, torch.device(device), meshes, forced)
    finally:
        dist.barrier()
    arrays, numbers = place_split(out)
    if rank == 0:
        np.savez(os.path.join(outdir, "place0.npz"), **arrays)
    with open(os.path.join(outdir, f"place{rank}.json"), "w") as f:
        json.dump(numbers, f)
    dist.barrier()
    dist.destroy_process_group()


def place_split(out: dict):
    """(arrays by "run.key", the other numbers by run) of `placement_runs`."""
    arrays, numbers = {}, {}
    for run, res in out.items():
        numbers[run] = {}
        for k, v in res.items():
            if hasattr(v, "numpy"):
                arrays[f"{run}.{k}"] = v.float().numpy() if v.is_floating_point() else v.numpy()
            else:
                numbers[run][k] = v
    return arrays, numbers


def placement_phases(torch, np, build, device, card: str) -> dict:
    """Phase 28: the LM placement layer on two ranks sharing the card:
    gemma-2b serving and training on (2, 1) (FSDP) and (1, 2) (TP),
    rwkv6-7b serving on (1, 2) with kernel #7 on each rank's heads,
    qwen3-moe-235b token-stationary prefill on (2, 1), PT-LM over gemma-2b
    on MeshSpec(1, 2); each against its unsharded run on the card."""
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="place_", dir=ROOT / "build"))
    ref = placement_runs(torch, np, build, device, lambda shape: None, None)
    np.savez(work / "forced.npz", gemma=ref["gemma_serve_unsharded"]["tokens"].numpy(),
             rwkv=ref["rwkv"]["tokens"].numpy())
    ref_s = time.perf_counter() - t_phase
    t = time.perf_counter()
    mp.start_processes(placement_rank, args=(2, str(work), "cuda:0" if device.type == "cuda"
                                             else "cpu"), nprocs=2, start_method="spawn")
    spawn_s = time.perf_counter() - t
    ranks = [json.loads((work / f"place{k}.json").read_text()) for k in range(2)]
    got = dict(np.load(work / "place0.npz"))
    cfgs = place_cfgs()
    failures, lines = [], []

    def close(a, b, what, model):
        """max |a - b| against PLACE_LOGITS_RTOL[model] times the scale of b
        (its largest magnitude): rounding, reassociated by the TP split,
        moves logits in proportion to their size."""
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        err, scale = float(np.max(np.abs(a - b))), float(np.max(np.abs(b)))
        rtol = PLACE_LOGITS_RTOL[model]
        if not err <= rtol * scale:
            failures.append(f"{what}: max |placed - unsharded| {err} past {rtol} x "
                            f"the scale {scale}")
        return f"{err:.3g} of {scale:.3g}"

    def same(a, b, what):
        if not np.array_equal(a, b):
            failures.append(f"{what} differ ({int(np.sum(np.asarray(a) != np.asarray(b)))} of "
                            f"{np.asarray(b).size})")

    def greedy(got_logits, want_logits, got_tokens, want_tokens, what):
        """Teacher-forced greedy tokens: equal wherever the logits' gap
        cannot flip them.  A token may differ only where the unsharded top-2
        margin is at most twice that step and row's max |placed - unsharded|
        (no larger gap can reorder the two).  Returns the flips' text."""
        want_sorted = np.sort(want_logits, axis=-1)
        margin = want_sorted[..., -1] - want_sorted[..., -2]  # (steps, B)
        err = np.max(np.abs(got_logits.astype(np.float64) - want_logits), axis=-1)
        flips = np.argwhere(got_tokens.T != want_tokens.T)  # (step, row) pairs
        for step, row in flips:
            if margin[step, row] > 2 * err[step, row]:
                failures.append(f"{what}: step {step} row {row} token differs at a top-2 margin "
                                f"{margin[step, row]} > 2 x {err[step, row]}")
        return (f"{len(flips)} of {got_tokens.size} differ, each at a top-2 margin within twice "
                f"its logits' gap" if len(flips) else "equal")

    want_g = ref["gemma_serve_unsharded"]
    want_t = ref["gemma_train_unsharded"]
    for shape in PLACE_MESHES:
        key = "x".join(map(str, shape))
        run = f"gemma_serve_{key}"
        e_pre = close(got[f"{run}.prefill"], want_g["prefill"].numpy(), f"gemma-2b {shape} prefill",
                      "gemma")
        e_dec = close(got[f"{run}.decode"], want_g["decode"].numpy(), f"gemma-2b {shape} decode",
                      "gemma")
        same(got[f"{run}.tokens"], want_g["tokens"].numpy(), f"gemma-2b {shape} greedy tokens")
        res = [r[run] for r in ranks]
        tr = [r[f"gemma_train_{key}"] for r in ranks]
        for k in range(2):
            for what, r in (("serving", res[k]), ("training", tr[k])):
                if r["resident"]["got"] != r["resident"]["specs"]:
                    failures.append(f"gemma-2b {shape} {what} rank {k}: resident "
                                    f"{r['resident']} != the specs' arithmetic")
            for what, rtol in (("losses", PLACE_LOSS_RTOL), ("grad_norms", PLACE_GRADNORM_RTOL)):
                for a, b in zip(tr[k][what], want_t[what]):
                    if not abs(a - b) <= rtol * abs(b):
                        failures.append(f"gemma-2b train {shape} rank {k}: {what} {a} != {b}")
            for tree, gap in tr[k]["gap"].items():
                if not gap <= PLACE_STATE_RTOL[tree]:
                    failures.append(f"gemma-2b train {shape} rank {k}: {tree} {gap} from the "
                                    f"unsharded state, past {PLACE_STATE_RTOL[tree]}")
            cast = tr[k]["bytes"].get("cast.all_gather_into_tensor.data", 0)
            grads = tr[k]["bytes"].get("grads.reduce_scatter_tensor.data", 0)
            if cast != tr[k]["arithmetic"] or grads != tr[k]["arithmetic"]:
                failures.append(f"gemma-2b train {shape} rank {k}: cast {cast} B / grads "
                                f"{grads} B a step != the specs' {tr[k]['arithmetic']} B")
        other = {k: v for k, v in tr[0]["bytes"].items()
                 if k not in ("cast.all_gather_into_tensor.data",
                              "grads.reduce_scatter_tensor.data")}
        lines.append(
            f"gemma-2b {shape}: serving resident {res[0]['resident']['got']} B a rank (the "
            f"specs' {res[0]['resident']['specs']}); f32; prefill (4, {PLACE_S}) "
            f"{res[0]['prefill_ms']:.1f} ms = {PLACE_B * PLACE_S / res[0]['prefill_ms'] * 1e3:.0f} "
            f"tokens/s (unsharded {want_g['prefill_ms']:.1f} ms), decode "
            f"{res[0]['decode_ms']:.2f} ms/token (unsharded {want_g['decode_ms']:.2f}), max "
            f"|d logits| prefill {e_pre}, decode {e_dec} over {PLACE_DECODE} steps, greedy tokens "
            f"equal; training {PLACE_TRAIN_LAYERS} of 18 layers ({PLACE_TRAIN_B}, "
            f"{PLACE_TRAIN_S}), bf16 compute: masters + moments "
            f"{tr[0]['resident']['got']} B a rank (the specs' {tr[0]['resident']['specs']}), "
            f"losses {[round(x, 5) for x in tr[0]['losses']]} (unsharded "
            f"{[round(x, 5) for x in want_t['losses']]}), grad norms "
            f"{[round(x, 5) for x in tr[0]['grad_norms']]} (unsharded "
            f"{[round(x, 5) for x in want_t['grad_norms']]}), after step {PLACE_TRAIN_STEPS} each "
            f"rank's blocks' largest gap from the unsharded state (masters: of the update's "
            f"norm; mu, nu: of the leaf's largest) "
            + ", ".join(f"{t} {max(r['gap'][t] for r in tr):.3g}" for t in PLACE_STATE_RTOL)
            + f" (limits {PLACE_STATE_RTOL}), {tr[0]['ms']:.1f} ms a step "
            f"(unsharded {want_t['ms']:.1f}), a step's cast all-gather / grads reduce-scatter "
            f"over 'data' {tr[0]['bytes'].get('cast.all_gather_into_tensor.data', 0)} / "
            f"{tr[0]['bytes'].get('grads.reduce_scatter_tensor.data', 0)} B (the specs' "
            f"{tr[0]['arithmetic']}), other collectives a step {other}, host s in the "
            f"collectives {tr[0]['collective_s']}")
    (all_halved, all_gap), (one_wrong, one_gap) = want_t["planted"].items()
    if not all_gap["grad_norm"] > PLACE_GRADNORM_RTOL:
        failures.append(f"the planted fault ({all_halved}) moved the grad norm by "
                        f"{all_gap['grad_norm']}, within the limit {PLACE_GRADNORM_RTOL}")
    for tree in PLACE_STATE_RTOL:
        if not one_gap[tree] > PLACE_STATE_RTOL[tree]:
            failures.append(f"the planted fault ({one_wrong}) moved {tree} by {one_gap[tree]}, "
                            f"within the limit {PLACE_STATE_RTOL[tree]}")
    lines.append("gemma-2b training, planted faults (unsharded, read against the sound run): "
                 + "; ".join(f"{fault}: " + ", ".join(f"{t} {v:.3g}" for t, v in gap.items())
                             for fault, gap in want_t["planted"].items())
                 + f" (the grad norm past {PLACE_GRADNORM_RTOL} for the first, the masters, mu "
                 "and nu past their limits for the second)")
    want_r = ref["rwkv"]
    e_pre = close(got["rwkv.prefill"], want_r["prefill"].numpy(), "rwkv6-7b prefill", "rwkv")
    e_dec = close(got["rwkv.decode"], want_r["decode"].numpy(), "rwkv6-7b decode", "rwkv")
    flips = greedy(got["rwkv.decode"], want_r["decode"].numpy(), got["rwkv.tokens"],
                   want_r["tokens"].numpy(), "rwkv6-7b (1, 2) greedy tokens")
    n_layers = cfgs["rwkv"].n_layers
    for k, r in enumerate(ranks + [ref]):
        for part, want in (("prefill", n_layers), ("decode", n_layers * PLACE_RWKV_DECODE)):
            n = r["rwkv"][f"{part}_launches"]
            if {kk: v for kk, v in n.items() if v} != {"wkv6": want}:
                failures.append(f"rwkv6-7b {part} {'unsharded' if k == 2 else f'rank {k}'}: "
                                f"launches {n} != wkv6 {want}")
    rr = ranks[0]["rwkv"]
    lines.append(
        f"rwkv6-7b (1, 2), full width and depth: kernel #7 launched {n_layers} times a forward "
        f"on each rank over its 32 of 64 heads ({rr['prefill_launches']['wkv6']} in the prefill, "
        f"{rr['decode_launches']['wkv6']} in {PLACE_RWKV_DECODE} decode steps a rank); f32; "
        f"prefill (4, {PLACE_RWKV_S}) {rr['prefill_ms']:.1f} ms = "
        f"{PLACE_B * PLACE_RWKV_S / rr['prefill_ms'] * 1e3:.0f} tokens/s (unsharded "
        f"{want_r['prefill_ms']:.1f}), decode {rr['decode_ms']:.2f} ms/token (unsharded "
        f"{want_r['decode_ms']:.2f}), max |d logits| prefill {e_pre}, decode {e_dec}; greedy "
        f"tokens {flips}")
    e_moe = close(got["moe.prefill"], ref["moe"]["prefill"].numpy(), "qwen3-moe prefill", "moe")
    same(got["moe.routing"], ref["moe"]["routing"].numpy(), "qwen3-moe (2, 1) routing")
    lines.append(
        f"qwen3-moe-235b (2, 1), full width, {PLACE_MOE_LAYERS} of 94 layers, "
        f"moe_token_stationary: prefill (4, {PLACE_MOE_S}) {ranks[0]['moe']['ms']:.1f} ms "
        f"(unsharded {ref['moe']['ms']:.1f}), routing of both layers compared, max |d logits| "
        f"{e_moe}")
    for f in ("states", "rung", "attempts", "accepts"):
        same(got[f"ptlm.{f}"], ref["ptlm"][f].numpy(), f"PT-LM MeshSpec(1, 2) {f}")
    e_pt = float(np.max(np.abs(got["ptlm.energy"] - ref["ptlm"]["energy"].numpy())))
    if not np.allclose(got["ptlm.energy"], ref["ptlm"]["energy"].numpy(), rtol=PTLM_ENERGY_RTOL,
                       atol=0):
        failures.append(f"PT-LM: energies {e_pt} apart")
    lines.append(
        f"PT-LM over gemma-2b on MeshSpec(1, 2): R={PLACE_PTLM_R} x {PLACE_PTLM_SEQ} tokens, "
        f"{PLACE_PTLM_STEPS} MH steps against one process stepping the halves at offsets 0 and "
        f"{PLACE_PTLM_R // 2}, energies within {e_pt:.3g}; {ranks[0]['ptlm']['ms_step']:.1f} ms "
        f"a step a rank (the replay {ref['ptlm']['ms_step']:.1f})")
    print(f"phase 28 LM placement [{card}] (two ranks over gloo share the one card, so these "
          f"times measure contention, not scaling): " + "; ".join(lines))
    print("phase 28 seconds: unsharded " + ", ".join(
        f"{k} {v:.1f}" for k, v in ref["seconds"].items()) + f" ({ref_s:.1f} s); ranks "
        + ", ".join(f"{k} {v:.1f}" for k, v in ranks[0]["seconds"].items())
        + f" ({spawn_s:.1f} s with their start)")
    if failures:
        raise AssertionError("phase 28: " + "; ".join(failures))
    import shutil

    shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    print(f"phase 28 done in {seconds:.1f} s")
    return {"seconds": seconds, "ranks": ranks}


# -- phase 29: the dry run, and the hybrid, vlm and encdec families placed ---------
# (a) Two spawned ranks over gloo share cuda:0, as phase 28's: recurrentgemma-9b
# serving on (1, 2) and (2, 1), llama-3.2-vision-11b on (1, 2) over a seeded
# (4, 1601) image with its cross gates set to 1.0 (as phase 27 sets them; a zero
# gate adds exactly 0), whisper-medium on (2, 1) and (1, 2) over seeded (4, 1500)
# frames: f32 prefill (4, FAMILY_S) then FAMILY_DECODE teacher-forced decode
# steps, each against the unsharded run made first in the parent; and one bf16
# training step of each family on one mesh.  Full width; depth cut to fit two
# copies on the card and the phase's time: recurrentgemma two pattern periods
# to serve (6 of 38 layers) and one to train (3), llama-3.2-vision 10 of 40
# layers to serve (two of them cross layers) and 5 to train (one), whisper 6 +
# 6 of 24 + 24 to serve and 2 + 2 to train.  A rank runs no unsharded training
# step (two whole states of a 256k-vocab model beside the placed ones would not
# fit): it reads its gap from the parent's sound step on layer 0's leaves of at
# most 2^22 elements and the final norm (`FAMILY_KEEP`), which hold the planted
# fault's leaf (`family_keep`); the loss and the grad norm cover every leaf.  The limits are
# phase 28's (PLACE_*), the planted faults read again for each family.
# (b) Every placed program of phase 28 and of (a) again on meta tensors over a
# fake process group of the mesh's size (device type cuda, as the ranks'), in a
# process started with the script: its collective bytes by (phase, collective,
# mesh axis) and the resident bytes a rank must equal the ranks' readings
# exactly; and gemma-2b prefill (4, 512) unsharded, its roofline's terms beside
# phase 25's measured time.  (c) `repro_torch.launch.dryrun --arch all --shape
# all --mesh both` and `dryrun_ising --mesh both`, also started with the script
# (CPU only, meta tensors, DRY_JOBS cell processes); a failed cell fails the phase.
FAMILY_S, FAMILY_DECODE = 64, 4
FAMILY_ONE_STEP = ("hybrid", "vlm", "encdec")
FAMILY_CELLS = (("recurrentgemma", "serve", (1, 2)), ("recurrentgemma", "serve", (2, 1)),
                ("recurrentgemma", "train", (2, 1)), ("vlm", "serve", (1, 2)),
                ("vlm", "train", (1, 2)), ("whisper", "serve", (2, 1)),
                ("whisper", "serve", (1, 2)), ("whisper", "train", (1, 2)))
FAMILY_LOGITS_RTOL = 1e-4  # phase 28's f32 limit (gemma-2b read ~8e-7)
DRY_JOBS = 3  # dry-run cell processes beside the card's phases (8 host cores)
DRY_TIMEOUT_S = 900


def family_keep(name: str) -> bool:
    """Whether a rank's training gap reads leaf ``name``: one of layer 0
    (whisper's first encoder and decoder layers), or the final norm; the
    caller also caps its elements at FAMILY_KEEP_MAX."""
    return name == "final_norm" or name.startswith(("layers.0.", "enc.0.", "dec.0."))


FAMILY_KEEP_MAX = 1 << 22


def family_cfgs():
    """fam -> {"serve": f32 config, "train": bf16 config}, full width."""
    from repro_torch.configs import get_config

    rg, vl, wh = (get_config(a) for a in ("recurrentgemma_9b", "llama32_vision_11b",
                                          "whisper_medium"))
    return {"recurrentgemma": {"serve": dataclasses.replace(rg, dtype="float32", n_layers=6),
                               "train": dataclasses.replace(rg, n_layers=3)},
            "vlm": {"serve": dataclasses.replace(vl, dtype="float32", n_layers=10),
                    "train": dataclasses.replace(vl, n_layers=5)},
            "whisper": {"serve": dataclasses.replace(wh, dtype="float32", n_layers=6,
                                                     enc_layers=6),
                        "train": dataclasses.replace(wh, n_layers=2, enc_layers=2)}}


def open_gates(named: dict) -> None:
    """The vlm's cross gates set to 1.0 in place (JAX makes them 0)."""
    for name, p in named.items():
        if name.endswith(".gate"):
            p.data.fill_(1.0)


def family_context(torch, cfg, device, batch: int = PLACE_B) -> dict:
    """The family's context in a batch: a seeded N(0, 1) image (batch,
    img_tokens, D) for the vlm, frames (batch, enc_seq, D) for whisper, in
    the compute dtype; else nothing (on ``meta``, its shape)."""
    name, n = {"vlm": ("img", cfg.img_tokens), "encdec": ("frames", cfg.enc_seq)}.get(
        cfg.family, (None, 0))
    if name is None:
        return {}
    shape, dt = (batch, n, cfg.d_model), cfg.compute_dtype
    if torch.device(device).type == "meta":
        return {name: torch.empty(shape, dtype=dt, device="meta")}
    return {name: torch.randn(shape, device=device, generator=torch.Generator(
        device=device).manual_seed(2)).to(dt)}


def family_runs(torch, np, build, device, mesh_for, forced: dict | None,
                ref: dict | None = None) -> dict:
    """Every run of phase 29(a): unsharded where ``mesh_for`` gives None
    (this process: each config once), else on the mesh it gives (a spawned
    rank, or the dry run's fake group on ``meta``).  ``ref``: the parent's
    sound training subsets by family."""
    import gc

    from repro_torch.launch import comm, sharding
    from repro_torch.models import model as model_lib
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts

    cfgs = family_cfgs()
    out = {"seconds": {}}
    t_last = time.perf_counter()
    for fam, kind, shape in FAMILY_CELLS:
        mesh = mesh_for(shape)
        key = f"{fam}_{kind}_" + ("unsharded" if mesh is None else "x".join(map(str, shape)))
        if key in out:
            continue
        cfg = cfgs[fam][kind]
        if kind == "serve":
            lm = placed_lm(torch, cfg, mesh, device)
            out[key] = place_serve(torch, build, model_lib, sharding, lm, cfg, mesh,
                                   None if forced is None else forced[fam], device,
                                   seq=FAMILY_S, n_decode=FAMILY_DECODE)
            del lm
        else:
            keep = None
            if mesh is None:
                shapes = dict(model_lib.model_class(cfg)(cfg, None, device="meta")
                              .named_parameters())

                def keep(n, shapes=shapes):
                    return family_keep(n) and shapes[n].numel() <= FAMILY_KEEP_MAX
            out[key] = place_train(torch, sharding, comm, ts, opt_lib, cfg, mesh, device,
                                   ref=None if ref is None else ref[fam], keep=keep)
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        now = time.perf_counter()
        out["seconds"][key] = now - t_last
        t_last = now
    return out


def dry_counts(outdir: str) -> None:
    """Phase 29(b), a process of its own: every placed program of phases 28
    and 29(a) on ``meta`` tensors over a fake group of its mesh's size (a
    ``cuda`` DeviceMesh, as the ranks'), the counts `placement_runs` and
    `family_runs` report; and gemma-2b prefill (4, 512) on one rank, counted.
    Writes ``dry.json``."""
    sys.path.insert(0, str(SRC))
    warnings.filterwarnings("ignore")
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.hlo.roofline import Roofline, analytic_hbm_bytes, model_flops
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    from repro_torch.launch.input_specs import ShapeCell

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    meta = torch.device("meta")

    def mesh_for(shape):
        return dryrun.fake_mesh(shape, ("data", "model"), "cuda")

    out = {"placement": placement_runs(torch, np, build, meta, mesh_for, None),
           "family": family_runs(torch, np, build, meta, mesh_for, None)}
    cfg = get_config("gemma_2b")
    cell = ShapeCell("card", "prefill", 512, PLACE_B)
    rec = dryrun.lower_one(cfg, cell, dryrun.fake_mesh((1, 1), ("data", "model"), "cuda"),
                           "card")
    mf = model_flops(cfg, "prefill", PLACE_B, 512)
    out["gemma_prefill"] = {"record": rec, "model_flops": mf, "roofline": Roofline(
        flops_per_device=rec["flops"], hbm_bytes_per_device=rec["hbm_traffic_bytes"],
        coll_wire_bytes_per_device=0.0, model_flops_global=mf, n_devices=1,
        hbm_analytic_per_device=analytic_hbm_bytes(cfg, "prefill", PLACE_B, 512, 1, 1)).row()}
    out["seconds"] = time.perf_counter() - t0
    with open(os.path.join(outdir, "dry.json"), "w") as f:
        json.dump(out, f, default=str)



def family_phases(torch, np, build, device, card: str, dry: dict, lmpt: dict,
                  pl: dict) -> dict:
    """Phase 29: (a) the hybrid, vlm and encdec families placed on two ranks
    sharing the card, each against its unsharded run; (b) the dry run of
    every placed program of phases 28 and 29(a) equal to the ranks'
    counted bytes, and gemma-2b prefill's roofline; (c) the dry-run CLI
    over every cell and `dryrun_ising`, started with the script."""
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="family_", dir=ROOT / "build"))
    ref = family_runs(torch, np, build, device, lambda shape: None, None)
    fams = ("recurrentgemma", "vlm", "whisper")
    np.savez(work / "forced.npz", **{f: ref[f"{f}_serve_unsharded"]["tokens"].numpy()
                                     for f in fams})
    torch.save({f: ref[f"{f}_train_unsharded"].pop("ref") for f in fams}, work / "ref.pt")
    ref_s = time.perf_counter() - t_phase
    t = time.perf_counter()
    mp.start_processes(placement_rank, args=(2, str(work), "cuda:0" if device.type == "cuda"
                                             else "cpu", "family"), nprocs=2,
                       start_method="spawn")
    spawn_s = time.perf_counter() - t
    ranks = [json.loads((work / f"place{k}.json").read_text()) for k in range(2)]
    got = dict(np.load(work / "place0.npz"))
    failures, lines = [], []

    def gap(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b))), float(np.max(np.abs(b)))

    # (a) placed == unsharded
    for fam, kind, shape in FAMILY_CELLS:
        key = "x".join(map(str, shape))
        run, want = f"{fam}_{kind}_{key}", ref[f"{fam}_{kind}_unsharded"]
        mine = [r[run] for r in ranks]
        if kind == "serve":
            errs = {}
            for part in ("prefill", "decode"):
                err, scale = gap(got[f"{run}.{part}"], want[part].numpy())
                errs[part] = f"{err:.3g} of {scale:.3g}"
                if not err <= FAMILY_LOGITS_RTOL * scale:
                    failures.append(f"{run} {part}: max |placed - unsharded| {err} past "
                                    f"{FAMILY_LOGITS_RTOL} x {scale}")
            margin = np.sort(want["decode"].numpy(), -1)
            margin = margin[..., -1] - margin[..., -2]
            err_row = np.max(np.abs(got[f"{run}.decode"] - want["decode"].numpy()), -1)
            flips = np.argwhere(got[f"{run}.tokens"].T != want["tokens"].numpy().T)
            for step, row in flips:
                if margin[step, row] > 2 * err_row[step, row]:
                    failures.append(f"{run}: step {step} row {row} token differs at a top-2 "
                                    f"margin {margin[step, row]}")
            lines.append(
                f"{run}: resident {mine[0]['resident']} B a rank, prefill (4, {FAMILY_S}) "
                f"{mine[0]['prefill_ms']:.1f} ms (unsharded {want['prefill_ms']:.1f}), decode "
                f"{mine[0]['decode_ms']:.2f} ms/token (unsharded {want['decode_ms']:.2f}), max "
                f"|d logits| prefill {errs['prefill']}, decode {errs['decode']} over "
                f"{FAMILY_DECODE} steps, greedy tokens {len(flips)} flips")
        else:
            for k, r in enumerate(mine):
                if r["resident"]["got"] != r["resident"]["specs"]:
                    failures.append(f"{run} rank {k}: resident {r['resident']}")
                for what, rtol in (("losses", PLACE_LOSS_RTOL),
                                   ("grad_norms", PLACE_GRADNORM_RTOL)):
                    for a, b in zip(r[what], want[what]):
                        if not abs(a - b) <= rtol * abs(b):
                            failures.append(f"{run} rank {k}: {what} {a} != {b}")
                for tree, g in r["gap"].items():
                    if not g <= PLACE_STATE_RTOL[tree]:
                        failures.append(f"{run} rank {k}: {tree} {g} past "
                                        f"{PLACE_STATE_RTOL[tree]}")
            (all_f, all_gap), (one_f, one_gap) = want["planted"].items()
            if not all_gap["grad_norm"] > PLACE_GRADNORM_RTOL:
                failures.append(f"{fam}: the planted fault ({all_f}) moved the grad norm by "
                                f"{all_gap['grad_norm']}, within {PLACE_GRADNORM_RTOL}")
            for tree in PLACE_STATE_RTOL:
                if not one_gap[tree] > PLACE_STATE_RTOL[tree]:
                    failures.append(f"{fam}: the planted fault ({one_f}) moved {tree} by "
                                    f"{one_gap[tree]}, within {PLACE_STATE_RTOL[tree]}")
            lines.append(
                f"{run}: one bf16 step, masters + moments {mine[0]['resident']['got']} B a rank "
                f"(the specs' {mine[0]['resident']['specs']}), loss {mine[0]['losses']} "
                f"(unsharded {want['losses']}), grad norm {mine[0]['grad_norms']} (unsharded "
                f"{want['grad_norms']}), gap on layer 0's small leaves "
                + ", ".join(f"{t} {max(r['gap'][t] for r in mine):.3g}" for t in PLACE_STATE_RTOL)
                + f"; planted, unsharded: " + "; ".join(
                    f"{fault}: " + ", ".join(f"{t} {v:.3g}" for t, v in g.items())
                    for fault, g in want["planted"].items())
                + f"; {mine[0]['ms']:.1f} ms a step (unsharded {want['ms']:.1f})")
    print(f"phase 29 placed families [{card}] (two ranks over gloo share the card): "
          + "; ".join(lines))
    print(f"phase 29 seconds: unsharded {ref_s:.1f} s, ranks {spawn_s:.1f} s with their start: "
          + ", ".join(f"{k} {v:.1f}" for k, v in ranks[0]["seconds"].items()))

    # (b) the dry run's counts == the ranks' readings
    deadline = time.perf_counter() + DRY_TIMEOUT_S
    rc, log, dry_s = wait_dry_run(dry, "counts", deadline)
    if rc != 0:
        raise AssertionError(f"phase 29 dry counts: exit {rc}\n{log[-4000:]}")
    counted = json.loads((dry["work"] / "dry.json").read_text())
    n_equal = 0
    for group, rank0 in (("placement", pl["ranks"][0]), ("family", ranks[0])):
        for run, want in counted[group].items():
            if run == "seconds":
                continue
            for field in ("counts", "bytes", "resident"):
                if field not in want:
                    continue
                if rank0[run][field] != want[field]:
                    failures.append(f"dry run {group} {run} {field}: {want[field]} != the "
                                    f"ranks' {rank0[run][field]}")
                else:
                    n_equal += 1
    gp = counted["gemma_prefill"]
    measured = PLACE_B * 512 / lmpt["gemma"]["prefill_tokens_s"] * 1e3
    roof_row = gp["roofline"]
    n_runs = sum(1 for g in ("placement", "family") for r in counted[g] if r != "seconds")
    print(f"phase 29 dry run == card [{card}]: {n_equal} counts (collective bytes by phase, "
          f"collective and mesh axis of each prefill, decode loop and training step; resident "
          f"bytes) of {n_runs} placed runs of phases 28 and 29 equal to the ranks' readings; the "
          f"dry run took "
          f"{counted['seconds']:.1f} s ({dry_s:.1f} s from its start to here); gemma-2b prefill "
          f"(4, 512) unsharded, bf16: counted {gp['record']['flops']:.4g} flops, "
          f"{gp['record']['hbm_traffic_bytes']:.4g} unfused bytes, model flops "
          f"{gp['model_flops']:.4g}: t_comp {1e3 * roof_row['t_comp_s']:.3f} ms, t_mem "
          f"(unfused) {1e3 * roof_row['t_mem_s']:.3f} ms, t_mem (analytic) "
          f"{1e3 * roof_row['t_mem_analytic_s']:.3f} ms, bound {1e3 * roof_row['bound_time_s']:.3f}"
          f" ms ({roof_row['dominant']}; analytic {roof_row['dominant_analytic']}) against "
          f"{measured:.2f} ms measured in phase 25")

    # (c) the CLI over every cell, and the Ising dry run
    rc, log, cli_s = wait_dry_run(dry, "cli", deadline)
    cells = [ln for ln in log.splitlines() if ln.startswith("[dryrun] ") and "/" in ln.split()[1]]
    total = [ln for ln in log.splitlines() if " cells in " in ln]
    if rc != 0 or not total or any(" FAIL " in ln for ln in cells):
        failures.append(f"dry-run CLI: exit {rc}; " + "; ".join(
            ln for ln in cells if " FAIL " in ln)[:2000] + (log[-2000:] if not total else ""))
    dominant = {}
    for ln in cells:
        parts = ln.split()
        dominant[parts[1]] = parts[4] if parts[3] == "ok" else parts[3]
    rc_i, log_i, ising_s = wait_dry_run(dry, "ising", deadline)
    ising = [ln for ln in log_i.splitlines() if ln.startswith("[ising-dryrun]")]
    if rc_i != 0 or len(ising) != 4:
        failures.append(f"dryrun_ising: exit {rc_i}\n{log_i[-2000:]}")
    print(f"phase 29 dry-run CLI (--arch all --shape all --mesh both, {DRY_JOBS} cell "
          f"processes beside phases 1-28): {total[-1][9:] if total else 'no summary'}; "
          f"{cli_s:.1f} s from its start; dominant terms "
          + ", ".join(f"{k} {v}" for k, v in dominant.items()))
    print(f"phase 29 dryrun_ising --mesh both ({ising_s:.1f} s from its start): "
          + " | ".join(ln[len('[ising-dryrun] '):] for ln in ising))
    if failures:
        raise AssertionError("phase 29: " + "; ".join(failures))
    import shutil

    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(dry["work"], ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    print(f"phase 29 done in {seconds:.1f} s")
    return {"seconds": seconds}

def start_dry_runs() -> dict:
    """Phase 29's CPU work, started with the script (it needs no card and
    runs beside the other phases): (b) `dry_counts`, (c) the dry-run CLI
    over every cell and `dryrun_ising`.  Returns name -> (process, log
    path, start time); `stop_dry_runs` ends any still running."""
    (ROOT / "build").mkdir(exist_ok=True)  # a fresh checkout has none before the kernels build
    work = Path(tempfile.mkdtemp(prefix="dry_", dir=ROOT / "build"))
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    cmds = {
        "counts": [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                   "import chip_smoke; chip_smoke.dry_counts(sys.argv[2])", str(ROOT), str(work)],
        "cli": [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "all", "--shape",
                "all", "--mesh", "both", "--out", str(work / "records"), "--jobs",
                str(DRY_JOBS)],
        "ising": [sys.executable, "-m", "repro_torch.launch.dryrun_ising", "--mesh", "both",
                  "--out", str(work / "records")],
    }
    runs = {"work": work}
    for name, cmd in cmds.items():
        log = work / f"{name}.log"
        with open(log, "w") as f:
            runs[name] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=f,
                                           stderr=subprocess.STDOUT), log, time.perf_counter())
    import atexit

    atexit.register(stop_dry_runs, runs)
    return runs


def stop_dry_runs(runs: dict) -> None:
    for name, value in runs.items():
        if name != "work" and value[0].poll() is None:
            value[0].kill()
            value[0].wait()


def wait_dry_run(runs: dict, name: str, deadline: float) -> tuple[int, str, float]:
    """(exit code, log text, seconds from its start to now) of a dry run."""
    proc, log, t0 = runs[name]
    try:
        rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    return rc, log.read_text(), time.perf_counter() - t0

def strict_api(api):
    """``api`` with its `Session` replaced by one whose ``strict_kernels``
    defaults to True (also in `Session.from_checkpoint`): every phase but
    phase 22's injected ``engine.compile`` fault runs strict, so a fused or
    round path that cannot prepare or launch its kernels fails here instead
    of degrading to the per-sweep path."""
    import types

    class Session(api.Session):
        def __init__(self, spec, callbacks=(), device="cuda", strict_kernels=True):
            super().__init__(spec, callbacks=callbacks, device=device,
                             strict_kernels=strict_kernels)

        @classmethod
        def from_checkpoint(cls, directory, callbacks=(), device="cuda", strict_kernels=True):
            return super().from_checkpoint(directory, callbacks=callbacks, device=device,
                                           strict_kernels=strict_kernels)

    ns = types.SimpleNamespace(**{k: getattr(api, k) for k in dir(api) if not k.startswith("__")})
    ns.Session = Session
    return ns


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
        SystemSpec,
    )

    api = strict_api(api)
    Session = api.Session
    # the conformance runs build their own Sessions: a degradation there fails too
    warnings.filterwarnings("error", message="kernel preparation or launch failed")
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
    dry = start_dry_runs()  # phase 29's CPU work (b, c), beside phases 1-28
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
    # one launch a round for both chains (the grid's chain axis), two exchanges
    expect_launches(counts_chains, "two-chain path", ising_packed=n_int_c,
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
          f"{ {k: v for k, v in counts_chains.items() if v} } (one launch a round for both "
          "chains); each "
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
    # one launch of #2p a round for both chains, running each chain's exchange
    conf_rounds = (entry.burn_sweeps + entry.n_batches
                   * entry.sweeps_per_batch) // entry.swap_interval
    expect_launches(counts_conf, "conformance", ising_packed=conf_rounds,
                    exchange=entry.n_chains * conf_rounds)
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

    # -- phase 22: the chain axis of A, #2p and #5, and serving on the card -------
    srv = serve_phases(torch, np, build, keys, isk, pk, api, device, card)
    check_tickets(build, "phase 22")

    # -- phase 23: the mesh over torch.distributed --------------------------------
    mesh = mesh_phases(torch, np, build, keys, prng, device, card)

    # -- phase 24: training on the card -------------------------------------------
    tr = train_phases(torch, np, build, device, card)

    # -- phase 25: PT over LM sequences, and the dense family ---------------------
    lmpt = ptlm_phases(torch, np, build, device, card)

    # -- phase 26: the hybrid and moe families at full width ----------------------
    hm = hybrid_moe_phases(torch, np, build, device, card)

    # -- phase 27: the vlm and encdec families at full width ----------------------
    ve = vlm_encdec_phases(torch, np, build, device, card)

    # -- phase 28: the LM placement layer on two ranks sharing the card -----------
    pl = placement_phases(torch, np, build, device, card)
    check_tickets(build, "phase 28")

    # -- phase 29: the hybrid, vlm and encdec families placed; the dry run -------
    fp = family_phases(torch, np, build, device, card, dry, lmpt, pl)
    check_tickets(build, "phase 29")

    # -- phase 30: kernel summary ---------------------------------------------
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
                                    counts_strategy.items() if "per-sweep" not in what},
         "chain_axis_round_ms": {"C=1": srv["chain_ms"]["ising_fused/C=1"],
                                 "C=8": srv["chain_ms"]["ising_fused/C=8"]},
         "serve_bucket_launches": srv["buckets"]["A"]["launches"],
         "serve_bucket_ms_per_interval": srv["buckets"]["A"]["ms_per_interval"],
         "serve_burst_launches": srv["bursts"]["round"]["launches"]["ising_fused"]},
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
         "resume_launches": resume_packed["counts"]["ising_packed"],
         "chain_axis_round_ms": {"C=1": srv["chain_ms"]["ising_packed/C=1"],
                                 "C=8": srv["chain_ms"]["ising_packed/C=8"]},
         "serve_bucket_launches": srv["buckets"]["#2p"]["launches"],
         "serve_bucket_ms_per_interval": srv["buckets"]["#2p"]["ms_per_interval"]},
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
            also_replaces="src/repro/kernels/potts_sweep.py:372 (with the exchange)",
            chain_axis_round_ms={"C=1": srv["chain_ms"]["potts_fused/C=1"],
                                 "C=8": srv["chain_ms"]["potts_fused/C=8"]},
            serve_bucket_launches=srv["buckets"]["#5"]["launches"],
            serve_bucket_ms_per_interval=srv["buckets"]["#5"]["ms_per_interval"]),
        row("jax_uniform", "jax_uniform.cu",
            "none: XLA's jax.random.uniform (src/repro/core/ising.py:210, "
            "src/repro/core/potts.py:144, src/repro/core/spin_glass.py:109)",
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
            "library_ms": None, "shape": shape, "step_us": zt[name]["step_us"],
            "device_ms": zt[name]["device_ms"],
            "path_ms_per_interval": zoo["paths"][path]["ms"]})
    kernels[-2]["conformance_launches"] = zoo["conformance_launches"]
    mk = mesh["kernels"]["times"]
    kernels.append({
        "name": "exchange_step", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/exchange_step.cu",
        "replaces": "src/repro/kernels/exchange.py:120 (run alone by the sharded round path, "
                    "src/repro/engine/driver.py:479)",
        "launches": mesh["one"]["counts"]["exchange_step"], "max_abs_err": mesh["kernels"]["max_err"],
        "ms": mk["exchange_step"]["ms"], "plain_ms": mk["exchange_step"]["plain_ms"],
        "bound_ms": mk["exchange_step"]["bound"][0], "bound_by": mk["exchange_step"]["bound"][1],
        "library_ms": None, "shape": "C=1 R=1500 gathered rows, rank slice 750",
        "device_ms": mk["exchange_step"]["device_ms"], "rows_ms": mk["exchange_step"]["rows_ms"],
        "c8_ms": mk["exchange_step_c8"]["ms"], "c8_device_ms": mk["exchange_step_c8"]["device_ms"],
        "global_variant_device_ms": mk["exchange_step_global"]["device_ms"],
        "global_variant_shape": f"C=1 R={SHARED_MAX_R + 1}",
        "mesh_ms_per_interval": {"paper (1, 1)": mesh["one"]["ms"],
                                 "L=32 S=1 (1, 1)": mesh["short"]["ms"]},
        "launches_per_rank": {f"{name} {tuple(m)}": mesh["ranks"][0][name]["counts"]["exchange_step"]
                              for name, m in (("paper", (1, 2)), ("paper_chains", (2, 1)),
                                              ("potts_round", (1, 2)))}})
    for k in kernels:
        if k["name"] == "exchange":
            rd, sw = mesh["kernels"]["packed_tail"]
            k["packed_round_launch_ms"] = {"L=32 R=1500 S=1": rd}
            k["packed_tail_ms"] = {"L=32 R=1500 S=1": rd - sw}
        if k["name"] == "jax_uniform":
            k["offset_ms"] = mk["jax_uniform_offset"]["ms"]
            k["offset_plain_ms"] = mk["jax_uniform_offset"]["plain_ms"]
            k["offset_bound_ms"] = mk["jax_uniform_offset"]["bound"][0]
            k["offset_shape"] = "750 replicas at offset 750 x (2,300,300)"
            k["mesh_launches_per_rank"] = mesh["ranks"][0]["per_sweep"]["counts"]["jax_uniform"]
        if k["name"] in ("hp_moves", "single_flip"):
            key = {"hp_moves": "hp", "single_flip": "single_flip"}[k["name"]]
            k["mesh_launches_per_rank"] = mesh["ranks"][0][key]["counts"][k["name"]]
            off = mk[k["name"] + "_offset"]
            k["offset_ms"], k["offset_plain_ms"] = off["ms"], off["plain_ms"]
            k["offset_bound_ms"], k["offset_bound_by"] = off["bound"][:2]
            k["offset_shape"] = ("750 replicas at offset 750, N=20, 20 moves"
                                 if k["name"] == "hp_moves"
                                 else "750 replicas at offset 750, L=300, 30 flips")
    tt = tr["times"]
    for k in kernels:
        if k["name"] == "wkv6":
            k["train_ms"], k["train_plain_ms"] = tt["wkv6"]["ms"], tt["wkv6"]["plain_ms"]
            k["train_device_ms"] = tt["wkv6"]["device"][0]
            k["train_bound_ms"], k["train_bound_by"] = tt["wkv6"]["bound"][:2]
            k["train_shape"] = "BH=512 T=512 dk=dv=64"
            k["train_launches"] = tr["launches"]["wkv6"]
            k["ptlm_launches"] = lmpt["rwkv"]["counts"]["wkv6"]
            k["ptlm_shape"] = (f"rwkv6-7b, R={PTLM_R} x {PTLM_SEQ} tokens, {PTLM_STEPS} MH "
                               "steps: BH=512 T=64 a forward")
            k["ptlm_ms_per_step"] = lmpt["rwkv"]["ms_step"]
            rr = pl["ranks"][0]["rwkv"]
            k["placed_launches_per_rank"] = {"prefill": rr["prefill_launches"]["wkv6"],
                                             "decode": rr["decode_launches"]["wkv6"]}
            k["placed_shape"] = (f"rwkv6-7b f32 on a (1, 2) mesh, a rank's 32 of 64 heads: "
                                 f"prefill (4, {PLACE_RWKV_S}), {PLACE_RWKV_DECODE} decode steps")
    kernels.append({
        "name": "wkv6_bwd", "route": "cuda", "source": "src/repro_torch/kernels/csrc/wkv6_bwd.cu",
        "replaces": "none: XLA's autodiff of src/repro/kernels/ref.py:133 (wkv6's lax.scan), "
                    "the gradient of src/repro/kernels/wkv6.py:54's recurrence",
        "launches": tr["launches"]["wkv6_bwd"], "max_abs_err": tr["err"],
        "ms": tt["wkv6_bwd"]["ms"], "plain_ms": tt["wkv6_bwd"]["plain_ms"],
        "bound_ms": tt["wkv6_bwd"]["bound"][0], "bound_by": tt["wkv6_bwd"]["bound"][1],
        "library_ms": None, "shape": "BH=512 T=512 dk=dv=64 (rwkv6-7b training, B=8)",
        "device_ms": tt["wkv6_bwd"]["device"][0],
        "launches_per_step": {f"remat={r}": c for r, c in tr["per_step"].items()},
        "train_step_ms": tr["warm_ms"], "train_tokens_s": tr["tokens_s"],
        "train_peak_gb": tr["peak_gb"]})
    print(f"phase 30 done in {time.perf_counter() - t_start:.1f} s (phase 26: "
          f"{hm['seconds']:.1f} s, phase 27: {ve['seconds']:.1f} s, phase 28: "
          f"{pl['seconds']:.1f} s, phase 29: {fp['seconds']:.1f} s)")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
