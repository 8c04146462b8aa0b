"""SASS instruction counts and a block-width sweep of the fused sweep kernels
A (``csrc/ising_fused.cu``), #5 (``csrc/potts_fused.cu``) and #2p
(``csrc/ising_packed.cu``), and their round exchange against an earlier
``csrc`` whose rounds were two launches, on the card.

For each variant — the package's ``csrc`` as it is, each ``--baseline``
directory as it is (e.g. an earlier commit's ``csrc``), and the package's
``csrc`` with each ``--grid`` entry ``TxS`` substituted for its ``kThreads``
/ ``kSites`` constants — it prints

* ``nvcc -Xptxas -v``: registers, spills and shared memory of each kernel;
* ``cuobjdump -sass``: the instructions of each innermost loop that hashes
  (a backward branch whose body holds Threefry rotates and no such inner
  loop), per site update, by class — integer ALU (SHF, LOP3, IADD3, ISETP,
  SEL, LEA, IMNMX, PRMT, ...), FMA pipe (IMAD*, FMUL, FADD, FFMA),
  conversion (I2F, I2FP, F2I, FRND), shared memory (LDS, STS), branch and
  other (moves, uniform-datapath ops and Hopper's VIADD / VIADDMNMX, whose
  pipe is not documented);
  a Threefry block has 20 rotates, 19 when its second word is dead, so a
  loop's hashes are its rotates / 19 rounded, its site updates the hashes
  over the planes each update draws (1 Ising, 2 Potts); #2p's innermost
  hashing loop is one replica's pass over a run, so the probe also prints
  the instructions of the enclosing run loop outside it (the loads, the
  adder and the store a site shares among its group's replicas);
* times (CUDA events) at the main paths' shapes — kernel A at L=300 R=1500,
  #5 at 300x300 q=3 R=1500, glauber, S=2 and S=100 — in turns (each
  variant, then again in reverse order), beside the bound (72 32-bit
  instructions per Threefry block at 33.5e12/s), after checking that each
  variant's spins/colours and counts at S=2 equal the plain version's;
  and the SM clock and power draw (``nvidia-smi``) while the package's
  kernel runs at S=100;
* #2p beside kernel A, in turns at S=100 with L=300, at R=1500 and R=2112,
  at the card's default group width and at 8 a block, after checking each
  variant's #2p at S=2 against the plain version (spins, counts) and
  against the package's kernel A (ΔE too, bit for bit);
* for each ``--baseline`` whose rounds are two launches (its ``csrc`` has
  ``exchange.cu``, kernel B): B's rows against the package's round exchange
  on `exchange_cases` (prob, accept, attempt, rung and energy, bit for
  bit).  Whole rounds of the two designs are timed tree against tree, each
  through its own package, by ``round_timing.py``;
* for the package and each variant whose rounds are one launch, the
  exchange tail of A, #2p and #5 at L=32 R=1500 S=1 (the shortest rounds,
  where it shows most), L=300 R=1500 S=2 and S=100: the round launch less
  the same launch without the exchange, by the profiler's device time, in
  turns.

The kernels' C interfaces are the wrappers', so every variant runs on the
wrappers' own tables.  Needs one card and the CUDA toolkit:

    PYTHONPATH=src python -m repro_torch.launch.fused_probe --grid 256x2 1024x2 512x4
    PYTHONPATH=src python -m repro_torch.launch.fused_probe --baseline build/base_csrc
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import keys
from repro_torch.kernels import build, prng
from repro_torch.kernels import ising_sweep as isk
from repro_torch.kernels import potts_sweep as pk

__all__ = ["build_variant", "ptxas_report", "sass_loops", "exchange_cases", "main"]

# Threefry planes per site update
KERNELS = {"ising_fused": 1, "potts_fused": 2, "ising_packed": 1}
N_INT_ARGS = {"ising_fused": 3, "potts_fused": 5, "ising_packed": 4}
THREEFRY_OPS = 72
INT32_OPS_PER_S = 132 * 128 * 1.98e9
CLASSES = {
    "alu": ("SHF", "LOP3", "IADD3", "ISETP", "SEL", "LEA", "IMNMX", "PRMT", "IABS",
            "FLO", "POPC", "BMSK", "SGXT", "FSEL", "FSETP", "LOP", "IADD", "SHL", "SHR"),
    "fma": ("IMAD", "FMUL", "FADD", "FFMA", "IMUL"),
    "conversion": ("I2F", "I2FP", "F2I", "F2IP", "FRND", "F2F", "I2I"),
    "shared": ("LDS", "STS"),
    "branch": ("BRA", "BSSY", "BSYNC", "EXIT", "BAR", "WARPSYNC", "CALL", "RET", "JMP"),
}
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")


def _class(op: str) -> str:
    base = op.split(".")[0]
    for name, ops in CLASSES.items():
        if base in ops:
            return name
    return "other"


def build_variant(csrc: Path, name: str, out: Path, threads: int | None = None,
                  sites: int | None = None) -> tuple[Path, subprocess.Popen]:
    """Start compiling ``name``.cu from ``csrc`` (constants substituted) with
    the package's flags and ``-Xptxas -v``; returns the library's path and
    the running ``nvcc``, whose output holds ptxas's report."""
    src = out / "src"
    shutil.copytree(csrc, src, dirs_exist_ok=True)
    text = (src / f"{name}.cu").read_text()
    for const, value in (("kThreads", threads), ("kSites", sites)):
        if value is not None:
            text, n = re.subn(rf"constexpr int {const} = \d+;",
                              f"constexpr int {const} = {value};", text)
            if n != 1:
                raise ValueError(f"{csrc / name}.cu has no single {const} constant")
    (src / f"{name}.cu").write_text(text)
    lib = out / f"lib{name}.so"
    # an earlier csrc's exchange.cu (kernel B) was built with nvcc's defaults
    cmd = [build.nvcc_path(), *build._COMMON, *build.SOURCES.get(name, []), "-Xptxas", "-v",
           "-I", str(src), "-o", str(lib), str(src / f"{name}.cu")]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)


def ptxas_report(proc: subprocess.Popen, what: str) -> str:
    """Wait for a `build_variant` compile; its registers, spills and entries."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {what}:\n{log}")
    return "\n    ".join(ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "spill" in ln or "Compiling entry" in ln)


def sass_loops(text: str, symbol: str) -> list[dict]:
    """Innermost hashing loops of the kernel whose name holds ``symbol`` in
    ``cuobjdump -sass`` output ``text``."""
    body, inside = [], False
    for line in text.splitlines():
        if "Function :" in line:
            inside = symbol in line
            continue
        m = _INSN.search(line) if inside else None
        if m:
            body.append((int(m.group(1), 16), m.group(2), m.group(3)))
    loops = []
    for addr, op, args in body:
        target = re.search(r"0x([0-9a-f]+)", args)
        if op.startswith("BRA") and target and int(target.group(1), 16) <= addr:
            lo = int(target.group(1), 16)
            ops = [o for a, o, _ in body if lo <= a <= addr]
            rot = sum(o.startswith(("SHF.L.W", "SHF.R.W")) for o in ops)
            if rot >= 19:
                loops.append({"start": lo, "end": addr, "ops": ops, "rotates": rot})
    def inside(a, b):
        return a is not b and b["start"] <= a["start"] and a["end"] <= b["end"]

    inner = [lp for lp in loops if not any(inside(o, lp) for o in loops)]
    for lp in inner:
        lp["hashes"] = round(lp["rotates"] / 19)
        lp["classes"] = Counter(_class(o) for o in lp["ops"])
        lp["opcodes"] = Counter(o.split(".")[0] for o in lp["ops"])
        outer = [o for o in loops if inside(lp, o)]
        if outer:  # the smallest enclosing hashing loop's instructions outside this one
            enclosing = min(outer, key=lambda o: o["end"] - o["start"])
            lp["outside"] = len(enclosing["ops"]) - len(lp["ops"])
    return inner


def _report_sass(lib: Path, name: str) -> str:
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out = []
    for lp in sass_loops(text, name):
        sites = lp["hashes"] / KERNELS[name]
        per = {k: v / sites for k, v in sorted(lp["classes"].items())}
        top = ", ".join(f"{o} {v / sites:.2f}" for o, v in lp["opcodes"].most_common(14))
        shared = (f"; enclosing loop: {lp['outside']} more ({lp['outside'] / sites:.2f} a site)"
                  if name == "ising_packed" and "outside" in lp else "")
        out.append(f"loop 0x{lp['start']:x}-0x{lp['end']:x}: {len(lp['ops'])} instructions, "
                   f"{lp['rotates']} rotates = {lp['hashes']} hashes = {sites:g} site updates; "
                   f"per update {len(lp['ops']) / sites:.2f}: "
                   + ", ".join(f"{k} {v:.2f}" for k, v in per.items()) + f"; opcodes: {top}"
                   + shared)
    return "\n    ".join(out) or "no hashing loop found"


def _split(csrc: Path) -> bool:
    """Whether ``csrc`` runs a round as two launches: its sweep kernels take
    no exchange arguments and kernel B (``exchange.cu``) follows them."""
    return (csrc / "exchange.cu").is_file()


def _load(lib_path: Path, name: str, split: bool = False) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(lib_path))
    p = ctypes.c_void_p
    fn = getattr(lib, f"{name}_launch")
    fn.restype = ctypes.c_int
    if name == "exchange":
        fn.argtypes = [p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [p] * 4
        return lib
    # a csrc whose launches take a chain count after the replica count
    lib.chained = hasattr(lib, "chain_axis")
    fn.argtypes = ([p] * 9 + [ctypes.c_longlong, ctypes.c_uint]
                   + [ctypes.c_int] * (N_INT_ARGS[name] + lib.chained)
                   + ([] if split else build.ROUND_ARGTYPES) + [p])
    lib.split = split
    return lib


def _launcher(lib: ctypes.CDLL, name: str, inputs: dict, n_sweeps: int, group: int = 0,
              xchg=None):
    """A closure that launches ``lib``'s kernel on ``inputs`` as the wrapper
    does (#2p at ``group`` replicas a block); with ``xchg`` (as
    `build.round_args` takes it) a round launch, else the sweeps alone."""
    st, words, t0, rung, p_tab, de_tab = (inputs[k] for k in (
        "states", "words", "t0", "rung", "p_tab", "de_tab"))
    r, h, w = st.shape
    out = torch.empty_like(st)
    de = torch.empty(r, dtype=torch.float32, device=st.device)
    nacc = torch.empty(r, dtype=torch.int32, device=st.device)
    dims = {"ising_fused": (h, n_sweeps), "potts_fused": (h, w, 3, n_sweeps),
            "ising_packed": (h, n_sweeps, group)}[name]
    dims = (r, 1, *dims) if lib.chained else (r, *dims)  # one chain
    round_args = () if lib.split else build.round_args(lib, inputs["betas"], xchg)

    def launch():
        err = getattr(lib, f"{name}_launch")(
            st.data_ptr(), out.data_ptr(), de.data_ptr(), nacc.data_ptr(), rung.data_ptr(),
            p_tab.data_ptr(), de_tab.data_ptr(), words.data_ptr(), t0.data_ptr(), 0, 0,
            *dims, *round_args, build.stream_of(st.device))
        build.raise_if(err, name)
        return out, de, nacc
    return launch


def _inputs(name: str, device, r: int = 1500, length: int = 300) -> dict:
    rng = np.random.default_rng(61)
    if name != "potts_fused":
        st = rng.choice(np.array([-1, 1], np.int8), size=(r, length, length))
        betas = (1.0 / (1.0 + np.arange(r) * 3.0 / r)).astype(np.float32)
    else:
        st = rng.integers(0, 3, (r, length, length)).astype(np.int8)
        betas = (1.0 / np.geomspace(0.7, 2.9, r)).astype(np.float32)
    betas = torch.from_numpy(betas).to(device)
    if name != "potts_fused":
        p_tab, de_tab = isk.accept_tables(betas, j=1.0, b=0.0, rule="glauber")
    else:
        p_tab, de_tab = pk.potts_tables(betas, j=1.0, rule="glauber")
    return {"states": torch.from_numpy(st).to(device), "betas": betas,
            "words": prng.key_words(keys.key(3, device=device)),
            "t0": torch.zeros((), dtype=torch.int64, device=device),
            "rung": torch.arange(r, dtype=torch.int32, device=device),
            "p_tab": p_tab, "de_tab": de_tab}


def _plain(name: str, inp: dict, n_sweeps: int):
    args = (inp["states"], inp["words"], inp["t0"], inp["betas"], inp["rung"])
    if name != "potts_fused":
        return isk.ising_sweep_fused_plain(*args, n_sweeps=n_sweeps, rule="glauber")
    return pk.potts_sweep_fused_plain(*args, n_sweeps=n_sweeps, q=3, rule="glauber")


def _under_load(fn, reps: int) -> str:
    """The card's SM clock and power draw while ``reps`` launches of ``fn`` run."""
    for _ in range(reps):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    torch.cuda.synchronize()
    return out.strip()


def _ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, nargs="*", default=[],
                    help="other csrc directories to build as they are")
    ap.add_argument("--grid", nargs="*", default=[],
                    help="THREADSxSITES: block width and sites per thread to substitute "
                         "for kThreads and kSites in the package's csrc")
    ap.add_argument("--out", type=Path, default=build.build_root() / "probe")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fused_probe needs a CUDA card")
    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    variants = [(d.name, d, None, None) for d in args.baseline]
    variants.append(("package", build.CSRC, None, None))
    for entry in args.grid:
        threads, sites = (int(v) for v in entry.split("x"))
        variants.append((entry, build.CSRC, threads, sites))
    builds = {}
    split = {label: _split(csrc) for label, csrc, *_ in variants}
    for label, csrc, threads, sites in variants:  # every nvcc at once
        for name in [*KERNELS, *(["exchange"] if split[label] else [])]:
            out = args.out / label / name
            if out.exists():
                shutil.rmtree(out)
            builds[label, name] = build_variant(csrc, name, out, threads, sites)
    libs = {}
    for (label, name), (lib_path, proc) in builds.items():
        print(f"[{label}] {name} ptxas:\n    {ptxas_report(proc, f'{label} {name}')}")
        if name != "exchange":
            print(f"[{label}] {name} SASS:\n    {_report_sass(lib_path, name)}")
        libs[label, name] = _load(lib_path, name, split[label])
    for name in ("ising_fused", "potts_fused"):
        inp = _inputs(name, device)
        sites = inp["states"].numel()
        want = _plain(name, inp, 2)
        for label, *_ in variants:
            got = _launcher(libs[label, name], name, inp, 2)()
            torch.cuda.synchronize()
            if not torch.equal(got[0], want[0]) or not torch.equal(got[2], want[2]):
                raise AssertionError(f"[{label}] {name} differs from the plain version at S=2")
        del want
        print(f"{name}: every variant equals the plain version at S=2 (states, nacc)")
        times = {label: {2: [], 100: []} for label, *_ in variants}
        order = [label for label, *_ in variants]
        for label in order + order[::-1]:
            for s, reps in ((2, 10), (100, 2)):
                times[label][s].append(_ms(_launcher(libs[label, name], name, inp, s), reps))
        load = _under_load(_launcher(libs["package", name], name, inp, 100), 6)
        print(f"[package] {name}: SM clock, power draw during S=100 launches: {load}")
        for label in order:
            bounds = {s: 1e3 * KERNELS[name] * s * sites * THREEFRY_OPS / INT32_OPS_PER_S
                      for s in (2, 100)}
            print(f"[{label}] {name} [{card}]: " + "; ".join(
                f"S={s} {' / '.join(f'{t:.4f}' for t in times[label][s])} ms "
                f"(bound {bounds[s]:.4f} ms, bound/time {bounds[s] / min(times[label][s]):.3f})"
                for s in (2, 100)))
        del inp
        torch.cuda.empty_cache()
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    for r in (1500, 2 * n_sms * 8):
        _packed_beside_a(libs, [label for label, *_ in variants], r, card, device)
    _tails(libs, [label for label, *_ in variants if not split[label]], card, device)
    for label in (label for label, *_ in variants if split[label]):
        _exchange_bits(libs[label, "exchange"], label, device)
    return 0


def _packed_beside_a(libs: dict, labels: list, r: int, card: str, device) -> None:
    """#2p at the default width and at 8 a block, in turns with kernel A, at
    L=300 R=``r`` S=100, every variant of both."""
    inp = _inputs("ising_packed", device, r)
    group = isk.packed_launch_shape(r, 300, device)[2]
    want = _plain("ising_packed", inp, 2)
    kernel_a = _launcher(libs["package", "ising_fused"], "ising_fused", inp, 2)()
    runs = []
    for label in labels:
        runs.append((label, "ising_fused", 0))
        for g in sorted({group, 8}):
            got = _launcher(libs[label, "ising_packed"], "ising_packed", inp, 2, g)()
            torch.cuda.synchronize()
            if not torch.equal(got[0], want[0]) or not torch.equal(got[2], want[2]):
                raise AssertionError(f"[{label}] #2p group {g} differs from the plain version")
            same_de = torch.equal(got[1], kernel_a[1])
            print(f"[{label}] ising_packed R={r} group {g}: equal to plain at S=2 (spins, "
                  f"nacc); ΔE {'equal to' if same_de else 'differs from'} kernel A's")
            runs.append((label, "ising_packed", g))
    del want, kernel_a
    times = {run: [] for run in runs}
    for run in runs + runs[::-1]:
        label, name, g = run
        times[run].append(_ms(_launcher(libs[label, name], name, inp, 100, g), 2))
    bound = 1e3 * 100 * inp["states"].numel() * THREEFRY_OPS / INT32_OPS_PER_S
    for (label, name, g), ts in times.items():
        what = "kernel A" if name == "ising_fused" else f"#2p at {g} a block"
        print(f"[{label}] {what} [{card}]: L=300 R={r} S=100 "
              f"{' / '.join(f'{x:.4f}' for x in ts)} ms (bound {bound:.4f} ms, "
              f"bound/time {bound / min(ts):.3f})")
    del inp
    torch.cuda.empty_cache()


def exchange_cases(device, r: int = 1500):
    """32 exchange cases at R replicas: DEO/SEO x logistic/metropolis x 8
    phases, each with a fresh rung map, per-slot energies whose rung order is
    near an equilibrated ladder (Δβ·ΔE of order 1 between neighbours, so the
    probabilities are not all saturated) and a ΔE row of multiples of 4.
    Yields dicts of rung, energy, de, betas (rung order), words, ph0 (a
    device counter) and the pairing, criterion and phase (added to ph0)."""
    rng = np.random.default_rng(7)
    temps = 1.0 + np.arange(r) * 3.0 / r
    betas = torch.from_numpy((1.0 / temps).astype(np.float32)).to(device)
    words = keys.key(11, device=device)
    for pairing in ("deo", "seo"):
        for criterion in ("logistic", "metropolis"):
            for phase in range(8):
                rung = rng.permutation(r).astype(np.int32)
                by_rung = -180000 + 100 * np.arange(r) + rng.integers(-400, 400, r)
                yield {"pairing": pairing, "criterion": criterion, "phase": phase,
                       "rung": torch.from_numpy(rung).to(device),
                       "energy": torch.from_numpy(by_rung[rung].astype(np.float32)).to(device),
                       "de": torch.from_numpy(
                           (4 * rng.integers(-50, 50, r)).astype(np.float32)).to(device),
                       "betas": betas, "words": words,
                       "ph0": torch.tensor(1000 + phase, dtype=torch.int64, device=device)}


def _exchange_launch(lib_b, rung, energy, de, betas, words, ph0, phase_add, pairing,
                     criterion, out):
    """An earlier csrc's kernel B on the rows, into ``out`` = (rung', energy',
    accept, prob, attempt), as its wrapper launched it."""
    err = lib_b.exchange_launch(
        rung.data_ptr(), out[0].data_ptr(), energy.data_ptr(), out[1].data_ptr(),
        de.data_ptr(), betas.data_ptr(), words.data_ptr(), ph0.data_ptr(), int(phase_add),
        rung.shape[0], int(pairing == "seo"), int(criterion == "metropolis"),
        out[2].data_ptr(), out[3].data_ptr(), out[4].data_ptr(), build.stream_of(rung.device))
    build.raise_if(err, "exchange")


def _exchange_bits(lib_b, label: str, device) -> None:
    """The baseline's kernel B against the package's round exchange (a round
    launch of kernel A with no sweep, on energy + ΔE) on `exchange_cases`:
    counts the cases whose rows are equal bit for bit."""
    same, diffs = 0, []
    for c in exchange_cases(device):
        r = c["rung"].shape[0]
        out = (torch.empty_like(c["rung"]), torch.empty_like(c["energy"]),
               torch.empty(r, dtype=torch.bool, device=device),
               torch.empty(r, dtype=torch.float32, device=device),
               torch.empty(r, dtype=torch.bool, device=device))
        _exchange_launch(lib_b, c["rung"], c["energy"], c["de"], c["betas"], c["words"],
                         c["ph0"], c["phase"], c["pairing"], c["criterion"], out)
        got = isk.ising_round_kernel(
            torch.ones((r, 2, 2), dtype=torch.int8, device=device), c["words"],
            torch.zeros((), dtype=torch.int64, device=device), c["ph0"], c["betas"], c["rung"],
            c["energy"] + c["de"], n_sweeps=0, pairing=c["pairing"], criterion=c["criterion"],
            phase_add=c["phase"])
        torch.cuda.synchronize()
        rows = (got[1], got[2], got[4], got[5], got[6])
        if all(torch.equal(x, y) for x, y in zip(out, rows)):
            same += 1
        else:
            diffs.append(f"{c['pairing']}/{c['criterion']} phase {c['phase']}: prob differs at "
                         f"{int((out[3] != got[5]).sum())} rungs, max "
                         f"{(out[3] - got[5]).abs().max().item():.3e}")
    print(f"[{label}] kernel B vs the package's round exchange: {same} of 32 cases equal bit "
          f"for bit (rung, energy, accept, prob, attempt)"
          + "".join(f"\n    {d}" for d in diffs))


def _tails(libs: dict, labels: list, card: str, device) -> None:
    """The exchange tail of kernels A, #2p (default group) and #5 in each
    one-launch variant: a round launch (DEO, logistic) less the same launch
    without the exchange, profiler device time, each variant in turns and
    back, at L=32 R=1500 S=1 (the shortest rounds, where it shows most),
    L=300 R=1500 S=2 and S=100 (#5 on LxL colours, q=3)."""
    r = 1500
    for length, n_sweeps, reps in ((32, 1, 300), (300, 2, 20), (300, 100, 3)):
        for name in KERNELS:
            inp = _inputs(name, device, r, length)
            rng = np.random.default_rng(63)
            inp["rung"] = torch.from_numpy(rng.permutation(r).astype(np.int32)).to(device)
            energy = torch.zeros(r, device=device)
            ph0 = torch.zeros((), dtype=torch.int64, device=device)
            rows = build.check_round(r, energy.device, inp["rung"], energy, ph0, None,
                                     pairing="deo", criterion="logistic")
            xchg = (energy, ph0, rows, dict(phase_add=0, pairing="deo", criterion="logistic"))
            group = isk.packed_launch_shape(r, length, device)[2] if name == "ising_packed" else 0
            times = {(label, w): [] for label in labels for w in (False, True)}
            order = list(times)
            for key in order + order[::-1]:
                label, with_round = key
                fn = _launcher(libs[label, name], name, inp, n_sweeps, group,
                               xchg if with_round else None)
                times[key].append(_device_ms(fn, reps, f"{name}_kernel")[1])
            if build.dirty_tickets():
                raise AssertionError(f"round tickets left set: {build.dirty_tickets()}")
            for label in labels:
                alone, rnd = times[label, False], times[label, True]
                print(f"[{label}] {name} exchange tail [{card}]: L={length} R={r} "
                      f"S={n_sweeps}: round launch " + " / ".join(f"{1e3 * x:.2f}" for x in rnd)
                      + " us, sweeps alone " + " / ".join(f"{1e3 * x:.2f}" for x in alone)
                      + f" us, tail {1e3 * (min(rnd) - min(alone)):.2f} us (lower readings)")
            del inp
            torch.cuda.empty_cache()


def _device_ms(fn, reps: int, symbol: str, others: tuple = ()) -> tuple[float, float]:
    """(all device time, device time of the kernels whose names hold
    ``symbol`` or one of ``others``) per call of ``fn`` over ``reps`` calls,
    by the profiler; NaN where the profiler saw another count of ``symbol``
    launches than ``reps`` (one a call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)  # the tracer runs before fn starts
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if sum(e.count for e in rows if symbol in e.key) != reps:
        return float("nan"), float("nan")
    total = sum(float(e.self_device_time_total) for e in rows)
    named = sum(float(e.self_device_time_total) for e in rows
                if any(sym in e.key for sym in (symbol, *others)))
    return total / reps / 1e3, named / reps / 1e3


if __name__ == "__main__":
    raise SystemExit(main())
