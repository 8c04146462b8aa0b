"""Where the serial-chain kernels' time goes (``csrc/serial_chain.cu``) on the card.

For the package's source, and for a ``--baseline`` tree's
``serial_chain.cu`` where one is given (e.g. ``git archive <commit>
src/repro_torch/kernels/csrc`` unpacked under ``build/``; the card's copy
of the repository has no ``.git``), it prints

* ``nvcc -Xptxas -v``: registers and spills of both kernels;
* the baseline against the package in turns (baseline, package, package,
  baseline): their outputs equal, and the profiler's device time a launch
  of ``hp_moves`` (N=20, R=1500, 20 moves, folded chains) and
  ``single_flip`` (L=300, R=1500, 300 flips), and of each at R=1 and 3000
  steps (one chain's critical path: ms / 3000);
* ``single_flip`` variants with a part of the work taken out (`VARIANTS`;
  the outputs of all but "no links", which reads the lattice in the serial
  pass, are wrong on purpose), device time in turns at both shapes;
* the pipeline's stages: a copy of the source (`STAGE_CLOCKS`) that records
  ``clock64()`` (SM cycles since the block began) where each warp's work of
  a stage ends and at each stage's barrier, for three blocks.

Needs one card and the CUDA toolkit:

    PYTHONPATH=src python -m repro_torch.launch.serial_probe \\
        --baseline build/base/src/repro_torch/kernels/csrc
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import keys
from repro_torch.kernels import build
from repro_torch.kernels import serial_chain as sc

__all__ = ["VARIANTS", "STAGE_CLOCKS", "substitute", "main"]

# single_flip_kernel without a part of its work: (old, new) source edits
VARIANTS = {
    "copy only": [("const int tiles = (flips + kFlipTile - 1) / kFlipTile;",
                   "const int tiles = 0;")],
    "no apply": [("if (warp == 1 && stage >= 1)", "if (false)")],
    # exact: the serial pass reads each flip's five spins from the lattice
    "no links": [
        ("    insert_site(sm, row * length + col, j);\n", ""),
        ("  for (int j = tid; j < count; j += kDrawThreads) {\n    unsigned link[kSites];",
         "  for (int j = tid; j < 0; j += kDrawThreads) {\n    unsigned link[kSites];"),
        ("  clear_sites(sm, tid, kDrawThreads);\n", ""),
        ("for (int f0 = lane; f0 < kFlipTile; f0 += 64) {", "for (int f0 = lane; f0 < 0; f0 += 64) {"),
        ("    unsigned nb = b.x, sw = b.y;\n    if ((l.x & l.y) != 0xffffffffu) {",
         "    unsigned nb = 0u, sw = static_cast<uint8_t>(s[d.x]);\n"
         "    for (int q = 0; q < 4; ++q)\n"
         "      nb |= static_cast<unsigned>(static_cast<uint8_t>(\n"
         "                s[flip_site(static_cast<int>(d.x), d.y, q, length)])) << (8 * q);\n"
         "    if (false) {"),
    ],
}
_SLOTS = 64  # a block's clock slots: 4 roles x 12 stages, 12 barriers, 3 copy ends
STAGE_CLOCKS = [
    ("struct FlipSmem {", "__device__ long long g_clock[1600 * 64];\n\nstruct FlipSmem {"),
    ("__shared__ FlipSmem sm;",
     "__shared__ FlipSmem sm;\n  const long long t_begin = clock64();\n"
     "  long long* tt = g_clock + blockIdx.x * 64;"),
    ("      if (lane == 0 && stage + 1 < tiles) walk_tile(sm, key, stage + 1, flips);\n",
     "      if (lane == 0 && stage + 1 < tiles) walk_tile(sm, key, stage + 1, flips);\n"
     "      if (lane == 0 && stage < 12) tt[stage * 4] = clock64() - t_begin;\n"),
    ("      draw_tile(sm, stage, flips, length, threadIdx.x - 64);\n",
     "      draw_tile(sm, stage, flips, length, threadIdx.x - 64);\n"
     "      if (threadIdx.x == 64 && stage < 12) tt[stage * 4 + 2] = clock64() - t_begin;\n"),
    ("    if (stage == 0) copy_chunks(spins_in + r * cells, s, cells, &sm.copy_next, lane);\n",
     "    if (stage == 0) copy_chunks(spins_in + r * cells, s, cells, &sm.copy_next, lane);\n"
     "    if (stage == 0 && lane == 0) tt[60 + warp] = clock64() - t_begin;\n"),
    ("apply_tile(sm, stage - 1, flips, length, lane, s, de_acc, nacc);\n",
     "apply_tile(sm, stage - 1, flips, length, lane, s, de_acc, nacc);\n"
     "    if (threadIdx.x == 32 && stage >= 1 && stage < 12) "
     "tt[stage * 4 + 3] = clock64() - t_begin;\n"),
    ("    __syncthreads();\n  }\n  if (threadIdx.x == 32) {",
     "    __syncthreads();\n    if (threadIdx.x == 0 && stage < 12) "
     "tt[48 + stage] = clock64() - t_begin;\n  }\n  if (threadIdx.x == 32) {"),
]
_READ_CLOCKS = """
extern "C" int serial_probe_clocks(void* dst, size_t bytes) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_clock, bytes));
}
"""


def substitute(text: str, edits) -> str:
    """``text`` with each (old, new) of ``edits`` applied; each old must
    occur exactly once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"serial_chain.cu has not exactly one {old!r}")
        text = text.replace(old, new)
    return text


def _build(text: str, out: Path) -> ctypes.CDLL:
    out.mkdir(parents=True, exist_ok=True)
    (out / "serial_chain.cu").write_text(text)
    so = out / "libserial_chain.so"
    res = subprocess.run([build.nvcc_path(), *build._COMMON, *build.SOURCES["serial_chain"],
                          "-Xptxas", "-v", "-I", str(build.CSRC), "-o", str(so),
                          str(out / "serial_chain.cu")], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {out}:\n{res.stdout}{res.stderr}")
    lines = (res.stdout + res.stderr).splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln:
            name = "hp_moves" if "hp_moves" in ln else "single_flip"
            print(f"  {out.name} {name}: " + "; ".join(x.split(":", 1)[-1].strip()
                                                       for x in lines[i + 2:i + 4]))
    lib = ctypes.CDLL(str(so))
    lib.hp_moves_launch.restype = ctypes.c_int
    lib.hp_moves_launch.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [
        ctypes.c_uint, ctypes.c_void_p]
    lib.single_flip_launch.restype = ctypes.c_int
    lib.single_flip_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
        ctypes.c_uint, ctypes.c_void_p]
    return lib


def _device_ms(fn, name: str, reps: int) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)  # the tracer runs before the first launch
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and name in e.key]
    return sum(float(e.self_device_time_total) for e in rows) / sum(e.count for e in rows) / 1e3


def _cases(dev):
    """The timed calls: (what, fn, kernel name, reps, steps)."""
    from repro_torch.core.hp import HPChain

    r, seq = 1500, "HPHPPHHPHHPHPHHPPHPH"
    betas = torch.linspace(1 / 0.6, 1 / 3.4, r, device=dev)
    key, t = keys.key(3, device=dev), torch.tensor(5, device=dev)
    hmask = torch.tensor([c == "H" for c in seq], device=dev)
    pos = HPChain(seq).init_state_batched(keys.split(keys.key(7, device=dev), r))
    for _ in range(20):  # fold the rods first
        pos = sc.hp_moves_kernel(pos, key, t, betas, hmask=hmask, eps=1.0, n_moves=20)[0]
        t = t + 1
    spins = torch.from_numpy(np.random.default_rng(9).choice(
        np.array([-1, 1], np.int8), size=(r, 300, 300))).to(dev)
    kw = dict(j=1.0, b=0.0, rule="glauber")
    return [
        ("hp_moves N=20 R=1500 20 moves", lambda: sc.hp_moves_kernel(
            pos, key, t, betas, hmask=hmask, eps=1.0, n_moves=20), "hp_moves", 20, 20),
        ("single_flip L=300 R=1500 300 flips", lambda: sc.single_flip_kernel(
            spins, key, t, betas, flips=300, **kw), "single_flip", 10, 300),
        ("hp_moves N=20 R=1 3000 moves", lambda: sc.hp_moves_kernel(
            pos[:1].contiguous(), key, t, betas[:1], hmask=hmask, eps=1.0, n_moves=3000),
         "hp_moves", 3, 3000),
        ("single_flip L=300 R=1 3000 flips", lambda: sc.single_flip_kernel(
            spins[:1].contiguous(), key, t, betas[:1], flips=3000, **kw), "single_flip", 3,
         3000),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, help="a csrc directory to hold the package against")
    ap.add_argument("--out", type=Path, default=build.build_root() / "serial_probe")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serial_probe needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip() or "unknown card"
    print(f"serial_probe [{card}]; ptxas (registers; spills):")
    text = (build.CSRC / "serial_chain.cu").read_text()
    libs = {"package": _build(text, args.out / "package")}
    if args.baseline:
        libs["baseline"] = _build((args.baseline / "serial_chain.cu").read_text(),
                                  args.out / "baseline")
    for name, edits in VARIANTS.items():
        libs[name] = _build(substitute(text, edits), args.out / name.replace(" ", "_"))
    clocks = _build(substitute(text, STAGE_CLOCKS) + _READ_CLOCKS, args.out / "clocks")
    clocks.serial_probe_clocks.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    build.build_all()
    original = sc._lib

    def use(lib):
        sc._lib = lambda: lib

    try:
        for what, fn, name, reps, steps in _cases(dev):
            tags = [t for t in libs if t in ("package", "baseline") or name == "single_flip"]
            outs = {}
            for tag in ("package", "baseline") if "baseline" in libs else ("package",):
                use(libs[tag])
                outs[tag] = fn()
            equal = len(outs) == 1 or all(
                torch.equal(a, b) for a, b in zip(outs["package"], outs["baseline"]))
            reads = {t: [] for t in tags}
            for t in tags + tags[::-1]:
                use(libs[t])
                reads[t].append(_device_ms(fn, f"{name}_kernel", reps))
            print(f"{what}: device ms a launch (profiler, in turns) " + "; ".join(
                f"{t} {min(v):.5f}" for t, v in reads.items())
                  + f"; package {1e3 * min(reads['package']) / steps:.5f} µs a step"
                  + (f"; baseline == package {equal}" if len(outs) > 1 else ""))
            if name == "single_flip":
                use(clocks)
                fn()
                torch.cuda.synchronize()
                buf = np.zeros((1600, _SLOTS), np.int64)
                if clocks.serial_probe_clocks(buf.ctypes.data, buf.nbytes) != 0:
                    raise RuntimeError("could not read the stage clocks")
                n_blocks = 1500 if "R=1500" in what else 1
                for b in sorted({0, n_blocks // 2, n_blocks - 1}):
                    roles, bars = buf[b, :48].reshape(12, 4), buf[b, 48:60]
                    print(f"  block {b} cycles: copy ends (warps 0-2) {buf[b, 60:63].tolist()}; "
                          + "; ".join(f"stage {s}: walk {roles[s][0]} draw {roles[s][2]} "
                                      f"apply {roles[s][3]} barrier {bars[s]}"
                                      for s in range(4) if bars[s]))
    finally:
        sc._lib = original
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
