"""Thread tiles of kernel #7 (``csrc/wkv6.cu``, the RWKV-6 recurrence) on the card.

For the package's source and for each ``--tile RxC`` substituted for its
``kRows`` / ``kCols`` constants (the rows and columns of the state a thread
holds; the block has 64·64 / (R·C) threads), it prints

* ``nvcc -Xptxas -v``: registers and spills;
* a check against the plain version (`ref.wkv6`) within the recurrence's
  rounding bound, 2·(dk + T)·eps times the recurrence on the inputs'
  magnitudes, at rwkv6-7b's serving shapes and at rows that are no multiple
  of 16 bytes, and that a run split into two launches equals one bit for
  bit;
* times at rwkv6-7b's shapes with B=4 (BH=256, dk=dv=64: prefill T=512 from
  zero state, decode T=1 from a carried state), in turns (each variant, then
  again in reverse order): CUDA events around back-to-back launches and the
  profiler's device time per launch, beside the byte bound.

The variants keep the package's C interface.  Needs one card and the CUDA
toolkit:

    PYTHONPATH=src python -m repro_torch.launch.wkv6_probe --tile 16x1 4x4 8x4 8x8
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build, ref

__all__ = ["substitute", "main"]

HBM_BYTES_PER_S = 3.35e12
F32_EPS = 2.0 ** -23


def substitute(text: str, rows: int, cols: int) -> str:
    """``wkv6.cu``'s source with its thread tile set to ``rows`` x ``cols``."""
    for const, value in (("kRows", rows), ("kCols", cols)):
        text, n = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};",
                          text)
        if n != 1:
            raise ValueError(f"wkv6.cu has no single {const} constant")
    return text


def _build(text: str, out: Path) -> tuple[Path, subprocess.Popen]:
    out.mkdir(parents=True, exist_ok=True)
    (out / "wkv6.cu").write_text(text)
    lib = out / "libwkv6.so"
    cmd = [build.nvcc_path(), *build._COMMON, *build.SOURCES["wkv6"], "-Xptxas", "-v",
           "-o", str(lib), str(out / "wkv6.cu")]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _inputs(bh, t, dk, dv, state, device, seed=3):
    g = np.random.default_rng(seed)
    r, k = (g.normal(size=(bh, t, dk)).astype(np.float32) for _ in range(2))
    v = g.normal(size=(bh, t, dv)).astype(np.float32)
    w = (1.0 / (1.0 + np.exp(-g.normal(size=(bh, t, dk))))).astype(np.float32)
    u = g.normal(size=(bh, dk)).astype(np.float32)
    s0 = g.normal(size=(bh, dk, dv)).astype(np.float32) if state else None
    return [None if x is None else torch.from_numpy(x).to(device) for x in (r, k, v, w, u, s0)]


def _launcher(lib: ctypes.CDLL, r, k, v, w, u, s0):
    """A closure that launches ``lib``'s kernel as the wrapper does."""
    bh, t, dk = r.shape
    dv = v.shape[-1]
    o = torch.empty((bh, t, dv), device=r.device)
    s = torch.empty((bh, dk, dv), device=r.device)

    def launch():
        err = lib.wkv6_launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                              u.data_ptr(), None if s0 is None else s0.data_ptr(),
                              o.data_ptr(), s.data_ptr(), bh, t, dk, dv,
                              build.stream_of(r.device))
        build.raise_if(err, "wkv6 variant")
        return o, s
    return launch


def _check(lib: ctypes.CDLL, device) -> None:
    for bh, t, dk, dv, state in ((256, 512, 64, 64, False), (256, 1, 64, 64, True),
                                 (3, 33, 63, 5, False), (2, 1000, 5, 63, True)):
        args = _inputs(bh, t, dk, dv, state, device)
        got = _launcher(lib, *args)()
        want = ref.wkv6(*args)
        mag = ref.wkv6(*(None if x is None else x.abs() for x in args))
        for g, w, m in zip(got, want, mag):
            if bool(((g - w).abs() > 2 * (dk + t) * F32_EPS * m).any()):
                raise AssertionError(f"beyond the rounding bound at {(bh, t, dk, dv)}")
    r, k, v, w, u, s0 = _inputs(3, 100, 64, 64, True, device)
    o_full, s_full = _launcher(lib, r, k, v, w, u, s0)()
    o1, s1 = _launcher(lib, *(x[:, :45].contiguous() for x in (r, k, v, w)), u, s0)()
    o2, s2 = _launcher(lib, *(x[:, 45:].contiguous() for x in (r, k, v, w)), u, s1)()
    if not (torch.equal(o_full, torch.cat([o1, o2], 1)) and torch.equal(s_full, s2)):
        raise AssertionError("two launches differ from one")


def _events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _device_ms(fn, reps: int = 50) -> float:
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
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "wkv6" in e.key]
    return sum(float(e.self_device_time_total) for e in rows) / sum(e.count for e in rows) / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tile", nargs="*", default=[],
                    help="ROWSxCOLS: the state tile a thread holds, for kRows and kCols")
    ap.add_argument("--out", type=Path, default=build.build_root() / "wkv6_probe")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("wkv6_probe needs a CUDA card")
    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    source = (build.CSRC / "wkv6.cu").read_text()
    variants = {"package": source}
    for entry in args.tile:
        rows, cols = (int(x) for x in entry.split("x"))
        variants[entry] = substitute(source, rows, cols)
    if args.out.exists():
        shutil.rmtree(args.out)
    builds = {label: _build(text, args.out / label) for label, text in variants.items()}
    libs = {}
    for label, (path, proc) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        report = " | ".join(ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln)
        print(f"[{label}] ptxas: {report}")
        lib = ctypes.CDLL(str(path))
        lib.wkv6_launch.restype = ctypes.c_int
        lib.wkv6_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        _check(lib, device)
        libs[label] = lib
    print("every variant within the rounding bound of the plain version; two launches == one")
    shapes = {"prefill": (_inputs(256, 512, 64, 64, False, device), 50),
              "decode": (_inputs(256, 1, 64, 64, True, device), 500)}
    times = {(label, name): [] for label in libs for name in shapes}
    order = list(libs)
    for label in order + order[::-1]:
        for name, (inp, reps) in shapes.items():
            fn = _launcher(libs[label], *inp)
            times[label, name].append((_events_ms(fn, reps), _device_ms(fn)))
    for name, (inp, _) in shapes.items():
        bh, t, dk = inp[0].shape
        n_bytes = 4.0 * (bh * t * (3 * dk + 2 * 64) + (2 if inp[5] is not None else 1) * bh * dk * 64
                         + bh * dk)
        bound = 1e3 * n_bytes / HBM_BYTES_PER_S
        for label in order:
            ts = times[label, name]
            print(f"[{label}] wkv6 {name} [{card}]: "
                  f"{' / '.join(f'{e:.4f}' for e, _ in ts)} ms (CUDA events), "
                  f"{' / '.join(f'{d:.5f}' for _, d in ts)} ms device time (profiler); "
                  f"byte bound {bound:.5f} ms, bound/device time {bound / min(d for _, d in ts):.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
