"""The standalone exchange (5x, ``csrc/exchange_step.cu``) and the mesh round
path it serves, timed on the card for one source tree of the port: run it
once a tree, in alternating processes, to compare two.

    python src/repro_torch/launch/exchange_probe.py --src src \\
        --sass build/base/src/repro_torch/kernels/csrc
    python src/repro_torch/launch/exchange_probe.py --src build/base/src

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (a
checkout, or ``git archive <commit> src pyproject.toml`` unpacked under
``build/``, so that its kernels build beside it).  Only what both trees have
is called: ``kernels.exchange.exchange_rows`` as the sharded round step
calls it, with that tree's post-work (a tree whose ``exchange_rows`` takes
no ``block`` slices the new rungs and adds 1 to the phase in torch, as its
sharded step does), and ``Session`` with ``engine.mesh``.  It prints, at
R=1500 gathered rows, C=1 and C=8 chains:

* the profiler's device time a call: the exchange launch alone, and all
  device work of the call with its post-work;
* CUDA events around 200 back-to-back calls, and the host's wall time to
  issue a call;
* with ``--parts`` (this tree's wrapper only): the shared variant's device
  time at C=1 beside `VARIANTS` of it (work taken out, other block sizes),
  in turns, the host time of each part of the wrapper, and one profiled
  short-round run on ``MeshSpec(1, 1)`` (device busy time, the host ops
  with the most self CPU time an interval);

then the mesh round path's ms an interval on a one-rank NCCL group
(``MeshSpec(1, 1)``) and unsharded: the paper's shape (Ising L=300 R=1500
S=100, 6 intervals) and short rounds (L=32 R=1500 S=1, 2000 intervals),
wall and host CPU time, ``--repeats`` runs each after a warm-up run, with
the launches of a run; and the card's name and power limit.  ``--sass
DIR`` also builds kernels A, #2p and #5 (``ising_fused.cu``,
``ising_packed.cu``, ``potts_fused.cu``) from this tree's ``csrc`` and from
the ``csrc`` directory DIR with the tree's flags and compares their SASS
(``cuobjdump -sass``) instruction for instruction.
"""
from __future__ import annotations

import argparse
import inspect
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROWS = 1500
CHAINS = (1, 8)
# name -> (lattice side, sweeps an interval, intervals a run)
MESH_CONFIGS = {"paper L=300 R=1500 S=100": (300, 100, 6),
                "short L=32 R=1500 S=1": (32, 1, 2000)}
ROUND_SOURCES = ("ising_fused", "ising_packed", "potts_fused")


def exchange_args(torch, c: int) -> tuple:
    """One chain's (C=1: (R,) rows, as the paper's sharded step) or C
    chains' rows at R=1500: rung, energy, betas, phase, key."""
    from repro_torch.core import keys

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(c)
    rung = torch.stack([torch.randperm(ROWS, generator=g, device=dev) for _ in range(c)]).int()
    energy = -180000 + 100 * torch.randperm(ROWS * c, generator=g, device=dev).reshape(c, ROWS)
    energy = energy.float()
    betas = 1.0 / torch.linspace(1.0, 4.0, ROWS, device=dev)
    phase = torch.arange(c, device=dev)
    key = torch.stack([keys.key(s, device=dev) for s in range(c)])
    if c == 1:
        return rung[0], energy[0], betas, phase[0], key[0]
    return rung, energy, betas, phase, key


def exchange_call(torch, c: int):
    """The exchange of `exchange_args` with the tree's post-work, rank block
    [750, 1500)."""
    from repro_torch.kernels import exchange as xk

    args = exchange_args(torch, c)
    kw = dict(pairing="deo", criterion="logistic")
    start, stop = ROWS // 2, ROWS
    if "block" in inspect.signature(xk.exchange_rows).parameters:
        return lambda: xk.exchange_rows(*args, block=(start, stop), **kw)

    def with_post_work():
        new_rung = xk.exchange_rows(*args, **kw)[0]
        return new_rung[..., start:stop].contiguous(), args[3] + 1

    return with_post_work


def device_ms(torch, fn, reps: int) -> tuple[float, float]:
    """(the exchange launch, all device work) ms a call of ``fn`` over
    ``reps`` calls, by the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(100)  # the tracer runs before fn starts (a spin_kernel)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key]
    total = sum(float(e.self_device_time_total) for e in rows)
    own = sum(float(e.self_device_time_total) for e in rows if "exchange" in e.key)
    return own / reps / 1e3, total / reps / 1e3


def time_exchange(torch, c: int, repeats: int) -> str:
    fn = exchange_call(torch, c)
    events, issue = [], []
    for _ in range(repeats):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        for _ in range(200):
            fn()
        stop.record()
        issue.append(1e3 * (time.perf_counter() - t) / 200)
        torch.cuda.synchronize()
        events.append(start.elapsed_time(stop) / 200)
    own, total = device_ms(torch, fn, 200)
    return (f"  exchange R={ROWS} C={c}: device ms a call {own:.5f} (launch), {total:.5f} (all "
            f"device work of the call); CUDA events ms a call "
            + " / ".join(f"{x:.5f}" for x in events) + f" (min {min(events):.5f}); host ms "
            f"to issue a call " + " / ".join(f"{x:.5f}" for x in issue)
            + f" (min {min(issue):.5f})")


def mesh_spec(side: int, interval: int, n_int: int, mesh: bool) -> dict:
    """The round path's RunSpec JSON (glauber, paper ladder, no adaptation)."""
    engine = {"swap_interval": interval, "chunk_intervals": min(n_int, 100)}
    if mesh:
        engine["mesh"] = {"ensemble": 1, "replica": 1}
    return {"spec_version": 1,
            "system": {"name": "ising", "params": {"length": side, "accept_rule": "glauber",
                                                   "use_fused": True, "use_fused_round": True}},
            "ladder": {"kind": "paper", "n_replicas": ROWS, "t_min": 1.0, "t_max": 4.0},
            "engine": engine,
            "schedule": {"phases": [{"name": "run", "n_sweeps": interval * n_int}]},
            "observables": ["absmag", "energy_per_site"], "seed": 0}


def time_mesh(torch, name: str, mesh: bool, repeats: int) -> str:
    from repro_torch.api import RunSpec, Session
    from repro_torch.kernels import build

    side, interval, n_int = MESH_CONFIGS[name]
    spec = RunSpec.from_json(mesh_spec(side, interval, n_int, mesh))
    walls, cpus, launches = [], [], None
    for rep in range(repeats + 1):  # the first run warms up
        session = Session(spec, device="cuda", strict_kernels=True)
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
    where = "MeshSpec(1, 1) NCCL" if mesh else "unsharded"
    return (f"  {name} {where}: ms/interval " + " / ".join(f"{w:.4f}" for w in walls)
            + f" (min {min(walls):.4f}), host CPU ms/interval "
            + " / ".join(f"{x:.4f}" for x in cpus) + f" (min {min(cpus):.4f}); launches a "
            f"run {launches}")


def sass_lines(build, csrc: Path, name: str, out: Path) -> list[str]:
    """The SASS instructions of ``csrc/name.cu`` built with the tree's flags."""
    out.mkdir(parents=True, exist_ok=True)
    cubin = out / f"{name}.cubin"
    flags = [f for f in build._COMMON if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([build.nvcc_path(), *flags, *build.SOURCES[name], "-cubin", "-I", str(csrc),
                    "-o", str(cubin), str(csrc / f"{name}.cu")], check=True,
                   capture_output=True, text=True)
    dump = subprocess.run([str(Path(build.nvcc_path()).with_name("cuobjdump")), "-sass",
                           str(cubin)], check=True, capture_output=True, text=True).stdout
    return [ln.strip() for ln in dump.splitlines() if ln.strip().startswith("/*")]


def compare_sass(base_csrc: Path) -> str:
    from repro_torch.kernels import build

    parts = []
    with tempfile.TemporaryDirectory() as tmp:
        for name in ROUND_SOURCES:
            mine = sass_lines(build, build.CSRC, name, Path(tmp) / "mine")
            base = sass_lines(build, base_csrc, name, Path(tmp) / "base")
            parts.append(f"{name} {len(mine)} instructions, "
                         + ("equal" if mine == base else f"DIFFERENT from {len(base)}"))
    return "  SASS against the baseline csrc: " + "; ".join(parts)


# exchange_step.cu with a part of the shared variant's work taken out or its
# block resized: (old, new) source edits; the cut ones' outputs are wrong on
# purpose, and each keeps what it does alive through one store of phase'
_KEEP = "  if (tid == 0) post.phase_out[c] = {};\n  return;\n"
VARIANTS = {
    "launch only": [("  const int c = blockIdx.x, tid = threadIdx.x;\n",
                     "  if (blockDim.x > 0) return;\n  const int c = blockIdx.x, "
                     "tid = threadIdx.x;\n")],
    "stage 1": [("  __syncthreads();\n\n  // (2)", "  __syncthreads();\n" + _KEEP.format(
        "rung_s[n - 1] + static_cast<int64_t>(e_rung[0] + beta_s[0]) + keys.parity")
        + "\n  // (2)")],
    "stages 1-2": [("  __syncthreads();\n\n  // (3)",
                    "  __syncthreads();\n" + _KEEP.format("perm[0]") + "\n  // (3)")],
    **{f"{n} threads": [("constexpr int kThreads = 512;", f"constexpr int kThreads = {n};")]
       for n in (128, 384, 1024)},
}


def substitute(text: str, edits) -> str:
    """``text`` with each (old, new) of ``edits`` applied; each old must
    occur exactly once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"exchange_step.cu has not exactly one {old!r}")
        text = text.replace(old, new)
    return text


def time_variants(torch, out: Path, repeats: int) -> str:
    """Device ms a launch (profiler) at R=1500, C=1 of the package's kernel
    and of each of `VARIANTS`, in turns."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels import exchange as xk

    text = (build.CSRC / "exchange_step.cu").read_text()
    libs, procs = {}, {}
    for name, edits in {"package": [], **VARIANTS}.items():
        d = out / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        (d / "exchange_step.cu").write_text(substitute(text, edits))
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build._COMMON, *build.SOURCES["exchange_step"], "-I",
             str(build.CSRC), "-o", str(d / "lib.so"), str(d / "exchange_step.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name!r} variant:\n{log}")
        libs[name] = ctypes.CDLL(str(out / name.replace(" ", "_") / "lib.so"))
    fn = exchange_call(torch, 1)
    reads = {name: [] for name in libs}
    try:
        for _ in range(repeats):
            for name, lib in libs.items():
                xk._lib.cache_clear()
                build._LOADED["exchange_step"] = lib
                reads[name].append(device_ms(torch, fn, 200)[0])
    finally:  # the package's own library again at the next launch
        build._LOADED.pop("exchange_step", None)
        xk._lib.cache_clear()
    return "  device ms a launch R=1500 C=1 (profiler, in turns): " + "; ".join(
        f"{name} {min(v):.5f}" for name, v in reads.items())


def host_parts(torch, reps: int = 2000) -> str:
    """Host µs a call of each part of the wrapper at R=1500, C=1, and of
    alternatives to some (wall time to issue ``reps`` calls)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import exchange as xk

    args = rung, energy, betas, phase, key = exchange_args(torch, 1)
    dev = rung.device
    block, kw = (ROWS // 2, ROWS), dict(pairing="deo", criterion="logistic")
    plan = xk._prepare((), ROWS, block, "deo", "logistic")
    buf = torch.empty(plan.nbytes, dtype=torch.uint8, device=dev)
    lib, stream = xk._lib(), build.stream_of(dev)
    fixed = (rung.data_ptr(), buf.data_ptr(), energy.data_ptr(), betas.data_ptr(),
             phase.data_ptr(), buf.data_ptr(), key.data_ptr(), *plan.ints, buf.data_ptr(),
             buf.data_ptr(), buf.data_ptr(), buf.data_ptr(), *plan.block, None, dev.index, stream)

    def views():
        v = dict(zip(xk._VIEWS, (buf.view(d) for d in xk._VIEWS)))
        return [v[d].as_strided(s, st, at) for d, s, st, at in plan.outputs]

    parts = {
        "exchange_rows": lambda: xk.exchange_rows(*args, block=block, **kw),
        "exchange_step_kernel": lambda: xk.exchange_step_kernel(*args, block=block, **kw),
        "the plan (cached)": lambda: xk._prepare((), ROWS, block, "deo", "logistic"),
        "five checks": lambda: [(x.device, x.dtype, x.shape) != (dev, d, s)
                                or not x.is_contiguous()
                                for x, (_, d, s) in zip(args, plan.inputs)],
        "torch.empty": lambda: torch.empty(plan.nbytes, dtype=torch.uint8, device=dev),
        "six views": views,
        "six torch.empty instead": lambda: [torch.empty(s, dtype=d, device=dev)
                                            for d, s, _, _ in plan.outputs],
        "build.stream_of": lambda: build.stream_of(dev),
        "torch.cuda.current_stream instead": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "exchange_rows' conversions": lambda: (xk._typed(betas, torch.float32),
                                               xk._typed(phase, torch.int64),
                                               xk._typed(key, torch.int64)),
        "ctypes launch": lambda: lib.exchange_step_launch(*fixed),
    }
    out = []

    def issue(name, fn):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        out.append(f"{name} {1e6 * (time.perf_counter() - t) / reps:.2f}")
        torch.cuda.synchronize()

    for name, fn in parts.items():
        issue(name, fn)
    return "  host µs a call, R=1500 C=1 (wall time to issue): " + "; ".join(out)


def profile_mesh(torch, n_int: int = 200) -> str:
    """One profiled run of the short rounds on ``MeshSpec(1, 1)``: device
    busy time and wall time an interval, and the host ops that take the
    most of the process's own time (self CPU µs an interval)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import RunSpec, Session

    side, interval, _ = MESH_CONFIGS["short L=32 R=1500 S=1"]
    spec = RunSpec.from_json(mesh_spec(side, interval, n_int, True))
    Session(spec, device="cuda", strict_kernels=True).run()  # warm
    session = Session(spec, device="cuda", strict_kernels=True)
    session.state = session.init_state()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        session.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = prof.key_averages()
    busy = sum(float(e.self_device_time_total) for e in rows if e.device_type == DeviceType.CUDA)
    host = sorted((e for e in rows if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:10]
    return (f"  profiled short rounds on MeshSpec(1, 1), {n_int} intervals: wall "
            f"{1e3 * wall / n_int:.4f} ms/interval (profiler on), device busy "
            f"{busy / n_int / 1e3:.4f} ms/interval; host self CPU µs an interval: "
            + "; ".join(f"{e.key} {e.self_cpu_time_total / n_int:.1f} ({e.count // n_int}x)"
                        for e in host))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, required=True,
                    help="src directory to import repro_torch from")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--sass", type=Path, help="a csrc directory to compare A, #2p, #5's SASS with")
    ap.add_argument("--parts", action="store_true",
                    help="also time the kernel's variants and the wrapper's host parts")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.src.resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("exchange_probe needs a CUDA card")
    import torch.distributed as dist

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"tree {args.src.resolve()} [{card}]", flush=True)
    if args.sass:
        print(compare_sass(args.sass), flush=True)
    for c in CHAINS:
        print(time_exchange(torch, c, args.repeats), flush=True)
    if args.parts:
        with tempfile.TemporaryDirectory() as tmp:
            print(time_variants(torch, Path(tmp), args.repeats), flush=True)
        print(host_parts(torch), flush=True)
        print(profile_mesh(torch), flush=True)
    for name in MESH_CONFIGS:
        for mesh in (False, True):
            print(time_mesh(torch, name, mesh, args.repeats), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
