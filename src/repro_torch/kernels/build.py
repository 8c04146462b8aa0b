"""Build the CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` becomes its own shared library with a plain C interface
(no PyTorch headers, so a build takes seconds).  All sources compile in
parallel, one ``nvcc`` each, into ``<checkout>/build/repro_torch/<hash>/``,
keyed by a hash of every source and flag, at the first launch in a process.
The package must be run from its source checkout (``PYTHONPATH=src`` or an
editable install), or ``$REPRO_TORCH_BUILD_DIR`` must name the build
directory: an installed copy never builds beside ``site-packages``.
Nothing here runs at import time.

Flags: ``-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC``, never fast math.  The sweep kernels (``ising_fused.cu``,
``ising_packed.cu``, ``sweep.cu``, ``potts_fused.cu``), ``jax_uniform.cu``,
``serial_chain.cu`` and ``exchange_step.cu`` add ``-fmad=false``
so no float product is contracted into an FMA (the round exchange that
kernels A, #2p and #5 run, ``exchange.cuh``, has no product followed by a
sum, and its exp/sigmoid are libdevice's as in PyTorch's own kernels);
``wkv6.cu`` and ``wkv6_bwd.cu`` keep nvcc's default contraction (their
sums are held to a tolerance, not bit for bit).

`launches` counts the launches of every kernel by name; each wrapper adds
one where it launches its kernel, and nowhere else.  `epilogues` counts the
round exchanges those launches ran (one per round launch of kernels A, #2p
and #5).  The wrappers share the argument checks (`check`, `check_smem`,
`check_round`), `stream_of`, `raise_if`, the round launches' arguments
(`round_args`, `scratch_bytes`, `ROUND_ARGTYPES`, `NO_ROUND`) and
`sweep_lib`, the library of kernels #1 and #4.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = [
    "CSRC", "SOURCES", "build_root", "nvcc_path", "build_all", "library", "load_all",
    "KernelError",
    "launches", "epilogues", "reset_launches", "MAX_SMEM_BYTES", "check",
    "check_smem", "check_round", "round_args", "scratch_bytes", "dirty_tickets",
    "ROUND_ARGTYPES", "NO_ROUND", "stream_of", "raise_if", "sweep_lib",
]

CSRC = Path(__file__).resolve().parent / "csrc"
_PKG = Path(__file__).resolve().parents[1]  # .../src/repro_torch
_COMMON = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
# library name -> extra nvcc flags
SOURCES = {
    "ising_fused": ["-fmad=false"],
    "ising_packed": ["-fmad=false"],
    "sweep": ["-fmad=false"],
    "potts_fused": ["-fmad=false"],
    "jax_uniform": ["-fmad=false"],
    "serial_chain": ["-fmad=false"],
    "exchange_step": ["-fmad=false"],
    "wkv6": [],
    "wkv6_bwd": [],
}
_LOADED: dict[str, ctypes.CDLL] = {}
# Hopper: 227 KB of shared memory per block (opt-in above 48 KB)
MAX_SMEM_BYTES = 232448
_P = ctypes.c_void_p

# kernel name -> launches since the last reset (kernel A, kernel #2p,
# kernels #1 and #4 of sweep.cu, kernel #5, the jax.random helper, the two
# serial chains of serial_chain.cu, the standalone exchange of the sharded
# round path, the RWKV-6 recurrence #7 and its gradient #7b)
launches = dict.fromkeys(
    ("ising_fused", "ising_packed", "ising_sweep", "potts_sweep", "potts_fused",
     "jax_uniform", "hp_moves", "single_flip", "exchange_step", "wkv6", "wkv6_bwd"), 0,
)
# round exchanges run at the end of a launch of kernel A, #2p or #5 since the
# last reset (no launch of their own)
epilogues = {"exchange": 0}


def reset_launches() -> None:
    for counts in (launches, epilogues):
        for name in counts:
            counts[name] = 0


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def build_root() -> Path:
    """Where kernel libraries are built: ``$REPRO_TORCH_BUILD_DIR``, else the
    source checkout's ``build/repro_torch``; raises for an installed copy."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    checkout = _PKG.parents[1]
    if _PKG.parent.name == "src" and (checkout / "pyproject.toml").is_file():
        return checkout / "build" / "repro_torch"
    raise RuntimeError(
        f"repro_torch at {_PKG} is not in a source checkout; set "
        "REPRO_TORCH_BUILD_DIR to a directory for the CUDA kernel builds"
    )


def _digest() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(repr((_COMMON, SOURCES)).encode())
    return h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every source that is not built yet; returns name -> .so path.

    All ``nvcc`` processes start together and are all waited for; a failed
    compile raises with the compiler's output.  Processes that build at once
    (the ranks of a mesh) take a file lock in the build directory in turn:
    the first builds, the others find the libraries built.
    """
    out_dir = build_root() / _digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    if all(p.is_file() for p in paths.values()):
        return paths
    import fcntl

    with open(out_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _build_missing(paths)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build_missing(paths: dict[str, Path]) -> dict[str, Path]:
    todo = {n: p for n, p in paths.items() if not p.is_file()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_COMMON, *SOURCES[name], "-I", str(CSRC),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    errors = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, paths[name])  # atomic: concurrent builders agree
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use)."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = load_all()[name]
    return lib


def load_all() -> dict[str, ctypes.CDLL]:
    """Every kernel library, built (`build_all`) and loaded on first use."""
    if len(_LOADED) < len(SOURCES):
        for lib_name, path in build_all().items():
            if lib_name not in _LOADED:
                _LOADED[lib_name] = ctypes.CDLL(str(path))
    return dict(_LOADED)


@functools.cache
def sweep_lib() -> ctypes.CDLL:
    """``sweep.cu`` (kernels #1 and #4), built on first use."""
    lib = library("sweep")
    lib.ising_sweep_launch.restype = ctypes.c_int
    lib.ising_sweep_launch.argtypes = [_P] * 7 + [ctypes.c_int] * 2 + [_P]
    lib.potts_sweep_launch.restype = ctypes.c_int
    lib.potts_sweep_launch.argtypes = [_P] * 7 + [ctypes.c_int] * 4 + [_P]
    for fn, n in ((lib.ising_sweep_smem_bytes, 1), (lib.potts_sweep_smem_bytes, 2)):
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.c_int] * n
    return lib


def check_smem(smem: int, what: str) -> None:
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"{what} needs {smem} B of shared memory per block, over the "
            f"{MAX_SMEM_BYTES} B a Hopper block can hold; a tiled kernel for "
            "large lattices is not written yet"
        )


def stream_of(dev: torch.device) -> int:
    """The handle of ``dev``'s current CUDA stream (``torch.cuda.
    current_stream(dev).cuda_stream`` without making a ``Stream``: 0.2
    against 6.7 µs of host time a launch on the H100's host)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def check(x: torch.Tensor, name: str, dtype, shape, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class KernelError(RuntimeError):
    """A kernel launch the card refused (a non-zero ``cudaGetLastError``)."""


def raise_if(err: int, what: str) -> None:
    if err != 0:
        raise KernelError(f"{what} launch failed with cudaError {err}")


# -- the round launches' exchange arguments (csrc/exchange.cuh) --------------

# C types of a round launch's exchange arguments (rung_out, energy_in,
# energy_out, betas, phase0, phase_add, seo, metropolis, the accept, prob and
# attempt rows, scratch, tickets), between a sweep launch's own and its stream
NO_ROUND = (None,) * 5 + (0, 0, 0) + (None,) * 5
ROUND_ARGTYPES = [_P] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + [_P] * 5
# (device index, stream, chains) -> the tickets of the round launches on that
# stream over that many chains: one uint32 a chain, which each block of the
# chain adds one to and the chain's last block sets back to 0.  Launches on
# one stream run one after another, so they can share them; two streams must
# not, since two round launches in flight at once would count each other's
# blocks, and one would run its exchange before all of its own blocks were
# done.  The scratch rows are per stream and size for the same reason.
_TICKETS: dict[tuple[int, int, int], torch.Tensor] = {}
_SCRATCH: dict[tuple[int, int, int], torch.Tensor] = {}


@functools.cache
def scratch_bytes(lib: ctypes.CDLL) -> int:
    """The exchange scratch bytes a replica that ``lib``'s round launches
    use (its ``exchange_scratch_bytes()``, i.e. ``exchange::kScratchBytes``)."""
    fn = lib.exchange_scratch_bytes
    fn.restype, fn.argtypes = ctypes.c_longlong, []
    return int(fn())


def check_round(r: int, device, rung, energy, phase0, rows, *, pairing: str,
                criterion: str, chains: int | None = None):
    """Check a round launch's exchange arguments and its ``(rung', energy',
    accept, prob, attempt)`` rows (allocated where ``rows`` is None; ``rung'``
    and ``energy'`` may be ``rung`` and ``energy`` themselves); returns the rows.
    With a chain axis (``chains = C``) every row is ``(C, r)`` and ``phase0``
    is ``(C,)``."""
    from repro_torch.kernels import exchange

    if pairing not in exchange.PAIRINGS or criterion not in exchange.CRITERIA:
        raise ValueError(f"unsupported exchange {pairing!r}/{criterion!r}")
    lead = () if chains is None else (chains,)
    check(energy, "energy", torch.float32, (*lead, r), device)
    check(phase0, "phase0", torch.int64, lead, device)
    if rows is None:
        rows = (torch.empty_like(rung), torch.empty_like(energy),
                torch.empty((*lead, r), dtype=torch.bool, device=device),
                torch.empty((*lead, r), dtype=torch.float32, device=device),
                torch.empty((*lead, r), dtype=torch.bool, device=device))
    if len(rows) != 5:
        raise ValueError(f"a round writes 5 exchange rows, got {len(rows)}")
    for x, name, dtype in zip(rows, ("rung out", "energy out", "accept row", "prob row",
                                     "attempt row"),
                              (torch.int32, torch.float32, torch.bool, torch.float32,
                               torch.bool)):
        check(x, name, dtype, (*lead, r), device)
    return tuple(rows)


def round_args(lib: ctypes.CDLL, betas, xchg, n_chains: int = 1) -> tuple:
    """A launch of ``lib``'s sweep kernel: its exchange arguments in
    `ROUND_ARGTYPES` order.  `NO_ROUND` where ``xchg`` is None (the sweeps
    alone), else those of the round ``xchg = (energy, phase0, rows, keywords
    of the exchange)`` (rows checked by `check_round`) over ``n_chains``
    chains, with the current stream's ``n_chains`` tickets and scratch rows
    for ``n_chains * len(betas)`` replicas at `scratch_bytes` (``lib``) a
    replica (both made on first use and kept)."""
    if xchg is None:
        return NO_ROUND
    energy, phase0, rows, kw = xchg
    dev = betas.device
    key = (dev.index, stream_of(dev))
    ticket = _TICKETS.get((*key, n_chains))
    if ticket is None:
        ticket = _TICKETS[(*key, n_chains)] = torch.zeros(n_chains, dtype=torch.int32,
                                                          device=dev)
    n_bytes = scratch_bytes(lib) * betas.shape[0] * n_chains
    scratch = _SCRATCH.get((*key, n_bytes))
    if scratch is None:
        scratch = _SCRATCH[(*key, n_bytes)] = torch.empty(n_bytes, dtype=torch.uint8,
                                                          device=dev)
    rung_out, energy_out, acc, prob, att = rows
    return (rung_out.data_ptr(), energy.data_ptr(), energy_out.data_ptr(),
            betas.data_ptr(), phase0.data_ptr(), int(kw["phase_add"]), int(kw["pairing"] == "seo"),
            int(kw["criterion"] == "metropolis"), acc.data_ptr(), prob.data_ptr(),
            att.data_ptr(), scratch.data_ptr(), ticket.data_ptr())


def dirty_tickets() -> dict[tuple[int, int, int], list[int]]:
    """The round tickets that are not all 0, by (device index, stream,
    chains), with their values.  A round launch that ran to its end leaves
    every chain's ticket at 0; one that faulted may not, and the next round
    launch on that stream would then misfire, so a caller that checks after a
    run fails on any.  Reads each from the card."""
    values = {key: t.tolist() for key, t in _TICKETS.items()}
    return {key: v for key, v in values.items() if any(v)}
