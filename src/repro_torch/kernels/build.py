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
``ising_packed.cu``, ``sweep.cu``, ``potts_fused.cu``) and
``jax_uniform.cu`` add ``-fmad=false``
so no float product is contracted into an FMA; ``exchange.cu`` keeps nvcc's
default contraction, as PyTorch builds its own exp/sigmoid kernels, because
its probabilities must match those torch ops.

`launches` counts the launches of every kernel by name; each wrapper adds
one where it launches its kernel, and nowhere else.  The wrappers share the
argument checks (`check`, `check_smem`), `stream_of` and `raise_if` below,
and `sweep_lib`, the library of kernels #1 and #4.
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
    "CSRC", "SOURCES", "build_root", "nvcc_path", "build_all", "library",
    "launches", "reset_launches", "MAX_SMEM_BYTES", "check", "check_smem",
    "stream_of", "raise_if", "sweep_lib",
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
    "exchange": [],
    "sweep": ["-fmad=false"],
    "potts_fused": ["-fmad=false"],
    "jax_uniform": ["-fmad=false"],
}
_LOADED: dict[str, ctypes.CDLL] = {}
# Hopper: 227 KB of shared memory per block (opt-in above 48 KB)
MAX_SMEM_BYTES = 232448
_P = ctypes.c_void_p

# kernel name -> launches since the last reset (kernel A and B of the round
# path, kernel #2p, kernels #1 and #4 of sweep.cu, kernel #5, the jax.random
# helper)
launches = dict.fromkeys(
    ("ising_fused", "ising_packed", "exchange", "ising_sweep", "potts_sweep",
     "potts_fused", "jax_uniform"), 0,
)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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
    compile raises with the compiler's output.
    """
    out_dir = build_root() / _digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {name: out_dir / f"lib{name}.so" for name in SOURCES}
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
        paths = build_all()
        for lib_name, path in paths.items():
            _LOADED[lib_name] = ctypes.CDLL(str(path))
        lib = _LOADED[name]
    return lib


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
    return torch.cuda.current_stream(dev).cuda_stream


def check(x: torch.Tensor, name: str, dtype, shape, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_if(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with cudaError {err}")
