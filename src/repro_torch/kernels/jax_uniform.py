"""The per-sweep ``jax.random`` uniforms of the default path, on the card.

The JAX engine's per-sweep path draws replica ``r``'s uniforms for sweep
``t`` as ``uniform(fold_in(fold_in(key, 2t), r), shape)``
(`repro.engine.driver._sweep_once`).  `jax_uniform_kernel` computes all R
of them in one launch of ``csrc/jax_uniform.cu``, reading ``t`` through a
device pointer; `jax_uniform_plain` is the same draw with `core.keys`, which
is what runs for CPU tensors.  The two are bit-equal.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core import keys
from repro_torch.kernels import build
from repro_torch.kernels.build import check, raise_if, stream_of

__all__ = ["jax_uniform_kernel", "jax_uniform_plain"]

_P = ctypes.c_void_p


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("jax_uniform")
    lib.jax_uniform_launch.restype = ctypes.c_int
    lib.jax_uniform_launch.argtypes = [_P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P]
    return lib


def jax_uniform_plain(key, t, replica_ids, shape) -> torch.Tensor:
    """(len(replica_ids), *shape) f32: ``uniform(fold_in(fold_in(key, 2t), r), shape)``."""
    return keys.uniform(keys.replica_keys(key, t, replica_ids), shape)


def jax_uniform_kernel(key, t, n_replicas: int, shape) -> torch.Tensor:
    """(n_replicas, *shape) f32 from one launch; replicas ``0..n_replicas-1``.

    Args:
      key: (2,) int64 key words on CUDA; t: () int64 sweep counter (device).
    """
    dev = key.device
    if dev.type != "cuda":
        raise ValueError(f"jax_uniform needs CUDA tensors, got {dev}")
    check(key, "key", torch.int64, (2,), dev)
    check(t, "t", torch.int64, (), dev)
    n = math.prod(shape)
    if not 0 < n_replicas <= 65535 or n > 1 << 32:
        raise ValueError(f"jax_uniform takes 1..65535 replicas of <= 2^32 values, "
                         f"got {n_replicas} x {n}")
    out = torch.empty((n_replicas, *shape), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().jax_uniform_launch(
            out.data_ptr(), key.data_ptr(), t.data_ptr(), n_replicas, n, stream_of(dev)
        )
    raise_if(err, "jax_uniform")
    build.launches["jax_uniform"] += 1
    return out
