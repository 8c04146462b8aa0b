"""int8 gradient compression with error feedback, for a data-parallel
all-reduce (twin of `repro.train.grad_compress`).

Each tensor is quantized to int8 against one per-tensor scale; the
quantization error is fed back into the next step (error-feedback SGD, Seide
et al. 2014 / Karimireddy et al. 2019).  `compressed_psum` reduces over a
`torch.distributed` process group, the port's counterpart of the JAX
package's named mesh axis: an all-reduce MAX of the scales (every rank then
dequantizes alike), a requantization against the common scale, and an
all-reduce SUM of the int8 payload in int32 (no overflow below 2^23 ranks).
`torch.round` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["quantize_int8", "dequantize", "compress_with_feedback", "compressed_psum"]


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(g: torch.Tensor, err: torch.Tensor):
    """Quantize (g + carried error); return (q, scale, new_err)."""
    target = g.to(torch.float32) + err
    q, scale = quantize_int8(target)
    new_err = target - dequantize(q, scale)
    return q, scale, new_err


def compressed_psum(g: torch.Tensor, err: torch.Tensor, group=None):
    """int8 all-reduce over ``group`` (the default group when None) with
    error feedback; returns (the f32 sum, this rank's new error)."""
    q, scale, new_err = compress_with_feedback(g, err)
    common = scale.clone()
    dist.all_reduce(common, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(dequantize(q, scale) / common), -127, 127).to(torch.int32)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return q.to(torch.float32) * common, new_err
