"""Shared model pieces: the config, its parameter count, RMS norm and the
dense initializer (twin of `repro.models.common`).

`ModelConfig` has the JAX package's fields that the port reads, with
their defaults; `compute_dtype` is a torch dtype.  `dense_init` draws from
an explicit `torch.Generator` (`dense_param` wraps it as a frozen
parameter), so a model is made from a seed on any device; its numbers differ from ``jax.random``'s, and parity
tests carry the JAX package's weights over
(`repro_torch.carry.lm_params_from_reference`) instead.  RoPE and the other
primitives wait for the families that use them.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["ModelConfig", "param_count", "rms_norm", "dense_init", "dense_param"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description (one instance per arch in `repro_torch.configs`).

    The fields the port reads, each with the JAX config's name and default.
    RWKV-6 heads are 64 wide (``d_model / 64`` of them) and its channel mix
    is a squared ReLU, so the head and activation fields wait for the
    families that read them.  A serving `LM` stores its weights in
    ``dtype``; training keeps f32 masters (``param_dtype``) and casts them
    once a step (`repro_torch.train.train_step`).  ``remat`` recomputes each
    layer in the backward pass (``remat_policy="full"``; ``"dots"`` is
    refused by name), and the loss runs its softmax over ``logit_chunk``
    positions at a time.
    """

    name: str
    family: str  # the port runs "rwkv"
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    dtype: str = "bfloat16"  # matmul/activation dtype (a serving LM's weights too)
    param_dtype: str = "float32"  # master weights (training)
    remat: bool = True
    remat_policy: str = "full"  # full (recompute all); "dots" is not ported
    logit_chunk: int = 512  # CE computed in seq chunks of this size
    tie_embeddings: bool = False
    embed_scale: float = 1.0

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def n_params(self) -> int:
        """Total parameter count (analytic)."""
        return param_count(self)


def param_count(cfg: ModelConfig) -> int:
    """The JAX package's analytic parameter count, rwkv family (it leaves out
    the nine d-vectors a layer of lerp weights, ``w0`` and ``ln_scale``)."""
    if cfg.family != "rwkv":
        raise NotImplementedError(f"not yet ported: param_count of the {cfg.family!r} family")
    d = cfg.d_model
    tm = 5 * d * d + 2 * d * 64 + d  # time-mix: r,k,v,g,o + decay lora + bonus u
    cm = 2 * d * cfg.d_ff + d * d  # channel-mix k/v + receptance gate
    out = cfg.n_layers * (tm + cm + 2 * d) + cfg.vocab * d + d  # + embedding, final norm
    if not cfg.tie_embeddings:
        out += cfg.vocab * d  # untied unembed
    return out


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32 with a ``1 + scale`` gain, cast back to ``x.dtype``."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


def dense_init(generator: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """N(0, 1/fan_in) weights drawn in f32 from ``generator``, cast to ``dtype``."""
    fan_in = shape[in_axis] if in_axis >= 0 else math.prod(shape[:-1])
    out = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                      device=device)
    return out.mul_(1.0 / math.sqrt(max(fan_in, 1))).to(dtype)


def dense_param(generator, shape, in_axis: int = 0, dtype=torch.float32,
                device=None) -> torch.nn.Parameter:
    """A frozen weight: drawn by `dense_init` from ``generator``, or left
    empty (``generator=None``) for `carry.lm_params_from_reference` to fill."""
    if generator is None:
        t = torch.empty(tuple(shape), dtype=dtype, device=device)
    else:
        t = dense_init(generator, shape, in_axis=in_axis, dtype=dtype, device=device)
    return torch.nn.Parameter(t, requires_grad=False)
