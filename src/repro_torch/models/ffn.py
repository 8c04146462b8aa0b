"""Feed-forward layers: gated (SwiGLU / GeGLU) and plain MLPs (twin of
`repro.models.ffn`).

Every op runs in the compute dtype and rounds once, as JAX runs them op
by op: GeGLU's gate is the tanh ``gelu`` (``jax.nn.gelu(approximate=
True)``, its constants rounded to the dtype), SiLU is
`repro_torch.models.common.silu`, ``relu2`` (minitron) is the squared ReLU.
The weights are stored in the compute dtype (``w_gate``, ``w_up`` (D, F),
``w_down`` (F, D)), the JAX package's leaf names.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.common import ModelConfig, dense_param, scalar, silu

__all__ = ["is_gated", "gelu_tanh", "FFN"]


def is_gated(act: str) -> bool:
    return act in ("silu", "geglu", "swiglu", "gelu_glu")


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` op by op:
    ``x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))``."""
    c = scalar(math.sqrt(2 / math.pi), x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + scalar(0.044715, x.dtype) * (x * x * x))))
    return x * cdf


_ACTS = {
    "silu": silu,
    "gelu": gelu_tanh,
    "relu": torch.relu,
    "relu2": lambda x: torch.square(torch.relu(x)),
}


def _gate_fn(act: str):
    if act in ("silu", "swiglu"):
        return _ACTS["silu"]
    if act in ("geglu", "gelu_glu"):
        return _ACTS["gelu"]
    return _ACTS[act]


class FFN(nn.Module):
    """``init_ffn`` / ``ffn`` of the JAX code as a module."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        if cfg.act not in _ACTS and not is_gated(cfg.act):
            raise ValueError(f"unknown activation {cfg.act!r}")
        self.act = cfg.act
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.compute_dtype
        if is_gated(cfg.act):
            self.w_gate = dense_param(generator, (d, f), dtype=dt, device=device)
        self.w_up = dense_param(generator, (d, f), dtype=dt, device=device)
        self.w_down = dense_param(generator, (f, d), dtype=dt, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if is_gated(self.act):
            h = _gate_fn(self.act)(x @ self.w_gate) * (x @ self.w_up)
        else:
            h = _ACTS[self.act](x @ self.w_up)
        return h @ self.w_down
