"""Decoder-only LM assembly, the rwkv subset (twin of `repro.models.transformer`).

The JAX package expands each architecture to a cyclic pattern of layer kinds
and stacks the layers into scanned groups plus a tail; the port keeps the
same plan (`layer_pattern`, `plan`) but holds the layers unstacked, in order,
in an `LM` module:

  LM.embed (V, D), LM.layers [RWKVBlock ...], LM.final_norm (D,),
  LM.unembed (D, V) (absent with tied embeddings)

A decode state is the list of the layers' states, in the same order.  Only
the ``rwkv`` family runs; every other family is refused by name.  Entry
points: `init_params`, `backbone`, `last_logits`, `init_decode_state`,
`decode_step`; `lm_loss` / `forward_loss` wait for the training slice.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import rwkv6 as rwkv_lib
from repro_torch.models.common import ModelConfig, dense_param, rms_norm

__all__ = ["layer_pattern", "plan", "layer_kinds", "LM", "init_params", "backbone",
           "unembed_matrix", "last_logits", "init_decode_state", "decode_step"]


def layer_pattern(cfg: ModelConfig) -> tuple:
    if cfg.family != "rwkv":
        raise NotImplementedError(
            f"not yet ported: the {cfg.family!r} family of {cfg.name}; the port runs "
            "the rwkv family")
    return ("rwkv",)


def plan(cfg: ModelConfig):
    pat = layer_pattern(cfg)
    return pat, cfg.n_layers // len(pat), cfg.n_layers % len(pat)


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """Every layer's kind in order: the groups' pattern repeated, then the tail."""
    pat, n_groups, tail = plan(cfg)
    return [*pat * n_groups, *(pat[i % len(pat)] for i in range(tail))]


class LM(nn.Module):
    """The decoder-only LM's parameters (empty unless ``generator`` is given),
    stored as `repro_torch.models.rwkv6` describes."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        kinds = layer_kinds(cfg)
        d, dt = cfg.d_model, cfg.compute_dtype
        self.embed = dense_param(generator, (cfg.vocab, d), in_axis=1, dtype=dt,
                                 device=device)
        self.layers = nn.ModuleList(
            rwkv_lib.RWKVBlock(cfg, generator, device) for _ in kinds)
        self.final_norm = nn.Parameter(
            torch.zeros((d,), dtype=torch.float32, device=device), requires_grad=False)
        if not cfg.tie_embeddings:
            self.unembed = dense_param(generator, (d, cfg.vocab), dtype=dt, device=device)


def init_params(cfg: ModelConfig, generator, device="cuda") -> LM:
    """An `LM` with weights drawn from ``generator`` (a `torch.Generator` on
    ``device``, or an int seed for one)."""
    device = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=device).manual_seed(generator)
    return LM(cfg, generator, device)


def backbone(model: LM, cfg: ModelConfig, tokens: torch.Tensor, ctx=None) -> torch.Tensor:
    """Token ids (B, S) -> final hidden states (B, S, D)."""
    if ctx is not None:
        raise NotImplementedError("not yet ported: ctx (the vlm / encdec families)")
    x = model.embed[tokens] * cfg.embed_scale
    for layer in model.layers:
        state = rwkv_lib.init_rwkv_state(cfg, x.shape[0], device=x.device)
        x, _ = layer(x, state)
    return rms_norm(x, model.final_norm)


def unembed_matrix(model: LM, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return model.embed.T
    return model.unembed


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 accumulation and output (JAX's
    ``preferred_element_type=float32``).

    On CUDA a low-precision pair goes to one cuBLAS GEMM with an f32 output
    (``torch.mm(..., out_dtype=torch.float32)``).  Elsewhere the operands are
    upcast, which is exact, and multiplied in f32.
    """
    if a.device.type == "cuda" and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.to(torch.float32) @ b.to(torch.float32)


def last_logits(model: LM, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """(B, V) f32 logits of the last position of ``hidden`` (B, S, D)."""
    return _mm_f32(hidden[:, -1].to(cfg.compute_dtype), unembed_matrix(model, cfg))


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      device="cuda") -> list[dict]:
    """Per-layer decode states in layer order (O(1) in ``max_seq`` for rwkv)."""
    device = resolve_device(device)
    return [rwkv_lib.init_rwkv_state(cfg, batch, device=device) for _ in layer_kinds(cfg)]


def decode_step(model: LM, cfg: ModelConfig, state: list[dict], token: torch.Tensor,
                pos, ctx=None):
    """One serve step: token (B, 1) at position ``pos`` (unused by rwkv).

    Returns (logits (B, V) f32, new_state).
    """
    if ctx is not None:
        raise NotImplementedError("not yet ported: ctx (the vlm / encdec families)")
    x = model.embed[token] * cfg.embed_scale
    new_state = []
    for layer, st in zip(model.layers, state, strict=True):
        x, st = layer(x, st)
        new_state.append(st)
    hidden = rms_norm(x, model.final_norm)
    return last_logits(model, cfg, hidden), new_state
