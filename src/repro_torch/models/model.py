"""Unified model API (twin of `repro.models.model`).

  init_params(cfg, generator, device)          -> LM module
  forward_loss(model, cfg, batch, params)      -> scalar loss  (train)
  prefill_logits(model, cfg, batch)            -> (B, V) last-position logits
  init_decode_state(cfg, batch, seq, device)   -> per-layer decode states
  decode_step(model, cfg, state, token, pos)   -> (logits, new state)

`forward_loss` runs the model's own tensors, or ``params`` (the training
step's cast masters; see `repro_torch.models.transformer`).  The dense and
rwkv families run; moe, hybrid, vlm and encdec wait for a later slice and
raise `NotImplementedError` by name (at `init_params` and
`init_decode_state`), and so does a batch with a context (``img``).  Entry
points put new tensors on ``cuda`` unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig

__all__ = ["init_params", "forward_loss", "prefill_logits", "init_decode_state",
           "decode_step"]


def init_params(cfg: ModelConfig, generator, device="cuda"):
    return transformer.init_params(cfg, generator, device=device)


def forward_loss(model, cfg: ModelConfig, batch, params: dict | None = None):
    """The mean next-token cross-entropy of ``batch`` (``tokens`` and
    ``labels``, (B, S)), a scalar f32 tensor."""
    return transformer.forward_loss(model, cfg, batch, params=params)


def prefill_logits(model, cfg: ModelConfig, batch):
    """Inference prefill: full-sequence forward, last-position (B, V) f32 logits."""
    hidden = transformer.backbone(model, cfg, batch["tokens"], ctx=batch.get("img"))
    return transformer.last_logits(model, cfg, hidden)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    return transformer.init_decode_state(cfg, batch, max_seq, device=device)


def decode_step(model, cfg: ModelConfig, state, token, pos, ctx=None):
    """ctx: encoder output (encdec) or image embeddings (vlm); else None."""
    return transformer.decode_step(model, cfg, state, token, pos, ctx=ctx)
