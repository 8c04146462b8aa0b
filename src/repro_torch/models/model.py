"""Unified model API, the serving subset (twin of `repro.models.model`).

  init_params(cfg, generator, device)          -> LM module
  prefill_logits(model, cfg, batch)            -> (B, V) last-position logits
  init_decode_state(cfg, batch, seq, device)   -> per-layer decode states
  decode_step(model, cfg, state, token, pos)   -> (logits, new state)

`forward_loss` (training) and every family but rwkv (encdec included) wait
for a later slice and raise `NotImplementedError` (a family at
`init_params` and `init_decode_state`).  Entry points put new tensors on ``cuda``
unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig

__all__ = ["init_params", "forward_loss", "prefill_logits", "init_decode_state",
           "decode_step"]


def init_params(cfg: ModelConfig, generator, device="cuda"):
    return transformer.init_params(cfg, generator, device=device)


def forward_loss(model, cfg: ModelConfig, batch):
    raise NotImplementedError(
        "not yet ported: forward_loss (training waits for a later slice)")


def prefill_logits(model, cfg: ModelConfig, batch):
    """Inference prefill: full-sequence forward, last-position (B, V) f32 logits."""
    hidden = transformer.backbone(model, cfg, batch["tokens"], ctx=batch.get("img"))
    return transformer.last_logits(model, cfg, hidden)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    return transformer.init_decode_state(cfg, batch, max_seq, device=device)


def decode_step(model, cfg: ModelConfig, state, token, pos, ctx=None):
    """ctx: encoder output (encdec) or image embeddings (vlm); else None."""
    return transformer.decode_step(model, cfg, state, token, pos, ctx=ctx)
