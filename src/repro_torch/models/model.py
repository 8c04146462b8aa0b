"""Unified model API: family dispatch (twin of `repro.models.model`).

  init_params(cfg, generator, device)               -> LM / WhisperLM module
  forward_loss(model, cfg, batch, params)           -> scalar loss  (train)
  prefill_logits(model, cfg, batch)                 -> (B, V) last-position logits
  init_decode_state(cfg, batch, seq, device)        -> per-layer decode states
  decode_step(model, cfg, state, token, pos, ctx)   -> (logits, new state)

The encdec family (whisper) runs `repro_torch.models.whisper`, every other
family `repro_torch.models.transformer`.  A batch carries the context by
name: ``frames`` (B, enc_seq, D) for encdec, optionally ``img`` (B,
img_tokens, D) for vlm (without it the cross layers attend over their own
input, as JAX's do); `decode_step`'s ``ctx`` is the encoder output
(`whisper.encode`) or the image tokens.  `forward_loss` runs the model's
own tensors, or ``params`` (the training step's cast masters; see
`repro_torch.models.transformer`).  A model placed as DTensors
(`repro_torch.launch.sharding.place_module` under ``param_shardings``, its
batch under ``batch_shardings`` and its decode state under
``decode_state_shardings``) runs the same entry points under DTensor's
rules (`repro_torch.models.placed`); the tensors the model makes inside
count as replicated, and the caller's batch, decode state and token must be
placed (a plain one raises ValueError).  Entry
points put new tensors on ``cuda`` unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

from repro_torch.models import placed
from repro_torch.models import transformer, whisper
from repro_torch.models.common import ModelConfig

__all__ = ["model_class", "init_params", "forward_loss", "prefill_logits", "init_decode_state",
           "decode_step"]


def model_class(cfg: ModelConfig):
    """The family's module: `whisper.WhisperLM` for encdec, else
    `transformer.LM` (``model_class(cfg)(cfg, None, "meta")`` is an empty
    template)."""
    return whisper.WhisperLM if cfg.family == "encdec" else transformer.LM


def init_params(cfg: ModelConfig, generator, device="cuda"):
    if cfg.family == "encdec":
        return whisper.init_params(cfg, generator, device=device)
    return transformer.init_params(cfg, generator, device=device)


def forward_loss(model, cfg: ModelConfig, batch, params: dict | None = None):
    """The mean next-token cross-entropy of ``batch`` (``tokens`` and
    ``labels``, (B, S), and the family's context), a scalar f32 tensor."""
    with placed.implicit(model, params, inputs=batch):
        if cfg.family == "encdec":
            return whisper.forward_loss(model, cfg, batch, params=params)
        return transformer.forward_loss(model, cfg, batch, params=params)


def prefill_logits(model, cfg: ModelConfig, batch):
    """Inference prefill: full-sequence forward, last-position (B, V) f32 logits."""
    with placed.implicit(model, inputs=batch):
        if cfg.family == "encdec":
            return whisper.prefill_logits(model, cfg, batch)
        hidden = transformer.backbone(model, cfg, batch["tokens"], ctx=batch.get("img"))
        return transformer.last_logits(model, cfg, hidden)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    if cfg.family == "encdec":
        return whisper.init_decode_state(cfg, batch, max_seq, device=device)
    return transformer.init_decode_state(cfg, batch, max_seq, device=device)


def decode_step(model, cfg: ModelConfig, state, token, pos, ctx=None):
    """ctx: encoder output (encdec, required) or image embeddings (vlm); else None."""
    if cfg.family == "encdec":
        if ctx is None:
            raise ValueError(f"{cfg.name}: decode_step needs ctx, the encoder output "
                             "(whisper.encode of the frames)")
        with placed.implicit(model, inputs=(state, token, ctx)):
            return whisper.decode_step(model, cfg, state, token, pos, ctx)
    with placed.implicit(model, inputs=(state, token, ctx)):
        return transformer.decode_step(model, cfg, state, token, pos, ctx=ctx)
