"""Whisper-style encoder-decoder backbone (twin of `repro.models.whisper`,
arXiv:2212.04356).

The conv frontend is a stub, as in the JAX package: the caller passes
precomputed frame embeddings ``frames`` (B, enc_seq, D), where the two
stride-2 conv1d layers would map 30 s of log-mel (3000 frames) to 1500
positions.  whisper-medium's "24L" is 24 encoder and 24 decoder layers.

Encoder: the frames plus the sinusoid table in the compute dtype, then
bidirectional self-attention (`attention.attend_full` with
``causal=False``, no RoPE) and the GELU MLP, pre-norm, and a last RMS norm
``enc_norm``.  Decoder: causal self-attention with RoPE (as the JAX code
has it; KV-cached for serving), cross-attention over the encoder output
(ungated) and the GELU MLP, each pre-norm and residual.

A `WhisperLM` holds JAX's tree with the stacked layers unstacked:

  enc [EncoderLayer: norm1, attn, norm2, ffn] x enc_layers, enc_norm (D,),
  dec [DecoderLayer: norm1, self, norm2, cross, norm3, ffn] x n_layers,
  embed (V, D), final_norm (D,), unembed (D, V)

Each layer runs through `torch.func.functional_call` on its slice of a
dict of tensors, under one checkpoint with ``cfg.remat`` where autograd
records (`repro_torch.models.transformer.run_layer`), so serving runs the
module's own tensors and training the cast f32 masters, as the decoder-only
LM does.  A decode state is the decoder layers' KV caches; `decode_step`
recomputes each layer's cross K/V from ``enc_out`` every step, as JAX's
does (its docstring names caching them once a request as the optimisation
it leaves out).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import placed
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig, dense_param, rms_norm, sinusoid_positions
from repro_torch.models.ffn import FFN

__all__ = ["EncoderLayer", "DecoderLayer", "WhisperLM", "init_params", "encode", "decoder",
           "forward_loss", "prefill_logits", "init_decode_state", "decode_step"]


class EncoderLayer(nn.Module):
    """Pre-norm bidirectional self-attention (no RoPE, no mask) and MLP."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.norm1 = tf.norm_param(cfg.d_model, device)
        self.attn = attn_lib.Attention(cfg, generator, device)
        self.norm2 = tf.norm_param(cfg.d_model, device)
        self.ffn = FFN(cfg, generator, device)

    def forward(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        h = rms_norm(x, self.norm1)
        q, k, v = attn_lib.project_qkv(self.attn, cfg, h)
        ctx = attn_lib.attend(q, k, v, cfg, causal=False)
        x = placed.residual(x, torch.einsum("bshk,hkd->bsd", ctx,
                                            self.attn.wo.to(cfg.compute_dtype)))
        return placed.residual(x, self.ffn(rms_norm(x, self.norm2)))


class DecoderLayer(nn.Module):
    """Pre-norm causal self-attention with RoPE, cross-attention over the
    encoder output, and MLP."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.norm1 = tf.norm_param(cfg.d_model, device)
        self.self = attn_lib.Attention(cfg, generator, device)
        self.norm2 = tf.norm_param(cfg.d_model, device)
        self.cross = attn_lib.Attention(cfg, generator, device)
        self.norm3 = tf.norm_param(cfg.d_model, device)
        self.ffn = FFN(cfg, generator, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                enc_out: torch.Tensor) -> torch.Tensor:
        h = rms_norm(x, self.norm1)
        x = placed.residual(x, attn_lib.attention(self.self, cfg, h, positions))
        return self._cross_and_ffn(x, cfg, enc_out)

    def _cross_and_ffn(self, x, cfg, enc_out):
        h = rms_norm(x, self.norm2)
        x = placed.residual(x, attn_lib.cross_attention(self.cross, cfg, h, enc_out))
        return placed.residual(x, self.ffn(rms_norm(x, self.norm3)))

    def decode(self, x: torch.Tensor, pos, cache: dict, cfg: ModelConfig,
               enc_out: torch.Tensor):
        """One token x (B, 1, D) at ``pos`` against the layer's KV cache
        (updated in place), the cross K/V projected from ``enc_out`` anew.
        Returns (x', cache)."""
        h = rms_norm(x, self.norm1)
        o, cache = attn_lib.decode_attention(self.self, cfg, h, cache, pos)
        return self._cross_and_ffn(placed.residual(x, o), cfg, enc_out), cache


class WhisperLM(nn.Module):
    """The encoder-decoder's parameters (empty unless ``generator`` is
    given), JAX's tree with its stacked layers unstacked (module docstring)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.compute_dtype
        self.enc = nn.ModuleList(EncoderLayer(cfg, generator, device)
                                 for _ in range(cfg.enc_layers))
        self.enc_norm = tf.norm_param(d, device)
        self.dec = nn.ModuleList(DecoderLayer(cfg, generator, device)
                                 for _ in range(cfg.n_layers))
        self.embed = dense_param(generator, (cfg.vocab, d), in_axis=1, dtype=dt, device=device)
        self.final_norm = tf.norm_param(d, device)
        self.unembed = dense_param(generator, (d, cfg.vocab), dtype=dt, device=device)


def init_params(cfg: ModelConfig, generator, device="cuda") -> WhisperLM:
    """A `WhisperLM` with weights drawn from ``generator`` (a
    `torch.Generator` on ``device``, or an int seed for one); on ``meta``,
    shapes only."""
    device = resolve_device(device)
    return WhisperLM(cfg, tf.generator_for(generator, device), device)


def encode(model: WhisperLM, cfg: ModelConfig, frames: torch.Tensor,
           params: dict | None = None) -> torch.Tensor:
    """frames (B, enc_seq, D) stub embeddings -> encoder states (B, enc_seq,
    D) in the compute dtype; see `repro_torch.models.transformer.backbone`
    for ``params``."""
    params = tf.model_params(model, params)
    remat = tf.remat_enabled(cfg, params) and "full"  # JAX's whisper: whole layers
    dt = cfg.compute_dtype
    x = frames.to(dt) + sinusoid_positions(frames.shape[1], cfg.d_model,
                                           device=frames.device).to(dt)
    for n, layer in enumerate(model.enc):
        def run(x, lp, layer=layer):
            return functional_call(layer, lp, (x, cfg))

        x = tf.run_layer(run, placed.rows(x, frames), tf.layer_params(params, f"enc.{n}.", layer),
                         remat)
    return rms_norm(placed.rows(x, frames), params["enc_norm"])


def decoder(model: WhisperLM, cfg: ModelConfig, tokens: torch.Tensor, enc_out: torch.Tensor,
            params: dict | None = None) -> torch.Tensor:
    """Token ids (B, S) over ``enc_out`` -> the decoder's final hidden
    states (B, S, D)."""
    params = tf.model_params(model, params)
    remat = tf.remat_enabled(cfg, params) and "full"
    x = tf.embed(params["embed"], cfg, tokens)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    for n, layer in enumerate(model.dec):
        def run(x, lp, layer=layer):
            return functional_call(layer, lp, (x, positions, cfg, enc_out))

        x = tf.run_layer(run, placed.rows(x, tokens), tf.layer_params(params, f"dec.{n}.", layer),
                         remat)
    return rms_norm(placed.rows(x, tokens), params["final_norm"])


def forward_loss(model: WhisperLM, cfg: ModelConfig, batch, params: dict | None = None):
    """The mean next-token cross-entropy of ``batch`` (``frames`` (B,
    enc_seq, D), ``tokens`` and ``labels`` (B, S)): a scalar f32 tensor."""
    enc_out = encode(model, cfg, batch["frames"], params)
    hidden = decoder(model, cfg, batch["tokens"], enc_out, params)
    return tf.lm_loss(model, cfg, hidden, batch["labels"], params=params)


def prefill_logits(model: WhisperLM, cfg: ModelConfig, batch) -> torch.Tensor:
    """The encdec branch of JAX's ``prefill_logits``: encode ``frames``,
    run the decoder over ``tokens``, (B, V) f32 logits of the last position."""
    enc_out = encode(model, cfg, batch["frames"])
    return tf.last_logits(model, cfg, decoder(model, cfg, batch["tokens"], enc_out))


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, device="cuda") -> list[dict]:
    """The decoder layers' KV caches ``{"k", "v"}`` (B, KV, max_seq, hd)."""
    device = resolve_device(device)
    return [attn_lib.init_kv_cache(cfg, batch, max_seq, device=device)
            for _ in range(cfg.n_layers)]


def decode_step(model: WhisperLM, cfg: ModelConfig, state: list[dict], token: torch.Tensor,
                pos, enc_out: torch.Tensor):
    """One decoder token (B, 1) at ``pos`` against the cached self-attention
    K/V (written in place) and the cross K/V recomputed from ``enc_out``.
    Returns (logits (B, V) f32, new_state)."""
    x = tf.embed(model.embed, cfg, token)
    new_state = []
    for layer, cache in zip(model.dec, state, strict=True):
        x, cache = layer.decode(placed.rows(x, token), pos, cache, cfg, enc_out)
        new_state.append(cache)
    return tf.last_logits(model, cfg, rms_norm(placed.rows(x, token), model.final_norm)), new_state
