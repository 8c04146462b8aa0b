"""Decoder-only LM assembly for the dense, rwkv, hybrid, moe and vlm
families (twin of `repro.models.transformer`; the encdec family is
`repro_torch.models.whisper`).

The JAX package expands each architecture to a cyclic pattern of layer
kinds and stacks the layers into scanned groups plus a tail; the port keeps
the same plan (`layer_pattern`, `plan`) but holds the layers unstacked, in
order, in an `LM` module:

  LM.embed (V, D), LM.layers [DenseBlock | RGLRUBlock | MoEBlock |
  CrossBlock | RWKVBlock ...], LM.final_norm (D,), LM.unembed (D, V)
  (absent with tied embeddings)

A ``DenseBlock`` (kinds ``"attn"`` and the hybrid family's
``"attn_local"``, whose window is ``local_window``) is JAX's pre-norm
attention layer, ``norm1``, ``attn`` (`repro_torch.models.attention`),
``norm2``, ``ffn`` (`repro_torch.models.ffn`), each residual; an
``RGLRUBlock`` (``"rglru"``) has ``mix`` (`repro_torch.models.rglru`) in
place of ``attn``, an ``MoEBlock`` (``"attn_moe"``) ``moe``
(`repro_torch.models.moe`) in place of ``ffn``, a ``CrossBlock``
(``"cross"``, the vlm family's every ``cross_attn_every``-th layer; the
hybrid family's pattern may name it too) a gated cross-attention over the
context ``ctx`` (the image tokens, (B, T, D)) and no self-attention.  With
no context, a cross layer attends over its own normed input, unmasked, as
JAX's does (``kv_x=None``).  A decode state is the list of the layers'
states, in the same order: an attention layer's KV cache ``{"k", "v"}``
(B, KV, S, hd), sized by the layer's window with a ring cache, which
`decode_step` updates in place; an RG-LRU layer's ``{"conv", "h"}``; an
rwkv layer's O(1) state; a cross layer's empty dict.  Entry points:
`init_params`, `backbone`, `last_logits`, `init_decode_state`,
`decode_step`, and for training `lm_loss` and `forward_loss`.  The
embedding is multiplied by ``embed_scale`` rounded to the compute dtype
first (JAX's weak typing: gemma-2b's sqrt(2048) is 45.25 in bf16).

`backbone` runs each layer through `torch.func.functional_call` on its
slice of a dict of tensors under the `LM`'s parameter names: the model's
own by default (serving, whose `LM` holds its bf16 tensors), or ``params``
(training: the f32 masters as `repro_torch.train.train_step` casts them,
with a template `LM` on the ``meta`` device that holds no memory).  With
``cfg.remat`` and autograd recording, each layer runs under one
non-reentrant `torch.utils.checkpoint` (JAX's ``jax.checkpoint`` of each
scanned group; a group is one layer).  The layer's tensors are
arguments of the checkpointed function, so its recompute in the backward
pass runs on the same tensors.  So serving and training share one set of
modules and one loop (`run_layer`, which `repro_torch.models.whisper`
uses too), and the masters stay f32.
"""
from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint
from torch import nn
from torch.func import functional_call

from repro_torch.device import resolve_device
from repro_torch.models import placed
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import rwkv6 as rwkv_lib
from repro_torch.models.common import ModelConfig, dense_param, rms_norm, scalar
from repro_torch.models.ffn import FFN

__all__ = ["layer_pattern", "plan", "layer_kinds", "DenseBlock", "RGLRUBlock", "MoEBlock",
           "CrossBlock", "LM", "init_params", "norm_param", "embed", "layer_params",
           "model_params", "remat_enabled", "run_layer", "backbone", "unembed_matrix",
           "mm_f32", "last_logits", "lm_loss", "forward_loss", "init_decode_state",
           "decode_step"]


def layer_pattern(cfg: ModelConfig) -> tuple:
    if cfg.family == "hybrid":
        pat = cfg.pattern or ("rglru", "rglru", "attn_local")
        for kind in pat:  # any kind JAX's _init_layer makes
            if kind not in _BLOCKS:
                raise ValueError(f"unknown layer kind {kind!r} in the pattern of {cfg.name}")
        return pat
    if cfg.family == "vlm":
        k = cfg.cross_attn_every or 5
        return tuple("cross" if i == k - 2 else "attn" for i in range(k))
    if cfg.family == "rwkv":
        return ("rwkv",)
    if cfg.family == "moe":
        return ("attn_moe",)
    if cfg.family == "dense":
        return ("attn",)
    if cfg.family == "encdec":
        raise ValueError(f"{cfg.name} is an encoder-decoder: it runs through "
                         "repro_torch.models.whisper (models.model dispatches on the family)")
    raise NotImplementedError(
        f"not yet ported: the {cfg.family!r} family of {cfg.name} (the port runs the dense, "
        "rwkv, hybrid, moe, vlm and encdec families)")


def plan(cfg: ModelConfig):
    pat = layer_pattern(cfg)
    return pat, cfg.n_layers // len(pat), cfg.n_layers % len(pat)


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """Every layer's kind in order: the groups' pattern repeated, then the tail."""
    pat, n_groups, tail = plan(cfg)
    return [*pat * n_groups, *(pat[i % len(pat)] for i in range(tail))]


def norm_param(d: int, device) -> nn.Parameter:
    """A layer norm's scale: (d,) f32 zeros, as JAX's init makes it."""
    return nn.Parameter(torch.zeros((d,), dtype=torch.float32, device=device),
                        requires_grad=False)


class DenseBlock(nn.Module):
    """One attention layer (kind ``"attn"``, or ``"attn_local"`` within
    ``local_window``): pre-norm self-attention and FFN, each residual.  The
    attention reads the config it is called with (a ring cache or a window
    is a config of the same weights)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None, kind: str = "attn"):
        super().__init__()
        self.local = kind == "attn_local"
        self.norm1 = norm_param(cfg.d_model, device)
        self.attn = attn_lib.Attention(cfg, generator, device)
        self.norm2 = norm_param(cfg.d_model, device)
        self.ffn = FFN(cfg, generator, device)

    def window(self, cfg: ModelConfig):
        return cfg.local_window if self.local else None

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
        """x (B, S, D) at ``positions`` (B, S) -> (B, S, D)."""
        h = rms_norm(x, self.norm1)
        x = x + attn_lib.attention(self.attn, cfg, h, positions, layer_window=self.window(cfg))
        return x + self.ffn(rms_norm(x, self.norm2))

    def decode(self, x: torch.Tensor, pos, cache: dict, cfg: ModelConfig):
        """One token x (B, 1, D) at ``pos`` against the layer's KV cache
        (updated in place). Returns (x', cache)."""
        h = rms_norm(x, self.norm1)
        o, cache = attn_lib.decode_attention(self.attn, cfg, h, cache, pos,
                                             layer_window=self.window(cfg))
        x = x + o
        return x + self.ffn(rms_norm(x, self.norm2)), cache


class RGLRUBlock(nn.Module):
    """One recurrent layer (kind ``"rglru"``): pre-norm RG-LRU block and FFN,
    each residual."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.norm1 = norm_param(cfg.d_model, device)
        self.mix = rglru_lib.init_rglru(cfg, generator, device)
        self.norm2 = norm_param(cfg.d_model, device)
        self.ffn = FFN(cfg, generator, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
        """x (B, S, D) -> (B, S, D): the scan from a zero state."""
        return self.decode(x, None, None, cfg)[0]

    def decode(self, x: torch.Tensor, pos, state: dict | None, cfg: ModelConfig):
        """x (B, S, D) from ``state`` (``{"conv", "h"}``, one token a step;
        None: the scan from zero). Returns (x', new state)."""
        o, state = rglru_lib.rglru_block(self.mix, cfg, rms_norm(x, self.norm1), state)
        x = x + o
        return x + self.ffn(rms_norm(x, self.norm2)), state


class MoEBlock(nn.Module):
    """One MoE layer (kind ``"attn_moe"``): pre-norm self-attention and the
    MoE FFN, each residual."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.norm1 = norm_param(cfg.d_model, device)
        self.attn = attn_lib.Attention(cfg, generator, device)
        self.norm2 = norm_param(cfg.d_model, device)
        self.moe = moe_lib.init_moe(cfg, generator, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
        h = rms_norm(x, self.norm1)
        x = x + attn_lib.attention(self.attn, cfg, h, positions)
        return x + moe_lib.moe_ffn(self.moe, cfg, rms_norm(x, self.norm2))

    def decode(self, x: torch.Tensor, pos, cache: dict, cfg: ModelConfig):
        h = rms_norm(x, self.norm1)
        o, cache = attn_lib.decode_attention(self.attn, cfg, h, cache, pos)
        x = x + o
        return x + moe_lib.moe_ffn(self.moe, cfg, rms_norm(x, self.norm2)), cache


class CrossBlock(nn.Module):
    """One gated cross-attention layer (kind ``"cross"``): pre-norm
    cross-attention over the context (a ``gate``d `Attention`, zero at
    init) and FFN, each residual; no self-attention, so no decode state."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.norm1 = norm_param(cfg.d_model, device)
        self.attn = attn_lib.Attention(cfg, generator, device, cross=True)
        self.norm2 = norm_param(cfg.d_model, device)
        self.ffn = FFN(cfg, generator, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                ctx: torch.Tensor | None = None) -> torch.Tensor:
        """x (B, S, D) over ``ctx`` (B, T, D); None: over the normed x."""
        h = rms_norm(x, self.norm1)
        x = x + attn_lib.cross_attention(self.attn, cfg, h, ctx, gated=True)
        return x + self.ffn(rms_norm(x, self.norm2))

    def decode(self, x: torch.Tensor, pos, state: dict, cfg: ModelConfig,
               ctx: torch.Tensor | None = None):
        """One token: the same layer (its context is whole at every step)."""
        return self.forward(x, None, cfg, ctx), state


_BLOCKS = {"attn": DenseBlock, "attn_local": functools.partial(DenseBlock, kind="attn_local"),
           "rglru": RGLRUBlock, "attn_moe": MoEBlock, "cross": CrossBlock,
           "rwkv": rwkv_lib.RWKVBlock}


class LM(nn.Module):
    """The decoder-only LM's parameters (empty unless ``generator`` is given),
    stored as the blocks above and `repro_torch.models.rwkv6` describe."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        kinds = layer_kinds(cfg)
        d, dt = cfg.d_model, cfg.compute_dtype
        self.embed = dense_param(generator, (cfg.vocab, d), in_axis=1, dtype=dt,
                                 device=device)
        self.layers = nn.ModuleList(_BLOCKS[kind](cfg, generator, device) for kind in kinds)
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


def layer_params(params: dict, prefix: str, layer: nn.Module) -> dict:
    """``layer``'s tensors in ``params``, found under ``prefix`` + its names."""
    return {name: params[prefix + name] for name, _ in layer.named_parameters()}


def model_params(model: nn.Module, params: dict | None) -> dict:
    """``params``, or by default the model's own tensors under their names."""
    return dict(model.named_parameters()) if params is None else params


def remat_enabled(cfg: ModelConfig, params: dict) -> bool:
    """Whether the layers recompute in the backward pass: ``cfg.remat``,
    autograd recording and a tensor of ``params`` requiring grad."""
    remat = (cfg.remat and torch.is_grad_enabled()
             and any(p.requires_grad for p in params.values()))
    if remat and cfg.remat_policy != "full":
        raise NotImplementedError(
            f"not yet ported: remat_policy={cfg.remat_policy!r} (the port recomputes "
            "whole layers, remat_policy='full')")
    return remat


def run_layer(run, x: torch.Tensor, lp: dict, remat: bool) -> torch.Tensor:
    """``run(x, lp)``: under one non-reentrant checkpoint with ``remat``."""
    if remat:
        return torch.utils.checkpoint.checkpoint(run, x, lp, use_reentrant=False)
    return run(x, lp)


def embed(table: torch.Tensor, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens`` in the compute dtype times
    ``embed_scale`` rounded to it (JAX's weak typing)."""
    x = placed.embed_rows(table, tokens) if placed.is_dtensor(table) else table[tokens]
    x = x.to(cfg.compute_dtype)
    if cfg.embed_scale != 1.0:
        x = x * scalar(cfg.embed_scale, cfg.compute_dtype)
    return x


def backbone(model: LM, cfg: ModelConfig, tokens: torch.Tensor, ctx=None,
             params: dict | None = None) -> torch.Tensor:
    """Token ids (B, S) -> final hidden states (B, S, D).

    Each layer runs through `functional_call` on its slice of ``params``
    (training: tensors under the model's parameter names; by default the
    model's own) and, with ``cfg.remat`` where autograd records, under one
    checkpoint a layer.  ``ctx`` (B, T, D) is the cross layers' context.
    """
    params = model_params(model, params)
    remat = remat_enabled(cfg, params)
    x = embed(params["embed"], cfg, tokens)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    for n, (layer, kind) in enumerate(zip(model.layers, layer_kinds(cfg), strict=True)):
        if kind == "rwkv":
            def run(x, lp, layer=layer):
                state = rwkv_lib.init_rwkv_state(cfg, x.shape[0], device=x.device)
                return functional_call(layer, lp, (x, state))[0]
        elif kind == "cross":
            def run(x, lp, layer=layer):
                return functional_call(layer, lp, (x, positions, cfg, ctx))
        else:
            def run(x, lp, layer=layer):
                return functional_call(layer, lp, (x, positions, cfg))

        x = run_layer(run, x, layer_params(params, f"layers.{n}.", layer), remat)
    return rms_norm(x, params["final_norm"])


def unembed_matrix(model: LM, cfg: ModelConfig, params: dict | None = None) -> torch.Tensor:
    if params is None:
        params = dict(model.named_parameters(recurse=False))
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


class _MmF32(torch.autograd.Function):
    """One cuBLAS GEMM of a low-precision pair with an f32 output, and its
    gradient: the f32 output gradient rounded to the operands' dtype, then
    one GEMM (f32 accumulation) an operand, so each cotangent has its
    operand's dtype, as JAX's transpose of a ``preferred_element_type=f32``
    dot gives it."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return g @ b.T, a.T @ g


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 accumulation and output (JAX's
    ``preferred_element_type=float32``).

    On CUDA a low-precision pair goes to one cuBLAS GEMM with an f32 output
    (`_MmF32`; under ``no_grad`` it records nothing).  Elsewhere the
    operands are upcast, which is exact, and multiplied in f32; autograd
    then gives each operand's cotangent in f32, rounded to its dtype by the
    upcast's gradient (JAX on the CPU).  On DTensors (a placed model) each
    rank multiplies its blocks (`placed.mm_local`: DTensor has no rule
    for an ``out_dtype`` product), on either device.
    """
    if placed.is_dtensor(a) or placed.is_dtensor(b):
        return placed.mm_local(mm_f32, a, b)
    if a.device.type == "cuda" and a.dtype in (torch.bfloat16, torch.float16):
        return _MmF32.apply(a, b)
    return a.to(torch.float32) @ b.to(torch.float32)


def last_logits(model: LM, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """(B, V) f32 logits of the last position of ``hidden`` (B, S, D)."""
    return mm_f32(hidden[:, -1].to(cfg.compute_dtype), unembed_matrix(model, cfg))


def lm_loss(model: LM, cfg: ModelConfig, hidden: torch.Tensor, labels: torch.Tensor,
            params: dict | None = None) -> torch.Tensor:
    """Chunked-softmax cross-entropy: the mean over every position of
    ``logsumexp(logits) - logits[label]``, never materialising (B, S, V).

    Operands in the compute dtype, logits f32 (`mm_f32`), ``logit_chunk``
    positions at a time, the chunks' sums added in order, as the JAX code.
    """
    b, s, d = hidden.shape
    w = unembed_matrix(model, cfg, params).to(cfg.compute_dtype)
    chunk = min(cfg.logit_chunk or s, s)
    n = (s + chunk - 1) // chunk
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = 0
    for i in range(n):
        h = hidden[:, i * chunk:(i + 1) * chunk].to(cfg.compute_dtype)
        y = labels[:, i * chunk:(i + 1) * chunk].to(torch.int64)
        logits = mm_f32(h.reshape(-1, d), w).reshape(*h.shape[:2], -1)
        lse = torch.logsumexp(logits, dim=-1)
        if placed.is_dtensor(logits):
            gold = placed.pick_last(logits, y)
        else:
            gold = torch.gather(logits, -1, y[..., None])[..., 0]
        total = total + torch.sum(lse - gold)
        count += y.numel()
    return total / count


def forward_loss(model: LM, cfg: ModelConfig, batch, params: dict | None = None):
    """The training loss of ``batch`` (``tokens``, ``labels`` (B, S), and
    for the vlm family optionally ``img`` (B, T, D), the cross layers'
    context): a scalar f32 tensor; see `backbone` for ``params``."""
    ctx = batch.get("img") if isinstance(batch, dict) else None
    hidden = backbone(model, cfg, batch["tokens"], ctx=ctx, params=params)
    return lm_loss(model, cfg, hidden, batch["labels"], params=params)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      device="cuda") -> list[dict]:
    """Per-layer decode states in layer order: an attention layer's KV
    cache (`repro_torch.models.attention.init_kv_cache`; a ring is sized by
    the layer's window, ``local_window`` for ``attn_local``), an RG-LRU
    layer's ``conv`` (B, W-1, lru) and ``h`` (B, lru) f32, an rwkv layer's
    O(1) state, and a cross layer's empty dict: JAX allocates a full KV
    cache for each cross layer and never writes it (its decode recomputes
    the cross K/V from the context every step), so the port holds none."""
    device = resolve_device(device)

    def one(kind):
        if kind == "cross":
            return {}
        if kind == "rwkv":
            return rwkv_lib.init_rwkv_state(cfg, batch, device=device)
        if kind == "rglru":
            return rglru_lib.init_rglru_state(cfg, batch, device=device)
        window = cfg.local_window if kind == "attn_local" else None
        return attn_lib.init_kv_cache(cfg, batch, max_seq, device=device, layer_window=window)

    return [one(kind) for kind in layer_kinds(cfg)]


def decode_step(model: LM, cfg: ModelConfig, state: list[dict], token: torch.Tensor,
                pos, ctx=None):
    """One serve step: token (B, 1) at position ``pos`` (an int or a 0-d
    tensor; unused by rwkv and RG-LRU layers).  Attention layers write
    their KV caches in place; cross layers attend over ``ctx`` (B, T, D),
    their K/V projected from it anew every step, as JAX's do.

    Returns (logits (B, V) f32, new_state).
    """
    x = embed(model.embed, cfg, token)
    new_state = []
    for layer, kind, st in zip(model.layers, layer_kinds(cfg), state, strict=True):
        if kind == "rwkv":
            x, st = layer(x, st)
        elif kind == "cross":
            x, st = layer.decode(x, pos, st, cfg, ctx)
        else:
            x, st = layer.decode(x, pos, st, cfg)
        new_state.append(st)
    hidden = rms_norm(x, model.final_norm)
    return last_logits(model, cfg, hidden), new_state
