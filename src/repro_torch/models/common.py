"""Shared model pieces: the config, its parameter count, RMS norm, RoPE,
the sinusoid table, JAX's sigmoid and SiLU, and the dense initializer (twin of
`repro.models.common`).

`ModelConfig` has the JAX package's fields that the port reads, with
their names and defaults; `compute_dtype` is a torch dtype.  `dense_init`
draws from an explicit `torch.Generator` (`dense_param` wraps it as a
frozen parameter), so a model is made from a seed on any device; its
numbers differ from ``jax.random``'s, and parity tests carry the JAX
package's weights over (`repro_torch.carry.lm_params_from_reference`)
instead.  `scalar` rounds a Python constant to a tensor's dtype first, as
JAX's weak typing does (``x_bf16 * 0.0884`` multiplies by the bf16 value).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

__all__ = ["ModelConfig", "param_count", "is_cross_layer", "rms_norm", "rope_freqs", "apply_rope",
           "sinusoid_positions", "scalar", "sigmoid", "silu", "dense_init", "dense_param"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description (one instance per arch in `repro_torch.configs`).

    The fields the port reads, each with the JAX config's name and default.
    The dense family reads the head fields (``n_kv_heads`` below
    ``n_heads`` is GQA, 1 is MQA), ``act`` (the FFN: ``silu`` / ``geglu``
    gated, ``relu2`` plain), ``qk_norm``, ``rope_theta``, ``swa_window``
    (0: full causal), ``attn_chunk`` (0: dense scores; else the chunked
    online softmax past that length) and ``ring_cache`` (a windowed
    decode cache of ``swa_window`` slots).  RWKV-6 heads are 64 wide
    whatever the head fields say.  The hybrid family reads ``pattern``
    (its cyclic layer kinds), ``lru_width`` (0: ``d_model``),
    ``conv1d_width`` and ``local_window`` (the ``attn_local`` layers'
    window, and their ring's length); the moe family ``n_experts``,
    ``top_k``, ``capacity_factor`` and ``renorm_gates``
    (`repro_torch.models.moe`); ``moe_token_stationary=True`` pins the
    (E, C, .) tensors' capacity axis to 'data' on a placed model (a
    placement, no change of value).  The encdec
    family (whisper) reads ``enc_layers`` (its encoder's depth; ``n_layers``
    is the decoder's) and ``enc_seq`` (the frames' length); the vlm family
    ``cross_attn_every`` (layer ``i`` is a gated cross-attention layer
    where ``i % k == k - 2``) and ``img_tokens`` (the image context's
    length).  A serving `LM` stores its weights in
    ``dtype``; training keeps f32 masters (``param_dtype``) and casts them
    once a step (`repro_torch.train.train_step`).  ``remat`` recomputes
    each layer in the backward pass (``remat_policy="full"``; ``"dots"``
    keeps the products without batch dims, as JAX's policy of that name),
    and the loss runs its softmax over
    ``logit_chunk`` positions at a time.
    """

    name: str
    family: str  # dense | moe | hybrid | rwkv | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "silu"  # silu | geglu (gated) | relu2 | gelu | relu (plain)
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    renorm_gates: bool = True
    moe_token_stationary: bool = False  # capacity axis on 'data' (a placed model)
    swa_window: int = 0  # sliding-window size; 0 = full causal
    attn_chunk: int = 0  # 0 = dense scores; else chunked online softmax
    ring_cache: bool = False  # windowed decode: ring-buffer KV (W slots) vs full S
    # --- hybrid (RG-LRU / Griffin) ---
    pattern: tuple = ()  # cyclic layer pattern, e.g. ("rglru", "rglru", "attn_local")
    lru_width: int = 0
    conv1d_width: int = 4
    local_window: int = 2048  # hybrid local-attention window
    # --- enc-dec (whisper) ---
    enc_layers: int = 0
    enc_seq: int = 1500  # precomputed frame embeddings (stub frontend)
    # --- vlm ---
    cross_attn_every: int = 0  # every k-th layer is cross-attn (0 = none)
    img_tokens: int = 0
    dtype: str = "bfloat16"  # matmul/activation dtype (a serving LM's weights too)
    param_dtype: str = "float32"  # master weights (training)
    remat: bool = True
    remat_policy: str = "full"  # full (recompute all) | dots (save the no-batch products)
    logit_chunk: int = 512  # CE computed in seq chunks of this size
    tie_embeddings: bool = False
    embed_scale: float = 1.0  # sqrt(d_model) for the gemma family

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def n_params(self) -> int:
        """Total parameter count (analytic)."""
        return param_count(self)

    @property
    def n_active_params(self) -> int:
        """Active-per-token parameters (MoE: only the routed experts)."""
        return param_count(self, active_only=True)


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """The JAX package's analytic parameter count, its formula word for word.

    It is not always what the model holds: for rwkv it leaves out the nine
    d-vectors a layer of lerp weights, ``w0`` and ``ln_scale``; for the
    hybrid family it counts every layer whose kind is not ``"attn"`` as a
    recurrent one, so recurrentgemma's ``attn_local`` layers count as
    RG-LRU layers, and it leaves out ``lam`` (9,975,459,840 at full size
    against the 9,396,408,320 the model holds); for the vlm family it
    counts each cross layer's gate as ``d`` where the gate holds 1
    (9,775,190,016 against 9,775,157,256 for llama-3.2-vision-11b); for
    encdec it leaves out ``enc_norm`` (810,986,496 against 810,987,520 for
    whisper-medium)."""
    d = cfg.d_model
    hd = cfg.head_dim
    attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d
    if cfg.qk_norm:
        attn += 2 * hd
    gated = cfg.act in ("silu", "gelu_glu", "geglu", "swiglu")
    dense_ffn = (3 if gated else 2) * d * cfg.d_ff
    per_layer_norms = 2 * d
    if cfg.family == "dense":
        out = cfg.n_layers * (attn + dense_ffn + per_layer_norms)
    elif cfg.family == "rwkv":
        tm = 5 * d * d + 2 * d * 64 + d  # time-mix: r,k,v,g,o + decay lora + bonus u
        cm = 2 * d * cfg.d_ff + d * d  # channel-mix k/v + receptance gate
        out = cfg.n_layers * (tm + cm + per_layer_norms)
    elif cfg.family == "moe":
        e_used = cfg.top_k if active_only else cfg.n_experts
        ffn = e_used * (3 * d * cfg.d_ff) + d * cfg.n_experts
        out = cfg.n_layers * (attn + ffn + per_layer_norms)
    elif cfg.family == "hybrid":
        n_attn = sum(1 for i in range(cfg.n_layers) if _hybrid_kind(cfg, i) == "attn")
        n_rec = cfg.n_layers - n_attn
        lru = cfg.lru_width or d
        rec = 2 * d * lru + lru * cfg.conv1d_width + 3 * lru + lru * d + 2 * lru * lru
        out = n_attn * (attn + dense_ffn + per_layer_norms) + n_rec * (
            rec + dense_ffn + per_layer_norms)
    elif cfg.family == "encdec":
        enc = cfg.enc_layers * (attn + dense_ffn + per_layer_norms)
        dec = cfg.n_layers * (2 * attn + dense_ffn + 3 * d)
        out = enc + dec
    elif cfg.family == "vlm":
        n_cross = sum(1 for i in range(cfg.n_layers) if is_cross_layer(cfg, i))
        out = (cfg.n_layers - n_cross) * (attn + dense_ffn + per_layer_norms) + n_cross * (
            attn + dense_ffn + per_layer_norms + d)  # gate
    else:
        raise NotImplementedError(f"not yet ported: param_count of the {cfg.family!r} family")
    out += cfg.vocab * d + d  # embedding + final norm
    if not cfg.tie_embeddings:
        out += cfg.vocab * d  # untied unembed
    return out


def _hybrid_kind(cfg: ModelConfig, i: int) -> str:
    return cfg.pattern[i % len(cfg.pattern)] if cfg.pattern else "attn"


def is_cross_layer(cfg: ModelConfig, i: int) -> bool:
    """Llama-3.2-Vision style: cross-attention at layers 3, 8, 13, ...
    (``i % k == k - 2`` for ``k = cross_attn_every``; 0: none)."""
    k = cfg.cross_attn_every
    return bool(k) and (i % k == k - 2)


def scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: the constant JAX multiplies by when a
    weakly typed Python float meets an array of that dtype."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32 with a ``1 + scale`` gain, cast back to ``x.dtype``."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


@functools.lru_cache(maxsize=32)
def _rope_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):  # a plain tensor, whatever mode fills the cache
        exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
        return (1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exps)).to(device)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim / 2,) f32 inverse frequencies ``1 / theta^(2i / head_dim)``,
    computed on the host once a device and cached (the same values on every
    device; no copy to the card a call)."""
    return _rope_freqs(head_dim, float(theta), torch.device(device or "cpu"))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x`` (..., S, n, head_dim) at ``positions``
    (..., S), in f32 and cast back: the head is split into halves (not
    interleaved pairs), ``[x1 cos - x2 sin, x2 cos + x1 sin]``."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    ang = positions[..., :, None, None].to(torch.float32) * freqs  # (..., S, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoid_positions(n: int, d: int, device=None) -> torch.Tensor:
    """The classic transformer's sinusoidal table (the whisper encoder's
    positions): (n, d) f32, ``[sin(ang), cos(ang)]`` with ``ang = pos /
    10000^(2i / d)``, op for op as JAX's (``pow`` of an f32 exponent, then
    the division).  ``sin`` / ``cos`` of angles up to n - 1 rad may differ
    from XLA's by an ulp (tests/test_torch_encdec.py states the gap)."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10_000.0, dtype=torch.float32, device=device), dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class _Logistic(torch.autograd.Function):
    """``jax.nn.sigmoid``: forward as XLA lowers it, gradient by JAX's rule."""

    @staticmethod
    def forward(ctx, x):
        s = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1.0 - s))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as it lowers: ``1 / (1 + exp(-x))``, each op in
    ``x``'s dtype (in bf16 it rounds three times; ``torch.sigmoid`` once);
    its gradient is ``logistic``'s JVP rule, ``g * (s * (1 - s))``, each op
    in the dtype too."""
    return _Logistic.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)`` with `sigmoid` above."""
    return x * sigmoid(x)


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
