"""Self-attention: GQA / MQA, qk-norm, a sliding window, the chunked
online softmax and KV-cache decode (twin of `repro.models.attention`).

Conventions, as in the JAX code: x (B, S, D); q (B, S, H, hd); k, v
(B, S, KV, hd); a layer's cache k, v (B, KV, S, hd), or (B, KV, W, hd) as a
ring of W slots (``cfg.ring_cache``), W the layer's window.  A layer's
window is ``swa_window`` unless the caller passes ``layer_window`` (the
hybrid family's ``attn_local`` layers pass ``local_window``).  GQA groups the
query heads as ``(b, s, kv, h // kv, hd)``: head ``i`` reads kv head
``i // (h // kv)``.

Attention is the plain products and an f32 softmax, op for op as the JAX
code computes it outside any Pallas kernel: scores in the compute dtype
times ``hd ** -0.5`` (rounded to that dtype, as JAX's weak typing does),
widened to f32, masked with ``NEG_INF``, ``exp(x - max) / sum`` in f32,
the probabilities cast back to the compute dtype for the product with v.
No library attention kernel runs; the products are `torch.einsum`
(cuBLAS on the card).  ``attend_chunked`` is the JAX code's static
triangular loop over (chunk, chunk) blocks with an f32 online softmax,
but for its last step: each chunk's output goes back to (B, c, H, hd)
with positions before heads, where JAX's raw reshape of (B, KV, G, c, hd)
mixes the two (JAX's chunked path disagrees with its own dense one; the
port's agrees with both dense paths).  It runs where a sequence is longer
than ``attn_chunk`` (2048 in the full configs), with the layer's window.

Decode writes the new key and value into the layer's cache in place and
returns it (a cache placed as DTensors, its sequence sharded by
`repro_torch.launch.sharding.decode_state_shardings`, is written by the
rank that holds the slot: `placed.write_slot`).  ``cross_attention``
(the vlm and encdec families) attends from x over a context (whisper's
encoder output, llama-3.2-vision's image tokens) with no mask and no
RoPE: K and V are projected from the context
(``project_qkv(..., kv_x=)``), the scores are GQA's in f32 and the output
is, ``gated``, scaled by ``tanh(gate)`` (f32, cast to the output's dtype).
A cross layer's ``gate`` starts at 0 (JAX's ``init_attention(cross=True)``),
so a freshly made vlm model's cross layers add exactly 0.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import placed
from repro_torch.models.common import ModelConfig, apply_rope, dense_param, rms_norm, scalar

__all__ = ["NEG_INF", "Attention", "project_qkv", "gqa_scores", "gqa_out", "causal_mask",
           "softmax", "attend_full", "attend_chunked", "attend", "attention", "init_kv_cache",
           "decode_attention", "cross_attention"]

NEG_INF = -2.3819763e38  # large negative for masking (bf16-safe)


class Attention(nn.Module):
    """One layer's projections (``init_attention`` of the JAX code): ``wq``
    (D, H, hd), ``wk`` / ``wv`` (D, KV, hd), ``wo`` (H, hd, D) in the
    compute dtype; with ``qk_norm``, ``q_norm`` / ``k_norm`` (hd,) f32; with
    ``cross``, the tanh ``gate`` (1,) f32, zero."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None, cross: bool = False):
        super().__init__()
        d, h, kv, hd, dt = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                            cfg.compute_dtype)
        self.wq = dense_param(generator, (d, h, hd), dtype=dt, device=device)
        self.wk = dense_param(generator, (d, kv, hd), dtype=dt, device=device)
        self.wv = dense_param(generator, (d, kv, hd), dtype=dt, device=device)
        self.wo = dense_param(generator, (h, hd, d), in_axis=0, dtype=dt, device=device)
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.zeros((hd,), dtype=torch.float32, device=device),
                                       requires_grad=False)
            self.k_norm = nn.Parameter(torch.zeros((hd,), dtype=torch.float32, device=device),
                                       requires_grad=False)
        if cross:  # llama-3.2-vision's tanh gate
            self.gate = nn.Parameter(torch.zeros((1,), dtype=torch.float32, device=device),
                                     requires_grad=False)


def project_qkv(p, cfg: ModelConfig, x: torch.Tensor, kv_x: torch.Tensor | None = None):
    """q (B, S, H, hd) from x, k and v (B, T, KV, hd) from ``kv_x`` (a
    cross-attention context; None: x itself), in the compute dtype, q and k
    RMS-normed over hd with ``qk_norm``; ``p`` is an `Attention` (or any
    object with its tensors)."""
    dt = cfg.compute_dtype
    x = x.to(dt)
    kv_src = x if kv_x is None else kv_x.to(dt)
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(dt))
    k = torch.einsum("btd,dgk->btgk", kv_src, p.wk.to(dt))
    v = torch.einsum("btd,dgk->btgk", kv_src, p.wv.to(dt))
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    return q, k, v


def gqa_scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, S, H, hd) x (B, T, KV, hd) -> (B, KV, H/KV, S, T) grouped scores,
    in q's dtype."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    return torch.einsum("bskgd,btkd->bkgst", qg, k) * scalar(scale, q.dtype)


def gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, KV, G, S, T) x (B, T, KV, hd) -> (B, S, H, hd)."""
    b, kv, g, s, t = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, kv * g, v.shape[-1])


def _window(cfg: ModelConfig, layer_window: int | None) -> int:
    """A layer's attention window: ``layer_window``, or ``swa_window``."""
    return cfg.swa_window if layer_window is None else layer_window


def causal_mask(s: int, t: int, offset: int = 0, window: int = 0, device=None) -> torch.Tensor:
    """(s, t) boolean keep-mask; ``offset`` = kv length - q length."""
    qi = torch.arange(s, device=device)[:, None] + offset
    kj = torch.arange(t, device=device)[None, :]
    keep = kj <= qi
    if window:
        keep &= kj > qi - window
    return keep


def softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: ``exp(x - max) / sum``."""
    u = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    return u / torch.sum(u, dim=-1, keepdim=True)


def attend_full(q, k, v, cfg: ModelConfig, *, causal: bool = True, offset: int = 0,
                window: int | None = None):
    """Dense-scores attention (train / prefill at moderate S), masked to
    ``window`` (default ``cfg.swa_window``; 0 = full causal)."""
    window = _window(cfg, window)
    scores = gqa_scores(q, k, cfg.head_dim ** -0.5).to(torch.float32)
    if causal:
        keep = causal_mask(q.shape[1], k.shape[1], offset, window, device=q.device)
        scores = torch.where(keep, scores, NEG_INF)
    probs = softmax(scores).to(q.dtype)
    return gqa_out(probs, v)


def attend_chunked(q, k, v, cfg: ModelConfig, *, chunk: int, window: int = 0):
    """Causal attention as a static triangular loop over (chunk, chunk)
    blocks with an f32 online softmax; with ``window``, blocks wholly
    outside the sliding window are skipped."""
    b, s, h, hd = q.shape
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of attn_chunk {chunk}")
    n = s // chunk
    scale = hd ** -0.5
    kvh = k.shape[2]
    outs = []
    for i in range(n):
        qi = q[:, i * chunk:(i + 1) * chunk]
        m = torch.full((b, kvh, h // kvh, chunk, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, kvh, h // kvh, chunk, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kvh, h // kvh, chunk, hd), dtype=torch.float32, device=q.device)
        j_lo = max(0, (i * chunk - window + 1) // chunk) if window else 0
        for jc in range(j_lo, i + 1):
            kj = k[:, jc * chunk:(jc + 1) * chunk]
            vj = v[:, jc * chunk:(jc + 1) * chunk]
            sc = gqa_scores(qi, kj, scale).to(torch.float32)
            if jc == i or window:
                keep = causal_mask(chunk, chunk, offset=(i - jc) * chunk, window=window,
                                   device=q.device)
                sc = torch.where(keep, sc, NEG_INF)
            m_new = torch.maximum(m, torch.amax(sc, dim=-1, keepdim=True))
            p = torch.exp(sc - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + torch.sum(p, dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bkgst,btkd->bkgsd", p.to(q.dtype),
                                             vj).to(torch.float32)
            m = m_new
        out = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)  # (B, KV, G, c, hd)
        # positions before heads, as `gqa_out` lays them out; JAX's code
        # reshapes (B, KV, G, c, hd) straight to (B, c, H, hd), which mixes
        # positions and heads wherever it chunks (the port does not copy that)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, chunk, h, hd))
    return torch.cat(outs, dim=1)


def attend(q, k, v, cfg: ModelConfig, *, causal: bool = True, window: int = 0):
    """q (B, S, H, hd) over k, v (B, T, KV, hd) -> (B, S, H, hd): a causal
    sequence longer than ``attn_chunk`` through `attend_chunked`, anything
    else `attend_full` (``causal=False``: no mask, the window unused).  On
    DTensors each rank attends with its own batch rows and query heads
    (`_attend_placed`)."""
    def local(q, k, v):
        if causal and cfg.attn_chunk and q.shape[1] > cfg.attn_chunk:
            return attend_chunked(q, k, v, cfg, chunk=cfg.attn_chunk, window=window)
        return attend_full(q, k, v, cfg, causal=causal, window=window)

    if placed.is_dtensor(q):
        return _attend_placed(q, k, v, local)
    return local(q, k, v)


def _attend_placed(q, k, v, local):
    """``local(q, k, v)`` (an attention) on DTensors: each rank runs it on
    its own batch rows and query heads (``local_map``), with the kv heads
    those query heads read, over the whole sequence.  Attention is
    independent across batch rows and heads, so this is the placed
    computation itself, and moves nothing where q, k and v come split that
    way; DTensor's own rules for the grouped products reshape a head dim
    sharded over 'model' together with a neighbour, which it refuses for
    some shapes (torch 2.11, gemma-2b at (4, 128)), and take the chunked
    loop's blocks one redistribution at a time."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    h, kv = q.shape[2], k.shape[2]
    q_pl, kv_pl, kv_grad = [], [], []
    heads_split = None
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        if p == Shard(0):  # batch rows
            q_pl.append(p)
            kv_pl.append(p)
            kv_grad.append(p)
        elif p == Shard(2) and heads_split is None:  # query heads
            heads_split = i
            q_pl.append(p)
            kv_pl.append(Shard(2) if kv % n == 0 else Replicate())
            kv_grad.append(Shard(2) if kv % n == 0 else Partial())
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
            kv_grad.append(Replicate())
    first = 0  # this rank's first query head
    if heads_split is not None:
        first = mesh.get_local_rank(heads_split) * (h // mesh.size(heads_split))

    def run(q, k, v):
        q, k, v = (placed.dense_grad(x) for x in (q, k, v))
        h_l, kv_l = q.shape[2], k.shape[2]
        if kv_l == kv and h_l < h:  # the kv heads of this rank's query heads
            group = h // kv
            lo, hi = first // group, (first + h_l - 1) // group + 1
            k, v = k[:, :, lo:hi], v[:, :, lo:hi]
        return local(q, k, v)

    qs, ks = tuple(q_pl), tuple(kv_pl)
    return local_map(run, out_placements=(qs,), in_placements=(qs, ks, ks),
                     in_grad_placements=(qs, tuple(kv_grad), tuple(kv_grad)), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def attention(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, *,
              layer_window: int | None = None) -> torch.Tensor:
    """Causal self-attention over a full sequence (train / prefill):
    (B, S, D) -> (B, S, D), within ``layer_window`` (default
    ``cfg.swa_window``)."""
    q, k, v = project_qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    # JAX's local-attention branch is these ops with the layer's window
    ctx = attend(q, k, v, cfg, causal=True, window=_window(cfg, layer_window))
    return torch.einsum("bshk,hkd->bsd", ctx, p.wo.to(cfg.compute_dtype))


def cross_attention(p, cfg: ModelConfig, x: torch.Tensor, context: torch.Tensor, *,
                    gated: bool = False) -> torch.Tensor:
    """Cross-attention of x (B, S, D) over ``context`` (B, T, D) (whisper's
    decoder over the encoder output, llama-3.2-vision's image layers): no
    mask, no RoPE, the scores f32 and JAX's softmax; -> (B, S, D), times
    ``tanh(gate)`` (f32, cast to the output's dtype) when ``gated``."""
    q, k, v = project_qkv(p, cfg, x, kv_x=context)
    ctx = attend(q, k, v, cfg, causal=False)
    out = torch.einsum("bshk,hkd->bsd", ctx, p.wo.to(cfg.compute_dtype))
    if gated:
        out = torch.tanh(p.gate.to(torch.float32)).to(out.dtype) * out
    return out


# -- decode (KV cache) ------------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None, *,
                  layer_window: int | None = None) -> dict:
    """One layer's cache ``{"k", "v"}`` (B, KV, S, hd) in the compute dtype;
    S is ``min(max_seq, W)`` for a ring cache, W the layer's window
    (``layer_window``, default ``swa_window``)."""
    window = _window(cfg, layer_window)
    s = max_seq
    if window and cfg.ring_cache:
        s = min(max_seq, window)
    shape = (batch, cfg.n_kv_heads, s, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}


def decode_attention(p, cfg: ModelConfig, x: torch.Tensor, cache: dict, pos, *,
                     layer_window: int | None = None):
    """One token's self-attention against a layer's cache, within
    ``layer_window`` (default ``swa_window``).

    ``x`` (B, 1, D) at position ``pos`` (an int or a 0-d integer tensor).
    The new key and value are written at ``pos`` (full cache) or ``pos %
    W`` (ring) in place; keys carry RoPE at their true position, so a warm
    ring needs no order, and slots past ``pos`` are masked while it is
    cold.  Returns (out (B, 1, D), the cache).
    """
    dt = cfg.compute_dtype
    window = _window(cfg, layer_window)
    ring = bool(window) and cfg.ring_cache
    cache_k, cache_v = cache["k"], cache["v"]
    b = x.shape[0]
    q, k_new, v_new = project_qkv(p, cfg, x)
    # placed: every query head on each rank of a batch block (one token's
    # worth), so the grouping below never splits a head dim that does not
    # divide by the kv heads
    q = placed.rows(q, x)
    positions = (pos.reshape(1, 1).expand(b, 1) if isinstance(pos, torch.Tensor)
                 else torch.full((b, 1), pos, device=x.device))  # no copy to the card
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)
    slot = pos % cache_k.shape[2] if ring else pos
    if placed.is_dtensor(cache_k):  # a placed cache: the rank holding the slot writes
        placed.write_slot(cache_k, k_new[:, 0], slot)
        placed.write_slot(cache_v, v_new[:, 0], slot)
    else:
        cache_k[:, :, slot] = k_new[:, 0].to(dt)
        cache_v[:, :, slot] = v_new[:, 0].to(dt)

    _, kv, s, hd = cache_k.shape
    h = q.shape[2]
    qg = q.reshape(b, 1, kv, h // kv, hd)
    scores = torch.einsum("bokgd,bktd->bkgot", qg, cache_k) * scalar(hd ** -0.5, dt)
    t_idx = torch.arange(s, device=x.device)
    keep = t_idx <= pos  # a ring: cold start only, a warm ring is fully valid
    if window and not ring:
        keep &= t_idx > pos - window
    scores = torch.where(keep, scores.to(torch.float32), NEG_INF)
    probs = softmax(scores).to(dt)
    ctx = torch.einsum("bkgot,bktd->bokgd", probs, cache_v).reshape(b, 1, h, hd)
    out = torch.einsum("bshk,hkd->bsd", ctx, p.wo.to(dt))
    return out, cache
