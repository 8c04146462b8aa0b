"""RG-LRU recurrent block of Griffin / RecurrentGemma (arXiv:2402.19427), the
twin of `repro.models.rglru`.

Block:  y = W_out( GeLU(W_gmlp x) * RG-LRU(conv1d(W_x x)) )

RG-LRU per channel::

    r_t = sigmoid(W_r u_t + b_r)        # recurrence gate
    i_t = sigmoid(W_i u_t + b_i)        # input gate
    a_t = exp(c * r_t * log(sigmoid(Lambda)))     (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Prefill and training run `rglru_scan`: JAX's ``jax.lax.associative_scan``
written out in torch, the same recursion (adjacent pairs combined, the
scan of the half-length sequence, the even positions filled in from it,
the two interleaved), so the f32 multiply-adds come in JAX's order and the
result equals JAX's bit for bit on the CPU.  It takes about 2·log2(S)
levels of a few whole-tensor ops each, never a Python loop over time
steps.  Decode carries ``h`` (B, lru) f32 and the causal conv's last W-1
inputs (B, W-1, lru) in the compute dtype (`rglru_step`).

Each op runs in the dtype JAX runs it in: the gates, ``a`` and the scan
in f32; the projections, the conv and the tanh GeLU in the compute dtype.
The sigmoid is `repro_torch.models.common.sigmoid` (JAX's logistic rule)
and ``softplus`` is ``jax.nn.softplus`` as JAX writes it,
``logaddexp(x, 0)`` with its JVP rule (``torch.nn.functional.softplus``
has a threshold of 20 and differs).  The weights are stored as the JAX
code uses them: the matrices and ``conv_w`` / ``conv_b`` (cast at use) in
the compute dtype, ``b_r``, ``b_i`` and ``lam`` f32.

Placed (DTensors under `repro_torch.launch.sharding`'s rules: ``w_x``,
``w_gmlp``, ``conv_w``, ``w_r``, ``w_i`` split their channels over 'model',
``w_out`` its rows), the block's channels stay split from ``w_x`` to
``w_out``.  The conv and the scan run on each rank's own batch rows and
channels (``local_map``: both act per channel along the whole, unsplit
sequence), so neither moves a byte; the gates' products mix the
channels and read ``u`` whole (one all-gather over 'model' a layer, both
gates); ``w_out``'s product leaves a partial sum, all-reduced where the
residual stream is held (`placed.rows`).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import placed
from repro_torch.models.common import ModelConfig, dense_param, sigmoid
from repro_torch.models.ffn import gelu_tanh

__all__ = ["RGLRU", "init_rglru", "softplus", "causal_conv1d", "associative_scan", "rglru_scan",
           "rglru_step", "rglru_block", "init_rglru_state"]

_C = 8.0


class RGLRU(nn.Module):
    """One RG-LRU block's parameters (``init_rglru`` of the JAX code):
    ``w_x``, ``w_gmlp`` (D, lru), ``conv_w`` (W, lru), ``conv_b``,
    ``w_r``, ``b_r``, ``w_i``, ``b_i`` (lru, lru) / (lru,), ``lam`` (lru,)
    and ``w_out`` (lru, D)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.compute_dtype
        lru = cfg.lru_width or d
        w = cfg.conv1d_width

        def zeros(dtype):
            return nn.Parameter(torch.zeros((lru,), dtype=dtype, device=device),
                                requires_grad=False)

        self.w_x = dense_param(generator, (d, lru), dtype=dt, device=device)
        self.w_gmlp = dense_param(generator, (d, lru), dtype=dt, device=device)
        self.conv_w = dense_param(generator, (w, lru), dtype=dt, device=device)
        self.conv_b = zeros(dt)
        self.w_r = dense_param(generator, (lru, lru), dtype=dt, device=device)
        self.b_r = zeros(torch.float32)
        self.w_i = dense_param(generator, (lru, lru), dtype=dt, device=device)
        self.b_i = zeros(torch.float32)
        # Lambda so that a = sigmoid(lam) lies in ~[0.9, 0.999]
        self.lam = nn.Parameter(
            torch.linspace(2.2, 6.9, lru, dtype=torch.float32, device=device),
            requires_grad=False)
        self.w_out = dense_param(generator, (lru, d), dtype=dt, device=device)


def init_rglru(cfg: ModelConfig, generator=None, device=None) -> RGLRU:
    return RGLRU(cfg, generator, device)


def _replace_inf(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isinf(x), torch.zeros_like(x), x)


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus`` = ``jnp.logaddexp(x, 0)``: forward as
    ``lax.logaddexp`` computes it, gradient by its JVP rule
    ``g * exp(x - out)`` (infinities replaced by 0), each op in x's dtype."""

    @staticmethod
    def forward(ctx, x):
        amax = torch.clamp_min(x, 0)
        out = torch.where(torch.isnan(x), x, amax + torch.log1p(torch.exp(-torch.abs(x))))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(_replace_inf(x) - _replace_inf(out))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (see `_Softplus`)."""
    return _Softplus.apply(x)


def causal_conv1d(u: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor, state=None):
    """Depthwise causal conv: u (B, S, C), conv_w (W, C).

    ``state``: (B, W-1, C), the previous segment's last inputs (decode).
    Returns (y, new_state), the taps added in order in u's dtype.
    """
    if placed.is_dtensor(u):
        return _conv_placed(u, conv_w, conv_b, state)
    w = conv_w.shape[0]
    if state is None:
        state = torch.zeros((u.shape[0], w - 1, u.shape[-1]), dtype=u.dtype, device=u.device)
    ext = torch.cat([state, u], dim=1)  # (B, S+W-1, C)
    s = u.shape[1]
    y = ext[:, 0:s] * conv_w[0].to(u.dtype)
    for i in range(1, w):
        y = y + ext[:, i:i + s] * conv_w[i].to(u.dtype)
    return y + conv_b.to(u.dtype), ext[:, ext.shape[1] - (w - 1):]


def _conv_placed(u, conv_w, conv_b, state):
    """`causal_conv1d` on DTensors: each rank convolves its own batch rows
    and channels with its channels' taps (``local_map``; the conv is
    depthwise, so no channel reads another).  A mesh dim that splits
    neither is gathered first; the decode state has ``u``'s layout."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = u.device_mesh
    u_pl, w_pl, b_pl, w_grad, b_grad = [], [], [], [], []
    for p in u.placements:
        if p == Shard(2):  # channels
            u_pl.append(p)
            w_pl.append(Shard(1))
            b_pl.append(Shard(0))
        else:  # batch rows, or gathered: every rank holds every tap
            u_pl.append(p if p == Shard(0) else Replicate())
            w_pl.append(Replicate())
            b_pl.append(Replicate())
        w_grad.append(Partial() if p == Shard(0) else w_pl[-1])
        b_grad.append(Partial() if p == Shard(0) else b_pl[-1])
    u_pl, w_pl, b_pl = tuple(u_pl), tuple(w_pl), tuple(b_pl)
    conv_w, conv_b = (x if placed.is_dtensor(x) else placed.as_replicated(x, mesh)
                      for x in (conv_w, conv_b))
    args, in_pl, grad_pl = (u, conv_w, conv_b), (u_pl, w_pl, b_pl), (u_pl, tuple(w_grad),
                                                                      tuple(b_grad))
    if state is not None:
        args, in_pl, grad_pl = args + (state,), in_pl + (u_pl,), grad_pl + (u_pl,)
    return local_map(causal_conv1d, out_placements=(u_pl, u_pl), in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _gates(p, u: torch.Tensor, dt: torch.dtype):
    """(a, gated input) of u (B, S, C), both f32 (placed: u whole over the
    channels for the products, which mix them)."""
    whole = placed.rows(u, u)
    r = sigmoid((whole @ p.w_r.to(dt)).to(torch.float32) + p.b_r)
    i = sigmoid((whole @ p.w_i.to(dt)).to(torch.float32) + p.b_i)
    log_a = -softplus(-p.lam)  # log sigmoid(lam), in lam's dtype
    a = torch.exp(_C * r * log_a)  # (B, S, C) f32
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.square(a), 1e-12)) * i * u.to(torch.float32)
    return a, gated


def _combine(x, y):
    (a1, b1), (a2, b2) = x, y
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along axis 1 (even one longer or equal)."""
    n = even.shape[1] + odd.shape[1]
    if odd.shape[1] < even.shape[1]:
        odd = torch.cat([odd, torch.zeros_like(odd[:, :1])], dim=1)
    out = torch.stack([even, odd], dim=2).flatten(1, 2)
    return out[:, :n]


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of the pairs (a, b) along axis 1 under
    ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``: JAX's
    ``associative_scan`` recursion (``jax/_src/lax/control_flow/loops.py``)
    op for op."""
    n = a.shape[1]
    if n < 2:
        return a, b
    reduced = _combine((a[:, 0:n - 1:2], b[:, 0:n - 1:2]), (a[:, 1::2], b[:, 1::2]))
    odd = associative_scan(*reduced)
    if n % 2 == 0:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        even = _combine(odd, (a[:, 2::2], b[:, 2::2]))
    even = [torch.cat([x[:, :1], e], dim=1) for x, e in zip((a, b), even)]
    return _interleave(even[0], odd[0]), _interleave(even[1], odd[1])


def rglru_scan(p, cfg: ModelConfig, u: torch.Tensor, h0: torch.Tensor | None = None):
    """The RG-LRU over a whole sequence u (B, S, C), from ``h0`` (B, C) or
    zero.  Returns (y (B, S, C) in the compute dtype, h_last (B, C) f32)."""
    dt = cfg.compute_dtype
    a, bterm = _gates(p, u, dt)
    if h0 is not None:
        # fold the initial state in as a virtual step: h_t = (prod a) h0 + ...
        first = bterm[:, :1] + (a[:, 0] * h0.to(torch.float32))[:, None]
        bterm = torch.cat([first, bterm[:, 1:]], dim=1)
    if placed.is_dtensor(a):
        _, h = _scan_placed(a, bterm)
    else:
        _, h = associative_scan(a, bterm)
    return h.to(dt), h[:, -1]


def _scan_placed(a, b):
    """`associative_scan` on DTensors (B, S, C): each rank scans its own
    batch rows and channels along the whole sequence (``local_map``); a
    mesh dim that splits neither is gathered first."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    pl = tuple(p if p in (Shard(0), Shard(2)) else Replicate() for p in a.placements)
    return local_map(associative_scan, out_placements=(pl, pl), in_placements=(pl, pl),
                     in_grad_placements=(pl, pl), device_mesh=a.device_mesh,
                     redistribute_inputs=True)(a, b)


def rglru_step(p, cfg: ModelConfig, u_t: torch.Tensor, h: torch.Tensor):
    """One decode step: u_t (B, 1, C), h (B, C). Returns (y (B, 1, C), h)."""
    a, bterm = _gates(p, u_t, cfg.compute_dtype)
    h = a[:, 0] * h.to(torch.float32) + bterm[:, 0]
    return h[:, None].to(cfg.compute_dtype), h


def rglru_block(p, cfg: ModelConfig, x: torch.Tensor, state: dict | None = None):
    """The Griffin recurrent block: x (B, S, D) -> (y (B, S, D), new state);
    ``state`` None (train / prefill: the scan from zero) or ``{"conv",
    "h"}`` for a decode step."""
    dt = cfg.compute_dtype
    gate = gelu_tanh(x @ p.w_gmlp.to(dt))
    u = x @ p.w_x.to(dt)
    conv_state = state["conv"] if state is not None else None
    u, new_conv = causal_conv1d(u, p.conv_w, p.conv_b, conv_state)
    if state is None:
        h_seq, h_last = rglru_scan(p, cfg, u)
    else:
        h_seq, h_last = rglru_step(p, cfg, u, state["h"])
    y = (gate * h_seq) @ p.w_out.to(dt)
    return y, {"conv": new_conv, "h": h_last}


def init_rglru_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    lru = cfg.lru_width or cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, lru), dtype=cfg.compute_dtype,
                            device=device),
        "h": torch.zeros((batch, lru), dtype=torch.float32, device=device),
    }
