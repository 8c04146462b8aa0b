"""RWKV-6 "Finch" block (arXiv:2404.05892), twin of `repro.models.rwkv6`:
attention-free token mixing via a data-dependent-decay linear recurrence and
squared-ReLU channel mixing.

Per layer:
  time-mix: token-shift lerp -> r,k,v,g projections + LoRA decay w_t
            -> wkv6 recurrence (`kernels.ops.wkv6`: kernel #7 on CUDA, the
               plain loop on the CPU) -> per-head RMS "group norm"
            -> SiLU(g) gate -> output proj
  channel-mix: token-shift lerp -> relu(W_k x)^2 -> W_v, gated by sigmoid(W_r x)

The dtype choices are the JAX code's: r, k, v, g and the LoRA products in
the compute dtype; ``w = exp(-exp(w0 + dd))`` in f32; the four slabs cast to
f32 into the recurrence; the head norm in f32, cast back; the sigmoid and
SiLU as ``jax.nn`` lowers them, one rounding per op.  The shift states
``tm_last`` / ``cm_last`` carry the normalised input h, not x.

Weights are stored once in the compute dtype.  The JAX package keeps f32
master weights and casts them with ``.astype(compute_dtype)`` at every use;
the port stores that cast's result at load (the same values), for every
tensor the JAX code uses only through it: the projections, the LoRA, the
``mu_*`` lerp weights (cast to the activation dtype) and, in
`repro_torch.models.transformer`, the embedding and unembedding.  ``w0``,
``u``, ``ln_scale`` and the layer norms stay f32.  At rwkv6-7b that is
15.1 GB of bf16 instead of 30 GB of f32 plus a cast per matrix product.
An f32 model is the config with ``dtype="float32"``.

Training runs the same modules on other tensors: `repro_torch.train.
train_step` keeps f32 masters and casts every >= 2-D one to the compute
dtype once a step, as the JAX trainer does, and the layers run on those
cast tensors through `torch.func.functional_call`
(`repro_torch.models.transformer.backbone` with ``params``).  So in
training ``u`` arrives in the compute dtype (JAX rounds it there too) and
is widened to f32 for the recurrence, as JAX's promotion does; ``mu_*``,
``w0`` and the norms arrive as f32 masters.  The sigmoid (and so SiLU)
differentiates by JAX's ``logistic`` rule, ``g * (s * (1 - s))``.

Decode state per layer: time-mix shift (B, D), channel-mix shift (B, D) and
the wkv state (B*H, 64, 64) f32 — O(1) in sequence length.

A model placed as DTensors (`repro_torch.launch.sharding`) runs the
recurrence through `local_map`: each rank launches kernel #7 on its batch
and head block, so its launch count is the unsharded model's.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.models import placed
from repro_torch.models.common import ModelConfig, dense_param, rms_norm, sigmoid

__all__ = ["LORA_RANK", "HEAD_DIM", "heads", "TimeMix", "ChannelMix", "RWKVBlock",
           "init_rwkv_state"]

LORA_RANK = 64
HEAD_DIM = 64  # dk = dv = 64 (RWKV-6 default)


def heads(cfg: ModelConfig) -> int:
    return cfg.d_model // HEAD_DIM


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _full(shape, value, dtype, device) -> nn.Parameter:
    return _param(torch.full(shape, value, dtype=dtype, device=device))


def _zeros(shape, device) -> nn.Parameter:
    return _param(torch.zeros(shape, dtype=torch.float32, device=device))


def _shift(x, last):
    """Token shift: x_{t-1} with ``last`` filling t=0. Returns (shifted, new_last)."""
    prev = torch.cat([last[:, None], x[:, :-1]], dim=1)
    return prev, x[:, -1]


def _lerp(x, prev, mu):
    return x + (prev - x) * mu.to(x.dtype)


def _silu(x):
    """``jax.nn.silu``: ``x * sigmoid(x)`` with this module's ``sigmoid``."""
    return x * sigmoid(x)


def _head_rms(x, scale, h):
    b, s, d = x.shape
    xh = x.reshape(b, s, h, d // h).to(torch.float32)
    var = torch.mean(torch.square(xh), dim=-1, keepdim=True)
    xh = xh * torch.rsqrt(var + 1e-6)
    return (xh.reshape(b, s, d) * (1.0 + scale)).to(x.dtype)


class TimeMix(nn.Module):
    """Token mixing through the wkv6 recurrence (``time_mix`` of the JAX code)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        d, h, dt = cfg.d_model, heads(cfg), cfg.compute_dtype
        for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
            setattr(self, name, _full((d,), 0.5, dt, device))
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, dense_param(generator, (d, d), dtype=dt, device=device))
        self.w0 = _full((d,), -3.0, torch.float32, device)  # base decay (slow)
        self.lora_a = dense_param(generator, (d, LORA_RANK), dtype=dt, device=device)
        self.lora_b = dense_param(generator, (LORA_RANK, d), dtype=dt, device=device)
        self.u = _zeros((h, HEAD_DIM), device)
        self.ln_scale = _zeros((d,), device)

    def forward(self, x, shift_last, wkv_state):
        """x: (B, S, D). Returns (out, new_shift_last, new_wkv_state)."""
        dt = self.cfg.compute_dtype
        b, s, d = x.shape
        h = heads(self.cfg)
        prev, new_last = _shift(x, shift_last)
        xr = _lerp(x, prev, self.mu_r)
        xk = _lerp(x, prev, self.mu_k)
        xv = _lerp(x, prev, self.mu_v)
        xw = _lerp(x, prev, self.mu_w)
        xg = _lerp(x, prev, self.mu_g)

        r = xr @ self.w_r
        k = xk @ self.w_k
        v = xv @ self.w_v
        g = xg @ self.w_g
        # data-dependent decay (f32): w_t = exp(-exp(w0 + tanh(x A) B))
        dd = (torch.tanh(xw @ self.lora_a) @ self.lora_b).to(torch.float32)
        w = torch.exp(-torch.exp(self.w0 + dd))  # in (0,1)

        if placed.is_dtensor(r):
            o, new_state = _wkv_placed(self.cfg, r, k, v, w, self.u, wkv_state)
        else:
            o, new_state = _wkv_heads(r, k, v, w, self.u, wkv_state)
        o = o.to(dt)
        o = _head_rms(o, self.ln_scale, h)
        o = o * _silu(g)
        return o @ self.w_o, new_last, new_state


def _wkv_heads(r, k, v, w, u, state):
    """The recurrence over (B, S, D) slabs r, k, v (compute dtype) and w
    (f32) with bonus ``u`` (H, 64) from ``state`` (B*H, 64, 64) or None: one
    `kops.wkv6` call on contiguous (B*H, S, 64) f32 slabs.  Returns o (B, S,
    D) f32 and the new state."""
    b, s, d = r.shape
    h = d // HEAD_DIM

    def to_heads(z):  # (B, S, D) -> contiguous (B*H, S, 64) slabs
        return (z.reshape(b, s, h, HEAD_DIM).transpose(1, 2)
                .reshape(b * h, s, HEAD_DIM).contiguous())

    u = u[None].expand(b, h, HEAD_DIM).reshape(b * h, HEAD_DIM).to(torch.float32).contiguous()
    o, new_state = kops.wkv6(to_heads(r).to(torch.float32), to_heads(k).to(torch.float32),
                             to_heads(v).to(torch.float32), to_heads(w), u, state)
    return o.reshape(b, h, s, HEAD_DIM).transpose(1, 2).reshape(b, s, d), new_state


def _wkv_placed(cfg: ModelConfig, r, k, v, w, u, state):
    """`_wkv_heads` on DTensors: each rank runs the recurrence (kernel #7
    on CUDA) on its own rows, its batch block over the batch axes and, where
    the heads divide, its head block over 'model' (DTensor has no rule for
    the kernel's op).  The state is held as the decode-state spec has it,
    (B*H, 64, 64) over the batch axes only: a rank takes its heads' rows of
    it, and the new state's head blocks are all-gathered over 'model'."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = r.device_mesh
    b, h = r.shape[0], heads(cfg)
    x_pl, u_pl, st_pl, st_out, u_grad, st_grad, kept = [], [], [], [], [], [], []
    split_heads = False
    for i, name in enumerate(mesh.mesh_dim_names):
        n = mesh.size(i)
        if name == placed.MODEL_AXIS and h % n == 0:
            split_heads = True
            x_pl.append(Shard(2))
            u_pl.append(Shard(0))
            st_pl.append(Replicate())
            st_out.append(Shard(1))
            u_grad.append(Shard(0))
            st_grad.append(Partial())  # each rank's gradient covers its heads only
            kept.append(Replicate())
        elif name in placed.BATCH_AXES and b % n == 0:
            x_pl.append(Shard(0))
            u_pl.append(Replicate())
            st_pl.append(Shard(0))
            st_out.append(Shard(0))
            u_grad.append(Partial())  # each rank's gradient covers its batch rows only
            st_grad.append(Shard(0))
            kept.append(Shard(0))
        else:
            for lst in (x_pl, u_pl, st_pl, st_out, u_grad, st_grad, kept):
                lst.append(Replicate())
    if state is None:
        state = torch.zeros((b * h, HEAD_DIM, HEAD_DIM), dtype=torch.float32,
                            device=r.to_local().device)
    if not placed.is_dtensor(state):
        state = placed.as_replicated(state, mesh)
    model_rank = mesh.get_local_rank(placed.MODEL_AXIS) if split_heads else 0

    def run(r, k, v, w, u, st):
        b_l, _, d_l = r.shape
        h_l = d_l // HEAD_DIM
        if h_l != h:  # this rank's heads of the whole-head state
            st = st.reshape(b_l, h, HEAD_DIM, HEAD_DIM)[:, model_rank * h_l:(model_rank + 1) * h_l]
            st = st.reshape(b_l * h_l, HEAD_DIM, HEAD_DIM)
        o, ns = _wkv_heads(r, k, v, w, u, st.contiguous())
        return o, ns.reshape(b_l, h_l, HEAD_DIM, HEAD_DIM)

    xs, us, sts = tuple(x_pl), tuple(u_pl), tuple(st_pl)
    o, new_state = local_map(
        run, out_placements=(xs, tuple(st_out)), in_placements=(xs, xs, xs, xs, us, sts),
        in_grad_placements=(xs, xs, xs, xs, tuple(u_grad), tuple(st_grad)),
        device_mesh=mesh, redistribute_inputs=True)(r, k, v, w, u, state)
    new_state = new_state.redistribute(mesh, kept)  # whole heads again
    return o, new_state.reshape(b * h, HEAD_DIM, HEAD_DIM)


class ChannelMix(nn.Module):
    """Squared-ReLU channel mixing gated by a receptance (``channel_mix``)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.compute_dtype
        self.mu_k = _full((d,), 0.5, dt, device)
        self.mu_r = _full((d,), 0.5, dt, device)
        self.w_k = dense_param(generator, (d, f), dtype=dt, device=device)
        self.w_v = dense_param(generator, (f, d), dtype=dt, device=device)
        self.w_r = dense_param(generator, (d, d), dtype=dt, device=device)

    def forward(self, x, shift_last):
        prev, new_last = _shift(x, shift_last)
        xk = _lerp(x, prev, self.mu_k)
        xr = _lerp(x, prev, self.mu_r)
        kk = torch.square(torch.relu(xk @ self.w_k))
        vv = kk @ self.w_v
        rr = sigmoid(xr @ self.w_r)
        return rr * vv, new_last


class RWKVBlock(nn.Module):
    """One rwkv layer: pre-norm time-mix and channel-mix, each residual."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.tm = TimeMix(cfg, generator, device)
        self.cm = ChannelMix(cfg, generator, device)
        self.norm1 = _zeros((cfg.d_model,), device)
        self.norm2 = _zeros((cfg.d_model,), device)

    def forward(self, x, state):
        """x: (B, S, D), state: this layer's decode state. Returns (x', state')."""
        h = rms_norm(x, self.norm1)
        o, tm_last, wkv = self.tm(h, state["tm_last"], state["wkv"])
        x = placed.residual(x, o)
        h = rms_norm(x, self.norm2)
        o, cm_last = self.cm(h, state["cm_last"])
        x = placed.residual(x, o)
        return x, {"tm_last": tm_last, "cm_last": cm_last, "wkv": wkv}


def init_rwkv_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    h = heads(cfg)
    return {
        "tm_last": torch.zeros((batch, cfg.d_model), dtype=cfg.compute_dtype, device=device),
        "cm_last": torch.zeros((batch, cfg.d_model), dtype=cfg.compute_dtype, device=device),
        "wkv": torch.zeros((batch * h, HEAD_DIM, HEAD_DIM), dtype=torch.float32,
                           device=device),
    }
