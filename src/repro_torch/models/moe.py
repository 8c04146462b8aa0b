"""Mixture-of-Experts FFN with sort-based capacity dispatch, the twin of
`repro.models.moe`.

Router -> top-k -> flattened assignments -> stable sort by expert id ->
rank within the expert -> capacity-bounded slots -> gather the tokens
into (E, C, D) -> each expert's gated FFN -> gate-weighted combine.
Capacity overflow drops assignments (a "dropping" MoE); the residual
stream carries a dropped token on unchanged.

Each step is JAX's, with what torch does not promise made explicit:

* the top k takes ties to the lower expert index, as ``jax.lax.top_k``:
  a stable descending sort, then its first k (``torch.topk`` makes no
  promise about ties);
* ``argsort(stable=True)``, ``searchsorted(side="left")`` and the scatters
  into E·C + 1 bins whose last bin takes every dropped assignment and is
  cut off, so capacity overflow drops the same assignments;
* the combine: JAX's ``.at[token_for_slot].add`` runs on the CPU in slot
  order, so a token's kept contributions are added to 0.0 in the order of
  its experts' ids.  The port adds them in that order as k whole-tensor
  adds (a dropped one adds 0.0), not with ``index_add_``, whose CUDA
  atomics add in no fixed order; so the card's result does not vary from
  run to run.

The expert products are three batched matrix products (``torch.bmm``,
cuBLAS on the card), as JAX's three einsums are XLA's.  The router runs in
f32.

On a model placed as DTensors (`repro_torch.launch.sharding`) the expert
products run under DTensor's rules on the placed expert weights (expert
parallel, or the intra-expert fallback), while the router, the dispatch and
the combine (sorts, searches, scatters and gathers DTensor has no rule for)
run on every rank over the whole batch: the tokens, the router and the
expert outputs are replicated first, an explicit all-gather (or all-reduce
of a partial sum).  ``moe_token_stationary=True`` pins the capacity axis of
the (E, C, .) tensors to 'data' at JAX's three ``tokstat`` points (expert
inputs, hidden, outputs), as JAX's ``with_sharding_constraint(z, P(None,
"data", None))``; it changes no value, and on plain tensors nothing.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import placed
from repro_torch.models.attention import softmax
from repro_torch.models.common import ModelConfig, dense_param
from repro_torch.models.ffn import _gate_fn

__all__ = ["MoE", "init_moe", "capacity", "top_k", "dispatch", "route", "tokstat", "experts",
           "combine", "moe_ffn", "router_load"]


class MoE(nn.Module):
    """One MoE FFN's parameters (``init_moe`` of the JAX code): ``router``
    (D, E) f32 (the router runs in f32), ``w_gate``, ``w_up`` (E, D, F) and
    ``w_down`` (E, F, D) in the compute dtype."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        d, f, e, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.compute_dtype
        self.router = dense_param(generator, (d, e), dtype=torch.float32, device=device)
        self.w_gate = dense_param(generator, (e, d, f), in_axis=1, dtype=dt, device=device)
        self.w_up = dense_param(generator, (e, d, f), in_axis=1, dtype=dt, device=device)
        self.w_down = dense_param(generator, (e, f, d), in_axis=1, dtype=dt, device=device)


def init_moe(cfg: ModelConfig, generator=None, device=None) -> MoE:
    return MoE(cfg, generator, device)


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(c, cfg.top_k)


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, ties to the
    lower index (``jax.lax.top_k``)."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _route(p, cfg: ModelConfig, xt: torch.Tensor):
    """Router probabilities (T, E) f32 and the top k (gates, expert ids)."""
    return _gates(p.router, cfg, xt)


def _gates(router: torch.Tensor, cfg: ModelConfig, xt: torch.Tensor):
    logits = xt.to(torch.float32) @ router.to(torch.float32)
    probs = softmax(logits)
    gate_vals, expert_idx = top_k(probs, cfg.top_k)
    return probs, gate_vals, expert_idx


def dispatch(cfg: ModelConfig, expert_idx: torch.Tensor, gate_vals: torch.Tensor):
    """The sort-based slotting of the (T, k) assignments into E·C slots.

    Returns a dict: ``token_for_slot`` (E·C,) int64, ``gate_for_slot``
    (E·C,) f32, ``valid`` (E·C,) bool, and ``slot_of`` (T, k) int64, the
    slot of each assignment (E·C where capacity dropped it).
    """
    t, k = expert_idx.shape
    e = cfg.n_experts
    c = capacity(cfg, t)
    dev = expert_idx.device
    flat_expert = expert_idx.reshape(-1)  # (t*k,)
    flat_token = torch.arange(t, device=dev).repeat_interleave(k)
    flat_gate = gate_vals.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    # rank within the expert: position - first occurrence of that expert
    first = torch.searchsorted(sorted_expert, sorted_expert, side="left")
    rank = torch.arange(t * k, device=dev) - first
    keep = rank < c
    slot = torch.where(keep, sorted_expert * c + rank, e * c)  # e*c: the dropped bin
    # scatters into E*C + 1 bins; the last one (every dropped assignment) is cut off
    token_for_slot = torch.zeros(e * c + 1, dtype=torch.int64, device=dev).scatter(
        0, slot, flat_token[order])[:e * c]
    gate_for_slot = torch.zeros(e * c + 1, dtype=torch.float32, device=dev).scatter(
        0, slot, torch.where(keep, flat_gate[order], 0.0))[:e * c]
    valid = torch.zeros(e * c + 1, dtype=torch.bool, device=dev).scatter(0, slot, keep)[:e * c]
    slot_of = torch.empty_like(slot).scatter(0, order, slot).reshape(t, k)
    return {"token_for_slot": token_for_slot, "gate_for_slot": gate_for_slot, "valid": valid,
            "slot_of": slot_of, "capacity": c}


def _combine(y_flat: torch.Tensor, expert_idx: torch.Tensor, slot_of: torch.Tensor):
    """out (T, D) f32: each token's kept rows of ``y_flat`` (E·C, D) added to
    0.0 in the order of its experts' ids (JAX's slot-order scatter-add on
    the CPU); a dropped assignment adds 0.0."""
    t, k = slot_of.shape
    y_pad = torch.cat([y_flat, y_flat.new_zeros((1, y_flat.shape[1]))])  # row E*C: 0.0
    by_expert = torch.gather(slot_of, 1, torch.argsort(expert_idx, dim=1))
    out = y_flat.new_zeros((t, y_flat.shape[1]))
    for j in range(k):
        out = out + y_pad[by_expert[:, j]]
    return out


def route(p, cfg: ModelConfig, xt: torch.Tensor):
    """The router and the dispatch of xt (T, D): the gathered (E, C, D)
    expert inputs in the compute dtype (zero in unfilled slots), `dispatch`'s
    slots and the (T, k) expert ids.  On a DTensor every rank routes the
    whole batch (the dispatch ranks tokens across it): the tokens and the
    router are replicated first, and the expert inputs come back replicated."""
    if placed.is_dtensor(xt):
        mesh = xt.device_mesh
        router = p.router
        router = placed.replicate(router).to_local() if placed.is_dtensor(router) else router
        x_g, slots, expert_idx = _route_whole(router, cfg, placed.replicate(xt).to_local())
        return placed.as_replicated(x_g, mesh), slots, expert_idx
    return _route_whole(p.router, cfg, xt)


def _route_whole(router: torch.Tensor, cfg: ModelConfig, xt: torch.Tensor):
    _, gate_vals, expert_idx = _gates(router, cfg, xt)
    if cfg.renorm_gates:
        gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    slots = dispatch(cfg, expert_idx, gate_vals)
    e, c, d = cfg.n_experts, slots["capacity"], xt.shape[-1]
    x_g = xt[slots["token_for_slot"]].reshape(e, c, d)
    x_g = torch.where(slots["valid"].reshape(e, c, 1), x_g, 0.0).to(cfg.compute_dtype)
    return x_g, slots, expert_idx


def tokstat(cfg: ModelConfig, z: torch.Tensor) -> torch.Tensor:
    """JAX's ``tokstat``: with ``moe_token_stationary`` an (E, C, .) DTensor's
    capacity axis goes to 'data' (the expert f-dim leaves 'model'), as
    ``with_sharding_constraint(z, P(None, "data", None))``; else ``z``."""
    if cfg.moe_token_stationary and placed.is_dtensor(z):
        return placed.redistribute(z, (None, "data", None))
    return z


def experts(p, cfg: ModelConfig, x_g: torch.Tensor) -> torch.Tensor:
    """Each expert's gated FFN on its (C, D) slots: (E, C, D) in the compute
    dtype, three batched products, `tokstat` at JAX's three points."""
    dt = cfg.compute_dtype
    x_g = tokstat(cfg, x_g)
    g = torch.bmm(x_g, p.w_gate.to(dt))
    h = torch.bmm(x_g, p.w_up.to(dt))
    h = tokstat(cfg, _gate_fn(cfg.act)(g) * h)
    return tokstat(cfg, torch.bmm(h, p.w_down.to(dt)))


def combine(y_g: torch.Tensor, slots: dict, expert_idx: torch.Tensor) -> torch.Tensor:
    """The gate-weighted combine of the experts' outputs (E, C, D): (T, D)
    f32, each token's kept contributions added in its experts' order.  A
    DTensor is replicated first (the gathers by token have no DTensor rule);
    the result is replicated."""
    if placed.is_dtensor(y_g):
        mesh = y_g.device_mesh
        return placed.as_replicated(combine(placed.replicate(y_g).to_local(), slots,
                                              expert_idx), mesh)
    e, c, d = y_g.shape
    y_flat = y_g.reshape(e * c, d).to(torch.float32) * slots["gate_for_slot"][:, None]
    y_flat = torch.where(slots["valid"][:, None], y_flat, 0.0)
    return _combine(y_flat, expert_idx, slots["slot_of"])


def moe_ffn(p, cfg: ModelConfig, x: torch.Tensor, *, trace: dict | None = None) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D) in the compute dtype: `route`, `experts`,
    `combine`.  ``trace``, if given, receives the routing (``expert_idx``
    and `dispatch`'s tensors)."""
    b, s, d = x.shape
    x_g, slots, expert_idx = route(p, cfg, x.reshape(b * s, d))
    if trace is not None:
        trace.update(slots, expert_idx=expert_idx)
    out = combine(experts(p, cfg, x_g), slots, expert_idx)
    return out.reshape(b, s, d).to(cfg.compute_dtype)


def router_load(cfg: ModelConfig, x: torch.Tensor, p):
    """Diagnostics: per-expert assignment counts (E,) and the dropped share
    of the assignments (a 0-d f32 tensor)."""
    b, s, d = x.shape
    t = b * s
    _, _, expert_idx = _route(p, cfg, x.reshape(t, d))
    counts = torch.bincount(expert_idx.reshape(-1), minlength=cfg.n_experts)
    c = capacity(cfg, t)
    dropped = torch.clamp_min(counts - c, 0).sum().to(torch.float32) / (t * cfg.top_k)
    return counts, dropped
