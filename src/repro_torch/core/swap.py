"""Replica-exchange pairing and acceptance (twin of `repro.core.swap`).

Alternating even/odd neighbour pairing, the logistic (paper) or Metropolis
swap probability on ``Δβ·ΔE``, and the acceptance core: one uniform per
rung, one decision per pair made at the lower member and broadcast to both.
"""
from __future__ import annotations

import torch

__all__ = ["pair_partners", "swap_probability", "accept_pairs"]


def pair_partners(n: int, phase, device=None) -> torch.Tensor:
    """(n,) int64 partner of each rung: phase 0 pairs (0,1),(2,3),…; phase 1
    pairs (1,2),(3,4),…; an unpaired boundary rung is its own partner.
    ``phase`` may be a device tensor (no host sync)."""
    if isinstance(phase, torch.Tensor):
        device = phase.device
    idx = torch.arange(n, dtype=torch.int64, device=device)
    ph = torch.as_tensor(phase, dtype=torch.int64, device=device) % 2
    even = idx ^ 1
    odd = torch.where(idx == 0, 0, ((idx - 1) ^ 1) + 1)
    partner = torch.where(ph == 0, even, odd)
    return torch.where(partner >= n, idx, partner)


def swap_probability(beta_lo, beta_hi, e_lo, e_hi, criterion: str = "logistic"):
    """Swap acceptance probability of pairs (lo, hi), symmetric in labelling."""
    arg = (beta_lo - beta_hi) * (e_lo - e_hi)
    if criterion == "logistic":
        return torch.sigmoid(arg)
    if criterion == "metropolis":
        return torch.clamp_max(torch.exp(torch.clamp_max(arg, 80.0)), 1.0)
    raise ValueError(f"unknown criterion {criterion!r}")


def accept_pairs(partner, betas, energies, criterion: str = "logistic", *, uniforms):
    """Accept/reject every proposed pair of an involution in parallel.

    ``uniforms`` is the (R,) f32 draw (one per rung).  Returns ``(perm,
    accept_at_lower, prob_at_lower, attempt_at_lower)`` in the conventions of
    `repro.core.swap.accept_pairs`: ``perm[r]`` is the rung whose state the
    holder of rung r receives.
    """
    n = partner.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=partner.device)
    lower = torch.minimum(idx, partner)
    is_lower = (partner != idx) & (idx == lower)
    p = swap_probability(
        betas, betas[partner], energies, energies[partner], criterion=criterion
    )
    accept_at_lower = (uniforms < p) & is_lower
    pair_accept = accept_at_lower[lower] & (partner != idx)
    perm = torch.where(pair_accept, partner, idx)
    prob_at_lower = torch.where(is_lower, p, 0.0)
    return perm, accept_at_lower, prob_at_lower, is_lower
