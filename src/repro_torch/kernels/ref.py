"""Plain PyTorch versions of the sweeps and of the RWKV-6 recurrence
(twins of `repro.kernels.ref`).

These are the numerical contracts the CUDA kernels are held against and the
port's CPU path.  The op sequence is the JAX oracle's, so at ``j=1, b=0``
(every ΔE an integer) spins, ΔE and acceptance counts are bit-equal to it;
an acceptance ``u < p`` can still differ where the two frameworks' exp /
sigmoid differ by an ulp and ``u`` falls between them.  `wkv6` follows
its oracle line for line; its float sums are held to a tolerance.
"""
from __future__ import annotations

import torch

__all__ = ["accept_prob", "ising_sweep", "potts_sweep", "parity", "POTTS_DIRECTIONS",
           "wkv6"]


def accept_prob(de: torch.Tensor, beta, rule: str) -> torch.Tensor:
    """Per-site acceptance probability: ``metropolis`` exp(-βΔE) (u in [0,1)
    makes ΔE <= 0 accept) or ``glauber`` heat-bath sigmoid(-βΔE)."""
    if rule == "metropolis":
        return torch.exp(-beta * de)
    if rule == "glauber":
        return torch.sigmoid(-beta * de)
    raise ValueError(f"unknown acceptance rule {rule!r}")


def parity(height: int, width: int, device) -> torch.Tensor:
    """(H, W) checkerboard colour map, ``(i + j) % 2``."""
    ii = torch.arange(height, device=device)
    jj = torch.arange(width, device=device)
    return (ii[:, None] + jj[None, :]) % 2


def ising_sweep(
    spins: torch.Tensor,
    u: torch.Tensor,
    betas: torch.Tensor,
    *,
    j: float,
    b: float,
    rule: str = "metropolis",
):
    """One checkerboard sweep (colour 0, then 1), batched over replicas.

    Args:
      spins: (R, L, L) int8 in {-1, +1}.
      u: (R, 2, L, L) f32 uniforms in [0, 1), one lattice per colour.
      betas: (R,) f32 inverse temperatures.

    Returns ``(spins' int8, delta_e (R,) f32, n_accepted (R,) int32)``.
    """
    par = parity(spins.shape[-2], spins.shape[-1], spins.device)
    beta = betas.to(torch.float32)[:, None, None]
    s = spins.to(torch.float32)
    de_total = torch.zeros(spins.shape[0], dtype=torch.float32, device=spins.device)
    n_acc = torch.zeros(spins.shape[0], dtype=torch.int32, device=spins.device)
    for color in (0, 1):
        nbr = (
            torch.roll(s, 1, -2) + torch.roll(s, -1, -2)
            + torch.roll(s, 1, -1) + torch.roll(s, -1, -1)
        )
        de = 2.0 * s * (j * nbr - b)
        accept = (u[:, color] < accept_prob(de, beta, rule)) & (par == color)
        s = torch.where(accept, -s, s)
        de_total = de_total + torch.where(accept, de, 0.0).sum(dim=(-2, -1))
        n_acc = n_acc + accept.sum(dim=(-2, -1), dtype=torch.int32)
    return s.to(torch.int8), de_total, n_acc


# (dim, shift) of the four neighbours in the order ΔE accumulates them:
# up, down, left, right (``roll(s, 1, -2)`` holds the site above)
POTTS_DIRECTIONS = ((-2, 1), (-2, -1), (-1, 1), (-1, -1))


def potts_sweep(
    states: torch.Tensor,
    u: torch.Tensor,
    betas: torch.Tensor,
    *,
    q: int,
    j: float,
    rule: str = "metropolis",
):
    """One checkerboard sweep of the q-state Potts model, batched over replicas.

    The proposal is ``trial = (s + d) % q`` with ``d = 1 + floor(u_prop *
    (q-1))``, a uniformly random different colour; ΔE adds ``j * ([s ==
    nbr] - [trial == nbr])`` over the four neighbours in `POTTS_DIRECTIONS`
    order, as the JAX oracle does.

    Args:
      states: (R, H, W) int8 colours in {0..q-1}.
      u: (R, 2, 2, H, W) f32 uniforms: colour x (proposal, acceptance).
      betas: (R,) f32 inverse temperatures.

    Returns ``(states' int8, delta_e (R,) f32, n_accepted (R,) int32)``.
    """
    h, w = states.shape[-2], states.shape[-1]
    par = parity(h, w, states.device)
    beta = betas.to(torch.float32)[:, None, None]
    s = states.to(torch.int32)
    de_total = torch.zeros(states.shape[0], dtype=torch.float32, device=states.device)
    n_acc = torch.zeros(states.shape[0], dtype=torch.int32, device=states.device)
    for color in (0, 1):
        d = 1 + torch.floor(u[:, color, 0] * (q - 1)).to(torch.int32)
        trial = (s + d) % q
        de = torch.zeros(s.shape, dtype=torch.float32, device=s.device)
        for dim, shift in POTTS_DIRECTIONS:
            nbr = torch.roll(s, shift, dim)
            de = de + j * ((s == nbr).to(torch.float32) - (trial == nbr).to(torch.float32))
        accept = (u[:, color, 1] < accept_prob(de, beta, rule)) & (par == color)
        s = torch.where(accept, trial, s)
        de_total = de_total + torch.where(accept, de, 0.0).sum(dim=(-2, -1))
        n_acc = n_acc + accept.sum(dim=(-2, -1), dtype=torch.int32)
    return s.to(torch.int8), de_total, n_acc


def wkv6(r, k, v, w, u, initial_state=None):
    """RWKV-6 ("Finch") recurrence, one batch*head slab at a time.

    Per head, with state ``S`` of shape (dk, dv)::

        o_t = r_t @ S_{t-1}  +  (r_t · (u ⊙ k_t)) v_t
        S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t

    Args:
      r, k, w: (BH, T, dk) f32 (w already exp(-exp(...))-activated).
      v: (BH, T, dv) f32; u: (BH, dk) f32 "bonus" for the current token.
      initial_state: optional (BH, dk, dv) f32 (decode); zeros otherwise.

    Returns (o (BH, T, dv) f32, final_state (BH, dk, dv) f32).
    """
    bh, t, dk = r.shape
    dv = v.shape[-1]
    if initial_state is None:
        s = torch.zeros((bh, dk, dv), dtype=torch.float32, device=r.device)
    else:
        s = initial_state.to(torch.float32)
    outs = []
    for i in range(t):
        rt, kt, vt, wt = r[:, i], k[:, i], v[:, i], w[:, i]
        bonus = torch.sum(rt * u * kt, dim=-1, keepdim=True)
        outs.append(torch.einsum("bk,bkv->bv", rt, s) + bonus * vt)
        s = wt[:, :, None] * s + kt[:, :, None] * vt[:, None, :]
    return torch.stack(outs, dim=1), s
