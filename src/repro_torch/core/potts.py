"""q-state Potts model (twin of `repro.core.potts`).

``E(s) = -J Σ_<xy> δ(s_x, s_y)`` with periodic boundaries on an (H, W)
lattice, each bond once; colours are int8 in {0..q-1}.  The checkerboard
update proposes a uniformly random different colour.  It runs on the same
three paths as `repro_torch.core.ising.IsingSystem`: per sweep (kernel #4
on ``jax.random`` uniforms), per interval (``use_fused``: kernel #5) and per
round (``use_fused_round``: one launch of kernel #5 a round, its last
block running the exchange).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import keys

__all__ = ["PottsSystem", "potts_energy", "potts_magnetization"]


def potts_energy(states: torch.Tensor, q: int, j: float) -> torch.Tensor:
    """Per-replica ``-j`` × (matching right + down bonds); f32."""
    s = states.to(torch.int32)
    match = (s == torch.roll(s, -1, -1)).to(torch.float32) + (
        s == torch.roll(s, -1, -2)
    ).to(torch.float32)
    return -j * match.sum(dim=(-2, -1))


def potts_magnetization(states: torch.Tensor, q: int) -> torch.Tensor:
    """Order parameter ``(q * rho_max - 1) / (q - 1)`` per replica, where
    ``rho_max`` is the occupation fraction of the most common colour."""
    s = states.to(torch.int32)
    n = s.shape[-2] * s.shape[-1]
    counts = torch.stack(
        [(s == c).to(torch.float32).sum(dim=(-2, -1)) for c in range(q)], dim=-1
    )
    rho_max = counts.max(dim=-1).values / n
    return (q * rho_max - 1.0) / (q - 1.0)


@dataclasses.dataclass(frozen=True)
class PottsSystem:
    """Replica-batched q-state Potts model.

    Attributes follow `repro.core.potts.PottsSystem`.  ``use_pallas`` and
    ``r_blk`` are TPU knobs, accepted and ignored.  ``pack_bits`` (int8
    lanes, q <= 64) is what kernel #5 always does, so it changes nothing but
    keeps the JAX package's ``q > 64`` refusal.
    """

    shape: tuple
    q: int = 3
    j: float = 1.0
    use_pallas: bool = False
    use_fused: bool = False
    use_fused_round: bool = False
    pack_bits: bool = False
    accept_rule: str = "metropolis"
    r_blk: int = 4

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(x) for x in self.shape))
        h, w = self.shape
        if h % 2 != 0 or w % 2 != 0:
            raise ValueError(
                f"checkerboard Potts needs even dims under PBC, got {self.shape}"
            )
        if self.q < 2:
            raise ValueError(f"Potts needs q >= 2, got q={self.q}")
        if self.use_fused_round and not self.use_fused:
            raise ValueError("use_fused_round=True needs use_fused=True")
        if self.pack_bits and self.q > 64:
            raise ValueError(f"pack_bits needs q <= 64 (int8 lanes), got q={self.q}")
        if self.accept_rule not in ("metropolis", "glauber"):
            raise ValueError(f"unknown acceptance rule {self.accept_rule!r}")

    def init_state_batched(self, keys_: torch.Tensor) -> torch.Tensor:
        """(R, H, W) int8 colours, replica r from ``randint(keys_[r], shape, 0, q)``,
        bit-equal to the JAX twin's ``vmap(init_state)``."""
        return keys.randint(keys_, self.shape, 0, self.q).to(torch.int8)

    def batched_energy(self, states: torch.Tensor) -> torch.Tensor:
        return potts_energy(states, self.q, self.j)

    def batched_mcmc_step(self, key, t, states, betas, replica_offset=0):
        """One sweep of every replica (the default path); the uniforms are
        ``uniform(fold_in(fold_in(key, 2t), replica_offset + r), (2, 2, H,
        W))`` as in `IsingSystem.batched_mcmc_step`, then kernel #4 sweeps."""
        from repro_torch.kernels import ops

        u = ops.jax_uniform(key, t, states.shape[0], (2, 2, *self.shape), replica_offset)
        return ops.potts_sweep(states, u, betas, q=self.q, j=self.j,
                               rule=self.accept_rule)

    def batched_mcmc_interval(self, key, t, states, betas, *, n_sweeps,
                              replica_offset=0):
        """``n_sweeps`` sweeps of every replica at its per-slot beta (kernel #5)."""
        from repro_torch.kernels import ops

        return ops.potts_sweep_fused(
            states, key, t, betas, n_sweeps=n_sweeps, q=self.q,
            replica_offset=replica_offset, j=self.j, rule=self.accept_rule,
            pack_bits=self.pack_bits,
        )

    def batched_mcmc_round(self, key, t, phase, states, rung, energy, betas,
                           *, n_sweeps, n_rounds=1, criterion="logistic",
                           pairing="deo"):
        """``n_rounds`` whole PT rounds (one launch of kernel #5 per round,
        its last block running the exchange)."""
        from repro_torch.kernels import ops

        return ops.potts_round_fused(
            states, key, t, phase, rung, energy, betas,
            n_sweeps=n_sweeps, q=self.q, n_rounds=n_rounds, j=self.j,
            rule=self.accept_rule, criterion=criterion, pairing=pairing,
            pack_bits=self.pack_bits,
        )
