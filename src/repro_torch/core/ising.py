"""2-D Ising model (twin of `repro.core.ising`), paper Eq. (3) with PBC.

``E(σ) = B Σ_i σ_i − J Σ_<ij> σ_i σ_j``; spins are int8 in {−1, +1} and a
replica batch is ``(R, L, L)``.  ``update="single_flip"`` (the paper's
per-iteration update, any L) runs ``flips_per_step`` serial single-spin
flips a step, one launch of ``csrc/serial_chain.cu`` on the card (the
plain torch loop on the CPU), on the per-sweep path only.  The
checkerboard update (even L) runs on three
paths: per sweep (the default: ``jax.random`` uniforms, kernel #1), per
interval (``use_fused``: S sweeps per launch of kernel A, torch exchange)
or per round (``use_fused_round``: one launch of kernel A whose last block
runs the exchange).  On the two fused paths ``pack_bits`` swaps kernel A
for kernel #2p (multispin coding), with a bit-equal trajectory; the
per-sweep path ignores it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import keys

__all__ = ["IsingSystem", "lattice_energy", "magnetization"]


def lattice_energy(spins: torch.Tensor, j: float, b: float) -> torch.Tensor:
    """Per-replica energy, each bond once (right and down neighbours); f32."""
    s = spins.to(torch.float32)
    bonds = s * (torch.roll(s, -1, -1) + torch.roll(s, -1, -2))
    return b * s.sum(dim=(-2, -1)) - j * bonds.sum(dim=(-2, -1))


def magnetization(spins: torch.Tensor) -> torch.Tensor:
    """Mean spin per replica in [-1, 1]."""
    return spins.to(torch.float32).mean(dim=(-2, -1))


@dataclasses.dataclass(frozen=True)
class IsingSystem:
    """Replica-batched 2-D Ising model on the fused CUDA path.

    Attributes follow `repro.core.ising.IsingSystem`.  ``use_pallas`` and
    ``r_blk`` are TPU knobs: they are accepted and ignored, and on CUDA the
    hand-written kernel always runs.  ``pack_bits`` acts on the fused paths
    only, as in the JAX package.
    """

    length: int
    j: float = 1.0
    b: float = 0.0
    update: str = "checkerboard"
    flips_per_step: int = 1
    use_pallas: bool = False
    use_fused: bool = False
    use_fused_round: bool = False
    pack_bits: bool = False
    accept_rule: str = "metropolis"
    init_balance: float = 0.5
    r_blk: int = 8

    def __post_init__(self):
        if self.update not in ("checkerboard", "single_flip"):
            raise ValueError(f"unknown update mode {self.update!r}")
        if self.update == "checkerboard" and self.length % 2 != 0:
            raise ValueError(
                f"checkerboard update needs even L under PBC, got L={self.length}; "
                "use update='single_flip' for odd lattices"
            )
        if self.use_fused and self.update != "checkerboard":
            raise ValueError(
                "use_fused=True needs update='checkerboard' (the fused "
                "kernel is an interval of checkerboard sweeps)"
            )
        if self.use_fused_round and not self.use_fused:
            raise ValueError("use_fused_round=True needs use_fused=True")
        if self.accept_rule not in ("metropolis", "glauber"):
            raise ValueError(f"unknown acceptance rule {self.accept_rule!r}")

    def init_state(self, key: torch.Tensor) -> torch.Tensor:
        """One (L, L) int8 lattice from a (2,) key (`init_state_batched`)."""
        return self.init_state_batched(key[None])[0]

    def init_state_batched(self, keys_: torch.Tensor) -> torch.Tensor:
        """(R, L, L) int8 lattices, replica r from key ``keys_[r]``.

        Bit-equal to the JAX twin's ``vmap(init_state)`` over the same keys:
        ``uniform(key, (L, L)) < init_balance`` gives +1.
        """
        u = keys.uniform(keys_, (self.length, self.length))
        one = torch.ones((), dtype=torch.int8, device=u.device)
        return torch.where(u < self.init_balance, one, -one)

    def batched_energy(self, spins: torch.Tensor) -> torch.Tensor:
        return lattice_energy(spins, self.j, self.b)

    def batched_mcmc_step(self, key, t, spins, betas):
        """One sweep of every replica at its per-slot beta (the default path).

        Replica r's uniforms are ``uniform(fold_in(fold_in(key, 2t), r),
        (2, L, L))``: the JAX engine derives these per-replica keys before
        calling its ``batched_mcmc_step(keys, ...)``; here they are derived
        with the draw (`ops.jax_uniform`, one launch on CUDA), from the run
        key and the () sweep counter ``t``.  Then kernel #1 sweeps.  With
        ``update="single_flip"``, ``flips_per_step`` serial flips from the
        same replica keys instead (`ops.single_flip`, one launch on CUDA).
        """
        from repro_torch.kernels import ops

        if self.update == "single_flip":
            return ops.single_flip(spins, key, t, betas, j=self.j, b=self.b,
                                   rule=self.accept_rule, flips=self.flips_per_step)

        u = ops.jax_uniform(key, t, spins.shape[0], (2, self.length, self.length))
        return ops.ising_sweep(spins, u, betas, j=self.j, b=self.b,
                               rule=self.accept_rule)

    def batched_mcmc_interval(self, key, t, spins, betas, *, n_sweeps,
                              replica_offset=0):
        """``n_sweeps`` sweeps of every replica at its per-slot beta (kernel
        A, or #2p with ``pack_bits``)."""
        from repro_torch.kernels import ops

        return ops.ising_sweep_fused(
            spins, key, t, betas, n_sweeps=n_sweeps,
            replica_offset=replica_offset, j=self.j, b=self.b,
            rule=self.accept_rule, pack_bits=self.pack_bits,
        )

    def batched_mcmc_round(self, key, t, phase, spins, rung, energy, betas,
                           *, n_sweeps, n_rounds=1, criterion="logistic",
                           pairing="deo"):
        """``n_rounds`` whole PT rounds (one launch of kernel A or #2p per
        round, its last block running the exchange)."""
        from repro_torch.kernels import ops

        return ops.ising_round_fused(
            spins, key, t, phase, rung, energy, betas,
            n_sweeps=n_sweeps, n_rounds=n_rounds, j=self.j, b=self.b,
            rule=self.accept_rule, criterion=criterion, pairing=pairing,
            pack_bits=self.pack_bits,
        )
