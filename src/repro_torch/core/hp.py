"""HP lattice protein (twin of `repro.core.hp`).

A fixed H/P sequence folds as a self-avoiding chain on the 2-D square
lattice; every non-bonded H-H lattice contact adds ``-eps``.  A replica's
state is its ``(N, 2)`` int32 coordinate chain; a batch is ``(R, N, 2)``.
The move set is the JAX system's Verdier-Stockmayer set (end moves to a
uniform neighbour of the chain neighbour, corner flips), ``N`` moves a
step unless ``moves_per_step`` says otherwise, plain Metropolis.

The JAX system runs the moves as a ``lax.fori_loop`` under ``vmap``; here
`repro_torch.kernels.ops.hp_moves` runs them, one launch of
``csrc/serial_chain.cu`` a step on the card (one thread a chain) and the
plain torch loop, batched over replicas, on the CPU.  Both draw replica
r's moves from ``fold_in(fold_in(key, 2t), r)`` exactly as the JAX chain.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import keys
from repro_torch.kernels.serial_chain import HP_DIRECTIONS

__all__ = ["HPChain", "hp_energy", "radius_of_gyration_sq"]


@functools.lru_cache(maxsize=64)
def _hmask(sequence: str, device=None) -> torch.Tensor:
    """(N,) bool, True at H; one copy per sequence and device (no host
    copy inside the interval loop)."""
    if not sequence or set(sequence) - {"H", "P"}:
        raise ValueError(f"sequence must be a nonempty H/P string, got {sequence!r}")
    return torch.tensor([c == "H" for c in sequence], dtype=torch.bool, device=device)


def hp_energy(pos: torch.Tensor, hmask: torch.Tensor, eps: float) -> torch.Tensor:
    """``-eps`` × non-bonded H-H lattice contacts of each chain in ``pos``
    (..., N, 2); f32."""
    n = pos.shape[-2]
    manh = (pos[..., :, None, :] - pos[..., None, :, :]).abs().sum(dim=-1)
    idx = torch.arange(n, device=pos.device)
    nonbonded = (idx[:, None] - idx[None, :]).abs() > 1
    hm = hmask.to(device=pos.device, dtype=torch.float32)
    hh = hm[:, None] * hm[None, :]
    contacts = torch.where((manh == 1) & nonbonded, hh, 0.0).sum(dim=(-2, -1))
    return -eps * contacts / 2.0  # each unordered pair counted twice


def radius_of_gyration_sq(pos: torch.Tensor) -> torch.Tensor:
    """Squared radius of gyration of each chain in ``pos`` (..., N, 2); f32."""
    p = pos.to(torch.float32)
    c = p.mean(dim=-2, keepdim=True)
    return ((p - c) ** 2).sum(dim=-1).mean(dim=-1)


@dataclasses.dataclass(frozen=True)
class HPChain:
    """Replica-batched 2-D HP lattice protein (attributes as in the JAX twin)."""

    sequence: str
    eps: float = 1.0
    moves_per_step: int = 0

    def __post_init__(self):
        _hmask(self.sequence)  # validate eagerly
        if len(self.sequence) < 3:
            raise ValueError("HP chain needs at least 3 monomers")

    @property
    def n_monomers(self) -> int:
        return len(self.sequence)

    def _n_moves(self) -> int:
        return self.moves_per_step if self.moves_per_step > 0 else self.n_monomers

    def init_state(self, key: torch.Tensor) -> torch.Tensor:
        """One (N, 2) chain from a (2,) key (`init_state_batched`)."""
        return self.init_state_batched(key[None])[0]

    def init_state_batched(self, keys_: torch.Tensor) -> torch.Tensor:
        """(R, N, 2) int32 straight rods, replica r along direction
        ``randint(keys_[r], (), 0, 4)``."""
        dirs = torch.tensor(HP_DIRECTIONS, dtype=torch.int32, device=keys_.device)
        d = dirs[keys.randint(keys_, (), 0, 4).long()]  # (R, 2)
        steps = torch.arange(self.n_monomers, dtype=torch.int32, device=keys_.device)
        return steps[None, :, None] * d[:, None, :]

    def batched_energy(self, pos: torch.Tensor) -> torch.Tensor:
        return hp_energy(pos, _hmask(self.sequence, pos.device), self.eps)

    def batched_mcmc_step(self, key, t, pos: torch.Tensor, betas: torch.Tensor,
                          replica_offset=0):
        """``moves_per_step`` (default N) moves of every replica's chain
        (replica r keyed as slot ``replica_offset + r``); returns ``(pos',
        delta_e (R,) f32, n_accepted (R,) int32)``."""
        from repro_torch.kernels import ops

        return ops.hp_moves(pos, key, t, betas, hmask=_hmask(self.sequence, pos.device),
                            eps=self.eps, n_moves=self._n_moves(),
                            replica_offset=replica_offset)
