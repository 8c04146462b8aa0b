"""1-D Gaussian mixture (twin of `repro.core.gaussian`).

``E(x) = -log Σ_k w_k N(x; mu_k, sigma_k)``, so the Boltzmann law at
``beta = 1`` is the mixture.  A replica's state is one f32 scalar; a batch
is ``(R,)``.  The step is the JAX system's random-walk Metropolis step,
batched over replicas in torch on either device (no kernel): replica r's
key ``fold_in(fold_in(key, 2t), r)`` splits into a proposal key
(`keys.normal`) and an acceptance key (`keys.uniform`), and ``u <
exp(-beta de)`` accepts.  `keys.normal` is within 3 ulps of
``jax.random.normal`` (its ``erf_inv``), so ``x`` follows the JAX chain
within that bound, not bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.core import keys

__all__ = ["GaussianMixture"]


@dataclasses.dataclass(frozen=True)
class GaussianMixture:
    """Replica-batched 1-D Gaussian mixture (attributes as in the JAX twin)."""

    mus: tuple = (-4.0, 4.0)
    sigmas: tuple = (1.0, 1.0)
    weights: tuple = (0.5, 0.5)
    step_size: float = 1.0
    init_scale: float = 0.1

    @functools.lru_cache(maxsize=16)
    def _params(self, device):
        """(mus, sigmas, log weights, log sigmas, log(2 pi) / 2) as f32
        tensors on ``device``, made once per device (no host copy inside the
        interval loop)."""
        mus, sig, w = (torch.tensor(v, dtype=torch.float32, device=device)
                       for v in (self.mus, self.sigmas, self.weights))
        two_pi = torch.tensor(2 * math.pi, dtype=torch.float32, device=device)
        return mus, sig, torch.log(w), torch.log(sig), 0.5 * torch.log(two_pi)

    def init_state(self, key: torch.Tensor) -> torch.Tensor:
        """One () f32 state from a (2,) key (`init_state_batched`)."""
        return self.init_state_batched(key[None])[0]

    def init_state_batched(self, keys_: torch.Tensor) -> torch.Tensor:
        """(R,) f32: ``mus[0] + init_scale * normal(keys_[r], ())`` (the
        left mode, as the JAX system starts)."""
        mu0 = torch.tensor(self.mus[0], dtype=torch.float32, device=keys_.device)
        return mu0 + self.init_scale * keys.normal(keys_, ())

    def batched_energy(self, x: torch.Tensor) -> torch.Tensor:
        """(R,) f32 ``-logsumexp_k(log w_k - ((x - mu_k)/sigma_k)^2 / 2 -
        log sigma_k - log(2 pi) / 2)``, JAX's ``logsumexp`` order: the
        finite max, ``log Σ exp(a - max) + max``."""
        mus, sig, log_w, log_sig, half_log_2pi = self._params(x.device)
        z = (x[..., None] - mus) / sig
        logp = log_w - 0.5 * (z * z) - log_sig - half_log_2pi
        amax = logp.max(dim=-1).values
        amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
        return -(torch.log(torch.exp(logp - amax[..., None]).sum(dim=-1)) + amax)

    def batched_mcmc_step(self, key, t, x: torch.Tensor, betas: torch.Tensor,
                          replica_offset=0):
        """One Metropolis step of every replica (replica r keyed as slot
        ``replica_offset + r``); returns ``(x', delta_e (R,) f32, n_accepted
        (R,) int32)``."""
        ids = replica_offset + torch.arange(x.shape[0], dtype=torch.int64, device=x.device)
        # k_prop, k_u = split(key); one Threefry evaluation draws both words
        bits = keys.random_bits(keys.split(keys.replica_keys(key, t, ids)), ())  # (R, 2)
        trial = x + self.step_size * keys.normal_from_bits(bits[:, 0])
        e = self.batched_energy(torch.stack([trial, x]))
        de = e[0] - e[1]
        accept = keys.uniform_from_bits(bits[:, 1]) < torch.exp(-betas * de)
        return (torch.where(accept, trial, x), torch.where(accept, de, 0.0),
                accept.to(torch.int32))
