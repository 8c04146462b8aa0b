"""Edwards-Anderson ±J spin glass (twin of `repro.core.spin_glass`).

``E(s) = -Σ_<xy> J_xy s_x s_y`` on an (H, W) periodic lattice with
quenched ±j bonds drawn from ``key(disorder_seed)``.  As in the JAX
package, each replica's state carries the coupling planes beside its
spins, ``{"spins" (H, W) int8, "jr" (H, W) f32, "jd" (H, W) f32}``, so
state-mode swaps, checkpoints and the ensemble axis move every leaf; every
replica holds the same planes.  ``jr[x, y]`` couples site (x, y) to its
right neighbour, ``jd`` to the one below.

The update is the checkerboard sweep of the JAX system in torch, batched
over replicas: the sweep's uniforms are the JAX engine's per-replica draw
``uniform(fold_in(fold_in(key, 2t), r), (2, H, W))`` (`ops.jax_uniform`,
one launch of ``csrc/jax_uniform.cu`` on the card), then both colours in
JAX's order of operations: the four-term field summed left to right, ``de
= 2 s field``, acceptance ``u < p(de)``.  No sweep kernel: the bond
disorder breaks the single-J tables of kernel #1, as it breaks the Pallas
kernel's premise in the JAX package.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import keys
from repro_torch.kernels import ref

__all__ = ["EASpinGlass", "ea_energy"]


def ea_energy(states: dict, j_scale: float = 1.0) -> torch.Tensor:
    """Per-replica ``-(Σ jr s s_right + Σ jd s s_down)`` with PBC; f32."""
    s = states["spins"].to(torch.float32)
    right = torch.roll(s, -1, -1)
    down = torch.roll(s, -1, -2)
    return -j_scale * (
        (states["jr"] * s * right).sum(dim=(-2, -1))
        + (states["jd"] * s * down).sum(dim=(-2, -1))
    )


@dataclasses.dataclass(frozen=True)
class EASpinGlass:
    """Replica-batched 2-D ±J EA spin glass (attributes as in the JAX twin)."""

    shape: tuple
    j: float = 1.0
    disorder_seed: int = 0
    accept_rule: str = "metropolis"

    def __post_init__(self):
        h, w = self.shape
        if h % 2 != 0 or w % 2 != 0:
            raise ValueError(f"checkerboard EA needs even dims under PBC, got {self.shape}")
        if self.accept_rule not in ("metropolis", "glauber"):
            raise ValueError(f"unknown acceptance rule {self.accept_rule!r}")

    def disorder(self, device=None) -> tuple[torch.Tensor, torch.Tensor]:
        """The quenched (H, W) f32 coupling planes ``(jr, jd)``:
        ``split(key(disorder_seed))``, each ``±j`` by ``uniform < 0.5``."""
        kr, kd = keys.split(keys.key(self.disorder_seed, device=device))
        j = torch.tensor(self.j, dtype=torch.float32, device=device)
        return tuple(torch.where(keys.uniform(k, tuple(self.shape)) < 0.5, j, -j)
                     for k in (kr, kd))

    def init_state(self, key: torch.Tensor) -> dict:
        """One replica's state from a (2,) key (`init_state_batched`)."""
        return {k: v[0] for k, v in self.init_state_batched(key[None]).items()}

    def init_state_batched(self, keys_: torch.Tensor) -> dict:
        """(R, H, W) leaves, replica r's spins from ``uniform(keys_[r], (H,
        W)) < 0.5`` (+1), each replica holding its own copy of the planes."""
        u = keys.uniform(keys_, tuple(self.shape))
        one = torch.ones((), dtype=torch.int8, device=u.device)
        jr, jd = self.disorder(u.device)
        r = keys_.shape[0]
        return {
            "spins": torch.where(u < 0.5, one, -one),
            "jr": jr.expand(r, *jr.shape).contiguous(),
            "jd": jd.expand(r, *jd.shape).contiguous(),
        }

    def batched_energy(self, states: dict) -> torch.Tensor:
        return ea_energy(states)

    def batched_mcmc_step(self, key, t, states: dict, betas: torch.Tensor,
                          replica_offset=0):
        """One checkerboard sweep (colour 0, then 1) of every replica at its
        per-slot beta, replica r drawing slot ``replica_offset + r``'s
        uniforms; returns ``(states', delta_e (R,) f32, n_accepted (R,)
        int32)``."""
        from repro_torch.kernels import ops

        h, w = self.shape
        r = betas.shape[0]
        u = ops.jax_uniform(key, t, r, (2, h, w), replica_offset)
        s = states["spins"].to(torch.float32)
        jr, jd = states["jr"], states["jd"]
        # the rolled planes do not change within the sweep
        jr_left, jd_up = torch.roll(jr, 1, -1), torch.roll(jd, 1, -2)
        par = ref.parity(h, w, s.device)
        beta = betas.to(torch.float32)[:, None, None]
        de_total = torch.zeros(r, dtype=torch.float32, device=s.device)
        n_acc = torch.zeros(r, dtype=torch.int32, device=s.device)
        for color in (0, 1):
            field = (
                jr * torch.roll(s, -1, -1)
                + jr_left * torch.roll(s, 1, -1)
                + jd * torch.roll(s, -1, -2)
                + jd_up * torch.roll(s, 1, -2)
            )
            de = 2.0 * s * field
            accept = (u[:, color] < ref.accept_prob(de, beta, self.accept_rule)) & (
                par == color)
            s = torch.where(accept, -s, s)
            de_total = de_total + torch.where(accept, de, 0.0).sum(dim=(-2, -1))
            n_acc = n_acc + accept.sum(dim=(-2, -1), dtype=torch.int32)
        return {**states, "spins": s.to(torch.int8)}, de_total, n_acc
