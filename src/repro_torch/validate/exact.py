"""Exact ground truth for the port's validation zoo (twin of `repro.validate.exact`).

Per-temperature Boltzmann expectations computed outside the sampler, by
brute-force enumeration of every configuration in float64 numpy: 2^16
configurations for the 4x4 Ising entry, 3^16 for the 4x4 q=3 Potts entry
(chunked, ~20 s; its conformance case rides the ``slow`` tier).  The port
keeps its own copy: it imports nothing of the JAX package.  The exact
references of the other zoo systems wait with their systems.
"""
from __future__ import annotations

import numpy as np

__all__ = ["boltzmann_means", "ising_exact", "potts_exact"]


def boltzmann_means(energies: np.ndarray, observables: dict, temps) -> dict[str, np.ndarray]:
    """Boltzmann expectations over an explicit configuration list.

    Args:
      energies: (M,) energy of every configuration.
      observables: {name: (M,) per-configuration values}.
      temps: (R,) temperatures.

    Returns ``{"energy": (R,), **{name: (R,)}}`` with
    ``<f>_T = sum_c f(c) e^{-E_c/T} / Z_T`` (max-shifted for stability).
    """
    e = np.asarray(energies, np.float64)
    betas = 1.0 / np.asarray(temps, np.float64)
    logw = -betas[:, None] * e[None, :]  # (R, M)
    logw -= logw.max(axis=1, keepdims=True)
    w = np.exp(logw)
    z = w.sum(axis=1)
    out = {"energy": (w * e[None, :]).sum(axis=1) / z}
    for name, vals in observables.items():
        out[name] = (w * np.asarray(vals, np.float64)[None, :]).sum(axis=1) / z
    return out


def _spin_configs(n_sites: int) -> np.ndarray:
    """All 2^n ±1 configurations, shape (2^n, n) int8."""
    ints = np.arange(1 << n_sites, dtype=np.int64)
    bits = (ints[:, None] >> np.arange(n_sites)) & 1
    return (2 * bits - 1).astype(np.int8)


def ising_exact(system, temps) -> dict[str, np.ndarray]:
    """Exact ⟨E⟩ / ⟨|m|⟩ for `repro_torch.core.ising.IsingSystem` (PBC Eq. 3)."""
    length = system.length
    s = _spin_configs(length * length).reshape(-1, length, length).astype(np.float64)
    bonds = s * (np.roll(s, -1, axis=2) + np.roll(s, -1, axis=1))
    e = system.b * s.sum(axis=(1, 2)) - system.j * bonds.sum(axis=(1, 2))
    absm = np.abs(s.mean(axis=(1, 2)))
    return boltzmann_means(e, {"absmag": absm}, temps)


def potts_exact(system, temps, chunk: int = 1 << 18) -> dict[str, np.ndarray]:
    """Exact ⟨E⟩ / ⟨m⟩ for `repro_torch.core.potts.PottsSystem` by a chunked
    sweep over all q^(H·W) configurations (mixed-radix decode, float64
    accumulators; weights shifted by the -2·J·n energy lower bound so the
    exponents stay finite at every validation temperature)."""
    h, w = system.shape
    q, j = system.q, system.j
    n = h * w
    total = q**n
    betas = 1.0 / np.asarray(temps, np.float64)
    e_ref = -abs(j) * 2 * n
    zw = np.zeros(len(betas))
    ze = np.zeros(len(betas))
    zm = np.zeros(len(betas))
    for start in range(0, total, chunk):
        m = min(chunk, total - start)
        ints = np.arange(start, start + m, dtype=np.int64)
        digits = np.empty((m, n), np.int8)
        for k in range(n):
            digits[:, k] = ints % q
            ints //= q
        s = digits.reshape(m, h, w)
        match = (s == np.roll(s, -1, axis=2)).sum(axis=(1, 2)) + (
            s == np.roll(s, -1, axis=1)
        ).sum(axis=(1, 2))
        e = -j * match.astype(np.float64)
        counts = np.stack([(s == c).sum(axis=(1, 2)) for c in range(q)], axis=1)
        mag = (q * counts.max(axis=1) / n - 1.0) / (q - 1.0)
        for bi, b in enumerate(betas):
            wgt = np.exp(-b * (e - e_ref))
            zw[bi] += wgt.sum()
            ze[bi] += (wgt * e).sum()
            zm[bi] += (wgt * mag).sum()
    return {"energy": ze / zw, "pmag": zm / zw}
