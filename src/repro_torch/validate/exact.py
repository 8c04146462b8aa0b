"""Exact ground truth for the port's validation zoo (twin of `repro.validate.exact`).

Per-temperature Boltzmann expectations computed outside the sampler, in
float64 numpy: brute-force enumeration of every configuration for the
discrete systems (2^16 for the 4x4 Ising and EA entries, 3^16 for the 4x4
q=3 Potts entry, chunked, ~20 s, so its conformance case rides the
``slow`` tier; every self-avoiding walk for short HP chains), trapezoidal
quadrature for the Gaussian mixture.  `hp_move_graph_connected` checks by
breadth-first search that the HP chain's end and corner moves reach every
walk of a length.  The port keeps its own copy: it imports nothing of the
JAX package.
"""
from __future__ import annotations

import functools
from collections import deque

import numpy as np

__all__ = [
    "boltzmann_means",
    "ising_exact",
    "potts_exact",
    "ea_exact",
    "gaussian_exact",
    "hp_exact",
    "enumerate_saws",
    "hp_move_graph_connected",
]


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


def ea_exact(system, temps) -> dict[str, np.ndarray]:
    """Exact ⟨E⟩ / ⟨|m|⟩ for `repro_torch.core.spin_glass.EASpinGlass`, on
    the system's own quenched couplings (the planes every replica carries)."""
    h, w = system.shape
    jr, jd = (np.asarray(x, np.float64) for x in system.disorder())
    s = _spin_configs(h * w).reshape(-1, h, w).astype(np.float64)
    e = -(jr[None] * s * np.roll(s, -1, axis=2)).sum(axis=(1, 2)) - (
        jd[None] * s * np.roll(s, -1, axis=1)
    ).sum(axis=(1, 2))
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


# -- Gaussian mixture ----------------------------------------------------------


def gaussian_exact(
    system, temps, *, span: float = 12.0, n_grid: int = 40001
) -> dict[str, np.ndarray]:
    """Quadrature moments for `repro_torch.core.gaussian.GaussianMixture`.

    The tempered density ``p_beta(x) ∝ exp(-beta E(x))`` has no closed form
    for K > 1 components, so ⟨E⟩ and ⟨|x|⟩ come from trapezoidal quadrature
    on a grid spanning ``span`` standard deviations past the extreme modes
    (refinement error ~1e-10).
    """
    mus = np.asarray(system.mus, np.float64)
    sig = np.asarray(system.sigmas, np.float64)
    wts = np.asarray(system.weights, np.float64)
    lo = (mus - span * sig).min()
    hi = (mus + span * sig).max()
    x = np.linspace(lo, hi, n_grid)
    comp = (
        np.log(wts)[:, None]
        - 0.5 * ((x[None, :] - mus[:, None]) / sig[:, None]) ** 2
        - np.log(sig)[:, None]
        - 0.5 * np.log(2 * np.pi)
    )
    cmax = comp.max(axis=0)
    energy = -(cmax + np.log(np.exp(comp - cmax[None, :]).sum(axis=0)))

    betas = 1.0 / np.asarray(temps, np.float64)
    logw = -betas[:, None] * energy[None, :]
    logw -= logw.max(axis=1, keepdims=True)
    w = np.exp(logw)
    trapz = getattr(np, "trapezoid", None) or np.trapz  # numpy 2 renamed trapz
    z = trapz(w, x, axis=1)

    def mean_of(f):
        return trapz(w * f[None, :], x, axis=1) / z

    return {"energy": mean_of(energy), "absx": mean_of(np.abs(x))}


# -- HP lattice protein --------------------------------------------------------

_DIRS = ((1, 0), (-1, 0), (0, 1), (0, -1))


@functools.lru_cache(maxsize=8)
def enumerate_saws(n_steps: int) -> np.ndarray:
    """All self-avoiding walks of ``n_steps`` from the origin.

    Returns (M, n_steps+1, 2) int64, monomer 0 at the origin, all four
    first-step directions included: the chain's state space modulo
    translation (every observable is translation-invariant).
    """
    out: list[tuple] = []
    path = [(0, 0)]
    occ = {(0, 0)}

    def rec():
        if len(path) == n_steps + 1:
            out.append(tuple(path))
            return
        x, y = path[-1]
        for dx, dy in _DIRS:
            p = (x + dx, y + dy)
            if p not in occ:
                occ.add(p)
                path.append(p)
                rec()
                path.pop()
                occ.remove(p)

    rec()
    return np.asarray(out, np.int64)


def hp_exact(system, temps) -> dict[str, np.ndarray]:
    """Exact ⟨E⟩ / ⟨R_g²⟩ for `repro_torch.core.hp.HPChain` over all SAWs."""
    n = system.n_monomers
    pos = enumerate_saws(n - 1).astype(np.float64)  # (M, N, 2)
    hmask = np.asarray([c == "H" for c in system.sequence], np.float64)
    manh = np.abs(pos[:, :, None, :] - pos[:, None, :, :]).sum(axis=-1)
    idx = np.arange(n)
    nonbonded = np.abs(idx[:, None] - idx[None, :]) > 1
    hh = hmask[:, None] * hmask[None, :]
    contacts = ((manh == 1) & nonbonded[None]) * hh[None]
    e = -system.eps * contacts.sum(axis=(1, 2)) / 2.0
    c = pos.mean(axis=1, keepdims=True)
    rg2 = ((pos - c) ** 2).sum(axis=-1).mean(axis=1)
    return boltzmann_means(e, {"rg2": rg2}, temps)


def _hp_neighbors(path: tuple) -> list[tuple]:
    """The walks one accepted end or corner move away from ``path``, each
    translated so its monomer 0 sits at the origin: the proposal set of
    `repro_torch.core.hp.HPChain`, on the host, for the breadth-first search."""
    n = len(path)
    occ = set(path)
    res = []
    for i in range(n):
        if i == 0 or i == n - 1:
            ax, ay = path[1] if i == 0 else path[n - 2]
            for dx, dy in _DIRS:
                c = (ax + dx, ay + dy)
                if c != path[i] and c not in occ:
                    q = list(path)
                    q[i] = c
                    res.append(q)
        else:
            a, b = path[i - 1], path[i + 1]
            if a[0] != b[0] and a[1] != b[1]:
                c = (a[0] + b[0] - path[i][0], a[1] + b[1] - path[i][1])
                if c not in occ:
                    q = list(path)
                    q[i] = c
                    res.append(q)
    norm = []
    for q in res:
        x0, y0 = q[0]
        norm.append(tuple((x - x0, y - y0) for x, y in q))
    return norm


def hp_move_graph_connected(n_monomers: int) -> bool:
    """True iff end and corner moves reach every SAW of ``n_monomers``
    monomers from the straight rod (the move set is not ergodic for long
    chains; the HP conformance entry is sound while this holds)."""
    target = {tuple(map(tuple, p)) for p in enumerate_saws(n_monomers - 1)}
    start = tuple((i, 0) for i in range(n_monomers))
    seen = {start}
    dq = deque([start])
    while dq:
        s = dq.popleft()
        for t in _hp_neighbors(s):
            if t not in seen:
                seen.add(t)
                dq.append(t)
    return seen == target
