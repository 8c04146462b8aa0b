"""Temperature ladders (twin of `repro.core.ladder`), cold to hot, k_B = 1.

Ladders are host-side float32 numpy arrays computed with the JAX package's
f32 op sequence, so ``paper_ladder`` gives the same bits as its twin.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "paper_ladder",
    "linear_ladder",
    "geometric_ladder",
    "betas_from_temps",
    "tune_ladder",
]


def paper_ladder(n_replicas: int, t_min: float = 1.0, t_span: float = 3.0) -> np.ndarray:
    """The paper's ladder ``T_i = t_min + i * t_span / R`` (hot end exclusive)."""
    i = np.arange(n_replicas, dtype=np.float32)
    return np.float32(t_min) + i * np.float32(t_span / n_replicas)


def linear_ladder(n_replicas: int, t_min: float, t_max: float) -> np.ndarray:
    """Inclusive linear ladder on ``[t_min, t_max]``.

    Within an ulp of ``jnp.linspace`` but not bit-equal to it (XLA's f32
    evaluation order is not reproduced); the paper and geometric ladders are.
    """
    return np.linspace(t_min, t_max, n_replicas, dtype=np.float32)


def geometric_ladder(n_replicas: int, t_min: float, t_max: float) -> np.ndarray:
    """Geometric ladder: constant ratio ``T_{i+1} / T_i``."""
    return np.geomspace(t_min, t_max, n_replicas).astype(np.float32)


def betas_from_temps(temps) -> np.ndarray:
    return (1.0 / np.asarray(temps)).astype(np.float32)


def tune_ladder(
    temps: np.ndarray,
    swap_acceptance: np.ndarray,
    target: float = 0.23,
    rate: float = 0.5,
    t_min: float | None = None,
    t_max: float | None = None,
) -> np.ndarray:
    """One feedback step of acceptance-equalizing ladder adaptation.

    Gaps whose measured swap acceptance exceeds ``target`` widen, the others
    narrow (in log spacing); the endpoints are pinned to ``t_min``/``t_max``
    or the current ends.  Host-side numpy, as in the JAX package.
    """
    temps = np.asarray(temps, dtype=np.float64)
    acc = np.clip(np.asarray(swap_acceptance, dtype=np.float64), 1e-3, 1.0)
    log_gaps = np.diff(np.log(temps))
    log_gaps = log_gaps * (1.0 + rate * np.tanh(np.log(acc / target)))
    new = np.concatenate([[np.log(temps[0])], np.log(temps[0]) + np.cumsum(log_gaps)])
    new = np.exp(new)
    lo = temps[0] if t_min is None else t_min
    hi = temps[-1] if t_max is None else t_max
    new = lo + (new - new[0]) * (hi - lo) / max(new[-1] - new[0], 1e-12)
    return new.astype(np.float32)
