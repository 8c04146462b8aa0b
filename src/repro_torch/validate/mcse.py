"""ESS / MCSE via batch means over the engine's Welford accumulators
(twin of `repro.validate.mcse`).

The engine keeps no sample trace, so uncertainty comes from batch means: the
measurement runs as ``B`` windows with the moment accumulators reset between
them, each chain x window Welford mean is one batch mean, and

    MCSE(grand mean) = sd(batch means) / sqrt(M)

over the ``M = B x n_chains`` batches (chains are independent).
`effective_sample_size` inverts that relation and `geweke_z` compares an
early and a late segment.  Host-side numpy, the JAX package's arithmetic.
"""
from __future__ import annotations

import numpy as np

__all__ = ["batch_mean_stats", "effective_sample_size", "geweke_z"]


def batch_mean_stats(batch_means: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Grand mean and MCSE from per-batch means.

    Args:
      batch_means: (M, ...) one row per batch (chain x window).

    Returns ``(grand_mean, mcse, M)`` with ``mcse = sd(ddof=1) / sqrt(M)``.
    """
    bm = np.asarray(batch_means, np.float64)
    m = bm.shape[0]
    if m < 2:
        raise ValueError(f"batch means need M >= 2 batches, got {m}")
    return bm.mean(axis=0), bm.std(axis=0, ddof=1) / np.sqrt(m), m


def effective_sample_size(pooled_var: np.ndarray, mcse: np.ndarray) -> np.ndarray:
    """ESS implied by a variance and an MCSE (the n with sd/sqrt(n) = MCSE);
    a zero-variance series reports 0 ("no information")."""
    v = np.asarray(pooled_var, np.float64)
    se2 = np.asarray(mcse, np.float64) ** 2
    return np.where(se2 > 0, v / np.maximum(se2, 1e-300), 0.0)


def geweke_z(first: np.ndarray, second: np.ndarray) -> np.ndarray:
    """Drift z-score ``(mean_1 - mean_2) / sqrt(se_1² + se_2²)`` between two
    disjoint segments of batch means; 0 when both errors are 0 and the means
    agree, ±inf when they differ."""
    m1, se1, _ = batch_mean_stats(first)
    m2, se2, _ = batch_mean_stats(second)
    denom = np.sqrt(se1**2 + se2**2)
    diff = m1 - m2
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.where(
            denom > 0, diff / np.maximum(denom, 1e-300),
            np.where(diff == 0, 0.0, np.inf * np.sign(diff)),
        )
    return z
