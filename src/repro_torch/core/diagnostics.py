"""Convergence and mixing diagnostics of PT traces (twin of
`repro.core.diagnostics`).

Host-side numpy post-processing of the engine's recorded series (``(T, R)``
arrays in rung order): the swap acceptance per rung pair, iterations to
convergence, Sokal's integrated autocorrelation time and the posterior mean
per rung.  The port keeps its own copy: it imports nothing of the JAX
package.
"""
from __future__ import annotations

import warnings

import numpy as np

__all__ = [
    "swap_acceptance_rate",
    "iterations_to_converge",
    "integrated_autocorrelation",
    "grand_mean_by_rung",
]


def swap_acceptance_rate(trace: dict) -> np.ndarray:
    """Mean accepted/attempted per adjacent rung pair, shape (R-1,).

    ``swap_accept`` / ``swap_attempt`` are recorded at the lower rung of each
    attempted pair.  Attempts come from the structural pairing mask when
    the trace carries it; a trace without ``swap_attempt`` falls back to
    ``swap_prob > 0`` (with a warning: a pair whose probability underflows
    to 0 in f32 is then not counted).
    """
    acc = np.asarray(trace["swap_accept"], dtype=np.float64)  # (T, R)
    if "swap_attempt" in trace:
        attempts = np.asarray(trace["swap_attempt"], dtype=np.float64).sum(axis=0)
    else:
        warnings.warn(
            "trace has no 'swap_attempt' channel; inferring attempts from "
            "swap_prob > 0, which undercounts pairs whose acceptance "
            "probability underflows to 0 in f32 (biasing the rate up). "
            "Re-record with an engine-era trace for exact counts.",
            RuntimeWarning,
            stacklevel=2,
        )
        prob = np.asarray(trace["swap_prob"], dtype=np.float64)
        attempts = (prob > 0).sum(axis=0)  # (R,)
    accepted = acc.sum(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        rate = np.where(attempts > 0, accepted / np.maximum(attempts, 1), 0.0)
    return rate[:-1]  # the last rung is never the lower member of a pair


def iterations_to_converge(series: np.ndarray, threshold: float, window: int = 8) -> int:
    """First index where a rolling mean of ``|series|`` over ``window``
    reaches ``threshold`` (the paper's Fig. 3b count: the cold Ising chain's
    |m| near saturation); -1 if it never does."""
    s = np.abs(np.asarray(series, dtype=np.float64))
    if len(s) < window:
        return -1
    roll = np.convolve(s, np.ones(window) / window, mode="valid")
    hits = np.nonzero(roll >= threshold)[0]
    return int(hits[0]) + window - 1 if len(hits) else -1


def integrated_autocorrelation(x: np.ndarray, c: float = 5.0) -> float:
    """Sokal's windowed integrated autocorrelation time of a scalar chain
    (FFT autocorrelation, window at ``c`` times the running estimate)."""
    x = np.asarray(x, dtype=np.float64)
    x = x - x.mean()
    n = len(x)
    if n < 8 or np.allclose(x, 0):
        return 1.0
    f = np.fft.rfft(x, n=2 * n)
    acf = np.fft.irfft(f * np.conjugate(f))[:n]
    acf /= acf[0]
    tau = 1.0
    for m in range(1, n):
        tau += 2.0 * acf[m]
        if m >= c * tau:
            break
    return float(max(tau, 1.0))


def grand_mean_by_rung(trace: dict, key: str, burn_frac: float = 0.5) -> np.ndarray:
    """Mean of the series ``key`` per rung over the trace after its first
    ``burn_frac`` (burn-in)."""
    arr = np.asarray(trace[key], dtype=np.float64)  # (T, R)
    t0 = int(len(arr) * burn_frac)
    return arr[t0:].mean(axis=0)
