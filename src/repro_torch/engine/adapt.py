"""In-loop ladder adaptation (twin of `repro.engine.adapt`).

Between chunks the engine reads the O(R) counters, pooled over the
ensemble axis when there is one (all chains share one ladder), and retunes
the interior rungs over the window since the last retune; the endpoints
stay pinned.  Two modes, host-side numpy identical to the JAX package:

* ``acceptance``: Kofke equalization of the per-pair swap acceptance
  (`core.ladder.tune_ladder`);
* ``flow``: Katzgraber feedback optimization from the measured flow
  fraction f(T) (`flow_optimized_ladder`); it needs ``swap_mode="temp"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import ladder as ladder_lib

__all__ = ["ADAPT_MODES", "AdaptConfig", "AdaptState", "flow_optimized_ladder",
           "maybe_adapt"]

ADAPT_MODES = ("acceptance", "flow")


@dataclasses.dataclass(frozen=True)
class AdaptConfig:
    """Feedback-loop configuration (see `repro.engine.adapt.AdaptConfig`)."""

    target: float = 0.23
    rate: float = 0.5
    min_attempts_per_pair: int = 20
    max_rounds: int | None = None
    mode: str = "acceptance"
    flow_min_visits: int = 100

    def __post_init__(self):
        if self.mode not in ADAPT_MODES:
            raise ValueError(
                f"unknown adapt mode {self.mode!r}; allowed: {list(ADAPT_MODES)}"
            )


@dataclasses.dataclass
class AdaptState:
    """Window baselines (counter snapshots at the last retune) + retune count.

    All four baselines ride in the checkpoint step meta (`to_meta`), so a
    resumed run re-enters the same window.
    """

    attempts_base: np.ndarray
    accepts_base: np.ndarray
    up_base: np.ndarray
    labeled_base: np.ndarray
    rounds: int = 0

    @classmethod
    def fresh(cls, n_replicas: int) -> "AdaptState":
        z = np.zeros((n_replicas,), np.float64)
        return cls(attempts_base=z, accepts_base=z.copy(), up_base=z.copy(),
                   labeled_base=z.copy())

    def rebase(self, counters: dict[str, np.ndarray]) -> None:
        """Move every baseline to the given cumulative counters."""
        self.attempts_base = np.asarray(counters["attempts"], np.float64)
        self.accepts_base = np.asarray(counters["accepts"], np.float64)
        self.up_base = np.asarray(counters["up"], np.float64)
        self.labeled_base = np.asarray(counters["labeled"], np.float64)

    def to_meta(self) -> dict:
        """JSON-able checkpoint form, in the JAX package's meta keys."""
        return {
            "adapt_attempts_base": self.attempts_base.tolist(),
            "adapt_accepts_base": self.accepts_base.tolist(),
            "adapt_up_base": self.up_base.tolist(),
            "adapt_labeled_base": self.labeled_base.tolist(),
        }

    @classmethod
    def from_meta(cls, meta: dict, rounds: int = 0) -> "AdaptState | None":
        """Rebuild from checkpoint meta (None when no baselines were saved;
        missing flow baselines are zeros)."""
        if "adapt_attempts_base" not in meta:
            return None
        attempts = np.asarray(meta["adapt_attempts_base"], np.float64)
        zeros = np.zeros_like(attempts)
        return cls(
            attempts_base=attempts,
            accepts_base=np.asarray(meta["adapt_accepts_base"], np.float64),
            up_base=np.asarray(meta.get("adapt_up_base", zeros), np.float64),
            labeled_base=np.asarray(meta.get("adapt_labeled_base", zeros), np.float64),
            rounds=rounds,
        )

    def zero(self) -> None:
        """Re-zero all baselines (after a stats reset zeroed the counters)."""
        z = np.zeros_like(self.attempts_base)
        self.attempts_base = z
        self.accepts_base = z.copy()
        self.up_base = z.copy()
        self.labeled_base = z.copy()


def flow_optimized_ladder(temps: np.ndarray, flow_up: np.ndarray,
                          rate: float = 1.0) -> np.ndarray:
    """One Katzgraber step: rungs at equal quantiles of ``∫ sqrt(Δf/ΔT)``.

    f is forced to 1 cold and 0 hot and made non-increasing; per-gap drops
    are floored at 1e-6 and gaps at 1e-12 (a collapsed gap attracts no
    density); a fully degenerate ladder is returned unchanged.  ``rate``
    blends old → optimal in log temperature; endpoints stay pinned.
    """
    temps = np.asarray(temps, np.float64)
    f = np.asarray(flow_up, np.float64).copy()
    r = temps.shape[0]
    if f.shape != (r,):
        raise ValueError(f"flow_up shape {f.shape} != temps shape {(r,)}")
    f[0], f[-1] = 1.0, 0.0
    f = np.minimum.accumulate(f)
    df = np.maximum(f[:-1] - f[1:], 1e-6)
    d_t = np.maximum(np.diff(temps), 1e-12)
    eta = np.sqrt(df / d_t)
    cum = np.concatenate([[0.0], np.cumsum(eta * d_t)])
    total = cum[-1]
    if not np.isfinite(total) or total <= 0.0:
        return temps.astype(np.float32)
    cum /= total
    optimal = np.interp(np.linspace(0.0, 1.0, r), cum, temps)
    new = np.exp((1.0 - rate) * np.log(temps) + rate * np.log(optimal))
    new[0], new[-1] = temps[0], temps[-1]
    return new.astype(np.float32)


def maybe_adapt(temps: np.ndarray, counters: dict[str, np.ndarray],
                adapt: AdaptConfig, st: AdaptState):
    """One feedback step if the window has enough signal.

    ``counters`` are the cumulative chain-pooled ``attempts`` / ``accepts``
    (lower-rung convention) and ``up`` / ``labeled`` (flow visits).  Returns
    ``(new_temps, feedback)``: the window's per-pair acceptance (R-1,) in
    ``acceptance`` mode or its flow fraction (R,) in ``flow`` mode; both
    None when the window is too thin or ``max_rounds`` was reached.
    """
    if adapt.max_rounds is not None and st.rounds >= adapt.max_rounds:
        return None, None
    if adapt.mode == "flow":
        up = np.asarray(counters["up"], np.float64)
        labeled = np.asarray(counters["labeled"], np.float64)
        w_lab = labeled - st.labeled_base
        if w_lab.min() < adapt.flow_min_visits:
            return None, None
        feedback = (up - st.up_base) / np.maximum(w_lab, 1.0)
        new_temps = flow_optimized_ladder(temps, feedback, rate=adapt.rate)
    else:
        attempts = np.asarray(counters["attempts"], np.float64)
        accepts = np.asarray(counters["accepts"], np.float64)
        w_att = (attempts - st.attempts_base)[:-1]  # the last rung is never "lower"
        if w_att.min() < adapt.min_attempts_per_pair:
            return None, None
        w_acc = (accepts - st.accepts_base)[:-1]
        feedback = w_acc / np.maximum(w_att, 1.0)
        new_temps = ladder_lib.tune_ladder(
            np.asarray(temps), feedback, target=adapt.target, rate=adapt.rate,
            t_min=float(temps[0]), t_max=float(temps[-1]),
        )
    st.rebase(counters)
    st.rounds += 1
    return new_temps, feedback
