"""In-loop ladder adaptation, acceptance mode (twin of `repro.engine.adapt`).

Between chunks the engine reads the O(R) swap counters, computes per-pair
acceptance over the window since the last retune, and retunes the interior
rungs with `core.ladder.tune_ladder` (Kofke equalization); the endpoints
stay pinned.  Host-side numpy, identical to the JAX package.  The ``flow``
mode is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import ladder as ladder_lib

__all__ = ["ADAPT_MODES", "AdaptConfig", "AdaptState", "maybe_adapt"]

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
        if self.mode == "flow":
            raise NotImplementedError("not yet ported: adapt mode 'flow'")


@dataclasses.dataclass
class AdaptState:
    """Window baselines (counter snapshots at the last retune) + retune count."""

    attempts_base: np.ndarray
    accepts_base: np.ndarray
    rounds: int = 0

    @classmethod
    def fresh(cls, n_replicas: int) -> "AdaptState":
        z = np.zeros((n_replicas,), np.float64)
        return cls(attempts_base=z, accepts_base=z.copy())

    def rebase(self, counters: dict[str, np.ndarray]) -> None:
        self.attempts_base = np.asarray(counters["attempts"], np.float64)
        self.accepts_base = np.asarray(counters["accepts"], np.float64)

    def zero(self) -> None:
        self.attempts_base = np.zeros_like(self.attempts_base)
        self.accepts_base = np.zeros_like(self.accepts_base)


def maybe_adapt(temps: np.ndarray, counters: dict[str, np.ndarray],
                adapt: AdaptConfig, st: AdaptState):
    """One feedback step if every pair has enough attempts in the window.

    Returns ``(new_temps, per-pair acceptance)``, or ``(None, None)`` when the
    window is too thin or ``max_rounds`` was reached.
    """
    if adapt.max_rounds is not None and st.rounds >= adapt.max_rounds:
        return None, None
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
