"""Replica-exchange strategies (twin of `repro.exchange`): DEO only so far.

The strategy path runs the swap phase of the ``use_fused`` (non-round)
engine path: DEO pairing plus `core.swap.accept_pairs` on
``uniform(fold_in(key, 2t+1), (R,))``.  SEO is resolvable by name because
the whole-round kernel implements its coin in-kernel, but SEO on the
strategy path (its coin is ``jax.random.randint``) and the ``windowed`` and
``vmpt`` strategies are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import swap as swap_lib

__all__ = ["ExchangeStrategy", "DEO", "SEO", "make_strategy", "available_strategies"]

_NOT_PORTED = ("windowed", "vmpt")


@dataclasses.dataclass(frozen=True)
class ExchangeStrategy:
    """Deterministic even/odd pairing plus the shared acceptance core."""

    name = "deo"
    n_virtual = 1

    def propose_pairs(self, phase, n: int, device=None) -> torch.Tensor:
        return swap_lib.pair_partners(n, phase, device=device)

    def accept(self, partner, betas, energies, criterion: str, *, uniforms):
        return swap_lib.accept_pairs(partner, betas, energies, criterion, uniforms=uniforms)


@dataclasses.dataclass(frozen=True)
class DEO(ExchangeStrategy):
    """Deterministic even/odd neighbour pairing (paper §3; the default)."""

    name = "deo"


@dataclasses.dataclass(frozen=True)
class SEO(ExchangeStrategy):
    """Stochastic even/odd: runs only inside the whole-round kernel."""

    name = "seo"

    def propose_pairs(self, phase, n, device=None):
        raise NotImplementedError(
            "not yet ported: SEO on the strategy path (its coin is "
            "jax.random.randint); use it with use_fused_round"
        )


_STRATEGIES = {"deo": DEO, "seo": SEO}


def available_strategies() -> list[str]:
    return sorted(_STRATEGIES)


def make_strategy(name=None, params=None) -> ExchangeStrategy:
    """Resolve a strategy name (None -> DEO); instances pass through."""
    if name is None:
        name = "deo"
    if isinstance(name, ExchangeStrategy):
        return name
    if name in _NOT_PORTED:
        raise NotImplementedError(f"not yet ported: exchange strategy {name!r}")
    if name not in _STRATEGIES:
        raise ValueError(
            f"unknown exchange strategy {name!r}; allowed: {available_strategies()}"
        )
    return _STRATEGIES[name]()
