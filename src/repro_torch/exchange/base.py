"""The replica-exchange strategy protocol and registry (twin of
`repro.exchange.base`).

A swap iteration is three policy decisions: ``propose_pairs`` (an
involution over rungs, ``partner[i] = i`` meaning unpaired), ``accept``
(the shared core, `core.swap.accept_pairs`, on one uniform a rung drawn
from the iteration's swap key) and ``estimator_weights`` (per-rung weights
over the ``n_virtual`` outcomes of the swap, for waste recycling).  Every
method is torch on the device with no host sync, so a strategy runs inside
the engine's interval loop.  `make_strategy` resolves the names the spec
layer and the CLI use.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch

from repro_torch.core import keys
from repro_torch.core import swap as swap_lib

__all__ = [
    "ExchangeStrategy",
    "STRATEGIES",
    "register_strategy",
    "make_strategy",
    "available_strategies",
    "strategy_help",
]


@dataclasses.dataclass(frozen=True)
class ExchangeStrategy:
    """Base strategy: deterministic even/odd pairing, shared acceptance.

    ``n_virtual`` is the number of outcomes each rung contributes to the
    estimator record: 1 records the realized post-swap state, 2 records
    both outcomes of the pair weighted by `estimator_weights`.
    """

    name = "deo"
    n_virtual = 1

    def propose_pairs(self, key: torch.Tensor, phase: torch.Tensor, n: int) -> torch.Tensor:
        """(n,) int64 partner involution for this iteration (``key`` is the
        iteration's swap key; ``phase`` the device swap counter)."""
        return swap_lib.pair_partners(n, phase)

    def accept(self, key, partner, betas, energies, criterion: str = "logistic"):
        """`core.swap.accept_pairs` on ``uniform(key, (R,))``."""
        u = keys.uniform(key, (partner.shape[0],))
        return swap_lib.accept_pairs(partner, betas, energies, criterion, uniforms=u)

    def estimator_weights(self, partner, prob_pair):
        """(n_virtual, R) weights over the virtual outcomes, or None (record
        the realized state with weight 1)."""
        return None


@dataclasses.dataclass(frozen=True)
class _Registered:
    build: Callable[..., ExchangeStrategy]
    help: str


STRATEGIES: dict[str, _Registered] = {}


def register_strategy(name: str, build: Callable[..., ExchangeStrategy], help: str) -> None:
    if name in STRATEGIES:
        raise ValueError(f"exchange strategy {name!r} already registered")
    STRATEGIES[name] = _Registered(build=build, help=help)


def available_strategies() -> list[str]:
    return sorted(STRATEGIES)


def strategy_help(name: str) -> str:
    return STRATEGIES[name].help


def make_strategy(name=None, params: Mapping[str, Any] | None = None) -> ExchangeStrategy:
    """Resolve a strategy name (+ JSON-able params); None is ``deo`` and an
    instance passes through."""
    if name is None:
        name = "deo"
    if isinstance(name, ExchangeStrategy):
        return name
    if name not in STRATEGIES:
        raise ValueError(
            f"unknown exchange strategy {name!r}; allowed: {available_strategies()}"
        )
    return STRATEGIES[name].build(**dict(params or {}))
