"""Pluggable replica-exchange strategies (twin of `repro.exchange`).

``deo`` (the default), ``seo``, ``windowed`` and ``vmpt``, resolved by name
through `make_strategy`; they run on the per-sweep and interval-fused
paths.  The whole-round kernels run DEO and SEO in-kernel, on the counter
swap stream (`repro_torch.kernels.exchange`).
"""
from repro_torch.exchange.base import (
    STRATEGIES,
    ExchangeStrategy,
    available_strategies,
    make_strategy,
    register_strategy,
    strategy_help,
)
from repro_torch.exchange.strategies import DEO, SEO, VMPT, Windowed

__all__ = [
    "DEO",
    "SEO",
    "STRATEGIES",
    "VMPT",
    "Windowed",
    "ExchangeStrategy",
    "available_strategies",
    "make_strategy",
    "register_strategy",
    "strategy_help",
]
