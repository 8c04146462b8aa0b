"""The in-tree replica-exchange strategies (twin of `repro.exchange.strategies`).

* `DEO`: deterministic even/odd pairing (paper §3; the default).
* `SEO`: the even/odd phase is ``randint(fold_in(key, 0x5E0), (), 0, 2)``.
* `Windowed`: rungs tiled into windows of ``window`` (the tiling shifted by
  ``window // 2`` on odd phases, the first window truncated, none wrapping);
  each window pairs its members two at a time along
  ``permutation(fold_in(key, 0x71D0 + 4096·offset + b), size)``.
* `VMPT`: DEO dynamics; the estimator records both outcomes of every pair,
  weighted ``[1 - p, p]`` by the pair's acceptance probability.

Proposal randomness folds distinct salts off the swap key, so the
acceptance uniforms (drawn from the swap key itself) stay a disjoint
stream.  `Windowed` draws every window of both tilings in one batch (one
``fold_in`` over the window salts, one key split, one ``random_bits``, one
stable row-wise sort), equal to JAX's one ``permutation`` a window.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import keys
from repro_torch.core import swap as swap_lib
from repro_torch.exchange.base import ExchangeStrategy, register_strategy

__all__ = ["DEO", "SEO", "Windowed", "VMPT"]

# fold_in salts of the proposal randomness (the JAX package's values)
_SEO_SALT = 0x5E0
_WINDOW_SALT = 0x71D0


@dataclasses.dataclass(frozen=True)
class DEO(ExchangeStrategy):
    """Deterministic even/odd neighbour pairing (paper §3; the default)."""

    name = "deo"


@dataclasses.dataclass(frozen=True)
class SEO(ExchangeStrategy):
    """Stochastic even/odd: the pairing phase is a per-iteration coin flip."""

    name = "seo"

    def propose_pairs(self, key, phase, n):
        coin = keys.randint(keys.fold_in(key, _SEO_SALT), (), 0, 2)
        return swap_lib.pair_partners(n, coin)


def _tiling(n: int, w: int, off: int):
    """(salt, start, size) of each window of one tiling (JAX's ``_matching``):
    windows [0, w-off), [w-off, 2w-off), ...; windows under 2 rungs draw
    nothing."""
    starts = [0] + list(range(w - off if off else w, n, w))
    out = []
    for b, start in enumerate(starts):
        size = min(w, n - start) if start else min(w - off, n)
        if size >= 2:
            out.append((_WINDOW_SALT + 4096 * off + b, start, size))
    return out


_TABLES: dict = {}


def _tables(n: int, w: int, device):
    """Both tilings' windows as device tensors, built once per (n, w, device)
    so the interval loop copies nothing to the card."""
    key = (n, w, str(device))
    if key not in _TABLES:
        rows = [(*x, tiling) for tiling, off in enumerate((0, w // 2))
                for x in _tiling(n, w, off)]
        salt, start, size, tiling = (list(c) for c in zip(*rows)) if rows else ([],) * 4
        t = lambda v, dt=torch.int64: torch.tensor(v, dtype=dt, device=device)
        size_t = t(size)
        half = torch.arange(w // 2, device=device)
        _TABLES[key] = dict(
            salt=t(salt), start=t(start), tiling=t(tiling),
            pad=torch.arange(w, device=device)[None] >= size_t[:, None],
            # pair i of a window joins slots 2i and 2i+1 when 2i+1 < size
            pairs=half[None] < (size_t[:, None] // 2),
            rounds=[keys.shuffle_rounds(s) for s in size],
        )
    return _TABLES[key]


@dataclasses.dataclass(frozen=True)
class Windowed(ExchangeStrategy):
    """Random perfect matching within (alternately shifted) rung windows.

    As in the JAX package, attempt/accept counters are credited to the
    lower rung of a pair whatever its span, so acceptance-mode adaptation
    reads an approximate signal here; flow mode does not depend on it.
    """

    name = "windowed"
    window: int = 4

    def __post_init__(self):
        if self.window < 2:
            raise ValueError(f"window must be >= 2, got {self.window}")

    def propose_pairs(self, key, phase, n):
        w = min(self.window, n)
        tab = _tables(n, w, key.device)
        idx = torch.arange(n, dtype=torch.int64, device=key.device)
        # [aligned tiling, shifted tiling, one slot that takes the writes of
        # the pair slots a window does not fill]: masks without a host sync
        both = torch.cat([idx, idx, idx[:1]])
        if tab["rounds"]:
            perm = keys.shuffle_rows(keys.fold_in(key, tab["salt"]), tab["pad"],
                                     tab["rounds"])
            members = tab["start"][:, None] + perm
            half = w // 2
            a, c = members[:, 0:2 * half:2], members[:, 1:2 * half:2]
            base = (tab["tiling"] * n)[:, None]
            keep, spare = tab["pairs"], 2 * n
            # windows are disjoint, so only the spare slot is written twice
            both[torch.where(keep, base + a, spare)] = torch.where(keep, c, 0)
            both[torch.where(keep, base + c, spare)] = torch.where(keep, a, 0)
        even = torch.as_tensor(phase, device=key.device) % 2 == 0
        return torch.where(even, both[:n], both[n:2 * n])


@dataclasses.dataclass(frozen=True)
class VMPT(ExchangeStrategy):
    """Virtual-move PT: DEO dynamics + waste-recycled estimator weights."""

    name = "vmpt"
    n_virtual = 2

    def estimator_weights(self, partner, prob_pair):
        idx = torch.arange(partner.shape[0], dtype=torch.int64, device=partner.device)
        lower = torch.minimum(idx, partner)
        # both members of a pair see the pair's probability; unpaired rungs
        # keep their configuration with certainty
        p = torch.where(partner != idx, prob_pair[lower], 0.0)
        return torch.stack([1.0 - p, p])


register_strategy(
    "deo", DEO,
    "deterministic even/odd neighbour pairing (paper §3; default, "
    "ballistic index flow)",
)
register_strategy(
    "seo", SEO,
    "stochastic even/odd: pairing phase drawn from the PRNG per iteration "
    "(diffusive reference scheme)",
)
register_strategy(
    "windowed", Windowed,
    "random perfect matching within alternately-shifted rung windows "
    "(non-adjacent exchanges; params: window)",
)
register_strategy(
    "vmpt", VMPT,
    "virtual-move PT: DEO dynamics + waste-recycled estimator weights "
    "over every attempted exchange (Coluzza & Frenkel)",
)
