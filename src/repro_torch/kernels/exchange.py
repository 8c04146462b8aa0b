"""Temp-mode DEO/SEO exchange step (plain twin of `repro.kernels.exchange`).

The JAX version writes every gather as a one-hot compare-sum because Mosaic
cannot lower a gather or argsort; here they are real gathers and a scatter,
with equal results.  This is the plain version that the round launches'
exchange (`csrc/exchange.cuh`) is held against, and the port's CPU path.
"""
from __future__ import annotations

import torch

from repro_torch.core import swap as swap_lib
from repro_torch.kernels import prng

__all__ = ["PAIRINGS", "CRITERIA", "rung_energies", "exchange_step"]

PAIRINGS = ("deo", "seo")
CRITERIA = ("logistic", "metropolis")


def rung_energies(rung: torch.Tensor, energy: torch.Tensor) -> torch.Tensor:
    """(R,) energies in rung order from per-slot energies (``energy[argsort(rung)]``)."""
    out = torch.empty_like(energy)
    out[rung.long()] = energy
    return out


def exchange_step(rung, energy, betas, phase, key_words, *, pairing: str,
                  criterion: str):
    """One temp-mode exchange drawn from the counter swap stream.

    Args:
      rung: (R,) int32 slot→rung map; energy: (R,) f32 per-slot energies.
      betas: (R,) f32 ladder in rung order (cold→hot).
      phase: global swap-iteration counter (int or device scalar tensor).
      key_words: (2,) int64 run-key words.

    Returns ``(new_rung int32, accept bool, prob f32, attempt bool, e_rung)``
    with the diagnostics at the lower rung of each pair.
    """
    if pairing not in PAIRINGS:
        raise ValueError(
            f"in-kernel exchange supports pairings {PAIRINGS}, got {pairing!r}"
        )
    n = rung.shape[0]
    e_rung = rung_energies(rung, energy)
    u = prng.swap_uniforms(key_words, phase, n)
    coin = phase if pairing == "deo" else prng.seo_coin(key_words, phase)
    partner = swap_lib.pair_partners(n, coin, device=rung.device)
    perm, accept, prob, attempt = swap_lib.accept_pairs(
        partner, betas, e_rung, criterion, uniforms=u
    )
    new_rung = perm[rung.long()].to(torch.int32)
    return new_rung, accept, prob, attempt, e_rung
