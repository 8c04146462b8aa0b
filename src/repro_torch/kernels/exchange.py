"""Temp-mode DEO/SEO exchange step (plain twin of `repro.kernels.exchange`).

The JAX version writes every gather as a one-hot compare-sum because Mosaic
cannot lower a gather or argsort; here they are real gathers and a scatter,
with equal results.  `exchange_step` is the plain version that the round
launches' exchange (`csrc/exchange.cuh`) is held against, and the port's
CPU path.  `exchange_step_kernel` launches the same exchange alone over the
gathered rows of C chains (``csrc/exchange_step.cu``, one block a chain):
the sharded round path's exchange on the card (`repro_torch.engine.driver.
make_sharded_interval_step`).  `exchange_rows` dispatches on the rows'
device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import swap as swap_lib
from repro_torch.kernels import prng

__all__ = ["PAIRINGS", "CRITERIA", "rung_energies", "exchange_step",
           "exchange_step_kernel", "exchange_rows"]

_P = ctypes.c_void_p

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


@functools.cache
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build

    lib = build.library("exchange_step")
    lib.exchange_step_launch.restype = ctypes.c_int
    lib.exchange_step_launch.argtypes = (
        [_P] * 5 + [ctypes.c_longlong, _P] + [ctypes.c_int] * 4 + [_P] * 5)
    return lib


def exchange_step_kernel(rung, energy, betas, phase, key_words, *, pairing: str,
                         criterion: str):
    """One launch of ``csrc/exchange_step.cu``: `exchange_step` of C chains
    at once, one block a chain, on the card.

    Args:
      rung: (C, R) int32 slot→rung maps; energy: (C, R) f32 per-slot
        energies (the interval's, ΔE already added).
      betas: (R,) f32 ladder shared by the chains.
      phase: (C,) int64 device swap counters; key_words: (C, 2) int64.

    Returns ``(new_rung, accept, prob, attempt)``, each (C, R): chain c's
    are `exchange_step`'s on its rows, bit for bit.
    """
    from repro_torch.kernels import build

    dev = rung.device
    if dev.type != "cuda":
        raise ValueError(f"exchange_step_kernel needs CUDA tensors, got {dev}")
    if pairing not in PAIRINGS or criterion not in CRITERIA:
        raise ValueError(f"unsupported exchange {pairing!r}/{criterion!r}")
    if rung.dim() != 2:
        raise ValueError(f"rung must be (C, R), got {tuple(rung.shape)}")
    c, r = rung.shape
    if not 0 < c <= 65535:
        raise ValueError(f"exchange_step_kernel takes 1..65535 chains, got {c}")
    build.check(rung, "rung", torch.int32, (c, r), dev)
    build.check(energy, "energy", torch.float32, (c, r), dev)
    build.check(betas, "betas", torch.float32, (r,), dev)
    build.check(phase, "phase", torch.int64, (c,), dev)
    build.check(key_words, "key words", torch.int64, (c, 2), dev)
    lib = _lib()
    new_rung = torch.empty_like(rung)
    acc = torch.empty((c, r), dtype=torch.bool, device=dev)
    prob = torch.empty((c, r), dtype=torch.float32, device=dev)
    att = torch.empty((c, r), dtype=torch.bool, device=dev)
    scratch = torch.empty(build.scratch_bytes(lib) * c * r, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.exchange_step_launch(
            rung.data_ptr(), new_rung.data_ptr(), energy.data_ptr(), betas.data_ptr(),
            phase.data_ptr(), 0, key_words.data_ptr(), r, c, int(pairing == "seo"),
            int(criterion == "metropolis"), acc.data_ptr(), prob.data_ptr(), att.data_ptr(),
            scratch.data_ptr(), build.stream_of(dev))
    build.raise_if(err, "exchange_step")
    build.launches["exchange_step"] += 1
    return new_rung, acc, prob, att


def exchange_rows(rung, energy, betas, phase, key, *, pairing: str, criterion: str):
    """The exchange of one chain's gathered rows (``rung``, ``energy`` (R,),
    ``phase`` (), ``key`` (2,)) or of C chains' ((C, R), (C,), (C, 2)):
    `exchange_step` chain by chain on the CPU, one launch of
    `exchange_step_kernel` for every chain on CUDA.  Returns ``(new_rung,
    accept, prob, attempt)`` shaped as ``rung``."""
    kind = rung.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no exchange kernel for tensors on {rung.device}")
    words = key.to(dtype=torch.int64) & prng.MASK
    one = rung.dim() == 1
    if kind == "cpu":
        if one:
            return exchange_step(rung, energy, betas, phase, words, pairing=pairing,
                                 criterion=criterion)[:4]
        rows = [exchange_step(rung[i], energy[i], betas, phase[i], words[i],
                              pairing=pairing, criterion=criterion)[:4]
                for i in range(rung.shape[0])]
        return tuple(torch.stack(x) for x in zip(*rows))
    lead = (1,) if one else ()
    out = exchange_step_kernel(
        rung.reshape(*lead, *rung.shape), energy.reshape(*lead, *energy.shape),
        betas.to(torch.float32), phase.reshape(-1).to(torch.int64).contiguous(),
        words.reshape(-1, 2).contiguous(), pairing=pairing, criterion=criterion)
    return tuple(x[0] for x in out) if one else out
