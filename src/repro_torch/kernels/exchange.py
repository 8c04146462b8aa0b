"""Temp-mode DEO/SEO exchange step (plain twin of `repro.kernels.exchange`).

The JAX version writes every gather as a one-hot compare-sum because Mosaic
cannot lower a gather or argsort; here they are real gathers and a scatter,
with equal results.  `exchange_step` is the plain version that the round
launches' exchange (`csrc/exchange.cuh`) is held against, and the port's
CPU path.  `exchange_step_kernel` launches the same exchange alone over the
gathered rows of C chains (``csrc/exchange_step.cu``, one block a chain),
which also writes a mesh rank's slice of the new rungs and the next phase:
the sharded round path's exchange on the card (`repro_torch.engine.driver.
make_sharded_interval_step`), one prepared launch a call (the shape's checks
and output layout made once, the outputs in one allocation, no scratch
below 19,369 rungs).  `exchange_rows` dispatches on the rows' device.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.core import swap as swap_lib
from repro_torch.kernels import prng

__all__ = ["PAIRINGS", "CRITERIA", "rung_energies", "exchange_step",
           "exchange_step_kernel", "exchange_rows", "shared_fits"]

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
        [_P] * 7 + [ctypes.c_int] * 4 + [_P] * 4 + [ctypes.c_int] * 2
        + [_P, ctypes.c_int, _P])
    lib.exchange_step_smem_bytes.restype = ctypes.c_longlong
    lib.exchange_step_smem_bytes.argtypes = [ctypes.c_int]
    return lib


def shared_fits(r: int) -> bool:
    """Whether `exchange_step_kernel` keeps rows of ``r`` rungs in shared
    memory (else it runs the global-scratch variant)."""
    from repro_torch.kernels import build

    return _lib().exchange_step_smem_bytes(r) <= build.MAX_SMEM_BYTES


_INPUTS = (("rung", torch.int32), ("energy", torch.float32), ("betas", torch.float32),
           ("phase", torch.int64), ("key words", torch.int64))
_VIEWS = (torch.int32, torch.bool, torch.float32, torch.int64)


class _Launch(NamedTuple):
    """A prepared `exchange_step_kernel` launch of one shape: the inputs'
    ``(name, dtype, shape)``; the outputs' ``(dtype, shape, stride,
    element offset)`` and byte offsets in one allocation of ``nbytes``;
    the global variant's scratch offset there (None: shared memory); the
    launcher's ints and the slice."""

    inputs: tuple
    outputs: tuple
    offsets: tuple
    nbytes: int
    scratch: int | None
    ints: tuple
    block: tuple


def _padded(n_bytes: int) -> int:
    return -(-n_bytes // 16) * 16


@functools.cache
def _prepare(lead: tuple, r: int, block: tuple, pairing: str, criterion: str) -> _Launch:
    from repro_torch.kernels import build

    if pairing not in PAIRINGS or criterion not in CRITERIA:
        raise ValueError(f"unsupported exchange {pairing!r}/{criterion!r}")
    c = lead[0] if lead else 1
    if not 0 < c <= 65535:
        raise ValueError(f"exchange_step_kernel takes 1..65535 chains, got {c}")
    start, stop = block
    if not 0 <= start < stop <= r:
        raise ValueError(f"block {block} is not a slice of {r} rungs")
    row, width = lead + (r,), lead + (stop - start,)
    # new_rung, accept, prob, attempt, the slice, phase': each 16-byte aligned
    outputs, offsets, nbytes = [], [], 0
    for dtype, shape in ((torch.int32, row), (torch.bool, row), (torch.float32, row),
                         (torch.bool, row), (torch.int32, width), (torch.int64, lead)):
        stride = (shape[1], 1) if len(shape) == 2 else (1,) * len(shape)
        outputs.append((dtype, shape, stride, nbytes // dtype.itemsize))
        offsets.append(nbytes)
        nbytes += _padded(math.prod(shape) * dtype.itemsize)
    scratch = None
    if not shared_fits(r):
        scratch, nbytes = nbytes, nbytes + _padded(build.scratch_bytes(_lib()) * c * r)
    inputs = tuple((name, dtype, shape) for (name, dtype), shape in
                   zip(_INPUTS, (row, row, (r,), lead, lead + (2,))))
    ints = (r, c, int(pairing == "seo"), int(criterion == "metropolis"))
    return _Launch(inputs, tuple(outputs), tuple(offsets), nbytes, scratch, ints, block)


def exchange_step_kernel(rung, energy, betas, phase, key_words, *, pairing: str,
                         criterion: str, block=None):
    """One launch of ``csrc/exchange_step.cu``: `exchange_step` of C chains
    at once, one block a chain, on the card.

    Args:
      rung: (C, R) int32 slot→rung maps (or one chain's (R,)); energy: the
        same shape, f32 per-slot energies (the interval's, ΔE already added).
      betas: (R,) f32 ladder shared by the chains.
      phase: (C,) int64 device swap counters (() for one chain); key_words:
        (C, 2) int64 ((2,)).
      block: ``(start, stop)``, the slots whose new rungs are also returned
        as a row of their own (a mesh rank's); the whole row by default.

    Returns ``(new_rung, accept, prob, attempt, rung_block, next_phase)``,
    views of one allocation: chain c's first four are `exchange_step`'s on
    its rows bit for bit, ``rung_block = new_rung[..., start:stop]`` and
    ``next_phase = phase + 1``.  Rows past a block's shared memory
    (`shared_fits`) run the global-scratch variant, its scratch in the same
    allocation.  Nothing is converted: a tensor of another device, dtype,
    shape or layout raises.
    """
    from repro_torch.kernels import build

    dev = rung.device
    if dev.type != "cuda":
        raise ValueError(f"exchange_step_kernel needs CUDA tensors, got {dev}")
    if rung.dim() not in (1, 2):
        raise ValueError(f"rung must be (C, R) or (R,), got {tuple(rung.shape)}")
    *lead, r = rung.shape
    plan = _prepare(tuple(lead), r, (0, r) if block is None else tuple(block), pairing,
                    criterion)
    args = (rung, energy, betas, phase, key_words)
    for x, (name, dtype, shape) in zip(args, plan.inputs):
        if (x.device, x.dtype, x.shape) != (dev, dtype, shape) or not x.is_contiguous():
            build.check(x, name, dtype, shape, dev)
    buf = torch.empty(plan.nbytes, dtype=torch.uint8, device=dev)
    views = dict(zip(_VIEWS, (buf.view(dtype) for dtype in _VIEWS)))
    out = tuple(views[dtype].as_strided(shape, stride, at)
                for dtype, shape, stride, at in plan.outputs)
    base = buf.data_ptr()
    ptr = [base + at for at in plan.offsets]
    err = _lib().exchange_step_launch(
        rung.data_ptr(), ptr[0], energy.data_ptr(), betas.data_ptr(), phase.data_ptr(),
        ptr[5], key_words.data_ptr(), *plan.ints, ptr[1], ptr[2], ptr[3], ptr[4], *plan.block,
        None if plan.scratch is None else base + plan.scratch, dev.index, build.stream_of(dev))
    build.raise_if(err, "exchange_step")
    build.launches["exchange_step"] += 1
    return out


def _typed(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` itself where it is contiguous ``dtype``, else a converted copy."""
    return x if x.dtype == dtype and x.is_contiguous() else x.to(dtype).contiguous()


def exchange_rows(rung, energy, betas, phase, key, *, pairing: str, criterion: str,
                  block=None):
    """The exchange of one chain's gathered rows (``rung``, ``energy`` (R,),
    ``phase`` (), ``key`` (2,)) or of C chains' ((C, R), (C,), (C, 2)):
    `exchange_step` chain by chain on the CPU, one launch of
    `exchange_step_kernel` for every chain on CUDA, which converts only a
    tensor not already of the kernel's dtype and layout.  Returns
    ``(new_rung, accept, prob, attempt, rung_block, next_phase)``, the first
    four shaped as ``rung``, ``rung_block = new_rung[..., start:stop]`` for
    ``block = (start, stop)`` (the whole row by default) and ``next_phase =
    phase + 1``: what a mesh rank keeps of the exchange."""
    if rung.is_cuda:
        return exchange_step_kernel(
            rung, energy, _typed(betas, torch.float32), _typed(phase, torch.int64),
            _typed(key, torch.int64), pairing=pairing, criterion=criterion, block=block)
    if rung.device.type != "cpu":
        raise ValueError(f"no exchange kernel for tensors on {rung.device}")
    start, stop = (0, rung.shape[-1]) if block is None else block
    words = key.to(dtype=torch.int64) & prng.MASK
    if rung.dim() == 1:
        rows = exchange_step(rung, energy, betas, phase, words, pairing=pairing,
                             criterion=criterion)[:4]
    else:
        rows = tuple(torch.stack(x) for x in zip(*(
            exchange_step(rung[i], energy[i], betas, phase[i], words[i], pairing=pairing,
                          criterion=criterion)[:4] for i in range(rung.shape[0]))))
    return (*rows, rows[0][..., start:stop].contiguous(), phase + 1)
