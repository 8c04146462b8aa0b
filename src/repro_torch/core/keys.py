"""The subset of partitionable ``jax.random`` that the ported path needs.

JAX (``jax_threefry_partitionable=True``) derives everything from plain
Threefry-2x32-20 on iota counters; these functions reproduce it word for
word on torch tensors:

* ``key(seed)``: key data ``[0, seed & 0xFFFFFFFF]`` (JAX with 64-bit mode
  off, as the JAX package runs, keeps the seed's low 32 bits);
* ``split(key, n)``: key ``i`` is ``threefry(key, (0, i))`` (both words);
* ``fold_in(key, d)``: ``threefry(key, (0, d))`` (both words);
* ``random_bits(key, shape)``: ``b0 ^ b1`` of ``threefry(key, (0, flat index))``;
* ``uniform(key, shape, minval, maxval)``: the mantissa trick on those
  bits, ``f = bitcast((bits >> 9) | 0x3F800000) - 1``, then
  ``max(minval, f * (maxval - minval) + minval)`` in f32;
* ``gumbel(key, shape)``: jax's default ("low") mode,
  ``-log(-log(uniform(minval=finfo.tiny, maxval=1)))``;
* ``categorical(key, logits)``: the Gumbel-max trick,
  ``argmax(gumbel(key, logits.shape) + logits)`` (first index on ties);
* ``randint(key, shape, lo, hi)``: int32 ``randint``: two bit draws from
  ``split(key)`` reduced modulo the span with JAX's ``2^32 mod span``
  multiplier;
* ``normal(key, shape)``: jax's ``_normal_real``, ``sqrt(2) *
  erf_inv(uniform(minval=nextafter(-1, 0), maxval=1))``; `erf_inv` is
  XLA's f32 form (Giles' single-precision polynomial on ``w =
  -log1p(-x*x)``, the ``w < 5`` and ``sqrt(w) - 3`` branches, Horner with
  a fused multiply-add), within 2 ulps of XLA's (its ``log1p`` is another
  approximation than torch's); ``normal`` is bit-equal to JAX's on ~99%
  of draws and within 3 ulps on all;
* ``replica_keys(key, t, ids)``: the JAX engine's per-sweep replica keys
  ``fold_in(fold_in(key, 2t), r)``;
* ``permutation(key, n)``: ``jax.random.permutation(key, n)``, JAX's
  ``_shuffle``: ``ceil(3 ln n / ln(2^32 - 1))`` rounds, each splitting the
  key and stably sorting ``arange(n)`` by 32-bit ``random_bits`` of the
  second half (`shuffle_rows` does a batch of padded rows at once).

A key is a (2,) int64 tensor holding the two uint32 words (JAX's
``jax.random.key_data``); a batch of keys is (..., 2).  Counters above
2^32 (a flat index's high word) are not needed on this path and refused.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.kernels.prng import MASK, threefry2x32

__all__ = ["key", "split", "fold_in", "random_bits", "uniform", "uniform_from_bits",
           "randint", "erf_inv", "normal", "normal_from_bits", "replica_keys", "gumbel",
           "categorical", "shuffle_rounds", "shuffle_rows", "permutation"]


def key(seed: int, device=None) -> torch.Tensor:
    """Key data for integer ``seed`` (``jax.random.key_data(jax.random.key(seed))``)."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def _pair(k: torch.Tensor):
    return k[..., 0], k[..., 1]


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(..., num, 2) keys — ``jax.random.split(key, num)`` (batched like `random_bits`)."""
    k0, k1 = _pair(k)
    lo = torch.arange(num, dtype=torch.int64, device=k.device)
    b0, b1 = threefry2x32(k0[..., None], k1[..., None], 0, lo)
    return torch.stack([b0, b1], dim=-1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``; ``data`` is a uint32 scalar (int or tensor)."""
    k0, k1 = _pair(k)
    b0, b1 = threefry2x32(k0, k1, 0, data)
    return torch.stack([b0, b1], dim=-1)


def random_bits(k: torch.Tensor, shape) -> torch.Tensor:
    """32-bit ``jax.random.bits(key, shape)`` as int64 uint32 words.

    ``k`` may carry leading batch dimensions: a (B, 2) key batch gives
    (B, *shape) bits, each row from its own key (``vmap`` of the single form).
    """
    shape = tuple(shape)
    size = math.prod(shape)
    if size > 1 << 32:
        raise NotImplementedError("random_bits beyond 2^32 counters")
    k0, k1 = _pair(k)
    lo = torch.arange(size, dtype=torch.int64, device=k.device)
    b0, b1 = threefry2x32(k0[..., None], k1[..., None], 0, lo)
    return (b0 ^ b1).reshape((*k.shape[:-1], *shape))


def uniform(k: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """f32 ``jax.random.uniform(key, shape, minval=minval, maxval=maxval)``
    (batched like `random_bits`; bounds are Python floats)."""
    return uniform_from_bits(random_bits(k, shape), minval, maxval)


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """`uniform` of already drawn `random_bits` (so draws from several keys
    can share one Threefry evaluation)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if (minval, maxval) == (0.0, 1.0):
        return torch.clamp_min(f, 0.0)
    # the bounds and their difference rounded to f32 on the host, as JAX
    # converts them, then entering the device ops as scalars (no copy)
    lo, hi = torch.tensor([minval, maxval], dtype=torch.float32)
    return torch.clamp_min(f * (hi - lo).item() + lo.item(), lo.item())


def randint(k: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """int32 ``jax.random.randint(key, shape, minval, maxval)`` (batched like
    `random_bits`; bounds are Python ints with ``minval < maxval``)."""
    span = int(maxval) - int(minval)
    if span < 1 or span > MASK:
        raise ValueError(f"randint needs 0 < maxval - minval < 2^32, got {minval}, {maxval}")
    ks = split(k)
    hi = random_bits(ks[..., 0, :], shape)
    lo = random_bits(ks[..., 1, :], shape)
    # (a * b) % n == ((a % n) * (b % n)) % n in uint32, as JAX computes it
    mult = (2 ** 16) % span
    mult = (mult * mult) % span
    offset = ((((hi % span) * mult) & MASK) + lo % span) & MASK
    return (int(minval) + offset % span).to(torch.int32)


# XLA's f32 ErfInv: Giles' coefficients for w < 5 and for w >= 5, highest first
_ERF_INV = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
     -0.00125372503, -0.00417768164, 0.246640727, 1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
     -0.0076224613, 0.00943887047, 1.00167406, 2.83297682),
)


@functools.lru_cache(maxsize=8)
def _erf_inv_coef(device: torch.device) -> torch.Tensor:
    """`_ERF_INV` on ``device``, copied once (no host copy per call)."""
    return torch.tensor(_ERF_INV, dtype=torch.float32, device=device)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """f32 ``lax.erf_inv`` on (-1, 1) as XLA computes it (see the module
    docstring for the bound); +-1 give +-inf."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    # the f32 square root through f64 (correctly rounded either way): torch
    # 2.13's f32 sqrt of a large CPU tensor returned a few elements off by
    # ~2e-4 in some processes
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0).double()
    coef = _erf_inv_coef(x.device)
    p = torch.where(lt, coef[0, 0], coef[1, 0])
    for i in range(1, coef.shape[1]):
        # c + p * w with one rounding, as XLA's fused multiply-add: the f32
        # product is exact in f64
        p = (torch.where(lt, coef[0, i], coef[1, i]).double() + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_NEXT_BELOW_ONE = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))


def normal(k: torch.Tensor, shape) -> torch.Tensor:
    """f32 ``jax.random.normal(key, shape)`` (batched like `random_bits`)."""
    return normal_from_bits(random_bits(k, shape))


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """`normal` of already drawn `random_bits`."""
    return _SQRT2_F32 * erf_inv(uniform_from_bits(bits, _NEXT_BELOW_ONE, 1.0))


def replica_keys(k: torch.Tensor, t, ids: torch.Tensor) -> torch.Tensor:
    """(len(ids), 2) keys ``fold_in(fold_in(k, 2t), r)`` for the replica ids
    ``ids``: the keys of the JAX engine's per-sweep step (``_sweep_once``);
    ``t`` is the sweep counter (an int or a () tensor)."""
    return fold_in(fold_in(k, 2 * t), ids)


def gumbel(k: torch.Tensor, shape) -> torch.Tensor:
    """f32 ``jax.random.gumbel(key, shape)`` in its default ("low") mode."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(k, shape, minval=tiny, maxval=1.0)))


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """int64 ``jax.random.categorical(key, logits, axis=-1)`` for f32 logits:
    the index of the largest ``gumbel + logits`` along the last axis."""
    if logits.dtype != torch.float32:
        raise TypeError(f"categorical takes f32 logits, got {logits.dtype}")
    return torch.argmax(gumbel(k, logits.shape) + logits, dim=-1)


def shuffle_rounds(n: int) -> int:
    """Sort rounds of JAX's ``_shuffle`` for ``n`` elements (1 up to n = 1625)."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def shuffle_rows(k: torch.Tensor, pad: torch.Tensor, rounds) -> torch.Tensor:
    """``(B, W)`` int64 rows: row ``b`` starts with ``permutation(k[b], s_b)``,
    where ``s_b`` counts the False entries of ``pad[b]`` (which lead the
    row), and ends with ``s_b, ..., W - 1``.

    ``k`` is a ``(B, 2)`` key batch, ``pad`` a ``(B, W)`` bool tensor on its
    device and ``rounds`` the host list of each row's `shuffle_rounds`.  The
    padding's sort keys lie above every 32-bit key, so a stable sort leaves
    it last; each element's bits depend only on its index (partitionable
    Threefry), so a padded row draws the bits an unpadded one would.
    """
    b, width = pad.shape
    x = torch.arange(width, dtype=torch.int64, device=k.device).expand(b, width)
    for r in range(max(rounds, default=0)):
        ks = split(k)
        k, sub = ks[..., 0, :], ks[..., 1, :]
        sort_keys = torch.where(pad, 1 << 32, random_bits(sub, (width,)))
        moved = torch.gather(x, 1, torch.sort(sort_keys, dim=1, stable=True).indices)
        if all(n > r for n in rounds):
            x = moved
        else:  # rows that need fewer rounds keep their order (n > 1625 only)
            live = torch.tensor([n > r for n in rounds], device=k.device)
            x = torch.where(live[:, None], moved, x)
    return x


def permutation(k: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) int64 ``jax.random.permutation(key, n)`` for a (2,) key."""
    pad = torch.zeros((1, n), dtype=torch.bool, device=k.device)
    return shuffle_rows(k[None], pad, [shuffle_rounds(n)])[0]
