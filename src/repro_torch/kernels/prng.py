"""Counter-based PRNG streams of the fused kernels (twin of `repro.kernels.prng`).

Threefry-2x32-20 evaluated at deterministic counters, word for word the
streams of the JAX package::

    stream key   = threefry(key_words, (DOMAIN, DOMAIN))          # once per run
    sweep key    = threefry(stream key, (t, replica))             # sweep x replica
    lattice bits = threefry(sweep key, (plane, i*W + j))          # per site
                   (Ising: plane = colour; Potts: 2*colour + (0 proposal | 1 accept))
    swap key     = threefry(threefry(key_words, (SWAP_DOMAIN,)*2), (phase, 0))
    rung uniform = threefry(swap key, (0, rung));  SEO coin = threefry(swap key, (1, 0)) & 1

A uniform is the top 24 bits of the first output word times 2^-24.

uint32 words are held in int64 tensors and masked with ``& 0xFFFFFFFF``
after every add and shift: PyTorch's CPU build has no uint32 ``+``, ``<<``
or ``>>``.  The same functions run on CUDA tensors (the plain version the
CUDA kernels are compared with); `csrc/threefry.cuh` is the device twin.
"""
from __future__ import annotations

import torch

__all__ = [
    "DOMAIN",
    "SWAP_DOMAIN",
    "MASK",
    "threefry2x32",
    "key_words",
    "stream_key",
    "sweep_key",
    "plane_uniforms",
    "ising_sweep_uniforms",
    "potts_sweep_uniforms",
    "swap_stream_key",
    "swap_key",
    "swap_uniforms",
    "seo_coin",
    "to_uniform",
]

# Fixed forever: changing either changes every fused trajectory.
DOMAIN = 0x46555345  # ascii "FUSE"
SWAP_DOMAIN = 0x53574150  # ascii "SWAP"

MASK = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x):
    """uint32 words: an int64 tensor masked on its device, or a masked int.

    Python ints stay Python ints, so a constant counter or domain word
    enters the tensor arithmetic as a kernel argument and never as a
    host-to-device copy (which would wait for the stream).
    """
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK
    return int(x) & MASK


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32-20: key (k0,k1), counter (x0,x1) -> two uint32 words.

    Arguments are broadcastable int64 tensors of uint32 values, or Python
    ints.  Returns two int64 tensors of uint32 values (on the CPU when every
    argument is an int).
    """
    k0, k1, x0, x1 = (_u32(v) for v in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for group in range(5):
        for d in _ROTATIONS[group % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, d) ^ x0
        inject = group + 1
        x0 = (x0 + ks[inject % 3]) & MASK
        x1 = (x1 + ks[(inject + 1) % 3] + inject) & MASK
    return torch.as_tensor(x0), torch.as_tensor(x1)


def to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """Top 24 bits of a uint32 word as an f32 in [0, 1) (exact)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def key_words(key: torch.Tensor) -> torch.Tensor:
    """(2,) int64 uint32 key words from raw key data.

    The port's keys are raw Threefry key data already (`core.keys`); wider
    data is folded down by XOR exactly as the JAX twin does.
    """
    data = _u32(torch.as_tensor(key)).reshape(-1)
    k0 = data[0]
    k1 = data[1] if data.shape[0] > 1 else torch.zeros_like(k0)
    for i in range(2, data.shape[0]):
        if i % 2 == 0:
            k0 = k0 ^ data[i]
        else:
            k1 = k1 ^ data[i]
    return torch.stack([k0, k1])


def stream_key(words: torch.Tensor):
    """Domain-separated root of the fused-sweep stream."""
    return threefry2x32(words[0], words[1], DOMAIN, DOMAIN)


def sweep_key(s0, s1, t, replica):
    """Per-(sweep, replica) subkey; ``t``/``replica`` broadcast elementwise."""
    return threefry2x32(s0, s1, t, replica)


def plane_uniforms(w0, w1, plane: int, h: int, w: int) -> torch.Tensor:
    """(..., h, w) f32 uniforms for one random lattice; site counter i*w + j."""
    site = torch.arange(h * w, dtype=torch.int64, device=w0.device).reshape(h, w)
    b0, _ = threefry2x32(w0[..., None, None], w1[..., None, None], plane, site)
    return to_uniform(b0)


def ising_sweep_uniforms(words, t, replica_ids, length: int) -> torch.Tensor:
    """(R, 2, L, L) f32 — the Ising sweep-``t`` uniforms of the fused stream."""
    s0, s1 = stream_key(words)
    w0, w1 = sweep_key(s0, s1, t, replica_ids)
    return torch.stack(
        [plane_uniforms(w0, w1, c, length, length) for c in (0, 1)], dim=1
    )


def potts_sweep_uniforms(words, t, replica_ids, h: int, w: int) -> torch.Tensor:
    """(R, 2, 2, H, W) f32 — the Potts sweep-``t`` uniforms of the fused
    stream: colour x (proposal, accept), on plane ``2*colour + which``."""
    s0, s1 = stream_key(words)
    w0, w1 = sweep_key(s0, s1, t, replica_ids)
    return torch.stack([
        torch.stack([plane_uniforms(w0, w1, 2 * c + p, h, w) for p in (0, 1)], dim=1)
        for c in (0, 1)
    ], dim=1)


def swap_stream_key(words: torch.Tensor):
    """Domain-separated root of the in-kernel exchange stream."""
    return threefry2x32(words[0], words[1], SWAP_DOMAIN, SWAP_DOMAIN)


def swap_key(s0, s1, phase):
    """Per-swap-iteration subkey; ``phase`` is the global swap counter."""
    return threefry2x32(s0, s1, phase, 0)


def swap_uniforms(words: torch.Tensor, phase, n: int) -> torch.Tensor:
    """(n,) f32 in [0,1): one acceptance uniform per rung for swap ``phase``."""
    s0, s1 = swap_stream_key(words)
    w0, w1 = swap_key(s0, s1, phase)
    rung = torch.arange(n, dtype=torch.int64, device=words.device)
    b0, _ = threefry2x32(w0, w1, 0, rung)
    return to_uniform(b0)


def seo_coin(words: torch.Tensor, phase) -> torch.Tensor:
    """Scalar int64 in {0, 1}: the SEO even/odd pairing coin for ``phase``."""
    s0, s1 = swap_stream_key(words)
    w0, w1 = swap_key(s0, s1, phase)
    b0, _ = threefry2x32(w0, w1, 1, 0)
    return b0 & 1
