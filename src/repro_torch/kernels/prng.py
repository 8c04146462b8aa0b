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
    "sweep_planes",
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


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32-20: key (k0,k1), counter (x0,x1) -> two uint32 words.

    Arguments are broadcastable int64 tensors of uint32 values, or Python
    ints.  Returns two int64 tensors of uint32 values (on the CPU when every
    argument is an int).  The rounds update two fresh tensors in place:
    on the CPU path, where the tensors are small, the op count is the cost.
    """
    dev = next((v.device for v in (k0, k1, x0, x1) if isinstance(v, torch.Tensor)), None)
    k0, k1, x0, x1 = (_u32(v) for v in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    a = torch.as_tensor((x0 + ks[0]) & MASK, device=dev)
    b = torch.as_tensor((x1 + ks[1]) & MASK, device=dev)
    x0, x1 = (t.clone() for t in torch.broadcast_tensors(a, b))
    # x1 is masked before every rotation; x0 only feeds adds and xors, whose
    # low 32 bits do not depend on its high bits, so it is masked once at the
    # end (it stays below 2^38)
    for group in range(5):
        for d in _ROTATIONS[group % 2]:
            x0.add_(x1)
            x1 = torch.bitwise_or(x1 << d, x1 >> (32 - d))
            x1.bitwise_xor_(x0).bitwise_and_(MASK)
        inject = group + 1
        x0.add_(ks[inject % 3])
        x1.add_(ks[(inject + 1) % 3] + inject).bitwise_and_(MASK)
    return x0.bitwise_and_(MASK), x1


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


def plane_uniforms(w0, w1, plane, h: int, w: int) -> torch.Tensor:
    """(..., h, w) f32 uniforms for one random lattice; site counter i*w + j.

    ``plane`` is an int, or an int64 tensor that broadcasts against the
    lattice (a ``(P, 1, 1)`` column gives P planes in one hash).
    """
    site = torch.arange(h * w, dtype=torch.int64, device=w0.device).reshape(h, w)
    b0, _ = threefry2x32(w0[..., None, None], w1[..., None, None], plane, site)
    return to_uniform(b0)


def sweep_planes(sk, t, replica_ids, n_planes: int, h: int, w: int) -> torch.Tensor:
    """(R, n_planes, H, W) f32: planes 0..n_planes-1 of sweep ``t`` for each
    replica, from the stream key ``sk = stream_key(words)``."""
    w0, w1 = sweep_key(sk[0], sk[1], t, replica_ids)
    planes = torch.arange(n_planes, dtype=torch.int64, device=w0.device)[:, None, None]
    return plane_uniforms(w0[..., None], w1[..., None], planes, h, w)


def ising_sweep_uniforms(words, t, replica_ids, length: int) -> torch.Tensor:
    """(R, 2, L, L) f32 — the Ising sweep-``t`` uniforms of the fused stream."""
    return sweep_planes(stream_key(words), t, replica_ids, 2, length, length)


def potts_sweep_uniforms(words, t, replica_ids, h: int, w: int) -> torch.Tensor:
    """(R, 2, 2, H, W) f32 — the Potts sweep-``t`` uniforms of the fused
    stream: colour x (proposal, accept), on plane ``2*colour + which``."""
    u = sweep_planes(stream_key(words), t, replica_ids, 4, h, w)
    return u.reshape(u.shape[0], 2, 2, h, w)


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
