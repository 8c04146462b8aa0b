"""ctypes wrappers of the Ising CUDA kernels, each beside its plain version.

* kernel #1, ``csrc/sweep.cu`` — one checkerboard sweep with the uniforms
  passed in (replaces `repro.kernels.ising_sweep.ising_sweep_pallas`);
* kernel A, ``csrc/ising_fused.cu`` — S checkerboard sweeps per launch
  (replaces `repro.kernels.ising_sweep.ising_sweep_fused_pallas` and the
  sweep half of ``ising_round_fused_pallas``);
* kernel #2p, ``csrc/ising_packed.cu`` — kernel A's sweeps on replica-bit-
  packed spins, up to 8 replicas a byte (replaces the ``pack_bits`` body
  `repro.kernels.ising_sweep._ising_sweep_body_packed` of both fused
  kernels);
* kernel B, ``csrc/exchange.cu`` — one temp-mode exchange on the O(R) rows
  (the exchange half of ``ising_round_fused_pallas``; Potts rounds reuse it).

Each ``*_kernel`` wrapper checks device, dtype, shape and contiguity,
allocates its outputs with ``torch.empty``, launches on the current stream
without synchronising, raises if the launch was refused, and adds one to
``build.launches[name]``, all through the helpers of `build`.  Each plain
version (``*_plain``, or `ref.ising_sweep` for kernel #1) computes the same
thing with plain torch ops on any device; it is what
`repro_torch.kernels.ops` runs for CPU tensors and what the kernels are
compared with on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, exchange, prng, ref
from repro_torch.kernels.build import check, check_smem, raise_if, stream_of

__all__ = [
    "accept_tables",
    "ising_sweep_kernel",
    "ising_sweep_fused_kernel",
    "ising_sweep_fused_plain",
    "ising_sweep_packed_kernel",
    "ising_sweep_packed_plain",
    "packed_group",
    "packed_launch_shape",
    "pack_spins",
    "unpack_spins",
    "exchange_kernel",
    "exchange_plain",
]

_P = ctypes.c_void_p


@functools.cache
def _libs() -> tuple[ctypes.CDLL, ctypes.CDLL, ctypes.CDLL]:
    """Kernels A, B and #2p, built on first use, with their C signatures."""
    lib_a, lib_b = build.library("ising_fused"), build.library("exchange")
    lib_p = build.library("ising_packed")
    # kernel #2p takes kernel A's arguments and its group width
    args = [_P] * 9 + [ctypes.c_longlong, ctypes.c_uint] + [ctypes.c_int] * 3
    lib_a.ising_fused_launch.argtypes = args + [_P]
    lib_p.ising_packed_launch.argtypes = args + [ctypes.c_int, _P]
    for lib, name in ((lib_a, "ising_fused"), (lib_p, "ising_packed")):
        getattr(lib, f"{name}_launch").restype = ctypes.c_int
        smem = getattr(lib, f"{name}_smem_bytes")
        smem.restype = ctypes.c_longlong
        smem.argtypes = [ctypes.c_int]
    lib_p.ising_packed_threads.restype = ctypes.c_int
    lib_p.ising_packed_threads.argtypes = []
    lib_b.exchange_launch.restype = ctypes.c_int
    lib_b.exchange_launch.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _P, _P, _P, _P,
    ]
    lib_b.exchange_smem_bytes.restype = ctypes.c_longlong
    lib_b.exchange_smem_bytes.argtypes = [ctypes.c_int]
    return lib_a, lib_b, lib_p


def de_table(j: float, b: float, device) -> torch.Tensor:
    """(2, 5) f32 ΔE rows with the plain version's own ops: entry ``[s, n]``
    is ``2*s*(j*nbr - b)`` for spin ``s`` in (-1, +1) and neighbour sum
    ``nbr = -4 + 2n`` (``n`` up neighbours)."""
    # built on the device (arange, not a host list) so no copy waits for the stream
    s = (2 * torch.arange(2, device=device) - 1).to(torch.float32)[:, None]
    nbr = (2 * torch.arange(5, device=device) - 4).to(torch.float32)[None, :]
    return (2.0 * s * (j * nbr - b)).contiguous()


def accept_tables(betas: torch.Tensor, *, j: float, b: float, rule: str):
    """Per-rung acceptance rows with the plain version's own ops.

    Returns ``(p_tab (R, 2, 5) f32, de_tab (2, 5) f32)``, indexed as
    `de_table`.  Kernels A, #1 and #2p select from these instead of
    evaluating exp/sigmoid per site, so they are bit-equal to
    `ref.ising_sweep` by construction.
    """
    de_tab = de_table(j, b, betas.device)
    p_tab = ref.accept_prob(
        de_tab[None], betas.to(torch.float32)[:, None, None], rule
    )
    return p_tab.contiguous(), de_tab


def ising_sweep_kernel(spins, u, betas, *, j: float = 1.0, b: float = 0.0,
                       rule: str = "metropolis"):
    """Kernel #1: one checkerboard sweep of every replica, uniforms passed in.

    Args:
      spins: (R, L, L) int8 on CUDA, L even; u: (R, 2, L, L) f32, one plane
        per colour; betas: (R,) f32 per replica.

    Returns ``(spins', delta_e (R,) f32, n_accepted (R,) int32)``, equal to
    `ref.ising_sweep` on the same inputs.
    """
    dev = spins.device
    if dev.type != "cuda":
        raise ValueError(f"kernel #1 needs CUDA tensors, got {dev}")
    r, length = spins.shape[0], spins.shape[-1]
    check(spins, "spins", torch.int8, (r, length, length), dev)
    check(u, "u", torch.float32, (r, 2, length, length), dev)
    check(betas, "betas", torch.float32, (r,), dev)
    if length % 2:
        raise ValueError(f"checkerboard sweeps need even L, got {length}")
    lib = build.sweep_lib()
    check_smem(lib.ising_sweep_smem_bytes(length), f"kernel #1 at L={length}")
    p_tab, de_tab = accept_tables(betas, j=j, b=b, rule=rule)
    out = torch.empty_like(spins)
    de = torch.empty(r, dtype=torch.float32, device=dev)
    nacc = torch.empty(r, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.ising_sweep_launch(
            spins.data_ptr(), out.data_ptr(), u.data_ptr(), de.data_ptr(),
            nacc.data_ptr(), p_tab.data_ptr(), de_tab.data_ptr(), r, length,
            stream_of(dev),
        )
    raise_if(err, "ising_sweep")
    build.launches["ising_sweep"] += 1
    return out, de, nacc


def _launch_sweeps(name, spins, words, t0, betas, rung, *, n_sweeps, j, b,
                   rule, replica_offset, t_add, out, extra=()):
    """Check, allocate and launch kernel A (``ising_fused``) or #2p
    (``ising_packed``, whose group width comes in ``extra``), which share
    one interface."""
    what = {"ising_fused": "kernel A", "ising_packed": "kernel #2p"}[name]
    dev = spins.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    r, length = spins.shape[0], spins.shape[-1]
    check(spins, "spins", torch.int8, (r, length, length), dev)
    check(words, "key words", torch.int64, (2,), dev)
    check(t0, "t0", torch.int64, (), dev)
    check(betas, "betas", torch.float32, (r,), dev)
    check(rung, "rung", torch.int32, (r,), dev)
    if length % 2:
        raise ValueError(f"checkerboard sweeps need even L, got {length}")
    lib_a, _, lib_p = _libs()
    lib = lib_a if name == "ising_fused" else lib_p
    check_smem(getattr(lib, f"{name}_smem_bytes")(length), f"{what} at L={length}")
    p_tab, de_tab = accept_tables(betas, j=j, b=b, rule=rule)
    if out is None:
        out = torch.empty_like(spins)
    check(out, "out", torch.int8, (r, length, length), dev)
    de = torch.empty(r, dtype=torch.float32, device=dev)
    nacc = torch.empty(r, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = getattr(lib, f"{name}_launch")(
            spins.data_ptr(), out.data_ptr(), de.data_ptr(), nacc.data_ptr(),
            rung.data_ptr(), p_tab.data_ptr(), de_tab.data_ptr(),
            words.data_ptr(), t0.data_ptr(), int(t_add),
            int(replica_offset) & prng.MASK, r, length, int(n_sweeps), *extra,
            stream_of(dev),
        )
    raise_if(err, name)
    build.launches[name] += 1
    return out, de, nacc


def ising_sweep_fused_kernel(
    spins, words, t0, betas, rung, *, n_sweeps: int, j: float = 1.0,
    b: float = 0.0, rule: str = "metropolis", replica_offset: int = 0,
    t_add: int = 0, out: torch.Tensor | None = None,
):
    """Kernel A: ``n_sweeps`` sweeps of every slot at ``betas[rung[slot]]``.

    Args:
      spins: (R, L, L) int8 on CUDA, L even.
      words: (2,) int64 run-key words; t0: () int64 sweep counter (device).
      betas: (R,) f32 ladder indexed by ``rung``; rung: (R,) int32.
      replica_offset: global index of slot 0 in the counter stream.
      t_add: added to ``t0`` on the device (round k of a multi-round call).
      out: optional (R, L, L) int8 output, may be ``spins`` itself.

    Returns ``(spins', delta_e (R,) f32, n_accepted (R,) int32)``.
    """
    return _launch_sweeps(
        "ising_fused", spins, words, t0, betas, rung, n_sweeps=n_sweeps, j=j,
        b=b, rule=rule, replica_offset=replica_offset, t_add=t_add, out=out,
    )


# replicas a byte of kernel #2p can hold
PACKED_MAX_GROUP = 8


def packed_group(n_replicas: int, n_sms: int) -> int:
    """Kernel #2p's group width: the widest of 1..8 that minimises the
    replicas on the busiest SM, ``ceil(ceil(R/g) / n_sms) * min(g, R)``
    (two blocks fit an SM, so blocks beyond one per SM share one)."""
    def busiest(g):
        blocks = _cdiv(n_replicas, g)
        return _cdiv(blocks, n_sms) * min(g, n_replicas)

    return min(range(PACKED_MAX_GROUP, 0, -1), key=busiest)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def packed_launch_shape(n_replicas: int, device="cuda") -> tuple[int, int, int]:
    """(blocks, threads per block, group width) of a kernel #2p launch over
    ``n_replicas`` slots on ``device``."""
    _, _, lib_p = _libs()
    group = packed_group(n_replicas, _sm_count(torch.device(device)))
    return _cdiv(n_replicas, group), lib_p.ising_packed_threads(), group


def ising_sweep_packed_kernel(
    spins, words, t0, betas, rung, *, n_sweeps: int, j: float = 1.0,
    b: float = 0.0, rule: str = "metropolis", replica_offset: int = 0,
    t_add: int = 0, out: torch.Tensor | None = None, group: int | None = None,
):
    """Kernel #2p: kernel A's sweeps with the spins packed up to 8 replicas
    a byte in shared memory.  Same arguments and results as
    `ising_sweep_fused_kernel`, and equal to it: spins and counts bit for
    bit, ΔE too (each replica's sums are kernel A's, in kernel A's order).
    ``group`` (1..8 replicas per block) defaults to `packed_group` for the
    card's SM count; no result depends on it."""
    if spins.device.type != "cuda":
        raise ValueError(f"kernel #2p needs CUDA tensors, got {spins.device}")
    if group is None:
        group = packed_launch_shape(spins.shape[0], spins.device)[2]
    if not 1 <= group <= PACKED_MAX_GROUP:
        raise ValueError(f"kernel #2p groups 1..{PACKED_MAX_GROUP} replicas, got {group}")
    return _launch_sweeps(
        "ising_packed", spins, words, t0, betas, rung, n_sweeps=n_sweeps, j=j,
        b=b, rule=rule, replica_offset=replica_offset, t_add=t_add, out=out,
        extra=(int(group),),
    )


def ising_sweep_fused_plain(
    spins, words, t0, betas, rung, *, n_sweeps: int, j: float = 1.0,
    b: float = 0.0, rule: str = "metropolis", replica_offset: int = 0,
    t_add: int = 0,
):
    """Plain version of kernel A: ``n_sweeps`` × `ref.ising_sweep` on
    `prng.ising_sweep_uniforms`, same arguments and results."""
    r, length = spins.shape[0], spins.shape[-1]
    beta_slot = betas[rung.long()]
    rep = replica_offset + torch.arange(r, dtype=torch.int64, device=spins.device)
    de = torch.zeros(r, dtype=torch.float32, device=spins.device)
    na = torch.zeros(r, dtype=torch.int32, device=spins.device)
    sk = prng.stream_key(words)
    for i in range(n_sweeps):
        u = prng.sweep_planes(sk, t0 + (t_add + i), rep, 2, length, length)
        spins, d, n = ref.ising_sweep(spins, u, beta_slot, j=j, b=b, rule=rule)
        de = de + d
        na = na + n
    return spins, de, na


# -- kernel #2p's plain version: sweeps on replica-bit-packed words ---------
#
# The JAX package packs 32 replicas into the bits of a uint32 word (bit k of
# word w is replica 32w + k, up = 1), counts each site's up neighbours with a
# bitwise full adder over the four rolled words, and selects ΔE per replica
# from the (spin, count) table.  Here the words are int64 tensors holding
# uint32 values (torch's CPU build has no uint32 shifts), and every bit of a
# word is handled at once by broadcasting over a 32-long shift axis.  The
# acceptance draw and the ΔE / count sums are `ref.ising_sweep`'s on the same
# (r, L, L) planes, so the result is the unpacked plain version's bit for bit.

_WORD = 32


def _shifts(device) -> torch.Tensor:
    return torch.arange(_WORD, dtype=torch.int64, device=device)[:, None, None]


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """(r, H, W) bool/0-1 planes -> (ceil(r/32), H, W) int64 words."""
    r, h, w = bits.shape
    n = -(-r // _WORD)
    planes = torch.zeros((n * _WORD, h, w), dtype=torch.int64, device=bits.device)
    planes[:r] = bits
    words = planes.view(n, _WORD, h, w) << _shifts(bits.device)
    return words.sum(dim=1)  # distinct bits: the sum is their OR


def _bits(words: torch.Tensor, r: int) -> torch.Tensor:
    """(n, H, W) words -> (r, H, W) int64 0/1 planes (replica order)."""
    n, h, w = words.shape
    planes = (words[:, None] >> _shifts(words.device)) & 1
    return planes.reshape(n * _WORD, h, w)[:r]


def pack_spins(spins: torch.Tensor) -> torch.Tensor:
    """(r, L, L) int8 ±1 -> bit-plane words, up = 1 (`_pack_spins`)."""
    return _pack(spins > 0)


def unpack_spins(words: torch.Tensor, r: int) -> torch.Tensor:
    """Inverse of `pack_spins`: (r, L, L) int8 ±1."""
    return (2 * _bits(words, r) - 1).to(torch.int8)


def _majority(a, b, c):
    return (a & b) | (a & c) | (b & c)


def _sweep_packed(words, u, beta, de_flat, par, r: int, rule: str):
    """One checkerboard sweep of the packed words (`_ising_sweep_body_packed`)."""
    ds = torch.zeros(r, dtype=torch.float32, device=words.device)
    na = torch.zeros(r, dtype=torch.int32, device=words.device)
    for color in (0, 1):
        up, dn = torch.roll(words, 1, -2), torch.roll(words, -1, -2)
        lf, rt = torch.roll(words, 1, -1), torch.roll(words, -1, -1)
        # up-neighbour count cnt = n0 + 2*n1 + 4*n2 by a bitwise full adder
        s0, c0 = up ^ dn, up & dn
        s1, c1 = lf ^ rt, lf & rt
        n0, c2 = s0 ^ s1, s0 & s1
        n1, n2 = c0 ^ c1 ^ c2, _majority(c0, c1, c2)
        entry = (5 * _bits(words, r) + _bits(n0, r) + 2 * _bits(n1, r)
                 + 4 * _bits(n2, r))
        de = de_flat[entry]
        accept = (u[:, color] < ref.accept_prob(de, beta, rule)) & (par == color)
        words = words ^ _pack(accept)
        ds = ds + torch.where(accept, de, 0.0).sum(dim=(-2, -1))
        na = na + accept.sum(dim=(-2, -1), dtype=torch.int32)
    return words, ds, na


def ising_sweep_packed_plain(
    spins, words, t0, betas, rung, *, n_sweeps: int, j: float = 1.0,
    b: float = 0.0, rule: str = "metropolis", replica_offset: int = 0,
    t_add: int = 0,
):
    """Plain version of kernel #2p: `ising_sweep_fused_plain` with the spins
    held as bit-plane words between load and store; same arguments and
    results, bit-equal to it."""
    r, length = spins.shape[0], spins.shape[-1]
    dev = spins.device
    beta = betas[rung.long()].to(torch.float32)[:, None, None]
    rep = replica_offset + torch.arange(r, dtype=torch.int64, device=dev)
    de_flat = de_table(j, b, dev).reshape(10)
    par = ref.parity(length, length, dev)
    packed = pack_spins(spins)
    de = torch.zeros(r, dtype=torch.float32, device=dev)
    na = torch.zeros(r, dtype=torch.int32, device=dev)
    sk = prng.stream_key(words)
    for i in range(n_sweeps):
        u = prng.sweep_planes(sk, t0 + (t_add + i), rep, 2, length, length)
        packed, d, n = _sweep_packed(packed, u, beta, de_flat, par, r, rule)
        de = de + d
        na = na + n
    return unpack_spins(packed, r), de, na


def exchange_kernel(
    rung, energy, de, betas, words, phase0, *, pairing: str, criterion: str,
    phase_add: int = 0, out=None,
):
    """Kernel B: ``energy += de`` then one exchange at phase ``phase0 + phase_add``.

    Args:
      rung: (R,) int32; energy, de, betas: (R,) f32 (betas in rung order).
      words: (2,) int64 key words; phase0: () int64 swap counter (device).
      out: optional ``(rung', energy', accept, prob, attempt)`` buffers;
        ``rung'``/``energy'`` may be the inputs themselves.

    Returns ``(rung' int32, energy' f32, accept bool, prob f32, attempt bool)``.
    """
    dev = rung.device
    if dev.type != "cuda":
        raise ValueError(f"kernel B needs CUDA tensors, got {dev}")
    if pairing not in exchange.PAIRINGS or criterion not in exchange.CRITERIA:
        raise ValueError(f"unsupported exchange {pairing!r}/{criterion!r}")
    n = rung.shape[0]
    check(rung, "rung", torch.int32, (n,), dev)
    for x, name in ((energy, "energy"), (de, "de"), (betas, "betas")):
        check(x, name, torch.float32, (n,), dev)
    check(words, "key words", torch.int64, (2,), dev)
    check(phase0, "phase0", torch.int64, (), dev)
    _, lib_b, _ = _libs()
    check_smem(lib_b.exchange_smem_bytes(n), f"kernel B at R={n}")
    if out is None:
        out = (
            torch.empty_like(rung), torch.empty_like(energy),
            torch.empty(n, dtype=torch.bool, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.bool, device=dev),
        )
    rung_out, energy_out, acc, prob, att = out
    check(rung_out, "rung out", torch.int32, (n,), dev)
    check(energy_out, "energy out", torch.float32, (n,), dev)
    check(acc, "accept row", torch.bool, (n,), dev)
    check(prob, "prob row", torch.float32, (n,), dev)
    check(att, "attempt row", torch.bool, (n,), dev)
    with torch.cuda.device(dev):
        err = lib_b.exchange_launch(
            rung.data_ptr(), rung_out.data_ptr(), energy.data_ptr(),
            energy_out.data_ptr(), de.data_ptr(), betas.data_ptr(),
            words.data_ptr(), phase0.data_ptr(), int(phase_add), n,
            int(pairing == "seo"), int(criterion == "metropolis"),
            acc.data_ptr(), prob.data_ptr(), att.data_ptr(), stream_of(dev),
        )
    raise_if(err, "exchange")
    build.launches["exchange"] += 1
    return out


def exchange_plain(
    rung, energy, de, betas, words, phase0, *, pairing: str, criterion: str,
    phase_add: int = 0,
):
    """Plain version of kernel B (`exchange.exchange_step` after ``energy + de``)."""
    energy = energy + de
    new_rung, acc, prob, att, _ = exchange.exchange_step(
        rung, energy, betas, phase0 + phase_add, words,
        pairing=pairing, criterion=criterion,
    )
    return new_rung, energy, acc, prob, att
