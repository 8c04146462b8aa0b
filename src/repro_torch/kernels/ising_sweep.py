"""ctypes wrappers of the Ising CUDA kernels, each beside its plain version.

* kernel #1, ``csrc/sweep.cu`` — one checkerboard sweep with the uniforms
  passed in (replaces `repro.kernels.ising_sweep.ising_sweep_pallas`);
* kernel A, ``csrc/ising_fused.cu`` — S checkerboard sweeps per launch
  (replaces `repro.kernels.ising_sweep.ising_sweep_fused_pallas`);
* kernel #2p, ``csrc/ising_packed.cu`` — kernel A's sweeps on replica-bit-
  packed spins, up to 8 replicas a byte (replaces the ``pack_bits`` body
  `repro.kernels.ising_sweep._ising_sweep_body_packed` of both fused
  kernels);
* a whole PT round, ``ising_round_kernel`` — one launch of kernel A (or
  #2p) whose last block to finish runs the temp-mode exchange on the O(R)
  rows (``csrc/exchange.cuh``), as ``ising_round_fused_pallas`` is one
  ``pallas_call``; Potts rounds run the same exchange in kernel #5.

Each ``*_kernel`` wrapper checks dtype, shape and contiguity, then the
device (a CPU tensor is refused), allocates its outputs with
``torch.empty``, launches on the current stream without synchronising,
raises if the launch was refused, and adds one to
``build.launches[name]``, all through the helpers of `build`.  Each plain
version (``*_plain``, or `ref.ising_sweep` for kernel #1, `exchange_plain`
for the round's exchange) computes the same thing with plain torch ops on
any device; it is what `repro_torch.kernels.ops` runs for CPU tensors and
what the kernels are compared with on the card.
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
    "ising_round_kernel",
    "exchange_plain",
]

_P = ctypes.c_void_p


@functools.cache
def _libs() -> tuple[ctypes.CDLL, ctypes.CDLL]:
    """Kernels A and #2p, built on first use, with their C signatures."""
    lib_a, lib_p = build.library("ising_fused"), build.library("ising_packed")
    # kernel #2p takes kernel A's arguments (replicas, chains, L, sweeps) and
    # its group width; both then take a round's exchange arguments (null for
    # the sweeps alone)
    args = [_P] * 9 + [ctypes.c_longlong, ctypes.c_uint] + [ctypes.c_int] * 4
    lib_a.ising_fused_launch.argtypes = args + build.ROUND_ARGTYPES + [_P]
    lib_p.ising_packed_launch.argtypes = args + [ctypes.c_int] + build.ROUND_ARGTYPES + [_P]
    for lib, name in ((lib_a, "ising_fused"), (lib_p, "ising_packed")):
        getattr(lib, f"{name}_launch").restype = ctypes.c_int
        smem = getattr(lib, f"{name}_smem_bytes")
        smem.restype = ctypes.c_longlong
        smem.argtypes = [ctypes.c_int]
    lib_p.ising_packed_threads.restype = ctypes.c_int
    lib_p.ising_packed_threads.argtypes = []
    lib_p.ising_packed_blocks_per_sm.restype = ctypes.c_int
    lib_p.ising_packed_blocks_per_sm.argtypes = [ctypes.c_int, _P]
    return lib_a, lib_p


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
                   rule, replica_offset, t_add, out, group=None, xchg=None):
    """Check, allocate and launch kernel A (``ising_fused``) or #2p
    (``ising_packed``, ``group`` replicas a block), which share one
    interface.  ``xchg`` is a round's ``(energy, phase0, rows, exchange
    keywords)`` with its rows checked (`build.check_round`): the launch then
    runs the exchange too; without it, the sweeps alone.

    ``spins`` (R, L, L) is one chain; (C, R, L, L) is C chains in one launch
    (the grid's second dimension), with ``words`` (C, 2), ``t0`` (C,),
    ``rung`` (C, R) and the outputs (C, R): chain c's results are those of a
    launch on its slice alone.  ``betas`` is 1-D, indexed by the values of
    ``rung``: (R,) shared by the chains, or (C*R,) with chain c's ``rung``
    in [c*R, (c+1)*R) (the interval path's per-slot rows)."""
    what = {"ising_fused": "kernel A", "ising_packed": "kernel #2p"}[name]
    dev = spins.device
    lead = tuple(spins.shape[:-3])
    if len(lead) > 1 or spins.dim() < 3:
        raise ValueError(f"{what} takes (R, L, L) or (C, R, L, L) spins, got "
                         f"{tuple(spins.shape)}")
    n_chains = lead[0] if lead else 1
    r, length = spins.shape[-3], spins.shape[-1]
    check(spins, "spins", torch.int8, (*lead, r, length, length), dev)
    check(words, "key words", torch.int64, (*lead, 2), dev)
    check(t0, "t0", torch.int64, lead, dev)
    if betas.shape not in ((r,), (n_chains * r,)):
        raise ValueError(f"betas has shape {tuple(betas.shape)}, expected ({r},) "
                         f"or ({n_chains * r},)")
    check(betas, "betas", torch.float32, betas.shape, dev)
    check(rung, "rung", torch.int32, (*lead, r), dev)
    if out is not None:
        check(out, "out", torch.int8, (*lead, r, length, length), dev)
    if length % 2:
        raise ValueError(f"checkerboard sweeps need even L, got {length}")
    if n_sweeps < 0:
        raise ValueError(f"n_sweeps must be >= 0, got {n_sweeps}")
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    extra = ()
    if name == "ising_packed":
        if group is None:
            group = packed_launch_shape(r, length, dev)[2]
        if not 1 <= group <= PACKED_MAX_GROUP:
            raise ValueError(f"kernel #2p groups 1..{PACKED_MAX_GROUP} replicas, got {group}")
        extra = (int(group),)
    lib_a, lib_p = _libs()
    lib = lib_a if name == "ising_fused" else lib_p
    check_smem(getattr(lib, f"{name}_smem_bytes")(length), f"{what} at L={length}")
    p_tab, de_tab = accept_tables(betas, j=j, b=b, rule=rule)
    if out is None:
        out = torch.empty_like(spins)
    de = torch.empty((*lead, r), dtype=torch.float32, device=dev)
    nacc = torch.empty((*lead, r), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        round_args = build.round_args(lib, betas, xchg, n_chains)
        err = getattr(lib, f"{name}_launch")(
            spins.data_ptr(), out.data_ptr(), de.data_ptr(), nacc.data_ptr(),
            rung.data_ptr(), p_tab.data_ptr(), de_tab.data_ptr(),
            words.data_ptr(), t0.data_ptr(), int(t_add),
            int(replica_offset) & prng.MASK, r, n_chains, length, int(n_sweeps), *extra,
            *round_args, stream_of(dev),
        )
    raise_if(err, name)
    build.launches[name] += 1
    if xchg is not None:
        build.epilogues["exchange"] += n_chains
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

    A leading chain axis runs C chains in one launch (see `_launch_sweeps`).

    Returns ``(spins', delta_e (R,) f32, n_accepted (R,) int32)``.
    """
    return _launch_sweeps(
        "ising_fused", spins, words, t0, betas, rung, n_sweeps=n_sweeps, j=j,
        b=b, rule=rule, replica_offset=replica_offset, t_add=t_add, out=out,
    )


# replicas a byte of kernel #2p can hold
PACKED_MAX_GROUP = 8


def packed_group(n_replicas: int, n_sms: int, blocks_per_sm: int = 2) -> int:
    """Kernel #2p's group width: the widest of 1..8 that minimises the
    replicas on the busiest SM, ``ceil(ceil(R/g) / n_sms) * min(g, R)``.

    ``blocks_per_sm`` is how many blocks an SM holds at once (the kernel's
    occupancy at its lattice side).  The card hands blocks out one an SM at
    a time, so the busiest SM gets ``ceil(blocks / n_sms)`` groups whether
    they run together (up to ``blocks_per_sm``) or in turn, and its replica
    count, which the kernel's issue-bound time follows, is the same: the
    width does not depend on it.  A kernel that fits no block raises."""
    if blocks_per_sm < 1:
        raise ValueError(f"kernel #2p fits {blocks_per_sm} blocks an SM: it cannot launch")

    def busiest(g):
        blocks = _cdiv(n_replicas, g)
        return _cdiv(blocks, n_sms) * min(g, n_replicas)

    return min(range(PACKED_MAX_GROUP, 0, -1), key=busiest)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _blocks_per_sm(length: int, device: torch.device) -> int:
    """Kernel #2p's blocks an SM at lattice side ``length`` (its occupancy)."""
    _, lib_p = _libs()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib_p.ising_packed_blocks_per_sm(int(length), ctypes.byref(blocks))
    raise_if(err, "ising_packed occupancy")
    return blocks.value


def packed_launch_shape(n_replicas: int, length: int, device="cuda") -> tuple[int, int, int]:
    """(blocks, threads per block, group width) of a kernel #2p launch over
    ``n_replicas`` slots of side ``length`` on ``device``."""
    _, lib_p = _libs()
    device = torch.device(device)
    group = packed_group(n_replicas, _sm_count(device), _blocks_per_sm(length, device))
    return _cdiv(n_replicas, group), lib_p.ising_packed_threads(), group


def ising_sweep_packed_kernel(
    spins, words, t0, betas, rung, *, n_sweeps: int, j: float = 1.0,
    b: float = 0.0, rule: str = "metropolis", replica_offset: int = 0,
    t_add: int = 0, out: torch.Tensor | None = None, group: int | None = None,
):
    """Kernel #2p: kernel A's sweeps with the spins packed up to 8 replicas
    a byte in shared memory.  Same arguments and results as
    `ising_sweep_fused_kernel`, and equal to it bit for bit: spins, counts
    and ΔE (each replica's partial sums add kernel A's terms in kernel A's
    order).  ``group`` (1..8 replicas per block) defaults to `packed_group`
    for the card's SM count and the kernel's occupancy; no result depends
    on it."""
    return _launch_sweeps(
        "ising_packed", spins, words, t0, betas, rung, n_sweeps=n_sweeps, j=j,
        b=b, rule=rule, replica_offset=replica_offset, t_add=t_add, out=out,
        group=group,
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


def ising_round_kernel(
    spins, words, t0, phase0, betas, rung, energy, *, n_sweeps: int,
    pairing: str, criterion: str, j: float = 1.0, b: float = 0.0,
    rule: str = "metropolis", t_add: int = 0, phase_add: int = 0,
    pack_bits: bool = False, group: int | None = None, out=None,
):
    """One whole PT round in one launch: kernel A (#2p with ``pack_bits``,
    ``group`` replicas a block) sweeps every slot ``n_sweeps`` times at
    ``betas[rung[slot]]``, then the block that finishes last adds each
    slot's ΔE to ``energy`` and runs one exchange at phase ``phase0 +
    phase_add`` (``csrc/exchange.cuh``).

    Args:
      spins: (R, L, L) int8 on CUDA, L even; or (C, R, L, L): C chains in
        the same launch, each chain's last block running its own exchange.
      words: (2,) int64 run-key words; t0, phase0: () int64 sweep and swap
        counters (device); ``t_add`` / ``phase_add`` are added on the device.
        With C chains: (C, 2), (C,) and (C,).
      betas: (R,) f32 ladder in rung order, shared by the chains; rung: (R,)
        int32 slot -> rung; energy: (R,) f32 per slot ((C, R) each with C
        chains).
      out: optional ``(spins', rung', energy', accept, prob, attempt)``
        buffers; ``spins'``, ``rung'`` and ``energy'`` may be the inputs
        themselves (every block reads its slot's rung before the exchange
        writes ``rung'``).

    Returns ``(spins', rung', energy', n_accepted, accept, prob, attempt)``,
    equal to the plain sweeps then `exchange_plain` on their ΔE, chain by
    chain.
    """
    r = spins.shape[-3]
    chains = spins.shape[0] if spins.dim() == 4 else None
    if betas.shape != (r,):
        raise ValueError(f"a round's betas are the shared ({r},) ladder, got "
                         f"{tuple(betas.shape)}")
    rows = build.check_round(r, spins.device, rung, energy, phase0,
                             None if out is None else out[1:], pairing=pairing,
                             criterion=criterion, chains=chains)
    xkw = dict(phase_add=phase_add, pairing=pairing, criterion=criterion)
    spins_out, _, nacc = _launch_sweeps(
        "ising_packed" if pack_bits else "ising_fused", spins, words, t0, betas,
        rung, n_sweeps=n_sweeps, j=j, b=b, rule=rule, replica_offset=0,
        t_add=t_add, out=None if out is None else out[0], group=group,
        xchg=(energy, phase0, rows, xkw),
    )
    rung_out, energy_out, acc, prob, att = rows
    return spins_out, rung_out, energy_out, nacc, acc, prob, att


def exchange_plain(
    rung, energy, de, betas, words, phase0, *, pairing: str, criterion: str,
    phase_add: int = 0,
):
    """Plain version of a round launch's exchange: ``energy + de``, then
    `exchange.exchange_step`; returns ``(rung', energy', accept, prob, attempt)``."""
    energy = energy + de
    new_rung, acc, prob, att, _ = exchange.exchange_step(
        rung, energy, betas, phase0 + phase_add, words,
        pairing=pairing, criterion=criterion,
    )
    return new_rung, energy, acc, prob, att
