"""ctypes wrappers of the Ising CUDA kernels, each beside its plain version.

* kernel #1, ``csrc/sweep.cu`` — one checkerboard sweep with the uniforms
  passed in (replaces `repro.kernels.ising_sweep.ising_sweep_pallas`);
* kernel A, ``csrc/ising_fused.cu`` — S checkerboard sweeps per launch
  (replaces `repro.kernels.ising_sweep.ising_sweep_fused_pallas` and the
  sweep half of ``ising_round_fused_pallas``);
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
    "exchange_kernel",
    "exchange_plain",
]

_P = ctypes.c_void_p


@functools.cache
def _libs() -> tuple[ctypes.CDLL, ctypes.CDLL]:
    """Both kernel libraries, built on first use, with their C signatures."""
    lib_a, lib_b = build.library("ising_fused"), build.library("exchange")
    lib_a.ising_fused_launch.restype = ctypes.c_int
    lib_a.ising_fused_launch.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _P,
        ctypes.c_longlong, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _P,
    ]
    lib_a.ising_fused_smem_bytes.restype = ctypes.c_longlong
    lib_a.ising_fused_smem_bytes.argtypes = [ctypes.c_int]
    lib_b.exchange_launch.restype = ctypes.c_int
    lib_b.exchange_launch.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _P, _P, _P, _P,
    ]
    lib_b.exchange_smem_bytes.restype = ctypes.c_longlong
    lib_b.exchange_smem_bytes.argtypes = [ctypes.c_int]
    return lib_a, lib_b


def accept_tables(betas: torch.Tensor, *, j: float, b: float, rule: str):
    """Per-rung acceptance rows with the plain version's own ops.

    Returns ``(p_tab (R, 2, 5) f32, de_tab (2, 5) f32)``: entry ``[s, n]`` is
    for spin ``s`` in (-1, +1) and neighbour sum ``-4 + 2n``.  Kernels A and
    #1 select from these instead of evaluating exp/sigmoid per site, so they
    are bit-equal to `ref.ising_sweep` by construction.
    """
    dev = betas.device
    # built on the device (arange, not a host list) so no copy waits for the stream
    s = (2 * torch.arange(2, device=dev) - 1).to(torch.float32)[:, None]
    nbr = (2 * torch.arange(5, device=dev) - 4).to(torch.float32)[None, :]
    de_tab = 2.0 * s * (j * nbr - b)
    p_tab = ref.accept_prob(
        de_tab[None], betas.to(torch.float32)[:, None, None], rule
    )
    return p_tab.contiguous(), de_tab.contiguous()


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
    dev = spins.device
    if dev.type != "cuda":
        raise ValueError(f"kernel A needs CUDA tensors, got {dev}")
    r, length = spins.shape[0], spins.shape[-1]
    check(spins, "spins", torch.int8, (r, length, length), dev)
    check(words, "key words", torch.int64, (2,), dev)
    check(t0, "t0", torch.int64, (), dev)
    check(betas, "betas", torch.float32, (r,), dev)
    check(rung, "rung", torch.int32, (r,), dev)
    if length % 2:
        raise ValueError(f"checkerboard sweeps need even L, got {length}")
    lib_a, _ = _libs()
    check_smem(lib_a.ising_fused_smem_bytes(length), f"kernel A at L={length}")
    p_tab, de_tab = accept_tables(betas, j=j, b=b, rule=rule)
    if out is None:
        out = torch.empty_like(spins)
    check(out, "out", torch.int8, (r, length, length), dev)
    de = torch.empty(r, dtype=torch.float32, device=dev)
    nacc = torch.empty(r, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib_a.ising_fused_launch(
            spins.data_ptr(), out.data_ptr(), de.data_ptr(), nacc.data_ptr(),
            rung.data_ptr(), p_tab.data_ptr(), de_tab.data_ptr(),
            words.data_ptr(), t0.data_ptr(), int(t_add),
            int(replica_offset) & prng.MASK, r, length, int(n_sweeps), stream_of(dev),
        )
    raise_if(err, "ising_fused")
    build.launches["ising_fused"] += 1
    return out, de, nacc


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
    for i in range(n_sweeps):
        u = prng.ising_sweep_uniforms(words, t0 + (t_add + i), rep, length)
        spins, d, n = ref.ising_sweep(spins, u, beta_slot, j=j, b=b, rule=rule)
        de = de + d
        na = na + n
    return spins, de, na


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
    _, lib_b = _libs()
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
