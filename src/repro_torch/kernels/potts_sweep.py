"""ctypes wrappers of the Potts CUDA kernels, each beside its plain version
(twin of `repro.kernels.potts_sweep`).

* kernel #4, ``csrc/sweep.cu`` — one checkerboard sweep with the uniforms
  passed in (replaces `repro.kernels.potts_sweep.potts_sweep_pallas`); its
  plain version is `ref.potts_sweep`;
* kernel #5, ``csrc/potts_fused.cu`` — S sweeps per launch with in-kernel
  Threefry uniforms (replaces ``potts_sweep_fused_pallas``);
* a whole PT round, ``potts_round_kernel`` — one launch of kernel #5 whose
  last block to finish runs the round's exchange (``csrc/exchange.cuh``;
  replaces ``potts_round_fused_pallas``).

The wrappers follow `repro_torch.kernels.ising_sweep`: check, refuse a CPU
tensor, allocate with ``torch.empty``, launch on the current stream without
a sync, raise if the launch was refused, count the launch in
``build.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, prng, ref
from repro_torch.kernels.build import check, check_smem, raise_if, stream_of

__all__ = [
    "potts_tables",
    "potts_sweep_kernel",
    "potts_sweep_fused_kernel",
    "potts_sweep_fused_plain",
    "potts_round_kernel",
]

_P = ctypes.c_void_p


@functools.cache
def _fused_lib() -> ctypes.CDLL:
    lib = build.library("potts_fused")
    lib.potts_fused_launch.restype = ctypes.c_int
    lib.potts_fused_launch.argtypes = [_P] * 9 + [
        # replicas, chains, H, W, q, sweeps
        ctypes.c_longlong, ctypes.c_uint, *[ctypes.c_int] * 6, *build.ROUND_ARGTYPES, _P,
    ]
    lib.potts_fused_smem_bytes.restype = ctypes.c_longlong
    lib.potts_fused_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def potts_tables(betas: torch.Tensor, *, j: float, rule: str):
    """Per-beta acceptance rows with the plain version's own ops.

    Entry ``k = 27*(a+1) + 9*(b+1) + 3*(c+1) + (d+1)`` is for the direction
    terms ``[s == nbr] - [trial == nbr]`` = (a, b, c, d) of the up, down,
    left and right neighbours.  Returns ``(p_tab (R, 81) f32, de_tab (81,)
    f32)``; ΔE adds ``j * term`` in `ref.POTTS_DIRECTIONS` order from 0, as
    `ref.potts_sweep` does, and ``p = accept_prob(ΔE, beta)``, so a kernel
    that selects from them is bit-equal to the plain version.
    """
    dev = betas.device
    k = torch.arange(81, device=dev)  # on the device: no copy waits for the stream
    de_tab = torch.zeros(81, dtype=torch.float32, device=dev)
    for place in (27, 9, 3, 1):
        term = (k // place) % 3 - 1
        de_tab = de_tab + j * ((term == 1).to(torch.float32) - (term == -1).to(torch.float32))
    p_tab = ref.accept_prob(de_tab[None], betas.to(torch.float32)[:, None], rule)
    return p_tab.contiguous(), de_tab


def _shape(states: torch.Tensor, what: str):
    if states.dim() != 3:
        raise ValueError(f"{what} takes (R, H, W) states, got {tuple(states.shape)}")
    r, h, w = states.shape
    if h % 2 or w % 2:
        raise ValueError(f"checkerboard sweeps need even H and W, got {h}x{w}")
    return r, h, w


def _check_q(q: int) -> None:
    if not 2 <= q <= 128:
        raise ValueError(f"int8 Potts colours need 2 <= q <= 128, got q={q}")


def potts_sweep_kernel(states, u, betas, *, q: int, j: float = 1.0,
                       rule: str = "metropolis"):
    """Kernel #4: one checkerboard Potts sweep, uniforms passed in.

    Args:
      states: (R, H, W) int8 colours on CUDA, H and W even.
      u: (R, 2, 2, H, W) f32, colour x (proposal, acceptance).
      betas: (R,) f32 per replica.

    Returns ``(states', delta_e (R,) f32, n_accepted (R,) int32)``, equal to
    `ref.potts_sweep` on the same inputs.
    """
    r, h, w = _shape(states, "kernel #4")
    _check_q(q)
    dev = states.device
    check(states, "states", torch.int8, (r, h, w), dev)
    check(u, "u", torch.float32, (r, 2, 2, h, w), dev)
    check(betas, "betas", torch.float32, (r,), dev)
    _refuse_cpu(dev, "kernel #4")
    lib = build.sweep_lib()
    check_smem(lib.potts_sweep_smem_bytes(h, w), f"kernel #4 at {h}x{w}")
    p_tab, de_tab = potts_tables(betas, j=j, rule=rule)
    out = torch.empty_like(states)
    de = torch.empty(r, dtype=torch.float32, device=dev)
    nacc = torch.empty(r, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.potts_sweep_launch(
            states.data_ptr(), out.data_ptr(), u.data_ptr(), de.data_ptr(),
            nacc.data_ptr(), p_tab.data_ptr(), de_tab.data_ptr(), r, h, w, q,
            stream_of(dev),
        )
    raise_if(err, "potts_sweep")
    build.launches["potts_sweep"] += 1
    return out, de, nacc


def _refuse_cpu(dev, what: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")


def _launch_fused(states, words, t0, betas, rung, *, n_sweeps, q, j, rule,
                  replica_offset, t_add, out, xchg=None):
    """Check, allocate and launch kernel #5; ``xchg`` and a leading chain
    axis as in `ising_sweep._launch_sweeps` (a round's exchange, else the
    sweeps alone; (C, R, H, W) colours for C chains in one launch)."""
    lead = tuple(states.shape[:-3])
    if len(lead) > 1:
        raise ValueError(f"kernel #5 takes (R, H, W) or (C, R, H, W) colours, got "
                         f"{tuple(states.shape)}")
    n_chains = lead[0] if lead else 1
    r, h, w = _shape(states[0] if lead else states, "kernel #5")
    _check_q(q)
    dev = states.device
    check(states, "states", torch.int8, (*lead, r, h, w), dev)
    check(words, "key words", torch.int64, (*lead, 2), dev)
    check(t0, "t0", torch.int64, lead, dev)
    if betas.shape not in ((r,), (n_chains * r,)):
        raise ValueError(f"betas has shape {tuple(betas.shape)}, expected ({r},) "
                         f"or ({n_chains * r},)")
    check(betas, "betas", torch.float32, betas.shape, dev)
    check(rung, "rung", torch.int32, (*lead, r), dev)
    if out is not None:
        check(out, "out", torch.int8, (*lead, r, h, w), dev)
    if n_sweeps < 0:
        raise ValueError(f"n_sweeps must be >= 0, got {n_sweeps}")
    _refuse_cpu(dev, "kernel #5")
    lib = _fused_lib()
    check_smem(lib.potts_fused_smem_bytes(h, w), f"kernel #5 at {h}x{w}")
    p_tab, de_tab = potts_tables(betas, j=j, rule=rule)
    if out is None:
        out = torch.empty_like(states)
    de = torch.empty((*lead, r), dtype=torch.float32, device=dev)
    nacc = torch.empty((*lead, r), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        round_args = build.round_args(lib, betas, xchg, n_chains)
        err = lib.potts_fused_launch(
            states.data_ptr(), out.data_ptr(), de.data_ptr(), nacc.data_ptr(),
            rung.data_ptr(), p_tab.data_ptr(), de_tab.data_ptr(),
            words.data_ptr(), t0.data_ptr(), int(t_add),
            int(replica_offset) & prng.MASK, r, n_chains, h, w, q, int(n_sweeps),
            *round_args, stream_of(dev),
        )
    raise_if(err, "potts_fused")
    build.launches["potts_fused"] += 1
    if xchg is not None:
        build.epilogues["exchange"] += n_chains
    return out, de, nacc


def potts_sweep_fused_kernel(
    states, words, t0, betas, rung, *, n_sweeps: int, q: int, j: float = 1.0,
    rule: str = "metropolis", replica_offset: int = 0, t_add: int = 0,
    out: torch.Tensor | None = None,
):
    """Kernel #5: ``n_sweeps`` Potts sweeps of every slot at ``betas[rung[slot]]``.

    Arguments and results as `ising_sweep.ising_sweep_fused_kernel`, with
    (R, H, W) int8 colours and ``q``.
    """
    return _launch_fused(
        states, words, t0, betas, rung, n_sweeps=n_sweeps, q=q, j=j, rule=rule,
        replica_offset=replica_offset, t_add=t_add, out=out,
    )


def potts_round_kernel(
    states, words, t0, phase0, betas, rung, energy, *, n_sweeps: int, q: int,
    pairing: str, criterion: str, j: float = 1.0, rule: str = "metropolis",
    t_add: int = 0, phase_add: int = 0, out=None,
):
    """One whole Potts PT round in one launch of kernel #5, its last block
    running the exchange; arguments and results as
    `ising_sweep.ising_round_kernel`, with (R, H, W) int8 colours and ``q``
    ((C, R, H, W) for C chains in one launch)."""
    r = states.shape[-3]
    if betas.shape != (r,):
        raise ValueError(f"a round's betas are the shared ({r},) ladder, got "
                         f"{tuple(betas.shape)}")
    rows = build.check_round(r, states.device, rung, energy, phase0,
                             None if out is None else out[1:], pairing=pairing,
                             criterion=criterion,
                             chains=states.shape[0] if states.dim() == 4 else None)
    xkw = dict(phase_add=phase_add, pairing=pairing, criterion=criterion)
    states_out, _, nacc = _launch_fused(
        states, words, t0, betas, rung, n_sweeps=n_sweeps, q=q, j=j, rule=rule,
        replica_offset=0, t_add=t_add, out=None if out is None else out[0],
        xchg=(energy, phase0, rows, xkw),
    )
    rung_out, energy_out, acc, prob, att = rows
    return states_out, rung_out, energy_out, nacc, acc, prob, att


def potts_sweep_fused_plain(
    states, words, t0, betas, rung, *, n_sweeps: int, q: int, j: float = 1.0,
    rule: str = "metropolis", replica_offset: int = 0, t_add: int = 0,
):
    """Plain version of kernel #5: ``n_sweeps`` × `ref.potts_sweep` on
    `prng.potts_sweep_uniforms`, same arguments and results."""
    r, h, w = states.shape
    beta_slot = betas[rung.long()]
    rep = replica_offset + torch.arange(r, dtype=torch.int64, device=states.device)
    de = torch.zeros(r, dtype=torch.float32, device=states.device)
    na = torch.zeros(r, dtype=torch.int32, device=states.device)
    sk = prng.stream_key(words)
    for i in range(n_sweeps):
        u = prng.sweep_planes(sk, t0 + (t_add + i), rep, 4, h, w).reshape(r, 2, 2, h, w)
        states, d, n = ref.potts_sweep(states, u, beta_slot, q=q, j=j, rule=rule)
        de = de + d
        na = na + n
    return states, de, na
