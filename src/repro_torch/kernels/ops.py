"""Public entry points of the kernels (twins of `repro.kernels.ops`).

The signatures are the JAX package's.  Dispatch is by the tensors' device
alone: a CPU tensor runs the plain PyTorch version, a CUDA tensor launches
the hand-written kernel (and raises if it cannot), anything else raises.
``use_pallas``, ``r_blk`` and ``chunk`` are TPU knobs, accepted and ignored.

Besides the JAX package's ops, `jax_uniform` draws the per-sweep
``jax.random`` uniforms that `ising_sweep`, `potts_sweep` and the EA sweep
consume on the engine's default path, and `hp_moves` / `single_flip` run
the serial chains that the JAX package leaves to XLA's ``fori_loop``
(``csrc/serial_chain.cu`` on the card).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ising_sweep as _isk
from repro_torch.kernels import jax_uniform as _ju
from repro_torch.kernels import potts_sweep as _pk
from repro_torch.kernels import prng as _prng
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import serial_chain as _sc
from repro_torch.kernels import wkv6 as _wkv6

__all__ = [
    "jax_uniform",
    "hp_moves",
    "single_flip",
    "ising_sweep",
    "potts_sweep",
    "ising_sweep_fused",
    "potts_sweep_fused",
    "ising_round_fused",
    "potts_round_fused",
    "wkv6",
]


def _device_kind(x: torch.Tensor, what: str = "sweep kernel") -> str:
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no {what} for tensors on {x.device}")
    return kind


def _counter(value, device) -> torch.Tensor:
    """() int64 device scalar from an int or a one-element tensor."""
    return torch.as_tensor(value, dtype=torch.int64, device=device).reshape(())


def _ising_sweeps(pack_bits: bool):
    """(plain, kernel) pair of the Ising sweeps: #2p with ``pack_bits``, else A."""
    if pack_bits:
        return _isk.ising_sweep_packed_plain, _isk.ising_sweep_packed_kernel
    return _isk.ising_sweep_fused_plain, _isk.ising_sweep_fused_kernel


def _check_potts_pack_bits(pack_bits: bool, q: int) -> None:
    """Potts ``pack_bits`` keeps int8 lanes, which kernel #5 always does."""
    if pack_bits and q > 64:
        raise ValueError(f"pack_bits needs q <= 64 (int8 lanes), got q={q}")


def jax_uniform(key: torch.Tensor, t, n_replicas: int, shape) -> torch.Tensor:
    """(n_replicas, *shape) f32: replica r's ``uniform(fold_in(fold_in(key,
    2t), r), shape)``, the JAX engine's per-sweep draw."""
    kind = _device_kind(key)
    t = _counter(t, key.device)
    if kind == "cpu":
        ids = torch.arange(n_replicas, dtype=torch.int64)
        return _ju.jax_uniform_plain(key, t, ids, shape)
    return _ju.jax_uniform_kernel(key, t, n_replicas, shape)


def hp_moves(pos: torch.Tensor, key: torch.Tensor, t, betas: torch.Tensor, *,
             hmask: torch.Tensor, eps: float, n_moves: int):
    """``n_moves`` HP end/corner moves of every replica's chain, replica r
    keyed by ``fold_in(fold_in(key, 2t), r)``; see
    `serial_chain.hp_moves_plain` for the contract.  One launch on CUDA."""
    kind = _device_kind(pos, "serial-chain kernel")
    fn = _sc.hp_moves_plain if kind == "cpu" else _sc.hp_moves_kernel
    return fn(pos, key, _counter(t, pos.device), betas.to(torch.float32),
              hmask=hmask.to(pos.device), eps=eps, n_moves=n_moves)


def single_flip(spins: torch.Tensor, key: torch.Tensor, t, betas: torch.Tensor, *,
                j: float = 1.0, b: float = 0.0, rule: str = "metropolis", flips: int = 1):
    """``flips`` serial single-spin flips of every replica's lattice, replica
    r keyed by ``fold_in(fold_in(key, 2t), r)``; see
    `serial_chain.single_flip_plain` for the contract.  One launch on CUDA."""
    kind = _device_kind(spins, "serial-chain kernel")
    fn = _sc.single_flip_plain if kind == "cpu" else _sc.single_flip_kernel
    return fn(spins, key, _counter(t, spins.device), betas.to(torch.float32),
              j=j, b=b, rule=rule, flips=flips)


def ising_sweep(
    spins: torch.Tensor,
    u: torch.Tensor,
    betas: torch.Tensor,
    *,
    j: float = 1.0,
    b: float = 0.0,
    rule: str = "metropolis",
    r_blk: int = 8,
    use_pallas: bool = True,
):
    """One checkerboard sweep; see `ref.ising_sweep` for the contract."""
    betas = betas.to(torch.float32)
    if _device_kind(spins) == "cpu":
        return _ref.ising_sweep(spins, u, betas, j=j, b=b, rule=rule)
    return _isk.ising_sweep_kernel(spins, u, betas, j=j, b=b, rule=rule)


def potts_sweep(
    states: torch.Tensor,
    u: torch.Tensor,
    betas: torch.Tensor,
    *,
    q: int,
    j: float = 1.0,
    rule: str = "metropolis",
    r_blk: int = 4,
    use_pallas: bool = True,
):
    """One checkerboard Potts sweep; see `ref.potts_sweep` for the contract."""
    betas = betas.to(torch.float32)
    if _device_kind(states) == "cpu":
        return _ref.potts_sweep(states, u, betas, q=q, j=j, rule=rule)
    return _pk.potts_sweep_kernel(states, u, betas, q=q, j=j, rule=rule)


def _fused(plain, kernel, states, key, t, betas, *, n_sweeps, replica_offset, **kw):
    """Shared body of the interval-fused ops (identity rung, per-slot betas)."""
    kind = _device_kind(states)
    dev = states.device
    words = _prng.key_words(key).to(dev)
    identity = torch.arange(states.shape[0], dtype=torch.int32, device=dev)
    fn = plain if kind == "cpu" else kernel
    return fn(
        states, words, _counter(t, dev), betas.to(torch.float32), identity,
        n_sweeps=n_sweeps, replica_offset=int(replica_offset), **kw,
    )


def ising_sweep_fused(
    spins: torch.Tensor,
    key: torch.Tensor,
    t,
    betas: torch.Tensor,
    *,
    n_sweeps: int,
    replica_offset: int = 0,
    j: float = 1.0,
    b: float = 0.0,
    rule: str = "metropolis",
    r_blk: int = 8,
    pack_bits: bool = False,
    use_pallas: bool = True,
):
    """``n_sweeps`` checkerboard sweeps with counter-PRNG uniforms.

    ``key`` is (2,) int64 key data, ``t`` the global sweep counter at entry,
    ``betas`` the per-slot (R,) inverse temperatures.  Returns ``(spins',
    delta_e, n_accepted)`` summed over the interval.  ``pack_bits`` runs
    kernel #2p (on the CPU its plain version), whose results are kernel A's
    bit for bit.
    """
    return _fused(
        *_ising_sweeps(pack_bits), spins, key, t, betas, n_sweeps=n_sweeps,
        replica_offset=replica_offset, j=j, b=b, rule=rule,
    )


def potts_sweep_fused(
    states: torch.Tensor,
    key: torch.Tensor,
    t,
    betas: torch.Tensor,
    *,
    n_sweeps: int,
    q: int,
    replica_offset: int = 0,
    j: float = 1.0,
    rule: str = "metropolis",
    r_blk: int = 4,
    pack_bits: bool = False,
    use_pallas: bool = True,
):
    """``n_sweeps`` Potts sweeps with counter-PRNG uniforms; see
    `ising_sweep_fused`.  ``pack_bits`` (int8 lanes, q <= 64) runs the same
    kernel: its trajectory is bitwise the unpacked one."""
    _check_potts_pack_bits(pack_bits, q)
    return _fused(
        _pk.potts_sweep_fused_plain, _pk.potts_sweep_fused_kernel, states, key,
        t, betas, n_sweeps=n_sweeps, replica_offset=replica_offset, q=q, j=j,
        rule=rule,
    )


def _round_fused(plain, kernel, states, key, t, phase, rung, energy, betas, *,
                 n_sweeps, n_rounds, criterion, pairing, **kw):
    """Shared body of the whole-round ops: per round, S sweeps at
    ``betas[rung]`` then one exchange.  On the CPU the plain sweeps then
    `exchange_plain`; on CUDA one launch of the round ``kernel`` a round,
    with nothing waiting for the card."""
    kind = _device_kind(states)
    dev = states.device
    words = _prng.key_words(key).to(dev)
    t0 = _counter(t, dev)
    ph0 = _counter(phase, dev)
    rung = rung.to(torch.int32)
    energy = energy.to(torch.float32)
    betas = betas.to(torch.float32)
    r = states.shape[0]
    na_total = torch.zeros(r, dtype=torch.int32, device=dev)
    xw = dict(pairing=pairing, criterion=criterion)
    if kind == "cpu":
        rows = []
        for k in range(n_rounds):
            states, de, na = plain(
                states, words, t0, betas, rung, n_sweeps=n_sweeps,
                t_add=k * n_sweeps, **kw,
            )
            na_total = na_total + na
            rung, energy, acc, prob, att = _isk.exchange_plain(
                rung, energy, de, betas, words, ph0, phase_add=k, **xw
            )
            rows.append((acc, prob, att))
        acc, prob, att = (torch.stack(x) for x in zip(*rows))
        return states, rung, energy, na_total, acc, prob, att

    acc = torch.empty((n_rounds, r), dtype=torch.bool, device=dev)
    prob = torch.empty((n_rounds, r), dtype=torch.float32, device=dev)
    att = torch.empty((n_rounds, r), dtype=torch.bool, device=dev)
    out = torch.empty_like(states)
    rung_out, energy_out = torch.empty_like(rung), torch.empty_like(energy)
    for k in range(n_rounds):
        na = kernel(
            states, words, t0, ph0, betas, rung, energy, n_sweeps=n_sweeps,
            t_add=k * n_sweeps, phase_add=k,
            out=(out, rung_out, energy_out, acc[k], prob[k], att[k]), **xw, **kw,
        )[3]
        na_total += na
        # later rounds update the output buffers in place
        states, rung, energy = out, rung_out, energy_out
    return out, rung_out, energy_out, na_total, acc, prob, att


def ising_round_fused(
    spins: torch.Tensor,
    key: torch.Tensor,
    t,
    phase,
    rung: torch.Tensor,
    energy: torch.Tensor,
    betas: torch.Tensor,
    *,
    n_sweeps: int,
    n_rounds: int = 1,
    j: float = 1.0,
    b: float = 0.0,
    rule: str = "metropolis",
    criterion: str = "logistic",
    pairing: str = "deo",
    pack_bits: bool = False,
    use_pallas: bool = True,
):
    """``n_rounds`` × (``n_sweeps`` sweeps at ``betas[rung]`` + one exchange).

    On CUDA each round is one launch of kernel A (kernel #2p with
    ``pack_bits``) whose last block runs the exchange, enqueued on the
    current stream with no host sync.
    Returns ``(spins', rung', energy', n_accepted, accept, prob, attempt)``
    with (n_rounds, R) diagnostics in `repro.core.swap.accept_pairs`
    conventions.
    """
    return _round_fused(
        _ising_sweeps(pack_bits)[0],
        functools.partial(_isk.ising_round_kernel, pack_bits=pack_bits), spins,
        key, t, phase, rung, energy, betas, n_sweeps=n_sweeps, n_rounds=n_rounds,
        criterion=criterion, pairing=pairing, j=j, b=b, rule=rule,
    )


def potts_round_fused(
    states: torch.Tensor,
    key: torch.Tensor,
    t,
    phase,
    rung: torch.Tensor,
    energy: torch.Tensor,
    betas: torch.Tensor,
    *,
    n_sweeps: int,
    q: int,
    n_rounds: int = 1,
    j: float = 1.0,
    rule: str = "metropolis",
    criterion: str = "logistic",
    pairing: str = "deo",
    pack_bits: bool = False,
    use_pallas: bool = True,
):
    """Whole-round Potts op; see `ising_round_fused`.  On CUDA each round is
    one launch of kernel #5 whose last block runs the exchange."""
    _check_potts_pack_bits(pack_bits, q)
    return _round_fused(
        _pk.potts_sweep_fused_plain, _pk.potts_round_kernel, states, key,
        t, phase, rung, energy, betas, n_sweeps=n_sweeps, n_rounds=n_rounds,
        criterion=criterion, pairing=pairing, q=q, j=j, rule=rule,
    )


def wkv6(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    initial_state: torch.Tensor | None = None,
    *,
    chunk: int = 64,
    use_pallas: bool = True,
):
    """RWKV-6 recurrence; see `ref.wkv6` for the contract.

    On CUDA one launch of kernel #7 covers all T steps (no padding of T).
    Returns ``(o (BH, T, dv) f32, final_state (BH, dk, dv) f32)``.
    """
    if _device_kind(r, "wkv6 kernel") == "cpu":
        return _ref.wkv6(r, k, v, w, u, initial_state)
    return _wkv6.wkv6_kernel(r, k, v, w, u, initial_state)
