"""Public entry points of the fused Ising kernels (twins of `repro.kernels.ops`).

The signatures are the JAX package's.  Dispatch is by the tensors' device
alone: a CPU tensor runs the plain PyTorch version, a CUDA tensor launches
the hand-written kernel (and raises if it cannot), anything else raises.
``use_pallas`` and ``r_blk`` are TPU knobs, accepted and ignored.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ising_sweep as _isk
from repro_torch.kernels import prng as _prng

__all__ = ["ising_sweep_fused", "ising_round_fused"]


def _device_kind(x: torch.Tensor) -> str:
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no Ising kernel for tensors on {x.device}")
    return kind


def _counter(value, device) -> torch.Tensor:
    """() int64 device scalar from an int or a one-element tensor."""
    return torch.as_tensor(value, dtype=torch.int64, device=device).reshape(())


def _refuse_pack_bits(pack_bits: bool) -> None:
    if pack_bits:
        raise NotImplementedError(
            "not yet ported: pack_bits multispin coding (TPU kernel #2p)"
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
    delta_e, n_accepted)`` summed over the interval.
    """
    _refuse_pack_bits(pack_bits)
    kind = _device_kind(spins)
    dev = spins.device
    words = _prng.key_words(key).to(dev)
    t0 = _counter(t, dev)
    betas = betas.to(torch.float32)
    identity = torch.arange(spins.shape[0], dtype=torch.int32, device=dev)
    fn = _isk.ising_sweep_fused_plain if kind == "cpu" else _isk.ising_sweep_fused_kernel
    return fn(
        spins, words, t0, betas, identity, n_sweeps=n_sweeps, j=j, b=b,
        rule=rule, replica_offset=int(replica_offset),
    )


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

    On CUDA each round is kernel A then kernel B, enqueued on the current
    stream with no host sync between them.  Returns ``(spins', rung',
    energy', n_accepted, accept, prob, attempt)`` with (n_rounds, R)
    diagnostics in `repro.core.swap.accept_pairs` conventions.
    """
    _refuse_pack_bits(pack_bits)
    kind = _device_kind(spins)
    dev = spins.device
    words = _prng.key_words(key).to(dev)
    t0 = _counter(t, dev)
    ph0 = _counter(phase, dev)
    rung = rung.to(torch.int32)
    energy = energy.to(torch.float32)
    betas = betas.to(torch.float32)
    r = spins.shape[0]
    na_total = torch.zeros(r, dtype=torch.int32, device=dev)
    kw = dict(j=j, b=b, rule=rule)
    xw = dict(pairing=pairing, criterion=criterion)
    if kind == "cpu":
        rows = []
        for k in range(n_rounds):
            spins, de, na = _isk.ising_sweep_fused_plain(
                spins, words, t0, betas, rung, n_sweeps=n_sweeps,
                t_add=k * n_sweeps, **kw,
            )
            na_total = na_total + na
            rung, energy, acc, prob, att = _isk.exchange_plain(
                rung, energy, de, betas, words, ph0, phase_add=k, **xw
            )
            rows.append((acc, prob, att))
        acc, prob, att = (torch.stack(x) for x in zip(*rows))
        return spins, rung, energy, na_total, acc, prob, att

    acc = torch.empty((n_rounds, r), dtype=torch.bool, device=dev)
    prob = torch.empty((n_rounds, r), dtype=torch.float32, device=dev)
    att = torch.empty((n_rounds, r), dtype=torch.bool, device=dev)
    out = torch.empty_like(spins)
    rung_out, energy_out = torch.empty_like(rung), torch.empty_like(energy)
    for k in range(n_rounds):
        out, de, na = _isk.ising_sweep_fused_kernel(
            spins, words, t0, betas, rung, n_sweeps=n_sweeps,
            t_add=k * n_sweeps, out=out, **kw,
        )
        na_total += na
        _isk.exchange_kernel(
            rung, energy, de, betas, words, ph0, phase_add=k,
            out=(rung_out, energy_out, acc[k], prob[k], att[k]), **xw,
        )
        # later rounds update the output buffers in place
        spins, rung, energy = out, rung_out, energy_out
    return out, rung_out, energy_out, na_total, acc, prob, att
