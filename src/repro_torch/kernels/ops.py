"""Public entry points of the kernels (twins of `repro.kernels.ops`).

The signatures are the JAX package's.  Dispatch is by the tensors' device
alone: a CPU tensor runs the plain PyTorch version, a CUDA tensor launches
the hand-written kernel (and raises if it cannot), anything else raises.
``use_pallas``, ``r_blk`` and ``chunk`` are TPU knobs, accepted and ignored.

Besides the JAX package's ops, `jax_uniform` draws the per-sweep
``jax.random`` uniforms that `ising_sweep`, `potts_sweep` and the EA sweep
consume on the engine's default path, and `hp_moves` / `single_flip` run
the serial chains that the JAX package leaves to XLA's ``fori_loop``
(``csrc/serial_chain.cu`` on the card); each takes the ``replica_offset``
of a replica shard.  The sharded round path's exchange alone is
`repro_torch.kernels.exchange.exchange_rows`.

The dry run's ops (`wkv6` and its gradient, the interval-fused sweeps) also
take ``meta`` tensors: they return empty tensors of the contract's
shapes and dtypes, run neither the kernel nor the plain version, and
report the work of the launch (`build.count_meta`: flops, 32-bit integer
instructions and bytes by the bound formulas of the kernels' chip checks).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build as _build
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


def _device_kind(x: torch.Tensor, what: str = "sweep kernel", meta: bool = False) -> str:
    """``cpu`` (the plain version), ``cuda`` (the kernel) or, where the op
    has a dry-run path (``meta``), ``meta``."""
    kind = x.device.type
    if kind not in ("cpu", "cuda") and not (meta and kind == "meta"):
        raise ValueError(f"no {what} for tensors on {x.device}")
    return kind


# the 32-bit integer instructions of one Threefry-2x32-20 block (2 counter
# adds, 20 rounds of add / rotate / xor, 5 key injections of 2 adds): a
# uniform, or an Ising site update of kernel A
THREEFRY_OPS = 2 + 20 * 3 + 5 * 2


def _nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs if isinstance(x, torch.Tensor))


def _counter(value, device, chains: int | None = None) -> torch.Tensor:
    """() int64 device scalar from an int or a one-element tensor; with a
    chain axis, (C,) int64 (an int or a () tensor is every chain's)."""
    x = torch.as_tensor(value, dtype=torch.int64, device=device)
    if chains is None:
        return x.reshape(())
    return x.broadcast_to((chains,)).contiguous()


def _chains(states: torch.Tensor, key) -> int | None:
    """C when ``key`` is C keys, (C, 2), over (C, R, ...) states (a chain
    axis, one launch for every chain on CUDA); None for one (2,) key."""
    key = torch.as_tensor(key)
    if key.dim() == 1:
        return None
    if key.dim() != 2 or key.shape[0] != states.shape[0]:
        raise ValueError(f"keys of shape {tuple(key.shape)} for states of shape "
                         f"{tuple(states.shape)}: expected (2,) or (C, 2) with C "
                         "the states' leading axis")
    return key.shape[0]


def _chain_words(key: torch.Tensor, device) -> torch.Tensor:
    """(C, 2) int64 words of C two-word keys: each row is `prng.key_words`
    of its key (the words themselves, as uint32)."""
    return key.to(device=device, dtype=torch.int64) & _prng.MASK


def _ising_sweeps(pack_bits: bool):
    """(plain, kernel) pair of the Ising sweeps: #2p with ``pack_bits``, else A."""
    if pack_bits:
        return _isk.ising_sweep_packed_plain, _isk.ising_sweep_packed_kernel
    return _isk.ising_sweep_fused_plain, _isk.ising_sweep_fused_kernel


def _check_potts_pack_bits(pack_bits: bool, q: int) -> None:
    """Potts ``pack_bits`` keeps int8 lanes, which kernel #5 always does."""
    if pack_bits and q > 64:
        raise ValueError(f"pack_bits needs q <= 64 (int8 lanes), got q={q}")


def jax_uniform(key: torch.Tensor, t, n_replicas: int, shape,
                replica_offset: int = 0) -> torch.Tensor:
    """(n_replicas, *shape) f32: replica r's ``uniform(fold_in(fold_in(key,
    2t), offset + r), shape)``, the JAX engine's per-sweep draw (``offset`` =
    ``replica_offset``, a replica shard's first global slot)."""
    kind = _device_kind(key)
    t = _counter(t, key.device)
    if kind == "cpu":
        ids = replica_offset + torch.arange(n_replicas, dtype=torch.int64)
        return _ju.jax_uniform_plain(key, t, ids, shape)
    return _ju.jax_uniform_kernel(key, t, n_replicas, shape, replica_offset)


def hp_moves(pos: torch.Tensor, key: torch.Tensor, t, betas: torch.Tensor, *,
             hmask: torch.Tensor, eps: float, n_moves: int, replica_offset: int = 0):
    """``n_moves`` HP end/corner moves of every replica's chain, replica r
    keyed by ``fold_in(fold_in(key, 2t), replica_offset + r)``; see
    `serial_chain.hp_moves_plain` for the contract.  One launch on CUDA."""
    kind = _device_kind(pos, "serial-chain kernel")
    fn = _sc.hp_moves_plain if kind == "cpu" else _sc.hp_moves_kernel
    return fn(pos, key, _counter(t, pos.device), betas.to(torch.float32),
              hmask=hmask.to(pos.device), eps=eps, n_moves=n_moves,
              replica_offset=replica_offset)


def single_flip(spins: torch.Tensor, key: torch.Tensor, t, betas: torch.Tensor, *,
                j: float = 1.0, b: float = 0.0, rule: str = "metropolis", flips: int = 1,
                replica_offset: int = 0):
    """``flips`` serial single-spin flips of every replica's lattice, replica
    r keyed by ``fold_in(fold_in(key, 2t), replica_offset + r)``; see
    `serial_chain.single_flip_plain` for the contract.  One launch on CUDA."""
    kind = _device_kind(spins, "serial-chain kernel")
    fn = _sc.single_flip_plain if kind == "cpu" else _sc.single_flip_kernel
    return fn(spins, key, _counter(t, spins.device), betas.to(torch.float32),
              j=j, b=b, rule=rule, flips=flips, replica_offset=replica_offset)


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
    """Shared body of the interval-fused ops (identity rung, per-slot betas).

    With a chain axis (``key`` (C, 2), ``t`` (C,), ``betas`` (C, R) over (C,
    R, ...) states) CUDA makes one launch for every chain; the CPU runs the
    plain version chain by chain; ``meta`` runs neither (`_fused_meta`)."""
    kind = _device_kind(states, meta=True)
    if kind == "meta":
        return _fused_meta(kernel, states, n_sweeps)
    dev = states.device
    c = _chains(states, key)
    if c is not None:
        t = _counter(t, dev, c)
        if kind == "cpu":
            outs = [_fused(plain, kernel, states[i], key[i], t[i], betas[i],
                           n_sweeps=n_sweeps, replica_offset=replica_offset, **kw)
                    for i in range(c)]
            return tuple(torch.stack(x) for x in zip(*outs))
        r = states.shape[1]
        # chain i's slot s reads row i*R + s of the flattened per-slot betas
        rows = torch.arange(c * r, dtype=torch.int32, device=dev).view(c, r)
        return kernel(
            states, _chain_words(key, dev), t, betas.to(torch.float32).reshape(-1), rows,
            n_sweeps=n_sweeps, replica_offset=int(replica_offset), **kw,
        )
    words = _prng.key_words(key).to(dev)
    identity = torch.arange(states.shape[0], dtype=torch.int32, device=dev)
    fn = plain if kind == "cpu" else kernel
    return fn(
        states, words, _counter(t, dev), betas.to(torch.float32), identity,
        n_sweeps=n_sweeps, replica_offset=int(replica_offset), **kw,
    )


def _fused_meta(kernel, states, n_sweeps: int):
    """The dry run of an interval-fused launch: ``(states', delta_e,
    n_accepted)`` empty, and its work: a Threefry block (twice for Potts)
    and a compare per site update, the states read and written once."""
    name = getattr(kernel, "__name__", "")
    potts = "potts" in name
    label = "potts_fused" if potts else "ising_packed" if "packed" in name else "ising_fused"
    lead = states.shape[:-2]
    updates = states.numel() * n_sweeps
    out = (torch.empty_like(states), torch.empty(lead, device="meta"),
           torch.empty(lead, dtype=torch.int32, device="meta"))
    _build.count_meta(label, flops=updates,
                      int_ops=(2 if potts else 1) * THREEFRY_OPS * updates,
                      n_bytes=_nbytes(states, *out))
    return out


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
    bit for bit.  C keys ``(C, 2)``, ``t`` (C,) and ``betas`` (C, R) over
    ``(C, R, L, L)`` spins run C chains, one launch on CUDA.
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
    with nothing waiting for the card.

    With a chain axis (``key`` (C, 2), ``t`` and ``phase`` (C,), ``rung``
    and ``energy`` (C, R) over (C, R, ...) states; ``betas`` (R,) shared)
    CUDA makes one launch a round for every chain, and the diagnostics are
    (n_rounds, C, R); the CPU runs the plain rounds chain by chain."""
    kind = _device_kind(states)
    dev = states.device
    c = _chains(states, key)
    if c is not None and kind == "cpu":
        t, phase = _counter(t, dev, c), _counter(phase, dev, c)
        outs = [_round_fused(plain, kernel, states[i], key[i], t[i], phase[i], rung[i],
                             energy[i], betas, n_sweeps=n_sweeps, n_rounds=n_rounds,
                             criterion=criterion, pairing=pairing, **kw)
                for i in range(c)]
        return tuple(torch.stack(x, dim=1 if n >= 4 else 0)
                     for n, x in enumerate(zip(*outs)))
    if c is None:
        words = _prng.key_words(key).to(dev)
    else:
        words = _chain_words(key, dev)
    t0 = _counter(t, dev, c)
    ph0 = _counter(phase, dev, c)
    rung = rung.to(torch.int32)
    energy = energy.to(torch.float32)
    betas = betas.to(torch.float32)
    lead = () if c is None else (c,)
    r = states.shape[len(lead)]
    na_total = torch.zeros((*lead, r), dtype=torch.int32, device=dev)
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

    acc = torch.empty((n_rounds, *lead, r), dtype=torch.bool, device=dev)
    prob = torch.empty((n_rounds, *lead, r), dtype=torch.float32, device=dev)
    att = torch.empty((n_rounds, *lead, r), dtype=torch.bool, device=dev)
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
    current stream with no host sync; C keys ``(C, 2)`` over ``(C, R, L,
    L)`` spins run C chains in the same launch (see `_round_fused`).
    Returns ``(spins', rung', energy', n_accepted, accept, prob, attempt)``
    with (n_rounds, R) diagnostics ((n_rounds, C, R) with a chain axis) in
    `repro.core.swap.accept_pairs` conventions.
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


def wkv6_work(bh: int, t: int, dk: int, dv: int, state: bool) -> tuple[float, float]:
    """(f32 flops, bytes) of kernel #7: ~4·dk·dv + 3·dk + 2·dv flops a slab
    and step; r, k, w, v read and o written once, u read once, the final
    state written and an initial one (``state``) read once."""
    n_state = (2 if state else 1) * bh * dk * dv
    return (float(bh * t * (4 * dk * dv + 3 * dk + 2 * dv)),
            4.0 * (bh * t * (3 * dk + 2 * dv) + n_state + bh * dk))


def wkv6_bwd_work(bh: int, t: int, dk: int, dv: int, state: bool) -> tuple[float, float]:
    """(f32 flops, bytes) of kernel #7b: 14·dk·dv + 12·dk + 4·dv flops a slab
    and step; r, k, w, v, do read and dr, dk, dw, dv written once, u read
    and du written once, with an initial state it and d(final state) read
    and d(initial state) written once."""
    n_state = (3 if state else 0) * bh * dk * dv
    return (float(bh * t * (14 * dk * dv + 12 * dk + 4 * dv)),
            4.0 * (bh * t * (3 * dk + 2 * dv) + bh * t * (3 * dk + dv) + n_state + 2 * bh * dk))


class _Wkv6Meta(torch.autograd.Function):
    """The dry run of `_Wkv6`: empty outputs of the contract's shapes and
    the work of #7 forward and #7b backward (`build.count_meta`)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, initial_state):
        bh, t, dk = k.shape
        dv = v.shape[-1]
        ctx.shape, ctx.state = (bh, t, dk, dv), initial_state is not None
        flops, n_bytes = wkv6_work(bh, t, dk, dv, ctx.state)
        _build.count_meta("wkv6", flops=flops, n_bytes=n_bytes)
        return (torch.empty((bh, t, dv), dtype=torch.float32, device="meta"),
                torch.empty((bh, dk, dv), dtype=torch.float32, device="meta"))

    @staticmethod
    def backward(ctx, d_o, d_state):
        bh, t, dk, dv = ctx.shape
        flops, n_bytes = wkv6_bwd_work(bh, t, dk, dv, ctx.state)
        _build.count_meta("wkv6_bwd", flops=flops, n_bytes=n_bytes)

        def grad(i, shape):
            return torch.empty(shape, dtype=torch.float32, device="meta") \
                if ctx.needs_input_grad[i] else None

        return (grad(0, (bh, t, dk)), grad(1, (bh, t, dk)), grad(2, (bh, t, dv)),
                grad(3, (bh, t, dk)), grad(4, (bh, dk)), grad(5, (bh, dk, dv)))


class _Wkv6(torch.autograd.Function):
    """The recurrence on the card with its gradient: kernel #7 forward,
    kernel #7b backward (the forward's inputs saved, nothing else)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, initial_state):
        ctx.save_for_backward(r, k, v, w, u, initial_state)
        ctx.set_materialize_grads(False)  # an unused final state's gradient: None
        return _wkv6.wkv6_kernel(r, k, v, w, u, initial_state)

    @staticmethod
    def backward(ctx, d_o, d_state):
        r, k, v, w, u, s0 = ctx.saved_tensors
        d_o = torch.zeros_like(v) if d_o is None else d_o.contiguous()
        d_state = None if d_state is None else d_state.contiguous()
        need = ctx.needs_input_grad[5]
        dr, dk, dv, dw, du, ds0 = _wkv6.wkv6_bwd_kernel(r, k, v, w, u, s0, d_o, d_state,
                                                        need_state_grad=need)
        return dr, dk, dv, dw, du, ds0


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

    On CUDA one launch of kernel #7 covers all T steps (no padding of T);
    where autograd records, the gradient is one launch of kernel #7b, and
    never the plain version (`_Wkv6`; under ``no_grad`` it records
    nothing).  On the CPU it is the plain recurrence, differentiated by
    autograd; on ``meta``, shapes and counted work only (`_Wkv6Meta`).
    Returns ``(o (BH, T, dv) f32, final_state (BH, dk, dv) f32)``.
    """
    kind = _device_kind(r, "wkv6 kernel", meta=True)
    if kind == "cpu":
        return _ref.wkv6(r, k, v, w, u, initial_state)
    if kind == "meta":
        return _Wkv6Meta.apply(r, k, v, w, u, initial_state)
    return _Wkv6.apply(r, k, v, w, u, initial_state)
