"""ctypes wrappers of the serial-chain CUDA kernels, each beside its plain
version.

``csrc/serial_chain.cu`` holds two kernels, each one serial Metropolis
chain per replica (the JAX package's ``lax.fori_loop`` chains; no Pallas
kernel):

* ``hp_moves_kernel`` — ``n_moves`` end/corner moves of an HP lattice
  protein (`repro.core.hp.HPChain.mcmc_step`);
* ``single_flip_kernel`` — ``flips`` single-spin flips of an Ising lattice
  (`repro.core.ising.IsingSystem._single_flip_steps`).

Both start replica r from the JAX engine's per-sweep key
``fold_in(fold_in(key, 2t), offset + r)`` (``offset`` = ``replica_offset``,
the first global slot of a replica shard; 0 on one device) and draw every iteration's keys as
``jax.random`` does (`core.keys`); the kernels derive them on the card from
the run key and the () sweep counter ``t``, with no host-side Threefry.
Acceptance reads per-replica tables (`hp_tables`, `ising_sweep.accept_tables`)
built with the plain version's own torch expressions, so each kernel equals
its plain version bit for bit on the card.

Each plain version (``*_plain``) runs on any device: it derives the chain's
keys (one Threefry evaluation a step, in sequence), then every draw of the
whole chain in a few batched calls, then the moves, batched over replicas.
It is what `repro_torch.kernels.ops` runs for CPU tensors.  Each
``*_kernel`` wrapper checks its arguments, refuses a CPU tensor, allocates
its outputs, launches on the current stream without synchronising, raises
if the launch was refused, and adds one to ``build.launches[name]``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import keys
from repro_torch.kernels import build, ref
from repro_torch.kernels.build import check, raise_if, stream_of
from repro_torch.kernels.ising_sweep import accept_tables

__all__ = ["HP_DIRECTIONS", "hp_tables", "hp_moves_plain", "hp_moves_kernel",
           "single_flip_plain", "single_flip_kernel"]

_P = ctypes.c_void_p
# (dx, dy) of the end move's direction draw, in the JAX package's order
HP_DIRECTIONS = ((1, 0), (-1, 0), (0, 1), (0, -1))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("serial_chain")
    lib.hp_moves_launch.restype = ctypes.c_int
    lib.hp_moves_launch.argtypes = [_P] * 9 + [ctypes.c_int] * 3 + [ctypes.c_uint, _P]
    lib.single_flip_launch.restype = ctypes.c_int
    lib.single_flip_launch.argtypes = [_P] * 8 + [ctypes.c_int] * 3 + [ctypes.c_uint, _P]
    return lib


def _chain_keys(k_r: torch.Tensor, steps: int) -> torch.Tensor:
    """(R, steps, 2): the key each step of replica r's chain splits, from
    ``k_r`` (R, 2); step m+1 takes key 0 of step m's split."""
    out = [k_r]
    for _ in range(steps - 1):
        out.append(keys.fold_in(out[-1], 0))
    return torch.stack(out, dim=1)


def hp_tables(betas: torch.Tensor, eps: float):
    """Per-replica acceptance rows of the HP chain with the plain version's
    own ops: ``(p_tab (R, 7) f32, de_tab (7,) f32)`` at the contact change
    ``k = -3..3``: ``de = -eps * k``, ``p = exp(-beta * de)``."""
    k = torch.arange(-3, 4, device=betas.device).to(torch.float32)
    de_tab = -eps * k
    p_tab = torch.exp(-betas.to(torch.float32)[:, None] * de_tab[None])
    return p_tab.contiguous(), de_tab.contiguous()


def hp_moves_plain(pos, key, t, betas, *, hmask, eps: float, n_moves: int,
                   replica_offset: int = 0, work=None):
    """``n_moves`` end/corner moves of every replica's chain.

    Args:
      pos: (R, N, 2) int32 monomer coordinates; key: (2,) int64 run key;
      t: () int64 sweep counter; betas: (R,) f32 per replica;
      hmask: (N,) bool, True at H monomers;
      replica_offset: the global slot of replica 0 (its keys' ``fold_in``);
      work: a dict to fill, if given, with what the data asked of the
        kernel, summed over replicas as () int64 tensors: ``ends`` (end
        moves, which draw a direction), ``evaluated`` (moves to a new site,
        which scan the chain) and ``tested`` (those to a free site, which
        draw a uniform).

    Returns ``(pos', delta_e (R,) f32, n_accepted (R,) int32)``.
    """
    r, n = pos.shape[0], pos.shape[1]
    dev = pos.device
    ar = torch.arange(r, device=dev)
    de_acc = torch.zeros(r, dtype=torch.float32, device=dev)
    n_acc = torch.zeros(r, dtype=torch.int32, device=dev)
    pos = pos.clone()
    if n_moves == 0:
        return pos, de_acc, n_acc
    ks = _chain_keys(keys.replica_keys(key, t, ar + replica_offset), n_moves)
    site = keys.randint(keys.fold_in(ks, 1), (), 0, n).long()  # (R, M)
    dirs = torch.tensor(HP_DIRECTIONS, dtype=torch.int32, device=dev)
    end_step = dirs[keys.randint(keys.fold_in(ks, 2), (), 0, 4).long()]  # (R, M, 2)
    u = keys.uniform(keys.fold_in(ks, 3), ())  # (R, M)
    idx = torch.arange(n, device=dev)
    nonbonded = (idx[:, None] - idx[None, :]).abs() > 1
    hm = hmask.to(device=dev, dtype=torch.float32)
    betas = betas.to(torch.float32)

    def contacts(i, at):
        """H-H contacts monomer i makes from ``at`` (R, 2), |i - j| > 1."""
        manh = (pos - at[:, None, :]).abs().sum(dim=-1)
        return torch.where((manh == 1) & nonbonded[i], hm[i][:, None] * hm, 0.0).sum(dim=-1)

    counts = dict.fromkeys(("ends", "evaluated", "tested"), 0)
    for m in range(n_moves):
        i = site[:, m]
        is_end = (i == 0) | (i == n - 1)
        cur = pos[ar, i]
        end_cand = pos[ar, torch.where(i == 0, 1, n - 2)] + end_step[:, m]
        a = pos[ar, (i - 1).clamp(0, n - 1)]
        b = pos[ar, (i + 1).clamp(0, n - 1)]
        corner_ok = (a[:, 0] != b[:, 0]) & (a[:, 1] != b[:, 1])
        cand = torch.where(is_end[:, None], end_cand, a + b - cur)
        movable = is_end | corner_ok
        moved = (cand != cur).any(dim=-1)
        occupied = ((pos == cand[:, None, :]).all(dim=-1) & (idx != i[:, None])).any(dim=-1)
        de = -eps * (contacts(i, cand) - contacts(i, cur))
        accept = movable & moved & ~occupied & (u[:, m] < torch.exp(-betas * de))
        if work is not None:
            counts["ends"] = counts["ends"] + is_end.sum()
            counts["evaluated"] = counts["evaluated"] + (movable & moved).sum()
            counts["tested"] = counts["tested"] + (movable & moved & ~occupied).sum()
        pos[ar, i] = torch.where(accept[:, None], cand, cur)
        de_acc = de_acc + torch.where(accept, de, 0.0)
        n_acc = n_acc + accept.to(torch.int32)
    if work is not None:
        work.update(counts)
    return pos, de_acc, n_acc


def _offset(replica_offset: int) -> int:
    if not 0 <= replica_offset < 1 << 32:
        raise ValueError(f"replica_offset must fit 32 bits, got {replica_offset}")
    return int(replica_offset)


def hp_moves_kernel(pos, key, t, betas, *, hmask, eps: float, n_moves: int,
                    replica_offset: int = 0):
    """One launch of ``hp_moves_kernel``; arguments and result as
    `hp_moves_plain`, all on one CUDA device."""
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"hp_moves_kernel needs CUDA tensors, got {dev}")
    r, n = pos.shape[0], pos.shape[1]
    check(pos, "pos", torch.int32, (r, n, 2), dev)
    check(key, "key", torch.int64, (2,), dev)
    check(t, "t", torch.int64, (), dev)
    check(betas, "betas", torch.float32, (r,), dev)
    check(hmask, "hmask", torch.bool, (n,), dev)
    if n < 3 or n_moves < 0:
        raise ValueError(f"hp_moves needs N >= 3 and n_moves >= 0, got {n}, {n_moves}")
    p_tab, de_tab = hp_tables(betas, eps)
    out = torch.empty_like(pos)
    de = torch.empty(r, dtype=torch.float32, device=dev)
    nacc = torch.empty(r, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().hp_moves_launch(
            pos.data_ptr(), out.data_ptr(), hmask.data_ptr(), key.data_ptr(), t.data_ptr(),
            p_tab.data_ptr(), de_tab.data_ptr(), de.data_ptr(), nacc.data_ptr(), r, n,
            n_moves, _offset(replica_offset), stream_of(dev))
    raise_if(err, "hp_moves")
    build.launches["hp_moves"] += 1
    return out, de, nacc


def single_flip_plain(spins, key, t, betas, *, j: float, b: float, rule: str, flips: int,
                      replica_offset: int = 0):
    """``flips`` single-spin Metropolis/Glauber flips of every replica.

    Args:
      spins: (R, L, L) int8 in {-1, +1}, any L; key: (2,) int64 run key;
      t: () int64 sweep counter; betas: (R,) f32 per replica;
      replica_offset: the global slot of replica 0 (its keys' ``fold_in``).

    Returns ``(spins', delta_e (R,) f32, n_accepted (R,) int32)``.
    """
    r, length = spins.shape[0], spins.shape[-1]
    dev = spins.device
    ar = torch.arange(r, device=dev)
    de_acc = torch.zeros(r, dtype=torch.float32, device=dev)
    n_acc = torch.zeros(r, dtype=torch.int32, device=dev)
    spins = spins.clone()
    if flips == 0:
        return spins, de_acc, n_acc
    ks = _chain_keys(keys.replica_keys(key, t, ar + replica_offset), flips)
    site = keys.randint(keys.fold_in(ks, 1), (2,), 0, length).long()  # (R, F, 2)
    u = keys.uniform(keys.fold_in(ks, 2), ())  # (R, F)
    betas = betas.to(torch.float32)
    for f in range(flips):
        row, col = site[:, f, 0], site[:, f, 1]
        s = spins[ar, row, col]
        nbr = (spins[ar, (row + 1) % length, col] + spins[ar, (row - 1) % length, col]
               + spins[ar, row, (col + 1) % length] + spins[ar, row, (col - 1) % length])
        de = 2.0 * s.to(torch.float32) * (j * nbr.to(torch.float32) - b)
        accept = u[:, f] < ref.accept_prob(de, betas, rule)
        spins[ar, row, col] = torch.where(accept, -s, s)
        de_acc = de_acc + torch.where(accept, de, 0.0)
        n_acc = n_acc + accept.to(torch.int32)
    return spins, de_acc, n_acc


def single_flip_kernel(spins, key, t, betas, *, j: float, b: float, rule: str, flips: int,
                       replica_offset: int = 0):
    """One launch of ``single_flip_kernel``; arguments and result as
    `single_flip_plain`, all on one CUDA device."""
    dev = spins.device
    if dev.type != "cuda":
        raise ValueError(f"single_flip_kernel needs CUDA tensors, got {dev}")
    r, length = spins.shape[0], spins.shape[-1]
    check(spins, "spins", torch.int8, (r, length, length), dev)
    check(key, "key", torch.int64, (2,), dev)
    check(t, "t", torch.int64, (), dev)
    check(betas, "betas", torch.float32, (r,), dev)
    if flips < 0:
        raise ValueError(f"flips must be >= 0, got {flips}")
    if length * length >= 1 << 31:
        raise ValueError(f"single_flip_kernel indexes a lattice with int32, got L={length}")
    p_tab, de_tab = accept_tables(betas, j=j, b=b, rule=rule)
    out = torch.empty_like(spins)
    de = torch.empty(r, dtype=torch.float32, device=dev)
    nacc = torch.empty(r, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().single_flip_launch(
            spins.data_ptr(), out.data_ptr(), key.data_ptr(), t.data_ptr(), p_tab.data_ptr(),
            de_tab.data_ptr(), de.data_ptr(), nacc.data_ptr(), r, length, flips,
            _offset(replica_offset), stream_of(dev))
    raise_if(err, "single_flip")
    build.launches["single_flip"] += 1
    return out, de, nacc
