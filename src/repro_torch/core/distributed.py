"""Distributed replica placement over `torch.distributed` (twin of
`repro.core.distributed`).

The paper splits the replicas over threads (|R|/H replicas a thread); the
JAX package makes that a named 2-D device mesh, and so does the port, with
one process (a rank) per device.  `MeshSpec(ensemble, replica)` puts
``ensemble`` ranks along the ``chains`` axis, each holding whole chains,
times ``replica`` ranks along the ``replicas`` axis, each holding a
contiguous block of every chain's slots.  Rank ``e * replica + d`` holds
chain block ``e`` and slot block ``d`` (ensemble-major, the JAX device
order).  Between exchanges a rank advances its block with no
communication; at an exchange:

* ``temp`` swap mode: the decision needs only the (R,) energy and rung rows,
  one all-gather each of O(R) scalars over the rank's replica subgroup; the
  full-ladder decision is computed redundantly on every rank from identical
  inputs, and no lattice moves (rungs permute in place);
* ``state`` swap mode moves lattices between the slots of accepted pairs,
  so it needs ``replica == 1`` (whole chains a rank); `repro_torch.engine.
  EngineConfig` refuses a sharded replica axis in state mode, as the JAX
  engine does.

The placement contract, on tensors (`local_block` cuts it, `gather_state`
undoes it):

=====================  ==============================  ====================
engine state leaf      one chain (C == 1)              ensemble (C > 1)
=====================  ==============================  ====================
``pt.states`` leaves   slots ``[d R/D, (d+1) R/D)``    chains ``[e C/E,
``pt.energy/rung``     of the (R, ...) leaf            (e+1) C/E)`` x slots
``pt.key/phase/t``     whole                           chains ``[e C/E, ...)``
``stats`` leaves       whole (R,) rows                 chains x whole rows
``betas``              whole                           whole
=====================  ==============================  ====================

The O(R) rows (stats, betas, the swap decision) are kept whole and equal on
every rank of a replica subgroup, which is what makes a sharded run equal
to the single-device run bit for bit.  `MeshSpec.build` binds the spec to
the running process group and returns the rank's `MeshLayout`: its
coordinates, device, subgroups and collectives.  Checkpoints are
mesh-independent: `gather_state` assembles the whole state (for a
checkpoint or a result), and `local_block` cuts any rank's block from it.

Elastic scaling: replicas are independent between swaps, so
`rebalance_state` reshapes a chain's population onto a new ladder size
(`rebalance_ladder`), as the JAX twin does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from repro_torch.core.pt import PTState, map_states

__all__ = [
    "CHAIN_AXIS",
    "REPLICA_AXIS",
    "MeshSpec",
    "MeshLayout",
    "launcher_group",
    "local_block",
    "gather_state",
    "rebalance_ladder",
    "rebalance_state",
]

CHAIN_AXIS = "chains"
REPLICA_AXIS = "replicas"


def _launcher_hint(n: int) -> str:
    return (f"start one process per rank, e.g. `torchrun --nproc-per-node {n} "
            f"-m repro_torch run SPEC.json ...`, or initialize a "
            f"torch.distributed process group of {n} ranks before building the engine")


@contextlib.contextmanager
def launcher_group(device: str):
    """The process group a launcher (torchrun) describes in ``RANK`` /
    ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``, for the body of the
    ``with``: NCCL on cuda (the rank's card ``cuda:{LOCAL_RANK}``), gloo on
    cpu.  Yields whether this process writes results (rank 0).

    A group that was up already is left as it is.  A group brought up here
    is ended here: after a barrier when the body returns, so no rank leaves
    while another still talks to it, and at once when it raises (a barrier
    could wait forever on a rank inside a collective).  A process that
    exits with its group still up can abort in the group's destructor
    (``terminate called without an active exception``) while a peer is
    still running."""
    import torch.distributed as dist

    if dist.is_initialized():
        yield dist.get_rank() == 0
        return
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device == "cuda" else "gloo", init_method="env://")
    try:
        yield dist.get_rank() == 0
        dist.barrier()
    finally:
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Serializable (ensemble x replica) mesh shape (see `repro.core.
    distributed.MeshSpec`).  ``MeshSpec(1, 1)`` runs the sharded interval
    step on one rank, which is how one process holds the sharded path
    against the plain one bit for bit."""

    ensemble: int = 1
    replica: int = 1

    def __post_init__(self):
        if self.ensemble < 1 or self.replica < 1:
            raise ValueError(
                f"mesh axes must be >= 1, got ensemble={self.ensemble} "
                f"replica={self.replica}"
            )

    @property
    def n_devices(self) -> int:
        return self.ensemble * self.replica

    def validate(self, n_replicas: int, n_chains: int) -> None:
        """Check the run shape divides onto this mesh (fail at config time)."""
        if n_replicas % self.replica != 0:
            raise ValueError(
                f"n_replicas={n_replicas} does not divide over the "
                f"{self.replica}-way replica mesh axis"
            )
        if n_chains % self.ensemble != 0:
            raise ValueError(
                f"n_chains={n_chains} does not divide over the "
                f"{self.ensemble}-way ensemble mesh axis"
            )

    def build(self, device="cuda") -> "MeshLayout":
        """This rank's `MeshLayout` on the running process group.

        The group must be initialized with ``n_devices`` ranks (``torchrun``
        sets ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``; the CLI brings the
        group up from them).  With none and ``n_devices == 1``, a one-rank
        group is made here on an in-process store: gloo on the CPU, NCCL on
        CUDA.  ``device`` is ``"cpu"``, ``"cuda"`` (``cuda:{LOCAL_RANK}``,
        one card a rank) or an explicit ``"cuda:k"`` (ranks that share a
        card).  Both axes' subgroups are made on every rank, in one order.
        """
        import torch.distributed as dist

        dev = _rank_device(device)
        n = self.n_devices
        if not dist.is_available():
            raise RuntimeError("this torch build has no torch.distributed")
        if not dist.is_initialized():
            if n > 1:
                raise ValueError(
                    f"mesh {self.ensemble}x{self.replica} needs {n} ranks, but no "
                    f"torch.distributed process group is initialized; " + _launcher_hint(n)
                )
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                    store=dist.HashStore(), rank=0, world_size=1)
        world = dist.get_world_size()
        if world != n:
            raise ValueError(
                f"mesh {self.ensemble}x{self.replica} needs {n} ranks, the process "
                f"group has {world}; " + _launcher_hint(n)
            )
        backend = dist.get_backend()
        if backend == "nccl" and dev.type != "cuda":
            raise ValueError("an NCCL process group needs the engine on CUDA")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        rank = dist.get_rank()
        e, d = divmod(rank, self.replica)
        replica_group = ensemble_group = None
        for i in range(self.ensemble):
            g = _group([i * self.replica + k for k in range(self.replica)], world)
            if i == e:
                replica_group = g
        for k in range(self.replica):
            g = _group([i * self.replica + k for i in range(self.ensemble)], world)
            if k == d:
                ensemble_group = g
        return MeshLayout(spec=self, rank=rank, coords=(e, d), device=dev,
                          backend=backend, replica_group=replica_group,
                          ensemble_group=ensemble_group)


def _rank_device(device) -> torch.device:
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def _group(ranks: list[int], world: int):
    """The process group of ``ranks`` (the world group when it is all of
    them).  Every rank calls this for every group, in the same order."""
    import torch.distributed as dist

    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(ranks)


@dataclasses.dataclass
class MeshLayout:
    """One rank's place on a `MeshSpec`: coordinates ``(e, d)``, device,
    backend and the two subgroups (``replica_group``: the ranks of chain
    block ``e``, in slot-block order; ``ensemble_group``: those of slot
    block ``d``, in chain-block order).

    `gather_replicas` and `gather_chains` are the only collectives the
    engine issues.  On gloo, CUDA tensors are staged through host memory
    (the O(R) rows of an exchange; whole states only for checkpoints and
    results); NCCL gathers on the card.
    """

    spec: MeshSpec
    rank: int
    coords: tuple
    device: torch.device
    backend: str
    replica_group: object
    ensemble_group: object

    @property
    def is_writer(self) -> bool:
        """Rank 0 writes checkpoints and manifests."""
        return self.rank == 0

    def slot_block(self, n_replicas: int) -> tuple[int, int]:
        """``[start, stop)`` of this rank's slots in each chain."""
        r_local = n_replicas // self.spec.replica
        return self.coords[1] * r_local, (self.coords[1] + 1) * r_local

    def chain_block(self, n_chains: int) -> tuple[int, int]:
        """``[start, stop)`` of this rank's chains."""
        c_local = n_chains // self.spec.ensemble
        return self.coords[0] * c_local, (self.coords[0] + 1) * c_local

    def gather_replicas(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """All-gather ``x`` over the replica subgroup, blocks concatenated
        along ``dim`` in slot order."""
        return self._gather(x, self.replica_group, self.spec.replica, dim)

    def gather_chains(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """All-gather ``x`` over the ensemble subgroup, blocks concatenated
        along ``dim`` in chain order."""
        return self._gather(x, self.ensemble_group, self.spec.ensemble, dim)

    def _gather(self, x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
        import torch.distributed as dist

        x = x.contiguous()
        if self.backend == "nccl":
            out = torch.empty((size, *x.shape), dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(out, x, group=group)
            return torch.cat(out.unbind(0), dim=dim)
        host = x.cpu() if x.device.type != "cpu" else x
        parts = [torch.empty_like(host) for _ in range(size)]
        dist.all_gather(parts, host, group=group)
        return torch.cat(parts, dim=dim).to(x.device)


def _stacked(state) -> bool:
    """Whether an engine state carries the ensemble axis (keys ``(C, 2)``)."""
    return state.pt.key.dim() == 2


def local_block(state, mesh: MeshSpec, coords: tuple):
    """The block of a whole engine state that rank ``coords = (e, d)`` holds
    (the placement contract in the module docstring); every block tensor
    is a copy, so the whole state can be freed."""
    from repro_torch.engine.stats import map_leaves

    e, d = coords
    stacked = _stacked(state)
    r = state.pt.energy.shape[-1]
    r_local = r // mesh.replica
    slots = slice(d * r_local, (d + 1) * r_local)
    if stacked:
        c_local = state.pt.key.shape[0] // mesh.ensemble
        chains = slice(e * c_local, (e + 1) * c_local)

        def rep(x):
            return x[chains, slots].clone()

        def chain(x):
            return x[chains].clone()
    else:
        def rep(x):
            return x[slots].clone()

        def chain(x):
            return x

    pt = state.pt
    pt = PTState(states=map_states(pt.states, rep), energy=rep(pt.energy), rung=rep(pt.rung),
                 key=chain(pt.key), phase=chain(pt.phase), t=chain(pt.t))
    return dataclasses.replace(state, pt=pt, stats=map_leaves(state.stats, chain))


def gather_state(state, layout: MeshLayout):
    """The whole engine state from every rank's block (`local_block`
    undone), on every rank: for checkpoints and results only."""
    from repro_torch.engine.stats import map_leaves

    stacked = _stacked(state)
    if stacked:
        def rep(x):
            return layout.gather_chains(layout.gather_replicas(x, dim=1))

        chain = layout.gather_chains
    else:
        def rep(x):
            return layout.gather_replicas(x, dim=0)

        def chain(x):
            return x

    pt = state.pt
    pt = PTState(states=map_states(pt.states, rep), energy=rep(pt.energy), rung=rep(pt.rung),
                 key=chain(pt.key), phase=chain(pt.phase), t=chain(pt.t))
    return dataclasses.replace(state, pt=pt, stats=map_leaves(state.stats, chain))


def rebalance_ladder(temps, new_r: int) -> np.ndarray:
    """Resample a ladder to ``new_r`` rungs, endpoints kept (geometric
    interpolation in log T); f32 as the JAX twin returns it."""
    temps = np.asarray(temps, dtype=np.float64)
    x_old = np.linspace(0.0, 1.0, len(temps))
    x_new = np.linspace(0.0, 1.0, new_r)
    return np.exp(np.interp(x_new, x_old, np.log(temps))).astype(np.float32)


def rebalance_state(state: PTState, new_r: int) -> PTState:
    """Grow or shrink one chain's replica population to ``new_r``.

    Growing tiles the existing replicas (slot k copies slot ``k % R``; each
    slot draws its own stream from then on); shrinking keeps an
    endpoint-preserving subsample in rung order.  Rungs become the identity;
    pair it with `rebalance_ladder`.
    """
    r_old = state.energy.shape[0]
    if new_r == r_old:
        return state
    dev = state.energy.device
    if new_r > r_old:
        sel = torch.arange(new_r, device=dev) % r_old
    else:
        pick = np.unique(np.round(np.linspace(0, r_old - 1, new_r)).astype(np.int64))
        while len(pick) < new_r:  # guard duplicates on tiny ladders
            extra = np.setdiff1d(np.arange(r_old), pick)[: new_r - len(pick)]
            pick = np.sort(np.concatenate([pick, extra]))
        inv = torch.empty(r_old, dtype=torch.int64, device=dev)
        inv[state.rung.long()] = torch.arange(r_old, device=dev)
        sel = inv[torch.from_numpy(pick).to(dev)]
    return dataclasses.replace(
        state,
        states=map_states(state.states, lambda x: torch.index_select(x, 0, sel)),
        energy=torch.index_select(state.energy, 0, sel),
        rung=torch.arange(new_r, dtype=torch.int32, device=dev),
    )
