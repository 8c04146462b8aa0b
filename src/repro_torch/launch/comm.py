"""Collective bytes a rank moves, by collective (the byte counter that the
LM placement layer's runs read, and the torch side of `repro.hlo.collectives`).

`CollectiveCounter` is a `TorchDispatchMode` over the functional
collectives (``torch.ops._c10d_functional``) that DTensor issues for every
redistribution: each call adds its count and the bytes this rank sends
under the ring algorithms (a rank receives as many):

  all_gather_into_tensor   (g - 1) * input bytes
  reduce_scatter_tensor    (g - 1) / g * input bytes
  all_reduce               2 (g - 1) / g * bytes
  all_to_all_single        (g - 1) / g * input bytes
  broadcast                bytes (counted at every rank)

with g the group's size.  DTensor's Shard -> Shard redistribution on a
mesh of device type ``cuda`` is its own op, ``_dtensor.shard_dim_alltoall``,
counted as ``all_to_all_single`` (on a ``cpu`` mesh DTensor runs it as an
all-gather and a chunk, and it is counted so).  ``payload[name]`` holds the
input bytes (the operand bytes of `repro_torch.hlo.collectives`).  `phase`
names the collectives of a region (the training step's ``cast``
all-gathers and ``grads`` reduce-scatters), so a run's counts can be held against the arithmetic from the specs.  A mode
sees the collectives of the backward pass too.
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["CollectiveCounter", "ring_bytes", "eager_collectives"]


_COLLECTIVES = ("all_gather_into_tensor", "all_gather_into_tensor_coalesced",
                "reduce_scatter_tensor", "reduce_scatter_tensor_coalesced", "all_to_all_single",
                "all_reduce", "all_reduce_coalesced", "broadcast")


# ops outside ``_c10d_functional`` that are collectives: name -> counted as
_OTHER = {("_dtensor", "shard_dim_alltoall"): "all_to_all_single"}


def ring_bytes(name: str, nbytes: int, group: int) -> int:
    """The bytes one rank sends for collective ``name`` of ``nbytes``
    (the input's) over ``group`` ranks."""
    if name in ("all_gather_into_tensor", "all_gather_into_tensor_coalesced"):
        return (group - 1) * nbytes
    if name in ("reduce_scatter_tensor", "reduce_scatter_tensor_coalesced",
                "all_to_all_single"):
        return (group - 1) * nbytes // group
    if name in ("all_reduce", "all_reduce_coalesced"):
        return 2 * (group - 1) * nbytes // group
    return nbytes


def _group_name(args, kwargs) -> str:
    return kwargs.get("group_name") or [a for a in args if isinstance(a, str)][-1]


def _group_size(name: str, args, kwargs) -> int:
    if name == "shard_dim_alltoall":
        return _resolve(args[3]).size()
    if name.startswith(("all_gather", "reduce_scatter")):
        return int(args[1] if name.startswith("all_gather") else args[2])
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(_group_name(args, kwargs)).size()


def _resolve(group):
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(group) if isinstance(group, str) else group


def _ranks(group) -> tuple:
    import torch.distributed as dist

    return tuple(sorted(dist.get_process_group_ranks(group)))


def _nbytes(x) -> int:
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return x.numel() * x.element_size()


class CollectiveCounter(TorchDispatchMode):
    """Counts, under ``with``, every functional collective: ``calls[name]``,
    ``bytes[name]`` (this rank's sent bytes), ``by_phase[(phase, name)]``
    and, given the ``mesh`` (a `DeviceMesh`), ``by_axis[(phase, name,
    axis)]`` with the mesh axis whose group ran it; ``seconds[(phase,
    name)]`` is the host's wall time in the calls (the whole collective
    where it completes on return, as the host-staged ones of
    `eager_collectives` do; an enqueue where it runs asynchronously)."""

    def __init__(self, mesh=None):
        super().__init__()
        self.calls: collections.Counter = collections.Counter()
        self.bytes: collections.Counter = collections.Counter()
        self.payload: collections.Counter = collections.Counter()
        self.by_phase: collections.Counter = collections.Counter()
        self.by_axis: collections.Counter = collections.Counter()
        self.seconds: collections.Counter = collections.Counter()
        self._axes, self._names = {}, {}
        if mesh is not None:  # a group is known by its ranks (names differ between handles)
            for i, axis in enumerate(mesh.mesh_dim_names):
                self._axes[_ranks(mesh.get_group(i))] = axis
        self._phase = None

    def _axis(self, group_name):
        if group_name not in self._names:
            self._names[group_name] = self._axes.get(_ranks(_resolve(group_name)))
        return self._names[group_name]

    @contextlib.contextmanager
    def phase(self, name: str):
        before, self._phase = self._phase, name
        try:
            yield
        finally:
            self._phase = before

    def total(self) -> int:
        return sum(self.bytes.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if any(t is DTensor for t in types):
            return NotImplemented  # let DTensor desugar to the collectives first
        op = func.__name__.split(".")[0]
        name = _OTHER.get((func.namespace, op), op)
        if name not in _COLLECTIVES or (func.namespace != "_c10d_functional"
                                        and (func.namespace, op) not in _OTHER):
            return self.local_op(func, args, kwargs or {})
        size = _nbytes(args[0])
        n = ring_bytes(name, size, _group_size(op, args, kwargs or {}))
        group = args[3] if op == "shard_dim_alltoall" else _group_name(args, kwargs or {})
        self.calls[name] += 1
        self.bytes[name] += n
        self.payload[name] += size
        self.by_phase[(self._phase, name)] += n
        self.by_axis[(self._phase, name, self._axis(group))] += n
        t = time.perf_counter()
        out = func(*args, **(kwargs or {}))
        self.seconds[(self._phase, name)] += time.perf_counter() - t
        return out

    def local_op(self, func, args, kwargs):
        """Any other op on plain tensors: run it (a subclass counts it)."""
        return func(*args, **kwargs)


_STAGED: dict = {}  # device type -> its torch.library registration, kept alive


def eager_collectives(device_type: str = "CUDA") -> None:
    """Run the functional collectives on ``device_type`` tensors through the
    process group's eager c10d collectives on host copies (ranks that share
    one card cannot use NCCL, and gloo collects host memory).

    DTensor issues ``_c10d_functional`` ops; with a gloo group their CUDA
    path crashes the process (torch 2.11: a segfault in the first
    ``all_gather_into_tensor``).  This registers, for the ``device_type``
    dispatch key, kernels that copy the input to the host, run the eager
    gloo collective there and copy the finished result back (``wait_tensor``
    then finds no pending work).  The collectives run and are counted as
    before (`CollectiveCounter` sees the functional op).  Call it once a
    process, after the group is up (the CPU tests register it for ``"CPU"``
    to hold it against gloo's functional collectives)."""
    if device_type in _STAGED:
        return
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    ops = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.AVG, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT}

    def host(x):
        return x.detach().to("cpu", memory_format=torch.contiguous_format)

    def all_gather(x, group_size, group_name):
        h = host(x)
        out = h.new_empty((h.shape[0] * group_size, *h.shape[1:]))
        dist.all_gather_into_tensor(out, h, group=_resolve_process_group(group_name))
        return out.to(x.device)

    def reduce_scatter(x, reduce_op, group_size, group_name):
        h = host(x)
        out = h.new_empty((h.shape[0] // group_size, *h.shape[1:]))
        dist.reduce_scatter_tensor(out, h, op=ops[reduce_op.lower()],
                                   group=_resolve_process_group(group_name))
        return out.to(x.device)

    def all_reduce(x, reduce_op, group_name):
        h = host(x).clone() if x.device.type == "cpu" else host(x)
        dist.all_reduce(h, op=ops[reduce_op.lower()], group=_resolve_process_group(group_name))
        return h.to(x.device)

    def all_reduce_(x, reduce_op, group_name):
        x.copy_(all_reduce(x, reduce_op, group_name))
        return x

    def all_to_all(x, output_split_sizes, input_split_sizes, group_name):
        # gather every rank's input, keep the parts sent here (even splits,
        # as DTensor's Shard -> Shard makes them)
        group = _resolve_process_group(group_name)
        n, me = group.size(), group.rank()
        if input_split_sizes and len(set(input_split_sizes)) > 1:
            raise ValueError(f"uneven all_to_all splits {input_split_sizes}")
        h = host(x)
        everyone = [torch.empty_like(h) for _ in range(n)]
        dist.all_gather(everyone, h, group=group)
        return torch.cat([part.chunk(n)[me] for part in everyone]).to(x.device)

    def shard_dim_alltoall(x, gather_dim, shard_dim, group_name):
        # DTensor's Shard(gather_dim) -> Shard(shard_dim) on a cuda mesh:
        # every rank's block gathered, this rank's part of shard_dim kept
        group = _resolve_process_group(group_name)
        n, me = group.size(), group.rank()
        h = host(x)
        everyone = [torch.empty_like(h) for _ in range(n)]
        dist.all_gather(everyone, h, group=group)
        whole = torch.cat(everyone, dim=gather_dim)
        return whole.chunk(n, dim=shard_dim)[me].contiguous().to(x.device)

    def broadcast(x, src, group_name):
        h = host(x).clone() if x.device.type == "cpu" else host(x)
        dist.broadcast(h, src=src, group=_resolve_process_group(group_name))
        return h.to(x.device)

    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name, fn in (("all_gather_into_tensor", all_gather),
                     ("reduce_scatter_tensor", reduce_scatter), ("all_reduce", all_reduce),
                     ("all_reduce_", all_reduce_), ("all_to_all_single", all_to_all),
                     ("broadcast", broadcast)):
        lib.impl(name, fn, device_type)
    dtensor_lib = torch.library.Library("_dtensor", "IMPL")
    dtensor_lib.impl("shard_dim_alltoall", shard_dim_alltoall, device_type)
    _STAGED[device_type] = (lib, dtensor_lib)
