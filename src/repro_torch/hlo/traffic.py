"""HBM traffic: the analytic sweep-kernel model and the unfused byte count
of a dry run (twin of `repro.hlo.traffic`).

`hbm_bytes_per_cell_sweep` is JAX's arithmetic, unchanged: the modeled
HBM bytes a lattice cell and sweep of the per-sweep and fused paths.

`OpTally` is the dry run's counter, where JAX's package walks the compiled
HLO: a `repro_torch.launch.comm.CollectiveCounter` (so the collectives are
counted by the rule a real run counts them with) that also counts, for
every aten op a rank runs on plain tensors (a DTensor's local blocks
included, and the ops DTensor issues to redistribute them):

* ``unfused_bytes``: each tensor argument's bytes read and each output's
  written, views and allocations free.  No op is fused with another, so
  this is the twin of XLA's pre-fusion ``bytes accessed``: an upper bound
  of the HBM traffic;
* ``flops``: the products' (`torch.utils.flop_counter`'s formulas: mm,
  bmm, addmm, convolutions, attention) and one an output element for a
  pointwise op; reductions, copies and indexing count none;
* ``kernels``: what each hand-written kernel's entry point reports when it
  is called on ``meta`` tensors (`repro_torch.kernels.build.count_meta`):
  its flops, 32-bit integer instructions and bytes by the kernels' bound
  formulas, added to ``flops`` and ``unfused_bytes`` too.
"""
from __future__ import annotations

import collections

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.launch.comm import CollectiveCounter

__all__ = ["hbm_bytes_per_cell_sweep", "OpTally"]


def hbm_bytes_per_cell_sweep(
    *,
    fused: bool,
    sweeps_per_interval: int = 1,
    rounds_per_launch: int = 1,
    state_bytes: float = 2.0,
    uniform_plane_bytes: float = 8.0,
) -> float:
    """Modeled HBM bytes per lattice cell per sweep (O(R) scalars excluded).

    Per-sweep path: ``state_bytes`` (int8 state in + out) **plus the
    uniforms stream** — ``uniform_plane_bytes`` written per cell by the
    external generator and the same read back by the kernel.  Fused path:
    the state block crosses HBM once each way per *launch*
    (``state_bytes`` amortized over ``sweeps_per_interval`` sweeps per PT
    round × ``rounds_per_launch`` rounds — the whole-round kernels fold the
    exchange in, so a multi-round launch never touches HBM between rounds);
    the randoms come from the in-kernel counter PRNG and never exist in HBM.

    Defaults model the Ising kernel (one f32 uniform per cell per colour =
    8 B/cell/sweep each way -> 18 B/cell/sweep unfused); Potts passes
    ``uniform_plane_bytes=16.0`` (proposal + acceptance planes -> 34).
    """
    if not fused:
        return state_bytes + 2.0 * uniform_plane_bytes
    if sweeps_per_interval < 1:
        raise ValueError("sweeps_per_interval must be >= 1")
    if rounds_per_launch < 1:
        raise ValueError("rounds_per_launch must be >= 1")
    return state_bytes / (sweeps_per_interval * rounds_per_launch)


def _free(func) -> bool:
    """An op that moves no data of its own: a view, an allocation, a detach."""
    name = func.__name__.split(".")[0]
    return func.is_view or name.startswith(("empty", "new_empty")) or name in (
        "detach", "alias", "lift_fresh", "_to_copy_meta", "set_", "resize_")


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class OpTally(CollectiveCounter):
    """Under ``with``: the collectives (`CollectiveCounter`), and the flops
    and unfused bytes of every other op and of the kernels' ``meta`` calls
    (module docstring)."""

    def __init__(self, mesh=None):
        super().__init__(mesh)
        from torch.utils.flop_counter import flop_registry

        self._formulas = flop_registry
        self.flops = 0.0
        self.unfused_bytes = 0.0
        self.kernels: dict = collections.defaultdict(collections.Counter)

    def __enter__(self):
        from repro_torch.kernels import build

        build.meta_sinks.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import build

        build.meta_sinks.remove(self._kernel)
        return super().__exit__(*exc)

    def _kernel(self, kernel: str, *, flops: float, int_ops: float, n_bytes: float) -> None:
        k = self.kernels[kernel]
        k["calls"] += 1
        k["flops"] += flops
        k["int_ops"] += int_ops
        k["bytes"] += n_bytes
        self._add(flops, n_bytes)

    def _add(self, flops: float, n_bytes: float) -> None:
        self.flops += flops
        self.unfused_bytes += n_bytes

    def local_op(self, func, args, kwargs):
        from torch._subclasses.fake_tensor import FakeTensor

        out = func(*args, **kwargs)
        if _free(func):
            return out
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out  # DTensor's sharding propagation on fake tensors: no rank's work
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            flops = float(formula(*args, **kwargs, out_val=out))
        elif torch.Tag.pointwise in func.tags:
            flops = float(sum(t.numel() for t in outs))
        else:
            flops = 0.0
        self._add(flops, _bytes(ins) + _bytes(outs))
        return out
