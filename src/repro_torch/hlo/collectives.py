"""Collective bytes a rank moves (twin of `repro.hlo.collectives`), read
from a placed run's `repro_torch.launch.comm.CollectiveCounter` (a dry
run's `repro_torch.hlo.traffic.OpTally` is one) where JAX's package parses
the compiled HLO: one counting rule for a dry run on ``meta`` tensors over
a fake process group and a real run on a group of ranks.

``payload_bytes`` sums each collective's input bytes a rank (JAX's operand
bytes); ``wire_bytes`` the bytes a rank sends under the ring algorithms of
`repro_torch.launch.comm.ring_bytes`: (g - 1) x the input for an
all-gather, (g - 1) / g of it for a reduce-scatter or an all-to-all,
2 (g - 1) / g for an all-reduce.  (JAX's model charges an all-gather
(g - 1) / g of its shard instead.)  ``by_op`` holds the payload by JAX's
HLO op names, ``by_axis`` the wire bytes by mesh axis and ``by_phase`` by
``phase/op/axis``.
"""
from __future__ import annotations

import collections
import dataclasses

__all__ = ["HLO_NAMES", "CollectiveStats", "collective_stats"]

# the functional collective -> JAX's HLO name for it
HLO_NAMES = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
}


@dataclasses.dataclass
class CollectiveStats:
    payload_bytes: float  # sum of input bytes (a rank)
    wire_bytes: float  # ring-model bytes a rank sends
    by_op: dict  # HLO op name -> payload bytes
    count: int
    by_axis: dict  # mesh axis -> wire bytes
    by_phase: dict  # "phase/op/axis" -> wire bytes


def collective_stats(counter) -> CollectiveStats:
    """The `CollectiveStats` of what ``counter`` counted."""
    by_op: collections.Counter = collections.Counter()
    for name, n in counter.payload.items():
        by_op[HLO_NAMES.get(name, name)] += n
    by_axis: collections.Counter = collections.Counter()
    by_phase = {}
    for (phase, name, axis), n in sorted(counter.by_axis.items(), key=str):
        by_axis[str(axis)] += n
        by_phase[f"{phase}/{HLO_NAMES.get(name, name)}/{axis}"] = n
    return CollectiveStats(payload_bytes=float(sum(counter.payload.values())),
                           wire_bytes=float(counter.total()), by_op=dict(by_op),
                           count=int(sum(counter.calls.values())), by_axis=dict(by_axis),
                           by_phase=by_phase)
