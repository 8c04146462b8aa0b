"""Device-side online statistics (twin of `repro.engine.stats`, one chain).

Per-rung Welford moments of the energy and every observable, per-rung swap
attempt/accept counters at the lower rung of each pair, and round-trip flow
labels per slot.  Updates run on the device inside the interval loop;
`summarize` is host-side numpy.  The estimator-weight channel (VMPT) is not
ported.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

__all__ = ["OnlineStats", "init_stats", "update_stats", "summarize"]


@dataclasses.dataclass
class OnlineStats:
    """O(R) accumulators; ``mean``/``m2`` are keyed by series name."""

    n_records: torch.Tensor  # () int32
    weight_sum: torch.Tensor  # (R,) f32
    mean: dict
    m2: dict
    swap_attempts: torch.Tensor  # (R,) f32
    swap_accepts: torch.Tensor  # (R,) f32
    direction: torch.Tensor  # (R,) int8 per slot: +1 up, -1 down, 0 unlabelled
    round_trips: torch.Tensor  # (R,) int32 per slot
    up_visits: torch.Tensor  # (R,) f32
    labeled_visits: torch.Tensor  # (R,) f32


def init_stats(n_replicas: int, names: Sequence[str], device) -> OnlineStats:
    """Zeroed accumulators on ``device``."""
    f = lambda: torch.zeros(n_replicas, dtype=torch.float32, device=device)
    return OnlineStats(
        n_records=torch.zeros((), dtype=torch.int32, device=device),
        weight_sum=f(),
        mean={k: f() for k in names},
        m2={k: f() for k in names},
        swap_attempts=f(),
        swap_accepts=f(),
        direction=torch.zeros(n_replicas, dtype=torch.int8, device=device),
        round_trips=torch.zeros(n_replicas, dtype=torch.int32, device=device),
        up_visits=f(),
        labeled_visits=f(),
    )


def update_stats(stats: OnlineStats, rec: dict, rung: torch.Tensor) -> OnlineStats:
    """Fold one interval record into the accumulators (device-side).

    ``rec`` holds the per-rung series named in ``stats.mean`` plus
    ``swap_accept``/``swap_attempt``; ``rung`` is the post-interval slot→rung
    map.  Same op sequence as the JAX twin's unweighted path.
    """
    n = stats.n_records + 1
    cnt = n.to(torch.float32)
    mean, m2 = {}, {}
    for k in stats.mean:
        x = rec[k].to(torch.float32)
        d = x - stats.mean[k]
        m = stats.mean[k] + d / cnt
        mean[k] = m
        m2[k] = stats.m2[k] + d * (x - m)
    r = stats.direction.shape[-1]
    at_bottom = rung == 0
    at_top = rung == r - 1
    completed = at_bottom & (stats.direction == -1)
    up_lbl = torch.ones((), dtype=torch.int8, device=rung.device)
    direction = torch.where(
        at_bottom, up_lbl, torch.where(at_top, -up_lbl, stats.direction)
    )
    up = (direction == 1).to(torch.float32)
    labeled = (direction != 0).to(torch.float32)
    ridx = rung.long()
    return OnlineStats(
        n_records=n,
        weight_sum=stats.weight_sum + 1.0,
        mean=mean,
        m2=m2,
        swap_attempts=stats.swap_attempts + rec["swap_attempt"].to(torch.float32),
        swap_accepts=stats.swap_accepts + rec["swap_accept"].to(torch.float32),
        direction=direction,
        round_trips=stats.round_trips + completed.to(torch.int32),
        up_visits=stats.up_visits.index_add(0, ridx, up),
        labeled_visits=stats.labeled_visits.index_add(0, ridx, labeled),
    )


def summarize(stats: OnlineStats) -> dict[str, np.ndarray]:
    """Host-side summary in the JAX twin's keys and conventions."""
    f64 = lambda x: x.detach().cpu().numpy().astype(np.float64)
    out: dict[str, np.ndarray] = {"n_records": f64(stats.n_records)}
    wsum = f64(stats.weight_sum)
    denom = np.where(wsum > 1.0, wsum - 1.0, 1.0)
    for k in stats.mean:
        out[f"mean_{k}"] = f64(stats.mean[k])
        out[f"var_{k}"] = f64(stats.m2[k]) / denom
    att, acc = f64(stats.swap_attempts)[:-1], f64(stats.swap_accepts)[:-1]
    out["swap_attempts"] = att
    out["swap_acceptance"] = np.where(att > 0, acc / np.maximum(att, 1.0), 0.0)
    out["round_trips"] = stats.round_trips.cpu().numpy().astype(np.int64)
    up, labeled = f64(stats.up_visits), f64(stats.labeled_visits)
    out["flow_up"] = np.where(labeled > 0, up / np.maximum(labeled, 1.0), 0.0)
    return out
