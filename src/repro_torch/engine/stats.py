"""Device-side online statistics (twin of `repro.engine.stats`).

Per-rung Welford moments of the energy and every observable, per-rung swap
attempt/accept counters at the lower rung of each pair, and round-trip flow
labels per slot.  Leaves are ``(R,)`` for one chain and ``(C, R)`` with the
ensemble axis; `update_stats` folds one chain's record, or C chains' at
once (the engine's chain-axis paths), `chain_slice` / `chain_block` carve chains back out and
`combine_chains` pools them.  Updates run on the device inside the interval
loop; `summarize` and `combine_chains` are host-side numpy.  A record that
carries ``est_weight`` (``(V, R)``, its series stacked ``(V, R)``: VMPT's
waste recycling) updates the moments by West's weighted Welford, one
virtual outcome at a time, in the JAX twin's op order.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "OnlineStats",
    "init_stats",
    "update_stats",
    "summarize",
    "combine_chains",
    "chain_slice",
    "chain_block",
    "map_leaves",
    "stack_leaves",
]


@dataclasses.dataclass
class OnlineStats:
    """O(R) accumulators (``(C, R)`` with an ensemble); ``mean``/``m2`` are
    keyed by series name."""

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


def init_stats(n_replicas: int, names: Sequence[str], device,
               n_chains: int = 0) -> OnlineStats:
    """Zeroed accumulators on ``device``; ``n_chains=0`` means no ensemble axis."""
    shape = (n_replicas,) if n_chains == 0 else (n_chains, n_replicas)
    scalar = () if n_chains == 0 else (n_chains,)
    f = lambda: torch.zeros(shape, dtype=torch.float32, device=device)
    return OnlineStats(
        n_records=torch.zeros(scalar, dtype=torch.int32, device=device),
        weight_sum=f(),
        mean={k: f() for k in names},
        m2={k: f() for k in names},
        swap_attempts=f(),
        swap_accepts=f(),
        direction=torch.zeros(shape, dtype=torch.int8, device=device),
        round_trips=torch.zeros(shape, dtype=torch.int32, device=device),
        up_visits=f(),
        labeled_visits=f(),
    )


def update_stats(stats: OnlineStats, rec: dict, rung: torch.Tensor) -> OnlineStats:
    """Fold one chain's interval record into its ``(R,)`` accumulators
    (device-side), or C chains' ``(C, R)`` records into ``(C, R)`` ones.

    ``rec`` holds the per-rung series named in ``stats.mean`` plus
    ``swap_accept``/``swap_attempt`` (and optionally ``est_weight``, one
    chain only); ``rung`` is the post-interval slot→rung map.  Same op
    sequence as the JAX twin; every op is elementwise or adds one value to
    each accumulator entry (``rung`` is a permutation), so a chain's leaves
    are those of its solo update bit for bit.
    """
    n = stats.n_records + 1
    mean, m2 = {}, {}
    w_rec = rec.get("est_weight")
    if w_rec is None:
        cnt = n.to(torch.float32)
        if cnt.dim():
            cnt = cnt[:, None]  # one count a chain
        for k in stats.mean:
            x = rec[k].to(torch.float32)
            d = x - stats.mean[k]
            m = stats.mean[k] + d / cnt
            mean[k] = m
            m2[k] = stats.m2[k] + d * (x - m)
        weight_sum = stats.weight_sum + 1.0
    else:
        # a zero weight (an unpaired rung) leaves the accumulators untouched
        for k in stats.mean:
            m_k, m2_k = stats.mean[k], stats.m2[k]
            w_run = stats.weight_sum
            for v in range(w_rec.shape[0]):
                w = w_rec[v].to(torch.float32)
                x = rec[k][v].to(torch.float32)
                w_new = w_run + w
                d = x - m_k
                frac = torch.where(w_new > 0, w / torch.clamp_min(w_new, 1e-30), 0.0)
                m_k = m_k + d * frac
                m2_k = m2_k + w * d * (x - m_k)
                w_run = w_new
            mean[k], m2[k] = m_k, m2_k
        weight_sum = stats.weight_sum + w_rec.sum(dim=0).to(torch.float32)
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
    if ridx.dim() == 1:
        visit = lambda acc, x: acc.index_add(0, ridx, x)  # noqa: E731
    else:
        visit = lambda acc, x: acc.scatter_add(1, ridx, x)  # noqa: E731
    return OnlineStats(
        n_records=n,
        weight_sum=weight_sum,
        mean=mean,
        m2=m2,
        swap_attempts=stats.swap_attempts + rec["swap_attempt"].to(torch.float32),
        swap_accepts=stats.swap_accepts + rec["swap_accept"].to(torch.float32),
        direction=direction,
        round_trips=stats.round_trips + completed.to(torch.int32),
        up_visits=visit(stats.up_visits, up),
        labeled_visits=visit(stats.labeled_visits, labeled),
    )


# -- ensemble slices -------------------------------------------------------


def map_leaves(obj, fn):
    """A dataclass of tensors (or dicts of tensors) with ``fn`` applied to
    every tensor: the pytree map the engine needs for `OnlineStats` and
    ``PTState``."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        kw[f.name] = {k: fn(x) for k, x in v.items()} if isinstance(v, dict) else fn(v)
    return type(obj)(**kw)


def stack_leaves(objs):
    """One dataclass whose every tensor stacks the ``objs``' along a new
    leading (chain) axis; inverse of `chain_slice` over all chains."""
    first = objs[0]
    kw = {}
    for f in dataclasses.fields(first):
        v = getattr(first, f.name)
        if isinstance(v, dict):
            kw[f.name] = {k: torch.stack([getattr(o, f.name)[k] for o in objs])
                          for k in v}
        else:
            kw[f.name] = torch.stack([getattr(o, f.name) for o in objs])
    return type(first)(**kw)


def chain_slice(stats, index: int):
    """Chain ``index`` of an ensemble accumulator, as un-batched ``(R,)``
    leaves: the shape a solo ``n_chains=1`` run carries."""
    return map_leaves(stats, lambda x: x[index])


def chain_block(stats, start: int, stop: int):
    """Chains ``[start, stop)`` of an ensemble accumulator, keeping the
    ensemble axis: the shape a solo ``n_chains=stop-start`` run carries."""
    return map_leaves(stats, lambda x: x[start:stop])


# -- host-side summaries ---------------------------------------------------


def _f64(x) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float64)


def _assemble(n, wsum, means, m2s, attempts, accepts, round_trips, up, labeled):
    """Shared summary assembly for the per-chain and chain-pooled views."""
    out: dict[str, np.ndarray] = {"n_records": n}
    denom = np.where(wsum > 1.0, wsum - 1.0, 1.0)
    for k in means:
        out[f"mean_{k}"] = means[k]
        out[f"var_{k}"] = m2s[k] / denom
    att, acc = attempts[..., :-1], accepts[..., :-1]
    out["swap_attempts"] = att
    out["swap_acceptance"] = np.where(att > 0, acc / np.maximum(att, 1.0), 0.0)
    out["round_trips"] = round_trips
    out["flow_up"] = np.where(labeled > 0, up / np.maximum(labeled, 1.0), 0.0)
    return out


def summarize(stats: OnlineStats) -> dict[str, np.ndarray]:
    """Host-side summary in the JAX twin's keys and conventions (per chain
    for ``(C, R)`` leaves)."""
    return _assemble(
        _f64(stats.n_records),
        _f64(stats.weight_sum),
        {k: _f64(v) for k, v in stats.mean.items()},
        {k: _f64(v) for k, v in stats.m2.items()},
        _f64(stats.swap_attempts),
        _f64(stats.swap_accepts),
        stats.round_trips.cpu().numpy().astype(np.int64),
        _f64(stats.up_visits),
        _f64(stats.labeled_visits),
    )


def combine_chains(stats: OnlineStats) -> dict[str, np.ndarray]:
    """Merge the ensemble axis into one grand summary (host-side).

    Welford states merge by Chan's parallel algorithm: counts add, means
    combine weighted by each chain's per-rung weight, and ``m2`` gains the
    between-chain spread term; swap and round-trip counters sum.
    """
    n_c = _f64(stats.n_records)
    if n_c.ndim == 0:
        return summarize(stats)
    ws_c = _f64(stats.weight_sum)  # (C, R)
    ws = ws_c.sum(axis=0)
    w = np.divide(ws_c, ws, out=np.zeros_like(ws_c), where=ws > 0)
    means, m2s = {}, {}
    for k in stats.mean:
        cm = _f64(stats.mean[k])
        grand = (w * cm).sum(axis=0)
        means[k] = grand
        m2s[k] = _f64(stats.m2[k]).sum(axis=0) + (ws_c * (cm - grand) ** 2).sum(axis=0)
    return _assemble(
        np.asarray(n_c.sum()),
        ws,
        means,
        m2s,
        _f64(stats.swap_attempts).sum(axis=0),
        _f64(stats.swap_accepts).sum(axis=0),
        stats.round_trips.cpu().numpy().astype(np.int64).sum(axis=0),
        _f64(stats.up_visits).sum(axis=0),
        _f64(stats.labeled_visits).sum(axis=0),
    )
