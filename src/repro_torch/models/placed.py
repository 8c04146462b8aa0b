"""Placed execution: the ops of the models on tensors placed as DTensors.

A model whose parameters are DTensors (placed by
`repro_torch.launch.sharding` under JAX's partition rules) runs its ops
under DTensor's sharding rules, the torch twin of GSPMD.  This module
holds what those rules do not give: the context a placed model runs in
(`implicit`), a spec's placements and the redistribution to it
(``with_sharding_constraint``), and the ops DTensor has no rule for, each
placed explicitly on every rank's blocks: the vocab-sharded lookup
(`embed_rows`), the loss's gold logits (`pick_last`), a product with an
``out_dtype`` (`mm_local`) and a KV-cache write (`write_slot`); the
layout of the residual stream (`rows`, `residual`: the batch's, so every
sublayer starts from the same placements and DTensor's rules do not carry
a reduce-scatter's sequence split from one sublayer into the next); and
`dense_grad` for a ``local_map``'s inputs.  A spec is a
tuple with one entry a tensor dimension, as a JAX ``PartitionSpec`` holds
them: ``None``, a mesh axis name, or a tuple of names.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["BATCH_AXES", "MODEL_AXIS", "is_dtensor", "implicit", "placements", "redistribute",
           "replicate", "as_replicated", "rows", "residual", "dense_grad",
           "write_slot", "embed_rows", "pick_last", "mm_local"]

BATCH_AXES = ("pod", "data")  # logical batch/replica axes (present subset used)
MODEL_AXIS = "model"


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def implicit(*own, inputs=()):
    """DTensor's implicit replication while a placed model runs, so the
    plain tensors it makes inside (positions, masks, zero states, scalars)
    count as replicated; else a null context.  The model is placed where a
    tensor of ``own`` (its module, its parameter dicts) or of ``inputs`` is
    a DTensor.  ``inputs`` are the caller's (a batch, a decode state, a
    token): on a placed model each must be a DTensor already, placed by the
    caller (`repro_torch.launch.sharding.place` under ``batch_shardings`` /
    ``decode_state_shardings``), because a plain one would count as
    replicated whatever each rank holds.  Raises ValueError naming it."""
    if not any(_placed(t) for t in (*own, inputs)):
        return contextlib.nullcontext()
    plain = [path for path, x in _tensors(inputs) if not is_dtensor(x)]
    if plain:
        raise ValueError(f"a placed model takes its inputs placed; plain tensors at {plain}: "
                         "place them with repro_torch.launch.sharding.place under "
                         "batch_shardings / decode_state_shardings")
    return _implicit_replication()


def _placed(tree) -> bool:
    if isinstance(tree, torch.nn.Module):
        return any(is_dtensor(p) for p in tree.parameters())
    return any(is_dtensor(x) for _, x in _tensors(tree))


def _tensors(tree, path: str = ""):
    """(path, tensor) of every tensor in dicts / lists / tuples of tensors."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{path}[{i}]")
    elif isinstance(tree, torch.Tensor):
        yield path or "the input", tree


@contextlib.contextmanager
def _implicit_replication():
    """DTensor's ``implicit_replication``, restoring the setting it found
    (the library's context manager clears it on exit, so a nested one would
    end it for the caller's backward pass)."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def placements(spec: tuple, names: tuple, sizes: dict) -> list:
    """A spec as DTensor placements on a mesh of axis ``names`` and ``sizes``
    (name -> size), one a mesh dimension: ``Shard(d)`` where tensor dim d
    names the axis, else ``Replicate()``.  A dim over
    several axes must name them in the mesh's order (major first, as JAX
    splits it).  An axis of size 1 places as ``Replicate()`` (the same
    layout; DTensor's view rules refuse a size-1 dim sharded over it)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis order {names}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return out


def redistribute(x, spec: tuple):
    """``with_sharding_constraint``: the DTensor ``x`` under ``spec`` on its mesh."""
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    return _to(x, placements(spec, names, dict(zip(names, mesh.shape))))


def replicate(x):
    """The DTensor ``x`` replicated on every rank of its mesh (an all-gather
    of its blocks, or the all-reduce of a partial sum)."""
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def as_replicated(x: torch.Tensor, mesh):
    """A plain tensor that every rank of ``mesh`` holds equal, as a
    replicated DTensor (no communication)."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def rows(x, like):
    """``with_sharding_constraint`` of an activation (B, S, ...) to the
    layout of ``like`` (the caller's placed tokens, frames or image): each
    mesh dim that splits ``like``'s batch (dim 0) or sequence (dim 1)
    splits ``x``'s the same way, every other mesh dim holds ``x`` whole (a
    partial sum is all-reduced).  ``x`` itself where it is no DTensor."""
    if not is_dtensor(x):
        return x
    return _to(x, _row_placements(x, like))


def residual(x, o):
    """``x + o`` for a layer's residual stream ``x`` and a sublayer's output
    ``o``: a placed ``o`` (a partial sum after a row-split product) is
    brought to ``x``'s layout first (`rows`), so the stream keeps one layout
    through the layer (DTensor's rule for the sum of a replicated and a
    partial tensor would carry the partial sum into the next norm)."""
    return x + rows(o, x)


def _row_placements(x, like) -> list:
    from torch.distributed.tensor import Replicate, Shard

    if not is_dtensor(like):
        return [Replicate()] * x.device_mesh.ndim
    return [p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate()
            for p in like.placements]


class _DenseGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient.  An op
    run through ``local_map`` returns its inputs' gradients as its backward
    made them, transposed maybe; DTensor takes the layout of a gradient
    from its global strides, and its ``view`` of a transposed block fails
    (torch 2.11-2.13: the backward of the K projection feeding a
    cross-attention)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def dense_grad(x):
    """``x``, its gradient made contiguous in the backward pass (`_DenseGrad`)."""
    return _DenseGrad.apply(x) if x.requires_grad else x


def _to(x, placements_: list):
    """``x`` redistributed to ``placements_``, or ``x`` itself where it has
    them: a redistribution's backward returns the gradient in ``x``'s own
    placements, so a needless one would all-reduce a partial gradient."""
    if tuple(x.placements) == tuple(placements_):
        return x
    return x.redistribute(x.device_mesh, placements_)


def _block(mesh, placements_, dim: int, size: int) -> tuple[int, int]:
    """(offset, length) of this rank's block of a dim of ``size`` split
    evenly over the mesh dims that shard it (major first)."""
    from torch.distributed.tensor import Shard

    offset, length = 0, size
    for i, p in enumerate(placements_):
        if isinstance(p, Shard) and p.dim == dim:
            length //= mesh.size(i)
            offset = offset + mesh.get_local_rank(i) * length
    return offset, length


def write_slot(cache, value, slot) -> None:
    """``cache[:, :, slot] = value`` in place on a KV cache DTensor (B, KV,
    S, hd) whose S may be sharded: ``value`` (B, KV, hd) is laid out as the
    cache's other dims, and the rank that holds position ``slot`` writes it
    into its block (an int slot: one row; a 0-d tensor slot: a select over
    the rank's block, no host sync).  A write through DTensor indexing would
    land in a redistributed copy."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = cache.device_mesh
    for p in cache.placements:
        if not isinstance(p, (Shard, Replicate)):
            raise ValueError(f"a KV cache placed as {cache.placements} cannot take a write")
    value_pl = [Shard(p.dim - (p.dim > 2)) if isinstance(p, Shard) and p.dim != 2
                else Replicate() for p in cache.placements]
    v = value.redistribute(mesh, value_pl).to_local() if is_dtensor(value) else value
    local = cache.to_local()
    offset, length = _block(mesh, cache.placements, 2, cache.shape[2])
    v = v.to(local.dtype)
    if isinstance(slot, torch.Tensor):
        hit = torch.arange(offset, offset + length, device=local.device) == slot
        local.copy_(torch.where(hit[:, None], v[:, :, None], local))
    elif offset <= slot < offset + length:
        local[:, :, slot - offset] = v


def embed_rows(table, tokens):
    """``table[tokens]`` for a (V, D) table DTensor: each rank looks up the
    tokens in its vocab block (zero rows elsewhere), a partial sum over the
    mesh dims that shard the vocab.  DTensor's own rule for the lookup
    fails on the reduce-scatter of that partial sum, in the backward pass."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    if not is_dtensor(tokens):
        tokens = as_replicated(tokens, mesh)
    t_pl, k_pl, out, t_grad = [], [], [], []
    for pt, pk in zip(table.placements, tokens.placements, strict=True):
        rk = pk if isinstance(pk, Shard) else Replicate()
        rt = pt if isinstance(pt, Shard) and not isinstance(rk, Shard) else Replicate()
        t_pl.append(rt)
        k_pl.append(rk)
        if rt == Shard(0):
            out.append(Partial())
        elif rt == Shard(1):
            out.append(Shard(tokens.ndim))
        else:
            out.append(rk)
        t_grad.append(Partial() if isinstance(rk, Shard) else rt)
    vocab = table.shape[0]
    offset, length = _block(mesh, t_pl, 0, vocab)

    def rows(tab, tok):
        hit = (tok >= offset) & (tok < offset + length)
        got = tab[torch.where(hit, tok - offset, 0)]
        return torch.where(hit[..., None], got, 0.0)

    table = _to(table, t_pl)
    tokens = _to(tokens, k_pl)
    return local_map(rows, out_placements=(tuple(out),), in_placements=(tuple(t_pl), tuple(k_pl)),
                     in_grad_placements=(tuple(t_grad), tuple(k_pl)), device_mesh=mesh)(
        table, tokens)


def pick_last(x, index):
    """``torch.gather(x, -1, index[..., None])[..., 0]`` for a DTensor ``x``
    (..., V) whose V may be sharded: each rank picks the indices in its V
    block (zero elsewhere), a partial sum over the mesh dims that shard V.
    (DTensor's own rule for the gather fails as `embed_rows` says.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    last = x.ndim - 1
    if not is_dtensor(index):
        index = as_replicated(index, mesh)
    x_pl, i_pl, out, x_grad = [], [], [], []
    for px, pi in zip(x.placements, index.placements, strict=True):
        if isinstance(px, Shard) and px.dim == last:
            x_pl.append(px)
            i_pl.append(Replicate())
            out.append(Partial())
        elif isinstance(px, Shard):
            x_pl.append(px)
            i_pl.append(px)
            out.append(px)
        else:
            x_pl.append(Replicate())
            i_pl.append(Replicate())
            out.append(Replicate())
        x_grad.append(x_pl[-1])
    offset, length = _block(mesh, x_pl, last, x.shape[last])

    def pick(v, i):
        hit = (i >= offset) & (i < offset + length)
        got = torch.gather(v, -1, torch.where(hit, i - offset, 0)[..., None])[..., 0]
        return torch.where(hit, got, 0.0)

    x = _to(x, x_pl)
    index = _to(index, i_pl)
    return local_map(pick, out_placements=(tuple(out),), in_placements=(tuple(x_pl), tuple(i_pl)),
                     in_grad_placements=(tuple(x_grad), tuple(i_pl)), device_mesh=mesh)(x, index)


def mm_local(fn, a, b):
    """``fn(a, b)`` (a matrix product, (M, K) x (K, N)) on each rank's
    blocks, for a product DTensor has no rule for (``torch.mm`` with an
    ``out_dtype``).  The contracted dim is replicated first (an explicit
    all-gather where it was sharded); M keeps ``a``'s sharding and N
    ``b``'s, where they do not share a mesh dim."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = a.device_mesh if is_dtensor(a) else b.device_mesh
    if not is_dtensor(a):
        a = as_replicated(a, mesh)
    if not is_dtensor(b):
        b = as_replicated(b, mesh)
    a_pl, b_pl, out, a_grad, b_grad = [], [], [], [], []
    for pa, pb in zip(a.placements, b.placements, strict=True):
        ra = pa if pa == Shard(0) else Replicate()
        rb = pb if pb == Shard(1) and ra != Shard(0) else Replicate()
        a_pl.append(ra)
        b_pl.append(rb)
        out.append(ra if ra == Shard(0) else rb)
        # a rank's gradient of an operand replicated on a mesh dim that
        # shards the other operand's free dim is a partial sum
        a_grad.append(Partial() if rb == Shard(1) else ra)
        b_grad.append(Partial() if ra == Shard(0) else rb)
    a = _to(a, a_pl)
    b = _to(b, b_pl)
    return local_map(fn, out_placements=(tuple(out),), in_placements=(tuple(a_pl), tuple(b_pl)),
                     in_grad_placements=(tuple(a_grad), tuple(b_grad)),
                     device_mesh=mesh)(a, b)
