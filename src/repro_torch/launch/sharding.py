"""Sharding policy: logical-rule partition specs with a divisibility
fallback (twin of `repro.launch.sharding`), and their placement as DTensors.

A spec is a tuple with one entry a tensor dimension, as a JAX
``PartitionSpec`` holds them: ``None`` (replicated), a mesh axis name, or a
tuple of names (the dimension split over several axes, major first).  The
rules are JAX's, keyed on the trailing component of a weight's path in
JAX's parameter tree (its role), then validated against the mesh: any
sharded dimension that does not divide by its mesh axes falls to the next
candidate, or to replication (Mixtral's 8 experts cannot take the 16-way
model axis, so its expert weights fall back from ``("model", None, None)``
to the intra-expert ``(None, None, "model")``).

The port holds its layers unstacked: each parameter's JAX path comes from
`repro_torch.models.jax_tree` (``layers.3.attn.wq`` is
``['groups']['0_attn']['attn']['wq']`` at index 3), and a leaf that JAX
stacks gets JAX's spec without its leading ``None``.  Decode states map
the same way (whisper's caches are JAX's ``['k']`` / ``['v']`` stacks; a
vlm cross layer holds no cache in the port).

DTensor is the torch twin of GSPMD: `place` distributes tensors under
their specs on a `DeviceMesh` (an in-sharding), `place_module` a model's
parameters, and `gather` returns the whole tensors.  A placed model runs
its ops through `repro_torch.models.placed` (``redistribute`` there is
``with_sharding_constraint``).
"""
from __future__ import annotations

import re

import torch

from repro_torch.launch.mesh import axis_names, axis_sizes, batch_axes
from repro_torch.models import jax_tree, placed
from repro_torch.models.transformer import plan

__all__ = ["param_shardings", "leaf_paths", "batch_shardings", "decode_state_shardings",
           "scalar_sharding", "placements", "place", "place_module", "gather", "spec_bytes"]

# rule: name -> list of candidate dim-spec tuples, first fitting one wins.
# 'M' is replaced by the model axis.
_RULES: dict[str, list[tuple]] = {
    # embeddings
    "embed": [("M", None)],
    "unembed": [(None, "M")],
    # attention
    "wq": [(None, "M", None), ("M", None, None)],
    "wk": [(None, "M", None), ("M", None, None)],
    "wv": [(None, "M", None), ("M", None, None)],
    "wo": [("M", None, None), (None, None, "M")],
    # dense ffn (2-D) and moe experts (3-D share the names)
    "w_gate": [(None, "M"), ("M", None, None), (None, None, "M")],
    "w_up": [(None, "M"), ("M", None, None), (None, None, "M")],
    "w_down": [("M", None), ("M", None, None), (None, "M", None)],
    "router": [(None, None)],
    # rglru
    "w_x": [(None, "M")],
    "w_gmlp": [(None, "M")],
    "conv_w": [(None, "M")],
    "w_r": [(None, "M")],
    "w_i": [(None, "M")],
    "w_out": [("M", None)],
    # rwkv time-mix
    "w_k": [(None, "M")],
    "w_v": [(None, "M"), ("M", None)],
    "w_g": [(None, "M")],
    "w_o": [("M", None)],
    "lora_a": [(None, None)],
    "lora_b": [(None, "M")],
}


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def _entry(axes: tuple):
    """One spec entry for ``axes``: None, the name, or the tuple (as
    ``PartitionSpec`` normalizes a one-name tuple to the name)."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def _fits(mesh, shape, spec) -> bool:
    for dim, axis in zip(shape, spec):
        if axis is not None and dim % _axis_size(mesh, axis) != 0:
            return False
    return True


def _leaf_spec(mesh, path: str, shape, fsdp: bool = False) -> tuple:
    """The spec of a leaf at JAX ``keystr`` ``path`` with JAX's ``shape``
    (stacked leaves included), as the JAX code picks it."""
    shape = tuple(shape)
    name = path.rstrip("]").split("'")[-2] if "'" in path else path.split(".")[-1]
    stacked = "groups" in path or re.search(r"\['(enc|dec)'\]", path) is not None
    base_shape = shape[1:] if stacked and len(shape) >= 2 else shape
    chosen = None
    for cand in _RULES.get(name, []):
        if len(cand) != len(base_shape):
            continue
        spec = tuple("model" if a == "M" else a for a in cand)
        if _fits(mesh, base_shape, spec):
            chosen = spec
            break
    if chosen is None:
        chosen = (None,) * len(base_shape)
    if fsdp:
        # ZeRO-3 style: also shard the largest unsharded dim over 'data'
        chosen = list(chosen)
        free = [i for i, a in enumerate(chosen) if a is None]
        free.sort(key=lambda i: -base_shape[i])
        for i in free:
            if base_shape[i] % _axis_size(mesh, "data") == 0:
                chosen[i] = "data"
                break
        chosen = tuple(chosen)
    if stacked and len(shape) >= 2:
        chosen = (None,) + chosen
    return chosen


def _named(tree) -> dict:
    if isinstance(tree, torch.nn.Module):
        return dict(tree.named_parameters())
    return dict(tree)


def leaf_paths(cfg, names) -> dict:
    """The port's parameter name -> (JAX ``keystr`` of the leaf, whether
    JAX stacks it)."""
    return {n: (key, layer is not None) for n, (key, layer)
            in jax_tree.tree_names("", names, jax_tree.jax_layer_paths(cfg)).items()}


def param_shardings(mesh, params, cfg, fsdp: bool = False) -> dict:
    """Name -> spec for a parameter (or optimizer-state) dict or module.

    ``fsdp=True`` also shards each weight's largest free dim over 'data'
    (the training layout of the f32 masters and AdamW's moments)."""
    params = _named(params)
    out = {}
    for name, (path, stacked) in leaf_paths(cfg, params).items():
        shape = tuple(params[name].shape)
        spec = _leaf_spec(mesh, path, (1,) + shape if stacked else shape, fsdp=fsdp)
        out[name] = spec[1:] if stacked else spec
    return out


def batch_shardings(mesh, batch, extra_axes: tuple = (), seq_axes: tuple = ()):
    """Batch inputs: leading axis over (pod, data) when divisible.

    ``extra_axes`` folds more mesh axes into the batch shard (("model",):
    hierarchical data parallelism); ``seq_axes`` shards dim 1 (context
    parallelism).  Leading axes are dropped until the batch divides.
    ``batch``: a dict (or one tensor) of anything with ``.shape``."""
    names = axis_names(mesh)
    ba = batch_axes(mesh) + tuple(a for a in extra_axes if a in names)
    ba = tuple(a for a in ba if a not in seq_axes)
    sa = tuple(a for a in seq_axes if a in names)

    def fn(leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return ()
        use = ba
        while use and shape[0] % _axis_size(mesh, use) != 0:
            use = use[1:]
        rest: list = [None] * (len(shape) - 1)
        if sa and len(shape) >= 2 and shape[1] % _axis_size(mesh, sa) == 0:
            rest[0] = sa if len(sa) > 1 else sa[0]
        return (_entry(use),) + tuple(rest)

    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    return fn(batch)


def _state_spec(mesh, key: str, shape) -> tuple:
    """JAX's decode-state rule for the leaf at ``key`` of JAX's ``shape``."""
    ba = _entry(batch_axes(mesh))
    msize = axis_sizes(mesh)["model"]
    bsize = _axis_size(mesh, ba)
    nd = len(shape)
    spec: list = [None] * nd
    if nd >= 4 and ("'k'" in key or "'v'" in key):
        # (B, KV, S, hd), possibly stacked: batch over (pod, data), S over model
        if shape[nd - 4] % bsize == 0:
            spec[nd - 4] = ba
        if shape[nd - 2] % msize == 0:
            spec[nd - 2] = "model"
    elif "wkv" in key and nd >= 3:
        # (BH, dk, dv), possibly stacked: the fused batch*head dim
        if shape[nd - 3] % bsize == 0:
            spec[nd - 3] = ba
    elif nd >= 2:
        lead = 1 if nd > 2 and "groups" in key else 0
        if shape[lead] % bsize == 0:
            spec[lead] = ba
        if shape[-1] % msize == 0 and nd - 1 != lead:
            spec[-1] = "model"
    return tuple(spec)


def decode_state_shardings(mesh, state: list, cfg) -> list:
    """Specs for the port's decode state (a list of per-layer dicts): KV
    caches shard batch over (pod, data) and the sequence over 'model';
    rwkv's wkv state its fused batch*head dim; other recurrent leaves their
    batch dim and, when divisible, their trailing feature dim over 'model'.

    Each leaf takes JAX's spec of its stacked twin (stack size: the plan's
    group count, whisper's depth) without the stack's entry.  JAX's rule
    tests ``"wkv" in key``, which every leaf of an rwkv group's path meets
    (``['0_rwkv']``): there it shards the stack axis of ``tm_last`` /
    ``cm_last`` over the batch axes and leaves the rest replicated.  The
    port holds a layer on every rank, so those two leaves are replicated."""
    if cfg.family == "encdec":
        paths, stack = {}, cfg.n_layers
    else:
        paths, stack = jax_tree.jax_layer_paths(cfg), plan(cfg)[1]
    out = []
    for n, layer_state in enumerate(state):
        prefix, index = paths.get(f"layers.{n}", ("", n))
        stacked = index is not None
        specs = {}
        for leaf, x in layer_state.items():
            shape = tuple(x.shape)
            spec = _state_spec(mesh, f"{prefix}['{leaf}']",
                               (stack,) + shape if stacked else shape)
            specs[leaf] = spec[1:] if stacked else spec
        out.append(specs)
    return out


def scalar_sharding(mesh) -> tuple:
    return ()


# -- DTensor placement ---------------------------------------------------------------
def placements(spec: tuple, mesh) -> list:
    """A spec as DTensor placements on ``mesh`` (a `DeviceMesh` or a
    shape-only mesh): `repro_torch.models.placed.placements`."""
    return placed.placements(spec, axis_names(mesh), axis_sizes(mesh))


def _map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, s) for v, s in zip(tree, specs, strict=True))
    return fn(tree, specs)


def place(tree, specs, mesh):
    """``tree`` (dicts / lists of tensors) as DTensors under ``specs``.
    Each rank cuts its block from its own whole tensor, which every rank
    must hold equal (a model made from one seed): no communication."""
    return _map(lambda x, spec: _distribute(x, spec, mesh), tree, specs)


def _distribute(x: torch.Tensor, spec: tuple, mesh):
    """``x`` as a DTensor under ``spec``; a rank's block that is a view of
    the whole tensor is copied, so the whole tensor can be freed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    pl = placements(spec, mesh)
    dt = distribute_tensor(x, mesh, pl, src_data_rank=None)
    block = dt.to_local()
    if (block.numel() != x.numel()
            and block.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()):
        dt = DTensor.from_local(block.clone(), mesh, pl, run_check=False, shape=dt.shape,
                                stride=dt.stride())
    return dt


def gather(tree):
    """The whole tensors of a tree of DTensors (others as they are)."""
    from torch.distributed.tensor import DTensor

    def one(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    if isinstance(tree, dict):
        return {k: gather(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather(v) for v in tree)
    return one(tree)


def spec_bytes(shape, itemsize: int, spec: tuple, mesh) -> int:
    """The bytes of one rank's block of a tensor of ``shape`` under ``spec``."""
    n = itemsize
    for d, dim in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        n *= dim // _axis_size(mesh, entry) if entry is not None else dim
    return n


def place_module(module: torch.nn.Module, specs: dict, mesh):
    """Replace each parameter of ``module`` by its DTensor under ``specs``
    (name -> spec), in place, one at a time (the whole tensor is freed as
    its block is made; every rank holds the same whole tensors, as `place`
    needs); returns ``module``."""
    for name in [n for n, _ in module.named_parameters()]:
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        p = getattr(sub, leaf)
        dt = _distribute(p.data, specs[name], mesh)
        setattr(sub, leaf, torch.nn.Parameter(dt, requires_grad=p.requires_grad))
        del p, dt
    return module
