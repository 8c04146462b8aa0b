"""Where JAX's parameter tree holds the port's parameters.

The port holds its layers unstacked (``layers.<n>``, whisper's ``enc.<n>``
/ ``dec.<n>``); JAX's tree stacks the layers of the scanned groups and
whisper's encoder and decoder.  These maps give each port parameter its
JAX ``keystr`` and its index in a stack: the names of a training
checkpoint's leaves and the keys of the partition rules.
"""
from __future__ import annotations

from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig

__all__ = ["jax_layer_paths", "stacked_in_jax", "tree_names"]


def jax_layer_paths(cfg: ModelConfig) -> dict[str, tuple[str, int | None]]:
    """Where JAX's tree holds each of the port's layers: the layer's prefix
    (``layers.<n>``, whisper's ``enc.<n>`` / ``dec.<n>``) -> (the JAX
    ``keystr`` of its subtree, its index in a stack or None).  A layer of
    the scanned groups is ``['groups']['<i>_<kind>']`` at index n //
    len(pattern), a tail layer ``['tail'][t]``; whisper's layers are
    ``['enc']`` / ``['dec']`` at index n."""
    if cfg.family == "encdec":
        return {**{f"enc.{n}": ("['enc']", n) for n in range(cfg.enc_layers)},
                **{f"dec.{n}": ("['dec']", n) for n in range(cfg.n_layers)}}
    pat, n_groups, tail = transformer.plan(cfg)
    stacked = n_groups * len(pat)
    out = {f"layers.{n}": (f"['groups']['{n % len(pat)}_{pat[n % len(pat)]}']", n // len(pat))
           for n in range(stacked)}
    out.update({f"layers.{stacked + t}": (f"['tail'][{t}]", None) for t in range(tail)})
    return out


def stacked_in_jax(paths: dict, name: str) -> bool:
    """Whether JAX's tree holds the leaf of the port's parameter ``name``
    in a stack of layers, one more axis than the port's tensor (``paths``:
    `jax_layer_paths`)."""
    entry = paths.get(".".join(name.split(".")[:2]))
    return entry is not None and entry[1] is not None


def tree_names(prefix: str, names, paths: dict) -> dict:
    """The port's leaf name -> (JAX name, index in a stack of layers or
    None).  ``paths`` (`jax_layer_paths`) says where JAX's tree holds each
    layer: a group of the layer plan at an index, a tail layer, whisper's
    ``enc`` / ``dec`` stacks."""
    out = {}
    for name in names:
        parts = name.split(".")
        entry = paths.get(".".join(parts[:2]))
        if entry is None:
            out[name] = (f"{prefix}[{name!r}]", None)
        else:
            key = "".join(f"[{p!r}]" for p in parts[2:])
            out[name] = (f"{prefix}{entry[0]}{key}", entry[1])
    return out
