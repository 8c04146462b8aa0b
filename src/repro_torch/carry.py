"""Carry a state or the LM weights of the JAX package over into the port.

`from_reference` takes a `repro` ``PTState`` or ``EngineState`` dumped to
numpy arrays under flat names and returns the port's state on ``device``
(required: ``"cuda"``, or ``"cpu"`` for the plain PyTorch path), so both
packages can be started from one state:

==========================  ===============================================
name                        JAX source
==========================  ===============================================
``states``                  ``pt.states`` (R, L, L) int8
``energy`` / ``rung``       ``pt.energy`` (R,) f32 / ``pt.rung`` (R,) int32
``key``                     ``jax.random.key_data(pt.key)`` (2,) uint32
``t`` / ``phase``           ``pt.t`` / ``pt.phase`` scalars (per chain)
``betas``                   ``EngineState.betas`` (R,) f32 (engine only)
``stats.<field>``           each `OnlineStats` array field (engine only)
``stats.mean.<series>``     ``stats.mean[series]``; likewise ``stats.m2.``
==========================  ===============================================

With ``betas`` present the result is an `EngineState`, else a `PTState`.
`from_checkpoint_arrays` does the same for the arrays of an engine
checkpoint (``arrays_p0.npz`` of either package), named by the checkpoint
manager's one table (`repro_torch.checkpoint.engine_leaves`).
An ensemble state (``n_chains = C > 1``) carries a leading chain axis on
every array but ``betas``: ``states`` (C, R, ...), ``key`` (C, 2), ``t``
and ``phase`` (C,), ``stats.*`` (C, R) and ``stats.n_records`` (C,).

`lm_params_from_reference` takes the JAX package's LM parameter pytree
(`repro.models.model.init_params`) as a nested dict of numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``) and returns the port's
`repro_torch.models.transformer.LM` holding the same values: the stacked
``groups/<i>_<kind>/...`` leaves (G, ...) are unstacked into the layers in
order, then the ``tail`` layers, if any.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.pt import PTState
from repro_torch.device import resolve_device
from repro_torch.engine.driver import EngineState
from repro_torch.engine.stats import OnlineStats

__all__ = ["from_reference", "from_checkpoint_arrays", "lm_params_from_reference"]


def _t(x, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(dtype=dtype, device=device)


def from_reference(arrays: dict[str, np.ndarray], device):
    """Port state from a JAX state dumped to numpy (see the module table)."""
    device = resolve_device(device)
    chains = np.shape(arrays["energy"])[:-1]  # () or (C,)
    pt = PTState(
        states=_t(arrays["states"], torch.int8, device),
        energy=_t(arrays["energy"], torch.float32, device),
        rung=_t(arrays["rung"], torch.int32, device),
        key=_t(np.asarray(arrays["key"], np.uint32).astype(np.int64), torch.int64, device),
        phase=_t(arrays["phase"], torch.int64, device).reshape(chains),
        t=_t(arrays["t"], torch.int64, device).reshape(chains),
    )
    if "betas" not in arrays:
        return pt
    dtypes = {"n_records": torch.int32, "direction": torch.int8,
              "round_trips": torch.int32}
    fields = {}
    for f in dataclasses.fields(OnlineStats):
        if f.name in ("mean", "m2"):
            prefix = f"stats.{f.name}."
            fields[f.name] = {
                k[len(prefix):]: _t(v, torch.float32, device)
                for k, v in arrays.items() if k.startswith(prefix)
            }
        else:
            fields[f.name] = _t(
                arrays[f"stats.{f.name}"], dtypes.get(f.name, torch.float32), device
            )
    return EngineState(
        pt=pt, stats=OnlineStats(**fields),
        betas=_t(arrays["betas"], torch.float32, device),
    )


def from_checkpoint_arrays(arrays: dict[str, np.ndarray], device):
    """The port's `EngineState` from a checkpoint's arrays (JAX ``keystr``
    names)."""
    from repro_torch.checkpoint.manager import from_arrays

    return from_arrays(arrays, resolve_device(device))


def _leaves(tree, prefix=""):
    """(dotted name, array) pairs of a nested dict, depth first."""
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", value


def lm_params_from_reference(params_np: dict, cfg, device):
    """The port's `LM` with the JAX parameter pytree's values (see the module
    docstring): the tensors the JAX code casts to the compute dtype at use
    are stored cast, the f32 leaves (``w0``, ``u``, the norms) stay f32."""
    from repro_torch.models.transformer import LM, plan

    device = resolve_device(device)
    model = LM(cfg, None, device)
    pat, n_groups, _ = plan(cfg)
    layers = []
    for g in range(n_groups):
        for i, kind in enumerate(pat):
            stacked = params_np["groups"][f"{i}_{kind}"]
            layers.append({n: np.asarray(a)[g] for n, a in _leaves(stacked)})
    layers += [dict(_leaves(lp)) for lp in params_np.get("tail", [])]
    state = {n: params_np[n] for n in ("embed", "final_norm", "unembed") if n in params_np}
    for n, lp in enumerate(layers):
        state.update({f"layers.{n}.{name}": a for name, a in lp.items()})
    model.load_state_dict({n: torch.from_numpy(np.array(a)) for n, a in state.items()},
                          strict=True)
    return model
