"""Carry a state of the JAX package over into the port.

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
``t`` / ``phase``           ``pt.t`` / ``pt.phase`` scalars
``betas``                   ``EngineState.betas`` (R,) f32 (engine only)
``stats.<field>``           each `OnlineStats` array field (engine only)
``stats.mean.<series>``     ``stats.mean[series]``; likewise ``stats.m2.``
==========================  ===============================================

With ``betas`` present the result is an `EngineState`, else a `PTState`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.pt import PTState
from repro_torch.device import resolve_device
from repro_torch.engine.driver import EngineState
from repro_torch.engine.stats import OnlineStats

__all__ = ["from_reference"]


def _t(x, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(dtype=dtype, device=device)


def from_reference(arrays: dict[str, np.ndarray], device):
    """Port state from a JAX state dumped to numpy (see the module table)."""
    device = resolve_device(device)
    pt = PTState(
        states=_t(arrays["states"], torch.int8, device),
        energy=_t(arrays["energy"], torch.float32, device),
        rung=_t(arrays["rung"], torch.int32, device),
        key=_t(np.asarray(arrays["key"], np.uint32).astype(np.int64), torch.int64, device),
        phase=_t(arrays["phase"], torch.int64, device).reshape(()),
        t=_t(arrays["t"], torch.int64, device).reshape(()),
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
