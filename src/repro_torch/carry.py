"""Carry a state or the LM weights of the JAX package over into the port.

`from_reference` takes a `repro` ``PTState`` or ``EngineState`` dumped to
numpy arrays under flat names and returns the port's state on ``device``
(required: ``"cuda"``, or ``"cpu"`` for the plain PyTorch path), so both
packages can be started from one state:

==========================  ===============================================
name                        JAX source
==========================  ===============================================
``states``                  ``pt.states`` (R, ...) in its own dtype (int8
                            lattices, HP's int32 chains, the Gaussian's
                            f32), or a dict of such arrays (EA)
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
`repro_torch.models.transformer.LM` (or, for the encdec family,
`repro_torch.models.whisper.WhisperLM`) holding the same values: the stacked
``groups/<i>_<kind>/...`` leaves (G, ...) are unstacked into the layers in
order, then the ``tail`` layers, if any (recurrentgemma's 38 layers are
12 groups of ``0_rglru``, ``1_rglru``, ``2_attn_local`` and a 2-layer
``rglru`` tail).  A dense or ``attn_local`` layer's leaves are
``norm1``, ``attn.{wq, wk, wv, wo[, q_norm, k_norm]}``, ``norm2`` and
``ffn.{[w_gate,] w_up, w_down}``; an ``rglru`` layer has ``mix.{w_x,
w_gmlp, conv_w, conv_b, w_r, b_r, w_i, b_i, lam, w_out}`` in place of
``attn``, an ``attn_moe`` layer ``moe.{router, w_gate, w_up, w_down}`` in
place of ``ffn``, a vlm ``cross`` layer (``3_cross`` in llama-3.2-vision's
groups) ``attn.gate`` (1,) f32 besides the attention's leaves; a model with
tied embeddings has no ``unembed``.  Whisper's tree is ``enc`` (its layers
stacked (enc_layers, ...): ``norm1``, ``attn``, ``norm2``, ``ffn``),
``enc_norm``, ``dec`` (stacked (n_layers, ...): ``norm1``, ``self``,
``norm2``, ``cross``, ``norm3``, ``ffn``), ``embed``, ``final_norm`` and
``unembed``; the port's names are ``enc.<n>.…`` and ``dec.<n>.…``.

`train_state_from_reference` takes a JAX training state
(`repro.train.train_step.TrainState`: the masters, AdamW's ``mu``, ``nu``
and ``count``, and ``step``) as numpy arrays in the same nested form and
returns the port's `repro_torch.train.train_step.TrainState`: every leaf
f32 (the count and the step int32), under the `LM`'s parameter names.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.pt import PTState
from repro_torch.device import resolve_device
from repro_torch.engine.driver import EngineState
from repro_torch.engine.stats import OnlineStats

__all__ = ["from_reference", "from_checkpoint_arrays", "lm_params_from_reference",
           "train_state_from_reference"]


def _t(x, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(dtype=dtype, device=device)


def from_reference(arrays: dict[str, np.ndarray], device):
    """Port state from a JAX state dumped to numpy (see the module table)."""
    device = resolve_device(device)
    chains = np.shape(arrays["energy"])[:-1]  # () or (C,)

    def state_leaf(x):
        return torch.from_numpy(np.array(x)).to(device)

    states = arrays["states"]
    pt = PTState(
        states=({k: state_leaf(v) for k, v in states.items()} if isinstance(states, dict)
                else state_leaf(states)),
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


def _lm_state(params_np: dict, cfg) -> dict:
    """The JAX LM tree's arrays under the port's `LM` (`WhisperLM`)
    parameter names."""
    from repro_torch.models.transformer import plan

    if cfg.family == "encdec":
        state = {n: params_np[n] for n in ("embed", "enc_norm", "final_norm", "unembed")}
        for stack, depth in (("enc", cfg.enc_layers), ("dec", cfg.n_layers)):
            for name, a in _leaves(params_np[stack]):
                for n in range(depth):
                    state[f"{stack}.{n}.{name}"] = np.asarray(a)[n]
        return state
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
    return state


def lm_params_from_reference(params_np: dict, cfg, device):
    """The port's `LM` with the JAX parameter pytree's values (see the module
    docstring): the tensors the JAX code casts to the compute dtype at use
    are stored cast, the f32 leaves (``w0``, ``u``, the norms, ``q_norm`` /
    ``k_norm``, ``b_r``, ``b_i``, ``lam``, the MoE ``router``, the cross
    layers' ``gate``) stay f32."""
    from repro_torch.models.model import model_class

    device = resolve_device(device)
    model = model_class(cfg)(cfg, None, device)
    state = _lm_state(params_np, cfg)
    model.load_state_dict({n: torch.from_numpy(np.array(a)) for n, a in state.items()},
                          strict=True)
    return model


def train_state_from_reference(state_np, cfg, device):
    """The port's `TrainState` from a JAX one dumped to numpy (an object with
    ``params``, ``opt.mu``, ``opt.nu``, ``opt.count`` and ``step``, or the
    same as nested dicts); the masters and moments in the `LM`'s parameter
    order, f32, on ``device``."""
    from repro_torch.models.model import model_class
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.train_step import TrainState, jax_layer_paths

    def get(x, name):
        return x[name] if isinstance(x, dict) else getattr(x, name)

    device = resolve_device(device)
    names = [n for n, _ in model_class(cfg)(cfg, None, "meta").named_parameters()]

    def tree(t):
        flat = _lm_state(t, cfg)
        if set(flat) != set(names):
            raise KeyError(f"JAX tree leaves {sorted(set(flat) ^ set(names))} do not match "
                           f"the port's model")
        return {n: _t(flat[n], torch.float32, device) for n in names}

    opt = get(state_np, "opt")
    return TrainState(
        params=tree(get(state_np, "params")),
        opt=AdamWState(mu=tree(get(opt, "mu")), nu=tree(get(opt, "nu")),
                       count=_t(get(opt, "count"), torch.int32, device).reshape(())),
        step=_t(get(state_np, "step"), torch.int32, device).reshape(()),
        jax_paths=jax_layer_paths(cfg))
