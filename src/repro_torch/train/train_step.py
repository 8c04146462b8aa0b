"""Training step: loss -> grad -> AdamW, with microbatch gradient
accumulation (twin of `repro.train.train_step`).

A `TrainState` holds f32 master weights under the `LM`'s parameter names
(``embed``, ``layers.<n>.tm.w_r``, ...: JAX's tree with its stacked groups
unstacked into layers), the AdamW moments mirroring them and the step, a
0-d int32 device tensor.  Each step casts the f32 masters that JAX casts
to the compute dtype once, before the layers (`cast_params`), runs
`repro_torch.models.model.forward_loss` on those tensors through a template
`LM` on the ``meta`` device, and takes f32 gradients with respect to the
masters: the cast's gradient widens each bf16 cotangent to f32, as JAX's
transpose of ``astype`` does.

On CUDA every wkv6 of the forward is kernel #7 and every one of the
backward kernel #7b (`repro_torch.kernels.ops.wkv6`); with ``cfg.remat``
each layer's forward runs again in the backward pass (two #7 a layer and
step, one #7b).  The step enqueues its work with no host sync.

``cast_shardings`` and ``grad_shardings`` are the JAX trainer's GSPMD
placements (FSDP masters, TP-sharded casts); the port's mesh layer for
them (`launch/sharding.py`) is not ported, so anything but None is
refused by name.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig
from repro_torch.train import optimizer as opt_lib

__all__ = ["TrainState", "init_state", "cast_params", "make_train_step"]


@dataclasses.dataclass
class TrainState:
    params: dict  # name -> f32 master tensor
    opt: opt_lib.AdamWState
    step: torch.Tensor  # () int32


def init_state(cfg: ModelConfig, generator, device="cuda") -> TrainState:
    """f32 masters drawn as `model.init_params` draws an `LM` (an int seed or
    a `torch.Generator` on ``device``), zero moments, step 0."""
    device = resolve_device(device)
    master = dataclasses.replace(cfg, dtype=cfg.param_dtype)
    lm = model_lib.init_params(master, generator, device=device)
    params = {n: p.data for n, p in lm.named_parameters()}
    return TrainState(params=params, opt=opt_lib.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def cast_params(cfg: ModelConfig, params: dict) -> dict:
    """The f32 tensors that JAX's ``cast_params`` casts, to
    ``cfg.compute_dtype``; the rest as they are.

    JAX casts every >= 2-D f32 leaf of its tree, and its tree stacks the
    layers of the scanned groups (G, ...): there a layer's 1-D leaves (the
    norms, ``w0``, ``ln_scale``, biases) are 2-D and cast too, so their
    gradients come back rounded to the compute dtype.  The tail's layers
    and the top-level leaves (``final_norm``) keep their own rank.
    """
    dt = cfg.compute_dtype
    pat, n_groups, _ = transformer.plan(cfg)
    stacked = n_groups * len(pat)  # the layers JAX holds in its groups

    def rank(name: str, p: torch.Tensor) -> int:
        parts = name.split(".")
        in_group = parts[0] == "layers" and int(parts[1]) < stacked
        return p.dim() + in_group

    return {n: p.to(dt) if rank(n, p) >= 2 and p.dtype == torch.float32 else p
            for n, p in params.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: opt_lib.AdamWConfig, *,
                    microbatches: int = 1, cast_shardings=None, grad_shardings=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch``: ``tokens`` and ``labels`` (B, S) integer tensors on the
    state's device.  ``microbatches`` splits B and accumulates the losses and
    the f32 gradients in order from zero, then divides both by their count,
    as JAX's ``lax.scan`` does.  The state's dicts get the new tensors and
    the same `TrainState` is returned (as a donated JAX state, the old one is
    gone); ``metrics`` holds ``loss``, ``grad_norm`` and ``lr`` as 0-d f32
    device tensors.
    """
    for name, value in (("cast_shardings", cast_shardings), ("grad_shardings", grad_shardings)):
        if value is not None:
            raise NotImplementedError(
                f"not yet ported: {name} (GSPMD placement; launch/sharding.py is not "
                "ported)")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    template = transformer.LM(cfg, None, device="meta")

    def grad_fn(params: dict, batch: dict):
        leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
        with torch.enable_grad():
            loss = model_lib.forward_loss(template, cfg, batch,
                                          params=cast_params(cfg, leaves))
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    def train_step(state: TrainState, batch: dict):
        if microbatches == 1:
            loss, grads = grad_fn(state.params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"a batch of {b} does not split into {microbatches} "
                                 "microbatches")
            size = b // microbatches
            loss = torch.zeros((), dtype=torch.float32, device=state.step.device)
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for n, p in state.params.items()}
            for i in range(microbatches):
                mb = {k: x[i * size:(i + 1) * size] for k, x in batch.items()}
                l, g = grad_fn(state.params, mb)
                loss = loss + l
                for n in grads:
                    grads[n] = grads[n] + g.pop(n)
            loss = loss / microbatches
            grads = {n: g / microbatches for n, g in grads.items()}
        _, _, metrics = opt_lib.apply(opt_cfg, state.params, grads, state.opt)
        metrics["loss"] = loss
        state.step = state.step + 1
        return state, metrics

    return train_step
