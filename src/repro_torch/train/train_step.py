"""Training step: loss -> grad -> AdamW, with microbatch gradient
accumulation (twin of `repro.train.train_step`).

A `TrainState` holds f32 master weights under the `LM`'s parameter names
(``embed``, ``layers.<n>.tm.w_r``, ...: JAX's tree with its stacked groups
unstacked into layers), the AdamW moments mirroring them and the step, a
0-d int32 device tensor.  Each step casts the f32 masters that JAX casts
to the compute dtype once, before the layers (`cast_params`), runs
`repro_torch.models.model.forward_loss` on those tensors through a template
of the family's module (`LM`, or whisper's `WhisperLM`) on the ``meta``
device, and takes f32 gradients with respect to the
masters: the cast's gradient widens each bf16 cotangent to f32, as JAX's
transpose of ``astype`` does.

On CUDA every wkv6 of the forward is kernel #7 and every one of the
backward kernel #7b (`repro_torch.kernels.ops.wkv6`); with ``cfg.remat``
each layer's forward runs again in the backward pass (two #7 a layer and
step, one #7b).  The step enqueues its work with no host sync.

``cast_shardings`` and ``grad_shardings`` (name -> spec, from
`repro_torch.launch.sharding.param_shardings`) are the JAX trainer's
mixed-precision FSDP pattern over DTensor: the masters and AdamW's moments
live in the ``grad_shardings`` layout (`place_state` with the same specs;
JAX's FSDP layout is ``param_shardings(..., fsdp=True)``), each step casts every leaf and
redistributes it to its ``cast_shardings`` spec once, before the layers (the
all-gather over 'data' happens once a step, outside the layer loop), and
the gradients come back to the ``grad_shardings`` layout (a reduce-scatter)
before AdamW runs on each rank's block.  A plain batch is placed under
`sharding.batch_shardings` (after the microbatch split, so microbatches keep
their order).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.launch import sharding
from repro_torch.models import model as model_lib
from repro_torch.models import placed
from repro_torch.models.common import ModelConfig
from repro_torch.models.jax_tree import jax_layer_paths, stacked_in_jax
from repro_torch.train import optimizer as opt_lib

__all__ = ["TrainState", "init_state", "place_state", "jax_layer_paths", "stacked_in_jax",
           "cast_params", "make_train_step"]


@dataclasses.dataclass
class TrainState:
    params: dict  # name -> f32 master tensor
    opt: opt_lib.AdamWState
    step: torch.Tensor  # () int32
    # where JAX's tree holds each layer (`jax_layer_paths`): the names a
    # training checkpoint gives the leaves
    jax_paths: dict


def init_state(cfg: ModelConfig, generator, device="cuda") -> TrainState:
    """f32 masters drawn as `model.init_params` draws an `LM` (an int seed or
    a `torch.Generator` on ``device``), zero moments, step 0."""
    device = resolve_device(device)
    master = dataclasses.replace(cfg, dtype=cfg.param_dtype)
    lm = model_lib.init_params(master, generator, device=device)
    params = {n: p.data for n, p in lm.named_parameters()}
    return TrainState(params=params, opt=opt_lib.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device),
                      jax_paths=jax_layer_paths(cfg))


def place_state(state: TrainState, specs: dict, mesh) -> TrainState:
    """``state`` with its masters and moments as DTensors on ``mesh`` under
    ``specs`` (name -> spec: the ``grad_shardings`` the step is made with),
    each rank cutting its blocks from its own whole tensors (all equal: one
    seed)."""
    for tree in (state.params, state.opt.mu, state.opt.nu):
        tree.update(sharding.place(tree, specs, mesh))
    return state


def cast_params(cfg: ModelConfig, params: dict) -> dict:
    """The f32 tensors that JAX's ``cast_params`` casts, to
    ``cfg.compute_dtype``; the rest as they are.

    JAX casts every >= 2-D f32 leaf of its tree, and its tree stacks the
    layers of the scanned groups (G, ...) and whisper's encoder and decoder
    layers (L, ...): there a layer's 1-D leaves (the norms, ``w0``,
    ``ln_scale``, biases) are 2-D, and the vlm gates (1,) are (G, 1), and
    all are cast too, so their gradients come back rounded to the compute
    dtype (`stacked_in_jax`).  The tail's layers and the top-level leaves
    (``final_norm``, whisper's ``enc_norm``) keep their own rank.
    """
    dt = cfg.compute_dtype
    paths = jax_layer_paths(cfg)
    return {n: p.to(dt) if p.dim() + stacked_in_jax(paths, n) >= 2 and p.dtype == torch.float32
            else p for n, p in params.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: opt_lib.AdamWConfig, *,
                    microbatches: int = 1, cast_shardings=None, grad_shardings=None,
                    counter=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch``: ``tokens`` and ``labels`` (B, S) integer tensors on the
    state's device (and the family's context: whisper's ``frames``, the
    vlm's optional ``img``).  ``microbatches`` splits B and accumulates the losses and
    the f32 gradients in order from zero, then divides both by their count,
    as JAX's ``lax.scan`` does.  The state's dicts get the new tensors and
    the same `TrainState` is returned (as a donated JAX state, the old one is
    gone); ``metrics`` holds ``loss``, ``grad_norm`` and ``lr`` as 0-d f32
    device tensors.  ``counter`` (a `repro_torch.launch.comm.CollectiveCounter`)
    gets the placed step's ``cast`` and ``grads`` phases named.

    With ``cast_shardings`` the masters and moments must be placed under
    ``grad_shardings`` (`place_state` with the same dict), else the step
    raises.  A plain batch is placed by the step: every rank passes the same
    whole batch, and takes its block of it.
    """
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    template = model_lib.model_class(cfg)(cfg, None, device="meta")

    def grad_fn(params: dict, batch: dict):
        if cast_shardings is not None:
            return placed_grad_fn(params, batch)
        leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
        with torch.enable_grad():
            loss = model_lib.forward_loss(template, cfg, batch,
                                          params=cast_params(cfg, leaves))
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), constrain(dict(zip(leaves, grads)))

    def placed_grad_fn(params: dict, batch: dict):
        """The cast and its transpose made explicit, so each collective is
        one of the step's own: every leaf cast and redistributed to its
        ``cast_shardings`` spec (``cast``: the all-gather over 'data'), the
        loss's gradients taken with respect to those tensors, brought back
        to ``grad_shardings`` (``grads``: the reduce-scatter over 'data' of
        the partial sums, after `to_cast_layout`), then widened to f32 (the
        cast's transpose)."""
        for n, p in params.items():
            if not placed.is_dtensor(p) or (grad_shardings is not None and tuple(p.placements)
                                            != tuple(sharding.placements(grad_shardings[n],
                                                                         p.device_mesh))):
                raise ValueError("cast_shardings / grad_shardings need the masters placed as "
                                 "DTensors under grad_shardings (train_step.place_state(state, "
                                 f"grad_shardings, mesh)); {n} is not")
        with phase("cast"):
            cast = {n: placed.redistribute(p, cast_shardings[n])
                    for n, p in cast_params(cfg, params).items()}
        leaves = {n: p.detach().requires_grad_() for n, p in cast.items()}
        with torch.enable_grad():
            loss = model_lib.forward_loss(template, cfg, batch, params=leaves)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        with phase("grads"):
            grads = constrain({n: to_cast_layout(g, n) for n, g in zip(leaves, grads)})
        return loss.detach(), {n: g.to(torch.float32) for n, g in grads.items()}

    def to_cast_layout(g, name: str):
        """A gradient that the TP products left partial over the non-batch
        axes, reduced onto its ``cast_shardings`` layout there first, so the
        'data' reduce-scatter moves the cast's block and no more."""
        mesh = g.device_mesh
        want = sharding.placements(cast_shardings[name], mesh)
        mid = [have if axis in placed.BATCH_AXES else w
               for axis, have, w in zip(mesh.mesh_dim_names, g.placements, want)]
        return g if mid == list(g.placements) else g.redistribute(mesh, mid)

    def phase(name: str):
        return counter.phase(name) if counter is not None else contextlib.nullcontext()

    def constrain(grads: dict) -> dict:
        if grad_shardings is None:
            return grads
        return {n: placed.redistribute(g, grad_shardings[n]) for n, g in grads.items()}

    def place(state: TrainState, batch: dict) -> dict:
        """A plain batch on placed masters goes under `batch_shardings`."""
        p = next(iter(state.params.values()))
        if not placed.is_dtensor(p) or any(placed.is_dtensor(x) for x in batch.values()):
            return batch
        return sharding.place(batch, sharding.batch_shardings(p.device_mesh, batch),
                              p.device_mesh)

    def train_step(state: TrainState, batch: dict):
        with placed.implicit(state.params):
            return step(state, batch)

    def step(state: TrainState, batch: dict):
        if microbatches == 1:
            loss, grads = grad_fn(state.params, place(state, batch))
        else:
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"a batch of {b} does not split into {microbatches} "
                                 "microbatches")
            size = b // microbatches
            loss = torch.zeros((), dtype=torch.float32, device=state.step.device)
            grads = constrain({n: torch.zeros_like(p, dtype=torch.float32)
                               for n, p in state.params.items()})
            for i in range(microbatches):
                mb = place(state, {k: x[i * size:(i + 1) * size] for k, x in batch.items()})
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
