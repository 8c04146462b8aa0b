"""AdamW with decoupled weight decay and global-norm clipping (twin of
`repro.train.optimizer`).

Written op for op as the JAX package writes it, not `torch.optim.AdamW`
(whose update rounds in another order): bias corrections ``1 - b**count``
in f32, then ``(m / c1) / (sqrt(v / c2) + eps)``, the decoupled decay inside
the ``lr *`` product, the clip scale on the gradient first.  Python floats
meet f32 tensors as JAX's weakly typed scalars do (rounded to f32).

A tree is a dict of tensors (`repro_torch.train.train_step` keeps the LM's
parameters under their names); the optimizer state mirrors it.  The step
makes no host sync: the norm, the clip scale, the schedule and the count
stay 0-d tensors on the device.  `apply` replaces the parameters' and the
moments' dict entries leaf by leaf (a JAX step donates its state; here the
old and the new state of the whole tree never both exist), and returns the
same dicts.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["AdamWConfig", "AdamWState", "init", "schedule", "global_norm", "apply"]


@dataclasses.dataclass
class AdamWState:
    mu: dict
    nu: dict
    count: torch.Tensor  # () int32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # cosine decay to lr*min_ratio over total_steps (0 = constant after warmup)
    total_steps: int = 0
    min_ratio: float = 0.1


def init(params: dict) -> AdamWState:
    """Zero f32 moments shaped like ``params`` and a count of 0."""
    def z(p):  # zeros_like: a DTensor master gets moments of its placement
        return torch.zeros_like(p, dtype=torch.float32)

    device = next(iter(params.values())).device
    return AdamWState(mu={n: z(p) for n, p in params.items()},
                      nu={n: z(p) for n, p in params.items()},
                      count=torch.zeros((), dtype=torch.int32, device=device))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then (with ``total_steps``) cosine decay, f32 on ``step``'s device."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.total_steps:
        frac = torch.clamp(
            (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
            0.0, 1.0,
        )
        cos = cfg.min_ratio + (1 - cfg.min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    else:
        cos = 1.0
    return cfg.lr * warm * cos


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in order, of each leaf's f32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in tree.values()))


def apply(cfg: AdamWConfig, params: dict, grads: dict, state: AdamWState):
    """One AdamW step.  Returns ``(params, state, metrics)``: the same dicts
    with each entry replaced by its new tensor (``grads`` is emptied as each
    leaf is used), and ``{"grad_norm", "lr"}`` as 0-d f32 device tensors."""
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
             if cfg.grad_clip else 1.0)
    count = state.count + 1
    lr = schedule(cfg, count)
    c1 = 1.0 - cfg.b1 ** count.to(torch.float32)
    c2 = 1.0 - cfg.b2 ** count.to(torch.float32)
    for name in list(params):
        p, g = params[name], grads.pop(name)
        m, v = state.mu[name], state.nu[name]
        g = g.to(torch.float32) * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        step = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
        pf = p.to(torch.float32)
        new_p = pf - lr * (step + cfg.weight_decay * pf)
        del p, g, m, v, step, pf
        params[name] = new_p.to(params[name].dtype)
        state.mu[name], state.nu[name] = m_new, v_new
    state.count = count
    return params, state, {"grad_norm": gnorm, "lr": lr}
