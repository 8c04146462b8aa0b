"""How far two runs' f32 masters may lie apart after the same AdamW steps,
element by element (numpy only: tests/test_torch_train.py holds the port
against the JAX package by it, tests/test_torch_cuda.py the card against
the CPU).

Where the two runs' gradients differ in their last bits, so do their
moments, and Adam turns that into a difference of the update direction
``(m / c1) / (sqrt(v / c2) + eps)``: small where the gradient is large
against the difference, up to 2 where it is near 0 and its sign is the
last bits'.  Each run's direction is read from its own moments after each
step, and the masters may differ by what those directions explain:

    bound_s = bound_{s-1} (1 + lr_s wd) + lr_s |dir_a - dir_b|
              + 4 eps_f32 (|p| + lr_s (1 + |dir_a|))

(the last term: the update's own roundings).  Everything else about the
step must agree, so a last update left out, or taken with the wrong sign,
lies far outside it wherever the gradient is not near 0.  The moments are
held against each other on their own.
"""
import numpy as np

EPS32 = float(np.finfo(np.float32).eps)


def direction(mu, nu, count, opt):
    """Adam's update direction from moments after step ``count``, in f32 as
    `repro.train.optimizer.apply` computes it."""
    c1 = np.float32(1.0) - np.float32(opt.b1) ** np.float32(count)
    c2 = np.float32(1.0) - np.float32(opt.b2) ** np.float32(count)
    return (mu / c1) / (np.sqrt(nu / c2) + np.float32(opt.eps))


def grow(bound: dict, opt, lr: float, count: int, p: dict, mine: tuple, ref: tuple) -> dict:
    """The bound after one more step: ``p`` the masters before it (one
    run's), ``mine`` and ``ref`` each run's ``(mu, nu)`` after it (dicts of
    numpy arrays under the same names)."""
    out = {}
    for n, pn in p.items():
        da = direction(mine[0][n], mine[1][n], count, opt)
        db = direction(ref[0][n], ref[1][n], count, opt)
        out[n] = (bound.get(n, 0.0) * (1 + lr * opt.weight_decay) + lr * np.abs(da - db)
                  + 4 * EPS32 * (np.abs(pn) + lr * (1 + np.abs(da))))
    return out


def reading(mine: dict, ref: dict, bound: dict) -> float:
    """The largest ``|mine - ref| / (1e-6 + bound)`` over every element: at
    most 1 where the masters agree as the bound says."""
    return max(float(np.max(np.abs(mine[n] - ref[n]) / (1e-6 + bound[n]))) for n in mine)
