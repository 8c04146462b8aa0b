"""The port's RWKV-6 recurrence against the JAX package's.

`repro_torch.kernels.ref.wkv6` (the plain version: the CPU path and the
oracle of CUDA kernel #7) against `repro.kernels.ref.wkv6` (the `lax.scan`
oracle) and against `repro.kernels.ops.wkv6(use_pallas=True)`, which runs
the Pallas kernel `wkv6_pallas` in interpret mode on the CPU, on the shapes
of `tests/test_kernels.py`'s wkv6 tests: the T=33 pad case, initial-state
threading and the w=1, k=0 identity.  Inputs come from a numpy seed.

Tolerance: rtol = atol = 3e-5, the JAX package's own between its Pallas
kernel and its oracle (the sums are f32 in other orders); the identity case
to 1e-6 as there.  The CUDA kernel's twins are in `tests/test_torch_cuda.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import wkv6 as twk  # noqa: E402

TOL = dict(rtol=3e-5, atol=3e-5)


def _inputs(seed, bh, t, dk, dv, state=False):
    """r, k, v, w, u (and an initial state) as numpy f32; w = sigmoid(normal)."""
    rng = np.random.default_rng(seed)
    r, k = (rng.normal(size=(bh, t, dk)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(bh, t, dv)).astype(np.float32)
    w = (1.0 / (1.0 + np.exp(-rng.normal(size=(bh, t, dk))))).astype(np.float32)
    u = rng.normal(size=(bh, dk)).astype(np.float32)
    s0 = rng.normal(size=(bh, dk, dv)).astype(np.float32) if state else None
    return r, k, v, w, u, s0


def _jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


def _torch(args):
    return [None if a is None else torch.from_numpy(a) for a in args]


@pytest.mark.parametrize("bh,t,dk,dv,chunk", [
    (1, 8, 4, 4, 4), (2, 32, 8, 16, 8), (4, 33, 8, 8, 16),  # pad path
    (3, 64, 64, 64, 32), (2, 16, 16, 8, 16),
])
@pytest.mark.parametrize("state", [False, True], ids=["zero-state", "carried-state"])
def test_plain_wkv6_matches_jax_oracle_and_pallas(bh, t, dk, dv, chunk, state):
    args = _inputs(bh * 7 + t, bh, t, dk, dv, state)
    o, s = tref.wkv6(*_torch(args))
    o_ref, s_ref = jref.wkv6(*_jax(args))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), **TOL)
    o_pl, s_pl = jops.wkv6(*_jax(args), chunk=chunk, use_pallas=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_pl), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_pl), **TOL)
    # the op dispatches CPU tensors to the plain version; the TPU knobs are ignored
    o_op, s_op = tops.wkv6(*_torch(args), chunk=chunk, use_pallas=True)
    assert torch.equal(o_op, o) and torch.equal(s_op, s)


def test_initial_state_threading():
    """Chunked decode: running T=32 in two halves == one shot (cache reuse)."""
    r, k, v, w, u, _ = _torch(_inputs(5, 2, 32, 8, 8))
    o_full, s_full = tops.wkv6(r, k, v, w, u)
    o1, s1 = tops.wkv6(r[:, :16], k[:, :16], v[:, :16], w[:, :16], u)
    o2, s2 = tops.wkv6(r[:, 16:], k[:, 16:], v[:, 16:], w[:, 16:], u, s1)
    np.testing.assert_allclose(o_full.numpy(), torch.cat([o1, o2], 1).numpy(), **TOL)
    np.testing.assert_allclose(s_full.numpy(), s2.numpy(), **TOL)
    o_j, s_j = jops.wkv6(*_jax(_inputs(5, 2, 32, 8, 8)[:5]), chunk=8)
    np.testing.assert_allclose(o_full.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(s_full.numpy(), np.asarray(s_j), **TOL)


def test_decay_semantics():
    """w=1, k=0 must be the identity (state preserved, output = r @ S)."""
    dk = dv = 4
    s0 = torch.arange(dk * dv, dtype=torch.float32).reshape(1, dk, dv)
    r, w = torch.ones((1, 2, dk)), torch.ones((1, 2, dk))
    k, v = torch.zeros((1, 2, dk)), torch.zeros((1, 2, dv))
    o, s = tops.wkv6(r, k, v, w, torch.zeros((1, dk)), s0, chunk=2)
    np.testing.assert_allclose(s.numpy(), s0.numpy(), rtol=1e-6)
    np.testing.assert_allclose(o[0, 0].numpy(), (r[:, 0] @ s0[0])[0].numpy(), rtol=1e-6)


def test_cuda_wrapper_refuses_cpu_tensors_and_builds_nothing():
    """A CPU tensor never reaches kernel #7; on ``meta`` (the dry run) the op
    returns the contract's shapes and builds and launches nothing."""
    args = _torch(_inputs(1, 2, 4, 8, 8))
    before = dict(build.launches)
    with pytest.raises(ValueError, match="needs CUDA"):
        twk.wkv6_kernel(*args)
    o, s = tops.wkv6(*[None if a is None else a.to("meta") for a in args])
    assert o.is_meta and s.is_meta and o.shape == args[2].shape
    assert build.launches == before and "wkv6" in before
    assert "wkv6" in build.SOURCES and not build._LOADED
