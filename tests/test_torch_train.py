"""The port's training path against the JAX package's, on the CPU.

`repro_torch.data.synthetic`, the wkv6 gradient (the plain version of
kernel #7b), `train.optimizer`, `train.grad_compress`, `train.train_step`
on the reduced rwkv6-7b, training checkpoints across the packages and
`launch.train`, each against `repro`'s counterpart from numpy-seeded inputs
or a JAX `TrainState` carried over (`carry.train_state_from_reference`).

Tolerances:

* `SyntheticLM` batches, int8 quantization, dequantization and error
  feedback: bit for bit.
* wkv6 gradients (r, k, v, w, u, initial state) against ``jax.vjp`` of
  `repro.kernels.ref.wkv6`: 1e-5 of each gradient's largest magnitude (f32,
  sums in other orders; the two agree within ~2e-7 of it).
* one AdamW step: params, mu and nu within 2 ulps per element; ``lr`` and
  ``grad_norm`` within 1e-6 relative (JAX sums the squares in its own
  order).
* three f32 train steps of the reduced model from one carried state: the
  loss of each step within 1e-5 relative; mu within 1e-2 and nu within
  2e-2 of each leaf's largest value; after step 3 each master within
  1e-6 plus what the two packages' Adam directions, each read from its own
  moments after each step, explain (`_torch_train_bound`: ~lr where a
  gradient near 0 takes its sign from the last bits, a few f32 roundings
  elsewhere).  The sound runs read at most 0.9973 of that bound; the
  port's step-2 masters in place of its step-3 ones read 289 (a last
  update left out), and the test holds that reading above 100.  The
  gradients of layer 0's r and k paths
  are ill-conditioned in f32: the head norm's ``rsqrt(var + 1e-6)`` meets
  near-zero outputs at the first positions (u = 0 and a zero state give
  o_0 = 0), so both packages' f32 gradients lie ~2-3e-3 of the leaf's
  scale from the same model run in f64, the port no further than JAX
  (``test_f32_gradients_are_as_close_to_f64_as_jax``).
* bf16 (against JAX's op-by-op ``scan_layers=False``): the loss within
  1e-3 relative; each gradient within a share of its leaf's largest value
  (`BF16_GRAD_SHARE`): 0.1 for the leaves of layer 0's r and k paths
  (``norm1``, ``w_r``, ``w_k``, ``mu_r``, ``mu_k``) and the embedding
  that feeds them (the f32 ill-conditioning above, at bf16's 2^-8; the
  embedding's gradient adds duplicate tokens in bf16 in both packages, in
  other orders; they read 0.039-0.070), 0.04 for the other 1-D ``mu_*``
  and ``w0`` (at most 0.029) and 0.02 for the rest (at most 0.015).  The
  sigmoid differentiated by autograd's rule instead of JAX's ``logistic``
  rule reads 0.08-0.16 on those six, above 0.1 on five of them, and fails
  (``test_bf16_gradients_need_the_logistic_rule``).  The gradient of every
  leaf that JAX's ``cast_params`` casts comes back rounded to bf16 (the
  cast's transpose) in both packages: every >= 2-D leaf of JAX's tree,
  whose groups stack the layers (G, ...), so each layer's 1-D leaves
  (norms, ``w0``, ``ln_scale``, ``mu_*``) are cast and rounded too; only
  the unstacked 1-D ``final_norm`` is not, in either package.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.train import grad_compress as jgc  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
import _torch_train_bound as tb  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import wkv6 as twk  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.train import grad_compress as tgc  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OPT = dict(warmup_steps=2, total_steps=10)
SEQ, BATCH = 32, 4
# bf16 gradients against JAX's: the largest distance a leaf may read, as a
# share of its largest value (see the module docstring)
BF16_GRAD_SHARE = dict.fromkeys(("embed", "layers.0.norm1", "layers.0.tm.w_r", "layers.0.tm.w_k",
                                  "layers.0.tm.mu_r", "layers.0.tm.mu_k"), 0.1)


def _cfgs(dtype):
    """(JAX config, port config) of reduced rwkv6-7b at ``dtype``; the JAX
    one op by op (``scan_layers=False``) at bf16, as tests/test_torch_rwkv.py."""
    jcfg = dataclasses.replace(jax_get_config("rwkv6_7b", reduced=True), dtype=dtype,
                               scan_layers=dtype == "float32")
    return jcfg, dataclasses.replace(get_config("rwkv6_7b", reduced=True), dtype=dtype)


@pytest.fixture(scope="module")
def jax_state():
    """The JAX trainer's initial state of the reduced model, and its numpy dump."""
    js = jts.init_state(_cfgs("float32")[0], jax.random.key(0))
    return js, jax.tree_util.tree_map(np.asarray, js)


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's jitted f32 train step (``OPT``) by microbatches,
    each compiled once a module."""
    cache = {}

    def get(microbatches=1):
        if microbatches not in cache:
            cache[microbatches] = jax.jit(jts.make_train_step(
                _cfgs("float32")[0], jopt.AdamWConfig(**OPT), microbatches=microbatches))
        return cache[microbatches]

    return get


@pytest.fixture(scope="module")
def jax_grads(jax_state):
    """JAX's loss and gradients (under the port's names) of step 0's batch
    at a compute dtype, each computed once a module."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            jcfg, cfg = _cfgs(dtype)
            jl, jg = _grads_jax(jcfg, jax_state[0].params, _batch(0))
            cache[dtype] = float(jl), _np_tree(jg, cfg)
        return cache[dtype]

    return get


def _batch(step, seq=SEQ, batch=BATCH, vocab=512):
    return SyntheticLM(vocab=vocab, seq_len=seq, global_batch=batch).batch(step)


def _np_tree(tree, cfg):
    """A JAX params-shaped tree as the port's flat names -> numpy."""
    return carry._lm_state(jax.tree_util.tree_map(np.asarray, tree), cfg)


def _scale(a):
    return max(float(np.abs(a).max()), 1e-30)


# -- data ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,host_index,host_count", [(0, 0, 1), (3, 1, 2), (7, 3, 4)])
def test_synthetic_batches_bit_equal(seed, host_index, host_count):
    kw = dict(vocab=512, seq_len=40, global_batch=8, seed=seed, host_index=host_index,
              host_count=host_count)
    mine, ref = SyntheticLM(**kw), JSyntheticLM(**kw)
    assert mine.local_batch == ref.local_batch
    for (s1, b1), (s2, b2) in zip(mine.batches(5), ref.batches(5)):
        assert s1 == s2
        for k in ("tokens", "labels"):
            assert b1[k].dtype == b2[k].dtype and np.array_equal(b1[k], b2[k])
        if s1 == 7:
            break
    with pytest.raises(ValueError, match="divide evenly"):
        SyntheticLM(vocab=8, seq_len=4, global_batch=3, host_count=2)


# -- the wkv6 gradient ----------------------------------------------------------------
def _wkv6_inputs(seed, bh, t, dk, dv, state):
    rng = np.random.default_rng(seed)
    r, k = (rng.normal(size=(bh, t, dk)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(bh, t, dv)).astype(np.float32)
    w = (1.0 / (1.0 + np.exp(-rng.normal(size=(bh, t, dk))))).astype(np.float32)
    u = rng.normal(size=(bh, dk)).astype(np.float32)
    s0 = rng.normal(size=(bh, dk, dv)).astype(np.float32) if state else None
    d_o = rng.normal(size=(bh, t, dv)).astype(np.float32)
    d_s = rng.normal(size=(bh, dk, dv)).astype(np.float32)
    return (r, k, v, w, u, s0), d_o, d_s


@pytest.mark.parametrize("bh,t,dk,dv", [(2, 1, 8, 8), (3, 33, 8, 16), (2, 40, 64, 64),
                                        (2, 17, 5, 63)])
@pytest.mark.parametrize("state", [False, True], ids=["zero-state", "carried-state"])
def test_wkv6_gradient_matches_jax_vjp(bh, t, dk, dv, state):
    """`wkv6_bwd_plain` (kernel #7b's plain version) == ``jax.vjp`` of
    `repro.kernels.ref.wkv6`, for r, k, v, w, u and the initial state, with
    cotangents on both the output and the final state; and `ops.wkv6` on
    CPU tensors differentiates to the same."""
    args, d_o, d_s = _wkv6_inputs(bh * 11 + t, bh, t, dk, dv, state)
    s0 = args[5] if state else np.zeros((bh, dk, dv), np.float32)
    _, vjp = jax.vjp(lambda *a: jref.wkv6(*a), *(jnp.asarray(x) for x in (*args[:5], s0)))
    want = vjp((jnp.asarray(d_o), jnp.asarray(d_s)))
    targs = [None if x is None else torch.from_numpy(x) for x in args]
    got = twk.wkv6_bwd_plain(*targs, torch.from_numpy(d_o), torch.from_numpy(d_s))
    for name, g, w in zip(("r", "k", "v", "w", "u", "state"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * _scale(w), err_msg=name)
    xs = [torch.from_numpy(x).requires_grad_() for x in (*args[:5], s0)]
    o, s = tops.wkv6(*xs)
    auto = torch.autograd.grad((o, s), xs, (torch.from_numpy(d_o), torch.from_numpy(d_s)))
    for a, g in zip(auto, got):
        assert torch.equal(a, g)


def test_wkv6_gradient_without_a_final_state_cotangent():
    args, d_o, _ = _wkv6_inputs(5, 2, 9, 8, 8, False)
    targs = [None if x is None else torch.from_numpy(x) for x in args]
    got = twk.wkv6_bwd_plain(*targs, torch.from_numpy(d_o), None)
    _, vjp = jax.vjp(lambda *a: jref.wkv6(*a)[0], *(jnp.asarray(x) for x in args[:5]))
    for g, w in zip(got[:5], vjp(jnp.asarray(d_o))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * _scale(np.asarray(w)))
    with pytest.raises(ValueError, match="needs CUDA"):
        twk.wkv6_bwd_kernel(*targs, torch.from_numpy(d_o), None)


# -- AdamW ------------------------------------------------------------------------------
def _adam_case(seed, grad_scale):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": (13,), "c": (3, 4, 2)}
    p = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    g = {n: (rng.normal(size=s) * grad_scale).astype(np.float32) for n, s in shapes.items()}
    m = {n: (rng.normal(size=s) * 0.01).astype(np.float32) for n, s in shapes.items()}
    v = {n: np.abs(rng.normal(size=s) * 1e-4).astype(np.float32) for n, s in shapes.items()}
    return p, g, m, v


@pytest.mark.parametrize("cfg_kw,count,grad_scale", [
    (dict(), 5, 0.01),                                             # warmup, no clip
    (dict(lr=1e-2, grad_clip=1.0, warmup_steps=10, total_steps=100), 0, 100.0),  # clip
    (dict(warmup_steps=3, total_steps=20), 9, 1.0),               # cosine decay, clip
    (dict(grad_clip=0.0, weight_decay=0.1, warmup_steps=1), 40, 0.5),  # no clipping
])
def test_adamw_step_matches_jax(cfg_kw, count, grad_scale):
    p, g, m, v = _adam_case(count + 3, grad_scale)
    jcfg, tcfg = jopt.AdamWConfig(**cfg_kw), topt.AdamWConfig(**cfg_kw)
    jstate = jopt.AdamWState({n: jnp.asarray(x) for n, x in m.items()},
                             {n: jnp.asarray(x) for n, x in v.items()},
                             jnp.asarray(count, jnp.int32))
    jp, js, jmet = jopt.apply(jcfg, {n: jnp.asarray(x) for n, x in p.items()},
                              {n: jnp.asarray(x) for n, x in g.items()}, jstate)

    def t(d):
        return {n: torch.from_numpy(x.copy()) for n, x in sorted(d.items())}

    tstate = topt.AdamWState(t(m), t(v), torch.tensor(count, dtype=torch.int32))
    tp, ts, tmet = topt.apply(tcfg, t(p), t(g), tstate)
    for n in p:
        np.testing.assert_array_max_ulp(tp[n].numpy(), np.asarray(jp[n]), maxulp=2)
        np.testing.assert_array_max_ulp(ts.mu[n].numpy(), np.asarray(js.mu[n]), maxulp=2)
        np.testing.assert_array_max_ulp(ts.nu[n].numpy(), np.asarray(js.nu[n]), maxulp=2)
    assert int(ts.count) == int(js.count) == count + 1 and ts.count.dtype == torch.int32
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-6)
    if cfg_kw.get("grad_clip", 1.0) and grad_scale == 100.0:
        assert float(tmet["grad_norm"]) > 100.0  # clipped (tests/test_substrate.py)
        assert float(tmet["lr"]) == pytest.approx(1e-2 / 10, rel=1e-4)  # warmup step 1


def test_schedule_and_init_match_jax():
    cfg_kw = dict(lr=1e-3, warmup_steps=7, total_steps=50, min_ratio=0.2)
    for step in (0, 1, 6, 7, 8, 30, 50, 60):
        want = float(jopt.schedule(jopt.AdamWConfig(**cfg_kw), jnp.asarray(step)))
        got = topt.schedule(topt.AdamWConfig(**cfg_kw), torch.tensor(step))
        np.testing.assert_allclose(float(got), want, rtol=1e-6)
        assert got.dtype == torch.float32
    st = topt.init({"x": torch.ones(3, 2), "y": torch.ones(4)})
    assert all(float(x.abs().sum()) == 0 and x.dtype == torch.float32
               for x in (*st.mu.values(), *st.nu.values()))
    assert st.count.dtype == torch.int32 and int(st.count) == 0


# -- int8 compression -------------------------------------------------------------------
@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 300.0)])
def test_int8_compression_bit_equal(seed, scale):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(257,)) * scale).astype(np.float32)
    x[:4] = [0.5, -0.5, 1.5, 2.5]  # ties: both round half to even
    err = (rng.normal(size=(257,)) * scale * 1e-2).astype(np.float32)
    q, s = tgc.quantize_int8(torch.from_numpy(x))
    jq, js = jgc.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert np.array_equal(tgc.dequantize(q, s).numpy(), np.asarray(jgc.dequantize(jq, js)))
    tq, tsc, terr = tgc.compress_with_feedback(torch.from_numpy(x), torch.from_numpy(err))
    for a, b in zip((tq, tsc, terr), jgc.compress_with_feedback(jnp.asarray(x), jnp.asarray(err))):
        assert np.array_equal(a.numpy(), np.asarray(b))
    half = torch.tensor([0.5, 1.5, 2.5, -0.5])
    assert torch.round(half).tolist() == np.asarray(jnp.round(half.numpy())).tolist()


# -- the train step ---------------------------------------------------------------------
@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_f32_train_steps_match_jax(jax_state, jax_steps, microbatches):
    _, cfg = _cfgs("float32")
    js = jax_state[0]
    ts = carry.train_state_from_reference(jax_state[1], cfg, "cpu")
    jstep = jax_steps(microbatches)
    tstep = tts.make_train_step(cfg, topt.AdamWConfig(**OPT), microbatches=microbatches)
    bound = {}
    for step in range(3):
        b = _batch(step)
        before = _np_port(ts.params)
        js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tmet = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=1e-3)
        bound = _grow_bound(bound, float(tmet["lr"]), step + 1, before, ts, js, cfg)
    assert int(ts.step) == int(js.step) == 3 and int(ts.opt.count) == 3
    for name, mine, ref, tol in (("mu", ts.opt.mu, js.opt.mu, 1e-2),
                                 ("nu", ts.opt.nu, js.opt.nu, 2e-2)):
        ref = _np_tree(ref, cfg)
        assert list(mine) == [n for n, _ in ttf.LM(cfg, None, "meta").named_parameters()]
        for n, a in mine.items():
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), ref[n], rtol=0, atol=tol * _scale(ref[n]),
                                       err_msg=f"{name} {n}")
    _assert_masters(ts, js, cfg, bound, skipped=before)


def _np_port(tree):
    return {n: x.detach().numpy().copy() for n, x in tree.items()}


def _grow_bound(bound, lr, count, before, ts, js, cfg):
    """`_torch_train_bound.grow` for one step of both packages: ``before``
    the port's masters before it, ``ts`` and ``js`` the states after it."""
    return tb.grow(bound, topt.AdamWConfig(**OPT), lr, count, before,
                   (_np_port(ts.opt.mu), _np_port(ts.opt.nu)),
                   (_np_tree(js.opt.mu, cfg), _np_tree(js.opt.nu, cfg)))


def _assert_masters(ts, js, cfg, bound, skipped):
    """Every f32 master within ``bound`` (reading at most 1), and the port's
    masters before the last step (``skipped``) far outside it."""
    ref = _np_tree(js.params, cfg)
    assert all(a.dtype == torch.float32 for a in ts.params.values())
    assert tb.reading(_np_port(ts.params), ref, bound) <= 1.0
    assert tb.reading(skipped, ref, bound) > 100.0


def _grads_port(cfg, params, batch):
    template = ttf.LM(cfg, None, "meta")
    leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
    loss = tm.forward_loss(template, cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                           params=tts.cast_params(cfg, leaves))
    return loss, dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def _grads_jax(jcfg, params, batch):
    def loss_fn(p):
        p = jax.tree_util.tree_map(
            lambda x: x.astype(jcfg.compute_dtype) if x.ndim >= 2 else x, p)
        return jm.forward_loss(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})

    return jax.value_and_grad(loss_fn)(params)


def _bf16_share(name):
    leaf = name.rsplit(".", 1)[-1]
    return BF16_GRAD_SHARE.get(name, 0.04 if leaf.startswith("mu_") or leaf == "w0" else 0.02)


def _bf16_exact(a):
    a = np.array(a)
    return bool(np.array_equal(a, torch.from_numpy(a).to(torch.bfloat16).float().numpy()))


def _gradient_readings(jax_state, jax_grads, dtype):
    """(port loss, JAX loss, each leaf's largest distance from JAX's
    gradient over the leaf's largest value, the port's and JAX's gradients)
    of one step's batch, with respect to the f32 masters."""
    _, cfg = _cfgs(dtype)
    ts = carry.train_state_from_reference(jax_state[1], cfg, "cpu")
    jl, jg = jax_grads(dtype)
    tl, tg = _grads_port(cfg, ts.params, _batch(0))
    for n, g in tg.items():
        assert g.dtype == torch.float32 and g.shape == ts.params[n].shape
    read = {n: float(np.abs(g.numpy() - jg[n]).max()) / _scale(jg[n]) for n, g in tg.items()}
    return tl.item(), jl, read, tg, jg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_match_jax(jax_state, jax_grads, dtype):
    """One step's loss and f32 gradients with respect to the masters (the
    cast and its gradient as JAX's ``cast_params``); the gradients' dtype
    and every leaf's shape; in bf16, the gradient of every leaf that JAX's
    ``cast_params`` casts rounded to bf16 (the cast's transpose) in both
    packages: each layer's leaves, the 1-D ones (norms, ``mu_*``, ``w0``,
    ``ln_scale``) among them, as JAX's tree stacks them (G, d); and the
    1-D ``final_norm``, which neither casts, not rounded in either."""
    tl, jl, read, tg, jg = _gradient_readings(jax_state, jax_grads, dtype)
    np.testing.assert_allclose(tl, jl, rtol=1e-5 if dtype == "float32" else 1e-3)
    cast = tts.cast_params(_cfgs(dtype)[1], tg)
    for n, r in read.items():
        assert r <= (5e-3 if dtype == "float32" else _bf16_share(n)), (n, r)
        if dtype == "bfloat16":
            rounded = cast[n].dtype == torch.bfloat16
            assert rounded == (n != "final_norm"), n
            assert _bf16_exact(tg[n].numpy()) == _bf16_exact(jg[n]) == rounded, n


def test_bf16_gradients_need_the_logistic_rule(jax_state, jax_grads, monkeypatch):
    """With the sigmoid differentiated by autograd's rule on
    ``1 / (1 + exp(-x))`` (the port's first form) in place of JAX's
    ``logistic`` rule, the bf16 gradients leave their bounds."""
    from repro_torch.models import rwkv6 as trwkv

    monkeypatch.setattr(trwkv, "sigmoid", lambda x: 1.0 / (1.0 + torch.exp(-x)))
    _, _, read, _, _ = _gradient_readings(jax_state, jax_grads, "bfloat16")
    assert [n for n, r in read.items() if r > _bf16_share(n)]


def test_f32_gradients_are_as_close_to_f64_as_jax(jax_state, jax_grads, monkeypatch):
    """The f32 gradients' spread is the model's conditioning, not the port:
    against the port's own model run in f64 (its f32 casts rebound to f64)
    the port's f32 gradients are within 1.5x of the JAX package's distance
    (plus 1e-6 of the scale) on every leaf."""
    _, cfg = _cfgs("float32")
    ts = carry.train_state_from_reference(jax_state[1], cfg, "cpu")
    b = _batch(0)
    _, jg = jax_grads("float32")
    _, g32 = _grads_port(cfg, ts.params, b)
    monkeypatch.setattr(torch, "float32", torch.float64)
    _, g64 = _grads_port(dataclasses.replace(cfg, dtype="float64"),
                         {n: p.double() for n, p in ts.params.items()}, b)
    monkeypatch.undo()
    for n, g in g64.items():
        g = g.numpy()
        port = np.abs(g32[n].numpy() - g).max()
        ref = np.abs(jg[n] - g).max()
        assert port <= 1.5 * ref + 1e-6 * _scale(g), n


def test_remat_recomputes_the_same_gradients(jax_state):
    """``remat=True`` (one checkpoint a layer) gives the gradients of
    ``remat=False`` bit for bit on the CPU; the layers run twice."""
    _, cfg = _cfgs("float32")
    ts = carry.train_state_from_reference(jax_state[1], cfg, "cpu")
    b = _batch(1, seq=12, batch=2)
    calls = []
    orig = tops.wkv6

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    from repro_torch.models import rwkv6 as trwkv
    trwkv.kops.wkv6 = counted
    try:
        l0, g0 = _grads_port(cfg, ts.params, b)
        n0 = len(calls)
        l1, g1 = _grads_port(dataclasses.replace(cfg, remat=True), ts.params, b)
    finally:
        trwkv.kops.wkv6 = orig
    assert n0 == cfg.n_layers and len(calls) - n0 == 2 * cfg.n_layers
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)


def test_serving_model_and_training_tensors_give_one_loss():
    """`forward_loss` of a serving `LM` (its own bf16 tensors) equals the
    loss of the same seed's f32 masters cast as the train step casts them."""
    _, cfg = _cfgs("bfloat16")
    lm = tm.init_params(cfg, 3, device="cpu")
    state = tts.init_state(cfg, 3, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch(2, seq=16, batch=2).items()}
    with torch.no_grad():
        served = tm.forward_loss(lm, cfg, b)
        trained = tm.forward_loss(ttf.LM(cfg, None, "meta"), cfg, b,
                                  params=tts.cast_params(cfg, state.params))
    assert torch.equal(served, trained)
    assert {n: p.dtype for n, p in state.params.items()} == dict.fromkeys(
        state.params, torch.float32)


def test_train_refusals_by_name():
    """An unknown ``remat_policy`` is refused by name (``"dots"`` runs:
    tests/test_torch_dryrun.py); ``cast_shardings`` runs
    on masters placed as DTensors (tests/test_torch_sharded_lm.py) and asks
    for them by name otherwise."""
    _, cfg = _cfgs("float32")
    state = tts.init_state(cfg, 0, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch(0, seq=8, batch=2).items()}
    specs = {n: (None,) * p.dim() for n, p in state.params.items()}
    with pytest.raises(ValueError, match="place_state"):
        tts.make_train_step(cfg, topt.AdamWConfig(), cast_shardings=specs)(state, b)
    step = tts.make_train_step(dataclasses.replace(cfg, remat=True, remat_policy="offload"),
                               topt.AdamWConfig())
    with pytest.raises(ValueError, match="remat_policy 'offload'"):
        step(state, b)
    with pytest.raises(ValueError, match="microbatches"):
        tts.make_train_step(cfg, topt.AdamWConfig(), microbatches=3)(state, b)


# -- checkpoints across the packages --------------------------------------------------
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_training_checkpoint_resumes_across_packages(jax_state, jax_steps, tmp_path,
                                                    direction):
    """Two f32 steps in one package, a checkpoint at step 2, step 3 in the
    other: equal to three steps in the first (the tolerances of the train
    step test), and the checkpoint's names JAX's."""
    _, cfg = _cfgs("float32")
    jstep = jax_steps()
    tstep = tts.make_train_step(cfg, topt.AdamWConfig(**OPT))
    batches = [_batch(s) for s in range(3)]
    js = jax_state[0]
    ts = carry.train_state_from_reference(jax_state[1], cfg, "cpu")
    for b in batches[:2]:
        if direction == "jax_to_port":
            js, _ = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        else:
            ts, _ = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
    ckdir = str(tmp_path / "ck")
    if direction == "jax_to_port":
        JManager(ckdir).save(2, js)
        like = tts.init_state(cfg, 0, device="cpu")
        ts, meta = CheckpointManager(ckdir).restore_latest(like)
        assert int(ts.step) == 2 and int(ts.opt.count) == 2 and meta["step"] == 2
        before = _np_port(ts.params)
        ts, met = tstep(ts, {k: torch.from_numpy(v) for k, v in batches[2].items()})
        js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in batches[2].items()})
    else:
        CheckpointManager(ckdir).save(2, ts)
        before = _np_port(ts.params)
        names = set(np.load(os.path.join(ckdir, "step_0000000002", "arrays_p0.npz")).files)
        from repro.checkpoint.manager import _flatten
        assert names == set(_flatten(js))
        js, meta = JManager(ckdir).restore_latest(jax_state[0])
        assert int(js.step) == 2 and meta["step"] == 2
        js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in batches[2].items()})
        ts, met = tstep(ts, {k: torch.from_numpy(v) for k, v in batches[2].items()})
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)
    bound = _grow_bound({}, float(met["lr"]), 3, before, ts, js, cfg)
    _assert_masters(ts, js, cfg, bound, skipped=before)


def test_training_checkpoint_round_trips_in_the_port(tmp_path):
    _, cfg = _cfgs("float32")
    state = tts.init_state(cfg, 5, device="cpu")
    state.step = torch.tensor(7, dtype=torch.int32)
    state.opt.count = torch.tensor(7, dtype=torch.int32)
    state.opt.mu = {n: p * 0.5 for n, p in state.params.items()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, state)
    back, meta = mgr.restore(7, tts.init_state(cfg, 0, device="cpu"))
    assert meta["step"] == 7 and int(back.step) == 7 and back.step.device.type == "cpu"
    for tree in ("params",):
        assert all(torch.equal(getattr(back, tree)[n], getattr(state, tree)[n])
                   for n in state.params)
    assert all(torch.equal(back.opt.mu[n], state.opt.mu[n]) for n in state.params)
    arrays = np.load(tmp_path / "step_0000000007" / "arrays_p0.npz")
    w = arrays[".params['groups']['0_rwkv']['tm']['w_r']"]
    assert w.shape == (cfg.n_layers, cfg.d_model, cfg.d_model)
    assert arrays[".step"].dtype == np.int32 and arrays[".opt.count"].dtype == np.int32


# -- the CLI -----------------------------------------------------------------------------
def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _train(*args):
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--smoke",
                          *args], env=_env(), capture_output=True, text=True, timeout=300)
    return out


def test_train_cli_on_cpu_resumes_equal_to_an_uninterrupted_run(tmp_path):
    """20 steps with a checkpoint every 10; a second directory holding only
    the step-10 checkpoint resumes there and ends at the same step-20 loss
    line and the same checkpoint, bit for bit."""
    full, part = tmp_path / "full", tmp_path / "part"
    args = ("--steps", "20", "--ckpt-every", "10", "--seq", "16", "--batch", "4",
            "--device", "cpu")
    out = _train(*args, "--ckpt-dir", str(full))
    assert out.returncode == 0, out.stderr
    lines = [line.split(" loss ")[1].split()[0] for line in out.stdout.splitlines()
             if line.startswith("step")]
    assert len(lines) == 2 and "it/s" in out.stdout
    part.mkdir()
    shutil.copytree(full / "step_0000000010", part / "step_0000000010")
    out2 = _train(*args, "--ckpt-dir", str(part))
    assert out2.returncode == 0, out2.stderr
    assert "[restart] resumed at step 10" in out2.stdout
    resumed = [line.split(" loss ")[1].split()[0] for line in out2.stdout.splitlines()
               if line.startswith("step")]
    assert resumed == lines[1:]
    a = np.load(full / "step_0000000020" / "arrays_p0.npz")
    b = np.load(part / "step_0000000020" / "arrays_p0.npz")
    assert sorted(a.files) == sorted(b.files)
    assert all(np.array_equal(a[k], b[k]) for k in a.files)


def test_train_cli_refuses_a_missing_card_and_unported_archs():
    out = _train("--arch", "whisper_medium", "--device", "cpu", "--steps", "1")
    assert out.returncode != 0 and "whisper_medium: the encdec family needs frames" in out.stderr
    if not torch.cuda.is_available():
        out = _train("--steps", "1")
        assert out.returncode != 0 and "CUDA was requested" in out.stderr
