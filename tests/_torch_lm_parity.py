"""Helpers shared by the LM families' parity tests against the JAX package
(tests/test_torch_hybrid*.py, tests/test_torch_moe*.py,
tests/test_torch_vlm*.py, tests/test_torch_encdec*.py): the two packages'
configs of a reduced arch, the JAX weights, and one batch's loss and f32
gradients with respect to the f32 masters through each package's
``cast_params``.

JAX's ``cast_params`` casts every >= 2-D leaf of its tree, whose groups
(and whisper's encoder and decoder) stack the layers (G, ...): a stacked
layer's 1-D leaves are cast too, the tail's and the top level's are not.  A cast leaf's gradient comes back
rounded to the compute dtype (the cast's transpose), and so does that of a
leaf the model casts at use (``conv_b``).  `check_gradients` holds the
port to the same: each leaf's gradient bf16-exact in the port exactly where
it is in JAX, and always where ``cast_params`` cast it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as jm
from repro_torch import carry
from repro_torch.configs import get_config
from repro_torch.models import model as tm
from repro_torch.train import train_step as tts


def cfgs(arch, dtype, **kw):
    """(JAX config, port config) of ``arch`` reduced at ``dtype``; the JAX
    one op by op (``scan_layers=False``) at bf16, where XLA would otherwise
    fuse bf16 chains in f32 inside the scanned layer body."""
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True), dtype=dtype,
                               scan_layers=dtype == "float32", **kw)
    return jcfg, dataclasses.replace(get_config(arch, reduced=True), dtype=dtype, **kw)


def jax_init(arch):
    """The reduced arch's JAX weights (f32 masters, ``jax.random.key(0)``,
    ``init_params`` jitted: one compile) and their numpy dump."""
    params = jax.jit(jm.init_params, static_argnums=0)(jax_get_config(arch, reduced=True),
                                                        jax.random.key(0))
    return params, jax.tree_util.tree_map(np.asarray, params)


def set_gates(params_np: dict, value: float):
    """A copy of the numpy tree with every cross layer's ``gate`` set to
    ``value`` (JAX makes them 0, so a fresh vlm's cross layers add
    exactly 0), and the same as JAX arrays: (JAX tree, numpy tree)."""
    def walk(t):
        if isinstance(t, dict):
            return {k: (np.full_like(v, value) if k == "gate" else walk(v)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return np.array(t)

    out = walk(params_np)
    return jax.tree_util.tree_map(jnp.asarray, out), out


def np32(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def batch(seed, b, s, vocab=512):
    t = tokens(seed, b, s, vocab)
    return {"tokens": t, "labels": np.roll(t, -1, axis=1)}


def scale(a):
    return max(float(np.abs(a).max()), 1e-30)


def bf16_exact(a) -> bool:
    a = np.array(a, dtype=np.float32)
    return bool(np.array_equal(a, torch.from_numpy(a).to(torch.bfloat16).float().numpy()))


def jax_cast(params, cfg) -> set:
    """The port's names of the leaves JAX's ``cast_params`` casts: those
    that are >= 2-D in JAX's tree (its stacked layers' 1-D leaves too)."""
    flags = jax.tree_util.tree_map(lambda x: np.full(np.shape(x), np.ndim(x) >= 2), params)
    return {n for n, a in carry._lm_state(flags, cfg).items() if np.asarray(a).all()}


def jax_loss_and_grads(jcfg, cfg, params, data):
    """JAX's loss and gradients (under the port's names) of ``data`` with
    respect to the f32 masters through JAX's ``cast_params`` (jitted in
    f32, op by op in bf16), and the names of the leaves it casts."""
    def loss_fn(p):
        p = jax.tree_util.tree_map(
            lambda x: x.astype(jcfg.compute_dtype) if x.ndim >= 2 else x, p)
        return jm.forward_loss(p, jcfg, {k: jnp.asarray(v) for k, v in data.items()})

    fn = jax.value_and_grad(loss_fn)
    if jcfg.dtype == "float32":
        fn = jax.jit(fn)
    loss, grads = fn(params)
    return (float(loss), carry._lm_state(jax.tree_util.tree_map(np.asarray, grads), cfg),
            jax_cast(params, cfg))


def port_loss_and_grads(cfg, params_np, data):
    """The port's loss, its f32 gradients with respect to the masters and
    the cast tensors (`repro_torch.train.train_step.cast_params`)."""
    masters = carry._lm_state(params_np, cfg)
    leaves = {n: torch.from_numpy(np.array(a)).requires_grad_() for n, a in masters.items()}
    cast = tts.cast_params(cfg, leaves)
    loss = tm.forward_loss(tm.model_class(cfg)(cfg, None, "meta"), cfg,
                           {k: torch.from_numpy(v) for k, v in data.items()}, params=cast)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return loss.item(), grads, cast


def check_gradients(cfg, port, ref, *, f32_share: float, bf16_share: float) -> dict:
    """Holds the port's (loss, grads, cast) against JAX's (loss, grads, the
    leaves it casts): the
    loss within 1e-5 relative (f32) or 1e-3 (bf16); each leaf's largest
    distance within ``f32_share`` / ``bf16_share`` of its largest value;
    in bf16 each leaf bf16-exact in both packages alike, and wherever
    ``cast_params`` cast it, which must be where JAX's does (every leaf of
    a stacked layer, the tail's >= 2-D ones).  Returns each leaf's reading."""
    loss, grads, cast = port
    jl, jg, jcast = ref
    bf16 = cfg.dtype == "bfloat16"
    np.testing.assert_allclose(loss, jl, rtol=1e-3 if bf16 else 1e-5)
    assert set(grads) == set(jg)
    reads = {}
    for n, g in grads.items():
        assert g.dtype == torch.float32 and g.shape == tuple(jg[n].shape), n
        reads[n] = float(np.abs(g.numpy() - jg[n]).max()) / scale(jg[n])
        assert reads[n] <= (bf16_share if bf16 else f32_share), (n, reads[n])
        if bf16:
            rounded = cast[n].dtype == torch.bfloat16
            assert rounded == (n in jcast), n
            assert bf16_exact(g.numpy()) == bf16_exact(jg[n]), n
            assert bf16_exact(g.numpy()) or not rounded, n
    return reads
