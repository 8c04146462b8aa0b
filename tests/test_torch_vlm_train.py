"""The vlm family's training loss and gradients against the JAX package's,
on the CPU.

`forward_loss` of the reduced ``llama32_vision_11b`` (one group of attn,
attn, attn, cross, attn) with every gate at 1.0 (JAX makes them 0, and a
zero gate passes no gradient to the cross layer's attention weights: only
the gate itself would get one), over an image context ``img``
and over none (the cross layer then attends over its own input), and its
f32 gradients with respect to the carried f32 masters through
`repro_torch.train.train_step.cast_params`, against ``jax.value_and_grad``
through JAX's ``cast_params`` (`_torch_lm_parity`), in f32 (JAX jitted)
and bf16 (JAX op by op).  A train step of the port from JAX's masters
then matches JAX's.  Kept apart from tests/test_torch_vlm.py so that each
file stays well under a minute on the CPU.

Tolerances: the loss within 1e-5 relative (f32) / 1e-3 (bf16); each
leaf's gradient within 1e-5 of its largest value in f32 and within
``BF16_GRAD_SHARE`` of it in bf16; in bf16 each leaf's gradient
bf16-exact in both packages alike, and rounded exactly where JAX's
``cast_params`` casts it: every leaf of the group (JAX stacks it, so the
norms (G, d) and the gate (G, 1) are cast), not ``final_norm``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
import _torch_lm_parity as lm  # noqa: E402
import _torch_train_bound as tb  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402

ARCH = "llama32_vision_11b"
BF16_GRAD_SHARE = 0.05


@pytest.fixture(scope="module")
def weights():
    return lm.set_gates(lm.jax_init(ARCH)[1], 1.0)


def _data(img: bool):
    data = lm.batch(1, 2, 16)
    if img:
        data["img"] = np.random.default_rng(2).normal(size=(2, 8, 64)).astype(np.float32)
    return data


@pytest.mark.parametrize("dtype,img", [("float32", True), ("float32", False),
                                       ("bfloat16", True)],
                         ids=["float32-img", "float32-no-img", "bfloat16-img"])
def test_loss_and_gradients_match_jax(weights, dtype, img):
    jcfg, cfg = lm.cfgs(ARCH, dtype)
    data = _data(img)
    port = lm.port_loss_and_grads(cfg, weights[1], data)
    ref = lm.jax_loss_and_grads(jcfg, cfg, weights[0], data)
    reads = lm.check_gradients(cfg, port, ref, f32_share=1e-5, bf16_share=BF16_GRAD_SHARE)
    grads = port[1]
    # the gate and the cross layer's weights get gradients of their own
    assert float(grads["layers.3.attn.gate"].abs().max()) > 0
    assert float(grads["layers.3.attn.wk"].abs().max()) > 0
    assert set(reads) == set(grads)
    if dtype == "bfloat16":
        assert lm.bf16_exact(grads["layers.3.attn.gate"].numpy())
        assert lm.bf16_exact(grads["layers.0.norm1"].numpy())
        assert not lm.bf16_exact(grads["final_norm"].numpy())


def test_one_f32_train_step_matches_jax(weights):
    """One AdamW step of the reduced vlm over an image from one carried JAX
    `TrainState`: the loss, ``lr``, ``grad_norm`` and the masters (the gate
    too), each master within what the two runs' Adam directions explain
    (`_torch_train_bound`)."""
    opt = dict(warmup_steps=2, total_steps=10)
    jcfg, cfg = lm.cfgs(ARCH, "float32")
    params = weights[0]
    js = jts.TrainState(params=params, opt=jopt.init(params), step=jnp.zeros((), jnp.int32))
    ts = carry.train_state_from_reference(jax.tree_util.tree_map(np.asarray, js), cfg, "cpu")
    data = _data(True)
    before = {n: x.numpy().copy() for n, x in ts.params.items()}
    js, jmet = jax.jit(jts.make_train_step(jcfg, jopt.AdamWConfig(**opt)))(
        js, {k: jnp.asarray(v) for k, v in data.items()})
    ts, tmet = tts.make_train_step(cfg, topt.AdamWConfig(**opt))(
        ts, {k: torch.from_numpy(v) for k, v in data.items()})
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-3)

    def port(tree):
        return {n: x.numpy() for n, x in tree.items()}

    def ref(tree):
        return carry._lm_state(jax.tree_util.tree_map(np.asarray, tree), cfg)

    bound = tb.grow({}, topt.AdamWConfig(**opt), float(tmet["lr"]), 1, before,
                    (port(ts.opt.mu), port(ts.opt.nu)), (ref(js.opt.mu), ref(js.opt.nu)))
    assert set(ts.params) == set(ref(js.params))
    assert tb.reading(port(ts.params), ref(js.params), bound) <= 1.0
    assert tb.reading(before, ref(js.params), bound) > 100.0
    assert float(ts.params["layers.3.attn.gate"][0]) != 1.0
