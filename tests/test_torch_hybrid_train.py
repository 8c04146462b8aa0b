"""The hybrid family's training loss and gradients against the JAX
package's, on the CPU.

`forward_loss` of the reduced ``recurrentgemma_9b`` (one group of rglru,
rglru, attn_local and a 2-layer rglru tail; the RG-LRU's associative scan
differentiated by autograd) and its f32 gradients with respect to the
carried f32 masters through `repro_torch.train.train_step.cast_params`,
against ``jax.value_and_grad`` through JAX's ``cast_params``
(`_torch_lm_parity`), in f32 (JAX jitted) and bf16 (JAX op by op).  Kept
apart from tests/test_torch_hybrid.py so that each file stays near a
minute on the CPU: JAX compiles the bf16 backward op by op.

Tolerances: the loss within 1e-5 relative (f32) / 1e-3 (bf16); each
leaf's gradient within 1e-5 of its largest value in f32 and within
``BF16_GRAD_SHARE`` of it in bf16 (the readings: f32 at most 3.3e-6, bf16
at most 0.027, on ``conv_b``, ``w_gmlp`` and ``lam``, where an exp ulp
in the RG-LRU's ``a`` flips a bf16 rounding); in bf16 each leaf's
gradient bf16-exact in both packages alike: every leaf of the group layers (JAX's ``cast_params`` casts their
stacked (G, ...) leaves, the 1-D ones included), the tail's matrices and
its ``conv_b`` (cast at use), and not the tail's norms, biases and
``lam`` or ``final_norm``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_lm_parity as lm  # noqa: E402

ARCH = "recurrentgemma_9b"
BF16_GRAD_SHARE = 0.05


@pytest.fixture(scope="module")
def jax_params():
    return lm.jax_init(ARCH)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_match_jax(jax_params, dtype):
    jcfg, cfg = lm.cfgs(ARCH, dtype)
    data = lm.batch(1, 2, 16)
    port = lm.port_loss_and_grads(cfg, jax_params[1], data)
    ref = lm.jax_loss_and_grads(jcfg, cfg, jax_params[0], data)
    lm.check_gradients(cfg, port, ref, f32_share=1e-5, bf16_share=BF16_GRAD_SHARE)
    if dtype == "bfloat16":
        grads = port[1]
        # the tail's 1-D f32 leaves are neither cast nor rounded; conv_b is cast at use
        assert not lm.bf16_exact(grads["layers.3.norm1"].numpy())
        assert not lm.bf16_exact(grads["layers.4.mix.lam"].numpy())
        assert lm.bf16_exact(grads["layers.4.mix.conv_b"].numpy())
        assert lm.bf16_exact(grads["layers.0.mix.lam"].numpy())
        assert np.isfinite(port[0])
