"""The moe family's training loss and gradients against the JAX package's,
on the CPU.

`forward_loss` of the reduced ``mixtral_8x22b`` and ``qwen3_moe_235b``
(the router's softmax and top-k gates, the gathers and the ordered
combine differentiated by autograd) and its f32 gradients with respect to
the carried f32 masters through `repro_torch.train.train_step.cast_params`,
against ``jax.value_and_grad`` through JAX's ``cast_params``
(`_torch_lm_parity`), in f32 (JAX jitted) and bf16 (JAX op by op).  Kept
apart from tests/test_torch_moe.py so that each file stays near a minute on
the CPU.

Tolerances: the loss within 1e-5 relative (f32) / 1e-3 (bf16); each
leaf's gradient within 1e-5 of its largest value in f32 and within
``BF16_GRAD_SHARE`` of it in bf16 (the readings: f32 at most 1.3e-6; bf16
at most 0.017, on the experts' ``w_gate``: the bf16 backward GEMMs round
their cotangents after summing in other orders); in bf16 every leaf's
gradient bf16-exact in both packages alike (both reduced configs are one
group of two layers and no tail, so JAX's ``cast_params`` casts every
layer leaf, the router and the norms included; ``final_norm`` is not).
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_lm_parity as lm  # noqa: E402

BF16_GRAD_SHARE = 0.04


@pytest.fixture(scope="module")
def jax_params():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = lm.jax_init(arch)
        return cache[arch]

    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mixtral_8x22b", "qwen3_moe_235b"])
def test_loss_and_gradients_match_jax(jax_params, arch, dtype):
    jcfg, cfg = lm.cfgs(arch, dtype)
    data = lm.batch(1, 2, 16)
    port = lm.port_loss_and_grads(cfg, jax_params(arch)[1], data)
    ref = lm.jax_loss_and_grads(jcfg, cfg, jax_params(arch)[0], data)
    lm.check_gradients(cfg, port, ref, f32_share=1e-5, bf16_share=BF16_GRAD_SHARE)
    if dtype == "bfloat16":
        grads = port[1]
        assert lm.bf16_exact(grads["layers.1.moe.router"].numpy())
        assert lm.bf16_exact(grads["layers.0.norm1"].numpy())
        assert not lm.bf16_exact(grads["final_norm"].numpy())
