"""Training checkpoints of every LM family in the JAX package's names, on
the CPU.

A training state's leaves take JAX's ``keystr`` names with the layers
stacked where JAX's tree stacks them (`TrainState.jax_paths`,
`repro_torch.train.train_step.jax_layer_paths`): a group of the layer plan
at an index (the vlm's ``0_attn`` ... ``3_cross``, recurrentgemma's
``0_rglru``, ``1_rglru``, ``2_attn_local``, mixtral's ``0_attn_moe``),
recurrentgemma's ``['tail'][t]``, whisper's ``['enc']`` / ``['dec']``
stacks and ``enc_norm``.  JAX's manager must restore the port's
checkpoint into JAX's template leaf for leaf, and the port's into the
port's.  (The dense and rwkv archs: tests/test_torch_dense.py,
tests/test_torch_train.py.)
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.checkpoint.manager import _flatten as jflatten  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
import _torch_lm_parity as lm  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402


@pytest.mark.parametrize("arch", ["llama32_vision_11b", "recurrentgemma_9b", "mixtral_8x22b",
                                  "whisper_medium"])
def test_training_checkpoints_take_jax_s_names(arch, tmp_path):
    cfg = lm.cfgs(arch, "float32")[1]
    params = lm.jax_init(arch)[0]
    js = jts.TrainState(params=params, opt=jopt.init(params), step=jnp.zeros((), jnp.int32))
    ts = tts.init_state(cfg, 0, device="cpu")
    ckdir = str(tmp_path / "ck")
    CheckpointManager(ckdir).save(3, ts)
    restored, meta = JManager(ckdir).restore_latest(js)
    assert meta["step"] == 3 and set(jflatten(restored)) == set(jflatten(js))
    mine = carry._lm_state(jax.tree_util.tree_map(np.asarray, restored.params), cfg)
    assert set(mine) == set(ts.params)
    assert all(np.array_equal(mine[n], x.numpy()) for n, x in ts.params.items())
    back, _ = CheckpointManager(ckdir).restore_latest(tts.init_state(cfg, 1, device="cpu"))
    assert all(torch.equal(back.params[n], x) for n, x in ts.params.items())
