"""Child process of tests/test_torch_sharded_lm.py: the JAX package on 4
forced host devices (the flag must be set before jax is imported).

    python tests/_jax_sharded_child.py OUTDIR

* ``train``: reduced gemma-2b in f32, JAX's GSPMD training step as
  ``launch/dryrun.py`` places it (state in the FSDP layout,
  ``cast_shardings`` the TP-only specs, ``grad_shardings`` the FSDP ones) on
  a (2, 2) ``("data", "model")`` mesh, 2 steps of one seeded batch;
* ``ptlm``: PT over reduced gemma-2b sequences through the `Engine` on
  ``MeshSpec(1, 2)`` (the first 2 devices).

Writes ``OUTDIR/jax_init.pkl`` first (the initial train state and the
PT-LM weights as numpy trees, for the port's child to start from) and
``OUTDIR/jax.npz`` (the final masters, moments and losses under JAX's
``keystr`` names, and the PT-LM run's tokens, rungs, energies and swap
counters).
"""
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"

import dataclasses  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.configs import get_config  # noqa: E402
from repro.core.distributed import MeshSpec  # noqa: E402
from repro.core.ptlm import LMSystem  # noqa: E402
from repro.engine import Engine, EngineConfig  # noqa: E402
from repro.launch import sharding  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.train import optimizer as opt_lib  # noqa: E402
from repro.train.train_step import init_state, make_train_step  # noqa: E402

from _torch_sharded_child import (  # noqa: E402
    PTLM_R, PTLM_SEED, PTLM_SEQ, PTLM_STEPS, PTLM_TEMPS, SWAP_INTERVAL, TRAIN_STEPS,
    WARMUP, train_batch,
)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def main(outdir: str) -> int:
    assert jax.device_count() == 4, jax.device_count()
    cfg = dataclasses.replace(get_config("gemma_2b", reduced=True), dtype="float32")
    out, init = {}, {}

    state = init_state(cfg, jax.random.key(0))
    init["train"] = _np({"params": state.params, "step": state.step,
                         "opt": {"mu": state.opt.mu, "nu": state.opt.nu,
                                 "count": state.opt.count}})
    params = jm.init_params(cfg, jax.random.key(0))
    init["ptlm"] = _np(params)
    tmp = os.path.join(outdir, "jax_init.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(init, f)
    os.replace(tmp, os.path.join(outdir, "jax_init.pkl"))  # the port's child waits for it
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    batch = {k: jax.numpy.asarray(v) for k, v in train_batch().items()}
    step = make_train_step(cfg, opt_lib.AdamWConfig(warmup_steps=WARMUP),
                           cast_shardings=sharding.param_shardings(mesh, state.params),
                           grad_shardings=sharding.param_shardings(mesh, state.params, fsdp=True))
    in_sh = (sharding.param_shardings(mesh, state, fsdp=True),
             sharding.batch_shardings(mesh, batch))
    jstep = jax.jit(step, in_shardings=in_sh)
    state = jax.device_put(state, in_sh[0])
    batch = jax.device_put(batch, in_sh[1])
    losses = []
    for _ in range(TRAIN_STEPS):
        state, metrics = jstep(state, batch)
        losses.append(np.asarray(metrics["loss"]))
    out["train_loss"] = np.asarray(losses)
    for name, tree in (("params", state.params), ("mu", state.opt.mu), ("nu", state.opt.nu)):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            out[f"train_{name}{jax.tree_util.keystr(path)}"] = np.asarray(leaf)

    system = LMSystem(cfg=cfg, seq_len=PTLM_SEQ).bind(params)
    eng = Engine(system, EngineConfig(n_replicas=PTLM_R, swap_interval=SWAP_INTERVAL,
                                      mesh=MeshSpec(1, 2)))
    st = eng.init(jax.random.key(PTLM_SEED), np.asarray(PTLM_TEMPS, np.float32))
    st, _ = eng.run(st, PTLM_STEPS)
    out["ptlm_states"] = np.asarray(st.pt.states)
    out["ptlm_rung"] = np.asarray(st.pt.rung)
    out["ptlm_energy"] = np.asarray(st.pt.energy)
    out["ptlm_attempts"] = np.asarray(st.stats.swap_attempts)
    out["ptlm_accepts"] = np.asarray(st.stats.swap_accepts)

    np.savez(os.path.join(outdir, "jax.npz"), **out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1]))
