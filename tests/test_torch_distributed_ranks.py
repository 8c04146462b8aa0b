"""The port's multi-device engine on 4 ranks and under torchrun, against
the JAX package (the multi-process half of tests/test_distributed.py's
twin; the in-process half is tests/test_torch_distributed.py).

``tests/_torch_mesh_child.py`` (run once a module, as a script) starts 4
gloo ranks with `torch.multiprocessing` (spawn) and runs every scenario of
its table on its mesh: (1, 4) DEO per sweep, fused, round (``pack_bits``)
and SEO; (2, 2) with two chains, per sweep and round; HP and
``single_flip`` per sweep; a checkpoint saved on (1, 4); an
``engine.compile`` fault on one rank; a JAX checkpoint (written here
first) resumed on (2, 2); and the int8 ``compressed_psum`` of one seeded
gradient a rank, bit-equal to JAX's ``compressed_psum`` of the same four
mapped over a named axis.  Each final state, rung
map and swap counter must equal JAX's unsharded engine from the same seed;
the (1, 4) checkpoint resumes on one device in the port and in JAX; and
the child's count of the bytes every replica-axis all-gather returned
shows that an interval moves two O(R) rows and no lattice.  The CLI
under torchrun is in tests/test_torch_distributed_cli.py.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.core import systems as jsystems  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JConfig  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import systems as tsystems  # noqa: E402
from repro_torch.engine import Engine, EngineConfig  # noqa: E402
from test_torch_distributed import (  # noqa: E402
    CHILD, R, SEED, TEMPS, _assert_state, _jax_run, _port_state, child,
)

@pytest.fixture(scope="module")
def mesh4(tmp_path_factory):
    """A JAX checkpoint of two chains at sweep 40 for the child to resume,
    then one run of tests/_torch_mesh_child.py on 4 ranks; yields its
    output dir."""
    outdir = tmp_path_factory.mktemp("mesh4")
    _, sys_name, params, kw = child.SCENARIOS["chains"]
    eng = JEngine(jsystems.make_system(sys_name, params), JConfig(**child.config_kw(kw)))
    eng.run(eng.init(jax.random.key(SEED), TEMPS), child.CKPT_SWEEPS,
            checkpoint=JManager(str(outdir / "jax_ckpt"), keep=1), checkpoint_every_chunks=2)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(CHILD), str(outdir)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, f"mesh child failed\n{proc.stdout}\n{proc.stderr}"
    out = dict(np.load(outdir / "mesh4.npz"))
    return outdir, out


def _child_state(out, name):
    return {f: out[f"{name}_{f}"] for f in ("energy", "rung", "states", "t", "attempts",
                                             "accepts")}


@pytest.mark.parametrize("name", list(child.SCENARIOS))
def test_four_ranks_bit_equal_to_jax_unsharded(mesh4, name):
    _, out = mesh4
    _, (jst, jres) = _jax_run(name)
    _assert_state(_child_state(out, name), jst, name)
    np.testing.assert_array_equal(out[f"{name}_summary_acceptance"],
                                  jres.summary["swap_acceptance"])


def test_temp_mode_gathers_carry_only_rows(mesh4):
    """Each rank holds one chain in every scenario; every replica-axis
    all-gather of a run returns one (R,) row of 4-byte scalars, two an
    interval (the energy and the rung rows; the scenarios record no
    observable), and the lattices (R L^2 bytes a chain) never move."""
    _, out = mesh4
    intervals = child.SWEEPS // child.SWAP_INTERVAL
    for name, (mesh, *_rest) in child.SCENARIOS.items():
        assert child.SCENARIOS[name][3].get("n_chains", 1) == mesh[0], name
        got = out[f"{name}_gathered_bytes"]
        assert len(got) == 2 * intervals, name
        assert set(got.tolist()) == {4 * R}, (name, set(got.tolist()))


def test_checkpoint_from_mesh_resumes_on_one_device(mesh4):
    """The (1, 4) mesh's checkpoint at sweep 40 finishes on one device, in
    the port and in JAX, equal to the uninterrupted sharded run."""
    outdir, out = mesh4
    want = _child_state(out, "deo")
    _, sys_name, params, kw = child.SCENARIOS["deo"]
    teng = Engine(tsystems.make_system(sys_name, params), EngineConfig(**child.config_kw(kw)),
                  device="cpu")
    restored, meta = teng.restore(CheckpointManager(str(outdir / "ckpt")))
    assert meta["step"] == child.CKPT_SWEEPS
    resumed, _ = teng.run(restored, child.SWEEPS - child.CKPT_SWEEPS)
    got = _port_state(resumed)
    for f in ("energy", "rung", "states", "t"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    jeng = JEngine(jsystems.make_system(sys_name, params), JConfig(**child.config_kw(kw)))
    jrestored, jmeta = jeng.restore(JManager(str(outdir / "ckpt")))
    assert jmeta["step"] == child.CKPT_SWEEPS
    jresumed, _ = jeng.run(jrestored, child.SWEEPS - child.CKPT_SWEEPS)
    for f in ("energy", "rung", "states", "t"):
        np.testing.assert_array_equal(np.asarray(getattr(jresumed.pt, f)), want[f], err_msg=f)


def test_kernel_failure_on_one_rank_is_fatal_not_a_degradation(mesh4):
    """An engine.compile fault on one rank of a fused (1, 4) mesh raises
    there; no rank degrades, so the ranks keep one path and swap stream."""
    _, out = mesh4
    want = [int(r == child.FAULT_RANK) for r in range(child.WORLD)]
    assert out["fault_raised"].tolist() == want
    assert out["fault_still_fused"].tolist() == [1] * child.WORLD
    assert out["fault_compiles"].tolist() == [1 - w for w in want]


def test_jax_checkpoint_resumes_on_two_by_two(mesh4):
    _, out = mesh4
    assert int(out["resumed_step"]) == child.CKPT_SWEEPS
    for f in ("energy", "rung", "states"):
        np.testing.assert_array_equal(out[f"resumed_{f}"], out[f"chains_{f}"], err_msg=f)


def test_compressed_psum_on_four_ranks_matches_jax(mesh4):
    """`compressed_psum` over 4 gloo ranks (all-reduce MAX of the scales,
    SUM of the int8 payload in int32) == the JAX package's
    `compressed_psum` of the same four gradients, mapped over a named axis
    of 4 (``jax.vmap``, whose ``pmax`` / ``psum`` reduce over it), bit for
    bit: every rank's sum and its own new error."""
    import jax
    import jax.numpy as jnp

    from repro.train import grad_compress as jgc

    _, out = mesh4
    g, err = (jnp.stack([jnp.asarray(child.psum_inputs(r)[i]) for r in range(child.WORLD)])
              for i in (0, 1))
    totals, errors = jax.vmap(lambda g, e: jgc.compressed_psum(g, e, "i"),
                              axis_name="i")(g, err)
    for r in range(child.WORLD):
        assert np.array_equal(out["psum_totals"][r], np.asarray(totals[r])), r
        assert np.array_equal(out["psum_errors"][r], np.asarray(errors[r])), r
