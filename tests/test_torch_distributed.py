"""The port's multi-device engine against the JAX package (twin of
tests/test_distributed.py).

In process, on one gloo rank: ``MeshSpec(1, 1)`` runs the sharded interval
step (gathered rows, the full-ladder decision, the local block pulled back)
and must equal the JAX package's ``MeshSpec(1, 1)`` run and the port's own
unsharded run bit for bit, for every exchange strategy and on the fused
and round paths; the mesh guards (axes, divisibility, the state-mode guard,
"needs N ranks") fail as the JAX ones do, and a kernel failure on a mesh
is an error, never a degradation.

The multi-rank half (4 gloo ranks, the checkpoints across meshes and
packages, the gathered bytes) is in tests/test_torch_distributed_ranks.py,
the CLI under torchrun in tests/test_torch_distributed_cli.py.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import systems as jsystems  # noqa: E402
from repro.core.distributed import MeshSpec as JMeshSpec  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JConfig  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import keys  # noqa: E402
from repro_torch.core import systems as tsystems  # noqa: E402
from repro_torch.core.distributed import MeshSpec  # noqa: E402
from repro_torch.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.exchange import available_strategies  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CHILD = ROOT / "tests" / "_torch_mesh_child.py"
_spec = importlib.util.spec_from_file_location("_torch_mesh_child", CHILD)
child = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(child)

R, L, SEED = child.R, child.L, child.SEED
TEMPS = np.asarray(child.TEMPS)


def _jax_params(params: dict) -> dict:
    # the JAX systems on their use_pallas=False paths, which the JAX
    # package's own tests pin bit-equal to its Pallas kernels
    return {**params, "use_pallas": False} if params.get("use_fused") else params


def _jax_run(name, sweeps=child.SWEEPS, mesh=None, **engine_kw):
    _, sys_name, params, kw = child.SCENARIOS[name]
    eng = JEngine(jsystems.make_system(sys_name, _jax_params(params)),
                  JConfig(**child.config_kw({**kw, **engine_kw}), mesh=mesh))
    return eng, eng.run(eng.init(jax.random.key(SEED), TEMPS), sweeps)


def _assert_state(got: dict, want, what: str):
    for f in ("energy", "rung", "states", "t"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want.pt, f)),
                                      err_msg=f"{what}: {f}")
    np.testing.assert_array_equal(got["attempts"], np.asarray(want.stats.swap_attempts),
                                  err_msg=f"{what}: swap attempts")
    np.testing.assert_array_equal(got["accepts"], np.asarray(want.stats.swap_accepts),
                                  err_msg=f"{what}: swap accepts")


def _port_state(st) -> dict:
    return {"energy": st.pt.energy.numpy(), "rung": st.pt.rung.numpy(),
            "states": st.pt.states.numpy(), "t": st.pt.t.numpy(),
            "attempts": st.stats.swap_attempts.numpy(),
            "accepts": st.stats.swap_accepts.numpy()}


# ---------- MeshSpec and the guards -------------------------------------------------


def test_mesh_spec_validation():
    assert MeshSpec().n_devices == 1
    assert MeshSpec(ensemble=2, replica=4).n_devices == 8
    with pytest.raises(ValueError, match=">= 1"):
        MeshSpec(ensemble=0)
    with pytest.raises(ValueError, match="divide"):
        MeshSpec(replica=3).validate(n_replicas=8, n_chains=1)
    with pytest.raises(ValueError, match="divide"):
        MeshSpec(ensemble=2).validate(n_replicas=8, n_chains=3)
    MeshSpec(ensemble=2, replica=4).validate(n_replicas=8, n_chains=2)
    assert dataclasses.asdict(MeshSpec(2, 4)) == dataclasses.asdict(JMeshSpec(2, 4))


def test_state_mode_rejects_replica_sharding():
    with pytest.raises(ValueError, match="temp"):
        EngineConfig(n_replicas=R, swap_interval=5, swap_mode="state",
                     mesh=MeshSpec(ensemble=1, replica=2))
    EngineConfig(n_replicas=R, swap_interval=5, swap_mode="state", mesh={"ensemble": 2},
                 n_chains=2)


def test_mesh_build_needs_its_ranks():
    """With no process group of N ranks, a mesh of N > 1 fails at engine
    construction naming the ranks and the launcher (JAX: "needs N devices")."""
    with pytest.raises(ValueError, match="needs 2 ranks") as err:
        Engine(tsystems.make_system("ising", {"length": L}),
               EngineConfig(n_replicas=R, swap_interval=5, mesh=MeshSpec(1, 2)), device="cpu")
    assert "torchrun --nproc-per-node 2" in str(err.value)


@pytest.mark.parametrize("how", ["compile fault", "refused launch"])
def test_mesh_never_degrades(how, monkeypatch):
    """On a mesh a failed preparation or a refused launch on a fused path is
    an error, as under ``strict_kernels``: a degradation one rank took alone
    would put the ranks on different paths and swap streams."""
    from repro_torch.engine import driver
    from repro_torch.kernels import build
    from repro_torch.resilience import Fault, FaultPlan, InjectedFault

    faults = FaultPlan([Fault("engine.compile")]) if how == "compile fault" else None
    eng = Engine(tsystems.make_system("ising", {"length": L, "use_fused": True}),
                 EngineConfig(n_replicas=R, swap_interval=5, mesh=MeshSpec()), device="cpu",
                 faults=faults)
    if how == "refused launch":
        def refuse(self, state, n):
            raise build.KernelError("ising_fused launch failed with cudaError 1")

        monkeypatch.setattr(driver.Engine, "_issue", refuse)
    with pytest.raises(InjectedFault if how == "compile fault" else build.KernelError):
        eng.run(eng.init(keys.key(0), TEMPS), 10)
    assert eng.system.use_fused and not eng._degraded


def test_local_block_and_gather_state_round_trip():
    """`local_block` cuts the placement contract's block; on one rank
    `gather_state` gives the whole state back."""
    eng = Engine(tsystems.make_system("ising", {"length": L}),
                 EngineConfig(n_replicas=R, swap_interval=5, n_chains=2), device="cpu")
    whole = eng.init(keys.key(1), TEMPS)
    block = tdist.local_block(whole, MeshSpec(2, 4), (1, 2))
    assert block.pt.states.shape == (1, 2, L, L)
    assert torch.equal(block.pt.states[0], whole.pt.states[1, 4:6])
    assert torch.equal(block.pt.key, whole.pt.key[1:2])
    assert block.stats.swap_attempts.shape == (1, R) and block.betas.shape == (R,)
    layout = MeshSpec(1, 1).build("cpu")
    back = tdist.gather_state(whole, layout)
    for a, b in zip(tdist.local_block(back, MeshSpec(1, 1), (0, 0)).pt.states, whole.pt.states):
        assert torch.equal(a, b)


def test_rebalance_matches_jax():
    from repro.core import distributed as jdist
    from repro.core import pt as jpt
    from repro_torch.core import pt as tpt

    np.testing.assert_array_equal(tdist.rebalance_ladder(TEMPS, 5),
                                  jdist.rebalance_ladder(TEMPS, 5))
    js, ts = (m.make_system("ising", {"length": 4}) for m in (jsystems, tsystems))
    jst = jpt.init_replicas(js, R, jax.random.key(3))
    tst = tpt.init_replicas(ts, R, keys.key(3))
    jst = jst.__class__(**{**jst.__dict__, "rung": jax.numpy.asarray(np.roll(np.arange(R), 3),
                                                                     jax.numpy.int32)})
    tst = dataclasses.replace(tst, rung=torch.from_numpy(np.roll(np.arange(R), 3)).int())
    for new_r in (5, 12):
        a, b = tdist.rebalance_state(tst, new_r), jdist.rebalance_state(jst, new_r)
        np.testing.assert_array_equal(a.states.numpy(), np.asarray(b.states))
        np.testing.assert_array_equal(a.energy.numpy(), np.asarray(b.energy))
        np.testing.assert_array_equal(a.rung.numpy(), np.asarray(b.rung))


# ---------- one rank: MeshSpec(1, 1) == JAX's MeshSpec(1, 1) == unsharded ----------


def _port_run(mesh, params, exchange, sweeps=30):
    eng = Engine(tsystems.make_system("ising", params),
                 EngineConfig(n_replicas=R, swap_interval=5, chunk_intervals=3, mesh=mesh,
                              exchange=exchange), device="cpu")
    return eng.run(eng.init(keys.key(SEED), TEMPS), sweeps)


CASES = [(ex, "sweep") for ex in sorted(available_strategies())] + [
    ("deo", "fused"), ("windowed", "fused"), ("deo", "round"), ("seo", "round")]


@pytest.mark.parametrize("exchange,path", CASES, ids=[f"{e}-{p}" for e, p in CASES])
def test_single_rank_mesh_bit_equal(exchange, path):
    params = {"length": L, "use_fused": path != "sweep", "use_fused_round": path == "round"}
    st_mesh, res_mesh = _port_run(MeshSpec(), params, exchange)
    st_plain, res_plain = _port_run(None, params, exchange)
    for f in ("states", "energy", "rung", "t", "phase"):
        assert torch.equal(getattr(st_mesh.pt, f), getattr(st_plain.pt, f)), f
    for k, v in res_plain.summary.items():
        np.testing.assert_array_equal(res_mesh.summary[k], v, err_msg=k)
    jeng = JEngine(jsystems.make_system("ising", _jax_params(params)),
                   JConfig(n_replicas=R, swap_interval=5, chunk_intervals=3,
                           mesh=JMeshSpec(), exchange=exchange))
    jst, jres = jeng.run(jeng.init(jax.random.key(SEED), TEMPS), 30)
    _assert_state(_port_state(st_mesh), jst, f"{exchange} {path}")
    np.testing.assert_array_equal(res_mesh.summary["swap_acceptance"],
                                  jres.summary["swap_acceptance"])


def test_conformance_entry_runs_on_a_mesh():
    """``mesh=`` reaches the zoo entry's RunSpec as JAX's does; the entry's
    spec runs on a one-rank mesh equal to its unsharded run."""
    from repro.validate.conformance import entry_runspec as jentry_runspec
    from repro_torch.api import Session
    from repro_torch.validate.conformance import entry_runspec

    entry = tsystems.registered("ising")
    spec = entry_runspec(entry, seed=3, mesh=MeshSpec(2, 1))
    jspec = jentry_runspec(jsystems.REGISTRY["ising"], seed=3, mesh=JMeshSpec(2, 1))
    assert spec.to_dict() == jspec.to_dict()
    short = {"phases": [{"name": "burn", "n_sweeps": 40, "adapt": True}]}
    data = {**spec.to_dict(), "schedule": short}
    data["engine"]["mesh"] = {"ensemble": 1, "replica": 1}
    on_mesh = Session(type(spec).from_dict(data), device="cpu").run().manifest()
    data["engine"]["mesh"] = None
    plain = Session(type(spec).from_dict(data), device="cpu").run().manifest()
    on_mesh["spec"]["engine"]["mesh"] = None
    assert on_mesh == plain


def test_sample_driver_smoke(capsys):
    """``python -m repro_torch.launch.sample --smoke --device cpu``: the
    production driver's reduced run (L=32, 16 replicas, 500 sweeps)."""
    from repro_torch.launch import sample

    assert sample.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("sweep     500  cold|m|=") and "replica-sweeps/s" in out[0]
    assert out[-1].startswith("final swap acceptance (cold pairs):")
