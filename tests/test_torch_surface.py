"""Public surface the port carries for code written against the JAX package.

* ``Engine.run(checkpoint=, checkpoint_every_chunks=)``: a checkpoint the
  port's engine loop writes resumes in the JAX package and finishes equal
  to its uninterrupted run, one the JAX engine loop writes resumes in the
  port, and every save counts in ``engine_checkpoints_total``;
* `repro_torch.engine` re-exports the stats helpers as `repro.engine` does;
* `repro_torch.core.systems` has `System`, `batched_init`, `batched_energy`,
  `register_constructor` and `register`: a user's own system registered in
  the port runs through `RunSpec` and the conformance gate, and
  `batched_init` / `batched_energy` equal JAX's from the same key;
* `repro_torch.core.pt` has `PTConfig`, `init`, `run` and `make_run`, bit-equal
  to JAX's from the same key, and refuses JAX's ``shard=`` by name.

Tolerances: states, rungs, energies (integer-valued), counters and swap
decisions exact; energies of the f32 systems (Gaussian, EA) within 1e-6
relative; trace swap probabilities within 4 ulps relative (JAX's and
torch's sigmoid differ by up to 3 ulps), as in test_torch_engine.py.
"""
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.core import ising as jising  # noqa: E402
from repro.core import pt as jpt  # noqa: E402
from repro.core import systems as jsystems  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JConfig  # noqa: E402
from repro_torch import engine as tengine  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import ising as tising  # noqa: E402
from repro_torch.core import keys  # noqa: E402
from repro_torch.core import pt as tpt  # noqa: E402
from repro_torch.core import systems as tsystems  # noqa: E402
from repro_torch.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.obs import Observability  # noqa: E402

R, L = 6, 6
TEMPS = np.linspace(1.2, 3.6, R)
F32_EPS = float(np.finfo(np.float32).eps)


def _pair(params, **cfg):
    cfg = dict(n_replicas=R, swap_interval=5, chunk_intervals=2, **cfg)
    js = jsystems.make_system("ising", params)
    ts = tsystems.make_system("ising", params)
    return JEngine(js, JConfig(**cfg)), Engine(ts, EngineConfig(**cfg), device="cpu")


def _assert_pt_equal(tpt_st, jpt_st):
    for f in ("states", "energy", "rung", "t", "phase"):
        np.testing.assert_array_equal(getattr(tpt_st, f).numpy(),
                                      np.asarray(getattr(jpt_st, f)), err_msg=f)


# -- Engine.run(checkpoint=...) ----------------------------------------------


@pytest.mark.parametrize("params", [{"length": L}, {"length": L, "use_fused": True}],
                         ids=["per-sweep", "fused"])
def test_port_engine_checkpoint_resumes_in_jax(tmp_path, params):
    """The port's engine loop saves every chunk (4 chunks: 4 saves, each
    counted); the JAX engine restores the newest save at sweep 40 and
    finishes equal to its own uninterrupted 60-sweep run."""
    jeng, teng = _pair(params)
    obs = Observability.create(timeline=False)
    teng.obs = obs
    mgr = CheckpointManager(str(tmp_path / "port"), keep=2)
    teng.run(teng.init(keys.key(3), TEMPS), 40, checkpoint=mgr, checkpoint_every_chunks=1)
    snap = obs.metrics.snapshot()
    assert snap["engine_checkpoints_total"]["samples"][0]["value"] == 4
    assert mgr.steps() == [30, 40]

    whole, _ = jeng.run(jeng.init(jax.random.key(3), TEMPS), 60)
    restored, meta = jeng.restore(JManager(str(tmp_path / "port")))
    assert meta["step"] == 40 and len(meta["temps"]) == R
    resumed, _ = jeng.run(restored, 20)
    for f in ("states", "energy", "rung", "t", "phase"):
        np.testing.assert_array_equal(np.asarray(getattr(resumed.pt, f)),
                                      np.asarray(getattr(whole.pt, f)), err_msg=f)
    np.testing.assert_array_equal(np.asarray(resumed.stats.swap_attempts),
                                  np.asarray(whole.stats.swap_attempts))


def test_jax_engine_checkpoint_resumes_in_port(tmp_path):
    """A checkpoint the JAX engine loop writes at sweep 40 resumes in the
    port and finishes equal to JAX's uninterrupted run (and to the port's)."""
    jeng, teng = _pair({"length": L})
    mgr = JManager(str(tmp_path / "jax"), keep=2)
    jeng.run(jeng.init(jax.random.key(4), TEMPS), 40, checkpoint=mgr,
             checkpoint_every_chunks=1)
    whole, _ = jeng.run(jeng.init(jax.random.key(4), TEMPS), 60)
    restored, meta = teng.restore(CheckpointManager(str(tmp_path / "jax")))
    assert meta["step"] == 40
    resumed, _ = teng.run(restored, 20)
    _assert_pt_equal(resumed.pt, whole.pt)
    own, _ = teng.run(teng.init(keys.key(4), TEMPS), 60)
    _assert_pt_equal(own.pt, whole.pt)


def test_checkpoint_every_zero_or_none_saves_nothing(tmp_path):
    _, teng = _pair({"length": L})
    mgr = CheckpointManager(str(tmp_path / "c"))
    st = teng.init(keys.key(5), TEMPS)
    teng.run(st, 20, checkpoint=mgr, checkpoint_every_chunks=0)
    teng.run(st, 20, checkpoint=None, checkpoint_every_chunks=1)
    assert mgr.steps() == []


# -- engine re-exports -------------------------------------------------------


def test_engine_reexports_the_stats_helpers():
    import repro.engine as jengine
    from repro_torch.engine import stats

    names = ("OnlineStats", "init_stats", "update_stats", "summarize", "chain_slice",
             "chain_block", "combine_chains")
    for name in names:
        assert name in jengine.__all__ and name in tengine.__all__, name
        assert getattr(tengine, name) is getattr(stats, name), name
    assert set(jengine.__all__) <= set(tengine.__all__)


# -- core.systems: the System interface and the registries --------------------


class Harmonic:
    """A user's own system: ``E(x) = x^2 / 2`` (exact <x^2> = T), batched."""

    step_size = 1.5

    def init_state_batched(self, keys_):
        return keys.normal(keys_, ())

    def batched_energy(self, x):
        return 0.5 * x * x

    def batched_mcmc_step(self, key, t, x, betas, replica_offset=0):
        ids = replica_offset + torch.arange(x.shape[0], dtype=torch.int64)
        bits = keys.random_bits(keys.split(keys.replica_keys(key, t, ids)), ())
        trial = x + self.step_size * (2.0 * keys.uniform_from_bits(bits[:, 0]) - 1.0)
        de = self.batched_energy(trial) - self.batched_energy(x)
        accept = keys.uniform_from_bits(bits[:, 1]) < torch.exp(-betas * de)
        return (torch.where(accept, trial, x), torch.where(accept, de, 0.0),
                accept.to(torch.int32))


def _harmonic_exact(system, temps):
    t = np.asarray(temps, np.float64)
    return {"x2": t, "energy": t / 2.0}


@pytest.fixture
def harmonic():
    entry = tsystems.register_constructor(
        "harmonic_test", lambda: Harmonic(), {"x2": lambda s: (lambda x: x * x)})
    zoo = tsystems.register(tsystems.RegisteredSystem(
        name="harmonic_test", params={}, observable_names=("x2",),
        temps=(0.5, 1.0, 2.0, 4.0), swap_interval=2, burn_sweeps=200, n_batches=4,
        sweeps_per_batch=200, adapt_rounds=1))
    yield entry, zoo
    del tsystems.CONSTRUCTORS["harmonic_test"], tsystems.REGISTRY["harmonic_test"]


def test_user_system_runs_through_runspec_and_validate(harmonic):
    from repro_torch.api import RunSpec, Session
    from repro_torch.validate import assert_conforms, run_conformance
    from repro_torch.validate.conformance import entry_runspec

    _, zoo = harmonic
    assert isinstance(Harmonic(), tsystems.System)
    with pytest.raises(ValueError, match="already registered"):
        tsystems.register_constructor("harmonic_test", Harmonic)
    with pytest.raises(ValueError, match="already registered"):
        tsystems.register(zoo)
    spec = entry_runspec(zoo, seed=2)
    assert RunSpec.from_json(spec.to_json()) == spec
    assert isinstance(Session(spec, device="cpu").system, Harmonic)
    report = run_conformance(zoo, seed=2, exact_fn=_harmonic_exact, device="cpu")
    assert report.n_batches == 4 * 2  # windows x chains
    assert_conforms(report)


def test_registered_systems_satisfy_the_protocol():
    for name in tsystems.CONSTRUCTORS:
        assert isinstance(tsystems.registered(name).make(), tsystems.System), name


@pytest.mark.parametrize("name,params", [
    ("ising", {"length": 6}),
    ("potts", {"shape": (4, 6), "q": 3}),
    ("hp_protein", {"sequence": "HPHPPHHPHH"}),
    ("ea_spin_glass", {"shape": (4, 4), "disorder_seed": 1}),
    ("gaussian", {"mus": (-3.0, 3.0), "sigmas": (0.8, 0.8), "weights": (0.5, 0.5)}),
])
def test_batched_init_and_energy_equal_jax(name, params):
    js, ts = jsystems.make_system(name, params), tsystems.make_system(name, params)
    jstates = jsystems.batched_init(js, jax.random.key(7), 5)
    tstates = tsystems.batched_init(ts, keys.key(7), 5)
    jleaves = jstates if isinstance(jstates, dict) else {"": jstates}
    tleaves = tstates if isinstance(tstates, dict) else {"": tstates}
    assert set(jleaves) == set(tleaves)
    for k in jleaves:
        np.testing.assert_array_equal(tleaves[k].numpy(), np.asarray(jleaves[k]), err_msg=k)
    np.testing.assert_allclose(tsystems.batched_energy(ts, tstates).numpy(),
                               np.asarray(jsystems.batched_energy(js, jstates)),
                               rtol=1e-6, atol=0)


def test_batched_energy_falls_back_to_per_replica_energy():
    class PerReplica:
        def energy(self, x):
            return (x * x).sum()

    x = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    np.testing.assert_array_equal(tsystems.batched_energy(PerReplica(), x).numpy(),
                                  [1.0, 13.0, 41.0])


# -- core.pt: PTConfig / init / run / make_run ---------------------------------


@pytest.mark.parametrize("params,mode", [
    ({"length": L}, "temp"),
    ({"length": L, "use_fused": True}, "temp"),
    ({"length": L, "use_fused": True, "use_fused_round": True}, "temp"),
    ({"length": L}, "state"),
], ids=["per-sweep", "fused", "round", "state-mode"])
def test_pt_run_bit_equal_to_jax(params, mode):
    temps = tuple(float(t) for t in TEMPS)
    jcfg = jpt.PTConfig(n_replicas=R, temps=temps, swap_interval=5, swap_mode=mode)
    tcfg = tpt.PTConfig(n_replicas=R, temps=temps, swap_interval=5, swap_mode=mode)
    np.testing.assert_array_equal(tcfg.betas, jcfg.betas)
    js = jsystems.make_system("ising", {**params, "use_pallas": False})
    ts = tsystems.make_system("ising", params)
    jst = jpt.init(js, jcfg, jax.random.key(11))
    tst = tpt.init(ts, tcfg, keys.key(11))
    _assert_pt_equal(tst, jst)
    jst, jtrace = jpt.run(js, jcfg, jst, 30,
                          observables={"am": lambda s: jnp.abs(jising.magnetization(s))})
    tst, ttrace = tpt.make_run(ts, tcfg, 30, {"am": lambda s: tising.magnetization(s).abs()})(tst)
    _assert_pt_equal(tst, jst)
    assert set(ttrace) == set(jtrace)
    for k in ("energy", "swap_accept", "swap_attempt"):
        np.testing.assert_array_equal(ttrace[k].numpy(), np.asarray(jtrace[k]), err_msg=k)
    np.testing.assert_allclose(ttrace["am"].numpy(), np.asarray(jtrace["am"]), rtol=F32_EPS)
    np.testing.assert_allclose(ttrace["swap_prob"].numpy(), np.asarray(jtrace["swap_prob"]),
                               rtol=4 * F32_EPS, atol=0)
    assert ttrace["energy"].shape == (30 // 5, R)


def test_pt_run_equals_the_engine():
    """`pt.run` is the engine's interval step: the same state after 30 sweeps."""
    temps = tuple(float(t) for t in TEMPS)
    ts = tising.IsingSystem(length=L)
    cfg = tpt.PTConfig(n_replicas=R, temps=temps, swap_interval=5)
    st, _ = tpt.run(ts, cfg, tpt.init(ts, cfg, keys.key(2)), 30)
    eng = Engine(ts, EngineConfig(n_replicas=R, swap_interval=5), device="cpu")
    est, _ = eng.run(eng.init(keys.key(2), TEMPS.astype(np.float32)), 30)
    for f in ("states", "energy", "rung", "t", "phase"):
        assert torch.equal(getattr(st, f), getattr(est.pt, f)), f


@pytest.mark.parametrize("call", ["init", "run", "make_run"])
def test_pt_refuses_shard_by_name(call):
    ts = tising.IsingSystem(length=4)
    cfg = tpt.PTConfig(n_replicas=2, temps=(1.0, 2.0), swap_interval=2)
    st = tpt.init(ts, cfg, keys.key(0))
    fn = {"init": lambda: tpt.init(ts, cfg, keys.key(0), shard="replicas"),
          "run": lambda: tpt.run(ts, cfg, st, 4, shard="replicas"),
          "make_run": lambda: tpt.make_run(ts, cfg, 4, shard="replicas")}[call]
    with pytest.raises(NotImplementedError, match="shard"):
        fn()


def test_pt_config_validates_as_jax():
    with pytest.raises(ValueError, match="rungs"):
        tpt.PTConfig(n_replicas=3, temps=(1.0, 2.0))
    with pytest.raises(ValueError, match="swap_mode"):
        tpt.PTConfig(n_replicas=2, temps=(1.0, 2.0), swap_mode="both")
    spec, n = tpt.PTConfig(n_replicas=2, temps=(1.0, 2.0), swap_interval=0).step_spec(40)
    assert (spec.do_swap, spec.sweeps_per_interval, n) == (False, 40, 1)
    assert math.isclose(tpt.PTConfig(2, (1.0, 4.0)).betas[1], 0.25)
