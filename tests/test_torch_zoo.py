"""The rest of the system zoo on the port against the JAX package.

* `keys.normal` against ``jax.random.normal``: within 3 ulps (XLA's and
  torch's ``log1p`` inside ``erf_inv`` differ; measured 0.94% of 1e6 draws
  unequal, none by more than 3 ulps).
* The EA ±J spin glass: the quenched planes, ``init``, the energy and one
  batched checkerboard sweep.  Spins and acceptance counts bit-equal; ΔE
  and energies exact where every term is an integer (j=1), else within the
  4-ulp bound of the Ising sweeps (summation order).  40-sweep engine runs
  at 4x4 and 6x8 in temp and state mode, and with two chains: traces,
  rung trajectories and counters equal.
* The Gaussian mixture: ``init``, the energy and one step; ``x`` and the
  energies within the `keys.normal` bound (and the ulps of XLA's and
  torch's exp/log in the logsumexp), acceptance counts equal; a short run.
* The HP lattice protein: ``init``, ``hp_energy``, ``rg2`` and one step of
  N moves at N of 3, 10, 20 and 40: positions, ΔE and counts bit-equal; a short
  engine run (its per-rung ``rg2``, a mean over N, within 4 ulps: XLA may
  multiply by 1/N, test_torch_engine).
* Ising ``update="single_flip"``: one step of 1, 7, 16 and 300 flips at L=5
  and 6 (odd L has no checkerboard), both rules, integer and non-integer
  j, b: spins, ΔE and counts bit-equal; a short engine run.
* The generic per-sweep path: `pt.init_replicas` without a batched init,
  and the serial-chain kernels' wrappers refuse CPU tensors (the CPU runs
  their plain versions through `ops`).

Each run starts both packages from the same seed (`keys.key` is
``jax.random.key``), so a JAX key's words are the port's key.  The single
allowed divergence, a decision flipped inside the ulp gap between the two
frameworks' exp/sigmoid, does not occur at these seeds: every comparison
here is exact for integer state.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import systems as jsystems  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro_torch.core import keys as tkeys  # noqa: E402
from repro_torch.core import pt as tpt  # noqa: E402
from repro_torch.core import systems as tsystems  # noqa: E402
from repro_torch.engine import Engine as TEngine  # noqa: E402
from repro_torch.engine import EngineConfig as TEngineConfig  # noqa: E402
from repro_torch.kernels import ops, serial_chain  # noqa: E402

F32_EPS = 2.0 ** -23
EA = {"shape": (4, 4), "disorder_seed": 1, "accept_rule": "glauber"}
HP20 = "HPHPPHHPHHPHPHHPPHPH"


def _words(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jax.random.key_data(jkey)).astype(np.int64))


def _ulps(a, b) -> np.ndarray:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_state_equal(got, want, what):
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _assert_state_equal(got[k], want[k], f"{what}[{k}]")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _init_both(name, params, r, seed=11):
    jsys, tsys = jsystems.make_system(name, params), tsystems.make_system(name, params)
    jkeys = jax.random.split(jax.random.key(seed), r)
    jst = jax.vmap(jsys.init_state)(jkeys)
    tst = tsys.init_state_batched(_words(jkeys))
    return jsys, tsys, jst, tst


def _step_both(name, params, r, t=3, seed=11):
    """One batched step of each package from the same states, at replica
    keys ``fold_in(fold_in(key(5), 2t), r)``."""
    jsys, tsys, jst, tst = _init_both(name, params, r, seed)
    betas = np.linspace(0.3, 1.4, r).astype(np.float32)
    run_key = jax.random.key(5)
    rkeys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.fold_in(run_key, 2 * t), jnp.arange(r, dtype=jnp.uint32))
    step = getattr(jsys, "batched_mcmc_step", None) or jax.vmap(jsys.mcmc_step)
    jout = step(rkeys, jst, jnp.asarray(betas))
    tout = tsys.batched_mcmc_step(_words(run_key), torch.tensor(t), tst,
                                  torch.from_numpy(betas))
    return jout, tout


# -- keys.normal -----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_normal_matches_jax_within_3_ulps(seed):
    want = np.asarray(jax.random.normal(jax.random.key(seed), (200_000,)))
    got = tkeys.normal(tkeys.key(seed), (200_000,)).numpy()
    d = _ulps(got, want)
    assert d.max() <= 3 and (d > 0).mean() < 0.02
    # batched keys, () draws: the Gaussian's per-replica proposal
    jk = jax.random.split(jax.random.key(seed + 1), 64)
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, ()))(jk))
    assert _ulps(tkeys.normal(_words(jk), ()).numpy(), want).max() <= 3


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999], dtype=torch.float32)
    got = tkeys.erf_inv(x).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    assert np.isneginf(got[0]) and np.isposinf(got[1]) and got[2] == 0.0
    assert _ulps(got[2:], want[2:]).max() <= 3


# -- the EA spin glass -------------------------------------------------------------


@pytest.mark.parametrize("params", [
    EA,
    {"shape": (6, 8), "disorder_seed": 3, "j": 0.7, "accept_rule": "metropolis"},
], ids=["4x4-glauber", "6x8-j0.7-metropolis"])
def test_ea_disorder_init_and_energy_match_jax(params):
    jsys, tsys, jst, tst = _init_both("ea_spin_glass", params, r=5)
    for got, want in zip(tsys.disorder(), jsys.disorder()):
        _assert_state_equal(got, want, "disorder plane")
    _assert_state_equal(tst, jst, "init")
    want = np.asarray(jax.vmap(jsys.energy)(jst))
    got = tsys.batched_energy(tst).numpy()
    n_bonds = 2 * np.prod(params["shape"])
    if params.get("j", 1.0) == 1.0:
        np.testing.assert_array_equal(got, want)
    else:  # a sum of 2HW terms of magnitude j, in another order
        assert np.abs(got - want).max() <= 4 * F32_EPS * n_bonds * params["j"]


@pytest.mark.parametrize("params", [
    EA,
    {"shape": (4, 4), "disorder_seed": 1, "accept_rule": "metropolis"},
    {"shape": (6, 8), "disorder_seed": 3, "j": 0.7, "accept_rule": "glauber"},
], ids=["4x4-glauber", "4x4-metropolis", "6x8-j0.7-glauber"])
def test_ea_sweep_matches_jax(params):
    (js, jde, jna), (ts, tde, tna) = _step_both("ea_spin_glass", params, r=6)
    _assert_state_equal(ts, js, "states'")
    np.testing.assert_array_equal(tna.numpy(), np.asarray(jna))
    j = params.get("j", 1.0)
    err = np.abs(tde.numpy() - np.asarray(jde))
    if j == 1.0:
        assert err.max() == 0
    else:  # nacc terms of magnitude <= 8j, summed in another order
        assert (err <= 4 * F32_EPS * np.maximum(tna.numpy(), 1) * 8 * j).all()


def _engines(name, params, obs, *, r=4, swap_mode="temp", n_chains=1, swap_interval=2):
    jsys, tsys = jsystems.make_system(name, params), tsystems.make_system(name, params)
    cfg = dict(n_replicas=r, swap_interval=swap_interval, swap_mode=swap_mode,
               n_chains=n_chains, chunk_intervals=5, record_trace=True)
    jeng = JEngine(jsys, JEngineConfig(donate=False, **cfg),
                   observables=jsystems.named_observables(name, jsys, obs))
    teng = TEngine(tsys, TEngineConfig(**cfg),
                   observables=tsystems.named_observables(name, tsys, obs), device="cpu")
    return jeng, teng


def _run_both(name, params, obs, sweeps=40, seed=4, **kw):
    jeng, teng = _engines(name, params, obs, **kw)
    temps = np.linspace(1.0, 3.0, jeng.config.n_replicas)
    jst, jres = jeng.run(jeng.init(jax.random.key(seed), temps), sweeps)
    tst, tres = teng.run(teng.init(tkeys.key(seed), temps), sweeps)
    return (jst, jres), (tst, tres)


def _assert_runs_equal(j, t, float_series=(), ulps=1):
    (jst, jres), (tst, tres) = j, t
    assert sorted(jres.trace) == sorted(tres.trace)
    for k, want in jres.trace.items():
        want, got = np.asarray(want), np.asarray(tres.trace[k])
        if k == "swap_prob":  # JAX's and torch's sigmoid (test_torch_engine)
            np.testing.assert_allclose(got, want, rtol=4 * F32_EPS, atol=0)
        elif k in float_series:
            assert _ulps(got, want).max() <= ulps, k
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    np.testing.assert_array_equal(tst.pt.rung.numpy(), np.asarray(jst.pt.rung))
    np.testing.assert_array_equal(tst.pt.t.numpy(), np.asarray(jst.pt.t))
    for f in ("swap_attempts", "swap_accepts", "round_trips", "up_visits"):
        np.testing.assert_array_equal(getattr(tst.stats, f).numpy(),
                                      np.asarray(getattr(jst.stats, f)), err_msg=f)


@pytest.mark.parametrize("shape,swap_mode,n_chains", [
    ((4, 4), "temp", 1), ((4, 4), "state", 1), ((6, 8), "temp", 1), ((6, 8), "state", 1),
    ((4, 4), "temp", 2),
], ids=["4x4-temp", "4x4-state", "6x8-temp", "6x8-state", "4x4-two-chains"])
def test_ea_engine_run_matches_jax(shape, swap_mode, n_chains):
    """40 sweeps, a swap every 2: per-rung energy, |m| and swap rows, rung
    trajectories and counters equal; state mode gathers every leaf."""
    params = {**EA, "shape": shape}
    j, t = _run_both("ea_spin_glass", params, ("absmag",), swap_mode=swap_mode,
                     n_chains=n_chains)
    _assert_runs_equal(j, t, float_series=("absmag",))
    _assert_state_equal(t[0].pt.states, j[0].pt.states, "final states")
    if swap_mode == "state":
        assert t[0].pt.rung.tolist() == list(range(4))


# -- the Gaussian mixture ----------------------------------------------------------

GAUSS = {"mus": (-3.0, 3.0), "sigmas": (0.8, 0.8), "weights": (0.5, 0.5), "step_size": 1.0}


def test_gaussian_init_energy_and_step_match_jax():
    jsys, tsys, jst, tst = _init_both("gaussian", GAUSS, r=64)
    assert _ulps(tst.numpy(), np.asarray(jst)).max() <= 3
    x = np.linspace(-9.0, 9.0, 301).astype(np.float32)
    want = np.asarray(jax.vmap(jsys.energy)(jnp.asarray(x)))
    got = tsys.batched_energy(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=8 * F32_EPS, atol=8 * F32_EPS)
    (jx, jde, jna), (tx, tde, tna) = _step_both("gaussian", GAUSS, r=64)
    np.testing.assert_array_equal(tna.numpy(), np.asarray(jna))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=8 * F32_EPS, atol=0)
    np.testing.assert_allclose(tde.numpy(), np.asarray(jde), rtol=0, atol=64 * F32_EPS)


def test_gaussian_run_matches_jax():
    """40 steps: the rung trajectories, counters and swap decisions equal;
    the per-rung x and energy within a few ulps of the values."""
    j, t = _run_both("gaussian", GAUSS, ("absx", "x"), r=5)
    (jst, jres), (tst, tres) = j, t
    for k in ("swap_accept", "swap_attempt"):
        np.testing.assert_array_equal(tres.trace[k], np.asarray(jres.trace[k]), err_msg=k)
    for k in ("x", "absx", "energy"):
        np.testing.assert_allclose(tres.trace[k], np.asarray(jres.trace[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(tst.pt.rung.numpy(), np.asarray(jst.pt.rung))
    np.testing.assert_array_equal(tst.stats.swap_accepts.numpy(),
                                  np.asarray(jst.stats.swap_accepts))


# -- the HP lattice protein ----------------------------------------------------------


@pytest.mark.parametrize("sequence", ["HPH", "HPHPPHHPHH", HP20, HP20 * 2],
                         ids=["N3", "N10", "N20", "N40"])
def test_hp_init_energy_and_step_match_jax(sequence):
    jsys, tsys, jst, tst = _init_both("hp_protein", {"sequence": sequence}, r=7)
    _assert_state_equal(tst, jst, "init")
    (jp, jde, jna), (tp, tde, tna) = _step_both("hp_protein", {"sequence": sequence}, r=7)
    _assert_state_equal(tp, jp, "positions'")
    np.testing.assert_array_equal(tde.numpy(), np.asarray(jde))
    np.testing.assert_array_equal(tna.numpy(), np.asarray(jna))
    assert tna.sum() > 0
    # energies and rg2 of the moved (folded) chains
    from repro.core.hp import radius_of_gyration_sq
    from repro_torch.core.hp import radius_of_gyration_sq as t_rg2
    np.testing.assert_array_equal(tsys.batched_energy(tp).numpy(),
                                  np.asarray(jax.vmap(jsys.energy)(jp)))
    want = np.asarray(jax.vmap(radius_of_gyration_sq)(jp))
    np.testing.assert_allclose(t_rg2(tp).numpy(), want, rtol=4 * F32_EPS, atol=0)


def test_hp_engine_run_matches_jax():
    j, t = _run_both("hp_protein", {"sequence": "HPHPPHHPHH"}, ("rg2",), r=4)
    # rg2 is a mean over N: XLA may multiply by 1/N (test_torch_engine)
    _assert_runs_equal(j, t, float_series=("rg2",), ulps=4)
    _assert_state_equal(t[0].pt.states, j[0].pt.states, "final chains")


def test_hp_tables_equal_the_plain_expressions():
    """The kernel's rows are the plain version's ``exp(-beta de)`` and ``de``."""
    betas = torch.tensor([0.3, 1.0, 2.5])
    p_tab, de_tab = serial_chain.hp_tables(betas, 0.7)
    for k in range(-3, 4):
        de = -0.7 * torch.full((3,), float(k))
        assert torch.equal(de_tab[k + 3].expand(3), de)
        assert torch.equal(p_tab[:, k + 3], torch.exp(-betas * de))


# -- Ising single_flip ----------------------------------------------------------------


@pytest.mark.parametrize("flips", [1, 7, 16, 300])
@pytest.mark.parametrize("length,j,b,rule", [
    (5, 1.0, 0.0, "glauber"), (6, 1.0, 0.0, "metropolis"), (5, 0.7, 0.3, "metropolis"),
], ids=["L5-glauber", "L6-metropolis", "L5-j0.7-b0.3"])
def test_single_flip_step_matches_jax(length, j, b, rule, flips):
    params = {"length": length, "update": "single_flip", "flips_per_step": flips,
              "j": j, "b": b, "accept_rule": rule}
    (js, jde, jna), (ts, tde, tna) = _step_both("ising", params, r=5)
    _assert_state_equal(ts, js, "spins'")
    np.testing.assert_array_equal(tde.numpy(), np.asarray(jde))
    np.testing.assert_array_equal(tna.numpy(), np.asarray(jna))


def test_single_flip_engine_run_matches_jax():
    params = {"length": 5, "update": "single_flip", "flips_per_step": 7,
              "accept_rule": "glauber"}
    j, t = _run_both("ising", params, ("absmag",), r=4)
    _assert_runs_equal(j, t, float_series=("absmag",))


def test_single_flip_keeps_the_jax_refusals():
    from repro_torch.core.ising import IsingSystem

    IsingSystem(length=5, update="single_flip")  # odd L: no checkerboard needed
    with pytest.raises(ValueError, match="even L"):
        IsingSystem(length=5)
    with pytest.raises(ValueError, match="use_fused=True needs update='checkerboard'"):
        IsingSystem(length=6, update="single_flip", use_fused=True)


# -- the generic path ----------------------------------------------------------------


def test_init_replicas_without_a_batched_init_stacks_per_replica_states():
    """A system with only ``init_state`` / ``energy`` (JAX's protocol) gets
    ``split(k_init, R)`` keys and its states stacked: the batched init's."""
    from repro_torch.core.spin_glass import EASpinGlass, ea_energy

    sys_ = EASpinGlass(shape=(4, 4), disorder_seed=2)

    @dataclasses.dataclass(frozen=True)
    class PerReplica:
        def init_state(self, key):
            return sys_.init_state(key)

        def energy(self, state):
            return ea_energy(state)

    want = tpt.init_replicas(sys_, 5, tkeys.key(9))
    got = tpt.init_replicas(PerReplica(), 5, tkeys.key(9))
    _assert_state_equal(got.states, want.states, "states")
    assert torch.equal(got.energy, want.energy) and torch.equal(got.key, want.key)


def test_serial_chain_kernels_refuse_cpu_tensors():
    pos = torch.zeros((2, 3, 2), dtype=torch.int32)
    key, t, betas = tkeys.key(1), torch.tensor(0), torch.ones(2)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        serial_chain.hp_moves_kernel(pos, key, t, betas, hmask=torch.ones(3, dtype=torch.bool),
                                     eps=1.0, n_moves=3)
    spins = torch.ones((2, 5, 5), dtype=torch.int8)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        serial_chain.single_flip_kernel(spins, key, t, betas, j=1.0, b=0.0,
                                        rule="metropolis", flips=2)
    # the op runs the plain version for CPU tensors
    out = ops.single_flip(spins, key, 0, betas, flips=2)
    assert out[0].shape == spins.shape and out[2].dtype == torch.int32
