"""The port's q-state Potts model against the JAX package.

Same inputs (numpy, from a seed) through `repro` (its ``use_pallas=False``
paths, which its own tests pin bit-equal to the Pallas kernels in interpret
mode) and `repro_torch`:

* kernels: `ref.potts_sweep`, `ops.potts_sweep`, `ops.potts_sweep_fused`
  (``pack_bits`` both ways) and `ops.potts_round_fused` (K in {1, 2},
  DEO/SEO x logistic/metropolis); the 81-entry tables that kernels #4 and #5
  select from, replayed in torch against the plain sweep;
* the system: init, energy, ``pmag`` and one per-sweep step;
* whole runs: `Session` on a small Potts spec on each of its three paths,
  and a JAX Potts engine state carried over with `carry.from_reference`.

Tolerances: colours, rungs, acceptance and swap counters exact; ΔE and
energies exact at j=1 and within 4 ulps of the largest partial-sum
magnitude otherwise (the frameworks sum in different orders); swap
probabilities within 4 ulps relative; Welford means and variances within
1e-6 relative (XLA contracts the update differently).  An acceptance may
differ only where ``u`` lies between JAX's and torch's ``p`` for a ΔE the
run can meet (`_flip_possible`).
"""
import functools
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.api import Session as JSession  # noqa: E402
from repro.core import systems as jsystems  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.api import RunSpec as TRunSpec  # noqa: E402
from repro_torch.api import Session as TSession  # noqa: E402
from repro_torch.core import keys as tkeys  # noqa: E402
from repro_torch.core import systems as tsystems  # noqa: E402
from repro_torch.engine import Engine as TEngine  # noqa: E402
from repro_torch.engine import EngineConfig as TEngineConfig  # noqa: E402
from repro_torch.kernels import jax_uniform as tju  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import potts_sweep as tpk  # noqa: E402
from repro_torch.kernels import prng as tprng  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

F32_EPS = 2.0 ** -23


def _inputs(seed, q, r=6, h=8, w=6):
    rng = np.random.default_rng(seed)
    states = rng.integers(0, q, (r, h, w)).astype(np.int8)
    betas = (1.0 / np.geomspace(0.7, 2.9, r)).astype(np.float32)
    return rng, states, betas


def _flip_possible(u_acc, betas, j, rule):
    """Some acceptance uniform of ``u_acc`` (R, ...) lies between JAX's and
    torch's p of a ΔE its replica can meet (the 81 table entries)."""
    _, de = tpk.potts_tables(torch.ones(1), j=j, rule=rule)
    p_t = tref.accept_prob(de[None], torch.from_numpy(betas)[:, None], rule).numpy()
    p_j = np.asarray(jref.accept_prob(jnp.asarray(de.numpy())[None],
                                      jnp.asarray(betas)[:, None], rule))
    lo, hi = np.minimum(p_j, p_t), np.maximum(p_j, p_t)
    u = np.asarray(u_acc).reshape(u_acc.shape[0], -1)
    return any(np.any((u[r] >= a) & (u[r] < z))
               for r in range(u.shape[0]) for a, z in zip(lo[r], hi[r]) if a < z)


def _assert_de(got, want, nacc, j):
    got, want = np.asarray(got), np.asarray(want)
    if j == 1.0:
        np.testing.assert_array_equal(got, want)
    else:
        tol = 4 * F32_EPS * np.asarray(nacc, np.float64) * 4 * abs(j)
        assert np.all(np.abs(got.astype(np.float64) - want) <= tol)


def _same(got, want):
    """Colours and acceptance counts equal (ΔE is held by `_assert_de`)."""
    return all(np.array_equal(np.asarray(got[i]), np.asarray(want[i])) for i in (0, 2))


@pytest.mark.parametrize("q", [3, 5])
@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
@pytest.mark.parametrize("j", [1.0, 0.7])
def test_ref_potts_sweep_matches_jax(q, rule, j):
    rng, states, betas = _inputs(1, q)
    u = rng.random((6, 2, 2, 8, 6), dtype=np.float32)
    want = jref.potts_sweep(jnp.asarray(states), jnp.asarray(u), jnp.asarray(betas),
                            q=q, j=j, rule=rule)
    got = tref.potts_sweep(torch.from_numpy(states), torch.from_numpy(u),
                           torch.from_numpy(betas), q=q, j=j, rule=rule)
    if not _same([g.numpy() for g in got], want):
        assert _flip_possible(u[:, :, 1], betas, j, rule), "sweep differs outside the ulp gap"
        return
    _assert_de(got[1].numpy(), want[1], want[2], j)


@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
def test_ops_potts_sweep_matches_jax(rule):
    rng, states, betas = _inputs(2, 3)
    u = rng.random((6, 2, 2, 8, 6), dtype=np.float32)
    want = jops.potts_sweep(jnp.asarray(states), jnp.asarray(u), jnp.asarray(betas),
                            q=3, rule=rule, use_pallas=False)
    got = tops.potts_sweep(torch.from_numpy(states), torch.from_numpy(u),
                           torch.from_numpy(betas), q=3, rule=rule, use_pallas=True)
    if not _same([g.numpy() for g in got], want):
        assert _flip_possible(u[:, :, 1], betas, 1.0, rule)
        return
    _assert_de(got[1].numpy(), want[1], want[2], 1.0)


def _table_sweep(states, u, betas, *, q, j, rule):
    """Kernel #4's arithmetic replayed in torch: per-site table index of the
    four direction terms, then ΔE and p selected from `potts_tables`."""
    p_tab, de_tab = tpk.potts_tables(betas, j=j, rule=rule)
    h, w = states.shape[-2:]
    par = tref.parity(h, w, states.device)
    s = states.to(torch.int64)
    de_total = torch.zeros(states.shape[0])
    n_acc = torch.zeros(states.shape[0], dtype=torch.int32)
    for c in (0, 1):
        d = 1 + torch.floor(u[:, c, 0] * (q - 1)).to(torch.int64)
        trial = (s + d) % q
        k = torch.zeros_like(s)
        for place, (dim, shift) in zip((27, 9, 3, 1), tref.POTTS_DIRECTIONS):
            nbr = torch.roll(s, shift, dim)
            k = k + place * (1 + (s == nbr).long() - (trial == nbr).long())
        p = torch.gather(p_tab, 1, k.reshape(k.shape[0], -1)).reshape(k.shape)
        accept = (u[:, c, 1] < p) & (par == c)
        s = torch.where(accept, trial, s)
        de_total = de_total + torch.where(accept, de_tab[k], 0.0).sum(dim=(-2, -1))
        n_acc = n_acc + accept.sum(dim=(-2, -1), dtype=torch.int32)
    return s.to(torch.int8), de_total, n_acc


@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
@pytest.mark.parametrize("j", [1.0, 0.7, -1.3])
def test_potts_tables_reproduce_the_plain_sweep(rule, j):
    """Selecting ΔE and p from the 81-entry rows, as kernels #4 and #5 do,
    is bit-equal to the plain sweep for any j and rule."""
    rng, states, betas = _inputs(3, 5)
    u = torch.from_numpy(rng.random((6, 2, 2, 8, 6), dtype=np.float32))
    args = (torch.from_numpy(states), u, torch.from_numpy(betas))
    got = _table_sweep(*args, q=5, j=j, rule=rule)
    want = tref.potts_sweep(*args, q=5, j=j, rule=rule)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@functools.cache
def _jax_sweep_fused(rule, n_sweeps, q, seed, t0):
    """JAX's ``use_pallas=False`` fused sweeps, computed once per case: that
    path does not read ``pack_bits`` (its Pallas kernel is pinned bitwise
    equal either way), so one reference serves both of the port's cases."""
    _, states, betas = _inputs(4, q, r=5)
    return jops.potts_sweep_fused(
        jnp.asarray(states), jax.random.key(seed), jnp.int32(t0), jnp.asarray(betas),
        n_sweeps=n_sweeps, q=q, rule=rule, use_pallas=False,
    )


@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
@pytest.mark.parametrize("pack_bits", [False, True])
@pytest.mark.parametrize("n_sweeps", [1, 3])
def test_potts_sweep_fused_matches_jax(rule, pack_bits, n_sweeps):
    q = 3 if n_sweeps == 1 else 5
    _, states, betas = _inputs(4, q, r=5)
    t0, seed = 19, 6
    want = _jax_sweep_fused(rule, n_sweeps, q, seed, t0)
    got = tops.potts_sweep_fused(
        torch.from_numpy(states), tkeys.key(seed), t0, torch.from_numpy(betas),
        n_sweeps=n_sweeps, q=q, rule=rule, pack_bits=pack_bits,
    )
    if not _same([g.numpy() for g in got], want):
        words = tprng.key_words(tkeys.key(seed))
        u = torch.cat([tprng.potts_sweep_uniforms(words, t0 + i, torch.arange(5), 8, 6)[:, :, 1]
                       for i in range(n_sweeps)], dim=1)
        assert _flip_possible(u.numpy(), betas, 1.0, rule)
        return
    _assert_de(got[1].numpy(), want[1], want[2], 1.0)


@pytest.mark.parametrize("pairing", ["deo", "seo"])
@pytest.mark.parametrize("criterion", ["logistic", "metropolis"])
@pytest.mark.parametrize("n_rounds", [1, 2])
def test_potts_round_fused_matches_jax(pairing, criterion, n_rounds):
    _, states, betas = _inputs(5, 3)
    rung = np.random.default_rng(9).permutation(6).astype(np.int32)
    energy = np.asarray([-80.0 + 8 * i for i in range(6)], np.float32)[rung]
    t0, ph0, seed = 4, 3, 2
    kw = dict(n_sweeps=2, n_rounds=n_rounds, q=3, rule="glauber", criterion=criterion,
              pairing=pairing, pack_bits=n_rounds == 2)
    want = jops.potts_round_fused(
        jnp.asarray(states), jax.random.key(seed), jnp.int32(t0), jnp.int32(ph0),
        jnp.asarray(rung), jnp.asarray(energy), jnp.asarray(betas), use_pallas=False, **kw,
    )
    got = tops.potts_round_fused(
        torch.from_numpy(states), tkeys.key(seed), t0, ph0, torch.from_numpy(rung),
        torch.from_numpy(energy), torch.from_numpy(betas), **kw,
    )
    want = [np.asarray(x) for x in want]
    got = [x.numpy() for x in got]
    words = tprng.key_words(tkeys.key(seed))
    for k in range(n_rounds):
        diff = got[4][k] != want[4][k]
        if diff.any():  # a swap decision flipped: only inside the ulp gap
            u = tprng.swap_uniforms(words, ph0 + k, 6).numpy()
            lo, hi = np.minimum(got[5][k], want[5][k]), np.maximum(got[5][k], want[5][k])
            assert np.all(((u >= lo) & (u < hi))[diff])
            return
    for name, g, w in zip(("states", "rung", "energy", "nacc"), got[:4], want[:4]):
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(got[6], want[6])
    np.testing.assert_allclose(got[5], want[5], rtol=4 * F32_EPS, atol=0)


def test_pack_bits_keeps_the_q_limit():
    with pytest.raises(ValueError, match="q <= 64"):
        tsystems.make_system("potts", {"shape": (4, 4), "q": 65, "use_fused": True,
                                       "pack_bits": True})
    with pytest.raises(ValueError, match="q <= 64"):
        tops.potts_sweep_fused(torch.zeros((1, 4, 4), dtype=torch.int8), tkeys.key(0), 0,
                               torch.ones(1), n_sweeps=1, q=65, pack_bits=True)


def test_system_init_energy_obs_and_step_match_jax():
    params = {"shape": (6, 4), "q": 4, "j": 0.9, "accept_rule": "glauber"}
    js = jsystems.make_system("potts", params)
    ts = tsystems.make_system("potts", {**params, "shape": [6, 4]})
    k = jax.random.split(jax.random.key(8), 5)
    states = np.asarray(jax.vmap(js.init_state)(k))
    got = ts.init_state_batched(torch.from_numpy(np.asarray(jax.random.key_data(k)).astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), states)
    np.testing.assert_array_equal(ts.batched_energy(got).numpy(),
                                  np.asarray(jax.vmap(js.energy)(jnp.asarray(states))))
    pm = tsystems.named_observables("potts", ts, ["pmag"])["pmag"](got).numpy()
    np.testing.assert_allclose(pm, np.asarray(jax.vmap(js.magnetization)(jnp.asarray(states))),
                               rtol=F32_EPS, atol=0)
    # one per-sweep step: JAX derives the replica keys, the port the uniforms
    betas = (1.0 / np.linspace(0.7, 2.9, 5)).astype(np.float32)
    root, t = jax.random.key(2), 7
    keys_r = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.fold_in(root, 2 * t), jnp.arange(5, dtype=jnp.uint32))
    want = js.batched_mcmc_step(keys_r, jnp.asarray(states), jnp.asarray(betas))
    step = ts.batched_mcmc_step(tkeys.key(2), torch.tensor(t), got, torch.from_numpy(betas))
    if not _same([s.numpy() for s in step], want):
        u = tju.jax_uniform_plain(tkeys.key(2), torch.tensor(t), torch.arange(5), (2, 2, 6, 4))
        assert _flip_possible(u[:, :, 1].numpy(), betas, 0.9, "glauber")
        return
    _assert_de(step[1].numpy(), want[1], want[2], 0.9)


def _potts_spec(path):
    params = {"shape": [6, 4], "q": 3, "accept_rule": "glauber",
              "use_fused": path != "sweep", "use_fused_round": path == "round"}
    return {
        "spec_version": 1,
        "system": {"name": "potts", "params": params},
        "ladder": {"kind": "geometric", "n_replicas": 6, "t_min": 0.7, "t_max": 2.9},
        "engine": {"swap_interval": 5, "chunk_intervals": 4},
        "adapt": {"target": 0.3, "min_attempts_per_pair": 3, "max_rounds": 2},
        "schedule": {"phases": [
            {"name": "burn", "n_sweeps": 60, "adapt": True},
            {"name": "measure", "n_sweeps": 60, "reset_stats": True},
        ]},
        "observables": ["pmag"],
        "seed": 3,
    }


@pytest.mark.parametrize("path", ["sweep", "fused", "round"])
def test_potts_session_matches_jax_from_seed(path):
    d = _potts_spec(path)
    jres = JSession(JRunSpec.from_json(json.dumps(d))).run()
    tres = TSession(TRunSpec.from_json(json.dumps(d)), device="cpu").run()
    jm, tm = jres.manifest(), tres.manifest()
    assert jm["final"] == tm["final"]
    np.testing.assert_array_equal(tres.state.pt.states.numpy(), np.asarray(jres.state.pt.states))
    np.testing.assert_array_equal(tres.state.pt.rung.numpy(), np.asarray(jres.state.pt.rung))
    for name, jp in jm["phases"].items():
        tp = tm["phases"][name]
        assert jp["ladder_history"] == tp["ladder_history"]
        for k, v in jp["summary"].items():
            if k.startswith(("var_", "mean_")):
                np.testing.assert_allclose(tp["summary"][k], v, rtol=1e-6, atol=0, err_msg=k)
            else:
                assert tp["summary"][k] == v, (name, k)


def test_carry_from_reference_takes_a_potts_state():
    """A JAX Potts engine state (int8 colours) carried into the port runs on
    to the same state."""
    params = {"shape": (4, 6), "q": 3, "accept_rule": "glauber", "use_fused": True,
              "use_fused_round": True}
    js = jsystems.make_system("potts", params)
    jeng = JEngine(js, JEngineConfig(n_replicas=4, swap_interval=3, donate=False))
    state = jeng.init(jax.random.key(5), np.linspace(0.8, 2.5, 4))
    state, _ = jeng.run(state, 6)
    pt = state.pt
    arrays = {"states": np.asarray(pt.states), "energy": np.asarray(pt.energy),
              "rung": np.asarray(pt.rung), "key": np.asarray(jax.random.key_data(pt.key)),
              "t": np.asarray(pt.t), "phase": np.asarray(pt.phase)}
    got = carry.from_reference(arrays, "cpu")
    assert got.states.dtype == torch.int8 and got.states.shape == (4, 4, 6)
    jend, _ = jeng.run(state, 6)
    teng = TEngine(tsystems.make_system("potts", params),
                   TEngineConfig(n_replicas=4, swap_interval=3), device="cpu")
    tstate = teng.init(tkeys.key(5), np.linspace(0.8, 2.5, 4))
    tstate.pt = got
    tstate.betas = torch.from_numpy(np.array(state.betas))
    tend, _ = teng.run(tstate, 6)
    np.testing.assert_array_equal(tend.pt.states.numpy(), np.asarray(jend.pt.states))
    np.testing.assert_array_equal(tend.pt.rung.numpy(), np.asarray(jend.pt.rung))
    np.testing.assert_array_equal(tend.pt.energy.numpy(), np.asarray(jend.pt.energy))
