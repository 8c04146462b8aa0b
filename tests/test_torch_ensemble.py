"""The ensemble axis (``n_chains > 1``) against the JAX package.

* Engine level: ``Engine.init(key)`` then three chunks with ``n_chains=2``
  on the per-sweep, interval-fused and whole-round paths, for Ising and
  Potts, in both packages from the same key (the JAX systems on their
  ``use_pallas=False`` paths, which the JAX package's own tests pin
  bit-equal to its Pallas kernels in interpret mode).  Chain ``c`` of the
  port's ensemble also equals a solo port run from ``fold_in(key, c)``.
* Carry: a JAX two-chain state after a warm-up, carried into the port with
  `repro_torch.carry.from_reference`, continues as the JAX engine does.
* Stats level: `chain_slice`, `chain_block` and `combine_chains` against the
  JAX twins on the same accumulators.
* CLI level: ``python -m repro_torch run --device cpu`` writes the manifest
  that ``python -m repro run`` writes for a copy of
  ``examples/specs/ising_small_fused.json`` with ``n_chains=2``,
  ``use_fused_round`` and ``pack_bits``.

Tolerances (those of test_torch_engine.py): states, rungs, energies (j=1,
b=0), sweep counters, swap and flow counters exact; Welford means and M2
within 1e-6 relative (XLA may contract ``m + d/n`` differently from torch),
M2 with an absolute floor of 4·eps·n·x²; per-interval observables within 1
ulp (XLA divides by L² as a reciprocal multiply); trace swap
probabilities within 4 ulps relative on every path (JAX's and torch's
sigmoid differ by up to 3 ulps; these inputs meet such arguments on the
fused and round paths too).
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import systems as jsystems  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.engine import stats as jstats  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.core import keys as tkeys  # noqa: E402
from repro_torch.core import systems as tsystems  # noqa: E402
from repro_torch.engine import Engine as TEngine  # noqa: E402
from repro_torch.engine import EngineConfig as TEngineConfig  # noqa: E402
from repro_torch.engine import stats as tstats  # noqa: E402

SPECS = Path(__file__).resolve().parents[1] / "examples" / "specs"
EXACT_STATS = ("n_records", "swap_attempts", "swap_accepts", "direction",
               "round_trips", "up_visits", "labeled_visits", "weight_sum")
F32_EPS = float(np.finfo(np.float32).eps)


def _systems(system, mode):
    fused = {"use_fused": mode != "sweep", "use_fused_round": mode == "round"}
    if system == "ising":
        params, obs = {"length": 6, "accept_rule": "glauber", **fused}, ("absmag",)
    else:
        params = {"shape": (6, 4), "q": 3, "accept_rule": "glauber", **fused}
        obs = ("pmag",)
    js = jsystems.make_system(system, params)
    ts = tsystems.make_system(system, params)
    return (js, jsystems.named_observables(system, js, obs),
            ts, tsystems.named_observables(system, ts, obs), obs)


def _assert_stats(tst, jst, obs):
    """Exact counters, Welford moments within 1e-6 relative."""
    for name in EXACT_STATS:
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)), err_msg=name)
    n = int(np.max(np.asarray(jst.n_records)))
    for k in ("energy",) + obs:
        jm, jm2 = np.asarray(jst.mean[k]), np.asarray(jst.m2[k])
        np.testing.assert_allclose(tst.mean[k].numpy(), jm, rtol=1e-6, atol=0, err_msg=k)
        x2 = float(np.max(np.abs(jm))) ** 2 + float(np.max(jm2))
        np.testing.assert_allclose(tst.m2[k].numpy(), jm2, rtol=1e-6,
                                   atol=4 * F32_EPS * n * x2, err_msg=k)


@pytest.mark.parametrize("system", ["ising", "potts"])
@pytest.mark.parametrize("mode", ["sweep", "fused", "round"])
def test_two_chains_match_jax_engine(system, mode):
    r, spi, chunk, c = 5, 3, 2, 2
    js, jobs, ts, tobs, obs = _systems(system, mode)
    cfg = dict(n_replicas=r, swap_interval=spi, chunk_intervals=chunk, n_chains=c,
               record_trace=True)
    temps = np.linspace(1.2, 3.8, r) if system == "ising" else np.geomspace(0.7, 2.9, r)
    jeng = JEngine(js, JEngineConfig(donate=False, **cfg), observables=jobs)
    jstate, jres = jeng.run(jeng.init(jax.random.key(21), temps), 3 * chunk * spi)
    teng = TEngine(ts, TEngineConfig(**cfg), observables=tobs, device="cpu")
    tstate, tres = teng.run(teng.init(tkeys.key(21), temps), 3 * chunk * spi)

    jpt, tpt = jstate.pt, tstate.pt
    assert tuple(tpt.states.shape) == (c, r, *jpt.states.shape[2:])
    for name in ("states", "rung", "energy", "t", "phase"):
        np.testing.assert_array_equal(getattr(tpt, name).numpy(),
                                      np.asarray(getattr(jpt, name)), err_msg=name)
    np.testing.assert_array_equal(tpt.key.numpy(),
                                  np.asarray(jax.random.key_data(jpt.key)).astype(np.int64))
    _assert_stats(tstate.stats, jstate.stats, obs)
    assert set(tres.trace) == set(jres.trace)
    for k, jv in jres.trace.items():  # chain-first (C, T, R)
        got = tres.trace[k].astype(jv.dtype)
        assert got.shape == jv.shape == (c, 3 * chunk, r), k
        if k in obs:
            np.testing.assert_allclose(got, jv, rtol=F32_EPS, atol=0, err_msg=k)
        elif k == "swap_prob":
            np.testing.assert_allclose(got, jv, rtol=4 * F32_EPS, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got, jv, err_msg=k)
    for k, jv in jres.summary.items():
        if k.startswith(("mean_", "var_")):
            np.testing.assert_allclose(tres.summary[k], jv, rtol=1e-6, atol=1e-12, err_msg=k)
        else:
            np.testing.assert_array_equal(tres.summary[k], jv, err_msg=k)


@pytest.mark.parametrize("system,mode", [("ising", "round"), ("potts", "fused"),
                                         ("ising", "sweep")])
def test_each_chain_equals_its_solo_run(system, mode):
    """Chain ``c`` of an ensemble is the solo run from ``fold_in(key, c)``:
    growing the ensemble never perturbs a chain."""
    _, _, ts, tobs, obs = _systems(system, mode)
    cfg = dict(n_replicas=4, swap_interval=2, chunk_intervals=3)
    temps = np.linspace(1.2, 3.8, 4)
    ens = TEngine(ts, TEngineConfig(n_chains=3, **cfg), observables=tobs, device="cpu")
    est, _ = ens.run(ens.init(tkeys.key(8), temps), 12)
    solo = TEngine(ts, TEngineConfig(**cfg), observables=tobs, device="cpu")
    for c in range(3):
        sst, _ = solo.run(solo.init(tkeys.fold_in(tkeys.key(8), c), temps), 12)
        for f in dataclasses.fields(sst.pt):
            assert torch.equal(getattr(est.pt, f.name)[c], getattr(sst.pt, f.name)), f.name
        chain = tstats.chain_slice(est.stats, c)
        for f in dataclasses.fields(sst.stats):
            a, b = getattr(chain, f.name), getattr(sst.stats, f.name)
            if isinstance(a, dict):
                assert all(torch.equal(a[k], b[k]) for k in b), f.name
            else:
                assert torch.equal(a, b), f.name


def _dump(state) -> dict:
    """A JAX EngineState as the flat numpy dict `carry.from_reference` reads."""
    pt = state.pt
    out = {"states": np.asarray(pt.states), "energy": np.asarray(pt.energy),
           "rung": np.asarray(pt.rung), "key": np.asarray(jax.random.key_data(pt.key)),
           "t": np.asarray(pt.t), "phase": np.asarray(pt.phase),
           "betas": np.asarray(state.betas)}
    for f in dataclasses.fields(state.stats):
        v = getattr(state.stats, f.name)
        if isinstance(v, dict):
            out.update({f"stats.{f.name}.{k}": np.asarray(a) for k, a in v.items()})
        else:
            out[f"stats.{f.name}"] = np.asarray(v)
    return out


def test_carried_two_chain_state_continues_like_jax():
    js, jobs, ts, tobs, obs = _systems("ising", "round")
    cfg = dict(n_replicas=5, swap_interval=2, chunk_intervals=2, n_chains=2)
    jeng = JEngine(js, JEngineConfig(donate=False, **cfg), observables=jobs)
    state, _ = jeng.run(jeng.init(jax.random.key(5), np.linspace(1.2, 3.8, 5)), 4)
    start = _dump(state)
    jstate, _ = jeng.run(state, 8)
    teng = TEngine(ts, TEngineConfig(**cfg), observables=tobs, device="cpu")
    carried = carry.from_reference(start, "cpu")
    assert tuple(carried.pt.t.shape) == (2,) and tuple(carried.pt.key.shape) == (2, 2)
    tstate, _ = teng.run(carried, 8)
    for name in ("states", "rung", "energy", "t", "phase"):
        np.testing.assert_array_equal(getattr(tstate.pt, name).numpy(),
                                      np.asarray(getattr(jstate.pt, name)), err_msg=name)
    _assert_stats(tstate.stats, jstate.stats, obs)


def _to_jax_stats(tst):
    """The port's accumulators as the JAX package's `OnlineStats`."""
    conv = lambda x: jax.numpy.asarray(x.numpy())
    kw = {}
    for f in dataclasses.fields(tst):
        v = getattr(tst, f.name)
        kw[f.name] = {k: conv(x) for k, x in v.items()} if isinstance(v, dict) else conv(v)
    return jstats.OnlineStats(**kw)


def test_chain_slices_and_combine_match_jax():
    _, _, ts, tobs, _ = _systems("ising", "fused")
    eng = TEngine(ts, TEngineConfig(n_replicas=5, swap_interval=2, n_chains=3),
                  observables=tobs, device="cpu")
    st, _ = eng.run(eng.init(tkeys.key(4), np.linspace(1.2, 3.8, 5)), 20)
    jst = _to_jax_stats(st.stats)
    got, want = tstats.combine_chains(st.stats), jstats.combine_chains(jst)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=k)
    for mine, theirs in ((tstats.chain_slice(st.stats, 1), jstats.chain_slice(jst, 1)),
                         (tstats.chain_block(st.stats, 1, 3), jstats.chain_block(jst, 1, 3))):
        s_got, s_want = tstats.summarize(mine), jstats.summarize(theirs)
        for k in s_want:
            np.testing.assert_array_equal(s_got[k], s_want[k], err_msg=k)


def test_cli_run_with_two_chains_round_and_pack_bits_matches_jax_cli(tmp_path):
    """``python -m repro_torch run --device cpu`` and ``python -m repro run``
    on a copy of ising_small_fused.json with n_chains=2, use_fused_round
    and pack_bits write the same manifest (both CLIs in this process)."""
    from repro.api import cli as jcli
    from repro_torch.api import cli as tcli

    d = json.loads((SPECS / "ising_small_fused.json").read_text())
    d["engine"]["n_chains"] = 2
    d["system"]["params"].update(use_fused_round=True, pack_bits=True)
    spec = tmp_path / "ising_small_round_packed_2chains.json"
    spec.write_text(json.dumps(d))
    assert jcli.main(["run", str(spec), "--out", str(tmp_path / "jax")]) == 0
    assert tcli.main(["run", str(spec), "--device", "cpu", "--out", str(tmp_path / "port"),
                      "--quiet"]) == 0
    jm = json.loads((tmp_path / "jax" / "manifest.json").read_text())
    tm = json.loads((tmp_path / "port" / "manifest.json").read_text())
    assert jm["final"] == tm["final"] and jm["spec"] == tm["spec"]
    assert np.shape(tm["final"]["energy"]) == (2, 8)
    for name, jp in jm["phases"].items():
        tp = tm["phases"][name]
        assert (jp["n_sweeps"], jp["ladder_history"]) == (tp["n_sweeps"], tp["ladder_history"])
        for k, v in jp["summary"].items():
            if k.startswith(("var_", "mean_")):
                np.testing.assert_allclose(tp["summary"][k], v, rtol=1e-6, atol=0, err_msg=k)
            else:
                assert tp["summary"][k] == v, (name, k)
