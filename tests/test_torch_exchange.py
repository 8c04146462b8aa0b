"""The port's exchange layer against the JAX package, from the same seed.

* ``core.keys.permutation`` equals ``jax.random.permutation`` word for word;
* every strategy's proposal (DEO, SEO, windowed at window 2, 3, 4 and n,
  VMPT) equals JAX's at both phase parities;
* SEO, windowed (2, 3, 4, n), VMPT and DEO with ``swap_mode="state"`` on
  the interval-fused and per-sweep paths: one interval, then a 20-sweep
  run, both engines started from one seed (the JAX side on its non-Pallas
  references);
* ``flow_optimized_ladder`` equals JAX's on random flows and on a
  degenerate gap, and a flow-mode Session retunes to JAX's ladders;
* refusals: the round path takes only temp-mode DEO/SEO, and flow mode
  only ``swap_mode="temp"``, with the JAX package's errors;
* ``run_conformance(exchange=...)`` on a shortened Ising entry gives JAX's
  report with windowed and VMPT, and ``validate --exchange`` refuses an
  unknown name.

Tolerances: spins, rungs, sweep and phase counters, key words, energies
(integers at j=1, b=0), swap and flow counters and record weights' sums are
exact.  Swap probabilities, VMPT's ``est_weight`` (built from them) and the
pre-swap observables are within 4 ulps relative (JAX's and torch's
sigmoid differ by up to 3, test_torch_kernels) and 1 ulp (XLA divides by
L² as a multiply by the reciprocal, test_torch_engine); Welford means and
M2 within 1e-6 relative (M2 with the absolute floor of test_torch_engine).
"""
import dataclasses
import json
from pathlib import Path

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
from repro.engine import adapt as jadapt  # noqa: E402
from repro.exchange import make_strategy as jmake  # noqa: E402
from repro.validate import run_conformance as jrun  # noqa: E402
from repro_torch.api import RunSpec as TRunSpec  # noqa: E402
from repro_torch.api import Session as TSession  # noqa: E402
from repro_torch.core import keys as tkeys  # noqa: E402
from repro_torch.core import systems as tsystems  # noqa: E402
from repro_torch.engine import AdaptConfig as TAdaptConfig  # noqa: E402
from repro_torch.engine import Engine as TEngine  # noqa: E402
from repro_torch.engine import EngineConfig as TEngineConfig  # noqa: E402
from repro_torch.engine import adapt as tadapt  # noqa: E402
from repro_torch.exchange import make_strategy as tmake  # noqa: E402
from repro_torch.validate import run_conformance as trun  # noqa: E402

SPECS = Path(__file__).resolve().parents[1] / "examples" / "specs"
OBS = ("absmag", "energy_per_site")
F32 = 2.0 ** -23
R, L, SPI = 6, 6, 4
EXACT_STATS = ("n_records", "swap_attempts", "swap_accepts", "direction",
               "round_trips", "up_visits", "labeled_visits", "weight_sum")


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 64])
def test_permutation_matches_jax(n):
    for seed in (0, 7, 2 ** 31 - 1):
        want = np.asarray(jax.random.permutation(jax.random.key(seed), n))
        got = tkeys.permutation(tkeys.key(seed), n).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,params", [
    ("deo", {}), ("seo", {}), ("vmpt", {}), ("windowed", {"window": 2}),
    ("windowed", {"window": 3}), ("windowed", {"window": 4}),
    ("windowed", {"window": 13}),
], ids=["deo", "seo", "vmpt", "windowed2", "windowed3", "windowed4", "windowed-n"])
def test_proposals_match_jax(name, params):
    js, ts = jmake(name, params), tmake(name, params)
    for n in (1, 2, 5, 13):
        for seed in range(3):
            for phase in (0, 1, 7):
                want = np.asarray(js.propose_pairs(jax.random.key(seed), jnp.int32(phase), n))
                got = ts.propose_pairs(tkeys.key(seed), torch.tensor(phase), n).numpy()
                np.testing.assert_array_equal(got, want, err_msg=f"n={n} {seed} {phase}")
                assert sorted(got[got]) == list(range(n))  # an involution


def _dump(state) -> dict:
    pt = state.pt
    out = {"states": pt.states, "energy": pt.energy, "rung": pt.rung, "t": pt.t,
           "phase": pt.phase, "key": jax.random.key_data(pt.key), "betas": state.betas}
    for f in EXACT_STATS:
        out[f"stats.{f}"] = getattr(state.stats, f)
    for k in state.stats.mean:
        out[f"mean.{k}"] = state.stats.mean[k]
        out[f"m2.{k}"] = state.stats.m2[k]
    return {k: np.asarray(v) for k, v in out.items()}


def _tdump(state) -> dict:
    pt = state.pt
    out = {"states": pt.states, "energy": pt.energy, "rung": pt.rung, "t": pt.t,
           "phase": pt.phase, "key": pt.key, "betas": state.betas}
    for f in EXACT_STATS:
        out[f"stats.{f}"] = getattr(state.stats, f)
    for k in state.stats.mean:
        out[f"mean.{k}"] = state.stats.mean[k]
        out[f"m2.{k}"] = state.stats.m2[k]
    return {k: v.numpy() for k, v in out.items()}


def assert_states_match(got: dict, want: dict):
    for k, v in want.items():
        if k.startswith(("mean.", "m2.")):
            continue
        np.testing.assert_array_equal(got[k].astype(v.dtype), v, err_msg=k)
    n = float(np.max(want["stats.n_records"])) + 1.0
    for k in (k for k in want if k.startswith("mean.")):
        s = k[len("mean."):]
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0, err_msg=k)
        x2 = float(np.max(np.abs(want[k]))) ** 2 + float(np.max(want[f"m2.{s}"]))
        np.testing.assert_allclose(got[f"m2.{s}"], want[f"m2.{s}"], rtol=1e-6,
                                   atol=4 * F32 * n * x2, err_msg=f"m2.{s}")


def assert_traces_match(got: dict, want: dict):
    for k, v in want.items():
        g = np.asarray(got[k]).astype(v.dtype)
        if k in ("swap_prob", "est_weight"):
            # from JAX's / torch's sigmoid: up to 3 ulps apart; 1 - p moves
            # by the same absolute amount
            np.testing.assert_allclose(g, v, rtol=0, atol=4 * F32, err_msg=k)
        elif k in OBS:
            np.testing.assert_allclose(g, v, rtol=F32, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, v, err_msg=k)


CASES = {
    "seo": dict(exchange="seo"),
    "windowed2": dict(exchange=("windowed", {"window": 2})),
    "windowed3": dict(exchange=("windowed", {"window": 3})),
    "windowed4": dict(exchange=("windowed", {"window": 4})),
    "windowed-n": dict(exchange=("windowed", {"window": R})),
    "vmpt": dict(exchange="vmpt"),
    "state": dict(swap_mode="state"),
}


def _engines(path, case):
    params = {"length": L, "accept_rule": "glauber", "use_fused": path == "fused"}
    js = jsystems.make_system("ising", params)
    ts = tsystems.make_system("ising", params)
    kw = dict(CASES[case])
    ex = kw.pop("exchange", "deo")
    name, p = (ex, {}) if isinstance(ex, str) else ex
    # one chunk length, so JAX compiles one executable per engine
    cfg = dict(n_replicas=R, swap_interval=SPI, chunk_intervals=1, record_trace=True, **kw)
    jeng = JEngine(js, JEngineConfig(donate=False, exchange=jmake(name, p), **cfg),
                   observables=jsystems.named_observables("ising", js, OBS))
    teng = TEngine(ts, TEngineConfig(exchange=tmake(name, p), **cfg),
                   observables=tsystems.named_observables("ising", ts, OBS), device="cpu")
    return jeng, teng


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("path", ["fused", "sweep"])
def test_strategy_runs_match_jax(path, case):
    jeng, teng = _engines(path, case)
    temps = np.geomspace(1.3, 4.0, R)
    jst = jeng.init(jax.random.key(11), temps)
    tst = teng.init(tkeys.key(11), temps)
    assert_states_match(_tdump(tst), _dump(jst))
    jst, jres = jeng.run(jst, SPI)  # one interval
    tst, tres = teng.run(tst, SPI)
    assert_traces_match(tres.trace, jres.trace)
    assert_states_match(_tdump(tst), _dump(jst))
    jst, jres = jeng.run(jst, 20)  # then a 20-sweep run
    tst, tres = teng.run(tst, 20)
    assert_traces_match(tres.trace, jres.trace)
    got = _tdump(tst)
    assert_states_match(got, _dump(jst))
    if case == "state":  # rungs pinned, lattices moved with their energies
        np.testing.assert_array_equal(got["rung"], np.arange(R))
        np.testing.assert_array_equal(
            got["energy"], teng.system.batched_energy(tst.pt.states).numpy())
    if case == "vmpt":  # weights over both outcomes: every rung gains 1 a record
        assert jres.trace["est_weight"].shape == (5, 2, R)
        np.testing.assert_array_equal(got["stats.weight_sum"], np.full(R, 6.0, np.float32))


def test_flow_optimized_ladder_matches_jax():
    rng = np.random.default_rng(4)
    for r in (2, 3, 8, 33):
        temps = np.sort(rng.uniform(0.5, 5.0, r))
        for rate in (1.0, 0.5, 0.2):
            flow = rng.uniform(0.0, 1.0, r)
            got = tadapt.flow_optimized_ladder(temps, flow, rate=rate)
            want = jadapt.flow_optimized_ladder(temps, flow, rate=rate)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    # a collapsed interior gap, and a fully collapsed ladder
    for temps in (np.array([1.0, 2.0, 2.0, 3.0]), np.full(4, 2.0)):
        flow = np.array([1.0, 0.6, 0.4, 0.0])
        np.testing.assert_array_equal(tadapt.flow_optimized_ladder(temps, flow),
                                      jadapt.flow_optimized_ladder(temps, flow))


def _flow_spec(path):
    d = json.loads((SPECS / "ising_small_fused.json").read_text())
    d["system"]["params"].update(length=4, use_pallas=False, use_fused=path == "fused")
    d["ladder"] = {"kind": "geometric", "n_replicas": 6, "t_min": 1.5, "t_max": 4.0}
    d["adapt"] = {"mode": "flow", "rate": 0.5, "flow_min_visits": 20, "max_rounds": 2}
    d["engine"] = {"swap_interval": 2, "chunk_intervals": 20}
    d["schedule"]["phases"] = [{"name": "burn", "n_sweeps": 240, "adapt": True},
                               {"name": "measure", "n_sweeps": 40, "reset_stats": True}]
    return d


@pytest.mark.parametrize("path", ["fused", "sweep"])
def test_flow_mode_retunes_to_jax_ladders(path):
    d = _flow_spec(path)
    jres = JSession(JRunSpec.from_json(d)).run()
    tres = TSession(TRunSpec.from_json(d), device="cpu").run()
    jh = jres.phases["burn"].ladder_history
    th = tres.phases["burn"].ladder_history
    assert len(jh) > 1  # retuned at least once
    np.testing.assert_array_equal(th, jh)
    jm, tm = jres.manifest(), tres.manifest()
    assert jm["final"] == tm["final"]
    for k in ("swap_attempts", "swap_acceptance", "round_trips", "flow_up"):
        assert jm["phases"]["measure"]["summary"][k] == tm["phases"]["measure"]["summary"][k]


def test_round_path_and_flow_refuse_what_jax_refuses():
    ising = tsystems.make_system("ising", {"length": 4, "use_fused": True,
                                           "use_fused_round": True})
    for kw in ({"swap_mode": "state"}, {"exchange": "vmpt"}, {"exchange": "windowed"}):
        with pytest.raises(ValueError, match="supports only temp-mode DEO/SEO"):
            TEngine(ising, TEngineConfig(n_replicas=4, **kw), device="cpu")
    with pytest.raises(ValueError, match="only exists in swap_mode='temp'"):
        TEngine(tsystems.make_system("ising", {"length": 4}),
                TEngineConfig(n_replicas=4, swap_mode="state"),
                adapt=TAdaptConfig(mode="flow"), device="cpu")


# windowed credits attempts to the lower rung of a pair of any span, so some
# gaps gather attempts slowly: a burn long enough for both retunes
SHORT = dict(burn_sweeps=600, n_batches=4, sweeps_per_batch=100)


@pytest.mark.parametrize("strategy", ["windowed", "vmpt"])
def test_short_conformance_report_matches_jax(strategy):
    """`run_conformance(exchange=...)` on a shortened Ising entry (the
    interval-fused path) gives JAX's report: VMPT's means are its weighted
    Welford means (within 1e-6 relative, the moments' tolerance).  The MCSE
    is the spread of the batch means, so a batch mean off by 1e-6 of its
    size moves it by at most that much, absolute."""
    fused = {"use_fused": True, "use_pallas": True}
    got = trun(dataclasses.replace(tsystems.REGISTRY["ising"], **SHORT), seed=0,
               exchange=strategy, system_params=fused, device="cpu")
    want = jrun(dataclasses.replace(jsystems.REGISTRY["ising"], **SHORT), seed=0,
                exchange=strategy, system_params={**fused, "use_pallas": False})
    assert (got.n_retunes, got.n_batches) == (want.n_retunes, want.n_batches)
    np.testing.assert_allclose(got.temps, want.temps, rtol=1e-6, atol=0)
    for k in want.means:
        np.testing.assert_allclose(got.means[k], want.means[k], rtol=1e-6, atol=0, err_msg=k)
        np.testing.assert_allclose(got.mcse[k], want.mcse[k], rtol=1e-6,
                                   atol=1e-6 * np.abs(want.means[k]).max(), err_msg=k)


def test_cli_validate_refuses_an_unknown_strategy(capsys):
    from repro_torch.api import cli as tcli

    assert tcli.main(["validate", "ising", "--exchange", "bogus", "--device", "cpu"]) == 2
    assert "unknown exchange strategy 'bogus'" in capsys.readouterr().err
