"""The port's engine and Session against the JAX package, from the same state.

* Engine level: one JAX engine state (after a warm-up chunk, so counters,
  ``t`` and ``phase`` are non-trivial) is carried into the port with
  `repro_torch.carry.from_reference`; both then run 3 chunks of the
  whole-round path and of the interval-fused path.
  The per-sweep default path (``use_fused=False``) runs the same chunks.
* Slice level: ``Session(spec).run()`` in both packages from the spec's seed
  for ``examples/specs/ising_small_fused.json``, its ``use_fused_round``
  variant and ``examples/specs/ising_small.json`` (the per-sweep path); the
  JAX side with ``use_pallas=False``, which its own tests pin bit-equal to
  the Pallas kernels in interpret mode.  ``python -m repro_torch run
  examples/specs/ising_small.json --device cpu`` writes the manifest that
  ``python -m repro run`` writes.

Tolerances: spins, rungs, energies (j=1, b=0), sweep counters, swap
attempt/accept counters and flow counters are exact; per-interval
observables (a mean over L² sites) within 1 ulp, because inside its fused
scan XLA may divide by L² as a multiply by the reciprocal; the Welford means
and M2 are held to rtol 1e-6 because XLA may contract ``m + d/n`` and
``m2 + d*(x-m)`` differently from torch (observed: 1 ulp on a mean); M2,
a sum with cancellation, also gets an absolute floor of 4·eps·n·x².
Swap probabilities in the per-sweep chunks' trace are held within 4 ulps
relative, the bound of JAX's and torch's sigmoid (test_torch_kernels).
The single allowed divergence is a decision flipped inside the ulp gap
between the two frameworks' exp/sigmoid; `_explain_divergence` finds the
first diverging interval and requires that.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.api import Session as JSession  # noqa: E402
from repro.core import systems as jsystems  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.api import RunSpec as TRunSpec  # noqa: E402
from repro_torch.api import Session as TSession  # noqa: E402
from repro_torch.core import keys as tkeys  # noqa: E402
from repro_torch.core import systems as tsystems  # noqa: E402
from repro_torch.engine import Engine as TEngine  # noqa: E402
from repro_torch.engine import EngineConfig as TEngineConfig  # noqa: E402
from repro_torch.kernels import jax_uniform as tju  # noqa: E402
from repro_torch.kernels import prng as tprng  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

SPECS = Path(__file__).resolve().parents[1] / "examples" / "specs"
SPEC = SPECS / "ising_small_fused.json"
OBS = ("absmag", "energy_per_site")
EXACT_STATS = ("n_records", "swap_attempts", "swap_accepts", "direction",
               "round_trips", "up_visits", "labeled_visits", "weight_sum")
_NBR = np.array([-4.0, -2.0, 0.0, 2.0, 4.0], np.float32)


def _dump(state) -> dict:
    """A JAX EngineState as the flat numpy dict `carry.from_reference` reads."""
    pt = state.pt
    out = {
        "states": np.asarray(pt.states), "energy": np.asarray(pt.energy),
        "rung": np.asarray(pt.rung), "key": np.asarray(jax.random.key_data(pt.key)),
        "t": np.asarray(pt.t), "phase": np.asarray(pt.phase),
        "betas": np.asarray(state.betas),
    }
    for f in dataclasses.fields(state.stats):
        v = getattr(state.stats, f.name)
        if isinstance(v, dict):
            out.update({f"stats.{f.name}.{k}": np.asarray(a) for k, a in v.items()})
        else:
            out[f"stats.{f.name}"] = np.asarray(v)
    return out


def _sweep_flip_possible(u, ladders, rule):
    """Some uniform lies in the gap between JAX's and torch's acceptance p of
    a (beta, ΔE) pair the run can meet (any rung of any ladder it used)."""
    s = np.array([-1.0, 1.0], np.float32)[:, None]
    betas = np.unique(np.concatenate([np.asarray(x, np.float32).ravel() for x in ladders]))
    de = 2.0 * s * (1.0 * _NBR[None] - 0.0)
    p_j = np.asarray(jref.accept_prob(
        jax.numpy.asarray(de)[None], jax.numpy.asarray(betas)[:, None, None], rule))
    p_t = tref.accept_prob(torch.from_numpy(de)[None],
                           torch.from_numpy(betas)[:, None, None], rule).numpy()
    lo, hi = np.minimum(p_j, p_t).ravel(), np.maximum(p_j, p_t).ravel()
    u = np.asarray(u).ravel()
    return any(np.any((u >= a) & (u < z)) for a, z in zip(lo, hi) if a < z)


def _explain_divergence(jtrace, ttrace, *, mode, words, k_run, t0, phase0,
                        spi, r, length, ladders, rule):
    """Assert the first interval where the traces differ is an ulp-gap flip."""
    n = len(jtrace["energy"])
    for k in range(n):
        acc_diff = jtrace["swap_accept"][k] != ttrace["swap_accept"][k]
        e_same = np.array_equal(jtrace["energy"][k], ttrace["energy"][k])
        if e_same and not acc_diff.any():
            continue
        if e_same:  # the sweeps agreed: a swap decision flipped
            if mode == "round":
                u = tprng.swap_uniforms(words, phase0 + k, r).numpy()
            else:
                t_k = t0 + (k + 1) * spi
                u = tkeys.uniform(tkeys.fold_in(k_run, 2 * t_k + 1), (r,)).numpy()
            p_j, p_t = jtrace["swap_prob"][k], ttrace["swap_prob"][k]
            lo, hi = np.minimum(p_j, p_t), np.maximum(p_j, p_t)
            assert np.all(((u >= lo) & (u < hi))[acc_diff]), (
                f"swap decision differs outside the ulp gap at interval {k}")
            return k
        ts = [t0 + k * spi + i for i in range(spi)]
        if mode == "sweep":  # the jax.random per-sweep stream
            us = [tju.jax_uniform_plain(k_run, torch.tensor(t), torch.arange(r),
                                        (2, length, length)) for t in ts]
        else:
            us = [tprng.ising_sweep_uniforms(words, t, torch.arange(r), length) for t in ts]
        assert _sweep_flip_possible(torch.stack(us).numpy(), ladders, rule), (
            f"sweeps differ outside the ulp gap at interval {k}")
        return k
    raise AssertionError("final states differ but the traces agree")


def _systems(mode):
    params = {"length": 6, "accept_rule": "glauber", "use_fused": mode != "sweep",
              "use_fused_round": mode == "round"}
    js = jsystems.make_system("ising", params)
    ts = tsystems.make_system("ising", params)
    return (js, jsystems.named_observables("ising", js, OBS),
            ts, tsystems.named_observables("ising", ts, OBS))


@pytest.mark.parametrize("mode", ["round", "fused", "sweep"])
def test_engine_chunks_from_one_state_match_jax(mode):
    r, spi, chunk = 6, 3, 2
    js, jobs, ts, tobs = _systems(mode)
    cfg = dict(n_replicas=r, swap_interval=spi, chunk_intervals=chunk, record_trace=True)
    jeng = JEngine(js, JEngineConfig(donate=False, **cfg), observables=jobs)
    temps = np.linspace(1.2, 3.8, r)
    state = jeng.init(jax.random.key(21), temps)
    state, _ = jeng.run(state, chunk * spi)  # warm-up: non-trivial t/phase/stats
    start = _dump(state)
    jstate, jres = jeng.run(state, 3 * chunk * spi)

    teng = TEngine(ts, TEngineConfig(**cfg), observables=tobs, device="cpu")
    tstate, tres = teng.run(carry.from_reference(start, "cpu"), 3 * chunk * spi)

    end = _dump(jstate)
    same = np.array_equal(end["states"], tstate.pt.states.numpy()) and np.array_equal(
        end["stats.swap_accepts"], tstate.stats.swap_accepts.numpy())
    if not same:
        _explain_divergence(
            jres.trace, tres.trace, mode=mode,
            words=tprng.key_words(torch.from_numpy(start["key"].astype(np.int64))),
            k_run=torch.from_numpy(start["key"].astype(np.int64)),
            t0=int(start["t"]), phase0=int(start["phase"]), spi=spi, r=r, length=6,
            ladders=[start["betas"]], rule="glauber",
        )
        return
    got = tstate.pt
    for name, v in (("states", got.states), ("rung", got.rung), ("energy", got.energy),
                    ("t", got.t), ("phase", got.phase)):
        np.testing.assert_array_equal(v.numpy(), end[name], err_msg=name)
    for name in EXACT_STATS:
        np.testing.assert_array_equal(
            getattr(tstate.stats, name).numpy(), end[f"stats.{name}"], err_msg=name)
    for k in ("energy",) + OBS:
        np.testing.assert_allclose(tstate.stats.mean[k].numpy(), end[f"stats.mean.{k}"],
                                   rtol=1e-6, atol=0)
        # M2 sums n squared deviations: an ulp in the mean moves each term by
        # ~eps·x², so its absolute error scale is eps·n·max(x²)
        x2 = float(np.max(np.abs(end[f"stats.mean.{k}"]))) ** 2 + float(
            np.max(end[f"stats.m2.{k}"]))
        np.testing.assert_allclose(
            tstate.stats.m2[k].numpy(), end[f"stats.m2.{k}"], rtol=1e-6,
            atol=4 * np.finfo(np.float32).eps * int(end["stats.n_records"]) * x2)
    for k in jres.trace:  # per-interval records: exact at j=1, b=0 ...
        got_k = tres.trace[k].astype(jres.trace[k].dtype)
        if k in OBS:  # ... but inside its fused scan XLA divides by L² as a
            # multiply by the reciprocal (34/36 -> 0.9444445, torch 0.9444444)
            np.testing.assert_allclose(got_k, jres.trace[k], rtol=2.0 ** -23, atol=0)
        elif k == "swap_prob" and mode == "sweep":
            # the per-sweep chunks meet arguments where JAX's and torch's
            # sigmoid differ (by up to 3 ulps, test_torch_kernels); the
            # fused chunks' arguments happen to agree bit for bit
            np.testing.assert_allclose(got_k, jres.trace[k], rtol=4 * 2.0 ** -23, atol=0)
        else:
            np.testing.assert_array_equal(got_k, jres.trace[k], err_msg=k)


def test_carry_from_reference_round_trips_a_jax_state():
    js, jobs, _, _ = _systems("round")
    jeng = JEngine(js, JEngineConfig(n_replicas=4, swap_interval=2, donate=False),
                   observables=jobs)
    arrays = _dump(jeng.init(jax.random.key(3), np.linspace(1.0, 3.0, 4)))
    st = carry.from_reference(arrays, "cpu")
    assert st.pt.states.dtype == torch.int8 and st.pt.rung.dtype == torch.int32
    assert st.pt.key.tolist() == arrays["key"].astype(np.int64).tolist()
    assert st.pt.t.shape == () and st.pt.phase.shape == ()
    assert sorted(st.stats.mean) == sorted(["energy", *OBS])
    pt_only = carry.from_reference(
        {k: v for k, v in arrays.items() if not k.startswith("stats") and k != "betas"},
        "cpu")
    assert pt_only.__class__.__name__ == "PTState"


def _spec_dict(mode):
    if mode == "sweep":
        d = json.loads((SPECS / "ising_small.json").read_text())
    else:
        d = json.loads(SPEC.read_text())
        d["system"]["params"]["use_pallas"] = False
        d["system"]["params"]["use_fused_round"] = mode == "round"
    d["engine"]["record_trace"] = True
    return d


def _assert_manifests_match(jm, tm):
    """Exact but for Welford means/variances (rtol 1e-6, see the module doc)."""
    assert jm["final"] == tm["final"]
    assert jm["stopped_early"] == tm["stopped_early"]
    for name, jp in jm["phases"].items():
        tp = tm["phases"][name]
        assert jp["n_sweeps"] == tp["n_sweeps"]
        assert jp["ladder_history"] == tp["ladder_history"]
        for k, v in jp["summary"].items():
            if k.startswith(("var_", "mean_")):
                np.testing.assert_allclose(tp["summary"][k], v, rtol=1e-6, atol=0, err_msg=k)
            else:
                assert tp["summary"][k] == v, (name, k)
    assert jm["spec"]["system"] == tm["spec"]["system"]


@pytest.mark.parametrize("mode", ["fused", "round", "sweep"])
def test_session_matches_jax_from_seed(mode):
    d = _spec_dict(mode)
    jres = JSession(JRunSpec.from_json(d)).run()
    tres = TSession(TRunSpec.from_json(d), device="cpu").run()
    jm, tm = jres.manifest(), tres.manifest()
    if jm["final"] != tm["final"]:
        spi = d["engine"]["swap_interval"]
        key = tkeys.key(d["seed"])
        t0 = phase0 = 0
        for name in jres.phases:
            jt, tt = jres.phases[name].trace, tres.phases[name].trace
            if not all(np.array_equal(jt[k], tt[k]) for k in jt):
                _explain_divergence(
                    jt, tt, mode=mode, words=tprng.key_words(tkeys.split(key)[1]),
                    k_run=tkeys.split(key)[1], t0=t0, phase0=phase0, spi=spi,
                    r=d["ladder"]["n_replicas"], length=8,
                    ladders=[1.0 / np.asarray(x) for x in jres.phases[name].ladder_history],
                    rule="glauber",
                )
                return
            t0 += jres.phases[name].n_sweeps
            phase0 += jres.phases[name].n_sweeps // spi
        raise AssertionError("final states differ but every phase trace agrees")
    _assert_manifests_match(jm, tm)
    np.testing.assert_array_equal(tres.state.pt.states.numpy(),
                                  np.asarray(jres.state.pt.states))
    np.testing.assert_array_equal(tres.state.pt.rung.numpy(), np.asarray(jres.state.pt.rung))
    for k in ("swap_attempts", "swap_accepts", "round_trips", "up_visits", "labeled_visits"):
        np.testing.assert_array_equal(getattr(tres.state.stats, k).numpy(),
                                      np.asarray(getattr(jres.state.stats, k)), err_msg=k)


def test_cli_run_on_ising_small_matches_jax_cli(tmp_path):
    """``python -m repro_torch run examples/specs/ising_small.json --device
    cpu`` writes the manifest ``python -m repro run`` writes (both CLIs run
    in this process)."""
    from repro.api import cli as jcli
    from repro_torch.api import cli as tcli

    spec = str(SPECS / "ising_small.json")
    assert jcli.main(["run", spec, "--out", str(tmp_path / "jax")]) == 0
    assert tcli.main(["run", spec, "--device", "cpu", "--out", str(tmp_path / "port"),
                      "--quiet"]) == 0
    _assert_manifests_match(json.loads((tmp_path / "jax" / "manifest.json").read_text()),
                            json.loads((tmp_path / "port" / "manifest.json").read_text()))


@pytest.mark.parametrize("n", [1, 5, 8, 1500])
def test_ladders_match_jax(n):
    from repro.core import ladder as jladder
    from repro_torch.core import ladder as tladder

    np.testing.assert_array_equal(tladder.paper_ladder(n, 1.0, 3.0),
                                  np.asarray(jladder.paper_ladder(n, 1.0, 3.0)))
    np.testing.assert_array_equal(tladder.geometric_ladder(n, 0.5, 5.0),
                                  np.asarray(jladder.geometric_ladder(n, 0.5, 5.0)))
    # linear: within an ulp of jnp.linspace (XLA's f32 order is not reproduced)
    np.testing.assert_allclose(tladder.linear_ladder(n, 0.7, 4.1),
                               np.asarray(jladder.linear_ladder(n, 0.7, 4.1)),
                               rtol=2.0 ** -23, atol=0)
    acc = np.linspace(0.1, 0.6, max(n - 1, 1))[: n - 1]
    temps = np.asarray(jladder.paper_ladder(n, 1.0, 3.0))
    if n > 1:
        np.testing.assert_array_equal(tladder.tune_ladder(temps, acc),
                                      jladder.tune_ladder(temps, acc))
