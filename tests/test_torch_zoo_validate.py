"""The zoo's exact references, the diagnostics and the new conformance
entries on the port, against the JAX package.

* Every exact reference the zoo's new entries use equals JAX's bit for
  bit: `ea_exact` (on the system's own quenched planes), `gaussian_exact`
  (quadrature), `hp_exact`, the SAW counts of `enumerate_saws` and the
  move-graph check `hp_move_graph_connected` (connected through N=10, as
  the JAX package documents; its BFS neighbour lists too).
* `repro_torch.core.diagnostics` against `repro.core.diagnostics` on the
  same arrays: equal bit for bit, the warning of the attempt-less trace
  included.
* Conformance: the zoo's EA and Gaussian entries at the JAX zoo's full
  schedule pass ``assert_conforms(z_max=4, geweke_max=4)`` on the CPU, with
  both adaptive retunes fired in burn-in.  The HP entry's full schedule is
  66,000 serial moves of the plain torch chain (~1.2 ms each here), so it
  runs in the ``slow`` tier on the CPU; the card runs it at full schedule
  (``chip_smoke.py`` phase 20).  A shortened EA entry gives JAX's report
  at the same seed.
"""
import dataclasses
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import diagnostics as jdiag  # noqa: E402
from repro.core import systems as jsystems  # noqa: E402
from repro.validate import exact as jexact  # noqa: E402
from repro.validate import run_conformance as jrun_conformance  # noqa: E402
from repro_torch.core import diagnostics as tdiag  # noqa: E402
from repro_torch.core import systems as tsystems  # noqa: E402
from repro_torch.validate import assert_conforms, run_conformance  # noqa: E402
from repro_torch.validate import exact as texact  # noqa: E402
from repro_torch.validate.conformance import EXACT  # noqa: E402


def _both(name, params):
    return tsystems.make_system(name, params), jsystems.make_system(name, params)


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("params", [
    {"shape": (4, 4), "disorder_seed": 1, "accept_rule": "glauber"},
    {"shape": (2, 4), "disorder_seed": 5, "j": 0.7},
], ids=["zoo", "2x4-j0.7"])
def test_ea_exact_matches_jax(params):
    t, j = _both("ea_spin_glass", params)
    temps = np.array([0.8, 1.2, 1.8, 2.7, 4.0])
    _assert_same(texact.ea_exact(t, temps), jexact.ea_exact(j, temps))


@pytest.mark.parametrize("params", [
    tsystems.REGISTRY["gaussian"].params,
    {"mus": (0.5,), "sigmas": (1.3,), "weights": (1.0,)},
    {"mus": (-4.0, 0.0, 3.0), "sigmas": (1.0, 0.5, 0.7), "weights": (0.2, 0.5, 0.3)},
], ids=["zoo", "one-component", "three-components"])
def test_gaussian_exact_matches_jax(params):
    t, j = _both("gaussian", params)
    temps = np.array([1.0, 1.8, 3.2, 5.6, 10.0])
    _assert_same(texact.gaussian_exact(t, temps), jexact.gaussian_exact(j, temps))


@pytest.mark.parametrize("sequence", ["HPH", "HHPHH", "HPHPPHHPHH"])
def test_hp_exact_matches_jax(sequence):
    t, j = _both("hp_protein", {"sequence": sequence})
    temps = np.array([0.6, 0.9, 1.4, 2.2, 3.4])
    _assert_same(texact.hp_exact(t, temps), jexact.hp_exact(j, temps))


def test_saw_enumeration_matches_jax():
    counts = [len(texact.enumerate_saws(n)) for n in range(1, 10)]
    # the square lattice's self-avoiding walk counts
    assert counts == [4, 12, 36, 100, 284, 780, 2172, 5916, 16268]
    for n in (1, 4, 7):
        np.testing.assert_array_equal(texact.enumerate_saws(n), jexact.enumerate_saws(n))


def test_hp_move_graph_matches_jax():
    for n in range(3, 11):
        assert texact.hp_move_graph_connected(n) is jexact.hp_move_graph_connected(n) is True
    for path in map(tuple, texact.enumerate_saws(5)[::37].tolist()):
        path = tuple(map(tuple, path))
        assert texact._hp_neighbors(path) == jexact._hp_neighbors(path)


def test_exact_table_names_every_zoo_entry():
    from repro.validate.conformance import EXACT as JEXACT

    assert set(EXACT) == set(JEXACT) == set(tsystems.REGISTRY)
    for name, fn in EXACT.items():
        assert fn.__name__ == JEXACT[name].__name__


# -- diagnostics ------------------------------------------------------------------


def _trace(seed=3, t=50, r=6):
    rng = np.random.default_rng(seed)
    att = rng.random((t, r)) < 0.5
    att[:, -1] = False
    return {"swap_accept": att & (rng.random((t, r)) < 0.4),
            "swap_attempt": att,
            "swap_prob": np.where(att, rng.random((t, r)), 0.0).astype(np.float32),
            "energy": rng.normal(size=(t, r)).astype(np.float32)}


def test_diagnostics_match_jax():
    trace = _trace()
    np.testing.assert_array_equal(tdiag.swap_acceptance_rate(trace),
                                  jdiag.swap_acceptance_rate(trace))
    old = {k: v for k, v in trace.items() if k != "swap_attempt"}
    with pytest.warns(RuntimeWarning, match="swap_attempt"):
        got = tdiag.swap_acceptance_rate(old)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        np.testing.assert_array_equal(got, jdiag.swap_acceptance_rate(old))
    rng = np.random.default_rng(4)
    series = np.clip(np.cumsum(rng.normal(0.05, 0.1, 200)), -1, 1)
    for thr, win in ((0.9, 8), (0.5, 3), (2.0, 8)):
        assert (tdiag.iterations_to_converge(series, thr, win)
                == jdiag.iterations_to_converge(series, thr, win))
    assert tdiag.iterations_to_converge(series[:4], 0.1) == -1
    ar = np.zeros(500)
    for i in range(1, 500):
        ar[i] = 0.9 * ar[i - 1] + rng.normal()
    for x in (ar, rng.normal(size=300), np.zeros(20), np.ones(5)):
        assert tdiag.integrated_autocorrelation(x) == jdiag.integrated_autocorrelation(x)
    for frac in (0.5, 0.0, 0.9):
        np.testing.assert_array_equal(tdiag.grand_mean_by_rung(trace, "energy", frac),
                                      jdiag.grand_mean_by_rung(trace, "energy", frac))


# -- conformance ---------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ea_spin_glass", "gaussian"])
def test_zoo_entry_conforms_on_cpu(name):
    """The JAX zoo's full schedule (1200 burn sweeps with 2 retunes, 8
    batches of 400, 2 chains) on the port's per-sweep path."""
    entry = tsystems.REGISTRY[name]
    report = run_conformance(entry, seed=0, device="cpu")
    assert report.n_retunes == entry.adapt_rounds == 2
    assert_conforms(report, z_max=4.0, geweke_max=4.0)


@pytest.mark.slow
def test_hp_entry_conforms_on_cpu():
    """Slow tier: 66,000 serial moves of the plain torch chain on the CPU;
    the card runs the same entry through the serial-chain kernel."""
    entry = tsystems.REGISTRY["hp_protein"]
    report = run_conformance(entry, seed=0, device="cpu")
    assert report.n_retunes == entry.adapt_rounds
    assert_conforms(report, z_max=4.0, geweke_max=4.0)


def test_short_ea_entry_equals_jax_report():
    """A shortened EA entry at seed 0: the final ladder, per-rung means and
    MCSE equal JAX's within 1e-6 relative (the Welford moments' tolerance,
    test_torch_engine), the exact references bit for bit."""
    short = dataclasses.replace(tsystems.REGISTRY["ea_spin_glass"], burn_sweeps=150,
                                n_batches=4, sweeps_per_batch=100)
    jshort = dataclasses.replace(jsystems.REGISTRY["ea_spin_glass"], burn_sweeps=150,
                                 n_batches=4, sweeps_per_batch=100)
    got = run_conformance(short, seed=0, device="cpu")
    want = jrun_conformance(jshort, seed=0)
    np.testing.assert_allclose(got.temps, want.temps, rtol=1e-6, atol=0)
    assert got.n_retunes == want.n_retunes
    for k in want.means:
        np.testing.assert_allclose(got.means[k], want.means[k], rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(got.mcse[k], want.mcse[k], rtol=1e-5, atol=1e-7, err_msg=k)
