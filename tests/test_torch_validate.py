"""`repro_torch.validate` against exact answers and against the JAX package.

* The exact references (`ising_exact`; `potts_exact` in the ``slow`` tier,
  as the JAX package runs it) and the MCSE functions equal the JAX twins'.
* The #2p gate, twin of ``tests/test_conformance.py::
  test_round_fused_kernel_conforms_to_exact_reference``: the zoo's Ising
  entry on the whole-round path with ``pack_bits`` passes
  ``assert_conforms(z_max=4, geweke_max=4)`` on the CPU.
* The interval-fused path (``validate --fused``) passes the same gate;
  Potts, on its default and fused paths, in the ``slow`` tier.
* A shortened entry (``dataclasses.replace``: fewer sweeps) gives the JAX
  package's report at the same seed: temps, means and MCSE within 1e-6
  relative (the Welford moments' tolerance, test_torch_engine.py).
* Negative control, twin of ``test_conformance_catches_a_wrong_sampler``: a
  biased exact reference fails the gate.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import systems as jsystems  # noqa: E402
from repro.validate import exact as jexact  # noqa: E402
from repro.validate import mcse as jmcse  # noqa: E402
from repro.validate import run_conformance as jrun_conformance  # noqa: E402
from repro_torch.core import systems as tsystems  # noqa: E402
from repro_torch.validate import assert_conforms, run_conformance  # noqa: E402
from repro_torch.validate import exact as texact  # noqa: E402
from repro_torch.validate import mcse as tmcse  # noqa: E402

ROUND_PACKED = {"use_fused": True, "use_pallas": True, "use_fused_round": True,
                "pack_bits": True}
FUSED = {"use_fused": True, "use_pallas": True}
SHORT = dict(burn_sweeps=150, n_batches=4, sweeps_per_batch=100)


def test_registry_holds_the_ported_zoo_entries():
    # every entry of the JAX zoo, field for field: the port runs all five
    assert set(tsystems.REGISTRY) == set(jsystems.REGISTRY)
    for name, entry in tsystems.REGISTRY.items():
        jentry = jsystems.REGISTRY[name]
        assert dataclasses.asdict(entry) == dataclasses.asdict(jentry)
        assert entry.n_chains > 1 and entry.adapt_rounds > 0
        assert tsystems.registered(name) is entry
    with pytest.raises(KeyError, match="unknown system"):
        tsystems.registered("nonesuch")


def test_ising_exact_matches_jax():
    temps = np.array([1.5, 2.0, 2.6, 3.4, 4.4])
    for params in ({"length": 4}, {"length": 4, "j": 0.7, "b": 0.3}):
        got = texact.ising_exact(tsystems.make_system("ising", params), temps)
        want = jexact.ising_exact(jsystems.make_system("ising", params), temps)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.slow
def test_potts_exact_matches_jax():
    temps = np.array(tsystems.REGISTRY["potts"].temps)
    params = tsystems.REGISTRY["potts"].params
    got = texact.potts_exact(tsystems.make_system("potts", params), temps)
    want = jexact.potts_exact(jsystems.make_system("potts", params), temps)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_mcse_matches_jax():
    rng = np.random.default_rng(3)
    bm = rng.normal(size=(16, 5))
    for g, w in zip(tmcse.batch_mean_stats(bm), jmcse.batch_mean_stats(bm)):
        np.testing.assert_array_equal(g, w)
    var, se = rng.uniform(0.5, 2.0, 5), np.array([0.1, 0.0, 0.3, 1e-3, 2.0])
    np.testing.assert_array_equal(tmcse.effective_sample_size(var, se),
                                  jmcse.effective_sample_size(var, se))
    first = np.concatenate([bm[:8], np.ones((2, 5))])
    second = np.concatenate([bm[8:], np.ones((2, 5))])
    second[:, 1] = first[:, 1] = 0.5  # a degenerate column: equal means, no spread
    np.testing.assert_array_equal(tmcse.geweke_z(first, second), jmcse.geweke_z(first, second))
    with pytest.raises(ValueError, match="M >= 2"):
        tmcse.batch_mean_stats(bm[:1])


def test_round_packed_path_conforms_to_exact_reference():
    """The #2p gate on the CPU: the full zoo entry, round path + pack_bits."""
    entry = tsystems.REGISTRY["ising"]
    report = run_conformance(entry, seed=0, system_params=ROUND_PACKED, device="cpu")
    assert report.n_retunes == entry.adapt_rounds, report.n_retunes
    np.testing.assert_allclose(report.temps[0], entry.temps[0], rtol=1e-5)
    np.testing.assert_allclose(report.temps[-1], entry.temps[-1], rtol=1e-4)
    assert np.all(np.diff(report.temps) > 0)
    assert report.n_batches == entry.n_batches * entry.n_chains
    assert_conforms(report, z_max=4.0, geweke_max=4.0)
    for k, ess in report.ess.items():
        assert np.all(ess > 10), (k, ess)


@pytest.mark.parametrize("name,params", [
    pytest.param("ising", FUSED, id="ising-fused"),
    pytest.param("potts", None, id="potts", marks=pytest.mark.slow),
    pytest.param("potts", FUSED, id="potts-fused", marks=pytest.mark.slow),
])
def test_entry_conforms_to_exact_reference(name, params):
    """The other paths of the gate, as the JAX package runs them
    (``validate --fused``; Potts, whose exact reference takes ~20 s, in
    the ``slow`` tier)."""
    entry = tsystems.REGISTRY[name]
    report = run_conformance(entry, seed=0, system_params=params, device="cpu")
    assert report.n_retunes == entry.adapt_rounds, report.n_retunes
    assert np.all(np.diff(report.temps) > 0)
    assert_conforms(report, z_max=4.0, geweke_max=4.0)


def test_short_entry_report_matches_jax():
    tentry = dataclasses.replace(tsystems.REGISTRY["ising"], **SHORT)
    jentry = dataclasses.replace(jsystems.REGISTRY["ising"], **SHORT)
    got = run_conformance(tentry, seed=0, system_params=ROUND_PACKED, device="cpu")
    want = jrun_conformance(jentry, seed=0, system_params=ROUND_PACKED)
    assert (got.n_retunes, got.n_batches) == (want.n_retunes, want.n_batches) == (2, 8)
    np.testing.assert_allclose(got.temps, want.temps, rtol=1e-6, atol=0)
    for k in want.means:
        np.testing.assert_allclose(got.means[k], want.means[k], rtol=1e-6, atol=0, err_msg=k)
        np.testing.assert_allclose(got.mcse[k], want.mcse[k], rtol=1e-6, atol=0, err_msg=k)
        np.testing.assert_allclose(got.exact[k], want.exact[k], rtol=1e-12, atol=0, err_msg=k)


def test_conformance_catches_a_wrong_sampler():
    """A reference biased by +1 in the energy fails the gate (at the cold
    rungs the energy's MCSE is far below 1/4 even on the short entry)."""
    entry = dataclasses.replace(tsystems.REGISTRY["ising"], **SHORT)

    def biased_exact(system, temps):
        out = texact.ising_exact(system, temps)
        out["energy"] = out["energy"] + 1.0
        return out

    report = run_conformance(entry, seed=0, exact_fn=biased_exact,
                             system_params=ROUND_PACKED, device="cpu")
    with pytest.raises(AssertionError, match="disagrees"):
        assert_conforms(report)
