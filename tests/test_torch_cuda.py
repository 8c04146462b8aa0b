"""CUDA twins of the port's parity tests: each kernel against its plain version.

Kernels A and B (fused Ising round), #2p (A's sweeps on packed spins, also
held against kernel A), #1 and #4 (one Ising / Potts sweep on passed-in
uniforms), #5 (fused Potts sweeps) and the per-sweep ``jax.random`` draw;
the Session paths on the card against the CPU, with one chain and with
two; the interval loop of every path with host syncs made errors.

These need a card and import no JAX, so they run wherever only PyTorch is
installed; without a card they skip with a reason.  Run them on the card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.

Tolerances are those of the CPU parity tests: spins, acceptance counts,
rungs and accept/attempt rows exact; ΔE exact at j=1, b=0 and within 4
ulps of the largest partial-sum magnitude otherwise (summation order); a
swap decision may differ only where its ``u`` lies between the two ``p``.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import carry  # noqa: E402
from repro_torch.api import RunSpec, Session  # noqa: E402
from repro_torch.core import keys  # noqa: E402
from repro_torch.core.ising import IsingSystem  # noqa: E402
from repro_torch.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.engine.driver import make_interval_step  # noqa: E402
from repro_torch.engine.stats import update_stats  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ising_sweep as isk  # noqa: E402
from repro_torch.kernels import jax_uniform as ju  # noqa: E402
from repro_torch.kernels import ops, prng, ref  # noqa: E402
from repro_torch.kernels import potts_sweep as pk  # noqa: E402

F32_EPS = 2.0 ** -23

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    return torch.device("cuda")


def _lattice(seed, r, length, dev):
    rng = np.random.default_rng(seed)
    spins = rng.choice(np.array([-1, 1], np.int8), size=(r, length, length))
    betas = (1.0 / np.linspace(1.0, 4.0, r)).astype(np.float32)
    rung = rng.permutation(r).astype(np.int32)
    return (torch.from_numpy(spins).to(dev), torch.from_numpy(betas).to(dev),
            torch.from_numpy(rung).to(dev))


def test_streams_on_cuda_equal_cpu(dev):
    w = prng.key_words(keys.key(9))
    want = prng.ising_sweep_uniforms(w, 123, torch.arange(8), 10)
    got = prng.ising_sweep_uniforms(w.to(dev), 123, torch.arange(8, device=dev), 10)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(keys.uniform(keys.key(4, device=dev), (5, 5)).cpu(),
                       keys.uniform(keys.key(4), (5, 5)))


@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
@pytest.mark.parametrize("j,b", [(1.0, 0.0), (0.7, 0.3)])
def test_kernel_a_matches_plain(dev, rule, j, b):
    spins, betas, rung = _lattice(5, 12, 30, dev)
    args = (spins, keys.key(6, device=dev), torch.tensor(9, device=dev), betas, rung)
    kw = dict(n_sweeps=4, j=j, b=b, rule=rule, replica_offset=2)
    got = isk.ising_sweep_fused_kernel(*args, **kw)
    want = isk.ising_sweep_fused_plain(*args, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    err = (got[1] - want[1]).abs().double()
    if j == 1.0 and b == 0.0:
        assert torch.equal(got[1], want[1])
    else:
        assert bool((err <= 4 * F32_EPS * want[2].double() * 2 * (4 * j + b)).all())


def test_kernel_a_in_place_and_refusals(dev):
    spins, betas, rung = _lattice(6, 4, 16, dev)
    args = (keys.key(1, device=dev), torch.tensor(0, device=dev), betas, rung)
    want = isk.ising_sweep_fused_kernel(spins, *args, n_sweeps=2)
    work = spins.clone()
    got = isk.ising_sweep_fused_kernel(work, *args, n_sweeps=2, out=work)
    assert got[0].data_ptr() == work.data_ptr() and torch.equal(got[0], want[0])
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.ones((1, 482, 482), dtype=torch.int8, device=dev)
        isk.ising_sweep_fused_kernel(big, *args[:2], betas[:1], rung[:1] * 0, n_sweeps=1)
    with pytest.raises(TypeError):
        isk.ising_sweep_fused_kernel(spins.float(), *args, n_sweeps=1)


@pytest.mark.parametrize("pairing", ["deo", "seo"])
@pytest.mark.parametrize("criterion", ["logistic", "metropolis"])
def test_kernel_b_matches_plain(dev, pairing, criterion):
    r = 40
    rng = np.random.default_rng(7)
    rung = rng.permutation(r).astype(np.int32)
    energy = (-2000.0 + 20 * np.arange(r))[rung].astype(np.float32)
    args = (
        torch.from_numpy(rung).to(dev), torch.from_numpy(energy).to(dev),
        torch.full((r,), 4.0, device=dev),
        torch.from_numpy((1.0 / np.linspace(1, 4, r)).astype(np.float32)).to(dev),
        keys.key(1, device=dev), torch.tensor(3, device=dev),
    )
    kw = dict(pairing=pairing, criterion=criterion, phase_add=2)
    got = [x.cpu().numpy() for x in isk.exchange_kernel(*args, **kw)]
    want = [x.cpu().numpy() for x in isk.exchange_plain(*args, **kw)]
    np.testing.assert_array_equal(got[4], want[4])
    np.testing.assert_array_equal(got[1], want[1])
    diff = (got[2] != want[2]) | (got[3] != want[3])
    if diff.any():
        u = prng.swap_uniforms(args[4], 5, r).cpu().numpy()
        lo, hi = np.minimum(got[3], want[3]), np.maximum(got[3], want[3])
        assert np.all(((u >= lo) & (u < hi))[diff])
        return
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("pairing", ["deo", "seo"])
def test_round_fused_on_cuda_equals_cpu(dev, pairing):
    spins, betas, rung = _lattice(8, 6, 8, dev)
    energy = torch.linspace(-100, -20, 6, device=dev)[rung.long()]
    args = (spins, keys.key(2), 4, 1, rung, energy, betas)
    kw = dict(n_sweeps=3, n_rounds=3, rule="glauber", pairing=pairing)
    build.reset_launches()
    got = ops.ising_round_fused(*(a.to(dev) if isinstance(a, torch.Tensor) else a
                                  for a in args), **kw)
    assert {k: v for k, v in build.launches.items() if v} == {"ising_fused": 3, "exchange": 3}
    want = ops.ising_round_fused(*(a.cpu() if isinstance(a, torch.Tensor) else a
                                   for a in args), **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 5:  # prob: CUDA expf vs the CPU's vectorized exp, a few ulps
            torch.testing.assert_close(g.cpu(), w, rtol=4 * F32_EPS, atol=0)
        else:
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("system", ["ising", "potts"])
@pytest.mark.parametrize("path", ["sweep", "fused", "round"])
def test_session_on_cuda_equals_cpu(dev, path, system):
    spec = _small_spec(path, system)
    on_card = Session(spec, device="cuda").run().manifest()
    on_cpu = Session(spec, device="cpu").run().manifest()
    assert on_card["final"] == on_cpu["final"]
    for name in on_cpu["phases"]:
        for k in ("swap_attempts", "swap_acceptance", "round_trips", "mean_energy"):
            assert on_card["phases"][name]["summary"][k] == on_cpu["phases"][name]["summary"][k]


def _small_spec(path, system="ising"):
    d = json.loads((Path(__file__).resolve().parents[1] / "examples" / "specs"
                    / "ising_small_fused.json").read_text())
    if system == "potts":
        d["system"] = {"name": "potts", "params": {"shape": [6, 4], "q": 3}}
        d["observables"] = ["pmag"]
    d["system"]["params"].update(use_fused=path != "sweep", use_fused_round=path == "round")
    return RunSpec.from_json(d)


def test_cuda_engine_refuses_a_cpu_state(dev):
    system = IsingSystem(length=4, use_fused=True)
    cfg = EngineConfig(n_replicas=4, swap_interval=2)
    cpu_state = Engine(system, cfg, device="cpu").init(keys.key(1), np.linspace(1, 3, 4))
    eng = Engine(system, cfg, device="cuda")
    build.reset_launches()
    with pytest.raises(ValueError, match="is on cpu but the engine runs on cuda"):
        eng.run(cpu_state, 2)
    with pytest.raises(ValueError, match="is on cpu but the engine runs on cuda"):
        eng.reset_stats(cpu_state)
    assert all(v == 0 for v in build.launches.values())


@pytest.mark.parametrize("system", ["ising", "potts"])
@pytest.mark.parametrize("path", ["sweep", "fused", "round"])
def test_interval_loop_never_syncs_the_host(dev, path, system):
    session = Session(_small_spec(path, system), device="cuda")
    eng = session.engine
    step = make_interval_step(eng.system, eng.config.spec, eng.observables)
    state = session.init_state()
    pt, stats = step(state.pt, state.betas)[0], state.stats
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            pt, rec = step(pt, state.betas)
            stats = update_stats(stats, rec, pt.rung)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(stats.n_records.item()) == 3


@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
@pytest.mark.parametrize("j,b", [(1.0, 0.0), (0.7, 0.3)])
def test_kernel_1_matches_plain(dev, rule, j, b):
    spins, betas, _ = _lattice(11, 12, 30, dev)
    u = torch.rand((12, 2, 30, 30), device=dev)
    got = isk.ising_sweep_kernel(spins, u, betas, j=j, b=b, rule=rule)
    want = ref.ising_sweep(spins, u, betas, j=j, b=b, rule=rule)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    if j == 1.0 and b == 0.0:
        assert torch.equal(got[1], want[1])
    else:
        err = (got[1] - want[1]).abs().double()
        assert bool((err <= 4 * F32_EPS * want[2].double() * 2 * (4 * j + b)).all())


def _colours(seed, r, h, w, q, dev):
    rng = np.random.default_rng(seed)
    states = torch.from_numpy(rng.integers(0, q, (r, h, w)).astype(np.int8)).to(dev)
    betas = torch.from_numpy((1.0 / np.geomspace(0.7, 2.9, r)).astype(np.float32)).to(dev)
    rung = torch.from_numpy(rng.permutation(r).astype(np.int32)).to(dev)
    return states, betas, rung


def _assert_potts_equal(got, want, j):
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    if j == 1.0:
        assert torch.equal(got[1], want[1])
    else:
        err = (got[1] - want[1]).abs().double()
        assert bool((err <= 4 * F32_EPS * want[2].double() * 4 * abs(j)).all())


@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
@pytest.mark.parametrize("q,j", [(3, 1.0), (5, 0.7)])
def test_kernel_4_matches_plain(dev, rule, q, j):
    states, betas, _ = _colours(12, 10, 20, 14, q, dev)
    u = torch.rand((10, 2, 2, 20, 14), device=dev)
    got = pk.potts_sweep_kernel(states, u, betas, q=q, j=j, rule=rule)
    _assert_potts_equal(got, ref.potts_sweep(states, u, betas, q=q, j=j, rule=rule), j)


@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
@pytest.mark.parametrize("q,j", [(3, 1.0), (5, 0.7)])
def test_kernel_5_matches_plain(dev, rule, q, j):
    states, betas, rung = _colours(13, 10, 12, 18, q, dev)
    args = (states, keys.key(6, device=dev), torch.tensor(9, device=dev), betas, rung)
    kw = dict(n_sweeps=4, q=q, j=j, rule=rule, replica_offset=2, t_add=3)
    _assert_potts_equal(pk.potts_sweep_fused_kernel(*args, **kw),
                        pk.potts_sweep_fused_plain(*args, **kw), j)


@pytest.mark.parametrize("shape", [(2, 8, 8), (2, 2, 6, 4), (2, 300, 300)])
def test_jax_uniform_matches_plain(dev, shape):
    key, t = keys.key(21, device=dev), torch.tensor(2**31 + 5, device=dev)
    got = ju.jax_uniform_kernel(key, t, 40, shape)
    ids = torch.tensor([0, 1, 17, 39], device=dev)
    assert torch.equal(got[ids], ju.jax_uniform_plain(key, t, ids, shape))


@pytest.mark.parametrize("path", ["fused", "round"])
def test_potts_ops_on_cuda_equal_cpu(dev, path):
    states, betas, rung = _colours(14, 6, 8, 6, 3, dev)
    energy = torch.linspace(-60, -20, 6, device=dev)[rung.long()]
    build.reset_launches()
    if path == "fused":
        args, kw = (states, keys.key(2), 4, betas), dict(n_sweeps=3, q=3, rule="glauber")
        fn, want_launches = ops.potts_sweep_fused, {"potts_fused": 1}
    else:
        args = (states, keys.key(2), 4, 1, rung, energy, betas)
        kw = dict(n_sweeps=3, n_rounds=3, q=3, rule="glauber", pack_bits=True)
        fn, want_launches = ops.potts_round_fused, {"potts_fused": 3, "exchange": 3}
    got = fn(*(a.to(dev) if isinstance(a, torch.Tensor) else a for a in args), **kw)
    assert {k: v for k, v in build.launches.items() if v} == want_launches
    want = fn(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args), **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        if path == "round" and i == 5:  # prob: CUDA expf vs the CPU's exp
            torch.testing.assert_close(g.cpu(), w, rtol=4 * F32_EPS, atol=0)
        else:
            assert torch.equal(g.cpu(), w)


def test_carry_from_reference_puts_a_potts_state_on_the_card(dev):
    rng = np.random.default_rng(3)
    arrays = {"states": rng.integers(0, 3, (4, 6, 4)).astype(np.int8),
              "energy": np.zeros(4, np.float32), "rung": np.arange(4, dtype=np.int32),
              "key": np.array([0, 5], np.uint32), "t": np.array(7), "phase": np.array(2)}
    st = carry.from_reference(arrays, "cuda")
    assert st.states.device.type == "cuda" and st.states.dtype == torch.int8
    assert torch.equal(st.states.cpu(), torch.from_numpy(arrays["states"]))
    out = Session(_small_spec("sweep", "potts"), device="cuda").engine.system.batched_mcmc_step(
        st.key, st.t, st.states, torch.ones(4, device=dev))
    assert out[0].shape == (4, 6, 4)


@pytest.mark.parametrize("group", [8, 3, None])  # None: the card's default width
@pytest.mark.parametrize("length,r,sweeps,j,b,rule", [
    (8, 5, 3, 1.0, 0.0, "glauber"),  # one partial byte
    (30, 13, 4, 0.7, 0.3, "metropolis"),  # a full byte and a partial one
    (16, 16, 5, 1.0, 0.3, "glauber"),  # two full bytes
    (64, 33, 6, 1.0, 0.0, "metropolis"),
])
def test_packed_kernel_matches_plain_and_kernel_a(dev, length, r, sweeps, j, b, rule, group):
    spins, betas, rung = _lattice(21, r, length, dev)
    args = (spins, keys.key(6, device=dev), torch.tensor(9, device=dev), betas, rung)
    kw = dict(n_sweeps=sweeps, j=j, b=b, rule=rule, replica_offset=2, t_add=3)
    build.reset_launches()
    got = isk.ising_sweep_packed_kernel(*args, **kw, group=group)
    assert build.launches["ising_packed"] == 1
    kernel_a = isk.ising_sweep_fused_kernel(*args, **kw)
    for g, a in zip(got, kernel_a):  # ΔE too: kernel A's sums in kernel A's order
        assert torch.equal(g, a)
    want = isk.ising_sweep_packed_plain(*args, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    if j == 1.0 and b == 0.0:
        assert torch.equal(got[1], want[1])
    else:
        err = (got[1] - want[1]).abs().double()
        assert bool((err <= 4 * F32_EPS * want[2].double() * 2 * (4 * abs(j) + b)).all())


def test_packed_round_on_cuda_equals_cpu(dev):
    spins, betas, rung = _lattice(22, 11, 8, dev)
    energy = torch.linspace(-100, -20, 11, device=dev)[rung.long()]
    args = (spins, keys.key(2), 4, 1, rung, energy, betas)
    kw = dict(n_sweeps=3, n_rounds=3, rule="glauber", pairing="deo", pack_bits=True)
    build.reset_launches()
    got = ops.ising_round_fused(*(a.to(dev) if isinstance(a, torch.Tensor) else a
                                  for a in args), **kw)
    assert {k: v for k, v in build.launches.items() if v} == {"ising_packed": 3, "exchange": 3}
    want = ops.ising_round_fused(*(a.cpu() if isinstance(a, torch.Tensor) else a
                                   for a in args), **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 5:  # prob: CUDA expf vs the CPU's vectorized exp, a few ulps
            torch.testing.assert_close(g.cpu(), w, rtol=4 * F32_EPS, atol=0)
        else:
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("system", ["ising", "potts"])
@pytest.mark.parametrize("path", ["sweep", "fused", "round"])
def test_two_chains_on_cuda_equal_cpu(dev, path, system):
    """``n_chains=2`` on the card equals ``n_chains=2`` on the CPU (Ising's
    fused and round paths with ``pack_bits``)."""
    d = json.loads(_small_spec(path, system).to_json())
    d["engine"]["n_chains"] = 2
    if system == "ising" and path != "sweep":
        d["system"]["params"]["pack_bits"] = True
    spec = RunSpec.from_json(d)
    on_card = Session(spec, device="cuda").run().manifest()
    on_cpu = Session(spec, device="cpu").run().manifest()
    assert on_card["final"] == on_cpu["final"]
    assert len(on_card["final"]["energy"]) == 2
    for name in on_cpu["phases"]:
        for k in ("swap_attempts", "swap_acceptance", "round_trips", "mean_energy"):
            assert on_card["phases"][name]["summary"][k] == on_cpu["phases"][name]["summary"][k]


@pytest.mark.parametrize("path", ["sweep", "round"])
def test_ensemble_advance_never_syncs_the_host(dev, path):
    d = json.loads(_small_spec(path).to_json())
    d["engine"]["n_chains"] = 2
    d["system"]["params"]["pack_bits"] = path == "round"
    session = Session(RunSpec.from_json(d), device="cuda")
    state, _ = session.engine.advance(session.init_state(), 1)  # warm-up
    torch.cuda.synchronize()
    build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = session.engine.advance(state, 3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert state.stats.n_records.tolist() == [4, 4]
    if path == "round":  # one launch of each kernel per chain and interval
        assert {k: v for k, v in build.launches.items() if v} == {"ising_packed": 6,
                                                                    "exchange": 6}
