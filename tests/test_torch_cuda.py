"""CUDA twins of the port's parity tests: each kernel against its plain version.

Kernel A, the round launches of A, #2p and #5 (sweeps, then the exchange run
by the last block to finish) against the plain sweeps and `exchange_plain`,
#2p (A's sweeps on packed spins, also
held against kernel A: spins, counts and ΔE bit for bit, at every group
width and on the walk's edge shapes), #1 and #4 (one Ising / Potts sweep on passed-in
uniforms), #5 (fused Potts sweeps), the per-sweep ``jax.random`` draw and
#7 (the RWKV-6 recurrence); the Session paths on the card against the CPU,
with one chain and with two, and with the SEO, windowed and VMPT strategies
and state mode; the interval loop of every path with host syncs made
errors; a run checkpointed and resumed on the card against its
uninterrupted run; the reduced rwkv6-7b on the card against the CPU; both
serial-chain kernels (HP moves, Ising single_flip) against their plain
versions, and the zoo's per-sweep paths (EA, HP, single_flip, the Gaussian)
on the card against the CPU and with host syncs made errors.

These need a card and import no JAX, so they run wherever only PyTorch is
installed; without a card they skip with a reason.  Run them on the card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.

Tolerances are those of the CPU parity tests: spins, acceptance counts,
rungs and accept/attempt rows exact; ΔE exact at j=1, b=0 and within 4
ulps of the largest partial-sum magnitude otherwise (summation order); a
swap decision may differ only where its ``u`` lies between the two ``p``;
wkv6 within its rounding bound (see its test).
"""
import functools
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
from repro_torch.kernels import serial_chain as sc  # noqa: E402

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


# shapes the walk must get right: the smallest even lattices, sides that are
# no multiple of a warp's lanes, one near the shared-memory limit, an odd R
WALK_SHAPES = [(30, 12), (2, 13), (4, 13), (66, 13), (470, 13)]


@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
@pytest.mark.parametrize("j,b", [(1.0, 0.0), (0.7, 0.3)])
@pytest.mark.parametrize("length,r", WALK_SHAPES)
def test_kernel_a_matches_plain(dev, rule, j, b, length, r):
    spins, betas, rung = _lattice(5, r, length, dev)
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


# kernel -> (plain sweeps, round wrapper); #2p at 3 replicas a block, so
# R=40 ends in a partial group of one
ROUND_KERNELS = {
    "ising_fused": (isk.ising_sweep_fused_plain, isk.ising_round_kernel),
    "ising_packed": (isk.ising_sweep_packed_plain,
                     functools.partial(isk.ising_round_kernel, pack_bits=True, group=3)),
    "potts_fused": (functools.partial(pk.potts_sweep_fused_plain, q=3),
                    functools.partial(pk.potts_round_kernel, q=3)),
}


def _round_inputs(kernel, seed, r, dev):
    """States, betas, rung and per-slot energies near an equilibrated ladder
    (Δβ·ΔE of order 1 between neighbours, so swaps neither always nor never
    happen)."""
    if kernel == "potts_fused":
        states, betas, rung = _colours(seed, r, 8, 6, 3, dev)
    else:
        states, betas, rung = _lattice(seed, r, 8, dev)
    by_rung = torch.from_numpy((-2000.0 + 20 * np.arange(r)).astype(np.float32)).to(dev)
    return states, betas, rung, by_rung[rung.long()]


def _check_round(kernel, got, before, words, t0, ph0, betas, k, xw):
    """One round launch's outputs against the plain sweeps and
    `exchange_plain` on the same inputs: spins, counts, energy and attempt
    bit-equal; prob and accept equal or differing only where u lies between
    the two p; rung equal when no decision differs.  Returns whether any did."""
    plain = ROUND_KERNELS[kernel][0]
    states, rung, energy = before
    want_states, de, na = plain(states, words, t0, betas, rung, n_sweeps=2, t_add=2 * k,
                                rule="glauber")
    want = isk.exchange_plain(rung, energy, de, betas, words, ph0, phase_add=k, **xw)
    assert torch.equal(got[0], want_states) and torch.equal(got[3], na)
    assert torch.equal(got[2], want[1]) and torch.equal(got[6], want[4])
    u = prng.swap_uniforms(words, ph0 + k, len(rung))
    lo, hi = torch.minimum(got[5], want[3]), torch.maximum(got[5], want[3])
    in_gap = (u >= lo) & (u < hi)
    diff = (got[4] != want[2]) | (got[5] != want[3])
    assert not bool((diff & ~in_gap).any())
    if not bool(diff.any()):
        assert torch.equal(got[1], want[0])
    return bool(diff.any())


@pytest.mark.parametrize("pairing", ["deo", "seo"])
@pytest.mark.parametrize("criterion", ["logistic", "metropolis"])
@pytest.mark.parametrize("kernel", sorted(ROUND_KERNELS))
def test_round_kernel_matches_plain(dev, kernel, pairing, criterion):
    """Three rounds, each one launch with every output in place (``out`` =
    the inputs): each equals the plain sweeps + `exchange_plain` on that
    round's inputs; one launch and one exchange a round."""
    r = 40
    states, betas, rung, energy = _round_inputs(kernel, 31, r, dev)
    words, t0, ph0 = keys.key(1, device=dev), torch.tensor(5, device=dev), torch.tensor(3, device=dev)
    xw = dict(pairing=pairing, criterion=criterion)
    acc, prob, att = (torch.empty((3, r), dtype=d, device=dev)
                      for d in (torch.bool, torch.float32, torch.bool))
    for k in range(3):
        before = (states.clone(), rung.clone(), energy.clone())
        build.reset_launches()
        got = ROUND_KERNELS[kernel][1](
            states, words, t0, ph0, betas, rung, energy, n_sweeps=2, rule="glauber",
            t_add=2 * k, phase_add=k, out=(states, rung, energy, acc[k], prob[k], att[k]), **xw)
        assert [x.data_ptr() for x in got[:3]] == [states.data_ptr(), rung.data_ptr(),
                                                   energy.data_ptr()]
        assert {n: v for n, v in build.launches.items() if v} == {kernel: 1}
        assert build.epilogues == {"exchange": 1}
        if _check_round(kernel, got, before, words, t0, ph0, betas, k, xw):
            break  # a decision inside the ulp gap: the chains part from here
    assert build.dirty_tickets() == {}


@pytest.mark.parametrize("kernel", sorted(ROUND_KERNELS))
def test_round_scratch_is_sized_from_the_library(dev, kernel):
    """The scratch rows a round launch is given hold `build.scratch_bytes`
    of its own library a replica (8: e_rung and perm), at every R."""
    lib = build.library(kernel)
    assert build.scratch_bytes(lib) == 8
    for r in (7, 40):
        _, betas, rung, energy = _round_inputs(kernel, 60 + r, r, dev)
        ph0 = torch.zeros((), dtype=torch.int64, device=dev)
        rows = build.check_round(r, energy.device, rung, energy, ph0, None, pairing="deo",
                                 criterion="logistic")
        args = build.round_args(lib, betas, (energy, ph0, rows, dict(
            phase_add=0, pairing="deo", criterion="logistic")))
        scratch = [t for t in build._SCRATCH.values() if t.data_ptr() == args[-2]]
        assert len(scratch) == 1 and scratch[0].numel() == 8 * r


@pytest.mark.parametrize("kernel", sorted(ROUND_KERNELS))
def test_round_kernel_at_other_sizes_leaves_the_ticket_at_zero(dev, kernel):
    """Round launches at R = 1500 (three passes of the exchange's block over
    the rows), 7 and 40 in a row on one stream: each equals the plain round,
    and the stream's ticket reads 0 after each."""
    words, t0, ph0 = keys.key(4, device=dev), torch.tensor(0, device=dev), torch.tensor(8, device=dev)
    xw = dict(pairing="deo", criterion="logistic")
    for n, r in enumerate((1500, 7, 40)):
        states, betas, rung, energy = _round_inputs(kernel, 40 + n, r, dev)
        got = ROUND_KERNELS[kernel][1](states, words, t0, ph0, betas, rung, energy,
                                       n_sweeps=2, rule="glauber", **xw)
        _check_round(kernel, got, (states, rung, energy), words, t0, ph0, betas, 0, xw)
        assert build.dirty_tickets() == {}


@pytest.mark.parametrize("kernel", sorted(ROUND_KERNELS))
def test_rounds_back_to_back_equal_rounds_one_at_a_time(dev, kernel):
    """40 rounds queued back to back in one op call (each launch reading the
    rung, energy and spins the one before wrote in place) equal the same 40
    rounds one call each with the host waiting for the card in between."""
    states, betas, rung, energy = _round_inputs(kernel, 51, 40, dev)
    key = keys.key(9)
    if kernel == "potts_fused":
        op = functools.partial(ops.potts_round_fused, q=3)
    else:
        op = functools.partial(ops.ising_round_fused, pack_bits=kernel == "ising_packed")
    kw = dict(n_sweeps=1, rule="glauber", pairing="seo")
    queued = op(states, key, 7, 2, rung, energy, betas, n_rounds=40, **kw)
    st, rg, en, rows = states, rung, energy, []
    for k in range(40):
        st, rg, en, na, acc, prob, att = op(st, key, 7 + k, 2 + k, rg, en, betas, **kw)
        torch.cuda.synchronize()
        rows.append((na, acc[0], prob[0], att[0]))
    assert torch.equal(queued[0], st) and torch.equal(queued[1], rg)
    assert torch.equal(queued[2], en)
    assert torch.equal(queued[3], sum(r[0] for r in rows))
    for i in (1, 2, 3):
        assert torch.equal(queued[3 + i], torch.stack([r[i] for r in rows]))
    assert build.dirty_tickets() == {}


@pytest.mark.parametrize("pairing", ["deo", "seo"])
def test_round_fused_on_cuda_equals_cpu(dev, pairing):
    spins, betas, rung = _lattice(8, 6, 8, dev)
    energy = torch.linspace(-100, -20, 6, device=dev)[rung.long()]
    args = (spins, keys.key(2), 4, 1, rung, energy, betas)
    kw = dict(n_sweeps=3, n_rounds=3, rule="glauber", pairing=pairing)
    build.reset_launches()
    got = ops.ising_round_fused(*(a.to(dev) if isinstance(a, torch.Tensor) else a
                                  for a in args), **kw)
    assert {k: v for k, v in build.launches.items() if v} == {"ising_fused": 3}
    assert build.epilogues == {"exchange": 3}
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


STRATEGY_EDITS = {
    "seo": {"exchange": {"strategy": "seo"}},
    "windowed": {"exchange": {"strategy": "windowed", "window": 3}},
    "vmpt": {"exchange": {"strategy": "vmpt"}},
    "state": {"engine": {"swap_interval": 10, "chunk_intervals": 10, "swap_mode": "state"}},
}


def _strategy_spec(path, case):
    d = json.loads(_small_spec(path).to_json())
    return RunSpec.from_json({**d, **STRATEGY_EDITS[case]})


@pytest.mark.parametrize("case", sorted(STRATEGY_EDITS))
@pytest.mark.parametrize("path", ["sweep", "fused"])
def test_strategy_session_on_cuda_equals_cpu(dev, path, case):
    """Counters and the final state exact; VMPT's mean energy (weighted by
    swap probabilities, CUDA's sigmoid against the CPU's) within 1e-6."""
    spec = _strategy_spec(path, case)
    on_card = Session(spec, device="cuda").run().manifest()
    on_cpu = Session(spec, device="cpu").run().manifest()
    assert on_card["final"] == on_cpu["final"]
    for name in on_cpu["phases"]:
        got, want = on_card["phases"][name]["summary"], on_cpu["phases"][name]["summary"]
        for k in ("swap_attempts", "swap_acceptance", "round_trips"):
            assert got[k] == want[k]
        np.testing.assert_allclose(got["mean_energy"], want["mean_energy"],
                                   rtol=1e-6 if case == "vmpt" else 0, atol=0)


@pytest.mark.parametrize("case", sorted(STRATEGY_EDITS))
def test_strategy_interval_loop_never_syncs_the_host(dev, case):
    session = Session(_strategy_spec("fused", case), device="cuda")
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


@pytest.mark.parametrize("path", ["sweep", "fused", "round"])
def test_resume_on_cuda_equals_the_uninterrupted_run(dev, path, tmp_path):
    from repro_torch.api import CheckpointCallback, EarlyStopCallback
    from repro_torch.checkpoint import to_arrays

    spec = _small_spec(path)
    full = Session(spec, device="cuda").run()
    Session(spec, device="cuda", callbacks=[
        CheckpointCallback(str(tmp_path)),
        EarlyStopCallback(lambda i: int(i.state.pt.t.item()) >= 600)]).run()
    resumed = Session.from_checkpoint(str(tmp_path), device="cuda")
    assert resumed.state.pt.states.device.type == "cuda"
    got, want = to_arrays(resumed.run().state), to_arrays(full.state)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not build.dirty_tickets()


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
@pytest.mark.parametrize("q,j", [(3, 1.0), (5, 0.7), (2, 1.0), (64, 0.7)])
@pytest.mark.parametrize("h,w,r", [(12, 18, 10), (2, 2, 13), (4, 4, 13), (8, 6, 13),
                                   (64, 48, 13), (30, 66, 13), (470, 470, 13)])
def test_kernel_5_matches_plain(dev, rule, q, j, h, w, r):
    states, betas, rung = _colours(13, r, h, w, q, dev)
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
        fn, want_launches = ops.potts_round_fused, {"potts_fused": 3}
    got = fn(*(a.to(dev) if isinstance(a, torch.Tensor) else a for a in args), **kw)
    assert {k: v for k, v in build.launches.items() if v} == want_launches
    assert build.epilogues == {"exchange": 3 if path == "round" else 0}
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


@pytest.mark.parametrize("group", [8, 3, 1, None])  # None: the card's default width
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
    # #2p walks kernel A's runs and adds each replica's terms in A's order
    assert all(torch.equal(g, a) for g, a in zip(got, kernel_a))
    want = isk.ising_sweep_packed_plain(*args, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    if j == 1.0 and b == 0.0:  # integer terms: every order sums exactly
        assert torch.equal(got[1], want[1])
    else:  # the kernels sum each colour in their walk's order, the plain version in its own
        err = (got[1] - want[1]).abs().double()
        assert bool((err <= 4 * F32_EPS * want[2].double() * 2 * (4 * abs(j) + b)).all())


@pytest.mark.parametrize("group", [1, 3, 8])
@pytest.mark.parametrize("j,b,rule", [(1.0, 0.0, "glauber"), (0.7, 0.3, "metropolis")])
@pytest.mark.parametrize("length,r", WALK_SHAPES)
def test_packed_kernel_equals_kernel_a_on_the_walk_shapes(dev, length, r, j, b, rule, group):
    """#2p on kernel A's row-walk edges (L=2, 4, 30, 66, 470): spins, counts
    and ΔE bit for bit kernel A's, with full and partial groups."""
    spins, betas, rung = _lattice(23, r, length, dev)
    args = (spins, keys.key(7, device=dev), torch.tensor(11, device=dev), betas, rung)
    kw = dict(n_sweeps=3, j=j, b=b, rule=rule, replica_offset=4, t_add=2)
    got = isk.ising_sweep_packed_kernel(*args, **kw, group=group)
    kernel_a = isk.ising_sweep_fused_kernel(*args, **kw)
    assert all(torch.equal(g, a) for g, a in zip(got, kernel_a))


def test_packed_round_on_cuda_equals_cpu(dev):
    spins, betas, rung = _lattice(22, 11, 8, dev)
    energy = torch.linspace(-100, -20, 11, device=dev)[rung.long()]
    args = (spins, keys.key(2), 4, 1, rung, energy, betas)
    kw = dict(n_sweeps=3, n_rounds=3, rule="glauber", pairing="deo", pack_bits=True)
    build.reset_launches()
    got = ops.ising_round_fused(*(a.to(dev) if isinstance(a, torch.Tensor) else a
                                  for a in args), **kw)
    assert {k: v for k, v in build.launches.items() if v} == {"ising_packed": 3}
    assert build.epilogues == {"exchange": 3}
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
    if path == "round":  # one launch and one exchange per chain and interval
        assert {k: v for k, v in build.launches.items() if v} == {"ising_packed": 6}
        assert build.epilogues == {"exchange": 6}


def _wkv6_inputs(seed, bh, t, dk, dv, dev, state=False):
    rng = np.random.default_rng(seed)
    r, k = (rng.normal(size=(bh, t, dk)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(bh, t, dv)).astype(np.float32)
    w = (1.0 / (1.0 + np.exp(-rng.normal(size=(bh, t, dk))))).astype(np.float32)
    u = rng.normal(size=(bh, dk)).astype(np.float32)
    s0 = rng.normal(size=(bh, dk, dv)).astype(np.float32) if state else None
    return [None if x is None else torch.from_numpy(x).to(dev) for x in (r, k, v, w, u, s0)]


@pytest.mark.parametrize("bh,t,dk,dv,state", [
    (256, 512, 64, 64, False),  # rwkv6-7b prefill, B=4
    (256, 1, 64, 64, True),  # rwkv6-7b decode, carried state
    (4, 33, 8, 8, False), (2, 16, 16, 8, True), (1, 8, 4, 4, False), (3, 64, 64, 64, True),
    # rows that are no multiple of 16 bytes (4-byte copies), several stages
    (2, 33, 1, 5, True), (3, 33, 63, 5, False), (2, 1000, 5, 63, True),
    (2, 1000, 64, 64, False),
])
def test_wkv6_kernel_matches_plain(dev, bh, t, dk, dv, state):
    """Kernel #7 == ``ref.wkv6`` within the recurrence's rounding bound,
    2·(dk + T)·eps times the recurrence run on the inputs' magnitudes; and
    within the JAX package's rtol = atol = 3e-5 where T <= 64."""
    args = _wkv6_inputs(40 + t, bh, t, dk, dv, dev, state)
    build.reset_launches()
    got = ops.wkv6(*args)
    assert {k: v for k, v in build.launches.items() if v} == {"wkv6": 1}
    want = ref.wkv6(*args)
    mag = ref.wkv6(*(None if x is None else x.abs() for x in args))
    for g, w, m in zip(got, want, mag):
        assert bool(((g - w).abs() <= 2 * (dk + t) * F32_EPS * m).all())
        if t <= 64:
            torch.testing.assert_close(g, w, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("t,split,dk,dv", [(100, 45, 64, 64), (70, 1, 5, 63), (33, 32, 63, 1)])
def test_wkv6_split_off_a_stage_boundary_equals_one_run(dev, t, split, dk, dv):
    """Two launches carrying the state equal one, bit for bit, where the split
    is off the kernel's 32-step stages (and at one, with unaligned rows)."""
    r, k, v, w, u, s0 = _wkv6_inputs(52, 3, t, dk, dv, dev, state=True)
    o_full, s_full = ops.wkv6(r, k, v, w, u, s0)
    o1, s1 = ops.wkv6(*(x[:, :split].contiguous() for x in (r, k, v, w)), u, s0)
    o2, s2 = ops.wkv6(*(x[:, split:].contiguous() for x in (r, k, v, w)), u, s1)
    assert torch.equal(o_full, torch.cat([o1, o2], 1)) and torch.equal(s_full, s2)


def test_wkv6_kernel_threads_state_and_refuses_what_it_lacks(dev):
    r, k, v, w, u, _ = _wkv6_inputs(50, 2, 32, 8, 8, dev)
    o_full, s_full = ops.wkv6(r, k, v, w, u)
    first = [x[:, :16].contiguous() for x in (r, k, v, w)]
    rest = [x[:, 16:].contiguous() for x in (r, k, v, w)]
    o1, s1 = ops.wkv6(*first, u)
    o2, s2 = ops.wkv6(*rest, u, s1)
    assert torch.equal(o_full, torch.cat([o1, o2], 1)) and torch.equal(s_full, s2)
    big = _wkv6_inputs(51, 1, 2, 65, 8, dev)
    with pytest.raises(ValueError, match="dk, dv <= 64"):
        ops.wkv6(*big)
    with pytest.raises(ValueError, match="contiguous"):
        ops.wkv6(r[:, ::2], k[:, ::2], v[:, ::2], w[:, ::2], u)
    with pytest.raises(TypeError, match="dtype"):
        ops.wkv6(r.double(), k.double(), v.double(), w.double(), u.double())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_rwkv_on_cuda_equals_cpu(dev, dtype):
    """The reduced rwkv6-7b on the card against the same weights on the CPU:
    f32 prefill logits within 1e-4 and sampled tokens equal; bf16 logits
    within the JAX package's decode tolerance 3e-2 (rounding per op on both,
    GEMMs summed in other orders).  One wkv6 launch per layer and forward."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve_lm
    from repro_torch.models import model as model_lib

    cfg = dataclasses.replace(get_config("rwkv6_7b", reduced=True), dtype=dtype)
    on_cpu = model_lib.init_params(cfg, 0, device="cpu")
    on_card = copy.deepcopy(on_cpu).to(dev)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 12)))
    build.reset_launches()
    got = model_lib.prefill_logits(on_card, cfg, {"tokens": tokens.to(dev)})
    assert {k: v for k, v in build.launches.items() if v} == {"wkv6": cfg.n_layers}
    want = model_lib.prefill_logits(on_cpu, cfg, {"tokens": tokens})
    tol = 1e-4 if dtype == "float32" else 3e-2
    torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)
    if dtype == "float32":
        build.reset_launches()
        seq_card = serve_lm.generate(on_card, cfg, 4, 8, dev)
        assert build.launches["wkv6"] == 8 * cfg.n_layers
        assert torch.equal(seq_card.cpu(), serve_lm.generate(on_cpu, cfg, 4, 8, "cpu"))


# -- the serial chains (csrc/serial_chain.cu) and the rest of the zoo -------------


@pytest.mark.parametrize("sequence,r,eps", [
    ("HPH", 5, 1.0), ("HHPPHPH", 33, 0.7), ("HPHPPHHPHH", 13, 1.0),
    ("HPHPPHHPHHPHPHHPPHPH", 130, 1.3),
])
def test_hp_moves_kernel_matches_plain(dev, sequence, r, eps):
    """Positions, ΔE and counts bit for bit over 4 launches, each from the
    last one's (folded) chains."""
    from repro_torch.core.hp import HPChain

    rng = np.random.default_rng(len(sequence) + r)
    pos = HPChain(sequence).init_state_batched(keys.split(keys.key(4, device=dev), r))
    betas = torch.from_numpy(rng.uniform(0.2, 3.0, r).astype(np.float32)).to(dev)
    key, t = keys.key(9, device=dev), torch.tensor(11, device=dev)
    hmask = torch.tensor([c == "H" for c in sequence], device=dev)
    build.reset_launches()
    for _ in range(4):
        kw = dict(hmask=hmask, eps=eps, n_moves=len(sequence))
        got = sc.hp_moves_kernel(pos, key, t, betas, **kw)
        want = sc.hp_moves_plain(pos, key, t, betas, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        pos, t = got[0], t + 1
    assert build.launches["hp_moves"] == 4


@pytest.mark.parametrize("flips", [1, 7, 300])
@pytest.mark.parametrize("length,rule,j,b", [
    (5, "metropolis", 1.0, 0.0), (6, "glauber", 1.0, 0.0), (7, "glauber", 0.7, 0.3),
    (33, "metropolis", 1.0, 0.3),
])
def test_single_flip_kernel_matches_plain(dev, length, rule, j, b, flips):
    spins = _lattice(length + flips, 9, length, dev)[0]
    betas = torch.linspace(0.2, 1.5, 9, device=dev)
    key, t = keys.key(2, device=dev), torch.tensor(5, device=dev)
    build.reset_launches()
    for _ in range(2):
        kw = dict(j=j, b=b, rule=rule, flips=flips)
        got = sc.single_flip_kernel(spins, key, t, betas, **kw)
        want = sc.single_flip_plain(spins, key, t, betas, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        spins, t = got[0], t + 1
    assert build.launches["single_flip"] == 2


def test_serial_chain_ops_dispatch_to_the_kernels(dev):
    from repro_torch.core.hp import HPChain

    build.reset_launches()
    pos = HPChain("HPHPH").init_state_batched(keys.split(keys.key(1, device=dev), 3))
    ops.hp_moves(pos, keys.key(2, device=dev), 0, torch.ones(3, device=dev),
                 hmask=torch.ones(5, dtype=torch.bool, device=dev), eps=1.0, n_moves=5)
    ops.single_flip(_lattice(1, 3, 5, dev)[0], keys.key(2, device=dev), 0,
                    torch.ones(3, device=dev), flips=4)
    assert build.launches["hp_moves"] == 1 and build.launches["single_flip"] == 1


ZOO_SPECS = {
    "ea": ({"name": "ea_spin_glass", "params": {"shape": [4, 6], "disorder_seed": 2,
                                                "accept_rule": "glauber"}}, ["absmag"]),
    "hp": ({"name": "hp_protein", "params": {"sequence": "HPHPPHHPHH"}}, ["rg2"]),
    "single_flip": ({"name": "ising", "params": {"length": 5, "update": "single_flip",
                                                  "flips_per_step": 7}}, ["absmag"]),
    "gaussian": ({"name": "gaussian", "params": {"mus": [-3.0, 3.0]}}, ["absx"]),
}


def _zoo_spec(case, swap_mode="temp"):
    d = json.loads(_small_spec("sweep").to_json())
    d["system"], d["observables"] = ZOO_SPECS[case]
    d["engine"] = {"swap_interval": 5, "chunk_intervals": 4, "swap_mode": swap_mode}
    return RunSpec.from_json(d)


@pytest.mark.parametrize("swap_mode", ["temp", "state"])
@pytest.mark.parametrize("case", sorted(ZOO_SPECS))
def test_zoo_session_on_cuda_equals_cpu(dev, case, swap_mode):
    """The zoo's per-sweep paths: counters and the final state equal on the
    card and the CPU (the Gaussian's energies within 1e-5: the card's and
    the CPU's exp and log differ in ulps)."""
    spec = _zoo_spec(case, swap_mode)
    build.reset_launches()
    on_card = Session(spec, device="cuda").run().manifest()
    want = {"ea": "jax_uniform", "hp": "hp_moves", "single_flip": "single_flip"}.get(case)
    assert {k for k, v in build.launches.items() if v} == ({want} if want else set())
    on_cpu = Session(spec, device="cpu").run().manifest()
    for name in on_cpu["phases"]:
        got, ref_ = on_card["phases"][name]["summary"], on_cpu["phases"][name]["summary"]
        for k in ("swap_attempts", "swap_acceptance", "round_trips"):
            assert got[k] == ref_[k]
        np.testing.assert_allclose(got["mean_energy"], ref_["mean_energy"],
                                   rtol=0 if case != "gaussian" else 1e-5)
    if case == "gaussian":
        assert on_card["final"]["sweep"] == on_cpu["final"]["sweep"]
        np.testing.assert_allclose(on_card["final"]["energy"], on_cpu["final"]["energy"],
                                   rtol=1e-5, atol=1e-5)
    else:
        assert on_card["final"] == on_cpu["final"]


@pytest.mark.parametrize("case", sorted(ZOO_SPECS))
def test_zoo_interval_loop_never_syncs_the_host(dev, case):
    session = Session(_zoo_spec(case), device="cuda")
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
