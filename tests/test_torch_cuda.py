"""CUDA twins of the port's parity tests: each kernel against its plain version.

Kernel A, the round launches of A, #2p and #5 (sweeps, then the exchange run
by the last block to finish) against the plain sweeps and `exchange_plain`,
#2p (A's sweeps on packed spins, also
held against kernel A: spins, counts and ΔE bit for bit, at every group
width and on the walk's edge shapes), #1 and #4 (one Ising / Potts sweep on passed-in
uniforms), #5 (fused Potts sweeps), the per-sweep ``jax.random`` draw and
#7 (the RWKV-6 recurrence) and #7b (its gradient, the backward of
`ops.wkv6` under autograd, never the plain version); the Session paths on the card against the CPU,
with one chain and with two, and with the SEO, windowed and VMPT strategies
and state mode; the interval loop of every path with host syncs made
errors; a run checkpointed and resumed on the card against its
uninterrupted run; the reduced rwkv6-7b on the card against the CPU (serving
launches unchanged under ``no_grad``, and three f32 train steps); both
serial-chain kernels (HP moves, Ising single_flip) against their plain
versions, and the zoo's per-sweep paths (EA, HP, single_flip, the Gaussian)
on the card against the CPU and with host syncs made errors; the sharded
round path's standalone exchange (its shared-memory and global-scratch
variants) against a round launch's exchange and the plain version, with the
rank slice and next phase it writes, as the sharded step's one device op
between its gathers and its observables.

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
    if path == "round":  # one launch an interval for both chains, one exchange a chain
        assert {k: v for k, v in build.launches.items() if v} == {"ising_packed": 3}
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


def _wkv6_bwd_inputs(seed, bh, t, dk, dv, dev, state):
    args = _wkv6_inputs(seed, bh, t, dk, dv, dev, state)
    rng = np.random.default_rng(seed + 1)
    d_o = torch.from_numpy(rng.normal(size=(bh, t, dv)).astype(np.float32)).to(dev)
    d_s = (torch.from_numpy(rng.normal(size=(bh, dk, dv)).astype(np.float32)).to(dev)
           if state else None)
    return args, d_o, d_s


@pytest.mark.parametrize("bh,t,dk,dv,state", [
    (512, 512, 64, 64, False), (512, 512, 64, 64, True),  # rwkv6-7b training, B=8
    (4, 1, 64, 64, True), (4, 33, 64, 64, False), (3, 33, 8, 8, True),
    (2, 33, 5, 63, True), (2, 70, 63, 5, False), (3, 100, 48, 48, True),
    (2, 1000, 64, 64, True),
])
def test_wkv6_bwd_kernel_matches_plain(dev, bh, t, dk, dv, state):
    """Kernel #7b == the gradient of ``ref.wkv6`` under autograd (r, k, v,
    w, u, initial state) within 4·(T + dk + dv)·eps times the same gradient
    taken on the inputs' magnitudes (every term of a gradient is a product
    of inputs, summed over up to T steps and dk or dv lanes, in other
    orders); one launch."""
    from repro_torch.kernels import wkv6 as wk

    args, d_o, d_s = _wkv6_bwd_inputs(60 + t, bh, t, dk, dv, dev, state)
    build.reset_launches()
    got = wk.wkv6_bwd_kernel(*args, d_o, d_s)
    assert {k: v for k, v in build.launches.items() if v} == {"wkv6_bwd": 1}
    want = wk.wkv6_bwd_plain(*args, d_o, d_s)
    mag = wk.wkv6_bwd_plain(*(None if x is None else x.abs() for x in (*args, d_o, d_s)))
    for g, w, m in zip(got, want, mag):
        assert bool(torch.isfinite(g).all())
        assert bool(((g - w).abs() <= 4 * (t + dk + dv) * F32_EPS * m).all())


def test_wkv6_backward_on_cuda_launches_the_kernel_never_plain(dev, monkeypatch):
    """`ops.wkv6` under autograd on the card: one #7 forward, one #7b
    backward, the plain recurrence never called (patched to raise), the
    gradients equal to the kernel's; under ``no_grad`` just #7."""
    from repro_torch.kernels import wkv6 as wk

    args, d_o, d_s = _wkv6_bwd_inputs(70, 8, 40, 64, 64, dev, True)
    direct = wk.wkv6_bwd_kernel(*args, d_o, d_s)

    def refuse(*a, **k):
        raise AssertionError("the plain wkv6 ran on CUDA tensors")

    monkeypatch.setattr(ref, "wkv6", refuse)
    monkeypatch.setattr(wk, "wkv6_plain", refuse)
    xs = [x.clone().requires_grad_() for x in args]
    build.reset_launches()
    o, s = ops.wkv6(*xs)
    grads = torch.autograd.grad((o, s), xs, (d_o, d_s))
    assert {k: v for k, v in build.launches.items() if v} == {"wkv6": 1, "wkv6_bwd": 1}
    for g, want in zip(grads, direct):
        assert torch.equal(g, want)
    build.reset_launches()
    with torch.no_grad():
        ops.wkv6(*xs)
    assert {k: v for k, v in build.launches.items() if v} == {"wkv6": 1}


@pytest.mark.parametrize("remat", [False, True])
def test_train_steps_on_cuda_equal_cpu(dev, remat):
    """Three f32 train steps of the reduced rwkv6-7b on the card against
    the CPU from one state: each loss within 1e-5 relative, the masters
    within what the two runs' Adam directions explain
    (`_torch_train_bound`, as tests/test_torch_train.py holds the port
    against JAX), the card's masters before the last step far outside it.
    Launches a step: one #7 and one
    #7b a layer, two #7 with ``remat``; and serving's prefill under
    ``no_grad`` still one #7 a layer."""
    import dataclasses

    import _torch_train_bound as tb

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import model as model_lib
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import init_state, make_train_step

    cfg = dataclasses.replace(get_config("rwkv6_7b", reduced=True), dtype="float32",
                              remat=remat)
    opt = opt_lib.AdamWConfig(warmup_steps=2, total_steps=10)
    on_cpu, on_card = init_state(cfg, 0, device="cpu"), init_state(cfg, 0, device="cpu")
    on_card.params = {n: p.to(dev) for n, p in on_card.params.items()}
    on_card.opt = opt_lib.init(on_card.params)
    on_card.step = on_card.step.to(dev)
    step = make_train_step(cfg, opt)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=4)
    def host(tree):
        return {n: x.cpu().numpy().copy() for n, x in tree.items()}

    bound = {}
    for i in range(3):
        b = {k: torch.from_numpy(v) for k, v in data.batch(i).items()}
        before = host(on_card.params)
        on_cpu, m_cpu = step(on_cpu, b)
        build.reset_launches()
        on_card, m_card = step(on_card, {k: v.to(dev) for k, v in b.items()})
        torch.cuda.synchronize()
        want = {"wkv6": (2 if remat else 1) * cfg.n_layers, "wkv6_bwd": cfg.n_layers}
        assert {k: v for k, v in build.launches.items() if v} == want
        torch.testing.assert_close(m_card["loss"].cpu(), m_cpu["loss"], rtol=1e-5, atol=0)
        bound = tb.grow(bound, opt, float(m_cpu["lr"]), i + 1, before,
                        (host(on_card.opt.mu), host(on_card.opt.nu)),
                        (host(on_cpu.opt.mu), host(on_cpu.opt.nu)))
    assert tb.reading(host(on_card.params), host(on_cpu.params), bound) <= 1.0
    assert tb.reading(before, host(on_cpu.params), bound) > 100.0
    serving = dataclasses.replace(cfg, dtype="bfloat16")
    lm = model_lib.init_params(serving, 0, device=dev)
    tokens = torch.ones((2, 9), dtype=torch.int64, device=dev)
    build.reset_launches()
    with torch.no_grad():
        model_lib.prefill_logits(lm, serving, {"tokens": tokens})
    assert {k: v for k, v in build.launches.items() if v} == {"wkv6": cfg.n_layers}


# -- the serial chains (csrc/serial_chain.cu) and the rest of the zoo -------------


@pytest.mark.parametrize("sequence,r,eps", [
    ("HPH", 5, 1.0), ("HHPPHPH", 33, 0.7), ("HPHPPHHPHH", 13, 1.0),
    ("HPHPPHHPHHPHPHHPPHPH", 130, 1.3), ("HPHPPHHPHHPHPHHPPHPH", 1501, 1.0),
    (("HPHPPHHPHHPHPHHPPHPH" * 2)[:33], 1, 1.0), (("HPHPPHHPHHPHPHHPPHPH" * 3)[:48], 33, 0.8),
])
def test_hp_moves_kernel_matches_plain(dev, sequence, r, eps):
    """Positions, ΔE and counts bit for bit over 4 launches, each from the
    last one's (folded) chains; N > 32 puts several monomers on a lane, and
    R = 1, 33, 1501 leave warps of the last block (four a block) idle."""
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


def test_hp_moves_kernel_matches_plain_past_shared_memory(dev):
    """A chain too long for one warp's shared memory (N = 26,000) is worked
    on in the output rows: bit for bit over 2 launches of 256 moves from a
    staircase, where every interior monomer can make a corner move."""
    n, r = 26000, 5
    rng = np.random.default_rng(26)
    i = np.arange(n)
    stairs = np.stack([(i + 1) // 2, i // 2], axis=-1).astype(np.int32)
    pos = torch.from_numpy(np.broadcast_to(stairs, (r, n, 2)).copy()).to(dev)
    betas = torch.from_numpy(rng.uniform(0.2, 3.0, r).astype(np.float32)).to(dev)
    key, t = keys.key(8, device=dev), torch.tensor(3, device=dev)
    hmask = torch.from_numpy(rng.random(n) < 0.5).to(dev)
    build.reset_launches()
    for _ in range(2):
        kw = dict(hmask=hmask, eps=1.0, n_moves=256)
        got = sc.hp_moves_kernel(pos, key, t, betas, **kw)
        want = sc.hp_moves_plain(pos, key, t, betas, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        pos, t = got[0], t + 1
    assert int(got[2].sum()) > 0
    assert build.launches["hp_moves"] == 2


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


@pytest.mark.parametrize("length,r,flips", [
    (9, 33, 128), (9, 1, 129), (9, 1, 255), (9, 33, 256), (10, 1501, 257), (31, 33, 1000),
    (5, 33, 300), (2, 1, 300),
])
def test_single_flip_kernel_tile_edges_match_plain(dev, length, r, flips):
    """Flip counts around the kernel's 128-flip tile (one tile, one and two
    tiles with a flip over or short) and past several tiles;
    L=5 and L=2 with 300 flips, where every flip collides with an earlier
    one (spins, ΔE and counts bit for bit over 2 launches)."""
    spins = _lattice(length + flips + r, r, length, dev)[0]
    betas = torch.linspace(0.2, 1.5, r, device=dev)
    key, t = keys.key(6, device=dev), torch.tensor(3, device=dev)
    build.reset_launches()
    for _ in range(2):
        kw = dict(j=0.7, b=0.3, rule="metropolis", flips=flips)
        got = sc.single_flip_kernel(spins, key, t, betas, **kw)
        want = sc.single_flip_plain(spins, key, t, betas, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        spins, t = got[0], t + 1
    assert build.launches["single_flip"] == 2


def test_single_flip_kernel_refuses_a_lattice_past_int32_indices(dev):
    spins = torch.empty((1, 46341, 46341), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="int32"):
        sc.single_flip_kernel(spins, keys.key(1, device=dev), torch.tensor(0, device=dev),
                              torch.ones(1, device=dev), j=1.0, b=0.0, rule="glauber",
                              flips=1)


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


# -- the chain axis of kernels A, #2p and #5, and serving on the card ---------------

CHAIN_KERNELS = ("ising_fused", "ising_packed", "potts_fused")


def _chain_launchers(kernel):
    if kernel == "potts_fused":
        return (functools.partial(pk.potts_sweep_fused_kernel, q=3),
                functools.partial(pk.potts_round_kernel, q=3))
    packed = kernel == "ising_packed"
    return (isk.ising_sweep_packed_kernel if packed else isk.ising_sweep_fused_kernel,
            functools.partial(isk.ising_round_kernel, pack_bits=packed))


@pytest.mark.parametrize("kernel", CHAIN_KERNELS)
@pytest.mark.parametrize("c,length,r,s", [(1, 8, 8, 3), (2, 32, 40, 1), (5, 8, 13, 4),
                                          (3, 66, 7, 2)])
def test_chain_axis_launch_equals_per_chain_launches(dev, kernel, c, length, r, s):
    """One launch over C chains (sweeps alone, and a round) equals C launches
    of one chain bit for bit, counts one launch and C exchanges, and leaves
    every chain's ticket at 0."""
    rng = np.random.default_rng(c * 100 + length)
    hi = 3 if kernel == "potts_fused" else 2
    st = torch.from_numpy(rng.integers(0, hi, (c, r, length, length)).astype(np.int8)).to(dev)
    if kernel != "potts_fused":
        st = 2 * st - 1
    betas = torch.from_numpy((1.0 / np.geomspace(1.0, 4.0, r)).astype(np.float32)).to(dev)
    rung = torch.from_numpy(np.stack([rng.permutation(r) for _ in range(c)]).astype(np.int32)).to(dev)
    energy = torch.from_numpy(-rng.integers(0, 99, (c, r)).astype(np.float32)).to(dev)
    words = torch.stack([keys.key(11 + i, device=dev) for i in range(c)])
    t0 = torch.from_numpy(rng.integers(0, 50, c)).to(dev)
    ph0 = torch.from_numpy(rng.integers(0, 50, c)).to(dev)
    sweeps, one_round = _chain_launchers(kernel)
    kw, xw = dict(n_sweeps=s, rule="glauber"), dict(pairing="seo", criterion="logistic")
    build.reset_launches()
    got = sweeps(st, words, t0, betas, rung, **kw)
    got_round = one_round(st, words, t0, ph0, betas, rung, energy, **kw, **xw)
    assert {n: v for n, v in build.launches.items() if v} == {kernel: 2}
    assert build.epilogues == {"exchange": c}
    for i in range(c):
        want = sweeps(st[i], words[i], t0[i], betas, rung[i], **kw)
        want_round = one_round(st[i], words[i], t0[i], ph0[i], betas, rung[i], energy[i],
                               **kw, **xw)
        for x, y in zip((*got, *got_round), (*want, *want_round)):
            assert torch.equal(x[i], y)
    assert build.dirty_tickets() == {}


@pytest.mark.parametrize("kernel", ["A", "2p", "potts"])
def test_chain_axis_ops_on_cuda_equal_cpu(dev, kernel):
    """The chain-axis ops, one launch a round on the card, equal their plain
    versions chain by chain on the CPU."""
    rng = np.random.default_rng(3)
    c, r, length = 3, 6, 8
    hi = 3 if kernel == "potts" else 2
    st = torch.from_numpy(rng.integers(0, hi, (c, r, length, length)).astype(np.int8))
    if kernel != "potts":
        st = 2 * st - 1
    rung = torch.from_numpy(np.stack([rng.permutation(r) for _ in range(c)]).astype(np.int32))
    energy = torch.from_numpy(-rng.integers(0, 99, (c, r)).astype(np.float32))
    betas = torch.from_numpy((1.0 / np.geomspace(1.0, 4.0, r)).astype(np.float32))
    key = torch.stack([keys.key(5 + i) for i in range(c)])
    t, ph = torch.tensor([1, 7, 9]), torch.tensor([0, 3, 4])
    if kernel == "potts":
        op = functools.partial(ops.potts_round_fused, q=3)
    else:
        op = functools.partial(ops.ising_round_fused, pack_bits=kernel == "2p")
    kw = dict(n_sweeps=2, n_rounds=3, rule="glauber", pairing="deo")
    want = op(st, key, t, ph, rung, energy, betas, **kw)
    build.reset_launches()
    got = op(*(x.to(dev) for x in (st, key, t, ph, rung, energy, betas)), **kw)
    name = {"A": "ising_fused", "2p": "ising_packed", "potts": "potts_fused"}[kernel]
    assert build.launches[name] == 3 and build.epilogues["exchange"] == 3 * c
    for n, (x, y) in enumerate(zip(got, want)):
        if n == 5:  # prob: CUDA expf vs the CPU's vectorized exp, a few ulps
            torch.testing.assert_close(x.cpu(), y, rtol=4 * F32_EPS, atol=0)
        else:
            assert torch.equal(x.cpu(), y), n


@pytest.mark.parametrize("path", ["round", "fused", "sweep"])
def test_serve_bucket_on_cuda_equals_solo_and_cpu(dev, path):
    """4 tenants of ising_serve.json packed on the card: each equal to its
    solo run on the card and to the CPU bucket; on the round path one launch
    a round for the bucket."""
    from repro_torch.serve import Scheduler

    d = json.loads((Path(__file__).resolve().parents[1] / "examples" / "specs"
                    / "ising_serve.json").read_text())
    d["system"]["params"].update(use_fused=path != "sweep", use_fused_round=path == "round")
    specs = [RunSpec.from_dict({**d, "seed": s}) for s in range(4)]
    out = {}
    for device in ("cuda", "cpu"):
        sched = Scheduler(device=device, strict_kernels=True)
        jobs = [sched.submit(s) for s in specs]
        build.reset_launches()
        sched.run_until_idle()
        out[device] = [j.result(timeout=0) for j in jobs]
        if device == "cuda" and path == "round":
            assert build.launches["ising_fused"] == 16 and build.epilogues["exchange"] == 64
    for got, cpu, spec in zip(out["cuda"], out["cpu"], specs):
        solo = Session(spec, device="cuda", strict_kernels=True).run()
        assert np.array_equal(got.final_energy, solo.final_energies())
        assert np.array_equal(got.final_energy, cpu.final_energy)
        for name, res in solo.phases.items():
            for k, v in res.summary.items():
                assert np.array_equal(np.asarray(got.phases[name][k]), np.asarray(v)), k


def test_degradation_stays_on_the_card(dev):
    """An injected compile fault on the round path degrades to the per-sweep
    path on the card: kernels #1 and jax_uniform, equal to a never-fused run."""
    from repro_torch.resilience import Fault, FaultPlan

    temps = np.geomspace(1.5, 3.5, 4)
    cfg = EngineConfig(n_replicas=4, swap_interval=2, chunk_intervals=2, n_chains=2)
    eng = Engine(IsingSystem(length=8, use_fused=True, use_fused_round=True), cfg,
                 device="cuda", faults=FaultPlan([Fault("engine.compile")]))
    build.reset_launches()
    with pytest.warns(RuntimeWarning, match="per-sweep path on cuda"):
        st, _ = eng.run(eng.init(keys.key(2, device=dev), temps), 8)
    assert build.launches["ising_fused"] == 0 and build.launches["ising_sweep"] == 16
    ref = Engine(IsingSystem(length=8), cfg, device="cuda")
    st2, _ = ref.run(ref.init(keys.key(2, device=dev), temps), 8)
    assert st.pt.states.is_cuda and torch.equal(st.pt.states, st2.pt.states)
    assert torch.equal(st.pt.energy, st2.pt.energy)


@pytest.mark.parametrize("path", ["fused", "round"])
def test_ensemble_interval_loop_never_syncs_the_host(dev, path):
    """`Engine.advance` over 4 stacked chains on the chain-axis paths issues
    no host sync."""
    cfg = EngineConfig(n_replicas=6, swap_interval=3, chunk_intervals=2, n_chains=4)
    eng = Engine(IsingSystem(length=8, use_fused=True, use_fused_round=path == "round"), cfg,
                 device="cuda", strict_kernels=True)
    state = eng.init(keys.key(1, device=dev), np.geomspace(1.0, 3.0, 6))
    eng.advance(state, 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.advance(state, 3)
    finally:
        torch.cuda.set_sync_debug_mode(0)


# -- the mesh's kernels: the standalone exchange and the replica offsets ----------


# the largest R whose rows the standalone exchange keeps in shared memory
# (12 B a rung of an H100 block's 232,448 B); R + 1 runs its global variant
SHARED_MAX_R = 19368


def _exchange_rows_inputs(dev, r, c, seed):
    """(C, R) rung maps and energies, (R,) betas, (C,) phases, (C, 2) keys."""
    rng = np.random.default_rng(seed)
    betas = torch.from_numpy((1.0 / (1.0 + np.arange(r) * 3.0 / r)).astype(np.float32)).to(dev)
    rung = torch.from_numpy(np.stack([rng.permutation(r) for _ in range(c)]).astype(np.int32)
                            ).to(dev)
    energy = torch.from_numpy((-9000 + 50 * rng.permutation(r * c).reshape(c, r))
                              .astype(np.float32)).to(dev)
    phase = torch.from_numpy(rng.integers(0, 1 << 20, c)).to(dev)
    words = torch.stack([keys.key(int(s), device=dev) for s in rng.integers(1 << 30, size=c)])
    return rung, energy, betas, phase, words


@pytest.mark.parametrize("pairing", ["deo", "seo"])
@pytest.mark.parametrize("criterion", ["logistic", "metropolis"])
@pytest.mark.parametrize("r,c", [(6, 1), (6, 3), (1500, 1), (1500, 3), (1, 3), (2, 3), (3, 3),
                                 (1501, 3), (SHARED_MAX_R, 1), (SHARED_MAX_R + 1, 1),
                                 (SHARED_MAX_R + 1, 2)])
def test_exchange_step_kernel_matches_round_launch_and_plain(dev, r, c, pairing, criterion):
    """One standalone launch over C chains' gathered rows equals, chain by
    chain, a round launch's exchange (kernel A at S=0) bit for bit, and the
    plain ``exchange_step`` in rung and attempt, in accept and prob but where
    u lies between the two p (the round exchange's own contract).  Rows
    start unaligned at C=3 and R not a multiple of 4; R up to the largest
    that shared memory holds, and past it the global-scratch variant."""
    from repro_torch.kernels import exchange as xk

    assert xk.shared_fits(SHARED_MAX_R) and not xk.shared_fits(SHARED_MAX_R + 1)
    rung, energy, betas, phase, words = _exchange_rows_inputs(dev, r, c, r + c)
    build.reset_launches()
    got = xk.exchange_step_kernel(rung, energy, betas, phase, words, pairing=pairing,
                                  criterion=criterion)
    assert build.launches["exchange_step"] == 1
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(c):
        rd = isk.ising_round_kernel(torch.ones((r, 2, 2), dtype=torch.int8, device=dev),
                                    words[i], zero, phase[i], betas, rung[i], energy[i],
                                    n_sweeps=0, pairing=pairing, criterion=criterion)
        for g, w in zip(got, (rd[1], rd[4], rd[5], rd[6])):
            assert torch.equal(g[i], w)
        want = xk.exchange_step(rung[i], energy[i], betas, phase[i], words[i],
                                pairing=pairing, criterion=criterion)
        u = prng.swap_uniforms(words[i], phase[i], r)
        in_gap = (u >= torch.minimum(got[2][i], want[2])) & (u < torch.maximum(got[2][i], want[2]))
        assert not bool(((got[2][i] != want[2]) & ~in_gap).any())
        assert not bool(((got[1][i] != want[1]) & ~in_gap).any())
        assert torch.equal(got[3][i], want[3])
        if torch.equal(got[1][i], want[1]):
            assert torch.equal(got[0][i], want[0])


@pytest.mark.parametrize("r,c,block", [(1500, None, (0, 750)), (1500, None, (750, 1500)),
                                       (1501, 3, (1, 1500)), (7, 2, (3, 4)),
                                       (SHARED_MAX_R + 1, 2, (9685, SHARED_MAX_R + 1))])
def test_exchange_step_kernel_writes_rank_slice_and_next_phase(dev, r, c, block):
    """The launch's own post-work, in both variants: a mesh rank's slice of
    the new rungs as a row of its own, and phase + 1, for one chain's (R,)
    rows and for C stacked chains."""
    from repro_torch.kernels import exchange as xk

    args = _exchange_rows_inputs(dev, r, c or 1, r)
    if c is None:
        args = (args[0][0], args[1][0], args[2], args[3][0], args[4][0])
    new_rung, *_, rung_block, next_phase = xk.exchange_step_kernel(
        *args, pairing="seo", criterion="metropolis", block=block)
    assert rung_block.is_contiguous() and rung_block.dtype == torch.int32
    assert torch.equal(rung_block, new_rung[..., block[0]:block[1]])
    assert next_phase.shape == args[3].shape and torch.equal(next_phase, args[3] + 1)
    with pytest.raises(ValueError, match="not a slice"):
        xk.exchange_step_kernel(*args, pairing="seo", criterion="metropolis", block=(0, r + 1))


def _device_events(prof):
    from torch.autograd import DeviceType

    return sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def test_exchange_rows_dispatches_one_launch(dev):
    """A call on tensors of the kernel's types is one launch and no other
    device op (no scratch, no conversion or copy: the profiler sees one
    kernel); C chains take one launch, each chain's rows its solo call's."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import exchange as xk

    rung = torch.stack([torch.randperm(8, device=dev) for _ in range(2)]).int()
    energy = -torch.arange(16, dtype=torch.float32, device=dev).reshape(2, 8)
    betas = torch.linspace(1.0, 0.3, 8, device=dev)
    phase = torch.tensor([3, 4], device=dev)
    key = torch.stack([keys.key(1, device=dev), keys.key(2, device=dev)])
    build.reset_launches()
    got = xk.exchange_rows(rung, energy, betas, phase, key, pairing="deo", criterion="logistic")
    one = xk.exchange_rows(rung[1], energy[1], betas, phase[1], key[1], pairing="deo",
                           criterion="logistic")
    assert build.launches["exchange_step"] == 2
    for g, o in zip(got, one):
        assert torch.equal(g[1], o)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        xk.exchange_rows(rung, energy, betas, phase, key, pairing="deo", criterion="logistic",
                         block=(4, 8))
        torch.cuda.synchronize()
    names = [e.name for e in _device_events(prof)]
    assert len(names) == 1 and "exchange_shared_kernel" in names[0], names
    with pytest.raises(ValueError, match="CUDA"):
        xk.exchange_step_kernel(rung.cpu(), energy.cpu(), betas.cpu(), phase.cpu(), key.cpu(),
                                pairing="deo", criterion="logistic")
    with pytest.raises(TypeError, match="dtype"):
        xk.exchange_step_kernel(rung.long(), energy, betas, phase, key, pairing="deo",
                                criterion="logistic")
    with pytest.raises(ValueError, match="contiguous"):
        xk.exchange_step_kernel(rung.t().contiguous().t(), energy, betas, phase, key,
                                pairing="deo", criterion="logistic")


def test_sharded_round_step_runs_only_the_exchange_between_gathers_and_observables(
        dev, monkeypatch):
    """On the card the sharded round step launches exactly one device op
    after its gathers and before its observables: the exchange, which also
    writes the rank's rungs and the next phase.  A one-rank layout whose
    gathers copy; a spin kernel marks each gather's end and the observables'
    start."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine import driver

    class OneRank:
        def slot_block(self, n):
            return 0, n

        def gather_replicas(self, x, dim=-1):
            out = x.clone()
            torch.cuda._sleep(1)
            return out

    observe = driver._observe

    def marked(observables, st, gather=None):
        torch.cuda._sleep(1)
        return observe(observables, st, gather)

    monkeypatch.setattr(driver, "_observe", marked)
    system = IsingSystem(length=8, use_fused=True, use_fused_round=True)
    eng = Engine(system, EngineConfig(n_replicas=6, swap_interval=2), device="cuda",
                 strict_kernels=True)
    state = eng.init(keys.key(5, device=dev), np.geomspace(1.0, 3.0, 6))
    step = driver.make_sharded_interval_step(
        system, driver.StepSpec(n_replicas=6, sweeps_per_interval=2),
        {"absmag": lambda s: s.float().mean((-2, -1)).abs()}, OneRank())
    want, _ = make_interval_step(system, driver.StepSpec(n_replicas=6, sweeps_per_interval=2))(
        state.pt, state.betas)
    step(state.pt, state.betas)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got, rec, rung = step(state.pt, state.betas)
        torch.cuda.synchronize()
    names = [e.name for e in _device_events(prof)]
    # the energy and rung gathers, the observables' start, the absmag gather
    spins = [i for i, n in enumerate(names) if "spin_kernel" in n]
    assert len(spins) == 4, names
    between = names[spins[1] + 1:spins[2]]
    assert len(between) == 1 and "exchange_shared_kernel" in between[0], between
    for f in ("states", "energy", "rung", "t", "phase"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(rung, want.rung)


@pytest.mark.parametrize("offset", [0, 20])
def test_jax_uniform_offset_matches_plain_and_unsharded_rows(dev, offset):
    key, t = keys.key(21, device=dev), torch.tensor(7, device=dev)
    whole = ju.jax_uniform_kernel(key, t, 40, (2, 8, 8))
    part = ju.jax_uniform_kernel(key, t, 20, (2, 8, 8), offset)
    assert torch.equal(part, whole[offset:offset + 20])
    ids = torch.arange(20, device=dev)
    assert torch.equal(part, ju.jax_uniform_plain(key, t, ids + offset, (2, 8, 8)))


@pytest.mark.parametrize("offset", [0, 65])
def test_serial_chains_offset_match_plain_and_unsharded_rows(dev, offset):
    from repro_torch.core.hp import HPChain

    seq, r = "HPHPPHHPHH", 130
    pos = HPChain(seq).init_state_batched(keys.split(keys.key(4, device=dev), r))
    betas = torch.linspace(0.3, 2.5, r, device=dev)
    key, t = keys.key(9, device=dev), torch.tensor(11, device=dev)
    kw = dict(hmask=torch.tensor([ch == "H" for ch in seq], device=dev), eps=1.0,
              n_moves=len(seq))
    blk = slice(offset, offset + 65)
    whole = sc.hp_moves_kernel(pos, key, t, betas, **kw)
    got = sc.hp_moves_kernel(pos[blk], key, t, betas[blk], replica_offset=offset, **kw)
    want = sc.hp_moves_plain(pos[blk], key, t, betas[blk], replica_offset=offset, **kw)
    for g, w, f in zip(got, want, whole):
        assert torch.equal(g, w) and torch.equal(g, f[blk])
    spins = _lattice(3, r, 9, dev)[0]
    fkw = dict(j=1.0, b=0.0, rule="glauber", flips=40)
    whole = sc.single_flip_kernel(spins, key, t, betas, **fkw)
    got = sc.single_flip_kernel(spins[blk], key, t, betas[blk], replica_offset=offset, **fkw)
    want = sc.single_flip_plain(spins[blk], key, t, betas[blk], replica_offset=offset, **fkw)
    for g, w, f in zip(got, want, whole):
        assert torch.equal(g, w) and torch.equal(g, f[blk])


@pytest.mark.parametrize("params", [
    {"length": 8, "use_fused": True, "use_fused_round": True},
    {"length": 8, "use_fused": True, "pack_bits": True},
    {"length": 8},
], ids=["round", "packed-fused", "per-sweep"])
def test_single_rank_mesh_on_the_card_equals_unsharded(dev, params):
    """``MeshSpec(1, 1)`` on the card (a one-rank NCCL group): the round path
    runs A then one standalone exchange an interval, no round launch; every
    path equals its unsharded run bit for bit."""
    from repro_torch.core.distributed import MeshSpec

    temps = np.geomspace(1.0, 3.0, 8)
    out = []
    for mesh in (None, MeshSpec(1, 1)):
        eng = Engine(IsingSystem(**params), EngineConfig(n_replicas=8, swap_interval=4,
                                                         mesh=mesh), device="cuda",
                     strict_kernels=True)
        build.reset_launches()
        st, _ = eng.run(eng.init(keys.key(3, device=dev), temps), 16)
        out.append((st, dict(build.launches), dict(build.epilogues)))
    (a, la, ea), (b, lb, eb) = out
    for f in ("states", "energy", "rung", "t", "phase"):
        assert torch.equal(getattr(a.pt, f), getattr(b.pt, f)), f
    if params.get("use_fused_round"):
        assert (la["ising_fused"], ea["exchange"], la["exchange_step"]) == (4, 4, 0)
        assert (lb["ising_fused"], eb["exchange"], lb["exchange_step"]) == (4, 0, 4)
    else:
        assert la == lb
