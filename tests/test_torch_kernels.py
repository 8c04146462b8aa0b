"""The port's Ising sweep, exchange and fused-op functions against the JAX package
(the per-sweep op and one per-sweep system step included; Potts is in
test_torch_potts.py).

Same inputs (numpy, from a seed) through `repro.kernels` (its
``use_pallas=False`` path, which the JAX package's own tests pin bit-equal
to the Pallas kernels in interpret mode) and `repro_torch.kernels`.

Tolerances:

* spins, acceptance counts, rung maps, accept/attempt rows: exact.  The one
  allowed exception is an acceptance ``u < p`` where JAX's and torch's
  exp/sigmoid differ by an ulp and ``u`` falls between the two ``p``;
  `_flip_possible` / `_swap_flip_explained` decide that from the tables and
  uniforms, and `test_ulp_gap_flip_is_detected_and_explained` shows it.
* ΔE: exact at j=1, b=0 (integer terms); otherwise within 4 ulps of the
  largest partial-sum magnitude, because the two frameworks sum in
  different orders.
* swap probabilities: within 4 ulps relative (sigmoid differs by up to 3).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import exchange as jexchange  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import prng as jprng  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import keys as tkeys  # noqa: E402
from repro_torch.kernels import build as tbuild  # noqa: E402
from repro_torch.kernels import exchange as texchange  # noqa: E402
from repro_torch.kernels import ising_sweep as tisk  # noqa: E402
from repro_torch.kernels import jax_uniform as tju  # noqa: E402
from repro_torch.kernels import potts_sweep as tpk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import prng as tprng  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

F32_EPS = 2.0 ** -23
_NBR = np.array([-4.0, -2.0, 0.0, 2.0, 4.0], np.float32)


def _lattice(seed, r, length):
    rng = np.random.default_rng(seed)
    spins = rng.choice(np.array([-1, 1], np.int8), size=(r, length, length))
    betas = (1.0 / np.linspace(1.0, 4.0, r)).astype(np.float32)
    return rng, spins, betas


def _accept_gaps(betas, j, b, rule):
    """(R, 2, 5) [lo, hi) between JAX's and torch's acceptance p per table entry."""
    s = np.array([-1.0, 1.0], np.float32)[:, None]
    de_j = 2.0 * jnp.asarray(s) * (j * jnp.asarray(_NBR)[None] - b)
    p_j = np.asarray(jref.accept_prob(de_j[None], jnp.asarray(betas)[:, None, None], rule))
    de_t = 2.0 * torch.from_numpy(s) * (j * torch.from_numpy(_NBR)[None] - b)
    p_t = tref.accept_prob(de_t[None], torch.from_numpy(betas)[:, None, None], rule).numpy()
    return np.minimum(p_j, p_t), np.maximum(p_j, p_t)


def _flip_possible(u, betas, j, b, rule):
    """True iff some uniform of ``u`` (R, ..., L, L) lies in the gap between the
    two frameworks' p of an entry its replica can meet — the only way a sweep
    may differ."""
    lo, hi = _accept_gaps(betas, j, b, rule)
    u = np.asarray(u).reshape(u.shape[0], -1)
    for r in range(u.shape[0]):
        for a, z in zip(lo[r].ravel(), hi[r].ravel()):
            if a < z and np.any((u[r] >= a) & (u[r] < z)):
                return True
    return False


def _swap_flip_explained(u, p_a, p_b, diff):
    """Every differing decision has its u between the two probabilities."""
    lo, hi = np.minimum(p_a, p_b), np.maximum(p_a, p_b)
    return bool(np.all(((u >= lo) & (u < hi))[diff]))


def _assert_de(got, want, nacc, j, b):
    got, want = np.asarray(got), np.asarray(want)
    if j == 1.0 and b == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        scale = np.asarray(nacc, np.float64) * 2 * (4 * abs(j) + abs(b))
        assert np.all(np.abs(got.astype(np.float64) - want) <= 4 * F32_EPS * scale)


@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
@pytest.mark.parametrize("j,b", [(1.0, 0.0), (0.7, 0.3)])
def test_ref_ising_sweep_matches_jax(rule, j, b):
    rng, spins, betas = _lattice(1, 6, 10)
    u = rng.random((6, 2, 10, 10), dtype=np.float32)
    want = jref.ising_sweep(jnp.asarray(spins), jnp.asarray(u), jnp.asarray(betas),
                            j=j, b=b, rule=rule)
    got = tref.ising_sweep(torch.from_numpy(spins), torch.from_numpy(u),
                           torch.from_numpy(betas), j=j, b=b, rule=rule)
    same = np.array_equal(got[0].numpy(), np.asarray(want[0])) and np.array_equal(
        got[2].numpy(), np.asarray(want[2]))
    if not same:
        assert _flip_possible(u, betas, j, b, rule), "sweep differs outside the ulp gap"
        return
    _assert_de(got[1].numpy(), want[1], want[2], j, b)


@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
@pytest.mark.parametrize("j,b", [(1.0, 0.0), (0.7, 0.3)])
def test_ops_ising_sweep_matches_jax(rule, j, b):
    """The per-sweep op (kernel #1's dispatch) on the CPU against JAX's
    ``ops.ising_sweep(use_pallas=False)``."""
    rng, spins, betas = _lattice(11, 5, 8)
    u = rng.random((5, 2, 8, 8), dtype=np.float32)
    want = jops.ising_sweep(jnp.asarray(spins), jnp.asarray(u), jnp.asarray(betas),
                            j=j, b=b, rule=rule, use_pallas=False)
    got = tops.ising_sweep(torch.from_numpy(spins), torch.from_numpy(u),
                           torch.from_numpy(betas), j=j, b=b, rule=rule, use_pallas=True)
    same = np.array_equal(got[0].numpy(), np.asarray(want[0])) and np.array_equal(
        got[2].numpy(), np.asarray(want[2]))
    if not same:
        assert _flip_possible(u, betas, j, rule), "sweep differs outside the ulp gap"
        return
    _assert_de(got[1].numpy(), want[1], want[2], j, b)


def test_ising_batched_mcmc_step_matches_jax():
    """One per-sweep step: JAX derives the replica keys fold_in(fold_in(key,
    2t), r) and draws; the port draws from the run key and t directly."""
    from repro.core.ising import IsingSystem as JIsing
    from repro_torch.core.ising import IsingSystem as TIsing

    _, spins, betas = _lattice(12, 5, 8)
    t = 23
    keys_r = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.fold_in(jax.random.key(4), 2 * t), jnp.arange(5, dtype=jnp.uint32))
    want = JIsing(length=8, accept_rule="glauber").batched_mcmc_step(
        keys_r, jnp.asarray(spins), jnp.asarray(betas))
    got = TIsing(length=8, accept_rule="glauber").batched_mcmc_step(
        tkeys.key(4), torch.tensor(t), torch.from_numpy(spins), torch.from_numpy(betas))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
@pytest.mark.parametrize("j,b", [(1.0, 0.0), (0.7, 0.3)])
@pytest.mark.parametrize("n_sweeps", [1, 3])
def test_sweep_fused_matches_jax(rule, j, b, n_sweeps):
    _, spins, betas = _lattice(2, 5, 8)
    t0, seed = 17, 4
    want = jops.ising_sweep_fused(
        jnp.asarray(spins), jax.random.key(seed), jnp.int32(t0), jnp.asarray(betas),
        n_sweeps=n_sweeps, j=j, b=b, rule=rule, use_pallas=False,
    )
    got = tops.ising_sweep_fused(
        torch.from_numpy(spins), tkeys.key(seed), t0, torch.from_numpy(betas),
        n_sweeps=n_sweeps, j=j, b=b, rule=rule,
    )
    same = np.array_equal(got[0].numpy(), np.asarray(want[0])) and np.array_equal(
        got[2].numpy(), np.asarray(want[2]))
    if not same:
        w = tprng.key_words(tkeys.key(seed))
        u = torch.cat([tprng.ising_sweep_uniforms(w, t0 + i, torch.arange(5), 8)
                       for i in range(n_sweeps)], dim=1)
        assert _flip_possible(u.numpy(), betas, j, b, rule)
        return
    _assert_de(got[1].numpy(), want[1], want[2], j, b)


def _round_inputs(seed, r=6, length=8):
    rng, spins, betas = _lattice(seed, r, length)
    rung = rng.permutation(r).astype(np.int32)
    energy = np.asarray(
        [float(-2 * length * length + 8 * i) for i in range(r)], np.float32
    )[rung]
    return spins, betas, rung, energy


@pytest.mark.parametrize("pairing", ["deo", "seo"])
@pytest.mark.parametrize("criterion", ["logistic", "metropolis"])
@pytest.mark.parametrize("n_rounds", [1, 3])
def test_round_fused_matches_jax(pairing, criterion, n_rounds):
    spins, betas, rung, energy = _round_inputs(3)
    t0, ph0, seed, s = 6, 5, 8, 2
    kw = dict(n_sweeps=s, n_rounds=n_rounds, rule="glauber", criterion=criterion,
              pairing=pairing)
    want = jops.ising_round_fused(
        jnp.asarray(spins), jax.random.key(seed), jnp.int32(t0), jnp.int32(ph0),
        jnp.asarray(rung), jnp.asarray(energy), jnp.asarray(betas),
        use_pallas=False, **kw,
    )
    got = tops.ising_round_fused(
        torch.from_numpy(spins), tkeys.key(seed), t0, ph0, torch.from_numpy(rung),
        torch.from_numpy(energy), torch.from_numpy(betas), **kw,
    )
    want = [np.asarray(x) for x in want]
    got = [x.numpy() for x in got]
    words = tprng.key_words(tkeys.key(seed))
    for k in range(n_rounds):
        diff = got[4][k] != want[4][k]
        if diff.any():  # a swap decision flipped: only inside the ulp gap
            u = tprng.swap_uniforms(words, ph0 + k, len(betas)).numpy()
            assert _swap_flip_explained(u, got[5][k], want[5][k], diff)
            return
    for name, g, w in zip(("spins", "rung", "energy", "nacc"), got[:4], want[:4]):
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(got[6], want[6])
    np.testing.assert_allclose(got[5], want[5], rtol=4 * F32_EPS, atol=0)


@pytest.mark.parametrize("pairing", ["deo", "seo"])
@pytest.mark.parametrize("criterion", ["logistic", "metropolis"])
@pytest.mark.parametrize("phase", [0, 1, 6])
def test_exchange_step_matches_jax(pairing, criterion, phase):
    rng = np.random.default_rng(40 + phase)
    r = 9
    rung = rng.permutation(r).astype(np.int32)
    energy = (-200.0 + 4 * rng.integers(0, 40, r)).astype(np.float32)
    betas = (1.0 / np.linspace(1.0, 4.0, r)).astype(np.float32)
    jw = jprng.key_words(jax.random.key(2))
    want = jexchange.exchange_step(
        jnp.asarray(rung), jnp.asarray(energy), jnp.asarray(betas), phase, jw,
        pairing=pairing, criterion=criterion,
    )
    got = texchange.exchange_step(
        torch.from_numpy(rung), torch.from_numpy(energy), torch.from_numpy(betas),
        phase, torch.from_numpy(np.asarray(jw).astype(np.int64)),
        pairing=pairing, criterion=criterion,
    )
    want = [np.asarray(x) for x in want]
    got = [x.numpy() for x in got]
    np.testing.assert_array_equal(got[3], want[3])  # attempts: structural
    np.testing.assert_array_equal(got[4], want[4])  # e_rung
    diff = got[1] != want[1]
    if diff.any():
        u = tprng.swap_uniforms(torch.from_numpy(np.asarray(jw).astype(np.int64)), phase, r)
        assert _swap_flip_explained(u.numpy(), got[2], want[2], diff)
        return
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[2], want[2], rtol=4 * F32_EPS, atol=0)


def test_ulp_gap_flip_is_detected_and_explained():
    """The exception rule at work: at a beta where JAX's and torch's exp
    differ by an ulp, a uniform placed between the two p's flips exactly
    that site, and the helper explains the flip; the same lattice with the
    uniform moved off the gap agrees bit for bit."""
    found = None
    for beta in np.linspace(0.02, 0.2, 4000, dtype=np.float32):
        lo, hi = _accept_gaps(np.array([beta]), 1.0, 0.0, "metropolis")
        for s_i in range(2):
            for n_i in range(5):
                a, z = lo[0, s_i, n_i], hi[0, s_i, n_i]
                if 0.5 <= a < z < 1.0:  # p in [0.5, 1): a itself is a 24-bit uniform
                    found = (beta, s_i, n_i, a)
                    break
            if found:
                break
        if found:
            break
    assert found is not None, "no ulp gap between jnp.exp and torch.exp found"
    beta, s_i, n_i, u_gap = found
    length = 4
    spins = np.ones((1, length, length), np.int8)
    spins[0, 0, 0] = -1 if s_i == 0 else 1
    n_down = (4 - int(_NBR[n_i])) // 2  # neighbours set to -1
    for (i, jj) in [(1, 0), (3, 0), (0, 1), (0, 3)][:n_down]:
        spins[0, i, jj] = -1
    u = np.full((1, 2, length, length), 1.0 - 2.0 ** -24, np.float32)
    u[0, 0, 0, 0] = u_gap
    betas = np.array([beta], np.float32)

    def both(uu):
        want = jref.ising_sweep(jnp.asarray(spins), jnp.asarray(uu), jnp.asarray(betas),
                                j=1.0, b=0.0, rule="metropolis")
        got = tref.ising_sweep(torch.from_numpy(spins), torch.from_numpy(uu),
                               torch.from_numpy(betas), j=1.0, b=0.0, rule="metropolis")
        return np.asarray(want[0]), got[0].numpy()

    w, g = both(u)
    assert w[0, 0, 0] != g[0, 0, 0]
    assert _flip_possible(u, betas, 1.0, 0.0, "metropolis")
    u_off = u.copy()
    u_off[0, 0, 0, 0] = 0.25
    w, g = both(u_off)
    np.testing.assert_array_equal(w, g)
    assert not _flip_possible(u_off, betas, 1.0, 0.0, "metropolis")


def test_accept_tables_equal_per_site_probabilities():
    """The table kernel A selects from holds the plain sweep's per-site p."""
    betas = torch.tensor([0.3, 0.71, 1.0])
    p_tab, de_tab = tisk.accept_tables(betas, j=0.7, b=0.3, rule="glauber")
    s = torch.tensor([-1.0, 1.0])[:, None].expand(2, 5)
    nbr = torch.from_numpy(_NBR)[None].expand(2, 5)
    de = 2.0 * s * (0.7 * nbr - 0.3)
    assert torch.equal(de_tab, de)
    assert torch.equal(p_tab, tref.accept_prob(de[None], betas[:, None, None], "glauber"))


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback: the CUDA wrappers raise on CPU tensors (the ops dispatch
    sends CPU tensors to the plain versions instead)."""
    spins = torch.ones((2, 4, 4), dtype=torch.int8)
    words = torch.zeros(2, dtype=torch.int64)
    t0 = torch.zeros((), dtype=torch.int64)
    rung = torch.arange(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tisk.ising_sweep_fused_kernel(spins, words, t0, torch.ones(2), rung, n_sweeps=1)
    for pack_bits in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            tisk.ising_round_kernel(spins, words, t0, t0, torch.ones(2), rung, torch.zeros(2),
                                    n_sweeps=1, pairing="deo", criterion="logistic",
                                    pack_bits=pack_bits)
    with pytest.raises(ValueError, match="CUDA"):
        tpk.potts_round_kernel(spins, words, t0, t0, torch.ones(2), rung, torch.zeros(2),
                               n_sweeps=1, q=3, pairing="seo", criterion="metropolis")
    with pytest.raises(ValueError, match="CUDA"):
        tisk.ising_sweep_kernel(spins, torch.zeros((2, 2, 4, 4)), torch.ones(2))
    with pytest.raises(ValueError, match="CUDA"):
        tpk.potts_sweep_kernel(spins, torch.zeros((2, 2, 2, 4, 4)), torch.ones(2), q=3)
    with pytest.raises(ValueError, match="CUDA"):
        tpk.potts_sweep_fused_kernel(spins, words, t0, torch.ones(2), rung, n_sweeps=1, q=3)
    with pytest.raises(ValueError, match="CUDA"):
        tju.jax_uniform_kernel(words, t0, 2, (2, 4, 4))
    assert all(v == 0 for v in tbuild.launches.values())
    assert tbuild.epilogues == {"exchange": 0}


def _round_args(r=2, length=4):
    """Valid CPU arguments of a round wrapper: (states, words, t0, phase0,
    betas, rung, energy) and the ``out`` buffers."""
    states = torch.ones((r, length, length), dtype=torch.int8)
    args = (states, torch.zeros(2, dtype=torch.int64), torch.zeros((), dtype=torch.int64),
            torch.zeros((), dtype=torch.int64), torch.ones(r),
            torch.arange(r, dtype=torch.int32), torch.zeros(r))
    out = (torch.empty_like(states), torch.empty(r, dtype=torch.int32), torch.empty(r),
           torch.empty(r, dtype=torch.bool), torch.empty(r), torch.empty(r, dtype=torch.bool))
    return args, out


@pytest.mark.parametrize("source", ["ising_fused.cu", "ising_packed.cu", "potts_fused.cu"])
def test_round_libraries_export_their_exchange_scratch_size(source):
    """Each library that runs the round exchange exports the scratch bytes a
    replica of ``exchange.cuh`` (``exchange::kScratchBytes``), so the wrapper
    (`build.round_args`) sizes the buffer from the kernel's own layout."""
    text = (tbuild.CSRC / source).read_text()
    assert "exchange::make_round(" in text  # its launches run the exchange
    assert "long long exchange_scratch_bytes() { return exchange::kScratchBytes; }" in text
    assert "constexpr int kScratchBytes" in (tbuild.CSRC / "exchange.cuh").read_text()


@pytest.mark.parametrize("system", ["ising", "ising_packed", "potts"])
@pytest.mark.parametrize("bad,match", [
    ("energy_shape", "energy has shape"), ("energy_dtype", "energy has dtype"),
    ("phase0", "phase0 has shape"), ("rung_out", "rung out has dtype"),
    ("energy_out", "energy out has shape"), ("accept", "accept row has dtype"),
    ("prob", "prob row has shape"), ("attempt", "attempt row has dtype"),
    ("spins_out", "out has shape"), ("rows", "5 exchange rows"), ("rung", "rung has dtype"),
    ("pairing", "unsupported exchange"),
])
def test_round_wrappers_refuse_mismatched_rows_before_launch(system, bad, match):
    """The round wrappers name a mismatched argument or ``out`` buffer before
    any device check, build or launch: nothing is counted."""
    args, out = _round_args()
    args, out = list(args), list(out)
    kw = dict(n_sweeps=1, pairing="deo", criterion="logistic")
    r = 2
    if bad == "energy_shape":
        args[6] = torch.zeros(r + 1)
    elif bad == "energy_dtype":
        args[6] = torch.zeros(r, dtype=torch.float64)
    elif bad == "phase0":
        args[3] = torch.zeros(1, dtype=torch.int64)
    elif bad == "rung_out":
        out[1] = torch.empty(r, dtype=torch.int64)
    elif bad == "energy_out":
        out[2] = torch.empty(r + 1)
    elif bad == "accept":
        out[3] = torch.empty(r, dtype=torch.uint8)
    elif bad == "prob":
        out[4] = torch.empty(2 * r)
    elif bad == "attempt":
        out[5] = torch.empty(r)
    elif bad == "spins_out":
        out[0] = torch.empty((r, 6, 6), dtype=torch.int8)
    elif bad == "rows":
        out = out[:-1]
    elif bad == "rung":
        args[5] = torch.arange(r, dtype=torch.int64)
    elif bad == "pairing":
        kw["pairing"] = "windowed"
    tbuild.reset_launches()
    with pytest.raises((ValueError, TypeError), match=match):
        if system == "potts":
            tpk.potts_round_kernel(*args, q=3, out=tuple(out), **kw)
        else:
            tisk.ising_round_kernel(*args, pack_bits=system == "ising_packed", out=tuple(out),
                                    **kw)
    assert all(v == 0 for v in tbuild.launches.values())
    assert tbuild.epilogues == {"exchange": 0}


def test_ops_refuse_other_devices():
    """An op with no dry-run path refuses ``meta`` tensors by name (the
    sweeps the dry run reaches return shapes there: tests/test_torch_dryrun.py)."""
    states = torch.ones((2, 4, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="no sweep kernel"):
        tops.potts_sweep(states.to("meta"), torch.ones((2, 2, 4, 4)).to("meta"), torch.ones(2),
                         q=3)
