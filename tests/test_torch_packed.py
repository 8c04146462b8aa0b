"""Ising ``pack_bits`` multispin coding (TPU kernel #2p) against the JAX package.

Same inputs (numpy, from a seed) through the JAX package's packed Pallas
kernels, run in interpret mode on the CPU as its own tests run them
(``ops.ising_sweep_fused`` / ``ops.ising_round_fused`` with
``pack_bits=True, use_pallas=True``), and through the port's packed plain
version (`ops` dispatch on CPU tensors).  The JAX cases are those of
``tests/test_fused_round.py::test_ising_packed_interval_bit_equal`` (R in
{3, 6, 8, 33} with its r_blk, b=0.3), under both acceptance rules.

Tolerances (those of the unpacked tests, test_torch_kernels.py): spins,
acceptance counts, rung maps and accept/attempt rows exact; the one allowed
difference is an acceptance ``u < p`` whose ``u`` lies between JAX's and
torch's exp/sigmoid of one table entry (they differ by an ulp), which
`_flip_possible` decides from the tables and uniforms.  ΔE and energies are
exact at j=1, b=0, else within 4 ulps of the largest partial-sum magnitude
(nacc x max|ΔE|), because the two frameworks sum in different orders.  The
port's packed plain version against its unpacked one: bit for bit, any j, b.
"""
import json
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.api import RunSpec, Session  # noqa: E402
from repro_torch.core import keys as tkeys  # noqa: E402
from repro_torch.kernels import build as tbuild  # noqa: E402
from repro_torch.kernels import ising_sweep as tisk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import prng as tprng  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

F32_EPS = 2.0 ** -23
L = 8  # tests/test_fused_round.py's lattice
SPECS = Path(__file__).resolve().parents[1] / "examples" / "specs"


def _inputs(seed, r, length=L):
    rng = np.random.default_rng(seed)
    spins = rng.choice(np.array([-1, 1], np.int8), size=(r, length, length))
    betas = np.sort(rng.uniform(0.25, 1.0, r).astype(np.float32))[::-1].copy()
    return rng, spins, betas


def _gaps(betas, j, b, rule):
    """(R, 10) [lo, hi) between JAX's and torch's p of each (spin, neighbour
    sum) entry at each beta."""
    s = np.array([-1.0, 1.0], np.float32)[:, None]
    nbr = np.array([-4.0, -2.0, 0.0, 2.0, 4.0], np.float32)[None]
    de_j = 2.0 * jnp.asarray(s) * (j * jnp.asarray(nbr) - b)
    p_j = np.asarray(jref.accept_prob(de_j[None], jnp.asarray(betas)[:, None, None], rule))
    de_t = 2.0 * torch.from_numpy(s) * (j * torch.from_numpy(nbr) - b)
    p_t = tref.accept_prob(de_t[None], torch.from_numpy(betas)[:, None, None], rule).numpy()
    n = len(betas)
    return np.minimum(p_j, p_t).reshape(n, -1), np.maximum(p_j, p_t).reshape(n, -1)


def _in_gap(u, lo, hi):
    return any(np.any((u >= a) & (u < z)) for a, z in zip(lo, hi) if a < z)


def _flip_possible(u, betas, j, b, rule):
    """Some uniform of ``u`` (R, ..., L, L) lies in the gap of an entry at its
    replica's beta: the only way a sweep may differ."""
    lo, hi = _gaps(betas, j, b, rule)
    u = np.asarray(u).reshape(u.shape[0], -1)
    return any(_in_gap(u[r], lo[r], hi[r]) for r in range(u.shape[0]))


def _assert_de(got, want, nacc, j, b):
    got, want = np.asarray(got), np.asarray(want)
    if j == 1.0 and b == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        scale = np.asarray(nacc, np.float64) * 2 * (4 * abs(j) + abs(b))
        assert np.all(np.abs(got.astype(np.float64) - want) <= 4 * F32_EPS * scale)


@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
@pytest.mark.parametrize("r,r_blk", [(3, 8), (6, 4), (8, 8), (33, 64)])
def test_packed_fused_op_matches_jax_pallas(r, r_blk, rule):
    _, spins, betas = _inputs(60 + r, r)
    t0, seed, s, j, b = 7, 60 + r, 3, 1.0, 0.3
    want = jops.ising_sweep_fused(
        jnp.asarray(spins), jax.random.key(seed), jnp.int32(t0), jnp.asarray(betas),
        n_sweeps=s, j=j, b=b, rule=rule, r_blk=r_blk, pack_bits=True, use_pallas=True,
    )
    got = tops.ising_sweep_fused(
        torch.from_numpy(spins), tkeys.key(seed), t0, torch.from_numpy(betas),
        n_sweeps=s, j=j, b=b, rule=rule, r_blk=r_blk, pack_bits=True,
    )
    assert all(v == 0 for v in tbuild.launches.values())  # the CPU runs no kernel
    if not (np.array_equal(got[0].numpy(), np.asarray(want[0]))
            and np.array_equal(got[2].numpy(), np.asarray(want[2]))):
        words = tprng.key_words(tkeys.key(seed))
        u = torch.cat([tprng.ising_sweep_uniforms(words, t0 + i, torch.arange(r), L)
                       for i in range(s)], dim=1)
        assert _flip_possible(u.numpy(), betas, j, b, rule), "differs outside the ulp gap"
        return
    _assert_de(got[1].numpy(), want[1], want[2], j, b)


@pytest.mark.parametrize("pairing,j,b", [("deo", 1.0, 0.0), ("seo", 1.0, 0.3)])
def test_packed_round_op_matches_jax_pallas(pairing, j, b):
    r, n_rounds = 6, 2
    rng, spins, betas = _inputs(70, r)
    rung = rng.permutation(r).astype(np.int32)
    energy = (rng.normal(size=r) * 10.0).astype(np.float32)
    t0, ph0, seed = 4, 3, 71
    kw = dict(n_sweeps=2, n_rounds=n_rounds, j=j, b=b, rule="glauber",
              criterion="logistic", pairing=pairing, pack_bits=True)
    want = jops.ising_round_fused(
        jnp.asarray(spins), jax.random.key(seed), jnp.int32(t0), jnp.int32(ph0),
        jnp.asarray(rung), jnp.asarray(energy), jnp.asarray(betas), use_pallas=True, **kw,
    )
    got = tops.ising_round_fused(
        torch.from_numpy(spins), tkeys.key(seed), t0, ph0, torch.from_numpy(rung),
        torch.from_numpy(energy), torch.from_numpy(betas), **kw,
    )
    want = [np.asarray(x) for x in want]
    got = [x.numpy() for x in got]
    words = tprng.key_words(tkeys.key(seed))
    if not (np.array_equal(got[0], want[0]) and np.array_equal(got[4], want[4])):
        # a sweep (at any rung's beta) or a swap decision flipped in an ulp gap
        u = torch.cat([tprng.ising_sweep_uniforms(words, t0 + i, torch.arange(r), L)
                       for i in range(2 * n_rounds)], dim=1).numpy().ravel()
        lo, hi = _gaps(betas, j, b, "glauber")
        sweep_gap = _in_gap(u, lo.ravel(), hi.ravel())
        swap_gap = any(_in_gap(tprng.swap_uniforms(words, ph0 + k, r).numpy(),
                               np.minimum(got[5][k], want[5][k]),
                               np.maximum(got[5][k], want[5][k])) for k in range(n_rounds))
        assert sweep_gap or swap_gap, "round differs outside the ulp gaps"
        return
    for name, g, w in zip(("spins", "rung", "nacc", "attempt"),
                          (got[0], got[1], got[3], got[6]), (want[0], want[1], want[3], want[6])):
        np.testing.assert_array_equal(g, w, err_msg=name)
    _assert_de(got[2] - energy, want[2] - energy, np.maximum(got[3], 1), j, b)
    # swap probabilities: 4 ulps (JAX's and torch's sigmoid); at b != 0 the
    # energies may differ by the ΔE bound above, which moves
    # sigmoid(dbeta * dE) by at most dbeta_max / 4 per unit of energy, twice
    e_tol = 0.0 if b == 0.0 else float(
        4 * F32_EPS * np.max(got[3]) * 2 * (4 * abs(j) + abs(b)))
    dbeta = float(np.max(np.abs(np.diff(betas))))
    np.testing.assert_allclose(got[5], want[5], rtol=4 * F32_EPS, atol=dbeta / 4 * 2 * e_tol)


@pytest.mark.parametrize("r,length,j,b,rule", [
    (3, 8, 1.0, 0.3, "metropolis"), (33, 6, 0.7, 0.3, "glauber"),
    (8, 10, 1.0, 0.0, "glauber"), (70, 4, 1.0, 0.0, "metropolis"),
])
def test_packed_plain_equals_unpacked_plain(r, length, j, b, rule):
    """Bit for bit, with a partial last word (r=3, 33, 70) and j, b != 1, 0."""
    rng, spins, betas = _inputs(r, r, length)
    args = (torch.from_numpy(spins), tprng.key_words(tkeys.key(5)), torch.tensor(7),
            torch.from_numpy(betas), torch.from_numpy(rng.permutation(r).astype(np.int32)))
    kw = dict(n_sweeps=3, j=j, b=b, rule=rule, replica_offset=2, t_add=1)
    want = tisk.ising_sweep_fused_plain(*args, **kw)
    got = tisk.ising_sweep_packed_plain(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("r", [1, 31, 32, 33, 64, 70])
def test_pack_spins_round_trips(r):
    spins = torch.from_numpy(np.random.default_rng(r).choice(
        np.array([-1, 1], np.int8), size=(r, 4, 6)))
    words = tisk.pack_spins(spins)
    assert words.shape == ((r + 31) // 32, 4, 6) and int(words.max()) < 2 ** 32
    assert torch.equal(tisk.unpack_spins(words, r), spins)


@pytest.mark.parametrize("r,n_sms,group", [
    (1500, 132, 6),  # 250 blocks: at most 2 groups (12 replicas) on an SM, not 16
    (2112, 132, 8),  # 264 full bytes: 2 on every SM
    (1056, 132, 8), (5, 132, 1), (200, 132, 2), (300, 132, 3), (16, 4, 4),
])
def test_packed_group_balances_the_busiest_sm(r, n_sms, group):
    assert tisk.packed_group(r, n_sms) == group


def test_packed_kernel_wrapper_refuses_cpu_tensors():
    spins = torch.ones((2, 4, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="kernel #2p needs CUDA"):
        tisk.ising_sweep_packed_kernel(spins, torch.zeros(2, dtype=torch.int64),
                                       torch.zeros((), dtype=torch.int64), torch.ones(2),
                                       torch.arange(2, dtype=torch.int32), n_sweeps=1)
    assert all(v == 0 for v in tbuild.launches.values())


def test_per_sweep_path_ignores_pack_bits():
    """``pack_bits`` acts on the fused paths only (as in the JAX package):
    the per-sweep run with it equals the run without, manifest for manifest."""
    d = json.loads((SPECS / "ising_small.json").read_text())
    plain = Session(RunSpec.from_json(d), device="cpu").run().manifest()
    d["system"]["params"]["pack_bits"] = True
    packed = Session(RunSpec.from_json(d), device="cpu").run().manifest()
    assert packed["spec"]["system"]["params"]["pack_bits"] is True
    packed["spec"] = plain["spec"]
    assert packed == plain
