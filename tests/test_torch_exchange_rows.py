"""`repro_torch.kernels.exchange.exchange_rows`, the sharded round path's
exchange, against JAX's `repro.kernels.exchange.exchange_step`.

Same rows (numpy, from a seed) for one chain's (R,) rows and for C stacked
chains, chain by chain through JAX.  The contract beside JAX's four rows:
the rank's slice ``new_rung[..., start:stop]`` and the next phase.  Tolerances
are those of `test_torch_kernels.py`: rungs and attempts exact; prob within
4 ulps relative; an accept may differ only where its u lies between the two
p's (JAX's and torch's exp differ by an ulp), and then the rungs follow it.

The card's wrapper (`exchange_step_kernel`) is held against these on the card
(`tests/test_torch_cuda.py`); here its launch plan, the outputs' places in
its one allocation, is checked with the library's size rule stubbed.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import exchange as jexchange  # noqa: E402
from repro.kernels import prng as jprng  # noqa: E402
from repro_torch.kernels import build as tbuild  # noqa: E402
from repro_torch.kernels import exchange as texchange  # noqa: E402
from repro_torch.kernels import prng as tprng  # noqa: E402

F32_EPS = 2.0 ** -23


def _rows(seed: int, c: int, r: int):
    """(C, R) rung maps and per-slot energies, (R,) betas, (C,) phases and
    (C, 2) key words of C chains."""
    rng = np.random.default_rng(seed)
    rung = np.stack([rng.permutation(r) for _ in range(c)]).astype(np.int32)
    energy = (-300.0 + 6 * rng.integers(0, 60, (c, r))).astype(np.float32)
    betas = (1.0 / np.linspace(1.0, 4.0, r)).astype(np.float32)
    phase = rng.integers(0, 1 << 20, c).astype(np.int64)
    words = np.stack([np.asarray(jprng.key_words(jax.random.key(int(s)))).astype(np.int64)
                      for s in rng.integers(0, 1 << 30, c)])
    return rung, energy, betas, phase, words


def _jax_chain(rung, energy, betas, phase, words, pairing, criterion):
    out = jexchange.exchange_step(jnp.asarray(rung), jnp.asarray(energy), jnp.asarray(betas),
                                  int(phase), jnp.asarray(words.astype(np.uint32)),
                                  pairing=pairing, criterion=criterion)
    return [np.asarray(x) for x in out[:4]]


def _assert_chain(got, want, words, phase, r):
    """One chain's (new_rung, accept, prob, attempt) against JAX's."""
    new_rung, acc, prob, att = got
    np.testing.assert_array_equal(att, want[3])
    diff = acc != want[1]
    if diff.any():  # a decision flipped: only inside the ulp gap
        u = tprng.swap_uniforms(torch.from_numpy(words), int(phase), r).numpy()
        lo, hi = np.minimum(prob, want[2]), np.maximum(prob, want[2])
        assert np.all(((u >= lo) & (u < hi))[diff])
        return
    np.testing.assert_array_equal(new_rung, want[0])
    np.testing.assert_allclose(prob, want[2], rtol=4 * F32_EPS, atol=0)


@pytest.mark.parametrize("pairing", ["deo", "seo"])
@pytest.mark.parametrize("criterion", ["logistic", "metropolis"])
@pytest.mark.parametrize("c,r,block", [(None, 13, (4, 9)), (3, 13, (0, 7)), (3, 10, (5, 10))])
def test_exchange_rows_matches_jax_with_slice_and_next_phase(pairing, criterion, c, r, block):
    rung, energy, betas, phase, words = _rows(r + (c or 0), c or 1, r)
    args = [torch.from_numpy(x) for x in (rung, energy, betas, phase, words)]
    if c is None:  # one chain: (R,) rows, a () phase, (2,) key words
        args = [args[0][0], args[1][0], args[2], args[3][0], args[4][0]]
    out = texchange.exchange_rows(*args, pairing=pairing, criterion=criterion, block=block)
    assert len(out) == 6
    new_rung, acc, prob, att, rung_block, next_phase = out
    assert new_rung.shape == acc.shape == prob.shape == att.shape == args[0].shape
    assert (new_rung.dtype, acc.dtype, prob.dtype, att.dtype) == (
        torch.int32, torch.bool, torch.float32, torch.bool)
    start, stop = block
    assert rung_block.dtype == torch.int32 and rung_block.is_contiguous()
    assert torch.equal(rung_block, new_rung[..., start:stop])
    assert next_phase.shape == args[3].shape and next_phase.dtype == torch.int64
    assert torch.equal(next_phase, args[3] + 1)
    rows = [x.reshape(c or 1, -1).numpy() for x in (new_rung, acc, prob, att)]
    for i in range(c or 1):
        want = _jax_chain(rung[i], energy[i], betas, phase[i], words[i], pairing, criterion)
        _assert_chain([x[i] for x in rows], want, words[i], phase[i], r)


def test_exchange_rows_default_slice_is_the_whole_row_and_stack_is_per_chain():
    rung, energy, betas, phase, words = _rows(5, 3, 11)
    args = [torch.from_numpy(x) for x in (rung, energy, betas, phase, words)]
    stacked = texchange.exchange_rows(*args, pairing="seo", criterion="logistic")
    assert torch.equal(stacked[4], stacked[0])
    for i in range(3):
        one = texchange.exchange_rows(args[0][i], args[1][i], args[2], args[3][i], args[4][i],
                                      pairing="seo", criterion="logistic", block=(2, 11))
        for g, o in zip(stacked[:4], one[:4]):
            assert torch.equal(g[i], o)
        assert torch.equal(one[4], stacked[0][i, 2:]) and int(one[5]) == int(phase[i]) + 1


class _SizeRule:
    """The kernel library's size rule (12 B of shared memory a rung) and
    scratch (8 B a rung) without the library."""

    def exchange_step_smem_bytes(self, n):
        return 12 * ((n + 3) // 4 * 4)


@pytest.mark.parametrize("lead,r,block", [((), 1500, (0, 750)), ((8,), 1500, (750, 1500)),
                                          ((3,), 7, (2, 5)), ((), 19368, (0, 19368)),
                                          ((2,), 19369, (1, 19369))])
def test_prepared_launch_places_outputs_apart_in_one_allocation(monkeypatch, lead, r, block):
    """The plan `exchange_step_kernel` makes once a shape: six contiguous,
    16-byte aligned, disjoint outputs in one buffer, the global variant's
    scratch after them only past a block's shared memory (R > 19,368)."""
    monkeypatch.setattr(texchange, "_lib", _SizeRule)
    monkeypatch.setattr(tbuild, "scratch_bytes", lambda lib: 8)
    texchange._prepare.cache_clear()
    try:
        plan = texchange._prepare(lead, r, block, "deo", "metropolis")
    finally:
        texchange._prepare.cache_clear()
    c = lead[0] if lead else 1
    assert plan.ints == (r, c, 0, 1) and plan.block == block
    assert (plan.scratch is None) == (r <= 19368)
    buf = torch.zeros(plan.nbytes, dtype=torch.uint8)
    spans = []
    for i, (dtype, shape, stride, at) in enumerate(plan.outputs):
        x = buf.view(dtype).as_strided(shape, stride, at)
        assert x.is_contiguous() and plan.offsets[i] % 16 == 0
        assert x.data_ptr() == buf.data_ptr() + plan.offsets[i]
        spans.append((plan.offsets[i], plan.offsets[i] + x.numel() * x.element_size()))
    if plan.scratch is not None:
        spans.append((plan.scratch, plan.scratch + 8 * c * r))
    assert [tuple(s) for _, s, _, _ in plan.outputs] == [
        lead + (r,)] * 4 + [lead + (block[1] - block[0],), lead]
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])) and spans[-1][1] <= plan.nbytes
