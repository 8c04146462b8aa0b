"""The port's counter PRNG and jax.random subset, word for word against JAX.

Random123 known-answer vectors for the cipher itself, then every stream of
`repro.kernels.prng` and the partitionable ``jax.random`` functions the
ported path uses (`repro_torch.core.keys`: key, split, fold_in, bits,
uniform, randint) over several keys, sweep counters, replicas and swap
phases, and the per-sweep stream ``uniform(fold_in(fold_in(key, 2t), r))``
of the default engine path.  All comparisons are exact.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import prng as jprng  # noqa: E402
from repro_torch.core import keys as tkeys  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import prng as tprng  # noqa: E402

SEEDS = [0, 7, 123456789, 2**40 + 3]


def _words(seed):
    w = np.asarray(jprng.key_words(jax.random.key(seed)))
    return jnp.asarray(w), torch.from_numpy(w.astype(np.int64))


@pytest.mark.parametrize("key,ctr,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry_known_answer_vectors(key, ctr, want):
    got = tprng.threefry2x32(key[0], key[1], ctr[0], ctr[1])
    assert (int(got[0]), int(got[1])) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_key_words_match(seed):
    jw, _ = _words(seed)
    tw = tprng.key_words(tkeys.key(seed))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("t", [0, 17, 2**31 + 5])
def test_sweep_uniforms_match(seed, t):
    jw, tw = _words(seed)
    rep = np.array([0, 1, 5, 1000], np.uint32)
    want = np.asarray(jprng.ising_sweep_uniforms(jw, t, jnp.asarray(rep), 6))
    got = tprng.ising_sweep_uniforms(tw, t, torch.from_numpy(rep.astype(np.int64)), 6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_swap_streams_match(seed):
    jw, tw = _words(seed)
    for phase in (0, 1, 2, 9, 2**31 + 1):
        np.testing.assert_array_equal(
            tprng.swap_uniforms(tw, phase, 13).numpy(),
            np.asarray(jprng.swap_uniforms(jw, phase, 13)),
        )
        assert int(tprng.seo_coin(tw, phase)) == int(jprng.seo_coin(jw, phase))


def test_plane_uniforms_tensor_counters_match():
    """Device-scalar counters (the engine's t) give the Python-int stream."""
    jw, tw = _words(3)
    s0, s1 = tprng.stream_key(tw)
    w0, w1 = tprng.sweep_key(s0, s1, torch.tensor(41), torch.arange(3))
    js0, js1 = jprng.stream_key(jw)
    jw0, jw1 = jprng.sweep_key(js0, js1, jnp.uint32(41), jnp.arange(3, dtype=jnp.uint32))
    np.testing.assert_array_equal(
        tprng.plane_uniforms(w0, w1, 1, 4, 6).numpy(),
        np.asarray(jprng.plane_uniforms(jw0, jw1, 1, 4, 6)),
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match_jax_random(seed):
    k = jax.random.key(seed)
    tk = tkeys.key(seed)
    data = lambda x: np.asarray(jax.random.key_data(x))
    np.testing.assert_array_equal(tk.numpy(), data(k))
    np.testing.assert_array_equal(tkeys.split(tk).numpy(), data(jax.random.split(k)))
    np.testing.assert_array_equal(tkeys.split(tk, 7).numpy(), data(jax.random.split(k, 7)))
    for d in (0, 1, 75, 2**32 - 1):
        np.testing.assert_array_equal(
            tkeys.fold_in(tk, d).numpy(), data(jax.random.fold_in(k, d))
        )
    np.testing.assert_array_equal(
        tkeys.random_bits(tk, (3, 5)).numpy(), np.asarray(jax.random.bits(k, (3, 5)))
    )
    np.testing.assert_array_equal(
        tkeys.uniform(tk, (9, 4)).numpy(), np.asarray(jax.random.uniform(k, (9, 4)))
    )


def test_batched_uniform_matches_vmap():
    """A (B, 2) key batch is the vmap of the single-key uniform."""
    k = jax.random.split(jax.random.key(5), 4)
    want = np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, (6, 6)))(k))
    got = tkeys.uniform(torch.from_numpy(np.asarray(jax.random.key_data(k)).astype(np.int64)), (6, 6))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_potts_sweep_uniforms_match(seed):
    jw, tw = _words(seed)
    rep = np.array([0, 3, 1000], np.uint32)
    for t in (0, 29, 2**31 + 7):
        want = np.asarray(jprng.potts_sweep_uniforms(jw, t, jnp.asarray(rep), 4, 6))
        got = tprng.potts_sweep_uniforms(tw, t, torch.from_numpy(rep.astype(np.int64)), 4, 6)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_matches_jax(seed):
    """Single and batched keys; spans that are and are not powers of two."""
    k = jax.random.key(seed)
    ks = jax.random.split(k, 3)
    tk = tkeys.key(seed)
    for lo, hi in ((0, 2), (0, 3), (0, 5), (-4, 60), (0, 1000)):
        np.testing.assert_array_equal(
            tkeys.randint(tk, (5, 7), lo, hi).numpy(),
            np.asarray(jax.random.randint(k, (5, 7), lo, hi)))
        want = jax.vmap(lambda kk, lo=lo, hi=hi: jax.random.randint(kk, (4, 6), lo, hi))(ks)
        np.testing.assert_array_equal(
            tkeys.randint(tkeys.split(tk, 3), (4, 6), lo, hi).numpy(), np.asarray(want))


@functools.partial(jax.jit, static_argnames="shape")
def _per_sweep_draw(k, two_t, shape):
    """The JAX engine's per-sweep draw of replicas 0..4 (one compile per shape)."""
    kt = jax.random.fold_in(k, two_t)
    return jax.vmap(lambda r: jax.random.uniform(jax.random.fold_in(kt, r), shape))(
        jnp.arange(5, dtype=jnp.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_per_sweep_stream_matches_jax(seed):
    """`ops.jax_uniform` on the CPU is the JAX engine's per-sweep draw:
    ``uniform(fold_in(fold_in(key, 2t), r), shape)`` for replica r."""
    k = jax.random.key(seed)
    for t, shape in ((0, (2, 4, 4)), (37, (2, 2, 4, 6)), (2**30 + 1, (2, 6, 6))):
        want = _per_sweep_draw(k, jnp.uint32(2 * t), shape)
        got = tops.jax_uniform(tkeys.key(seed), torch.tensor(t), 5, shape)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
