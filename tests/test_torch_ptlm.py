"""Parallel tempering over LM sequences (`repro_torch.core.ptlm`) against
the JAX package's `repro.core.ptlm`, on the CPU.

Reduced gemma-2b (dense) and reduced rwkv6-7b in f32, each with the JAX
package's own weights (``init_params(cfg, jax.random.key(0))``) carried
over by `carry.lm_params_from_reference`: ``batched_energy``, one
``batched_mcmc_step`` from the JAX engine's per-sweep keys, the PT run of
``tests/test_ptlm.py`` (R = 4, 12 tokens, a geometric ladder 1-8, a swap
every 5 steps, 60 steps) through `core.pt.run`, and the `Engine` with
``record_trace`` as ``examples/pt_lm_sampling.py`` drives it.

Tolerances:

* tokens, proposal positions, acceptances, rungs and swap decisions
  (``swap_accept``, ``swap_attempt``): equal.  The draws are the JAX
  package's word for word; an f32 difference in the last bits could flip
  a decision only where a uniform lies within it, and none does here.
* energies (~60-80 nats): within 8 ulps of their magnitude (the packages
  sum the 11 log-probabilities and the vocabulary's softmax in other
  orders; they read at most 2-3 ulps), ``delta_e`` likewise within 8 ulps
  of the energies, and the tracked energies against a fresh
  ``batched_energy`` within 8 ulps too.
* swap probabilities: within 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import ladder  # noqa: E402
from repro.core import pt as jpt  # noqa: E402
from repro.core.ptlm import LMSystem as JLMSystem  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import keys  # noqa: E402
from repro_torch.core import pt as tpt  # noqa: E402
from repro_torch.core.ptlm import LMSystem  # noqa: E402
from repro_torch.core.systems import batched_init  # noqa: E402
from repro_torch.engine import Engine, EngineConfig  # noqa: E402

ARCHS = ["gemma_2b", "rwkv6_7b"]
R, SEQ = 4, 12
ULPS = 8


@pytest.fixture(scope="module")
def systems():
    """arch -> (JAX bound system, port bound system), f32, the same weights."""
    cache = {}

    def get(arch, seq_len=SEQ, prompt_len=1):
        if (arch, seq_len, prompt_len) not in cache:
            jcfg = dataclasses.replace(jax_get_config(arch, reduced=True), dtype="float32")
            cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
            if arch not in cache:
                params = jm.init_params(jcfg, jax.random.key(0))
                model = carry.lm_params_from_reference(
                    jax.tree_util.tree_map(np.asarray, params), cfg, "cpu")
                cache[arch] = params, model
            params, model = cache[arch]
            cache[(arch, seq_len, prompt_len)] = (
                JLMSystem(cfg=jcfg, seq_len=seq_len, prompt_len=prompt_len).bind(params),
                LMSystem(cfg=cfg, seq_len=seq_len, prompt_len=prompt_len).bind(model))
        return cache[(arch, seq_len, prompt_len)]

    return get


def _ulps(got, want, scale=None):
    """The largest |got - want| in ulps of ``scale`` (default: of ``want``)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ref = np.abs(want if scale is None else scale).astype(np.float32)
    return float(np.max(np.abs(got - want) / np.spacing(np.maximum(ref, 1.0))))


def _tokens(seed, vocab, r=R, s=SEQ):
    return np.random.default_rng(seed).integers(0, vocab, (r, s)).astype(np.int32)


@pytest.mark.parametrize("prompt_len", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_batched_energy_matches_jax(systems, arch, prompt_len):
    jsys, tsys = systems(arch, prompt_len=prompt_len)
    tokens = _tokens(1, tsys.cfg.vocab)
    want = np.asarray(jsys.batched_energy(jnp.asarray(tokens)))
    got = tsys.batched_energy(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and tuple(got.shape) == (R,)
    assert np.all(want > 0)
    assert _ulps(got.numpy(), want) <= ULPS


@pytest.mark.parametrize("t", [0, 17])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_mcmc_step_matches_jax(systems, arch, t):
    """The port's step from the run key and ``t`` against JAX's from the
    engine's per-sweep keys ``fold_in(fold_in(key, 2t), r)``: the tokens,
    delta_e and acceptances it returns; at most one token moves a replica,
    and delta_e is the recomputed energies' difference."""
    jsys, tsys = systems(arch)
    tokens = _tokens(2 + t, tsys.cfg.vocab)
    betas = np.array([1.0, 0.6, 0.3, 0.125], np.float32)
    run_key = jax.random.key(5)
    jkeys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.fold_in(run_key, 2 * t), jnp.arange(R, dtype=jnp.uint32))
    want = jsys.batched_mcmc_step(jkeys, jnp.asarray(tokens), jnp.asarray(betas))
    got = tsys.batched_mcmc_step(keys.key(5), torch.tensor(t), torch.from_numpy(tokens),
                                 torch.from_numpy(betas))
    new, de, acc = got
    assert new.dtype == torch.int32 and de.dtype == torch.float32 and acc.dtype == torch.int32
    assert np.array_equal(new.numpy(), np.asarray(want[0]))
    assert np.array_equal(acc.numpy(), np.asarray(want[2]))
    e0 = tsys.batched_energy(torch.from_numpy(tokens)).numpy()
    assert _ulps(de.numpy(), np.asarray(want[1]), scale=e0) <= ULPS
    assert np.all((new.numpy() != tokens).sum(axis=1) <= 1)
    e1 = tsys.batched_energy(new).numpy()
    assert _ulps(de.numpy(), e1 - e0, scale=e0) <= ULPS
    assert np.all((de.numpy() == 0) | (acc.numpy() == 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_pt_run_matches_jax(systems, arch):
    """`core.pt.init` / `run` over 60 steps (``tests/test_ptlm.py``'s run):
    the initial tokens, the final tokens and rungs and every interval's
    swap decisions equal; energies within 8 ulps; the cold chain improves
    and the tracked energies equal a fresh ``batched_energy``."""
    jsys, tsys = systems(arch)
    temps = tuple(float(t) for t in ladder.geometric_ladder(R, 1.0, 8.0))
    jc = jpt.PTConfig(n_replicas=R, temps=temps, swap_interval=5, swap_mode="temp")
    tc = tpt.PTConfig(n_replicas=R, temps=temps, swap_interval=5, swap_mode="temp")
    js = jpt.init(jsys, jc, jax.random.key(4))
    ts = tpt.init(tsys, tc, keys.key(4, device="cpu"))
    assert np.array_equal(ts.states.numpy(), np.asarray(js.states))
    assert _ulps(ts.energy.numpy(), np.asarray(js.energy)) <= ULPS
    js2, jtrace = jpt.run(jsys, jc, js, 60)
    ts2, ttrace = tpt.run(tsys, tc, ts, 60)
    assert np.array_equal(ts2.states.numpy(), np.asarray(js2.states))
    assert np.array_equal(ts2.rung.numpy(), np.asarray(js2.rung))
    assert int(ts2.t) == int(js2.t) == 60 and int(ts2.phase) == int(js2.phase) == 12
    assert set(ttrace) == set(jtrace)
    for name in ("swap_accept", "swap_attempt"):
        assert np.array_equal(ttrace[name].numpy(), np.asarray(jtrace[name])), name
    assert bool(np.asarray(jtrace["swap_accept"]).any())
    np.testing.assert_allclose(ttrace["swap_prob"].numpy(), np.asarray(jtrace["swap_prob"]),
                               rtol=0, atol=1e-5)
    assert _ulps(ttrace["energy"].numpy(), np.asarray(jtrace["energy"])) <= ULPS
    e0 = float(ts.energy[torch.argsort(ts.rung)][0])
    assert float(ttrace["energy"][-1, 0]) < e0
    assert _ulps(ts2.energy.numpy(), tsys.batched_energy(ts2.states).numpy()) <= ULPS


def test_engine_with_record_trace_matches_jax(systems):
    """``examples/pt_lm_sampling.py``'s drive (the Engine, a geometric ladder
    1-10, a swap every 5 steps, record_trace) on reduced gemma, cut to 40
    steps in chunks of 3 intervals: the same trace and final tokens."""
    jsys, tsys = systems("gemma_2b")
    temps = np.asarray(ladder.geometric_ladder(R, 1.0, 10.0), np.float64)
    kw = dict(n_replicas=R, swap_interval=5, swap_mode="temp", chunk_intervals=3,
              record_trace=True)
    jeng = JEngine(jsys, JEngineConfig(**kw))
    jstate, jres = jeng.run(jeng.init(jax.random.key(1), temps), 40)
    teng = Engine(tsys, EngineConfig(**kw), device="cpu")
    tstate, tres = teng.run(teng.init(keys.key(1, device="cpu"), temps), 40)
    assert np.array_equal(tstate.pt.states.numpy(), np.asarray(jstate.pt.states))
    assert np.array_equal(tstate.pt.rung.numpy(), np.asarray(jstate.pt.rung))
    assert set(tres.trace) == set(jres.trace) and tres.trace["energy"].shape == (8, R)
    for name in ("swap_accept", "swap_attempt"):
        assert np.array_equal(tres.trace[name], jres.trace[name]), name
    np.testing.assert_allclose(tres.trace["swap_prob"], jres.trace["swap_prob"], rtol=0,
                               atol=1e-5)
    assert _ulps(tres.trace["energy"], jres.trace["energy"]) <= ULPS
    for name in ("swap_attempts", "swap_accepts", "round_trips"):
        assert np.array_equal(getattr(tstate.stats, name).numpy(),
                              np.asarray(getattr(jstate.stats, name))), name


def test_init_draws_from_the_unsplit_key_and_the_mesh_is_refused(systems):
    """The LM system's initial tokens are ``randint(key, (R, S))`` (JAX's
    batched init); the zoo's systems keep one key a replica.  The mesh is
    no longer refused: a replica shard's step (``replica_offset`` o) draws
    from its first slot's key ``fold_in(fold_in(key, 2t), o)``, the
    ``keys[0]`` of JAX's sharded interval (tests/test_torch_sharded_lm.py
    runs the engine on the mesh against JAX's)."""
    jsys, tsys = systems("rwkv6_7b")
    k = keys.key(9)
    want = jax.random.randint(jax.random.key(9), (R, SEQ), 0, tsys.cfg.vocab, jnp.int32)
    assert np.array_equal(batched_init(tsys, k, R).numpy(), np.asarray(want))
    tokens = _tokens(3, tsys.cfg.vocab)[:2]
    betas = np.array([1.0, 0.5], np.float32)
    jkeys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.fold_in(jax.random.key(9), 2 * 4), jnp.arange(2, 4, dtype=jnp.uint32))
    want = jsys.batched_mcmc_step(jkeys, jnp.asarray(tokens), jnp.asarray(betas))
    got = tsys.batched_mcmc_step(k, 4, torch.from_numpy(tokens), torch.from_numpy(betas),
                                 replica_offset=2)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    with pytest.raises(ValueError, match="prompt_len"):
        LMSystem(cfg=tsys.cfg, seq_len=4, prompt_len=4).bind(tsys.model)
