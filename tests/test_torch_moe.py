"""The port's moe family (sort-based MoE) against the JAX package's, on the
CPU.

`repro_torch.models.moe` on the reduced ``mixtral_8x22b`` (8 -> 4
experts, top-2, a sliding window of 16) and ``qwen3_moe_235b`` (8
experts, top-2, qk-norm) with the JAX package's weights carried over by
`carry.lm_params_from_reference`: the routing (``expert_idx``,
``token_for_slot``, ``valid``, read from inside JAX's ``moe_ffn``), the
output, a capacity overflow, tied router probabilities, the combine's
order, ``router_load``; then each model's prefill logits, 12 decode
steps, decode against the port's forward, the parameter counts and the
sampling loop.  JAX's side is computed once a module.  `forward_loss` and
its gradients: tests/test_torch_moe_train.py.

Tolerances:

* the routing and the dropped assignments: equal.
* the combine, fed the same expert outputs: bit for bit (each token's
  kept contributions added to 0.0 in its experts' order, as JAX's
  scatter-add runs on the CPU).
* one MoE FFN: f32 within 1e-5 of the output's scale (the expert GEMMs sum
  in other orders); bf16 within 2 bf16 ulps of it.
* logits: f32 rtol = atol = 1e-4; bf16 the JAX package's decode tolerance
  rtol = atol = 3e-2 (they agree within ~1e-6 here).
* decode against the forward: the same, with a capacity that drops
  nothing (``capacity_factor = E / k``): the forward routes B·S tokens at
  once and a step B, so their capacities, and what they drop, differ.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
import _torch_lm_parity as lm  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.configs import PORTED, get_config  # noqa: E402
from repro_torch.launch import serve_lm  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ARCHS = ["mixtral_8x22b", "qwen3_moe_235b"]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
B, S = 2, 16
_np = lm.np32


@pytest.fixture(scope="module")
def jax_params():
    """Each reduced arch's JAX weights (f32 masters) and their numpy dump."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = lm.jax_init(arch)
        return cache[arch]

    return get


def _moe_layer(jax_params, arch, dtype, **kw):
    """Group layer 0's MoE weights: (JAX config, port config, JAX dict, port
    module)."""
    jcfg, cfg = lm.cfgs(arch, dtype, **kw)
    p = jax.tree_util.tree_map(lambda a: a[0], jax_params(arch)[0]["groups"]["0_attn_moe"]["moe"])
    mod = tmoe.MoE(cfg, None, "cpu")
    mod.load_state_dict({n: torch.from_numpy(np.array(a)) for n, a in p.items()}, strict=True)
    return jcfg, cfg, p, mod


def _x(seed, dtype, s=S):
    x = np.random.default_rng(seed).normal(size=(B, s, 64)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    return jx, torch.from_numpy(_np(jx)).to(getattr(torch, dtype))


def jax_moe_ffn(p, jcfg, x):
    """JAX's ``moe_ffn`` and its routing, read from inside the call:
    ``expert_idx`` (``lax.top_k``'s indices), ``token_for_slot`` (what
    ``jnp.take`` gathers by) and ``valid`` (the (E, C, 1) mask of
    ``jnp.where``)."""
    rec = {}

    class Lax:
        def __getattr__(self, name):
            return getattr(jax.lax, name)

        def top_k(self, v, k):
            out = jax.lax.top_k(v, k)
            rec["expert_idx"] = np.asarray(out[1])
            return out

    class Jax:
        lax = Lax()

        def __getattr__(self, name):
            return getattr(jax, name)

    class Jnp:
        def __getattr__(self, name):
            return getattr(jnp, name)

        def take(self, a, idx, axis=None):
            rec["token_for_slot"] = np.asarray(idx)
            return jnp.take(a, idx, axis=axis)

        def where(self, c, *a):
            if c.ndim == 3 and c.shape[-1] == 1:
                rec["valid"] = np.asarray(c).reshape(-1)
            return jnp.where(c, *a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmoe, "jax", Jax())
        mp.setattr(jmoe, "jnp", Jnp())
        out = jmoe.moe_ffn(p, jcfg, x)
    return _np(out), rec


def _assert_routing_equal(trace, rec):
    np.testing.assert_array_equal(trace["expert_idx"].numpy(), rec["expert_idx"])
    np.testing.assert_array_equal(trace["token_for_slot"].numpy(), rec["token_for_slot"])
    np.testing.assert_array_equal(trace["valid"].numpy(), rec["valid"])


def _close(got, want, dtype):
    tol = 1e-5 if dtype == "float32" else 2 * 2.0 ** -7
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * lm.scale(want))


# -- the MoE FFN --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(jax_params, arch, dtype):
    """The routing equal, the output within its bound."""
    jcfg, cfg, p, mod = _moe_layer(jax_params, arch, dtype)
    jx, tx = _x(1, dtype)
    want, rec = jax_moe_ffn(p, jcfg, jx)
    trace = {}
    got = tmoe.moe_ffn(mod, cfg, tx, trace=trace)
    assert got.dtype == cfg.compute_dtype and tuple(got.shape) == (B, S, 64)
    assert trace["capacity"] == jmoe.capacity(jcfg, B * S)
    _assert_routing_equal(trace, rec)
    _close(got.float().numpy(), want, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_overflow_drops_the_same_tokens(jax_params, arch):
    """``capacity_factor`` 0.5: capacity C = B·S·k / (2E) < the assignments an
    expert gets, so some are dropped (their tokens keep only their other
    experts' contributions): the same ones in both packages."""
    jcfg, cfg, p, mod = _moe_layer(jax_params, arch, "float32", capacity_factor=0.5)
    jx, tx = _x(2, "float32")
    want, rec = jax_moe_ffn(p, jcfg, jx)
    trace = {}
    got = tmoe.moe_ffn(mod, cfg, tx, trace=trace)
    _assert_routing_equal(trace, rec)
    kept = int(trace["valid"].sum())
    assert kept < B * S * cfg.top_k  # something was dropped
    assert bool((trace["slot_of"] == cfg.n_experts * trace["capacity"]).any())
    assert int((trace["slot_of"] < cfg.n_experts * trace["capacity"]).sum()) == kept
    _close(got.numpy(), want, "float32")
    counts, dropped = tmoe.router_load(cfg, tx, mod)
    jcounts, jdropped = jmoe.router_load(jcfg, jx, p)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert float(dropped) == float(jdropped) == (B * S * cfg.top_k - kept) / (B * S * cfg.top_k)


@pytest.mark.parametrize("arch", ARCHS)
def test_tied_router_probabilities_pick_the_same_experts(jax_params, arch):
    """A router whose columns come in equal triples ({0, 1, 2}, {3, 4, 5},
    ...): each token's probabilities tie within a triple, and where the top
    k cuts into a triple it takes its lower indices, as ``jax.lax.top_k``
    does."""
    jcfg, cfg, p, mod = _moe_layer(jax_params, arch, "float32")
    router = np.array(p["router"])
    group = np.arange(cfg.n_experts) // 3
    router = router[:, group * 3]
    p = dict(p, router=jnp.asarray(router))
    mod.router.data = torch.from_numpy(router)
    jx, tx = _x(3, "float32")
    probs, _, idx = tmoe._route(mod, cfg, tx.reshape(-1, 64))
    assert torch.equal(probs, probs[:, torch.from_numpy(group * 3)])
    picked = set(map(tuple, idx.tolist()))
    for row in picked:  # every pick's lower tied indices are picked too
        assert all(j - 1 in row for j in row if j % 3), row
    assert any(row[1] == row[0] + 1 for row in picked)  # a tie decided inside a triple
    want, rec = jax_moe_ffn(p, jcfg, jx)
    trace = {}
    got = tmoe.moe_ffn(mod, cfg, tx, trace=trace)
    _assert_routing_equal(trace, rec)
    _close(got.numpy(), want, "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_combine_adds_in_jax_slot_order(jax_params, arch):
    """Fed the same expert outputs, the port's combine equals JAX's
    ``.at[token_for_slot].add`` bit for bit, at top-4 (the order shows
    from 3 contributions on: 0.0 + a + b is b + a) with drops; the same
    contributions added in the reverse order of the experts differ (so the
    order is what the test holds)."""
    jcfg, cfg, p, mod = _moe_layer(jax_params, arch, "float32", capacity_factor=0.75, top_k=4)
    _, tx = _x(4, "float32")
    trace = {}
    tmoe.moe_ffn(mod, cfg, tx, trace=trace)
    rows = cfg.n_experts * trace["capacity"]
    y = (np.random.default_rng(5).normal(size=(rows, 64)) * 10.0 ** np.random.default_rng(
        6).integers(-3, 4, (rows, 1))).astype(np.float32)
    tok, valid = trace["token_for_slot"].numpy(), trace["valid"].numpy()
    want = np.asarray(jnp.zeros((B * S, 64), jnp.float32).at[jnp.asarray(tok)].add(
        jnp.where(jnp.asarray(valid)[:, None], jnp.asarray(y), 0.0)))
    yt = torch.where(trace["valid"][:, None], torch.from_numpy(y), 0.0)
    got = tmoe._combine(yt, trace["expert_idx"], trace["slot_of"])
    np.testing.assert_array_equal(got.numpy(), want)
    reverse = tmoe._combine(yt, -trace["expert_idx"], trace["slot_of"])
    assert not np.array_equal(reverse.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_load_matches_jax(jax_params, arch):
    jcfg, cfg, p, mod = _moe_layer(jax_params, arch, "float32")
    jx, tx = _x(7, "float32")
    counts, dropped = tmoe.router_load(cfg, tx, mod)
    jcounts, jdropped = jmoe.router_load(jcfg, jx, p)
    assert counts.shape == (cfg.n_experts,) and int(counts.sum()) == B * S * cfg.top_k
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert dropped.dtype == torch.float32 and float(dropped) == float(jdropped)


def test_moe_token_stationary_is_refused_by_name():
    """``moe_token_stationary=True`` is no longer refused: it places the
    (E, C, .) tensors of a model on a mesh (tests/test_torch_sharded_lm.py),
    and off a mesh the MoE gives the same output bit for bit."""
    base = get_config("mixtral_8x22b", reduced=True)
    cfg = dataclasses.replace(base, moe_token_stationary=True)
    mod = tmoe.MoE(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn((1, 2, 64), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    assert torch.equal(tmoe.moe_ffn(mod, cfg, x), tmoe.moe_ffn(mod, base, x))


# -- the models ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_side(jax_params):
    """JAX's prefill logits and 12 decode steps of an arch at a dtype, each
    computed once a module."""
    cache = {}

    def get(what, arch, dtype):
        key = (what, arch, dtype)
        if key in cache:
            return cache[key]
        jcfg, _ = lm.cfgs(arch, dtype)
        params = jax_params(arch)[0]
        if what == "prefill":
            fn = lambda p, t: jm.prefill_logits(p, jcfg, {"tokens": t})  # noqa: E731
            fn = jax.jit(fn) if dtype == "float32" else fn
            cache[key] = _np(fn(params, jnp.asarray(lm.tokens(1, B, S))))
        else:
            step = lambda p, s, tok, pos: jm.decode_step(p, jcfg, s, tok, pos)  # noqa: E731
            step = jax.jit(step) if dtype == "float32" else step
            tokens = lm.tokens(2, B, 12)
            state = jm.init_decode_state(jcfg, B, 14)
            out = []
            for pos in range(12):
                logits, state = step(params, state, jnp.asarray(tokens[:, pos:pos + 1]), pos)
                out.append(_np(logits))
            cache[key] = np.stack(out, 1), jax.tree_util.tree_map(_np, state)
        return cache[key]

    return get


def _port(jax_params, arch, cfg):
    return carry.lm_params_from_reference(jax_params(arch)[1], cfg, "cpu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax(jax_params, jax_side, arch, dtype):
    _, cfg = lm.cfgs(arch, dtype)
    got = tm.prefill_logits(_port(jax_params, arch, cfg), cfg,
                            {"tokens": torch.from_numpy(lm.tokens(1, B, S))}).numpy()
    assert got.dtype == np.float32 and got.shape == (B, cfg.vocab)
    np.testing.assert_allclose(got, jax_side("prefill", arch, dtype), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_twelve_decode_steps_match_jax(jax_params, jax_side, arch, dtype):
    """f32 against JAX's decode step jitted once, bf16 against its op-by-op
    form (each step routes B tokens with a capacity of its own); the KV
    caches too."""
    _, cfg = lm.cfgs(arch, dtype)
    want, jstate = jax_side("decode", arch, dtype)
    model = _port(jax_params, arch, cfg)
    tokens = lm.tokens(2, B, 12)
    state = tm.init_decode_state(cfg, B, 14, device="cpu")
    out = []
    for pos in range(12):
        logits, state = tm.decode_step(model, cfg, state, torch.from_numpy(tokens[:, pos:pos + 1]),
                                       pos)
        out.append(logits.numpy())
    np.testing.assert_allclose(np.stack(out, 1), want, **TOL[dtype])
    for i, st in enumerate(state):
        assert tuple(st["k"].shape) == (B, cfg.n_kv_heads, 14, cfg.head_dim)
        for name in ("k", "v"):
            np.testing.assert_allclose(st[name].float().numpy(),
                                       jstate["groups"]["0_attn_moe"][name][i], **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward_in_the_port(jax_params, arch, dtype):
    """With a capacity that drops nothing (``capacity_factor = E / k``:
    C = the tokens routed), decode logits at t == the full forward's at t."""
    _, cfg = lm.cfgs(arch, dtype)
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    model = _port(jax_params, arch, cfg)
    tokens = torch.from_numpy(lm.tokens(3, B, 12))
    hidden = ttf.backbone(model, cfg, tokens)
    full = torch.stack([ttf.last_logits(model, cfg, hidden[:, :p + 1]) for p in range(12)], 1)
    state = tm.init_decode_state(cfg, B, 12, device="cpu")
    for pos in range(12):
        logits, state = tm.decode_step(model, cfg, state, tokens[:, pos:pos + 1], pos)
        np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(), **TOL[dtype])


def test_generate_matches_the_jax_example_loop(jax_params):
    """`launch.serve_lm.generate` on reduced mixtral at f32: the JAX
    example's loop with the same weights samples the same tokens."""
    jcfg, cfg = lm.cfgs("mixtral_8x22b", "float32")
    batch, n = 4, 8
    state = jm.init_decode_state(jcfg, batch, max_seq=n + 8)

    @jax.jit
    def step(params, state, token, pos, key):
        logits, state = jm.decode_step(params, jcfg, state, token, pos)
        return state, jax.random.categorical(key, logits / 0.8, axis=-1)[:, None]

    token = jnp.ones((batch, 1), jnp.int32)
    seqs = [token]
    for pos in range(n):
        state, token = step(jax_params("mixtral_8x22b")[0], state, token, pos,
                            jax.random.key(100 + pos))
        seqs.append(token)
    want = np.concatenate([np.asarray(s) for s in seqs], axis=1)
    model = _port(jax_params, "mixtral_8x22b", cfg)
    assert serve_lm.generate(model, cfg, batch, n, "cpu").tolist() == want.tolist()


# -- configs, counts and weights ----------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_count_match_jax(arch, reduced):
    """Every field the port has equals JAX's; so do ``param_count`` and the
    active count (the routed experts only)."""
    mine, ref = get_config(arch, reduced=reduced), jax_get_config(arch, reduced=reduced)
    assert dataclasses.asdict(mine) == {f: getattr(ref, f) for f in dataclasses.asdict(mine)}
    assert mine.n_params == ref.n_params == tcommon.param_count(mine) == jcommon.param_count(ref)
    assert (mine.n_active_params == ref.n_active_params
            == tcommon.param_count(mine, active_only=True)
            == jcommon.param_count(ref, active_only=True) < mine.n_params)
    assert arch in PORTED and ttf.layer_pattern(mine) == ("attn_moe",)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_full_configs_build_the_counted_parameters(arch):
    """An `LM` on the meta device (no memory) of the full config holds
    ``n_params`` parameters: the moe formula counts every leaf."""
    cfg = get_config(arch)
    assert sum(p.numel() for p in ttf.LM(cfg, None, "meta").parameters()) == cfg.n_params


@pytest.mark.parametrize("arch", ARCHS)
def test_carried_weights_keep_the_jax_leaves_and_dtypes(jax_params, arch):
    """Every JAX leaf lands in the port once; the router and the norms stay
    f32, the expert weights are stored in the compute dtype."""
    _, cfg = lm.cfgs(arch, "bfloat16")
    tree = jax_params(arch)[1]
    model = _port(jax_params, arch, cfg)
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(tree))
    f32 = {"norm1", "norm2", "final_norm", "q_norm", "k_norm", "router"}
    for name, p in model.named_parameters():
        assert p.dtype == (torch.float32 if name.split(".")[-1] in f32 else torch.bfloat16), name
    assert torch.equal(model.layers[1].moe.router,
                       torch.from_numpy(tree["groups"]["0_attn_moe"]["moe"]["router"][1]))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_on_the_card_is_bit_equal_between_runs_and_routes_as_the_cpu(jax_params, arch):
    """On the card: two runs of `moe_ffn` on the same inputs are bit-equal
    (the ordered combine), and the routing equals the CPU's (f32, TF32
    off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    _, cfg, _, mod = _moe_layer(jax_params, arch, "float32")
    _, tx = _x(8, "float32")
    cpu_trace, card_trace = {}, {}
    tmoe.moe_ffn(mod, cfg, tx, trace=cpu_trace)
    card = mod.to("cuda")
    a = tmoe.moe_ffn(card, cfg, tx.cuda(), trace=card_trace)
    b = tmoe.moe_ffn(card, cfg, tx.cuda())
    assert torch.equal(a, b)
    for name in ("expert_idx", "token_for_slot", "valid"):
        assert torch.equal(card_trace[name].cpu(), cpu_trace[name]), name
