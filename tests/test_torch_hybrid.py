"""The port's hybrid family (RG-LRU and local attention) against the JAX
package's, on the CPU.

`repro_torch.models.rglru` (the causal conv, the associative scan, the
decode step, the block), the ``layer_window`` of `.attention` (dense,
chunked, decode with a ring that wraps past the window) and the reduced
``recurrentgemma_9b`` (one group of rglru, rglru, attn_local and a
2-layer rglru tail) with the JAX package's weights carried over by
`carry.lm_params_from_reference`: prefill logits, 12 decode steps, decode
against the port's forward, the parameter counts and
`launch.serve_lm.generate` (`forward_loss` and its gradients:
tests/test_torch_hybrid_train.py).  JAX's side is computed once a module
(the weights drawn by a jitted ``init_params``).

Tolerances:

* the causal conv: bit for bit (the taps are added in JAX's order, one
  rounding an op in either dtype).
* the associative scan: bit for bit against JAX's op by op.  Jitted, XLA
  contracts ``a2 * b1 + b2`` into one FMA where the port (and JAX op by
  op) rounds twice; the two then differ by at most one f32 rounding a
  level of the recursion, 2·ceil(log2 S) ulps of the largest |h|.
* the RG-LRU's gates: ``a = exp(8 r log_a)`` differs by an ulp where
  XLA's and torch's ``exp`` differ (~7% of inputs near 0), and
  ``sqrt(1 - a^2)`` magnifies that near a = 1.  Fed JAX's own gates the
  port's scan equals JAX's bit for bit; from x, f32 outputs are held within
  1e-5 of their scale (relative), bf16 ones within 2 bf16 ulps of the
  largest output (a rounding flip).
* logits: f32 rtol = atol = 1e-4; bf16 the JAX package's decode tolerance
  rtol = atol = 3e-2 (an exp ulp can flip a bf16 rounding, which moves
  these random-weight logits by up to ~0.03), and the port's bf16 logits
  no further from the f32 model's than JAX's are (1.1x plus 1e-3).
* decode against the forward: the tolerances above (the scan and the
  step sum in other orders).
* parameter counts: equal to JAX's formula, which is not what the model
  holds (stated below).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import rglru as jr  # noqa: E402
import _torch_lm_parity as lm  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.configs import PORTED, get_config  # noqa: E402
from repro_torch.launch import serve_lm  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import rglru as tr  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ARCH = "recurrentgemma_9b"
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
B, S = 2, 16  # every layer-level input has the model's shapes, so JAX compiles once


def _cfgs(dtype, **kw):
    return lm.cfgs(ARCH, dtype, **kw)


_np, _scale = lm.np32, lm.scale


def _t(x, dtype):
    return torch.from_numpy(_np(x)).to(dtype)


def _tokens(seed, b, s):
    return lm.tokens(seed, b, s)


def _close(got, want, dtype):
    """f32: within 1e-5 of the scale; bf16: within 2 bf16 ulps of it."""
    tol = 1e-5 if dtype == "float32" else 2 * 2.0 ** -7
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * _scale(want))


@pytest.fixture(scope="module")
def jax_params():
    """The reduced model's JAX weights (f32 masters) and their numpy dump."""
    return lm.jax_init(ARCH)


@pytest.fixture(scope="module")
def mix(jax_params):
    """Group layer 0's RG-LRU weights: (JAX dict, port module) at each dtype."""
    p = jax.tree_util.tree_map(lambda a: a[0], jax_params[0]["groups"]["0_rglru"]["mix"])
    mods = {}
    for dtype in DTYPES:
        mod = tr.RGLRU(_cfgs(dtype)[1], None, "cpu")
        mod.load_state_dict({n: torch.from_numpy(np.array(a)) for n, a in p.items()},
                            strict=True)
        mods[dtype] = mod
    return p, mods


def _x(seed, dtype, width=64, s=S):
    x = np.random.default_rng(seed).normal(size=(B, s, width)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    return jx, _t(jx, getattr(torch, dtype))


# -- the RG-LRU ---------------------------------------------------------------------------
@pytest.mark.parametrize("state", [False, True], ids=["zero-state", "carried-state"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv1d_matches_jax_bit_for_bit(mix, dtype, state):
    p, mods = mix
    ju, tu = _x(1, dtype)
    js, ts = _x(2, dtype, s=3) if state else (None, None)
    want, want_st = jr.causal_conv1d(ju, p["conv_w"], p["conv_b"], js)
    got, got_st = tr.causal_conv1d(tu, mods[dtype].conv_w, mods[dtype].conv_b, ts)
    assert got.dtype == getattr(torch, dtype) and tuple(got_st.shape) == (B, 3, 64)
    np.testing.assert_array_equal(got.float().numpy(), _np(want))
    np.testing.assert_array_equal(got_st.float().numpy(), _np(want_st))


def _combine(x, y):
    (a1, b1), (a2, b2) = x, y
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("s", [1, 2, 3, 7, 16, 33])
def test_associative_scan_matches_jax(s):
    """Bit for bit against ``jax.lax.associative_scan`` op by op; jitted
    (one FMA a combine) within 2·ceil(log2 S) ulps of the largest |h|."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.8, 1.0, (B, s, 8)).astype(np.float32)
    b = rng.normal(size=(B, s, 8)).astype(np.float32)
    want = [_np(v) for v in jax.lax.associative_scan(_combine, (jnp.asarray(a), jnp.asarray(b)),
                                                     axis=1)]
    got = [v.numpy() for v in tr.associative_scan(torch.from_numpy(a), torch.from_numpy(b))]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    jitted = _np(jax.jit(lambda a, b: jax.lax.associative_scan(_combine, (a, b), axis=1)[1])(
        a, b))
    levels = max(1, int(np.ceil(np.log2(s))))
    ulp = float(np.spacing(np.float32(np.abs(jitted).max())))
    assert np.abs(got[1] - jitted).max() <= 2 * levels * ulp


@pytest.mark.parametrize("h0", [False, True], ids=["from-zero", "from-h0"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_scan_matches_jax(mix, dtype, h0):
    """The scan from x: within its stated bound (the gates' exp); fed JAX's
    own gates, the port's recursion returns JAX's h bit for bit."""
    p, mods = mix
    jcfg, cfg = _cfgs(dtype)
    ju, tu = _x(3, dtype)
    jh = jnp.asarray(np.random.default_rng(4).normal(size=(B, 64)).astype(np.float32))
    want, want_last = jr.rglru_scan(p, jcfg, ju, jh if h0 else None)
    got, got_last = tr.rglru_scan(mods[dtype], cfg, tu,
                                  torch.from_numpy(_np(jh)) if h0 else None)
    assert got.dtype == cfg.compute_dtype and got_last.dtype == torch.float32
    _close(got.float().numpy(), _np(want), dtype)
    _close(got_last.numpy(), _np(want_last), "float32")
    a, bterm = jr._gates(p, ju, jcfg.compute_dtype)
    if h0:
        bterm = bterm.at[:, 0].add(a[:, 0] * jh)
    _, h = tr.associative_scan(torch.from_numpy(_np(a)), torch.from_numpy(_np(bterm)))
    np.testing.assert_array_equal(h.numpy(), _np(jax.lax.associative_scan(
        _combine, (a, bterm), axis=1)[1]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_step_matches_jax(mix, dtype):
    p, mods = mix
    jcfg, cfg = _cfgs(dtype)
    ju, tu = _x(5, dtype, s=1)
    jh = jnp.asarray(np.random.default_rng(6).normal(size=(B, 64)).astype(np.float32))
    want, want_h = jr.rglru_step(p, jcfg, ju, jh)
    got, got_h = tr.rglru_step(mods[dtype], cfg, tu, torch.from_numpy(_np(jh)))
    assert tuple(got.shape) == (B, 1, 64) and got_h.dtype == torch.float32
    _close(got.float().numpy(), _np(want), dtype)
    _close(got_h.numpy(), _np(want_h), "float32")


@pytest.mark.parametrize("state", [False, True], ids=["prefill", "decode-state"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_block_matches_jax(mix, dtype, state):
    """The whole block (GeLU gate, conv, scan or step, output projection)
    over the sequence, or one decode step from a carried conv tail and h."""
    p, mods = mix
    jcfg, cfg = _cfgs(dtype)
    jx, tx = _x(7, dtype, s=1 if state else S)
    jst = tst = None
    if state:
        jc, tc = _x(8, dtype, s=3)
        jh = jnp.asarray(np.random.default_rng(9).normal(size=(B, 64)).astype(np.float32))
        jst, tst = {"conv": jc, "h": jh}, {"conv": tc, "h": torch.from_numpy(_np(jh))}
    want, wst = jr.rglru_block(p, jcfg, jx, jst)
    got, gst = tr.rglru_block(mods[dtype], cfg, tx, tst)
    _close(got.float().numpy(), _np(want), dtype)
    np.testing.assert_array_equal(gst["conv"].float().numpy(), _np(wst["conv"]))
    _close(gst["h"].numpy(), _np(wst["h"]), "float32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_block_decode_over_s_steps_equals_the_scan(mix, dtype):
    """The block run one token at a time from `init_rglru_state` (the conv
    tail and h carried) equals the block over the whole sequence."""
    _, mods = mix
    _, cfg = _cfgs(dtype)
    _, tx = _x(10, dtype)
    full, last = tr.rglru_block(mods[dtype], cfg, tx)
    state = tr.init_rglru_state(cfg, B, device="cpu")
    assert state["conv"].dtype == cfg.compute_dtype and state["h"].dtype == torch.float32
    steps = []
    for t in range(S):
        y, state = tr.rglru_block(mods[dtype], cfg, tx[:, t:t + 1], state)
        steps.append(y)
    _close(torch.cat(steps, 1).float().numpy(), full.float().numpy(), dtype)
    _close(state["h"].numpy(), last["h"].numpy(), "float32")
    _close(state["conv"].float().numpy(), last["conv"].float().numpy(), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_softplus_matches_jax(dtype):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) and its gradient, within an
    ulp of the largest value (the packages' exp and log1p); also past
    ``torch.nn.functional.softplus``'s threshold of 20."""
    x = np.concatenate([np.linspace(-30, 30, 241), [-6.9, -2.2, 20.5, 25.0]]).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = _np(jax.nn.softplus(jx))
    want_g = _np(jax.grad(lambda v: jnp.sum(jax.nn.softplus(v)))(jx))
    tx = _t(jx, getattr(torch, dtype)).requires_grad_()
    got = tr.softplus(tx)
    (g,) = torch.autograd.grad(got.sum(), tx)
    assert got.dtype == getattr(torch, dtype)
    ulp = 2.0 ** -23 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=2 * ulp, atol=2 * ulp)
    np.testing.assert_allclose(g.float().numpy(), want_g, rtol=2 * ulp, atol=2 * ulp)


# -- attention within a layer's window ----------------------------------------------------
def _attn(jax_params, dtype, **kw):
    """The local layer's attention weights (group layer 2): (JAX config,
    port config, JAX dict, port module)."""
    jcfg, cfg = _cfgs(dtype, **kw)
    p = jax.tree_util.tree_map(lambda a: a[0], jax_params[0]["groups"]["2_attn_local"]["attn"])
    mod = tattn.Attention(cfg, None, "cpu")
    mod.load_state_dict({n: torch.from_numpy(np.array(a)) for n, a in p.items()}, strict=True)
    return jcfg, cfg, p, mod


@pytest.mark.parametrize("window", [3, 16])
@pytest.mark.parametrize("dtype", DTYPES)
def test_local_attention_matches_jax(jax_params, dtype, window):
    """``attention(..., layer_window=w)`` at S <= attn_chunk: JAX's local
    branch (the dense scores masked with the layer's window, whatever
    ``swa_window`` says)."""
    jcfg, cfg, p, mod = _attn(jax_params, dtype, swa_window=5)
    jx, tx = _x(11, dtype, s=12)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (B, 12))
    want = _np(jattn.attention(p, jcfg, jx, jnp.asarray(pos), layer_window=window))
    got = tattn.attention(mod, cfg, tx, torch.from_numpy(pos.copy()), layer_window=window)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=0, atol=2 * 2.0 ** -7 * _scale(want)))
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    other = tattn.attention(mod, cfg, tx, torch.from_numpy(pos.copy()))  # swa_window 5
    assert np.abs(other.float().numpy() - want).max() > 10 * tol["atol"]


def _chunked_as_jax_lays_it_out(out, chunk, kv):
    b, s, h, hd = out.shape
    blocks = out.reshape(b, s // chunk, chunk, kv, h // kv, hd).permute(0, 1, 3, 4, 2, 5)
    return blocks.reshape(b, s, h, hd)


@pytest.mark.parametrize("window", [3, 5, 9])
def test_chunked_local_attention_matches_jax(jax_params, window):
    """A sequence past ``attn_chunk`` (4 over 12 positions) with the layer's
    window: the port's chunked output, laid out JAX's way, equals JAX's
    ``attend_chunked``; as it returns it, it equals JAX's dense local branch
    (``attn_chunk=0``) and the port's own."""
    jcfg, cfg, p, mod = _attn(jax_params, "float32", attn_chunk=4)
    jx, tx = _x(12, "float32", s=12)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (B, 12))
    q, k, v = tattn.project_qkv(mod, cfg, tx)
    q = tcommon.apply_rope(q, torch.from_numpy(pos.copy()), cfg.rope_theta)
    k = tcommon.apply_rope(k, torch.from_numpy(pos.copy()), cfg.rope_theta)
    want = _np(jattn.attend_chunked(*(jnp.asarray(t.numpy()) for t in (q, k, v)), jcfg, chunk=4,
                                    window=window))
    got = tattn.attend_chunked(q, k, v, cfg, chunk=4, window=window)
    np.testing.assert_allclose(_chunked_as_jax_lays_it_out(got, 4, cfg.n_kv_heads).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    layer = tattn.attention(mod, cfg, tx, torch.from_numpy(pos.copy()), layer_window=window)
    dense = _np(jattn.attention(p, dataclasses.replace(jcfg, attn_chunk=0), jx, jnp.asarray(pos),
                                layer_window=window))
    np.testing.assert_allclose(layer.numpy(), dense, rtol=1e-5, atol=1e-5)
    own = tattn.attention(mod, dataclasses.replace(cfg, attn_chunk=0), tx,
                          torch.from_numpy(pos.copy()), layer_window=window)
    np.testing.assert_allclose(layer.numpy(), own.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_local_decode_with_a_ring_wrapping_past_the_window(jax_params, dtype):
    """local_window 4 with ``ring_cache``: the attn_local layers' caches hold
    4 slots (the full cache 10), the ring wraps twice over 10 steps, and
    its logits equal the full cache's (the JAX package's own gate,
    tests/test_decode_optimizations.py: rtol = atol = 2e-2 and equal
    argmaxes) and, in f32, the JAX model's with the same ring (its decode
    step jitted once)."""
    jcfg, base = _cfgs(dtype, local_window=4)
    ring = dataclasses.replace(base, ring_cache=True)
    model = carry.lm_params_from_reference(jax_params[1], base, "cpu")
    tokens = _tokens(13, B, 10)

    def drive(cfg):
        state = tm.init_decode_state(cfg, B, 10, device="cpu")
        out = []
        for pos in range(10):
            logits, state = tm.decode_step(model, cfg, state,
                                           torch.from_numpy(tokens[:, pos:pos + 1]), pos)
            out.append(logits)
        return torch.stack(out, 1).numpy(), state

    full, fstate = drive(base)
    got, rstate = drive(ring)
    kinds = ttf.layer_kinds(base)
    for kind, fs, rs in zip(kinds, fstate, rstate):
        if kind == "attn_local":
            assert fs["k"].shape[2] == 10 and rs["k"].shape[2] == 4
    np.testing.assert_allclose(got, full, rtol=2e-2, atol=2e-2)
    np.testing.assert_array_equal(got.argmax(-1), full.argmax(-1))
    if dtype != "float32":
        return
    jring = dataclasses.replace(jcfg, ring_cache=True)
    step = jax.jit(lambda p, s, tok, pos: jm.decode_step(p, jring, s, tok, pos))
    jstate = jm.init_decode_state(jring, B, 10)
    assert jstate["groups"]["2_attn_local"]["k"].shape[3] == 4
    for pos in range(10):
        want, jstate = step(jax_params[0], jstate, jnp.asarray(tokens[:, pos:pos + 1]), pos)
        np.testing.assert_allclose(got[:, pos], _np(want), **TOL[dtype])


# -- the model ----------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_side(jax_params):
    """JAX's prefill logits and 12 decode steps at a dtype, each computed
    once a module."""
    cache = {}

    def get(what, dtype):
        key = (what, dtype)
        if key in cache:
            return cache[key]
        jcfg, _ = _cfgs(dtype)
        params = jax_params[0]
        if what == "prefill":
            fn = lambda p, t: jm.prefill_logits(p, jcfg, {"tokens": t})  # noqa: E731
            fn = jax.jit(fn) if dtype == "float32" else fn
            cache[key] = _np(fn(params, jnp.asarray(_tokens(1, B, S))))
        elif what == "decode":
            step = lambda p, s, tok, pos: jm.decode_step(p, jcfg, s, tok, pos)  # noqa: E731
            step = jax.jit(step) if dtype == "float32" else step
            tokens = _tokens(2, B, 12)
            state = jm.init_decode_state(jcfg, B, 14)
            out = []
            for pos in range(12):
                logits, state = step(params, state, jnp.asarray(tokens[:, pos:pos + 1]), pos)
                out.append(_np(logits))
            cache[key] = np.stack(out, 1), jax.tree_util.tree_map(_np, state)
        return cache[key]

    return get


@pytest.fixture(scope="module")
def port_models(jax_params):
    return {dtype: carry.lm_params_from_reference(jax_params[1], _cfgs(dtype)[1], "cpu")
            for dtype in DTYPES}


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_logits_match_jax(jax_side, port_models, dtype):
    _, cfg = _cfgs(dtype)
    want = jax_side("prefill", dtype)
    got = tm.prefill_logits(port_models[dtype], cfg,
                            {"tokens": torch.from_numpy(_tokens(1, B, S))}).numpy()
    assert got.dtype == np.float32 and got.shape == (B, cfg.vocab)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    if dtype == "bfloat16":  # as close to the f32 model as JAX's bf16 is
        ref = jax_side("prefill", "float32")
        assert np.abs(got - ref).max() <= 1.1 * np.abs(want - ref).max() + 1e-3


@pytest.mark.parametrize("dtype", DTYPES)
def test_twelve_decode_steps_match_jax(jax_side, port_models, dtype):
    """f32 against JAX's decode step jitted once, bf16 against its op-by-op
    form; every layer's state too (the RG-LRU's conv tail and h, the local
    layer's KV cache)."""
    _, cfg = _cfgs(dtype)
    want, jstate = jax_side("decode", dtype)
    tokens = _tokens(2, B, 12)
    state = tm.init_decode_state(cfg, B, 14, device="cpu")
    out = []
    for pos in range(12):
        logits, state = tm.decode_step(port_models[dtype], cfg, state,
                                       torch.from_numpy(tokens[:, pos:pos + 1]), pos)
        out.append(logits.numpy())
    np.testing.assert_allclose(np.stack(out, 1), want, **TOL[dtype])
    pat, n_groups, _ = ttf.plan(cfg)
    for n, (kind, st) in enumerate(zip(ttf.layer_kinds(cfg), state)):
        ref = (jax.tree_util.tree_map(lambda a: a[n // len(pat)],
                                      jstate["groups"][f"{n % len(pat)}_{kind}"])
               if n < n_groups * len(pat) else jstate["tail"][n - n_groups * len(pat)])
        assert set(st) == set(ref), (n, kind)
        for name, x in st.items():
            assert x.dtype == (torch.float32 if name == "h" else cfg.compute_dtype)
            np.testing.assert_allclose(x.float().numpy(), ref[name], **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_matches_full_forward_in_the_port(port_models, dtype):
    """Decode logits at t == the full forward's at t (the scan against the
    step, the conv tail, the local layer's cache)."""
    _, cfg = _cfgs(dtype)
    model = port_models[dtype]
    tokens = torch.from_numpy(_tokens(3, B, 12))
    hidden = ttf.backbone(model, cfg, tokens)
    full = torch.stack([ttf.last_logits(model, cfg, hidden[:, :p + 1]) for p in range(12)], 1)
    state = tm.init_decode_state(cfg, B, 12, device="cpu")
    for pos in range(12):
        logits, state = tm.decode_step(model, cfg, state, tokens[:, pos:pos + 1], pos)
        np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(), **TOL[dtype])


def test_generate_matches_the_jax_example_loop(jax_params):
    """`launch.serve_lm.generate` on the hybrid model at f32: the JAX
    example's loop (``examples/serve_lm.py``) with the same weights samples
    the same tokens."""
    jcfg, cfg = _cfgs("float32")
    batch, n = 4, 8
    state = jm.init_decode_state(jcfg, batch, max_seq=n + 8)

    @jax.jit
    def step(params, state, token, pos, key):
        logits, state = jm.decode_step(params, jcfg, state, token, pos)
        return state, jax.random.categorical(key, logits / 0.8, axis=-1)[:, None]

    token = jnp.ones((batch, 1), jnp.int32)
    seqs = [token]
    for pos in range(n):
        state, token = step(jax_params[0], state, token, pos, jax.random.key(100 + pos))
        seqs.append(token)
    want = np.concatenate([np.asarray(s) for s in seqs], axis=1)
    model = carry.lm_params_from_reference(jax_params[1], cfg, "cpu")
    assert serve_lm.generate(model, cfg, batch, n, "cpu").tolist() == want.tolist()


# -- configs, counts and weights ----------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_and_param_count_match_jax(reduced):
    """Every field the port has equals JAX's, and so does ``param_count``
    (JAX's formula word for word)."""
    mine, ref = get_config(ARCH, reduced=reduced), jax_get_config(ARCH, reduced=reduced)
    assert dataclasses.asdict(mine) == {f: getattr(ref, f) for f in dataclasses.asdict(mine)}
    assert mine.n_params == ref.n_params == tcommon.param_count(mine) == jcommon.param_count(ref)
    assert mine.n_active_params == ref.n_active_params
    assert ARCH in PORTED and ttf.layer_pattern(mine) == ("rglru", "rglru", "attn_local")


def test_param_count_is_not_what_the_model_holds(jax_params):
    """JAX's hybrid formula counts every layer whose kind is not "attn" as
    an RG-LRU layer (recurrentgemma's are "attn_local") and leaves out
    ``lam``: 9,975,459,840 at full size against the 9,396,408,320 the
    model holds (12 local-attention layers, 26 recurrent).  The port keeps
    the formula; the tensors it holds are the JAX tree's leaf for leaf."""
    cfg = get_config(ARCH)
    held = sum(p.numel() for p in ttf.LM(cfg, None, "meta").parameters())
    assert cfg.n_params == 9_975_459_840 and held == 9_396_408_320
    assert ttf.layer_kinds(cfg).count("attn_local") == 12
    assert ttf.layer_kinds(cfg).count("rglru") == 26
    small = get_config(ARCH, reduced=True)
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(jax_params[1]))
    assert sum(p.numel() for p in ttf.LM(small, None, "meta").parameters()) == n_jax
    assert n_jax != small.n_params


def test_carried_weights_keep_the_jax_leaves_and_dtypes(jax_params, port_models):
    """Every JAX leaf lands in the port once, the 2-layer tail included; the
    tensors the JAX code casts at use are stored cast (the matrices,
    ``conv_w``, ``conv_b``), the rest f32 (norms, ``b_r``, ``b_i``,
    ``lam``)."""
    model = port_models["bfloat16"]
    tree = jax_params[1]
    assert len(tree["tail"]) == 2 and len(model.layers) == 5
    f32 = {"norm1", "norm2", "final_norm", "b_r", "b_i", "lam"}
    for name, p in model.named_parameters():
        assert p.dtype == (torch.float32 if name.split(".")[-1] in f32 else torch.bfloat16), name
    assert torch.equal(model.layers[3].mix.lam, torch.from_numpy(tree["tail"][0]["mix"]["lam"]))
    assert torch.equal(model.layers[2].attn.wq.float(), torch.from_numpy(
        _np(jnp.asarray(tree["groups"]["2_attn_local"]["attn"]["wq"][0]).astype(jnp.bfloat16))))
    assert [type(layer).__name__ for layer in model.layers] == [
        "RGLRUBlock", "RGLRUBlock", "DenseBlock", "RGLRUBlock", "RGLRUBlock"]
    assert model.layers[2].local and not hasattr(model, "unembed")
