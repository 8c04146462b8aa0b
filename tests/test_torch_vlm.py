"""The port's vlm family (gated cross-attention) against the JAX package's,
on the CPU.

`repro_torch.models.attention.cross_attention` and the reduced
``llama32_vision_11b`` (one group of attn, attn, attn, cross, attn; 4
heads over 2 KV heads) with the JAX package's weights carried over by
`carry.lm_params_from_reference`: prefill logits over an image context,
the backbone with no context, 12 decode steps, decode against the port's
forward, the configs and parameter counts, the carried leaves and the
sampling loop (`forward_loss` and its gradients:
tests/test_torch_vlm_train.py).  JAX's side is computed once a module.

JAX makes every cross layer's ``gate`` 0 (``init_attention(cross=True)``),
so with its weights a cross layer adds exactly 0 and a parity test would
pass whatever ``cross_attention`` computed.  The tests set the gates to
1.0 in the numpy arrays that both packages are handed
(`_torch_lm_parity.set_gates`), and one holds that the logits then move.
The image context comes from a numpy seed.

Tolerances:

* one cross-attention: f32 within 1e-5 of the output's scale (the
  products sum in other orders); bf16 within 2 bf16 ulps of it.
* logits: f32 rtol = atol = 1e-4; bf16 the JAX package's decode tolerance
  rtol = atol = 3e-2, against JAX op by op (``scan_layers=False``).
* decode against the forward: the same.
* parameter counts: JAX's formula word for word, which counts each gate
  as ``d`` where it holds 1 (stated below).
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
from repro.models import transformer as jtf  # noqa: E402
import _torch_lm_parity as lm  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.configs import PORTED, get_config  # noqa: E402
from repro_torch.launch import serve_lm  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ARCH = "llama32_vision_11b"
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
B, S, T = 2, 16, 8  # T: the reduced config's img_tokens
_np = lm.np32


def _cfgs(dtype, **kw):
    return lm.cfgs(ARCH, dtype, **kw)


def _img(seed, t=T):
    return np.random.default_rng(seed).normal(size=(B, t, 64)).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    """The reduced model's JAX weights (f32 masters) with every gate at 1.0:
    (JAX tree, numpy tree), and the untouched numpy tree (gates 0)."""
    _, params_np = lm.jax_init(ARCH)
    return (*lm.set_gates(params_np, 1.0), params_np)


@pytest.fixture(scope="module")
def port_models(weights):
    return {dtype: carry.lm_params_from_reference(weights[1], _cfgs(dtype)[1], "cpu")
            for dtype in DTYPES}


@pytest.fixture(scope="module")
def jax_side(weights):
    """JAX's prefill logits (with the image, and with none) and 12 decode
    steps at a dtype, each computed once a module."""
    cache = {}

    def get(what, dtype):
        key = (what, dtype)
        if key in cache:
            return cache[key]
        jcfg, _ = _cfgs(dtype)
        jit = jax.jit if dtype == "float32" else (lambda f: f)
        params = weights[0]
        if what in ("prefill", "no-context"):
            batch = {"tokens": jnp.asarray(lm.tokens(1, B, S))}
            if what == "prefill":
                batch["img"] = jnp.asarray(_img(2))
            cache[key] = _np(jit(lambda p, b: jm.prefill_logits(p, jcfg, b))(params, batch))
        elif what == "decode":
            step = jit(lambda p, s, tok, pos, ctx: jm.decode_step(p, jcfg, s, tok, pos, ctx=ctx))
            tokens = lm.tokens(3, B, 12)
            ctx = jnp.asarray(_img(4))
            state = jm.init_decode_state(jcfg, B, 14)
            out = []
            for pos in range(12):
                logits, state = step(params, state, jnp.asarray(tokens[:, pos:pos + 1]), pos, ctx)
                out.append(_np(logits))
            cache[key] = np.stack(out, 1), jax.tree_util.tree_map(_np, state)
        return cache[key]

    return get


# -- cross-attention ----------------------------------------------------------------------
def _cross(weights, dtype):
    """The group's cross layer's attention (gate 1.0): (JAX config, port
    config, JAX dict, port module)."""
    jcfg, cfg = _cfgs(dtype)
    p = jax.tree_util.tree_map(lambda a: a[0], weights[0]["groups"]["3_cross"]["attn"])
    mod = tattn.Attention(cfg, None, "cpu", cross=True)
    mod.load_state_dict({n: torch.from_numpy(np.array(a)) for n, a in p.items()}, strict=True)
    return jcfg, cfg, p, mod


def _x(seed, dtype, s):
    x = np.random.default_rng(seed).normal(size=(B, s, 64)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    return jx, torch.from_numpy(_np(jx)).to(getattr(torch, dtype))


def _close(got, want, dtype):
    """f32: within 1e-5 of the scale; bf16: within 2 bf16 ulps of it."""
    tol = 1e-5 if dtype == "float32" else 2 * 2.0 ** -7
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * lm.scale(want))


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_matches_jax(weights, dtype, gated):
    """GQA (4 heads over 2 KV heads) from 12 positions over a context of 8,
    unmasked, with and without the tanh gate (1.0: tanh(1) scales it)."""
    jcfg, cfg, p, mod = _cross(weights, dtype)
    jx, tx = _x(5, dtype, 12)
    jc, tc = _x(6, dtype, T)
    want = _np(jattn.cross_attention(p, jcfg, jx, jc, gated=gated))
    got = tattn.cross_attention(mod, cfg, tx, tc, gated=gated)
    assert got.dtype == cfg.compute_dtype and tuple(got.shape) == (B, 12, 64)
    _close(got.float().numpy(), want, dtype)
    ungated = tattn.cross_attention(mod, cfg, tx, tc)
    if gated:  # the gate scales the output by tanh(1.0)
        ratio = got.float() / ungated.float()
        mask = ungated.float().abs() > 1e-2 * float(ungated.float().abs().max())
        np.testing.assert_allclose(ratio[mask].numpy(), np.tanh(1.0),
                                   rtol=1e-6 if dtype == "float32" else 2e-2)


def test_cross_attention_without_a_context_attends_over_its_input(weights):
    """``context=None``: K and V from x itself, with no causal mask (JAX's
    ``kv_x=None``), equal to JAX's and to passing x as the context."""
    jcfg, cfg, p, mod = _cross(weights, "float32")
    jx, tx = _x(7, "float32", 12)
    want = _np(jattn.cross_attention(p, jcfg, jx, None, gated=True))
    got = tattn.cross_attention(mod, cfg, tx, None, gated=True)
    _close(got.numpy(), want, "float32")
    assert torch.equal(got, tattn.cross_attention(mod, cfg, tx, tx, gated=True))
    # no mask: the first position already sees every later one
    moved = tx.clone()
    moved[:, -1] += 1.0
    assert not torch.equal(tattn.cross_attention(mod, cfg, moved, None, gated=True)[:, 0],
                           got[:, 0])


# -- the model ----------------------------------------------------------------------------
def _prefill(model, cfg, img=True, tokens_seed=1):
    batch = {"tokens": torch.from_numpy(lm.tokens(tokens_seed, B, S))}
    if img is not None and img is not False:
        batch["img"] = torch.from_numpy(_img(2) if img is True else img)
    return tm.prefill_logits(model, cfg, batch).numpy()


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_logits_with_an_image_match_jax(jax_side, port_models, dtype):
    _, cfg = _cfgs(dtype)
    want = jax_side("prefill", dtype)
    got = _prefill(port_models[dtype], cfg)
    assert got.dtype == np.float32 and got.shape == (B, cfg.vocab)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    if dtype == "bfloat16":  # as close to the f32 model as JAX's bf16 is
        ref = jax_side("prefill", "float32")
        assert np.abs(got - ref).max() <= 1.1 * np.abs(want - ref).max() + 1e-3


def test_the_gates_decide_what_the_image_adds(weights, port_models):
    """With JAX's own gates (0) a cross layer adds exactly 0: the logits
    do not depend on the image.  At 1.0 they differ from the gates-0 logits
    and move with the image."""
    _, cfg = _cfgs("float32")
    closed = carry.lm_params_from_reference(weights[2], cfg, "cpu")
    assert float(closed.layers[3].attn.gate) == 0.0
    shut = _prefill(closed, cfg)
    np.testing.assert_array_equal(shut, _prefill(closed, cfg, img=_img(9)))
    opened = _prefill(port_models["float32"], cfg)
    assert np.abs(opened - shut).max() > 1e-2
    assert np.abs(opened - _prefill(port_models["float32"], cfg, img=_img(9))).max() > 1e-3


@pytest.mark.parametrize("dtype", DTYPES)
def test_backbone_without_a_context_matches_jax(jax_side, port_models, dtype):
    """No ``img`` (``ctx=None``): each cross layer attends over its own
    normed input, unmasked, as JAX's does (its ``forward_loss`` on a batch
    without ``img``, the synthetic batches, PT-LM)."""
    _, cfg = _cfgs(dtype)
    want = jax_side("no-context", dtype)
    got = _prefill(port_models[dtype], cfg, img=None)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    assert np.abs(got - jax_side("prefill", dtype)).max() > 1e-2


@pytest.mark.parametrize("dtype", DTYPES)
def test_twelve_decode_steps_match_jax(jax_side, port_models, dtype):
    """f32 against JAX's decode step jitted once, bf16 against its op-by-op
    form, over the same image; the attention layers' KV caches too.  The
    cross layer holds no state (JAX allocates a cache for it that it never
    writes)."""
    _, cfg = _cfgs(dtype)
    want, jstate = jax_side("decode", dtype)
    tokens = lm.tokens(3, B, 12)
    ctx = torch.from_numpy(_img(4))
    state = tm.init_decode_state(cfg, B, 14, device="cpu")
    out = []
    for pos in range(12):
        logits, state = tm.decode_step(port_models[dtype], cfg, state,
                                       torch.from_numpy(tokens[:, pos:pos + 1]), pos, ctx=ctx)
        out.append(logits.numpy())
    np.testing.assert_allclose(np.stack(out, 1), want, **TOL[dtype])
    for n, (kind, st) in enumerate(zip(ttf.layer_kinds(cfg), state)):
        ref = jstate["groups"][f"{n}_{kind}"]
        if kind == "cross":
            assert st == {} and not np.abs(ref["k"]).any()
            continue
        for name, x in st.items():
            assert x.dtype == cfg.compute_dtype
            np.testing.assert_allclose(x.float().numpy(), ref[name][0], **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_matches_full_forward_in_the_port(port_models, dtype):
    _, cfg = _cfgs(dtype)
    model = port_models[dtype]
    tokens = torch.from_numpy(lm.tokens(5, B, 12))
    ctx = torch.from_numpy(_img(6))
    hidden = ttf.backbone(model, cfg, tokens, ctx=ctx)
    full = torch.stack([ttf.last_logits(model, cfg, hidden[:, :p + 1]) for p in range(12)], 1)
    state = tm.init_decode_state(cfg, B, 12, device="cpu")
    for pos in range(12):
        logits, state = tm.decode_step(model, cfg, state, tokens[:, pos:pos + 1], pos, ctx=ctx)
        np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(), **TOL[dtype])


def test_generate_matches_the_jax_example_loop(weights):
    """`launch.serve_lm.generate` over an image context at f32: the JAX
    example's loop (``examples/serve_lm.py``) with the same weights and the
    same context samples the same tokens."""
    jcfg, cfg = _cfgs("float32")
    batch, n = B, 8
    ctx = _img(8)
    state = jm.init_decode_state(jcfg, batch, max_seq=n + 8)

    @jax.jit
    def step(params, state, token, pos, key):
        logits, state = jm.decode_step(params, jcfg, state, token, pos, ctx=jnp.asarray(ctx))
        return state, jax.random.categorical(key, logits / 0.8, axis=-1)[:, None]

    token = jnp.ones((batch, 1), jnp.int32)
    seqs = [token]
    for pos in range(n):
        state, token = step(weights[0], state, token, pos, jax.random.key(100 + pos))
        seqs.append(token)
    want = np.concatenate([np.asarray(s) for s in seqs], axis=1)
    model = carry.lm_params_from_reference(weights[1], cfg, "cpu")
    got = serve_lm.generate(model, cfg, batch, n, "cpu", ctx=torch.from_numpy(ctx))
    assert got.tolist() == want.tolist()
    ctx_port = serve_lm.context(model, cfg, batch, "cpu")
    assert tuple(ctx_port.shape) == (batch, cfg.img_tokens, cfg.d_model)


# -- configs, counts and weights ----------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_and_param_count_match_jax(reduced):
    """Every field equals JAX's (the port's config has them all), and so
    does ``param_count``; the layer plan is JAX's."""
    mine, ref = get_config(ARCH, reduced=reduced), jax_get_config(ARCH, reduced=reduced)
    assert dataclasses.asdict(mine) == {f: getattr(ref, f) for f in dataclasses.asdict(mine)}
    assert mine.n_params == ref.n_params == tcommon.param_count(mine) == jcommon.param_count(ref)
    assert ARCH in PORTED and ttf.plan(mine) == jtf.plan(ref)
    assert ttf.layer_pattern(mine) == ("attn", "attn", "attn", "cross", "attn")
    assert [tcommon.is_cross_layer(mine, i) for i in range(mine.n_layers)] == [
        jcommon._is_cross_layer(ref, i) for i in range(ref.n_layers)]


def test_the_models_hold_jax_s_leaves_and_param_count_counts_each_gate_as_d(weights):
    """The full config on the meta device holds 9,775,157,256 parameters: 8
    cross layers (3, 8, ..., 38) of 40, each with a (1,) gate.  JAX's
    formula counts each gate as d = 4096: 9,775,190,016 (8 x 4095 more).
    The reduced model holds exactly JAX's leaves."""
    cfg = get_config(ARCH)
    held = sum(p.numel() for p in ttf.LM(cfg, None, "meta").parameters())
    assert held == 9_775_157_256 and cfg.n_params == 9_775_190_016
    assert cfg.n_params - held == 8 * (cfg.d_model - 1)
    kinds = ttf.layer_kinds(cfg)
    assert [i for i, k in enumerate(kinds) if k == "cross"] == list(range(3, 40, 5))
    small = get_config(ARCH, reduced=True)
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(weights[1]))
    assert sum(p.numel() for p in ttf.LM(small, None, "meta").parameters()) == n_jax


def test_carried_weights_keep_the_jax_leaves_and_dtypes(weights, port_models):
    """Every JAX leaf lands in the port once; the matrices are stored cast
    to the compute dtype, the norms and the gate f32; the cross layer is a
    `CrossBlock` with JAX's (G, 1) gate unstacked to (1,)."""
    model = port_models["bfloat16"]
    tree = weights[1]
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(tree))
    f32 = {"norm1", "norm2", "final_norm", "gate"}
    for name, p in model.named_parameters():
        assert p.dtype == (torch.float32 if name.split(".")[-1] in f32 else torch.bfloat16), name
    assert tree["groups"]["3_cross"]["attn"]["gate"].shape == (1, 1)
    assert torch.equal(model.layers[3].attn.gate, torch.ones(1))
    assert [type(layer).__name__ for layer in model.layers] == [
        "DenseBlock", "DenseBlock", "DenseBlock", "CrossBlock", "DenseBlock"]
    assert not hasattr(model.layers[3], "self") and not hasattr(model.layers[0].attn, "gate")
    state = carry.train_state_from_reference(
        {"params": tree, "opt": {"mu": tree, "nu": tree, "count": 0}, "step": 0}, _cfgs(
            "float32")[1], "cpu")
    assert state.params["layers.3.attn.gate"].dtype == torch.float32


@pytest.mark.cuda
def test_reduced_vlm_on_the_card_equals_the_cpu(weights):
    """The reduced model with gates 1.0 in f32 (TF32 off): prefill logits
    over an image and 12 decode steps on the card equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    _, cfg = _cfgs("float32")
    got = {}
    for dev in ("cuda", "cpu"):
        model = carry.lm_params_from_reference(weights[1], cfg, dev)
        ctx = torch.from_numpy(_img(4)).to(dev)
        tokens = torch.from_numpy(lm.tokens(3, B, 12)).to(dev)
        with torch.inference_mode():
            logits = tm.prefill_logits(model, cfg, {"tokens": tokens, "img": ctx})
            state = tm.init_decode_state(cfg, B, 12, device=dev)
            steps = []
            for pos in range(12):
                lg, state = tm.decode_step(model, cfg, state, tokens[:, pos:pos + 1], pos,
                                           ctx=ctx)
                steps.append(lg)
        got[dev] = (logits.cpu(), torch.stack(steps, 1).cpu())
    for a, b in zip(got["cuda"], got["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
