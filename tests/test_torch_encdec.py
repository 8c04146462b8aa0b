"""The port's encdec family (whisper's encoder-decoder) against the JAX
package's, on the CPU.

`repro_torch.models.whisper` on the reduced ``whisper_medium`` (2 encoder
and 2 decoder layers, 16 frames, MHA 4 x 16) with the JAX package's
weights carried over by `carry.lm_params_from_reference`: the sinusoid
table, `encode`, prefill logits, 12 decode steps over the same encoder
output, decode against the port's forward, the configs and parameter
counts, the carried leaves and the sampling loop (`forward_loss` and its
gradients: tests/test_torch_encdec_train.py).  The frames come from a
numpy seed; JAX's side is computed once a module.

Tolerances:

* the sinusoid table (stated in its test): ``jnp.power`` and
  ``torch.pow`` differ by one ulp on 4 of whisper-medium's 512
  exponents, which moves those columns' angles (``pos / pow``) by up to
  two ulps of the angle;
  ``sin`` / ``cos`` of equal angles differ by at most one ulp.  Cast to
  bf16 (as `encode` casts it) the tables differ in 44 of 1,536,000
  entries, by at most 2^-8 (one bf16 ulp in [0.5, 1)).
* the encoder states and logits: f32 rtol = atol = 1e-4; bf16 the JAX
  package's decode tolerance rtol = atol = 3e-2, against JAX op by op
  (``scan_layers=False``).
* decode against the forward: the same.
* parameter counts: JAX's formula word for word, which leaves out
  ``enc_norm`` (stated below).
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
from repro.models import whisper as jw  # noqa: E402
import _torch_lm_parity as lm  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.configs import PORTED, get_config  # noqa: E402
from repro_torch.launch import serve_lm  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models import whisper as tw  # noqa: E402

ARCH = "whisper_medium"
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
B, S, F = 2, 16, 16  # F: the reduced config's enc_seq
_np = lm.np32


def _cfgs(dtype, **kw):
    return lm.cfgs(ARCH, dtype, **kw)


def _frames(seed, b=B):
    return np.random.default_rng(seed).normal(size=(b, F, 64)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_params():
    return lm.jax_init(ARCH)


@pytest.fixture(scope="module")
def port_models(jax_params):
    return {dtype: carry.lm_params_from_reference(jax_params[1], _cfgs(dtype)[1], "cpu")
            for dtype in DTYPES}


@pytest.fixture(scope="module")
def jax_side(jax_params):
    """JAX's encoder states, prefill logits and 12 decode steps (over its
    own encoder states) at a dtype, each computed once a module."""
    cache = {}

    def get(what, dtype):
        key = (what, dtype)
        if key in cache:
            return cache[key]
        jcfg, _ = _cfgs(dtype)
        jit = jax.jit if dtype == "float32" else (lambda f: f)
        params = jax_params[0]
        if what == "encode":
            cache[key] = jit(lambda p, f: jw.encode(p, jcfg, f))(params, jnp.asarray(_frames(1)))
        elif what == "prefill":
            batch = {"frames": jnp.asarray(_frames(1)), "tokens": jnp.asarray(lm.tokens(2, B, S))}
            cache[key] = _np(jit(lambda p, b: jm.prefill_logits(p, jcfg, b))(params, batch))
        elif what == "decode":
            enc_out = get("encode", dtype)
            step = jit(lambda p, s, tok, pos, ctx: jm.decode_step(p, jcfg, s, tok, pos, ctx=ctx))
            tokens = lm.tokens(3, B, 12)
            state = jm.init_decode_state(jcfg, B, 14)
            out = []
            for pos in range(12):
                logits, state = step(params, state, jnp.asarray(tokens[:, pos:pos + 1]), pos,
                                     enc_out)
                out.append(_np(logits))
            cache[key] = np.stack(out, 1), jax.tree_util.tree_map(_np, state)
        return cache[key]

    return get


# -- the sinusoid table -------------------------------------------------------------------
def test_sinusoid_positions_match_jax_within_an_ulp_of_each_op():
    """At whisper-medium's (1500, 1024): the exponents' ``pow`` within one
    ulp (4 of 512 differ), so the angles within two ulps of the angle (the
    division rounds again); ``sin`` / ``cos`` of JAX's own angles within
    one ulp; the tables then within two ulps of the angle plus one of the
    value (at most 3.05e-5 here).  The bf16 cast that
    `encode` applies hides nearly all of it: 44 of 1,536,000 entries
    differ, by at most 2^-8, one bf16 ulp in [0.5, 1) (none at the reduced
    (16, 64))."""
    n, d = 1500, 1024
    dims = np.arange(0, d, 2, dtype=np.float32) / np.float32(d)
    jpow = np.array(jnp.power(jnp.float32(10_000.0), jnp.asarray(dims)))
    tpow = torch.pow(torch.tensor(10_000.0), torch.from_numpy(dims.copy())).numpy()
    assert np.all(np.abs(jpow - tpow) <= np.spacing(jpow)) and 0 < (jpow != tpow).sum() <= 8
    ang = np.arange(n, dtype=np.float32)[:, None] / jpow[None, :]
    for jf, tf in ((jnp.sin, torch.sin), (jnp.cos, torch.cos)):
        want = np.array(jf(jnp.asarray(ang)))
        got = tf(torch.from_numpy(ang.copy())).numpy()
        assert np.abs(got - want).max() <= np.spacing(np.float32(1.0)) / 2
    want = np.array(jcommon.sinusoid_positions(n, d))
    got = tcommon.sinusoid_positions(n, d).numpy()
    assert got.dtype == np.float32 and got.shape == (n, d)
    ang2 = np.concatenate([ang, ang], axis=1)
    assert np.all(np.abs(got - want) <= 2 * np.spacing(ang2) + np.spacing(np.float32(1.0)))
    jb = np.array(jnp.asarray(want).astype(jnp.bfloat16).astype(jnp.float32))
    tb = torch.from_numpy(got.copy()).bfloat16().float().numpy()
    differ = jb != tb
    assert differ.sum() <= 1e-4 * differ.size
    assert np.abs(jb - tb).max() <= 2.0 ** -8
    small = np.array(jcommon.sinusoid_positions(F, 64)).astype(np.float32)
    assert np.array_equal(
        np.array(jnp.asarray(small).astype(jnp.bfloat16).astype(jnp.float32)),
        tcommon.sinusoid_positions(F, 64).bfloat16().float().numpy())


# -- the model ----------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_jax(jax_side, port_models, dtype):
    _, cfg = _cfgs(dtype)
    want = _np(jax_side("encode", dtype))
    got = tw.encode(port_models[dtype], cfg, torch.from_numpy(_frames(1)))
    assert got.dtype == cfg.compute_dtype and tuple(got.shape) == (B, F, 64)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_logits_match_jax(jax_side, port_models, dtype):
    """JAX's encdec branch of ``prefill_logits``: encode the frames, the
    decoder over the tokens, the last position's logits."""
    _, cfg = _cfgs(dtype)
    want = jax_side("prefill", dtype)
    got = tm.prefill_logits(port_models[dtype], cfg,
                            {"frames": torch.from_numpy(_frames(1)),
                             "tokens": torch.from_numpy(lm.tokens(2, B, S))}).numpy()
    assert got.dtype == np.float32 and got.shape == (B, cfg.vocab)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    if dtype == "bfloat16":  # as close to the f32 model as JAX's bf16 is
        ref = jax_side("prefill", "float32")
        assert np.abs(got - ref).max() <= 1.1 * np.abs(want - ref).max() + 1e-3


@pytest.mark.parametrize("dtype", DTYPES)
def test_twelve_decode_steps_match_jax(jax_side, port_models, dtype):
    """Both packages decode over JAX's encoder states (the cross K/V
    recomputed from them every step); f32 against JAX's decode step jitted
    once, bf16 against its op-by-op form; the self-attention KV caches
    too (JAX's stacked (L, B, KV, S, hd), the port's a list of layers)."""
    _, cfg = _cfgs(dtype)
    want, jstate = jax_side("decode", dtype)
    enc_out = torch.from_numpy(_np(jax_side("encode", dtype))).to(cfg.compute_dtype)
    tokens = lm.tokens(3, B, 12)
    state = tm.init_decode_state(cfg, B, 14, device="cpu")
    out = []
    for pos in range(12):
        logits, state = tm.decode_step(port_models[dtype], cfg, state,
                                       torch.from_numpy(tokens[:, pos:pos + 1]), pos,
                                       ctx=enc_out)
        out.append(logits.numpy())
    np.testing.assert_allclose(np.stack(out, 1), want, **TOL[dtype])
    assert len(state) == cfg.n_layers
    for n, st in enumerate(state):
        for name, x in st.items():
            assert x.dtype == cfg.compute_dtype
            np.testing.assert_allclose(x.float().numpy(), jstate[name][n], **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_matches_full_forward_in_the_port(port_models, dtype):
    _, cfg = _cfgs(dtype)
    model = port_models[dtype]
    tokens = torch.from_numpy(lm.tokens(5, B, 12))
    enc_out = tw.encode(model, cfg, torch.from_numpy(_frames(6)))
    hidden = tw.decoder(model, cfg, tokens, enc_out)
    full = torch.stack([ttf.last_logits(model, cfg, hidden[:, :p + 1])
                        for p in range(12)], 1)
    state = tm.init_decode_state(cfg, B, 12, device="cpu")
    for pos in range(12):
        logits, state = tm.decode_step(model, cfg, state, tokens[:, pos:pos + 1], pos,
                                       ctx=enc_out)
        np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(), **TOL[dtype])
    with pytest.raises(ValueError, match="needs ctx"):
        tm.decode_step(model, cfg, state, tokens[:, :1], 0)


def test_generate_matches_the_jax_example_loop(jax_params):
    """`launch.serve_lm.generate` at f32 over the encoded frames: the JAX
    example's loop (``examples/serve_lm.py``: ``whisper.encode`` of the
    frames, then the decode steps) with the same weights and frames
    samples the same tokens."""
    jcfg, cfg = _cfgs("float32")
    batch, n = B, 8
    frames = _frames(7)
    ctx = jw.encode(jax_params[0], jcfg, jnp.asarray(frames))
    state = jm.init_decode_state(jcfg, batch, max_seq=n + 8)

    @jax.jit
    def step(params, state, token, pos, key):
        logits, state = jm.decode_step(params, jcfg, state, token, pos, ctx=ctx)
        return state, jax.random.categorical(key, logits / 0.8, axis=-1)[:, None]

    token = jnp.ones((batch, 1), jnp.int32)
    seqs = [token]
    for pos in range(n):
        state, token = step(jax_params[0], state, token, pos, jax.random.key(100 + pos))
        seqs.append(token)
    want = np.concatenate([np.asarray(s) for s in seqs], axis=1)
    model = carry.lm_params_from_reference(jax_params[1], cfg, "cpu")
    enc_out = tw.encode(model, cfg, torch.from_numpy(frames))
    got = serve_lm.generate(model, cfg, batch, n, "cpu", ctx=enc_out)
    assert got.tolist() == want.tolist()
    ctx_port = serve_lm.context(model, cfg, batch, "cpu")
    assert tuple(ctx_port.shape) == (batch, cfg.enc_seq, cfg.d_model)


# -- configs, counts, weights and the CLIs ------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_and_param_count_match_jax(reduced):
    mine, ref = get_config(ARCH, reduced=reduced), jax_get_config(ARCH, reduced=reduced)
    assert dataclasses.asdict(mine) == {f: getattr(ref, f) for f in dataclasses.asdict(mine)}
    assert mine.n_params == ref.n_params == tcommon.param_count(mine) == jcommon.param_count(ref)
    assert ARCH in PORTED and tm.model_class(mine) is tw.WhisperLM


def test_the_model_holds_jax_s_leaves_and_param_count_leaves_out_enc_norm(jax_params):
    """The full config on the meta device holds 810,987,520 parameters (24
    encoder and 24 decoder layers); JAX's formula leaves out ``enc_norm``:
    810,986,496 = 810,987,520 - 1024.  The reduced model holds exactly
    JAX's leaves."""
    cfg = get_config(ARCH)
    model = tw.WhisperLM(cfg, None, "meta")
    held = sum(p.numel() for p in model.parameters())
    assert held == 810_987_520 and cfg.n_params == 810_986_496
    assert held - cfg.n_params == model.enc_norm.numel() == cfg.d_model
    assert len(model.enc) == len(model.dec) == 24
    small = get_config(ARCH, reduced=True)
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(jax_params[1]))
    assert sum(p.numel() for p in tw.WhisperLM(small, None, "meta").parameters()) == n_jax


def test_carried_weights_keep_the_jax_leaves_and_dtypes(jax_params, port_models):
    """Every JAX leaf lands in the port once (the stacked ``enc`` / ``dec``
    unstacked into layers); the matrices stored cast to the compute dtype,
    the norms f32; JAX's ``self`` / ``cross`` attention names kept."""
    model = port_models["bfloat16"]
    tree = jax_params[1]
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(tree))
    for name, p in model.named_parameters():
        f32 = name.split(".")[-1].startswith("norm") or name in ("enc_norm", "final_norm")
        assert p.dtype == (torch.float32 if f32 else torch.bfloat16), name
    assert torch.equal(model.dec[1].cross.wk.float(), torch.from_numpy(
        _np(jnp.asarray(tree["dec"]["cross"]["wk"][1]).astype(jnp.bfloat16))))
    assert torch.equal(model.enc[0].norm2, torch.from_numpy(np.array(tree["enc"]["norm2"][0])))
    assert not hasattr(model.dec[0].cross, "gate")  # whisper's cross-attention is ungated
    state = carry.train_state_from_reference(
        {"params": tree, "opt": {"mu": tree, "nu": tree, "count": 0}, "step": 0},
        _cfgs("float32")[1], "cpu")
    assert set(state.params) == {n for n, _ in model.named_parameters()}


def test_train_cli_refuses_whisper_by_name():
    """JAX's `repro.launch.train` cannot feed whisper ``frames`` (a
    ``KeyError`` in its loss); the port's refuses the arch by name before
    it builds anything."""
    from repro_torch.launch import train

    with pytest.raises(SystemExit, match="needs frames"):
        train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "1"])


@pytest.mark.cuda
def test_reduced_whisper_on_the_card_equals_the_cpu(jax_params):
    """The reduced model in f32 (TF32 off): the encoder states, prefill
    logits and 12 decode steps on the card equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    _, cfg = _cfgs("float32")
    got = {}
    for dev in ("cuda", "cpu"):
        model = carry.lm_params_from_reference(jax_params[1], cfg, dev)
        frames = torch.from_numpy(_frames(4)).to(dev)
        tokens = torch.from_numpy(lm.tokens(3, B, 12)).to(dev)
        with torch.inference_mode():
            enc_out = tw.encode(model, cfg, frames)
            logits = tm.prefill_logits(model, cfg, {"frames": frames, "tokens": tokens})
            state = tm.init_decode_state(cfg, B, 12, device=dev)
            steps = []
            for pos in range(12):
                lg, state = tm.decode_step(model, cfg, state, tokens[:, pos:pos + 1], pos,
                                           ctx=enc_out)
                steps.append(lg)
        got[dev] = (enc_out.cpu(), logits.cpu(), torch.stack(steps, 1).cpu())
    for a, b in zip(got["cuda"], got["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
