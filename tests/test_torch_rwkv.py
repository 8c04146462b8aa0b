"""The port's RWKV-6 serving path against the JAX package's, on the CPU.

`get_config("rwkv6_7b", reduced=True)` with the JAX package's own weights
(``init_params(cfg, jax.random.key(0))``) carried over by
`carry.lm_params_from_reference`: `TimeMix` / `ChannelMix`,
`prefill_logits` and 6 `decode_step`s against `repro.models`, decode against
the full forward inside the port, the sampler against `jax.random`, and
`launch.serve_lm.generate` against the loop of ``examples/serve_lm.py``.

Tolerances:

* f32 (``dtype="float32"``): rtol = atol = 1e-4 on logits of magnitude ~3,
  1e-5 on one layer's outputs; the two packages sum in other orders and
  XLA's and torch's exp differ by an ulp.
* bf16: the JAX package's own decode tolerance, rtol = atol = 3e-2.  The
  port rounds once per op, as JAX does when it runs op by op; inside the
  scanned layer body (``scan_layers=True``, the default) XLA fuses bf16
  elementwise chains in f32 and rounds once, which moves these random-weight
  logits by up to ~0.27.  So bf16 is held against the JAX model with
  ``scan_layers=False`` (its python-unrolled mode), run op by op.
* sampled token ids and categorical indices: equal.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.configs import PORTED, get_config  # noqa: E402
from repro_torch.core import keys  # noqa: E402
from repro_torch.launch import serve_lm  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
DTYPES = ["float32", "bfloat16"]


def _cfgs(dtype):
    """(JAX config, port config) of reduced rwkv6-7b at ``dtype``; the JAX
    one python-unrolled (op by op) at bf16, see the module docstring."""
    jcfg = dataclasses.replace(jax_get_config("rwkv6_7b", reduced=True), dtype=dtype,
                               scan_layers=dtype == "float32")
    return jcfg, dataclasses.replace(get_config("rwkv6_7b", reduced=True), dtype=dtype)


@pytest.fixture(scope="module")
def jax_params():
    """The JAX example's weights (f32 master weights, any compute dtype)."""
    cfg = jax_get_config("rwkv6_7b", reduced=True)
    params = jm.init_params(cfg, jax.random.key(0))
    return params, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def port_models(jax_params):
    return {dt: carry.lm_params_from_reference(jax_params[1], _cfgs(dt)[1], "cpu")
            for dt in DTYPES}


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_matches_jax(reduced):
    mine, ref = get_config("rwkv6-7b", reduced=reduced), jax_get_config("rwkv6_7b", reduced)
    # the port's config has the JAX fields it reads; heads are d_model / 64
    assert dataclasses.asdict(mine) == {f: getattr(ref, f) for f in dataclasses.asdict(mine)}
    assert ref.n_heads * ref.head_dim == ref.d_model and ref.head_dim == trwkv.HEAD_DIM
    assert mine.n_params == ref.n_params and mine.compute_dtype == torch.bfloat16
    if not reduced:
        assert mine.n_params == 7_533_367_296


@pytest.mark.parametrize("arch", ["qwen3_moe_235b", "mixtral-8x22b", "whisper_medium",
                                  "recurrentgemma_9b"])
def test_other_archs_refused_by_name(arch):
    """Every arch of the registry runs (dashed names too); a moe config with
    ``moe_token_stationary=True`` (a placement of the (E, C, .) tensors on a
    mesh) builds and, off a mesh, decodes as without it.  A context is
    ignored by a family with no cross layer, as JAX's ``decode_step``
    ignores it; whisper's decode step needs its encoder output and says so.
    An unknown arch is a KeyError."""
    name = arch.replace("-", "_")
    assert name in PORTED
    cfg = get_config(arch, reduced=True)
    assert cfg.name.startswith(name.split("_")[0])
    model = tm.init_params(cfg, 0, device="cpu")
    token = torch.ones((1, 1), dtype=torch.int64)

    def step(cfg=cfg, **kw):
        return tm.decode_step(model, cfg, tm.init_decode_state(cfg, 1, 2, device="cpu"), token,
                              0, **kw)[0]

    if cfg.family == "moe":
        stationary = dataclasses.replace(cfg, moe_token_stationary=True)
        tm.init_params(stationary, 0, device="cpu")
        assert torch.equal(step(stationary), step())

    if cfg.family == "encdec":
        with pytest.raises(ValueError, match="needs ctx"):
            step()
    else:
        assert torch.equal(step(ctx=torch.ones(1)), step())
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt5")


def test_carried_weights_keep_the_jax_leaves_and_dtypes(jax_params, port_models):
    """Every JAX leaf lands in the port once; the tensors the JAX code uses
    only through the compute-dtype cast are stored cast, the rest f32."""
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(jax_params[1]))
    model = port_models["bfloat16"]
    assert sum(p.numel() for p in model.parameters()) == n_jax
    f32 = {"w0", "u", "ln_scale", "norm1", "norm2", "final_norm"}
    for name, p in model.named_parameters():
        want = torch.float32 if name.split(".")[-1] in f32 else torch.bfloat16
        assert p.dtype == want, name
        assert not p.requires_grad
    w = jax_params[1]["groups"]["0_rwkv"]["tm"]["w_r"][1]
    assert torch.equal(model.layers[1].tm.w_r.float(),
                       torch.from_numpy(_np(jnp.asarray(w).astype(jnp.bfloat16))))


@pytest.mark.parametrize("dtype", DTYPES)
def test_time_mix_and_channel_mix_match_jax(jax_params, port_models, dtype):
    jcfg, cfg = _cfgs(dtype)
    lp = jax.tree_util.tree_map(lambda a: a[1], jax_params[0]["groups"]["0_rwkv"])
    layer = port_models[dtype].layers[1]
    rng = np.random.default_rng(3)
    h, last = rng.normal(size=(2, 5, 128)), rng.normal(size=(2, 128))
    state = rng.normal(size=(4, 64, 64)).astype(np.float32)
    jh, jl = (jnp.asarray(x, jnp.float32).astype(jcfg.compute_dtype) for x in (h, last))
    th, tl = (torch.from_numpy(_np(x)).to(cfg.compute_dtype) for x in (jh, jl))
    o, new_last, wkv = jrwkv.time_mix(lp["tm"], jcfg, jh, jl, jnp.asarray(state))
    to, tnew_last, twkv = layer.tm(th, tl, torch.from_numpy(state))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else TOL[dtype]
    np.testing.assert_allclose(to.float().numpy(), _np(o), **tol)
    np.testing.assert_allclose(twkv.numpy(), _np(wkv), **tol)
    assert torch.equal(tnew_last.float(), torch.from_numpy(_np(new_last)))
    assert tnew_last.dtype == cfg.compute_dtype and twkv.dtype == torch.float32
    o, new_last = jrwkv.channel_mix(lp["cm"], jcfg, jh, jl)
    to, tnew_last = layer.cm(th, tl)
    np.testing.assert_allclose(to.float().numpy(), _np(o), **tol)
    assert torch.equal(tnew_last.float(), torch.from_numpy(_np(new_last)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_logits_match_jax(jax_params, port_models, dtype):
    jcfg, cfg = _cfgs(dtype)
    tokens = _tokens(1, 2, 9, cfg.vocab)
    want = jm.prefill_logits(jax_params[0], jcfg, {"tokens": jnp.asarray(tokens)})
    got = tm.prefill_logits(port_models[dtype], cfg, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_six_decode_steps_match_jax(jax_params, port_models, dtype):
    """f32 against the JAX decode step jitted once (params as an argument),
    bf16 against its op-by-op form; the carried wkv state too."""
    jcfg, cfg = _cfgs(dtype)
    tokens = _tokens(2, 2, 6, cfg.vocab)
    step = (jax.jit(lambda p, s, tok, pos: jm.decode_step(p, jcfg, s, tok, pos))
            if dtype == "float32" else
            (lambda p, s, tok, pos: jm.decode_step(p, jcfg, s, tok, pos)))
    jstate = jm.init_decode_state(jcfg, 2, 8)
    tstate = tm.init_decode_state(cfg, 2, 8, device="cpu")
    for pos in range(6):
        want, jstate = step(jax_params[0], jstate, jnp.asarray(tokens[:, pos:pos + 1]), pos)
        got, tstate = tm.decode_step(port_models[dtype], cfg, tstate,
                                     torch.from_numpy(tokens[:, pos:pos + 1]), pos)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL[dtype])
    jwkv = jstate["groups"]["0_rwkv"]["wkv"] if "groups" in jstate else None
    for i, st in enumerate(tstate):
        ref = jwkv[i] if jwkv is not None else jstate["tail"][i]["wkv"]
        np.testing.assert_allclose(st["wkv"].numpy(), _np(ref), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_matches_full_forward_in_the_port(port_models, dtype):
    """Decode logits at position t == the full forward's at t (the cache)."""
    _, cfg = _cfgs(dtype)
    model = port_models[dtype]
    tokens = torch.from_numpy(_tokens(6, 2, 6, cfg.vocab))
    hidden = ttf.backbone(model, cfg, tokens)
    full = torch.stack([ttf.last_logits(model, cfg, hidden[:, :p + 1]) for p in range(6)], 1)
    state = tm.init_decode_state(cfg, 2, 6, device="cpu")
    for pos in range(6):
        logits, state = tm.decode_step(model, cfg, state, tokens[:, pos:pos + 1], pos)
        np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(), **TOL[dtype])


@pytest.mark.parametrize("seed", [0, 7, 100, 163])
def test_categorical_matches_jax(seed):
    logits = np.random.default_rng(seed).normal(size=(4, 512)).astype(np.float32) * 3
    want = jax.random.categorical(jax.random.key(seed), jnp.asarray(logits) / 0.8, axis=-1)
    got = keys.categorical(keys.key(seed), torch.from_numpy(logits) / 0.8)
    assert got.tolist() == np.asarray(want).tolist()
    tiny = float(np.finfo(np.float32).tiny)
    u = keys.uniform(keys.key(seed), (4, 512), minval=tiny, maxval=1.0)
    ju = jax.random.uniform(jax.random.key(seed), (4, 512), minval=tiny, maxval=1.0)
    assert np.array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_allclose(keys.gumbel(keys.key(seed), (4, 512)).numpy(),
                               np.asarray(jax.random.gumbel(jax.random.key(seed), (4, 512))),
                               rtol=1e-6, atol=1e-6)


def test_generate_matches_the_jax_example_loop(jax_params):
    """``examples/serve_lm.py``'s loop at f32: same weights, same tokens."""
    jcfg, cfg = _cfgs("float32")
    params, batch, n = jax_params[0], 4, 8
    state = jm.init_decode_state(jcfg, batch, max_seq=n + 8)

    @jax.jit
    def step(params, state, token, pos, key):
        logits, state = jm.decode_step(params, jcfg, state, token, pos)
        return state, jax.random.categorical(key, logits / 0.8, axis=-1)[:, None]

    token = jnp.ones((batch, 1), jnp.int32)
    seqs = [token]
    for pos in range(n):
        state, token = step(params, state, token, pos, jax.random.key(100 + pos))
        seqs.append(token)
    want = np.concatenate([np.asarray(s) for s in seqs], axis=1)
    model = carry.lm_params_from_reference(jax_params[1], cfg, "cpu")
    got = serve_lm.generate(model, cfg, batch, n, "cpu")
    assert got.tolist() == want.tolist()


def test_refusals_by_name(port_models):
    """rwkv has no cross layer, so an ``img`` changes nothing (JAX's
    backbone hands it only to cross layers); a family no package knows is
    refused by name, ``moe_token_stationary=True`` builds (it places tensors
    on a mesh), and the decoder-only assembly sends an encdec config to
    whisper's module by name."""
    _, cfg = _cfgs("float32")
    tokens = torch.ones((1, 2), dtype=torch.int64)
    model = port_models["float32"]
    assert torch.equal(tm.prefill_logits(model, cfg, {"tokens": tokens, "img": torch.ones(1)}),
                       tm.prefill_logits(model, cfg, {"tokens": tokens}))
    other = dataclasses.replace(cfg, family="ssm", name="tiny-ssm")
    with pytest.raises(NotImplementedError, match="the 'ssm' family of tiny-ssm"):
        tm.init_params(other, 0, device="cpu")
    moe = dataclasses.replace(cfg, family="moe", name="tiny-moe", n_experts=4, top_k=2,
                              moe_token_stationary=True)
    assert len(tm.init_params(moe, 0, device="cpu").layers) == cfg.n_layers
    with pytest.raises(ValueError, match="encoder-decoder.*whisper"):
        ttf.init_decode_state(dataclasses.replace(cfg, family="encdec"), 1, 4, device="cpu")


def test_init_params_from_a_seed(port_models):
    _, cfg = _cfgs("bfloat16")
    a = tm.init_params(cfg, 3, device="cpu")
    b = tm.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    c = tm.init_params(cfg, 4, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["layers.0.tm.w_r"], sc["layers.0.tm.w_r"])
    assert {k: v.dtype for k, v in sa.items()} == {
        k: v.dtype for k, v in port_models["bfloat16"].state_dict().items()}
    w = sa["unembed"].float()
    assert abs(w.std().item() * np.sqrt(cfg.d_model) - 1.0) < 0.05  # N(0, 1/fan_in)
    x = torch.randn(2, 3, cfg.d_model)
    np.testing.assert_allclose(tcommon.rms_norm(x, torch.zeros(cfg.d_model)).pow(2)
                               .mean(-1).numpy(), 1.0, rtol=1e-4)
    assert trwkv.heads(cfg) == 2


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_serve_lm_cli_on_cpu_and_refusing_a_missing_card():
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve_lm", "--device",
                          "cpu", "--tokens", "4", "--batch", "2"],
                         env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "arch=rwkv6_7b batch=2 device=cpu" in out.stdout
    assert "sample token ids: [1," in out.stdout
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve_lm"],
                             env=_env(), capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and "CUDA was requested" in out.stderr
