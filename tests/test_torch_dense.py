"""The port's dense decoder family against the JAX package's, on the CPU.

`repro_torch.models.common` (RoPE), `.ffn`, `.attention` and the dense
`LM` of `.transformer` on the four dense configs reduced (gemma-2b: MQA,
GeGLU, tied embeddings, embed scale; qwen3-32b: GQA with qk-norm;
minitron-4b: squared ReLU; stablelm-3b: MHA), each with the JAX package's
own weights (``init_params(cfg, jax.random.key(0))`` or the layer's init)
carried over by `carry.lm_params_from_reference`; prefill logits, 8
decode steps, decode against the full forward and the ring cache against
the full cache; the full configs' parameter counts; one f32 train step of
reduced gemma against JAX's ``make_train_step``; and the CLIs.

Tolerances:

* f32 (``dtype="float32"``): RoPE within 2e-6 (XLA's and torch's sin, cos
  and pow differ by an ulp); one FFN or attention layer within 1e-5
  relative and absolute; logits (magnitude ~5) within rtol = atol = 1e-4,
  as the rwkv tests (the packages sum in other orders).
* bf16, against JAX run op by op (``scan_layers=False``, no jit, as
  tests/test_torch_rwkv.py explains): one layer within 2 bf16 ulps of its
  largest output (2^-7 of it), logits within the JAX package's decode
  tolerance rtol = atol = 3e-2 (they agree within ~5e-7 here: the port
  rounds once an op as JAX does).
* the ring cache against the full cache: f32 within 1e-5; bf16 within the
  JAX package's own 2e-2 (``tests/test_decode_optimizations.py``), with
  equal argmaxes.
* parameter counts: equal.  One train step: the loss within 1e-5
  relative, ``lr`` within 1e-6, ``grad_norm`` within 1e-3; the masters
  within what the two Adam directions explain (`_torch_train_bound`,
  reading at most 1), the masters before the step far outside it.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.checkpoint.manager import _flatten as jflatten  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
import _torch_train_bound as tb  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import PORTED, get_config  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import ffn as tffn  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402

DENSE = ["gemma_2b", "qwen3_32b", "minitron_4b", "stablelm_3b"]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _cfgs(arch, dtype, **kw):
    """(JAX config, port config) of ``arch`` reduced at ``dtype``; the JAX one
    op by op at bf16 (see the module docstring)."""
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True), dtype=dtype,
                               scan_layers=dtype == "float32", **kw)
    return jcfg, dataclasses.replace(get_config(arch, reduced=True), dtype=dtype, **kw)


@pytest.fixture(scope="module")
def jax_params():
    """Each reduced dense arch's JAX weights (f32 masters) and their numpy dump."""
    cache = {}

    def get(arch):
        if arch not in cache:
            params = jm.init_params(jax_get_config(arch, reduced=True), jax.random.key(0))
            cache[arch] = params, jax.tree_util.tree_map(np.asarray, params)
        return cache[arch]

    return get


@pytest.fixture(scope="module")
def jax_prefill(jax_params):
    """JAX's prefill logits of an arch at a dtype for the tokens given, once
    a module: f32 jitted (one compile of the scanned layers), bf16 op by op."""
    cache = {}

    def get(arch, dtype, tokens):
        key = (arch, dtype, tokens.tobytes())
        if key not in cache:
            jcfg, _ = _cfgs(arch, dtype)
            fn = lambda p, t: jm.prefill_logits(p, jcfg, {"tokens": t})  # noqa: E731
            if dtype == "float32":
                fn = jax.jit(fn)
            cache[key] = _np(fn(jax_params(arch)[0], jnp.asarray(tokens)))
        return cache[key]

    return get


def _port(jax_params, arch, cfg):
    return carry.lm_params_from_reference(jax_params(arch)[1], cfg, "cpu")


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _t(x, dtype):
    return torch.from_numpy(_np(x)).to(dtype)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _layer_tol(dtype, want):
    if dtype == "float32":
        return dict(rtol=1e-5, atol=1e-5)
    return dict(rtol=0, atol=2 * 2.0 ** -7 * float(np.abs(want).max()))


def _module(cls, cfg, tree):
    """A port module (`FFN`, `Attention`) holding a JAX layer dict's values."""
    mod = cls(cfg, None, "cpu")
    mod.load_state_dict({n: torch.from_numpy(np.asarray(a)) for n, a in tree.items()},
                        strict=True)
    return mod


# -- primitives and layers --------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_jax(dtype, theta):
    x = np.random.default_rng(0).normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32) * 37, (2, 9))
    jx = jnp.asarray(x).astype(dtype)
    want = jcommon.apply_rope(jx, jnp.asarray(pos), theta)
    got = tcommon.apply_rope(_t(jx, getattr(torch, dtype)), torch.from_numpy(pos.copy()), theta)
    assert got.dtype == getattr(torch, dtype)
    tol = dict(rtol=0, atol=2e-6) if dtype == "float32" else _layer_tol(dtype, _np(want))
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)
    np.testing.assert_allclose(tcommon.rope_freqs(16, theta).numpy(),
                               np.asarray(jcommon.rope_freqs(16, theta)), rtol=2e-7)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["geglu", "silu", "relu2"])
def test_ffn_matches_jax(act, dtype):
    jcfg, cfg = _cfgs("gemma_2b", dtype, act=act)
    p = jffn.init_ffn(jax.random.key(1), jcfg)
    x = jnp.asarray(np.random.default_rng(1).normal(size=(2, 5, 64)), jnp.float32).astype(dtype)
    want = jffn.ffn(p, jcfg, x)
    mod = _module(tffn.FFN, cfg, jax.tree_util.tree_map(np.asarray, p))
    assert sorted(n for n, _ in mod.named_parameters()) == sorted(p)
    got = mod(_t(x, cfg.compute_dtype))
    assert got.dtype == cfg.compute_dtype
    np.testing.assert_allclose(got.float().numpy(), _np(want), **_layer_tol(dtype, _np(want)))


ATTN_CASES = {
    "mqa-gemma": ("gemma_2b", {}),
    "gqa-qknorm-qwen3": ("qwen3_32b", {}),
    "mha-stablelm": ("stablelm_3b", {}),
    "gqa-windowed": ("qwen3_32b", {"swa_window": 3}),
    "mqa-windowed": ("gemma_2b", {"swa_window": 4}),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_matches_jax(case, dtype):
    arch, kw = ATTN_CASES[case]
    jcfg, cfg = _cfgs(arch, dtype, **kw)
    p = jattn.init_attention(jax.random.key(2), jcfg)
    if jcfg.qk_norm:  # non-zero norm scales, so the norms' gain shows
        p["q_norm"] = jnp.linspace(-0.5, 0.5, jcfg.head_dim, dtype=jnp.float32)
        p["k_norm"] = jnp.linspace(0.3, -0.2, jcfg.head_dim, dtype=jnp.float32)
    x = jnp.asarray(np.random.default_rng(2).normal(size=(2, 10, 64)), jnp.float32).astype(dtype)
    pos = jnp.broadcast_to(jnp.arange(10, dtype=jnp.int32)[None], (2, 10))
    want = jattn.attention(p, jcfg, x, pos)
    mod = _module(tattn.Attention, cfg, jax.tree_util.tree_map(np.asarray, p))
    got = tattn.attention(mod, cfg, _t(x, cfg.compute_dtype),
                          torch.arange(10).expand(2, 10))
    assert got.dtype == cfg.compute_dtype and tuple(got.shape) == (2, 10, 64)
    np.testing.assert_allclose(got.float().numpy(), _np(want), **_layer_tol(dtype, _np(want)))


def _chunked_as_jax_lays_it_out(out, cfg):
    """The port's chunked output (B, S, H, hd) laid out as JAX's
    ``attend_chunked`` returns it: each chunk's (B, KV, G, c, hd) block
    reshaped straight to (B, c, H, hd)."""
    b, s, h, hd = out.shape
    c, kv = cfg.attn_chunk, cfg.n_kv_heads
    blocks = out.reshape(b, s // c, c, kv, h // kv, hd).permute(0, 1, 3, 4, 2, 5)
    return blocks.reshape(b, s, h, hd)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("arch", ["gemma_2b", "qwen3_32b"])
def test_attend_chunked_matches_jax(arch, window):
    """The static triangular loop (attn_chunk 4 over 12 positions) against
    JAX's and against dense scores.  JAX's chunked output is laid out as
    (B, KV, G, c, hd) reshaped to (B, c, H, hd) a chunk, so it disagrees
    with JAX's own dense path; the port's, laid out that way, equals JAX's
    chunked output, and as it returns it equals both dense paths."""
    jcfg, cfg = _cfgs(arch, "float32", attn_chunk=4, swa_window=window)
    rng = np.random.default_rng(3)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = (rng.normal(size=(2, 12, n, hd)).astype(np.float32) for n in (h, kv, kv))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = _np(jattn.attend_chunked(jq, jk, jv, jcfg, chunk=4, window=window))
    want_dense = _np(jattn.attend_full(jq, jk, jv, jcfg))
    assert np.abs(want - want_dense).max() > 0.1  # JAX's layout of the chunks
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tattn.attend_chunked(tq, tk, tv, cfg, chunk=4, window=window)
    np.testing.assert_allclose(_chunked_as_jax_lays_it_out(got, cfg).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_dense, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), tattn.attend_full(tq, tk, tv, cfg).numpy(),
                               rtol=1e-5, atol=1e-5)
    # the layer routes a sequence longer than attn_chunk through it
    jcfg, cfg = _cfgs(arch, "float32", attn_chunk=4, swa_window=window)
    p = jattn.init_attention(jax.random.key(4), jcfg)
    x = rng.normal(size=(2, 12, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    mod = _module(tattn.Attention, cfg, jax.tree_util.tree_map(np.asarray, p))
    got = tattn.attention(mod, cfg, torch.from_numpy(x), torch.from_numpy(pos.copy()))
    want = jattn.attention(p, dataclasses.replace(jcfg, attn_chunk=0), jnp.asarray(x),
                           jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


# -- the model --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_logits_match_jax(jax_params, jax_prefill, arch, dtype):
    _, cfg = _cfgs(arch, dtype)
    tokens = _tokens(1, 2, 9, cfg.vocab)
    want = jax_prefill(arch, dtype, tokens)
    model = _port(jax_params, arch, cfg)
    got = tm.prefill_logits(model, cfg, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])


def test_carried_weights_keep_the_jax_leaves_and_dtypes(jax_params):
    """Every JAX leaf lands in the port once (no ``unembed`` with tied
    embeddings); the tensors the JAX code casts at use are stored cast, the
    norms f32."""
    for arch in ("gemma_2b", "qwen3_32b"):
        _, cfg = _cfgs(arch, "bfloat16")
        tree = jax_params(arch)[1]
        model = _port(jax_params, arch, cfg)
        n_jax = sum(a.size for a in jax.tree_util.tree_leaves(tree))
        assert sum(p.numel() for p in model.parameters()) == n_jax
        assert hasattr(model, "unembed") != cfg.tie_embeddings
        for name, p in model.named_parameters():
            f32 = name.split(".")[-1] in ("norm1", "norm2", "final_norm", "q_norm", "k_norm")
            assert p.dtype == (torch.float32 if f32 else torch.bfloat16), name
        wq = tree["groups"]["0_attn"]["attn"]["wq"][1]
        assert torch.equal(model.layers[1].attn.wq.float(),
                           torch.from_numpy(_np(jnp.asarray(wq).astype(jnp.bfloat16))))


DECODE_CASES = [("gemma_2b", "float32"), ("qwen3_32b", "float32"), ("minitron_4b", "float32"),
                ("stablelm_3b", "float32"), ("gemma_2b", "bfloat16"), ("qwen3_32b", "bfloat16")]


@pytest.mark.parametrize("arch,dtype", DECODE_CASES)
def test_eight_decode_steps_match_jax(jax_params, arch, dtype):
    """f32 against the JAX decode step jitted once, bf16 against its op-by-op
    form; the KV caches too."""
    jcfg, cfg = _cfgs(arch, dtype)
    tokens = _tokens(2, 2, 8, cfg.vocab)
    step = (jax.jit(lambda p, s, tok, pos: jm.decode_step(p, jcfg, s, tok, pos))
            if dtype == "float32" else
            (lambda p, s, tok, pos: jm.decode_step(p, jcfg, s, tok, pos)))
    params = jax_params(arch)[0]
    jstate = jm.init_decode_state(jcfg, 2, 10)
    model = _port(jax_params, arch, cfg)
    tstate = tm.init_decode_state(cfg, 2, 10, device="cpu")
    for pos in range(8):
        want, jstate = step(params, jstate, jnp.asarray(tokens[:, pos:pos + 1]), pos)
        got, tstate = tm.decode_step(model, cfg, tstate, torch.from_numpy(tokens[:, pos:pos + 1]),
                                     pos)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL[dtype])
    for i, st in enumerate(tstate):
        assert st["k"].dtype == cfg.compute_dtype and tuple(st["k"].shape) == (
            2, cfg.n_kv_heads, 10, cfg.head_dim)
        for name in ("k", "v"):
            np.testing.assert_allclose(st[name].float().numpy(),
                                       _np(jstate["groups"]["0_attn"][name][i]), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["gemma_2b", "qwen3_32b"])
def test_decode_matches_full_forward_in_the_port(jax_params, arch, dtype):
    """Decode logits at position t == the full forward's at t (the cache),
    with ``pos`` as an int and as a 0-d tensor."""
    _, cfg = _cfgs(arch, dtype)
    model = _port(jax_params, arch, cfg)
    tokens = torch.from_numpy(_tokens(6, 2, 7, cfg.vocab))
    hidden = ttf.backbone(model, cfg, tokens)
    full = torch.stack([ttf.last_logits(model, cfg, hidden[:, :p + 1]) for p in range(7)], 1)
    for as_tensor in (False, True):
        state = tm.init_decode_state(cfg, 2, 7, device="cpu")
        for pos in range(7):
            at = torch.tensor(pos) if as_tensor else pos
            logits, state = tm.decode_step(model, cfg, state, tokens[:, pos:pos + 1], at)
            np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_ring_cache_matches_full_cache(jax_params, dtype):
    """A window of 4 slots wrapped twice over 8 steps (the JAX package's own
    tier-1 gate, tests/test_decode_optimizations.py)."""
    _, base = _cfgs("gemma_2b", dtype, swa_window=4)
    ring = dataclasses.replace(base, ring_cache=True)
    model = _port(jax_params, "gemma_2b", base)
    tokens = torch.from_numpy(_tokens(8, 2, 8, base.vocab))

    def drive(cfg):
        state = tm.init_decode_state(cfg, 2, 8, device="cpu")
        out = []
        for pos in range(8):
            logits, state = tm.decode_step(model, cfg, state, tokens[:, pos:pos + 1], pos)
            out.append(logits)
        return torch.stack(out, 1).numpy(), state

    full, _ = drive(base)
    got, state = drive(ring)
    assert state[0]["k"].shape[2] == 4
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got, full, **tol)
    np.testing.assert_array_equal(got.argmax(-1), full.argmax(-1))


# -- configs ----------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", DENSE + ["rwkv6_7b"])
def test_configs_and_parameter_counts_match_jax(arch, reduced):
    """Every field the port has equals JAX's, and so do ``n_params`` and
    ``param_count`` (nothing is built)."""
    mine, ref = get_config(arch, reduced=reduced), jax_get_config(arch, reduced=reduced)
    assert dataclasses.asdict(mine) == {f: getattr(ref, f) for f in dataclasses.asdict(mine)}
    assert mine.n_params == ref.n_params == tcommon.param_count(mine) == jcommon.param_count(ref)
    assert arch in PORTED


def test_the_full_configs_build_the_counted_parameters():
    """An `LM` on the meta device (no memory) of each full dense config holds
    ``n_params`` parameters."""
    for arch in DENSE:
        cfg = get_config(arch)
        n = sum(p.numel() for p in ttf.LM(cfg, None, "meta").parameters())
        assert n == cfg.n_params, arch


@pytest.mark.parametrize("arch", ["qwen3_moe_235b", "mixtral_8x22b", "recurrentgemma_9b",
                                  "whisper_medium", "llama32_vision_11b"])
def test_unported_families_refused_by_name(arch):
    """The vlm and encdec archs are refused by name, and so are their
    families on a dense config.  The moe and hybrid archs run; what the port
    leaves out of them is refused by name: ``moe_token_stationary=True`` (a
    GSPMD placement), a context (``img``) and a ``cross`` layer in a hybrid
    pattern."""
    family = jax_get_config(arch, reduced=True)
    if arch in PORTED:
        cfg = get_config(arch, reduced=True)
        assert cfg.family == family.family in ("moe", "hybrid")
        if cfg.family == "moe":
            bad, what = dataclasses.replace(cfg, moe_token_stationary=True), "moe_token_stationary"
        else:
            bad, what = dataclasses.replace(cfg, pattern=("rglru", "cross")), "layer kind 'cross'"
        with pytest.raises(NotImplementedError, match=f"not yet ported: {what}"):
            tm.init_params(bad, 0, device="cpu")
        model = tm.init_params(cfg, 0, device="cpu")
        tokens = torch.ones((1, 2), dtype=torch.int64)
        with pytest.raises(NotImplementedError, match="not yet ported: ctx"):
            tm.prefill_logits(model, cfg, {"tokens": tokens, "img": tokens})
        return
    with pytest.raises(NotImplementedError, match=f"not yet ported: arch '{arch}'"):
        get_config(arch)
    cfg = dataclasses.replace(get_config("gemma_2b", reduced=True), family=family.family,
                              name=family.name)
    with pytest.raises(NotImplementedError, match=f"the '{family.family}' family"):
        tm.init_params(cfg, 0, device="cpu")


# -- training ---------------------------------------------------------------------------
def test_one_f32_train_step_of_gemma_matches_jax(jax_params, tmp_path):
    """Reduced gemma (tied embeddings, GeGLU, MQA) from one carried JAX
    `TrainState` (``jts.init_state``'s: the key-0 masters, zero moments,
    step 0): the loss, ``lr``, ``grad_norm`` and the masters; the port's
    checkpoint of the stepped state has JAX's leaf names (the ``0_attn``
    group) and restores into JAX's trainer bit for bit."""
    opt = dict(warmup_steps=2, total_steps=10)
    jcfg, cfg = _cfgs("gemma_2b", "float32")
    params = jax_params("gemma_2b")[0]
    js = jts.TrainState(params=params, opt=jopt.init(params), step=jnp.zeros((), jnp.int32))
    ts = carry.train_state_from_reference(jax.tree_util.tree_map(np.asarray, js), cfg, "cpu")
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=4).batch(0)
    before = {n: x.numpy().copy() for n, x in ts.params.items()}
    js, jmet = jax.jit(jts.make_train_step(jcfg, jopt.AdamWConfig(**opt)))(
        js, {k: jnp.asarray(v) for k, v in batch.items()})
    ts, tmet = tts.make_train_step(cfg, topt.AdamWConfig(**opt))(
        ts, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-3)

    def port(tree):
        return {n: x.numpy() for n, x in tree.items()}

    def ref(tree):
        return carry._lm_state(jax.tree_util.tree_map(np.asarray, tree), cfg)

    bound = tb.grow({}, topt.AdamWConfig(**opt), float(tmet["lr"]), 1, before,
                    (port(ts.opt.mu), port(ts.opt.nu)), (ref(js.opt.mu), ref(js.opt.nu)))
    assert "unembed" not in ts.params and set(ts.params) == set(ref(js.params))
    assert tb.reading(port(ts.params), ref(js.params), bound) <= 1.0
    assert tb.reading(before, ref(js.params), bound) > 100.0
    ckdir = str(tmp_path / "ck")
    CheckpointManager(ckdir).save(1, ts)
    names = set(np.load(os.path.join(ckdir, "step_0000000001", "arrays_p0.npz")).files)
    assert names == set(jflatten(js))
    restored, meta = JManager(ckdir).restore_latest(js)
    assert meta["step"] == 1
    mine = ref(restored.params)
    assert all(np.array_equal(mine[n], x.numpy()) for n, x in ts.params.items())


# -- the CLIs ---------------------------------------------------------------------------
def test_serve_and_train_clis_run_gemma_on_cpu_and_refuse_a_missing_card(capsys):
    """The CLIs' ``main`` (what ``python -m`` of each module runs, and
    tests/test_torch_rwkv.py and test_torch_train.py run as programs), in
    this process: on the CPU, and refusing a missing card by name."""
    from repro_torch.launch import serve_lm, train

    assert serve_lm.main(["--arch", "gemma_2b", "--device", "cpu", "--tokens", "4",
                          "--batch", "2"]) == 0
    out = capsys.readouterr().out
    assert "arch=gemma_2b batch=2 device=cpu" in out
    assert "sample token ids: [1," in out
    assert train.main(["--arch", "gemma_2b", "--smoke", "--device", "cpu", "--steps", "10",
                       "--seq", "16", "--batch", "4"]) == 0
    out = capsys.readouterr()
    line = [x for x in out.out.splitlines() if x.startswith("step")]
    assert len(line) == 1 and line[0].split()[1] == "10"
    assert np.isfinite(float(line[0].split(" loss ")[1].split()[0]))
    if not torch.cuda.is_available():
        for main, args in ((serve_lm.main, ["--arch", "gemma_2b"]),
                           (train.main, ["--arch", "gemma_2b", "--smoke", "--steps", "1"])):
            with pytest.raises(RuntimeError, match="CUDA was requested"):
                main(args)
