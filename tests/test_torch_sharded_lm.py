"""The port's LM placement layer (`repro_torch.launch.sharding` over
DTensor) on 4 gloo ranks, against the unsharded port and the JAX package.

``tests/_torch_sharded_child.py`` (4 ranks, imports no JAX) and
``tests/_jax_sharded_child.py`` (4 forced host devices) run once a module,
side by side.  Reduced configs in f32.

Tolerances (f32; a placed run sums in another order: the model axis
splits the contractions, the data axis the batch reductions):

* prefill and decode logits: within 2e-5 of the unsharded port's
  (|logits| < 8; they read up to ~5e-6); greedy tokens and every MoE
  routing (``expert_idx`` of each call) equal;
* after a training step: masters within 1e-4 (one AdamW step moves a
  weight by up to lr = 3e-4, and by a share of it that rounding can shift
  where a gradient is near ``eps``), each moment leaf within 1e-4 of its
  largest magnitude (its gradients are sums over the batch in another
  order), the loss within 1e-6 relative;
* PT-LM on ``MeshSpec(1, 2)``: tokens, rungs and swap counters equal to
  JAX's mesh run, energies within 8 ulps of their magnitude.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_sharded_child as child  # noqa: E402

from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

LOGITS_ATOL = 2e-5
MASTERS_ATOL = 1e-4
ULPS = 8
HERE = os.path.dirname(__file__)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One run of each child (the JAX one beside the port's), and the
    unsharded port's runs, made here while they work; returns (port
    outputs, JAX outputs, unsharded runs)."""
    outdir = tmp_path_factory.mktemp("sharded")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, script), str(outdir)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for script in ("_jax_sharded_child.py", "_torch_sharded_child.py")]
    refs = _unsharded_runs()
    for proc in procs:
        text, _ = proc.communicate(timeout=400)
        assert proc.returncode == 0, f"{proc.args[1]} failed\n{text[-8000:]}"
    return dict(np.load(outdir / "torch.npz")), dict(np.load(outdir / "jax.npz")), refs


def _unsharded_runs() -> dict:
    from repro_torch.launch import serve_lm

    refs = {}
    for name, (arch, _, kw) in child.SERVE.items():
        refs[name] = _unsharded_serve(arch, kw)
        cfg = refs[name][0]
        refs[f"{name}_train"] = child.train(ts.init_state(cfg, 0, device="cpu"), cfg, 1)[0]
    cfg = child.config("gemma_2b")
    refs["train_mb2"] = child.train(ts.init_state(cfg, 0, device="cpu"), cfg,
                                    child.TRAIN_STEPS, microbatches=2)
    refs["generate"] = serve_lm.generate(model_lib.init_params(cfg, 0, device="cpu"), cfg,
                                         child.B, child.DECODE, "cpu")
    return refs


def _unsharded_serve(arch, kw):
    cfg = child.config(arch, **kw)
    log: list = []
    inner = child._record_routing(log)
    try:
        got = child.serve(model_lib.init_params(cfg, 0, device="cpu"), cfg)
    finally:
        moe.dispatch = inner
    routing = torch.cat([x.reshape(-1) for x in log]).numpy() if log else None
    return cfg, got, routing


@pytest.mark.parametrize("name", list(child.SERVE))
def test_placed_serving_equals_unsharded(runs, name):
    """Prefill, 4 greedy decode steps and the routing of a placed model ==
    the unsharded port's; every rank's blocks have its spec's shapes."""
    out, _, refs = runs
    cfg, (pre, dec, tok), routing = refs[name]
    assert bool(out[f"{name}_blocks_ok"])
    np.testing.assert_allclose(out[f"{name}_prefill"], pre, rtol=0, atol=LOGITS_ATOL)
    np.testing.assert_allclose(out[f"{name}_decode"], dec, rtol=0, atol=LOGITS_ATOL)
    assert np.array_equal(out[f"{name}_tokens"], tok)
    if cfg.family == "moe":
        assert np.array_equal(out[f"{name}_routing"], routing)
    assert np.abs(pre).max() < 8 and np.abs(dec).max() < 8


def test_generate_on_a_mesh_equals_unsharded(runs):
    """`serve_lm.generate(mesh=)` on (2, 2): the decode state and tokens
    placed, each rank sampling from the gathered logits; the tokens equal
    the unsharded loop's."""
    out, _, refs = runs
    assert np.array_equal(out["generate_tokens"], refs["generate"].numpy())


@pytest.mark.parametrize("name", list(child.SERVE))
def test_placed_train_step_equals_unsharded(runs, name):
    """One training step with the masters and moments in the FSDP layout
    (``cast_shardings`` / ``grad_shardings``) == the unsharded step."""
    out, _, refs = runs
    for n, p in refs[f"{name}_train"].params.items():
        np.testing.assert_allclose(out[f"{name}_train.{n}"], p.numpy(), rtol=0,
                                   atol=MASTERS_ATOL, err_msg=n)


def _close(tree, got, want, msg):
    """Masters within MASTERS_ATOL; a moment leaf within 1e-4 of its
    largest magnitude."""
    atol = MASTERS_ATOL if tree == "params" else 1e-4 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=msg)


def _jax_leaf(cfg, name):
    from repro_torch.models.jax_tree import tree_names

    key, index = tree_names("", [name], ts.jax_layer_paths(cfg))[name]
    return key, index


def test_train_step_equals_jax_gspmd(runs):
    """2 steps of reduced gemma on (2, 2) from JAX's initial state == JAX's
    GSPMD step on a (2, 2) mesh: masters, mu, nu and the losses."""
    out, jout, _ = runs
    name = "train_jax_2x2"
    cfg = child.config("gemma_2b")
    np.testing.assert_allclose(out[f"{name}_loss"], jout["train_loss"], rtol=1e-6, atol=0)
    names = [k[len(name) + len("_params."):] for k in out if k.startswith(f"{name}_params.")]
    assert names
    for n in names:
        key, index = _jax_leaf(cfg, n)
        for tree in ("params", "mu", "nu"):
            want = jout[f"train_{tree}{key}"]
            want = want if index is None else want[index]
            _close(tree, out[f"{name}_{tree}.{n}"], want, f"{tree} {n}")


def test_microbatched_train_step_equals_unsharded(runs):
    out, _, refs = runs
    name = "train_mb2_2x1"
    state, losses = refs["train_mb2"]
    np.testing.assert_allclose(out[f"{name}_loss"], losses, rtol=1e-6, atol=0)
    for tree, got in (("params", state.params), ("mu", state.opt.mu), ("nu", state.opt.nu)):
        for n, p in got.items():
            _close(tree, out[f"{name}_{tree}.{n}"], p.numpy(), f"{tree} {n}")


def _spec_arithmetic(shape):
    """A training step's bytes a rank sends, from the specs: each leaf's
    cast from its FSDP block to its TP block is an all-gather over 'data'
    ((D - 1) FSDP blocks), and its gradient's return a reduce-scatter
    ((D - 1) / D of the TP block): equal per leaf.  f32 config, so 4-byte
    items."""
    cfg = child.config("gemma_2b")
    params = dict(model_lib.model_class(cfg)(cfg, None, device="meta").named_parameters())
    mesh = mesh_lib.ShapeMesh(("data", "model"), shape)
    tp = sharding.param_shardings(mesh, params, cfg)
    fsdp = sharding.param_shardings(mesh, params, cfg, fsdp=True)
    d = shape[0]
    total = 0
    for n, p in params.items():
        if "data" in fsdp[n]:
            total += (d - 1) * sharding.spec_bytes(p.shape, 4, fsdp[n], mesh)
    return total


@pytest.mark.parametrize("name", list(child.TRAIN))
def test_collective_bytes_equal_spec_arithmetic(runs, name):
    """The counted ``cast`` all-gathers and ``grads`` reduce-scatters over
    'data' of the training steps == `_spec_arithmetic` times the casts (a
    step's microbatches each cast); the cast moves nothing over 'model',
    and no gradient is all-gathered over 'data'.  (On (2, 2) a gradient
    that the TP products left partial or differently split over 'model' is
    brought to its TP layout there first, in ``grads`` too.)"""
    out, _, _ = runs
    shape, mb, _ = child.TRAIN[name]
    want = _spec_arithmetic(shape) * child.TRAIN_STEPS * mb
    assert want > 0
    assert int(out[f"{name}_bytes.cast.all_gather_into_tensor.data"]) == want
    assert int(out[f"{name}_bytes.grads.reduce_scatter_tensor.data"]) == want
    assert not [k for k in out if k.startswith(f"{name}_bytes.cast.")
                and not k.endswith("all_gather_into_tensor.data")]
    assert f"{name}_bytes.grads.all_gather_into_tensor.data" not in out


def test_ptlm_on_the_mesh_equals_jax_mesh_run(runs):
    """PT over reduced gemma sequences on ``MeshSpec(1, 2)``: each rank
    steps its 2 replicas from its first slot's key, as JAX's sharded
    interval; tokens, rungs and swap counters equal, energies in ulps."""
    out, jout, _ = runs
    for f in ("states", "rung", "attempts", "accepts"):
        assert np.array_equal(out[f"ptlm_{f}"], jout[f"ptlm_{f}"]), f
    got, want = out["ptlm_energy"].astype(np.float64), jout["ptlm_energy"].astype(np.float64)
    assert np.max(np.abs(got - want) / np.spacing(np.abs(want).astype(np.float32))) <= ULPS


def test_placed_model_refuses_plain_inputs_and_misplaced_masters(runs):
    """A placed model's entry points take the caller's batch placed (a plain
    one would count as replicated whatever each rank holds), and a placed
    train step takes masters placed under its ``grad_shardings``: each
    otherwise raises ValueError naming the fix."""
    out, _, _ = runs
    assert bool(out["refused_plain_batch"])
    assert bool(out["refused_masters_layout"])


def test_token_stationary_and_cast_shardings_run_unplaced():
    """Off a mesh ``moe_token_stationary=True`` changes nothing, and
    ``cast_shardings`` / ``grad_shardings`` need placed masters."""
    cfg = child.config("qwen3_moe_235b")
    ts_cfg = child.config("qwen3_moe_235b", moe_token_stationary=True)
    model = model_lib.init_params(cfg, 0, device="cpu")
    batch = {"tokens": torch.from_numpy(child.prompt())}
    with torch.no_grad():
        assert torch.equal(model_lib.prefill_logits(model, cfg, batch),
                           model_lib.prefill_logits(model, ts_cfg, batch))
    state = ts.init_state(cfg, 0, device="cpu")
    spec = {n: (None,) * p.dim() for n, p in state.params.items()}
    step = ts.make_train_step(cfg, child.opt_config(), cast_shardings=spec, grad_shardings=spec)
    with pytest.raises(ValueError, match="place_state"):
        step(state, {k: torch.from_numpy(v) for k, v in child.train_batch().items()})


def test_eager_collectives_equal_the_functional_ones(runs):
    """gemma on (2, 2) with `comm.eager_collectives` (the functional
    collectives through gloo's eager ones, as ranks sharing a card run them)
    == the same run through the functional collectives: logits, tokens and
    masters equal, and the cast all-gather counted the same."""
    out, _, _ = runs
    name = "gemma_2x2"
    for k in ("prefill", "decode", "tokens"):
        assert np.array_equal(out[f"eager_{k}"], out[f"{name}_{k}"]), k
    for key in [k for k in out if k.startswith(f"{name}_train.")]:
        assert np.array_equal(out["eager_train." + key.split(".", 1)[1]], out[key]), key
    assert int(out["eager_cast_bytes"]) == _spec_arithmetic((2, 2))
