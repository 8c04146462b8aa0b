"""The port's LM placement rules (`repro_torch.launch.sharding`) against the
JAX package's, with no ranks: every leaf of the ten full configs on the
16x16 and 2x16x16 production meshes, fsdp off and on; the batch specs with
``extra_axes`` and ``seq_axes``; the decode-state specs of every family over
`input_specs.decode_specs`.

JAX's parameter specs come from ``repro.launch.sharding._leaf_spec`` on
tests/test_sharding.py's ``FakeMesh``; its batch and decode-state specs
need a mesh a ``NamedSharding`` accepts, a device-free ``AbstractMesh``.
A leaf JAX stacks (the scanned groups, whisper's ``enc`` / ``dec``) is one
layer a tensor in the port: its spec is JAX's without the leading ``None``.
"""
import functools
import os

import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from test_sharding import FakeMesh

from repro.configs import get_config as jax_get_config
from repro.launch import input_specs as jax_inputs
from repro.launch import sharding as jax_sharding
from repro.models import model as jax_model
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import input_specs, mesh as mesh_lib, sharding
from repro_torch.models import model as model_lib

MESHES = {"16x16": False, "2x16x16": True}


def _jax_mesh(multi_pod: bool, abstract: bool = False):
    m = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    if abstract:
        return AbstractMesh(m.sizes, m.axis_names)
    return FakeMesh(m.shape)


@functools.lru_cache(maxsize=None)
def _jax_param_leaves(arch):
    shapes = jax.eval_shape(lambda: jax_model.init_params(jax_get_config(arch),
                                                          jax.random.key(0)))
    return {jax.tree_util.keystr(p): tuple(x.shape)
            for p, x in jax.tree_util.tree_leaves_with_path(shapes)}


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    cfg = get_config(arch)
    model = model_lib.model_class(cfg)(cfg, None, device="meta")
    return cfg, {n: p for n, p in model.named_parameters()}


def test_production_mesh_is_shape_only():
    m = mesh_lib.make_production_mesh()
    assert m.shape == {"data": 16, "model": 16} and m.axis_names == ("data", "model")
    m2 = mesh_lib.make_production_mesh(multi_pod=True)
    assert m2.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh_lib.batch_axes(m) == ("data",) and mesh_lib.batch_axes(m2) == ("pod", "data")


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax(arch, mesh_name, fsdp):
    multi_pod = MESHES[mesh_name]
    jleaves = _jax_param_leaves(arch)
    cfg, params = _port_params(arch)
    specs = sharding.param_shardings(mesh_lib.make_production_mesh(multi_pod=multi_pod),
                                     params, cfg, fsdp=fsdp)
    jmesh = _jax_mesh(multi_pod)
    seen = set()
    for name, (path, stacked) in sharding.leaf_paths(cfg, params).items():
        jshape = jleaves[path]
        assert (jshape[1:] if stacked else jshape) == tuple(params[name].shape), name
        want = tuple(jax_sharding._leaf_spec(jmesh, path, jshape, fsdp=fsdp))
        if stacked:
            assert want[0] is None, (name, want)
            want = want[1:]
        assert specs[name] == want, (name, path, specs[name], want)
        seen.add(path)
    assert seen == set(jleaves)  # every JAX leaf has its port twin


def _cell_batches(arch):
    cfg = get_config(arch)
    jcfg = jax_get_config(arch)
    for name, cell in input_specs.SHAPES.items():
        if cell.kind == "decode":
            continue
        yield (input_specs.batch_specs(cfg, cell),
               jax_inputs.batch_specs(jcfg, jax_inputs.SHAPES[name]))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_equal_jax(arch, mesh_name):
    multi_pod = MESHES[mesh_name]
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    jmesh = _jax_mesh(multi_pod, abstract=True)
    axes = [{}, {"extra_axes": ("model",)}, {"seq_axes": ("model",)},
            {"extra_axes": ("model",), "seq_axes": ("pod",)},
            {"seq_axes": ("data", "model")}]
    n = 0
    for port_batch, jax_batch in _cell_batches(arch):
        assert {k: tuple(v.shape) for k, v in port_batch.items()} == {
            k: tuple(v.shape) for k, v in jax_batch.items()}
        assert all(v.device.type == "meta" for v in port_batch.values())
        for kw in axes:
            got = sharding.batch_shardings(mesh, port_batch, **kw)
            want = jax_sharding.batch_shardings(jmesh, jax_batch, **kw)
            for k in port_batch:
                assert got[k] == tuple(want[k].spec), (k, kw, got[k], want[k].spec)
                n += 1
    assert n >= 3 * len(axes)  # train: tokens, labels; prefill: tokens


@functools.lru_cache(maxsize=None)
def _jax_state_leaves(arch, cell_name):
    jcfg = jax_get_config(arch)
    state, *_ = jax_inputs.decode_specs(jcfg, jax_inputs.SHAPES[cell_name])
    return state


def _port_state_paths(cfg, state):
    """(layer, leaf) -> (JAX keystr, stacked) of the port's decode state."""
    from repro_torch.train.train_step import jax_layer_paths

    paths = jax_layer_paths(cfg)
    out = {}
    for n, layer_state in enumerate(state):
        for leaf in layer_state:
            if cfg.family == "encdec":
                out[n, leaf] = (f"['{leaf}']", n)
            else:
                key, index = paths[f"layers.{n}"]
                out[n, leaf] = (f"{key}['{leaf}']", index)
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_state_specs_equal_jax(arch, mesh_name):
    multi_pod = MESHES[mesh_name]
    cfg = get_config(arch)
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    jmesh = _jax_mesh(multi_pod, abstract=True)
    for cell_name, cell in input_specs.SHAPES.items():
        if cell.kind != "decode" or not input_specs.applicable(cfg, cell_name)[0]:
            continue
        state, token, pos, ctx = input_specs.decode_specs(cfg, cell)
        jstate = _jax_state_leaves(arch, cell_name)
        jspecs = jax_sharding.decode_state_shardings(jmesh, jstate, jax_get_config(arch))
        jleaves = {jax.tree_util.keystr(p): (tuple(x.shape), tuple(s.spec))
                   for (p, x), s in zip(jax.tree_util.tree_leaves_with_path(jstate),
                                        jax.tree_util.tree_leaves(jspecs))}
        got = sharding.decode_state_shardings(mesh, state, cfg)
        assert token.shape == (cell.batch, 1) and pos.shape == () and token.device.type == "meta"
        assert (ctx is None) == (cfg.family not in ("encdec", "vlm"))
        for (n, leaf), (key, index) in _port_state_paths(cfg, state).items():
            jshape, want = jleaves[key]
            shape = tuple(state[n][leaf].shape)
            if index is not None:
                # an rwkv group's tm_last / cm_last: JAX shards the stack
                # axis, which the port's one-layer tensors do not have
                assert jshape[1:] == shape and (want[0] is None or "rwkv" in key), (key, want)
                want = want[1:]
            else:
                assert jshape == shape
            assert got[n][leaf] == want, (cell_name, n, leaf, got[n][leaf], want)
        # the port holds no cache for a vlm cross layer (JAX's is never written)
        port_keys = {key for key, _ in _port_state_paths(cfg, state).values()}
        assert all("cross" in k for k in set(jleaves) - port_keys), set(jleaves) - port_keys


def test_placements_follow_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    m = mesh_lib.make_production_mesh(multi_pod=True)
    assert sharding.placements((("pod", "data"), None, "model"), m) == [
        Shard(0), Shard(0), Shard(2)]
    assert sharding.placements((None, None), m) == [Replicate()] * 3
    with pytest.raises(ValueError, match="axis order"):
        sharding.placements((("model", "data"),), m)
    assert sharding.spec_bytes((64, 32), 4, ("data", "model"), m) == 4 * 4 * 2
    assert sharding.scalar_sharding(m) == ()


def test_device_mesh_refuses_without_ranks():
    with pytest.raises(ValueError, match="torchrun"):
        mesh_lib.device_mesh((2, 1), ("data", "model"), "cpu")
    assert torch.device("meta").type == "meta"


def test_models_import_no_launch_layer():
    """The models run placed tensors through `repro_torch.models.placed` and
    import nothing of the launch layer, which sits above them."""
    import subprocess
    import sys

    code = ("import sys; import repro_torch.models.model, repro_torch.models.moe, "
            "repro_torch.models.rwkv6, repro_torch.models.attention; "
            "print(sorted(m for m in sys.modules if m.startswith(('repro_torch.launch', "
            "'repro_torch.train', 'repro_torch.checkpoint'))))")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=src), check=True).stdout
    assert out.strip() == "[]", out
