"""The port's dry run (`repro_torch.launch.dryrun`, `dryrun_ising`,
`repro_torch.hlo`) against the JAX package's arithmetic, and the pieces it
stands on: shape-only construction on ``meta``, the kernels' ``meta``
paths and ``remat_policy="dots"``.

``tests/_torch_dryrun_child.py delta`` runs once a module (a fake process
group; no JAX): reduced configs at (2, 2), each cell's counts composed by
the delta method beside a full-depth run, and a Shard -> Shard
redistribution's count.

Tolerances: the roofline arithmetic (`model_flops`, `analytic_hbm_bytes`,
`hbm_bytes_per_cell_sweep`) equal to JAX's exactly, its terms equal to
JAX's times the constants' ratio within 1e-12 relative (one f64 division
each); the delta-composed counts equal to the full depth's exactly (sums
of integers); ``remat_policy="dots"`` gradients equal to ``"full"``'s bit
for bit (a recomputed value is the saved one) and to JAX's ``"dots"``
within the f32 tolerance of tests/test_torch_train.py (5e-3 of each leaf's
largest value, the loss 1e-5 relative).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.hlo import roofline as jroof  # noqa: E402
from repro.hlo import traffic as jtraffic  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM  # noqa: E402
from repro_torch.hlo import roofline as roof  # noqa: E402
from repro_torch.hlo import traffic  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import input_specs as ispec  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

HERE = os.path.dirname(__file__)
sys.path.insert(0, HERE)

import _torch_dryrun_child as child  # noqa: E402


@pytest.fixture(scope="module")
def delta(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, os.path.join(HERE, "_torch_dryrun_child.py"),
                           "delta", str(outdir)], env=env, capture_output=True, text=True,
                          timeout=400)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-8000:]
    with open(outdir / "delta.json") as f:
        return json.load(f)


# -- the roofline arithmetic ------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_analytic_bytes_equal_jax(arch):
    """Every shape's kind, batch and sequence on both production meshes:
    `model_flops` and `analytic_hbm_bytes` of the port's config equal
    JAX's of its own."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for cell in ispec.SHAPES.values():
        assert (roof.model_flops(cfg, cell.kind, cell.batch, cell.seq)
                == jroof.model_flops(jcfg, cell.kind, cell.batch, cell.seq))
        for multi in (False, True):
            sizes = make_production_mesh(multi_pod=multi).shape
            n_model = sizes["model"]
            n_batchpar = int(np.prod(list(sizes.values()))) // n_model
            args = (cell.kind, cell.batch, cell.seq, n_model, n_batchpar)
            assert (roof.analytic_hbm_bytes(cfg, *args)
                    == jroof.analytic_hbm_bytes(jcfg, *args)), (cell.name, multi)


def test_hbm_bytes_per_cell_sweep_equals_jax():
    for fused in (False, True):
        for spi in (1, 2, 7, 100):
            for rounds in (1, 3):
                for state, plane in ((2.0, 8.0), (2.0, 16.0), (0.25, 8.0)):
                    kw = dict(fused=fused, sweeps_per_interval=spi, rounds_per_launch=rounds,
                              state_bytes=state, uniform_plane_bytes=plane)
                    assert (traffic.hbm_bytes_per_cell_sweep(**kw)
                            == jtraffic.hbm_bytes_per_cell_sweep(**kw))
    for bad in (dict(sweeps_per_interval=0), dict(rounds_per_launch=0)):
        with pytest.raises(ValueError):
            traffic.hbm_bytes_per_cell_sweep(fused=True, **bad)


@pytest.mark.parametrize("values", [(1e15, 2e11, 3e9, 5e17, 256, 1e11),
                                    (4e12, 9e10, 0.0, 1e15, 512, 7e10),
                                    (1e9, 5e12, 8e11, 2e14, 256, 0.0)])
def test_roofline_terms_scale_by_the_constants(values):
    """The port's `Roofline` is JAX's with H100 constants: each term is
    JAX's times the ratio of the constants (the collective term, with no
    per-axis seconds given, at the NIC's rate), and the derived readings
    keep JAX's definitions."""
    mine, theirs = roof.Roofline(*values).row(), jroof.Roofline(*values).row()
    ratio = {"t_comp_s": jroof.PEAK_FLOPS / roof.PEAK_FLOPS,
             "t_mem_s": jroof.HBM_BW / roof.HBM_BW,
             "t_mem_analytic_s": jroof.HBM_BW / roof.HBM_BW,
             "t_coll_s": jroof.ICI_BW / roof.NIC_BW}
    for key, r in ratio.items():
        np.testing.assert_allclose(mine[key], theirs[key] * r, rtol=1e-12, atol=0)
    r = roof.Roofline(*values)
    assert mine["bound_time_s"] == max(r.t_comp, r.t_mem, r.t_coll)
    assert mine["fraction_of_roofline"] == (r.t_comp / r.bound_time if r.bound_time else 0.0)
    assert mine["mfu_bound"] == r.model_flops_global / (r.n_devices * roof.PEAK_FLOPS
                                                         * r.bound_time)
    assert roof.Roofline(*values, coll_seconds=1.5).t_coll == 1.5


def test_links_of_the_mesh_axes():
    """Row-major ranks, 8 GPUs a node: an axis whose groups fit in a node
    is NVLink's, any other the NIC's; the production meshes cross nodes on
    every axis."""
    nic, nvl = ("nic", roof.NIC_BW), ("nvlink", roof.NVLINK_BW)
    assert roof.axis_links(("data", "model"), (16, 16)) == {"data": nic, "model": nic}
    assert roof.axis_links(("pod", "data", "model"), (2, 16, 16)) == dict.fromkeys(
        ("pod", "data", "model"), nic)
    assert roof.axis_links(("data", "model"), (2, 4)) == {"data": nvl, "model": nvl}
    assert roof.axis_links(("data", "model"), (4, 8)) == {"data": nic, "model": nvl}
    assert roof.axis_links(("data", "model"), (1, 2)) == {"data": nvl, "model": nvl}
    assert roof.collective_seconds({"data": 5e10, "model": 9e11}, ("data", "model"),
                                   (4, 8)) == 1.0 + 2.0


# -- the dry run on a fake group --------------------------------------------------------
@pytest.mark.parametrize("cell", [f"{a}/{k}" for a, (_, kinds) in child.DELTA.items()
                                  for k in kinds])
def test_delta_composed_counts_equal_full_depth(delta, cell):
    """A reduced config at (2, 2), deeper than its base by at least two
    layer groups: the base and plus-one-group runs composed give the full
    depth's flops, unfused bytes and collective payload, wire bytes and
    bytes by mesh axis exactly."""
    rec = delta[cell]
    assert all(n >= 2 for n in rec["groups"].values()), rec["groups"]
    assert rec["full"]["flops"] > 0 and rec["full"]["collective_wire_bytes"] > 0
    for field, value in rec["full"].items():
        assert rec["composed"][field] == value, field
    if cell.startswith("rwkv6_7b/train"):  # #7 and #7b report their work on meta
        assert rec["kernels"]["wkv6"]["calls"] == rec["kernels"]["wkv6_bwd"]["calls"] == 3


def test_shard_to_shard_is_counted_as_an_all_to_all(delta):
    """Shard(0) -> Shard(1) of a (4, 6) f32 block a rank over a 2-rank
    axis: on a ``cuda`` mesh DTensor's all-to-all, (g - 1) / g of its 96
    input bytes; on a ``cpu`` mesh its fallback, an all-gather, (g - 1)
    times them."""
    assert delta["shard_to_shard/cuda"] == {"calls": {"all_to_all_single": 1},
                                            "bytes": {"all_to_all_single": 48},
                                            "axes": ["data"]}
    assert delta["shard_to_shard/cpu"] == {"calls": {"all_gather_into_tensor": 1},
                                           "bytes": {"all_gather_into_tensor": 96},
                                           "axes": ["data"]}


def test_ising_interval_dry_run(delta):
    """The paper's interval at a small size on 4 fake ranks: kernel A's
    sweeps and the standalone exchange report their work on meta, the two
    row gathers are counted, and state mode is refused by the engine."""
    rec = delta["ising/temp"]
    assert rec["kernels"]["ising_fused"]["calls"] == 1
    assert rec["kernels"]["ising_fused"]["flops"] == 3 * 8 * 8 * 2
    assert rec["kernels"]["exchange_step"]["calls"] == 1
    assert rec["coll_count"] == 2 and rec["coll_gathered_bytes"] == 12 * (4 + 4)
    assert rec["coll_wire_bytes"] == 3 * rec["coll_payload_bytes"]
    assert "not supported across a sharded replica axis" in delta["ising/state"]["skipped"]


# -- shape-only construction and the kernels' meta paths ------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_state_on_meta_equals_the_cpu_state(arch):
    """`init_state(device="meta")` (no generator drawn) and `init_params`
    on ``meta`` give the CPU tree's names, shapes and dtypes."""
    cfg = get_config(arch, reduced=True)
    cpu, meta = ts.init_state(cfg, 0, device="cpu"), ts.init_state(cfg, 0, device="meta")

    def sig(tree):
        return {n: (tuple(p.shape), p.dtype) for n, p in tree.items()}

    for tree in ("params", "mu", "nu"):
        a = cpu.params if tree == "params" else getattr(cpu.opt, tree)
        b = meta.params if tree == "params" else getattr(meta.opt, tree)
        assert sig(a) == sig(b), tree
        assert all(p.is_meta for p in b.values())
    assert meta.step.is_meta and meta.step.dtype == cpu.step.dtype
    assert meta.jax_paths == cpu.jax_paths
    model = tm.init_params(cfg, 0, device="meta")
    assert sig(dict(model.named_parameters())) == sig(
        dict(tm.init_params(cfg, 0, device="cpu").named_parameters()))


def test_meta_wkv6_returns_the_contract_and_never_the_plain_version(monkeypatch):
    """`ops.wkv6` on ``meta``: outputs (BH, T, dv) and (BH, dk, dv) f32,
    gradients of the inputs' shapes, #7's and #7b's work reported once
    each by their bound formulas; the plain recurrence never runs."""
    def refuse(*a, **k):
        raise AssertionError("the plain recurrence ran on meta")

    monkeypatch.setattr(ref, "wkv6", refuse)
    bh, t, dk, dv = 6, 5, 64, 64
    got = []
    build.meta_sinks.append(lambda kernel, **work: got.append((kernel, work)))
    try:
        x = [torch.empty(bh, t, dk, device="meta", requires_grad=True) for _ in range(4)]
        u = torch.empty(bh, dk, device="meta", requires_grad=True)
        s0 = torch.empty(bh, dk, dv, device="meta", requires_grad=True)
        o, state = ops.wkv6(*x, u, s0)
        (o.sum() + state.sum()).backward()
    finally:
        build.meta_sinks.pop()
    assert (o.shape, state.shape) == ((bh, t, dv), (bh, dk, dv))
    assert o.dtype == state.dtype == torch.float32
    assert [p.grad.shape for p in (*x, u, s0)] == [(bh, t, dk)] * 4 + [(bh, dk), (bh, dk, dv)]
    flops, n_bytes = ops.wkv6_work(bh, t, dk, dv, True)
    bflops, bbytes = ops.wkv6_bwd_work(bh, t, dk, dv, True)
    assert got == [("wkv6", {"flops": flops, "int_ops": 0.0, "n_bytes": n_bytes}),
                   ("wkv6_bwd", {"flops": bflops, "int_ops": 0.0, "n_bytes": bbytes})]
    assert flops == bh * t * (4 * dk * dv + 3 * dk + 2 * dv)
    assert all(v == 0 for v in build.launches.values())


# -- remat_policy="dots" ----------------------------------------------------------------
def _grads(cfg, params, batch):
    leaves = {n: p.detach().clone().requires_grad_() for n, p in params.items()}
    loss = tm.forward_loss(ttf.LM(cfg, None, "meta"), cfg,
                           {k: torch.from_numpy(v) for k, v in batch.items()},
                           params=ts.cast_params(cfg, leaves))
    return loss, dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def _mm_calls(cfg, params, batch) -> int:
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._overloadpacket in (torch.ops.aten.mm, torch.ops.aten.bmm):
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        _grads(cfg, params, batch)
    return Count.n


def test_remat_dots_equals_full_and_jax():
    """Reduced rwkv6-7b in f32 from JAX's initial state: the gradients
    under ``remat_policy="dots"`` equal ``"full"``'s bit for bit with fewer
    products run (the saved ones are not recomputed), and JAX's under its
    ``"dots"`` (``dots_with_no_batch_dims_saveable``) within tolerance."""
    jcfg = dataclasses.replace(jax_get_config("rwkv6_7b", reduced=True), dtype="float32",
                               remat=True, remat_policy="dots")
    cfg = dataclasses.replace(get_config("rwkv6_7b", reduced=True), dtype="float32", remat=True)
    jstate = jts.init_state(jcfg, jax.random.key(0))
    state = carry.train_state_from_reference(jax.tree_util.tree_map(np.asarray, jstate), cfg,
                                             "cpu")
    batch = SyntheticLM(vocab=512, seq_len=16, global_batch=2).batch(0)
    full_loss, full = _grads(cfg, state.params, batch)
    dots_cfg = dataclasses.replace(cfg, remat_policy="dots")
    loss, dots = _grads(dots_cfg, state.params, batch)
    assert torch.equal(loss, full_loss)
    for n, g in dots.items():
        assert torch.equal(g, full[n]), n
    assert _mm_calls(dots_cfg, state.params, batch) < _mm_calls(cfg, state.params, batch)

    def loss_fn(p):
        p = jax.tree_util.tree_map(lambda x: x.astype(jcfg.compute_dtype) if x.ndim >= 2 else x,
                                   p)
        return jm.forward_loss(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})

    jl, jg = jax.value_and_grad(loss_fn)(jstate.params)
    jg = carry._lm_state(jax.tree_util.tree_map(np.asarray, jg), cfg)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for n, g in dots.items():
        scale = max(float(np.abs(jg[n]).max()), 1e-30)
        assert float(np.abs(g.numpy() - jg[n]).max()) / scale <= 5e-3, n
