"""Multi-pod dry run: every (arch x shape x mesh) cell's program on ``meta``
tensors over a fake 256- or 512-rank process group (twin of
`repro.launch.dryrun`).

No rank, device or byte of data exists: the process joins a ``"fake"``
process group (`torch.testing._internal.distributed.fake_pg.FakeStore`) of
the production mesh's size as rank 0, builds the 16 x 16 or 2 x 16 x 16
`DeviceMesh` over it, places the model, batch and decode state as DTensors
of ``meta`` tensors under `repro_torch.launch.sharding`'s rules, and runs
the real entry points (`model.prefill_logits`, `model.decode_step`, the
training step with ``cast_shardings`` / ``grad_shardings``).  DTensor
issues the collectives a rank would issue, and `repro_torch.hlo.traffic.
OpTally` counts them (`repro_torch.launch.comm.CollectiveCounter`'s rule,
which a real run on ranks reads too), every local op's flops and unfused
bytes, and the kernels' work (#7 and #7b report theirs on ``meta``).  So
the tool runs on a laptop, one cell a spawned process (``--jobs`` of them
side by side).

Per cell:
  * delta-method runs (``delta_axes``: a base depth and one layer group
    more) give the per-rank counts of the full depth exactly: every group
    adds the same work (`compose`);
  * ``--full`` also runs the whole depth (the compile proof's twin) with the
    training step's microbatches, and reads its memory: the argument bytes
    are the rank's blocks of every input, exactly; the peak is
    `torch.distributed._tools.mem_tracker.MemTracker`'s, where it runs;
  * records land in results/dryrun_torch/<arch>--<shape>--<mesh>--<variant>.json
    with JAX's keys (`repro.launch.dryrun`), the roofline on the H100
    constants of `repro_torch.hlo.roofline`.

The mesh is built with device type ``cuda``, as the card's ranks build
theirs: DTensor then issues a Shard -> Shard redistribution as one
all-to-all (on a ``cpu`` mesh, as an all-gather and a chunk, which is what
ranks over gloo on CPUs run: `fake_mesh` builds either).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3_32b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
  ... --override attn_chunk=4096 --variant chunk4k     (variants)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.hlo.collectives import collective_stats
from repro_torch.hlo.roofline import (Roofline, analytic_hbm_bytes, axis_links,
                                      collective_seconds, model_flops)
from repro_torch.hlo.traffic import OpTally
from repro_torch.launch import input_specs as ispec
from repro_torch.launch import sharding as shard_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as model_lib
from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig

__all__ = ["delta_axes", "fake_group", "fake_mesh", "placed_model", "placed_state",
           "measure", "lower_one", "run_cell", "compose", "main"]

OUT_DIR = "results/dryrun_torch"
# Saved layer inputs a rank may hold for the backward pass before the full
# run splits the batch into microbatches: a quarter of an H100's 80 GB
RESIDUAL_BUDGET = 20e9


# ---------------------------------------------------------------------------
# reduced-layer configs for the delta method
# ---------------------------------------------------------------------------
def delta_axes(cfg: ModelConfig) -> dict[str, tuple[int, int, int]]:
    """axis -> (full, base, step) layer counts."""
    if cfg.family == "encdec":
        return {
            "n_layers": (cfg.n_layers, 1, 1),
            "enc_layers": (cfg.enc_layers, 1, 1),
        }
    plen = len(transformer.layer_pattern(cfg))
    tail = cfg.n_layers % plen
    return {"n_layers": (cfg.n_layers, plen + tail, plen)}


def _with_layers(cfg: ModelConfig, **counts) -> ModelConfig:
    return dataclasses.replace(cfg, **counts)


def _microbatches(cfg, cell, sizes: dict) -> int:
    """The full run's microbatch count: the saved layer inputs (one (B_loc,
    S, D) bf16 tensor a layer) within RESIDUAL_BUDGET a rank; a power of
    two, so it divides the global batch."""
    n_batchpar = 1
    for axis, n in sizes.items():
        n_batchpar *= n if axis != "model" else 1
    b_loc = max(cell.batch // n_batchpar, 1)
    n_layers = cfg.n_layers + (cfg.enc_layers or 0)
    res_bytes = n_layers * b_loc * cell.seq * cfg.d_model * 2
    m = 1
    while res_bytes / m > RESIDUAL_BUDGET and m < cell.batch:
        m *= 2
    return m


# ---------------------------------------------------------------------------
# the fake group and its mesh
# ---------------------------------------------------------------------------
_MESHES: dict = {}


def fake_group(world: int) -> None:
    """This process as rank 0 of a ``"fake"`` process group of ``world``
    ranks (one of another size is ended first).  Collectives on it move
    nothing and return at once."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
        _MESHES.clear()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def fake_mesh(shape: tuple, names: tuple, device_type: str = "cuda"):
    """A `DeviceMesh` of ``shape`` named ``names`` (row-major ranks) over a
    fake group of its size; built once a process.  Only rank 0's group
    along each mesh dim is made (``DeviceMesh.from_group``): the fake rank
    0 is the only process, and making all of them takes minutes at 512."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape, names = tuple(shape), tuple(names)
    n = 1
    for s in shape:
        n *= s
    fake_group(n)
    key = (shape, names, device_type)
    if key not in _MESHES:
        ranks = torch.arange(n).reshape(shape)
        groups = []
        for d in range(len(shape)):
            line = [0] * len(shape)
            line[d] = slice(None)
            groups.append(dist.new_group(ranks[tuple(line)].flatten().tolist(),
                                         use_local_synchronization=True))
        _MESHES[key] = DeviceMesh.from_group(groups, device_type, mesh=ranks,
                                             mesh_dim_names=names)
    return _MESHES[key]


def production_mesh(multi_pod: bool):
    shape = make_production_mesh(multi_pod=multi_pod)
    return fake_mesh(shape.sizes, shape.axis_names)


# ---------------------------------------------------------------------------
# placed inputs
# ---------------------------------------------------------------------------
def _serve_dtype(model: torch.nn.Module) -> torch.nn.Module:
    """Serving holds bf16 weights: every f32 parameter of two or more dims
    becomes bf16 (JAX's ``_serve_dtype``)."""
    for p in model.parameters():
        if p.dtype == torch.float32 and p.dim() >= 2:
            p.data = p.data.to(torch.bfloat16)
    return model


def placed_model(cfg: ModelConfig, mesh, serve_dtype: bool = True, device="meta"):
    """The family's module on ``device`` (``meta``: shapes only), its
    parameters placed under ``param_shardings``."""
    model = model_lib.init_params(cfg, 0, device=device)
    if serve_dtype:
        _serve_dtype(model)
    return shard_lib.place_module(model, shard_lib.param_shardings(mesh, model, cfg), mesh)


def placed_state(cfg: ModelConfig, mesh, device="meta"):
    """(training state placed under the FSDP specs, the step's
    ``cast_shardings``, its ``grad_shardings``)."""
    from repro_torch.train import train_step as ts

    state = ts.init_state(cfg, 0, device=device)
    fsdp = shard_lib.param_shardings(mesh, state.params, cfg, fsdp=True)
    cast = shard_lib.param_shardings(mesh, state.params, cfg)
    return ts.place_state(state, fsdp, mesh), cast, fsdp


def local_bytes(tree) -> int:
    """The bytes of a rank's blocks of every tensor of ``tree``."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, torch.nn.Module):
        return local_bytes(list(tree.parameters()))
    if isinstance(tree, torch.Tensor):
        x = tree.to_local() if isinstance(tree, DTensor) else tree
        return x.numel() * x.element_size()
    if dataclasses.is_dataclass(tree):
        return sum(local_bytes(getattr(tree, f.name)) for f in dataclasses.fields(tree)
                   if f.name != "jax_paths")
    return 0


def measure(fn, mesh, memory: bool = False) -> tuple:
    """(output, counts) of ``fn()`` under an `OpTally` on ``mesh``: the
    flops, unfused bytes, kernels' work and collectives a rank runs, and,
    with ``memory``, the peak bytes `MemTracker` reads ("not measured"
    where it cannot run)."""
    tally = OpTally(mesh)
    peak = "not measured"
    t0 = time.perf_counter()
    if memory:
        try:
            from torch.distributed._tools.mem_tracker import MemTracker

            tracker = MemTracker()
            with tracker, tally:
                out = fn(tally)
            peak = max(sum(v.values()) for v in tracker.get_tracker_snapshot("peak").values())
        except Exception as e:  # noqa: BLE001  the tracker's limits, not the program's
            peak = f"not measured ({type(e).__name__}: {e})"[:200]
            tally = OpTally(mesh)
            with tally:
                out = fn(tally)
    else:
        with tally:
            out = fn(tally)
    seconds = time.perf_counter() - t0
    coll = collective_stats(tally)
    return out, {
        "flops": tally.flops,
        "bytes_accessed": tally.unfused_bytes,
        "hbm_traffic_bytes": tally.unfused_bytes,
        "collective_payload_bytes": coll.payload_bytes,
        "collective_wire_bytes": coll.wire_bytes,
        "collective_by_op": coll.by_op,
        "collective_count": coll.count,
        "collective_by_axis": coll.by_axis,
        "collective_by_phase": coll.by_phase,
        "kernels": {k: dict(v) for k, v in tally.kernels.items()},
        "peak_bytes": peak,
        "lower_s": seconds,
    }


# ---------------------------------------------------------------------------
# the programs
# ---------------------------------------------------------------------------
_BATCH_EXTRA_AXES: tuple = ()  # --batch-axes dpmodel: the model axis folded into the batch
_SEQ_AXES: tuple = ()  # --batch-axes dpmodel_sp: the sequence over 'pod' (context parallel)


def _place_batch(batch: dict, mesh) -> dict:
    specs = shard_lib.batch_shardings(mesh, batch, extra_axes=_BATCH_EXTRA_AXES,
                                      seq_axes=_SEQ_AXES)
    return shard_lib.place(batch, specs, mesh)


def _train(cfg, cell, mesh, microbatches: int):
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts

    state, cast, fsdp = placed_state(cfg, mesh)
    batch = _place_batch(ispec.batch_specs(cfg, cell), mesh)

    def run(tally):
        step = ts.make_train_step(cfg, opt_lib.AdamWConfig(), microbatches=microbatches,
                                  cast_shardings=cast, grad_shardings=fsdp, counter=tally)
        return step(state, batch)[1]["loss"]

    return run, (state, batch)


def _prefill(cfg, cell, mesh):
    model = placed_model(cfg, mesh)
    batch = _place_batch(ispec.batch_specs(cfg, cell), mesh)

    def run(tally):
        with torch.no_grad():
            return model_lib.prefill_logits(model, cfg, batch)

    return run, (model, batch)


def _decode(cfg, cell, mesh):
    model = placed_model(cfg, mesh)
    state, token, pos, ctx = ispec.decode_specs(cfg, cell)
    state = shard_lib.place(state, shard_lib.decode_state_shardings(mesh, state, cfg), mesh)
    token = shard_lib.place(token, shard_lib.batch_shardings(mesh, token), mesh)
    if ctx is not None:
        ctx = shard_lib.place(ctx, shard_lib.batch_shardings(mesh, ctx), mesh)

    def run(tally):
        with torch.no_grad():
            return model_lib.decode_step(model, cfg, state, token, pos, ctx=ctx)

    return run, (model, state, token, ctx)


def _warm(cfg) -> None:
    """Fill the models' host caches before a count (RoPE's frequencies are
    made once a device and kept, as XLA folds them into constants), so
    every run counts the same program."""
    from repro_torch.models.common import rope_freqs

    rope_freqs(cfg.head_dim, cfg.rope_theta, device="meta")


def lower_one(cfg, cell, mesh, label: str, microbatches: int = 1,
              memory: bool = False) -> dict:
    """Run one program on ``meta`` over ``mesh``; its count record."""
    _warm(cfg)
    if cell.kind == "train":
        run, args = _train(cfg, cell, mesh, microbatches)
    elif cell.kind == "prefill":
        run, args = _prefill(cfg, cell, mesh)
    else:
        run, args = _decode(cfg, cell, mesh)
    out, rec = measure(run, mesh, memory=memory)
    rec = {"label": label, **rec}
    rec["memory"] = {
        "argument_bytes": local_bytes(args),
        "output_bytes": local_bytes(out),
        "temp_bytes": rec.pop("peak_bytes"),
        "generated_code_bytes": None,
    }
    rec["compile_s"] = None  # eager: nothing is compiled
    return rec


def compose(lows: dict, axes: dict, field: str):
    """The full depth's ``field`` (a number, or a dict of numbers) from the
    base run and one run a delta axis with one more layer group."""
    def value(rec):
        return rec[field]

    base = value(lows["base"])
    if isinstance(base, dict):
        keys = set(base)
        for ax in axes:
            keys |= set(value(lows[f"plus_{ax}"]))
        return {k: compose({n: {field: value(r).get(k, 0.0)} for n, r in lows.items()},
                           axes, field) for k in sorted(keys)}
    total = base
    for ax, (full, b, step) in axes.items():
        total += (full - b) // step * (value(lows[f"plus_{ax}"]) - base)
    return total


def run_cell(arch: str, shape_name: str, multi_pod: bool, overrides: dict, variant: str,
             out_dir: str, full: bool = False) -> dict:
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = ispec.SHAPES[shape_name]
    ok, reason = ispec.applicable(cfg, shape_name)
    mesh_name = "multi" if multi_pod else "single"
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "variant": variant, "overrides": overrides,
        "n_params": cfg.n_params, "n_active_params": cfg.n_active_params,
    }
    if not ok:
        rec["skipped"] = reason
        _dump(rec, out_dir)
        return rec

    mesh = production_mesh(multi_pod)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n_dev = mesh.size()
    axes = delta_axes(cfg)

    # --- delta-method runs ---
    base_counts = {ax: base for ax, (_, base, _) in axes.items()}
    lows = {"base": lower_one(_with_layers(cfg, **base_counts), cell, mesh, "base")}
    for ax, (_, base, step) in axes.items():
        counts = dict(base_counts)
        counts[ax] = base + step
        lows[f"plus_{ax}"] = lower_one(_with_layers(cfg, **counts), cell, mesh, f"plus_{ax}")

    composed = {
        "flops_per_device": compose(lows, axes, "flops"),
        "hbm_bytes_per_device": compose(lows, axes, "hbm_traffic_bytes"),
        "hbm_bytes_prefusion_upper": compose(lows, axes, "bytes_accessed"),
        "coll_payload_bytes": compose(lows, axes, "collective_payload_bytes"),
        "coll_wire_bytes": compose(lows, axes, "collective_wire_bytes"),
        "coll_wire_by_axis": compose(lows, axes, "collective_by_axis"),
        "coll_wire_by_phase": compose(lows, axes, "collective_by_phase"),
        "argument_bytes": compose({n: {"a": r["memory"]["argument_bytes"]}
                                   for n, r in lows.items()}, axes, "a"),
    }

    # --- the whole depth: the program a deployment runs, and its memory ---
    if full:
        mb = _microbatches(cfg, cell, sizes) if cell.kind == "train" else 1
        whole = lower_one(cfg, cell, mesh, "full", microbatches=mb, memory=True)
        whole["microbatches"] = mb
        rec["full_scan"] = whole

    rec["lowerings"] = lows
    rec["composed"] = composed
    rec["bytes_counted"] = ("unfused: every aten op's inputs read and outputs written once "
                            "(an upper bound of HBM traffic)")
    mf = model_flops(cfg, cell.kind, cell.batch, cell.seq)
    n_model = sizes["model"]
    links = axis_links(mesh.mesh_dim_names, mesh.shape)
    rec["links"] = {axis: {"link": name, "bytes_per_s": bw} for axis, (name, bw) in links.items()}
    roof = Roofline(
        flops_per_device=composed["flops_per_device"],
        hbm_bytes_per_device=composed["hbm_bytes_per_device"],
        coll_wire_bytes_per_device=composed["coll_wire_bytes"],
        model_flops_global=mf,
        n_devices=n_dev,
        hbm_analytic_per_device=analytic_hbm_bytes(
            cfg, cell.kind, cell.batch, cell.seq, n_model, n_dev // n_model),
        coll_seconds=collective_seconds(composed["coll_wire_by_axis"], mesh.mesh_dim_names,
                                        mesh.shape),
    )
    rec["model_flops"] = mf
    rec["roofline"] = roof.row()
    _dump(rec, out_dir)
    return rec


def _dump(rec: dict, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    variant = rec.get("variant") or "baseline"
    name = f"{rec['arch']}--{rec['shape']}--{rec['mesh']}--{variant}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)


def _parse_overrides(pairs):
    out = {}
    for pair in pairs or []:
        k, v = pair.split("=", 1)
        for cast in (int, float):
            try:
                out[k] = cast(v)
                break
            except ValueError:
                continue
        else:
            out[k] = {"true": True, "false": False}.get(v.lower(), v)
    return out


def _set_batch_axes(batch_axes: str) -> None:
    global _BATCH_EXTRA_AXES, _SEQ_AXES
    _BATCH_EXTRA_AXES = ("model",) if batch_axes in ("dpmodel", "dpmodel_sp") else ()
    _SEQ_AXES = ("pod",) if batch_axes == "dpmodel_sp" else ()


def _task(job: dict) -> tuple:
    """One cell in a worker process: (tag, status, seconds, failed)."""
    import warnings

    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)
    _set_batch_axes(job.pop("batch_axes"))
    tag = f"{job['arch']}/{job['shape_name']}/{'multi' if job['multi_pod'] else 'single'}"
    t0 = time.time()
    try:
        rec = run_cell(**job)
        if "skipped" in rec:
            status = "SKIP " + rec["skipped"]
        else:
            roof = rec["roofline"]
            status = (f"ok   dominant={roof['dominant']} "
                      f"frac={roof['fraction_of_roofline']:.3f} "
                      f"analytic={roof['dominant_analytic']}")
        return tag, status, time.time() - t0, False
    except Exception as e:  # noqa: BLE001  reported per cell, and the run fails
        traceback.print_exc()
        return tag, f"FAIL {type(e).__name__}: {e}", time.time() - t0, True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--override", nargs="*", default=[])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--full", action="store_true",
                    help="also run the whole depth (the compile proof's twin) and its memory")
    ap.add_argument("--skip-full", action="store_true",
                    help="accepted for JAX's CLI: the whole-depth run is off unless --full")
    ap.add_argument("--batch-axes", default="dp", choices=["dp", "dpmodel", "dpmodel_sp"],
                    help="dpmodel: fold the model axis into the batch shard; "
                         "dpmodel_sp: also shard the sequence over 'pod' (context parallelism)")
    ap.add_argument("--jobs", type=int, default=max(1, (os.cpu_count() or 2) // 2),
                    help="cells run side by side, one spawned process each")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(ispec.SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    overrides = _parse_overrides(args.override)
    jobs = [dict(arch=arch, shape_name=shape, multi_pod=mp, overrides=overrides,
                 variant=args.variant, out_dir=args.out, full=args.full and not args.skip_full,
                 batch_axes=args.batch_axes)
            for arch in archs for shape in shapes for mp in meshes]

    import concurrent.futures
    import multiprocessing

    t0 = time.time()
    failures, counts = [], {"ok": 0, "skipped": 0, "failed": 0}
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(max_workers=max(1, args.jobs),
                                                mp_context=ctx) as pool:
        for tag, status, seconds, failed in pool.map(_task, jobs):
            counts["failed" if failed else "skipped" if status.startswith("SKIP") else "ok"] += 1
            if failed:
                failures.append(tag)
            print(f"[dryrun] {tag:55s} {seconds:7.1f}s  {status}", flush=True)
    print(f"[dryrun] {len(jobs)} cells in {time.time() - t0:.1f} s: {counts['ok']} ok, "
          f"{counts['skipped']} skipped, {counts['failed']} failed", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: {failures}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
