"""Child process of the dry-run tests: `repro_torch.launch.dryrun` on a fake
process group, no JAX.

    python tests/_torch_dryrun_child.py counts OUTDIR
    python tests/_torch_dryrun_child.py delta OUTDIR

``counts``: the programs of `tests/_torch_sharded_child.py`'s ``DRY`` cells
(serving: prefill, the whisper encoder, 4 decode steps and the logits'
gathers; one training step) on ``meta`` tensors over a fake group of the
mesh's size, the mesh of device type ``cpu`` as the gloo ranks build
theirs; writes ``dry.npz`` with the sharded child's keys (collective bytes
by stage, phase, collective and axis; resident bytes) for
`tests/test_torch_sharded_lm.py` to hold against the ranks' readings.

``delta``: reduced configs at (2, 2) on a ``cuda`` mesh: each cell's counts
composed by the delta method from its base and plus-one-group runs beside
a full-depth run (``delta.json``), a Shard -> Shard redistribution's
count on a ``cuda`` and a ``cpu`` mesh, and `repro_torch.launch.
dryrun_ising.lower_pt` of a small Ising interval on 4 ranks.
"""
import dataclasses
import json
import os
import sys
import warnings

import numpy as np

HERE = os.path.dirname(__file__)
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, HERE)

# arch -> (layer counts of the full depth, kinds run)
DELTA = {
    "recurrentgemma_9b": ({"n_layers": 11}, ("train", "prefill", "decode")),
    "whisper_medium": ({"n_layers": 3, "enc_layers": 3}, ("train", "prefill")),
    "llama32_vision_11b": ({"n_layers": 15}, ("prefill",)),
    "rwkv6_7b": ({"n_layers": 3}, ("train",)),
    "gemma_2b": ({"n_layers": 3}, ("decode",)),
}
FIELDS = ("flops", "bytes_accessed", "collective_payload_bytes", "collective_wire_bytes",
          "collective_by_axis")


def counts(outdir: str) -> None:
    import _torch_sharded_child as child

    from repro_torch.launch import comm, dryrun

    out = {}
    for name in child.DRY:
        arch, shape, kw = child.SERVE[name]
        cfg = child.config(arch, **kw)
        mesh = dryrun.fake_mesh(shape, ("data", "model"), "cpu")
        model = dryrun.placed_model(cfg, mesh, serve_dtype=False)
        counters = {"serve": comm.CollectiveCounter(mesh), "train": comm.CollectiveCounter(mesh)}
        with counters["serve"]:
            child.serve(model, cfg, mesh, device="meta")
        with counters["train"]:
            state, _ = child.train(child.init_train_state(cfg, "meta"), cfg, 1, mesh=mesh,
                                   counter=counters["train"], device="meta")
        out.update(child.counted(name, counters, model, state))
    np.savez(os.path.join(outdir, "dry.npz"), **out)


def delta(outdir: str) -> None:
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.configs import get_config
    from repro_torch.launch import comm, dryrun, dryrun_ising
    from repro_torch.launch.input_specs import ShapeCell

    cells = {"train": ShapeCell("t", "train", 16, 4), "prefill": ShapeCell("p", "prefill", 16, 4),
             "decode": ShapeCell("d", "decode", 16, 4)}
    mesh = dryrun.fake_mesh((2, 2), ("data", "model"), "cuda")
    out = {}
    for arch, (depth, kinds) in DELTA.items():
        cfg = dataclasses.replace(get_config(arch, reduced=True), **depth)
        axes = dryrun.delta_axes(cfg)
        base = {ax: b for ax, (_, b, _) in axes.items()}
        for kind in kinds:
            cell = cells[kind]
            lows = {"base": dryrun.lower_one(dataclasses.replace(cfg, **base), cell, mesh,
                                             "base")}
            for ax, (_, b, step) in axes.items():
                plus = dict(base, **{ax: b + step})
                lows[f"plus_{ax}"] = dryrun.lower_one(dataclasses.replace(cfg, **plus), cell,
                                                      mesh, f"plus_{ax}")
            full = dryrun.lower_one(cfg, cell, mesh, "full")
            out[f"{arch}/{kind}"] = {
                "composed": {f: dryrun.compose(lows, axes, f) for f in FIELDS},
                "full": {f: full[f] for f in FIELDS},
                "kernels": full["kernels"],
                "groups": {ax: (f - b) // s for ax, (f, b, s) in axes.items()},
            }
    for device_type in ("cuda", "cpu"):  # Shard(0) -> Shard(1) of a (4, 6) f32 block a rank
        m = dryrun.fake_mesh((2, 2), ("data", "model"), device_type)
        x = DTensor.from_local(torch.empty(4, 6, device="meta"), m, [Shard(0), Replicate()],
                               run_check=False)
        counter = comm.CollectiveCounter(m)
        with counter:
            x.redistribute(m, [Shard(1), Replicate()])
        out[f"shard_to_shard/{device_type}"] = {
            "calls": dict(counter.calls), "bytes": dict(counter.bytes),
            "axes": sorted({axis for (_, _, axis) in counter.by_axis})}
    for mode in ("temp", "state"):
        out[f"ising/{mode}"] = dryrun_ising.lower_pt(4, replicas=12, length=8, interval=2,
                                                     swap_mode=mode)
    with open(os.path.join(outdir, "delta.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    warnings.filterwarnings("ignore")
    mode, outdir = sys.argv[1], sys.argv[2]
    {"counts": counts, "delta": delta}[mode](outdir)
