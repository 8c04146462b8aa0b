"""Dry run of the paper's own workload: the 1500-replica (padded to 1536)
300x300 Ising PT interval on the production meshes (twin of
`repro.launch.dryrun_ising`).

One PT interval (``interval`` sweeps, then one swap) of the replica axis
split over 256 or 512 ranks, as `repro_torch.engine.EngineConfig` with
``mesh=MeshSpec(1, ranks)`` runs it: the sharded interval step
(`repro_torch.engine.driver.make_sharded_interval_step`) on rank 0's block
of 6 (or 3) replicas, on ``meta`` tensors over a fake process group
(`repro_torch.launch.dryrun.fake_group`): kernel A's interval-fused
sweeps and the standalone exchange report their work on ``meta``
(`repro_torch.kernels.build.count_meta`), and the exchange's all-gathers
of the energy and rung rows are counted where the card's mesh phase
counts them (`MeshLayout.gather_replicas`).  Two swap modes:

  * ``temp``: accepted pairs exchange rung indices (O(R) bytes);
  * ``state``: accepted pairs exchange (L, L) lattices.  The engine
    refuses it on a split replica axis (lattices would cross ranks), so
    its record holds the refusal as ``skipped``.

The sweeps move no byte between ranks.  Records land in
results/dryrun_torch/ising_paper--pt<interval>--<mesh>--<mode>.json.

  python -m repro_torch.launch.dryrun_ising --mesh both
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.core import ising
from repro_torch.core.distributed import REPLICA_AXIS, MeshSpec
from repro_torch.core.pt import PTState
from repro_torch.hlo.roofline import HBM_BW, INT32_OPS, PEAK_FLOPS, axis_links
from repro_torch.hlo.traffic import OpTally, hbm_bytes_per_cell_sweep
from repro_torch.launch.comm import ring_bytes
from repro_torch.launch.dryrun import OUT_DIR, fake_group, local_bytes
from repro_torch.launch.mesh import make_production_mesh

__all__ = ["lower_pt", "main"]


def lower_pt(ranks: int, *, replicas: int, length: int, interval: int, swap_mode: str,
             criterion: str = "logistic") -> dict:
    """One interval of rank 0's block on a fake group of ``ranks``: its
    counted work and collective bytes (a ``skipped`` record where the
    engine refuses the configuration)."""
    from repro_torch.engine.driver import EngineConfig, make_sharded_interval_step

    rec = {"swap_mode": swap_mode, "replicas": replicas, "length": length,
           "interval": interval, "ranks": ranks}
    try:
        cfg = EngineConfig(n_replicas=replicas, swap_interval=interval, criterion=criterion,
                           swap_mode=swap_mode, mesh=MeshSpec(1, ranks))
    except ValueError as e:
        rec["skipped"] = str(e)
        return rec
    fake_group(ranks)
    layout = cfg.mesh.build(device="meta")
    system = ising.IsingSystem(length=length, j=1.0, b=0.0, accept_rule="glauber",
                               use_fused=True, use_fused_round=True)
    step = make_sharded_interval_step(system, cfg.spec, {}, layout)
    gathered = []
    gather = layout.gather_replicas

    def counted(x, dim=-1):  # as the mesh phase on the card counts the gathers
        out = gather(x, dim)
        gathered.append((x.numel() * x.element_size(), out.numel() * out.element_size()))
        return out

    layout.gather_replicas = counted
    r_local = replicas // ranks

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    st = PTState(states=meta((r_local, length, length), torch.int8),
                 energy=meta((r_local,), torch.float32), rung=meta((r_local,), torch.int32),
                 key=meta((2,), torch.int64), phase=meta((), torch.int64),
                 t=meta((), torch.int64))
    betas = meta((replicas,), torch.float32)
    tally = OpTally()
    t0 = time.perf_counter()
    with tally:
        step(st, betas)
    seconds = time.perf_counter() - t0
    payload = sum(n for n, _ in gathered)
    wire = sum(ring_bytes("all_gather_into_tensor", n, ranks) for n, _ in gathered)
    # analytic flops, JAX's: 2 half-sweeps x ~12 ops a site a sweep, R*L^2 sites
    sweep_flops = replicas * length * length * 2 * 12 * interval
    hbm_model = (r_local * length * length * interval
                 * hbm_bytes_per_cell_sweep(fused=True, sweeps_per_interval=interval))
    link = axis_links((REPLICA_AXIS,), (ranks,))[REPLICA_AXIS]
    rec.update({
        "flops_per_device_counted": tally.flops,
        "model_flops_per_device": sweep_flops / ranks,
        "hbm_traffic_per_device": tally.unfused_bytes,
        "hbm_model_per_device": hbm_model,
        "hbm_bytes_per_cell_sweep": hbm_bytes_per_cell_sweep(
            fused=True, sweeps_per_interval=interval),
        "kernels": {k: dict(v) for k, v in tally.kernels.items()},
        "coll_payload_bytes": payload,
        "coll_wire_bytes": wire,
        "coll_by_op": {"all-gather": payload},
        "coll_gathered_bytes": sum(n for _, n in gathered),
        "coll_count": len(gathered),
        "link": {"axis": REPLICA_AXIS, "link": link[0], "bytes_per_s": link[1]},
        "memory": {"argument_bytes": local_bytes([st, betas]), "temp_bytes": "not measured"},
        "t_comp_s": sweep_flops / ranks / PEAK_FLOPS,
        # the kernels' Threefry draws: integer instructions at the issue rate
        "t_int_ops_s": sum(k["int_ops"] for k in tally.kernels.values()) / INT32_OPS,
        "t_mem_s": tally.unfused_bytes / HBM_BW,
        "t_mem_model_s": hbm_model / HBM_BW,
        "t_coll_s": wire / link[1],
        "compile_s": None,
        "lower_s": seconds,
    })
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--replicas", type=int, default=1536)  # the paper's 1500, padded
    ap.add_argument("--length", type=int, default=300)  # the paper's 300x300
    ap.add_argument("--interval", type=int, default=100)
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    for mp in meshes:
        shape = make_production_mesh(multi_pod=mp)
        ranks = 1
        for n in shape.sizes:
            ranks *= n
        mesh_name = "multi" if mp else "single"
        for mode in ("state", "temp"):
            rec = lower_pt(ranks, replicas=args.replicas, length=args.length,
                           interval=args.interval, swap_mode=mode)
            rec.update({"arch": "ising_paper", "shape": f"pt{args.interval}",
                        "mesh": mesh_name, "variant": mode})
            name = f"ising_paper--pt{args.interval}--{mesh_name}--{mode}.json"
            with open(os.path.join(args.out, name), "w") as f:
                json.dump(rec, f, indent=1)
            if "skipped" in rec:
                print(f"[ising-dryrun] {mesh_name}/{mode}: SKIP {rec['skipped']}", flush=True)
                continue
            terms = {"compute": rec["t_comp_s"], "integer": rec["t_int_ops_s"],
                     "memory": rec["t_mem_model_s"], "collective": rec["t_coll_s"]}
            print(f"[ising-dryrun] {mesh_name}/{mode}: {ranks} ranks, "
                  f"{args.replicas // ranks} replicas a rank, run {rec['lower_s']:.1f}s  "
                  f"coll_wire={rec['coll_wire_bytes'] / 2**20:.4f} MiB/rank "
                  f"({rec['coll_count']} gathers)  kernels={sorted(rec['kernels'])}  "
                  f"dominant={max(terms, key=terms.get)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
