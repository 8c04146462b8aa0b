"""Child process of tests/test_torch_distributed.py: 4 gloo ranks on the CPU.

The twin of tests/_mesh_child.py for the port.  The parent runs it once as
a script; it starts 4 ranks with `torch.multiprocessing` (spawn), joined by
a `FileStore` under OUTDIR, one thread each, and runs every scenario of
`SCENARIOS` on its mesh from the same seed, then gathers each final state
on rank 0.  Usage:

    python tests/_torch_mesh_child.py OUTDIR

Writes ``OUTDIR/mesh4.npz`` (rank 0: every scenario's final energies,
rungs, lattices, swap counters and the bytes a rank gathered per interval;
the parent runs the same scenarios unsharded in the JAX package and
asserts bit-equality), a checkpoint under ``OUTDIR/ckpt`` saved on the
(1, 4) mesh at sweep 40, ``fault_*`` arrays (each rank's outcome of an
``engine.compile`` fault injected on one rank of a fused mesh), and
``resumed_*`` arrays: a JAX-package checkpoint the parent left in
``OUTDIR/jax_ckpt`` resumed on the (2, 2) mesh and run to the end, and
``psum_*`` arrays: `repro_torch.train.grad_compress.compressed_psum` of
each rank's `psum_inputs` over the 4 ranks (every rank's sum and new
error).  Imports no JAX.
"""
import datetime
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

WORLD = 4
R, L = 8, 8
SWAP_INTERVAL = 5
SWEEPS = 60
CKPT_SWEEPS = 40
SEED = 21
TEMPS = tuple(1.0 + 2.5 * k / (R - 1) for k in range(R))  # ladder.linear_ladder(R, 1, 3.5)

# name -> (mesh (ensemble, replica), system name, system params, engine kw)
SCENARIOS = {
    "deo": ((1, 4), "ising", {"length": L}, {}),
    "fused": ((1, 4), "ising", {"length": L, "use_fused": True}, {}),
    "round": ((1, 4), "ising", {"length": L, "use_fused": True, "use_fused_round": True,
                                "pack_bits": True}, {}),
    "seo": ((1, 4), "ising", {"length": L, "use_fused": True}, {"exchange": "seo"}),
    "chains": ((2, 2), "ising", {"length": L}, {"n_chains": 2}),
    "chains_round": ((2, 2), "ising", {"length": L, "use_fused": True,
                                       "use_fused_round": True}, {"n_chains": 2}),
    "hp": ((1, 4), "hp_protein", {"sequence": "HPHPPHHPHH"}, {}),
    "single_flip": ((1, 4), "ising", {"length": 7, "update": "single_flip",
                                      "flips_per_step": 5}, {}),
}
# the mesh a JAX-package checkpoint (two chains, sweep 40) is resumed on
RESUME_MESH = (2, 2)
# the one rank an engine.compile fault is injected on
FAULT_RANK = 1


def config_kw(engine_kw: dict) -> dict:
    """EngineConfig keywords of a scenario (shared with the parent)."""
    return dict(n_replicas=R, swap_interval=SWAP_INTERVAL, chunk_intervals=2, **engine_kw)


def _count_gathers(layout, counts: list) -> None:
    """Wrap the layout's replica-axis all-gather (the exchange's and the
    observables' collective) to count the bytes each call returns."""
    fn = layout.gather_replicas

    def counted(x, dim=-1):
        out = fn(x, dim)
        counts.append(out.numel() * out.element_size())
        return out

    layout.gather_replicas = counted


def psum_inputs(rank: int):
    """Rank ``rank``'s gradient and carried error for the compressed psum
    (numpy f32, from a seed; the ranks' scales differ)."""
    rng = np.random.default_rng(100 + rank)
    g = (rng.normal(size=(64,)) * (rank + 1)).astype(np.float32)
    err = (rng.normal(size=(64,)) * 0.01).astype(np.float32)
    return g, err


def _rank(rank: int, outdir: str) -> None:
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import keys, systems
    from repro_torch.core.distributed import MeshSpec
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.resilience import Fault, FaultPlan, InjectedFault

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(outdir, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=240))
    out = {}

    def engine(name, mesh, **extra):
        _, sys_name, params, engine_kw = SCENARIOS[name]
        system = systems.make_system(sys_name, params)
        cfg = EngineConfig(**config_kw({**engine_kw, **extra}), mesh=MeshSpec(*mesh))
        return Engine(system, cfg, device="cpu")

    for name, (mesh, *_rest) in SCENARIOS.items():
        eng = engine(name, mesh)
        st = eng.init(keys.key(SEED), TEMPS)
        counts: list = []
        _count_gathers(eng.layout, counts)
        st, res = eng.run(st, SWEEPS)
        gathered = np.asarray(counts, np.int64)
        whole = eng.gathered(st)
        if rank == 0:
            out[f"{name}_energy"] = whole.pt.energy.numpy()
            out[f"{name}_rung"] = whole.pt.rung.numpy()
            out[f"{name}_states"] = whole.pt.states.numpy()
            out[f"{name}_t"] = whole.pt.t.numpy()
            out[f"{name}_attempts"] = whole.stats.swap_attempts.numpy()
            out[f"{name}_accepts"] = whole.stats.swap_accepts.numpy()
            out[f"{name}_summary_acceptance"] = res.summary["swap_acceptance"]
            out[f"{name}_gathered_bytes"] = gathered

    # an injected engine.compile fault on one rank of a fused (1, 4) mesh:
    # fatal there, and no rank leaves the fused path (a degradation one
    # rank alone took would split the ranks' paths and swap streams)
    faults = FaultPlan([Fault("engine.compile")]) if rank == FAULT_RANK else None
    _, sys_name, params, engine_kw = SCENARIOS["fused"]
    eng = Engine(systems.make_system(sys_name, params),
                 EngineConfig(**config_kw(engine_kw), mesh=MeshSpec(1, WORLD)),
                 device="cpu", faults=faults)
    try:
        eng.ensure_compiled(2)
        raised = False
    except InjectedFault:
        raised = True
    flags = [None] * WORLD
    dist.all_gather_object(flags, (raised, eng.system.use_fused, eng.n_compiles))
    if rank == 0:
        out["fault_raised"], out["fault_still_fused"], out["fault_compiles"] = (
            np.asarray(f, np.int64) for f in zip(*flags))

    # a checkpoint saved mid-run on the (1, 4) mesh (rank 0 writes it)
    mgr = CheckpointManager(os.path.join(outdir, "ckpt"), keep=2)
    eng = engine("deo", SCENARIOS["deo"][0])
    st = eng.init(keys.key(SEED), TEMPS)
    eng.run(st, CKPT_SWEEPS, checkpoint=mgr, checkpoint_every_chunks=1)

    # int8 gradient compression with error feedback over the 4 ranks
    from repro_torch.train.grad_compress import compressed_psum

    g, err = (torch.from_numpy(x) for x in psum_inputs(rank))
    total, new_err = compressed_psum(g, err)
    outs = [None] * WORLD
    dist.all_gather_object(outs, (total.numpy(), new_err.numpy()))
    if rank == 0:
        out["psum_totals"] = np.stack([t for t, _ in outs])
        out["psum_errors"] = np.stack([e for _, e in outs])

    # a JAX-package checkpoint of two chains resumed on the (2, 2) mesh
    eng = engine("chains", RESUME_MESH)
    restored, meta = eng.restore(CheckpointManager(os.path.join(outdir, "jax_ckpt")))
    st, _ = eng.run(restored, SWEEPS - int(meta["step"]))
    whole = eng.gathered(st)
    if rank == 0:
        out["resumed_step"] = np.asarray(meta["step"])
        out["resumed_energy"] = whole.pt.energy.numpy()
        out["resumed_rung"] = whole.pt.rung.numpy()
        out["resumed_states"] = whole.pt.states.numpy()
        np.savez(os.path.join(outdir, "mesh4.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


def main(outdir: str) -> int:
    import torch.multiprocessing as mp

    mp.start_processes(_rank, args=(outdir,), nprocs=WORLD, start_method="spawn")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1]))
