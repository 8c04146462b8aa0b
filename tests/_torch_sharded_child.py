"""Child process of tests/test_torch_sharded_lm.py: the port's LM placement
layer on 4 gloo ranks on the CPU.  Imports no JAX.

    python tests/_torch_sharded_child.py OUTDIR

Starts 4 ranks with `torch.multiprocessing` (spawn), joined by a
`FileStore` under OUTDIR.  The (2, 2) ``("data", "model")`` mesh spans
them; a (1, 2) or (2, 1) mesh is a slice of a (2, 1, 2) or (2, 2, 1)
``("copy", "data", "model")`` mesh, so two copies of the scenario run side
by side.  Reduced configs in f32, models from the seed 0, as the parent
makes them unsharded:

* ``SERVE``: each model placed under ``param_shardings``, the prefill
  logits of `prompt` (4, 8), then 4 greedy decode steps from its first
  token with the decode state under ``decode_state_shardings`` (logits and
  tokens), the MoE routing of every call (``expert_idx``), whether every
  rank's blocks have its spec's shapes, and one training step with the
  masters and moments in the FSDP layout; on (2, 2) also the sampling
  loop and the refusals of a plain batch and of misplaced masters.  The
  vlm runs over a seeded image with its cross gates set to 1 (a zero
  gate adds exactly 0), whisper over seeded frames (`context_inputs`).
  For the cells of ``DRY`` the collectives rank 0 counts in the serving
  and in the training step, by (phase, collective, mesh axis), and its
  resident bytes, for `tests/_torch_dryrun_child.py`'s dry run of the
  same programs to equal;
* ``TRAIN``: the training step against JAX's GSPMD step (gemma on (2, 2),
  2 steps from the initial state the JAX child wrote) and against the
  unsharded port (gemma on (2, 1), 2 microbatches), with the collective
  bytes of the ``cast`` and ``grads`` phases counted
  (`repro_torch.launch.comm.CollectiveCounter`);
* ``eager``: gemma on (2, 2) once more with `comm.eager_collectives`
  registered for the CPU (the functional collectives through gloo's eager
  ones, as ranks sharing a card run them);
* ``ptlm``: after the 4-rank group ends, ranks 0 and 1 join a group of 2
  and run PT over reduced gemma sequences on ``MeshSpec(1, 2)`` from the
  JAX child's weights.

Rank 0 writes ``OUTDIR/torch.npz``.
"""
import datetime
import os
import pickle
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

WORLD = 4
B, S, DECODE = 4, 8, 4
TRAIN_STEPS, WARMUP = 2, 1
SWAP_INTERVAL = 5
PTLM_R, PTLM_SEQ, PTLM_STEPS, PTLM_SEED = 4, 12, 20, 3
PTLM_TEMPS = tuple(8.0 ** (k / (PTLM_R - 1)) for k in range(PTLM_R))  # geometric 1..8

# name -> (arch, mesh (data, model), config overrides)
SERVE = {
    "gemma_2x2": ("gemma_2b", (2, 2), {}),
    "gemma_1x2": ("gemma_2b", (1, 2), {}),
    "rwkv_1x2": ("rwkv6_7b", (1, 2), {}),
    "rwkv_2x2": ("rwkv6_7b", (2, 2), {}),
    "moe_2x2": ("qwen3_moe_235b", (2, 2), {}),
    "moe_ts_2x1": ("qwen3_moe_235b", (2, 1), {"moe_token_stationary": True}),
    "moe_ts_2x2": ("qwen3_moe_235b", (2, 2), {"moe_token_stationary": True}),
    # 3 experts do not divide the model axis: the intra-expert fallback
    "moe3_2x2": ("qwen3_moe_235b", (2, 2), {"n_experts": 3, "top_k": 2}),
    "moe3_ts_2x2": ("qwen3_moe_235b", (2, 2), {"n_experts": 3, "top_k": 2,
                                               "moe_token_stationary": True}),
    "hybrid_2x2": ("recurrentgemma_9b", (2, 2), {}),
    "hybrid_1x2": ("recurrentgemma_9b", (1, 2), {}),
    "vlm_2x2": ("llama32_vision_11b", (2, 2), {}),
    "vlm_1x2": ("llama32_vision_11b", (1, 2), {}),
    "encdec_2x2": ("whisper_medium", (2, 2), {}),
    "encdec_1x2": ("whisper_medium", (1, 2), {}),
}
# the cells whose counted collectives and resident bytes a dry run repeats
DRY = ("hybrid_2x2", "hybrid_1x2", "vlm_2x2", "vlm_1x2", "encdec_2x2", "encdec_1x2")
# name -> (mesh, microbatches, start from JAX's initial state)
TRAIN = {
    "train_jax_2x2": ((2, 2), 1, True),
    "train_mb2_2x1": ((2, 1), 2, False),
}


def config(arch: str, **kw):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch, reduced=True), dtype="float32", **kw)


def prompt(vocab: int = 512) -> np.ndarray:
    return np.random.default_rng(11).integers(0, vocab, (B, S)).astype(np.int64)


def train_batch(vocab: int = 512) -> dict:
    t = np.random.default_rng(7).integers(0, vocab, (B, S)).astype(np.int32)
    return {"tokens": t, "labels": np.roll(t, -1, axis=1)}


def context_inputs(cfg, device="cpu") -> dict:
    """The family's context in a batch: a seeded image (B, img_tokens, D)
    for the vlm, frames (B, enc_seq, D) for whisper, f32 N(0, 1); else
    nothing.  On ``meta``, its shape."""
    name, n = {"vlm": ("img", cfg.img_tokens), "encdec": ("frames", cfg.enc_seq)}.get(
        cfg.family, (None, 0))
    if name is None:
        return {}
    import torch

    shape = (B, n, cfg.d_model)
    if str(device) == "meta":
        return {name: torch.empty(shape, device="meta")}
    return {name: torch.from_numpy(np.random.default_rng(5).normal(size=shape)
                                   .astype(np.float32))}


def open_gates(named: dict) -> None:
    """The vlm's cross gates set to 1.0 in place (JAX makes them 0)."""
    for name, p in named.items():
        if name.endswith(".gate"):
            p.data.fill_(1.0)


def init_model(cfg, device="cpu"):
    from repro_torch.models import model as model_lib

    model = model_lib.init_params(cfg, 0, device=device)
    open_gates(dict(model.named_parameters()))
    return model


def init_train_state(cfg, device="cpu"):
    from repro_torch.train import train_step as ts

    state = ts.init_state(cfg, 0, device=device)
    open_gates(state.params)
    return state


def opt_config():
    from repro_torch.train.optimizer import AdamWConfig

    return AdamWConfig(warmup_steps=WARMUP)


def serve(model, cfg, mesh=None, routing=None, device="cpu"):
    """Prefill logits, then DECODE greedy steps over the family's context:
    (prefill (B, V), decode logits (DECODE, B, V), tokens (DECODE + 1, B)),
    every tensor whole (on ``meta``, the dry run of the same calls: None)."""
    import torch

    from repro_torch.launch import sharding
    from repro_torch.models import model as model_lib
    from repro_torch.models import placed, whisper

    def put(x, spec_fn):
        return x if mesh is None else sharding.place(x, spec_fn(x), mesh)

    batch = put({"tokens": torch.from_numpy(prompt(cfg.vocab)).to(device),
                 **context_inputs(cfg, device)},
                lambda b: sharding.batch_shardings(mesh, b))
    with torch.no_grad():
        pre = sharding.gather(model_lib.prefill_logits(model, cfg, batch))
        ctx = batch.get("img")
        if cfg.family == "encdec":
            with placed.implicit(model, inputs=batch["frames"]):
                ctx = whisper.encode(model, cfg, batch["frames"])
        state = model_lib.init_decode_state(cfg, B, DECODE + 2, device=device)
        state = put(state, lambda st: sharding.decode_state_shardings(mesh, st, cfg))
        token = torch.from_numpy(prompt(cfg.vocab)[:, :1]).to(device)
        logits, tokens = [], [token[:, 0]]
        for pos in range(DECODE):
            step_in = put(token, lambda t: sharding.batch_shardings(mesh, t))
            lg, state = model_lib.decode_step(model, cfg, state, step_in, pos, ctx=ctx)
            lg = sharding.gather(lg)
            token = torch.argmax(lg, dim=-1)[:, None]
            logits.append(lg)
            tokens.append(token[:, 0])
    if str(device) == "meta":
        return None
    return pre.numpy(), torch.stack(logits).numpy(), torch.stack(tokens).numpy()


def train(state, cfg, steps: int, microbatches: int = 1, mesh=None, counter=None,
          device="cpu"):
    """``steps`` training steps of `train_batch` and the family's context;
    returns (state, losses) (on ``meta``, the dry run: losses None)."""
    import torch

    from repro_torch.launch import sharding
    from repro_torch.train import train_step as ts

    kw = {}
    if mesh is not None:
        fsdp = sharding.param_shardings(mesh, state.params, cfg, fsdp=True)
        state = ts.place_state(state, fsdp, mesh)
        kw = dict(cast_shardings=sharding.param_shardings(mesh, state.params, cfg),
                  grad_shardings=fsdp, counter=counter)
    step = ts.make_train_step(cfg, opt_config(), microbatches=microbatches, **kw)
    batch = {**{k: torch.from_numpy(v).to(device) for k, v in train_batch(cfg.vocab).items()},
             **context_inputs(cfg, device)}
    losses = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        losses.append(sharding.gather(metrics["loss"]))
    if str(device) == "meta":
        return state, None
    return state, np.asarray([float(x) for x in losses])


def blocks_match(params: dict, specs: dict, mesh) -> bool:
    """Every rank's block of every tensor has its spec's shape."""
    for name, p in params.items():
        want = []
        for d, n in enumerate(p.shape):
            entry = specs[name][d]
            axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
            for a in axes:
                n //= mesh.size(mesh.mesh_dim_names.index(a))
            want.append(n)
        if tuple(p.to_local().shape) != tuple(want):
            return False
    return True


def _refusals(model, cfg, mesh) -> dict:
    """Whether a placed model refuses a plain batch, and a placed train step
    masters placed otherwise than its ``grad_shardings``, each by a
    ValueError naming the fix."""
    import torch

    from repro_torch.launch import sharding
    from repro_torch.models import model as model_lib
    from repro_torch.train import train_step as ts

    out = {}
    try:
        model_lib.prefill_logits(model, cfg, {"tokens": torch.from_numpy(prompt(cfg.vocab))})
        out["refused_plain_batch"] = np.asarray(False)
    except ValueError as e:
        out["refused_plain_batch"] = np.asarray("sharding.place" in str(e))
    state = ts.init_state(cfg, 0, device="cpu")
    tp = sharding.param_shardings(mesh, state.params, cfg)
    state = ts.place_state(state, tp, mesh)  # the TP layout, where the step wants FSDP's
    step = ts.make_train_step(cfg, opt_config(), cast_shardings=tp,
                              grad_shardings=sharding.param_shardings(mesh, state.params, cfg,
                                                                      fsdp=True))
    try:
        step(state, {k: torch.from_numpy(v) for k, v in train_batch(cfg.vocab).items()})
        out["refused_masters_layout"] = np.asarray(False)
    except ValueError as e:
        out["refused_masters_layout"] = np.asarray("place_state" in str(e))
    return out


def counted(name: str, counters: dict, model, state) -> dict:
    """A cell's counted collectives (bytes by ``{name}_coll.{stage}.{phase}.
    {collective}.{axis}``) and resident bytes (``{name}_resident.model`` /
    ``.state``: the rank's blocks of the placed model, and of the training
    state's masters and moments)."""
    from repro_torch.launch.dryrun import local_bytes

    out = {}
    for stage, counter in counters.items():
        for (phase, coll, axis), n in counter.by_axis.items():
            out[f"{name}_coll.{stage}.{phase}.{coll}.{axis}"] = np.asarray(n)
    out[f"{name}_resident.model"] = np.asarray(local_bytes(model))
    out[f"{name}_resident.state"] = np.asarray(
        local_bytes([state.params, state.opt.mu, state.opt.nu]))
    return out


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh

    if shape == (2, 2):
        return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    full = init_device_mesh("cpu", (2, *shape), mesh_dim_names=("copy", "data", "model"))
    return full["data", "model"]


def _record_routing(log: list):
    from repro_torch.models import moe

    inner = moe.dispatch

    def dispatch(cfg, expert_idx, gate_vals):
        log.append(expert_idx.clone())
        return inner(cfg, expert_idx, gate_vals)

    moe.dispatch = dispatch
    return inner


def _jax_init(outdir: str, timeout: float = 240.0) -> dict:
    """The JAX child's initial trees (it runs beside this one and writes
    them before its own runs)."""
    import time

    path = os.path.join(outdir, "jax_init.pkl")
    end = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > end:
            raise TimeoutError(f"{path} was not written")
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


def _rank(rank: int, outdir: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch import carry
    from repro_torch.launch import comm, sharding
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe
    from repro_torch.train import train_step as ts

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(outdir, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=240))
    out = {}
    for name, (arch, shape, kw) in SERVE.items():
        cfg = config(arch, **kw)
        mesh = _mesh(shape)
        model = init_model(cfg)
        specs = sharding.param_shardings(mesh, model, cfg)
        sharding.place_module(model, specs, mesh)
        log: list = []
        inner = _record_routing(log)
        counters = {"serve": comm.CollectiveCounter(mesh), "train": comm.CollectiveCounter(mesh)}
        try:
            with counters["serve"]:
                pre, dec, tok = serve(model, cfg, mesh)
        finally:
            moe.dispatch = inner
        if name == "gemma_2x2":  # the sampling loop, its state and tokens placed
            from repro_torch.launch import serve_lm

            generated = serve_lm.generate(model, cfg, B, DECODE, "cpu", mesh=mesh)
            if rank == 0:
                out["generate_tokens"] = generated.numpy()
            refused = _refusals(model, cfg, mesh)
            if rank == 0:
                out.update(refused)
        with counters["train"]:
            st, _ = train(init_train_state(cfg), cfg, 1, mesh=mesh, counter=counters["train"])
        fsdp = sharding.param_shardings(mesh, st.params, cfg, fsdp=True)
        ok = (blocks_match(dict(model.named_parameters()), specs, mesh)
              and blocks_match(st.params, fsdp, mesh) and blocks_match(st.opt.nu, fsdp, mesh))
        masters = sharding.gather(st.params)
        if rank == 0:
            out[f"{name}_prefill"], out[f"{name}_decode"], out[f"{name}_tokens"] = pre, dec, tok
            out[f"{name}_blocks_ok"] = np.asarray(ok)
            if log:
                out[f"{name}_routing"] = torch.cat([x.reshape(-1) for x in log]).numpy()
            for n, p in masters.items():
                out[f"{name}_train.{n}"] = p.numpy()
            if name in DRY:
                out.update(counted(name, counters, model, st))

    init = _jax_init(outdir)
    for name, (shape, mb, from_jax) in TRAIN.items():
        cfg = config("gemma_2b")
        mesh = _mesh(shape)
        state = (carry.train_state_from_reference(init["train"], cfg, "cpu") if from_jax
                 else ts.init_state(cfg, 0, device="cpu"))
        counter = comm.CollectiveCounter(mesh)
        with counter:
            state, losses = train(state, cfg, TRAIN_STEPS, mb, mesh=mesh, counter=counter)
        trees = {"params": sharding.gather(state.params), "mu": sharding.gather(state.opt.mu),
                 "nu": sharding.gather(state.opt.nu)}
        if rank == 0:
            out[f"{name}_loss"] = losses
            for tree, leaves in trees.items():
                for n, p in leaves.items():
                    out[f"{name}_{tree}.{n}"] = p.numpy()
            for (phase, coll, axis), n in counter.by_axis.items():
                out[f"{name}_bytes.{phase}.{coll}.{axis}"] = np.asarray(n)
    # the same runs once more with the functional collectives routed through
    # gloo's eager ones (comm.eager_collectives, what ranks sharing a card use)
    comm.eager_collectives("CPU")
    name = "gemma_2x2"
    arch, shape, kw = SERVE[name]
    cfg = config(arch, **kw)
    mesh = _mesh(shape)
    model = model_lib.init_params(cfg, 0, device="cpu")
    sharding.place_module(model, sharding.param_shardings(mesh, model, cfg), mesh)
    pre, dec, tok = serve(model, cfg, mesh)
    counter = comm.CollectiveCounter(mesh)
    with counter:
        st, losses = train(ts.init_state(cfg, 0, device="cpu"), cfg, 1, mesh=mesh,
                           counter=counter)
    masters = sharding.gather(st.params)
    if rank == 0:
        out["eager_prefill"], out["eager_decode"], out["eager_tokens"] = pre, dec, tok
        out["eager_loss"] = losses
        out["eager_cast_bytes"] = np.asarray(
            counter.by_axis[("cast", "all_gather_into_tensor", "data")])
        for n, p in masters.items():
            out[f"eager_train.{n}"] = p.numpy()
    dist.barrier()
    dist.destroy_process_group()

    if rank >= 2:
        return
    # PT-LM on the PT mesh: a group of 2
    from repro_torch.core import keys
    from repro_torch.core.distributed import MeshSpec
    from repro_torch.core.ptlm import LMSystem
    from repro_torch.engine import Engine, EngineConfig

    store = dist.FileStore(os.path.join(outdir, "store2"), 2)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=240))
    cfg = config("gemma_2b")
    model = carry.lm_params_from_reference(init["ptlm"], cfg, "cpu")
    eng = Engine(LMSystem(cfg=cfg, seq_len=PTLM_SEQ).bind(model),
                 EngineConfig(n_replicas=PTLM_R, swap_interval=SWAP_INTERVAL,
                              mesh=MeshSpec(1, 2)), device="cpu")
    st = eng.init(keys.key(PTLM_SEED), PTLM_TEMPS)
    st, _ = eng.run(st, PTLM_STEPS)
    whole = eng.gathered(st)
    if rank == 0:
        out["ptlm_states"] = whole.pt.states.numpy()
        out["ptlm_rung"] = whole.pt.rung.numpy()
        out["ptlm_energy"] = whole.pt.energy.numpy()
        out["ptlm_attempts"] = whole.stats.swap_attempts.numpy()
        out["ptlm_accepts"] = whole.stats.swap_accepts.numpy()
        np.savez(os.path.join(outdir, "torch.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


def main(outdir: str) -> int:
    import torch.multiprocessing as mp

    mp.start_processes(_rank, args=(outdir,), nprocs=WORLD, start_method="spawn")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1]))
