"""Training driver with checkpointing (twin of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6_7b --smoke \\
        --steps 50 [--device cuda|cpu]

The JAX driver's flags plus ``--device`` (``cuda`` unless the caller asks
for the CPU; no fallback).  ``--smoke`` runs the reduced config.  The data
is `repro_torch.data.synthetic.SyntheticLM` (the JAX pipeline's batches),
the optimizer AdamW with 20 warmup steps and a cosine decay over
``--steps``, the masters drawn from seed 0.  Every 10 steps it prints the
JAX driver's line (``step N loss L X it/s``); with ``--ckpt-dir`` it saves
every ``--ckpt-every`` steps in the JAX package's training-checkpoint
format and a restart resumes at the newest saved step (``[restart] resumed
at step N``).  The dense, rwkv, hybrid, moe and vlm archs train (the vlm
on batches with no ``img``, as JAX's `repro.launch.train` does: its cross
layers then attend over their own input).  ``whisper_medium`` is refused
by name: its loss needs ``frames``, which `SyntheticLM` does not make
(JAX's `repro.launch.train` fails on it with a ``KeyError``).
"""
from __future__ import annotations

import argparse
import time

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6_7b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.device import resolve_device
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import init_state, make_train_step

    cfg = get_config(args.arch, reduced=args.smoke)
    if cfg.family == "encdec":
        raise SystemExit(f"{args.arch}: the encdec family needs frames, which the synthetic "
                         "LM batches do not carry; this trains decoder-only archs")
    device = resolve_device(args.device)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    opt_cfg = opt_lib.AdamWConfig(warmup_steps=20, total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches)

    state = init_state(cfg, 0, device=device)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr is not None:
        restored = mgr.restore_latest(state)
        if restored:
            state, meta = restored
            start = meta["step"]
            print(f"[restart] resumed at step {start}")

    t0 = time.time()
    for step, batch in data.batches(start):
        if step >= args.steps:
            break
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        state, metrics = step_fn(state, batch)
        if (step + 1) % 10 == 0:
            print(f"step {step+1:5d} loss {float(metrics['loss']):.4f} "
                  f"{(step + 1 - start) / (time.time() - t0):.2f} it/s", flush=True)
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, state, blocking=False)
    if mgr is not None:
        mgr.wait()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
