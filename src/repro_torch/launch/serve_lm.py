"""Batched autoregressive serving with the O(1) decode state, on a reduced
config (twin of ``examples/serve_lm.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve_lm [--arch rwkv6_7b]
        [--batch 4] [--tokens 32] [--device cuda|cpu]

Every sequence starts from token 1; step ``pos`` samples the next token with
``categorical(key(100 + pos), logits / 0.8)``, the JAX example's
``jax.random`` draw reproduced by `repro_torch.core.keys`, so the same
weights give the JAX loop's tokens.  The weights are drawn from a seeded
`torch.Generator` (not the JAX example's ``jax.random.key(0)`` weights).
Every arch runs: the dense ones (``gemma_2b``, ``qwen3_32b``,
``minitron_4b``, ``stablelm_3b``: a KV cache of ``--tokens`` + 8
positions), ``rwkv6_7b``, the hybrid ``recurrentgemma_9b``, the moe
``mixtral_8x22b`` and ``qwen3_moe_235b``, the vlm ``llama32_vision_11b``
and the encdec ``whisper_medium``; the decode state is
`model.init_decode_state`'s for every family.  As in the JAX example, the
vlm decodes over a seeded image context (B, img_tokens, D) and whisper over
the encoder's output of seeded frames (B, enc_seq, D) (`context`; the
port's draws, from a `torch.Generator` seeded 2).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import keys
from repro_torch.device import resolve_device
from repro_torch.launch import sharding
from repro_torch.models import model as model_lib

__all__ = ["TEMPERATURE", "context", "generate", "main"]

TEMPERATURE = 0.8


@torch.inference_mode()
def context(model, cfg, batch: int, device):
    """The decode context of the example: for the vlm, image tokens (batch,
    img_tokens, D) f32 N(0, 1); for encdec, `whisper.encode` of frames
    (batch, enc_seq, D) drawn so; else None.  Drawn from a
    `torch.Generator` on ``device`` seeded 2."""
    if cfg.family not in ("vlm", "encdec"):
        return None
    device = resolve_device(device)
    n = cfg.img_tokens if cfg.family == "vlm" else cfg.enc_seq
    x = torch.randn((batch, n, cfg.d_model), device=device,
                    generator=torch.Generator(device=device).manual_seed(2))
    if cfg.family == "vlm":
        return x
    from repro_torch.models import whisper

    return whisper.encode(model, cfg, x)


def generate(model, cfg, batch: int, n_tokens: int, device, ctx=None, mesh=None) -> torch.Tensor:
    """(batch, n_tokens + 1) int64 token ids: the start token 1, then
    ``n_tokens`` sampled ones, every step over ``ctx`` (the encoder output
    or the image tokens; required for encdec).

    With a ``mesh`` (a `DeviceMesh` the model was placed on by
    `repro_torch.launch.sharding.place_module`) the decode state is placed
    under ``decode_state_shardings`` and each token under
    ``batch_shardings``; each rank draws from the whole logits (gathered,
    equal on every rank), so every rank holds the same tokens.  It runs
    under ``no_grad`` there (in inference mode DTensor takes its uncached
    sharding propagation for every composite op), else ``inference_mode``."""
    with torch.no_grad() if mesh is not None else torch.inference_mode():
        return _generate(model, cfg, batch, n_tokens, device, ctx, mesh)


def _generate(model, cfg, batch, n_tokens, device, ctx, mesh):
    device = resolve_device(device)
    state = model_lib.init_decode_state(cfg, batch, max_seq=n_tokens + 8, device=device)
    if mesh is not None:
        state = sharding.place(state, sharding.decode_state_shardings(mesh, state, cfg), mesh)
    token = torch.ones((batch, 1), dtype=torch.int64, device=device)
    seqs = [token]
    for pos in range(n_tokens):
        step_in = token
        if mesh is not None:
            step_in = sharding.place(token, sharding.batch_shardings(mesh, token), mesh)
        logits, state = model_lib.decode_step(model, cfg, state, step_in, pos, ctx=ctx)
        logits = sharding.gather(logits)
        token = keys.categorical(keys.key(100 + pos, device=device),
                                 logits / TEMPERATURE)[:, None]
        seqs.append(token)
    return torch.cat(seqs, dim=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6_7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=True)
    model = model_lib.init_params(cfg, 0, device=device)
    ctx = context(model, cfg, args.batch, device)
    t0 = time.perf_counter()
    out = generate(model, cfg, args.batch, args.tokens, device, ctx=ctx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"arch={args.arch} batch={args.batch} device={device}: generated "
          f"{args.tokens} tokens in {dt:.2f}s ({args.batch * args.tokens / dt:.1f} tok/s "
          "incl. first-use costs)")
    print("sample token ids:", out[0][:16].tolist())
    if not bool(((out >= 0) & (out < cfg.vocab)).all()):
        raise AssertionError("sampled token ids outside the vocabulary")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
