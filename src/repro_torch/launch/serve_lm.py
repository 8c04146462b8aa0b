"""Batched autoregressive serving with the O(1) decode state, on a reduced
config (twin of ``examples/serve_lm.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve_lm [--arch rwkv6_7b]
        [--batch 4] [--tokens 32] [--device cuda|cpu]

Every sequence starts from token 1; step ``pos`` samples the next token with
``categorical(key(100 + pos), logits / 0.8)``, the JAX example's
``jax.random`` draw reproduced by `repro_torch.core.keys`, so the same
weights give the JAX loop's tokens.  The weights are drawn from a seeded
`torch.Generator` (not the JAX example's ``jax.random.key(0)`` weights).
The port runs the dense archs (``gemma_2b``, ``qwen3_32b``, ``minitron_4b``,
``stablelm_3b``: a KV cache of ``--tokens`` + 8 positions), ``rwkv6_7b``,
the hybrid ``recurrentgemma_9b`` and the moe ``mixtral_8x22b`` and
``qwen3_moe_235b``; the decode state is `model.init_decode_state`'s for
every family.  The others are refused by name.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import keys
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib

__all__ = ["TEMPERATURE", "generate", "main"]

TEMPERATURE = 0.8


@torch.inference_mode()
def generate(model, cfg, batch: int, n_tokens: int, device) -> torch.Tensor:
    """(batch, n_tokens + 1) int64 token ids: the start token 1, then
    ``n_tokens`` sampled ones."""
    device = resolve_device(device)
    state = model_lib.init_decode_state(cfg, batch, max_seq=n_tokens + 8, device=device)
    token = torch.ones((batch, 1), dtype=torch.int64, device=device)
    seqs = [token]
    for pos in range(n_tokens):
        logits, state = model_lib.decode_step(model, cfg, state, token, pos)
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
    t0 = time.perf_counter()
    out = generate(model, cfg, args.batch, args.tokens, device)
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
