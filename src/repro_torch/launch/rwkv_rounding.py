"""How far rounding alone moves the logits of rwkv6-7b at full width, on the
card: the measurement behind holding decode == full forward in f32 and not
in bf16 (``chip_smoke.py`` holds the f32 form).

For the model drawn from seed 0 and the first 16 of the (4, 512) tokens
drawn from seed 1 (``chip_smoke.py``'s inputs) it prints, in bf16 and in
f32, the largest |decode - full forward| over 16 decode steps, the first
step at which they differ, and how far the full forward's logits move when
every embedding value is scaled by about one ulp of the weights' type
(1 + 2^-8 in bf16, 1 + 2^-23 in f32); then how far the bf16 forward lies
from the f32 one.  It needs one card with ~31 GB free:

    PYTHONPATH=src python -m repro_torch.launch.rwkv_rounding
"""
from __future__ import annotations

import dataclasses
import subprocess

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as tf

__all__ = ["decode_vs_forward", "ulp_sensitivity", "main"]


def decode_vs_forward(model, cfg, tokens: torch.Tensor, n_steps: int):
    """Decode logits of ``n_steps`` steps and the full forward's logits at
    each position (``last_logits`` of the backbone's prefix): (B, n, V) each."""
    hidden = tf.backbone(model, cfg, tokens[:, :n_steps])
    full = torch.stack([tf.last_logits(model, cfg, hidden[:, :p + 1])
                        for p in range(n_steps)], 1)
    state = model_lib.init_decode_state(cfg, tokens.shape[0], n_steps, device=tokens.device)
    steps = []
    for p in range(n_steps):
        logits, state = model_lib.decode_step(model, cfg, state, tokens[:, p:p + 1], p)
        steps.append(logits)
    return torch.stack(steps, 1), full


def ulp_sensitivity(model, cfg, tokens: torch.Tensor, n_steps: int, rel: float) -> float:
    """Largest change of the full forward's logits at the first ``n_steps``
    positions when every embedding value is scaled by ``1 + rel``."""
    def logits():
        hidden = tf.backbone(model, cfg, tokens[:, :n_steps])
        return torch.stack([tf.last_logits(model, cfg, hidden[:, :p + 1])
                            for p in range(n_steps)], 1)

    base = logits()
    saved = model.embed.detach().clone()
    model.embed.mul_(1 + rel)
    moved = logits()
    model.embed.copy_(saved)
    return (moved - base).abs().max().item()


def main(n_steps: int = 16) -> None:
    device = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    cfg = get_config("rwkv6_7b")
    tokens = torch.randint(0, cfg.vocab, (4, 512), device=device,
                           generator=torch.Generator(device=device).manual_seed(1))
    full = {}
    with torch.inference_mode():
        for dtype, rel in (("bfloat16", 2.0 ** -8), ("float32", 2.0 ** -23)):
            c = dataclasses.replace(cfg, dtype=dtype)
            lm = model_lib.init_params(c, torch.Generator(device=device).manual_seed(0),
                                       device=device)
            steps, full[dtype] = decode_vs_forward(lm, c, tokens, n_steps)
            dev = (steps - full[dtype]).abs()
            first = next((p for p in range(n_steps) if bool((dev[:, p] > 0).any())), None)
            ratio = (dev / (3e-2 + 3e-2 * full[dtype].abs())).amax(dim=(0, 2))
            sens = ulp_sensitivity(lm, c, tokens, n_steps, rel)
            print(f"rwkv6-7b {dtype} [{card}]: max |decode - forward| over {n_steps} steps "
                  f"{dev.max().item():.4e}, bit-equal before step {first}, per-step max "
                  f"|dev| / (3e-2 + 3e-2|x|) {[round(x, 3) for x in ratio.tolist()]}; a "
                  f"one-ulp embedding scaling (1 + {rel:.3g}) moves the logits {sens:.4e}")
            del lm
            torch.cuda.empty_cache()
    print(f"rwkv6-7b [{card}]: bf16 vs f32 full forward max |dev| "
          f"{(full['bfloat16'] - full['float32']).abs().max().item():.4f}")


if __name__ == "__main__":
    main()
