"""rwkv6-7b [ssm]: 32L d_model=4096 (attention-free, 64 heads x 64 dims)
d_ff=14336 vocab=65536 — "Finch", data-dependent decay linear recurrence.
[arXiv:2404.05892; hf]  (Twin of `repro.configs.rwkv6_7b`.)"""
import dataclasses

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        family="rwkv",  # 64 heads of 64; channel-mix squared ReLU
        n_layers=32,
        d_model=4096,
        d_ff=14336,
        vocab=65536,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=128, d_ff=256, vocab=512,
                               logit_chunk=16, remat=False)
