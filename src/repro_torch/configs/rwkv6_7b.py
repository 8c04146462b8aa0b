"""rwkv6-7b [ssm]: 32L d_model=4096 (attention-free, 64 heads x 64 dims)
d_ff=14336 vocab=65536 — "Finch", data-dependent decay linear recurrence.
[arXiv:2404.05892; hf]  (Twin of `repro.configs.rwkv6_7b`.)"""
import dataclasses

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        family="rwkv",
        n_layers=32,
        d_model=4096,
        n_heads=64,  # d_model / 64 (fixed RWKV head dim)
        n_kv_heads=64,
        head_dim=64,
        d_ff=14336,
        vocab=65536,
        act="relu2",  # channel-mix squared ReLU
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(config(), n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
                               head_dim=64, d_ff=256, vocab=512, logit_chunk=16, remat=False)
