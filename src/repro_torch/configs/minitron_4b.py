"""minitron-4b [dense]: 32L d_model=3072 24H (GQA kv=8, head_dim=128)
d_ff=9216 vocab=256000 — pruned nemotron (squared-ReLU MLP, no gating).
[arXiv:2407.14679; hf]
(Twin of `repro.configs.minitron_4b`.)"""
import dataclasses

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        d_ff=9216,
        vocab=256_000,
        act="relu2",  # nemotron-family squared ReLU
        attn_chunk=2048,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, attn_chunk=0, logit_chunk=16, remat=False,
    )
