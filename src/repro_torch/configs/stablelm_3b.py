"""stablelm-3b [dense]: 32L d_model=2560 32H (MHA kv=32, head_dim=80)
d_ff=6912 vocab=50304.  [hf:stabilityai/stablelm-2-1_6b family; unverified]
(Twin of `repro.configs.stablelm_3b`.)"""
import dataclasses

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b",
        family="dense",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        head_dim=80,
        d_ff=6912,
        vocab=50304,
        act="silu",
        attn_chunk=2048,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512, attn_chunk=0, logit_chunk=16, remat=False,
    )
