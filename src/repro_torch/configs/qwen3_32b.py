"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8, head_dim=128)
d_ff=25600 vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-8B family; hf]
(Twin of `repro.configs.qwen3_32b`.)"""
import dataclasses

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=25600,
        vocab=151936,
        act="silu",
        qk_norm=True,
        rope_theta=1_000_000.0,
        attn_chunk=2048,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, attn_chunk=0, logit_chunk=16, remat=False,
    )
