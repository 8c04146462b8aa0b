"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1, head_dim=256)
d_ff=16384 vocab=256000 — GeGLU, tied embeddings, sqrt(d) embed scale.
[arXiv:2403.08295; hf]
(Twin of `repro.configs.gemma_2b`.)"""
import dataclasses
import math

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        family="dense",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab=256_000,
        act="geglu",
        tie_embeddings=True,
        embed_scale=math.sqrt(2048.0),
        attn_chunk=2048,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=512, embed_scale=8.0, attn_chunk=0, logit_chunk=16,
        remat=False,
    )
