"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1, head_dim=256)
d_ff=12288 vocab=256000 — RG-LRU + local attention, pattern
(rglru, rglru, local-attn) i.e. 1 attention per 2 recurrent layers;
38 = 12x3 + 2 recurrent tail.  [arXiv:2402.19427; unverified]
(Twin of `repro.configs.recurrentgemma_9b`.)"""
import dataclasses
import math

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab=256_000,
        act="geglu",
        pattern=("rglru", "rglru", "attn_local"),
        lru_width=4096,
        conv1d_width=4,
        local_window=2048,
        tie_embeddings=True,
        embed_scale=math.sqrt(4096.0),
        attn_chunk=2048,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        n_layers=5,  # 1 group + 2-layer tail: exercises both code paths
        d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128,
        vocab=512, lru_width=64, local_window=16, embed_scale=8.0,
        attn_chunk=0, logit_chunk=16, remat=False,
    )
