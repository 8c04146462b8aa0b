"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8, head_dim=128)
d_ff=14336 vocab=128256 — gated cross-attention image layers every 5th layer
(8 of 40); the vision tower is a stub: the caller passes precomputed patch
embeddings (B, 1601, 4096) (the `img` context).  [hf:meta-llama/Llama-3.2-11B-Vision; unverified]
(Twin of `repro.configs.llama32_vision_11b`.)"""
import dataclasses

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab=128256,
        act="silu",
        rope_theta=500_000.0,
        cross_attn_every=5,
        img_tokens=1601,
        attn_chunk=2048,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, img_tokens=8, attn_chunk=0, logit_chunk=16,
        remat=False,
    )
