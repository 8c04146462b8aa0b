"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4, head_dim=128)
expert d_ff=1536 vocab=151936, MoE 128 experts top-8, qk_norm.
[hf:Qwen/Qwen3-30B-A3B family; hf]
(Twin of `repro.configs.qwen3_moe_235b`.)"""
import dataclasses

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        head_dim=128,
        d_ff=1536,  # per-expert
        vocab=151936,
        act="silu",
        qk_norm=True,
        rope_theta=1_000_000.0,
        n_experts=128,
        top_k=8,
        capacity_factor=1.25,
        renorm_gates=True,
        attn_chunk=2048,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab=512, n_experts=8, top_k=2, attn_chunk=0,
        logit_chunk=16, remat=False,
    )
