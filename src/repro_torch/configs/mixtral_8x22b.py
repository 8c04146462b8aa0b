"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8, head_dim=128)
expert d_ff=16384 vocab=32768, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]
(Twin of `repro.configs.mixtral_8x22b`.)"""
import dataclasses

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,  # per-expert
        vocab=32768,
        act="silu",
        n_experts=8,
        top_k=2,
        capacity_factor=1.25,
        renorm_gates=True,
        swa_window=4096,  # SWA => sub-quadratic: long_500k runs for this arch
        attn_chunk=2048,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab=512, n_experts=4, top_k=2, swa_window=16,
        attn_chunk=0, logit_chunk=16, remat=False,
    )
