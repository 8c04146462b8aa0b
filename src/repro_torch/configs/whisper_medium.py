"""whisper-medium [audio enc-dec]: 24+24L d_model=1024 16H (MHA kv=16,
head_dim=64) d_ff=4096 vocab=51865 — the conv frontend is a stub: the caller
passes precomputed frame embeddings (B, 1500, 1024) (`frames`).
[arXiv:2212.04356; unverified]
(Twin of `repro.configs.whisper_medium`.)"""
import dataclasses

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="encdec",
        n_layers=24,  # decoder
        enc_layers=24,
        enc_seq=1500,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab=51865,
        act="gelu",
        attn_chunk=2048,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        n_layers=2, enc_layers=2, enc_seq=16, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=512, attn_chunk=0,
        logit_chunk=16, remat=False,
    )
