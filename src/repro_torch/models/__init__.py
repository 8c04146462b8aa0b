"""The LM substrate (twin of `repro.models`): the dense decoder family
(`attention`, `ffn`) and RWKV-6 (`rwkv6`), assembled by `transformer` and
dispatched by `model` (prefill, decode, training loss)."""
