"""Architecture registry (twin of `repro.configs`).

``get_config(name)`` returns the published configuration and
``get_config(name, reduced=True)`` the same-family reduced one used by the
CPU tests.  The registry knows the JAX package's ten architectures and
the port runs all of them: the dense four (``gemma_2b``, ``qwen3_32b``,
``minitron_4b``, ``stablelm_3b``), ``rwkv6_7b``, the hybrid
``recurrentgemma_9b``, the moe ``mixtral_8x22b`` and ``qwen3_moe_235b``,
the encdec ``whisper_medium`` and the vlm ``llama32_vision_11b``.
"""
from __future__ import annotations

import importlib

__all__ = ["ARCH_IDS", "ALIASES", "PORTED", "get_config"]

ARCH_IDS = [
    "qwen3_32b",
    "gemma_2b",
    "minitron_4b",
    "stablelm_3b",
    "qwen3_moe_235b",
    "mixtral_8x22b",
    "recurrentgemma_9b",
    "rwkv6_7b",
    "whisper_medium",
    "llama32_vision_11b",
]

# accept dashed external ids too (CLI convenience)
ALIASES = {
    "qwen3-32b": "qwen3_32b",
    "gemma-2b": "gemma_2b",
    "minitron-4b": "minitron_4b",
    "stablelm-3b": "stablelm_3b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "mixtral-8x22b": "mixtral_8x22b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "rwkv6-7b": "rwkv6_7b",
    "whisper-medium": "whisper_medium",
    "llama-3.2-vision-11b": "llama32_vision_11b",
}

# architectures whose config module the port has
PORTED = ("qwen3_32b", "gemma_2b", "minitron_4b", "stablelm_3b", "qwen3_moe_235b",
          "mixtral_8x22b", "recurrentgemma_9b", "rwkv6_7b", "whisper_medium",
          "llama32_vision_11b")


def get_config(name: str, reduced: bool = False):
    mod_name = ALIASES.get(name, name)
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    if mod_name not in PORTED:
        raise NotImplementedError(
            f"not yet ported: arch {mod_name!r} (the port runs {', '.join(PORTED)})")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.reduced() if reduced else mod.config()
