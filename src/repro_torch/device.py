"""Device selection: CUDA unless the caller asks for the CPU, never a fallback."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The torch device an entry point runs on.

    ``None`` means ``cuda``.  Asking for CUDA on a machine without it raises:
    the port never carries on silently on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu", "meta"):  # meta: shapes only, no data
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
