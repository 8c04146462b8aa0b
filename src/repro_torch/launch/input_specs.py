"""Shape-and-dtype stand-ins for every (architecture x input-shape) cell
(twin of `repro.launch.input_specs`).

Everything here lives on the ``meta`` device: shapes and dtypes, no
allocation.  The shape set:

    train_4k     seq=4096    global_batch=256   (training)
    prefill_32k  seq=32768   global_batch=32    (inference-prefill)
    decode_32k   seq=32768   global_batch=128   (decode: 1 new token, 32k KV)
    long_500k    seq=524288  global_batch=1     (long-context decode)

``long_500k`` needs sub-quadratic attention: it applies to rwkv6, the
hybrid family and sliding-window configs only.  The encdec and vlm inputs
carry the precomputed frame / image embeddings.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import model as model_lib
from repro_torch.models.common import ModelConfig

__all__ = ["ShapeCell", "SHAPES", "applicable", "batch_specs", "decode_specs"]

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason if skipped)."""
    if shape_name == "long_500k":
        subquad = cfg.family in ("rwkv", "hybrid") or cfg.swa_window > 0
        if not subquad:
            return False, "pure full-attention arch: long_500k needs sub-quadratic attention"
    return True, ""


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Model inputs for the train / prefill kinds."""
    b, s = cell.batch, cell.seq
    out = {"tokens": _sds((b, s), torch.int32)}
    if cell.kind == "train":
        out["labels"] = _sds((b, s), torch.int32)
    if cfg.family == "encdec":
        out["frames"] = _sds((b, cfg.enc_seq, cfg.d_model), cfg.compute_dtype)
    if cfg.family == "vlm":
        out["img"] = _sds((b, cfg.img_tokens, cfg.d_model), cfg.compute_dtype)
    return out


def decode_specs(cfg: ModelConfig, cell: ShapeCell):
    """(state, token, pos, ctx) stand-ins for the serve step."""
    state = model_lib.init_decode_state(cfg, cell.batch, cell.seq, device=META)
    token = _sds((cell.batch, 1), torch.int32)
    pos = _sds((), torch.int32)
    ctx = None
    if cfg.family == "encdec":
        ctx = _sds((cell.batch, cfg.enc_seq, cfg.d_model), cfg.compute_dtype)
    elif cfg.family == "vlm":
        ctx = _sds((cell.batch, cfg.img_tokens, cfg.d_model), cfg.compute_dtype)
    return state, token, pos, ctx
