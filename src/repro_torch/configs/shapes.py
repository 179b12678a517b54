"""Assigned input-shape cells and meta-tensor stand-ins for the dry run
(the port of the reference's ``repro.configs.shapes``).

  train_4k     seq=4,096   global_batch=256   → train_step
  prefill_32k  seq=32,768  global_batch=32    → forward (prefill)
  decode_32k   seq=32,768  global_batch=128   → serve_step (1 new token,
                                                KV/state cache of seq_len)
  long_500k    seq=524,288 global_batch=1     → serve_step; needs
               sub-quadratic attention ⇒ runs only for SSM/hybrid archs
               (rwkv6-3b, jamba-v0.1-52b).

``input_specs`` returns a tensor on the meta device for every model input
(the counterpart of the reference's ``ShapeDtypeStruct``s): shapes and
dtypes, no storage (the full configs are exercised only through the dry
run's trace on fake ranks, :mod:`repro_torch.launch.dryrun`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

SHAPE_NAMES: List[str] = list(SHAPES)


def cell_applicable(cfg: ModelConfig, shape: str) -> Optional[str]:
    """None if runnable, else the skip reason."""
    if shape == "long_500k" and not cfg.supports_long_context:
        return ("pure full-attention arch: 500k decode needs sub-quadratic "
                "attention (run only for SSM/hybrid archs)")
    return None


def input_specs(cfg: ModelConfig, shape: str,
                device="meta") -> Dict[str, torch.Tensor]:
    """Model-input stand-ins for a shape cell (token batch for training,
    request batch for serving; stubbed frontend embeddings where the arch
    needs them), as uninitialised tensors on ``device`` (``"meta"``: no
    storage at all)."""
    cell = SHAPES[shape]
    b, s = cell.global_batch, cell.seq_len
    i32 = torch.int32
    act = getattr(torch, cfg.dtype)

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=device)
    if cell.kind in ("train", "prefill"):
        specs = {"tokens": spec((b, s), i32), "labels": spec((b, s), i32)}
        if cfg.family == "vlm":
            specs["prefix_embeds"] = spec(
                (b, cfg.num_prefix_embeds, cfg.d_model), act)
        if cfg.family == "audio":
            from repro_torch.configs.whisper_tiny import NUM_FRAMES
            specs["enc_embeds"] = spec((b, NUM_FRAMES, cfg.d_model), act)
        return specs
    # decode: one new token against a cache of seq_len
    specs = {"tokens": spec((b, 1), i32)}
    if cfg.family == "audio":
        from repro_torch.configs.whisper_tiny import NUM_FRAMES
        specs["enc_out"] = spec((b, NUM_FRAMES, cfg.d_model), act)
    return specs
