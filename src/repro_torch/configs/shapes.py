"""Assigned input-shape cells (a copy of the reference's
``repro.configs.shapes``; its ``input_specs``, the dry run's stand-ins,
comes with the port of the dry run).

  train_4k     seq=4,096   global_batch=256   → train_step
  prefill_32k  seq=32,768  global_batch=32    → forward (prefill)
  decode_32k   seq=32,768  global_batch=128   → serve_step (1 new token,
                                                KV/state cache of seq_len)
  long_500k    seq=524,288 global_batch=1     → serve_step; needs
               sub-quadratic attention ⇒ runs only for SSM/hybrid archs
               (rwkv6-3b, jamba-v0.1-52b).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

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
