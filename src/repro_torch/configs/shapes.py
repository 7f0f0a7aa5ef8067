"""The assigned input-shape set and per-arch applicability rules, the port's
copy of ``repro.configs.shapes``.

Shapes (identical for all 10 LM-family archs):
  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> prefill (serve)
  decode_32k   seq 32,768  global_batch 128   -> serve_step (1 new token, 32k cache)
  long_500k    seq 524,288 global_batch 1     -> serve_step (1 new token, 500k cache)

Skip rules: encoder-only archs have no decode; long_500k only for archs with
a sub-quadratic mechanism (SSM, hybrid, sliding window:
``ModelConfig.supports_long_context``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: Shape) -> tuple[bool, str]:
    """(runs?, the reason when it does not)."""
    if shape.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only arch: no decode step"
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch: no sub-quadratic mechanism for 500k"
    # an encoder's prefill is the 32k encoder forward (no cache emitted)
    return True, ""


def all_cells(cfg: ModelConfig):
    """[(shape, runs, reason)] for the four assigned shapes."""
    return [(s,) + applicable(cfg, s) for s in SHAPES.values()]
