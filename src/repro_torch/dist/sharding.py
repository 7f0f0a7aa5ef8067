"""Logical-axis rules, the port's part of ``repro.dist.sharding``: only
``TP_RULES``, which the streamed trainer's FSDP layout reads to keep off the
axes that tensor parallelism would claim (``train.step_streamed``), so the
shard axes are JAX's. The activation rules, the placement builders and
``serve_input_specs`` wait for the tensor-parallel 'model' axis
(ROADMAP.md)."""

from __future__ import annotations

from typing import Mapping, Optional

#: parameter placement (Megatron TP / EP): every feature-parallel logical
#: axis maps onto 'model'
TP_RULES: Mapping[str, Optional[str]] = {
    "vocab": "model",
    "heads": "model",
    "ff": "model",
    "expert": "model",
}
