"""Architecture registry of the port: ``--arch <id>`` resolution with the
smoke variants and the trainer mode, for the architectures the port runs,
in the JAX registry's order. The JAX registry's other entries (the
streamed architectures) raise and name the ported ones."""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (gemma3_27b, granite_34b, hubert_xlarge, mamba2_370m,
                                 qwen15_4b, qwen25_32b, qwen2_moe_a27b)
from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    module: object
    trainer_mode: str      # simple | streamed


_ENTRIES = [
    ArchEntry("gemma3-27b", gemma3_27b, "simple"),
    ArchEntry("qwen2.5-32b", qwen25_32b, "simple"),
    ArchEntry("granite-34b", granite_34b, "simple"),
    ArchEntry("qwen1.5-4b", qwen15_4b, "simple"),
    ArchEntry("mamba2-370m", mamba2_370m, "simple"),
    ArchEntry("hubert-xlarge", hubert_xlarge, "simple"),
    ArchEntry("qwen2-moe-a2.7b", qwen2_moe_a27b, "simple"),
]

REGISTRY = {e.arch_id: e for e in _ENTRIES}
ARCH_IDS = [e.arch_id for e in _ENTRIES]


def get_entry(arch_id: str) -> ArchEntry:
    try:
        return REGISTRY[arch_id]
    except KeyError:
        raise KeyError(f"arch {arch_id!r} is not ported (or unknown); ported: "
                       f"{ARCH_IDS}") from None


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    e = get_entry(arch_id)
    return e.module.smoke_config() if smoke else e.module.config()


def trainer_mode(arch_id: str) -> str:
    return get_entry(arch_id).trainer_mode
