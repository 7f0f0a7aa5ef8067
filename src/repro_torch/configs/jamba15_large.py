"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2, Mamba + attention 1:7 interleave; the port's copy
of ``repro.configs.jamba15_large``.

Pattern (length 8, repeated 9x): mamba at every position except index 4
(attention), the routed-experts FFN on the odd positions, dense on the even
ones: 9 attention layers, 36 MoE layers. Attention layers carry no RoPE.
The mixers are the SSD (Mamba2) formulation at Jamba's d_state 16, as in
the JAX package. About 398 B parameters: trains in ``streamed`` mode.

``card_config(positions)`` keeps every published width and cuts the pattern
to ``config().pattern[a:b]`` with one repeat, so a superblock (the streamed
trainer's unit) holds blocks of the real pattern: nothing of the full
pattern fits one card (one repeat is 45.1 B parameters, 90.3 GB in bf16).
"""

import dataclasses

from repro_torch.configs.base import LayerSpec, ModelConfig

_MAMBA_DENSE = LayerSpec(mixer="mamba")
_MAMBA_MOE = LayerSpec(mixer="mamba", moe=True)
_ATTN_DENSE = LayerSpec(mixer="attn", use_rope=False)


def _pattern():
    # positions 0..7; attention replaces mamba at position 4; MoE on odd positions
    out = []
    for i in range(8):
        if i == 4:
            out.append(_ATTN_DENSE)
        elif i % 2 == 1:
            out.append(_MAMBA_MOE)
        else:
            out.append(_MAMBA_DENSE)
    return tuple(out)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=24576,
        vocab_size=65536,
        pattern=_pattern(),
        n_experts=16,
        n_experts_padded=16,
        top_k=2,
        moe_d_ff=24576,
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=64,
        supports_long_context=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b-smoke",
        family="hybrid",
        n_layers=8,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        pattern=tuple(
            LayerSpec(mixer="attn", use_rope=False) if i == 4
            else LayerSpec(mixer="mamba", moe=(i % 2 == 1))
            for i in range(8)
        ),
        n_experts=4,
        n_experts_padded=4,
        top_k=2,
        moe_d_ff=32,
        ssm_state=8,
        ssm_head_dim=16,
        ssm_chunk=8,
        supports_long_context=True,
        dtype="float32",
        attn_chunk=16, q_chunk=8, loss_chunk=16, capacity_factor=4.0,
    )


def card_config(positions, smoke: bool = False) -> ModelConfig:
    """``config()`` (or ``smoke_config()``) with the pattern cut to
    ``pattern[a:b]`` for ``positions`` = (a, b) and one repeat of it:
    ``n_layers = b - a``, every width as published. The name says the cut,
    ``jamba-1.5-large-398b@p2-4`` for (2, 5)."""
    base = smoke_config() if smoke else config()
    a, b = (int(p) for p in positions)
    if not 0 <= a < b <= len(base.pattern):
        raise ValueError(f"positions {positions!r} are not a cut of the "
                         f"{len(base.pattern)}-position pattern")
    return dataclasses.replace(base, name=f"{base.name}@p{a}-{b - 1}",
                               n_layers=b - a, pattern=base.pattern[a:b])
