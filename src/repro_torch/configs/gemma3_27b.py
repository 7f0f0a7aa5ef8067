"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144, 5:1 local:global sliding-window attention; the port's copy of
``repro.configs.gemma3_27b``.

62 = 10 x (5 local + 1 global) + 2 local tail layers (``tail_pattern``,
not stacked). Window 1024: a local layer's decode cache is a 1024-slot
ring. head_dim is d_model / n_heads = 168, as the JAX config has it.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

_LOCAL = LayerSpec(mixer="attn", window=1024)
_GLOBAL = LayerSpec(mixer="attn", window=None)


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b",
        family="dense",
        n_layers=62,
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        d_ff=21504,
        vocab_size=262144,
        pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
        tail_pattern=(_LOCAL, _LOCAL),
        tie_embeddings=True,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b-smoke",
        family="dense",
        n_layers=8,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        pattern=(LayerSpec(mixer="attn", window=8),) * 5 + (LayerSpec(mixer="attn"),),
        tail_pattern=(LayerSpec(mixer="attn", window=8),) * 2,
        tie_embeddings=True,
        dtype="float32",
        attn_chunk=16, q_chunk=8, loss_chunk=16,
    )
