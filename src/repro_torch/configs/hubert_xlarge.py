"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504,
an encoder-only transformer; the port's copy of
``repro.configs.hubert_xlarge``.

The inputs are frame embeddings [B, T, d_model] (the conv feature extractor
is a stub in the JAX package too); the loss is per-frame classification over
the 504-unit codebook. Bidirectional attention, the GELU MLP, no decode.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        pattern=(LayerSpec(mixer="attn"),),
        causal=False,
        input_kind="embeddings",
        mlp_variant="gelu",
        supports_decode=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-smoke",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=32,
        pattern=(LayerSpec(mixer="attn"),),
        causal=False,
        input_kind="embeddings",
        mlp_variant="gelu",
        supports_decode=False,
        dtype="float32",
        attn_chunk=16, q_chunk=8, loss_chunk=16,
    )
