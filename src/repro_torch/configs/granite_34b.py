"""granite-34b [dense]: 88L d_model=6144 48H (GQA kv=1, i.e. MQA) d_ff=24576
vocab=49152, a llama-arch code model; the port's copy of
``repro.configs.granite_34b``."""

from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-34b",
        family="dense",
        n_layers=88,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_ff=24576,
        vocab_size=49152,
        pattern=(LayerSpec(mixer="attn"),),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-34b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=256,
        pattern=(LayerSpec(mixer="attn"),),
        dtype="float32",
        attn_chunk=16, q_chunk=8, loss_chunk=16,
    )
