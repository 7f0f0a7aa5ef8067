"""qwen2.5-32b [dense]: 64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064,
GQA + QKV bias; the port's copy of ``repro.configs.qwen25_32b``."""

from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=27648,
        vocab_size=152064,
        pattern=(LayerSpec(mixer="attn"),),
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        pattern=(LayerSpec(mixer="attn"),),
        qkv_bias=True,
        dtype="float32",
        attn_chunk=16, q_chunk=8, loss_chunk=16,
    )
