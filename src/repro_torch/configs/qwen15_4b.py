"""qwen1.5-4b [dense]: 40L d_model=2560 20H (kv=20, full MHA) d_ff=6912
vocab=151936, QKV bias; the port's copy of ``repro.configs.qwen15_4b``."""

from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b",
        family="dense",
        n_layers=40,
        d_model=2560,
        n_heads=20,
        n_kv_heads=20,
        d_ff=6912,
        vocab_size=151936,
        pattern=(LayerSpec(mixer="attn"),),
        qkv_bias=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        pattern=(LayerSpec(mixer="attn"),),
        qkv_bias=True,
        dtype="float32",
        attn_chunk=16, q_chunk=8, loss_chunk=16,
    )
