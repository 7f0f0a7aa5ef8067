"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064, QKV bias, M-RoPE with sections (16, 24, 24) of head_dim / 2 =
64; the port's copy of ``repro.configs.qwen2_vl_72b``.

The backbone only: the vision frontend is a stub, so the inputs are
precomputed embeddings [B, S, d_model] with the three M-RoPE position streams
``positions3`` [B, S, 3]. 71.5 B parameters: trains in ``streamed`` mode.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=29568,
        vocab_size=152064,
        pattern=(LayerSpec(mixer="attn"),),
        qkv_bias=True,
        input_kind="embeddings",
        mrope=True,
        mrope_sections=(16, 24, 24),
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        pattern=(LayerSpec(mixer="attn"),),
        qkv_bias=True,
        input_kind="embeddings",
        mrope=True,
        mrope_sections=(4, 2, 2),
        dtype="float32",
        attn_chunk=16, q_chunk=8, loss_chunk=16,
    )
