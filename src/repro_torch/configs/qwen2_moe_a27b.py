"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (kv=16), vocab=151936, MoE
with 60 routed experts (top-4, per-expert d_ff=1408) and 4 shared experts;
the port's copy of ``repro.configs.qwen2_moe_a27b``.

The 60 routed experts are padded to 64 (the router never selects the 4 null
experts); the shared experts are one dense SwiGLU of width 4 x 1408 = 5632.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=151936,
        pattern=(LayerSpec(mixer="attn", moe=True),),
        qkv_bias=True,
        n_experts=60,
        n_experts_padded=64,
        top_k=4,
        moe_d_ff=1408,
        n_shared_experts=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=32,
        vocab_size=256,
        pattern=(LayerSpec(mixer="attn", moe=True),),
        qkv_bias=True,
        n_experts=6,
        n_experts_padded=8,
        top_k=4,
        moe_d_ff=32,
        n_shared_experts=2,
        dtype="float32",
        attn_chunk=16, q_chunk=8, loss_chunk=16, capacity_factor=4.0,
    )
