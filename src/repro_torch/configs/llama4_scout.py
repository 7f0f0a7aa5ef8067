"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8), vocab=202048,
every layer MoE with 16 routed experts (top-1, sigmoid routing, per-expert
d_ff=8192) and one always-on shared expert of the same width; the port's copy
of ``repro.configs.llama4_scout``.

The early-fusion frontend is not modelled (the text-token path only), and
iRoPE's chunked attention is treated as full attention, as in the JAX
package. 107.8 B parameters: trains in ``streamed`` mode.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        pattern=(LayerSpec(mixer="attn", moe=True),),
        n_experts=16,
        n_experts_padded=16,
        top_k=1,
        moe_d_ff=8192,
        n_shared_experts=1,
        router_act="sigmoid",
        rope_theta=500_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=32,
        vocab_size=256,
        pattern=(LayerSpec(mixer="attn", moe=True),),
        n_experts=4,
        n_experts_padded=4,
        top_k=1,
        moe_d_ff=32,
        n_shared_experts=1,
        router_act="sigmoid",
        dtype="float32",
        attn_chunk=16, q_chunk=8, loss_chunk=16, capacity_factor=4.0,
    )
