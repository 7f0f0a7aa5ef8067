"""mamba2-370m [ssm]: 48L d_model=1024 attn-free, vocab=50280, ssm_state=128:
SSD (state-space duality, arXiv:2405.21060); the port's copy of
``repro.configs.mamba2_370m``.

A pure mamba2 stack: mixer-only blocks (no FFN), tied embeddings. Decode
carries an O(1) state, so long contexts run.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        n_layers=48,
        d_model=1024,
        n_heads=1,            # unused (attn-free)
        n_kv_heads=1,
        d_ff=0,
        vocab_size=50280,
        pattern=(LayerSpec(mixer="mamba", ffn=False),),
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        tie_embeddings=True,
        supports_long_context=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab_size=256,
        pattern=(LayerSpec(mixer="mamba", ffn=False),),
        ssm_state=16,
        ssm_head_dim=16,
        ssm_chunk=8,
        tie_embeddings=True,
        supports_long_context=True,
        dtype="float32",
        loss_chunk=16,
    )
