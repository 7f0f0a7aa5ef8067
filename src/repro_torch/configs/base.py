"""Config schema of the model zoo, the port's copy of ``repro.configs.base``.

A model is ``n_layers`` blocks arranged as ``n_repeats`` repetitions of a
``pattern`` (a tuple of LayerSpec); parameters of a pattern position are
stacked over the repeats, as in the JAX package, so the parameter leaves
(and the seeds the trainer derives from their order) are the same; the
``tail_pattern`` blocks after the repeats are not stacked. Only the fields
the ported model reads are kept; M-RoPE is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"            # attn | mamba
    window: Optional[int] = None   # sliding-window width (attn only); None = global
    use_rope: bool = True
    moe: bool = False              # routed-experts FFN instead of dense
    ffn: bool = True               # False: mixer-only block


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    tail_pattern: Tuple[LayerSpec, ...] = ()
    d_head: Optional[int] = None   # default d_model // n_heads
    qkv_bias: bool = False
    causal: bool = True
    input_kind: str = "tokens"     # tokens | embeddings (frames [B, S, d_model])
    mlp_variant: str = "swiglu"    # swiglu | gelu
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    mrope: bool = False
    norm_eps: float = 1e-6
    # --- MoE ---
    n_experts: int = 0
    n_experts_padded: int = 0      # >= n_experts; the router never selects the padding
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_act: str = "softmax"    # softmax | sigmoid
    renorm_topk: bool = False
    moe_impl: str = "gather"       # gather | dense
    # --- Mamba/SSD ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 4
    # --- execution ---
    dtype: str = "bfloat16"
    attn_chunk: int = 1024         # kv-chunk of the online-softmax attention
    q_chunk: int = 512             # q-chunk of the windowed attention
    loss_chunk: int = 512          # seq-chunk of the softmax-xent loop
    decode_chunk: int = 8192       # kv-chunk of decode attention
    remat: bool = True
    supports_decode: bool = True   # False: an encoder-only model serves no decode

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def n_repeats(self) -> int:
        body = self.n_layers - len(self.tail_pattern)
        if body % len(self.pattern):
            raise ValueError(f"{self.name}: {body} layers are not whole repeats of a "
                             f"{len(self.pattern)}-layer pattern")
        return body // len(self.pattern)

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim
