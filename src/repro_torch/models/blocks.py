"""Block assembly, the port of ``repro.models.blocks``: (mixer -> residual) +
(FFN -> residual), both pre-normed. The attention mixer with the dense
SwiGLU FFN is ported; MoE FFNs, Mamba2 mixers and the GELU MLP raise.

``block_param_defs`` is the one source of parameter shapes and dtypes; the
model stacks them over the pattern repeats."""

from __future__ import annotations

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import rms_norm, swiglu
from repro_torch.models.rope import apply_rope


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md: the MoE and mamba2 "
                               f"families follow the streamed trainer)")


def block_param_defs(cfg: ModelConfig, spec: LayerSpec) -> dict:
    """name -> (shape, dtype) of one block."""
    dt = cfg.activation_dtype
    d, hd = cfg.d_model, cfg.head_dim
    if spec.mixer != "attn":
        raise _not_ported(f"the {spec.mixer!r} mixer")
    if spec.moe:
        raise _not_ported("the MoE FFN")
    if spec.ffn and cfg.mlp_variant != "swiglu":
        raise _not_ported(f"the {cfg.mlp_variant!r} MLP")
    if cfg.mrope:
        raise _not_ported("M-RoPE")
    defs = {"ln1": ((d,), dt)}
    if spec.ffn:
        defs["ln2"] = ((d,), dt)
    defs.update({
        "wq": ((d, cfg.n_heads * hd), dt),
        "wk": ((d, cfg.n_kv_heads * hd), dt),
        "wv": ((d, cfg.n_kv_heads * hd), dt),
        "wo": ((cfg.n_heads * hd, d), dt),
    })
    if cfg.qkv_bias:
        defs.update({
            "bq": ((cfg.n_heads * hd,), dt),
            "bk": ((cfg.n_kv_heads * hd,), dt),
            "bv": ((cfg.n_kv_heads * hd,), dt),
        })
    if spec.ffn:
        defs.update({
            "w_gate": ((d, cfg.d_ff), dt),
            "w_up": ((d, cfg.d_ff), dt),
            "w_down": ((cfg.d_ff, d), dt),
        })
    return defs


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor):
    b, s, _ = x.shape
    hd = cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, s, cfg.n_heads, hd), k.reshape(b, s, cfg.n_kv_heads, hd),
            v.reshape(b, s, cfg.n_kv_heads, hd))


def block_forward(cfg: ModelConfig, spec: LayerSpec, p: dict, h: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """Training forward of one block: h [B, S, D] -> [B, S, D]."""
    if spec.window is not None:
        raise _not_ported("windowed attention")
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(cfg, p, x)
    if spec.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = attn_lib.chunked_attention(q, k, v, positions_q=positions, positions_kv=positions,
                                     causal=cfg.causal, chunk=cfg.attn_chunk,
                                     remat=cfg.remat)
    b, s = out.shape[:2]
    h = h + out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"]
    if spec.ffn:
        x = rms_norm(h, p["ln2"], cfg.norm_eps)
        h = h + swiglu(x @ p["w_gate"], x @ p["w_up"]) @ p["w_down"]
    return h
