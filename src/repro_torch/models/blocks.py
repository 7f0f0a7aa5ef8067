"""Block assembly, the port of ``repro.models.blocks``: (mixer -> residual) +
(FFN -> residual), both pre-normed, for training and prefill
(``block_forward``) and for one-token decode against a cache
(``block_decode``). The global attention mixer and the Mamba2 mixer
(``models.mamba2``) are ported, with the dense SwiGLU FFN or none (a
mixer-only block, ``ffn=False``, has no ``ln2``); MoE FFNs, sliding windows
(and their ring caches) and the GELU MLP raise.

``block_param_defs`` is the one source of parameter shapes and dtypes; the
model stacks them over the pattern repeats. ``block_cache_defs`` gives one
block's decode cache: K, V and positions for attention, the conv ring and
the float32 SSD state for mamba."""

from __future__ import annotations

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2
from repro_torch.models.common import rms_norm, swiglu
from repro_torch.models.rope import apply_rope


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md: the MoE family, "
                               f"windowed attention and the GELU MLP come later)")


def mamba_dims(cfg: ModelConfig) -> mamba2.MambaDims:
    return mamba2.MambaDims(d_model=cfg.d_model, d_inner=cfg.d_inner, n_heads=cfg.ssm_heads,
                            head_dim=cfg.ssm_head_dim, d_state=cfg.ssm_state,
                            d_conv=cfg.ssm_conv, chunk=cfg.ssm_chunk)


def _ssm_params(p: dict) -> dict:
    return {k[len("ssm_"):]: v for k, v in p.items() if k.startswith("ssm_")}


def block_param_defs(cfg: ModelConfig, spec: LayerSpec) -> dict:
    """name -> (shape, dtype) of one block."""
    dt = cfg.activation_dtype
    d, hd = cfg.d_model, cfg.head_dim
    if spec.ffn and spec.moe:
        raise _not_ported("the MoE FFN")
    if spec.ffn and cfg.mlp_variant != "swiglu":
        raise _not_ported(f"the {cfg.mlp_variant!r} MLP")
    if cfg.mrope:
        raise _not_ported("M-RoPE")
    defs = {"ln1": ((d,), dt)}
    if spec.ffn:
        defs["ln2"] = ((d,), dt)
    if spec.mixer == "attn":
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
    elif spec.mixer == "mamba":
        defs.update({f"ssm_{k}": v
                     for k, v in mamba2.mamba_param_defs(mamba_dims(cfg), dt).items()})
    else:
        raise ValueError(spec.mixer)
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


def _rope_qk(cfg: ModelConfig, spec: LayerSpec, q, k, positions):
    if not spec.use_rope:
        return q, k
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta)


def _ffn_residual(cfg: ModelConfig, spec: LayerSpec, p: dict, h: torch.Tensor) -> torch.Tensor:
    if not spec.ffn:
        return h
    x = rms_norm(h, p["ln2"], cfg.norm_eps)
    return h + swiglu(x @ p["w_gate"], x @ p["w_up"]) @ p["w_down"]


def block_forward(cfg: ModelConfig, spec: LayerSpec, p: dict, h: torch.Tensor,
                  positions: torch.Tensor, return_cache: bool = False):
    """Training and prefill forward of one block: h [B, S, D] -> [B, S, D],
    and with ``return_cache`` its decode cache: for attention the prompt's K
    and V after RoPE and their positions, as deep as the prompt (JAX's dense
    branch); for mamba the conv tail and the final SSD state."""
    if spec.mixer == "mamba":
        x = rms_norm(h, p["ln1"], cfg.norm_eps)
        out = mamba2.mamba_forward(_ssm_params(p), x, mamba_dims(cfg), return_cache=return_cache)
        if return_cache:
            out, (conv, state) = out
        h = _ffn_residual(cfg, spec, p, h + out)
        return (h, {"conv": conv, "state": state}) if return_cache else h
    if spec.window is not None:
        raise _not_ported("windowed attention")
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(cfg, p, x)
    q, k = _rope_qk(cfg, spec, q, k, positions)
    out = attn_lib.chunked_attention(q, k, v, positions_q=positions, positions_kv=positions,
                                     causal=cfg.causal, chunk=cfg.attn_chunk,
                                     remat=cfg.remat)
    b, s = out.shape[:2]
    h = h + out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"]
    h = _ffn_residual(cfg, spec, p, h)
    if not return_cache:
        return h
    pos = positions.to(torch.int32).clone(memory_format=torch.contiguous_format)
    return h, {"k": k, "v": v, "pos": pos}


def block_decode(cfg: ModelConfig, spec: LayerSpec, p: dict, h: torch.Tensor, cache: dict,
                 positions: torch.Tensor):
    """One-token decode of one block: h [B, 1, D] at ``positions`` [B, 1]
    against ``cache`` -> (h', cache). The new K, V and position go into slot
    ``position % W`` of the cache in place (``index_copy_``, where JAX
    returns an updated copy of its donated cache), then the token attends to
    every filled slot. A mamba block steps its recurrence and writes the
    new conv ring and SSD state into ``cache`` in place."""
    if spec.mixer == "mamba":
        x = rms_norm(h, p["ln1"], cfg.norm_eps)
        out, (ring, state) = mamba2.mamba_decode_step(
            _ssm_params(p), x, (cache["conv"], cache["state"]), mamba_dims(cfg))
        cache["conv"].copy_(ring)
        cache["state"].copy_(state)
        return _ffn_residual(cfg, spec, p, h + out), cache
    if spec.window is not None:
        raise _not_ported("windowed attention")
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(cfg, p, x)
    q, k = _rope_qk(cfg, spec, q, k, positions)
    b, w = cache["k"].shape[:2]
    # flat slot index b * W + position % W into the (B * W, ...) views
    flat = torch.arange(b, device=h.device) * w + (positions[:, 0].long() % w)
    cache["k"].view((b * w,) + tuple(cache["k"].shape[2:])).index_copy_(0, flat, k[:, 0])
    cache["v"].view((b * w,) + tuple(cache["v"].shape[2:])).index_copy_(0, flat, v[:, 0])
    cache["pos"].view(-1).index_copy_(0, flat, positions[:, 0].to(torch.int32))
    out = attn_lib.decode_attention(q, cache["k"], cache["v"], cache["pos"], positions,
                                    window=spec.window, chunk=cfg.decode_chunk)
    h = h + out.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return _ffn_residual(cfg, spec, p, h), cache


def block_cache_defs(cfg: ModelConfig, spec: LayerSpec, batch: int, max_len: int) -> dict:
    """name -> (shape, dtype) of one block's decode cache; position slots are
    int32 (-1 marks an empty slot). A mamba block's cache is the conv ring
    [B, K-1, d_inner + 2N] in the activation dtype and the SSD state
    [B, H, P, N] in float32, whatever ``max_len``."""
    dt = cfg.activation_dtype
    if spec.mixer == "mamba":
        md = mamba_dims(cfg)
        return {"conv": ((batch, md.d_conv - 1, md.d_inner + 2 * md.d_state), dt),
                "state": ((batch, md.n_heads, md.head_dim, md.d_state), torch.float32)}
    if spec.window is not None:
        raise _not_ported("the windowed ring cache")
    return {"k": ((batch, max_len, cfg.n_kv_heads, cfg.head_dim), dt),
            "v": ((batch, max_len, cfg.n_kv_heads, cfg.head_dim), dt),
            "pos": ((batch, max_len), torch.int32)}
