"""Block assembly, the port of ``repro.models.blocks``: (mixer -> residual) +
(FFN -> residual), both pre-normed, for training and prefill
(``block_forward``) and for one-token decode against a cache
(``block_decode``). The mixers: attention, global or under a sliding window
(causal: ``windowed_attention``; bidirectional: the windowed mask of
``chunked_attention``), and Mamba2 (``models.mamba2``). The FFNs: dense
SwiGLU, the GELU MLP with biases, the routed experts of ``models.moe``, or
none (a mixer-only block, ``ffn=False``, has no ``ln2``). M-RoPE raises.

``block_param_defs`` is the one source of parameter shapes and dtypes; the
model stacks them over the pattern repeats. ``block_cache_defs`` gives one
block's decode cache: K, V and positions for attention (a ring of
min(window, max_len) slots under a window), the conv ring and the float32
SSD state for mamba."""

from __future__ import annotations

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import gelu, rms_norm, swiglu
from repro_torch.models.rope import apply_rope


def moe_dims(cfg: ModelConfig) -> moe_lib.MoEDims:
    return moe_lib.MoEDims(n_experts=cfg.n_experts,
                           n_experts_padded=cfg.n_experts_padded or cfg.n_experts,
                           top_k=cfg.top_k, d_model=cfg.d_model, d_ff=cfg.moe_d_ff,
                           capacity_factor=cfg.capacity_factor, router_act=cfg.router_act,
                           renorm_topk=cfg.renorm_topk)


def mamba_dims(cfg: ModelConfig) -> mamba2.MambaDims:
    return mamba2.MambaDims(d_model=cfg.d_model, d_inner=cfg.d_inner, n_heads=cfg.ssm_heads,
                            head_dim=cfg.ssm_head_dim, d_state=cfg.ssm_state,
                            d_conv=cfg.ssm_conv, chunk=cfg.ssm_chunk)


def _sub_params(p: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def block_param_defs(cfg: ModelConfig, spec: LayerSpec) -> dict:
    """name -> (shape, dtype) of one block."""
    dt = cfg.activation_dtype
    d, hd = cfg.d_model, cfg.head_dim
    if cfg.mrope:
        raise NotImplementedError("M-RoPE is not ported yet (ROADMAP.md: qwen2-vl-72b waits "
                                  "for the streamed trainer)")
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
    if not spec.ffn:
        return defs
    if spec.moe:
        shapes = moe_lib.moe_param_shapes(moe_dims(cfg), cfg.n_shared_experts, dt)
        defs.update({f"moe_{k}": v for k, v in shapes.items()})
    elif cfg.mlp_variant == "swiglu":
        defs.update({
            "w_gate": ((d, cfg.d_ff), dt),
            "w_up": ((d, cfg.d_ff), dt),
            "w_down": ((cfg.d_ff, d), dt),
        })
    else:   # the GELU MLP (hubert)
        defs.update({
            "w1": ((d, cfg.d_ff), dt),
            "b1": ((cfg.d_ff,), dt),
            "w2": ((cfg.d_ff, d), dt),
            "b2": ((d,), dt),
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


def _ffn(cfg: ModelConfig, spec: LayerSpec, p: dict, x: torch.Tensor) -> torch.Tensor:
    if spec.moe:
        b, s, d = x.shape
        y = moe_lib.moe_ffn(_sub_params(p, "moe_"), x.reshape(b * s, d), moe_dims(cfg),
                            cfg.moe_impl)
        return y.reshape(b, s, d)
    if cfg.mlp_variant == "swiglu":
        return swiglu(x @ p["w_gate"], x @ p["w_up"]) @ p["w_down"]
    return gelu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _ffn_residual(cfg: ModelConfig, spec: LayerSpec, p: dict, h: torch.Tensor) -> torch.Tensor:
    if not spec.ffn:
        return h
    return h + _ffn(cfg, spec, p, rms_norm(h, p["ln2"], cfg.norm_eps))


def _ring_cache(k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor, w: int) -> dict:
    """The prefill's ring of ``w`` slots: each slot holds the K, V and
    position of the last position p with p % w == the slot (JAX scatters
    every position into slot p % w and the later write wins), -1 and zeros
    where none. Each slot is written once, from a gather."""
    b, s = positions.shape
    slots = (positions % w).long()
    last = torch.full((b, w), -1, dtype=torch.long, device=positions.device)
    order = torch.arange(s, device=positions.device).expand(b, s)
    last.scatter_reduce_(1, slots, order, reduce="amax")
    has, src = last >= 0, last.clamp(min=0)

    def take(x):   # [B, S, KV, D] -> [B, w, KV, D]
        rows = torch.gather(x, 1, src[:, :, None, None].expand((b, w) + x.shape[2:]))
        return torch.where(has[:, :, None, None], rows, torch.zeros((), dtype=x.dtype,
                                                                    device=x.device))

    pos = torch.where(has, positions.gather(1, src).to(torch.int32),
                      torch.full((), -1, dtype=torch.int32, device=positions.device))
    return {"k": take(k), "v": take(v), "pos": pos}


def block_forward(cfg: ModelConfig, spec: LayerSpec, p: dict, h: torch.Tensor,
                  positions: torch.Tensor, return_cache: bool = False):
    """Training and prefill forward of one block: h [B, S, D] -> [B, S, D],
    and with ``return_cache`` its decode cache: for attention the prompt's K
    and V after RoPE and their positions, as deep as the prompt (JAX's dense
    branch), or, under a window shorter than the prompt, the ring of
    ``_ring_cache``; for mamba the conv tail and the final SSD state."""
    if spec.mixer == "mamba":
        x = rms_norm(h, p["ln1"], cfg.norm_eps)
        out = mamba2.mamba_forward(_sub_params(p, "ssm_"), x, mamba_dims(cfg),
                                   return_cache=return_cache)
        if return_cache:
            out, (conv, state) = out
        h = _ffn_residual(cfg, spec, p, h + out)
        return (h, {"conv": conv, "state": state}) if return_cache else h
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(cfg, p, x)
    q, k = _rope_qk(cfg, spec, q, k, positions)
    if spec.window is not None and cfg.causal:
        out = attn_lib.windowed_attention(q, k, v, positions=positions, window=spec.window,
                                          q_chunk=min(cfg.q_chunk, q.shape[1]),
                                          remat=cfg.remat)
    else:
        out = attn_lib.chunked_attention(q, k, v, positions_q=positions,
                                         positions_kv=positions, causal=cfg.causal,
                                         window=spec.window, chunk=cfg.attn_chunk,
                                         remat=cfg.remat)
    b, s = out.shape[:2]
    h = h + out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"]
    h = _ffn_residual(cfg, spec, p, h)
    if not return_cache:
        return h
    if spec.window is not None and spec.window < s:
        return h, _ring_cache(k, v, positions, spec.window)
    pos = positions.to(torch.int32).clone(memory_format=torch.contiguous_format)
    return h, {"k": k, "v": v, "pos": pos}


def block_decode(cfg: ModelConfig, spec: LayerSpec, p: dict, h: torch.Tensor, cache: dict,
                 positions: torch.Tensor):
    """One-token decode of one block: h [B, 1, D] at ``positions`` [B, 1]
    against ``cache`` -> (h', cache). The new K, V and position go into slot
    ``position % W`` of the cache in place (``index_copy_``, where JAX
    returns an updated copy of its donated cache), then the token attends to
    every filled slot (within the window, for a ring). A mamba block steps
    its recurrence and writes the new conv ring and SSD state into ``cache``
    in place."""
    if spec.mixer == "mamba":
        x = rms_norm(h, p["ln1"], cfg.norm_eps)
        out, (ring, state) = mamba2.mamba_decode_step(
            _sub_params(p, "ssm_"), x, (cache["conv"], cache["state"]), mamba_dims(cfg))
        cache["conv"].copy_(ring)
        cache["state"].copy_(state)
        return _ffn_residual(cfg, spec, p, h + out), cache
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
    int32 (-1 marks an empty slot); under a window, a ring of min(window,
    max_len) slots. A mamba block's cache is the conv ring
    [B, K-1, d_inner + 2N] in the activation dtype and the SSD state
    [B, H, P, N] in float32, whatever ``max_len``."""
    dt = cfg.activation_dtype
    if spec.mixer == "mamba":
        md = mamba_dims(cfg)
        return {"conv": ((batch, md.d_conv - 1, md.d_inner + 2 * md.d_state), dt),
                "state": ((batch, md.n_heads, md.head_dim, md.d_state), torch.float32)}
    w = min(spec.window, max_len) if spec.window is not None else max_len
    return {"k": ((batch, w, cfg.n_kv_heads, cfg.head_dim), dt),
            "v": ((batch, w, cfg.n_kv_heads, cfg.head_dim), dt),
            "pos": ((batch, w), torch.int32)}
