"""Transformer layers of the dense family: RMSNorm, RoPE, flash and decode
attention with GQA + KV cache, SwiGLU MLP, embeddings (counterpart of
``repro.models.layers``).

Pure functions over parameter dicts of tensors.  The layers cast weights
to the activation dtype with ``.to(dt)`` as the reference does; a caller
that hands them weights already in that dtype (the serving engine keeps
one compute-dtype copy) pays no cast.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

import repro_torch.ff as ff
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor
Params = Dict[str, Any]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: Tensor, w: Tensor, eps: float, ff_stats: bool = False
             ) -> Tensor:
    """RMSNorm; with ff_stats=True the mean-square is a compensated sum
    (``ff.mean_sq``: the fused CUDA kernel on the card)."""
    xf = x.to(torch.float32).contiguous()
    if ff_stats:
        ms = ff.mean_sq(xf)[..., None]
    else:
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    scale = torch.rsqrt(ms + eps).to(x.dtype)
    return x * scale * w.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                       # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs       # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                    block_q: int, block_kv: int, q_offset: int = 0,
                    impl: str = "fast") -> Tensor:
    """Blockwise attention through the ``ff.attention`` registry."""
    return ff.attention(q, k, v, causal=causal, q_offset=q_offset,
                        block_q=block_q, block_kv=block_kv, impl=impl)


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     cache_len, *, impl: str = "fast") -> Tensor:
    """Single-position attention against a partially filled cache.

    q: (B, 1, H, hd); caches: (B, Smax, KV, hd); cache_len: an int or a
    (B,) int tensor of valid positions per row (ragged serving batches).
    Accurate impls route through ``ff.attention(causal=False, kv_len=...)``.
    """
    B, _, H, hd = q.shape
    cache_len = torch.as_tensor(cache_len, dtype=torch.int32,
                                device=q.device)
    if impl != "fast":
        kv_len = torch.broadcast_to(cache_len, (B,))
        return ff.attention(q, k_cache, v_cache, causal=False,
                            kv_len=kv_len, impl=impl)
    _, Smax, KV, _ = k_cache.shape
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    q4 = q.reshape(B, KV, G, hd).to(torch.float32) * scale
    kf = k_cache.to(torch.float32)
    s = torch.einsum("bkgd,bskd->bkgs", q4, kf)                 # (B,KV,G,S)
    pos = torch.arange(Smax, device=q.device)
    if cache_len.ndim:
        valid = (pos[None] < cache_len[:, None])[:, None, None]
    else:
        valid = (pos < cache_len)[None, None, None]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p / torch.clamp_min(l, 1e-30),
                       v_cache.to(torch.float32))
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _qkv(p: Params, x: Tensor, cfg: ModelConfig, S: int):
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, S, cfg.num_heads, hd)
    k = (x @ p["wk"].to(dt)).reshape(B, S, cfg.num_kv_heads, hd)
    v = (x @ p["wv"].to(dt)).reshape(B, S, cfg.num_kv_heads, hd)
    return q, k, v


def attn_apply(p: Params, x: Tensor, cfg: ModelConfig, *,
               positions: Tensor, causal: bool = True,
               attn_impl: str = "fast") -> Tensor:
    """Full-sequence attention (training)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, S)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=causal, block_q=cfg.attn_block_q,
                        block_kv=cfg.attn_block_kv, impl=attn_impl)
    return o.reshape(B, S, -1) @ p["wo"].to(x.dtype)


def attn_prefill(p: Params, x: Tensor, cfg: ModelConfig, *,
                 positions: Tensor, cache: Params,
                 attn_impl: str = "fast") -> Tuple[Tensor, Params]:
    """Full-sequence causal attention that also writes the KV cache.  The
    cache tensors are updated in place (the reference returns a new
    pytree); the same dict is returned."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, S)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=True, block_q=cfg.attn_block_q,
                        block_kv=cfg.attn_block_kv, impl=attn_impl)
    cache["k"][:, :S] = k.to(cache["k"].dtype)
    cache["v"][:, :S] = v.to(cache["v"].dtype)
    return o.reshape(B, S, -1) @ p["wo"].to(x.dtype), cache


def attn_decode(p: Params, x: Tensor, cfg: ModelConfig, *, pos: int,
                cache: Params, attn_impl: str = "fast"
                ) -> Tuple[Tensor, Params]:
    """One-token decode: write the cache at ``pos`` (in place), attend to
    cache[:pos+1]."""
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"attn_decode takes one position, got {S}")
    q, k, v = _qkv(p, x, cfg, 1)
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    cache["k"][:, pos] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v[:, 0].to(cache["v"].dtype)
    o = decode_attention(q, cache["k"], cache["v"], pos + 1, impl=attn_impl)
    return o.reshape(B, 1, -1) @ p["wo"].to(x.dtype), cache


def attn_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                    dtype=torch.bfloat16, device=None) -> Params:
    hd = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# SwiGLU MLP, embeddings
# ---------------------------------------------------------------------------

def mlp_apply(p: Params, x: Tensor, ff_math: bool = False) -> Tensor:
    """SwiGLU MLP.  ``ff_math=True`` (the policy's ``ff_math`` switch)
    computes the silu gate with the FF elementary function (``ff.silu``,
    ~2^-43; one ``ff_math`` kernel on the card under
    ``ff.use(silu="pallas")``) in place of the f32 builtin."""
    dt = x.dtype
    pre = x @ p["w_gate"].to(dt)
    if ff_math:
        g = ff.to_f32(ff.silu(pre.to(torch.float32))).to(dt)
    else:
        g = F.silu(pre)
    u = x @ p["w_up"].to(dt)
    return (g * u) @ p["w_down"].to(dt)


def embed_apply(p: Params, tokens: Tensor, dtype) -> Tensor:
    return p["tok"].to(dtype)[tokens]


def unembed_apply(p: Params, x: Tensor, cfg: ModelConfig,
                  ff_math: bool = False) -> Tensor:
    """Unembedding (+ optional logit soft-cap).  ``ff_math=True`` runs the
    soft-cap tanh through ``ff.tanh`` (the cap is the last op before the
    loss and log-prob reductions)."""
    dt = x.dtype
    w = p["unembed"].to(dt) if "unembed" in p else p["tok"].to(dt).T
    logits = x @ w
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        if ff_math:
            lf = logits.to(torch.float32)
            t = ff.tanh(lf / torch.full_like(lf, c))
            logits = (c * ff.to_f32(t)).to(dt)
        else:
            logits = c * torch.tanh(logits / c)
    return logits
