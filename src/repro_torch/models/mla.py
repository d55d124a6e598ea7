"""Multi-head Latent Attention (DeepSeek-V2) with its compressed KV cache
(counterpart of ``repro.models.mla``).

Queries come through the low-rank ``q_lora`` path; keys and values
through a shared ``kv_lora_rank`` latent, which is the cache, beside a
decoupled RoPE key slice.  Prefill up-projects the latent to per-head K/V
and runs flash attention at head dim qk_nope + qk_rope (v zero-padded to
it: 192 at full size, the attention kernel's HD = 192 instance under
``attention="pallas"`` on the card).  Decode takes the absorbed form (q
projected into the latent space), touching only (B, S, kv_lora + rope)
a step.  The cache is updated in place.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

import repro_torch.ff as ff
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (NEG_INF, apply_rope, flash_attention,
                                       rms_norm)

Tensor = torch.Tensor
Params = Dict[str, Any]


def mla_params(cfg: ModelConfig, dense, ones) -> Params:
    """One MLA layer's weights; ``dense(shape)`` draws a matrix (normal /
    sqrt(shape[-2])), ``ones(n)`` a norm weight, each with any leading
    layer axis."""
    H, d = cfg.num_heads, cfg.d_model
    dq = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    r = cfg.kv_lora_rank
    return {
        "wq_a": dense((d, cfg.q_lora_rank)),
        "q_norm": ones(cfg.q_lora_rank),
        "wq_b": dense((cfg.q_lora_rank, H * dq)),
        "wkv_a": dense((d, r + cfg.qk_rope_head_dim)),
        "kv_norm": ones(r),
        "wk_b": dense((r, H * cfg.qk_nope_head_dim)),
        "wv_b": dense((r, H * cfg.v_head_dim)),
        "wo": dense((H * cfg.v_head_dim, d)),
    }


def _project_q(p: Params, x: Tensor, cfg: ModelConfig, positions: Tensor):
    B, S, _ = x.shape
    dt = x.dtype
    q_lat = rms_norm(x @ p["wq_a"].to(dt), p["q_norm"], cfg.norm_eps)
    q = (q_lat @ p["wq_b"].to(dt)).reshape(
        B, S, cfg.num_heads, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    q_nope = q[..., :cfg.qk_nope_head_dim]
    q_rope = apply_rope(q[..., cfg.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    return q_nope, q_rope


def _project_latent(p: Params, x: Tensor, cfg: ModelConfig,
                    positions: Tensor):
    dt = x.dtype
    kv = x @ p["wkv_a"].to(dt)
    c_kv = rms_norm(kv[..., :cfg.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., cfg.kv_lora_rank:][:, :, None, :],
                        positions, cfg.rope_theta)[:, :, 0]  # (B, S, dr)
    return c_kv, k_rope


def mla_apply(p: Params, x: Tensor, cfg: ModelConfig, *,
              positions: Tensor, attn_impl: str = "fast") -> Tensor:
    """Training / prefill: the latent up-projected to per-head K/V, causal
    flash attention at head dim qk_nope + qk_rope."""
    B, S, _ = x.shape
    H, dt = cfg.num_heads, x.dtype
    q_nope, q_rope = _project_q(p, x, cfg, positions)
    c_kv, k_rope = _project_latent(p, x, cfg, positions)
    k_nope = (c_kv @ p["wk_b"].to(dt)).reshape(B, S, H, cfg.qk_nope_head_dim)
    v = (c_kv @ p["wv_b"].to(dt)).reshape(B, S, H, cfg.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, cfg.qk_rope_head_dim)], dim=-1)
    # v padded to the qk head dim for the shared flash kernel, sliced back
    dq = q.shape[-1]
    if cfg.v_head_dim < dq:
        v = F.pad(v, (0, dq - cfg.v_head_dim))
    o = flash_attention(q, k, v, causal=True, block_q=cfg.attn_block_q,
                        block_kv=cfg.attn_block_kv, impl=attn_impl)
    o = o[..., :cfg.v_head_dim].reshape(B, S, H * cfg.v_head_dim)
    return o @ p["wo"].to(dt)


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None) -> Params:
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


def mla_prefill(p: Params, x: Tensor, cfg: ModelConfig, *, positions: Tensor,
                cache: Params, attn_impl: str = "fast"
                ) -> Tuple[Tensor, Params]:
    """``mla_apply`` that also writes the latent cache (in place)."""
    S = x.shape[1]
    c_kv, k_rope = _project_latent(p, x, cfg, positions)
    cache["c_kv"][:, :S] = c_kv.to(cache["c_kv"].dtype)
    cache["k_rope"][:, :S] = k_rope.to(cache["k_rope"].dtype)
    return mla_apply(p, x, cfg, positions=positions,
                     attn_impl=attn_impl), cache


def mla_decode(p: Params, x: Tensor, cfg: ModelConfig, *, pos: int,
               cache: Params, attn_impl: str = "fast"
               ) -> Tuple[Tensor, Params]:
    """Absorbed decode: score = q_nope Wk_b c_kv + q_rope k_rope over the
    latent cache; output = (softmax @ c_kv) absorbed through Wv_b.

    ``attn_impl="fast"`` is the reference's dense softmax.  Any other impl
    is one attention call with a single shared KV head, q = [q_eff ‖
    q_rope], k = [c_kv ‖ k_rope], v = c_kv zero-padded, head dim
    kv_lora + rope (576 at full size) and ``kv_len``: ``ff.attention``'s
    compensated class (under ``pallas`` the dispatch's ``kv_len`` route to
    the ``ff`` tier, with its warning, as the reference's)."""
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"mla_decode takes one position, got {S}")
    H, dt, dev = cfg.num_heads, x.dtype, x.device
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    f32 = torch.float32
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=dev)
    q_nope, q_rope = _project_q(p, x, cfg, posv)             # (B, 1, H, *)
    c_new, kr_new = _project_latent(p, x, cfg, posv)
    cache["c_kv"][:, pos] = c_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][:, pos] = kr_new[:, 0].to(cache["k_rope"].dtype)
    c_kv = cache["c_kv"].to(f32)                               # (B, Smax, r)
    k_rope = cache["k_rope"].to(f32)                           # (B, Smax, dr)
    Smax = c_kv.shape[1]

    wk_b = p["wk_b"].to(f32).reshape(r, H, cfg.qk_nope_head_dim)
    q_eff = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].to(f32), wk_b)
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + dr)
    if attn_impl != "fast":
        q_cat = torch.cat([q_eff, q_rope[:, 0].to(f32)], dim=-1)[:, None]
        k_cat = torch.cat([c_kv, k_rope], dim=-1)[:, :, None]
        v_lat = F.pad(c_kv, (0, dr))[:, :, None]
        kv_len = torch.full((B,), pos + 1, dtype=torch.int32, device=dev)
        lat = ff.attention(q_cat, k_cat, v_lat, causal=False, kv_len=kv_len,
                           scale=scale, impl=attn_impl)[:, 0, :, :r]
    else:
        s = (torch.einsum("bhr,bsr->bhs", q_eff, c_kv)
             + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].to(f32), k_rope))
        s = s * scale
        valid = torch.arange(Smax, device=dev) <= pos
        s = torch.where(valid[None, None], s, NEG_INF)
        lat = torch.einsum("bhs,bsr->bhr", torch.softmax(s, dim=-1), c_kv)
    wv_b = p["wv_b"].to(f32).reshape(r, H, cfg.v_head_dim)
    o = torch.einsum("bhr,rhd->bhd", lat, wv_b).reshape(
        B, 1, H * cfg.v_head_dim)
    return o.to(dt) @ p["wo"].to(dt), cache
