"""Model assembly for the dense family: params / cache / prefill / decode
(counterpart of ``repro.models.model``).

Params are a dict laid out like the reference's pytree, with the layers
stacked on a leading L axis (``params["layers"]["attn"]["wq"]`` is
(L, d, H*hd)); a Python loop over layers takes the place of ``lax.scan``.
The KV cache is updated in place.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

import repro_torch.ff as ff
from repro_torch import resolve_device
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attn_cache_init, attn_decode,
                                       attn_prefill, embed_apply, mlp_apply,
                                       rms_norm, unembed_apply)

Tensor = torch.Tensor
Params = Dict[str, Any]


def check_supported(cfg: ModelConfig, policy: PrecisionPolicy) -> None:
    """The port serves the dense GQA family without ``ff_math`` so far."""
    if cfg.family != "dense" or cfg.use_mla or cfg.moe_num_experts:
        raise NotImplementedError(
            f"repro_torch models the dense GQA family only; got family="
            f"{cfg.family!r}, use_mla={cfg.use_mla}, moe_num_experts="
            f"{cfg.moe_num_experts}")
    if policy.ff_math:
        raise NotImplementedError("policy ff_math=True (FF silu/tanh/"
                                  "scoring) is not ported yet")


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a layer-stacked dict (views, no copy)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """One copy of the weights in ``dtype`` (the values every ``.to(dt)``
    in the layers would produce; a no-op for tensors already in it)."""
    return {k: cast_params(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in params.items()}


# ===========================================================================
# parameter init
# ===========================================================================

def init_params(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Random dense-family weights from ``generator`` (on the generator's
    device): normal / sqrt(fan_in) matrices, unit norm weights."""
    check_supported(cfg, PrecisionPolicy())
    dev = generator.device
    L, d, hd = cfg.num_layers, cfg.d_model, cfg.resolved_head_dim

    def dense(shape):
        fan_in = shape[-2]
        return torch.randn(shape, generator=generator, device=dev) \
            * (1.0 / math.sqrt(fan_in))

    embed = {"tok": dense((cfg.vocab_size, d))}
    if not cfg.tie_embeddings:
        embed["unembed"] = dense((d, cfg.vocab_size))
    ones = torch.ones((L, d), device=dev)
    layers = {
        "ln1": ones, "ln2": ones.clone(),
        "attn": {"wq": dense((L, d, cfg.num_heads * hd)),
                 "wk": dense((L, d, cfg.num_kv_heads * hd)),
                 "wv": dense((L, d, cfg.num_kv_heads * hd)),
                 "wo": dense((L, cfg.num_heads * hd, d))},
        "ffn": {"w_gate": dense((L, d, cfg.d_ff)),
                "w_up": dense((L, d, cfg.d_ff)),
                "w_down": dense((L, cfg.d_ff, d))},
    }
    return {"embed": embed, "final_norm": torch.ones((d,), device=dev),
            "layers": layers}


# ===========================================================================
# serving: prefill + decode
# ===========================================================================

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Params:
    """Layer-stacked KV cache: {"layers": {"k", "v": (L, B, S, KV, hd)}}."""
    one = attn_cache_init(cfg, batch, max_len, dtype,
                          resolve_device(device))
    return {"layers": {n: t[None].repeat((cfg.num_layers,) + (1,) * t.ndim)
                       for n, t in one.items()}}


def _stack(params: Params, x: Tensor, cfg: ModelConfig,
           policy: PrecisionPolicy, cache: Params, attn) -> Tensor:
    """The layer loop shared by prefill and decode; ``attn(lp, z, lcache)``
    runs one layer's attention and writes its cache."""
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        lcache = layer(cache["layers"], i)
        z = rms_norm(x, lp["ln1"], cfg.norm_eps,
                     ff_stats=policy.ff_reductions)
        x = x + attn(lp["attn"], z, lcache)
        z = rms_norm(x, lp["ln2"], cfg.norm_eps,
                     ff_stats=policy.ff_reductions)
        x = x + mlp_apply(lp["ffn"], z)
    return x


def prefill(params: Params, batch: Dict[str, Tensor], cfg: ModelConfig,
            cache: Params, policy: Optional[PrecisionPolicy] = None
            ) -> Tuple[Tensor, Params]:
    """Run the prompt through the model, filling the cache.  Returns
    (last-position logits (B, V), cache)."""
    policy = ff.resolve_policy(policy)
    check_supported(cfg, policy)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_apply(params["embed"], tokens, compute_dtype(cfg))
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)

    def attn(p, z, lcache):
        return attn_prefill(p, z, cfg, positions=positions, cache=lcache,
                            attn_impl=policy.attention)[0]

    x = _stack(params, x, cfg, policy, cache, attn)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps,
                 ff_stats=policy.ff_reductions)
    return unembed_apply(params["embed"], x, cfg)[:, 0], cache


def decode_step(params: Params, token: Tensor, pos: int, cache: Params,
                cfg: ModelConfig, policy: Optional[PrecisionPolicy] = None
                ) -> Tuple[Tensor, Params]:
    """One decode step.  token: (B, 1) int; pos: the write index.
    Returns (logits (B, V), cache)."""
    policy = ff.resolve_policy(policy)
    check_supported(cfg, policy)
    x = embed_apply(params["embed"], token, compute_dtype(cfg))

    def attn(p, z, lcache):
        return attn_decode(p, z, cfg, pos=pos, cache=lcache,
                           attn_impl=policy.attention)[0]

    x = _stack(params, x, cfg, policy, cache, attn)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps,
                 ff_stats=policy.ff_reductions)
    return unembed_apply(params["embed"], x, cfg)[:, 0], cache
