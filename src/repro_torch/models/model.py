"""Model assembly for the dense family: params / train_forward / cache /
prefill / decode (counterpart of ``repro.models.model``).

Params are a dict laid out like the reference's pytree, with the layers
stacked on a leading L axis (``params["layers"]["attn"]["wq"]`` is
(L, d, H*hd)); a Python loop over layers takes the place of ``lax.scan``,
and ``torch.utils.checkpoint`` of ``jax.checkpoint`` (``cfg.remat``).
The KV cache is updated in place.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

import repro_torch.ff as ff
from repro_torch import resolve_device
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.ff import scope as ff_scope
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attn_apply, attn_cache_init,
                                       attn_decode, attn_prefill,
                                       embed_apply, mlp_apply, rms_norm,
                                       unembed_apply)

Tensor = torch.Tensor
Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """The port models the dense GQA family, serving and training, under
    every policy (``ff_math`` included: the FF functions carry their
    reference gradients)."""
    if cfg.family != "dense" or cfg.use_mla or cfg.moe_num_experts:
        raise NotImplementedError(
            f"repro_torch models the dense GQA family only; got family="
            f"{cfg.family!r}, use_mla={cfg.use_mla}, moe_num_experts="
            f"{cfg.moe_num_experts}")


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a layer-stacked dict (views, no copy)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def unstack_layers(tree: Params, n: int) -> List[Params]:
    """The ``n`` per-layer dicts of a layer-stacked dict, from one
    ``torch.unbind`` per leaf.  Its backward is one stack per leaf;
    indexing ``t[i]`` per layer instead would make each layer's backward
    fill a zero tensor the size of the whole stack."""
    out: List[Params] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = (unstack_layers(v, n) if isinstance(v, dict)
                 else torch.unbind(v, 0))
        for d, part in zip(out, parts):
            d[k] = part
    return out


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
    check_supported(cfg)
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
# training forward + loss
# ===========================================================================

def _decoder_layer(x: Tensor, lp: Params, cfg: ModelConfig,
                   policy: PrecisionPolicy, positions: Tensor) -> Tensor:
    h = rms_norm(x, lp["ln1"], cfg.norm_eps, ff_stats=policy.ff_reductions)
    x = x + attn_apply(lp["attn"], h, cfg, positions=positions,
                       attn_impl=policy.attention)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps, ff_stats=policy.ff_reductions)
    return x + mlp_apply(lp["ffn"], h, ff_math=policy.ff_math)


def _run_stack(params: Params, x: Tensor, cfg: ModelConfig,
               policy: PrecisionPolicy, positions: Tensor) -> Tensor:
    """The layer loop of training.  With ``cfg.remat`` each layer keeps
    only its input and recomputes the rest in the backward pass."""
    scoped = ff_scope.captured()

    def body(h, lp):
        with scoped():
            return _decoder_layer(h, lp, cfg, policy, positions)

    for lp in unstack_layers(params["layers"], cfg.num_layers):
        if cfg.remat:
            # the layer draws no random numbers: no RNG state to restore
            x = checkpoint(body, x, lp, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = body(x, lp)
    return x


def _gold(logits: Tensor, targets: Tensor) -> Tensor:
    """``logits[..., targets]``; a negative (masked) target reads entry 0,
    which the mask then zeroes."""
    idx = targets.clamp_min(0).long()[..., None]
    return torch.gather(logits, -1, idx)[..., 0]


def chunked_cross_entropy(x: Tensor, params: Params, targets: Tensor,
                          cfg: ModelConfig,
                          policy: Optional[PrecisionPolicy] = None
                          ) -> Tensor:
    """Sequence-chunked CE: the logits of each S-chunk are computed inside
    a checkpoint and reduced at once, so the (B, S, V) logits never exist
    whole.  ``cfg.loss_chunk`` of 0, or S within one chunk, takes the
    plain :func:`cross_entropy`."""
    policy = ff.resolve_policy(policy)
    B, S, _ = x.shape
    c = cfg.loss_chunk
    if not c or S <= c:
        logits = unembed_apply(params["embed"], x, cfg,
                               ff_math=policy.ff_math)
        return cross_entropy(logits, targets, policy)
    pad = (-S) % c
    mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    scoped = ff_scope.captured()

    def body(xi, ti, mi):
        with scoped():
            logits = unembed_apply(params["embed"], xi, cfg,
                                   ff_math=policy.ff_math).to(
                torch.float32)
            if policy.ff_reductions:
                lse = ff.logsumexp(logits, axis=-1)
            else:
                lse = torch.logsumexp(logits, dim=-1)
            nll = (lse - _gold(logits, ti)) * mi
            return nll.sum(), mi.sum()

    tot = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(x.shape[1] // c):
        sl = slice(i * c, (i + 1) * c)
        t, n = checkpoint(body, x[:, sl], targets[:, sl], mask[:, sl],
                          use_reentrant=False, preserve_rng_state=False)
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp_min(cnt, 1.0)


def cross_entropy(logits: Tensor, targets: Tensor,
                  policy: Optional[PrecisionPolicy] = None,
                  mask: Optional[Tensor] = None) -> Tensor:
    """Token-mean CE.  With ff_reductions: compensated LSE + loss sum."""
    policy = ff.resolve_policy(policy)
    lf = logits.to(torch.float32)
    if policy.ff_reductions:
        lse = ff.logsumexp(lf, axis=-1)
    else:
        lse = torch.logsumexp(lf, dim=-1)
    nll = lse - _gold(lf, targets)
    if mask is None:
        mask = targets >= 0
    mask = mask.to(torch.float32)
    nll = nll * mask
    if policy.ff_reductions:
        tot = ff.sum(nll.reshape(-1), block=1024).to_f32()
    else:
        tot = nll.sum()
    return tot / torch.clamp_min(mask.sum(), 1.0)


def train_forward(params: Params, batch: Dict[str, Tensor], cfg: ModelConfig,
                  policy: Optional[PrecisionPolicy] = None
                  ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The training loss of a batch ``{"tokens", "targets"}`` (B, S).
    Returns ``(loss, {"loss", "aux"})``; the dense family has no auxiliary
    loss, so ``aux`` is 0 and the total is the loss."""
    policy = ff.resolve_policy(policy)
    check_supported(cfg)
    tokens, targets = batch["tokens"], batch["targets"]
    B, S = tokens.shape
    x = embed_apply(params["embed"], tokens, compute_dtype(cfg))
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    x = _run_stack(params, x, cfg, policy, positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps,
                 ff_stats=policy.ff_reductions)
    loss = chunked_cross_entropy(x, params, targets, cfg, policy)
    aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss, {"loss": loss, "aux": aux}


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
        x = x + mlp_apply(lp["ffn"], z, ff_math=policy.ff_math)
    return x


def prefill(params: Params, batch: Dict[str, Tensor], cfg: ModelConfig,
            cache: Params, policy: Optional[PrecisionPolicy] = None
            ) -> Tuple[Tensor, Params]:
    """Run the prompt through the model, filling the cache.  Returns
    (last-position logits (B, V), cache)."""
    policy = ff.resolve_policy(policy)
    check_supported(cfg)
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
    return unembed_apply(params["embed"], x, cfg,
                         ff_math=policy.ff_math)[:, 0], cache


def decode_step(params: Params, token: Tensor, pos: int, cache: Params,
                cfg: ModelConfig, policy: Optional[PrecisionPolicy] = None
                ) -> Tuple[Tensor, Params]:
    """One decode step.  token: (B, 1) int; pos: the write index.
    Returns (logits (B, V), cache)."""
    policy = ff.resolve_policy(policy)
    check_supported(cfg)
    x = embed_apply(params["embed"], token, compute_dtype(cfg))

    def attn(p, z, lcache):
        return attn_decode(p, z, cfg, pos=pos, cache=lcache,
                           attn_impl=policy.attention)[0]

    x = _stack(params, x, cfg, policy, cache, attn)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps,
                 ff_stats=policy.ff_reductions)
    return unembed_apply(params["embed"], x, cfg,
                         ff_math=policy.ff_math)[:, 0], cache
