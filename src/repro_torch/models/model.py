"""Model assembly for the decoder-only families: params / train_forward /
cache / prefill / decode (counterpart of ``repro.models.model``).

The families ``dense``, ``moe`` and ``vlm``, with GQA or MLA attention
(``cfg.use_mla``) and a dense or MoE FFN (``cfg.moe_num_experts``); the
``vlm`` family prepends projected patch embeddings (``batch["patches"]``,
the vision tower a stub as in the reference).  The ``ssm``, ``hybrid``
and ``encdec`` families are not ported yet.

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
from repro_torch.models import mla
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import NOT_PORTED, ModelConfig
from repro_torch.models.layers import (attn_apply, attn_cache_init,
                                       attn_decode, attn_prefill,
                                       embed_apply, mlp_apply, rms_norm,
                                       unembed_apply)

Tensor = torch.Tensor
Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """The port models the decoder-only families (``dense``, ``moe``,
    ``vlm``; GQA or MLA attention, dense or MoE FFN) under every policy.
    The others raise ``NotImplementedError`` naming their ROADMAP item;
    interleaved dense/MoE stacks the reference's ``ValueError``."""
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(f"repro_torch does not model the "
                                  f"{cfg.family!r} family yet: "
                                  f"{NOT_PORTED[cfg.family]}")
    if cfg.moe_num_experts and cfg.moe_every != 1:
        raise ValueError("interleaved dense/MoE stacks use the hybrid path")


def check_trainable(cfg: ModelConfig) -> None:
    """Training (gradients, the Trainer) covers the dense GQA family; the
    MoE, MLA and VLM families run forward only so far."""
    check_supported(cfg)
    if cfg.family != "dense" or cfg.use_mla or cfg.moe_num_experts:
        raise NotImplementedError(
            f"repro_torch trains the dense GQA family only (family="
            f"{cfg.family!r}, use_mla={cfg.use_mla}, moe_num_experts="
            f"{cfg.moe_num_experts}): training of the MoE, MLA and VLM "
            f"families is ROADMAP.md §1 item 7's last step")


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
    """Random weights from ``generator`` (on the generator's device):
    normal / sqrt(fan_in) matrices, unit norm weights, laid out as the
    reference's pytree (MLA attention, MoE FFN and the VLM's identity
    ``patch_proj`` where the config has them)."""
    check_supported(cfg)
    dev = generator.device
    L, d, hd = cfg.num_layers, cfg.d_model, cfg.resolved_head_dim

    def dense(shape):
        fan_in = shape[-2]
        return torch.randn(shape, generator=generator, device=dev) \
            * (1.0 / math.sqrt(fan_in))

    def stacked(shape):
        return dense((L,) + shape)

    embed = {"tok": dense((cfg.vocab_size, d))}
    if not cfg.tie_embeddings:
        embed["unembed"] = dense((d, cfg.vocab_size))
    ones = torch.ones((L, d), device=dev)
    if cfg.use_mla:
        attn = mla.mla_params(cfg, stacked,
                              lambda n: torch.ones((L, n), device=dev))
    else:
        attn = {"wq": stacked((d, cfg.num_heads * hd)),
                "wk": stacked((d, cfg.num_kv_heads * hd)),
                "wv": stacked((d, cfg.num_kv_heads * hd)),
                "wo": stacked((cfg.num_heads * hd, d))}
    if cfg.moe_num_experts:
        ffn = moe_lib.moe_params(cfg, stacked)
    else:
        ffn = {"w_gate": stacked((d, cfg.d_ff)),
               "w_up": stacked((d, cfg.d_ff)),
               "w_down": stacked((cfg.d_ff, d))}
    layers = {"ln1": ones, "ln2": ones.clone(), "attn": attn, "ffn": ffn}
    params = {"embed": embed, "final_norm": torch.ones((d,), device=dev),
              "layers": layers}
    if cfg.family == "vlm":
        params["patch_proj"] = torch.eye(d, device=dev)
    return params


# ===========================================================================
# training forward + loss
# ===========================================================================

def _ffn(p: Params, z: Tensor, cfg: ModelConfig, policy: PrecisionPolicy,
         ff_stats: bool = False) -> Tuple[Tensor, Optional[Tensor]]:
    """The layer's FFN: the MoE (output, aux) where it has a router, else
    the SwiGLU MLP and no aux."""
    if "router" in p:
        return moe_lib.moe_apply(p, z, cfg, ff_stats=ff_stats,
                                 ff_math=policy.ff_math)
    return mlp_apply(p, z, ff_math=policy.ff_math), None


def _decoder_layer(x: Tensor, lp: Params, cfg: ModelConfig,
                   policy: PrecisionPolicy, positions: Tensor
                   ) -> Tuple[Tensor, Optional[Tensor]]:
    h = rms_norm(x, lp["ln1"], cfg.norm_eps, ff_stats=policy.ff_reductions)
    attn = mla.mla_apply if cfg.use_mla else attn_apply
    x = x + attn(lp["attn"], h, cfg, positions=positions,
                 attn_impl=policy.attention)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps, ff_stats=policy.ff_reductions)
    f, aux = _ffn(lp["ffn"], h, cfg, policy, policy.ff_reductions)
    return x + f, aux


def _run_stack(params: Params, x: Tensor, cfg: ModelConfig,
               policy: PrecisionPolicy, positions: Tensor
               ) -> Tuple[Tensor, Tensor]:
    """The layer loop of training; returns (hidden, the layers' summed
    aux loss).  With ``cfg.remat`` each layer keeps only its input and
    recomputes the rest in the backward pass."""
    scoped = ff_scope.captured()

    def body(h, lp):
        with scoped():
            return _decoder_layer(h, lp, cfg, policy, positions)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in unstack_layers(params["layers"], cfg.num_layers):
        if cfg.remat:
            # the layer draws no random numbers: no RNG state to restore
            x, a = checkpoint(body, x, lp, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = body(x, lp)
        if a is not None:
            aux = aux + a
    return x, aux


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


def _embed_inputs(params: Params, batch: Dict[str, Tensor],
                  cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """The input embeddings and their positions; the ``vlm`` family puts
    its projected patches (``batch["patches"]``, (B, P, d)) before the
    text."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    dt = compute_dtype(cfg)
    x = embed_apply(params["embed"], tokens, dt)
    if cfg.family == "vlm":
        patches = batch["patches"].to(dt) @ params["patch_proj"].to(dt)
        x = torch.cat([patches, x], dim=1)
        S += patches.shape[1]
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    return x, positions


def train_forward(params: Params, batch: Dict[str, Tensor], cfg: ModelConfig,
                  policy: Optional[PrecisionPolicy] = None
                  ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The training loss of a batch ``{"tokens", "targets"}`` (B, S) (and
    ``"patches"`` for ``vlm``; the loss over the text positions only).
    Returns ``(loss + 0.01 aux, {"loss", "aux"})``: ``aux`` sums the MoE
    layers' load-balance losses (0 without experts, where the total is the
    loss)."""
    policy = ff.resolve_policy(policy)
    check_supported(cfg)
    targets = batch["targets"]
    S = targets.shape[1]
    x, positions = _embed_inputs(params, batch, cfg)
    x, aux = _run_stack(params, x, cfg, policy, positions)
    if cfg.family == "vlm":
        x = x[:, -S:]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps,
                 ff_stats=policy.ff_reductions)
    loss = chunked_cross_entropy(x, params, targets, cfg, policy)
    total = loss + 0.01 * aux if cfg.moe_num_experts else loss
    return total, {"loss": loss, "aux": aux}


# ===========================================================================
# serving: prefill + decode
# ===========================================================================

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Params:
    """Layer-stacked KV cache: {"layers": {"k", "v": (L, B, S, KV, hd)}},
    or with MLA the latent cache {"layers": {"c_kv": (L, B, S, r),
    "k_rope": (L, B, S, dr)}}."""
    check_supported(cfg)
    init = mla.mla_cache_init if cfg.use_mla else attn_cache_init
    one = init(cfg, batch, max_len, dtype, resolve_device(device))
    return {"layers": {n: t[None].repeat((cfg.num_layers,) + (1,) * t.ndim)
                       for n, t in one.items()}}


def _stack(params: Params, x: Tensor, cfg: ModelConfig,
           policy: PrecisionPolicy, cache: Params, attn) -> Tensor:
    """The layer loop shared by prefill and decode; ``attn(lp, z, lcache)``
    runs one layer's attention and writes its cache.  The MoE FFN takes
    the plain load-balance statistic here (its aux is dropped), as the
    reference's serving path."""
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        lcache = layer(cache["layers"], i)
        z = rms_norm(x, lp["ln1"], cfg.norm_eps,
                     ff_stats=policy.ff_reductions)
        x = x + attn(lp["attn"], z, lcache)
        z = rms_norm(x, lp["ln2"], cfg.norm_eps,
                     ff_stats=policy.ff_reductions)
        x = x + _ffn(lp["ffn"], z, cfg, policy)[0]
    return x


def prefill(params: Params, batch: Dict[str, Tensor], cfg: ModelConfig,
            cache: Params, policy: Optional[PrecisionPolicy] = None
            ) -> Tuple[Tensor, Params]:
    """Run the prompt (after the patches, for ``vlm``) through the model,
    filling the cache.  Returns (last-position logits (B, V), cache)."""
    policy = ff.resolve_policy(policy)
    check_supported(cfg)
    x, positions = _embed_inputs(params, batch, cfg)
    fill = mla.mla_prefill if cfg.use_mla else attn_prefill

    def attn(p, z, lcache):
        return fill(p, z, cfg, positions=positions, cache=lcache,
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
    step = mla.mla_decode if cfg.use_mla else attn_decode

    def attn(p, z, lcache):
        return step(p, z, cfg, pos=pos, cache=lcache,
                    attn_impl=policy.attention)[0]

    x = _stack(params, x, cfg, policy, cache, attn)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps,
                 ff_stats=policy.ff_reductions)
    return unembed_apply(params["embed"], x, cfg,
                         ff_math=policy.ff_math)[:, 0], cache
