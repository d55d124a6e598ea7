"""Model assembly: params / train_forward / cache / prefill / decode
(counterpart of ``repro.models.model``).

Families
--------
dense / moe / vlm : decoder-only LM (GQA or MLA attention, dense or MoE
                    FFN; ``vlm`` prepends projected patch embeddings,
                    ``batch["patches"]``, the vision tower a stub)
ssm               : the mamba2 SSD stack (attention-free)
hybrid            : jamba's period structure (one attention layer per
                    ``attn_every`` layers at ``attn_index``, the MoE FFN
                    where ``i % moe_every == 1``)
encdec            : whisper's encoder-decoder (``batch["frames"]``: stub
                    frame embeddings), cross attention to the encoder

Params are a dict laid out like the reference's pytree, with the layers
stacked on a leading axis (``params["layers"]["attn"]["wq"]`` is
(L, d, H*hd)); the hybrid's ``params["layers"]`` is a tuple of
``attn_every`` per-index dicts, each leaf stacked over the periods.  A
Python loop over layers takes the place of ``lax.scan``, and
``torch.utils.checkpoint`` of ``jax.checkpoint`` (``cfg.remat``).  The
caches are updated in place.  ``train_forward`` covers the decoder-only
families (``make_train_step`` the dense GQA one); the ssm, hybrid and
encdec families serve only.
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
from repro_torch.models import mamba2, mla
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attn_apply, attn_cache_init,
                                       attn_decode, attn_prefill,
                                       decode_attention, embed_apply,
                                       flash_attention, mlp_apply, rms_norm,
                                       unembed_apply)

Tensor = torch.Tensor
Params = Dict[str, Any]


SERVE_ONLY = ("ssm", "hybrid", "encdec")
TRAINING_ITEM = "ROADMAP.md §1 item 7.4"


def check_supported(cfg: ModelConfig) -> None:
    """The port models every family of the reference.  Interleaved
    dense/MoE stacks outside the hybrid family raise the reference's
    ``ValueError``."""
    if cfg.family in ("dense", "moe", "vlm") and cfg.moe_num_experts \
            and cfg.moe_every != 1:
        raise ValueError("interleaved dense/MoE stacks use the hybrid path")


def check_trainable(cfg: ModelConfig) -> None:
    """Training (gradients, the Trainer) covers the dense GQA family; the
    other families run forward only so far."""
    check_supported(cfg)
    if cfg.family != "dense" or cfg.use_mla or cfg.moe_num_experts:
        raise NotImplementedError(
            f"repro_torch trains the dense GQA family only (family="
            f"{cfg.family!r}, use_mla={cfg.use_mla}, moe_num_experts="
            f"{cfg.moe_num_experts}): training of the MoE, MLA, VLM, SSM, "
            f"hybrid and enc-dec families is {TRAINING_ITEM}")


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


def tree_map(fn, tree):
    """``fn`` over every tensor of nested dicts, tuples and lists, the
    structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """One copy of the weights in ``dtype`` (the values every ``.to(dt)``
    in the layers would produce; a no-op for tensors already in it)."""
    return tree_map(lambda t: t.to(dtype), params)


# ===========================================================================
# parameter init
# ===========================================================================

def _draws(generator: torch.Generator, n: int):
    """Draws of weights stacked on a leading axis of ``n`` layers:
    ``dense(shape)`` (normal / sqrt(shape[-2])), ``normal(shape)``,
    ``full(shape, value)``."""
    dev = generator.device

    def normal(shape):
        return torch.randn((n,) + shape, generator=generator, device=dev)

    def dense(shape):
        return normal(shape) * (1.0 / math.sqrt(shape[-2]))

    def full(shape, value):
        return torch.full((n,) + shape, value, device=dev)
    return dense, normal, full


def _attn_params(cfg: ModelConfig, dense) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {"wq": dense((d, cfg.num_heads * hd)),
            "wk": dense((d, cfg.num_kv_heads * hd)),
            "wv": dense((d, cfg.num_kv_heads * hd)),
            "wo": dense((cfg.num_heads * hd, d))}


def _mlp_params(cfg: ModelConfig, dense) -> Params:
    d = cfg.d_model
    return {"w_gate": dense((d, cfg.d_ff)), "w_up": dense((d, cfg.d_ff)),
            "w_down": dense((cfg.d_ff, d))}


def _norms(full, d: int, *names: str) -> Params:
    return {n: full((d,), 1.0) for n in names}


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Random weights from ``generator`` (on the generator's device):
    normal / sqrt(fan_in) matrices, unit norm weights, laid out as the
    reference's pytree (MLA attention, MoE FFN and the VLM's identity
    ``patch_proj`` where the config has them; the SSD mixers' own
    initialisation, ``mamba2.ssd_params``)."""
    check_supported(cfg)
    dev = generator.device
    L, d = cfg.num_layers, cfg.d_model
    dense, _, _ = _draws(generator, 1)

    def one(shape):
        return dense(shape)[0]

    embed = {"tok": one((cfg.vocab_size, d))}
    if not cfg.tie_embeddings:
        embed["unembed"] = one((d, cfg.vocab_size))
    params = {"embed": embed, "final_norm": torch.ones((d,), device=dev)}
    dense, normal, full = _draws(generator, L)
    if cfg.family == "ssm":
        params["layers"] = {"ln": full((d,), 1.0), "mixer":
                            mamba2.ssd_params(cfg, dense, normal, full)}
    elif cfg.family == "hybrid":
        params["layers"] = _hybrid_params(cfg, generator)
    elif cfg.family == "encdec":
        edense, _, efull = _draws(generator, cfg.encoder_layers)
        params["encoder"] = {**_norms(efull, d, "ln1", "ln2"),
                             "attn": _attn_params(cfg, edense),
                             "ffn": _mlp_params(cfg, edense)}
        params["layers"] = {**_norms(full, d, "ln1", "ln2", "ln3"),
                            "attn": _attn_params(cfg, dense),
                            "xattn": _attn_params(cfg, dense),
                            "ffn": _mlp_params(cfg, dense)}
        params["enc_final_norm"] = torch.ones((d,), device=dev)
    else:
        attn = (mla.mla_params(cfg, dense, lambda n: full((n,), 1.0))
                if cfg.use_mla else _attn_params(cfg, dense))
        ffn = (moe_lib.moe_params(cfg, dense) if cfg.moe_num_experts
               else _mlp_params(cfg, dense))
        params["layers"] = {**_norms(full, d, "ln1", "ln2"), "attn": attn,
                            "ffn": ffn}
    if cfg.family == "vlm":
        params["patch_proj"] = torch.eye(d, device=dev)
    return params


def _hybrid_params(cfg: ModelConfig, generator: torch.Generator
                   ) -> Tuple[Params, ...]:
    """The hybrid's layers: a tuple of ``attn_every`` per-index dicts (the
    attention mixer at ``attn_index``, an SSD mixer elsewhere; the MoE FFN
    where ``i % moe_every == 1``, else the MLP), each leaf stacked over
    the periods."""
    period = cfg.attn_every
    if cfg.num_layers % period:
        raise ValueError(f"num_layers {cfg.num_layers} is not a multiple "
                         f"of attn_every {period}")
    dense, normal, full = _draws(generator, cfg.num_layers // period)
    layers = []
    for i in range(period):
        lp = _norms(full, cfg.d_model, "ln1", "ln2")
        if i == cfg.attn_index:
            lp["mixer_attn"] = _attn_params(cfg, dense)
        else:
            lp["mixer_ssd"] = mamba2.ssd_params(cfg, dense, normal, full)
        if cfg.moe_num_experts and i % cfg.moe_every == 1:
            lp["ffn_moe"] = moe_lib.moe_params(cfg, dense)
        else:
            lp["ffn_mlp"] = _mlp_params(cfg, dense)
        layers.append(lp)
    return tuple(layers)


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
    if cfg.family in SERVE_ONLY:
        raise NotImplementedError(
            f"repro_torch serves the {cfg.family!r} family but does not "
            f"train it yet: {TRAINING_ITEM}")
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

def _stacked(one: Params, n: int) -> Params:
    """``n`` copies of a cache dict on a new leading axis."""
    return tree_map(lambda t: t[None].repeat((n,) + (1,) * t.ndim), one)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Params:
    """Layer-stacked caches, as the reference's: {"layers": {"k", "v": (L,
    B, S, KV, hd)}}; with MLA the latent {"c_kv": (L, B, S, r), "k_rope":
    (L, B, S, dr)}; ``ssm``: the f32 SSD state {"ssm": (L, B, H, P, N),
    "conv": (L, B, W - 1, d_inner + 2N)}; ``hybrid``: per period
    {"attn_<i>": KV cache, "ssm_<j>": SSD state}; ``encdec``: the
    decoder's KV cache and {"cross": {"k", "v": (L, B, encoder_seq, KV,
    hd)}}."""
    check_supported(cfg)
    dev = resolve_device(device)
    L = cfg.num_layers
    if cfg.family == "ssm":
        return {"layers": _stacked(mamba2.ssd_state_init(
            cfg, batch, torch.float32, dev), L)}
    if cfg.family == "hybrid":
        per = {}
        for i in range(cfg.attn_every):
            if i == cfg.attn_index:
                per[f"attn_{i}"] = attn_cache_init(cfg, batch, max_len,
                                                   dtype, dev)
            else:
                per[f"ssm_{i}"] = mamba2.ssd_state_init(cfg, batch,
                                                        torch.float32, dev)
        return {"layers": _stacked(per, L // cfg.attn_every)}
    init = mla.mla_cache_init if cfg.use_mla else attn_cache_init
    cache = {"layers": _stacked(init(cfg, batch, max_len, dtype, dev), L)}
    if cfg.family == "encdec":
        cache["cross"] = _stacked(attn_cache_init(
            cfg, batch, cfg.encoder_seq, dtype, dev), L)
    return cache


def _stack(params: Params, x: Tensor, cfg: ModelConfig,
           policy: PrecisionPolicy, cache: Params, attn) -> Tensor:
    """The decoder-only layer loop shared by prefill and decode;
    ``attn(lp, z, lcache)`` runs one layer's attention and writes its
    cache.  The MoE FFN takes the plain load-balance statistic here (its
    aux is dropped), as the reference's serving path."""
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


def _ssm_stack(params: Params, x: Tensor, cfg: ModelConfig,
               policy: PrecisionPolicy, cache: Params, mixer) -> Tensor:
    """The ssm family's layer loop; ``mixer(p, z, state)`` runs one SSD
    mixer and writes its state."""
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        z = rms_norm(x, lp["ln"], cfg.norm_eps,
                     ff_stats=policy.ff_reductions)
        x = x + mixer(lp["mixer"], z, layer(cache["layers"], i))
    return x


def _hybrid_stack(params: Params, x: Tensor, cfg: ModelConfig,
                  policy: PrecisionPolicy, cache: Params, attn,
                  mixer) -> Tensor:
    """The hybrid's period loop: ``attn_every`` layers a period, the
    attention mixer (``attn(p, z, kv_cache)``) at ``attn_index``, SSD
    mixers (``mixer(p, z, state)``) elsewhere; the MoE FFN's aux dropped,
    as the reference's serving path."""
    for per in range(cfg.num_layers // cfg.attn_every):
        pcache = layer(cache["layers"], per)
        for i, stacked in enumerate(params["layers"]):
            lp = layer(stacked, per)
            z = rms_norm(x, lp["ln1"], cfg.norm_eps,
                         ff_stats=policy.ff_reductions)
            if "mixer_attn" in lp:
                x = x + attn(lp["mixer_attn"], z, pcache[f"attn_{i}"])
            else:
                x = x + mixer(lp["mixer_ssd"], z, pcache[f"ssm_{i}"])
            z = rms_norm(x, lp["ln2"], cfg.norm_eps,
                         ff_stats=policy.ff_reductions)
            ffn = lp["ffn_moe"] if "ffn_moe" in lp else lp["ffn_mlp"]
            x = x + _ffn(ffn, z, cfg, policy)[0]
    return x


def _encdec_stack(params: Params, x: Tensor, cfg: ModelConfig,
                  policy: PrecisionPolicy, cache: Params, attn,
                  cross) -> Tensor:
    """The decoder's layer loop: self attention (``attn(p, z, lcache)``),
    cross attention to the cached encoder K/V (``cross(p, z, xkv)``), the
    MLP."""
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        z = rms_norm(x, lp["ln1"], cfg.norm_eps,
                     ff_stats=policy.ff_reductions)
        x = x + attn(lp["attn"], z, layer(cache["layers"], i))
        z = rms_norm(x, lp["ln2"], cfg.norm_eps,
                     ff_stats=policy.ff_reductions)
        x = x + cross(lp["xattn"], z, layer(cache["cross"], i))
        z = rms_norm(x, lp["ln3"], cfg.norm_eps,
                     ff_stats=policy.ff_reductions)
        x = x + mlp_apply(lp["ffn"], z, ff_math=policy.ff_math)
    return x


def _encoder_stack(params: Params, frames: Tensor, cfg: ModelConfig,
                   policy: PrecisionPolicy) -> Tensor:
    """The encoder over (B, Se, d) frame embeddings: non-causal self
    attention and the MLP a layer; the final norm's statistics plain, as
    the reference's."""
    B, Se, _ = frames.shape
    positions = torch.arange(Se, dtype=torch.int32,
                             device=frames.device).expand(B, Se)
    h = frames
    for i in range(cfg.encoder_layers):
        lp = layer(params["encoder"], i)
        z = rms_norm(h, lp["ln1"], cfg.norm_eps,
                     ff_stats=policy.ff_reductions)
        h = h + attn_apply(lp["attn"], z, cfg, positions=positions,
                           causal=False, attn_impl=policy.attention)
        z = rms_norm(h, lp["ln2"], cfg.norm_eps,
                     ff_stats=policy.ff_reductions)
        h = h + mlp_apply(lp["ffn"], z, ff_math=policy.ff_math)
    return rms_norm(h, params["enc_final_norm"], cfg.norm_eps)


def _fill_cross(params: Params, enc: Tensor, cfg: ModelConfig,
                cache: Params) -> None:
    """The cross-attention K/V of every decoder layer from the encoder
    output, into ``cache["cross"]`` (its length the encoder's, as the
    reference's)."""
    B, Se, _ = enc.shape
    dt = cache["cross"]["k"].dtype
    kv = {n: torch.stack([
        (enc @ params["layers"]["xattn"][w][i].to(enc.dtype)).reshape(
            B, Se, cfg.num_kv_heads, cfg.resolved_head_dim).to(dt)
        for i in range(cfg.num_layers)]) for n, w in (("k", "wk"),
                                                      ("v", "wv"))}
    cache["cross"].update(kv)


def _cross_attn_cached(p: Params, x: Tensor, xkv: Params, cfg: ModelConfig,
                       attn_impl: str = "fast") -> Tensor:
    """Non-causal attention from the decoder's positions to the cached
    encoder K/V, through ``ff.attention`` (the CUDA kernel under
    ``attention="pallas"``)."""
    B, S, _ = x.shape
    hd, dt = cfg.resolved_head_dim, x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, S, cfg.num_heads, hd)
    o = flash_attention(q, xkv["k"].to(dt), xkv["v"].to(dt), causal=False,
                        block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv,
                        impl=attn_impl)
    return o.reshape(B, S, cfg.num_heads * hd) @ p["wo"].to(dt)


def _cross_attn_decode(p: Params, x: Tensor, xkv: Params, cfg: ModelConfig,
                       attn_impl: str = "fast") -> Tensor:
    """One position's cross attention: ``decode_attention`` with the
    whole encoder length valid (under ``"pallas"`` the dispatch routes
    its ``kv_len`` to the ``ff`` tier, as the reference's)."""
    B = x.shape[0]
    hd, dt = cfg.resolved_head_dim, x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, 1, cfg.num_heads, hd)
    o = decode_attention(q, xkv["k"], xkv["v"], xkv["k"].shape[1],
                         impl=attn_impl)
    return o.reshape(B, 1, cfg.num_heads * hd) @ p["wo"].to(dt)


def _head(params: Params, x: Tensor, cfg: ModelConfig,
          policy: PrecisionPolicy) -> Tensor:
    """The final norm and the unembedding of (B, 1, d): logits (B, V)."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps,
                 ff_stats=policy.ff_reductions)
    return unembed_apply(params["embed"], x, cfg,
                         ff_math=policy.ff_math)[:, 0]


def prefill(params: Params, batch: Dict[str, Tensor], cfg: ModelConfig,
            cache: Params, policy: Optional[PrecisionPolicy] = None
            ) -> Tuple[Tensor, Params]:
    """Run the prompt (after the patches, for ``vlm``; with the encoder
    over ``batch["frames"]`` first, for ``encdec``) through the model,
    filling the cache.  Returns (last-position logits (B, V), cache).
    The ssm and hybrid families take prompts of at least W - 1 tokens:
    the reference's conv state of a shorter prompt has fewer rows than
    its decode step takes."""
    policy = ff.resolve_policy(policy)
    check_supported(cfg)
    x, positions = _embed_inputs(params, batch, cfg)
    W = cfg.ssm_conv_width
    if cfg.family in ("ssm", "hybrid") and x.shape[1] < W - 1:
        raise ValueError(f"{cfg.family} prefill takes at least W - 1 = "
                         f"{W - 1} tokens (the conv window), got "
                         f"{x.shape[1]}")

    def attn(p, z, lcache):
        fill = mla.mla_prefill if cfg.use_mla else attn_prefill
        return fill(p, z, cfg, positions=positions, cache=lcache,
                    attn_impl=policy.attention)[0]

    def mixer(p, z, state):
        out, new = mamba2.ssd_block_apply(p, z, cfg, return_state=True,
                                          ff_math=policy.ff_math)
        for k, t in new.items():
            state[k].copy_(t)
        return out

    if cfg.family == "ssm":
        x = _ssm_stack(params, x, cfg, policy, cache, mixer)
    elif cfg.family == "hybrid":
        x = _hybrid_stack(params, x, cfg, policy, cache, attn, mixer)
    elif cfg.family == "encdec":
        enc = _encoder_stack(params, batch["frames"].to(x.dtype), cfg,
                             policy)
        _fill_cross(params, enc, cfg, cache)
        x = _encdec_stack(params, x, cfg, policy, cache, attn,
                          lambda p, z, xkv: _cross_attn_cached(
                              p, z, xkv, cfg, policy.attention))
    else:
        x = _stack(params, x, cfg, policy, cache, attn)
    return _head(params, x[:, -1:], cfg, policy), cache


def decode_step(params: Params, token: Tensor, pos: int, cache: Params,
                cfg: ModelConfig, policy: Optional[PrecisionPolicy] = None
                ) -> Tuple[Tensor, Params]:
    """One decode step.  token: (B, 1) int; pos: the write index.
    Returns (logits (B, V), cache)."""
    policy = ff.resolve_policy(policy)
    check_supported(cfg)
    x = embed_apply(params["embed"], token, compute_dtype(cfg))

    def attn(p, z, lcache):
        step = mla.mla_decode if cfg.use_mla else attn_decode
        return step(p, z, cfg, pos=pos, cache=lcache,
                    attn_impl=policy.attention)[0]

    def mixer(p, z, state):
        return mamba2.ssd_decode_step(p, z, cfg, state,
                                      ff_math=policy.ff_math)[0]

    if cfg.family == "ssm":
        x = _ssm_stack(params, x, cfg, policy, cache, mixer)
    elif cfg.family == "hybrid":
        x = _hybrid_stack(params, x, cfg, policy, cache, attn, mixer)
    elif cfg.family == "encdec":
        x = _encdec_stack(params, x, cfg, policy, cache, attn,
                          lambda p, z, xkv: _cross_attn_decode(
                              p, z, xkv, cfg, policy.attention))
    else:
        x = _stack(params, x, cfg, policy, cache, attn)
    return _head(params, x, cfg, policy), cache
