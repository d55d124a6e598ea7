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
``torch.utils.checkpoint`` of ``jax.checkpoint`` (``cfg.remat``: per
layer, per hybrid period, per encoder and decoder layer).  The caches
are updated in place.  Every family trains and serves.
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
from repro_torch.tree import tree_map

Tensor = torch.Tensor
Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """The port models every family of the reference.  Interleaved
    dense/MoE stacks outside the hybrid family raise the reference's
    ``ValueError``."""
    if cfg.family in ("dense", "moe", "vlm") and cfg.moe_num_experts \
            and cfg.moe_every != 1:
        raise ValueError("interleaved dense/MoE stacks use the hybrid path")


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a layer-stacked tree (views, no copy)."""
    return tree_map(lambda t: t[i], tree)


def unstack_layers(tree: Params, n: int) -> List[Params]:
    """The ``n`` per-layer trees of a layer-stacked tree (dicts, and the
    hybrid's tuple), from one ``torch.unbind`` per leaf.  Its backward is
    one stack per leaf; indexing ``t[i]`` per layer instead would make
    each layer's backward fill a zero tensor the size of the whole
    stack."""
    if isinstance(tree, dict):
        parts = {k: unstack_layers(v, n) for k, v in tree.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    if isinstance(tree, (tuple, list)):
        parts = [unstack_layers(v, n) for v in tree]
        return [type(tree)(p[i] for p in parts) for i in range(n)]
    return list(torch.unbind(tree, 0))


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
# forward blocks (shared by training and serving)
# ===========================================================================

def _remat(on: bool, body, *args):
    """``body(*args)``; with ``on`` inside a checkpoint: only the inputs
    are kept and the rest is recomputed in the backward pass, under the
    ff scopes of this call (autograd may run the backward on a thread of
    its own)."""
    if not on:
        return body(*args)
    scoped = ff_scope.captured()

    def run(*a):
        with scoped():
            return body(*a)
    # the layers draw no random numbers: no RNG state to restore
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _ffn(p: Params, z: Tensor, cfg: ModelConfig, policy: PrecisionPolicy,
         ff_stats: bool = False) -> Tuple[Tensor, Optional[Tensor]]:
    """The layer's FFN: the MoE (output, aux) where it has a router, else
    the SwiGLU MLP and no aux."""
    if "router" in p:
        return moe_lib.moe_apply(p, z, cfg, ff_stats=ff_stats,
                                 ff_math=policy.ff_math)
    return mlp_apply(p, z, ff_math=policy.ff_math), None


def _norm(x: Tensor, w: Tensor, cfg: ModelConfig,
          policy: PrecisionPolicy) -> Tensor:
    return rms_norm(x, w, cfg.norm_eps, ff_stats=policy.ff_reductions)


def _decoder_layer(x: Tensor, lp: Params, cfg: ModelConfig,
                   policy: PrecisionPolicy, attn, ff_stats: bool
                   ) -> Tuple[Tensor, Optional[Tensor]]:
    """One decoder-only layer; ``attn(p, z)`` runs its attention.  Returns
    (x, the MoE aux or None)."""
    x = x + attn(lp["attn"], _norm(x, lp["ln1"], cfg, policy))
    f, aux = _ffn(lp["ffn"], _norm(x, lp["ln2"], cfg, policy), cfg, policy,
                  ff_stats)
    return x + f, aux


def _ssm_layer(x: Tensor, lp: Params, cfg: ModelConfig,
               policy: PrecisionPolicy, mixer) -> Tensor:
    """One ssm layer; ``mixer(p, z)`` runs its SSD mixer."""
    return x + mixer(lp["mixer"], _norm(x, lp["ln"], cfg, policy))


def _hybrid_period(x: Tensor, pp: Tuple[Params, ...], cfg: ModelConfig,
                   policy: PrecisionPolicy, attn, mixer, ff_stats: bool
                   ) -> Tuple[Tensor, Tensor]:
    """One hybrid period (``pp``: its ``attn_every`` per-index layers):
    ``attn(p, z, i)`` at ``attn_index``, ``mixer(p, z, i)`` elsewhere, the
    MoE FFN where the layer has one.  Returns (x, the period's summed MoE
    aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(pp):
        z = _norm(x, lp["ln1"], cfg, policy)
        if "mixer_attn" in lp:
            x = x + attn(lp["mixer_attn"], z, i)
        else:
            x = x + mixer(lp["mixer_ssd"], z, i)
        ffn = lp["ffn_moe"] if "ffn_moe" in lp else lp["ffn_mlp"]
        f, a = _ffn(ffn, _norm(x, lp["ln2"], cfg, policy), cfg, policy,
                    ff_stats)
        x = x + f
        if a is not None:
            aux = aux + a
    return x, aux


def _encdec_layer(x: Tensor, lp: Params, cfg: ModelConfig,
                  policy: PrecisionPolicy, attn, cross) -> Tensor:
    """One decoder layer of the enc-dec family: self attention
    (``attn(p, z)``), cross attention to the encoder (``cross(p, z)``),
    the MLP."""
    x = x + attn(lp["attn"], _norm(x, lp["ln1"], cfg, policy))
    x = x + cross(lp["xattn"], _norm(x, lp["ln2"], cfg, policy))
    return x + mlp_apply(lp["ffn"], _norm(x, lp["ln3"], cfg, policy),
                         ff_math=policy.ff_math)


def _encoder_stack(params: Params, frames: Tensor, cfg: ModelConfig,
                   policy: PrecisionPolicy, remat: bool = False) -> Tensor:
    """The encoder over (B, Se, d) frame embeddings: non-causal self
    attention and the MLP a layer (each layer under ``_remat(remat)``);
    the final norm's statistics plain, as the reference's."""
    B, Se, _ = frames.shape
    positions = torch.arange(Se, dtype=torch.int32,
                             device=frames.device).expand(B, Se)

    def body(h, lp):
        h = h + attn_apply(lp["attn"], _norm(h, lp["ln1"], cfg, policy),
                           cfg, positions=positions, causal=False,
                           attn_impl=policy.attention)
        return h + mlp_apply(lp["ffn"], _norm(h, lp["ln2"], cfg, policy),
                             ff_math=policy.ff_math)

    h = frames
    for lp in unstack_layers(params["encoder"], cfg.encoder_layers):
        h = _remat(remat, body, h, lp)
    return rms_norm(h, params["enc_final_norm"], cfg.norm_eps)


def _cross_kv(p: Params, enc: Tensor, cfg: ModelConfig) -> Params:
    """The cross attention's K and V of the encoder output: (B, Se, KV,
    hd) each, in ``enc``'s dtype."""
    B, Se, _ = enc.shape
    shape = (B, Se, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {n: (enc @ p[w].to(enc.dtype)).reshape(shape)
            for n, w in (("k", "wk"), ("v", "wv"))}


def _cross_attn_cached(p: Params, x: Tensor, xkv: Params, cfg: ModelConfig,
                       attn_impl: str = "fast") -> Tensor:
    """Non-causal attention from the decoder's positions to the encoder's
    K/V, through ``ff.attention`` (the CUDA kernel under
    ``attention="pallas"``)."""
    B, S, _ = x.shape
    hd, dt = cfg.resolved_head_dim, x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, S, cfg.num_heads, hd)
    o = flash_attention(q, xkv["k"].to(dt), xkv["v"].to(dt), causal=False,
                        block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv,
                        impl=attn_impl)
    return o.reshape(B, S, cfg.num_heads * hd) @ p["wo"].to(dt)


# ===========================================================================
# training forward + loss
# ===========================================================================

def _run_stack(params: Params, x: Tensor, cfg: ModelConfig,
               policy: PrecisionPolicy, positions: Tensor
               ) -> Tuple[Tensor, Tensor]:
    """The layer loop of training (a layer, or a hybrid period, a step);
    returns (hidden, the layers' summed MoE aux).  With ``cfg.remat``
    each step keeps only its input and recomputes the rest in the
    backward pass."""

    def attn(p, z, *_):
        fn = mla.mla_apply if cfg.use_mla else attn_apply
        return fn(p, z, cfg, positions=positions, attn_impl=policy.attention)

    def mixer(p, z, *_):
        return mamba2.ssd_block_apply(p, z, cfg, ff_math=policy.ff_math)

    stats = policy.ff_reductions
    n = cfg.num_layers
    if cfg.family == "ssm":
        def body(h, lp):
            return _ssm_layer(h, lp, cfg, policy, mixer), None
    elif cfg.family == "hybrid":
        n //= cfg.attn_every

        def body(h, pp):
            return _hybrid_period(h, pp, cfg, policy, attn, mixer, stats)
    else:
        def body(h, lp):
            return _decoder_layer(h, lp, cfg, policy, attn, stats)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in unstack_layers(params["layers"], n):
        x, a = _remat(cfg.remat, body, x, lp)
        if a is not None:
            aux = aux + a
    return x, aux


def _encdec_decoder(params: Params, x: Tensor, enc: Tensor,
                    cfg: ModelConfig, policy: PrecisionPolicy,
                    positions: Tensor) -> Tensor:
    """The enc-dec decoder of training: causal self attention, cross
    attention to ``enc`` (its K/V computed in each layer, so the
    gradient reaches the encoder through them), the MLP; a layer a
    ``_remat`` step."""

    def body(h, lp, e):
        return _encdec_layer(
            h, lp, cfg, policy,
            lambda p, z: attn_apply(p, z, cfg, positions=positions,
                                    attn_impl=policy.attention),
            lambda p, z: _cross_attn_cached(p, z, _cross_kv(p, e, cfg), cfg,
                                            policy.attention))

    for lp in unstack_layers(params["layers"], cfg.num_layers):
        x = _remat(cfg.remat, body, x, lp, enc)
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
    """The training loss of a batch ``{"tokens", "targets"}`` (B, S), with
    ``"patches"`` (B, P, d) for ``vlm`` (the loss over the text positions
    only) and ``"frames"`` (B, Se, d) for ``encdec``.  Returns ``(loss +
    0.01 aux, {"loss", "aux"})``: ``aux`` sums the MoE layers'
    load-balance losses (0 without experts)."""
    policy = ff.resolve_policy(policy)
    check_supported(cfg)
    targets = batch["targets"]
    S = targets.shape[1]
    x, positions = _embed_inputs(params, batch, cfg)
    if cfg.family == "encdec":
        enc = _encoder_stack(params, batch["frames"].to(x.dtype), cfg,
                             policy, remat=cfg.remat)
        x = _encdec_decoder(params, x, enc, cfg, policy, positions)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        x, aux = _run_stack(params, x, cfg, policy, positions)
    if cfg.family == "vlm":
        x = x[:, -S:]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps,
                 ff_stats=policy.ff_reductions)
    loss = chunked_cross_entropy(x, params, targets, cfg, policy)
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}


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


def _serve_stack(params: Params, x: Tensor, cfg: ModelConfig,
                 policy: PrecisionPolicy, cache: Params, attn, mixer,
                 cross) -> Tensor:
    """The layer loop shared by prefill and decode: ``attn(p, z, kv)``
    runs an attention layer and writes its KV cache, ``mixer(p, z,
    state)`` an SSD mixer and writes its state, ``cross(p, z, xkv)`` the
    enc-dec's cross attention to the cached encoder K/V.  The MoE FFN
    takes the plain load-balance statistic here (its aux is dropped), as
    the reference's serving path."""
    caches = cache["layers"]
    if cfg.family == "hybrid":
        for per in range(cfg.num_layers // cfg.attn_every):
            pc = layer(caches, per)
            x, _ = _hybrid_period(
                x, layer(params["layers"], per), cfg, policy,
                lambda p, z, i: attn(p, z, pc[f"attn_{i}"]),
                lambda p, z, i: mixer(p, z, pc[f"ssm_{i}"]), False)
        return x
    for i in range(cfg.num_layers):
        lp, lc = layer(params["layers"], i), layer(caches, i)
        if cfg.family == "ssm":
            x = _ssm_layer(x, lp, cfg, policy, lambda p, z: mixer(p, z, lc))
        elif cfg.family == "encdec":
            xkv = layer(cache["cross"], i)
            x = _encdec_layer(x, lp, cfg, policy,
                              lambda p, z: attn(p, z, lc),
                              lambda p, z: cross(p, z, xkv))
        else:
            x, _ = _decoder_layer(x, lp, cfg, policy,
                                  lambda p, z: attn(p, z, lc), False)
    return x


def _fill_cross(params: Params, enc: Tensor, cfg: ModelConfig,
                cache: Params) -> None:
    """The cross-attention K/V of every decoder layer from the encoder
    output, into ``cache["cross"]`` (its length the encoder's, as the
    reference's)."""
    dt = cache["cross"]["k"].dtype
    kv = [_cross_kv(layer(params["layers"]["xattn"], i), enc, cfg)
          for i in range(cfg.num_layers)]
    cache["cross"].update({n: torch.stack([t[n].to(dt) for t in kv])
                           for n in ("k", "v")})


def _short_conv(cache: Params, S: int) -> None:
    """A prompt of S < W - 1 positions leaves a conv state of S rows, as
    the reference's prefill: each ``conv`` leaf of the cache becomes one
    of S rows, which the mixer then writes (a decode step after it
    raises, where the reference's fails)."""
    def walk(d):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "conv":
                d[k] = v.new_zeros(v.shape[:2] + (S,) + v.shape[3:])
    walk(cache["layers"])


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
    filling the cache.  Returns (last-position logits (B, V), cache).  An
    ssm or hybrid prompt shorter than the conv window leaves a short conv
    state (``_short_conv``), as the reference's."""
    policy = ff.resolve_policy(policy)
    check_supported(cfg)
    x, positions = _embed_inputs(params, batch, cfg)
    if cfg.family in ("ssm", "hybrid") and \
            x.shape[1] < cfg.ssm_conv_width - 1:
        _short_conv(cache, x.shape[1])

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

    def cross(p, z, xkv):
        return _cross_attn_cached(p, z, xkv, cfg, policy.attention)

    if cfg.family == "encdec":
        enc = _encoder_stack(params, batch["frames"].to(x.dtype), cfg,
                             policy)
        _fill_cross(params, enc, cfg, cache)
    x = _serve_stack(params, x, cfg, policy, cache, attn, mixer, cross)
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

    def cross(p, z, xkv):
        return _cross_attn_decode(p, z, xkv, cfg, policy.attention)

    x = _serve_stack(params, x, cfg, policy, cache, attn, mixer, cross)
    return _head(params, x, cfg, policy), cache
