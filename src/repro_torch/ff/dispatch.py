"""Dispatch registry for ``repro_torch.ff`` (counterpart of
``repro.ff.dispatch``, with the ops of the serving, training, FF matmul
and fused-composite paths).

Each op name maps to named implementations; a call resolves one:

    per-call ``impl=`` > ``use(op=impl)`` scope
      > policy (``PrecisionPolicy.matmul_impl``, for ``matmul``)
      > ``"tuned"`` / ``"tuned_accurate"``
      > per-device default ("cuda" / "cpu", else "*")
      > first registered implementation

The port has no tuning table yet: ``"tuned"`` resolves to the per-device
default and ``"tuned_accurate"`` to the first registered name of the op's
accurate fallback (for matmul: f64, ozaki, dot2; for softmax and
logsumexp: ff), as the reference does for a shape its table lacks.  Mesh and guard resolution are not ported yet.
Implementation names are the reference's, so one policy string means the
same in both packages: ``"pallas"`` (``"pallas_*"`` for matmul) names the
one-kernel tier, which in the port is a CUDA kernel, and for
``adamw_update``, ``"fused"`` names the one-kernel update, the CUDA default
as ``"tpu"`` is the reference's.  The ``f64`` tiers are real device tiers
(the H100 and the CPU have f64 units); unlike the reference, no CPU
default lands on them (``jnp`` stays the CPU default).

The public calls route through the ``torch.autograd.Function``s of
:mod:`repro_torch.ff.autodiff` when an input requires a gradient
(``softmax`` and ``norm_stats`` have none yet and raise).
"""

from __future__ import annotations

import functools
import warnings
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import compensated, ffmatmul, ffmath
from repro_torch.core import ff as core_ff
from repro_torch.core import transforms as T
from repro_torch.core.ff import FF
from repro_torch.ff import autodiff, scope
from repro_torch.kernels import ff_attention, ff_fused, ff_matmul

Tensor = torch.Tensor

_REGISTRY: Dict[str, Dict[str, Callable]] = {}
_DEFAULTS: Dict[str, Dict[str, str]] = {}     # op -> {device type|"*": impl}
# what "tuned_accurate" resolves to without a tuning table: per op, the
# first registered name
_ACCURATE_FALLBACK: Dict[str, Tuple[str, ...]] = {
    "matmul": ("f64", "ozaki", "dot2"),
    # composites whose f32-builtin exponentials cap them at the fast
    # class: the accurate tier is the FF-exp impl
    "softmax": ("ff",), "logsumexp": ("ff",)}


def register(op: str, impl: str, fn: Callable, *,
             default_for: Tuple[str, ...] = ()) -> Callable:
    """Register ``fn`` as implementation ``impl`` of ``op``; ``default_for``
    lists the device types ("cuda", "cpu", "*" = any) it is the default on."""
    _REGISTRY.setdefault(op, {})[impl] = fn
    for d in default_for:
        _DEFAULTS.setdefault(op, {})[d] = impl
    return fn


def ops() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def impls(op: str) -> Tuple[str, ...]:
    """Registered implementation names for ``op``."""
    return tuple(sorted(_REGISTRY.get(op, ())))


def resolve_name(op: str, impl: Optional[str] = None,
                 device: Optional[torch.device] = None) -> str:
    """Which implementation a call to ``op`` on ``device`` uses."""
    if op not in _REGISTRY:
        raise KeyError(f"unknown ff op {op!r}; registered: {ops()}")
    name = impl or scope.current_impl(op)
    if name is None and op == "matmul":
        pol = scope.current_policy().matmul_impl
        if pol and pol != "auto":
            name = pol
    if name == "tuned":
        name = None
    elif name == "tuned_accurate":
        name = next((c for c in _ACCURATE_FALLBACK.get(op, ())
                     if c in _REGISTRY[op]), None)
    if name is None:
        d = _DEFAULTS.get(op, {})
        name = d.get(torch.device(device or "cpu").type, d.get("*"))
    if name is None:
        name = next(iter(_REGISTRY[op]))
    if name not in _REGISTRY[op]:
        raise KeyError(f"ff op {op!r} has no implementation {name!r}; "
                       f"available: {impls(op)}")
    return name


def lookup(op: str, impl: str) -> Callable:
    return _REGISTRY[op][impl]


def _fallback_warn(impl: str, op: str, why: str) -> None:
    """A kernel impl that takes its plain formulation says so."""
    warnings.warn(f"ff.{op}(impl={impl!r}): {why}; falling back to the "
                  f"jnp formulation", stacklevel=3)


# -- add: FF addition with the FF/f32 promotions -----------------------------

def _as_ff(x) -> FF:
    if isinstance(x, FF):
        return x
    x = torch.as_tensor(x, dtype=torch.float32)
    return FF(x, torch.zeros_like(x))


def _add_jnp(a, b, **_kw) -> FF:
    """Add212 where one operand is f32, Add22 where both are FF."""
    if isinstance(a, FF) and not isinstance(b, FF):
        return core_ff.add212(a, torch.as_tensor(b, dtype=torch.float32))
    if isinstance(b, FF) and not isinstance(a, FF):
        return core_ff.add212(b, torch.as_tensor(a, dtype=torch.float32))
    return core_ff.add22(_as_ff(a), _as_ff(b))


def _mul_jnp(a, b, **_kw) -> FF:
    """Mul212 where one operand is f32, Mul22 where both are FF."""
    if isinstance(a, FF) and not isinstance(b, FF):
        return core_ff.mul212(a, torch.as_tensor(b, dtype=torch.float32))
    if isinstance(b, FF) and not isinstance(a, FF):
        return core_ff.mul212(b, torch.as_tensor(a, dtype=torch.float32))
    return core_ff.mul22(_as_ff(a), _as_ff(b))


register("add", "jnp", _add_jnp, default_for=("*",))
register("mul", "jnp", _mul_jnp, default_for=("*",))


# -- sum: the compensated sum -------------------------------------------------

def _sum_blocked(x: Tensor, axis=None, *, block: int = 128, **_kw) -> FF:
    return compensated.ff_sum_blocked(x, axis=axis, block=block)


register("sum", "blocked", _sum_blocked, default_for=("*",))


# -- mean_sq: the RMSNorm statistic ------------------------------------------

register("mean_sq", "jnp", ff_fused.mean_sq_plain, default_for=("*",))
register("mean_sq", "fused", ff_fused.mean_sq, default_for=("cuda",))


# -- whole-row composites: logsumexp, softmax, norm_stats ---------------------
#
# ``jnp`` is the compensated formulation (f32 max and builtin exp, FF
# exp-sum); ``pallas`` the one-kernel tier (``ff_fused.ff_softmax`` /
# ``ff_norm_stats``), the CUDA default; ``ff`` the accurate class (FF
# exponentials: its kernel on the card where the row fits, else the FF
# formulation); ``f64`` a native-f64 exp-sum.

def _last_axis_fusable(x: Tensor, axis: int) -> bool:
    """Whether the whole-row kernels apply: a last-axis reduction with the
    row within ``ff_fused.MAX_FUSED_COLS``."""
    return (x.ndim >= 1 and axis in (-1, x.ndim - 1)
            and x.shape[-1] <= ff_fused.MAX_FUSED_COLS)


def _logsumexp_jnp(x: Tensor, axis: int = -1, *, block: int = 256, **_kw):
    """Compensated LSE: f32 max, f32 builtin exp, FF exp-sum, f32 log."""
    x = x.to(torch.float32)
    m = torch.amax(x, dim=axis, keepdim=True)
    e = torch.exp(x - m)
    s = compensated.ff_sum_blocked(e, axis=axis, block=block)
    return m.squeeze(axis) + torch.log(s.to_f32())


def _logsumexp_pallas(x: Tensor, axis: int = -1, **_kw):
    """One kernel: max, exp, compensated sum, log.  Non-last axes and rows
    longer than MAX_FUSED_COLS take the jnp formulation, with a warning."""
    x = x.to(torch.float32)
    if not _last_axis_fusable(x, axis):
        _fallback_warn("pallas", "logsumexp",
                       "not a last-axis reduction within MAX_FUSED_COLS")
        return _logsumexp_jnp(x, axis=axis)
    return ff_fused.ff_softmax(x, mode="logsumexp")


def _sum_f64_axis(e: Tensor, axis: int) -> Tensor:
    """The exp-sum in native f64, rounded to f32."""
    return e.to(torch.float64).sum(dim=axis).to(torch.float32)


def _logsumexp_f64(x: Tensor, axis: int = -1, **_kw):
    """LSE with a native-f64 exp-sum (f64-quality sum, f32 builtins)."""
    x = x.to(torch.float32)
    m = torch.amax(x, dim=axis, keepdim=True)
    e = torch.exp(x - m)
    return m.squeeze(axis) + torch.log(_sum_f64_axis(e, axis))


def _ff_exp_terms(x: Tensor, axis: int):
    """exp(x - max) in FF with the reduction held exact (TwoSum)."""
    m = torch.amax(x, dim=axis, keepdim=True)
    dh, dl = T.two_sum(x, (-m).expand(x.shape))
    return m, FF(*ffmath.exp22(dh, dl))


def _ff_expsum(e: FF, axis: int, block: int) -> FF:
    return core_ff.add22_accurate(
        compensated.ff_sum_blocked(e.hi, axis=axis, block=block),
        compensated.ff_sum_blocked(e.lo, axis=axis, block=block))


def _logsumexp_ff(x: Tensor, axis: int = -1, *, block: int = 256, **_kw):
    """Accurate-class LSE: FF exponentials, FF log of the FF exp-sum."""
    x = x.to(torch.float32)
    if x.device.type == "cuda" and _last_axis_fusable(x, axis):
        return ff_fused.ff_softmax(x, mode="logsumexp", accurate=True)
    m, e = _ff_exp_terms(x, axis)
    s = _ff_expsum(e, axis, block)
    logs = FF(*ffmath.log22(s.hi, s.lo))
    return core_ff.add212(logs, m.squeeze(axis)).hi


register("logsumexp", "jnp", _logsumexp_jnp, default_for=("*",))
register("logsumexp", "pallas", _logsumexp_pallas, default_for=("cuda",))
register("logsumexp", "f64", _logsumexp_f64)
register("logsumexp", "ff", _logsumexp_ff)


def _softmax_jnp(x: Tensor, axis: int = -1, *, block: int = 256, **_kw):
    """Compensated softmax: exp(x - max) / FF-accurate denominator."""
    x = x.to(torch.float32)
    m = torch.amax(x, dim=axis, keepdim=True)
    e = torch.exp(x - m)
    s = compensated.ff_sum_blocked(e, axis=axis, block=block)
    return e / s.to_f32().unsqueeze(axis % x.ndim)


def _softmax_pallas(x: Tensor, axis: int = -1, **_kw):
    x = x.to(torch.float32)
    if not _last_axis_fusable(x, axis):
        _fallback_warn("pallas", "softmax",
                       "not a last-axis reduction within MAX_FUSED_COLS")
        return _softmax_jnp(x, axis=axis)
    return ff_fused.ff_softmax(x, mode="softmax")


def _softmax_f64(x: Tensor, axis: int = -1, **_kw):
    """Softmax with a native-f64 denominator."""
    x = x.to(torch.float32)
    m = torch.amax(x, dim=axis, keepdim=True)
    e = torch.exp(x - m)
    return e / _sum_f64_axis(e, axis).unsqueeze(axis % x.ndim)


def _softmax_ff(x: Tensor, axis: int = -1, *, block: int = 256, **_kw):
    """Accurate-class softmax: FF exponentials and an FF division."""
    x = x.to(torch.float32)
    if x.device.type == "cuda" and _last_axis_fusable(x, axis):
        return ff_fused.ff_softmax(x, mode="softmax", accurate=True)
    _m, e = _ff_exp_terms(x, axis)
    s = _ff_expsum(e, axis, block)
    ax = axis % x.ndim
    return core_ff.div22(e, FF(s.hi.unsqueeze(ax).expand(x.shape),
                               s.lo.unsqueeze(ax).expand(x.shape))).hi


register("softmax", "jnp", _softmax_jnp, default_for=("*",))
register("softmax", "pallas", _softmax_pallas, default_for=("cuda",))
register("softmax", "f64", _softmax_f64)
register("softmax", "ff", _softmax_ff)


def _norm_stats_jnp(x: Tensor, *, block: int = 128, **_kw):
    """LayerNorm statistics: compensated mean and centred variance."""
    x = x.to(torch.float32)
    n = x.shape[-1]
    mu = ff_fused.div_n(
        compensated.ff_sum_blocked(x, axis=-1, block=block).to_f32(), n)
    d = x - mu[..., None]
    var = ff_fused.div_n(
        compensated.ff_sum_blocked(d * d, axis=-1, block=block).to_f32(), n)
    return mu, var


def _norm_stats_pallas(x: Tensor, **_kw):
    x = x.to(torch.float32)
    if not _last_axis_fusable(x, -1):
        _fallback_warn("pallas", "norm_stats", "row exceeds MAX_FUSED_COLS")
        return _norm_stats_jnp(x)
    return ff_fused.ff_norm_stats(x)


register("norm_stats", "jnp", _norm_stats_jnp, default_for=("*",))
register("norm_stats", "pallas", _norm_stats_pallas, default_for=("cuda",))


# -- adamw_update: the FF-master-weight AdamW leaf update ---------------------

register("adamw_update", "jnp", ff_fused.adamw_update_plain,
         default_for=("*",))
register("adamw_update", "fused", ff_fused.adamw_update,
         default_for=("cuda",))


# -- matmul: f32 operands -> FF (FF operands: autodiff.mm_any) ----------------
#
# Each follows the reference's compiled (non-interpret) branch with "cuda"
# where it says "tpu": hybrid, dot2 and ozaki launch their CUDA kernel on a
# CUDA tensor and take the torch formulation on the CPU; the pallas_* names
# always name the kernel wrapper (its plain version on the CPU); f64 is one
# float64 GEMM on both devices.

def _mm_hybrid(a, b, *, block_k: int = 512, bm: int = 256, bn: int = 256,
               **_kw) -> FF:
    """Blocked-K f32 GEMMs + Add22, the production path."""
    if a.device.type == "cuda":
        return FF(*ff_matmul.ff_matmul(a, b, bm=bm, bn=bn, bk=block_k))
    return ffmatmul.matmul_compensated(a, b, block_k=block_k)


def _mm_pallas_hybrid(a, b, *, bm: int = 256, bn: int = 256, bk: int = 512,
                      **_kw) -> FF:
    return FF(*ff_matmul.ff_matmul(a, b, bm=bm, bn=bn, bk=bk))


def _mm_dot2(a, b, *, bm: int = 128, bn: int = 128, bk: int = 128,
             vec: int = 8, chunk: int = 32, **_kw) -> FF:
    """Paper-faithful Mul12 + Dot3 cascade (~2^-44)."""
    if a.device.type == "cuda":
        return FF(*ff_matmul.ff_matmul_dot2(a, b, bm=bm, bn=bn, bk=bk,
                                            vec=vec))
    return ffmatmul.matmul_dot2(a, b, chunk=chunk)


def _mm_pallas_dot2(a, b, *, bm: int = 128, bn: int = 128, bk: int = 128,
                    vec: int = 8, **_kw) -> FF:
    return FF(*ff_matmul.ff_matmul_dot2(a, b, bm=bm, bn=bn, bk=bk, vec=vec))


def _mm_split(a, b, *, block_k: int = 512, **_kw) -> FF:
    return ffmatmul.matmul_split(a, b, block_k=block_k)


def _mm_compensated(a, b, *, block_k: int = 512, **_kw) -> FF:
    return ffmatmul.matmul_compensated(a, b, block_k=block_k)


def _mm_ozaki(a, b, *, slices: int = 0, beta: int = 0, block_k: int = 0,
              **_kw) -> FF:
    """Exact-slice Ozaki matmul (~2^-46)."""
    if a.device.type == "cuda":
        return FF(*ff_matmul.ff_matmul_ozaki(a, b, slices=slices, beta=beta,
                                             bk=block_k or 512))
    return ffmatmul.matmul_ozaki(a, b, slices=slices, beta=beta,
                                 block_k=block_k)


def _mm_pallas_ozaki(a, b, *, slices: int = 0, beta: int = 0, bm: int = 128,
                     bn: int = 128, bk: int = 512, **_kw) -> FF:
    return FF(*ff_matmul.ff_matmul_ozaki(a, b, slices=slices, beta=beta,
                                         bm=bm, bn=bn, bk=bk))


def _mm_f64(a, b, **_kw) -> FF:
    """One float64 GEMM rounded to FF (~2^-48): the H100 and the CPU both
    have f64 units, so the reference's TPU degrade to Ozaki does not
    apply."""
    return ffmatmul.matmul_f64(a, b)


register("matmul", "hybrid", _mm_hybrid, default_for=("*",))
register("matmul", "pallas_hybrid", _mm_pallas_hybrid)
register("matmul", "compensated", _mm_compensated)
register("matmul", "split", _mm_split)
register("matmul", "dot2", _mm_dot2)
register("matmul", "pallas_dot2", _mm_pallas_dot2)
register("matmul", "ozaki", _mm_ozaki)
register("matmul", "pallas_ozaki", _mm_pallas_ozaki)
register("matmul", "f64", _mm_f64)


# -- attention ----------------------------------------------------------------

def _attention_pallas(q, k, v, *, block=128, **kw):
    if kw.get("kv_len") is not None:
        _fallback_warn("pallas", "attention",
                       "per-row kv_len (ragged batch) needs dynamic masks "
                       "the kernel's static grid cannot express")
        return ff_attention.flash_attention_ff(q, k, v, block=block, **kw)
    kw.pop("kv_len", None)
    return ff_attention.flash_attention_pallas(q, k, v, **kw)


register("attention", "fast", ff_attention.flash_attention_fast,
         default_for=("*",))
register("attention", "ff", ff_attention.flash_attention_ff)
register("attention", "pallas", _attention_pallas)


# -- the public calls (the reference's ``repro.ff`` entry points) -----------

def _resolved(op: str, impl: Optional[str], device, opts: dict):
    """The implementation of ``op`` a call on ``device`` runs, with the
    call's options bound."""
    return functools.partial(lookup(op, resolve_name(op, impl, device)),
                             **opts)


def add(a, b, *, impl: Optional[str] = None, **opts) -> FF:
    """FF addition (paper Add22; Add212 where one operand is f32).
    Accepts FF or f32 operands."""
    dev = (a.hi if isinstance(a, FF) else torch.as_tensor(a)).device
    return _resolved("add", impl, dev, opts)(a, b)


def mul(a, b, *, impl: Optional[str] = None, **opts) -> FF:
    """FF multiplication (paper Mul22; Mul212 where one operand is f32).
    Accepts FF or f32 operands; no gradient."""
    dev = (a.hi if isinstance(a, FF) else torch.as_tensor(a)).device
    return _resolved("mul", impl, dev, opts)(a, b)


def sum(x: Tensor, axis=None, *, impl: Optional[str] = None,
        **opts) -> FF:
    """Compensated sum of an f32 tensor -> FF (~44-bit accurate)."""
    x = x.to(torch.float32)
    fn = _resolved("sum", impl, x.device, opts)
    if autodiff.needs_grad(x):
        return FF(*autodiff.Sum.apply(x, fn, axis))
    return fn(x, axis=axis)


def mean_sq(x: Tensor, *, impl: Optional[str] = None, **opts) -> Tensor:
    """Compensated mean of squares over the last axis -> f32 (the RMSNorm
    statistic)."""
    x = x.to(torch.float32)
    fn = _resolved("mean_sq", impl, x.device, opts)
    if autodiff.needs_grad(x):
        return autodiff.MeanSq.apply(x, fn)
    return fn(x)


def logsumexp(x: Tensor, axis: int = -1, *, impl: Optional[str] = None,
              **opts) -> Tensor:
    """Compensated log-sum-exp -> f32 (gradient: the softmax)."""
    x = x.to(torch.float32)
    fn = _resolved("logsumexp", impl, x.device, opts)
    axis = axis % x.ndim
    if autodiff.needs_grad(x):
        return autodiff.LogSumExp.apply(x, fn, axis)
    return fn(x, axis=axis)


def _forward_only(op: str, x: Tensor) -> None:
    if autodiff.needs_grad(x):
        raise NotImplementedError(
            f"the gradient of ff.{op} is not ported yet (ROADMAP, queue "
            f"item 3): call it on a tensor that needs no gradient")


def softmax(x: Tensor, axis: int = -1, *, impl: Optional[str] = None,
            **opts) -> Tensor:
    """Compensated softmax -> f32: one kernel on the card for rows up to
    ``MAX_FUSED_COLS`` (longer rows take the jnp impl, with a warning).
    Forward only."""
    x = x.to(torch.float32)
    _forward_only("softmax", x)
    return _resolved("softmax", impl, x.device, opts)(x, axis=axis % x.ndim)


def norm_stats(x: Tensor, *, impl: Optional[str] = None, **opts):
    """Compensated LayerNorm statistics over the last axis -> (mean, var),
    both f32: one kernel on the card, reading x once.  Forward only."""
    x = x.to(torch.float32)
    _forward_only("norm_stats", x)
    return _resolved("norm_stats", impl, x.device, opts)(x)


def adamw_update(g: Tensor, m: Tensor, v: Tensor, w: Tensor, wlo: Tensor,
                 lr, b1, b2, bc1, bc2, *, eps: float, wd: float,
                 impl: Optional[str] = None, **opts):
    """The AdamW leaf update as one dispatched chain: the moments, bias
    correction, decoupled weight decay and the FF master-weight Add212 —
    one kernel launch on the card.  In place: ``(w, wlo)`` become the new
    master weight, ``m`` and ``v`` the new moments (the reference returns
    them).  Runs outside autograd (an optimizer step)."""
    g = g.to(torch.float32)
    _resolved("adamw_update", impl, g.device, opts)(
        g, m, v, w, wlo, lr, b1, b2, bc1, bc2, eps=eps, wd=wd)


def matmul(a, b, *, impl: Optional[str] = None, **opts) -> FF:
    """FF matrix product of (M, K) x (K, N) operands, each an f32 tensor
    or an FF pair.

    The impl is registry-dispatched: ``hybrid`` (blocked-K GEMMs + Add22;
    its CUDA kernel on the card) by default; ``compensated``, ``split``,
    ``dot2``, ``ozaki``, ``f64`` and the kernels ``pallas_hybrid``,
    ``pallas_dot2``, ``pallas_ozaki`` per call, per ``use(matmul=...)``
    scope or per ``policy(matmul=...)``.  Option precedence: explicit
    kwargs (``bk`` is read as ``block_k`` for the blocked-K impls) > the
    ambient policy's ``ff_matmul_block_k`` (hybrid, compensated, split).
    Differentiable: the gradient runs the same impl."""
    a = a if isinstance(a, FF) else torch.as_tensor(a).to(torch.float32)
    b = b if isinstance(b, FF) else torch.as_tensor(b).to(torch.float32)
    dev = (a.hi if isinstance(a, FF) else a).device
    name = resolve_name("matmul", impl, dev)
    opts = dict(opts)
    if "bk" in opts and name in ("hybrid", "compensated", "split", "ozaki"):
        opts.setdefault("block_k", opts.pop("bk"))
    if name in ("hybrid", "compensated", "split"):
        opts.setdefault("block_k", scope.current_policy().ff_matmul_block_k)
    base = functools.partial(lookup("matmul", name), **opts)
    limbs = [a.hi, a.lo] if isinstance(a, FF) else [a, None]
    limbs += [b.hi, b.lo] if isinstance(b, FF) else [b, None]
    if autodiff.needs_grad(*limbs):
        return FF(*autodiff.Matmul.apply(*limbs, base))
    return autodiff.mm_any(base, a, b)


def attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
              q_offset: int = 0, kv_len: Optional[Tensor] = None,
              scale: Optional[float] = None, impl: Optional[str] = None,
              return_ff: bool = False, **opts):
    """Blockwise (flash) attention with registry-selected softmax class.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) with H = KV * G (GQA).
    ``kv_len``: optional (B,) per-row valid-key counts (ragged serving
    batches).  ``return_ff=True`` returns the FF limb pair."""
    name = resolve_name("attention", impl, q.device)
    fn = lookup("attention", name)
    call = dict(causal=bool(causal), q_offset=int(q_offset),
                scale=None if scale is None else float(scale), **opts)
    if name == "fast" or return_ff or not autodiff.needs_grad(q, k, v):
        # the fast tier's gradient is plain autograd, as in the reference
        return fn(q, k, v, kv_len=kv_len, return_ff=return_ff, **call)
    if kv_len is not None:
        raise NotImplementedError("the gradient of attention with a per-row "
                                  "kv_len is not ported yet")
    return autodiff.Attention.apply(q, k, v, fn, call)
