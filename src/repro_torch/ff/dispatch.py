"""Dispatch registry for ``repro_torch.ff`` (counterpart of
``repro.ff.dispatch``).

Each op name maps to named implementations; a call resolves one:

    per-call ``impl=`` > ``use(op=impl)`` scope
      > policy (``PrecisionPolicy.matmul_impl``, for ``matmul``)
      > ``"tuned"`` / ``"tuned_accurate"``: the tuning table's winner of
        the call's (device, shape bucket); an untuned accurate request
        takes the op's accurate fallback (``_ACCURATE_FALLBACK``)
      > the tuning table's fast winner (``tuned_default``)
      > per-device default ("cuda" / "cpu", else "*")
      > first registered implementation

and then, inside an ``ff.guard(mode="degrade")`` scope that has recorded
a violation of the op, ``guard.maybe_degrade`` swaps an accurate-class
name for the op's fast class (source ``"guard_degraded"``).

The tuning table (:mod:`repro_torch.ff.tuning`, ``ff.tune``) is keyed by
the call's device where the reference keys it by JAX backend; a winner
this build does not register falls through to the static default.
``resolve_opts`` gives the tuned block config of a resolved impl, which
the calls merge under their explicit options.  Each resolution is
counted in ``RESOLUTIONS`` by (op, impl, source, device, bucket) and,
on the same event, in ``repro_torch.obs.REGISTRY``'s
``ff_dispatch_resolutions_total`` (the reference's resolution telemetry;
the port runs eagerly, so every call resolves and is counted, where the
reference counts at trace time only, and the ``backend`` label is the
device type).  Mesh resolution is not ported yet.

Implementation names are the reference's, so one policy string means the
same in both packages: ``"pallas"`` (``"pallas_*"`` for matmul and sum)
names the one-kernel tier, which in the port is a CUDA kernel, and for
``adamw_update``, ``"fused"`` names the one-kernel update, the CUDA default
as ``"tpu"`` is the reference's.  The ``f64`` tiers are real device tiers
(the H100 and the CPU have f64 units); unlike the reference, no CPU
default lands on them (``jnp`` stays the CPU default).

The public calls route through the ``torch.autograd.Function``s of
:mod:`repro_torch.ff.autodiff` when an input requires a gradient, and
run the resolved implementation directly otherwise: every op the
reference differentiates is differentiable here, with its closed form
(``adamw_update`` and ``ff.fused`` carry no gradient, as there).
"""

from __future__ import annotations

import collections
import functools
import importlib
import warnings
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.core import compensated, ffmatmul, ffmath
from repro_torch.core import ff as core_ff
from repro_torch.core import transforms as T
from repro_torch.core.ff import FF
from repro_torch.ff import autodiff, scope, tuning
from repro_torch.kernels import (ff_attention, ff_elementwise, ff_fused,
                                 ff_math, ff_matmul, ff_reduce)

Tensor = torch.Tensor

_REGISTRY: Dict[str, Dict[str, Callable]] = {}
_DEFAULTS: Dict[str, Dict[str, str]] = {}     # op -> {device type|"*": impl}
# what "tuned_accurate" resolves to without a tuning table: per op, the
# first registered name
_ACCURATE_FALLBACK: Dict[str, Tuple[str, ...]] = {
    "matmul": ("f64", "ozaki", "dot2"),
    "add": ("accurate",),
    # composites whose f32-builtin exponentials cap them at the fast
    # class: the accurate tier is the FF-exp impl
    "softmax": ("ff",), "logsumexp": ("ff",),
    "attention": ("f64", "ff"),
    # ff.math: native f64 (the card and the CPU have it), else the FF kernel
    **{op: ("f64", "jnp") for op in tuple(ffmath.UNARY22) + ("pow",)},
}

# (op, impl, source, device, shape bucket) -> resolutions: which rule
# picked each call's impl ("explicit", "scope", "policy", "tuned",
# "tuned_accurate", "accurate_fallback", "tuned_default",
# "static_default", "first_registered", "guard_degraded")
RESOLUTIONS: collections.Counter = collections.Counter()


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


def resolve_name(op: str, impl: Optional[str] = None, device=None,
                 shape: Optional[Sequence[int]] = None) -> str:
    """Which implementation a call to ``op`` on ``device`` uses.  With
    ``shape`` (the call's tuning bucket: (M, K, N) for matmul, (R, C)
    otherwise) the tuning table takes part (see the module docstring)."""
    if op not in _REGISTRY:
        raise KeyError(f"unknown ff op {op!r}; registered: {ops()}")
    dev = torch.device(device or "cpu").type
    name = impl or scope.current_impl(op)
    src = "explicit" if impl else ("scope" if name is not None else None)
    if name is None and op == "matmul":
        pol = scope.current_policy().matmul_impl
        if pol and pol != "auto":
            name, src = pol, "policy"
    if name in ("tuned", "tuned_accurate"):
        accurate = name == "tuned_accurate"
        name = (tuning.lookup_impl(op, shape,
                                   "accurate" if accurate else "fast", dev)
                if shape is not None else None)
        src = "tuned_accurate" if accurate else "tuned"
        if name is not None and name not in _REGISTRY[op]:
            name = None   # a stale or foreign table never breaks dispatch
        if name is None and accurate:
            # an accurate request never degrades to the fast class
            name = next((c for c in _ACCURATE_FALLBACK.get(op, ())
                         if c in _REGISTRY[op]), None)
            src = "accurate_fallback"
    if name is None and shape is not None:
        name = tuning.lookup_impl(op, shape, "fast", dev)
        src = "tuned_default"
        if name is not None and name not in _REGISTRY[op]:
            name = None
    if name is None:
        d = _DEFAULTS.get(op, {})
        name, src = d.get(dev, d.get("*")), "static_default"
    if name is None:
        name, src = next(iter(_REGISTRY[op])), "first_registered"
    if name not in _REGISTRY[op]:
        raise KeyError(f"ff op {op!r} has no implementation {name!r}; "
                       f"available: {impls(op)}")
    # the guard scope's final say: inside ff.guard(mode="degrade"), an op
    # with a recorded violation drops one accuracy class
    final = importlib.import_module("repro_torch.ff.guard").maybe_degrade(
        op, name)
    if final != name:
        name, src = final, "guard_degraded"
    bucket = tuning.bucket_key(shape) if shape else ""
    RESOLUTIONS[(op, name, src, dev, bucket)] += 1
    obs.record("record_resolution", op, name, src, dev, bucket)
    return name


def resolve_opts(op: str, name: str, shape: Optional[Sequence[int]] = None,
                 device=None) -> dict:
    """The measured-best block config of ``name`` at ``shape`` on
    ``device`` (empty without a table entry); callers merge it under
    their explicit options."""
    if shape is None:
        return {}
    return tuning.lookup_opts(op, name, shape, torch.device(device or "cpu"))


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


def _add_accurate(a, b, **_kw) -> FF:
    return core_ff.add22_accurate(_as_ff(a), _as_ff(b))


def _elementwise_pallas(op22: str):
    """The one-kernel tier of a binary FF op (``ff_elementwise``): FF or
    f32 operands, both lifted to FF (an f32 operand's lo is 0)."""
    def fn(a, b, *, block=None, **_kw) -> FF:
        af, bf = _as_ff(a), _as_ff(b)
        return FF(*ff_elementwise.elementwise(
            op22, af.hi, af.lo, bf.hi, bf.lo,
            block=tuple(block) if block else ff_elementwise.DEFAULT_BLOCK))
    return fn


def _div_jnp(a, b, **_kw) -> FF:
    return core_ff.div22(_as_ff(a), _as_ff(b))


def _sqrt_jnp(a, **_kw) -> FF:
    return core_ff.sqrt22(_as_ff(a))


def _sqrt_pallas(a, *, block=None, **_kw) -> FF:
    af = _as_ff(a)
    return FF(*ff_elementwise.elementwise(
        "sqrt22", af.hi, af.lo,
        block=tuple(block) if block else ff_elementwise.DEFAULT_BLOCK))


# The elementwise default is jnp on every device, as in the reference: the
# per-op kernels stay registered for explicit callers and for ff.tune.
register("add", "jnp", _add_jnp, default_for=("*",))
register("add", "accurate", _add_accurate)
register("add", "pallas", _elementwise_pallas("add22"))
register("mul", "jnp", _mul_jnp, default_for=("*",))
register("mul", "pallas", _elementwise_pallas("mul22"))
register("div", "jnp", _div_jnp, default_for=("*",))
register("div", "pallas", _elementwise_pallas("div22"))
register("sqrt", "jnp", _sqrt_jnp, default_for=("*",))
register("sqrt", "pallas", _sqrt_pallas)


# -- EFTs: (f32, f32) -> FF, exact ---------------------------------------------

def _f32(x) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _two_sum_jnp(a, b) -> FF:
    return FF(*T.two_sum(_f32(a), _f32(b)))


def _two_prod_jnp(a, b) -> FF:
    return FF(*T.two_prod(_f32(a), _f32(b)))


def _eft_pallas(op: str):
    def fn(a, b) -> FF:
        return FF(*ff_elementwise.elementwise(op, _f32(a), _f32(b)))
    return fn


register("two_sum", "jnp", _two_sum_jnp, default_for=("*",))
register("two_sum", "pallas", _eft_pallas("two_sum"))
register("two_prod", "jnp", _two_prod_jnp, default_for=("*",))
register("two_prod", "pallas", _eft_pallas("two_prod"))


# -- sum: the compensated sum -------------------------------------------------

def _sum_blocked(x: Tensor, axis=None, *, block: int = 128, **_kw) -> FF:
    return compensated.ff_sum_blocked(x, axis=axis, block=block)


def _sum_cascade(x: Tensor, axis=None, **_kw) -> FF:
    return compensated.ff_sum(x, axis=axis)


def _sum_pallas_rowsum(x: Tensor, axis=None, *, br: int = 256,
                       bc: int = 512, lane: int = 128, **_kw) -> FF:
    """The row-sum kernel over the last axis; ND input flattens to
    (prod(leading), last).  Other axes take the blocked impl, with a
    warning (a tuned winner must never break a call)."""
    if isinstance(axis, tuple) and len(axis) == 1:
        axis = axis[0]
    if x.ndim < 1 or axis not in (-1, x.ndim - 1):
        _fallback_warn("pallas_rowsum", "sum",
                       f"axis {axis} of a {x.ndim}-D input is not a "
                       f"last-axis row reduction")
        return _sum_blocked(x, axis=axis)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]) if x.ndim != 2 else x
    hi, lo = ff_reduce.ff_rowsum(x2, br=br, bc=bc, lane=lane)
    return FF(hi.reshape(lead), lo.reshape(lead))


register("sum", "blocked", _sum_blocked, default_for=("*",))
register("sum", "cascade", _sum_cascade)
register("sum", "pallas_rowsum", _sum_pallas_rowsum)


# -- mean, dot: the compensated mean and dot product ---------------------------

def _dot_jnp(a: Tensor, b: Tensor, axis=None, **_kw) -> FF:
    return compensated.ff_dot(a, b, axis=axis)


def _mean_jnp(x: Tensor, axis=None, *, block: int = 128, **_kw) -> FF:
    """The blocked compensated sum over n in FF (Div22 by n as FF, exact
    to 2^48: an f32-rounded 1/n would cap the mean at ~2^-24)."""
    s = compensated.ff_sum_blocked(x, axis=axis, block=block)
    return core_ff.div22(s, FF.from_f64(float(compensated.axis_size(
        x, axis)), device=x.device))


register("dot", "jnp", _dot_jnp, default_for=("*",))
register("mean", "jnp", _mean_jnp, default_for=("*",))


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
    """Exact-slice Ozaki matmul (~2^-46), annotated ``ff.matmul_ozaki``
    for profiles inside ``obs.enable()``."""
    with obs.annotate("ff.matmul_ozaki"):
        if a.device.type == "cuda":
            return FF(*ff_matmul.ff_matmul_ozaki(
                a, b, slices=slices, beta=beta, bk=block_k or 512))
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


# the f64 tier's size guard: B H Sq Skv scores materialised at most
ATTENTION_F64_MAX_SCORES = 1 << 24


def _attention_f64(q, k, v, *, causal=True, q_offset=0, kv_len=None,
                   scale=None, return_ff=False, **_kw):
    """Float64 attention on the device (``ff_attention.attention_f64``,
    the (Sq, Skv) score plane materialised) up to
    ``ATTENTION_F64_MAX_SCORES``; past that size guard the ``ff`` tier,
    with a warning, as in the reference."""
    B, Sq, H = q.shape[0], q.shape[1], q.shape[2]
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, scale=scale,
              return_ff=return_ff)
    if B * H * Sq * k.shape[1] <= ATTENTION_F64_MAX_SCORES:
        return ff_attention.attention_f64(q, k, v, **kw)
    _fallback_warn("f64", "attention",
                   "materialized f64 score plane exceeds the size guard")
    return ff_attention.flash_attention_ff(q, k, v, **kw)


register("attention", "fast", ff_attention.flash_attention_fast,
         default_for=("*",))
register("attention", "ff", ff_attention.flash_attention_ff)
register("attention", "pallas", _attention_pallas)
register("attention", "f64", _attention_f64)


# -- the FF elementary functions (ff.math) ------------------------------------
#
# Four classes per function, as in the reference: ``jnp`` the compensated
# formulation (``core.ffmath``; the default everywhere), ``pallas`` the
# same arithmetic as one CUDA kernel (``ff_math``; bitwise ``jnp``), ``f64``
# the native-f64 function rounded to FF (a real tier on the card and the
# CPU, never a default), ``fast`` the f32 builtin on hi + lo, lifted to FF
# with a zero lo (~2^-24: never a default, never a tuned fast winner).

MATH_UNARY_OPS: Tuple[str, ...] = tuple(sorted(ffmath.UNARY22))
MATH_OPS: Tuple[str, ...] = MATH_UNARY_OPS + ("pow",)


def _math_jnp(op: str):
    fn = ffmath.UNARY22[op]

    def impl(a, **_kw) -> FF:
        af = _as_ff(a)
        return FF(*fn(af.hi, af.lo))
    return impl


def _math_block(block) -> Tuple[int, int]:
    return tuple(block) if block else ff_math.DEFAULT_BLOCK


def _math_pallas(op: str):
    def impl(a, *, block=None, **_kw) -> FF:
        af = _as_ff(a)
        return FF(*ff_math.math_elementwise(op, af.hi, af.lo,
                                            block=_math_block(block)))
    return impl


def _f64_to_ff(r: Tensor) -> FF:
    hi = r.to(torch.float32)
    return FF(hi, (r - hi.to(torch.float64)).to(torch.float32))


def _sigmoid64(x: Tensor) -> Tensor:
    one = torch.ones_like(x)
    return one / (one + torch.exp(-x))


def _gelu64(x: Tensor) -> Tensor:
    one = torch.ones_like(x)
    two = one + one
    return (one / two) * x * (one + torch.erf(x / torch.sqrt(two)))


_MATH_F64_FNS = {
    "exp": torch.exp, "expm1": torch.expm1, "log": torch.log,
    "log1p": torch.log1p, "tanh": torch.tanh, "sigmoid": _sigmoid64,
    "erf": torch.erf, "gelu": _gelu64, "silu": lambda x: x * _sigmoid64(x),
}


def _math_f64(op: str):
    fn = _MATH_F64_FNS[op]

    def impl(a, **_kw) -> FF:
        af = _as_ff(a)
        return _f64_to_ff(fn(af.hi.to(torch.float64)
                             + af.lo.to(torch.float64)))
    return impl


_MATH_FAST_FNS = {
    "exp": torch.exp, "expm1": torch.expm1, "log": torch.log,
    "log1p": torch.log1p, "tanh": torch.tanh, "sigmoid": torch.sigmoid,
    "erf": torch.erf,
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="none"),
    "silu": torch.nn.functional.silu,
}


def _math_fast(op: str):
    fn = _MATH_FAST_FNS[op]

    def impl(a, **_kw) -> FF:
        af = _as_ff(a)
        return FF.from_f32(fn(af.hi + af.lo))
    return impl


for _op in MATH_UNARY_OPS:
    register(_op, "jnp", _math_jnp(_op), default_for=("*",))
    register(_op, "pallas", _math_pallas(_op))
    register(_op, "f64", _math_f64(_op))
    register(_op, "fast", _math_fast(_op))


def _pow_jnp(a, b, **_kw) -> FF:
    af, bf = _as_ff(a), _as_ff(b)
    return FF(*ffmath.pow22(af.hi, af.lo, bf.hi, bf.lo))


def _pow_pallas(a, b, *, block=None, **_kw) -> FF:
    af, bf = _as_ff(a), _as_ff(b)
    return FF(*ff_math.math_elementwise("pow", af.hi, af.lo, bf.hi, bf.lo,
                                        block=_math_block(block)))


def _pow_f64(a, b, **_kw) -> FF:
    """Native-f64 pow with the FF kernel's domain rule: nan for a < 0
    (unless b == 0), no integer-exponent case."""
    af, bf = _as_ff(a), _as_ff(b)
    neg = (af.hi < 0) & (bf.hi != 0)
    x = af.hi.to(torch.float64) + af.lo.to(torch.float64)
    y = bf.hi.to(torch.float64) + bf.lo.to(torch.float64)
    return _f64_to_ff(torch.where(neg, float("nan"), torch.pow(x, y)))


def _pow_fast(a, b, **_kw) -> FF:
    af, bf = _as_ff(a), _as_ff(b)
    a32, b32 = af.hi + af.lo, bf.hi + bf.lo
    return FF.from_f32(torch.where((a32 < 0) & (b32 != 0), float("nan"),
                                   torch.pow(a32, b32)))


register("pow", "jnp", _pow_jnp, default_for=("*",))
register("pow", "pallas", _pow_pallas)
register("pow", "f64", _pow_f64)
register("pow", "fast", _pow_fast)


# -- the public calls (the reference's ``repro.ff`` entry points) -----------

def _resolved(op: str, impl: Optional[str], device, opts: dict,
              shape: Optional[Sequence[int]] = None):
    """The implementation of ``op`` a call on ``device`` (tuning bucket
    ``shape``) runs, with the call's options bound over the tuned ones."""
    name = resolve_name(op, impl, device, shape)
    fn = functools.partial(lookup(op, name), **autodiff.merge_tuned(
        op, name, shape, opts, device))
    fn.impl = name                  # the resolved name (ff.math's tier)
    return fn


def _limbs(x):
    return (x.hi, x.lo) if isinstance(x, FF) else (x,)


def _ew_call(op: str, impl: Optional[str], opts: dict, *xs):
    """An elementwise call's implementation, resolved on its operands'
    device and broadcast (R, C) bucket."""
    xs = [x if isinstance(x, FF) else torch.as_tensor(x, dtype=torch.float32)
          for x in xs]
    dev = ff_elementwise.operand_device([t for x in xs for t in _limbs(x)])
    shape = autodiff.bucket2d(torch.broadcast_shapes(
        *(x.shape for x in xs)))
    return _resolved(op, impl, dev, opts, shape), xs


def _binary(grad_fn, fn: Callable, a, b) -> FF:
    """``fn(a, b)``, through the autograd Function ``grad_fn`` when an
    operand needs a gradient (its limbs broadcast outside the Function)."""
    if not autodiff.needs_grad(*_limbs(a), *_limbs(b)):
        return fn(a, b)
    return FF(*grad_fn.apply(*autodiff.broadcast2(a, b), fn))


def add(a, b, *, impl: Optional[str] = None, **opts) -> FF:
    """FF addition (paper Add22; Add212 where one operand is f32).
    Accepts FF or f32 operands; differentiable (``autodiff.Add``)."""
    fn, (a, b) = _ew_call("add", impl, opts, a, b)
    return _binary(autodiff.Add, fn, a, b)


def sub(a, b, *, impl: Optional[str] = None, **opts) -> FF:
    """FF subtraction: add(a, -b) (negation is exact)."""
    b = b if isinstance(b, FF) else torch.as_tensor(b, dtype=torch.float32)
    return add(a, -b, impl=impl, **opts)


def mul(a, b, *, impl: Optional[str] = None, **opts) -> FF:
    """FF multiplication (paper Mul22; Mul212 where one operand is f32).
    Accepts FF or f32 operands; differentiable (``autodiff.Mul``)."""
    fn, (a, b) = _ew_call("mul", impl, opts, a, b)
    return _binary(autodiff.Mul, fn, a, b)


def div(a, b, *, impl: Optional[str] = None, **opts) -> FF:
    """FF division (Dekker quotient + one correction).  Accepts FF or f32
    operands; differentiable (``autodiff.Div``)."""
    fn, (a, b) = _ew_call("div", impl, opts, a, b)
    return _binary(autodiff.Div, fn, a, b)


def sqrt(a, *, impl: Optional[str] = None, **opts) -> FF:
    """FF square root (correctly rounded f32 root + one Newton
    correction); differentiable (``autodiff.Sqrt``)."""
    fn, (a,) = _ew_call("sqrt", impl, opts, a)
    if not autodiff.needs_grad(*_limbs(a)):
        return fn(a)
    return FF(*autodiff.Sqrt.apply(*autodiff.limb_pair(a), fn))


def _eft(op: str, grad_fn, impl: Optional[str], opts: dict, a, b) -> FF:
    """An EFT of two f32 tensors, through ``grad_fn`` (the operands
    broadcast outside it) when one needs a gradient."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32)
    dev = ff_elementwise.operand_device([a, b])
    fn = functools.partial(lookup(op, resolve_name(op, impl, dev)), **opts)
    if not autodiff.needs_grad(a, b):
        return fn(a, b)
    a, _, b, _ = autodiff.broadcast2(a, b)
    return FF(*grad_fn.apply(a, b, fn))


def two_sum(a, b, *, impl: Optional[str] = None, **opts) -> FF:
    """Exact a + b of two f32 tensors as FF (paper Theorem 2);
    differentiable (``autodiff.TwoSum``)."""
    return _eft("two_sum", autodiff.TwoSum, impl, opts, a, b)


def two_prod(a, b, *, impl: Optional[str] = None, **opts) -> FF:
    """Exact a * b of two f32 tensors as FF (paper Theorem 4, Dekker's
    split); differentiable (``autodiff.TwoProd``)."""
    return _eft("two_prod", autodiff.TwoProd, impl, opts, a, b)


def sum(x: Tensor, axis=None, *, impl: Optional[str] = None,
        **opts) -> FF:
    """Compensated sum of an f32 tensor -> FF (~44-bit accurate)."""
    x = x.to(torch.float32)
    fn = _resolved("sum", impl, x.device, opts, autodiff.bucket2d(x.shape))
    if autodiff.needs_grad(x):
        return FF(*autodiff.Sum.apply(x, fn, axis))
    return fn(x, axis=axis)


def mean(x: Tensor, axis=None, *, impl: Optional[str] = None,
         **opts) -> FF:
    """Compensated mean of an f32 tensor -> FF (the blocked sum over n,
    Div22); differentiable (``autodiff.Mean``)."""
    x = torch.as_tensor(x).to(torch.float32)
    fn = _resolved("mean", impl, x.device, opts)
    if autodiff.needs_grad(x):
        return FF(*autodiff.Mean.apply(x, fn, axis))
    return fn(x, axis=axis)


def dot(a: Tensor, b: Tensor, axis=None, *, impl: Optional[str] = None,
        **opts) -> FF:
    """Compensated dot product of two f32 tensors of one shape over
    ``axis`` (all axes by default) -> FF (TwoProd products, Dot3-quality
    cascade); differentiable (``autodiff.Dot``)."""
    a = torch.as_tensor(a).to(torch.float32)
    b = torch.as_tensor(b).to(torch.float32)
    fn = _resolved("dot", impl, a.device, opts)
    if autodiff.needs_grad(a, b):
        return FF(*autodiff.Dot.apply(a, b, fn, axis))
    return fn(a, b, axis=axis)


def mean_sq(x: Tensor, *, impl: Optional[str] = None, **opts) -> Tensor:
    """Compensated mean of squares over the last axis -> f32 (the RMSNorm
    statistic)."""
    x = x.to(torch.float32)
    fn = _resolved("mean_sq", impl, x.device, opts,
                   autodiff.bucket2d(x.shape))
    if autodiff.needs_grad(x):
        return autodiff.MeanSq.apply(x, fn)
    return fn(x)


def logsumexp(x: Tensor, axis: int = -1, *, impl: Optional[str] = None,
              **opts) -> Tensor:
    """Compensated log-sum-exp -> f32 (gradient: the softmax)."""
    x = x.to(torch.float32)
    fn = _resolved("logsumexp", impl, x.device, opts,
                   autodiff.bucket2d(x.shape))
    axis = axis % x.ndim
    if autodiff.needs_grad(x):
        return autodiff.LogSumExp.apply(x, fn, axis)
    return fn(x, axis=axis)


def softmax(x: Tensor, axis: int = -1, *, impl: Optional[str] = None,
            **opts) -> Tensor:
    """Compensated softmax -> f32: one kernel on the card for rows up to
    ``MAX_FUSED_COLS`` (longer rows take the jnp impl, with a warning).
    Differentiable (``autodiff.Softmax``)."""
    x = x.to(torch.float32)
    fn = _resolved("softmax", impl, x.device, opts,
                   autodiff.bucket2d(x.shape))
    axis = axis % x.ndim
    if autodiff.needs_grad(x):
        return autodiff.Softmax.apply(x, fn, axis)
    return fn(x, axis=axis)


def norm_stats(x: Tensor, *, impl: Optional[str] = None, **opts):
    """Compensated LayerNorm statistics over the last axis -> (mean, var),
    both f32: one kernel on the card, reading x once.  Differentiable
    (``autodiff.NormStats``)."""
    x = x.to(torch.float32)
    fn = _resolved("norm_stats", impl, x.device, opts,
                   autodiff.bucket2d(x.shape))
    if autodiff.needs_grad(x):
        return autodiff.NormStats.apply(x, fn)
    return fn(x)


def adamw_update(g: Tensor, m: Tensor, v: Tensor, w: Tensor, wlo: Tensor,
                 lr, b1, b2, bc1, bc2, *, eps: float, wd: float,
                 impl: Optional[str] = None, **opts):
    """The AdamW leaf update as one dispatched chain: the moments, bias
    correction, decoupled weight decay and the FF master-weight Add212 —
    one kernel launch on the card.  In place: ``(w, wlo)`` become the new
    master weight, ``m`` and ``v`` the new moments (the reference returns
    them).  Runs outside autograd (an optimizer step)."""
    g = g.to(torch.float32)
    _resolved("adamw_update", impl, g.device, opts,
              autodiff.bucket2d(g.shape))(
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
    tuned block config (``ff.tune``) > the ambient policy's
    ``ff_matmul_block_k`` (hybrid, compensated, split).  Resolution is
    shape-aware: a tuning-table entry for the (M, K, N) bucket supplies
    the default impl.  Differentiable: the gradient runs the same impl."""
    a = a if isinstance(a, FF) else torch.as_tensor(a).to(torch.float32)
    b = b if isinstance(b, FF) else torch.as_tensor(b).to(torch.float32)
    dev = (a.hi if isinstance(a, FF) else a).device
    mkn = (a.shape[-2], a.shape[-1], b.shape[-1])
    name = resolve_name("matmul", impl, dev, mkn)
    opts = dict(opts)
    if "bk" in opts and name in ("hybrid", "compensated", "split", "ozaki"):
        opts.setdefault("block_k", opts.pop("bk"))
    opts = autodiff.merge_tuned("matmul", name, mkn, opts, dev)
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
    batches).  ``return_ff=True`` returns the FF limb pair.  The accurate
    tiers (``ff``, ``pallas``, ``f64``) back-propagate through the fast
    recurrence (``autodiff.Attention``), with ``kv_len`` too."""
    bshape = autodiff.bucket2d((q.shape[1], k.shape[1]))
    name = resolve_name("attention", impl, q.device, bshape)
    fn = lookup("attention", name)
    call = dict(causal=bool(causal), q_offset=int(q_offset),
                scale=None if scale is None else float(scale),
                **autodiff.merge_tuned("attention", name, bshape, opts,
                                       q.device))
    if name == "fast" or return_ff or not autodiff.needs_grad(q, k, v):
        # the fast tier's gradient is plain autograd, as in the reference
        return fn(q, k, v, kv_len=kv_len, return_ff=return_ff, **call)
    return autodiff.Attention.apply(q, k, v, fn, call, kv_len)
