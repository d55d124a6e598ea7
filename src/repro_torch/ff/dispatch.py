"""Dispatch registry for ``repro_torch.ff`` (counterpart of
``repro.ff.dispatch``, with the ops this slice needs).

Each op name maps to named implementations; a call resolves one:

    per-call ``impl=`` > ``use(op=impl)`` scope > per-device default
    ("cuda" / "cpu", else "*") > first registered implementation

Tuned, mesh and guard resolution are not ported yet.  Implementation names
are the reference's, so one policy string means the same in both packages:
for ``attention``, ``"pallas"`` names the one-kernel tier, which in the port
is a CUDA kernel.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import compensated
from repro_torch.ff import scope
from repro_torch.kernels import ff_attention, ff_fused

Tensor = torch.Tensor

_REGISTRY: Dict[str, Dict[str, Callable]] = {}
_DEFAULTS: Dict[str, Dict[str, str]] = {}     # op -> {device type|"*": impl}


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


# -- mean_sq: the RMSNorm statistic ------------------------------------------

register("mean_sq", "jnp", ff_fused.mean_sq_plain, default_for=("*",))
register("mean_sq", "fused", ff_fused.mean_sq, default_for=("cuda",))


# -- logsumexp ----------------------------------------------------------------

def _logsumexp_jnp(x: Tensor, axis: int = -1, *, block: int = 256, **_kw):
    """Compensated LSE: f32 max, f32 builtin exp, FF exp-sum, f32 log."""
    x = x.to(torch.float32)
    m = torch.amax(x, dim=axis, keepdim=True)
    e = torch.exp(x - m)
    s = compensated.ff_sum_blocked(e, axis=axis, block=block)
    return m.squeeze(axis) + torch.log(s.to_f32())


register("logsumexp", "jnp", _logsumexp_jnp, default_for=("*",))


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

def mean_sq(x: Tensor, *, impl: Optional[str] = None, **opts) -> Tensor:
    """Compensated mean of squares over the last axis -> f32 (the RMSNorm
    statistic)."""
    x = x.to(torch.float32)
    return lookup("mean_sq", resolve_name("mean_sq", impl, x.device))(
        x, **opts)


def logsumexp(x: Tensor, axis: int = -1, *, impl: Optional[str] = None,
              **opts) -> Tensor:
    """Compensated log-sum-exp -> f32."""
    x = x.to(torch.float32)
    return lookup("logsumexp", resolve_name("logsumexp", impl, x.device))(
        x, axis=axis, **opts)


def attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
              q_offset: int = 0, kv_len: Optional[Tensor] = None,
              scale: Optional[float] = None, impl: Optional[str] = None,
              return_ff: bool = False, **opts):
    """Blockwise (flash) attention with registry-selected softmax class.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) with H = KV * G (GQA).
    ``kv_len``: optional (B,) per-row valid-key counts (ragged serving
    batches).  ``return_ff=True`` returns the FF limb pair."""
    name = resolve_name("attention", impl, q.device)
    return lookup("attention", name)(
        q, k, v, causal=bool(causal), q_offset=int(q_offset), kv_len=kv_len,
        scale=None if scale is None else float(scale), return_ff=return_ff,
        **opts)
