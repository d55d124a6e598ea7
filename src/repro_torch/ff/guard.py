"""``ff.guard``: numeric guardrails for float-float values (counterpart of
``repro.ff.guard``).

The paper's 2^-44 contract holds only while both limbs stay well-formed:
finite, and normalized (``|lo| <= ulp(hi)/2``).  This module makes those
invariants observable and recoverable:

* :func:`guard_probe`: per-category violation counts (``nonfinite``,
  ``unnormalized``, ``denormal_lo``) of an FF value, a registered dispatch
  op with the ``jnp`` impl (plain torch, the default everywhere) and the
  ``pallas`` impl (the ``guard_flags`` CUDA kernel, by ``impl=`` or
  ``ff.use(guard_probe="pallas")``);
* :func:`health_mask` / :func:`assert_healthy`: the invariant as a boolean
  mask and as a check raising the typed :class:`FFError` taxonomy;
* :class:`guard`: a scoped policy slot, ``ff.guard(mode=...)``::

      with ff.guard(mode="degrade") as g:
          y = ff.exp(x)              # violation -> warn, count, and the
          ...                        # op re-resolves one class lower
      g.counters                     # {("exp", "nonfinite"): 2, ...}

  ``mode="off"`` (the ambient state) disables every probe, ``"check"``
  detects, warns and counts, ``"degrade"`` also repairs the flagged lanes
  (:func:`protect`) and drops the offending op one accuracy class (ff ->
  fast f32) for the rest of the scope: the dispatch registry consults
  :func:`maybe_degrade` at resolution time.

The port runs eagerly, so :func:`protect` brings its two counts to the
host (one sync) where the reference hands them to a ``jax.debug.callback``;
with the mode ``off`` it does nothing.  Every recorded violation also
counts in ``repro_torch.obs.REGISTRY`` (``ff_guard_violations_total``,
past the warn-once), and every warning in ``ff_warnings_total``, as in
the reference.  Scopes are thread-local Python state, like
``ff.policy``.
"""

from __future__ import annotations

import threading
import warnings
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.core.ff import FF
from repro_torch.ff import dispatch, tuning
from repro_torch.kernels.ff_guard import flag_planes, guard_flags

Tensor = torch.Tensor

_MODES = ("off", "check", "degrade")


# ===========================================================================
# FFError taxonomy
# ===========================================================================

class FFError(RuntimeError):
    """Base of the structured FF failure taxonomy: the op name, a
    violation ``kind`` and a detail string."""

    kind = "error"

    def __init__(self, op: str, detail: str = ""):
        self.op = op
        self.detail = detail
        super().__init__(
            f"ff.{op}: {self.kind}" + (f" — {detail}" if detail else ""))


class FFNonFiniteError(FFError):
    """A NaN or Inf limb reached an FF value."""
    kind = "nonfinite"


class FFNormalizationError(FFError):
    """An FF pair violates ``|lo| <= ulp(hi)/2``: the limbs overlap and
    the 2^-44 contract no longer holds."""
    kind = "unnormalized"


class FFResourceError(FFError):
    """A host-side FF resource fault (page pool, bounded queue, sidecar)."""
    kind = "resource"


class FFGuardWarning(UserWarning):
    """A guard scope detected (and handled) an FF invariant violation."""


class FFTuneWarning(UserWarning):
    """The tuning sidecar was unusable and static defaults are in effect."""


#: violation kind -> the error class assert_healthy raises for it
_ERRORS = {"nonfinite": FFNonFiniteError,
           "unnormalized": FFNormalizationError}


# ===========================================================================
# probes
# ===========================================================================

class GuardCounts(NamedTuple):
    """Per-category violation counts of one :func:`guard_probe` pass, int32
    scalar tensors on the probed value's device.  ``nonfinite`` and
    ``unnormalized`` are invariant violations; ``denormal_lo`` is a hazard
    flag (a legal pair may carry a subnormal ``lo``)."""
    nonfinite: Tensor
    unnormalized: Tensor
    denormal_lo: Tensor

    @property
    def violations(self) -> Tensor:
        """nonfinite + unnormalized (the health-gating total)."""
        return self.nonfinite + self.unnormalized


def _as_limbs(x, lo=None) -> Tuple[Tensor, Tensor]:
    if isinstance(x, FF):
        return x.hi, x.lo
    hi = torch.as_tensor(x, dtype=torch.float32)
    lo = torch.zeros_like(hi) if lo is None else torch.as_tensor(
        lo, dtype=torch.float32, device=hi.device)
    return hi, lo


def health_mask(x, lo=None) -> Tensor:
    """Elementwise FF health: True where both limbs are finite and the pair
    is normalized (a subnormal ``lo`` does not fail it).  Accepts an
    :class:`FF`, (hi, lo) planes or a plain f32 tensor (finiteness only)."""
    nf, un, _ = flag_planes(*_as_limbs(x, lo))
    return ~(nf | un)


def _sum32(plane: Tensor) -> Tensor:
    return plane.sum(dtype=torch.int32)


def _guard_probe_jnp(x, lo=None, **_kw) -> GuardCounts:
    return GuardCounts(*map(_sum32, flag_planes(*_as_limbs(x, lo))))


def _guard_probe_pallas(x, lo=None, *, block=None, **_kw) -> GuardCounts:
    codes = guard_flags(*_as_limbs(x, lo), block=block).to(torch.int32)
    return GuardCounts(_sum32(codes & 1), _sum32((codes >> 1) & 1),
                       _sum32((codes >> 2) & 1))


def guard_probe(x, lo=None, *, impl: Optional[str] = None,
                **opts) -> GuardCounts:
    """Count FF invariant violations: :class:`GuardCounts` ``(nonfinite,
    unnormalized, denormal_lo)`` of an :class:`FF`, explicit ``(hi, lo)``
    planes or a plain f32 tensor.  Resolved like every op (``impl=``,
    ``ff.use(guard_probe=...)``); exact integer counts on every impl."""
    hi, lo = _as_limbs(x, lo)
    name = dispatch.resolve_name("guard_probe", impl, hi.device)
    return dispatch.lookup("guard_probe", name)(hi, lo, **opts)


def assert_healthy(x, lo=None, *, op: str = "value") -> None:
    """Raise the :class:`FFError` subclass of the first violated category
    (nonfinite before unnormalized)."""
    c = guard_probe(x, lo)
    for kind, n in (("nonfinite", c.nonfinite),
                    ("unnormalized", c.unnormalized)):
        n = int(n)
        if n:
            raise _ERRORS[kind](op, f"{n} element(s) flagged by guard_probe")


# ===========================================================================
# the scoped guard policy slot
# ===========================================================================

class GuardScope:
    """State of one ``ff.guard`` scope: the mode, per-(op, kind) violation
    counters, and the ops degraded within the scope."""

    def __init__(self, mode: str):
        if mode not in _MODES:
            raise ValueError(f"guard mode {mode!r}; choose from {_MODES}")
        self.mode = mode
        self.counters: Dict[Tuple[str, str], int] = {}
        self.degraded: set = set()
        self._warned: set = set()

    def record(self, op: str, kind: str, count: int = 1) -> None:
        """Count a detected violation; warn once per (op, kind); in
        ``degrade`` mode mark ``op`` for one-class-lower resolution.  The
        obs counter accumulates on every call, past the warn-once."""
        if self.mode == "off" or count <= 0:
            return
        key = (op, kind)
        self.counters[key] = self.counters.get(key, 0) + int(count)
        obs.record("record_guard_violation", op, kind, int(count))
        if self.mode == "degrade" and kind in _ERRORS:
            self.degraded.add(op)
        if key not in self._warned:
            self._warned.add(key)
            act = ("degrading ff.%s one accuracy class for this scope"
                   % op if self.mode == "degrade" and kind in _ERRORS
                   else "counting only (mode=%r)" % self.mode)
            obs.record("record_warning", "guard")
            warnings.warn(f"ff.guard: {count} {kind} FF element(s) in "
                          f"ff.{op} — {act}", FFGuardWarning, stacklevel=2)


_OFF = GuardScope("off")


class _GuardState(threading.local):
    def __init__(self):
        self.stack = []


_STATE = _GuardState()


def current_guard() -> GuardScope:
    """The innermost active guard scope (a shared ``mode="off"`` scope when
    none is active)."""
    return _STATE.stack[-1] if _STATE.stack else _OFF


class guard:
    """Context manager installing an FF guard policy for the scope:
    ``"off"``, ``"check"`` (detect, warn, count) or ``"degrade"`` (check,
    repair flagged lanes, re-resolve the offending op one accuracy class
    lower for the rest of the scope).  Yields the :class:`GuardScope`."""

    def __init__(self, mode: str = "check"):
        self._scope = GuardScope(mode)

    def __enter__(self) -> GuardScope:
        _STATE.stack.append(self._scope)
        return self._scope

    def __exit__(self, *exc):
        _STATE.stack.pop()
        return False


def report_violation(op: str, kind: str, count: int = 1) -> None:
    """Record a violation against the innermost guard scope (the entry
    point of host-side detectors such as the serve engine)."""
    current_guard().record(op, kind, count)


def protect(op: str, value, fallback=None):
    """Guard an FF op result under the ambient scope.

    ``"off"``: returns ``value`` untouched, with no device work.
    ``"check"``: counts the result's nonfinite and unnormalized lanes into
    the scope (one host sync) and warns once.  ``"degrade"``: also
    repairs the flagged lanes to ``fallback`` (default: the ``hi`` limb
    with NaN/Inf zeroed and a zero ``lo``, the fast-class value of the
    same computation) and marks ``op`` for degraded resolution."""
    g = current_guard()
    if g.mode == "off" or not isinstance(value, FF):
        return value
    nf, un, _ = flag_planes(value.hi, value.lo)
    n_nf, n_un = torch.stack([_sum32(nf), _sum32(un)]).tolist()
    g.record(op, "nonfinite", n_nf)
    g.record(op, "unnormalized", n_un)
    if g.mode != "degrade":
        return value
    bad = nf | un
    if fallback is None:
        hi = torch.where(torch.isfinite(value.hi), value.hi, 0.0)
        fb = FF(hi, torch.zeros_like(hi))
    elif isinstance(fallback, FF):
        fb = fallback
    else:
        f = torch.as_tensor(fallback, dtype=torch.float32,
                            device=value.hi.device)
        fb = FF(f.expand(value.hi.shape), torch.zeros_like(value.hi))
    return FF(torch.where(bad, fb.hi, value.hi),
              torch.where(bad, fb.lo, value.lo))


# per-op preferred fast-class impls for one-class degradation (first
# registered name wins; ops not listed take any fast-class impl)
_FAST_DEGRADE: Dict[str, Tuple[str, ...]] = {
    "matmul": ("hybrid", "split", "jnp"),
    "add": ("jnp",),
    "softmax": ("jnp",),
    "logsumexp": ("jnp",),
    "attention": ("fast",),
}


def maybe_degrade(op: str, name: str) -> str:
    """Dispatch hook: inside a ``mode="degrade"`` scope that has marked
    ``op``, swap an accurate-class resolution for the op's fast class (one
    class lower, never another op).  Anywhere else: identity."""
    g = current_guard()
    if g.mode != "degrade" or op not in g.degraded:
        return name
    if tuning.accuracy_class(op, name) == "fast":
        return name                      # already at the fast class
    reg = dispatch._REGISTRY.get(op, {})
    swap = next((c for c in _FAST_DEGRADE.get(op, ()) if c in reg), None)
    if swap is None:
        swap = next((c for c in reg
                     if tuning.accuracy_class(op, c) == "fast"), None)
    if swap is None:
        return name                      # no fast class registered: keep
    key = (op, "degrade-resolve")
    if key not in g._warned:
        g._warned.add(key)
        obs.record("record_warning", "guard")
        warnings.warn(f"ff.guard(mode='degrade'): resolving ff.{op} to "
                      f"fast-class impl {swap!r} (was {name!r}) for this "
                      f"scope", FFGuardWarning, stacklevel=3)
    return swap


dispatch.register("guard_probe", "jnp", _guard_probe_jnp, default_for=("*",))
dispatch.register("guard_probe", "pallas", _guard_probe_pallas)
