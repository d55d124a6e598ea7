"""Scoped precision policy + dispatch overrides (counterpart of
``repro.ff.scope``, without the mesh scope).

:func:`resolve_policy`: explicit argument wins, otherwise the innermost
active :class:`policy` scope, otherwise the process default.  PyTorch is
eager, so a scope applies to every call made inside it (the reference's
scopes are read at trace time).  Scopes are thread-local.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, ContextManager, Dict, Optional, Union

from repro_torch.core.policy import BASELINE, PrecisionPolicy


class _ScopeState(threading.local):
    def __init__(self):
        self.policies = []      # innermost-last stack of PrecisionPolicy
        self.impls = []         # innermost-last stack of {op: impl_name}


_STATE = _ScopeState()


def current_policy() -> PrecisionPolicy:
    """The innermost active policy scope, else ``BASELINE`` (the
    reference's process default)."""
    if _STATE.policies:
        return _STATE.policies[-1]
    return BASELINE


def resolve_policy(explicit: Optional[PrecisionPolicy] = None
                   ) -> PrecisionPolicy:
    """Explicit policy if given, else the ambient scoped/default policy."""
    return explicit if explicit is not None else current_policy()


class policy:
    """Context manager installing a :class:`PrecisionPolicy` for the scope.

    Accepts a level name, an existing :class:`PrecisionPolicy`, or nothing
    (derive from the current scope), plus field overrides, e.g.
    ``policy("ff_reduce", attention="pallas")``.  ``matmul=`` selects the
    FF matmul implementation the dispatch registry uses inside the scope
    (``"hybrid"``, ``"dot2"``, ``"ozaki"``, ...; ``"tuned"`` and
    ``"tuned_accurate"`` resolve to the static default and the accurate
    fallback while the port has no tuning table).
    """

    def __init__(self,
                 level_or_policy: Union[str, PrecisionPolicy, None] = None,
                 *, matmul: Optional[str] = None, **overrides):
        self._base = level_or_policy
        self._matmul = matmul
        self._overrides = overrides

    def _build(self) -> PrecisionPolicy:
        base = self._base
        if isinstance(base, PrecisionPolicy):
            p = (dataclasses.replace(base, **self._overrides)
                 if self._overrides else base)
        elif base is None:
            p = dataclasses.replace(current_policy(), **self._overrides)
        else:
            p = PrecisionPolicy.make(base, **self._overrides)
        if self._matmul is not None:
            p = dataclasses.replace(p, matmul_impl=self._matmul)
        return p

    def __enter__(self) -> PrecisionPolicy:
        p = self._build()
        _STATE.policies.append(p)
        return p

    def __exit__(self, *exc):
        _STATE.policies.pop()
        return False


class use:
    """Context manager overriding dispatch per op: ``with use(mean_sq="jnp")``."""

    def __init__(self, **op_impls: str):
        self._m = dict(op_impls)

    def __enter__(self) -> Dict[str, str]:
        _STATE.impls.append(self._m)
        return self._m

    def __exit__(self, *exc):
        _STATE.impls.pop()
        return False


def current_impl(op: str) -> Optional[str]:
    """The innermost ``use()`` override for ``op``, if any."""
    for m in reversed(_STATE.impls):
        if op in m:
            return m[op]
    return None


def captured() -> Callable[[], ContextManager[None]]:
    """The calling thread's active scopes, as a context manager that
    installs them again.  Autograd runs the backward of CUDA tensors on a
    thread of its own, so work that a checkpoint recomputes there must
    re-enter the scopes its forward ran under to resolve the same
    implementations."""
    policies, impls = list(_STATE.policies), list(_STATE.impls)

    @contextlib.contextmanager
    def installed():
        saved = _STATE.policies, _STATE.impls
        _STATE.policies, _STATE.impls = list(policies), list(impls)
        try:
            yield
        finally:
            _STATE.policies, _STATE.impls = saved

    return installed
