"""Scoped profiler annotations, ``obs.enable()`` / ``obs.annotate``
(counterpart of ``repro.obs.profiling``).

The hot paths (the engine's prefill and decode step, the Ozaki matmul)
are wrapped in :func:`annotate`.  Outside an :class:`enable` scope the
wrapper is a ``nullcontext`` (one thread-local list check, nothing
allocated), so the default serving path pays nothing.  Inside the scope
it enters

* :class:`torch.profiler.record_function`, which names the region in a
  ``torch.profiler`` capture (where the reference enters
  ``jax.profiler.TraceAnnotation`` and ``jax.named_scope``); and
* ``torch.cuda.nvtx.range``, where CUDA is available, which names it for
  an NVTX-reading profiler.

The scope is a thread-local stack, like ``ff.policy``: per thread,
re-entrant, innermost wins.  torch is imported only inside an enabled
:func:`annotate`, so the registry and the trace stay importable without
it.
"""

from __future__ import annotations

import contextlib
import threading

__all__ = ["enable", "enabled", "annotate"]


class _ObsState(threading.local):
    def __init__(self):
        self.stack = []


_STATE = _ObsState()


def enabled() -> bool:
    """True inside an ``obs.enable()`` scope (innermost wins)."""
    return bool(_STATE.stack) and _STATE.stack[-1]


class enable:
    """Context manager toggling profiler annotations for the scope.

    ``obs.enable()`` turns annotations on; ``obs.enable(False)`` forces
    them off for an inner region."""

    def __init__(self, on: bool = True):
        self._on = bool(on)

    def __enter__(self) -> bool:
        _STATE.stack.append(self._on)
        return self._on

    def __exit__(self, *exc):
        _STATE.stack.pop()
        return False


def annotate(name: str):
    """``record_function(name)`` (and an NVTX range where CUDA is
    available) when enabled, ``nullcontext`` otherwise."""
    if not enabled():
        return contextlib.nullcontext()
    import torch
    import torch.profiler
    stack = contextlib.ExitStack()
    stack.enter_context(torch.profiler.record_function(name))
    if torch.cuda.is_available():
        stack.enter_context(torch.cuda.nvtx.range(name))
    return stack
