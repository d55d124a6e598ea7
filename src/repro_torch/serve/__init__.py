"""Continuous-batching serving over a paged KV cache (PyTorch port)."""

from repro_torch.serve.engine import (FAILED, OK, REJECTED, STATUSES,
                                      GenResult, Request, ServeEngine,
                                      UnsupportedModelError)
from repro_torch.serve.paged_kv import PagedKVCache, ff_merge, ff_split

__all__ = ["FAILED", "OK", "REJECTED", "STATUSES", "GenResult",
           "PagedKVCache", "Request", "ServeEngine", "UnsupportedModelError",
           "ff_merge", "ff_split"]
