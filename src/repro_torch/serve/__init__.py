"""Continuous-batching serving over a paged KV cache (PyTorch port)."""

from repro_torch.serve.engine import (DEGRADED, FAILED, GUARD_STAT_KEYS, OK,
                                      REJECTED, SNAPSHOT_SCHEMA, STATUSES,
                                      TIMEOUT, GenResult, Request,
                                      ServeEngine, UnsupportedModelError,
                                      resume_engine)
from repro_torch.serve.journal import JournalWarning, RequestJournal
from repro_torch.serve.paged_kv import PagedKVCache, ff_merge, ff_split

__all__ = ["DEGRADED", "FAILED", "GUARD_STAT_KEYS", "JournalWarning", "OK",
           "REJECTED", "RequestJournal", "SNAPSHOT_SCHEMA", "STATUSES",
           "TIMEOUT", "GenResult", "PagedKVCache", "Request", "ServeEngine",
           "UnsupportedModelError", "ff_merge", "ff_split", "resume_engine"]
