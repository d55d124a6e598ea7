"""Write-ahead request journal for crash-safe serving (counterpart of
``repro.serve.journal``; the same file format).

An append-only JSONL log, fsync'd per record, written BEFORE a request is
admitted: a request the engine accepted is on disk before any work runs
on it, so a crash between accept and retire can never lose it.  Records:

  ``{"op": "submit", "uid", "prompt": [ids...], "max_new",
     "deadline_s", "deadline_steps", "t_wall", "step_sub"}``
  ``{"op": "retire", "uid", "status"}``

Recovery contract: on restart, every ``submit`` record whose uid is not
already accounted for by the restored engine snapshot (terminal result,
running row, or queued) is re-admitted in original order.  Greedy
decoding is deterministic, so a replayed request produces the SAME tokens
as the lost run — re-execution is harmless, and a ``retire`` record whose
result died with the process (crash after retire, before the next
snapshot) still ends in a terminal state.  A torn final record (crash
mid-append) is skipped with a warning; everything before it is intact
because each append is fsync'd.

Compaction: the log is truncated when every journaled request has retired
and none is outstanding (clean retirement), and rewritten down to the
still-unaccounted tail after a snapshot durably covers the results —
the journal only ever needs to span "since the last durable point".

Every append, retire, truncate and compaction counts in
``repro_torch.obs.REGISTRY``'s ``serve_journal_events_total{event=...}``,
as in the reference.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from typing import Any, Dict, Iterable, List, Set

import numpy as np

from repro_torch import obs


class JournalWarning(UserWarning):
    """A journal record could not be parsed (torn write) and was skipped."""


class RequestJournal:
    """fsync'd JSONL write-ahead log of submitted requests."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        # original submission order survives restart: dict preserves
        # insertion order and records are appended in submit order
        self._submits: Dict[int, Dict[str, Any]] = {}
        self._retired: Set[int] = set()
        self._recover()
        self._f = open(path, "a", encoding="utf-8")

    def _recover(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, "r", encoding="utf-8") as f:
            raw = f.read()
        for lineno, line in enumerate(raw.splitlines(), 1):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
                op = rec["op"]
                uid = rec["uid"]
            except (json.JSONDecodeError, KeyError, TypeError):
                # torn tail from a crash mid-append; every earlier record
                # was fsync'd whole, so only the last line can be torn
                warnings.warn(
                    f"request journal {self.path}: skipping undecodable "
                    f"record at line {lineno} (torn write)",
                    JournalWarning, stacklevel=3)
                continue
            if op == "submit":
                self._submits[uid] = rec
            elif op == "retire":
                self._retired.add(uid)

    # -- write path --------------------------------------------------------

    def _write(self, rec: Dict[str, Any]) -> None:
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def append(self, req, *, step_sub: int = 0) -> None:
        """Durably record a submission (called BEFORE admission)."""
        rec = {"op": "submit", "uid": int(req.uid),
               "prompt": [int(t) for t in np.asarray(req.prompt)],
               "max_new": int(req.max_new),
               "deadline_s": req.deadline_s,
               "deadline_steps": req.deadline_steps,
               "t_wall": time.time(), "step_sub": int(step_sub)}
        self._write(rec)
        self._submits[rec["uid"]] = rec
        obs.record("record_journal_event", "append")

    def retire(self, uid: int, status: str) -> None:
        """Record a terminal status; truncates the log once every
        journaled request has retired (clean retirement)."""
        uid = int(uid)
        if uid not in self._submits:
            return
        self._write({"op": "retire", "uid": uid, "status": status})
        self._retired.add(uid)
        obs.record("record_journal_event", "retire")
        if self._retired >= set(self._submits):
            self.truncate()

    def truncate(self) -> None:
        """Drop every record (all work is durably accounted for)."""
        self._f.close()
        self._f = open(self.path, "w", encoding="utf-8")
        self._f.flush()
        os.fsync(self._f.fileno())
        self._submits.clear()
        self._retired.clear()
        obs.record("record_journal_event", "truncate")

    def compact(self, covered_uids: Iterable[int]) -> None:
        """Rewrite the log keeping only records for uids NOT in
        ``covered_uids`` (uids a durable snapshot now accounts for)."""
        covered = {int(u) for u in covered_uids}
        keep = [rec for uid, rec in self._submits.items()
                if uid not in covered]
        keep_retired = {uid for uid in self._retired if uid not in covered}
        self._f.close()
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for rec in keep:
                f.write(json.dumps(rec) + "\n")
            for uid in keep_retired:
                f.write(json.dumps({"op": "retire", "uid": uid,
                                    "status": "?"}) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        obs.record("record_journal_event", "compact")
        self._submits = {rec["uid"]: rec for rec in keep}
        self._retired = keep_retired
        self._f = open(self.path, "a", encoding="utf-8")

    # -- read path ---------------------------------------------------------

    def pending(self) -> List[Dict[str, Any]]:
        """Every journaled submit record, in original submission order.
        The engine decides what to replay (anything not accounted for by
        its restored state — including retired records whose results were
        never snapshotted)."""
        return list(self._submits.values())

    def retired_uids(self) -> Set[int]:
        return set(self._retired)

    def close(self) -> None:
        self._f.close()
