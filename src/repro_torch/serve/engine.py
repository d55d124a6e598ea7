"""Continuous-batching serve engine over the paged KV cache (counterpart of
``repro.serve.engine``).

Scheduling model, as in the reference:

  * requests enter a FIFO queue; structurally impossible ones (prompt +
    max_new over ``max_ctx``, a trajectory larger than the pool, a full
    bounded queue) are ``REJECTED`` at submit, never raised;
  * admission runs an exact-length prefill through
    :func:`repro_torch.models.prefill` and moves the prompt's K/V into
    pages.  ``reserve="trajectory"`` (default) reserves the whole
    trajectory's pages there; ``reserve="prompt"`` only the prompt's, and
    each decode step grows a row by at most one page: when the pool runs
    dry the youngest running row is preempted (pages freed, the request
    back at the front of the queue with its deadline; greedy decoding is
    deterministic, so its re-prefill replays the same tokens);
  * one paged decode step advances every running row one token: per-row
    positions and RoPE, a paged write of the new K/V (in ``ff_bf16`` mode
    split into both limb planes), a block-table gather feeding the
    per-row ``decode_attention``, argmax, and both scores
    (``token_logprob`` and the FF ``token_logprob_ff``).  The step's five
    (B,) vectors stay on the device until a flush: ``sync_every=N``
    copies N steps' vectors to the host in one transfer (the next input
    token never leaves the device, so N changes no arithmetic; ``eos_id``
    forces N = 1);
  * at a flush, tokens and scores join their rows in step order; flagged
    rows are quarantined, rows past a deadline retire ``TIMEOUT`` with the
    tokens so far, rows that emitted EOS or reached ``max_new`` retire;
    waiting requests join.  Per-request deadlines are wall-clock
    (``deadline_s``) or decode steps (``deadline_steps``), counted from
    submission; a request that expires while queued retires ``TIMEOUT``
    with no tokens;
  * with ``guard="check"`` or ``"degrade"`` (or an ambient ``ff.guard``
    scope), the decode step also returns a per-row health flag: non-finite
    new K or V in any layer, a non-finite f32 score, or an FF score that
    is non-finite or unnormalized.  A flagged row, or one whose prefill
    score is non-finite, is quarantined: its pages are freed and the whole
    request is retried on the fast f32 tier (``greedy_generate`` under
    :meth:`ServeEngine._fast_policy`), ending ``DEGRADED``, or ``FAILED``
    with its tokens withheld.  The paging metadata is audited
    (:meth:`~repro_torch.serve.paged_kv.PagedKVCache.check_integrity`)
    after every admission round and flush: untrusted rows are
    quarantined and the free list rebuilt.  The statuses are the
    reference's, including its page-0 leak: a row's unused block-table
    entries gather page 0, whose masked positions still reach ``p @ v``
    (``0 * NaN``), so a NaN in page 0 flags every row.

Crash safety, as in the reference: :meth:`ServeEngine.snapshot` freezes
the engine between decode steps (KV planes, paging metadata, running and
queued requests with their tokens, scores and deadlines, results,
counters) as numpy arrays and a JSON meta dict; :meth:`ServeEngine.restore`
rebuilds a fresh engine from them, and the continued run is token for
token (FF scores bit for bit) the uninterrupted one.  ``journal=`` names
an fsync'd write-ahead log of submissions (:mod:`repro_torch.serve.journal`);
:meth:`ServeEngine.save_snapshot` writes through
:mod:`repro_torch.checkpoint` (CRC32, keep-last-3), ``run(snapshot_dir=,
snapshot_every=)`` snapshots on a writer thread, and :func:`resume_engine`
restores the newest generation that verifies and replays the journal.
The snapshot and checkpoint files are the reference's format.

Observability, as in the reference: every engine records into an
:class:`~repro_torch.obs.Observer` (``obs=``, else its own): request
counts per status, tokens emitted, the prefill, decode-step and flush
histograms, tokens/s between flushes, queue depth, active rows and pages
used per scheduler step, snapshots written, and ``guard_stats`` as a view
over ``serve_guard_events_total{kind=...}``; its trace holds one
``request`` span per request with ``queued``, ``prefill`` and ``decode``
children, instants for quarantines, paging rebuilds, preemptions, host
syncs and snapshots, and counter tracks per step.  Inside
``obs.enable()`` the prefill and the decode step are
``torch.profiler`` ranges (``serve.prefill``, ``serve.decode_step``).
``serve_decode_step_seconds`` observes the interval ``decode_s`` records
(a decode step with the flush that follows it), where the reference's
observes the step's asynchronous dispatch alone.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch import resolve_device
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.ff.guard import (FFGuardWarning, GuardCounts, current_guard,
                                  guard_probe, health_mask, report_violation)
from repro_torch.ff.scope import resolve_policy
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, decode_attention,
                                       embed_apply, mlp_apply, rms_norm,
                                       unembed_apply)
from repro_torch.models.model import (cast_params, check_supported,
                                      compute_dtype, init_cache, layer,
                                      prefill)
from repro_torch.serve.journal import RequestJournal
from repro_torch.serve.paged_kv import PagedKVCache, ff_merge, ff_split
from repro_torch.train.serve_step import (greedy_generate, token_logprob,
                                          token_logprob_ff)

Tensor = torch.Tensor

#: engine snapshot schema version (the reference's); restore() refuses
#: any other
SNAPSHOT_SCHEMA = 1

# -- terminal statuses (the reference's names) ------------------------------
OK = "OK"                  # ran to eos/max_new
TIMEOUT = "TIMEOUT"        # deadline expired (queued or mid-decode)
REJECTED = "REJECTED"      # never admitted: bounded queue / impossible size
DEGRADED = "DEGRADED"      # guard quarantined the row; fast-tier retry OK
FAILED = "FAILED"          # no healthy result on any tier
STATUSES = (OK, TIMEOUT, REJECTED, DEGRADED, FAILED)

#: the engine's guard and robustness event categories (one obs counter
#: each; ``guard_stats``, which snapshots carry)
GUARD_STAT_KEYS = ("flagged_rows", "quarantined", "preempted",
                   "integrity_rebuilds", "snapshot_errors")


class UnsupportedModelError(NotImplementedError):
    """A model config outside the engine's supported families."""

    def __init__(self, field: str, value: Any, supported: str):
        self.field = field
        self.value = value
        self.supported = supported
        super().__init__(f"ServeEngine does not support {field}={value!r}; "
                         f"supported: {supported}")


@dataclasses.dataclass
class Request:
    """One generation request.  ``prompt``: 1-D int token ids.

    ``deadline_s`` is a wall-clock budget (seconds from submit),
    ``deadline_steps`` a budget of decode steps from submit; either
    expiring retires the request ``TIMEOUT`` with the tokens so far."""
    uid: int
    prompt: np.ndarray
    max_new: int = 16
    deadline_s: Optional[float] = None
    deadline_steps: Optional[int] = None


@dataclasses.dataclass
class GenResult:
    """Completed generation: tokens, f32 scores, FF limb-pair scores and
    the terminal ``status`` (``detail`` explains every non-``OK`` one)."""
    uid: int
    tokens: np.ndarray            # (n,) int32, n <= max_new
    logprobs: np.ndarray          # (n,) f32 (compensated-LSE scores)
    logprobs_ff: np.ndarray       # (n, 2) f32 — FF (hi, lo) limb pairs
    prompt_len: int = 0
    status: str = OK
    detail: str = ""


def _check_cfg(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise UnsupportedModelError("family", cfg.family,
                                    '"dense" (GQA decoder stack)')
    if cfg.use_mla:
        raise UnsupportedModelError("use_mla", True, "use_mla=False")
    if cfg.moe_num_experts:
        raise UnsupportedModelError("moe_num_experts", cfg.moe_num_experts,
                                    "moe_num_experts=0 (dense FFN)")


def _empty_result(req: Request, status: str, detail: str) -> GenResult:
    return GenResult(uid=req.uid, tokens=np.zeros((0,), np.int32),
                     logprobs=np.zeros((0,), np.float32),
                     logprobs_ff=np.zeros((0, 2), np.float32),
                     prompt_len=int(req.prompt.shape[0]),
                     status=status, detail=detail)


def _request(meta: Dict[str, Any], prompt) -> Request:
    return Request(uid=meta["uid"], prompt=np.asarray(prompt, np.int32),
                   max_new=meta["max_new"],
                   deadline_s=meta.get("deadline_s"),
                   deadline_steps=meta.get("deadline_steps"))


class _GuardStats:
    """``ServeEngine.guard_stats``: the mutable-mapping surface of a dict
    (callers and the chaos tests read and mutate it, ``snapshot`` writes
    it as a plain dict, ``restore`` sets it with ``update``), every count
    stored in the engine's ``serve_guard_events_total{kind=...}``
    counters, so the counts show in metrics exports and a restored
    engine's metrics resume from the snapshot's values."""

    def __init__(self, registry: "obs_mod.MetricsRegistry"):
        self._registry = registry
        self._keys = list(GUARD_STAT_KEYS)
        for k in GUARD_STAT_KEYS:
            self._counter(k)

    def _counter(self, key: str) -> "obs_mod.Counter":
        if key not in self._keys:
            self._keys.append(key)
        return self._registry.counter("serve_guard_events_total", kind=key)

    def __getitem__(self, key: str) -> int:
        return self._counter(key).value

    def __setitem__(self, key: str, value: int) -> None:
        self._counter(key).set(int(value))

    def __contains__(self, key: str) -> bool:
        return key in self._keys

    def __iter__(self):
        return iter(tuple(self._keys))

    def __len__(self) -> int:
        return len(self._keys)

    def keys(self):
        return tuple(self._keys)

    def items(self):
        return [(k, self[k]) for k in self._keys]

    def values(self):
        return [self[k] for k in self._keys]

    def get(self, key: str, default=None):
        return self[key] if key in self._keys else default

    def update(self, other) -> None:
        for k, v in dict(other).items():
            self[k] = v

    def __repr__(self) -> str:
        return repr(dict(self.items()))

    def __eq__(self, other) -> bool:
        return dict(self.items()) == other


class ServeEngine:
    """Continuous-batching greedy decoder with a paged KV cache.

    ``max_batch`` concurrent rows; ``page_size`` tokens per page;
    ``max_ctx`` per-sequence ceiling (prompt + generated); ``num_pages``
    defaults to a full pool; ``eos_id`` enables per-sequence termination;
    ``kv_mode`` "bf16" (default), "f32" or "ff_bf16" (double-bf16 limb
    planes) page storage; ``max_queue`` bounds the wait queue;
    ``reserve`` "trajectory" (default) or "prompt" (lazy growth with
    preemption of the youngest row); ``sync_every`` steps share one
    device->host copy (1 when ``eos_id`` is set); ``guard`` ("off",
    "check" or "degrade"; None inherits the ambient ``ff.guard`` mode at
    construction) switches the per-step health probe, quarantine and the
    paging audit, counted in ``guard_stats``; ``journal`` names a
    write-ahead request log (replayed on attach, see
    :meth:`attach_journal`); ``obs`` an :class:`~repro_torch.obs.Observer`
    to record into (None: the engine's own, ``eng.obs``).  The attention
    impl and the RMSNorm statistic follow the ambient ``ff.policy`` at
    construction.
    ``device=None`` means the CUDA card (raises without one); pass
    ``device="cpu"`` to run on the CPU.  ``params`` must lie on that
    device; the engine keeps one copy of them in the compute dtype.

    ``prefill_s`` records the host time of every prefill (each ends in a
    device sync; the ``prefill`` span and ``serve_prefill_seconds``);
    ``decode_s`` the host time of every decode step, with the flush that
    follows it in the same scheduler iteration (what
    ``serve_decode_step_seconds`` observes)."""

    def __init__(self, params: Dict[str, Any], cfg: ModelConfig, *,
                 max_batch: int = 8, page_size: int = 16,
                 max_ctx: int = 256, num_pages: Optional[int] = None,
                 eos_id: Optional[int] = None, kv_mode: str = "bf16",
                 policy: Optional[PrecisionPolicy] = None,
                 max_queue: Optional[int] = None,
                 reserve: str = "trajectory",
                 guard: Optional[str] = None, sync_every: int = 1,
                 journal: Optional[str] = None, device=None,
                 obs: Optional["obs_mod.Observer"] = None):
        _check_cfg(cfg)
        if reserve not in ("trajectory", "prompt"):
            raise ValueError(f"reserve {reserve!r}: 'trajectory' | 'prompt'")
        if sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        if guard is None:
            guard = current_guard().mode
        if guard not in ("off", "check", "degrade"):
            raise ValueError(f"guard {guard!r}: 'off' | 'check' | 'degrade'")
        self.guard_mode = guard
        self.device = resolve_device(device)
        self.cfg = cfg
        self.policy = resolve_policy(policy)
        check_supported(cfg)
        w_dev = params["final_norm"].device
        if w_dev.type != self.device.type:
            raise ValueError(f"params lie on {w_dev}, the engine runs on "
                             f"{self.device}")
        self.params = params
        self._w = cast_params(params, compute_dtype(cfg))
        self.max_batch = max_batch
        self.eos_id = eos_id
        self.max_queue = max_queue
        self.reserve = reserve
        self.sync_every = 1 if eos_id is not None else int(sync_every)
        pages_per_seq = -(-max_ctx // page_size)
        if num_pages is None:
            num_pages = max_batch * pages_per_seq
        self.kv = PagedKVCache(
            cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim,
            num_pages=num_pages, page_size=page_size, max_seqs=max_batch,
            max_ctx=max_ctx, kv_mode=kv_mode, device=self.device)
        self.queue: List[Dict[str, Any]] = []   # {"req", "t_sub", "step_sub"}
        self.results: Dict[int, GenResult] = {}
        self._slots: List[Optional[Dict[str, Any]]] = [None] * max_batch
        self._last_tok = np.zeros((max_batch,), np.int32)
        self._token_dev = torch.zeros((max_batch,), dtype=torch.long,
                                      device=self.device)
        self._pending: List[Dict[str, Any]] = []   # unsynced decode steps
        self._admit_seq = 0
        self.decode_steps = 0
        # a private registry (engines and tests never share counts) and
        # the request/step trace
        self.obs = obs if obs is not None else obs_mod.Observer()
        self.guard_stats = _GuardStats(self.obs.registry)
        self._req_trace: Dict[int, Dict[str, Any]] = {}
        self._last_flush_ts = self.obs.trace.now()
        self._auditing = False
        self.journal: Optional[RequestJournal] = None
        self._snap_cover: Optional[set] = None   # uids of the last async save
        self.prefill_s: List[float] = []
        self.decode_s: List[float] = []
        if journal is not None:
            self.attach_journal(journal)

    # -- the paged decode step ---------------------------------------------

    def _decode(self, lens: np.ndarray, active: np.ndarray):
        """One token for every row.  lens: (B,) tokens already cached per
        row; active: (B,) bool.  Returns (next greedy token, its f32 score,
        its FF score hi and lo, the guard flag), each (B,) on the device;
        the flag is all False with the guard off.  Per active row the math
        is the dense decode body at that row's position."""
        cfg, policy, kv, w = self.cfg, self.policy, self.kv, self._w
        dev, dt = self.device, compute_dtype(cfg)
        B = self.max_batch
        H, KVh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        ps, npg, NP = kv.page_size, kv.max_pages, kv.num_pages
        ff_pages = kv.kv_mode == "ff_bf16"
        probe = self.guard_mode != "off"
        rows = np.nonzero(active)[0]
        # the page/offset every active row writes its new K/V to.  Inactive
        # rows write nothing, and neither does a row whose page id lies
        # outside the pool (a corrupt block table, which the guard's audit
        # repairs): the reference scatters both to a dropped page
        # (``mode="drop"``, after numpy's wrap of a negative id)
        wp = kv.block_table[rows, lens[rows] // ps].astype(np.int64)
        wp = np.where(wp < 0, wp + NP, wp)
        keep = (wp >= 0) & (wp < NP)
        rows = rows[keep]
        wpage = torch.as_tensor(wp[keep], dtype=torch.long, device=dev)
        woff = torch.as_tensor(lens[rows] % ps, dtype=torch.long, device=dev)
        rows_t = torch.as_tensor(rows, dtype=torch.long, device=dev)
        # gather table: a row's unused entries (-1) read page 0, masked by
        # lens; an id outside the pool clamps into it, as the reference's
        # gather does
        gidx = torch.as_tensor(np.clip(kv.block_table, 0, NP - 1),
                               dtype=torch.long, device=dev)
        lens_t = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        posv = lens_t[:, None]
        bad = torch.zeros((B,), dtype=torch.bool, device=dev)

        h = embed_apply(w["embed"], self._token_dev[:, None], dt)
        for i in range(cfg.num_layers):
            lp = layer(w["layers"], i)
            ap = lp["attn"]
            z = rms_norm(h, lp["ln1"], cfg.norm_eps,
                         ff_stats=policy.ff_reductions)
            q = (z @ ap["wq"]).reshape(B, 1, H, hd)
            k = (z @ ap["wk"]).reshape(B, 1, KVh, hd)
            v = (z @ ap["wv"]).reshape(B, 1, KVh, hd)
            q = apply_rope(q, posv, cfg.rope_theta)
            k = apply_rope(k, posv, cfg.rope_theta)
            if probe:
                # non-finite new K/V in this layer poisons the row's cache
                # for every later step: flag it at the source
                for new in (k, v):
                    bad |= ~torch.isfinite(new.float()).flatten(1).all(1)
            gathered = {}
            for base, new in (("k", k), ("v", v)):
                if ff_pages:
                    phi = kv.planes[f"{base}_hi"][i]     # (NP, ps, KV, hd)
                    plo = kv.planes[f"{base}_lo"][i]
                    hi, lo = ff_split(new[rows_t, 0])
                    phi[wpage, woff] = hi
                    plo[wpage, woff] = lo
                    merged = ff_merge(phi[gidx], plo[gidx])
                else:
                    plane = kv.planes[base][i]           # (NP, ps, KV, hd)
                    plane[wpage, woff] = new[rows_t, 0].to(plane.dtype)
                    merged = plane[gidx]
                gathered[base] = merged.reshape(B, npg * ps, KVh, hd)
            o = decode_attention(q, gathered["k"], gathered["v"], lens_t + 1,
                                 impl=policy.attention)
            h = h + (o.reshape(B, 1, H * hd) @ ap["wo"])
            z = rms_norm(h, lp["ln2"], cfg.norm_eps,
                         ff_stats=policy.ff_reductions)
            h = h + mlp_apply(lp["ffn"], z, ff_math=policy.ff_math)
        x = rms_norm(h, w["final_norm"], cfg.norm_eps,
                     ff_stats=policy.ff_reductions)
        logits = unembed_apply(w["embed"], x, cfg,
                               ff_math=policy.ff_math)[:, 0]
        nxt = torch.argmax(logits, -1)
        lp = token_logprob(logits, nxt, policy)
        lp_ff = token_logprob_ff(logits, nxt)
        if probe:
            # score health: a non-finite f32 score, or an FF score pair
            # that is non-finite or unnormalized
            bad |= ~torch.isfinite(lp) | ~health_mask(lp_ff)
        return nxt, lp, lp_ff.hi, lp_ff.lo, bad

    # -- request lifecycle -------------------------------------------------

    def _trace_submit(self, uid: int) -> None:
        """Open a request's span timeline (once per uid: a preempted
        request keeps its submission time)."""
        if uid not in self._req_trace:
            self._req_trace[uid] = {"submit": self.obs.trace.now(),
                                    "admit": None}
            self.obs.trace.name_request_track(uid)

    def _set_result(self, res: GenResult) -> None:
        """The one sink of terminal results: records ``res``, closes its
        ``decode`` (admission to retirement, when it ran) and ``request``
        (submission to retirement, with the status) spans, counts it and
        its tokens, and, with a journal attached, durably marks the uid
        retired."""
        self.results[res.uid] = res
        tr = self._req_trace.pop(res.uid, None)
        if tr is not None:
            now = self.obs.trace.now()
            tid = self.obs.trace.request_tid(res.uid)
            if tr["admit"] is not None:
                self.obs.trace.complete("decode", tr["admit"],
                                        now - tr["admit"], tid=tid)
            self.obs.trace.complete(
                "request", tr["submit"], now - tr["submit"], tid=tid,
                args={"status": res.status, "uid": int(res.uid),
                      "tokens": int(res.tokens.shape[0]),
                      "detail": res.detail})
            self.obs.registry.counter("serve_requests_total",
                                      status=res.status).inc()
            self.obs.registry.counter("serve_tokens_emitted_total").inc(
                int(res.tokens.shape[0]))
        if self.journal is not None:
            self.journal.retire(res.uid, res.status)

    def submit(self, req: Request) -> str:
        """Enqueue a request.  Returns ``"QUEUED"``, or records a
        ``REJECTED`` result and returns it when the request can never be
        served — submission never raises.  With a journal attached the
        request is journaled (fsync'd) before admission."""
        if self.journal is not None:
            self.journal.append(req, step_sub=self.decode_steps)
        return self._submit(req, t_sub=time.monotonic(),
                            step_sub=self.decode_steps, bounded=True)

    def _submit(self, req: Request, *, t_sub: float, step_sub: int,
                bounded: bool) -> str:
        """The admission checks and the enqueue.  ``bounded=False``
        (journal replay) skips the queue bound: the request was accepted
        once; structural impossibility still rejects."""
        self._trace_submit(req.uid)
        S = int(req.prompt.shape[0])
        total = S + req.max_new
        max_ctx = self.kv.max_pages * self.kv.page_size
        detail = None
        if total > max_ctx:
            detail = f"prompt+max_new = {total} exceeds max_ctx = {max_ctx}"
        elif self.kv.pages_for(total) > self.kv.num_pages:
            detail = (f"trajectory needs {self.kv.pages_for(total)} pages; "
                      f"pool has {self.kv.num_pages}")
        elif bounded and self.max_queue is not None \
                and len(self.queue) >= self.max_queue:
            detail = f"wait queue full (max_queue = {self.max_queue})"
        if detail is not None:
            self._set_result(_empty_result(req, REJECTED, detail))
            return REJECTED
        self.queue.append({"req": req, "t_sub": t_sub, "step_sub": step_sub})
        return "QUEUED"

    def status(self, uid: int) -> str:
        """A submitted uid's status: a terminal one from :data:`STATUSES`,
        else ``"RUNNING"`` or ``"QUEUED"``."""
        if uid in self.results:
            return self.results[uid].status
        if any(s is not None and s["req"].uid == uid for s in self._slots):
            return "RUNNING"
        if any(q["req"].uid == uid for q in self.queue):
            return "QUEUED"
        raise KeyError(f"unknown request uid {uid}")

    def _deadline_passed(self, req: Request, t_sub: float,
                         step_sub: int) -> bool:
        if req.deadline_s is not None and \
                time.monotonic() - t_sub > req.deadline_s:
            return True
        return req.deadline_steps is not None and \
            self.decode_steps - step_sub >= req.deadline_steps

    def _expire_queue(self) -> None:
        kept = []
        for q in self.queue:
            if self._deadline_passed(q["req"], q["t_sub"], q["step_sub"]):
                self._set_result(_empty_result(
                    q["req"], TIMEOUT, "deadline expired while queued"))
            else:
                kept.append(q)
        self.queue = kept

    def _admit(self) -> None:
        """Join waiting requests into free rows while pages allow (FIFO).
        Under a guard, a non-finite prefill score quarantines the row, and
        an admission round ends with the paging audit."""
        admitted = False
        while self.queue:
            q = self.queue[0]
            req = q["req"]
            S = int(req.prompt.shape[0])
            total = S + req.max_new
            slot = next((i for i, s in enumerate(self._slots) if s is None),
                        None)
            need = total if self.reserve == "trajectory" else S
            if slot is None or not self.kv.can_alloc(need):
                break
            self.queue.pop(0)
            tr = self._req_trace.get(req.uid)
            ts_adm = self.obs.trace.now()
            tid = self.obs.trace.request_tid(req.uid)
            if tr is not None:
                self.obs.trace.complete("queued", tr["submit"],
                                        ts_adm - tr["submit"], tid=tid)
            if self.reserve == "trajectory":
                self.kv.alloc(slot, total)  # reserve the whole trajectory
                self.kv.seq_lens[slot] = S  # ...but only S tokens are live
            else:
                self.kv.alloc(slot, S)      # lazy: grow() per decode step
            # the prefill cache dtype is the page fidelity: bf16 pages take
            # bf16 K/V; the f32 and ff_bf16 pages the full f32 K/V
            cache_dt = torch.bfloat16 if self.kv.kv_mode == "bf16" \
                else torch.float32
            cache = init_cache(self.cfg, 1, S, dtype=cache_dt,
                               device=self.device)
            tokens = torch.as_tensor(np.asarray(req.prompt)[None],
                                     dtype=torch.long, device=self.device)
            with obs_mod.annotate("serve.prefill"):
                logits, cache = prefill(self._w, {"tokens": tokens},
                                        self.cfg, cache, self.policy)
                self.kv.write_prefill(slot, {
                    "k": cache["layers"]["k"][:, 0],
                    "v": cache["layers"]["v"][:, 0]})
                tok_t = torch.argmax(logits, -1)
                ff_lp = token_logprob_ff(logits, tok_t)
                scores = torch.stack([
                    token_logprob(logits, tok_t, self.policy), ff_lp.hi,
                    ff_lp.lo]).cpu().numpy()[:, 0]
            tok = int(tok_t[0])
            ts_pf = self.obs.trace.now()
            self.obs.trace.complete("prefill", ts_adm, ts_pf - ts_adm,
                                    tid=tid, args={"prompt_len": S})
            self.prefill_s.append((ts_pf - ts_adm) / 1e6)
            self.obs.registry.histogram("serve_prefill_seconds").observe(
                self.prefill_s[-1])
            if tr is not None:
                tr["admit"] = ts_pf
            state = {"req": req, "prompt_len": S, "tokens": [tok],
                     "logprobs": [float(scores[0])],
                     "logprobs_ff": [(float(scores[1]), float(scores[2]))],
                     "pending": 0, "start_step": self.decode_steps,
                     "t_sub": q["t_sub"], "step_sub": q["step_sub"],
                     "admit_seq": self._admit_seq}
            self._admit_seq += 1
            self._slots[slot] = state
            self._last_tok[slot] = tok
            # out of place: the old tensor may be a pending step's output
            self._token_dev = self._token_dev.index_fill(
                0, torch.tensor([slot], device=self.device), tok)
            admitted = True
            if self.guard_mode != "off" and not (
                    np.isfinite(scores[0]) and np.isfinite(scores[1])):
                self._quarantine(slot, "non-finite prefill score")
            elif self._finished(state):
                self._retire(slot)
        if admitted and self.guard_mode != "off":
            self._audit_paging()

    def _finished(self, state: Dict[str, Any]) -> bool:
        if len(state["tokens"]) >= state["req"].max_new:
            return True
        return self.eos_id is not None and state["tokens"][-1] == self.eos_id

    def _clear_slot(self, slot: int) -> None:
        self._slots[slot] = None
        self._last_tok[slot] = 0

    def _retire(self, slot: int, status: str = OK, detail: str = "") -> None:
        state = self._slots[slot]
        self._set_result(GenResult(
            uid=state["req"].uid,
            tokens=np.asarray(state["tokens"], np.int32),
            logprobs=np.asarray(state["logprobs"], np.float32),
            logprobs_ff=np.asarray(state["logprobs_ff"],
                                   np.float32).reshape(-1, 2),
            prompt_len=state["prompt_len"], status=status, detail=detail))
        self.kv.free_slot(slot)
        self._clear_slot(slot)

    # -- the guard ----------------------------------------------------------

    def _fast_policy(self) -> PrecisionPolicy:
        """One accuracy class below the serving policy: fast f32 attention
        and the f32 builtin transcendentals."""
        return dataclasses.replace(self.policy, attention="fast",
                                   ff_math=False)

    def _quarantine(self, slot: int, why: str,
                    trust_pages: bool = True) -> None:
        """Evict a poisoned row and retry the whole request on the fast
        tier (greedy decoding is deterministic, so the retry is the
        request's fast-class answer).  A healthy retry ends ``DEGRADED``;
        one that scores non-finite, or raises, ends ``FAILED`` with its
        tokens withheld.  ``trust_pages=False`` drops the row's page ids
        instead of freeing them (the caller rebuilds the free list)."""
        state = self._slots[slot]
        req = state["req"]
        if trust_pages:
            self.kv.free_slot(slot)
        else:
            self.kv.drop_slot(slot)
        self._clear_slot(slot)
        self.guard_stats["quarantined"] += 1
        self.obs.trace.instant("quarantine",
                               args={"uid": int(req.uid), "why": why})
        report_violation("serve.decode", "nonfinite")
        prompt = torch.as_tensor(np.asarray(req.prompt)[None],
                                 dtype=torch.long, device=self.device)
        try:
            toks, lps = greedy_generate(
                self._w, self.cfg, prompt, req.max_new,
                cache_len=state["prompt_len"] + req.max_new,
                policy=self._fast_policy(), return_logprobs=True,
                eos_id=self.eos_id)
        except Exception as e:   # a retry never takes the engine down
            self._set_result(_empty_result(
                req, FAILED, f"guard: {why}; fast-tier retry raised "
                f"{type(e).__name__}: {e}"))
            return
        toks = toks[0].cpu().numpy().astype(np.int32)
        lps = lps[0].to(torch.float32).cpu().numpy()
        if not np.all(np.isfinite(lps)):
            self._set_result(_empty_result(
                req, FAILED, f"guard: {why}; fast-tier retry still "
                f"non-finite"))
            return
        self._set_result(GenResult(
            uid=req.uid, tokens=toks, logprobs=lps,
            logprobs_ff=np.stack([lps, np.zeros_like(lps)], axis=1),
            prompt_len=state["prompt_len"], status=DEGRADED,
            detail=f"guard: {why}; retried on the fast tier"))

    def _audit_paging(self) -> None:
        """The guard's audit of the paging metadata: sync the pending
        steps, quarantine every row with an untrusted page list, then
        rebuild the free list."""
        if self._auditing:
            return
        self._auditing = True
        try:
            problems, bad = self.kv.check_integrity()
            if not problems:
                return
            warnings.warn("ServeEngine: paging metadata corrupt — "
                          + "; ".join(problems[:4])
                          + (f" (+{len(problems) - 4} more)"
                             if len(problems) > 4 else ""),
                          FFGuardWarning, stacklevel=2)
            report_violation("serve.paging", "nonfinite", len(problems))
            self._flush()
            for slot in sorted(bad):
                if self._slots[slot] is not None:
                    self._quarantine(slot, "corrupt block table",
                                     trust_pages=False)
                else:
                    self.kv.drop_slot(slot)
            self.kv.rebuild_free_list()
            self.guard_stats["integrity_rebuilds"] += 1
            self.obs.trace.instant("integrity_rebuild",
                                   args={"problems": len(problems)})
        finally:
            self._auditing = False

    def probe_kv(self) -> GuardCounts:
        """One :class:`~repro_torch.ff.guard.GuardCounts` over the whole
        K and V pools (each plane read as f32 (hi, 0) pairs; ``ff_bf16``
        limbs merged first), through ``guard_probe`` as resolved
        (``ff.use(guard_probe="pallas")``: the ``guard_flags`` kernel).  A
        debug and chaos hook: the per-step probe sees only the new K/V."""
        tot = [0, 0, 0]
        for base in ("k", "v"):
            if self.kv.kv_mode == "ff_bf16":
                plane = ff_merge(self.kv.planes[f"{base}_hi"],
                                 self.kv.planes[f"{base}_lo"])
            else:
                plane = self.kv.planes[base].to(torch.float32)
            c = guard_probe(plane)
            tot = [t + int(n) for t, n in zip(tot, c)]
        return GuardCounts(*(torch.tensor(t, dtype=torch.int32)
                             for t in tot))

    # -- decode -------------------------------------------------------------

    def _row_len(self, state: Dict[str, Any]) -> int:
        """Tokens already cached for a row: prompt + emitted (unsynced
        pending steps included) - 1 (the latest token is the step's input;
        the step writes its K/V)."""
        return state["prompt_len"] + len(state["tokens"]) \
            + state["pending"] - 1

    def _preempt(self, slot: int) -> None:
        """Preempt a running row: its pages back to the free list, the
        request back to the front of the queue with its submission time
        and step (its deadline stands)."""
        state = self._slots[slot]
        self.kv.free_slot(slot)
        self._clear_slot(slot)
        self.guard_stats["preempted"] += 1
        uid = int(state["req"].uid)
        self.obs.trace.instant("preempt", args={"uid": uid})
        tr = self._req_trace.get(uid)
        if tr is not None:
            tr["admit"] = None          # decode restarts at re-admission
        self.queue.insert(0, {"req": state["req"], "t_sub": state["t_sub"],
                              "step_sub": state["step_sub"]})

    def _ensure_growth(self) -> bool:
        """``reserve="prompt"``: give every running row a page for the K/V
        it writes this step, oldest first, preempting the youngest row
        while the pool is dry.  Returns False when no row is left."""
        if self.reserve == "trajectory":
            return any(s is not None for s in self._slots)
        order = sorted((i for i, s in enumerate(self._slots)
                        if s is not None),
                       key=lambda i: self._slots[i]["admit_seq"])
        for slot in order:
            if self._slots[slot] is None:   # preempted by an older row
                continue
            target = self._row_len(self._slots[slot]) + 1
            while True:
                if self.kv.pages_for(target) <= self.kv.pages_for(
                        int(self.kv.seq_lens[slot])) or self.kv.free_pages:
                    self.kv.grow(slot, target)
                    break
                # the pool is dry: sync pending work, then preempt
                self._flush()
                if self._slots[slot] is None:   # the flush retired it
                    break
                running = [i for i, s in enumerate(self._slots)
                           if s is not None]
                if len(running) == 1:
                    # nobody to take pages from: the pool cannot hold even
                    # one trajectory; terminal, not a livelock
                    self._retire(slot, FAILED,
                                 "page pool too small for one trajectory")
                    break
                victim = max(running,
                             key=lambda i: self._slots[i]["admit_seq"])
                self._preempt(victim)
                if victim == slot:
                    break
        return any(s is not None for s in self._slots)

    def _step_decode(self) -> None:
        """Launch one decode step of every running row; its outputs wait
        on the device in ``_pending`` until a flush."""
        if not self._ensure_growth():
            return
        active = np.asarray([s is not None for s in self._slots])
        lens = np.asarray([self._row_len(s) if s else 0
                           for s in self._slots], np.int32)
        with obs_mod.annotate("serve.decode_step"):
            nxt, lp, lph, lpl, bad = self._decode(lens, active)
        self._token_dev = nxt
        self._pending.append({"step": self.decode_steps, "nxt": nxt,
                              "lp": lp, "lph": lph, "lpl": lpl, "bad": bad})
        self.decode_steps += 1
        for slot, state in enumerate(self._slots):
            if state is None:
                continue
            state["pending"] += 1
            # the step wrote this row's K/V at position lens[slot] (under
            # reserve="prompt" grow() already moved seq_lens)
            self.kv.seq_lens[slot] = int(lens[slot]) + 1

    def _flush(self) -> None:
        """Copy every pending step's five (B,) vectors to the host in one
        transfer, append tokens and scores in step order, then apply the
        guard, deadline and finish transitions."""
        if not self._pending:
            return
        entries, self._pending = self._pending, []
        i32 = torch.int32
        t0 = self.obs.trace.now()
        host = torch.stack([torch.stack([
            e["nxt"].to(i32), e["lp"].to(torch.float32).view(i32),
            e["lph"].view(i32), e["lpl"].view(i32), e["bad"].to(i32)])
            for e in entries]).cpu().numpy()          # (steps, 5, B)
        t1 = self.obs.trace.now()
        self.obs.trace.instant("host_sync", args={"steps": len(entries)})
        self.obs.registry.histogram("serve_flush_seconds").observe(
            (t1 - t0) / 1e6)
        scores = host[:, 1:4].view(np.float32)
        n_synced = 0
        flagged = set()
        for n, e in enumerate(entries):
            for slot, state in enumerate(self._slots):
                if state is None or state["pending"] == 0:
                    continue
                if state["start_step"] > e["step"]:
                    continue            # admitted after this step ran
                tok = int(host[n, 0, slot])
                state["tokens"].append(tok)
                state["logprobs"].append(float(scores[n, 0, slot]))
                state["logprobs_ff"].append((float(scores[n, 1, slot]),
                                             float(scores[n, 2, slot])))
                state["pending"] -= 1
                n_synced += 1
                self._last_tok[slot] = tok
                if host[n, 4, slot]:
                    flagged.add(slot)
        # tokens made host-visible per second between consecutive syncs
        if n_synced and t1 > self._last_flush_ts:
            self.obs.registry.histogram("serve_tokens_per_s").observe(
                n_synced / ((t1 - self._last_flush_ts) / 1e6))
        self._last_flush_ts = t1
        if flagged:
            self.guard_stats["flagged_rows"] += len(flagged)
        for slot in flagged:
            if self._slots[slot] is not None:
                self._quarantine(slot, "per-step probe flagged the row")
        for slot, state in enumerate(self._slots):
            if state is None:
                continue
            if self._deadline_passed(state["req"], state["t_sub"],
                                     state["step_sub"]):
                self._retire(slot, TIMEOUT, "deadline expired mid-decode "
                             f"(kept {len(state['tokens'])} tokens)")
            elif self._finished(state):
                self._retire(slot)
        if self.guard_mode != "off":
            self._audit_paging()

    def _must_flush(self) -> bool:
        if not self._pending:
            return False
        if len(self._pending) >= self.sync_every:
            return True
        for state in self._slots:
            if state is None:
                continue
            req = state["req"]
            if len(state["tokens"]) + state["pending"] >= req.max_new:
                return True
            if (req.deadline_s is not None
                    or req.deadline_steps is not None) and \
                    self._deadline_passed(req, state["t_sub"],
                                          state["step_sub"]):
                return True
        return bool(self.queue) and any(s is None for s in self._slots)

    def step(self) -> bool:
        """One scheduler iteration: expire queued deadlines, admit, launch
        one decode step of every running row, flush when due and admit
        again.  Returns True while work remains.  Never raises for
        off-nominal scheduling: every request ends with a status from
        :data:`STATUSES`."""
        self._expire_queue()
        self._admit()
        if any(s is not None for s in self._slots):
            t0 = time.perf_counter()
            n = self.decode_steps
            self._step_decode()
            if self._must_flush():
                self._flush()
            if self.decode_steps > n:
                self.decode_s.append(time.perf_counter() - t0)
                self.obs.registry.histogram(
                    "serve_decode_step_seconds").observe(self.decode_s[-1])
            self._admit()
        elif self.queue:
            self._flush()
            if not any(s is not None for s in self._slots) and self.queue:
                # empty engine and the head still cannot be admitted
                # (pages leaked or the pool too small): terminal
                q = self.queue.pop(0)
                self._set_result(_empty_result(
                    q["req"], FAILED, "unschedulable: no running rows and "
                    "the head request cannot be admitted"))
        elif self._pending:
            self._flush()
        self._trace_step_counters()
        return (any(s is not None for s in self._slots)
                or bool(self.queue) or bool(self._pending))

    def _trace_step_counters(self) -> None:
        """Per-scheduler-step samples of the queue depth, the active rows
        and the pool's occupancy: registry gauges and Perfetto counter
        tracks."""
        depth = len(self.queue)
        active = sum(1 for s in self._slots if s is not None)
        free = len(self.kv.free_pages)
        used = self.kv.num_pages - free
        self.obs.registry.gauge("serve_queue_depth").set(depth)
        self.obs.registry.gauge("serve_active_rows").set(active)
        self.obs.registry.gauge("serve_pages_used").set(used)
        self.obs.trace.counter("queue", {"depth": depth, "active": active})
        self.obs.trace.counter("pages", {"used": used, "free": free})

    def run(self, *, snapshot_dir: Optional[str] = None,
            snapshot_every: Optional[int] = None) -> Dict[int, GenResult]:
        """Drain the queue; every submitted uid ends with a terminal
        status.

        With ``snapshot_dir`` and ``snapshot_every``, the engine snapshots
        every N decode steps through an
        :class:`~repro_torch.checkpoint.AsyncCheckpointer` (the write
        overlaps decoding) and polls it each iteration: a failed write
        warns (:class:`FFGuardWarning`) and counts in
        ``guard_stats["snapshot_errors"]``, and serving goes on.  A last
        synchronous snapshot lands when the queue is drained."""
        ckpt = None
        last_snap = self.decode_steps
        if snapshot_dir is not None and snapshot_every:
            ckpt = ckpt_lib.AsyncCheckpointer(snapshot_dir)
        while self.step():
            if ckpt is None:
                continue
            self._poll_snapshot(ckpt)
            if self.decode_steps - last_snap >= snapshot_every:
                try:
                    arrays, meta = self.snapshot()
                    ckpt.save(self.decode_steps, arrays, extra=meta)
                    self._snap_cover = set(self.results)
                    self.obs.trace.instant(
                        "snapshot", args={"step": self.decode_steps,
                                          "mode": "async"})
                except Exception as e:
                    self._snapshot_error(e)
                last_snap = self.decode_steps
        self._flush()
        if ckpt is not None:
            try:
                ckpt.wait()
            except Exception as e:
                self._snapshot_error(e)
            self._snap_cover = None
            try:
                self.save_snapshot(snapshot_dir)
            except Exception as e:
                self._snapshot_error(e)
        return self.results

    # -- crash safety: snapshot, restore, journal ----------------------------

    def _fingerprint(self) -> Dict[str, Any]:
        """The construction knobs a snapshot is valid under (the
        reference's keys and values).  Weights and config are not
        snapshotted: the caller passes the same ones, and the policy's
        repr and the config's name are compared."""
        return {"kv_mode": self.kv.kv_mode, "max_batch": self.max_batch,
                "page_size": self.kv.page_size,
                "max_ctx": self.kv.max_pages * self.kv.page_size,
                "num_pages": self.kv.num_pages, "eos_id": self.eos_id,
                "reserve": self.reserve, "sync_every": self.sync_every,
                "guard": self.guard_mode, "max_queue": self.max_queue,
                "policy_repr": repr(self.policy),
                "cfg_name": self.cfg.name}

    def snapshot(self):
        """Freeze the engine between decode steps (pending steps are
        synced first).  Returns ``(arrays, meta)``: a flat ``{name:
        np.ndarray}`` dict (the KV cache's :meth:`PagedKVCache.to_state`
        under ``kv.``, the rows' and queue's prompts, the rows' tokens and
        scores, the results) and a JSON-able dict (schema, wall time,
        counters, per-request deadlines as elapsed seconds)."""
        self._flush()
        arrays: Dict[str, np.ndarray] = {
            f"kv.{k}": v for k, v in self.kv.to_state().items()}
        arrays["last_tok"] = self._last_tok.copy()
        now_m, now_w = time.monotonic(), time.time()

        def req_meta(req, step_sub, t_sub):
            return {"uid": int(req.uid), "max_new": int(req.max_new),
                    "deadline_s": req.deadline_s,
                    "deadline_steps": req.deadline_steps,
                    "step_sub": int(step_sub),
                    "elapsed_s": float(now_m - t_sub)}

        slots_meta: List[Optional[Dict[str, Any]]] = []
        for i, s in enumerate(self._slots):
            if s is None:
                slots_meta.append(None)
                continue
            req = s["req"]
            arrays[f"slot.{i}.prompt"] = np.asarray(req.prompt, np.int32)
            arrays[f"slot.{i}.tokens"] = np.asarray(s["tokens"], np.int32)
            arrays[f"slot.{i}.logprobs"] = np.asarray(s["logprobs"],
                                                      np.float32)
            arrays[f"slot.{i}.logprobs_ff"] = np.asarray(
                s["logprobs_ff"], np.float32).reshape(-1, 2)
            slots_meta.append({
                **req_meta(req, s["step_sub"], s["t_sub"]),
                "prompt_len": int(s["prompt_len"]),
                "start_step": int(s["start_step"]),
                "admit_seq": int(s["admit_seq"])})
        queue_meta = []
        for j, q in enumerate(self.queue):
            arrays[f"queue.{j}.prompt"] = np.asarray(q["req"].prompt,
                                                     np.int32)
            queue_meta.append(req_meta(q["req"], q["step_sub"], q["t_sub"]))
        results_meta = []
        for uid, r in self.results.items():
            arrays[f"result.{uid}.tokens"] = np.asarray(r.tokens, np.int32)
            arrays[f"result.{uid}.logprobs"] = np.asarray(r.logprobs,
                                                          np.float32)
            arrays[f"result.{uid}.logprobs_ff"] = np.asarray(
                r.logprobs_ff, np.float32).reshape(-1, 2)
            results_meta.append({"uid": int(uid), "status": r.status,
                                 "detail": r.detail,
                                 "prompt_len": int(r.prompt_len)})
        meta = {"schema": SNAPSHOT_SCHEMA, "wall_time": now_w,
                "decode_steps": int(self.decode_steps),
                "admit_seq": int(self._admit_seq),
                "guard_stats": {k: int(v)
                                for k, v in self.guard_stats.items()},
                "engine": self._fingerprint(),
                "slots": slots_meta, "queue": queue_meta,
                "results": results_meta}
        return arrays, meta

    def restore(self, arrays: Dict[str, Any], meta: Dict[str, Any], *,
                downtime_s: Optional[float] = None) -> None:
        """Rebuild a freshly constructed engine from :meth:`snapshot`
        output (the port's or the reference's).  A snapshot schema or an
        engine fingerprint (kv_mode, geometry, policy, ...) other than
        this engine's raises ``ValueError``.

        Deadlines: each request's elapsed time is stored at the snapshot;
        ``downtime_s`` (default: the wall time since the snapshot) is
        added, so a ``deadline_s`` that expired while the process was
        down retires ``TIMEOUT`` here, with the tokens so far.
        ``deadline_steps`` count decode steps and ignore downtime."""
        if not isinstance(meta, dict) or meta.get("schema") != \
                SNAPSHOT_SCHEMA:
            got = meta.get("schema") if isinstance(meta, dict) else None
            raise ValueError(f"engine snapshot schema {got!r} != "
                             f"supported {SNAPSHOT_SCHEMA}")
        mine, theirs = self._fingerprint(), meta["engine"]
        for k in sorted(set(mine) | set(theirs)):
            if mine.get(k) != theirs.get(k):
                raise ValueError(
                    f"snapshot/engine mismatch: snapshot has "
                    f"{k}={theirs.get(k)!r}, this engine has "
                    f"{mine.get(k)!r}")
        if (self.queue or self._pending or self.results
                or any(s is not None for s in self._slots)):
            raise RuntimeError("restore() requires a freshly constructed "
                               "engine (no queued/running/completed work)")
        self.kv = PagedKVCache.from_state(
            {k[len("kv."):]: v for k, v in arrays.items()
             if k.startswith("kv.")}, device=self.device)
        self.decode_steps = int(meta["decode_steps"])
        self._admit_seq = int(meta["admit_seq"])
        self.guard_stats.update(meta["guard_stats"])
        now_m, now_w = time.monotonic(), time.time()
        if downtime_s is None:
            downtime_s = max(0.0, now_w - float(meta["wall_time"]))
        self._last_tok = np.asarray(arrays["last_tok"], np.int32).copy()
        self._token_dev = torch.as_tensor(self._last_tok, dtype=torch.long,
                                          device=self.device)
        for i, sm in enumerate(meta["slots"]):
            if sm is None:
                continue
            lf = np.asarray(arrays[f"slot.{i}.logprobs_ff"],
                            np.float32).reshape(-1, 2)
            self._slots[i] = {
                "req": _request(sm, arrays[f"slot.{i}.prompt"]),
                "prompt_len": sm["prompt_len"],
                "tokens": [int(t) for t in arrays[f"slot.{i}.tokens"]],
                "logprobs": [float(x)
                             for x in arrays[f"slot.{i}.logprobs"]],
                "logprobs_ff": [(float(h), float(lo)) for h, lo in lf],
                "pending": 0, "start_step": sm["start_step"],
                "t_sub": now_m - (sm["elapsed_s"] + downtime_s),
                "step_sub": sm["step_sub"], "admit_seq": sm["admit_seq"]}
            # reopen the request's timeline (the spans before the crash
            # belong to the lost process's trace)
            self._trace_submit(sm["uid"])
            self._req_trace[sm["uid"]]["admit"] = self.obs.trace.now()
        self.queue = [
            {"req": _request(qm, arrays[f"queue.{j}.prompt"]),
             "t_sub": now_m - (qm["elapsed_s"] + downtime_s),
             "step_sub": qm["step_sub"]}
            for j, qm in enumerate(meta["queue"])]
        for qm in meta["queue"]:
            self._trace_submit(qm["uid"])
        for rm in meta["results"]:
            uid = rm["uid"]
            self.results[uid] = GenResult(
                uid=uid,
                tokens=np.asarray(arrays[f"result.{uid}.tokens"], np.int32),
                logprobs=np.asarray(arrays[f"result.{uid}.logprobs"],
                                    np.float32),
                logprobs_ff=np.asarray(arrays[f"result.{uid}.logprobs_ff"],
                                       np.float32).reshape(-1, 2),
                prompt_len=rm["prompt_len"], status=rm["status"],
                detail=rm["detail"])
        # wall-clock deadlines that expired during the downtime retire
        # now, with the tokens so far: never silently revived
        self._expire_queue()
        for slot, state in enumerate(self._slots):
            if state is not None and self._deadline_passed(
                    state["req"], state["t_sub"], state["step_sub"]):
                self._retire(slot, TIMEOUT,
                             "deadline expired across restart downtime "
                             f"(kept {len(state['tokens'])} tokens)")

    def save_snapshot(self, directory: str) -> str:
        """:meth:`snapshot` written synchronously through
        :func:`repro_torch.checkpoint.save` (tmp dir + rename, CRC32
        manifest, keep-last-3); then the journal is compacted, since the
        snapshot covers every result.  Returns the checkpoint's path."""
        arrays, meta = self.snapshot()
        path = ckpt_lib.save(directory, self.decode_steps, arrays,
                             extra=meta)
        self.obs.trace.instant("snapshot", args={"step": self.decode_steps,
                                                 "mode": "sync"})
        self.obs.registry.counter("serve_snapshots_total").inc()
        if self.journal is not None:
            self.journal.compact(set(self.results))
        return path

    def _poll_snapshot(self, ckpt) -> None:
        """Surface an async write's error into the engine loop, and
        compact the journal once the last snapshot is on disk."""
        err = ckpt.poll()
        if err is not None:
            self._snapshot_error(err)
            self._snap_cover = None
        elif self._snap_cover is not None and not (
                ckpt._thread is not None and ckpt._thread.is_alive()):
            if self.journal is not None:
                self.journal.compact(self._snap_cover)
            self._snap_cover = None

    def _snapshot_error(self, err: BaseException) -> None:
        self.guard_stats["snapshot_errors"] += 1
        self.obs.trace.instant("snapshot_error",
                               args={"error": type(err).__name__})
        warnings.warn(
            f"ServeEngine: snapshot write failed "
            f"({type(err).__name__}: {err}) — serving continues, restart "
            f"durability degraded", FFGuardWarning, stacklevel=3)

    def attach_journal(self, path: str) -> RequestJournal:
        """Attach a write-ahead request journal and replay, in submission
        order, every journaled request this engine does not account for
        (no result, not running, not queued).  Greedy decoding is
        deterministic, so a replayed request gives the tokens the lost run
        would have."""
        self.journal = RequestJournal(path)
        now_w = time.time()
        for rec in self.journal.pending():
            uid = rec["uid"]
            if uid in self.results or any(
                    s is not None and s["req"].uid == uid
                    for s in self._slots) or any(
                    q["req"].uid == uid for q in self.queue):
                continue
            elapsed = max(0.0, now_w - rec.get("t_wall", now_w))
            self._submit(_request(rec, rec["prompt"]),
                         t_sub=time.monotonic() - elapsed,
                         step_sub=min(int(rec.get("step_sub", 0)),
                                      self.decode_steps),
                         bounded=False)
        return self.journal


def resume_engine(params: Dict[str, Any], cfg: ModelConfig,
                  snapshot_dir: str, *, journal: Optional[str] = None,
                  downtime_s: Optional[float] = None,
                  policy: Optional[PrecisionPolicy] = None,
                  **engine_kwargs) -> ServeEngine:
    """Restart a :class:`ServeEngine` after a crash.

    Loads the newest snapshot generation under ``snapshot_dir`` that
    verifies (a corrupt one falls back, warned, to the one before; see
    :mod:`repro_torch.checkpoint`), builds an engine with the snapshot's
    knobs (``engine_kwargs`` override them; ``device=`` picks the device),
    restores it, then replays ``journal``'s unaccounted-for requests in
    order.  With no snapshot at all it starts a cold engine and replays
    the whole journal.  Raises
    :class:`~repro_torch.checkpoint.CheckpointError` when generations
    exist but none verifies."""
    try:
        arrays, _step, meta = ckpt_lib.load_dict(snapshot_dir)
    except FileNotFoundError:
        arrays, meta = None, None
    if meta is not None:
        knobs = {k: v for k, v in meta["engine"].items()
                 if k not in ("policy_repr", "cfg_name", "guard")}
        knobs["guard"] = meta["engine"].get("guard", "off")
        knobs.update(engine_kwargs)
        eng = ServeEngine(params, cfg, policy=policy, **knobs)
        eng.restore(arrays, meta, downtime_s=downtime_s)
    else:
        eng = ServeEngine(params, cfg, policy=policy, **engine_kwargs)
    if journal is not None:
        eng.attach_journal(journal)
    return eng
