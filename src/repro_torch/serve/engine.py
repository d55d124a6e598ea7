"""Continuous-batching serve engine over the paged KV cache (counterpart of
``repro.serve.engine``).

Scheduling model, as in the reference:

  * requests enter a FIFO queue; structurally impossible ones (prompt +
    max_new over ``max_ctx``, a trajectory larger than the pool, a full
    bounded queue) are ``REJECTED`` at submit, never raised;
  * admission reserves the whole trajectory's pages ("trajectory"
    reserve) and runs an exact-length prefill through
    :func:`repro_torch.models.prefill`, then moves the prompt's K/V into
    pages;
  * one paged decode step advances every running row one token: per-row
    positions and RoPE, a paged write of the new K/V, a block-table gather
    feeding the per-row ``decode_attention``, argmax, and both scores
    (``token_logprob`` and the FF ``token_logprob_ff``);
  * after each step, rows that emitted EOS or reached ``max_new`` retire
    (pages back to the free list) and waiting requests join;
  * with ``guard="check"`` or ``"degrade"`` (or an ambient ``ff.guard``
    scope), the decode step also returns a per-row health flag: non-finite
    new K or V in any layer, a non-finite f32 score, or an FF score that
    is non-finite or unnormalized.  A flagged row, or one whose prefill
    score is non-finite, is quarantined: its pages are freed and the whole
    request is retried on the fast f32 tier (``greedy_generate`` under
    :meth:`ServeEngine._fast_policy`), ending ``DEGRADED``, or ``FAILED``
    with its tokens withheld.  The paging metadata is audited
    (:meth:`~repro_torch.serve.paged_kv.PagedKVCache.check_integrity`)
    after every admission round and decode step: untrusted rows are
    quarantined and the free list rebuilt.  The statuses are the
    reference's, including its page-0 leak: a row's unused block-table
    entries gather page 0, whose masked positions still reach ``p @ v``
    (``0 * NaN``), so a NaN in page 0 flags every row.

Not ported yet: the journal, snapshot/restore, ``obs``, deadlines,
``reserve="prompt"`` (preemption) and ``sync_every`` (the port syncs the
five (B,) result vectors after every step).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
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
from repro_torch.serve.paged_kv import PagedKVCache
from repro_torch.train.serve_step import (greedy_generate, token_logprob,
                                          token_logprob_ff)

Tensor = torch.Tensor

# -- terminal statuses (the reference's names) ------------------------------
OK = "OK"                  # ran to eos/max_new
TIMEOUT = "TIMEOUT"        # deadline expired (deadlines not ported yet)
REJECTED = "REJECTED"      # never admitted: bounded queue / impossible size
DEGRADED = "DEGRADED"      # guard quarantined the row; fast-tier retry OK
FAILED = "FAILED"          # no healthy result on any tier
STATUSES = (OK, TIMEOUT, REJECTED, DEGRADED, FAILED)

#: the engine's guard and robustness event counts (``guard_stats``);
#: ``preempted`` and ``snapshot_errors`` stay 0 until preemption and
#: snapshots are ported
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
    """One generation request.  ``prompt``: 1-D int token ids."""
    uid: int
    prompt: np.ndarray
    max_new: int = 16


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


class ServeEngine:
    """Continuous-batching greedy decoder with a paged KV cache.

    ``max_batch`` concurrent rows; ``page_size`` tokens per page;
    ``max_ctx`` per-sequence ceiling (prompt + generated); ``num_pages``
    defaults to a full pool; ``eos_id`` enables per-sequence termination;
    ``kv_mode`` "bf16" (default) or "f32" page storage; ``max_queue``
    bounds the wait queue; ``guard`` ("off", "check" or "degrade"; None
    inherits the ambient ``ff.guard`` mode at construction) switches the
    per-step health probe, quarantine and the paging audit, counted in
    ``guard_stats``.  The attention impl and the RMSNorm statistic
    follow the ambient ``ff.policy`` at construction.  ``device=None``
    means the CUDA card (raises without one); pass ``device="cpu"`` to run
    on the CPU.  ``params`` must lie on that device; the engine keeps one
    copy of them in the compute dtype.

    ``prefill_s`` / ``decode_s`` record the host time of every prefill and
    decode step (each ends in a device sync)."""

    def __init__(self, params: Dict[str, Any], cfg: ModelConfig, *,
                 max_batch: int = 8, page_size: int = 16,
                 max_ctx: int = 256, num_pages: Optional[int] = None,
                 eos_id: Optional[int] = None, kv_mode: str = "bf16",
                 policy: Optional[PrecisionPolicy] = None,
                 max_queue: Optional[int] = None,
                 guard: Optional[str] = None, device=None):
        _check_cfg(cfg)
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
        pages_per_seq = -(-max_ctx // page_size)
        if num_pages is None:
            num_pages = max_batch * pages_per_seq
        self.kv = PagedKVCache(
            cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim,
            num_pages=num_pages, page_size=page_size, max_seqs=max_batch,
            max_ctx=max_ctx, kv_mode=kv_mode, device=self.device)
        self.queue: List[Request] = []
        self.results: Dict[int, GenResult] = {}
        self._slots: List[Optional[Dict[str, Any]]] = [None] * max_batch
        self._token_dev = torch.zeros((max_batch,), dtype=torch.long,
                                      device=self.device)
        self.decode_steps = 0
        self.guard_stats: Dict[str, int] = dict.fromkeys(GUARD_STAT_KEYS, 0)
        self._auditing = False
        self.prefill_s: List[float] = []
        self.decode_s: List[float] = []

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
                plane = kv.planes[base][i]           # (NP, ps, KV, hd) view
                plane[wpage, woff] = new[rows_t, 0].to(plane.dtype)
                gathered[base] = plane[gidx].reshape(B, npg * ps, KVh, hd)
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

    def submit(self, req: Request) -> str:
        """Enqueue a request.  Returns ``"QUEUED"``, or records a
        ``REJECTED`` result and returns it when the request can never be
        served — submission never raises."""
        S = int(req.prompt.shape[0])
        total = S + req.max_new
        max_ctx = self.kv.max_pages * self.kv.page_size
        detail = None
        if total > max_ctx:
            detail = f"prompt+max_new = {total} exceeds max_ctx = {max_ctx}"
        elif self.kv.pages_for(total) > self.kv.num_pages:
            detail = (f"trajectory needs {self.kv.pages_for(total)} pages; "
                      f"pool has {self.kv.num_pages}")
        elif self.max_queue is not None and len(self.queue) >= self.max_queue:
            detail = f"wait queue full (max_queue = {self.max_queue})"
        if detail is not None:
            self.results[req.uid] = _empty_result(req, REJECTED, detail)
            return REJECTED
        self.queue.append(req)
        return "QUEUED"

    def _admit(self) -> None:
        """Join waiting requests into free rows while pages allow (FIFO).
        Under a guard, a non-finite prefill score quarantines the row, and
        an admission round ends with the paging audit."""
        admitted = False
        while self.queue:
            req = self.queue[0]
            S = int(req.prompt.shape[0])
            total = S + req.max_new
            slot = next((i for i, s in enumerate(self._slots) if s is None),
                        None)
            if slot is None or not self.kv.can_alloc(total):
                break
            self.queue.pop(0)
            t0 = time.perf_counter()
            self.kv.alloc(slot, total)     # reserve the whole trajectory
            self.kv.seq_lens[slot] = S     # ...but only S tokens are live
            cache_dt = torch.bfloat16 if self.kv.kv_mode == "bf16" \
                else torch.float32
            cache = init_cache(self.cfg, 1, S, dtype=cache_dt,
                               device=self.device)
            tokens = torch.as_tensor(np.asarray(req.prompt)[None],
                                     dtype=torch.long, device=self.device)
            logits, cache = prefill(self._w, {"tokens": tokens}, self.cfg,
                                    cache, self.policy)
            self.kv.write_prefill(slot, {"k": cache["layers"]["k"][:, 0],
                                         "v": cache["layers"]["v"][:, 0]})
            tok_t = torch.argmax(logits, -1)
            ff_lp = token_logprob_ff(logits, tok_t)
            scores = torch.stack([token_logprob(logits, tok_t, self.policy),
                                  ff_lp.hi, ff_lp.lo]).cpu().numpy()[:, 0]
            tok = int(tok_t[0])
            self.prefill_s.append(time.perf_counter() - t0)
            state = {"req": req, "prompt_len": S, "tokens": [tok],
                     "logprobs": [float(scores[0])],
                     "logprobs_ff": [(float(scores[1]), float(scores[2]))]}
            self._slots[slot] = state
            self._token_dev[slot] = tok
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

    def _retire(self, slot: int, status: str = OK, detail: str = "") -> None:
        state = self._slots[slot]
        self.results[state["req"].uid] = GenResult(
            uid=state["req"].uid,
            tokens=np.asarray(state["tokens"], np.int32),
            logprobs=np.asarray(state["logprobs"], np.float32),
            logprobs_ff=np.asarray(state["logprobs_ff"], np.float32),
            prompt_len=state["prompt_len"], status=status, detail=detail)
        self.kv.free_slot(slot)
        self._slots[slot] = None

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
        self._slots[slot] = None
        self.guard_stats["quarantined"] += 1
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
            self.results[req.uid] = _empty_result(
                req, FAILED, f"guard: {why}; fast-tier retry raised "
                f"{type(e).__name__}: {e}")
            return
        toks = toks[0].cpu().numpy().astype(np.int32)
        lps = lps[0].to(torch.float32).cpu().numpy()
        if not np.all(np.isfinite(lps)):
            self.results[req.uid] = _empty_result(
                req, FAILED, f"guard: {why}; fast-tier retry still "
                f"non-finite")
            return
        self.results[req.uid] = GenResult(
            uid=req.uid, tokens=toks, logprobs=lps,
            logprobs_ff=np.stack([lps, np.zeros_like(lps)], axis=1),
            prompt_len=state["prompt_len"], status=DEGRADED,
            detail=f"guard: {why}; retried on the fast tier")

    def _audit_paging(self) -> None:
        """The guard's audit of the paging metadata: quarantine every row
        with an untrusted page list, then rebuild the free list."""
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
            for slot in sorted(bad):
                if self._slots[slot] is not None:
                    self._quarantine(slot, "corrupt block table",
                                     trust_pages=False)
                else:
                    self.kv.drop_slot(slot)
            self.kv.rebuild_free_list()
            self.guard_stats["integrity_rebuilds"] += 1
        finally:
            self._auditing = False

    def probe_kv(self) -> GuardCounts:
        """One :class:`~repro_torch.ff.guard.GuardCounts` over the whole
        K and V pools (each plane read as f32 (hi, 0) pairs), through
        ``guard_probe`` as resolved (``ff.use(guard_probe="pallas")``: the
        ``guard_flags`` kernel).  A debug and chaos hook: the per-step
        probe sees only the new K/V."""
        tot = [0, 0, 0]
        for base in ("k", "v"):
            c = guard_probe(self.kv.planes[base].to(torch.float32))
            tot = [t + int(n) for t, n in zip(tot, c)]
        return GuardCounts(*(torch.tensor(t, dtype=torch.int32)
                             for t in tot))

    def _step_decode(self) -> None:
        """Advance every running row one token, sync the results; under a
        guard quarantine the flagged rows; retire finished rows; audit the
        paging under a guard."""
        active = np.asarray([s is not None for s in self._slots])
        # tokens already cached: prompt + emitted - 1 (the latest token is
        # the step's input; the step writes its K/V)
        lens = np.asarray([s["prompt_len"] + len(s["tokens"]) - 1 if s
                           else 0 for s in self._slots], np.int32)
        t0 = time.perf_counter()
        nxt, lp, lph, lpl, bad = self._decode(lens, active)
        toks = nxt.cpu().numpy()
        scores = torch.stack([lp, lph, lpl, bad.to(lp.dtype)]).cpu().numpy()
        self.decode_s.append(time.perf_counter() - t0)
        self._token_dev = nxt
        self.decode_steps += 1
        flagged = []
        for slot, state in enumerate(self._slots):
            if state is None:
                continue
            self.kv.seq_lens[slot] = int(lens[slot]) + 1
            state["tokens"].append(int(toks[slot]))
            state["logprobs"].append(float(scores[0, slot]))
            state["logprobs_ff"].append((float(scores[1, slot]),
                                         float(scores[2, slot])))
            if scores[3, slot]:
                flagged.append(slot)
        self.guard_stats["flagged_rows"] += len(flagged)
        for slot in flagged:
            self._quarantine(slot, "per-step probe flagged the row")
        for slot, state in enumerate(self._slots):
            if state is not None and self._finished(state):
                self._retire(slot)
        if self.guard_mode != "off":
            self._audit_paging()

    def step(self) -> bool:
        """One scheduler iteration: admit, decode one token for every
        running row, retire, admit again.  Returns True while work
        remains."""
        self._admit()
        if any(s is not None for s in self._slots):
            self._step_decode()
            self._admit()
        elif self.queue:
            # empty engine and the head still cannot be admitted: terminal
            req = self.queue.pop(0)
            self.results[req.uid] = _empty_result(
                req, FAILED, "unschedulable: no running rows and the head "
                "request cannot be admitted")
        return any(s is not None for s in self._slots) or bool(self.queue)

    def run(self) -> Dict[int, GenResult]:
        """Drain the queue; every submitted uid ends with a terminal
        status."""
        while self.step():
            pass
        return self.results
