"""Serving steps: prefill / decode step builders, token scoring (f32 and
FF), and the sequential greedy loop (counterpart of
``repro.train.serve_step``)."""

from __future__ import annotations

from typing import Dict, Optional

import torch

import repro_torch.ff as ff
from repro_torch.core import compensated, ffmath
from repro_torch.core import ff as core_ff
from repro_torch.core import transforms as T
from repro_torch.core.ff import FF
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.ff.scope import resolve_policy
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import decode_step, init_cache, prefill

Tensor = torch.Tensor


def make_prefill_step(cfg: ModelConfig,
                      policy: Optional[PrecisionPolicy] = None):
    """policy=None reads the ambient ``ff.policy`` scope at build."""
    policy = resolve_policy(policy)

    def step(params, batch: Dict[str, Tensor], cache):
        return prefill(params, batch, cfg, cache, policy)
    return step


def make_decode_step(cfg: ModelConfig,
                     policy: Optional[PrecisionPolicy] = None):
    policy = resolve_policy(policy)

    def step(params, token: Tensor, pos: int, cache):
        return decode_step(params, token, pos, cache, cfg, policy)
    return step


def token_logprob(logits: Tensor, token: Tensor,
                  policy: Optional[PrecisionPolicy] = None) -> Tensor:
    """Log-probability of ``token`` under ``logits`` (B, V) -> (B,), with
    the compensated ``ff.logsumexp`` normalizer; under a policy with
    ``ff_math``, its accurate ``"ff"`` impl (FF exponentials, FF log)."""
    policy = resolve_policy(policy)
    x = logits.to(torch.float32)
    lse = ff.logsumexp(x, axis=-1, impl="ff" if policy.ff_math else None)
    chosen = torch.gather(x, -1, token[:, None].long())[:, 0]
    return chosen - lse


def token_logprob_ff(logits: Tensor, token: Tensor) -> FF:
    """FF-valued chosen-token log-probability: (B, V), (B,) -> FF of (B,).

    TwoSum max-shift, FF exponentials, compensated exp-sum, FF log and the
    final chosen-minus-LSE subtract all stay in FF (the reference's op
    sequence: bitwise its result on the same logits)."""
    x = logits.to(torch.float32)
    m = torch.amax(x, dim=-1, keepdim=True)
    dh, dl = T.two_sum(x, (-m).expand(x.shape))
    eh, el = ffmath.exp22(dh, dl)
    s = core_ff.add22_accurate(
        compensated.ff_sum_blocked(eh, axis=-1, block=256),
        compensated.ff_sum_blocked(el, axis=-1, block=256))
    logs = FF(*ffmath.log22(s.hi, s.lo))
    lse = core_ff.add212(logs, m.squeeze(-1))
    chosen = torch.gather(x, -1, token[:, None].long())[:, 0]
    return core_ff.add212(FF(-lse.hi, -lse.lo), chosen)


def greedy_generate(params, cfg: ModelConfig, prompt: Tensor, max_new: int,
                    cache_len: int,
                    policy: Optional[PrecisionPolicy] = None,
                    extra_inputs: Optional[Dict[str, Tensor]] = None,
                    return_logprobs: bool = False,
                    eos_id: Optional[int] = None):
    """Greedy decoding, one sequence batch at a time.  prompt: (B, S) int;
    ``extra_inputs`` joins the prefill batch (``{"patches": (B, P, d)}``
    for ``vlm``, whose decode starts at S + num_patches; ``{"frames": (B,
    encoder_seq, d)}`` for ``encdec``).

    ``return_logprobs=True`` also returns the (B, n) chosen-token scores
    (:func:`token_logprob`).  With ``eos_id`` set, rows that emitted it are
    pinned to it and the loop ends once every row has."""
    B, S = prompt.shape
    pol = resolve_policy(policy)
    cache = init_cache(cfg, B, cache_len, device=prompt.device)
    pf = make_prefill_step(cfg, pol)
    dc = make_decode_step(cfg, pol)
    logits, cache = pf(params, {"tokens": prompt, **(extra_inputs or {})},
                       cache)
    toks = [torch.argmax(logits, -1).to(torch.int32)]
    lps = [token_logprob(logits, toks[-1], pol)] if return_logprobs else None
    done = (toks[-1] == eos_id) if eos_id is not None else None
    pos0 = S + (cfg.num_patches if cfg.family == "vlm" else 0)
    for t in range(max_new - 1):
        if eos_id is not None and bool(done.all()):
            break
        logits, cache = dc(params, toks[-1][:, None], pos0 + t, cache)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        if eos_id is not None:
            nxt = torch.where(done, eos_id, nxt).to(torch.int32)
            done = done | (nxt == eos_id)
        toks.append(nxt)
        if return_logprobs:
            lps.append(token_logprob(logits, toks[-1], pol))
    out = torch.stack(toks, dim=1)
    if return_logprobs:
        return out, torch.stack(lps, dim=1)
    return out
