"""Mixture-of-Experts FFN with capacity-based dispatch (counterpart of
``repro.models.moe``).

The reference's semantics, including where it drops work: each expert
takes at most ``cap = int(max(1, round(k T cf / E)))`` (token, slot)
pairs (Python's ``round``), in token order; the rest are dropped.  The
top-k keeps the reference's tie order (the lower expert index first: a
stable descending sort over the experts, cut to k, where ``torch.topk``
promises no order on CUDA); the slot positions come from a stable
argsort and a left ``searchsorted``, as the reference's.  The combine
sums each token's k slots in slot order (deterministic on every device,
where ``index_add_`` on CUDA adds in the order its atomics land).

Router logits and softmax are f32; with ``ff_stats`` the load-balance
statistic's expert means are a compensated sum (``ff.sum(probs, axis=0,
block=4096)``: the ``blocked`` impl by default on every device, plain
torch, as the reference's default).  With ``ff_math`` the expert and
shared-expert silu gates are ``ff.silu`` (the ``ff_math`` kernel on the
card under ``ff.use(silu="pallas")``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

import repro_torch.ff as ff
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp_apply

Tensor = torch.Tensor
Params = Dict[str, Any]


def moe_params(cfg: ModelConfig, dense) -> Params:
    """One MoE FFN's weights; ``dense(shape)`` draws a matrix (normal /
    sqrt(fan_in), fan_in = shape[-2]) with any leading layer axis."""
    E, d = cfg.moe_num_experts, cfg.d_model
    dff = cfg.moe_d_ff or cfg.d_ff
    p = {"router": dense((d, E)), "w_gate": dense((E, d, dff)),
         "w_up": dense((E, d, dff)), "w_down": dense((E, dff, d))}
    if cfg.moe_shared_experts:
        sff = cfg.moe_shared_experts * dff
        p["shared"] = {"w_gate": dense((d, sff)), "w_up": dense((d, sff)),
                       "w_down": dense((sff, d))}
    return p


def capacity(cfg: ModelConfig, T: int) -> int:
    """Slots an expert takes from ``T`` tokens (the reference's formula,
    Python's round: 2.5 -> 2)."""
    return int(max(1, round(cfg.moe_top_k * T * cfg.moe_capacity_factor
                            / cfg.moe_num_experts)))


class Routing(NamedTuple):
    gates: Tensor       # (T, k) f32: the top-k probabilities, renormalised
    idx: Tensor         # (T, k) int64: the experts, highest first
    pos_in_e: Tensor    # (T * k,) int64: each slot's place in its expert
    keep: Tensor        # (T * k,) bool: pos_in_e < cap
    cap: int
    counts: Tensor      # (E,) int64: the slots that chose each expert


def route(probs: Tensor, cfg: ModelConfig) -> Routing:
    """The top-k experts of each token and each (token, slot)'s place in
    its expert's queue (token order, then slot order)."""
    T, E = probs.shape
    k = cfg.moe_top_k
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :k], order[:, :k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    e_idx = idx.reshape(T * k)
    perm = torch.argsort(e_idx, stable=True)
    sorted_e = e_idx[perm]
    starts = torch.searchsorted(
        sorted_e, torch.arange(E, dtype=e_idx.dtype, device=probs.device))
    pos_sorted = torch.arange(T * k, device=probs.device) - starts[sorted_e]
    pos_in_e = torch.empty_like(pos_sorted)
    pos_in_e[perm] = pos_sorted
    cap = capacity(cfg, T)
    counts = torch.diff(starts, append=starts.new_full((1,), T * k))
    return Routing(gates, idx, pos_in_e, pos_in_e < cap, cap, counts)


def moe_apply(p: Params, x: Tensor, cfg: ModelConfig, ff_stats: bool = False,
              ff_math: bool = False) -> Tuple[Tensor, Tensor]:
    """x: (B, S, d) -> (out, aux loss)."""
    B, S, d = x.shape
    T, E, k = B * S, cfg.moe_num_experts, cfg.moe_top_k
    dt, dev = x.dtype, x.device
    xt = x.reshape(T, d)

    logits = (xt @ p["router"].to(dt)).to(torch.float32)          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    r = route(probs, cfg)
    e_idx = r.idx.reshape(T * k)
    t_idx = torch.arange(T, device=dev).repeat_interleave(k)

    # dispatch: every kept (token, slot) to its own (expert, place); the
    # reference adds them onto zeros, where no two kept slots meet
    buf = torch.zeros((E, r.cap, d), dtype=dt, device=dev)
    buf[e_idx[r.keep], r.pos_in_e[r.keep]] = xt[t_idx[r.keep]]

    # the experts' SwiGLU, batched over E
    pre = torch.bmm(buf, p["w_gate"].to(dt))
    if ff_math:
        g = ff.to_f32(ff.silu(pre.to(torch.float32))).to(dt)
    else:
        g = F.silu(pre)
    u = torch.bmm(buf, p["w_up"].to(dt))
    h = torch.bmm(g * u, p["w_down"].to(dt))

    # combine: each slot's output weighted by its gate, the k slots of a
    # token summed in slot order
    safe_pos = torch.where(r.keep, r.pos_in_e, r.cap - 1)
    y = torch.where(r.keep[:, None], h[e_idx, safe_pos], 0) \
        * r.gates.reshape(T * k, 1).to(dt)
    y = y.reshape(T, k, d)
    out = torch.zeros((T, d), dtype=dt, device=dev)
    for s in range(k):
        out = out + y[:, s]

    if cfg.moe_shared_experts:
        out = out + mlp_apply(p["shared"], xt, ff_math=ff_math)

    # the load-balance aux loss (Switch): E * sum_e f_e * P_e
    f32 = dict(dtype=torch.float32, device=dev)
    if ff_stats:
        me = ff.sum(probs, axis=0, block=4096).to_f32() \
            / torch.tensor(float(T), **f32)
    else:
        me = probs.mean(dim=0)
    ce = r.counts.to(torch.float32) / torch.tensor(float(T * k), **f32)
    aux = E * torch.sum(me * ce)
    return out.reshape(B, S, d), aux
