"""AdamW with float-float master weights (counterpart of
``repro.optim.adamw``, without the mesh branch).

Why FF master weights: late in training a step's update shrinks to ~1e-7
of the weight; in f32 (2^-24 ~ 6e-8 relative) ``w - lr*u`` rounds it
away.  The FF pair ``(w, master_lo)`` keeps ~2^-44, and the update adds
each f32 step with Add212.

State (all f32, one tensor per parameter leaf): ``master_lo`` the FF low
limb (the high limb is the parameter itself), ``m`` and ``v`` the moments;
``count`` the step.  ``ff=False`` is the plain-f32 baseline arm.

Unlike the reference, which returns new pytrees, :meth:`AdamW.update`
writes the parameters and the state **in place**: at granite-3-2b's width
the out-of-place form needs ~42 GB more.  The values are the
reference's: one ``ff.adamw_update`` per leaf (one kernel launch on the
card), with ``lr``, ``bc1`` and ``bc2`` computed on the device in f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Union

import torch

import repro_torch.ff as ff_ns
from repro_torch.core.ff import FF
from repro_torch.kernels.ff_fused import adamw_chain
from repro_torch.tree import tree_leaves, tree_map

Tensor = torch.Tensor
Params = Dict[str, Any]


@dataclasses.dataclass
class AdamWState:
    count: Tensor            # 0-d int32 on the parameters' device
    master_lo: Params        # like the params (zeros when ff=False)
    m: Params
    v: Params


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Union[Callable[[Tensor], Tensor], float] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    ff: bool = True                      # float-float master weights

    def init(self, params: Params) -> AdamWState:
        dev = tree_leaves(params)[0].device
        zeros = lambda: tree_map(torch.zeros_like, params)  # noqa: E731
        return AdamWState(count=torch.zeros((), dtype=torch.int32,
                                            device=dev),
                          master_lo=zeros(), m=zeros(), v=zeros())

    def _lr(self, count: Tensor) -> Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return torch.tensor(self.learning_rate, dtype=torch.float32,
                            device=count.device)

    @torch.no_grad()
    def update(self, grads: Params, state: AdamWState, params: Params):
        """One step; writes ``params`` and ``state`` in place and returns
        them (the reference's ``(new_params_hi, new_state)``)."""
        state.count += 1
        dev = state.count.device
        c = state.count.to(torch.float32)
        lr = self._lr(state.count)
        b1 = torch.tensor(self.b1, dtype=torch.float32, device=dev)
        b2 = torch.tensor(self.b2, dtype=torch.float32, device=dev)
        bc1 = 1.0 - b1 ** c
        bc2 = 1.0 - b2 ** c
        for g, m, v, w, lo in zip(*(tree_leaves(t) for t in (
                grads, state.m, state.v, params, state.master_lo))):
            g = g.to(torch.float32)
            if self.ff:
                ff_ns.adamw_update(g, m, v, w, lo, lr, b1, b2, bc1, bc2,
                                   eps=self.eps, wd=self.weight_decay)
            else:
                # the f32 baseline arm: the same chain, a plain f32 add
                delta, m2, v2 = adamw_chain(g, m, v, w, lr, b1, b2, bc1,
                                            bc2, self.eps,
                                            self.weight_decay)
                w.add_(delta)
                m.copy_(m2)
                v.copy_(v2)
        return params, state


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable[[Tensor], Tensor]:
    """Linear warm-up, then cosine decay to ``min_frac * base_lr``; the
    rate is an f32 tensor on the step count's device."""
    def lr(count: Tensor) -> Tensor:
        c = count.to(torch.float32)
        warm = c / max(warmup, 1)
        prog = torch.clamp((c - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(c < warmup, warm, cos)
    return lr


def global_grad_norm(grads: Params, ff: bool = False) -> Tensor:
    """Global L2 norm; with ``ff=True`` the per-leaf f32 sums of squares
    are accumulated across leaves in FF (``ff.add``)."""
    leaves = tree_leaves(grads)
    if not ff:
        return torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                              for g in leaves))
    z = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    acc = FF(z, z)
    for g in leaves:
        acc = ff_ns.add(acc, torch.sum(g.to(torch.float32) ** 2))
    return torch.sqrt(acc.to_f32())


@torch.no_grad()
def clip_by_global_norm(grads: Params, max_norm: float, ff: bool = False):
    """Scales ``grads`` in place to a global norm of at most ``max_norm``
    (the reference returns scaled copies); returns ``(grads, norm)``."""
    n = global_grad_norm(grads, ff=ff)
    scale = torch.clamp_max(max_norm / torch.clamp_min(n, 1e-12), 1.0)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, n
