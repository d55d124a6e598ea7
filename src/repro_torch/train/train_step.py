"""Train and eval step factories (counterpart of
``repro.train.train_step``, without the mesh tier).

``make_train_step(cfg, policy, optimizer)`` returns
    step(params, opt_state, batch) -> (params, opt_state, metrics)
with optional microbatch gradient accumulation and global-norm clipping.
The step writes ``params`` and ``opt_state`` in place (see
:mod:`repro_torch.optim.adamw`) and returns them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core import ff as core_ff
from repro_torch.core.ff import FF
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.ff.scope import resolve_policy
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import train_forward
from repro_torch.optim.adamw import AdamW, AdamWState, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_unflatten

Tensor = torch.Tensor


def _no_mesh(mesh, mesh_axis) -> None:
    if mesh is not None or mesh_axis is not None:
        raise NotImplementedError("the mesh tier (repro.ff.sharded) is not "
                                  "ported yet")


def make_loss_fn(cfg: ModelConfig, policy: Optional[PrecisionPolicy] = None,
                 *, mesh=None, mesh_axis=None) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics)``.  policy=None reads
    the ambient ``ff.policy`` scope when ``make_loss_fn`` is called."""
    _no_mesh(mesh, mesh_axis)
    policy = resolve_policy(policy)

    def loss_fn(params, batch):
        return train_forward(params, batch, cfg, policy)
    return loss_fn


def make_train_step(cfg: ModelConfig,
                    policy: Optional[PrecisionPolicy] = None,
                    optimizer: Optional[AdamW] = None, *,
                    microbatches: int = 1,
                    clip_norm: Optional[float] = 1.0,
                    mesh=None, mesh_axis=None) -> Callable:
    """Build ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.

    With ``microbatches > 1`` the batch's leading dim splits into that many
    microbatches, whose gradients add up in f32 and whose losses add up in
    an FF carry (Add212), as in the reference."""
    if optimizer is None:
        raise TypeError("make_train_step requires an optimizer (policy is "
                        "optional — it falls back to the ambient ff.policy "
                        "scope — but the optimizer is not)")
    _no_mesh(mesh, mesh_axis)
    policy = resolve_policy(policy)
    loss_fn = make_loss_fn(cfg, policy)

    def grads_of(params, batch, leaves):
        loss, metrics = loss_fn(params, batch)
        return loss, metrics, torch.autograd.grad(loss, leaves)

    def step(params, opt_state: AdamWState, batch: Dict[str, Tensor]):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            if microbatches == 1:
                loss, metrics, grads = grads_of(params, batch, leaves)
                loss = loss.detach()
            else:
                grads = [torch.zeros_like(p, dtype=torch.float32)
                         for p in leaves]
                z = torch.zeros((), dtype=torch.float32,
                                device=leaves[0].device)
                loss_acc = FF(z, z)
                for i in range(microbatches):
                    mb = {k: _microbatch(x, i, microbatches)
                          for k, x in batch.items()}
                    l, _m, g = grads_of(params, mb, leaves)
                    for a, b in zip(grads, g):
                        a.add_(b)
                    # compensated loss carry across microbatches
                    loss_acc = core_ff.add212(loss_acc, l.detach())
                for g in grads:
                    g.div_(microbatches)
                loss = loss_acc.to_f32() / microbatches
                metrics = {"loss": loss, "aux": torch.zeros_like(loss)}
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = tree_unflatten(params, iter(grads))
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm,
                                               ff=policy.ff_reductions)
        else:
            gnorm = torch.zeros((), dtype=torch.float32, device=loss.device)
        params, opt_state = optimizer.update(grads, opt_state, params)
        metrics = {k: t.detach() for k, t in metrics.items()}
        metrics["grad_norm"] = gnorm
        metrics["lr"] = optimizer._lr(opt_state.count)
        return params, opt_state, metrics

    return step


def make_eval_step(cfg: ModelConfig,
                   policy: Optional[PrecisionPolicy] = None) -> Callable:
    """``step(params, batch) -> metrics``, without gradients."""
    loss_fn = make_loss_fn(cfg, policy)

    @torch.no_grad()
    def step(params, batch):
        _loss, metrics = loss_fn(params, batch)
        return metrics
    return step


def _microbatch(x: Tensor, i: int, n: int) -> Tensor:
    b = x.shape[0]
    if b % n:
        raise ValueError(f"batch of {b} does not split into {n} "
                         f"microbatches")
    return x[i * (b // n):(i + 1) * (b // n)]
