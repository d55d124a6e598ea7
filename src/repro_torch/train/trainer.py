"""The training loop (counterpart of ``repro.train.trainer``):
checkpoint and resume, straggler detection and a compensated loss
accumulator.

  * with a ``ckpt_dir``, ``{"params", "opt"}`` is checkpointed every
    ``ckpt_every`` steps and at the end through an
    :class:`~repro_torch.checkpoint.AsyncCheckpointer` (copied to the host
    on the call, written on a thread; the reference's files and leaf
    names); :meth:`Trainer.restore` resumes from the latest one, copying
    it into the live tensors in place.  The data pipeline is indexed by
    step, so a resumed run sees the batches the lost one would have;
  * an injectable ``fault_hook(step)`` may raise to simulate a failure;
  * per-step wall times go into a ring buffer; a step slower than
    ``median * straggler_factor`` (once 8 steps are in) is logged and
    counted;
  * the running loss is an FF accumulator (``ff.add``), exact over very
    many steps; the mean is taken in Python floats (f64).
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

import torch

import repro_torch.ff as ff
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.core.ff import FF


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    straggler_window: int = 32
    straggler_factor: float = 3.0


class Trainer:
    def __init__(self, tcfg: TrainerConfig, step_fn: Callable, params,
                 opt_state, data_iter: Callable[[int], Dict[str, Any]], *,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 log_fn: Callable[[str], None] = print):
        self.tcfg = tcfg
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.data_iter = data_iter
        self.fault_hook = fault_hook
        self.log = log_fn
        self.step = 0
        self.times = deque(maxlen=tcfg.straggler_window)
        self.straggler_events = 0
        z = torch.zeros((), dtype=torch.float32)
        self.loss_acc = FF(z, z)          # on the host, like the reference
        self.loss_count = 0
        self.ckpt = (ckpt_lib.AsyncCheckpointer(tcfg.ckpt_dir)
                     if tcfg.ckpt_dir else None)

    def restore(self) -> bool:
        """Resume from the latest checkpoint, if any: its parameters and
        optimizer state are copied into the live tensors in place (their
        devices and dtypes kept).  Returns whether it resumed."""
        if not self.tcfg.ckpt_dir:
            return False
        latest = ckpt_lib.latest_step(self.tcfg.ckpt_dir)
        if latest is None:
            return False
        tree = {"params": self.params, "opt": self.opt_state}
        restored, step, _extra = ckpt_lib.load(self.tcfg.ckpt_dir, tree,
                                               latest)
        names = ckpt_lib.flatten_with_names(tree)
        for (_, live), (_, saved) in zip(
                names, ckpt_lib.flatten_with_names(restored)):
            live.copy_(torch.as_tensor(saved))
        self.step = step
        self.log(f"[trainer] resumed from step {step}")
        return True

    def _maybe_checkpoint(self, force: bool = False) -> None:
        if self.ckpt and (force or self.step % self.tcfg.ckpt_every == 0):
            self.ckpt.save(self.step,
                           {"params": self.params, "opt": self.opt_state},
                           extra={"step": self.step})

    def _record_time(self, dt: float) -> None:
        self.times.append(dt)
        if len(self.times) >= 8:
            med = statistics.median(self.times)
            if dt > med * self.tcfg.straggler_factor:
                self.straggler_events += 1
                self.log(f"[trainer] straggler step {self.step}: "
                         f"{dt*1e3:.1f}ms vs median {med*1e3:.1f}ms")

    def run(self) -> Dict[str, Any]:
        loss = torch.zeros(())
        while self.step < self.tcfg.total_steps:
            if self.fault_hook:
                self.fault_hook(self.step)   # may raise (simulated failure)
            batch = self.data_iter(self.step)
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            loss = metrics["loss"].to("cpu")  # waits for the step
            self._record_time(time.perf_counter() - t0)
            self.loss_acc = ff.add(self.loss_acc, loss)
            self.loss_count += 1
            self.step += 1
            if self.step % self.tcfg.log_every == 0:
                gnorm = float(metrics.get("grad_norm", 0))
                self.log(f"[trainer] step {self.step} "
                         f"loss {float(loss):.4f} gnorm {gnorm:.3f}")
            self._maybe_checkpoint()
        self._maybe_checkpoint(force=True)
        if self.ckpt:
            self.ckpt.wait()
        acc = float(self.loss_acc.hi) + float(self.loss_acc.lo)
        return {"step": self.step,
                "mean_loss": acc / max(self.loss_count, 1),
                "straggler_events": self.straggler_events,
                "last_loss": float(loss)}
