"""The training loop (counterpart of ``repro.train.trainer``): straggler
detection and a compensated loss accumulator.

  * per-step wall times go into a ring buffer; a step slower than
    ``median * straggler_factor`` (once 8 steps are in) is logged and
    counted;
  * the running loss is an FF accumulator (``ff.add``), exact over very
    many steps; the mean is taken in Python floats (f64).

Checkpointing and resume are not ported yet: a ``ckpt_dir`` raises.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

import torch

import repro_torch.ff as ff
from repro_torch.core.ff import FF


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None      # checkpointing: not ported yet
    log_every: int = 10
    straggler_window: int = 32
    straggler_factor: float = 3.0


class Trainer:
    def __init__(self, tcfg: TrainerConfig, step_fn: Callable, params,
                 opt_state, data_iter: Callable[[int], Dict[str, Any]], *,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 log_fn: Callable[[str], None] = print):
        if tcfg.ckpt_dir is not None:
            raise NotImplementedError("checkpointing is not ported yet: "
                                      "run without ckpt_dir")
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
        acc = float(self.loss_acc.hi) + float(self.loss_acc.lo)
        return {"step": self.step,
                "mean_loss": acc / max(self.loss_count, 1),
                "straggler_events": self.straggler_events,
                "last_loss": float(loss)}
