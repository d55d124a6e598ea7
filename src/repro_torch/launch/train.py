"""Training launcher (counterpart of ``repro.launch.train``, without
``--mesh``)::

    python -m repro_torch.launch.train --arch granite-3-2b --steps 3 \\
        [--policy ff_reduce] [--reduced] [--device cpu] \\
        [--ckpt-dir DIR [--ckpt-every N]]

Runs on the CUDA card unless ``--device cpu`` is given.  Weights come from
seed 0, batches from ``SyntheticLM``.  With ``--ckpt-dir`` the run
checkpoints every ``--ckpt-every`` steps (default: a third of ``--steps``)
and at the end, and first resumes from the latest checkpoint there.
``--arch`` names any architecture.  As the reference's launcher, its
batches hold tokens and targets only, so a VLM config (internvl2-1b)
stops at its first step with ``KeyError: 'patches'`` and an enc-dec one
(whisper-medium) with ``KeyError: 'frames'``; ``Trainer`` and
``make_train_step`` train both given those inputs in the batch.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.selfcheck import require_eft_safe
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import init_params
from repro_torch.optim.adamw import AdamW, cosine_schedule, tree_leaves
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-size variant (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--policy", default="ff_master")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory; resumes from its latest "
                         "checkpoint")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="steps between checkpoints (default: steps // 3)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    require_eft_safe(device=device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    policy = PrecisionPolicy.make(args.policy,
                                  compute_dtype=cfg.compute_dtype)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"[train] {cfg.name}: {n/1e6:.1f}M params, policy={policy.level}, "
          f"device={device}")

    opt = AdamW(learning_rate=cosine_schedule(args.lr, 10, args.steps),
                ff=policy.ff_master_weights)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, policy, opt,
                              microbatches=args.microbatches)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq,
                                  global_batch=args.batch))

    def data_iter(i):
        return {k: torch.from_numpy(v).to(device)
                for k, v in data.batch(i).items()}

    trainer = Trainer(
        TrainerConfig(total_steps=args.steps,
                      ckpt_every=args.ckpt_every or max(args.steps // 3, 1),
                      ckpt_dir=args.ckpt_dir, log_every=10),
        step_fn, params, opt_state, data_iter)
    if args.ckpt_dir:
        trainer.restore()
    result = trainer.run()
    print(f"[train] done: {result}")
    return result


if __name__ == "__main__":
    main()
