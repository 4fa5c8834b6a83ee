"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Counterpart of ``repro.launch.train``: ``Trainer`` on one device, fed by
``SyntheticTokens`` and driven by ``run_with_recovery`` (a checkpoint at
step 0 and every ``--ckpt-every`` steps). Runs on ``--device`` (default
cuda; the CPU only when asked for). ``main`` returns a summary with every
step's loss, for callers that check the run.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.config import reduced
from repro_torch.configs import ALL_ARCHS, EXTRA_ARCHS, get
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.runtime.fault import StragglerMonitor, run_with_recovery
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import AdamWConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="exanest-lm-100m",
                    choices=ALL_ARCHS + EXTRA_ARCHS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--quantize-opt", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                          decay_steps=args.steps,
                          quantize_states=args.quantize_opt)
    trainer = Trainer(model, opt_cfg, device=device)
    data = SyntheticTokens(cfg, batch=args.batch, seq=args.seq, device=device)
    step_fn = trainer.make_step()
    mon = StragglerMonitor()
    losses: dict[int, torch.Tensor] = {}   # last run of each step (replays)
    marks: dict[str, float] = {}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def one_step(st, i):
        st, metrics = step_fn(st, data.batch_at(i))
        losses[i] = metrics["loss"]
        if i % 10 == 0:
            print(f"step {i} loss {float(metrics['loss']):.4f}", flush=True)
        if i == 0:
            sync()
            marks["after_step0"] = time.perf_counter()
        return st

    os.makedirs(args.ckpt_dir, exist_ok=True)
    t0 = time.perf_counter()
    # the initial state is handed over, not kept here: a full-width 2.4 B
    # model's state (~24 GB with its moments) held twice does not fit one
    # 80 GB card beside a step
    state, log = run_with_recovery(
        trainer.init_state(torch.Generator().manual_seed(0)), one_step,
        args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        straggler=mon)
    sync()
    t_end = time.perf_counter()
    print(f"done: {args.steps} steps, straggles={log['straggles']}",
          flush=True)
    # steady state: every step after the first (which also warms up the
    # libraries), without the step-0 checkpoint
    steady = ((t_end - marks["after_step0"]) / (args.steps - 1)
              if args.steps > 1 and log["failures"] == 0 else None)
    return {"arch": cfg.name, "device": str(device), "steps": args.steps,
            "batch": args.batch, "seq": args.seq,
            "losses": [float(losses[i]) for i in range(args.steps)],
            "log": log, "wall_s": t_end - t0, "steady_s_per_step": steady,
            "state": state}


if __name__ == "__main__":
    main()
