"""End-to-end training run: a ~100M-parameter LM for a few hundred steps,
with checkpointing, failure injection + recovery, and straggler
monitoring — the full production loop.

Counterpart of the reference's ``examples/train_lm.py``: one failure
injected at step ``steps // 3``, replayed from the last checkpoint; the
run fails unless the loss falls.

Run: PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200]
[--small] [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.config import reduced
from repro_torch.configs import get
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models import build_model
from repro_torch.runtime.fault import (FailureInjector, StragglerMonitor,
                                       run_with_recovery)
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import AdamWConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--small", action="store_true",
                    help="reduced config (fast CI run)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--inject-failures", action="store_true", default=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)

    cfg = get("exanest-lm-100m")
    if args.small:
        cfg = reduced(cfg)
    model = build_model(cfg)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"batch={args.batch} seq={args.seq} steps={args.steps}")

    trainer = Trainer(model, AdamWConfig(lr=3e-3, warmup_steps=20,
                                         decay_steps=args.steps),
                      device=args.device)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    data = SyntheticTokens(cfg, batch=args.batch, seq=args.seq,
                           device=args.device)
    step_fn = trainer.make_step()

    losses = []

    def one_step(st, i):
        batch = data.batch_at(i)
        st, metrics = step_fn(st, batch)
        if i % 20 == 0 or i == args.steps - 1:
            losses.append((i, float(metrics["loss"])))
            print(f"step {i:4d} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f}")
        return st

    injector = FailureInjector(frozenset({args.steps // 3})) \
        if args.inject_failures else None
    mon = StragglerMonitor()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        state, log = run_with_recovery(
            state, one_step, args.steps, ckpt_dir=ckpt_dir, ckpt_every=50,
            injector=injector, straggler=mon)
    print(f"done. failures={log['failures']} "
          f"replayed={log['replayed_steps']} straggles={log['straggles']}")
    assert losses[-1][1] < losses[0][1], "loss must decrease"
    print(f"loss {losses[0][1]:.3f} -> {losses[-1][1]:.3f}  OK")
    return {"losses": losses, "log": log}


if __name__ == "__main__":
    main()
