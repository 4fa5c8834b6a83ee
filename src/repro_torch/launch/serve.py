"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Counterpart of ``repro.launch.serve``: drives the slot-based
continuous-batching engine with synthetic requests and reports per-request
latency in engine steps (submit -> done). Runs on ``--device`` (default
cuda; the CPU only when asked for).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.config import reduced
from repro_torch.configs import ALL_ARCHS, EXTRA_ARCHS, get
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="exanest-lm-100m",
                    choices=ALL_ARCHS + EXTRA_ARCHS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--window", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0,
                    help="RNG seed for the synthetic requests "
                         "(deterministic token streams per seed)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=device)
    eng = ServeEngine(model, params, slots=args.slots, window=args.window,
                      device=device)
    rng = np.random.default_rng(args.seed)
    rids = [eng.submit(
        list(rng.integers(0, cfg.vocab_size, size=args.prompt_len)),
        max_new_tokens=args.max_new)
        for _ in range(args.requests)]
    t0 = time.perf_counter()
    steps = eng.run_until_idle(max_steps=10000)
    dt = time.perf_counter() - t0
    done = sum(eng.result(r) is not None for r in rids)
    toks = sum(len(eng.result(r) or []) for r in rids)
    print(f"served {done}/{args.requests} requests, {toks} tokens in "
          f"{steps} engine steps, {dt:.2f}s ({toks/max(dt,1e-9):.1f} tok/s) "
          f"on {device}")
    stats = eng.request_steps()
    if stats:
        lat = np.sort(np.array([d - s for s, d in stats.values()],
                               dtype=np.float64))
        print(f"latency (submit->done, engine steps): "
              f"p50={np.quantile(lat, 0.5):.0f} "
              f"p90={np.quantile(lat, 0.9):.0f} "
              f"p99={np.quantile(lat, 0.99):.0f} max={lat.max():.0f}")
        for rid in sorted(stats)[:8]:
            s, d = stats[rid]
            print(f"  request {rid}: submit@{s} done@{d} "
                  f"({d - s} steps, {len(eng.result(rid) or [])} tokens)")


if __name__ == "__main__":
    main()
