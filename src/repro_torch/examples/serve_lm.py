"""Batched serving demo: continuous batching with slot-based KV cache over
a small LM — requests arrive while others are mid-generation.

Counterpart of the reference's ``examples/serve_lm.py``: the same reduced
model, 4 slots of 64 positions, 3 requests, then 3 more after the third
engine step.

Run: PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.bridge import load_params
from repro_torch.config import reduced
from repro_torch.configs import get
from repro_torch.models import build_model
from repro_torch.serve.engine import ServeEngine


def serve(device=None, leaves: dict | None = None) -> dict[int, list[int]]:
    """Each request's generated tokens, by request id. The weights are
    ``leaves`` (tree path -> array, e.g. the reference's parameters) when
    given, else drawn from ``torch.Generator`` seed 0."""
    cfg = reduced(get("exanest-lm-100m"), n_layers=2, d_model=64,
                  vocab_size=512, n_heads=4, n_kv_heads=2, d_ff=128)
    model = build_model(cfg)
    params = (model.init(torch.Generator().manual_seed(0), device=device)
              if leaves is None else load_params(model, leaves, device))
    eng = ServeEngine(model, params, slots=4, window=64, device=device)

    # staggered arrivals: 6 requests over time into 4 slots
    rids = []
    for i in range(3):
        rids.append(eng.submit([1 + i, 2 + i, 3 + i], max_new_tokens=8))
    for step in range(50):
        eng.step()
        if step == 2:
            for i in range(3):
                rids.append(eng.submit([10 + i] * 5, max_new_tokens=6))
        if all(eng.result(r) is not None for r in rids):
            break
    outs = {}
    for r in rids:
        out = eng.result(r)
        print(f"request {r}: {out}")
        assert out is not None
        outs[r] = out
    print("serve_lm OK")
    return outs


def main(argv=None) -> dict[int, list[int]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    return serve(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
