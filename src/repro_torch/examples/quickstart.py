"""Quickstart: the three layers of the framework in one minute.

1. Layer A — ExaNet model: reproduce a paper number (accelerated allreduce).
2. Layer B — the hierarchical allreduce on a process mesh (at least two
   ranks of an initialised ``torch.distributed``; one process skips it).
3. Train a tiny LM for a few steps with the full substrate.

Counterpart of the reference's ``examples/quickstart.py``.

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import torch
import torch.distributed as dist


def layer_a() -> None:
    from repro_torch.core.exanet import ExanetMPI
    from repro_torch.core.exanet.allreduce_accel import \
        accel_allreduce_latency
    mpi = ExanetMPI(ranks_per_mpsoc=1)
    sw = mpi.allreduce_sw(256, 128)
    hw = accel_allreduce_latency(256, 128)
    print(f"[exanet] 256B allreduce @128 ranks: software {sw:.1f}us, "
          f"NI accelerator {hw:.2f}us -> {100*(1-hw/sw):.1f}% faster "
          f"(paper: 87.9%)")


def layer_b(device=None) -> bool | None:
    """``hierarchical_allreduce`` against ``flat_allreduce`` on a (pod 2,
    data n/2) mesh of the initialised process group: whether they agree,
    or None where there is no group of two ranks or more."""
    from repro_torch.core.collectives import (flat_allreduce,
                                              hierarchical_allreduce)
    from repro_torch.launch.mesh import make_mesh
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n < 2:
        print(f"[tpu-adapt] single device ({n}) — skipping mesh demo "
              "(see tests/test_torch_examples.py for the 2-rank run)")
        return None
    mesh = make_mesh((2, n // 2), ("pod", "data"), device=device)
    x = torch.arange(8.0, device=mesh.device)
    a = hierarchical_allreduce(x, mesh, intra_axis="data", inter_axis="pod")
    b = flat_allreduce(x, mesh, ("data", "pod"))
    same = bool(torch.allclose(a, b))
    print(f"[tpu-adapt] hierarchical == flat allreduce: {same}")
    return same


def tiny_training(device=None, leaves: dict | None = None,
                  steps: int = 20) -> list[dict]:
    """The reduced exanest-lm-100m trained ``steps`` steps (batch 4 x 64,
    lr 1e-2); from ``leaves`` (tree path -> array, e.g. the reference's
    parameters) when given, else from ``torch.Generator`` seed 0."""
    from repro_torch.bridge import load_params
    from repro_torch.config import reduced
    from repro_torch.configs import get
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.train.loop import Trainer
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    cfg = reduced(get("exanest-lm-100m"))
    model = build_model(cfg)
    trainer = Trainer(model, AdamWConfig(lr=1e-2, warmup_steps=5),
                      device=device)
    if leaves is None:
        state = trainer.init_state(torch.Generator().manual_seed(0))
    else:
        params = load_params(model, leaves, device=device)
        state = {"params": params,
                 "opt": adamw_init(params, trainer.opt_cfg)}
    data = SyntheticTokens(cfg, batch=4, seq=64, device=device)
    state, hist = trainer.fit(state, iter(data), n_steps=steps, log_every=5)
    print(f"[train] tiny LM loss: {hist[0]['loss']:.3f} -> "
          f"{hist[-1]['loss']:.3f} over {steps} steps")
    return hist


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device for layer B and the LM (default "
                         "cuda)")
    args = ap.parse_args(argv)
    layer_a()
    layer_b(args.device)
    tiny_training(args.device)
    print("quickstart OK")


if __name__ == "__main__":
    main()
