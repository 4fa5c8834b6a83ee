"""The paper's Allreduce accelerator (section 4.7), all three incarnations:

1. the latency MODEL (Layer A) reproducing Fig. 19;
2. the ``combine`` KERNEL (the NI's reduction arithmetic) held against its
   plain version: the CUDA kernel on a cuda device, the plain version alone
   on the CPU;
3. the hierarchical collective SCHEDULE (Layer B) with its cross-pod
   traffic reduction napkin math.

Counterpart of the reference's ``examples/allreduce_accel_demo.py``.

Run: PYTHONPATH=src python -m repro_torch.examples.allreduce_accel_demo
[--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.device import resolve_device


def model_fig19() -> None:
    from repro_torch.core.exanet import ExanetMPI
    from repro_torch.core.exanet.allreduce_accel import \
        accel_allreduce_latency
    mpi = ExanetMPI(ranks_per_mpsoc=1)
    print("ranks  size   software(us)  accelerator(us)  improvement")
    for n in (16, 32, 64, 128):
        sw = mpi.allreduce_sw(256, n)
        hw = accel_allreduce_latency(256, n)
        print(f"{n:5d}  256B  {sw:11.2f}  {hw:14.2f}  {100*(1-hw/sw):9.1f}%")


def schedule_structure() -> None:
    """The section 4.7 accelerator as a first-class schedule (Fig. 10
    rounds)."""
    from collections import Counter

    from repro_torch.core.exanet.schedules import HierarchicalAccelAllreduce
    sched = HierarchicalAccelAllreduce()
    counts = Counter(r.label for r in sched.rounds(64, 256))
    print(f"[schedule] 64-rank accel rounds: {dict(counts)} "
          f"(1 client gather + log2(16 QFDBs) server levels + 1 broadcast)")


def schedule_alternatives() -> None:
    """Ring / Rabenseifner vs the MPICH recursive doubling the paper ran."""
    from repro_torch.core.exanet import ExanetMPI
    mpi = ExanetMPI()
    size, n = 1 << 20, 64
    rd = mpi.allreduce(size, n, "recursive_doubling")
    print(f"[schedules] 1MB/64-rank allreduce: recursive_doubling={rd:.0f}us"
          + "".join(f", {a}={mpi.allreduce(size, n, a):.0f}us"
                    for a in ("ring", "rabenseifner")))


def kernel_combine(device=None) -> float:
    """``combine_parts`` on 4 seeded parts of 8192 against ``combine_ref``:
    the CUDA kernel on a cuda device; on the CPU both are the plain
    version, and the line says so. Returns the largest difference."""
    from repro_torch.kernels.allreduce_combine.ops import combine_parts
    from repro_torch.kernels.allreduce_combine.ref import combine_ref
    dev = resolve_device(device)
    parts = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 8192)).astype(np.float32)).to(dev)
    out = combine_parts(parts, op="sum")
    ref = combine_ref(parts, op="sum")
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-6)
    if dev.type == "cuda":
        print("[kernel] CUDA combine (4 parts x 8192) == plain version  OK")
    else:
        print("[kernel] combine (4 parts x 8192) on the CPU: the plain "
              "version only, the CUDA kernel not checked  OK")
    return float((out - ref).abs().max())


def schedule_napkin() -> None:
    from repro_torch.core.collectives import hierarchical_collective_bytes
    hb = hierarchical_collective_bytes(64 << 20, intra=16, inter=2)
    print(f"[schedule] 64MB gradient, 2 pods x 16: cross-pod bytes/chip "
          f"{hb['flat']['inter']/2**20:.1f}MB (flat) -> "
          f"{hb['hier']['inter']/2**20:.2f}MB (hierarchical), "
          f"{hb['inter_reduction']:.0f}x less — the QFDB-accelerator "
          f"decomposition at pod scale")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device for the combine check (default cuda)")
    args = ap.parse_args(argv)
    model_fig19()
    schedule_structure()
    schedule_alternatives()
    kernel_combine(args.device)
    schedule_napkin()
    print("allreduce_accel_demo OK")


if __name__ == "__main__":
    main()
