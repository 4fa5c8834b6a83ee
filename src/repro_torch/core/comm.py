"""CommPolicy: the gradient-bucket sizing the reference's sync uses.

A copy of the fields of ``repro.core.comm.CommPolicy`` and of its
``bucket_bytes`` rule, kept here so that the port imports nothing of the
JAX package. The reference derives its alpha and beta from its TPU machine
model (``TpuMachine.alpha_beta(INTRA)`` is ``(alpha_s, ici_bw)``); the
constants below are those of the reference's v5e model (``roofline/hw.py``:
50 GB/s per ICI link), kept so that the port cuts gradients into the same
buckets as the reference: the compressed sync takes one scale per shard of
each bucket, so its results depend on where the bucket boundaries fall.
The planner methods (``plan_bucket``, the crossovers) wait for the port's
copies of ``core/machine`` and ``core/planner`` (ROADMAP.md queue 1 item 10).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CommPolicy:
    #: per-collective launch/latency cost (alpha) in seconds
    alpha_s: float = 2e-6
    #: cross-pod alpha
    alpha_pod_s: float = 5e-5
    #: per-link bandwidth (beta) of the fast axis, bytes/s
    ici_bw: float = 50e9
    #: cross-pod per-device bandwidth, bytes/s
    dcn_bw: float = 6.25e9
    #: bucket target: amortize alpha to <2% of wire time
    alpha_amortization: float = 0.02

    def bucket_bytes(self, p: int) -> int:
        """Gradient bucket size so the 2(p-1) alpha terms cost <=2% of wire
        time (``repro.core.comm.CommPolicy.bucket_bytes``)."""
        alpha, bw = self.alpha_s, self.ici_bw
        alpha_total = 2 * (p - 1) * alpha
        wire_per_byte = 2 * (p - 1) / p / bw
        return int(alpha_total / self.alpha_amortization / wire_per_byte)
