"""CommPolicy: message-size-aware collective strategy selection.

The ExaNet-MPI runtime switches transports at 32 B: packetizer/mailbox
(latency-optimal, "eager") below, RDMA rendez-vous (bandwidth-optimal)
above (§5.2.1). The transferable idea is an alpha-beta crossover: pick the
algorithm by comparing startup-dominated vs wire-dominated cost.

On TPU the same split appears in gradient synchronization:
* tiny tensors (norm scales, biases) -> fuse into one bucket, single
  all-reduce (the "eager" path: pay alpha once);
* bulk tensors -> reduce-scatter + all-gather pipeline, hierarchical across
  pods (the "rendez-vous" path: pay bandwidth, hide alpha).

Since the MachineModel/CollectivePlanner split (DESIGN.md §3.5) this class
is a thin facade: its alpha/beta knobs instantiate a
:class:`repro_torch.core.machine.TpuMachine`, its crossovers come from
:mod:`repro_torch.core.planner` cost functions over that machine, and its
:attr:`planner` is what ``grad_sync``'s ``strategy="auto"`` consults per
bucket. The closed-form numbers are unchanged; they just live in one place.

The port's copy of the reference's ``repro.core.comm``, whole. Its knobs
default to the reference's TPU v5e model constants (:data:`V5E`), not to
readings of the card the port runs on: with them the port cuts gradients
into the reference's buckets (the compressed sync takes one scale per shard
of each bucket, so its results depend on where the boundaries fall) and
plans each bucket as the reference does. ``tests/test_torch_planner.py``
holds the two equal.
"""

from __future__ import annotations

import dataclasses
import functools

from repro_torch.core.machine import INTRA, TpuMachine
from repro_torch.core.planner import (CollectivePlanner, Plan,
                                      crossover_bytes, oneshot_cost_s,
                                      ring_cost_s)
from repro_torch.roofline.hw import V5E


@dataclasses.dataclass(frozen=True)
class CommPolicy:
    #: per-collective launch/latency cost (alpha) in seconds; ICI hop-scale
    alpha_s: float = 2e-6
    #: cross-pod (DCN) alpha is orders of magnitude worse
    alpha_pod_s: float = 5e-5
    #: ICI per-link bandwidth (beta), bytes/s
    ici_bw: float = V5E.ici_link_bw
    #: cross-pod per-chip bandwidth, bytes/s
    dcn_bw: float = V5E.dcn_bw
    #: bucket target: amortize alpha to <2% of wire time
    alpha_amortization: float = 0.02

    @functools.cached_property
    def machine(self) -> TpuMachine:
        """The machine model these knobs describe (the planner's backend)."""
        return TpuMachine(alpha_s=self.alpha_s, alpha_pod_s=self.alpha_pod_s,
                          ici_bw=self.ici_bw, dcn_bw=self.dcn_bw)

    @functools.cached_property
    def planner(self) -> CollectivePlanner:
        """Cost-driven schedule selection over :attr:`machine`; consulted by
        ``grad_sync``'s ``strategy="auto"``."""
        return CollectivePlanner(self.machine, fidelity="analytic")

    def ring_allreduce_s(self, n_bytes: int, p: int, bw: float,
                         alpha: float) -> float:
        return ring_cost_s(n_bytes, p, bw, alpha)

    def schedule_allreduce_s(self, n_bytes: int, p: int, bw: float,
                             alpha: float, *, algo: str = "ring") -> float:
        """Alpha-beta cost of an allreduce derived from the *schedule* that
        the ExaNet event engine executes
        (repro_torch.core.exanet.schedules), not from a hand-written
        closed form.  For ``algo="ring"`` this coincides
        with :meth:`ring_allreduce_s` whenever ``p`` divides ``n_bytes``;
        ``"rabenseifner"`` and ``"recursive_doubling"`` come for free but
        require power-of-two ``p`` (ValueError otherwise)."""
        from repro_torch.core.exanet.schedules import (
            ALLREDUCE_SCHEDULES, alpha_beta_cost_s)
        if p <= 1:
            return 0.0
        sched = ALLREDUCE_SCHEDULES[algo]()
        return alpha_beta_cost_s(sched, p, n_bytes, alpha_s=alpha,
                                 bw_bytes_per_s=bw)

    def oneshot_allreduce_s(self, n_bytes: int, p: int, bw: float,
                            alpha: float) -> float:
        """all-gather everything + local reduce: 1 phase, alpha-cheap,
        bandwidth-expensive (the packetizer analog)."""
        return oneshot_cost_s(n_bytes, p, bw, alpha)

    def eager_threshold_bytes(self, p: int, *, bw: float | None = None,
                              alpha: float | None = None) -> int:
        """Crossover size below which the one-shot schedule wins — the
        TPU re-derivation of the paper's 32 B eager threshold (bisected by
        :func:`repro_torch.core.planner.crossover_bytes` over the machine's
        one-shot/ring cost pair)."""
        bw = bw or self.ici_bw
        alpha = alpha or self.alpha_s
        return crossover_bytes(
            lambda n: oneshot_cost_s(n, p, bw, alpha),
            lambda n: ring_cost_s(n, p, bw, alpha))

    def bucket_bytes(self, p: int) -> int:
        """Gradient bucket size so the 2(p-1) alpha terms cost <=2% of wire
        time (the cell/bucket adaptation of §4.2's small-MTU trade-off)."""
        alpha, bw = self.machine.alpha_beta(INTRA)
        alpha_total = 2 * (p - 1) * alpha
        wire_per_byte = 2 * (p - 1) / p / bw
        return int(alpha_total / self.alpha_amortization / wire_per_byte)

    def choose(self, n_bytes: int, p: int) -> str:
        return ("eager" if n_bytes <= self.eager_threshold_bytes(p)
                else "rendezvous")

    def plan_bucket(self, n_bytes: int, intra: int, inter: int = 1,
                    *, allow_lossy: bool = False) -> Plan:
        """Planner-chosen gradient-sync strategy for one bucket (the
        ``strategy="auto"`` entry point of ``parallel/grad_sync``).
        ``allow_lossy=False`` restricts the candidates to exact syncs."""
        return self.planner.plan("grad_sync", n_bytes, (intra, inter),
                                 allow_lossy=allow_lossy)
