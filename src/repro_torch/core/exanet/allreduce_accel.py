"""Model of the NI-resident MPI_Allreduce accelerator (§4.7, §6.1.5).

Algorithm (Fig. 10): for N ranks (1 rank/MPSoC, whole QFDBs, N multiple of 4):

* Level 0: every *client* module (non-network FPGAs) DMA-fetches its vector
  and sends it to the QFDB's *server* module (network FPGA), which reduces
  the 4 local vectors.
* Levels 1..log2(N)-1: server modules pairwise exchange partial vectors over
  inter-QFDB links (recursive doubling over QFDBs: log2(N/4) levels) and
  reduce.
* Final level: servers broadcast to their clients; clients DMA the reduced
  vector to memory and notify software.

The engine is triggered once per 256 B block (the max ExaNet cell payload);
latency therefore scales ~linearly in ceil(size/256) (§6.1.5: 6.79 us ->
13.38 us -> 26.11 us for 256/512/1024 B at 16 ranks). Above 4 KB the
accelerator is not profitable and ExaNet-MPI falls back to software.

The port's copy of the reference's ``repro.core.exanet.allreduce_accel``,
whole: the same names, layout and float arithmetic, with its imports
rewritten to ``repro_torch`` (``tests/test_torch_planner.py`` holds the two
equal).
"""

from __future__ import annotations

import math

from repro_torch.core.exanet.params import DEFAULT, HwParams
from repro_torch.core.exanet.schedules import HierarchicalAccelAllreduce


def accel_rank_applicable(nranks: int, params: HwParams = DEFAULT) -> bool:
    """The *hardware* envelope of §4.7: <=1024 ranks, one rank per FPGA,
    whole QFDBs (multiples of 4).  The engine itself is per-256B-block, so
    vector size is not a hardware constraint — the historical 4 KB cap in
    :func:`accel_applicable` is the runtime's profitability fallback, which
    the CollectivePlanner re-derives from cost (DESIGN.md §3.5)."""
    return nranks % 4 == 0 and 4 <= nranks <= params.ar_accel_max_ranks


def accel_applicable(size: int, nranks: int, params: HwParams = DEFAULT) -> bool:
    """§4.7 constraints: sum/min/max over int/float/double, <=1024 ranks,
    one rank per FPGA, whole QFDBs (multiples of 4), plus the runtime's
    4 KB profitability fallback (see :func:`accel_rank_applicable`)."""
    return (accel_rank_applicable(nranks, params)
            and size <= params.ar_accel_max_vector_bytes)


def accel_server_levels(nranks: int) -> int:
    """Inter-QFDB server-exchange levels, counted from the first-class
    schedule (Fig. 10 structure) rather than a closed-form log."""
    sched = HierarchicalAccelAllreduce()
    return sum(1 for r in sched.rounds(nranks, 1)
               if r.label == "server_exchange")


def accel_cost_us(size: int, nranks: int, params: HwParams = DEFAULT) -> float:
    """Ungated per-block cost model of the accelerated allreduce (us).

    Per 256 B block: fixed cost (software programming of the modules +
    level-0 client fetch/send + final broadcast + completion notification +
    software poll-out, calibrated 4.91 us) + one inter-QFDB server-exchange
    level per recursive-doubling step over QFDBs (0.94 us/level, one per
    ``server_exchange`` round of the schedule).  Valid at any vector size
    within the rank envelope — the planner compares it against simulated
    software cost to place the Fig. 19 crossover.
    """
    if not accel_rank_applicable(nranks, params):
        raise ValueError(f"accelerator rank envelope violated: N={nranks}")
    blocks = max(1, math.ceil(size / params.ar_accel_block_bytes))
    per_block = params.ar_accel_fixed_us + \
        accel_server_levels(nranks) * params.ar_accel_level_us
    return blocks * per_block


def accel_allreduce_latency(size: int, nranks: int,
                            params: HwParams = DEFAULT) -> float:
    """Latency (us) of the accelerated allreduce, gated by the historical
    runtime applicability rule (see :func:`accel_cost_us` for the model)."""
    if not accel_applicable(size, nranks, params):
        raise ValueError(f"accelerator not applicable: size={size} N={nranks}")
    return accel_cost_us(size, nranks, params)
