"""Collective communication schedules for the ExaNet engine.

A *schedule* is pure structure: it yields the communication :class:`Round`\\ s
of a collective — who sends how many bytes to whom at which step — without
knowing anything about link rates, R5 firmware or DMA engines.  The executor
(:meth:`repro.core.exanet.mpi.ExanetMPI.run_schedule`) replays the rounds on
the discrete-event engine, which supplies the hardware behaviour.  The split
is what makes new collectives ~10-line definitions (see
:class:`AllGather`, :class:`AllToAll`, :class:`Barrier`) instead of
hand-rolled event loops.

Provided schedules:

* :class:`BinomialBroadcast` — MPICH binomial tree (§5.2.1/§6.1.4).
* :class:`RecursiveDoublingAllreduce` — MPICH recursive doubling (§6.1.3).
* :class:`RingAllreduce` — bandwidth-optimal ring (reduce-scatter ring +
  all-gather ring, 2(N-1) rounds of size/N chunks).
* :class:`RabenseifnerAllreduce` — recursive-halving reduce-scatter +
  recursive-doubling all-gather (bandwidth-optimal in log N rounds).
* :class:`OneShotAllreduce` — single-round all-gather + local reduce (the
  "eager"/packetizer analog: one alpha, bandwidth-expensive).
* :class:`HierarchicalAccelAllreduce` — the §4.7 NI-accelerator schedule
  (intra-QFDB client gather, inter-QFDB server recursive doubling,
  intra-QFDB broadcast) as a first-class schedule.
* :class:`AllGather`, :class:`AllToAll`, :class:`Barrier`,
  :class:`ScatterBinomial`, :class:`GatherBinomial` — the collectives the
  schedule/executor split unlocks for free.

Schedules also admit a hardware-free **alpha-beta cost**
(:func:`alpha_beta_cost_s`), which is how
:class:`repro_torch.core.comm.CommPolicy` derives its crossover sizes from
the very same round structure.

The port's copy of the reference's ``repro.core.exanet.schedules``, whole:
the same names, layout and float arithmetic, with its imports rewritten to
``repro_torch`` (``tests/test_torch_planner.py`` holds the two equal).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Protocol, runtime_checkable

#: one send: (src_rank, dst_rank, nbytes)
SendOp = tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class Round:
    """One synchronization-free batch of sends.

    ``exchange=True`` gives MPI_Sendrecv semantics: every participant waits
    for both its outgoing send to return and its incoming payload to arrive
    (plus the rendez-vous end-to-end-ACK R5 charge) before the round's local
    reduction of ``reduce_bytes`` bytes.  ``exchange=False`` is a one-way
    relay (broadcast/scatter trees).  ``sync`` adds the per-step skew noise
    stand-in of §6.1.4 after the round.
    """
    step: int
    sends: tuple[SendOp, ...]
    exchange: bool = False
    reduce_bytes: int = 0
    sync: bool = False
    label: str = ""


@runtime_checkable
class CollectiveSchedule(Protocol):
    """Structure of a collective: rounds + endpoint copy costs."""
    name: str
    #: sends use the one-way (blocking-send -> recv) latency model
    one_way: bool

    def rounds(self, nranks: int, nbytes: int) -> Iterator[Round]: ...

    def pre_copy_bytes(self, nbytes: int) -> int: ...

    def post_copy_bytes(self, nbytes: int) -> int: ...


class Schedule:
    """Base: no endpoint copies, sendrecv (ping-pong) latency model."""
    name = "schedule"
    one_way = False

    def pre_copy_bytes(self, nbytes: int) -> int:
        return 0

    def post_copy_bytes(self, nbytes: int) -> int:
        return 0

    def rounds(self, nranks: int, nbytes: int) -> Iterator[Round]:
        raise NotImplementedError


def _pow2_check(nranks: int) -> None:
    if nranks < 2 or nranks & (nranks - 1):
        raise ValueError(f"schedule requires power-of-two ranks >= 2 "
                         f"(as in §6.1.4), got {nranks}")


class _CopyInOut(Schedule):
    """Allreduce-style endpoint behaviour: one memcpy in, one memcpy out."""

    def pre_copy_bytes(self, nbytes: int) -> int:
        return nbytes

    def post_copy_bytes(self, nbytes: int) -> int:
        return nbytes


# --------------------------------------------------------------- broadcast
class BinomialBroadcast(Schedule):
    """MPICH binomial tree: step distances N/2, N/4, ..., 1 (§6.1.4)."""
    name = "bcast_binomial"
    one_way = True

    def rounds(self, nranks: int, nbytes: int) -> Iterator[Round]:
        _pow2_check(nranks)
        step, d = 0, nranks // 2
        while d >= 1:
            sends = tuple((r, r + d, nbytes)
                          for r in range(0, nranks, 2 * d) if r + d < nranks)
            yield Round(step, sends, sync=True, label="bcast")
            step, d = step + 1, d // 2


# --------------------------------------------------------------- allreduce
class RecursiveDoublingAllreduce(_CopyInOut):
    """MPICH recursive doubling: log N full-size sendrecv+reduce rounds."""
    name = "allreduce_recursive_doubling"

    def rounds(self, nranks: int, nbytes: int) -> Iterator[Round]:
        _pow2_check(nranks)
        for step in range(nranks.bit_length() - 1):
            d = 1 << step
            sends = tuple((r, r ^ d, nbytes) for r in range(nranks))
            yield Round(step, sends, exchange=True, reduce_bytes=nbytes)


class RingAllreduce(_CopyInOut):
    """Bandwidth-optimal ring: N-1 reduce-scatter rounds + N-1 all-gather
    rounds, each moving a size/N chunk to the next rank."""
    name = "allreduce_ring"

    def rounds(self, nranks: int, nbytes: int) -> Iterator[Round]:
        assert nranks >= 2
        chunk = max(1, nbytes // nranks)
        sends = tuple((r, (r + 1) % nranks, chunk) for r in range(nranks))
        for step in range(nranks - 1):
            yield Round(step, sends, exchange=True, reduce_bytes=chunk,
                        label="reduce_scatter")
        for step in range(nranks - 1, 2 * (nranks - 1)):
            yield Round(step, sends, exchange=True, label="all_gather")


class RabenseifnerAllreduce(_CopyInOut):
    """Rabenseifner: recursive-halving reduce-scatter then recursive-doubling
    all-gather; bandwidth-optimal wire bytes in only 2 log N rounds."""
    name = "allreduce_rabenseifner"

    def rounds(self, nranks: int, nbytes: int) -> Iterator[Round]:
        _pow2_check(nranks)
        step, d = 0, nranks // 2
        while d >= 1:
            nb = max(1, nbytes * d // nranks)
            sends = tuple((r, r ^ d, nb) for r in range(nranks))
            yield Round(step, sends, exchange=True, reduce_bytes=nb,
                        label="reduce_scatter")
            step, d = step + 1, d // 2
        d = 1
        while d < nranks:
            nb = max(1, nbytes * d // nranks)
            sends = tuple((r, r ^ d, nb) for r in range(nranks))
            yield Round(step, sends, exchange=True, label="all_gather")
            step, d = step + 1, d * 2


class OneShotAllreduce(_CopyInOut):
    """One-shot allreduce: every rank sends its full vector to every other
    rank in a single round, then reduces the N-1 received vectors locally.
    Latency-optimal (one alpha), bandwidth-expensive ((N-1)x wire bytes per
    rank) — the collective analog of the paper's eager/packetizer transport
    (§5.2.1), and the schedule behind the derived eager threshold."""
    name = "allreduce_oneshot"

    def rounds(self, nranks: int, nbytes: int) -> Iterator[Round]:
        assert nranks >= 2
        sends = tuple((r, (r + k) % nranks, nbytes)
                      for r in range(nranks) for k in range(1, nranks))
        yield Round(0, sends, exchange=True,
                    reduce_bytes=(nranks - 1) * nbytes, label="oneshot")


class HierarchicalAccelAllreduce(Schedule):
    """The §4.7 NI-resident accelerator schedule (Fig. 10), per 256 B block:

    * level 0: the 3 client FPGAs of every QFDB push their vector to the
      QFDB's server FPGA (the Network MPSoC), which reduces the 4 inputs;
    * levels 1..log2(N/4): servers recursive-double over inter-QFDB links;
    * final level: servers broadcast the result back to their clients.

    Ranks are 1/MPSoC over whole QFDBs (``nranks`` a multiple of 4, §4.7).
    """
    name = "allreduce_accel"
    one_way = True
    ranks_per_qfdb = 4

    def rounds(self, nranks: int, nbytes: int) -> Iterator[Round]:
        q = self.ranks_per_qfdb
        assert nranks % q == 0 and nranks >= q
        n_qfdbs = nranks // q
        servers = [i * q for i in range(n_qfdbs)]
        up = tuple((s + c, s, nbytes) for s in servers for c in range(1, q))
        yield Round(0, up, reduce_bytes=nbytes, label="client_reduce")
        step = 1
        # recursive doubling runs over the largest power-of-two server
        # subset; surplus servers fold their partial in first and get the
        # result back with the final broadcast (MPICH-style pre-step).
        pow2 = 1 << (n_qfdbs.bit_length() - 1)
        if pow2 < n_qfdbs:
            fold = tuple((servers[i], servers[i - pow2], nbytes)
                         for i in range(pow2, n_qfdbs))
            yield Round(step, fold, reduce_bytes=nbytes, label="server_fold")
            step += 1
        d = 1
        while d < pow2:
            sends = tuple((servers[i], servers[i ^ d], nbytes)
                          for i in range(pow2))
            yield Round(step, sends, exchange=True, reduce_bytes=nbytes,
                        label="server_exchange")
            step, d = step + 1, d * 2
        if pow2 < n_qfdbs:
            unfold = tuple((servers[i - pow2], servers[i], nbytes)
                           for i in range(pow2, n_qfdbs))
            yield Round(step, unfold, label="server_unfold")
            step += 1
        down = tuple((s, s + c, nbytes) for s in servers for c in range(1, q))
        yield Round(step, down, label="client_broadcast")


# ------------------------------------------------- schedule-split dividends
class AllGather(Schedule):
    """Recursive doubling: at distance d every rank exchanges its
    accumulated d*nbytes block (nbytes = per-rank contribution)."""
    name = "allgather_recursive_doubling"

    def rounds(self, nranks: int, nbytes: int) -> Iterator[Round]:
        _pow2_check(nranks)
        step, d = 0, 1
        while d < nranks:
            sends = tuple((r, r ^ d, nbytes * d) for r in range(nranks))
            yield Round(step, sends, exchange=True)
            step, d = step + 1, d * 2


class AllToAll(Schedule):
    """XOR pairwise exchange: N-1 rounds, each rank trades its nbytes block
    with partner r^k."""
    name = "alltoall_pairwise"

    def rounds(self, nranks: int, nbytes: int) -> Iterator[Round]:
        _pow2_check(nranks)
        for k in range(1, nranks):
            sends = tuple((r, r ^ k, nbytes) for r in range(nranks))
            yield Round(k - 1, sends, exchange=True)


class Barrier(Schedule):
    """Dissemination barrier: ceil(log2 N) rounds of empty messages to
    (r + 2^i) mod N."""
    name = "barrier_dissemination"

    def rounds(self, nranks: int, nbytes: int = 0) -> Iterator[Round]:
        assert nranks >= 2
        step, d = 0, 1
        while d < nranks:
            sends = tuple((r, (r + d) % nranks, 0) for r in range(nranks))
            yield Round(step, sends, exchange=True)
            step, d = step + 1, d * 2


class ScatterBinomial(Schedule):
    """Binomial scatter from rank 0: holders forward the half of their block
    destined for the subtree at distance d (nbytes = per-rank payload)."""
    name = "scatter_binomial"
    one_way = True

    def rounds(self, nranks: int, nbytes: int) -> Iterator[Round]:
        _pow2_check(nranks)
        step, d = 0, nranks // 2
        while d >= 1:
            sends = tuple((r, r + d, nbytes * d)
                          for r in range(0, nranks, 2 * d))
            yield Round(step, sends, label="scatter")
            step, d = step + 1, d // 2


class GatherBinomial(Schedule):
    """Binomial gather to rank 0: mirror of scatter, distances 1, 2, ...,
    N/2 with growing blocks."""
    name = "gather_binomial"
    one_way = True

    def rounds(self, nranks: int, nbytes: int) -> Iterator[Round]:
        _pow2_check(nranks)
        step, d = 0, 1
        while d < nranks:
            sends = tuple((r + d, r, nbytes * d)
                          for r in range(0, nranks, 2 * d))
            yield Round(step, sends, label="gather")
            step, d = step + 1, d * 2


#: allreduce algorithm registry for the executor entry points
ALLREDUCE_SCHEDULES = {
    "recursive_doubling": RecursiveDoublingAllreduce,
    "ring": RingAllreduce,
    "rabenseifner": RabenseifnerAllreduce,
    "oneshot": OneShotAllreduce,
}

#: op -> {algo name -> schedule class} for embedded Program collectives
#: (first key of each op is its default algorithm; ``algo="auto"`` on a
#: non-allreduce op falls back to that default — the planner only ranks
#: allreduce candidates today)
COLLECTIVE_SCHEDULES: dict[str, dict[str, type]] = {
    "allreduce": ALLREDUCE_SCHEDULES,
    "bcast": {"binomial": BinomialBroadcast},
    "allgather": {"recursive_doubling": AllGather},
    "alltoall": {"pairwise": AllToAll},
    "barrier": {"dissemination": Barrier},
    "scatter": {"binomial": ScatterBinomial},
    "gather": {"binomial": GatherBinomial},
}


# --------------------------------------------------------- alpha-beta costs
def alpha_beta_cost_s(schedule: CollectiveSchedule, nranks: int, nbytes: int,
                      *, alpha_s: float, bw_bytes_per_s: float) -> float:
    """Hardware-free LogP-style cost of a schedule: every round costs one
    launch latency (alpha) plus the serialization of the busiest sender's
    outgoing bytes (beta * bytes).  For schedules where every rank sends at
    most once per round this is the classic max-single-send model; fan-out
    rounds (one-shot, the accelerator's client broadcast) charge the sum of
    each source's sends, since one NI serializes them.  This is the model
    :class:`repro_torch.core.comm.CommPolicy` and the planner's ``analytic``
    fidelity use to place eager/rendez-vous-style crossovers, derived from
    the same round structure the event engine executes."""
    t = 0.0
    for rnd in schedule.rounds(nranks, nbytes):
        if not rnd.sends:
            continue
        per_src: dict[int, int] = {}
        for (src, _, nb) in rnd.sends:
            per_src[src] = per_src.get(src, 0) + nb
        t += alpha_s + max(per_src.values()) / bw_bytes_per_s
    return t
