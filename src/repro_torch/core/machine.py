"""MachineModel: the hardware half of the planner/machine split (DESIGN.md §3.5).

A *machine* answers two questions about a target system, and nothing else:

* :meth:`MachineModel.alpha_beta` — the (alpha seconds, beta bytes/s)
  linearization of one communication *level* (``"intra"`` = the fast axis:
  ICI links on TPU, intra-QFDB GTH links on the prototype; ``"inter"`` = the
  slow axis: cross-pod DCN, inter-QFDB SFP+ links);
* :meth:`MachineModel.cost_s` — predicted wall-clock seconds of one
  collective schedule at a chosen *fidelity* (``"analytic"`` closed-form
  alpha-beta, or ``"sim"`` full event simulation where available).

Machines never inspect a schedule's rounds themselves: analytic costs go
through :func:`repro_torch.core.exanet.schedules.alpha_beta_cost_s`,
simulated costs through the event executor (:meth:`ExanetMPI.run_schedule`).
The :class:`repro_torch.core.planner.CollectivePlanner` is the only caller
that ranks schedules; consumers (CommPolicy, grad_sync, ExanetMPI) talk to
the planner.

The reference has two implementations.  This copy holds one of them:

* :class:`TpuMachine` — the TPU v5e target, backed by ``roofline/hw.py``
  constants with per-axis (ICI vs DCN) alphas and bandwidths.  Its
  figures are the reference's model constants (:data:`V5E`), not readings
  of the card the port runs on: the port's planner prices the reference's
  mesh so that it picks, bucket for bucket, what the reference picks.

The reference's ``ExanetMachine`` (the ExaNeSt prototype seen through the
event engine) needs the MPI layer, the compiled executors and the event
engine of ``core/exanet``; it comes with the rest of ROADMAP.md queue 1
item 10.  Everything else here is the port's copy of the reference's
``repro.core.machine``, whole, with its imports rewritten to
``repro_torch`` (``tests/test_torch_planner.py`` holds the two equal).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Protocol, runtime_checkable

from repro_torch.core.exanet.schedules import (COLLECTIVE_SCHEDULES,
                                               CollectiveSchedule,
                                               alpha_beta_cost_s)
from repro_torch.roofline.hw import V5E

INTRA = "intra"
INTER = "inter"


def _analytic_coll_us(nranks: int, alpha_s: float, bw_bytes_per_s: float,
                      accel_params=None):
    """Closed-form cost hook for embedded program collectives: alpha-beta
    cost of the named schedule, or of the cheapest feasible candidate when
    ``algo="auto"`` (the analytic twin of the planner's choice).  The §4.7
    accelerator is already a closed form, so ``algo="accel"`` costs it
    directly when the machine has one (``accel_params``); machines
    without an NI accelerator reject it at either fidelity."""
    def _accel_us(nbytes: int):
        """Closed-form accel cost, or None when this machine has no NI
        accelerator / the rank envelope rules it out."""
        if accel_params is None:
            return None
        from repro_torch.core.exanet.allreduce_accel import (
            accel_cost_us, accel_rank_applicable)
        if not accel_rank_applicable(nranks, accel_params):
            return None
        return accel_cost_us(nbytes, nranks, accel_params)

    def cost_us(op: str, nbytes: int, algo: str) -> float:
        if op == "allreduce" and algo == "accel":
            accel = _accel_us(nbytes)
            if accel is None:
                raise ValueError("no NI allreduce accelerator on this "
                                 "machine (or rank count outside its "
                                 "envelope)")
            return accel
        algos = COLLECTIVE_SCHEDULES.get(op)
        if algos is None:
            raise ValueError(f"unknown collective op {op!r}; options: "
                             f"{sorted(COLLECTIVE_SCHEDULES)}")
        if algo == "auto":
            candidates = list(algos.values())
        else:
            if algo not in algos:
                raise ValueError(f"unknown {op} algo {algo!r}; options: "
                                 f"{sorted(algos) + ['auto']}")
            candidates = [algos[algo]]
        best = None
        for cls in candidates:
            sched = cls()
            if not _schedule_feasible(sched, nranks, nbytes):
                continue
            c = alpha_beta_cost_s(sched, nranks, nbytes, alpha_s=alpha_s,
                                  bw_bytes_per_s=bw_bytes_per_s)
            if best is None or c < best:
                best = c
        if op == "allreduce" and algo == "auto":
            # the analytic twin of the planner's choice considers the
            # §4.7 accelerator too (its closed form needs no alpha-beta)
            accel = _accel_us(nbytes)
            if accel is not None and (best is None or accel * 1e-6 < best):
                best = accel * 1e-6
        if best is None:
            raise ValueError(f"no feasible {op} schedule at "
                             f"nranks={nranks} nbytes={nbytes}")
        return best * 1e6
    return cost_us


def _schedule_feasible(schedule: CollectiveSchedule, nranks: int,
                       nbytes: int) -> bool:
    """A schedule is feasible when its round generator accepts the shape
    (power-of-two constraints, minimum rank counts, QFDB multiples)."""
    if nranks < 2:
        return False
    try:
        # every schedule validates its shape before the first yield, so one
        # round is enough — no need to materialize the whole round list
        next(iter(schedule.rounds(nranks, nbytes)), None)
    except (ValueError, AssertionError):
        return False
    return True


@runtime_checkable
class MachineModel(Protocol):
    """What the planner needs from a target system (and nothing more)."""
    name: str
    levels: tuple[str, ...]

    def alpha_beta(self, level: str = INTRA) -> tuple[float, float]:
        """(alpha seconds, beta bytes/s) of a communication level."""
        ...

    def supports(self, schedule: CollectiveSchedule, nranks: int,
                 nbytes: int) -> bool:
        """Can this machine run this schedule at this shape?"""
        ...

    def cost_s(self, schedule: CollectiveSchedule, nranks: int, nbytes: int,
               *, fidelity: str = "analytic", level: str | None = None
               ) -> float:
        """Predicted seconds for one execution of the schedule."""
        ...

    def cost_program(self, prog, *, fidelity: str = "analytic",
                     level: str | None = None,
                     backend: str = "auto") -> float:
        """Predicted seconds for one execution of a whole
        :class:`repro_torch.core.program.Program` (compute + point-to-point +
        embedded collectives, with whatever overlap the program
        expresses).  ``backend`` selects the sim-fidelity executor
        (``"auto"`` | ``"compiled"`` | ``"interp"``); machines without an
        event simulator ignore it."""
        ...

    def cost_program_many(self, progs, *, fidelity: str = "analytic",
                          level: str | None = None,
                          backend: str = "auto") -> list[float]:
        """Batched :meth:`cost_program` — the planner-facing surface the
        sweep consumers call; simulated machines batch
        structurally-identical programs through one compiled replay."""
        ...


@dataclasses.dataclass(frozen=True)
class TpuMachine:
    """TPU v5e mesh: closed-form alpha-beta per axis (roofline/hw.py).

    There is no event simulator for the TPU target, so both fidelities are
    analytic; ``fidelity="sim"`` silently degrades (the planner treats the
    knob as a *maximum* fidelity).
    """
    #: per-collective launch/latency cost over ICI, seconds
    alpha_s: float = 2e-6
    #: cross-pod (DCN) alpha is orders of magnitude worse
    alpha_pod_s: float = 5e-5
    #: ICI per-link bandwidth, bytes/s
    ici_bw: float = V5E.ici_link_bw
    #: cross-pod per-chip bandwidth, bytes/s
    dcn_bw: float = V5E.dcn_bw
    #: HBM bandwidth, bytes/s (costs the quantize/dequantize passes of the
    #: compressed gradient-sync candidate)
    hbm_bw: float = V5E.hbm_bw

    name: ClassVar[str] = "tpu-v5e"
    levels: ClassVar[tuple[str, ...]] = (INTRA, INTER)
    #: rank-placement key for the synthesized-schedule winner cache
    #: (DESIGN.md §2.8): the mesh has one placement
    placement: ClassVar[str] = "mesh"

    def alpha_beta(self, level: str = INTRA) -> tuple[float, float]:
        if level == INTER:
            return self.alpha_pod_s, self.dcn_bw
        return self.alpha_s, self.ici_bw

    def supports(self, schedule: CollectiveSchedule, nranks: int,
                 nbytes: int) -> bool:
        if schedule.name == "allreduce_accel":
            return False  # no NI-resident accelerator on the TPU target
        return _schedule_feasible(schedule, nranks, nbytes)

    def cost_s(self, schedule: CollectiveSchedule, nranks: int, nbytes: int,
               *, fidelity: str = "analytic", level: str | None = None
               ) -> float:
        if nranks < 2:
            return 0.0
        alpha, bw = self.alpha_beta(level or INTRA)
        return alpha_beta_cost_s(schedule, nranks, nbytes,
                                 alpha_s=alpha, bw_bytes_per_s=bw)

    def cost_many(self, schedule: CollectiveSchedule, nranks: int, sizes,
                  *, fidelity: str = "analytic", level: str | None = None,
                  engine=None) -> list[float]:
        """Batched :meth:`cost_s` over a message-size grid.  Closed forms
        have no shared work to amortize, so this is the plain loop — the
        method exists so the planner can batch uniformly across machines
        (``engine``, a scan-backend choice for *simulated* machines, has
        nothing to select here)."""
        return [self.cost_s(schedule, nranks, s, fidelity=fidelity,
                            level=level) for s in sizes]

    def cost_population(self, population, nranks: int, *,
                        fidelity: str = "analytic",
                        level: str | None = None,
                        engine=None) -> list[float]:
        """Per-member cost of a
        :class:`~repro_torch.core.exanet.schedule_algebra.SchedulePopulation`.
        Closed forms share no work across members, so this is the plain
        loop (the uniform search-facing surface; simulated machines
        batch it)."""
        return [self.cost_s(m, nranks, population.nbytes,
                            fidelity=fidelity, level=level)
                for m in population.members]

    def cost_program(self, prog, *, fidelity: str = "analytic",
                     level: str | None = None,
                     backend: str = "auto", engine=None) -> float:
        """Closed-form program time: the TPU target has no event
        simulator, so both fidelities are the contention-free alpha-beta
        walk of :func:`repro_torch.core.program.analytic_program_us` (and
        ``backend`` — an executor choice for *simulated* programs — has
        nothing to select)."""
        from repro_torch.core.program import analytic_program_us
        alpha, bw = self.alpha_beta(level or INTRA)
        res = analytic_program_us(
            prog, alpha_us=alpha * 1e6, bw_bytes_per_us=bw * 1e-6,
            coll_cost_us=_analytic_coll_us(prog.nranks, alpha, bw))
        return res.latency_us * 1e-6

    def cost_program_many(self, progs, *, fidelity: str = "analytic",
                          level: str | None = None,
                          backend: str = "auto",
                          engine=None) -> list[float]:
        """Batched :meth:`cost_program`: closed forms share no work, so
        this is the plain loop (uniform planner-facing surface)."""
        return [self.cost_program(p, fidelity=fidelity, level=level,
                                  backend=backend) for p in progs]

    def memory_pass_s(self, nbytes: int) -> float:
        """One streaming read+write pass over a buffer (HBM roundtrip)."""
        return 2.0 * nbytes / self.hbm_bw
