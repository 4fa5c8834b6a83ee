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

Two implementations:

* :class:`ExanetMachine` — the ExaNeSt prototype, backed by the event
  engine's :class:`PathMetrics` and the calibrated :class:`HwParams`.
* :class:`TpuMachine` — the TPU v5e target, backed by ``roofline/hw.py``
  constants with per-axis (ICI vs DCN) alphas and bandwidths.  Its
  figures are the reference's model constants (:data:`V5E`), not readings
  of the card the port runs on: the port's planner prices the reference's
  mesh so that it picks, bucket for bucket, what the reference picks.

The port's copy of the reference's ``repro.core.machine``, whole, with its
imports rewritten to ``repro_torch`` (``tests/test_torch_planner.py``
holds the two equal).
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


class ExanetMachine:
    """The ExaNeSt prototype, seen through the event engine.

    * ``fidelity="sim"`` replays the schedule on the discrete-event engine
      (R5/DMA/packetizer/link contention included) — the calibrated model
      the paper-validation tests pin.
    * ``fidelity="analytic"`` linearizes a rendez-vous sendrecv step from
      the engine's :class:`PathMetrics` of a representative path per level
      (alpha = handshake + R5 startup + endpoint software, beta = the
      path's single-stream RDMA bandwidth).

    The §4.7 accelerator schedule is costed by its calibrated per-block
    closed form at either fidelity: the event executor models *software*
    endpoints, which is exactly what the NI offload removes.
    """

    name = "exanest-prototype"
    levels = (INTRA, INTER)

    def __init__(self, mpi=None, params=None, faults=None):
        from repro_torch.core.exanet.mpi import ExanetMPI
        if mpi is None:
            from repro_torch.core.exanet.params import DEFAULT
            mpi = ExanetMPI(params or DEFAULT, ranks_per_mpsoc=1,
                            faults=faults)
        self.mpi = mpi
        self.params = mpi.p
        self.faults = mpi.faults
        if self.faults is not None:
            # degraded machines are first-class MachineModel variants: the
            # fault signature scopes every name-keyed cache (synthesized-
            # schedule winners, DESIGN.md §2.8) to this degradation
            self.name = f"exanest-prototype+{self.faults.signature()}"
        self._ab_cache: dict[str, tuple[float, float]] = {}
        self._tiers: dict[int, object] = {}
        self._degraded: dict = {}

    def degraded(self, spec) -> "ExanetMachine":
        """The machine variant operating under ``spec`` (a
        :class:`~repro_torch.core.exanet.faults.FaultSpec`), cached by fault
        signature: same params and placement, fault-aware routes, every
        latency constant carrying the static degradation.  The healthy
        spec returns ``self``."""
        if spec is None or spec.is_empty:
            return self
        cached = self._degraded.get(spec)
        if cached is None:
            from repro_torch.core.exanet.mpi import ExanetMPI
            cached = self._degraded[spec] = ExanetMachine(
                ExanetMPI(self.params, ranks_per_mpsoc=self.mpi._rpm,
                          faults=spec))
        return cached

    @property
    def placement(self) -> str:
        """Rank-placement key for the synthesized-schedule winner cache:
        QFDB-major 1/MPSoC (the §4.7 placement) vs block-packed cores."""
        return "mpsoc" if self.mpi._rpm == 1 else "block"

    def _mpi_for(self, nranks: int):
        """The simulation instance that fits ``nranks``: the calibrated
        prototype when the ranks fit its 512 cores, else a scaled twin
        (same per-component constants, larger mezzanine torus) built once
        per size tier — what lets the planner answer paper-scale
        (1024/4096+) queries the base machine cannot even route."""
        mpi = self.mpi
        if nranks < 2:
            return mpi
        needed = mpi.rank_core(nranks - 1) + 1
        if needed <= mpi.p.n_cores:
            return mpi
        from repro_torch.core.exanet.mpi import ExanetMPI
        from repro_torch.core.exanet.params import scaled_params
        p2 = scaled_params(needed, mpi.p)
        tier = self._tiers.get(p2.n_cores)
        if tier is None:
            tier = self._tiers[p2.n_cores] = ExanetMPI(
                p2, ranks_per_mpsoc=mpi._rpm, faults=mpi.faults)
        return tier

    def _level_alpha_beta(self, level: str) -> tuple[float, float]:
        p = self.params
        # representative single-hop paths: next MPSoC in the QFDB (intra),
        # first MPSoC of the next QFDB across a mezzanine link (inter)
        dst = p.cores_per_mpsoc if level == INTRA else \
            p.cores_per_mpsoc * p.fpgas_per_qfdb
        m = self.mpi.net.path_metrics(0, dst)
        alpha_us = m.handshake_pp_us + p.rdma_startup_us + \
            p.sendrecv_sw_rdv_us
        bw_bytes_per_s = m.rdma_bw_gbps * 1e9 / 8.0
        return alpha_us * 1e-6, bw_bytes_per_s

    def alpha_beta(self, level: str = INTRA) -> tuple[float, float]:
        ab = self._ab_cache.get(level)
        if ab is None:
            ab = self._ab_cache[level] = self._level_alpha_beta(level)
        return ab

    def _default_level(self, nranks: int) -> str:
        """Ranks are 1/MPSoC on this machine: beyond one QFDB the schedule
        crosses the slower inter-QFDB links."""
        return INTRA if nranks <= self.params.fpgas_per_qfdb else INTER

    def supports(self, schedule: CollectiveSchedule, nranks: int,
                 nbytes: int) -> bool:
        if schedule.name == "allreduce_accel":
            # only the hardware (rank) envelope gates the candidate: the
            # historical 4 KB vector cap is the profitability fallback the
            # planner re-derives from cost (Fig. 19 crossover)
            from repro_torch.core.exanet.allreduce_accel import \
                accel_rank_applicable
            return accel_rank_applicable(nranks, self.params)
        return _schedule_feasible(schedule, nranks, nbytes)

    def cost_s(self, schedule: CollectiveSchedule, nranks: int, nbytes: int,
               *, fidelity: str = "sim", level: str | None = None) -> float:
        if nranks < 2:
            return 0.0
        if schedule.name == "allreduce_accel":
            from repro_torch.core.exanet.allreduce_accel import accel_cost_us
            return accel_cost_us(nbytes, nranks, self.params) * 1e-6
        if fidelity == "sim":
            return self._mpi_for(nranks).run_schedule(
                schedule, nbytes, nranks).latency_us * 1e-6
        alpha, bw = self.alpha_beta(level or self._default_level(nranks))
        return alpha_beta_cost_s(schedule, nranks, nbytes,
                                 alpha_s=alpha, bw_bytes_per_s=bw)

    def cost_many(self, schedule: CollectiveSchedule, nranks: int, sizes,
                  *, fidelity: str = "sim", level: str | None = None,
                  engine=None) -> list[float]:
        """Batched :meth:`cost_s` over a message-size grid.  At ``sim``
        fidelity one compiled round program (the schedule lowered once for
        this rank count) serves the whole grid in a single vectorized
        replay — this is what cuts the planner's cold-plan cost from
        per-size event simulation to one batched run.  Serial-chain
        schedules the array executor cannot amortize (see
        ``round_parallelism``) stay on the interpreter.  ``engine``
        selects the replay's scan backend (DESIGN.md §2.5)."""
        sizes = list(sizes)
        if nranks < 2 or not sizes:
            return [0.0] * len(sizes)
        if schedule.name == "allreduce_accel" or fidelity != "sim":
            return [self.cost_s(schedule, nranks, s, fidelity=fidelity,
                                level=level) for s in sizes]
        from repro_torch.core.exanet.exec_compiled import ProgramStructureError
        mpi = self._mpi_for(nranks)
        try:
            if not mpi.compiled_profitable(schedule, nranks):
                raise ProgramStructureError("serial-chain schedule")
            res = mpi.run_schedule_many(schedule, sizes, nranks,
                                        engine=engine)
        except (ProgramStructureError, ValueError):
            # chain-bound, size-varying structure, or a tracing engine:
            # interpret per size
            return [self.cost_s(schedule, nranks, s, fidelity=fidelity,
                                level=level) for s in sizes]
        return [float(us) * 1e-6 for us in res.latency_us]

    def cost_population(self, population, nranks: int, *,
                        fidelity: str = "sim", level: str | None = None,
                        engine=None) -> list[float]:
        """Per-member simulated cost of a
        :class:`~repro_torch.core.exanet.schedule_algebra.SchedulePopulation`
        in ONE batched compiled replay (one batch column per member, one
        lowered program per skeleton x rank count) — the synthesis
        search's fitness call.  Populations whose skeleton the array
        executor cannot amortize fall back to interpreting each member,
        same gate as :meth:`cost_many`."""
        n_members = len(population)
        if nranks < 2 or not n_members:
            return [0.0] * n_members
        if fidelity != "sim":
            alpha, bw = self.alpha_beta(level
                                        or self._default_level(nranks))
            return [alpha_beta_cost_s(m, nranks, population.nbytes,
                                      alpha_s=alpha, bw_bytes_per_s=bw)
                    for m in population.members]
        from repro_torch.core.exanet.exec_compiled import ProgramStructureError
        mpi = self._mpi_for(nranks)
        try:
            if not mpi.compiled_profitable(population, nranks):
                raise ProgramStructureError("serial-chain population")
            res = mpi.run_schedule_population(population, nranks,
                                              engine=engine)
        except (ProgramStructureError, ValueError):
            return [mpi.run_schedule(m, population.nbytes,
                                     nranks).latency_us * 1e-6
                    for m in population.members]
        return [float(us) * 1e-6 for us in res.latency_us]

    def cost_program(self, prog, *, fidelity: str = "sim",
                     level: str | None = None,
                     backend: str = "auto", engine=None) -> float:
        """Program cost on the prototype.  ``fidelity="sim"`` executes the
        program on the event engine of the tier that fits its rank count
        (:meth:`ExanetMPI.run_program`: per-rank cores, contending
        point-to-point flows, embedded collectives at live occupancy) with
        the chosen executor ``backend`` — ``"auto"`` compiles paper-scale
        programs to vectorized level programs
        (:mod:`repro_torch.core.exanet.program_compiled`), which is what makes
        1024-4096-rank weak-scaling queries answerable; ``"analytic"`` is
        the contention-free alpha-beta walk — their gap *is* the
        congestion the retired apps ``alpha`` used to paper over."""
        nranks = prog.nranks
        if nranks < 1:
            return 0.0
        if fidelity == "sim":
            mpi = self._mpi_for(nranks)
            return mpi.run_program(prog, backend=backend,
                                   engine=engine).latency_us * 1e-6
        alpha, bw = self.alpha_beta(level or self._default_level(nranks))
        from repro_torch.core.program import analytic_program_us
        res = analytic_program_us(
            prog, alpha_us=alpha * 1e6, bw_bytes_per_us=bw * 1e-6,
            coll_cost_us=_analytic_coll_us(nranks, alpha, bw,
                                           accel_params=self.params))
        return res.latency_us * 1e-6

    def cost_program_many(self, progs, *, fidelity: str = "sim",
                          level: str | None = None,
                          backend: str = "auto",
                          engine=None) -> list[float]:
        """Batched :meth:`cost_program` over many programs.  At ``sim``
        fidelity, programs are grouped per machine tier and handed to
        :meth:`ExanetMPI.run_program_many`, where structurally-identical
        emissions (a weak/strong sweep at one rank count) become columns
        of a single compiled replay."""
        progs = list(progs)
        if fidelity != "sim":
            return [self.cost_program(p, fidelity=fidelity, level=level,
                                      backend=backend) for p in progs]
        out: list[float] = [0.0] * len(progs)
        tiers: dict[int, list[int]] = {}
        for i, p in enumerate(progs):
            if p.nranks < 1:
                continue
            tiers.setdefault(id(self._mpi_for(p.nranks)), []).append(i)
        for idxs in tiers.values():
            mpi = self._mpi_for(progs[idxs[0]].nranks)
            results = mpi.run_program_many([progs[i] for i in idxs],
                                           backend=backend, engine=engine)
            for i, r in zip(idxs, results):
                out[i] = r.latency_us * 1e-6
        return out

    def cost_program_scenarios(self, prog, *, compute_scale=None,
                               byte_scale=None, site_scale=None,
                               link_scale=None, link_latency_us=None,
                               t0=None, engine=None,
                               check: int = 0, rtol: float = 1e-9):
        """Batched scenario costing of ONE program: bind per-column
        compute skew / payload scale / collective payload scale / link
        degradation / entry clocks onto the compiled artifact of ``prog``
        and replay every column at once
        (:meth:`ExanetMPI.run_program_scenarios` on the tier that fits
        the rank count).  This is the machine-level fast lane the train
        co-sim's candidate populations, the serve step table and the
        Monte-Carlo fault sweeps ride; returns one
        :class:`~repro_torch.core.program.ProgramResult` per column."""
        return self._mpi_for(prog.nranks).run_program_scenarios(
            prog, compute_scale=compute_scale, byte_scale=byte_scale,
            site_scale=site_scale, link_scale=link_scale,
            link_latency_us=link_latency_us,
            t0=t0, engine=engine, check=check, rtol=rtol)

    def memory_pass_s(self, nbytes: int) -> float:
        """One read+write pass on an A53 endpoint (single DDR4 channel is
        the §6.2 bottleneck)."""
        return 2.0 * nbytes / (self.params.a53_copy_bw_bytes_per_us * 1e6)
