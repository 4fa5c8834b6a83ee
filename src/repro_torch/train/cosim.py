"""Overlap-aware train-step co-simulation (ROADMAP item 5; DESIGN.md §2.9).

Closes the loop from model configs to simulated training step time: the
compute side comes from the roofline stack (synthetic train HLO through
the while-rollup cost model, cross-anchored by the closed form), the
communication side is *executed* — per-rank forward/backward ``Compute``
ops interleaved with bucketed nonblocking gradient ``Collective``\\ s, so
backward/sync overlap is emergent from the event engine
(``Collective(handle=...)`` + ``Wait``, the seam of
:class:`repro_torch.core.program.ProgramExecutor`), never a closed-form
assumption.  The same emission runs on both machines:
:class:`~repro_torch.core.machine.ExanetMachine` at sim fidelity (contention
included) and :class:`~repro_torch.core.machine.TpuMachine` through the
analytic hooks of the shared scheduler.

The fast path mirrors :mod:`repro_torch.serve.sim`: a *candidate family* —
same (bucket count, algorithm, overlap depth), hence the same Program
structure — binds every member's bucket layout as one batch column of
ONE compiled replay (per-site payload scale for the bucket bytes,
per-compute-slot scale for the backward slices that produce them), so
the planner's hillclimb (:meth:`repro_torch.core.planner.CollectivePlanner.
plan_train_sync`) evaluates whole populations per
:meth:`~repro_torch.core.exanet.mpi.ExanetMPI.run_program_scenarios` call
instead of re-binding per candidate.  Candidates always carry explicit
algorithms (never ``"auto"``): per-column payloads must not be able to
flip the probe tape's schedule resolution.

Step emission (per rank, identical across ranks)::

    Compute(fwd)
    for bucket i in 0..k-1:
        Compute(bwd * frac_i)
        Collective(allreduce, grad_bytes * frac_i, algo[, handle=g_i])
        Wait((g_{i-depth},))          # overlap_depth > 0 only
    Wait()                            # drain outstanding syncs
    Compute(opt)

``overlap_depth = 0`` emits blocking collectives — exactly the PR-4
``grad_sync.emit_sync_program`` pipeline the analytic ``CommPolicy``
baseline assumes.  Depth ``d`` lets ``d`` syncs ride behind backward
compute; the engine decides what actually overlaps.

The port's copy of the reference's ``repro.train.cosim``, whole: the same
names, layout and float arithmetic, with its imports rewritten to
``repro_torch``. ``tests/test_torch_train_cosim.py`` holds the two equal.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.program import Collective, Compute, Program, Wait

#: software allreduce candidates the grid defaults to: log-p round counts
#: stay compilable at 4096 ranks (ring's O(p) rounds and oneshot's O(p^2)
#: flows are excluded by default, not by ability)
DEFAULT_ALGOS = ("rabenseifner", "recursive_doubling")


@dataclasses.dataclass(frozen=True)
class TrainStepSpec:
    """One simulated data-parallel training deployment."""
    arch: str = "exanest-lm-100m"
    nranks: int = 512
    seq_len: int = 2048
    batch_per_rank: int = 1        #: sequences per rank per step
    microbatches: int = 1
    #: wire dtype of the gradient sync (bf16 buckets by default)
    grad_dtype_bytes: int = 2
    #: per-rank sustained training compute, GFLOP/s.  The default is an
    #: A53+NEON-class MPSoC node (the prototype's compute tier), which
    #: puts backward compute and gradient wire time in the same decade —
    #: the regime where overlap decisions actually move step time.  This
    #: is the knob that moves the compute/comm crossover.
    rank_gflops: float = 50.0
    bwd_fwd_ratio: float = 2.0     #: backward flops per forward flop
    opt_frac: float = 0.15         #: optimizer+misc as fraction of forward


@dataclasses.dataclass(frozen=True)
class SyncCandidate:
    """One gradient-sync configuration the planner can pick: bucket
    layout x collective algorithm x overlap depth.  ``split`` is the
    per-bucket fraction tuple (None = equal); members sharing
    ``family()`` share a Program structure and batch together."""
    n_buckets: int
    algo: str
    overlap_depth: int = 0
    split: tuple[float, ...] | None = None

    def __post_init__(self):
        if self.algo == "auto":
            raise ValueError(
                "co-sim candidates need explicit algorithms: per-column "
                "payload bindings must not be able to flip an algo='auto' "
                "schedule resolution recorded on the probe tape")
        if self.split is not None and len(self.split) != self.n_buckets:
            raise ValueError(f"{self.n_buckets} buckets but "
                             f"{len(self.split)} split fractions")

    def fractions(self) -> tuple[float, ...]:
        if self.split is None:
            return (1.0 / self.n_buckets,) * self.n_buckets
        tot = sum(self.split)
        return tuple(f / tot for f in self.split)

    def family(self) -> tuple:
        """Structure key: candidates with equal families emit
        structurally-identical Programs (depth saturates at the bucket
        count — deeper never changes the op sequence)."""
        return (self.n_buckets, self.algo,
                min(self.overlap_depth, self.n_buckets)
                if self.overlap_depth else 0)


class TrainSim:
    """Emit + cost train-step Programs for one :class:`TrainStepSpec`.

    The simulation instance (base prototype or scaled-torus twin) is
    resolved per rank count through the same
    :meth:`~repro_torch.core.machine.ExanetMachine._mpi_for` tier cache the
    planner and serve sweeps use.
    """

    def __init__(self, spec: TrainStepSpec, machine=None,
                 rank_compute_scale=None):
        from repro_torch.configs import get
        from repro_torch.roofline.analysis import lm_train_step_cost
        from repro_torch.roofline.hlo_cost import analyze_hlo, synth_train_hlo
        if spec.nranks & (spec.nranks - 1):
            raise ValueError("nranks must be a power of two for the "
                             f"log-p allreduce schedules; got {spec.nranks}")
        self.spec = spec
        # per-rank compute-time multipliers (slow/"hot" ranks, DESIGN.md
        # §2.10): every batched costing lane sees the stragglers, so
        # plan_train_sync replans *for* the degraded machine; the
        # single-candidate lanes stay healthy references
        self.rank_compute_scale = None
        if rank_compute_scale is not None:
            rcs = np.asarray(rank_compute_scale, dtype=np.float64)
            if rcs.shape != (spec.nranks,):
                raise ValueError(f"rank_compute_scale must be "
                                 f"({spec.nranks},); got {rcs.shape}")
            if (rcs != 1.0).any():
                self.rank_compute_scale = rcs
        self.cfg = get(spec.arch)
        if machine is None:
            from repro_torch.core.machine import ExanetMachine
            machine = ExanetMachine()
        self.machine = machine
        self.mpi = machine._mpi_for(spec.nranks)
        # compute side: the synthetic-HLO estimate is primary (same
        # while-rollup model real dry-run artifacts go through), the
        # closed form is the cross-anchor pinned by tests
        self.closed = lm_train_step_cost(
            self.cfg, seq_len=spec.seq_len, batch=spec.batch_per_rank,
            grad_dtype_bytes=spec.grad_dtype_bytes)
        self.hlo_cost = analyze_hlo(synth_train_hlo(
            self.cfg, seq_len=spec.seq_len, batch=spec.batch_per_rank,
            microbatches=spec.microbatches))
        rate = spec.rank_gflops * 1e3            # flops per microsecond
        self.fwd_us = self.hlo_cost["flops"] / rate
        self.bwd_us = spec.bwd_fwd_ratio * self.fwd_us
        self.opt_us = spec.opt_frac * self.fwd_us
        self.grad_bytes = int(self.closed["grad_bytes"])

    # ------------------------------------------------------------ emission
    def bucket_bytes(self, cand: SyncCandidate) -> tuple[int, ...]:
        return tuple(max(1, int(round(self.grad_bytes * f)))
                     for f in cand.fractions())

    def emit_step(self, cand: SyncCandidate) -> Program:
        """One training step as a Program (module docstring shape).
        Structure depends only on ``cand.family()``; payloads and
        backward slices move with the split, so same-family candidates
        bind as columns of one compiled artifact."""
        depth = cand.overlap_depth
        ops: list = [Compute(us=self.fwd_us)]
        fr = cand.fractions()
        for i, (f, nb) in enumerate(zip(fr, self.bucket_bytes(cand))):
            ops.append(Compute(us=self.bwd_us * f))
            if depth > 0:
                ops.append(Collective("allreduce", nb, cand.algo,
                                      handle=f"g{i}"))
                if i - depth >= 0:
                    ops.append(Wait((f"g{i - depth}",)))
            else:
                ops.append(Collective("allreduce", nb, cand.algo))
        if depth > 0:
            ops.append(Wait())
        ops.append(Compute(us=self.opt_us))
        return Program(tuple(tuple(ops) for _ in range(self.spec.nranks)))

    # ------------------------------------------------------------- costing
    def cost_candidates(self, cands, *, engine=None, check: int = 0,
                        rtol: float = 1e-9) -> np.ndarray:
        """Simulated step time (us) of every candidate: ONE batched
        scenario replay per structure family — per-site payload scale
        carries each member's bucket bytes, per-compute-slot scale the
        backward slice that produces each bucket.  ``check`` forwards to
        :meth:`~repro_torch.core.exanet.mpi.ExanetMPI.run_program_scenarios`
        (sampled columns re-run on the interpreter, <=rtol or raise)."""
        cands = list(cands)
        out = np.empty(len(cands))
        fams: dict[tuple, list[int]] = {}
        for i, c in enumerate(cands):
            fams.setdefault(c.family(), []).append(i)
        for (nb, algo, depth), idxs in fams.items():
            base_cand = SyncCandidate(nb, algo, depth)
            base = self.emit_step(base_cand)
            base_bytes = np.array(self.bucket_bytes(base_cand),
                                  dtype=np.float64)
            base_fr = np.array(base_cand.fractions())
            N = len(idxs)
            ss = np.empty((nb, N))
            pat = np.ones((nb + 2, N))      # [fwd, bwd_0..bwd_k-1, opt]
            for j, i in enumerate(idxs):
                ss[:, j] = (np.array(self.bucket_bytes(cands[i]),
                                     dtype=np.float64) / base_bytes)
                pat[1:nb + 1, j] = (np.array(cands[i].fractions())
                                    / base_fr)
            # compute slots are rank-major in program order and every
            # rank emits the same pattern: tile it across ranks
            cs = np.tile(pat, (self.spec.nranks, 1))
            if self.rank_compute_scale is not None:
                cs = cs * np.repeat(self.rank_compute_scale,
                                    nb + 2)[:, None]
            res = self.machine.cost_program_scenarios(
                base, compute_scale=cs, site_scale=ss, engine=engine,
                check=min(check, N), rtol=rtol)
            for j, i in enumerate(idxs):
                out[i] = res[j].latency_us
        return out

    def step_time_single(self, cand: SyncCandidate, *,
                         backend: str = "auto", engine=None) -> float:
        """The naive lane: emit and run this one candidate alone — what
        a per-candidate search pays per evaluation.  Same payloads as
        the batched column, so lane agreement is executor agreement."""
        return self.mpi.run_program(self.emit_step(cand), backend=backend,
                                    engine=engine).latency_us

    def step_time_analytic(self, cand: SyncCandidate, machine=None) -> float:
        """The same emission through a machine's analytic program walk
        (default: the TPU target, which has no event engine) — overlap
        still emerges because the analytic hooks run on the shared
        nonblocking-collective scheduler, in microseconds."""
        if machine is None:
            from repro_torch.core.machine import TpuMachine
            machine = TpuMachine()
        return machine.cost_program(self.emit_step(cand)) * 1e6

    def serialized_us(self, cand: SyncCandidate, *, engine=None) -> float:
        """No-overlap reference: the same buckets forced blocking."""
        return self.step_time_single(
            dataclasses.replace(cand, overlap_depth=0), engine=engine)

    def sync_tail_us(self, cand: SyncCandidate) -> float:
        """Simulated time of the LAST bucket's allreduce alone — with
        the compute totals, a critical-path lower bound: the final
        bucket cannot enter before every backward slice has run, and
        the optimizer cannot start before it exits."""
        nb = self.bucket_bytes(cand)[-1]
        prog = Program(tuple((Collective("allreduce", nb, cand.algo),)
                             for _ in range(self.spec.nranks)))
        return self.mpi.run_program(prog).latency_us

    def lower_bound_us(self, cand: SyncCandidate) -> float:
        return (self.fwd_us + self.bwd_us + self.opt_us
                + self.sync_tail_us(cand))

    # ------------------------------------------- planner candidate surface
    def feasible_algos(self, algos=DEFAULT_ALGOS) -> tuple[str, ...]:
        """Requested algos this machine supports at this rank count,
        plus the NI accelerator where the machine has one."""
        from repro_torch.core.exanet.schedules import ALLREDUCE_SCHEDULES
        p = self.spec.nranks
        out = [a for a in algos if self.machine.supports(
            ALLREDUCE_SCHEDULES[a](), p, self.grad_bytes)]
        try:
            from repro_torch.core.exanet.allreduce_accel import \
                accel_rank_applicable
            if accel_rank_applicable(p, getattr(self.machine, "params",
                                                None)):
                out.append("accel")
        except (ImportError, AttributeError, TypeError):
            pass
        return tuple(out)

    def candidate_grid(self, *, buckets=(1, 2, 4, 8, 16, 32),
                       algos=DEFAULT_ALGOS,
                       depths=(0, 1, 2)) -> list[SyncCandidate]:
        """Equal-split seed grid for the planner's hillclimb: bucket
        counts whose buckets stay at least one element per rank, every
        feasible algorithm, blocking plus small overlap depths."""
        nb_ok = [b for b in buckets
                 if self.grad_bytes // b >= self.spec.nranks]
        return [SyncCandidate(nb, a, d)
                for nb in (nb_ok or [1])
                for a in self.feasible_algos(algos)
                for d in depths if d <= nb]

    def mutate(self, cand: SyncCandidate, rng) -> SyncCandidate:
        """One hillclimb move: usually a same-family split perturbation
        (stays a batch column of the parent's artifact), sometimes a
        family hop (bucket count, algorithm, or overlap depth)."""
        r = rng.random()
        if r < 0.55:
            fr = np.array(cand.fractions())
            fr = fr * np.exp(rng.normal(0.0, 0.25, fr.shape))
            fr = np.maximum(fr / fr.sum(), 1e-3)
            return dataclasses.replace(
                cand, split=tuple(float(f) for f in fr / fr.sum()))
        if r < 0.75:
            nb = cand.n_buckets * 2 if rng.random() < 0.5 else \
                max(1, cand.n_buckets // 2)
            nb = min(nb, 64)
            if self.grad_bytes // nb < self.spec.nranks:
                nb = cand.n_buckets
            return SyncCandidate(nb, cand.algo,
                                 min(cand.overlap_depth, nb))
        if r < 0.9:
            algos = self.feasible_algos()
            return dataclasses.replace(
                cand, split=None,
                algo=algos[int(rng.integers(len(algos)))])
        return dataclasses.replace(
            cand, overlap_depth=int(rng.integers(0, 3)))

    def analytic_candidate(self) -> SyncCandidate:
        """What the pre-cosim stack picks: ``CommPolicy.bucket_bytes``
        sizes buckets by alpha amortization on THIS machine's
        (alpha, beta), the analytic planner picks the algorithm for
        that bucket size, and emission is the blocking PR-4 pipeline
        (``overlap_depth=0`` — the closed forms carry no overlap
        term).  This is the baseline the simulated plan flips against
        (``BENCH_train.json``)."""
        from repro_torch.core.comm import CommPolicy
        from repro_torch.core.machine import INTRA
        from repro_torch.core.planner import CollectivePlanner
        alpha, bw = self.machine.alpha_beta(INTRA)
        pol = CommPolicy(alpha_s=alpha, ici_bw=bw)
        per_bucket = max(self.spec.nranks, pol.bucket_bytes(self.spec.nranks))
        nb = max(1, min(64, math.ceil(self.grad_bytes / per_bucket)))
        plan = CollectivePlanner(self.machine, fidelity="analytic").plan(
            "allreduce", max(1, self.grad_bytes // nb), self.spec.nranks)
        algo = plan.schedule
        if algo not in self.feasible_algos() or algo.startswith("synth:"):
            # the grid carries only structurally-stable explicit algos;
            # fall back to the best of those by the same analytic plan
            feas = self.feasible_algos()
            costs = [(plan.cost_of(a), a) for a in feas
                     if plan.cost_of(a) is not None]
            algo = min(costs)[1] if costs else feas[0]
        return SyncCandidate(nb, algo, 0)
