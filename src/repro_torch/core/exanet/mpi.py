"""ExaNet-MPI runtime model (§5.2.1) + OSU-style microbenchmarks (§6.1).

Point-to-point: eager (<=32 B) via packetizer/mailbox; rendez-vous otherwise
(RTS -> CTS -> RDMA write + concurrent completion notification).

Collectives are *schedules*
(:mod:`repro_torch.core.exanet.schedules`) replayed on
the discrete-event engine by :meth:`ExanetMPI.run_schedule`; the MPICH 3.2.1
algorithms the paper used (§5.2.1: binomial broadcast, recursive-doubling
allreduce) keep their historical entry points (:meth:`bcast`,
:meth:`allreduce_sw`) as thin wrappers, and the schedule split adds ring and
Rabenseifner allreduce, allgather, alltoall, barrier and scatter/gather at
no extra engine code.

Rank placement is block-packed (4 ranks/MPSoC fills cores first), matching
the §6.1.4 schedule decomposition: binomial step distance >=16 crosses a
QFDB ("mezzanine-class" step), >=4 crosses an MPSoC ("QFDB-class" step),
otherwise it is an intra-MPSoC step.

The port's copy of the reference's ``repro.core.exanet.mpi``, whole: the
same names, layout and float arithmetic, with its imports rewritten to
``repro_torch``. Its scan lanes are ``"numpy"`` and ``"torch"``
(:mod:`repro_torch.core.exanet.scan_engine`).
``tests/test_torch_exanet_sim.py`` and
``tests/test_torch_exanet_compiled.py`` hold the two equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.exanet import sim
from repro_torch.core.exanet.exec_compiled import (BatchScheduleResult,
                                                   ProgramStructureError,
                                                   compile_program,
                                                   round_parallelism)
from repro_torch.core.exanet.network import Network
from repro_torch.core.exanet.params import DEFAULT, HwParams
from repro_torch.core.exanet.schedules import (ALLREDUCE_SCHEDULES,
                                               COLLECTIVE_SCHEDULES, AllGather,
                                               AllToAll, Barrier,
                                               BinomialBroadcast,
                                               CollectiveSchedule,
                                               GatherBinomial,
                                               RecursiveDoublingAllreduce,
                                               ScatterBinomial)
from repro_torch.core.exanet.topology import Path, Topology


@dataclasses.dataclass
class BcastResult:
    observed_us: float
    expected_us: float      # Eq. 1 analytic model
    steps: dict[str, int]   # Ns_MPSoC / Ns_QFDB / Ns_mezzanine

    @property
    def deviation(self) -> float:
        """(observed - expected)/observed, the paper's §6.1.4 metric."""
        return (self.observed_us - self.expected_us) / self.observed_us


@dataclasses.dataclass
class ScheduleResult:
    """Outcome of one schedule execution on the event engine."""
    latency_us: float
    clocks: list[float]                       # per-rank completion times
    round_heads: list[tuple[int, int]]        # first (src, dst) per round

    @property
    def n_rounds(self) -> int:
        return len(self.round_heads)


class ExanetMPI:
    def __init__(self, params: HwParams = DEFAULT, *,
                 ranks_per_mpsoc: int | None = None, trace: bool = False,
                 cache: bool = True, faults=None):
        """``cache=False`` disables both the route cache and the engine's
        path table — the pre-refactor per-send ``route()`` behaviour, kept
        for the collectives_sweep speedup benchmark.  ``faults`` takes a
        :class:`repro_torch.core.exanet.faults.FaultSpec`: routes become
        fault-aware and every latency constant picks up the static
        degradation (DESIGN.md §2.10)."""
        self.p = params
        self.topo = Topology(params, faults=faults) if cache else \
            Topology(params, route_cache_size=0, faults=faults)
        self.net = Network(self.topo, params,
                           engine=sim.Engine(trace=trace, cache_paths=cache))
        self._rpm = ranks_per_mpsoc

    @property
    def faults(self):
        """The static :class:`FaultSpec` this machine instance carries
        (None when healthy)."""
        return self.topo.faults

    # --------------------------------------------------------- rank placement
    def rank_core(self, rank: int) -> int:
        """Block placement. With ranks_per_mpsoc=1 (accelerator comparisons,
        §6.1.5) each rank occupies core 0 of its own MPSoC."""
        if self._rpm == 1:
            return rank * self.p.cores_per_mpsoc
        return rank

    def _cores(self, nranks: int) -> list[int]:
        """Rank -> core map, cached per rank count."""
        cache = getattr(self, "_cores_cache", None)
        if cache is None:
            cache = self._cores_cache = {}
        cores = cache.get(nranks)
        if cores is None:
            cores = cache[nranks] = [self.rank_core(r) for r in range(nranks)]
        return cores

    def _r5s(self, nranks: int) -> list:
        """Rank -> R5 :class:`Resource` of its MPSoC, cached per rank count
        (rendez-vous exchange rounds charge the end-to-end ACK on it every
        collective; the engine zeroes occupancy in place on reset, so the
        objects stay valid across runs)."""
        cache = getattr(self, "_r5s_cache", None)
        if cache is None:
            cache = self._r5s_cache = {}
        r5s = cache.get(nranks)
        if r5s is None:
            engine = self.net.engine
            r5s = cache[nranks] = [
                engine.resource(sim.R5, self.topo.core_to_mpsoc(c))
                for c in self._cores(nranks)]
        return r5s

    def _rank_path(self, r0: int, r1: int | None) -> Path:
        """Route between two ranks; ``r1=None`` means the default
        intra-QFDB neighbour used by the OSU pair benchmarks."""
        if r1 is None:
            r1 = self.p.cores_per_mpsoc
        return self.topo.route(self.rank_core(r0), self.rank_core(r1))

    # ------------------------------------------------------- microbenchmarks
    def osu_latency(self, size: int, r0: int = 0, r1: int | None = None) -> float:
        """Half ping-pong latency (osu_latency)."""
        return self.net.mpi_latency(size, self._rank_path(r0, r1))

    def osu_one_way(self, size: int, r0: int, r1: int) -> float:
        return self.net.mpi_latency(size, self._rank_path(r0, r1),
                                    one_way=True)

    def osu_bw(self, size: int, r0: int = 0, r1: int | None = None) -> float:
        return self.net.osu_bw_gbps(size, self._rank_path(r0, r1))

    def osu_bibw(self, size: int, r0: int = 0, r1: int | None = None) -> float:
        return self.net.osu_bibw_gbps(size, self._rank_path(r0, r1))

    # ------------------------------------------------------ endpoint software
    def _copy_us(self, nbytes: int) -> float:
        """One A53 memcpy (buffer in / buffer out of the MPI runtime)."""
        if nbytes <= 0:
            return 0.0
        return nbytes / self.p.a53_copy_bw_bytes_per_us + \
            self.p.a53_call_overhead_us

    def _reduce_us(self, nbytes: int) -> float:
        """MPI_Reduce_local: read two operands + write one (3x traffic)."""
        if nbytes <= 0:
            return 0.0
        return 3.0 * nbytes / self.p.a53_copy_bw_bytes_per_us + \
            self.p.a53_call_overhead_us

    # --------------------------------------------------------- the executor
    #: ``backend="auto"`` compiles once the interpreter's per-send Python
    #: overhead dominates; below this rank count a single-size replay is
    #: cheaper interpreted (batched sweeps always compile).
    COMPILED_AUTO_MIN_RANKS = 512

    def run_schedule(self, sched: CollectiveSchedule, size: int,
                     nranks: int, *, backend: str = "auto",
                     t0: list[float] | None = None,
                     reset: bool = True) -> ScheduleResult:
        """Replay a schedule's rounds on the event engine.

        One-way rounds relay data down a tree (receiver clock = arrival,
        sender clock = send-engine return).  Exchange rounds have
        MPI_Sendrecv semantics: both directions must complete (plus the
        rendez-vous end-to-end-ACK R5 charge on each sender's MPSoC,
        §4.5.2) before the per-round software penalty and local reduction.

        ``backend`` selects the executor: ``"interp"`` (this method's
        per-send loop — the reference semantics), ``"compiled"`` (the
        vectorized round programs of
        :mod:`repro_torch.core.exanet.exec_compiled`, equal to ~1e-9), or
        ``"auto"`` (compiled at paper scale / for batched sweeps, where
        the interpreter is Python-bound; interpreted otherwise, and always
        when tracing is on — the compiled path records no trace).

        ``t0``/``reset`` serve *embedded* execution inside a program
        (:meth:`run_program`): ``t0`` gives per-rank entry clocks (the
        collective starts skewed, like real ranks arriving late) and
        ``reset=False`` keeps the engine's occupancy from in-flight
        point-to-point traffic.  ``reset=False`` runs always interpret —
        the compiled executor assumes zero starting occupancy — but a
        skewed fresh start (``t0`` with ``reset=True``) is exact on both
        backends: compiled replay seeds its clocks from ``t0`` over an
        all-zero :class:`ResourceState`, just like the interpreter after
        ``net.reset()``.
        """
        if backend not in ("auto", "interp", "compiled"):
            raise ValueError(f"unknown backend {backend!r}; "
                             f"options: ['auto', 'compiled', 'interp']")
        embedded = not reset
        if embedded and backend == "compiled":
            raise ValueError("compiled backend cannot start from nonzero "
                             "occupancy; use backend='interp'")
        auto = backend == "auto"
        if auto:
            backend = "compiled" if (
                not embedded
                and not self.net.engine.tracing
                and nranks >= self.COMPILED_AUTO_MIN_RANKS
                and self.compiled_profitable(sched, nranks)) else "interp"
        if backend == "compiled":
            try:
                t0c = None if t0 is None else \
                    np.asarray(t0, dtype=np.float64)[:, None]
                batch = self.run_schedule_many(sched, (size,), nranks,
                                               t0=t0c)
            except ProgramStructureError:
                if not auto:
                    raise
            else:
                return ScheduleResult(float(batch.latency_us[0]),
                                      [float(c) for c in batch.clocks[0]],
                                      batch.round_heads)
        p = self.p
        net = self.net
        send = net._send
        one_way = sched.one_way
        eager_max = p.mpi_eager_max_bytes
        r5_occ = p.r5_occupancy_us
        if reset:
            net.reset()
        cores = self._cores(nranks)
        r5s = None  # per-rank R5 resources, bound on first rdv round
        pre = self._copy_us(sched.pre_copy_bytes(size))
        clocks = [pre] * nranks if t0 is None else [t + pre for t in t0]
        # per-step sync skew (§6.1.4 noise stand-in) hits every rank equally,
        # so it is tracked as one running offset instead of N list writes;
        # ``clocks`` stores times relative to -skew.
        skew = 0.0
        round_heads: list[tuple[int, int]] = []
        for rnd in sched.rounds(nranks, size):
            sends = rnd.sends
            if not sends:
                continue
            round_heads.append(sends[0][:2])
            if rnd.exchange:
                arrivals = [0.0] * nranks
                done = [0.0] * nranks
                rdv = sends[0][2] > eager_max
                for (s, d, nb) in sends:
                    complete, sender_free = send(cores[s], cores[d], nb,
                                                 clocks[s] + skew, one_way)
                    if complete > arrivals[d]:
                        arrivals[d] = complete
                    # a rank sending twice in one round waits for both
                    # sends (max, not last-write-wins)
                    if sender_free > done[s]:
                        done[s] = sender_free
                if rdv:
                    # end-to-end ACK processing is a second R5 invocation on
                    # the sender's MPSoC (§4.5.2) and serializes with other
                    # channels.
                    if r5s is None:
                        r5s = self._r5s(nranks)
                    for (s, _, _) in sends:
                        done[s] = r5s[s].acquire(done[s], r5_occ) + r5_occ
                penalty = p.sendrecv_sw_rdv_us if rdv else \
                    p.sendrecv_sw_eager_us
                t_red = self._reduce_us(rnd.reduce_bytes)
                participants = {s for (s, _, _) in sends} | \
                    {d for (_, d, _) in sends}
                for r in participants:
                    clocks[r] = max(done[r], arrivals[r]) + penalty + t_red \
                        - skew
            else:
                for (s, d, nb) in sends:
                    complete, sender_free = send(cores[s], cores[d], nb,
                                                 clocks[s] + skew, one_way)
                    complete -= skew
                    if complete > clocks[d]:
                        clocks[d] = complete
                    clocks[s] = sender_free - skew
                if rnd.reduce_bytes:
                    t_red = self._reduce_us(rnd.reduce_bytes)
                    for d in {d for (_, d, _) in sends}:
                        clocks[d] += t_red
            if rnd.sync:
                # deterministic stand-in for per-step late-arrival noise
                # (§6.1.4)
                skew += p.step_sync_us
        total = max(clocks) + skew + \
            self._copy_us(sched.post_copy_bytes(size)) + p.barrier_exit_us
        return ScheduleResult(total, [c + skew for c in clocks], round_heads)

    # ------------------------------------------------- compiled batch runs
    #: minimum mean sends-per-level before ``auto`` / ``cost_many`` pick
    #: the compiled backend: below this a schedule's rounds are serial
    #: chains the array executor cannot amortize (see round_parallelism)
    COMPILED_MIN_PARALLELISM = 8.0

    @staticmethod
    def _schedule_cache_key(sched: CollectiveSchedule, nranks: int):
        """Cache key of a (schedule, nranks) pair, or None when the
        schedule must not share cached artifacts: the key is the
        schedule's ``program_key()`` when it defines one, else its *type*
        — but only for instances without per-instance state (every
        shipped schedule: their structure depends only on nranks).  Two
        differently-parameterized instances of one stateful class must
        not share a lowered program or a profitability verdict."""
        key_fn = getattr(sched, "program_key", None)
        if key_fn is not None:
            return (key_fn(), nranks)
        if not getattr(sched, "__dict__", True):
            return (type(sched), nranks)
        return None

    def compiled_profitable(self, sched: CollectiveSchedule,
                            nranks: int) -> bool:
        """Would the compiled backend beat the interpreter on this
        schedule shape?  Cached under the same keying rule as
        :meth:`compiled_program`."""
        cache = getattr(self, "_parallelism_cache", None)
        if cache is None:
            cache = self._parallelism_cache = {}
        key = self._schedule_cache_key(sched, nranks)
        par = None if key is None else cache.get(key)
        if par is None:
            par = round_parallelism(self.net, sched, self._cores(nranks),
                                    nranks)
            if key is not None:
                cache[key] = par
        return par >= self.COMPILED_MIN_PARALLELISM

    def compiled_program(self, sched: CollectiveSchedule, nranks: int):
        """The cached :class:`RoundProgram` of a (schedule, nranks) pair
        (see :meth:`_schedule_cache_key`; stateful schedules without a
        ``program_key`` compile fresh each call)."""
        cache = getattr(self, "_program_cache", None)
        if cache is None:
            cache = self._program_cache = {}
        key = self._schedule_cache_key(sched, nranks)
        prog = None if key is None else cache.get(key)
        if prog is None:
            prog = compile_program(self.net, sched, self._cores(nranks),
                                   nranks)
            if key is not None:
                cache[key] = prog
        return prog

    def run_schedule_many(self, sched: CollectiveSchedule, sizes,
                          nranks: int, *, t0=None,
                          engine=None) -> BatchScheduleResult:
        """Replay one compiled program over a whole message-size grid in a
        single batched run — the sweep workload (algorithm x size x scale,
        Figs. 14-19) that makes the compiled backend >=10x faster than
        interpreting each size.  Raises :class:`ProgramStructureError` if
        the schedule's round structure varies with size (no shipped
        schedule does).

        ``t0`` — optional (nranks, len(sizes)) per-rank entry clocks, one
        column per binding: repeating one size across columns turns the
        batch axis into a Monte-Carlo *arrival-offset* scenario axis (the
        compiled twin of ``run_schedule(t0=...)``, still from fresh
        occupancy).  ``engine`` selects the scan backend (``"numpy"``
        default | ``"torch"``; DESIGN.md §2.5)."""
        if self.net.engine.tracing:
            raise ValueError("compiled backend records no per-send trace; "
                             "use backend='interp' (or trace=False)")
        prog = self.compiled_program(sched, nranks)
        return prog.run(sched, sizes, t0=t0, engine=engine)

    def run_schedule_population(self, population, nranks: int, *,
                                engine=None) -> BatchScheduleResult:
        """Cost every member of a
        :class:`~repro_torch.core.exanet.schedule_algebra.SchedulePopulation`
        as one batched compiled replay — the synthesis-search fitness
        call (one column per candidate; DESIGN.md §2.8).

        The lowered program is cached by the population's *skeleton*
        (``program_key``), so successive generations of a search reuse
        one compilation; binding always bypasses the byte caches
        (``cache_bind=False``) because the member behind each batch
        token changes between generations."""
        if self.net.engine.tracing:
            raise ValueError("compiled backend records no per-send trace; "
                             "use backend='interp' (or trace=False)")
        prog = self.compiled_program(population, nranks)
        return prog.run(population, population.tokens(), engine=engine,
                        cache_bind=False)

    # ------------------------------------------------------ program execution
    #: ``run_program(backend="auto")`` compiles at and above this rank
    #: count: per-iteration replay of a lowered Program beats the
    #: interpreted heap scheduler once thousands of matches contend
    #: (below it, array dispatch overhead wins; the apps sweep records
    #: the crossover empirically in BENCH_apps.json)
    PROGRAM_COMPILED_AUTO_MIN_RANKS = 256

    def _resolve_collective_schedule(self, op: str, nbytes: int, algo: str,
                                     plans: dict) -> str:
        """The executor key an embedded ``Collective`` resolves to — one
        place, so the interpreter hook and the compiled splice
        (:mod:`repro_torch.core.exanet.program_compiled`) can never drift."""
        algos = COLLECTIVE_SCHEDULES.get(op)
        if algos is None:
            raise ValueError(f"unknown collective op {op!r}; options: "
                             f"{sorted(COLLECTIVE_SCHEDULES)}")
        name = algo
        if algo == "auto":
            plan = plans.get((op, int(nbytes)))
            # non-allreduce ops have a single shipped schedule each
            name = plan.schedule if plan is not None else next(iter(algos))
        if name != "accel" and name not in algos:
            if name.startswith("synth:"):
                from repro_torch.core.synth.search import registered
                if registered(name) is not None:
                    return name
            raise ValueError(f"unknown {op} algo {name!r}; options: "
                             f"{sorted(algos) + ['auto']}")
        return name

    def _schedule_instance(self, op: str, name: str) -> CollectiveSchedule:
        """Schedule object behind a resolved algorithm name: a menu class
        instantiation, or the synthesized-schedule registry for
        ``synth:<digest>`` names the planner's winner cache emits."""
        if name.startswith("synth:"):
            from repro_torch.core.synth.search import registered
            sched = registered(name)
            if sched is None:
                raise ValueError(
                    f"synthesized schedule {name!r} is not registered "
                    "(load its winner cache first)")
            return sched
        return COLLECTIVE_SCHEDULES[op][name]()

    def _program_hooks(self, nranks: int, plans: dict,
                       recorder=None) -> dict:
        """The event-engine cost hooks of :class:`ProgramExecutor` —
        shared by the interpreted backend and the compiled backend's
        recording probe (``recorder`` logs the scheduler's match/barrier
        firing order without touching the semantics)."""
        net = self.net
        cores = self._cores(nranks)
        core_res = [net.engine.resource(sim.CORE, c) for c in cores]

        def compute(rank: int, us: float, t: float) -> float:
            return core_res[rank].acquire(t, us) + us

        def p2p(src: int, dst: int, nbytes: int, tag: int,
                t_send: float, t_recv: float) -> tuple[float, float]:
            if recorder is not None:
                recorder.p2p(src, dst, tag)
            res = net.isend(cores[src], cores[dst], nbytes, t_send, t_recv)
            return res.t_send_done, res.t_recv_done

        def collective(op: str, nbytes: int, algo: str,
                       enters: list[float]) -> list[float]:
            n = len(enters)
            if n < 2:
                if recorder is not None:
                    recorder.coll(None)
                return list(enters)
            name = self._resolve_collective_schedule(op, nbytes, algo,
                                                     plans)
            if recorder is not None:
                recorder.coll(name)
            if name == "accel":
                from repro_torch.core.exanet.allreduce_accel import (
                    accel_cost_us)
                t = max(enters) + accel_cost_us(nbytes, n, self.p)
                return [t] * n
            res = self.run_schedule(self._schedule_instance(op, name),
                                    nbytes, n, backend="interp",
                                    t0=list(enters), reset=False)
            shift = res.latency_us - max(res.clocks)
            return [c + shift for c in res.clocks]

        return {"compute": compute, "p2p": p2p, "collective": collective}

    def _plan_program_sites(self, prog, plans: dict | None) -> dict:
        if plans is None and prog.nranks >= 2 and any(
                c.algo == "auto" and c.op == "allreduce"
                for c in prog.collectives()):
            plans = self.planner.plan_program(prog)
        return plans or {}

    def _program_splices_profitable(self, prog, plans: dict) -> bool:
        """Would every embedded collective site's compiled splice beat
        interpreting it?  Serial-chain schedules (the ring's ``r -> r+1``
        DMA coupling) degenerate to one send per level, where replaying
        thousands of one-send array steps is an order of magnitude
        *slower* than the interpreter — the same
        :meth:`compiled_profitable` gate ``run_schedule``'s auto backend
        applies, lifted to whole programs so ``run_program(backend=
        "auto")`` can never pick a losing executor."""
        if prog.nranks < 2:
            return True
        for c in prog.collectives():
            name = self._resolve_collective_schedule(c.op, c.nbytes,
                                                     c.algo, plans)
            if name == "accel":
                continue
            if not self.compiled_profitable(
                    self._schedule_instance(c.op, name), prog.nranks):
                return False
        return True

    def _program_auto_compiles(self, prog, plans: dict) -> bool:
        """The consolidated ``backend="auto"`` gate of
        :meth:`run_program` / :meth:`run_program_many`: compiled only
        when (a) tracing is off (the compiled path records no trace),
        (b) the program is at or above the rank floor
        (:data:`PROGRAM_COMPILED_AUTO_MIN_RANKS` — BENCH_apps records
        forced-compiled at 0.87x the interpreter for nranks=2 hpcg/weak,
        so below the floor auto must interpret), and (c) every embedded
        collective splice clears the sends-per-level parallelism floor
        (:meth:`_program_splices_profitable`).  One method, so the two
        entry points can never gate differently."""
        return (not self.net.engine.tracing
                and prog.nranks >= self.PROGRAM_COMPILED_AUTO_MIN_RANKS
                and self._program_splices_profitable(prog, plans))

    def program_artifact(self, prog):
        """The cached compiled artifact of a Program *structure*
        (:meth:`repro_torch.core.program.Program.structure_key`): payload data
        — byte sizes, compute microseconds — binds per column, so two
        differently-parameterized emissions of one builder (a weak/strong
        sweep at fixed rank count, every iteration of an app) share one
        lowering.  Structure mismatches at bind raise
        :class:`ProgramStructureError` — content-keyed caching is what
        makes builders that close over mutable state safe."""
        cache = getattr(self, "_app_program_cache", None)
        if cache is None:
            cache = self._app_program_cache = {}
        key = prog.structure_key()
        art = cache.get(key)
        if art is None:
            from repro_torch.core.exanet.program_compiled import (
                compile_program_ir)
            art = cache[key] = compile_program_ir(self, prog)
        return art

    def run_program(self, prog, *, plans: dict | None = None,
                    backend: str = "auto", engine=None, t0=None):
        """Execute a :class:`repro_torch.core.program.Program` on the event
        engine.

        Every rank's ops run concurrently: ``Compute`` occupies the rank's
        A53 core, nonblocking sends go through :meth:`Network.isend` (so
        simultaneous flows from *all* ranks contend on the shared
        R5/DMA/link resources — full-machine halo congestion is emergent,
        not modeled), and embedded ``Collective`` ops replay their
        schedule with the ranks' skewed entry clocks and the engine's
        live occupancy.

        ``backend`` selects the executor: ``"interp"`` (the
        :class:`ProgramExecutor` heap scheduler over per-send engine
        calls — the reference semantics), ``"compiled"`` (the program
        lowered to vectorized level programs by
        :mod:`repro_torch.core.exanet.program_compiled`, equal to ~1e-9;
        embedded
        collectives splice their compiled
        :class:`~repro_torch.core.exanet.exec_compiled.RoundProgram`\\ s), or
        ``"auto"`` (compiled at paper scale —
        :data:`PROGRAM_COMPILED_AUTO_MIN_RANKS` — when tracing is off,
        interpreted otherwise).

        ``Collective(algo="auto")`` sites are planned in one pass by the
        :class:`~repro_torch.core.planner.CollectivePlanner` *before* execution
        starts (planning simulates candidate schedules on this same
        engine, which resets occupancy); ``plans`` can inject the mapping
        ``{(op, nbytes): Plan}`` directly, e.g. from
        :meth:`CollectivePlanner.plan_program`.

        Returns the executor's :class:`~repro_torch.core.program.ProgramResult`
        (per-rank completion clocks, total compute, send/collective
        counts).

        ``engine`` selects the compiled path's scan backend (``"numpy"``
        default | ``"torch"``; DESIGN.md §2.5) and is ignored by the
        interpreter.

        ``t0`` skews per-rank start clocks: a scalar or an (nranks,)
        sequence of entry times in microseconds (request-arrival /
        dispatch jitter for serving Programs).  Both backends honor it;
        exactness of the compiled path under skew follows the same
        payload-invariant-firing-order contract as
        :meth:`run_program_scenarios` documents.
        """
        if backend not in ("auto", "interp", "compiled"):
            raise ValueError(f"unknown backend {backend!r}; "
                             f"options: ['auto', 'compiled', 'interp']")
        from repro_torch.core.program import ProgramExecutor
        nranks = prog.nranks
        if t0 is not None:
            t0 = np.asarray(t0, dtype=np.float64)
            if t0.ndim == 0:
                t0 = np.full(nranks, float(t0))
            elif t0.shape != (nranks,):
                raise ValueError(f"t0 must be scalar or (nranks,); got "
                                 f"shape {t0.shape} for nranks={nranks}")
        default_plans = plans is None
        tracing = self.net.engine.tracing
        if backend == "compiled" and tracing:
            raise ValueError("compiled backend records no per-send trace; "
                             "use backend='interp' (or trace=False)")
        if backend == "compiled" or (
                backend == "auto" and not tracing
                and nranks >= self.PROGRAM_COMPILED_AUTO_MIN_RANKS):
            try:
                # memoized per program *identity*: iterating an app
                # replays the same (artifact, binding) without re-walking
                # the IR for plans, structure key or payload extraction.
                # Keyed by id() — hashing a frozen Program would deep-hash
                # every op tuple on every call — with a weakref guard so a
                # recycled id can never alias a dead program.
                import weakref
                memo = getattr(self, "_prog_run_memo", None)
                if memo is None:
                    memo = self._prog_run_memo = {}
                ent = memo.get(id(prog)) if default_plans else None
                if ent is None or ent[0]() is not prog:
                    plans = self._plan_program_sites(prog, plans)
                    if backend == "auto" and \
                            not self._program_auto_compiles(prog, plans):
                        raise ProgramStructureError(
                            "auto gate: compiled would lose here")
                    art = self.program_artifact(prog)
                    ent = (weakref.ref(
                        prog, lambda _, k=id(prog): memo.pop(k, None)),
                        art, art.bind((prog,), (plans,)))
                    if default_plans:
                        memo[id(prog)] = ent
                return ent[1].run(ent[2], engine=engine, t0=t0)[0]
            except ProgramStructureError:
                if backend == "compiled":
                    raise
        # `plans` is already the resolved dict when the compiled branch
        # fell back after planning — _plan_program_sites passes it through
        plans = self._plan_program_sites(prog, plans)
        hooks = self._program_hooks(nranks, plans)
        self.net.reset()
        return ProgramExecutor(
            prog, **hooks,
            post_overhead_us=self.p.a53_call_overhead_us).run(
                t0=0.0 if t0 is None else t0)

    def run_program_many(self, progs, *, plans=None,
                         backend: str = "auto", engine=None) -> list:
        """Execute many Programs, batching structurally-identical ones
        through one compiled artifact (columns of a single vectorized
        replay, grouped by probe tape via
        :meth:`CompiledProgram.bind_batch`) — the weak/strong sweep
        workload.  ``plans`` is an optional per-program list.  Results
        keep input order; programs below the auto threshold (or whose
        batch the compiler rejects) fall back per program.  ``engine``
        selects the compiled path's scan backend."""
        if backend not in ("auto", "interp", "compiled"):
            raise ValueError(f"unknown backend {backend!r}; "
                             f"options: ['auto', 'compiled', 'interp']")
        progs = list(progs)
        tracing = self.net.engine.tracing
        if backend == "compiled" and tracing:
            # validate before planning: the planner simulates candidates
            # on this engine (resetting occupancy, polluting the trace)
            raise ValueError("compiled backend records no per-send trace; "
                             "use backend='interp' (or trace=False)")
        if plans is None:
            plans_list = [None] * len(progs)
        else:
            plans_list = list(plans)
            if len(plans_list) != len(progs) or not all(
                    pl is None or isinstance(pl, dict)
                    for pl in plans_list):
                raise ValueError(
                    "plans must be a per-program sequence of plan dicts "
                    f"(or None) matching len(progs)={len(progs)}")
        resolved = [self._plan_program_sites(p, pl)
                    for p, pl in zip(progs, plans_list)]
        out: list = [None] * len(progs)
        groups: dict[tuple, list[int]] = {}
        for i, p in enumerate(progs):
            if backend == "interp" or (backend == "auto" and
                    not self._program_auto_compiles(p, resolved[i])):
                out[i] = self.run_program(p, plans=resolved[i],
                                          backend="interp")
            else:
                groups.setdefault(p.structure_key(), []).append(i)
        for idxs in groups.values():
            try:
                art = self.program_artifact(progs[idxs[0]])
                for cols, bound in art.bind_batch(
                        [progs[i] for i in idxs],
                        [resolved[i] for i in idxs]):
                    for j, r in zip(cols, art.run(bound, engine=engine)):
                        out[idxs[int(j)]] = r
            except ProgramStructureError:
                if backend == "compiled":
                    raise
                for i in idxs:  # retry singly (compiled, then interp)
                    out[i] = self.run_program(progs[i], plans=resolved[i],
                                              backend="auto",
                                              engine=engine)
        return out

    def _norm_link_axis(self, ax, name: str):
        """Normalize a per-link scenario axis to {undirected key: (N,)}.
        Accepts an (N,) array (applies to *every* physical link) or a
        mapping ``{(kind, a, b): (N,)}`` (directed tuples normalized)."""
        from repro_torch.core.exanet import faults as _faults
        if ax is None:
            return None
        if hasattr(ax, "items"):
            out = {}
            for k, v in ax.items():
                v = np.asarray(v, dtype=np.float64)
                if v.ndim != 1:
                    raise ValueError(f"{name}[{k}] must be (N,); got "
                                     f"shape {v.shape}")
                out[_faults.link_key(*k)] = v
            return out or None
        arr = np.asarray(ax, dtype=np.float64)
        if arr.ndim != 1:
            raise ValueError(f"{name} must be (N,) or a per-link mapping; "
                             f"got shape {arr.shape}")
        return {k: arr for k in _faults.all_link_keys(self.topo)}

    def _link_degrade(self, slow_map, extra_map, N):
        """Build the :class:`LinkDegrade` run-time axis: (n_resource_rows,
        N) slowdown/extra-latency arrays indexed by the engine's directed
        LINK resource ids (an undirected fault key hits both directions).
        Must run *after* the artifact compiles so every routed link has
        its id registered."""
        from repro_torch.core.exanet.exec_compiled import LinkDegrade
        from repro_torch.core.exanet import faults as _faults
        R = self.net.engine.n_resource_ids
        slow = np.ones((R, N))
        extra = np.zeros((R, N))
        for ident, rid in self.net.engine.resource_ids_of(sim.LINK).items():
            key = _faults.link_key(*ident)
            if slow_map and key in slow_map:
                slow[rid] = slow_map[key]
            if extra_map and key in extra_map:
                extra[rid] = extra_map[key]
        return LinkDegrade(slow, extra, self.p)

    def _column_fault_spec(self, slow_map, extra_map, b: int):
        """The static FaultSpec equivalent of scenario column ``b`` of the
        link axes, merged over this machine's own faults — the
        interpreter-twin reference lane of the batched degradation."""
        from repro_torch.core.exanet import faults as _faults
        base = self.topo.faults or _faults.HEALTHY
        slow = {k: base.link_slow(*k) for k in base.degraded_link_keys()}
        extra = {k: base.link_extra_us(*k)
                 for k in base.degraded_link_keys()}
        for k, v in (slow_map or {}).items():
            slow[k] = slow.get(k, 1.0) * float(v[b])
        for k, v in (extra_map or {}).items():
            extra[k] = extra.get(k, 0.0) + float(v[b])
        return _faults.FaultSpec(
            dead_links=base.dead_links, dead_mpsocs=base.dead_mpsocs,
            slow_links={k: f for k, f in slow.items() if f != 1.0},
            link_extra_latency_us={k: e for k, e in extra.items() if e},
            slow_ranks=base.slow_ranks)

    def run_program_scenarios(self, prog, *, compute_scale=None,
                              byte_scale=None, site_scale=None,
                              link_scale=None, link_latency_us=None,
                              t0=None, plans: dict | None = None,
                              engine=None, check: int = 0,
                              rtol: float = 1e-9) -> list:
        """Monte-Carlo scenario sweep of one Program as a single batched
        replay: N payload perturbations of ``prog`` bind as columns of
        its compiled artifact (:meth:`CompiledProgram.bind_arrays` — no
        N Program objects, no N probes) and execute in one pass.

        ``compute_scale`` — (N,) per-scenario, (nranks, N) per-rank, or
        (n_computes, N) per-compute-slot (slots in static-walk order;
        when ``nranks == n_computes`` the per-rank reading wins)
        multiplicative compute skew; ``byte_scale`` — (N,) per-scenario
        or (n_posts, N) per-post multiplier on point-to-point payloads
        (rounded to whole bytes); ``site_scale`` — (N,) per-scenario or
        (n_sites, N) per-collective-site multiplier on embedded
        collective payloads (rounded; every scaled size must resolve to
        the *same* schedule as the base site — single-schedule ops and
        explicit ``algo=`` are always safe, ``algo="auto"`` allreduce
        sites may cross a planner decision boundary and are rejected by
        ``bind_arrays``); ``t0`` — (nranks, N) per-rank per-scenario
        entry clocks in microseconds (the request-arrival-skew axis for
        serving Programs).  ``check`` > 0 cross-checks that many
        evenly-sampled columns against the interpreter
        (:func:`rebind_program` hands it the perturbed column, with the
        column's ``t0``) and raises if any latency disagrees beyond
        ``rtol`` relative — the guard for builders whose scheduling
        order is *not* payload-invariant.

        ``link_scale`` / ``link_latency_us`` are the degradation axes
        (DESIGN.md §2.10): an (N,) array applies to every physical link,
        a ``{(kind, a, b): (N,)}`` mapping degrades chosen links
        (undirected — both directions are hit).  ``link_scale`` divides
        per-link serialization rate and sustained wire bandwidth
        (factors >= 1; a §4.5.3 lossy link with block-loss probability
        ``p`` is the factor ``1/(1-p)``); ``link_latency_us`` adds
        per-link one-way latency.  N sampled fault sets x load points
        cost one replay; checked columns run against a statically
        degraded interpreter twin (:class:`FaultSpec` merged over this
        machine's own faults).

        Returns N :class:`~repro_torch.core.program.ProgramResult`\\ s.
        """
        from repro_torch.core.exanet.program_compiled import (extract_data,
                                                              rebind_program)
        base = extract_data(prog)
        slow_map = self._norm_link_axis(link_scale, "link_scale")
        extra_map = self._norm_link_axis(link_latency_us, "link_latency_us")
        if slow_map:
            for k, v in slow_map.items():
                if (v < 1.0).any():
                    raise ValueError(
                        f"link_scale[{k}] has factors < 1 (a speedup); "
                        "degradation factors must be >= 1")
        N = None
        for nm, a in (("compute_scale", compute_scale),
                      ("byte_scale", byte_scale),
                      ("site_scale", site_scale), ("t0", t0),
                      ("link_scale", slow_map),
                      ("link_latency_us", extra_map)):
            if a is not None:
                if isinstance(a, dict):
                    n = len(next(iter(a.values())))
                    bad = {k: len(v) for k, v in a.items() if len(v) != n}
                    if bad:
                        raise ValueError(f"{nm} values disagree on N: "
                                         f"{bad} vs {n}")
                else:
                    n = np.asarray(a).shape[-1]
                if N is None:
                    N = n
                elif n != N:
                    raise ValueError(f"{nm} disagrees on N ({n} vs {N})")
        if N is None:
            raise ValueError(
                "give at least one of compute_scale / byte_scale / "
                "site_scale / link_scale / link_latency_us / t0")
        comp_cols = post_cols = site_cols = t0_cols = None
        base_comp = np.array(base[0], dtype=np.float64)
        base_post = np.array(base[1], dtype=np.float64)
        base_site = np.array(base[2], dtype=np.float64)
        if compute_scale is not None:
            cs = np.asarray(compute_scale, dtype=np.float64)
            if cs.ndim == 1:
                comp_cols = base_comp[:, None] * cs[None, :]
            elif cs.shape[0] == prog.nranks:
                art0 = self.program_artifact(prog)
                comp_cols = base_comp[:, None] * \
                    cs[art0._static.compute_rank]
            elif cs.shape[0] == len(base_comp):
                # per-compute-slot skew: the train co-sim's bucket-layout
                # axis (candidates move backward compute between buckets,
                # not between ranks)
                comp_cols = base_comp[:, None] * cs
            else:
                raise ValueError(
                    f"compute_scale must be (N,), (nranks, N) or "
                    f"(n_computes, N); got {cs.shape} for "
                    f"nranks={prog.nranks}, n_computes={len(base_comp)}")
        if byte_scale is not None:
            bs = np.asarray(byte_scale, dtype=np.float64)
            if bs.ndim == 1:
                post_cols = np.rint(base_post[:, None] * bs[None, :])
            else:
                if bs.shape[0] != len(base_post):
                    raise ValueError(
                        f"byte_scale must be (N,) or (n_posts, N); got "
                        f"{bs.shape} for n_posts={len(base_post)}")
                post_cols = np.rint(base_post[:, None] * bs)
        if site_scale is not None:
            ss = np.asarray(site_scale, dtype=np.float64)
            if ss.ndim == 1:
                site_cols = np.rint(base_site[:, None] * ss[None, :]
                                    ).astype(np.int64)
            else:
                if ss.shape[0] != len(base_site):
                    raise ValueError(
                        f"site_scale must be (N,) or (n_sites, N); got "
                        f"{ss.shape} for n_sites={len(base_site)}")
                site_cols = np.rint(base_site[:, None] * ss
                                    ).astype(np.int64)
        if t0 is not None:
            t0_cols = np.asarray(t0, dtype=np.float64)
            if t0_cols.shape != (prog.nranks, N):
                raise ValueError(
                    f"t0 must be (nranks, N); got {t0_cols.shape} for "
                    f"nranks={prog.nranks}, N={N}")
        if (comp_cols is None and post_cols is None and site_cols is None
                and (t0_cols is not None or slow_map or extra_map)):
            # t0-/link-only sweep: bind_arrays infers N from payload
            # arrays, so hold one of them constant across the N columns
            if len(base_comp):
                comp_cols = np.broadcast_to(
                    base_comp[:, None], (len(base_comp), N))
            elif len(base_post):
                post_cols = np.broadcast_to(
                    base_post[:, None], (len(base_post), N))
            else:
                site_cols = np.broadcast_to(
                    np.array(base[2], dtype=np.int64)[:, None],
                    (len(base_site), N))
        plans = self._plan_program_sites(prog, plans)
        art = self.program_artifact(prog)
        bound = art.bind_arrays(prog, compute_us=comp_cols,
                                post_nbytes=post_cols,
                                site_nbytes=site_cols, plans=plans)
        # build the degradation AFTER binding: the bind's probe is what
        # allocates the engine's LINK resource ids on a cold artifact
        deg = self._link_degrade(slow_map, extra_map, N) \
            if (slow_map or extra_map) else None
        results = art.run(bound, engine=engine, t0=t0_cols, deg=deg)
        if check > 0:
            cols = np.unique(np.linspace(0, N - 1, min(int(check), N))
                             .astype(np.int64))
            twins: dict = {}
            for b in cols:
                ref_mpi = self
                if deg is not None:
                    # link degradation cannot be rebound into a Program:
                    # the reference lane is a statically degraded machine
                    spec = self._column_fault_spec(slow_map, extra_map,
                                                   int(b))
                    ref_mpi = twins.get(spec)
                    if ref_mpi is None:
                        ref_mpi = twins[spec] = ExanetMPI(
                            self.p, ranks_per_mpsoc=self._rpm, faults=spec)
                pb = rebind_program(
                    prog,
                    compute_us=None if comp_cols is None
                    else comp_cols[:, b],
                    post_nbytes=None if post_cols is None
                    else post_cols[:, b],
                    site_nbytes=None if site_cols is None
                    else site_cols[:, b])
                ref = ref_mpi.run_program(pb, plans=plans, backend="interp",
                                          t0=None if t0_cols is None
                                          else t0_cols[:, b])
                err = abs(results[b].latency_us - ref.latency_us) / \
                    max(abs(ref.latency_us), 1e-30)
                if err > rtol:
                    raise ProgramStructureError(
                        f"scenario column {int(b)} disagrees with the "
                        f"interpreter ({err:.2e} rel > {rtol:.0e}) — the "
                        f"scheduling order is payload-dependent; run "
                        f"these scenarios via run_program_many instead")
        return results

    def _step_class(self, src: int, dst: int) -> str:
        d = abs(dst - src) * (self.p.cores_per_mpsoc if self._rpm == 1 else 1)
        cpq = self.p.cores_per_mpsoc * self.p.fpgas_per_qfdb
        if d >= cpq:
            return "mezzanine"
        if d >= self.p.cores_per_mpsoc:
            return "qfdb"
        return "mpsoc"

    # ------------------------------------------------------------- broadcast
    def bcast(self, size: int, nranks: int) -> BcastResult:
        """Event-simulated binomial broadcast vs the Eq. 1 expectation."""
        sched = BinomialBroadcast()
        res = self.run_schedule(sched, size, nranks)
        counts = {"mpsoc": 0, "qfdb": 0, "mezzanine": 0}
        for (s, d) in res.round_heads:
            counts[self._step_class(s, d)] += 1
        expected = self.bcast_expected(size, counts)
        return BcastResult(res.latency_us, expected, counts)

    def bcast_expected(self, size: int, counts: dict[str, int]) -> float:
        """Eq. 1: L_exp = Ns_MPSoC*L_MPSoC + Ns_QFDB*L_QFDB + Ns_mezz*L_mezz,
        with one-way latencies from osu_one_way_lat over representative
        single-hop paths (§6.1.4)."""
        c = self.p.cores_per_mpsoc
        l_mpsoc = self.osu_one_way_core(size, 0, 1)
        l_qfdb = self.osu_one_way_core(size, 0, c)
        l_mezz = self.osu_one_way_core(size, 0, c * self.p.fpgas_per_qfdb)
        return (counts["mpsoc"] * l_mpsoc + counts["qfdb"] * l_qfdb
                + counts["mezzanine"] * l_mezz)

    def osu_one_way_core(self, size: int, c0: int, c1: int) -> float:
        path = self.topo.route(c0, c1)
        return self.net.mpi_latency(size, path, one_way=True)

    # ------------------------------------------------------------- planner
    @property
    def planner(self):
        """Cost-driven schedule selection over *this* instance (its rank
        placement and calibrated params), at full event-simulation fidelity.
        Built lazily: the planner layer is optional for plain wrapper use."""
        planner = getattr(self, "_planner", None)
        if planner is None:
            from repro_torch.core.machine import ExanetMachine
            from repro_torch.core.planner import CollectivePlanner
            planner = self._planner = CollectivePlanner(
                ExanetMachine(mpi=self), fidelity="sim")
        return planner

    # ------------------------------------------------------------- allreduce
    def allreduce(self, size: int, nranks: int,
                  algo: str = "recursive_doubling") -> float:
        """Event-simulated software allreduce with a pluggable schedule
        (``recursive_doubling`` | ``ring`` | ``rabenseifner`` |
        ``oneshot``), or ``algo="auto"``: the planner picks the cheapest
        schedule — including the §4.7 accelerator where applicable — by
        simulated cost, reproducing the paper's Fig. 19 sw/accel crossover
        from cost alone instead of a hand-coded threshold."""
        if algo == "auto":
            plan = self.planner.plan("allreduce", size, (nranks,))
            if plan.schedule == "accel":
                # ungated cost path: the planner (not the historical 4 KB
                # fallback) decided the accelerator is profitable here
                from repro_torch.core.exanet.allreduce_accel import (
                    accel_cost_us)
                return accel_cost_us(size, nranks, self.p)
            algo = plan.schedule
        if algo.startswith("synth:"):
            sched = self._schedule_instance("allreduce", algo)
        else:
            sched_cls = ALLREDUCE_SCHEDULES.get(algo)
            if sched_cls is None:
                raise ValueError(
                    f"unknown allreduce algo {algo!r}; options: "
                    f"{sorted(ALLREDUCE_SCHEDULES) + ['auto']}")
            sched = sched_cls()
        return self.run_schedule(sched, size, nranks).latency_us

    def allreduce_sw(self, size: int, nranks: int) -> float:
        """Recursive-doubling software allreduce (§6.1.3): per step an
        MPI_Sendrecv (full exchange) + MPI_Reduce_local; one memcpy in, one
        memcpy out. Event-simulated with R5/DMA contention."""
        return self.allreduce(size, nranks, "recursive_doubling")

    def allreduce_hw(self, size: int, nranks: int) -> float:
        from repro_torch.core.exanet.allreduce_accel import (
            accel_allreduce_latency)
        return accel_allreduce_latency(size, nranks, self.p)

    # ------------------------------------------- schedule-split collectives
    def allgather(self, size: int, nranks: int) -> float:
        """All-gather ``size`` bytes per rank (recursive doubling)."""
        return self.run_schedule(AllGather(), size, nranks).latency_us

    def alltoall(self, size: int, nranks: int) -> float:
        """Pairwise-exchange all-to-all of ``size`` bytes per pair."""
        return self.run_schedule(AllToAll(), size, nranks).latency_us

    def barrier(self, nranks: int) -> float:
        """Dissemination barrier (empty eager messages)."""
        return self.run_schedule(Barrier(), 0, nranks).latency_us

    def scatter(self, size: int, nranks: int) -> float:
        """Binomial scatter of ``size`` bytes per rank from rank 0."""
        return self.run_schedule(ScatterBinomial(), size, nranks).latency_us

    def gather(self, size: int, nranks: int) -> float:
        """Binomial gather of ``size`` bytes per rank to rank 0."""
        return self.run_schedule(GatherBinomial(), size, nranks).latency_us
