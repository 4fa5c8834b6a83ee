"""CollectivePlanner: schedule selection by simulated cost (DESIGN.md §3.5).

The paper's headline result is that *choosing the communication mechanism per
message* is what makes the interconnect fast: eager vs rendez-vous at 32 B
(§5.2.1), software vs NI-accelerated allreduce with up to 88% latency
reduction below a crossover vector size (§6.2).  The repo used to hard-code
each of those choices in a different layer; the planner is the one place
they are all derived from machine cost.

Given (collective op, payload bytes, participants per mesh axis) the planner
enumerates candidate schedules from :mod:`repro_torch.core.exanet.schedules`,
costs each on a :class:`repro_torch.core.machine.MachineModel` at the requested
``fidelity`` (``"analytic"`` alpha-beta closed forms or ``"sim"`` full event
simulation where the machine has one), and returns a memoized :class:`Plan`
carrying the chosen executor key, its predicted cost, and every candidate's
cost for auditability.

Design rules (enforced by import structure, see DESIGN.md §3.5):

* the planner never sees jax — it works on byte counts and axis sizes, so
  it can run at trace time inside a jitted training step;
* machines never see schedules' internals — costs go through
  ``alpha_beta_cost_s`` or the event executor;
* plans are frozen value objects; repeated queries are cache hits.

The port's copy of the reference's ``repro.core.planner``, whole: the same
names, layout and float arithmetic, with its imports rewritten to
``repro_torch`` (``tests/test_torch_planner.py`` holds the two equal).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

from repro_torch.core.exanet.schedules import (HierarchicalAccelAllreduce,
                                               OneShotAllreduce,
                                               RabenseifnerAllreduce,
                                               RecursiveDoublingAllreduce,
                                               RingAllreduce)
from repro_torch.core.machine import INTER, INTRA, MachineModel


# ----------------------------------------------------- closed-form anchors
def oneshot_cost_s(nbytes: int, p: int, bw: float, alpha: float) -> float:
    """All-gather everything + local reduce: 1 phase, alpha-cheap,
    bandwidth-expensive (the packetizer analog).  Identical to the
    alpha-beta cost of :class:`OneShotAllreduce` by construction."""
    if p <= 1:
        return 0.0
    return alpha + (p - 1) * nbytes / bw


def ring_cost_s(nbytes: int, p: int, bw: float, alpha: float) -> float:
    """Bandwidth-optimal ring: 2(p-1) rounds moving size/p chunks (the
    rendez-vous analog)."""
    if p <= 1:
        return 0.0
    return 2 * (p - 1) * alpha + 2 * (p - 1) / p * nbytes / bw


def crossover_bytes(cost_small: Callable[[int], float],
                    cost_large: Callable[[int], float],
                    *, hi: int = 1 << 32) -> int:
    """Smallest message size at which ``cost_small`` stops winning, found by
    bisection (assumes the sign of the difference flips at most once, which
    holds whenever ``cost_small`` has the steeper per-byte slope).  Returns
    ``hi`` when ``cost_small`` wins everywhere."""
    lo = 1
    while lo < hi:
        mid = (lo + hi) // 2
        if cost_small(mid) <= cost_large(mid):
            lo = mid + 1
        else:
            hi = mid
    return lo


# ------------------------------------------------------------------- plans
@dataclasses.dataclass(frozen=True)
class Plan:
    """Outcome of one planning query: the chosen executor key plus every
    candidate's predicted cost (seconds), for auditing and benchmarks."""
    op: str
    nbytes: int
    participants: tuple[int, ...]
    schedule: str                        # chosen executor key
    cost_s: float                        # predicted cost of the choice
    costs: tuple[tuple[str, float], ...]  # every feasible candidate
    fidelity: str
    machine: str
    #: candidate source of the winner: ``"menu"`` (hand-written schedule
    #: or the §4.7 accelerator) or ``"synthesized"`` (winner-cache term)
    provenance: str = "menu"
    #: fractional cost advantage of the winner over the best candidate
    #: from the *other* source (0.0 when only one source was feasible):
    #: how much the synthesis search actually buys (or forgoes) here
    margin: float = 0.0

    def cost_of(self, name: str) -> float | None:
        for k, v in self.costs:
            if k == name:
                return v
        return None


@dataclasses.dataclass(frozen=True)
class TrainSyncPlan:
    """Outcome of one train-sync planning run
    (:meth:`CollectivePlanner.plan_train_sync`): the simulated-best
    gradient-sync candidate next to the analytic-policy baseline, with
    the step-time margin that justifies (or refutes) a flip."""
    arch: str
    nranks: int
    chosen: object                  #: winning repro.train.cosim.SyncCandidate
    step_us: float                  #: its simulated step time
    baseline: object                #: the analytic CommPolicy candidate
    baseline_step_us: float         #: its simulated step time
    flipped: bool                   #: does the decision differ at all?
    flip_kinds: tuple[str, ...]     #: which knobs differ
    margin: float                   #: (baseline - chosen) / baseline
    evaluated: int                  #: candidates costed (batched)
    machine: str
    fidelity: str = "sim"


#: software allreduce candidates, in tie-breaking preference order
#: (latency-optimal first: ties at tiny sizes resolve to the eager path)
ALLREDUCE_CANDIDATES: tuple[tuple[str, type], ...] = (
    ("oneshot", OneShotAllreduce),
    ("recursive_doubling", RecursiveDoublingAllreduce),
    ("rabenseifner", RabenseifnerAllreduce),
    ("ring", RingAllreduce),
    ("accel", HierarchicalAccelAllreduce),
)

GRAD_SYNC_STRATEGIES = ("flat", "hierarchical", "compressed")


class CollectivePlanner:
    """Cost-driven collective schedule selection on one machine model."""

    def __init__(self, machine: MachineModel, *, fidelity: str = "analytic",
                 engine=None, synth_cache="default"):
        """``engine`` — scan backend forwarded to the machine's batched
        ``sim``-fidelity costing (:meth:`plan_many`; ``"numpy"`` default |
        ``"jax"``, DESIGN.md §2.5).  Plans are engine-independent (the
        engines agree to 1e-9), so the cache never keys on it.

        ``synth_cache`` — the synthesized-schedule candidate source
        (DESIGN.md §2.8): ``"default"`` loads the committed
        ``core/synth/winners.json`` artifact, ``None`` disables
        synthesized candidates, a path or
        :class:`repro_torch.core.synth.search.WinnerCache` uses that cache.
        Cached winners whose ``(machine, op, nranks, size-bucket,
        placement)`` key matches a query are costed alongside the menu —
        never trusted blindly — so ``allreduce(algo="auto")`` and
        ``grad_sync(strategy="auto")`` pick them up only where they
        actually win at this machine's fidelity."""
        self.machine = machine
        self.fidelity = fidelity
        self.engine = engine
        self._synth_cache_arg = synth_cache
        self._synth_cache = None if synth_cache is None else "unresolved"
        self._cache: dict[tuple, Plan] = {}
        self._hits = 0
        self._misses = 0
        self._synth_candidates = 0
        self._synth_wins = 0

    # ------------------------------------------------------------- caching
    def cache_info(self) -> dict:
        total = self._hits + self._misses
        return {"hits": self._hits, "misses": self._misses,
                "size": len(self._cache),
                "hit_rate": self._hits / total if total else 0.0,
                "synth_candidates": self._synth_candidates,
                "synth_wins": self._synth_wins}

    # --------------------------------------------- synthesized candidates
    def _winner_cache(self):
        if self._synth_cache == "unresolved":
            from repro_torch.core.synth.search import resolve_cache
            self._synth_cache = resolve_cache(self._synth_cache_arg)
        return self._synth_cache

    def _synth_candidate(self, op: str, p: int, nbytes: int):
        """(name, schedule) of the cached synthesized winner matching
        this query's cell, or None.  Counts lookups that produced a
        candidate (``cache_info()["synth_candidates"]``)."""
        cache = self._winner_cache()
        if cache is None:
            return None
        entry = cache.get(self.machine.name, op, p, nbytes,
                          getattr(self.machine, "placement", "default"))
        if entry is None:
            return None
        sched = cache.schedule(entry)
        if not self.machine.supports(sched, p, nbytes):
            return None
        self._synth_candidates += 1
        return sched.name, sched

    def resolve_schedule(self, plan: Plan):
        """The executable schedule object behind a plan's chosen key
        (menu class instance, accelerator schedule, or the registered
        synthesized term)."""
        if plan.schedule.startswith("synth:"):
            from repro_torch.core.synth.search import registered
            sched = registered(plan.schedule)
            if sched is None:
                raise ValueError(f"synthesized schedule {plan.schedule!r} "
                                 "is not registered")
            return sched
        for name, factory in ALLREDUCE_CANDIDATES:
            if name == plan.schedule:
                return factory()
        raise ValueError(f"no schedule object for {plan.schedule!r}")

    # ------------------------------------------------------------ planning
    def plan(self, op: str, nbytes: int, participants: tuple[int, ...] | int,
             *, fidelity: str | None = None, allow_lossy: bool = False) -> Plan:
        """Memoized plan for one collective.

        ``op="allreduce"``: participants collapse to one rank count; the
        candidates are every schedule in :data:`ALLREDUCE_CANDIDATES` the
        machine supports (including the §4.7 accelerator where applicable).

        ``op="grad_sync"``: participants are ``(intra, inter)`` mesh-axis
        sizes; the candidates are the bucket strategies ``flat`` /
        ``hierarchical`` / ``compressed`` of
        :func:`repro_torch.parallel.grad_sync.sync_gradients`.
        The int8-quantized candidate is only considered with
        ``allow_lossy=True`` — lossy compression must be an explicit caller
        decision, never a silent cost win (its error feedback lives in
        ``CompressedSync``).
        """
        if isinstance(participants, int):
            participants = (participants,)
        participants = tuple(int(p) for p in participants)
        nbytes = int(nbytes)
        fidelity = fidelity or self.fidelity
        key = (op, nbytes, participants, fidelity, allow_lossy)
        plan = self._cache.get(key)
        if plan is not None:
            self._hits += 1
            return plan
        self._misses += 1
        if op == "allreduce":
            plan = self._plan_allreduce(nbytes, participants, fidelity)
        elif op == "grad_sync":
            plan = self._plan_grad_sync(nbytes, participants, fidelity,
                                        allow_lossy)
        else:
            raise ValueError(f"unknown collective op {op!r}; "
                             f"options: ['allreduce', 'grad_sync']")
        self._cache[key] = plan
        return plan

    def plan_many(self, op: str, sizes, participants: tuple[int, ...] | int,
                  *, fidelity: str | None = None,
                  allow_lossy: bool = False) -> list[Plan]:
        """Memoized plans for a whole message-size grid.

        For ``op="allreduce"`` the uncached sizes are costed in batch: one
        :meth:`MachineModel.cost_many` call per candidate schedule, which
        at ``sim`` fidelity reuses one compiled round program across the
        grid (``exec_compiled``) instead of event-interpreting every
        (schedule, size) pair — the cold-plan path of a sweep drops from
        O(sizes) simulations per candidate to one.  Results land in the
        same plan cache :meth:`plan` uses, so single-size queries keep
        hitting them."""
        if isinstance(participants, int):
            participants = (participants,)
        participants = tuple(int(p) for p in participants)
        fidelity = fidelity or self.fidelity
        sizes = [int(s) for s in sizes]
        missing = [s for s in dict.fromkeys(sizes)
                   if (op, s, participants, fidelity, allow_lossy)
                   not in self._cache]
        if op == "allreduce" and missing:
            p = math.prod(participants)
            m = self.machine
            costs_by_size: dict[int, list] = {s: [] for s in missing}
            for name, factory in ALLREDUCE_CANDIDATES:
                sched = factory()
                # supports() is by-contract byte-dependent: gate per size
                # (exactly like plan()) and batch over the feasible subset
                feasible = [s for s in missing if m.supports(sched, p, s)]
                if not feasible:
                    continue
                for s, c in zip(feasible, m.cost_many(sched, p, feasible,
                                                      fidelity=fidelity,
                                                      engine=self.engine)):
                    costs_by_size[s].append((name, c))
            # synthesized candidates: one winner-cache entry per size
            # bucket, batched per distinct schedule like the menu
            by_sched: dict[str, tuple] = {}
            for s in missing:
                syn = self._synth_candidate("allreduce", p, s)
                if syn is not None:
                    by_sched.setdefault(syn[0], (syn[1], []))[1].append(s)
            for name, (sched, ss) in by_sched.items():
                for s, c in zip(ss, m.cost_many(sched, p, ss,
                                                fidelity=fidelity,
                                                engine=self.engine)):
                    costs_by_size[s].append((name, c))
            for s in missing:
                key = (op, s, participants, fidelity, allow_lossy)
                self._cache[key] = self._pick("allreduce", s, participants,
                                              costs_by_size[s], fidelity)
                self._misses += 1
        return [self.plan(op, s, participants, fidelity=fidelity,
                          allow_lossy=allow_lossy) for s in sizes]

    def plan_program(self, prog, *, fidelity: str | None = None,
                     allow_lossy: bool = False) -> dict:
        """Plan every ``Collective(algo="auto")`` site of a
        :class:`repro_torch.core.program.Program` in one pass.

        Sites are grouped by op and planned through :meth:`plan_many`, so
        at ``sim`` fidelity all sizes of one candidate schedule share a
        single compiled round program instead of being event-interpreted
        per site.  Returns ``{(op, nbytes): Plan}`` — the mapping
        :meth:`repro.core.exanet.mpi.ExanetMPI.run_program` consumes on
        *both* executors: the interpreter resolves each site through
        ``ExanetMPI._resolve_collective_schedule`` at barrier time, and
        the compiled backend resolves through the same method at bind
        time to pick which compiled ``RoundProgram`` to splice — one
        resolution rule, two executors (DESIGN.md §2.5).  Only allreduce
        sites have multiple candidates today; other ops fall back to
        their single shipped schedule at execution time and need no plan.
        """
        sites: dict[str, set[int]] = {}
        for c in prog.collectives():
            if c.algo == "auto" and c.op == "allreduce":
                sites.setdefault(c.op, set()).add(int(c.nbytes))
        out: dict[tuple[str, int], Plan] = {}
        for op, sizes in sites.items():
            ordered = sorted(sizes)
            plans = self.plan_many(op, ordered, (prog.nranks,),
                                   fidelity=fidelity,
                                   allow_lossy=allow_lossy)
            out.update({(op, s): p for s, p in zip(ordered, plans)})
        return out

    def _pick(self, op: str, nbytes: int, participants: tuple[int, ...],
              costs: list[tuple[str, float]], fidelity: str) -> Plan:
        if not costs:
            raise ValueError(f"no feasible schedule for {op} at "
                             f"nbytes={nbytes} participants={participants} "
                             f"on {self.machine.name}")
        best, best_cost = costs[0]
        for name, c in costs[1:]:
            if c < best_cost:
                best, best_cost = name, c
        synth_won = best.startswith("synth:")
        other = [c for name, c in costs
                 if name.startswith("synth:") != synth_won]
        margin = (min(other) - best_cost) / min(other) if other else 0.0
        if synth_won:
            self._synth_wins += 1
        return Plan(op, nbytes, participants, best, best_cost,
                    tuple(costs), fidelity, self.machine.name,
                    provenance="synthesized" if synth_won else "menu",
                    margin=margin)

    def _plan_allreduce(self, nbytes: int, participants: tuple[int, ...],
                        fidelity: str) -> Plan:
        p = math.prod(participants)
        m = self.machine
        costs = []
        for name, factory in ALLREDUCE_CANDIDATES:
            sched = factory()
            if not m.supports(sched, p, nbytes):
                continue
            costs.append((name, m.cost_s(sched, p, nbytes,
                                         fidelity=fidelity)))
        syn = self._synth_candidate("allreduce", p, nbytes)
        if syn is not None:
            name, sched = syn
            costs.append((name, m.cost_s(sched, p, nbytes,
                                         fidelity=fidelity)))
        return self._pick("allreduce", nbytes, participants, costs, fidelity)

    # ------------------------------------------------- gradient-sync plans
    def _best_sw_allreduce_s(self, nbytes: int, p: int, level: str,
                             fidelity: str,
                             exclude: tuple[str, ...] = ("accel",)) -> float:
        """Cheapest feasible *software* allreduce at one level."""
        m = self.machine
        best = None
        for name, factory in ALLREDUCE_CANDIDATES:
            if name in exclude:
                continue
            sched = factory()
            if not m.supports(sched, p, nbytes):
                continue
            c = m.cost_s(sched, p, nbytes, fidelity=fidelity, level=level)
            if best is None or c < best:
                best = c
        syn = self._synth_candidate("allreduce", p, nbytes)
        if syn is not None and syn[0] not in exclude:
            # synthesized winners are software schedules: grad_sync's
            # strategy costing benefits from them transparently
            c = m.cost_s(syn[1], p, nbytes, fidelity=fidelity, level=level)
            if best is None or c < best:
                best = c
        if best is None:
            raise ValueError(f"no software allreduce feasible at p={p}")
        return best

    def _plan_grad_sync(self, nbytes: int, participants: tuple[int, ...],
                        fidelity: str, allow_lossy: bool) -> Plan:
        """Cost the flat / hierarchical / compressed bucket strategies.

        * flat — one allreduce over all k*m ranks; with an inter axis the
          flat schedule crosses the slow links, so it is costed at the
          ``inter`` level (the whole point of DESIGN.md §5's rule that
          cross-pod traffic must never be the flat ring).
        * hierarchical — ring reduce-scatter + all-gather on the intra axis
          (together exactly one ring-allreduce cost) plus an allreduce of
          the 1/k shard on the inter axis.
        * compressed — hierarchical with the inter payload quantized to
          int8 and accumulated in int16 on the wire (half the bytes while
          the inter axis is <=255 wide, matching ``_compressed_allreduce``;
          int32 — no wire saving — beyond that) plus two memory passes
          (quantize + dequantize) over the shard.
        """
        k = participants[0] if participants else 1
        m_axis = participants[1] if len(participants) > 1 else 1
        machine = self.machine
        flat_level = INTER if m_axis > 1 else INTRA
        costs = [("flat", self._best_sw_allreduce_s(
            nbytes, k * m_axis, flat_level, fidelity))]
        if k > 1 and m_axis > 1:
            intra = machine.cost_s(RingAllreduce(), k, nbytes,
                                   fidelity=fidelity, level=INTRA)
            shard = max(1, nbytes // k)
            inter = self._best_sw_allreduce_s(shard, m_axis, INTER, fidelity)
            costs.append(("hierarchical", intra + inter))
            if allow_lossy:
                mem_pass = getattr(machine, "memory_pass_s", lambda nb: 0.0)
                wire = shard // 2 if m_axis <= 255 else shard
                inter_q = self._best_sw_allreduce_s(max(1, wire), m_axis,
                                                    INTER, fidelity)
                costs.append(("compressed",
                              intra + inter_q + 2.0 * mem_pass(shard)))
        return self._pick("grad_sync", nbytes, participants, costs, fidelity)

    # ------------------------------------------------- train-sync planning
    def plan_train_sync(self, sim, *, generations: int = 2,
                        survivors: int = 4, children: int = 4,
                        candidates=None, engine=None, check: int = 0,
                        seed: int = 0) -> TrainSyncPlan:
        """Hillclimb gradient-sync configurations (bucket layout,
        schedule, overlap depth) against *simulated* train-step time
        (DESIGN.md §2.9).

        ``sim`` is the cost oracle and domain surface — anything with
        the :class:`repro.train.cosim.TrainSim` protocol
        (``candidate_grid`` / ``cost_candidates`` / ``mutate`` /
        ``analytic_candidate`` / ``spec`` / ``machine``); the planner
        contributes only the search policy, so it stays import-clean of
        the train layer.  Every generation is costed through the sim's
        batched scenario lane (one compiled replay per structure
        family), which is what makes population search affordable at
        512-4096 ranks.  The returned plan carries the analytic
        ``CommPolicy`` baseline and the step-time margin, i.e. whether
        simulated overlap *flips* the analytic decision."""
        import numpy as np
        rng = np.random.default_rng(seed)
        base_cand = sim.analytic_candidate()
        pop = list(candidates) if candidates is not None \
            else sim.candidate_grid()
        if base_cand not in pop:
            pop.append(base_cand)
        seen = dict(zip(pop, sim.cost_candidates(pop, engine=engine,
                                                 check=check)))
        for _ in range(generations):
            elite = sorted(seen, key=seen.get)[:survivors]
            kids = [sim.mutate(c, rng) for c in elite
                    for _ in range(children)]
            kids = [k for k in dict.fromkeys(kids) if k not in seen]
            if not kids:
                break
            seen.update(zip(kids, sim.cost_candidates(kids, engine=engine,
                                                      check=check)))
        best = min(seen, key=seen.get)
        best_us, base_us = float(seen[best]), float(seen[base_cand])
        kinds = tuple(
            k for k, differs in (
                ("n_buckets", best.n_buckets != base_cand.n_buckets),
                ("algo", best.algo != base_cand.algo),
                ("overlap_depth",
                 best.overlap_depth != base_cand.overlap_depth),
                ("split", best.split != base_cand.split),
            ) if differs)
        return TrainSyncPlan(
            arch=sim.spec.arch, nranks=sim.spec.nranks, chosen=best,
            step_us=best_us, baseline=base_cand, baseline_step_us=base_us,
            flipped=bool(kinds), flip_kinds=kinds,
            margin=(base_us - best_us) / base_us if base_us else 0.0,
            evaluated=len(seen), machine=sim.machine.name)

    # --------------------------------------------------------- thresholds
    def eager_threshold_bytes(self, p: int, *, level: str = INTRA) -> int:
        """Derived eager threshold: the message size below which the
        one-shot (single-alpha, eager-analog) schedule is the *plan* — i.e.
        it beats every other feasible software schedule.  The one-shot
        per-byte slope (p-1)/bw dominates all candidates', so the winner
        flips at most once and bisection applies."""
        if p < 2:
            return 1 << 32
        alpha, bw = self.machine.alpha_beta(level)

        def oneshot(n: int) -> float:
            return oneshot_cost_s(n, p, bw, alpha)

        def best_other(n: int) -> float:
            try:
                return self._best_sw_allreduce_s(
                    n, p, level, "analytic", exclude=("oneshot", "accel"))
            except ValueError:
                return float("inf")

        return crossover_bytes(oneshot, best_other)
