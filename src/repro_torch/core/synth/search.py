"""Population search over the round algebra + the persistent winner cache.

Promoted from ``benchmarks/hillclimb.py`` into a library the
planner can consume.  One *cell* is a (collective, nbytes, nranks,
placement) point; :func:`search_cell` runs, per feasible skeleton
(:func:`skeletons`), a small evolutionary search whose fitness call
costs the whole genome population as ONE batched compiled replay
(:meth:`ExanetMachine.cost_population` — one batch column per
candidate), followed by coordinate-descent local refinement around the
incumbent.  Nothing in the search family knows about the §4.7 NI
accelerator: re-deriving the paper's Fig. 19 sw/accel crossover from
synthesized software schedules is an acceptance check, not an input.

Every winner must clear two gates before it is cached or registered:

1. **semantic** — the contribution-tracking check of
   :mod:`repro_torch.core.synth.verify` (exact-once allreduce dataflow);
2. **agreement** — the interpreter re-run of the winner matches its
   batched compiled fitness cost to ≤ :data:`AGREEMENT_RTOL` (the
   Exo-style equivalence harness).

Winners persist in a :class:`WinnerCache` (JSON artifact keyed by
``op/nranks/size-bucket/placement`` per machine name; the committed
default lives next to this module as ``winners.json``) and resolve at
execution time through the ``synth:<digest>`` name registry
(:func:`registered`) — the seam :meth:`ExanetMPI._schedule_instance`
and the planner's ``synthesized`` candidate source share.

The port's copy of the reference's ``repro.core.synth.search``, whole: the
same names, layout and float arithmetic, with its imports rewritten to
``repro_torch`` (``tests/test_torch_planner.py`` holds the two equal).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time

import numpy as np

from ..exanet.schedule_algebra import (SIGMA_HI, SIGMA_LO, Dissemination,
                                       Hierarchical, Pipeline,
                                       SchedulePopulation, Split, Term,
                                       TermSchedule, term_from_spec)
from .verify import check_term

#: interp-vs-compiled relative tolerance every winner must meet
AGREEMENT_RTOL = 1e-9


# ----------------------------------------------------------- name registry
_REGISTRY: dict[str, TermSchedule] = {}


def register(sched: TermSchedule) -> str:
    """Make a synthesized schedule resolvable by its ``synth:<digest>``
    name (idempotent; the digest is content-addressed)."""
    _REGISTRY[sched.name] = sched
    return sched.name


def register_term(term: Term) -> TermSchedule:
    sched = TermSchedule(term)
    existing = _REGISTRY.get(sched.name)
    if existing is not None:
        return existing
    register(sched)
    return sched


def registered(name: str) -> TermSchedule | None:
    """The schedule behind a ``synth:<digest>`` name, if registered."""
    return _REGISTRY.get(name)


# ------------------------------------------------------------ winner cache
def size_bucket(nbytes: int) -> int:
    """Power-of-two floor bucket for winner-cache keys: a winner searched
    at ``nbytes`` serves queries in ``[bucket, 2*bucket)``."""
    return 1 << (max(1, int(nbytes)).bit_length() - 1)


def _cache_key(machine_name: str, op: str, nranks: int, bucket: int,
               placement: str) -> str:
    return f"{op}/p{nranks}/b{bucket}/{placement}@{machine_name}"


class WinnerCache:
    """Persistent synthesized-schedule winners, keyed by
    ``op/nranks/size-bucket/placement`` per machine name.

    Each entry stores the winning term's :meth:`Term.spec` (the
    re-buildable wire format), its simulated cost, and the best menu
    cost at search time — enough for the planner to register the
    schedule and for BENCH rows to report the margin without
    re-searching."""

    def __init__(self, entries: dict | None = None,
                 path: str | None = None):
        self.entries: dict[str, dict] = dict(entries or {})
        self.path = path

    @classmethod
    def load(cls, path: str) -> "WinnerCache":
        with open(path) as f:
            doc = json.load(f)
        return cls(doc.get("entries", {}), path=path)

    #: committed default artifact: a byte-equal copy of the reference's
    #: ``repro/core/synth/winners.json``, held equal by
    #: ``tests/test_torch_planner.py``
    DEFAULT_PATH = os.path.join(os.path.dirname(__file__), "winners.json")

    _default: "WinnerCache | None" = None

    @classmethod
    def default(cls) -> "WinnerCache":
        """The committed artifact (singleton; empty cache if absent)."""
        if cls._default is None:
            if os.path.exists(cls.DEFAULT_PATH):
                cls._default = cls.load(cls.DEFAULT_PATH)
            else:
                cls._default = cls(path=cls.DEFAULT_PATH)
        return cls._default

    def __len__(self) -> int:
        return len(self.entries)

    def get(self, machine_name: str, op: str, nranks: int, nbytes: int,
            placement: str) -> dict | None:
        return self.entries.get(_cache_key(machine_name, op, int(nranks),
                                           size_bucket(nbytes), placement))

    def put(self, machine_name: str, op: str, nranks: int, nbytes: int,
            placement: str, *, spec, cost_s: float, best_menu_s: float,
            menu_name: str) -> dict:
        entry = {"spec": spec, "nranks": int(nranks),
                 "searched_nbytes": int(nbytes),
                 "cost_s": float(cost_s),
                 "best_menu_s": float(best_menu_s),
                 "menu_name": menu_name}
        key = _cache_key(machine_name, op, int(nranks),
                         size_bucket(nbytes), placement)
        self.entries[key] = entry
        return entry

    def schedule(self, entry: dict) -> TermSchedule:
        """Registered executable schedule of a cache entry."""
        return register_term(term_from_spec(entry["spec"]))

    def save(self, path: str | None = None) -> str:
        path = path or self.path
        if path is None:
            raise ValueError("no path to save the winner cache to")
        doc = {"version": 1, "entries": self.entries}
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        self.path = path
        return path


def resolve_cache(synth_cache) -> WinnerCache | None:
    """Planner-facing coercion: ``"default"`` -> the committed artifact,
    ``None`` -> disabled, a path -> loaded, a cache -> itself."""
    if synth_cache is None:
        return None
    if synth_cache == "default":
        return WinnerCache.default()
    if isinstance(synth_cache, str):
        return WinnerCache.load(synth_cache)
    return synth_cache


# ------------------------------------------------------------ search space
def skeletons(nranks: int, *, groups: tuple[int, ...] = (4, 16),
              chunk_options: tuple[int, ...] = (2, 4)) -> list[Term]:
    """The discrete skeleton points feasible at a rank count, balanced
    genomes.  Deduplicated by structure key; the continuous sigma genes
    are what the per-skeleton population search explores."""
    out: list[Term] = []

    def pow2(n: int) -> bool:
        return n >= 2 and not (n & (n - 1))

    if pow2(nranks):
        base = Split.balanced(nranks)
        out.append(base)
        for c in chunk_options:
            out.append(Pipeline(c, base))
    for radix in (2, 3, 4):
        try:
            Dissemination(radix).validate(nranks)
        except ValueError:
            continue
        if radix == 2 and pow2(nranks):
            continue  # structurally dominated by Split's butterfly here
        out.append(Dissemination(radix))
    for q in groups:
        if nranks % q or nranks // q < 2:
            continue
        inner_n = nranks // q
        if pow2(inner_n):
            inner = Split.balanced(inner_n)
            out.append(Hierarchical(q, inner))
            out.append(Hierarchical(q, Pipeline(2, inner)))
    seen: set = set()
    uniq = []
    for t in out:
        k = t.structure_key()
        if k not in seen:
            seen.add(k)
            uniq.append(t)
    return uniq


def mutate(genome: np.ndarray, scale: float,
           rng: np.random.Generator) -> np.ndarray:
    return np.clip(genome + rng.normal(0.0, scale, size=genome.shape),
                   SIGMA_LO, SIGMA_HI)


# ------------------------------------------------------------------ search
@dataclasses.dataclass
class CellResult:
    """Outcome of one search cell (everything a BENCH row needs)."""
    op: str
    nranks: int
    nbytes: int
    placement: str
    machine: str
    best_menu: str
    best_menu_s: float
    best_sw_menu: str
    best_sw_menu_s: float
    accel_s: float | None
    winner_spec: list
    winner_name: str
    winner_s: float
    interp_s: float
    agreement_rel: float
    evals: int
    elapsed_s: float
    semantic_ok: bool

    @property
    def speedup_vs_menu(self) -> float:
        return self.best_sw_menu_s / self.winner_s

    @property
    def candidates_per_s(self) -> float:
        return self.evals / self.elapsed_s if self.elapsed_s > 0 else 0.0

    def to_row(self) -> dict:
        row = dataclasses.asdict(self)
        row["speedup_vs_menu"] = self.speedup_vs_menu
        row["candidates_per_s"] = self.candidates_per_s
        return row


def _menu_costs(machine, nranks: int, nbytes: int, fidelity: str):
    from ..planner import ALLREDUCE_CANDIDATES
    sw, accel_s = [], None
    for name, factory in ALLREDUCE_CANDIDATES:
        sched = factory()
        if not machine.supports(sched, nranks, nbytes):
            continue
        c = machine.cost_s(sched, nranks, nbytes, fidelity=fidelity)
        if name == "accel":
            accel_s = c
        else:
            sw.append((name, c))
    if not sw:
        raise ValueError(f"no software menu schedule at nranks={nranks}")
    sw.sort(key=lambda kv: kv[1])
    return sw, accel_s


def search_cell(machine, nbytes: int, nranks: int, *, op: str = "allreduce",
                pop: int = 32, gens: int = 8, refine: int = 2,
                seed: int = 0, fidelity: str = "sim", engine=None,
                skeleton_list: list[Term] | None = None) -> CellResult:
    """Synthesize the best schedule for one cell and gate it.

    Population search (elite quarter + decaying-scale gaussian mutation,
    seeded half-balanced half-uniform, the hillclimb loop) over
    each feasible skeleton's sigma genome, then ``refine`` rounds of
    batched coordinate descent around the incumbent.  The returned
    winner has passed the semantic contribution check and the
    interpreter agreement gate — a result that fails either raises."""
    if op != "allreduce":
        raise ValueError(f"only allreduce synthesis is wired up, got {op!r}")
    rng = np.random.default_rng(seed)
    terms = skeletons(nranks) if skeleton_list is None else skeleton_list
    if not terms:
        raise ValueError(f"no feasible skeleton at nranks={nranks}")
    sw_menu, accel_s = _menu_costs(machine, nranks, nbytes, fidelity)

    t_start = time.perf_counter()
    evals = 0
    best: tuple[float, Term] | None = None

    def evaluate(candidates: list[Term]) -> np.ndarray:
        nonlocal evals
        population = SchedulePopulation(
            [TermSchedule(t) for t in candidates], nbytes)
        costs = machine.cost_population(population, nranks,
                                        fidelity=fidelity, engine=engine)
        evals += len(candidates)
        return np.asarray(costs)

    for skel in terms:
        g0 = np.asarray(skel.genome())
        if g0.size == 0:
            cost = float(evaluate([skel])[0])
            if best is None or cost < best[0]:
                best = (cost, skel)
            continue
        # ---- population search (per-skeleton; members share structure)
        genomes = [g0] + [
            mutate(g0, 0.25, rng) if i % 2 else
            rng.uniform(SIGMA_LO, SIGMA_HI, size=g0.shape)
            for i in range(1, pop)]
        skel_best: tuple[float, np.ndarray] | None = None
        for gen in range(gens):
            costs = evaluate([skel.with_genome(g) for g in genomes])
            order = np.argsort(costs)
            if skel_best is None or costs[order[0]] < skel_best[0]:
                skel_best = (float(costs[order[0]]), genomes[order[0]])
            elite = [genomes[i] for i in order[:max(1, pop // 4)]]
            scale = 0.15 * (0.6 ** gen)
            genomes = list(elite) + [
                mutate(elite[i % len(elite)], scale, rng)
                for i in range(pop - len(elite))]
        # ---- local refinement: batched coordinate descent
        cost_b, g_b = skel_best
        for delta in ([0.08, 0.03, 0.01][:max(0, refine)]):
            cands = [g_b]
            for i in range(g_b.size):
                for sgn in (+1.0, -1.0):
                    g = g_b.copy()
                    g[i] = np.clip(g[i] + sgn * delta, SIGMA_LO, SIGMA_HI)
                    cands.append(g)
            costs = evaluate([skel.with_genome(g) for g in cands])
            j = int(np.argmin(costs))
            if costs[j] < cost_b:
                cost_b, g_b = float(costs[j]), cands[j]
        if best is None or cost_b < best[0]:
            best = (cost_b, skel.with_genome(g_b))
    elapsed = time.perf_counter() - t_start

    winner_s, winner = best
    # ---- gate 1: contribution-tracking semantic check (raises on fail)
    check_term(winner, nranks)
    # ---- gate 2: interpreter agreement with the batched fitness cost
    sched = register_term(winner)
    if fidelity == "sim" and hasattr(machine, "mpi"):
        interp_s = machine._mpi_for(nranks).run_schedule(
            sched, nbytes, nranks, backend="interp").latency_us * 1e-6
    else:
        interp_s = machine.cost_s(sched, nranks, nbytes, fidelity=fidelity)
    rel = abs(interp_s - winner_s) / max(abs(interp_s), 1e-30)
    if rel > AGREEMENT_RTOL:
        raise AssertionError(
            f"winner {sched.name} fails interp agreement: batched "
            f"{winner_s:.9e}s vs interp {interp_s:.9e}s (rel {rel:.3e})")

    return CellResult(
        op=op, nranks=int(nranks), nbytes=int(nbytes),
        placement=getattr(machine, "placement", "default"),
        machine=machine.name,
        best_menu=("accel" if accel_s is not None
                   and accel_s < sw_menu[0][1] else sw_menu[0][0]),
        best_menu_s=(min(accel_s, sw_menu[0][1]) if accel_s is not None
                     else sw_menu[0][1]),
        best_sw_menu=sw_menu[0][0], best_sw_menu_s=sw_menu[0][1],
        accel_s=accel_s,
        winner_spec=winner.spec(), winner_name=sched.name,
        winner_s=winner_s, interp_s=interp_s, agreement_rel=rel,
        evals=evals, elapsed_s=elapsed, semantic_ok=True)


def synthesize(machine, cells, *, cache: WinnerCache | None = None,
               pop: int = 32, gens: int = 8, refine: int = 2, seed: int = 0,
               fidelity: str = "sim", engine=None) -> list[CellResult]:
    """Search a list of ``(nbytes, nranks)`` cells and record winners
    that beat the software menu into ``cache`` (losers are reported in
    the results but never cached — the planner's menu already covers
    them)."""
    results = []
    for i, (nbytes, nranks) in enumerate(cells):
        res = search_cell(machine, nbytes, nranks, pop=pop, gens=gens,
                          refine=refine, seed=seed + i, fidelity=fidelity,
                          engine=engine)
        results.append(res)
        if cache is not None and res.winner_s < res.best_sw_menu_s:
            cache.put(machine.name, res.op, nranks, nbytes,
                      res.placement, spec=res.winner_spec,
                      cost_s=res.winner_s, best_menu_s=res.best_sw_menu_s,
                      menu_name=res.best_sw_menu)
    return results
