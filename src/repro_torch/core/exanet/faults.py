"""Fault & degradation model of the ExaNeSt machine (DESIGN.md §2.10).

The paper's reliability story is hardware-level: the transaction layer
replays faulting RDMA blocks end-to-end (§4.5.3) and the 3-D torus keeps
routes available when a ring direction dies (the APEnet+ lineage).  This
module makes those operating conditions *first-class simulation inputs*:

* :class:`FaultSpec` — a frozen, canonicalized description of one degraded
  machine: dead links (mezzanine-level or intra-QFDB), dead MPSoCs, slow
  "hot" links, per-link extra latency, lossy links (loss probability ``p``
  costs the expected ``1/(1-p)`` retransmissions of the block-replay
  protocol, §4.5.3), and slow ranks (compute stragglers).
* :func:`sample_fault_spec` — deterministic Monte-Carlo fault sets for
  batched sweeps (``benchmarks/faults_sweep.py``).
* :exc:`UnroutableError` — raised by fault-aware routing
  (:meth:`repro_torch.core.exanet.topology.Topology._compute_route`) when a
  fault set cuts the network; carries the diagnosis.

Link identity is *undirected*: a physical link failure or degradation hits
both directions, so every key is normalized to ``(kind, lo, hi)`` with
``lo <= hi`` MPSoC ids.  Kind strings match
:data:`repro_torch.core.exanet.topology.INTRA_QFDB` / ``MEZZ`` (this
module keeps plain literals to stay import-free of the topology).

Structural faults (dead links/MPSoCs) change *routes* and therefore program
structure; they select a distinct degraded machine
(:meth:`repro_torch.core.machine.ExanetMachine.degraded`, cached by
:meth:`FaultSpec.signature`).  Non-structural degradation (slow/lossy
links, extra latency, slow ranks) preserves routes and rides the batched
scenario axes (``link_scale`` / ``link_latency_us`` / ``compute_scale`` of
:meth:`repro_torch.core.exanet.mpi.ExanetMPI.run_program_scenarios`).

The port's copy of the reference's ``repro.core.exanet.faults``, whole: the
same names, layout and float arithmetic, with its imports rewritten to
``repro_torch``. ``tests/test_torch_exanet_sim.py`` and
``tests/test_torch_exanet_compiled.py`` hold the two equal.
"""

from __future__ import annotations

import dataclasses
import hashlib

#: link-class literals (== topology.INTRA_QFDB / topology.MEZZ)
INTRA_QFDB = "intra_qfdb"
MEZZ = "mezz"


class UnroutableError(RuntimeError):
    """A fault set disconnects the requested (src, dst) pair.  The message
    names the cut: which ring dimension / intra-QFDB crossbar pair, and
    why both alternatives are unavailable."""


def link_key(kind: str, a: int, b: int) -> tuple[str, int, int]:
    """Normalized undirected link key ``(kind, lo, hi)``."""
    a, b = int(a), int(b)
    return (kind, a, b) if a <= b else (kind, b, a)


def _norm_links(links) -> tuple[tuple[str, int, int], ...]:
    return tuple(sorted({link_key(*k) for k in links}))


def _norm_weighted(items) -> tuple:
    """Canonicalize a mapping/iterable of (link key -> float)."""
    if hasattr(items, "items"):
        items = items.items()
    merged: dict[tuple, float] = {}
    for k, v in items:
        merged[link_key(*k)] = float(v)
    return tuple(sorted(merged.items()))


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One degraded machine, canonicalized and hashable.

    Construction accepts convenient inputs (sets/dicts/iterables, directed
    or undirected link tuples); ``__post_init__`` normalizes everything to
    sorted tuples so equal fault sets compare, hash and sign equal.
    """
    #: dead physical links, undirected ``(kind, mpsoc_a, mpsoc_b)``
    dead_links: tuple = ()
    #: dead MPSoCs (node failures): unroutable as endpoint, skipped as relay
    dead_mpsocs: tuple = ()
    #: hot/slow links: key -> bandwidth slowdown factor (>= 1)
    slow_links: tuple = ()
    #: per-link extra one-way latency in microseconds (degraded serdes,
    #: retimer retraining, firmware-level retries)
    link_extra_latency_us: tuple = ()
    #: lossy links: key -> block-loss probability in [0, 1); §4.5.3 replay
    #: makes the expected cost ``1/(1-p)`` transmissions per block
    lossy_links: tuple = ()
    #: compute stragglers: (rank, compute-time slowdown factor >= 1)
    slow_ranks: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "dead_links", _norm_links(self.dead_links))
        object.__setattr__(self, "dead_mpsocs",
                           tuple(sorted({int(m) for m in self.dead_mpsocs})))
        object.__setattr__(self, "slow_links",
                           _norm_weighted(self.slow_links))
        object.__setattr__(self, "link_extra_latency_us",
                           _norm_weighted(self.link_extra_latency_us))
        object.__setattr__(self, "lossy_links",
                           _norm_weighted(self.lossy_links))
        sr = self.slow_ranks
        if hasattr(sr, "items"):
            sr = sr.items()
        object.__setattr__(self, "slow_ranks", tuple(
            sorted((int(r), float(f)) for r, f in sr)))
        for k, f in self.slow_links:
            if f < 1.0:
                raise ValueError(f"slow_links[{k}] = {f} < 1 (a factor "
                                 "below 1 would be a speedup)")
        for k, p in self.lossy_links:
            if not 0.0 <= p < 1.0:
                raise ValueError(f"lossy_links[{k}] = {p} outside [0, 1)")
        # derived lookup structures (identity-level, excluded from eq/hash)
        object.__setattr__(self, "_dead_links", frozenset(self.dead_links))
        object.__setattr__(self, "_dead_mpsocs",
                           frozenset(self.dead_mpsocs))
        slow = {k: f for k, f in self.slow_links}
        for k, p in self.lossy_links:
            slow[k] = slow.get(k, 1.0) / (1.0 - p)
        object.__setattr__(self, "_slow", slow)
        object.__setattr__(self, "_extra",
                           dict(self.link_extra_latency_us))

    # ------------------------------------------------------------- queries
    @property
    def is_empty(self) -> bool:
        return not (self.dead_links or self.dead_mpsocs or self.slow_links
                    or self.link_extra_latency_us or self.lossy_links
                    or self.slow_ranks)

    @property
    def degrades_structure(self) -> bool:
        """Do routes change?  Dead links/MPSoCs reroute; everything else
        only rescales the existing paths."""
        return bool(self.dead_links or self.dead_mpsocs)

    def is_dead_link(self, kind: str, a: int, b: int) -> bool:
        return link_key(kind, a, b) in self._dead_links

    def is_dead_mpsoc(self, mpsoc: int) -> bool:
        return mpsoc in self._dead_mpsocs

    def link_slow(self, kind: str, a: int, b: int) -> float:
        """Combined bandwidth slowdown (hot-link factor x §4.5.3 replay
        expectation) of one link; 1.0 when undegraded."""
        return self._slow.get(link_key(kind, a, b), 1.0)

    def link_extra_us(self, kind: str, a: int, b: int) -> float:
        return self._extra.get(link_key(kind, a, b), 0.0)

    def degraded_link_keys(self) -> tuple:
        """Every link key carrying non-structural degradation."""
        return tuple(sorted(set(self._slow) | set(self._extra)))

    def rank_compute_scale(self, nranks: int):
        """(nranks,) per-rank compute-time multipliers for the slow-rank
        class — feeds the existing ``compute_scale`` scenario axis."""
        import numpy as np
        s = np.ones(nranks)
        for r, f in self.slow_ranks:
            if 0 <= r < nranks:
                s[r] = f
        return s

    # ----------------------------------------------------------- signature
    def signature(self) -> str:
        """Deterministic short id of this fault set — the cache key that
        scopes degraded machines, their compiled artifacts and planner
        winners (DESIGN.md §2.10).  ``"healthy"`` for the empty spec."""
        if self.is_empty:
            return "healthy"
        canon = repr((self.dead_links, self.dead_mpsocs, self.slow_links,
                      self.link_extra_latency_us, self.lossy_links,
                      self.slow_ranks)).encode()
        digest = hashlib.sha256(canon).hexdigest()[:10]
        return (f"f{len(self.dead_links)}l{len(self.dead_mpsocs)}m"
                f"{len(self.slow_links) + len(self.lossy_links)}s"
                f"{len(self.slow_ranks)}r-{digest}")


#: the healthy machine (empty spec)
HEALTHY = FaultSpec()


def batch_fault_axes(specs, prog=None) -> dict:
    """Fold N *non-structural* FaultSpecs into the scenario axes of one
    batched replay: column ``j`` carries ``specs[j]``'s degradation, every
    other column holds 1/0 on that link.  Returns kwargs for
    :meth:`~repro_torch.core.exanet.mpi.ExanetMPI.run_program_scenarios`
    (``link_scale`` / ``link_latency_us`` / ``compute_scale``, omitting
    empty axes).  Specs with ``slow_ranks`` need ``prog`` — the
    ``compute_scale`` axis is per *Compute post* (rank-major program
    order), so each rank's multiplier repeats across its compute ops.
    Structural specs are rejected — dead links change routes and need a
    degraded machine per fault signature, not a column (DESIGN.md
    §2.10)."""
    import numpy as np
    specs = list(specs)
    N = len(specs)
    slow: dict = {}
    extra: dict = {}
    any_ranks = False
    for j, s in enumerate(specs):
        if s.degrades_structure:
            raise ValueError(
                f"specs[{j}] kills links/MPSoCs (signature "
                f"{s.signature()}): structural faults reroute and must "
                "run on a degraded machine, not a batch column")
        for k in s.degraded_link_keys():
            f = s.link_slow(*k)
            if f != 1.0:
                slow.setdefault(k, np.ones(N))[j] = f
            e = s.link_extra_us(*k)
            if e:
                extra.setdefault(k, np.zeros(N))[j] = e
        any_ranks = any_ranks or bool(s.slow_ranks)
    axes: dict = {}
    if slow:
        axes["link_scale"] = slow
    if extra:
        axes["link_latency_us"] = extra
    if any_ranks:
        if prog is None:
            raise ValueError("specs carry slow_ranks; pass the Program so "
                             "the per-compute-post compute_scale axis can "
                             "be shaped")
        from repro_torch.core.program import Compute
        counts = [sum(isinstance(op, Compute) for op in ops)
                  for ops in prog.rank_ops]
        per_rank = np.stack([s.rank_compute_scale(prog.nranks)
                             for s in specs], axis=1)     # (nranks, N)
        axes["compute_scale"] = np.repeat(per_rank, counts, axis=0)
    return axes


# --------------------------------------------------------------- samplers
def all_link_keys(topo) -> list[tuple[str, int, int]]:
    """Every physical link of a topology as a normalized key: the full
    intra-QFDB crossbar plus the +1-neighbour mezzanine-level torus links
    (each undirected link listed once)."""
    keys: set = set()
    for q in range(topo.n_qfdbs):
        base = q * topo.fpgas_per_qfdb
        for i in range(topo.fpgas_per_qfdb):
            for j in range(i + 1, topo.fpgas_per_qfdb):
                keys.add(link_key(INTRA_QFDB, base + i, base + j))
        x, y, z = topo.qfdb_coords(q)
        here = topo.network_mpsoc(q)
        for nq in ((x + 1) % topo.qfdbs_per_mezz, y, z), \
                  (x, (y + 1) % topo.mezz_y, z), \
                  (x, y, (z + 1) % topo.mezz_z):
            other = topo.network_mpsoc(topo.coords_to_qfdb(*nq))
            if other != here:
                keys.add(link_key(MEZZ, here, other))
    return sorted(keys)


def sample_fault_spec(rng, topo, *, n_dead_links: int = 0,
                      n_dead_mpsocs: int = 0, n_slow_links: int = 0,
                      slow_factor: tuple[float, float] = (2.0, 8.0),
                      n_lossy_links: int = 0,
                      loss_prob: tuple[float, float] = (0.02, 0.3),
                      n_slow_ranks: int = 0, nranks: int | None = None,
                      rank_factor: tuple[float, float] = (2.0, 6.0),
                      extra_latency_us: float = 0.0) -> FaultSpec:
    """One Monte-Carlo fault set drawn from ``rng``
    (:class:`numpy.random.Generator`).  Dead MPSoCs avoid Network MPSoCs
    so a single sample rarely cuts a whole QFDB (a cut raises
    :exc:`UnroutableError` at route time, which the fuzz tests cover by
    sampling network MPSoCs explicitly)."""
    links = all_link_keys(topo)
    picked = [links[i] for i in rng.choice(
        len(links), size=min(n_dead_links + n_slow_links + n_lossy_links,
                             len(links)), replace=False)]
    dead = picked[:n_dead_links]
    hot = picked[n_dead_links:n_dead_links + n_slow_links]
    lossy = picked[n_dead_links + n_slow_links:]
    non_net = [m for m in range(topo.n_mpsocs)
               if m % topo.fpgas_per_qfdb != 0]
    dead_mpsocs = [non_net[i] for i in rng.choice(
        len(non_net), size=min(n_dead_mpsocs, len(non_net)),
        replace=False)] if n_dead_mpsocs else []
    slow_links = {k: float(rng.uniform(*slow_factor)) for k in hot}
    lossy_links = {k: float(rng.uniform(*loss_prob)) for k in lossy}
    extra = {k: extra_latency_us for k in hot} if extra_latency_us else {}
    n = nranks if nranks is not None else topo.n_cores
    ranks = rng.choice(n, size=min(n_slow_ranks, n), replace=False) \
        if n_slow_ranks else []
    slow_ranks = {int(r): float(rng.uniform(*rank_factor)) for r in ranks}
    return FaultSpec(dead_links=dead, dead_mpsocs=dead_mpsocs,
                     slow_links=slow_links, link_extra_latency_us=extra,
                     lossy_links=lossy_links, slow_ranks=slow_ranks)
