"""Discrete-event simulation substrate for the ExaNet model.

The paper's contention effects (§6.1.4: R5 firmware serialization, AXI/DMA
wire sharing, link occupancy) used to be tracked by ad-hoc ``*_free`` dicts
inside :class:`~repro_torch.core.exanet.network.Network`.  This module extracts
that bookkeeping into a proper engine:

* :class:`Resource` — a serially-reusable unit (one R5 core, one AXI/DMA
  wire, one packetizer, one link direction) with occupancy accounting.
* :class:`Engine` — owns every resource of the simulated machine, an
  optional per-send :class:`TraceEvent` log, and the **path table**: routes
  and their derived per-path constants (:class:`PathMetrics`) are computed
  once per (src, dst) pair and reused across sends, which is what makes
  paper-scale sweeps (256+ ranks) fast.

The closed-form latency/bandwidth math stays in ``network.py``; the engine
is the substrate it runs on.

Two execution backends share this substrate (DESIGN.md §2.5):

* the **interpreter** (:meth:`ExanetMPI.run_schedule`) drives
  :class:`Resource` objects one ``acquire`` at a time — the reference
  semantics;
* the **compiled executor** (:mod:`repro_torch.core.exanet.exec_compiled`)
  replays pre-lowered round programs against :class:`ResourceState` —
  array-backed ``free_at`` rows addressed by :meth:`Engine.resource_id` —
  using :func:`segmented_maxplus_scan` to serialize contending sends with
  ``maximum``-scan arithmetic instead of per-send Python calls.

The port's copy of the reference's ``repro.core.exanet.sim``, whole: the
same names, layout and float arithmetic, with its imports rewritten to
``repro_torch``. ``tests/test_torch_exanet_sim.py`` and
``tests/test_torch_exanet_compiled.py`` hold the two equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.exanet.topology import Path

#: resource kinds (the shared units of §4.4-4.5)
R5 = "r5"        # per-MPSoC R5 transaction-layer firmware
DMA = "dma"      # per-MPSoC AXI/DMA wire
PKTZ = "pktz"    # per-MPSoC packetizer
LINK = "link"    # one physical link direction
CORE = "core"    # one A53 core (per-rank compute resource: program
                 # execution charges Compute ops on it, so compute and
                 # in-flight communication overlap is accounted per rank)


class Resource:
    """A serially-reusable resource with busy-time accounting."""

    __slots__ = ("key", "free_at", "busy_us", "n_acquires")

    def __init__(self, key: tuple):
        self.key = key
        self.free_at = 0.0
        self.busy_us = 0.0
        self.n_acquires = 0

    def acquire(self, t: float, duration_us: float) -> float:
        """Acquire from time ``t`` for ``duration_us``; returns the actual
        start time (``max(t, free_at)``)."""
        start = self.free_at if self.free_at > t else t
        self.free_at = start + duration_us
        self.busy_us += duration_us
        self.n_acquires += 1
        return start


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One send through the engine (recorded when tracing is enabled)."""
    t_issue: float
    src_core: int
    dst_core: int
    nbytes: int
    transport: str          # "eager" | "rendezvous"
    t_complete: float
    t_sender_free: float


@dataclasses.dataclass(frozen=True)
class PathMetrics:
    """Route + per-path constants derived once and reused on every send.

    Besides the physical quantities, the table pins the :class:`Resource`
    objects the path touches, so the send hot loop is pure arithmetic plus
    ``Resource.acquire`` calls — no dict lookups.
    """
    path: Path
    src_mpsoc: int
    dst_mpsoc: int
    hop_latency_us: float          # links + routers + local switches
    eager_wire_us_per_byte: float  # sum of 8/(rate*1000) over the links
    rdma_bw_gbps: float            # single-stream RDMA bandwidth
    eager_pp_const_us: float       # ping-pong base + hop latency
    eager_ow_const_us: float       # one-way base + hop latency
    handshake_pp_us: float         # 2x 0-byte eager control (RTS+CTS)
    handshake_ow_us: float
    stream_us_per_byte: float      # 8/(rdma_bw*1000)
    pktz_src: Resource
    r5_src: Resource
    dma_src: Resource
    dma_dst: Resource | None       # None for intra-MPSoC loopback
    link_res: tuple                # link Resources along the path


class Engine:
    """Owns the shared resources, the path table and the optional trace.

    ``reset()`` clears occupancy state between simulated collectives but
    keeps the path table — routes do not change with time.
    """

    def __init__(self, *, trace: bool = False, cache_paths: bool = True):
        self.tracing = trace
        self.cache_paths = cache_paths
        self._resources: dict[tuple, Resource] = {}
        self._resource_ids: dict[tuple, int] = {}
        self.path_table: dict[tuple[int, int], PathMetrics] = {}
        self.trace: list[TraceEvent] = []

    # ------------------------------------------------------------- resources
    def resource(self, kind: str, ident) -> Resource:
        key = (kind, ident)
        r = self._resources.get(key)
        if r is None:
            r = self._resources[key] = Resource(key)
        return r

    def resource_id(self, kind: str, ident) -> int:
        """Stable dense integer id of a resource.  Compiled round programs
        index :class:`ResourceState` rows by these ids; the interpreter's
        :class:`Resource` objects are untouched, so both backends can name
        the same physical unit."""
        key = (kind, ident)
        rid = self._resource_ids.get(key)
        if rid is None:
            rid = self._resource_ids[key] = len(self._resource_ids)
        return rid

    @property
    def n_resource_ids(self) -> int:
        return len(self._resource_ids)

    def resource_ids_of(self, kind: str) -> dict:
        """ident -> dense id for every registered resource of ``kind``
        (the degradation axes map undirected physical-link keys onto the
        directed LINK rows of the compiled executors)."""
        return {ident: rid for (k, ident), rid in self._resource_ids.items()
                if k == kind}

    def reset(self) -> None:
        # zero in place (don't clear): PathMetrics entries hold direct
        # references to these Resource objects across collectives
        for r in self._resources.values():
            r.free_at = 0.0
            r.busy_us = 0.0
            r.n_acquires = 0
        self.trace.clear()

    # ------------------------------------------------------------ path table
    def metrics(self, src_core: int, dst_core: int):
        """Cached :class:`PathMetrics` lookup; ``None`` on miss (the caller
        builds and registers it via :meth:`register_metrics`)."""
        if not self.cache_paths:
            return None
        return self.path_table.get((src_core, dst_core))

    def register_metrics(self, m: PathMetrics) -> PathMetrics:
        if self.cache_paths:
            self.path_table[(m.path.src_core, m.path.dst_core)] = m
        return m

    # ----------------------------------------------------------------- trace
    def record(self, ev: TraceEvent) -> None:
        if self.tracing:
            self.trace.append(ev)

    # ------------------------------------------------------------- reporting
    def utilization(self, t_end: float) -> dict[tuple, float]:
        """Busy fraction of every touched resource over [0, t_end]."""
        if t_end <= 0.0:
            return {}
        return {k: r.busy_us / t_end for k, r in self._resources.items()}

    def occupancy_stats(self) -> dict[tuple, dict]:
        return {k: {"busy_us": r.busy_us, "n_acquires": r.n_acquires,
                    "free_at": r.free_at}
                for k, r in self._resources.items()}


# ---------------------------------------------------------------------------
# Array-backed resource state (the compiled executor's substrate)
# ---------------------------------------------------------------------------
class ResourceState:
    """Vectorized ``free_at`` bookkeeping: one row per engine resource id
    (:meth:`Engine.resource_id`), one trailing *batch* axis per bound
    binding — a message size of a sweep grid, a perturbed scenario of a
    Monte-Carlo batch.  ``batch`` is an int (one flat column axis, the
    common case) or a tuple of trailing dims (``(N, B)`` nests scenario
    and size axes without reshaping the caller's data).

    The compiled executor replays a whole round program against one state;
    a run starts from all-zero occupancy, exactly like ``Engine.reset()``.
    """

    __slots__ = ("free",)

    def __init__(self, n_resources: int, batch):
        shape = (n_resources,) + (tuple(batch) if isinstance(batch, tuple)
                                  else (int(batch),))
        self.free = np.zeros(shape)

    def acquire_unique(self, rows: np.ndarray, t: np.ndarray,
                       dur) -> np.ndarray:
        """Acquire resources ``rows`` (no row repeated) from times ``t``
        for ``dur``; returns the start times (``maximum(t, free)``)."""
        free = self.free[rows]
        start = np.maximum(t, free)
        self.free[rows] = start + dur
        return start

    def acquire_unique_masked(self, rows: np.ndarray, t: np.ndarray, dur,
                              active: np.ndarray) -> np.ndarray:
        """Like :meth:`acquire_unique`, but only batch elements where
        ``active`` advance the resource (an eager send never touches the
        R5/DMA rows its rendez-vous twin would)."""
        free = self.free[rows]
        start = np.maximum(t, free)
        self.free[rows] = np.where(active, start + dur, free)
        return start


def scan_take_masks(first: np.ndarray, max_group: int) -> list:
    """Precomputed per-pass combine masks of a segmented Hillis-Steele
    scan.  The flag evolution is data-independent, so a compiled program
    pays for it once per (schedule, nranks) instead of per run."""
    F = np.array(first, copy=True)
    takes = []
    s = 1
    while s < max_group:
        takes.append((s, (~F[s:])[:, None]))
        F[s:] |= F[:-s]
        s *= 2
    return takes


def segmented_maxplus_scan(dur: np.ndarray, t_plus_dur: np.ndarray,
                           first: np.ndarray, max_group: int,
                           *, takes: list | None = None, copy: bool = True
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Inclusive segmented scan of serially-reusable acquisitions.

    One acquire is the max-plus affine map ``g(f) = max(f + D, T)`` of the
    resource's free time ``f``, with ``D`` the busy duration and
    ``T = t + D`` (an inactive acquire is the identity: ``D=0, T=-inf``).
    Composition is associative — ``(D1,T1) then (D2,T2)`` is
    ``(D1+D2, max(T1+D2, T2))`` — so serialization of every contention
    group resolves in ``ceil(log2(max_group))`` Hillis-Steele passes of
    plain array arithmetic instead of a Python loop over sends.

    ``dur``/``t_plus_dur`` are ``(k, *batch)`` acquire arrays laid out so
    each resource's acquires are contiguous and in send order; ``first``
    is the (k,) segment-start mask.  The trailing batch may be any number
    of dims (``(k, B)`` size grids, ``(k, N, B)`` scenario x size
    batches); the precomputed (m, 1) combine masks broadcast over one
    trailing dim and are right-padded for deeper batches.  Returns
    ``(Dacc, Tacc)`` such that the resource is next free at
    ``maximum(F0 + Dacc_i, Tacc_i)`` after its i-th acquire, where ``F0``
    is the segment's initial free time.  ``takes`` (from
    :func:`scan_take_masks`) skips recomputing the flag evolution;
    ``copy=False`` lets the scan clobber its inputs.
    """
    D = np.array(dur, copy=True) if copy else dur
    T = np.array(t_plus_dur, copy=True) if copy else t_plus_dur
    if takes is None:
        takes = scan_take_masks(first, max_group)
    pad = T.ndim - 2
    for s, mask in takes:
        if pad > 0:
            mask = mask.reshape(mask.shape[0], *([1] * (T.ndim - 1)))
        # masked in-place ufuncs: numpy detects the self-overlap and
        # buffers internally, so this is the np.where form minus the
        # intermediate allocations (the scans are the replay hot loop)
        np.maximum(T[:-s] + D[s:], T[s:], out=T[s:], where=mask)
        np.add(D[:-s], D[s:], out=D[s:], where=mask)
    return D, T


def segmented_running_max(v: np.ndarray, takes: list) -> np.ndarray:
    """In-place segmented running maximum (the scalar-duration fast path:
    with a group-constant duration ``d``, the serialization recurrence
    collapses to ``f_after_i = (k_i+1) d + max(F0, max_j<=i (t_j - k_j d))``
    — one plain-max scan over ``v = t - k d`` instead of the (D, T)
    composition).  Like :func:`segmented_maxplus_scan`, ``v`` may carry
    any number of trailing batch dims."""
    pad = v.ndim - 2
    for s, mask in takes:
        if pad > 0:
            mask = mask.reshape(mask.shape[0], *([1] * (v.ndim - 1)))
        np.maximum(v[:-s], v[s:], out=v[s:], where=mask)
    return v
