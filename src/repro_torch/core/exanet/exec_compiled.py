"""Compiled execution backend: collective schedules as vectorized programs.

The interpreter
(:meth:`repro_torch.core.exanet.mpi.ExanetMPI.run_schedule`) walks
every send of a schedule through a Python call chain (``Network._send`` →
per-resource ``Resource.acquire``), which caps paper-scale sweeps at ~1M
simulated sends/sec.  This module lowers a schedule's rounds — for a fixed
(nranks, rank placement, topology) — into a cached :class:`RoundProgram` of
NumPy arrays, then replays them with array arithmetic:

* **compile** (once per schedule x nranks): per-send src/dst indices, the
  gathered :class:`PathMetrics` constants (hop latency, wire us/byte,
  handshake constants, stream us/byte) and the shared-resource rows each
  send touches (:meth:`Engine.resource_id`), plus the *level* decomposition
  described below;
* **bind** (once per message-size grid): per-round byte counts, reduce
  sizes and eager/rendez-vous transport flags for every size in the batch —
  the program structure is byte-size parameterized, so one compiled program
  serves a whole message-size sweep as one batched run;
* **execute**: per round, resource contention resolves through
  :func:`repro_torch.core.exanet.sim.segmented_maxplus_scan` (grouped running
  maxima) against an array-backed :class:`ResourceState` instead of per-send
  Python calls.

Exactness
=========
The interpreter stays the reference semantics; the compiled executor must
match it to ~1e-9 relative (enforced by ``tests/test_exec_compiled.py`` and
the hypothesis property test).  Two constructions make that possible:

* Within one round, the interpreter acquires every resource in *send
  order*.  Acquires of one resource from the same pipeline stage (e.g. the
  four ranks of an MPSoC hitting its R5 in a rendez-vous round) compose
  associatively in max-plus arithmetic, so a whole contention group
  resolves in one segmented scan.
* Acquires of one resource from *different* stages (a DMA engine that is
  send A's source and send B's destination, a link crossed at hop 1 by one
  path and hop 3 by another) cannot be reordered stage-major.  At compile
  time each round is split into **levels**: send j lands one level after
  send i whenever a shared resource is touched at different stages (or, in
  one-way rounds, when j's issue clock reads a rank i just wrote).  Levels
  execute in order; within a level only same-stage sharing remains, which
  the scans serialize in send order — reproducing the interpreter's
  acquisition order exactly.

The port's copy of the reference's ``repro.core.exanet.exec_compiled``,
whole: the same names, layout and float arithmetic, with its imports
rewritten to ``repro_torch``. Its scan lanes are ``"numpy"`` and
``"torch"`` (:mod:`repro_torch.core.exanet.scan_engine`).
``tests/test_torch_exanet_sim.py`` and
``tests/test_torch_exanet_compiled.py`` hold the two equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.exanet.scan_engine import NUMPY, resolve_engine
from repro_torch.core.exanet.sim import ResourceState, scan_take_masks

NEG_INF = float("-inf")


class ProgramStructureError(ValueError):
    """A schedule's round structure changed with message size, so one
    compiled program cannot serve the requested size grid (the ``auto``
    backend falls back to the interpreter)."""


# ---------------------------------------------------------------------------
# compile-time pieces
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Stage:
    """One pipeline stage of a level: which sends acquire which resource
    rows, laid out contiguously per contention group in send order."""
    sperm: np.ndarray       # (m,) indices into the level's send arrays
    rows: np.ndarray        # (m,) resource row per acquire (sperm order)
    first: np.ndarray       # (m,) segment-start mask
    last: np.ndarray        # (m,) segment-end mask
    max_group: int
    takes: list             # precomputed Hillis-Steele combine masks
    kpos: np.ndarray        # (m, 1) within-group ordinal
    kpos1: np.ndarray       # (m, 1) ordinal + 1
    #: duration constant within every group (per batch column) — enables
    #: the running-max fast path when activity is also column-uniform
    pb_uniform: bool


def _make_stage(positions, rows, pb=None, span=None,
                force_grouped=False) -> _Stage | None:
    """Sort (level-position, resource-row) acquires into grouped layout;
    ``pb`` (per-byte duration factors) marks whether durations are
    group-constant for the scan fast path.  Contention-free stages skip
    the grouped layout entirely (acquire order is irrelevant when no row
    repeats); a full-cover contention-free stage (``span`` == stage size)
    keeps the level's own array order (``sperm`` None)."""
    m = len(positions)
    if m == 0:
        return None
    positions = np.asarray(positions, dtype=np.int64)
    rows = np.asarray(rows, dtype=np.int64)
    if not force_grouped and len(np.unique(rows)) == m:
        sperm = None if span == m else positions
        return _Stage(sperm, rows, None, None, 1, [], None, None, True)
    order = np.argsort(rows, kind="stable")   # stable: keeps send order
    sperm = positions[order]
    rows = rows[order]
    first = np.empty(m, dtype=bool)
    first[0] = True
    first[1:] = rows[1:] != rows[:-1]
    last = np.empty(m, dtype=bool)
    last[-1] = True
    last[:-1] = first[1:]
    seg = np.cumsum(first) - 1
    max_group = int(np.bincount(seg).max())
    idx = np.arange(m)
    kpos = idx - np.maximum.accumulate(np.where(first, idx, 0))
    if pb is None:
        pb_uniform = True
    else:
        ps = np.asarray(pb)[order]
        nf = np.flatnonzero(~first)
        pb_uniform = bool((ps[nf] == ps[nf - 1]).all())
    return _Stage(sperm, rows, first, last, max_group,
                  scan_take_masks(first, max_group),
                  kpos[:, None].astype(np.float64),
                  (kpos + 1)[:, None].astype(np.float64), pb_uniform)


def _dst_grouping(dst, positions=None):
    """(perm, reduceat starts, unique dst) for grouped running maxima;
    ``positions`` restricts (and renames) the contributing indices."""
    dst = np.asarray(dst, dtype=np.int64)
    if positions is None:
        positions = np.arange(len(dst), dtype=np.int64)
    if len(dst) == 0:
        return None, None, None
    perm = positions[np.argsort(dst, kind="stable")]
    sd = np.sort(dst, kind="stable")
    first = np.empty(len(sd), dtype=bool)
    first[0] = True
    first[1:] = sd[1:] != sd[:-1]
    return perm, np.flatnonzero(first), sd[first]


@dataclasses.dataclass
class _Level:
    sel: np.ndarray                  # (k,) round-send indices, ascending
    # per-send constants, shaped (k, 1) for broadcasting over the batch
    e_const: np.ndarray
    eager_pb: np.ndarray
    handshake: np.ndarray
    stream_pb: np.ndarray
    hop: np.ndarray
    pktz: _Stage
    r5: _Stage
    dsrc: _Stage
    links: list                      # list[_Stage] per link position
    ddst: _Stage | None
    # one-way epilogue (None for exchange rounds)
    src_ranks: np.ndarray | None
    dst_perm: np.ndarray | None
    dst_starts: np.ndarray | None
    udst: np.ndarray | None
    # raw per-send link data (k, L) / (k,), -1/0-padded: lets a batched
    # link-degradation axis (:class:`LinkDegrade`) recompute the derived
    # constants per column at run time (DESIGN.md §2.10)
    link_ids: np.ndarray | None = None
    link_rate: np.ndarray | None = None
    link_wire: np.ndarray | None = None
    n_links: np.ndarray | None = None


@dataclasses.dataclass
class _EagerRound:
    """Round-wide eager transport of an exchange round: the packetizer is
    only ever shared same-stage, so the eager branch never needs the level
    decomposition and runs once per round."""
    pktz: _Stage
    e_const: np.ndarray
    eager_pb: np.ndarray
    # raw link data for the batched degradation axis (eager sends pay the
    # per-link serialization + extra latency, but no stream/handshake)
    link_ids: np.ndarray | None = None
    link_rate: np.ndarray | None = None
    n_links: np.ndarray | None = None


class LinkDegrade:
    """Per-(link, batch-column) degradation: the new binding axes of the
    batched substrate (DESIGN.md §2.10).  ``slow``/``extra_us`` are
    ``(n_resource_rows, N)`` arrays indexed by :meth:`Engine.resource_id`
    LINK rows: ``slow`` divides a link's serialization rate and sustained
    wire bandwidth (bandwidth-scale axis), ``extra_us`` adds per-link
    one-way latency (latency axis).

    At run time every level's derived constants are recomputed per column
    with the *same formulas* ``Network.path_metrics`` uses — per-link
    eager serialization summed, bottleneck wire bandwidth through the
    §6.1.1 16KB-block RDMA formula, handshake/hop picking up the extra
    latency — so an all-ones column is bit-identical to the undegraded
    constants and the interpreter twin agrees to ~1e-9 under degradation.
    Loopback sends (no links) are AXI-bound and keep their base constants.
    """

    def __init__(self, slow, extra_us, p):
        self.slow = np.asarray(slow, dtype=np.float64)
        self.extra = np.asarray(extra_us, dtype=np.float64)
        if self.slow.shape != self.extra.shape:
            raise ValueError(f"slow {self.slow.shape} != extra "
                             f"{self.extra.shape}")
        self.ncols = self.slow.shape[1]
        self._block_bits = p.rdma_block_bytes * 8.0
        self._gap_us = p.rdma_block_gap_us
        self._cache: dict[int, dict] = {}

    def column(self, j: int) -> "LinkDegrade":
        """A one-column view (the per-binding reference lane)."""
        return LinkDegrade(self.slow[:, j:j + 1], self.extra[:, j:j + 1],
                           _ParamsView(self._block_bits, self._gap_us))

    def consts(self, lv) -> dict:
        """Recomputed per-column constants of one level (cached per level
        object: levels are compile-time artifacts that outlive runs)."""
        out = self._cache.get(id(lv))
        if out is not None:
            return out
        ids = lv.link_ids
        if ids is None or ids.size == 0:
            out = {"e_const": lv.e_const, "eager_pb": lv.eager_pb}
            if hasattr(lv, "handshake"):
                out.update(handshake=lv.handshake, stream_pb=lv.stream_pb,
                           hop=lv.hop)
            self._cache[id(lv)] = out
            return out
        mask = ids >= 0                                    # (k, L)
        idx = np.where(mask, ids, 0)
        s = self.slow[idx]                                 # (k, L, N)
        ex = np.where(mask[..., None], self.extra[idx], 0.0)
        exsum = ex.sum(axis=1)                             # (k, N)
        rate = np.where(mask[..., None], lv.link_rate[..., None], np.inf)
        pb = 8.0 / ((rate / s) * 1000.0)   # exactly 0.0 on padding
        has = (lv.n_links > 0)[:, None]
        out = {"e_const": lv.e_const + exsum,
               "eager_pb": np.where(has, pb.sum(axis=1), lv.eager_pb)}
        if hasattr(lv, "handshake"):                       # full _Level
            wire = np.where(mask[..., None],
                            lv.link_wire[..., None] / s, np.inf)
            wmin = wire.min(axis=1)                        # (k, N)
            t_block = self._block_bits / (wmin * 1000.0) + self._gap_us
            bw = self._block_bits / t_block / 1000.0
            out["handshake"] = lv.handshake + 2.0 * exsum
            out["stream_pb"] = np.where(has, 8.0 / (bw * 1000.0),
                                        lv.stream_pb)
            out["hop"] = lv.hop + exsum
        self._cache[id(lv)] = out
        return out


@dataclasses.dataclass
class _ParamsView:
    """The two HwParams fields :class:`LinkDegrade` needs, for views."""
    _block_bits: float
    _gap_us: float

    @property
    def rdma_block_bytes(self) -> float:
        return self._block_bits / 8.0

    @property
    def rdma_block_gap_us(self) -> float:
        return self._gap_us


def _deg_col(a: np.ndarray, cols) -> np.ndarray:
    """Column-subset a degraded (k, N) constant; (k, 1) arrays broadcast
    over any subset and pass through untouched."""
    return a if cols is None or a.shape[1] == 1 else a[:, cols]


@dataclasses.dataclass
class _LoweredRound:
    src: np.ndarray
    dst: np.ndarray
    exchange: bool
    sync: bool
    levels: list
    eager: _EagerRound | None = None
    # exchange epilogue
    src_perm: np.ndarray | None = None
    src_starts: np.ndarray | None = None
    usrc: np.ndarray | None = None
    dst_perm: np.ndarray | None = None
    dst_starts: np.ndarray | None = None
    udst: np.ndarray | None = None
    participants: np.ndarray | None = None
    ack: _Stage | None = None
    ack_first_of_sender: np.ndarray | None = None   # (m,) sperm-order mask
    ack_src: np.ndarray | None = None               # (m,) sender rank
    ack_last_pos: np.ndarray | None = None          # positions of last send
    ack_senders: np.ndarray | None = None           # rank per last position
    # one-way epilogue
    round_udst: np.ndarray | None = None


@dataclasses.dataclass
class _BoundRound:
    nb: np.ndarray          # (1, B) uniform-bytes round, else (n, B)
    t_red: np.ndarray       # (B,)
    penalty: np.ndarray     # (B,)
    rdv_round: np.ndarray   # (B,) bool — the interpreter's first-send rule
    is_rdv: np.ndarray      # per-send transport mask, same shape as nb
    col_uniform: bool       # transport uniform within each batch column
    any_e: bool
    any_r: bool
    cols_e: np.ndarray | None   # eager batch columns (mixed uniform rounds)
    cols_r: np.ndarray | None


@dataclasses.dataclass
class _BoundProgram:
    sizes: tuple
    rounds: list
    pre_copy_us: np.ndarray   # (B,)
    post_copy_us: np.ndarray  # (B,)


@dataclasses.dataclass
class BatchScheduleResult:
    """One compiled replay over a message-size grid."""
    sizes: tuple
    latency_us: np.ndarray     # (B,)
    clocks: np.ndarray         # (B, nranks) per-rank completion times
    round_heads: list          # first (src, dst) per non-empty round

    @property
    def n_rounds(self) -> int:
        return len(self.round_heads)


def _send_res_tags(pm, n):
    """Per-send (resource_row, stage_tag) pairs for the level analysis."""
    link_rows = pm["link_ids"]
    n_links = pm["n_links"]
    res_tags = []
    for i in range(n):
        tags = [(int(pm["pktz_id"][i]), "E"),
                (int(pm["r5_id"][i]), "R"),
                (int(pm["dma_src_id"][i]), "S")]
        for k in range(int(n_links[i])):
            tags.append((int(link_rows[i, k]), k))
        if pm["dma_dst_id"][i] >= 0:
            tags.append((int(pm["dma_dst_id"][i]), "D"))
        res_tags.append(tags)
    return res_tags


def _level_assignment(n, src, dst, res_tags, exchange):
    """Longest-path level per send (see module docstring).

    ``res_tags[i]`` lists ``(resource_row, stage_tag)`` pairs; same-tag
    sharing costs nothing extra (scans keep send order), cross-tag sharing
    forces a later level.  One-way rounds add the clock-coupling rules:
    a send reading a rank another send wrote must run in a later level.
    """
    row_tags: dict = {}
    src_lv: dict = {}
    dst_lv: dict = {}
    levels = np.zeros(n, dtype=np.int64)
    for i in range(n):
        lv = 0
        for (row, tag) in res_tags[i]:
            tags = row_tags.get(row)
            if tags:
                for t2, l2 in tags.items():
                    need = l2 if t2 == tag else l2 + 1
                    if need > lv:
                        lv = need
        if not exchange:
            a = src_lv.get(src[i])
            if a is not None and a + 1 > lv:
                lv = a + 1              # j assigned clocks[s] that i reads
            b = dst_lv.get(src[i])
            if b is not None and b + 1 > lv:
                lv = b + 1              # j max-wrote clocks[s] that i reads
            c = src_lv.get(dst[i])
            if c is not None and c > lv:
                lv = c                  # j read clocks[s_j] before i's write
        levels[i] = lv
        for (row, tag) in res_tags[i]:
            d = row_tags.setdefault(row, {})
            if d.get(tag, -1) < lv:
                d[tag] = lv
        if not exchange:
            if src_lv.get(src[i], -1) < lv:
                src_lv[src[i]] = lv
            if dst_lv.get(dst[i], -1) < lv:
                dst_lv[dst[i]] = lv
    return levels


# ---------------------------------------------------------------------------
# the vectorized transport substrate (shared by RoundProgram and the Program
# compiler in program_compiled.py)
# ---------------------------------------------------------------------------
class VecTransport:
    """The eager / rendez-vous transports over an array-backed
    :class:`ResourceState`: stage acquisition via the segmented max-plus
    scans, exactly mirroring ``Network._send``'s acquire chain.  Both
    compiled executors — collective :class:`RoundProgram`\\ s and whole
    Program-IR artifacts (:mod:`repro_torch.core.exanet.program_compiled`) —
    run their sends through these three methods, so there is exactly one
    vectorized implementation of the interpreter's transport semantics."""

    def _init_transport(self, p):
        self._p = p
        self._eng = NUMPY     # scan engine; rebound per run (engine=)
        self._deg = None      # LinkDegrade axis; rebound per run (deg=)
        self._eager_max = p.mpi_eager_max_bytes
        self._pktz_occ = p.pktz_occupancy_us
        self._pktz_ret = p.pktz_occupancy_us + p.a53_call_overhead_us
        self._r5_occ = p.r5_occupancy_us
        self._rdma_startup = p.rdma_startup_us

    def _stage_acquire(self, state, st, t, dur, act, dur_const, cols):
        """Acquire one stage; ``t`` is the branch's (k, Bc) issue array,
        result is the start times in ``st.sperm`` order (level order when
        ``sperm`` is None — a contention-free full-cover stage).

        ``act`` is the per-send activity mask (None = all active; only
        non-column-uniform rounds mask).  ``cols`` restricts the acquire
        to a batch-column subset (the transport split of a mixed
        column-uniform round).  ``dur_const`` promises the duration is
        group-constant per column, unlocking the running-max fast path.
        """
        gather = st.sperm is not None
        ts = t[st.sperm] if gather else t
        scalar_dur = not isinstance(dur, np.ndarray)
        ds = dur if scalar_dur or not gather else dur[st.sperm]
        rows = st.rows
        if st.max_group == 1:
            if cols is not None:
                ix = (rows[:, None], cols[None, :])
                free = state.free[ix]
                start = np.maximum(ts, free)
                state.free[ix] = start + ds
                return start
            if act is None:
                return state.acquire_unique(rows, ts, ds)
            return state.acquire_unique_masked(
                rows, ts, ds, act[st.sperm] if gather else act)
        if cols is not None:
            ix = (rows[:, None], cols[None, :])
            F0 = state.free[ix]
        else:
            F0 = state.free[rows]
        if dur_const and act is None:
            # group-constant durations: one plain running-max scan
            v = self._eng.running_max(ts - st.kpos * ds, st.takes)
            f_after = np.maximum(v, F0) + st.kpos1 * ds
        else:
            if act is None:
                D, T = np.array(ds, copy=True), ts + ds
                if D.shape != T.shape:
                    D = np.broadcast_to(D, T.shape).copy()
            else:
                asub = act[st.sperm] if gather else act
                D = np.where(asub, ds, 0.0)
                T = np.where(asub, ts + ds, NEG_INF)
            Dacc, Tacc = self._eng.maxplus_scan(D, T, st.takes)
            f_after = np.maximum(F0 + Dacc, Tacc)
        if cols is not None:
            state.free[(rows[st.last][:, None], cols[None, :])] = \
                f_after[st.last]
        else:
            state.free[rows[st.last]] = f_after[st.last]
        return f_after - ds

    def _run_eager(self, state, lv, t_issue, nbl, act, cols):
        """The packetizer/mailbox transport: (complete, sender_free)."""
        if self._deg is None:
            e_const, eager_pb = lv.e_const, lv.eager_pb
        else:
            c = self._deg.consts(lv)
            e_const = _deg_col(c["e_const"], cols)
            eager_pb = _deg_col(c["eager_pb"], cols)
        st = lv.pktz
        r = self._stage_acquire(state, st, t_issue, self._pktz_occ, act,
                                True, cols)
        if st.sperm is None:
            dep = r
        else:
            dep = np.empty(t_issue.shape)
            dep[st.sperm] = r
        comp = dep + e_const + nbl * eager_pb
        return comp, dep + self._pktz_ret

    def _run_rdv(self, state, lv, t_issue, nbl, act, cols, uni):
        """The RTS/CTS + RDMA transport: (complete, complete)."""
        if self._deg is None:
            handshake, stream_pb, hop = lv.handshake, lv.stream_pb, lv.hop
        else:
            # per-column constants: the group-constant-duration fast path
            # no longer applies, force the exact max-plus general path
            c = self._deg.consts(lv)
            handshake = _deg_col(c["handshake"], cols)
            stream_pb = _deg_col(c["stream_pb"], cols)
            hop = _deg_col(c["hop"], cols)
            uni = False
        stream = nbl * stream_pb
        st = lv.r5
        r = self._stage_acquire(state, st, t_issue + handshake,
                                self._r5_occ, act, True, cols)
        if st.sperm is None:
            cur = r + self._rdma_startup
        else:
            cur = np.empty(t_issue.shape)
            cur[st.sperm] = r
            cur += self._rdma_startup
        st = lv.dsrc
        s0 = self._stage_acquire(state, st, cur, stream, act,
                                 uni and st.pb_uniform, cols)
        if st.sperm is None:
            cur = s0
        else:
            cur[st.sperm] = s0
        occupied = cur + stream
        for st in lv.links:
            s0 = self._stage_acquire(state, st, cur, stream, act,
                                     uni and st.pb_uniform, cols)
            cur[st.sperm] = s0
            occupied[st.sperm] = s0 + stream[st.sperm]
        st = lv.ddst
        if st is not None:
            s0 = self._stage_acquire(state, st, cur, stream, act,
                                     uni and st.pb_uniform, cols)
            occupied[st.sperm] = s0 + stream[st.sperm]
        comp = occupied + hop
        return comp, comp


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------
class RoundProgram(VecTransport):
    """A schedule lowered for one (nranks, placement, topology)."""

    def __init__(self, net, sched, cores, nranks):
        self.schedule_name = getattr(sched, "name", type(sched).__name__)
        self.one_way = bool(sched.one_way)
        self.nranks = nranks
        self.cores = list(cores)
        self._init_transport(net.p)
        self.round_heads: list = []
        self.rounds: list = []
        self._bind_cache: dict = {}
        self._size_cache: dict = {}
        self._compile(net, sched)
        self.n_rows = net.engine.n_resource_ids

    # ----------------------------------------------------------- compilation
    def _compile(self, net, sched):
        one_way = self.one_way
        structure = []
        for rnd in sched.rounds(self.nranks, _STRUCT_SIZE):
            if not rnd.sends:
                continue
            structure.append(rnd)
        for rnd in structure:
            self.round_heads.append(rnd.sends[0][:2])
            self.rounds.append(self._lower_round(net, rnd, one_way))

    def _lower_round(self, net, rnd, one_way):
        src = np.array([s for (s, _, _) in rnd.sends], dtype=np.int64)
        dst = np.array([d for (_, d, _) in rnd.sends], dtype=np.int64)
        n = len(src)
        pairs = [(self.cores[s], self.cores[d]) for (s, d, _) in rnd.sends]
        pm = net.path_metrics_arrays(pairs)
        e_const = pm["eager_ow_const_us"] if one_way else \
            pm["eager_pp_const_us"]
        handshake = pm["handshake_ow_us"] if one_way else \
            pm["handshake_pp_us"]
        link_rows = pm["link_ids"]
        n_links = pm["n_links"]
        max_links = int(n_links.max()) if n else 0

        levels_of = _level_assignment(n, src, dst, _send_res_tags(pm, n),
                                      rnd.exchange)

        levels = []
        for lv in range(int(levels_of.max()) + 1 if n else 0):
            sel = np.flatnonzero(levels_of == lv)
            k = len(sel)
            pos = np.arange(k)
            link_stages = []
            for pos_k in range(max_links):
                sub = np.flatnonzero(n_links[sel] > pos_k)
                link_stages.append(_make_stage(
                    pos[sub], link_rows[sel[sub], pos_k],
                    pm["stream_us_per_byte"][sel[sub]]))
            ddst_sub = np.flatnonzero(pm["dma_dst_id"][sel] >= 0)
            if rnd.exchange:
                src_ranks = dperm = dstarts = udst = None
            else:
                src_ranks = src[sel]
                # a self-send's receive clock is overwritten by its own
                # sender-side assignment (the interpreter maxes clocks[d]
                # *before* assigning clocks[s]), so it never contributes
                keep = np.flatnonzero(src[sel] != dst[sel])
                dperm, dstarts, udst = _dst_grouping(dst[sel[keep]], keep)
            spb = pm["stream_us_per_byte"][sel]
            levels.append(_Level(
                sel=sel,
                e_const=e_const[sel][:, None],
                eager_pb=pm["eager_wire_us_per_byte"][sel][:, None],
                handshake=handshake[sel][:, None],
                stream_pb=spb[:, None],
                hop=pm["hop_latency_us"][sel][:, None],
                # exchange rounds run their eager branch round-wide
                pktz=None if rnd.exchange else
                _make_stage(pos, pm["pktz_id"][sel], span=k),
                r5=_make_stage(pos, pm["r5_id"][sel], span=k),
                dsrc=_make_stage(pos, pm["dma_src_id"][sel], spb, span=k),
                links=[st for st in link_stages if st is not None],
                ddst=_make_stage(ddst_sub, pm["dma_dst_id"][sel[ddst_sub]],
                                 spb[ddst_sub]),
                src_ranks=src_ranks, dst_perm=dperm, dst_starts=dstarts,
                udst=udst,
                link_ids=link_rows[sel],
                link_rate=pm["link_rate_gbps"][sel],
                link_wire=pm["link_wire_gbps"][sel],
                n_links=n_links[sel]))

        out = _LoweredRound(src=src, dst=dst, exchange=rnd.exchange,
                            sync=rnd.sync, levels=levels)
        if rnd.exchange:
            out.eager = _EagerRound(
                _make_stage(np.arange(n), pm["pktz_id"], span=n),
                e_const[:, None], pm["eager_wire_us_per_byte"][:, None],
                link_ids=link_rows, link_rate=pm["link_rate_gbps"],
                n_links=n_links)
            out.src_perm, out.src_starts, out.usrc = _dst_grouping(src)
            out.dst_perm, out.dst_starts, out.udst = _dst_grouping(dst)
            out.participants = np.unique(np.concatenate([src, dst]))
            # end-to-end-ACK phase: one R5 invocation per send, in send
            # order, serialized per MPSoC (§4.5.2)
            ack = _make_stage(np.arange(n), pm["r5_id"],
                              force_grouped=True)
            ack_src = src[ack.sperm]
            seen: set = set()
            first_of_sender = np.zeros(n, dtype=bool)
            last_pos: dict = {}
            for j in range(n):
                s = int(ack_src[j])
                if s not in seen:
                    seen.add(s)
                    first_of_sender[j] = True
                last_pos[s] = j
            out.ack = ack
            out.ack_src = ack_src
            out.ack_first_of_sender = first_of_sender
            out.ack_last_pos = np.array(sorted(last_pos.values()),
                                        dtype=np.int64)
            out.ack_senders = ack_src[out.ack_last_pos]
        else:
            out.round_udst = np.unique(dst)
        return out

    # ----------------------------------------------------------------- bind
    def _round_bytes(self, sched, size, cache=True):
        """Per-round byte data for one size, verifying the structure."""
        cached = self._size_cache.get(size) if cache else None
        if cached is not None:
            return cached
        per_round = []
        rid = 0
        for rnd in sched.rounds(self.nranks, size):
            if not rnd.sends:
                continue
            if rid >= len(self.rounds):
                raise ProgramStructureError(
                    f"{self.schedule_name}: round count varies with size")
            r = self.rounds[rid]
            nb = np.fromiter((b for (_, _, b) in rnd.sends),
                             dtype=np.float64, count=len(rnd.sends))
            if (len(nb) != len(r.src) or rnd.exchange != r.exchange
                    or rnd.sync != r.sync):
                raise ProgramStructureError(
                    f"{self.schedule_name}: round shape varies with size")
            s2 = np.fromiter((s for (s, _, _) in rnd.sends),
                             dtype=np.int64, count=len(nb))
            d2 = np.fromiter((d for (_, d, _) in rnd.sends),
                             dtype=np.int64, count=len(nb))
            if not (np.array_equal(s2, r.src) and np.array_equal(d2, r.dst)):
                raise ProgramStructureError(
                    f"{self.schedule_name}: send structure varies with size")
            uniform = bool((nb == nb[0]).all())
            per_round.append((nb[:1] if uniform else nb,
                              float(rnd.reduce_bytes), float(nb[0])))
            rid += 1
        if rid != len(self.rounds):
            raise ProgramStructureError(
                f"{self.schedule_name}: round count varies with size")
        data = (per_round, float(sched.pre_copy_bytes(size)),
                float(sched.post_copy_bytes(size)))
        if cache:
            self._size_cache[size] = data
        return data

    def _copy_us(self, nb):
        p = self._p
        return np.where(nb > 0,
                        nb / p.a53_copy_bw_bytes_per_us
                        + p.a53_call_overhead_us, 0.0)

    def _reduce_us(self, nb):
        p = self._p
        return np.where(nb > 0,
                        3.0 * nb / p.a53_copy_bw_bytes_per_us
                        + p.a53_call_overhead_us, 0.0)

    def bind(self, sched, sizes, cache=True) -> _BoundProgram:
        """Per-size byte counts, transport flags and endpoint copy costs
        for a size grid; cached, so a repeated sweep only pays once.

        ``cache=False`` bypasses both the bind and per-size byte caches:
        population binding (DESIGN.md §2.8) reuses one lowered program
        across search generations while the payload behind each member
        *token* changes, so cached byte grids would be stale."""
        key = tuple(int(s) for s in sizes)
        bound = self._bind_cache.get(key) if cache else None
        if bound is not None:
            return bound
        per_size = [self._round_bytes(sched, s, cache) for s in key]
        p = self._p
        rounds = []
        for rid in range(len(self.rounds)):
            cols = [ps[0][rid][0] for ps in per_size]
            uniform = all(c.shape[0] == 1 for c in cols)
            if uniform:
                nb = np.array([c[0] for c in cols])[None, :]
            else:
                n = len(self.rounds[rid].src)
                nb = np.stack([np.broadcast_to(c, (n,)) for c in cols],
                              axis=1)
            red = np.array([ps[0][rid][1] for ps in per_size])
            first_b = np.array([ps[0][rid][2] for ps in per_size])
            rdv = first_b > self._eager_max
            penalty = np.where(rdv, p.sendrecv_sw_rdv_us,
                               p.sendrecv_sw_eager_us)
            is_rdv = nb > self._eager_max
            col_uniform = is_rdv.shape[0] == 1
            any_e = bool((~is_rdv).any())
            any_r = bool(is_rdv.any())
            cols_e = cols_r = None
            if col_uniform and any_e and any_r:
                cols_e = np.flatnonzero(~is_rdv[0])
                cols_r = np.flatnonzero(is_rdv[0])
            rounds.append(_BoundRound(
                nb=nb, t_red=self._reduce_us(red), penalty=penalty,
                rdv_round=rdv, is_rdv=is_rdv, col_uniform=col_uniform,
                any_e=any_e, any_r=any_r, cols_e=cols_e, cols_r=cols_r))
        bound = _BoundProgram(
            sizes=key, rounds=rounds,
            pre_copy_us=self._copy_us(np.array([ps[1] for ps in per_size])),
            post_copy_us=self._copy_us(np.array([ps[2] for ps in per_size])))
        self._bind_cache[key] = bound
        return bound

    # ------------------------------------------------------------ execution
    def _exec_exchange_round(self, state, r, rb, t_issue, B):
        """All sends of an exchange round: the eager branch runs once
        round-wide (packetizer sharing is always same-stage), the
        rendez-vous branch walks the level decomposition."""
        n = len(r.src)
        complete = np.empty((n, B))
        sender_free = np.empty((n, B))
        if rb.col_uniform:
            if rb.any_e and rb.any_r:
                ce, cr = rb.cols_e, rb.cols_r
                comp_e, sfree_e = self._run_eager(
                    state, r.eager, t_issue[:, ce], rb.nb[:, ce], None, ce)
                complete[:, ce] = comp_e
                sender_free[:, ce] = sfree_e
                for lv in r.levels:
                    ix = (lv.sel[:, None], cr[None, :])
                    comp, sfree = self._run_rdv(state, lv, t_issue[ix],
                                                rb.nb[:, cr], None, cr,
                                                True)
                    complete[ix] = comp
                    sender_free[ix] = sfree
            elif rb.any_r:
                for lv in r.levels:
                    comp, sfree = self._run_rdv(state, lv,
                                                t_issue[lv.sel], rb.nb,
                                                None, None, True)
                    complete[lv.sel] = comp
                    sender_free[lv.sel] = sfree
            else:
                complete, sender_free = self._run_eager(
                    state, r.eager, t_issue, rb.nb, None, None)
            return complete, sender_free
        # per-send byte variation: masked dual execution + blend
        act_r = rb.is_rdv
        comp_e = sfree_e = None
        if rb.any_e:
            comp_e, sfree_e = self._run_eager(
                state, r.eager, t_issue, rb.nb,
                ~act_r if rb.any_r else None, None)
        if rb.any_r:
            for lv in r.levels:
                act = None if not rb.any_e else \
                    np.broadcast_to(act_r[lv.sel], (len(lv.sel), B))
                comp, sfree = self._run_rdv(state, lv, t_issue[lv.sel],
                                            rb.nb[lv.sel], act, None,
                                            False)
                complete[lv.sel] = comp
                sender_free[lv.sel] = sfree
            if rb.any_e:
                complete = np.where(act_r, complete, comp_e)
                sender_free = np.where(act_r, sender_free, sfree_e)
        else:
            complete, sender_free = comp_e, sfree_e
        return complete, sender_free

    def _exec_level(self, state, lv, t_issue, rb):
        """Run one level's sends through both transports; returns
        (complete, sender_free) in level order.  Mixed column-uniform
        rounds split the batch columns per transport (each branch runs
        unmasked on its own column subset); only rounds with per-send
        byte variation pay the masked dual-execution path."""
        if rb.col_uniform:
            nbl, rdvl = rb.nb, rb.is_rdv
            any_e, any_r = rb.any_e, rb.any_r
        else:
            nbl, rdvl = rb.nb[lv.sel], rb.is_rdv[lv.sel]
            any_e = bool((~rdvl).any())
            any_r = bool(rdvl.any())
        if not (any_e and any_r):
            if any_r:
                return self._run_rdv(state, lv, t_issue, nbl, None,
                                     None, rb.col_uniform)
            return self._run_eager(state, lv, t_issue, nbl, None, None)
        if rb.col_uniform:
            cols_e, cols_r = rb.cols_e, rb.cols_r
            comp_e, sfree_e = self._run_eager(
                state, lv, t_issue[:, cols_e], nbl[:, cols_e], None, cols_e)
            comp_r, sfree_r = self._run_rdv(
                state, lv, t_issue[:, cols_r], nbl[:, cols_r], None, cols_r,
                True)
            comp = np.empty(t_issue.shape)
            sfree = np.empty(t_issue.shape)
            comp[:, cols_e] = comp_e
            comp[:, cols_r] = comp_r
            sfree[:, cols_e] = sfree_e
            sfree[:, cols_r] = sfree_r
            return comp, sfree
        act = np.broadcast_to(rdvl, t_issue.shape)
        comp_e, sfree_e = self._run_eager(state, lv, t_issue, nbl, ~act,
                                          None)
        comp_r, sfree_r = self._run_rdv(state, lv, t_issue, nbl, act,
                                        None, False)
        return (np.where(rdvl, comp_r, comp_e),
                np.where(rdvl, sfree_r, sfree_e))

    def run(self, sched, sizes, *, state: ResourceState | None = None,
            t0: np.ndarray | None = None, engine=None,
            deg: LinkDegrade | None = None,
            cache_bind: bool = True) -> BatchScheduleResult:
        """Execute the program over a message-size grid in one batch.

        ``state``/``t0`` serve *embedded* execution inside a compiled
        Program-IR artifact
        (:mod:`repro_torch.core.exanet.program_compiled`) —
        the array twin of the interpreter's ``run_schedule(t0=, reset=
        False)`` seam: ``t0`` gives per-rank per-column entry clocks
        (shape (nranks, B)), ``state`` the live occupancy the collective
        starts over (its rows must cover :attr:`n_rows`).  The level
        decomposition is start-state independent, so one lowered program
        serves both the cold standalone replay and every spliced entry.
        ``t0`` is also exact for standalone runs (fresh all-zero state):
        it batches per-rank arrival offsets — one scenario per column of
        a repeated-size grid.

        ``engine`` selects the scan backend (``"numpy"`` default,
        ``"torch"``, or an engine object; DESIGN.md §2.5).  ``deg`` binds
        the per-(link, column) degradation axes (:class:`LinkDegrade`) —
        one batched replay sweeps N fault/congestion scenarios.
        """
        self._eng = resolve_engine(engine)
        self._deg = deg
        bound = self.bind(sched, sizes, cache_bind)
        B = len(bound.sizes)
        if deg is not None and deg.ncols not in (1, B):
            raise ValueError(f"deg has {deg.ncols} columns, batch has {B}")
        p = self._p
        if state is None:
            state = ResourceState(self.n_rows, B)
        clocks = np.tile(bound.pre_copy_us, (self.nranks, 1))
        if t0 is not None:
            clocks = clocks + t0
        skew = 0.0
        for r, rb in zip(self.rounds, bound.rounds):
            if r.exchange:
                t_issue_all = clocks[r.src] + skew
                complete, sender_free = self._exec_exchange_round(
                    state, r, rb, t_issue_all, B)
                arrivals = np.zeros((self.nranks, B))
                arrivals[r.udst] = np.maximum.reduceat(
                    complete[r.dst_perm], r.dst_starts, axis=0)
                done = np.zeros((self.nranks, B))
                done[r.usrc] = np.maximum.reduceat(
                    sender_free[r.src_perm], r.src_starts, axis=0)
                if rb.rdv_round.any():
                    done = self._ack_phase(state, r, rb, done, B)
                base = np.maximum(done[r.participants],
                                  arrivals[r.participants])
                clocks[r.participants] = base + rb.penalty + rb.t_red - skew
            else:
                for lv in r.levels:
                    t_issue = clocks[lv.src_ranks] + skew
                    comp, sfree = self._exec_level(state, lv, t_issue, rb)
                    clocks[lv.src_ranks] = sfree - skew
                    if lv.udst is not None:
                        red = np.maximum.reduceat(comp[lv.dst_perm],
                                                  lv.dst_starts, axis=0)
                        clocks[lv.udst] = np.maximum(clocks[lv.udst],
                                                     red - skew)
                clocks[r.round_udst] += rb.t_red
            if r.sync:
                skew += p.step_sync_us
        latency = clocks.max(axis=0) + skew + bound.post_copy_us \
            + p.barrier_exit_us
        return BatchScheduleResult(bound.sizes, latency,
                                   (clocks + skew).T, list(self.round_heads))

    def _ack_phase(self, state, r, rb, done, B):
        """Rendez-vous end-to-end-ACK: a second R5 invocation per send on
        the sender's MPSoC, serialized in send order (§4.5.2).  Repeat
        sends of one sender chain through the previous acquire, which in
        max-plus terms is an unconditional (T = -inf) acquire."""
        st = r.ack
        occ = self._r5_occ
        act = rb.rdv_round[None, :]
        F0 = state.free[st.rows]
        # repeat sends chain (T = -inf); duration is the scalar occupancy,
        # activity column-uniform — the running-max fast path applies
        v = np.where(r.ack_first_of_sender[:, None],
                     done[r.ack_src] - st.kpos * occ, NEG_INF)
        v = self._eng.running_max(v, st.takes)
        f_after = np.maximum(v, F0) + st.kpos1 * occ
        if not rb.rdv_round.all():
            f_after = np.where(act, f_after, F0)
        state.free[st.rows[st.last]] = f_after[st.last]
        done = done.copy()
        done[r.ack_senders] = np.where(act, f_after[r.ack_last_pos],
                                       done[r.ack_senders])
        return done


#: structure-probe size used when lowering a schedule's rounds; bytes at
#: other sizes are bound per grid (and verified against this structure)
_STRUCT_SIZE = 4096


def compile_program(net, sched, cores, nranks) -> RoundProgram:
    """Lower ``sched`` for a fixed (nranks, placement, topology).  Raises
    whatever the schedule's own shape validation raises (like the
    interpreter does on its first round)."""
    return RoundProgram(net, sched, cores, nranks)


def round_parallelism(net, sched, cores, nranks) -> float:
    """Cheap pre-compile predictor of compiled-backend profitability:
    mean sends per dependency level over the schedule's first and last
    non-empty rounds.  Wide rounds (recursive doubling, broadcast trees,
    the accelerator's fan-in/out) vectorize; serial-chain rounds (the
    ring's ``r -> r+1`` pattern couples every DMA engine source-to-
    destination) degenerate to one send per level, where the interpreter
    is cheaper than replaying thousands of one-send array steps."""
    rounds = [r for r in sched.rounds(nranks, _STRUCT_SIZE) if r.sends]
    if not rounds:
        return float("inf")
    probe = [rounds[0]] if len(rounds) == 1 else [rounds[0], rounds[-1]]
    best = 0.0
    for rnd in probe:
        n = len(rnd.sends)
        src = np.fromiter((s for (s, _, _) in rnd.sends), np.int64, n)
        dst = np.fromiter((d for (_, d, _) in rnd.sends), np.int64, n)
        pm = net.path_metrics_arrays(
            [(cores[s], cores[d]) for (s, d, _) in rnd.sends])
        levels = _level_assignment(n, src, dst, _send_res_tags(pm, n),
                                   rnd.exchange)
        best = max(best, n / float(levels.max() + 1))
    return best
