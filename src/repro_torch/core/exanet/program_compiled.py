"""Compiled Program-IR execution: whole applications as vectorized level
programs (DESIGN.md §2.5, the Program half).

The interpreted :class:`~repro_torch.core.program.ProgramExecutor`
(:meth:`ExanetMPI.run_program`) walks every rank's op stream through a
Python heap scheduler and every matched point-to-point transfer through
``Network.isend`` → per-resource ``Resource.acquire`` — which caps the
apps workload simulator at ~10 simulated iterations/sec at 512 ranks.
This module lowers a :class:`~repro_torch.core.program.Program` the
same way the collective schedules are lowered: compile the *structure* once, bind the
*data* (byte sizes, compute microseconds) per column, replay with array
arithmetic.

Pipeline
========
1. **Static analysis** (once per :meth:`Program.structure_key`): FIFO
   matching is purely structural — the k-th ``Isend`` on channel
   (src, dst, tag) matches the k-th ``Irecv`` on that channel regardless of
   timing — so the match table, the per-rank *segments* (op runs between
   ``Wait``/``Collective`` boundaries, within which a rank's clock advances
   by bindable constants only), the wait sets and the collective sites are
   all computed without simulating anything.
2. **Probe** (once per binding): one interpreted run with recording hooks
   pins the *order* in which the scheduler fires matches and collective
   barriers — the composition order of same-resource acquisitions, which
   is the one thing array replay cannot derive structurally (it depends on
   the per-rank clocks, i.e. on the bound data).  Bindings that produce
   the same tape share one lowered artifact; for wave-structured programs
   (every halo/CG/BSP builder in the repo: all ranks post in lockstep) the
   tape is provably size-invariant, so a whole weak/strong sweep lands on
   a single lowering.
3. **Level decomposition** (once per tape): matched transfers are layered
   exactly like ``exec_compiled`` rounds — same-stage resource sharing
   (four ranks of an MPSoC hitting its R5) stays within a level and
   resolves in one segmented max-plus scan in tape order; *cross-stage*
   sharing (a DMA that is transfer A's source and transfer B's
   destination) forces a later level; a transfer whose post clocks read a
   wait's output lands after that wait; a ``Collective`` is a full
   barrier level that splices the schedule's already-compiled
   :class:`~repro_torch.core.exanet.exec_compiled.RoundProgram` at the ranks'
   skewed entry clocks over the live :class:`ResourceState` (the array
   twin of the interpreter's ``run_schedule(t0=..., reset=False)`` seam).
4. **Execute**: per-segment clock offsets are one segmented ``cumsum``;
   per level, the eager/rendez-vous transports run through the shared
   :class:`~repro_torch.core.exanet.exec_compiled.VecTransport` kernels; waits
   are grouped ``maximum.reduceat`` reductions.  One run costs a few
   thousand array ops instead of hundreds of thousands of Python calls.

Exactness
=========
The interpreter stays the reference semantics; compiled execution must
match it to ~1e-9 relative (``tests/test_program_compiled.py``: the
60-seed deterministic fuzz and its hypothesis twin).  The probe *is* an
interpreted run, so the recorded acquisition order is the interpreter's
own order for that binding by construction; within a level the scans
compose same-stage acquires in tape order, and every cross-stage or
clock-coupled pair is level-separated — the same two constructions that
make ``RoundProgram`` exact.

The port's copy of the reference's ``repro.core.exanet.program_compiled``,
whole: the same names, layout and float arithmetic, with its imports
rewritten to ``repro_torch`` and one repair (``_lower_coll`` resolves a
schedule name through ``ExanetMPI._schedule_instance``, so a synthesized
``synth:<digest>`` winner lowers as the interpreter runs it).
``tests/test_torch_exanet_sim.py`` and
``tests/test_torch_exanet_compiled.py`` hold the two equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.exanet.exec_compiled import (ProgramStructureError,
                                                   VecTransport, _Level,
                                                   _make_stage, _send_res_tags)
from repro_torch.core.exanet.scan_engine import resolve_engine
from repro_torch.core.exanet.sim import ResourceState
from repro_torch.core.program import (Collective, Compute, Irecv, Isend,
                                      Program, ProgramError, ProgramExecutor,
                                      ProgramResult, Wait)


# ---------------------------------------------------------------------------
# static analysis (per structure)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Post:
    rank: int
    gid: int          # segment the post belongs to
    item: int         # global item index (for the offset cumsum)
    is_send: bool
    peer: int
    tag: int


@dataclasses.dataclass
class _WaitNode:
    idx: int
    rank: int
    prev_gid: int     # segment the wait ends (exit clock read)
    new_gid: int      # segment the wait produces
    consumed: tuple   # post indices whose completion the wait maxes over


@dataclasses.dataclass
class _CollSite:
    idx: int
    op: str
    algo: str
    handle: str | None  # None = blocking barrier; else nonblocking site
    entry_gid: list   # per rank: segment whose exit clock is the entry
    exit_gid: list    # per rank: segment the exits produce (blocking only)
    entry_item: list  # per rank: item index of the entry (nonblocking only)


class _Static:
    """Structure-only decomposition of a Program: segments, posts, FIFO
    match table, waits and collective sites (no hardware, no timing)."""

    def __init__(self, prog: Program):
        nranks = prog.nranks
        self.nranks = nranks
        self.first_gid: list[int] = []
        self.last_gid: list[int] = []
        self.seg_producer: dict[int, tuple] = {}
        self.items: list[tuple] = []      # ("c"|"p", data_idx, gid)
        self.posts: list[_Post] = []
        self.waits: list[_WaitNode] = []
        self.sites: list[_CollSite] = []
        self.n_computes = 0
        channels: dict[tuple, tuple[list, list]] = {}
        n_segs = 0
        for r in range(nranks):
            gid = n_segs
            n_segs += 1
            self.first_gid.append(gid)
            outstanding: list[int] = []
            named: dict[str, int] = {}
            coll_i = 0
            for op in prog.rank_ops[r]:
                if isinstance(op, Compute):
                    self.items.append(("c", self.n_computes, gid))
                    self.n_computes += 1
                elif isinstance(op, (Isend, Irecv)):
                    is_send = isinstance(op, Isend)
                    peer = op.dst if is_send else op.src
                    pi = len(self.posts)
                    self.posts.append(_Post(r, gid, len(self.items),
                                            is_send, peer, op.tag))
                    self.items.append(("p", pi, gid))
                    key = (r, peer, op.tag) if is_send else \
                        (peer, r, op.tag)
                    ch = channels.setdefault(key, ([], []))
                    ch[0 if is_send else 1].append(pi)
                    outstanding.append(pi)
                    if op.handle is not None:
                        named[op.handle] = pi
                elif isinstance(op, Wait):
                    if op.handles is None:
                        consumed = tuple(outstanding)
                    else:
                        try:
                            consumed = tuple(named[h] for h in op.handles)
                        except KeyError as e:
                            raise ProgramError(
                                f"rank {r}: Wait on unknown handle "
                                f"{e}") from e
                    widx = len(self.waits)
                    new_gid = n_segs
                    n_segs += 1
                    self.waits.append(_WaitNode(widx, r, gid, new_gid,
                                                consumed))
                    self.seg_producer[new_gid] = ("w", widx)
                    cset = set(consumed)
                    outstanding = [q for q in outstanding if q not in cset]
                    named = {h: q for h, q in named.items()
                             if q not in cset}
                    gid = new_gid
                elif isinstance(op, Collective):
                    if coll_i == len(self.sites):
                        self.sites.append(_CollSite(
                            coll_i, op.op, op.algo, op.handle,
                            [None] * nranks, [None] * nranks,
                            [None] * nranks))
                    site = self.sites[coll_i]
                    if (site.op, site.algo, site.handle) != \
                            (op.op, op.algo, op.handle):
                        # a handle mismatch changes the *structure* (a
                        # blocking rank cuts a segment, a nonblocking one
                        # does not), so it must be rejected here, not at
                        # probe time
                        raise ProgramError(
                            f"collective mismatch at site #{coll_i}: "
                            f"rank {r} calls ({op.op}, {op.algo}, "
                            f"{op.handle}), another rank called "
                            f"({site.op}, {site.algo}, {site.handle})")
                    site.entry_gid[r] = gid
                    if op.handle is not None:
                        # nonblocking: the entry is an in-segment item
                        # (costing one post overhead, like an Isend) and
                        # the completion a pseudo-request a later Wait
                        # consumes — the rank's segment is NOT cut
                        site.entry_item[r] = len(self.items)
                        self.items.append(("a", coll_i, gid))
                        token = ("x", coll_i)
                        outstanding.append(token)
                        if op.handle in named:
                            raise ProgramError(
                                f"rank {r}: handle {op.handle!r} reused "
                                f"while still outstanding")
                        named[op.handle] = token
                    else:
                        new_gid = n_segs
                        n_segs += 1
                        site.exit_gid[r] = new_gid
                        self.seg_producer[new_gid] = ("x", coll_i)
                        gid = new_gid
                    coll_i += 1
            self.last_gid.append(gid)
        self.n_segs = n_segs
        # FIFO matching: k-th send on a channel pairs with its k-th recv
        # (a channel's sends all come from one rank, in its program order,
        # so the pairing is timing-independent).  Length mismatches are
        # dangling requests — the probe run raises the interpreter's own
        # ProgramError for them.
        self.events: list[tuple[int, int]] = []
        self.event_of_post: dict[int, tuple[int, bool]] = {}
        self.chan_events: dict[tuple, list[int]] = {}
        for key, (s_list, r_list) in channels.items():
            ids = []
            for sp, rp in zip(s_list, r_list):
                e = len(self.events)
                self.events.append((sp, rp))
                self.event_of_post[sp] = (e, True)
                self.event_of_post[rp] = (e, False)
                ids.append(e)
            self.chan_events[key] = ids
        # item -> segment bookkeeping for the bind-time offset cumsum
        # (items of one segment are contiguous and gids increase in walk
        # order, so segmented prefixes come from plain cumsum + gathers)
        self.item_seg = np.array([g for (_, _, g) in self.items],
                                 dtype=np.int64)
        n_items = len(self.items)
        self.item_first = np.zeros(n_items, dtype=np.int64)
        seg_first: dict[int, int] = {}
        for i, g in enumerate(self.item_seg):
            seg_first.setdefault(int(g), i)
            self.item_first[i] = seg_first[int(g)]
        self.seg_item_start = np.array(sorted(seg_first.values()),
                                       dtype=np.int64)
        self.segs_with_items = np.array(
            sorted(seg_first, key=lambda g: seg_first[g]), dtype=np.int64)
        self.post_item = np.array([p.item for p in self.posts],
                                  dtype=np.int64)
        # posts AND nonblocking-collective entries both cost one post
        # overhead on the poster's clock
        self.item_is_post = np.array([k != "c" for (k, _, _) in self.items],
                                     dtype=bool)
        # nonblocking sites get virtual completion rows past the p2p
        # events: row n_events + async_ord[site]*nranks + rank
        self.async_ord = {s.idx: i for i, s in enumerate(
            s for s in self.sites if s.handle is not None)}
        self.n_async = len(self.async_ord)
        # compute slots are appended rank-major, so per-rank totals are a
        # reduceat over contiguous runs
        first_gids = np.array(self.first_gid, dtype=np.int64)
        comp_gids = np.array([g for (k, _, g) in self.items if k == "c"],
                             dtype=np.int64)
        self.compute_rank = (
            np.searchsorted(first_gids, comp_gids, side="right") - 1
            if self.n_computes else np.zeros(0, dtype=np.int64))
        self.last_gid_arr = np.array(self.last_gid, dtype=np.int64)
        self.first_gid_arr = first_gids


def extract_data(prog: Program) -> tuple:
    """The bindable payload of a program, in static-walk order:
    (compute us, post nbytes, per-site collective nbytes)."""
    comp: list[float] = []
    post_nb: list[int] = []
    site_nb: dict[int, int] = {}
    for ops in prog.rank_ops:
        coll_i = 0
        for op in ops:
            if isinstance(op, Compute):
                comp.append(float(op.us))
            elif isinstance(op, (Isend, Irecv)):
                post_nb.append(int(op.nbytes))
            elif isinstance(op, Collective):
                nb = int(op.nbytes)
                prev = site_nb.setdefault(coll_i, nb)
                if prev != nb:
                    # sizes are excluded from structure_key, so a
                    # rank-inconsistent site would otherwise alias a
                    # consistent binding in the cache; the interpreter
                    # rejects it at barrier time, we reject it at extract
                    raise ProgramError(
                        f"collective mismatch at site #{coll_i}: ranks "
                        f"disagree on nbytes ({prev} vs {nb})")
                coll_i += 1
    sites = tuple(site_nb[i] for i in range(len(site_nb)))
    return tuple(comp), tuple(post_nb), sites


def rebind_program(prog: Program, *, compute_us=None, post_nbytes=None,
                   site_nbytes=None) -> Program:
    """Rebuild ``prog`` with replaced payload data — the Program-object
    inverse of one :meth:`CompiledProgram.bind_arrays` column, in the
    same static-walk order :func:`extract_data` emits (computes and posts
    rank-major in program order, collectives by site index).  Used by the
    scenario cross-checks to hand a perturbed column to the
    interpreter."""
    ci = pi = 0
    new_ranks = []
    for ops in prog.rank_ops:
        coll_i = 0
        new_ops = []
        for op in ops:
            if isinstance(op, Compute):
                if compute_us is not None:
                    op = dataclasses.replace(op, us=float(compute_us[ci]))
                ci += 1
            elif isinstance(op, (Isend, Irecv)):
                if post_nbytes is not None:
                    op = dataclasses.replace(op,
                                             nbytes=int(post_nbytes[pi]))
                pi += 1
            elif isinstance(op, Collective):
                if site_nbytes is not None:
                    op = dataclasses.replace(
                        op, nbytes=int(site_nbytes[coll_i]))
                coll_i += 1
            new_ops.append(op)
        new_ranks.append(tuple(new_ops))
    return Program(tuple(new_ranks))


# ---------------------------------------------------------------------------
# probe recording
# ---------------------------------------------------------------------------
class _Recorder:
    """Maps the interpreter's hook invocations back to static event ids:
    the i-th p2p call on a channel is that channel's i-th match; collective
    barriers complete in site order (site s+1 needs every rank past s)."""

    def __init__(self, static: _Static):
        self._chan_events = static.chan_events
        self._count: dict[tuple, int] = {}
        self._coll_i = 0
        self.tape: list[tuple] = []

    def p2p(self, src: int, dst: int, tag: int) -> None:
        key = (src, dst, tag)
        i = self._count.get(key, 0)
        self._count[key] = i + 1
        self.tape.append(("p", self._chan_events[key][i]))

    def coll(self, name: str | None) -> None:
        self.tape.append(("x", self._coll_i, name))
        self._coll_i += 1


# ---------------------------------------------------------------------------
# lowered artifacts
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _PLevel:
    """One dependency level of matched point-to-point transfers."""
    lv: _Level                  # shared stage structures (VecTransport)
    ev: np.ndarray              # event ids, tape order
    send_post: np.ndarray
    recv_post: np.ndarray
    send_seg: np.ndarray
    recv_seg: np.ndarray


@dataclasses.dataclass
class _WaitPlan:
    """All waits of one level, grouped for one reduceat."""
    target: np.ndarray          # produced segment ids
    prev: np.ndarray            # ended segment ids (exit clock read)
    with_req: np.ndarray        # indices into target that have >=1 request
    req_ev: np.ndarray          # concatenated event ids
    req_side: np.ndarray        # True = send-side completion
    starts: np.ndarray          # reduceat starts into req_ev


@dataclasses.dataclass
class _CollSlot:
    site: _CollSite
    name: str | None            # resolved schedule ("accel", None = trivial)
    sched: object | None        # schedule instance (stateless)
    rp: object | None           # compiled RoundProgram
    entry: np.ndarray           # (nranks,) entry segment ids
    exit: np.ndarray | None     # (nranks,) produced segment ids (blocking)
    entry_item: np.ndarray | None  # (nranks,) entry items (nonblocking)
    virt_base: int              # first virtual done-row (nonblocking)


@dataclasses.dataclass
class _LevelPlan:
    p2p: _PLevel | None = None
    waits: _WaitPlan | None = None
    coll: _CollSlot | None = None


@dataclasses.dataclass
class _LoweredTape:
    levels: list
    n_rows: int


@dataclasses.dataclass
class _BoundLevel:
    nb: np.ndarray              # (k, B) send bytes per event
    is_rdv: np.ndarray          # (k, B)
    any_e: bool
    any_r: bool
    uni: bool                   # bytes uniform across the level's events


@dataclasses.dataclass
class _BoundIR:
    """One binding of a compiled program: per-column payload data laid out
    for array replay (plus the lowered tape the columns share)."""
    B: int
    lowered: _LoweredTape
    post_off: np.ndarray        # (n_posts, B) in-segment clock offsets
    seg_total: np.ndarray       # (n_segs, B)
    rank_compute: np.ndarray    # (nranks, B)
    levels: list                # _BoundLevel per _LevelPlan (None w/o p2p)
    site_sizes: list            # per site: tuple of per-column nbytes
    coll_entry_off: dict        # async site idx -> (nranks, B) item offsets


class CompiledProgram(VecTransport):
    """A Program structure lowered for one (machine, placement).

    Compile once per :meth:`Program.structure_key`; :meth:`bind` payload
    data per column (one probe per distinct binding pins the scheduling
    order — bindings with equal tapes share the lowered levels);``run``
    replays bound columns in one batched pass.  Collective sites splice
    their compiled :class:`RoundProgram` at the ranks' entry clocks over
    the shared live :class:`ResourceState`.
    """

    def __init__(self, mpi, prog: Program):
        prog.validate()
        self.key = prog.structure_key()
        self.nranks = prog.nranks
        self._mpi = mpi
        self._init_transport(mpi.p)
        self._static = _Static(prog)
        self._cores = mpi._cores(self.nranks)
        self._pm = None             # per-event path metrics (lazy)
        self._res_tags = None
        self._tape_cache: dict = {}
        self._bind_cache: dict = {}
        self._probe_cache: dict = {}

    # ---------------------------------------------------------------- probe
    def _probe(self, prog: Program, plans: dict) -> tuple:
        """One interpreted run with recording hooks: returns the tape (the
        scheduler's match/barrier firing order for this binding)."""
        mpi = self._mpi
        rec = _Recorder(self._static)
        hooks = mpi._program_hooks(self.nranks, plans, recorder=rec)
        mpi.net.reset()
        ProgramExecutor(prog, **hooks,
                        post_overhead_us=mpi.p.a53_call_overhead_us).run()
        return tuple(rec.tape)

    # ------------------------------------------------------------- lowering
    def _event_metrics(self):
        if self._pm is None:
            st = self._static
            pairs = [(self._cores[st.posts[sp].rank],
                      self._cores[st.posts[rp].rank])
                     for (sp, rp) in st.events]
            self._pm = self._mpi.net.path_metrics_arrays(pairs)
            self._res_tags = _send_res_tags(self._pm, len(st.events))
        return self._pm, self._res_tags

    def _lowered(self, tape: tuple) -> _LoweredTape:
        lt = self._tape_cache.get(tape)
        if lt is not None:
            return lt
        st = self._static
        pm, res_tags = self._event_metrics()
        avail: dict[int, int] = {g: 0 for g in st.first_gid}
        ev_level: dict[int, int] = {}
        wait_level: dict[int, int] = {}
        coll_level: dict[int, int] = {}

        def resolve_seg(gid: int) -> int:
            # iterative over the rank's Wait chain (which can be
            # arbitrarily deep — a recursion would overflow on long
            # phase-sequenced programs the interpreter handles fine)
            lv = avail.get(gid)
            if lv is not None:
                return lv
            stack = [gid]
            while stack:
                g = stack[-1]
                if g in avail:
                    stack.pop()
                    continue
                kind, idx = st.seg_producer[g]
                if kind != "w":     # collective exits set avail eagerly
                    raise ProgramStructureError(
                        "tape references a collective exit before the "
                        "site fired — scheduling order inconsistent "
                        "with structure")
                w = st.waits[idx]
                lv = avail.get(w.prev_gid)
                if lv is None:
                    stack.append(w.prev_gid)
                    continue
                for pi in w.consumed:
                    if isinstance(pi, tuple):   # nonblocking collective
                        if pi[1] not in coll_level:
                            raise ProgramStructureError(
                                "wait consumes a nonblocking collective "
                                "the probe never fired")
                        # the splice executes after the level's waits, so
                        # a consuming wait lands one level later
                        lv = max(lv, coll_level[pi[1]] + 1)
                        continue
                    rec = st.event_of_post.get(pi)
                    if rec is None or rec[0] not in ev_level:
                        raise ProgramStructureError(
                            "wait consumes a request the probe never "
                            "matched")
                    lv = max(lv, ev_level[rec[0]])
                wait_level[idx] = lv
                avail[g] = lv + 1
                stack.pop()
            return avail[gid]

        floor = 0
        amax = -1
        row_tags: dict = {}
        # Stage-major execution within a level runs R5 -> DMA src -> link
        # hops in path order -> DMA dst.  A later send touching a shared
        # row at a *later* pipeline stage is therefore acquired after the
        # earlier send even inside one level — only the reverse direction
        # (later send, earlier stage) forces a level split.  This is a
        # strictly tighter rule than ``exec_compiled._level_assignment``'s
        # symmetric one and roughly halves the level count of halo
        # programs (the dominant S->D DMA chains pair up).
        def stage_ord(tag):
            if isinstance(tag, int):      # link hop position
                return 2 + tag
            return {"E": -1, "R": 0, "S": 1, "D": 1 << 30}[tag]
        for item in tape:
            if item[0] == "p":
                e = item[1]
                sp, rp = st.events[e]
                lv = max(floor, resolve_seg(st.posts[sp].gid),
                         resolve_seg(st.posts[rp].gid))
                for (row, tag) in res_tags[e]:
                    tags = row_tags.get(row)
                    if tags:
                        o = stage_ord(tag)
                        for t2, l2 in tags.items():
                            need = l2 if t2 == tag or stage_ord(t2) < o \
                                else l2 + 1
                            if need > lv:
                                lv = need
                ev_level[e] = lv
                for (row, tag) in res_tags[e]:
                    d = row_tags.setdefault(row, {})
                    if d.get(tag, -1) < lv:
                        d[tag] = lv
                if lv > amax:
                    amax = lv
            else:
                _, s, _name = item
                site = st.sites[s]
                lv = floor
                for r in range(self.nranks):
                    lv = max(lv, resolve_seg(site.entry_gid[r]))
                # the interpreter fired every recorded event before the
                # last rank arrived, so the splice must follow everything
                # assigned so far (nonblocking sites keep the same
                # conservative ordering: levels only sequence resource
                # acquisitions, the entry clocks stay mid-segment)
                lv = max(lv, amax + 1)
                coll_level[s] = lv
                if site.handle is None:
                    for r in range(self.nranks):
                        avail[site.exit_gid[r]] = lv + 1
                floor = lv + 1
                amax = lv
                row_tags = {}
        for w in st.waits:
            if w.idx not in wait_level:
                resolve_seg(w.new_gid)

        n_levels = 1 + max(
            [lv for lv in ev_level.values()]
            + [lv for lv in wait_level.values()]
            + [lv for lv in coll_level.values()] + [-1])
        levels = [_LevelPlan() for _ in range(n_levels)]
        by_level: dict[int, list[int]] = {}
        for item in tape:                      # keep tape order per level
            if item[0] == "p":
                by_level.setdefault(ev_level[item[1]], []).append(item[1])
        for lv_i, evs in by_level.items():
            levels[lv_i].p2p = self._lower_p2p_level(evs, pm)
        waits_by_level: dict[int, list[_WaitNode]] = {}
        for w in st.waits:
            waits_by_level.setdefault(wait_level[w.idx], []).append(w)
        for lv_i, ws in waits_by_level.items():
            levels[lv_i].waits = self._lower_waits(ws)
        for item in tape:
            if item[0] == "x":
                _, s, name = item
                levels[coll_level[s]].coll = self._lower_coll(
                    st.sites[s], name)
        lt = _LoweredTape(levels, self._mpi.net.engine.n_resource_ids)
        self._tape_cache[tape] = lt
        return lt

    def _lower_p2p_level(self, evs: list[int], pm) -> _PLevel:
        st = self._static
        idx = np.array(evs, dtype=np.int64)
        k = len(idx)
        pos = np.arange(k)
        spb = pm["stream_us_per_byte"][idx]
        n_links = pm["n_links"][idx]
        max_links = int(n_links.max()) if k else 0
        link_stages = []
        for pos_k in range(max_links):
            sub = np.flatnonzero(n_links > pos_k)
            link_stages.append(_make_stage(
                pos[sub], pm["link_ids"][idx[sub], pos_k], spb[sub]))
        ddst_sub = np.flatnonzero(pm["dma_dst_id"][idx] >= 0)
        lv = _Level(
            sel=idx,
            e_const=pm["eager_ow_const_us"][idx][:, None],
            eager_pb=pm["eager_wire_us_per_byte"][idx][:, None],
            handshake=pm["handshake_ow_us"][idx][:, None],
            stream_pb=spb[:, None],
            hop=pm["hop_latency_us"][idx][:, None],
            pktz=_make_stage(pos, pm["pktz_id"][idx], span=k),
            r5=_make_stage(pos, pm["r5_id"][idx], span=k),
            dsrc=_make_stage(pos, pm["dma_src_id"][idx], spb, span=k),
            links=[s for s in link_stages if s is not None],
            ddst=_make_stage(ddst_sub, pm["dma_dst_id"][idx[ddst_sub]],
                             spb[ddst_sub]),
            src_ranks=None, dst_perm=None, dst_starts=None, udst=None,
            link_ids=pm["link_ids"][idx],
            link_rate=pm["link_rate_gbps"][idx],
            link_wire=pm["link_wire_gbps"][idx],
            n_links=n_links)
        send_post = np.array([st.events[e][0] for e in evs], dtype=np.int64)
        recv_post = np.array([st.events[e][1] for e in evs], dtype=np.int64)
        return _PLevel(
            lv=lv, ev=idx, send_post=send_post, recv_post=recv_post,
            send_seg=np.array([st.posts[p].gid for p in send_post],
                              dtype=np.int64),
            recv_seg=np.array([st.posts[p].gid for p in recv_post],
                              dtype=np.int64))

    def _lower_waits(self, ws: list[_WaitNode]) -> _WaitPlan:
        st = self._static
        n_events = len(st.events)
        req_ev, req_side, starts, with_req = [], [], [], []
        for i, w in enumerate(ws):
            if w.consumed:
                with_req.append(i)
                starts.append(len(req_ev))
                for pi in w.consumed:
                    if isinstance(pi, tuple):   # nonblocking collective:
                        # virtual completion row of (site, waiting rank)
                        req_ev.append(n_events
                                      + st.async_ord[pi[1]] * self.nranks
                                      + w.rank)
                        req_side.append(True)
                        continue
                    e, is_send = st.event_of_post[pi]
                    req_ev.append(e)
                    req_side.append(is_send)
        return _WaitPlan(
            target=np.array([w.new_gid for w in ws], dtype=np.int64),
            prev=np.array([w.prev_gid for w in ws], dtype=np.int64),
            with_req=np.array(with_req, dtype=np.int64),
            req_ev=np.array(req_ev, dtype=np.int64),
            req_side=np.array(req_side, dtype=bool),
            starts=np.array(starts, dtype=np.int64))

    def _lower_coll(self, site: _CollSite, name: str | None) -> _CollSlot:
        st = self._static
        entry = np.array(site.entry_gid, dtype=np.int64)
        if site.handle is None:
            exit_ = np.array(site.exit_gid, dtype=np.int64)
            entry_item = None
            virt_base = -1
        else:
            exit_ = None
            entry_item = np.array(site.entry_item, dtype=np.int64)
            virt_base = len(st.events) + st.async_ord[site.idx] * self.nranks
        sched = rp = None
        if name is not None and name != "accel":
            sched = self._mpi._schedule_instance(site.op, name)
            rp =self._mpi.compiled_program(sched, self.nranks)
        return _CollSlot(site, name, sched, rp, entry, exit_, entry_item,
                         virt_base)

    # ----------------------------------------------------------------- bind
    def _tape_of(self, prog, plans, data, names) -> tuple:
        """Cached probe: one interpreted run per distinct (payload data,
        resolved schedule names) binding ever probed on this artifact."""
        key = (data, names)
        tape = self._probe_cache.get(key)
        if tape is None:
            tape = self._probe_cache[key] = self._probe(prog, plans or {})
        return tape

    def bind(self, progs, plans_list=None) -> _BoundIR:
        """Bind one or more structurally-identical programs as batch
        columns of a *single* replay.  Raises
        :class:`ProgramStructureError` when the scheduler's firing order
        differs between columns — :meth:`bind_batch` is the total version
        that groups divergent columns instead of raising."""
        groups = self.bind_batch(progs, plans_list)
        if len(groups) > 1:
            raise ProgramStructureError(
                "scheduling order varies across the bound columns; bind "
                "them separately")
        return groups[0][1]

    def bind_batch(self, progs, plans_list=None
                   ) -> list[tuple[np.ndarray, _BoundIR]]:
        """Bind structurally-identical programs as batch columns, grouped
        by probe tape: returns ``[(column_indices, bound), ...]`` where
        each bound replays its columns in one pass (one group — the
        common case for wave-structured builders — means the whole batch
        is a single array program).  Raises
        :class:`ProgramStructureError` when a program's structure does
        not match this artifact (the cache-poisoning guard:
        differently-*structured* programs must never share a lowering)."""
        progs = list(progs)
        plans_list = list(plans_list or [None] * len(progs))
        datas = []
        names_cols = []
        for i, (prog, plans) in enumerate(zip(progs, plans_list)):
            if prog.structure_key() != self.key:
                raise ProgramStructureError(
                    "program structure does not match the compiled "
                    "artifact (FIFO matching / waits / collective sites "
                    "differ) — compile it instead of re-binding")
            if plans is None:
                # same default as run_program: auto allreduce sites are
                # planner-chosen, so both backends resolve identically
                plans_list[i] = self._mpi._plan_program_sites(prog, None)
        for prog, plans in zip(progs, plans_list):
            data = extract_data(prog)
            datas.append(data)
            names_cols.append(tuple(
                None if self.nranks < 2 else
                self._mpi._resolve_collective_schedule(
                    s.op, data[2][s.idx], s.algo, plans or {})
                for s in self._static.sites))
        groups: dict[tuple, list[int]] = {}
        for i, (prog, plans) in enumerate(zip(progs, plans_list)):
            tape = self._tape_of(prog, plans, datas[i], names_cols[i])
            groups.setdefault(tape, []).append(i)
        out = []
        for tape, cols in groups.items():
            key = (tuple(datas[i] for i in cols),
                   tuple(names_cols[i] for i in cols))
            bound = self._bind_cache.get(key)
            if bound is None:
                lowered = self._lowered(tape)
                bound = self._bind_data(lowered, [datas[i] for i in cols])
                self._bind_cache[key] = bound
            out.append((np.array(cols, dtype=np.int64), bound))
        return out

    def bind_arrays(self, prog: Program, *, compute_us=None,
                    post_nbytes=None, site_nbytes=None,
                    plans=None) -> _BoundIR:
        """Scenario binding: N payload perturbations of one base program
        as batch columns, *without* materializing N Program objects or
        probing N times.

        ``compute_us`` is (n_computes, N) per-slot compute microseconds
        (slots in static-walk order: rank-major, program order — the
        order :func:`extract_data` emits), ``post_nbytes``
        (n_posts, N) per-post byte counts, ``site_nbytes`` (n_sites, N)
        per-collective-site byte counts; ``None`` holds the base
        program's value constant across columns.

        All columns share the *base binding's* probe tape.  That is exact
        whenever the scheduler's firing order is payload-invariant —
        which holds for the repo's wave-structured builders (all ranks
        post in lockstep; the heap's rank-id tie-break fixes the order)
        but is not checked per column here: perturbations that change
        which collective schedule a site resolves to are rejected, and
        :meth:`ExanetMPI.run_program_scenarios` offers sampled
        interpreter cross-checks for the rest.
        """
        if prog.structure_key() != self.key:
            raise ProgramStructureError(
                "program structure does not match the compiled artifact "
                "(FIFO matching / waits / collective sites differ) — "
                "compile it instead of re-binding")
        st = self._static
        if plans is None:
            plans = self._mpi._plan_program_sites(prog, None)
        base = extract_data(prog)
        N = None
        for nm, a, k in (("compute_us", compute_us, st.n_computes),
                         ("post_nbytes", post_nbytes, len(st.posts)),
                         ("site_nbytes", site_nbytes, len(st.sites))):
            if a is None:
                continue
            a = np.asarray(a)
            if a.ndim != 2 or a.shape[0] != k:
                raise ValueError(f"{nm} must have shape ({k}, N), "
                                 f"got {a.shape}")
            if N is None:
                N = a.shape[1]
            elif a.shape[1] != N:
                raise ValueError("scenario arrays disagree on N")
        if N is None:
            N = 1
        comp_cols = (np.asarray(compute_us, dtype=np.float64)
                     if compute_us is not None else np.broadcast_to(
                         np.array(base[0])[:, None], (st.n_computes, N)))
        post_nb = (np.asarray(post_nbytes, dtype=np.float64)
                   if post_nbytes is not None else np.broadcast_to(
                       np.array(base[1], dtype=np.float64)[:, None],
                       (len(st.posts), N)))
        if site_nbytes is not None:
            site_cols = np.asarray(site_nbytes, dtype=np.int64)
        else:
            site_cols = np.broadcast_to(
                np.array(base[2], dtype=np.int64)[:, None],
                (len(st.sites), N))
        names0 = tuple(
            None if self.nranks < 2 else
            self._mpi._resolve_collective_schedule(
                s.op, base[2][s.idx], s.algo, plans or {})
            for s in st.sites)
        for j, s in enumerate(st.sites):
            if self.nranks < 2:
                continue
            for sz in np.unique(site_cols[j]):
                name = self._mpi._resolve_collective_schedule(
                    s.op, int(sz), s.algo, plans or {})
                if name != names0[j]:
                    raise ProgramStructureError(
                        f"site #{j}: scenario size {int(sz)} resolves to "
                        f"schedule {name!r} but the base binding uses "
                        f"{names0[j]!r} — the tape differs; bind those "
                        f"scenarios separately")
        tape = self._tape_of(prog, plans, base, names0)
        lowered = self._lowered(tape)
        site_sizes = [tuple(int(x) for x in site_cols[j])
                      for j in range(len(st.sites))]
        return self._bind_cols(lowered, comp_cols, post_nb, site_sizes)

    def _bind_data(self, lowered: _LoweredTape, datas: list) -> _BoundIR:
        st = self._static
        B = len(datas)
        comp_cols = np.array([d[0] for d in datas]).T.reshape(
            st.n_computes, B)
        post_nb = np.array([d[1] for d in datas], dtype=np.float64).T \
            .reshape(len(st.posts), B)
        site_sizes = [tuple(int(d[2][s.idx]) for d in datas)
                      for s in st.sites]
        return self._bind_cols(lowered, comp_cols, post_nb, site_sizes)

    def _bind_cols(self, lowered: _LoweredTape, comp_cols: np.ndarray,
                   post_nb: np.ndarray, site_sizes: list) -> _BoundIR:
        """Column-stacked payload arrays -> a :class:`_BoundIR` (shared
        tail of :meth:`bind` and :meth:`bind_arrays`)."""
        st = self._static
        B = comp_cols.shape[1]
        po = self._p.a53_call_overhead_us
        n_items = len(st.items)
        item_cost = np.empty((n_items, B))
        item_cost[st.item_is_post] = po
        if st.n_computes:
            item_cost[~st.item_is_post] = comp_cols
        excl = np.cumsum(item_cost, axis=0) - item_cost if n_items else \
            np.zeros((0, B))
        item_off = excl - excl[st.item_first] if n_items else excl
        post_off = item_off[st.post_item] if len(st.posts) else \
            np.zeros((0, B))
        seg_total = np.zeros((st.n_segs, B))
        if n_items:
            seg_total[st.segs_with_items] = np.add.reduceat(
                item_cost, st.seg_item_start, axis=0)
        rank_compute = np.zeros((self.nranks, B))
        if st.n_computes:
            np.add.at(rank_compute, st.compute_rank, comp_cols)
        coll_entry_off = {
            s.idx: item_off[np.array(s.entry_item, dtype=np.int64)]
            for s in st.sites if s.handle is not None}
        b_levels = []
        for plan in lowered.levels:
            if plan.p2p is None:
                b_levels.append(None)
                continue
            nb = post_nb[plan.p2p.send_post]
            # the interpreter's _match rejects size-mismatched channels;
            # re-bound programs must fail the same way (the probe already
            # raised for the compiled columns, this guards the arrays)
            nb_r = post_nb[plan.p2p.recv_post]
            if not np.array_equal(nb, nb_r):
                raise ProgramError(
                    "size mismatch on a matched (src, dst, tag) channel")
            is_rdv = nb > self._eager_max
            b_levels.append(_BoundLevel(
                nb=nb, is_rdv=is_rdv, any_e=bool((~is_rdv).any()),
                any_r=bool(is_rdv.any()),
                uni=bool((nb == nb[:1]).all())))
        return _BoundIR(B, lowered, post_off, seg_total, rank_compute,
                        b_levels, site_sizes, coll_entry_off)

    # ------------------------------------------------------------ execution
    def run(self, bound: _BoundIR, *, engine=None, t0=None,
            deg=None) -> list[ProgramResult]:
        """Replay the bound columns; one :class:`ProgramResult` each.
        ``engine`` selects the scan backend (``"numpy"`` default,
        ``"torch"``, or an engine object; DESIGN.md §2.5) — collective
        splices inherit it.

        ``t0`` seeds per-rank entry clocks: ``(nranks,)`` applied to all
        columns, or ``(nranks, B)`` per column — the Program-IR twin of
        the schedule replay's arrival-offset axis (exact for the same
        reason: resources start at zero occupancy, so an offset start is
        just a shifted first segment).  Like payload perturbations, the
        columns share the base probe tape; skews large enough to reorder
        the scheduler's firing are the cross-check's (``check=``) job to
        catch.

        ``deg`` binds the per-(link, column) degradation axes
        (:class:`~repro_torch.core.exanet.exec_compiled.LinkDegrade`): every
        p2p level and spliced collective recomputes its link-derived
        constants per column (DESIGN.md §2.10)."""
        self._eng = resolve_engine(engine)
        self._deg = deg
        st = self._static
        B = bound.B
        if deg is not None and deg.ncols not in (1, B):
            raise ValueError(f"deg has {deg.ncols} columns, batch has {B}")
        lowered = bound.lowered
        state = ResourceState(lowered.n_rows, B)
        C = np.zeros((st.n_segs, B))
        if t0 is not None:
            t0 = np.asarray(t0, dtype=np.float64)
            if t0.ndim == 1:
                t0 = t0[:, None]
            if t0.shape != (self.nranks, 1) and t0.shape != (self.nranks, B):
                raise ValueError(
                    f"t0 must have shape ({self.nranks},) or "
                    f"({self.nranks}, {B}), got {t0.shape}")
            C[st.first_gid_arr] = t0
        # virtual rows past the p2p events hold the per-(site, rank) exit
        # clocks of nonblocking collectives, consumed by waits like any
        # send-side completion
        n_rows = len(st.events) + st.n_async * self.nranks
        send_done = np.empty((n_rows, B))
        recv_done = np.empty((n_rows, B))
        for plan, bl in zip(lowered.levels, bound.levels):
            if plan.p2p is not None:
                self._exec_p2p_level(state, plan.p2p, bl, C, bound,
                                     send_done, recv_done)
            if plan.waits is not None:
                self._exec_waits(plan.waits, C, bound, send_done, recv_done)
            if plan.coll is not None:
                self._exec_coll(state, plan.coll, C, bound, send_done)
        final = C[st.last_gid_arr] + bound.seg_total[st.last_gid_arr]
        latency = final.max(axis=0) if self.nranks else np.zeros(B)
        return [ProgramResult(
            float(latency[b]),
            tuple(float(x) for x in final[:, b]),
            tuple(float(x) for x in bound.rank_compute[:, b]),
            len(st.events), len(st.sites)) for b in range(B)]

    def _exec_p2p_level(self, state, pl: _PLevel, bl: _BoundLevel, C,
                        bound, send_done, recv_done) -> None:
        t_send = C[pl.send_seg] + bound.post_off[pl.send_post]
        t_recv = C[pl.recv_seg] + bound.post_off[pl.recv_post]
        lv, nb = pl.lv, bl.nb
        if not bl.any_r:
            comp, sfree = self._run_eager(state, lv, t_send, nb, None, None)
            send_done[pl.ev] = sfree
            recv_done[pl.ev] = np.maximum(comp, t_recv)
            return
        if not bl.any_e:
            comp, _ = self._run_rdv(state, lv, np.maximum(t_send, t_recv),
                                    nb, None, None, bl.uni)
            send_done[pl.ev] = comp
            recv_done[pl.ev] = comp
            return
        act_r = np.broadcast_to(bl.is_rdv, t_send.shape)
        comp_e, sfree_e = self._run_eager(state, lv, t_send, nb, ~act_r,
                                          None)
        comp_r, _ = self._run_rdv(state, lv, np.maximum(t_send, t_recv),
                                  nb, act_r, None, False)
        send_done[pl.ev] = np.where(bl.is_rdv, comp_r, sfree_e)
        recv_done[pl.ev] = np.where(bl.is_rdv, comp_r,
                                    np.maximum(comp_e, t_recv))

    def _exec_waits(self, wp: _WaitPlan, C, bound, send_done,
                    recv_done) -> None:
        exit_ = C[wp.prev] + bound.seg_total[wp.prev]
        if wp.req_ev.size:
            vals = np.where(wp.req_side[:, None], send_done[wp.req_ev],
                            recv_done[wp.req_ev])
            gm = np.maximum.reduceat(vals, wp.starts, axis=0)
            exit_[wp.with_req] = np.maximum(exit_[wp.with_req], gm)
        C[wp.target] = exit_

    def _exec_coll(self, state, slot: _CollSlot, C, bound,
                   send_done=None) -> None:
        if slot.entry_item is None:         # blocking: entry ends a segment
            enters = C[slot.entry] + bound.seg_total[slot.entry]
        else:                               # nonblocking: mid-segment item
            enters = C[slot.entry] + bound.coll_entry_off[slot.site.idx]
        sizes = bound.site_sizes[slot.site.idx]
        if slot.name is None:               # nranks < 2: pass-through
            exits = enters
        elif slot.name == "accel":
            from repro_torch.core.exanet.allreduce_accel import accel_cost_us
            cost = np.array([accel_cost_us(s, self.nranks, self._p)
                             for s in sizes])
            exits = np.broadcast_to(
                enters.max(axis=0)[None, :] + cost[None, :], enters.shape)
        else:
            rp, sched = slot.rp, slot.sched
            res = rp.run(sched, sizes, state=state, t0=enters,
                         engine=self._eng, deg=self._deg)
            b = rp.bind(sched, sizes)
            exits = res.clocks.T + b.post_copy_us[None, :] + \
                self._p.barrier_exit_us
        if slot.entry_item is None:
            C[slot.exit] = exits
        else:
            send_done[slot.virt_base:slot.virt_base + self.nranks] = exits


def compile_program_ir(mpi, prog: Program) -> CompiledProgram:
    """Lower a Program's structure for one (machine, placement).  Payload
    data (sizes, compute times) binds per column via
    :meth:`CompiledProgram.bind`."""
    return CompiledProgram(mpi, prog)
