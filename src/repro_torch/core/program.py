"""Program IR: per-rank communication/compute programs (DESIGN.md §2.6).

A :class:`Program` is what an application *does* per iteration, expressed as
one op sequence per rank:

* :class:`Compute` — local work in microseconds (occupies the rank's core);
* :class:`Isend` / :class:`Irecv` — nonblocking tagged point-to-point
  (matched FIFO per (src, dst, tag) channel, like MPI);
* :class:`Wait` — block until named requests (or all outstanding ones)
  complete;
* :class:`Collective` — an embedded collective over all program ranks,
  executed by schedule (``algo="auto"`` lets the
  :class:`repro_torch.core.planner.CollectivePlanner` pick it by cost).

The IR is pure structure: no link rates, no engine, no jax — the same
split that keeps :mod:`repro_torch.core.exanet.schedules` hardware-free.  Two
executors share it:

* :class:`ProgramExecutor` here is the *scheduler* (per-rank clocks, FIFO
  message matching, waits, collective barriers, deadlock detection) over
  pluggable cost hooks;
* :meth:`repro.core.exanet.mpi.ExanetMPI.run_program` binds the hooks to
  the discrete-event engine, so independent flows from every rank contend
  on the shared R5/DMA/link resources — full-machine halo congestion is
  *simulated*, not modeled;
* :func:`analytic_hooks` binds them to closed-form alpha-beta costs (no
  contention) — the reference the sim is compared against, and the TPU
  machine's only fidelity.

Builders for the common shapes live here too: :func:`halo3d` (nearest-
neighbour 3-D halo exchange), :func:`cg_iteration` (halo + SpMV compute +
dot-product allreduces), :func:`bsp_step` (compute + one collective).

The port's copy of the reference's ``repro.core.program``, whole: the same
names, layout and float arithmetic, with its imports rewritten to
``repro_torch`` (``tests/test_torch_planner.py`` holds the two equal).
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Callable, Iterator, Sequence, Union


class ProgramError(Exception):
    """Malformed program: bad rank ids, reused handles, size-mismatched
    matches, or unmatched sends/recvs at program exit."""


class ProgramDeadlockError(ProgramError):
    """No rank can make progress: a Wait on a request whose peer never
    posts (mismatched tag/peer), or a Collective some ranks never reach."""


# ------------------------------------------------------------------- the IR
@dataclasses.dataclass(frozen=True)
class Compute:
    """Local work for ``us`` microseconds on the rank's core."""
    us: float


@dataclasses.dataclass(frozen=True)
class Isend:
    """Nonblocking tagged send of ``nbytes`` to rank ``dst``."""
    dst: int
    nbytes: int
    tag: int = 0
    handle: str | None = None   # name for a selective Wait; None = anonymous


@dataclasses.dataclass(frozen=True)
class Irecv:
    """Nonblocking tagged receive of ``nbytes`` from rank ``src``."""
    src: int
    nbytes: int
    tag: int = 0
    handle: str | None = None


@dataclasses.dataclass(frozen=True)
class Wait:
    """Block until the named requests complete; ``handles=None`` waits on
    every outstanding request of the rank (MPI_Waitall)."""
    handles: tuple[str, ...] | None = None


@dataclasses.dataclass(frozen=True)
class Collective:
    """An embedded collective over all program ranks.  ``algo="auto"``
    defers schedule choice to the planner (allreduce only; other ops fall
    back to their single shipped schedule).

    With ``handle=None`` the collective is a full barrier: every rank's
    clock advances to its exit.  With a handle it is *nonblocking*
    (MPI_Iallreduce): each rank records its entry clock and keeps
    executing — the transfer progresses off the core (NI/DMA-driven) —
    and a later :class:`Wait` on the handle (or ``Wait()``) joins the
    rank's exit clock.  This is the seam that lets backward/sync overlap
    in a training step be *emergent* rather than assumed: the exit clocks
    still come from the full schedule replay on the shared engine
    resources, only the rank cores stop standing still."""
    op: str                 # "allreduce" | "bcast" | "allgather" | ...
    nbytes: int
    algo: str = "auto"
    handle: str | None = None   # None = blocking barrier semantics


Op = Union[Compute, Isend, Irecv, Wait, Collective]


@dataclasses.dataclass(frozen=True)
class Program:
    """One op sequence per rank (SPMD programs repeat the same shape)."""
    rank_ops: tuple[tuple[Op, ...], ...]

    @property
    def nranks(self) -> int:
        return len(self.rank_ops)

    def collectives(self) -> list[Collective]:
        """Unique Collective sites, in first-appearance order across ranks
        (what :meth:`CollectivePlanner.plan_program` plans in one pass)."""
        seen: dict[tuple, Collective] = {}
        for ops in self.rank_ops:
            for op in ops:
                if isinstance(op, Collective):
                    seen.setdefault((op.op, op.nbytes, op.algo), op)
        return list(seen.values())

    def compute_us(self, rank: int) -> float:
        """Total Compute microseconds of one rank (contention-free lower
        bound; per-rank cores never contend, so this is also the simulated
        compute time)."""
        return sum(op.us for op in self.rank_ops[rank]
                   if isinstance(op, Compute))

    def counts(self) -> dict[str, int]:
        c: dict[str, int] = {}
        for ops in self.rank_ops:
            for op in ops:
                k = type(op).__name__.lower()
                c[k] = c.get(k, 0) + 1
        return c

    def structure_key(self) -> tuple:
        """Hashable fingerprint of the program's *structure*: op kinds,
        peers, tags, handles and collective (op, algo) — everything except
        the bindable payload data (``Compute.us``, ``Isend``/``Irecv``/
        ``Collective.nbytes``).  Two programs with equal keys have
        identical FIFO channel matchings, wait sets and collective sites,
        so a compiled execution artifact
        (:mod:`repro.core.exanet.program_compiled`) lowered for one can be
        re-bound with the other's sizes — the Program analog of
        ``RoundProgram``'s per-(schedule, nranks) cache key."""
        sig = []
        for ops in self.rank_ops:
            row = []
            for op in ops:
                if isinstance(op, Compute):
                    row.append(("c",))
                elif isinstance(op, Isend):
                    row.append(("s", op.dst, op.tag, op.handle))
                elif isinstance(op, Irecv):
                    row.append(("r", op.src, op.tag, op.handle))
                elif isinstance(op, Wait):
                    row.append(("w", op.handles))
                elif isinstance(op, Collective):
                    row.append(("x", op.op, op.algo, op.handle))
                else:
                    row.append(("?", repr(op)))
            sig.append(tuple(row))
        return (self.nranks, tuple(sig))

    def validate(self) -> None:
        n = self.nranks
        for r, ops in enumerate(self.rank_ops):
            for op in ops:
                if isinstance(op, Isend) and not 0 <= op.dst < n:
                    raise ProgramError(f"rank {r}: Isend dst {op.dst} "
                                       f"outside [0, {n})")
                if isinstance(op, Irecv) and not 0 <= op.src < n:
                    raise ProgramError(f"rank {r}: Irecv src {op.src} "
                                       f"outside [0, {n})")
                if isinstance(op, (Isend, Irecv)) and op.nbytes < 0:
                    raise ProgramError(f"rank {r}: negative nbytes")


# ---------------------------------------------------------------- builders
def balanced_grid3(n: int) -> tuple[int, int, int]:
    """Balanced 3-D process grid of ``n`` ranks (largest factors last) —
    the block decomposition HPCG/miniFE/LAMMPS all use."""
    best = (n, 1, 1)
    score = float("inf")
    for px in range(1, n + 1):
        if n % px:
            continue
        rem = n // px
        for py in range(1, rem + 1):
            if rem % py:
                continue
            pz = rem // py
            s = max(px, py, pz) / min(px, py, pz)
            if s < score:
                score, best = s, (px, py, pz)
    return best


def _halo_neighbors(rank: int, grid: tuple[int, int, int]
                    ) -> list[tuple[int, int]]:
    """(neighbor_rank, face_index) of the up-to-6 periodic face neighbours.
    face_index = 2*dim + (0 for +, 1 for -), from the *sender's* view."""
    px, py, pz = grid
    x, y, z = rank % px, (rank // px) % py, rank // (px * py)
    out = []
    for dim, (c, extent) in enumerate(((x, px), (y, py), (z, pz))):
        if extent == 1:
            continue  # periodic self-neighbour: no message
        for face, step in ((0, 1), (1, -1)):
            cc = (c + step) % extent
            coords = [x, y, z]
            coords[dim] = cc
            nb = coords[0] + px * (coords[1] + py * coords[2])
            out.append((nb, 2 * dim + face))
    return out


def halo3d(nranks: int, face_bytes: int, compute_us: float = 0.0, *,
           grid: tuple[int, int, int] | None = None,
           overlap: bool = False) -> Program:
    """One BSP step of a 3-D halo exchange: every rank posts receives for
    its (up to) 6 faces, sends its 6 faces, then computes.  With
    ``overlap=True`` the compute is issued *between* the sends and the
    Wait, so it hides communication up to the critical path (the paper's
    codes under MPICH do not overlap; the option exists for the IR's
    overlap semantics and their tests).

    A face sent in direction +x carries tag 0; the receiver (our +x
    neighbour) posts tag 0 from us — tags pair the six faces even when two
    ranks exchange more than one face (e.g. 2-rank periodic grids).
    """
    grid = grid or balanced_grid3(nranks)
    if grid[0] * grid[1] * grid[2] != nranks:
        raise ProgramError(f"grid {grid} does not tile {nranks} ranks")
    ranks = []
    for r in range(nranks):
        ops: list[Op] = []
        for nb, face in _halo_neighbors(r, grid):
            # the message we receive from neighbour `nb` is the one *they*
            # sent toward us: their face index, which is ours with the
            # +/- bit flipped in the same dimension
            ops.append(Irecv(src=nb, nbytes=face_bytes, tag=face ^ 1))
        for nb, face in _halo_neighbors(r, grid):
            ops.append(Isend(dst=nb, nbytes=face_bytes, tag=face))
        if overlap and compute_us > 0.0:
            ops.append(Compute(compute_us))
        ops.append(Wait())
        if not overlap and compute_us > 0.0:
            ops.append(Compute(compute_us))
        ranks.append(tuple(ops))
    return Program(tuple(ranks))


def cg_iteration(nranks: int, face_bytes: int, compute_us: float, *,
                 n_dots: int = 2, dot_bytes: int = 8,
                 coll_algo: str = "auto",
                 grid: tuple[int, int, int] | None = None,
                 overlap: bool = False) -> Program:
    """One CG-style iteration: halo exchange + SpMV/smoother compute +
    ``n_dots`` dot-product allreduces of ``dot_bytes`` each — the
    iteration shape of HPCG and miniFE (§6.2)."""
    halo = halo3d(nranks, face_bytes, compute_us, grid=grid,
                  overlap=overlap)
    dots = tuple(Collective("allreduce", dot_bytes, coll_algo)
                 for _ in range(n_dots))
    return Program(tuple(ops + dots for ops in halo.rank_ops))


def bsp_step(nranks: int, compute_us: float, coll_op: str = "allreduce",
             coll_bytes: int = 0, *, coll_algo: str = "auto") -> Program:
    """Plain bulk-synchronous step: compute then one collective."""
    ops: tuple[Op, ...] = (Compute(compute_us),)
    if coll_bytes or coll_op == "barrier":
        ops += (Collective(coll_op, coll_bytes, coll_algo),)
    return Program(tuple(ops for _ in range(nranks)))


# -------------------------------------------------------------- the runner
@dataclasses.dataclass(frozen=True)
class ProgramResult:
    """Outcome of one program execution."""
    latency_us: float            # completion time of the slowest rank
    clocks: tuple[float, ...]    # per-rank completion times
    compute_us: tuple[float, ...]  # per-rank total Compute time
    n_sends: int
    n_collectives: int

    @property
    def comm_us(self) -> float:
        """Communication on the critical path: what the iteration pays on
        top of the slowest rank's pure compute.  This is the quantity the
        retired closed-form ``alpha`` used to multiply."""
        return self.latency_us - max(self.compute_us, default=0.0)


@dataclasses.dataclass(eq=False)  # identity semantics: two posts are two
class _Req:                       # requests even with identical fields
    rank: int
    peer: int
    nbytes: int
    tag: int
    is_send: bool
    t_post: float
    t_done: float | None = None


class ProgramExecutor:
    """Event-driven scheduler of a :class:`Program` over cost hooks.

    Hooks (all times in microseconds):

    * ``compute(rank, us, t) -> t_end`` — local work;
    * ``p2p(src, dst, nbytes, tag, t_send, t_recv) -> (t_send_done,
      t_recv_done)`` — one matched point-to-point transfer, called at
      match time (eager transfers depart at ``t_send``, rendez-vous ones
      cannot start before ``max(t_send, t_recv)`` — the hook decides);
    * ``collective(op, nbytes, algo, enters) -> exits`` — per-rank entry
      clocks to per-rank exit clocks.

    Ranks advance one op per scheduling step, always the rank with the
    smallest clock first, so shared-resource hooks see sends in near
    global-time order (exact time ordering is the hooks' concern; the
    engine's ``Resource.acquire`` serializes whatever order it is called
    in).  Execution is deterministic: ties break by rank id.
    """

    def __init__(self, prog: Program, *,
                 compute: Callable[[int, float, float], float],
                 p2p: Callable[..., tuple[float, float]],
                 collective: Callable[..., list[float]],
                 post_overhead_us: float = 0.0):
        prog.validate()
        self.prog = prog
        self._compute = compute
        self._p2p = p2p
        self._collective = collective
        #: local CPU cost of posting one Isend/Irecv (descriptor write /
        #: request setup) charged on the poster's clock
        self.post_overhead_us = post_overhead_us

    # ------------------------------------------------------------- matching
    def _match(self, send: _Req, recv: _Req) -> None:
        if send.nbytes != recv.nbytes:
            raise ProgramError(
                f"size mismatch on channel ({send.rank}->{send.peer}, "
                f"tag {send.tag}): Isend {send.nbytes} B vs Irecv "
                f"{recv.nbytes} B")
        send.t_done, recv.t_done = self._p2p(
            send.rank, recv.rank, send.nbytes, send.tag,
            send.t_post, recv.t_post)
        self._n_sends += 1

    def run(self, t0: float | Sequence[float] = 0.0) -> ProgramResult:
        prog = self.prog
        n = prog.nranks
        if hasattr(t0, "__len__"):
            t0s = [float(v) for v in t0]
            if len(t0s) != n:
                raise ProgramError(
                    f"t0 has {len(t0s)} entries for {n} ranks")
        else:
            t0s = [float(t0)] * n
        clock = list(t0s)
        pc = [0] * n
        compute_tot = [0.0] * n
        self._n_sends = 0
        n_coll = 0
        # FIFO channels of unmatched posts, keyed (src, dst, tag)
        sends: dict[tuple, deque] = {}
        recvs: dict[tuple, deque] = {}
        # per-rank outstanding requests; named handles point into it
        outstanding: dict[int, list[_Req]] = {r: [] for r in range(n)}
        named: dict[tuple[int, str], _Req] = {}
        # blocked ranks: rank -> ("wait", [reqs]) | ("coll", site_key)
        blocked: dict[int, tuple] = {}
        coll_idx = [0] * n
        barriers: dict[int, dict[int, float]] = {}
        # nonblocking collective sites: site -> {rank: pseudo-request}
        coll_reqs: dict[int, dict[int, _Req]] = {}
        ready = [(t0s[r], r) for r in range(n) if prog.rank_ops[r]]
        heapq.heapify(ready)

        def wake_waiters() -> None:
            for r in [r for r, b in blocked.items() if b[0] == "wait"]:
                reqs = blocked[r][1]
                if all(q.t_done is not None for q in reqs):
                    del blocked[r]
                    clock[r] = max([clock[r]] + [q.t_done for q in reqs])
                    heapq.heappush(ready, (clock[r], r))

        while ready:
            _, r = heapq.heappop(ready)
            if r in blocked or pc[r] >= len(prog.rank_ops[r]):
                continue
            op = prog.rank_ops[r][pc[r]]
            pc[r] += 1
            if isinstance(op, Compute):
                t_end = self._compute(r, op.us, clock[r])
                compute_tot[r] += op.us
                clock[r] = t_end
            elif isinstance(op, (Isend, Irecv)):
                is_send = isinstance(op, Isend)
                peer = op.dst if is_send else op.src
                key = (r, peer, op.tag) if is_send else (peer, r, op.tag)
                req = _Req(r, peer, op.nbytes, op.tag, is_send, clock[r])
                clock[r] += self.post_overhead_us
                outstanding[r].append(req)
                if op.handle is not None:
                    if (r, op.handle) in named:
                        raise ProgramError(
                            f"rank {r}: handle {op.handle!r} reused while "
                            f"still outstanding")
                    named[(r, op.handle)] = req
                mine, theirs = (sends, recvs) if is_send else (recvs, sends)
                q = theirs.get(key)
                if q:
                    other = q.popleft()
                    self._match(req if is_send else other,
                                other if is_send else req)
                    wake_waiters()
                else:
                    mine.setdefault(key, deque()).append(req)
            elif isinstance(op, Wait):
                if op.handles is None:
                    reqs = outstanding[r]
                else:
                    try:
                        reqs = [named[(r, h)] for h in op.handles]
                    except KeyError as e:
                        raise ProgramError(
                            f"rank {r}: Wait on unknown handle {e}") from e
                if all(q.t_done is not None for q in reqs):
                    clock[r] = max([clock[r]] + [q.t_done for q in reqs])
                else:
                    blocked[r] = ("wait", list(reqs))
                # consume: a waited request cannot be waited on again
                outstanding[r] = [q for q in outstanding[r] if q not in reqs]
                for q in reqs:
                    for h, v in list(named.items()):
                        if v is q:
                            del named[h]
            elif isinstance(op, Collective):
                site = coll_idx[r]
                coll_idx[r] += 1
                sig = (op.op, op.nbytes, op.algo, op.handle)
                bar, first = barriers.setdefault(site, ({}, sig))
                if sig != first:
                    raise ProgramError(
                        f"collective mismatch at site #{site}: rank {r} "
                        f"calls {sig}, another rank called {first} — "
                        f"ranks must reach matching collectives in the "
                        f"same order")
                bar[r] = clock[r]
                if op.handle is not None:
                    # nonblocking: register a pseudo-request per rank (the
                    # entry pays the same local post cost as an Isend) and
                    # keep executing; the hook fires on last arrival and
                    # completes the requests without touching clocks.
                    req = _Req(r, -1, op.nbytes, -1, False, clock[r])
                    clock[r] += self.post_overhead_us
                    outstanding[r].append(req)
                    if (r, op.handle) in named:
                        raise ProgramError(
                            f"rank {r}: handle {op.handle!r} reused while "
                            f"still outstanding")
                    named[(r, op.handle)] = req
                    coll_reqs.setdefault(site, {})[r] = req
                    if len(bar) == n:
                        enters = [bar[i] for i in range(n)]
                        exits = self._collective(op.op, op.nbytes, op.algo,
                                                 enters)
                        n_coll += 1
                        del barriers[site]
                        for i, q in coll_reqs.pop(site).items():
                            q.t_done = exits[i]
                        wake_waiters()
                elif len(bar) == n:
                    enters = [bar[i] for i in range(n)]
                    exits = self._collective(op.op, op.nbytes, op.algo,
                                             enters)
                    n_coll += 1
                    del barriers[site]
                    for i in range(n):
                        clock[i] = exits[i]
                        if i != r and blocked.get(i, (None,))[0] == "coll":
                            del blocked[i]
                            heapq.heappush(ready, (clock[i], i))
                else:
                    blocked[r] = ("coll", site)
            else:
                raise ProgramError(f"rank {r}: unknown op {op!r}")
            if r not in blocked and pc[r] < len(prog.rank_ops[r]):
                heapq.heappush(ready, (clock[r], r))

        unfinished = [r for r in range(n)
                      if r in blocked or pc[r] < len(prog.rank_ops[r])]
        if unfinished:
            raise ProgramDeadlockError(self._diagnose(blocked, unfinished,
                                                      sends, recvs))
        dangling = [q for qs in list(sends.values()) + list(recvs.values())
                    for q in qs]
        if dangling:
            d = dangling[0]
            kind = "Isend" if d.is_send else "Irecv"
            raise ProgramError(
                f"program completed with {len(dangling)} unmatched "
                f"request(s); first: rank {d.rank} {kind} peer={d.peer} "
                f"tag={d.tag} ({d.nbytes} B)")
        return ProgramResult(max(clock) if clock else max(t0s, default=0.0),
                             tuple(clock),
                             tuple(compute_tot), self._n_sends, n_coll)

    @staticmethod
    def _diagnose(blocked: dict, unfinished: list, sends: dict,
                  recvs: dict) -> str:
        parts = [f"deadlock: {len(unfinished)} rank(s) cannot progress"]
        for r in unfinished[:8]:
            b = blocked.get(r)
            if b is None:
                parts.append(f"  rank {r}: never scheduled")
            elif b[0] == "coll":
                parts.append(f"  rank {r}: in collective barrier #{b[1]} "
                             f"other ranks never reach")
            else:
                pend = [q for q in b[1] if q.t_done is None]
                what = ", ".join(
                    f"Collective({q.nbytes} B) some ranks never post"
                    if q.peer < 0 else
                    f"{'Isend' if q.is_send else 'Irecv'}(peer={q.peer}, "
                    f"tag={q.tag}, {q.nbytes} B)" for q in pend[:4])
                parts.append(f"  rank {r}: Wait on unmatched {what}")
        un = sum(len(q) for q in sends.values())
        ur = sum(len(q) for q in recvs.values())
        parts.append(f"  unmatched posts: {un} send(s), {ur} recv(s) — "
                     f"check (src, dst, tag) pairing")
        return "\n".join(parts)


# ------------------------------------------------------- closed-form hooks
def analytic_hooks(alpha_us: float, bw_bytes_per_us: float,
                   coll_cost_us: Callable[[str, int, str], float]) -> dict:
    """Contention-free alpha-beta hooks: a point-to-point message costs
    ``alpha + nbytes/bw`` after both sides are ready; compute is exact;
    collectives are barrier + ``coll_cost_us(op, nbytes, algo)``.  This is
    the closed-form reference the event-engine execution is validated
    against in the no-contention limit, and the only fidelity machines
    without an event simulator (the TPU target) have."""

    def compute(rank: int, us: float, t: float) -> float:
        return t + us

    def p2p(src: int, dst: int, nbytes: int, tag: int,
            t_send: float, t_recv: float) -> tuple[float, float]:
        done = max(t_send, t_recv) + alpha_us + nbytes / bw_bytes_per_us
        return t_send + alpha_us, done

    def collective(op: str, nbytes: int, algo: str,
                   enters: list[float]) -> list[float]:
        t = max(enters) + coll_cost_us(op, nbytes, algo)
        return [t] * len(enters)

    return {"compute": compute, "p2p": p2p, "collective": collective}


def analytic_program_us(prog: Program, *, alpha_us: float,
                        bw_bytes_per_us: float,
                        coll_cost_us: Callable[[str, int, str], float]
                        ) -> ProgramResult:
    """Closed-form program time (microseconds): the :func:`analytic_hooks`
    semantics run through the same scheduler as the event engine."""
    return ProgramExecutor(prog, **analytic_hooks(
        alpha_us, bw_bytes_per_us, coll_cost_us)).run()


def rounds_iter(prog: Program) -> Iterator[Op]:
    """Flat op iterator (debug/introspection helper)."""
    for ops in prog.rank_ops:
        yield from ops
