"""Multi-tenant interference: concurrent background Programs contending
on the shared event-engine resources (DESIGN.md §2.10).

The prototype has no inter-job traffic isolation: a neighbour tenant's
RDMA streams share mezzanine-level links and network-MPSoC crossbar ports
with the application.  This module builds *merged* Programs — one rank
set carrying the application's ops, another the background tenant's — so
congestion stays **emergent**: both tenants' sends run through the same
interpreter/compiled transports on the same resources, and slowdown falls
out of link occupancy, never out of a fitted contention model.

Placement matters: under dimension-ordered routing with a full
intra-QFDB crossbar, two tenants occupying *disjoint whole QFDBs* own
disjoint links and never interfere.  Real co-tenancy shares QFDBs — each
tenant gets some MPSoCs of each board, and both tenants' cross-QFDB
traffic funnels through the board's single network MPSoC onto the same
mezzanine links.  :func:`interleave_qfdb` builds that placement;
:func:`merge_tenants` accepts any explicit rank mapping.

The neighbour-load axis rides the batched substrate: background posts get
their own rows of a ``byte_scale`` (n_posts, N) array
(:func:`neighbor_load_byte_scale`), so an interference *curve* — app
efficiency vs. background load — costs one
:meth:`~repro_torch.core.exanet.mpi.ExanetMPI.run_program_scenarios` replay.
The load-0 column is the in-placement baseline (the tenant still posts,
but carries ~0 bytes).

Constraint: embedded ``Collective`` sites span every rank of a Program,
so both tenants must be collective-free (pure point-to-point, e.g.
:func:`~repro_torch.core.program.halo3d`); :func:`merge_tenants` rejects
programs with sites rather than silently simulating a collective that
straddles tenants.

The port's copy of the reference's ``repro.core.exanet.interference``, whole:
the same names, layout and float arithmetic, with its imports
rewritten to ``repro_torch``. ``tests/test_torch_exanet_apps.py`` holds
the two equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.program import (Collective, Compute, Irecv, Isend,
                                      Program, ProgramError, Wait)

#: tag base for background-tenant channels.  Channels are keyed
#: (src, dst, tag) with merged ranks, so collisions with app tags are
#: impossible; the distinct base just makes traces readable.
BG_TAG = 7000


@dataclasses.dataclass(frozen=True)
class TenantMix:
    """A merged two-tenant Program plus the bookkeeping the sweeps need."""
    program: Program
    app_ranks: tuple           # merged rank of each app rank
    bg_ranks: tuple            # merged rank of each background rank
    bg_post_mask: np.ndarray   # (n_posts,) bool, True on background posts

    def app_latency_us(self, result) -> float:
        """The application's finish time: max over *app* rank clocks (the
        merged program's global latency includes the background tenant,
        which deliberately outlives the app)."""
        return max(result.clocks[r] for r in self.app_ranks)


def background_stream(n_bg: int, iters: int, nbytes: int, *,
                      stride: int | None = None,
                      compute_us: float = 0.0) -> Program:
    """A background tenant: ``n_bg`` ranks in pairwise exchange at
    ``stride`` (rank ``r`` partners ``r + stride``; default ``n_bg // 2``
    — long-range traffic that crosses QFDBs and loads the mezzanine
    rings), ``iters`` rounds of Isend/Irecv/Wait of ``nbytes`` each,
    optionally separated by ``compute_us`` of local work (an idle-ish
    tenant).  Ranks without a partner sit out.  Sized by the caller so
    the stream outlives the app under every load column (see
    :func:`size_background`)."""
    if stride is None:
        stride = max(1, n_bg // 2)
    rank_ops = []
    for r in range(n_bg):
        lo = r if (r // stride) % 2 == 0 else r - stride
        partner = r + stride if r == lo else r - stride
        ops: list = []
        if not 0 <= partner < n_bg or partner == r:
            rank_ops.append(())
            continue
        for it in range(iters):
            if compute_us > 0.0:
                ops.append(Compute(us=compute_us))
            tag = BG_TAG + it
            ops.append(Isend(partner, nbytes, tag=tag))
            ops.append(Irecv(partner, nbytes, tag=tag))
            ops.append(Wait())
        rank_ops.append(tuple(ops))
    return Program(tuple(rank_ops))


def interleave_qfdb(n_app: int, n_bg: int,
                    cores_per_qfdb: int = 16) -> tuple[tuple, tuple]:
    """Co-tenant placement: walk QFDBs, giving the first half of each
    board's cores to the app and the second half to the background
    tenant, until both are placed.  Cross-QFDB traffic of *both* tenants
    then shares each board's network MPSoC and its mezzanine links — the
    physical medium of multi-tenant interference.  Returns
    (app_ranks, bg_ranks) merged-rank mappings."""
    half = cores_per_qfdb // 2
    app, bg = [], []
    core = 0
    while len(app) < n_app or len(bg) < n_bg:
        for i in range(half):
            if len(app) < n_app:
                app.append(core + i)
        for i in range(half):
            if len(bg) < n_bg:
                bg.append(core + half + i)
        core += cores_per_qfdb
    return tuple(app), tuple(bg)


def _check_p2p(prog: Program, who: str) -> None:
    for ops in prog.rank_ops:
        for op in ops:
            if isinstance(op, Collective):
                raise ProgramError(
                    f"merge_tenants: {who} program has a Collective "
                    "site; collectives span every rank of a Program, so "
                    "a merged tenant mix must be point-to-point only")


def merge_tenants(app: Program, bg: Program, app_ranks=None,
                  bg_ranks=None) -> TenantMix:
    """Merge two tenants into one Program over the union of their
    placements.  ``app_ranks`` / ``bg_ranks`` map tenant rank -> merged
    rank (default: app on [0, n_app), background appended after it — a
    whole-QFDB split; pass :func:`interleave_qfdb` mappings for shared
    boards).  Peers inside each tenant's ops are remapped; unassigned
    merged ranks idle.  The returned mask marks background posts in the
    merged program's static post order (rank-major, program order — the
    ``byte_scale`` row order of ``run_program_scenarios``)."""
    _check_p2p(app, "app")
    _check_p2p(bg, "background")
    if app_ranks is None:
        app_ranks = tuple(range(app.nranks))
    if bg_ranks is None:
        bg_ranks = tuple(range(app.nranks, app.nranks + bg.nranks))
    app_ranks, bg_ranks = tuple(app_ranks), tuple(bg_ranks)
    if len(app_ranks) != app.nranks or len(bg_ranks) != bg.nranks:
        raise ValueError(f"rank maps must cover both tenants: "
                         f"{len(app_ranks)} vs {app.nranks} app, "
                         f"{len(bg_ranks)} vs {bg.nranks} bg")
    overlap = set(app_ranks) & set(bg_ranks)
    if overlap:
        raise ValueError(f"tenants overlap on merged ranks {sorted(overlap)[:4]}")

    def remap(ops, m):
        row = []
        for op in ops:
            if isinstance(op, Isend):
                row.append(dataclasses.replace(op, dst=m[op.dst]))
            elif isinstance(op, Irecv):
                row.append(dataclasses.replace(op, src=m[op.src]))
            else:
                row.append(op)
        return tuple(row)

    total = max((*app_ranks, *bg_ranks)) + 1
    merged: list = [()] * total
    is_bg: list = [False] * total
    for i, r in enumerate(app_ranks):
        merged[r] = remap(app.rank_ops[i], app_ranks)
    for i, r in enumerate(bg_ranks):
        merged[r] = remap(bg.rank_ops[i], bg_ranks)
        is_bg[r] = True
    mask = np.array([is_bg[r] for r in range(total)
                     for op in merged[r]
                     if isinstance(op, (Isend, Irecv))], dtype=bool)
    return TenantMix(Program(tuple(merged)), app_ranks, bg_ranks, mask)


def neighbor_load_byte_scale(mix: TenantMix, loads) -> np.ndarray:
    """The neighbour-load axis: (n_posts, N) ``byte_scale`` columns that
    scale only the background tenant's payloads.  ``loads`` is the (N,)
    relative background intensity (0 silences the tenant — posts still
    fire but carry ~0 bytes; 1 is the nominal stream)."""
    loads = np.asarray(loads, dtype=np.float64)
    if loads.ndim != 1:
        raise ValueError(f"loads must be (N,); got shape {loads.shape}")
    if (loads < 0).any():
        raise ValueError("negative background load")
    bs = np.ones((len(mix.bg_post_mask), len(loads)))
    bs[mix.bg_post_mask] = loads
    return bs


def size_background(app_us: float, iters_hint: int,
                    round_us: float) -> int:
    """Iterations needed for the background stream to outlive the app:
    ceil(app_us / round_us) with a floor of ``iters_hint`` (round_us is
    the tenant's own per-iteration time, measured or estimated by the
    caller)."""
    if round_us <= 0:
        return iters_hint
    return max(iters_hint, int(np.ceil(app_us / round_us)))
