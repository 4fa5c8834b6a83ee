"""Contribution-tracking semantic verification for collective schedules.

The synthesis search (:mod:`repro_torch.core.synth.search`) optimizes simulated
*cost*; nothing in the fitness function knows whether a candidate still
computes an allreduce.  This module is the gate that does — the
equivalence check (Exo's role model): replay a schedule's annotated data
rounds (:class:`~repro_torch.core.exanet.schedule_algebra.DataRound`)
through an exact multiset model and require that **every rank ends
holding every rank's contribution exactly once on every atom**.

State is an integer tensor ``counts[holder, atom, src]`` starting as the
identity (each rank holds its own contribution once).  Within a round
all reads come from the pre-round snapshot (sendrecv semantics); a
``reduce`` send adds the source's multiset into the destination, a
replace send overwrites it.  The final state must be all-ones: a
schedule that double-counts, drops, or misroutes any contribution fails
loudly with the first offending (holder, atom, src) triple.

Menu schedules lower to plain :class:`~repro_torch.core.exanet.schedules.Round`
streams without atom annotations, so this module carries their semantic
twins (:data:`MENU_SEMANTICS`) — the documented dataflow of each
hand-written algorithm in annotated form.  Algebra terms are annotated
natively.

The port's copy of the reference's ``repro.core.synth.verify``, whole: the
same names, layout and float arithmetic, with its imports rewritten to
``repro_torch`` (``tests/test_torch_planner.py`` holds the two equal).
"""

from __future__ import annotations

import numpy as np

from ..exanet.schedule_algebra import (DataRound, DataSend, Split, Term,
                                       TermSchedule)


class SemanticCheckError(Exception):
    """A schedule's dataflow is not an exact-once allreduce."""


def contribution_check(data_rounds, nranks: int, n_atoms: int,
                       *, label: str = "schedule") -> None:
    """Raise :class:`SemanticCheckError` unless the rounds implement an
    exact-once allreduce over ``nranks`` ranks and ``n_atoms`` atoms."""
    counts = np.zeros((nranks, n_atoms, nranks), dtype=np.int32)
    idx = np.arange(nranks)
    counts[idx, :, idx] = 1
    for dr in data_rounds:
        snap = counts.copy()
        replaced = np.zeros((nranks, n_atoms), dtype=bool)
        for s in dr.sends:
            if not (0 <= s.src < nranks and 0 <= s.dst < nranks):
                raise SemanticCheckError(
                    f"{label}: send {s} outside rank range at step {dr.step}")
            if not (0 <= s.a_lo < s.a_hi <= n_atoms):
                raise SemanticCheckError(
                    f"{label}: send {s} outside atom range at step {dr.step}")
            sl = slice(s.a_lo, s.a_hi)
            if s.reduce:
                if replaced[s.dst, sl].any():
                    raise SemanticCheckError(
                        f"{label}: reduce and replace race on rank "
                        f"{s.dst} atoms [{s.a_lo},{s.a_hi}) at step "
                        f"{dr.step}")
                counts[s.dst, sl, :] += snap[s.src, sl, :]
            else:
                if replaced[s.dst, sl].any():
                    raise SemanticCheckError(
                        f"{label}: two replaces on rank {s.dst} atoms "
                        f"[{s.a_lo},{s.a_hi}) at step {dr.step}")
                counts[s.dst, sl, :] = snap[s.src, sl, :]
                replaced[s.dst, sl] = True
    bad = np.argwhere(counts != 1)
    if len(bad):
        h, a, src = (int(v) for v in bad[0])
        raise SemanticCheckError(
            f"{label}: rank {h} ends holding rank {src}'s contribution "
            f"{int(counts[h, a, src])} times on atom {a} "
            f"(expected exactly once); {len(bad)} violations total")


def check_term(term: Term, nranks: int) -> None:
    """Semantic gate for an algebra term at a rank count."""
    term.validate(nranks)
    contribution_check(term.data_rounds(nranks), nranks,
                       term.n_atoms(nranks),
                       label=f"term {term.spec()!r} @ {nranks} ranks")


# ------------------------------------------------ menu semantic twins
def _dr_recursive_doubling(nranks: int):
    rounds = []
    for step in range(nranks.bit_length() - 1):
        d = 1 << step
        rounds.append(DataRound(step, tuple(
            DataSend(r, r ^ d, 0, 1, True) for r in range(nranks)), True))
    return rounds, 1


def _dr_oneshot(nranks: int):
    sends = tuple(DataSend(r, (r + k) % nranks, 0, 1, True)
                  for r in range(nranks) for k in range(1, nranks))
    return [DataRound(0, sends, True)], 1


def _dr_rabenseifner(nranks: int):
    term = Split.balanced(nranks)
    return term.data_rounds(nranks), term.n_atoms(nranks)


def _dr_ring(nranks: int):
    # reduce-scatter: at step t rank r forwards chunk (r - t) mod n, so
    # after n-1 steps rank r holds chunk (r + 1) mod n fully reduced;
    # all-gather: at step t rank r forwards chunk (r + 1 - t) mod n (the
    # one it completed/received most recently), replace semantics
    n = nranks
    rounds = []
    for t in range(n - 1):
        rounds.append(DataRound(t, tuple(
            DataSend(r, (r + 1) % n, (r - t) % n, (r - t) % n + 1, True)
            for r in range(n)), True, "reduce_scatter"))
    for t in range(n - 1):
        rounds.append(DataRound(n - 1 + t, tuple(
            DataSend(r, (r + 1) % n, (r + 1 - t) % n, (r + 1 - t) % n + 1,
                     False)
            for r in range(n)), True, "all_gather"))
    return rounds, n


def _dr_accel(nranks: int):
    # semantic twin of schedules.HierarchicalAccelAllreduce, including
    # the MPICH-style fold/unfold pre/post steps for non-power-of-two
    # QFDB counts
    q = 4
    if nranks % q or nranks < q:
        raise ValueError(f"accel needs a multiple of {q} ranks")
    n_g = nranks // q
    servers = [i * q for i in range(n_g)]
    rounds = [DataRound(0, tuple(
        DataSend(s + c, s, 0, 1, True)
        for s in servers for c in range(1, q)), False, "client_reduce")]
    step = 1
    pow2 = 1 << (n_g.bit_length() - 1)
    if pow2 < n_g:
        rounds.append(DataRound(step, tuple(
            DataSend(servers[i], servers[i - pow2], 0, 1, True)
            for i in range(pow2, n_g)), False, "server_fold"))
        step += 1
    d = 1
    while d < pow2:
        rounds.append(DataRound(step, tuple(
            DataSend(servers[i], servers[i ^ d], 0, 1, True)
            for i in range(pow2)), True, "server_exchange"))
        step, d = step + 1, d * 2
    if pow2 < n_g:
        rounds.append(DataRound(step, tuple(
            DataSend(servers[i - pow2], servers[i], 0, 1, False)
            for i in range(pow2, n_g)), False, "server_unfold"))
        step += 1
    rounds.append(DataRound(step, tuple(
        DataSend(s, s + c, 0, 1, False)
        for s in servers for c in range(1, q)), False, "client_broadcast"))
    return rounds, 1


#: allreduce candidate name -> nranks -> (data rounds, n_atoms); every
#: name the planner can emit must appear here or be a synth term
MENU_SEMANTICS = {
    "recursive_doubling": _dr_recursive_doubling,
    "oneshot": _dr_oneshot,
    "rabenseifner": _dr_rabenseifner,
    "ring": _dr_ring,
    "accel": _dr_accel,
}


def check_allreduce(name_or_schedule, nranks: int) -> None:
    """Semantic gate for anything the planner can emit: a menu algorithm
    name, an ``"synth:..."`` name (resolved through the registry), or a
    :class:`TermSchedule` instance."""
    obj = name_or_schedule
    if isinstance(obj, str) and obj.startswith("synth:"):
        from .search import registered
        sched = registered(obj)
        if sched is None:
            raise SemanticCheckError(f"unknown synthesized schedule {obj!r}")
        obj = sched
    if isinstance(obj, TermSchedule):
        check_term(obj.term, nranks)
        return
    if isinstance(obj, str):
        emitter = MENU_SEMANTICS.get(obj)
        if emitter is None:
            raise SemanticCheckError(
                f"no semantic model for menu algorithm {obj!r}")
        rounds, n_atoms = emitter(nranks)
        contribution_check(rounds, nranks, n_atoms,
                           label=f"{obj} @ {nranks} ranks")
        return
    raise SemanticCheckError(
        f"cannot semantically check {type(obj).__name__}")
