"""Composable round algebra for collective-schedule synthesis.

A schedule *term* is a small combinator tree —

* :class:`Split` — generalized-butterfly reduce-scatter + mirrored
  all-gather whose per-step split fractions ``sigma`` are *continuous*
  search parameters (``sigma = 1/2`` everywhere is exactly
  :class:`~repro_torch.core.exanet.schedules.RabenseifnerAllreduce`);
* :class:`Dissemination` — radix-``r`` dissemination rounds (every rank
  pushes its full accumulator to ``r - 1`` modular neighbours per round;
  exact when the scope is a power of the radix);
* :class:`Hierarchical` — group-leader staging over a machine axis
  (QFDB = 4 ranks, mezzanine = 16 at one rank per MPSoC): clients fold
  into their leader, an *outer* term runs among leaders, leaders
  broadcast back — the software analog of the §4.7 accelerator's
  client/server split, built from ordinary sends;
* :class:`Pipeline` — chunk the payload into ``c`` equal pieces and
  software-pipeline the inner term's rounds with unit stagger, so chunk
  ``i``'s round ``t`` shares a wire round with chunk ``i+1``'s round
  ``t-1``.

Terms lower to the same :class:`~repro_torch.core.exanet.schedules.Round`
stream every other schedule uses — the interpreter and the compiled
executor replay them unchanged — but through an *annotated* intermediate
form (:class:`DataRound`) that records which **atoms** (finest vector
intervals) each send carries and whether the receiver reduces or
replaces.  The annotations are what make synthesized schedules
checkable: :mod:`repro_torch.core.synth.verify` replays them through a
contribution-tracking semantic check (every rank must end holding every
rank's contribution exactly once) before a term is ever allowed near the
planner.

Continuous parameters form the term's **genome** (a flat tuple of the
``sigma`` fractions, in pre-order); the combinator tree plus its
discrete parameters (chunks, radix, group) is the **skeleton**.  The
round *structure* — send graph, exchange flags, round count — depends
only on the skeleton, never the genome, which is exactly the
compiled-executor contract: a whole population of same-skeleton terms
binds as batch columns of ONE lowered
:class:`~repro.core.exanet.exec_compiled.RoundProgram` replay
(:class:`SchedulePopulation`), replacing an earlier hack that reinterpreted
the ``nbytes`` argument as a candidate index.

The port's copy of the reference's ``repro.core.exanet.schedule_algebra``,
whole: the same names, layout and float arithmetic, with its imports
rewritten to ``repro_torch`` (``tests/test_torch_planner.py`` holds the two
equal).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Iterator, Sequence

import numpy as np

from .schedules import Round, _CopyInOut

#: clamp range for sigma genes — keeps every atom non-degenerate so the
#: round structure (>=1 byte per send) never collapses a send away
SIGMA_LO = 0.02
SIGMA_HI = 0.98

#: machine axes usable by :class:`Hierarchical` at one rank per MPSoC
AXIS_GROUPS = {"qfdb": 4, "mezzanine": 16}


@dataclasses.dataclass(frozen=True)
class DataSend:
    """One annotated send: atoms ``[a_lo, a_hi)`` travel src -> dst;
    ``reduce=True`` means the receiver adds them into its accumulator,
    ``False`` means it replaces its copy."""
    src: int
    dst: int
    a_lo: int
    a_hi: int
    reduce: bool


@dataclasses.dataclass(frozen=True)
class DataRound:
    """One round of annotated sends (the semantic twin of :class:`Round`)."""
    step: int
    sends: tuple[DataSend, ...]
    exchange: bool
    label: str = ""


class Term:
    """Base combinator.  A term is immutable; ``with_genome`` returns a
    re-parameterized copy with the same skeleton."""

    kind = "term"

    def validate(self, nranks: int) -> None:
        """Raise ValueError if the term cannot run over ``nranks`` ranks."""
        raise NotImplementedError

    def n_atoms(self, nranks: int) -> int:
        raise NotImplementedError

    def atom_widths(self, nranks: int) -> np.ndarray:
        """Fractional widths of this term's atoms (sum to 1.0)."""
        raise NotImplementedError

    def lower(self, ranks: Sequence[int], a0: int, step0: int
              ) -> list[DataRound]:
        """Annotated rounds over the given scope ranks, with this scope's
        atoms starting at global atom index ``a0``."""
        raise NotImplementedError

    def genome(self) -> tuple[float, ...]:
        return ()

    def with_genome(self, genome: Sequence[float]) -> "Term":
        term, rest = self._consume(tuple(float(g) for g in genome))
        if rest:
            raise ValueError(f"genome has {len(rest)} unused genes")
        return term

    def _consume(self, genome: tuple[float, ...]):
        return self, genome

    def structure_key(self) -> tuple:
        """Genome-free skeleton key (same key == batchable together)."""
        raise NotImplementedError

    def spec(self):
        """JSON-serializable description including the genome."""
        raise NotImplementedError

    def data_rounds(self, nranks: int) -> list[DataRound]:
        self.validate(nranks)
        return self.lower(range(nranks), 0, 0)


@dataclasses.dataclass(frozen=True)
class Split(Term):
    """sigma-split butterfly: ``len(sigmas)`` recursive-halving
    reduce-scatter steps (the lower rank of each XOR pair keeps the
    ``1 - sigma`` lower interval, the upper rank the ``sigma`` upper
    interval) followed by the mirrored recursive-doubling all-gather.
    Scope must be exactly ``2 ** len(sigmas)`` ranks."""

    sigmas: tuple[float, ...]

    kind = "split"

    @classmethod
    def balanced(cls, nranks: int) -> "Split":
        k = nranks.bit_length() - 1
        if nranks != 1 << k or k < 1:
            raise ValueError(f"Split needs power-of-two ranks, got {nranks}")
        return cls((0.5,) * k)

    def validate(self, nranks: int) -> None:
        k = len(self.sigmas)
        if k < 1 or nranks != 1 << k:
            raise ValueError(
                f"Split({k} steps) needs exactly {1 << k} ranks, "
                f"got {nranks}")
        for s in self.sigmas:
            if not (0.0 < s < 1.0):
                raise ValueError(f"sigma out of (0, 1): {s}")

    def n_atoms(self, nranks: int) -> int:
        return 1 << len(self.sigmas)

    def atom_widths(self, nranks: int) -> np.ndarray:
        k = len(self.sigmas)
        w = np.ones(1)
        for s in self.sigmas:
            w = np.concatenate([w * (1.0 - s), w * s]) \
                if len(w) == 1 else np.stack(
                    [w * (1.0 - s), w * s], axis=1).reshape(-1)
        # the loop above interleaves: each existing interval splits in
        # place into (lower, upper), preserving position order
        assert len(w) == 1 << k
        return w

    def lower(self, ranks, a0, step0):
        ranks = list(ranks)
        p = len(ranks)
        k = len(self.sigmas)
        rounds = []
        # reduce-scatter: step i pairs ranks at XOR distance 2^(k-1-i);
        # partners share their first-i split path, so they hold the same
        # working interval and trade its two sigma-halves
        for i in range(k):
            hb = k - 1 - i          # bit index of this step's distance
            d = 1 << hb
            sends = []
            for j in range(p):
                jp = j ^ d
                prefix = j >> (hb + 1)
                lo = prefix << (hb + 1)
                mid = lo + d
                hi = lo + (d << 1)
                # j sends the sub-half its partner keeps (partner's bit)
                if jp & d:
                    s_lo, s_hi = mid, hi
                else:
                    s_lo, s_hi = lo, mid
                sends.append(DataSend(ranks[j], ranks[jp],
                                      a0 + s_lo, a0 + s_hi, True))
            rounds.append(DataRound(step0 + i, tuple(sends), True,
                                    "reduce_scatter"))
        # all-gather mirror: owned block doubles at distances 1, 2, ...
        for t in range(k):
            d = 1 << t
            sends = []
            for j in range(p):
                lo = (j >> t) << t
                sends.append(DataSend(ranks[j], ranks[j ^ d],
                                      a0 + lo, a0 + lo + d, False))
            rounds.append(DataRound(step0 + k + t, tuple(sends), True,
                                    "all_gather"))
        return rounds

    def genome(self):
        return self.sigmas

    def _consume(self, genome):
        k = len(self.sigmas)
        if len(genome) < k:
            raise ValueError("genome too short for Split")
        return Split(genome[:k]), genome[k:]

    def structure_key(self):
        return ("split", len(self.sigmas))

    def spec(self):
        return ["split", [round(s, 12) for s in self.sigmas]]


@dataclasses.dataclass(frozen=True)
class Dissemination(Term):
    """Radix-r dissemination allreduce: round ``k`` has every rank push
    its full accumulator to ranks ``(j + c * r**k) mod P`` for
    ``c = 1 .. r-1``; exactly-once when ``P == r**m`` (base-r digit
    uniqueness).  No continuous genes — a pure skeleton point."""

    radix: int

    kind = "dissem"

    def _steps(self, nranks: int) -> int:
        r, m, p = self.radix, 0, 1
        while p < nranks:
            p *= r
            m += 1
        if p != nranks:
            raise ValueError(
                f"Dissemination(radix={r}) needs a power of {r} ranks, "
                f"got {nranks}")
        return m

    def validate(self, nranks: int) -> None:
        if self.radix < 2:
            raise ValueError(f"radix must be >= 2, got {self.radix}")
        if nranks < 2:
            raise ValueError("need at least 2 ranks")
        self._steps(nranks)

    def n_atoms(self, nranks: int) -> int:
        return 1

    def atom_widths(self, nranks: int) -> np.ndarray:
        return np.ones(1)

    def lower(self, ranks, a0, step0):
        ranks = list(ranks)
        p = len(ranks)
        m = self._steps(p)
        rounds = []
        for k in range(m):
            d = self.radix ** k
            sends = tuple(
                DataSend(ranks[j], ranks[(j + c * d) % p], a0, a0 + 1, True)
                for j in range(p) for c in range(1, self.radix))
            rounds.append(DataRound(step0 + k, sends, True, "dissemination"))
        return rounds

    def structure_key(self):
        return ("dissem", self.radix)

    def spec(self):
        return ["dissem", self.radix]


@dataclasses.dataclass(frozen=True)
class Hierarchical(Term):
    """Group-leader staging over a machine axis: the ``group`` ranks of
    each group fold into their leader (rank ``g * group``), the outer
    term allreduces among leaders, leaders broadcast the result back.
    The software analog of the §4.7 accelerator's client/server split —
    but made of ordinary sends, so the search is never told about the
    NI-resident hardware."""

    group: int
    outer: Term

    kind = "hier"

    @classmethod
    def over_axis(cls, axis: str, outer: Term) -> "Hierarchical":
        return cls(AXIS_GROUPS[axis], outer)

    def validate(self, nranks: int) -> None:
        if self.group < 2:
            raise ValueError(f"group must be >= 2, got {self.group}")
        if nranks % self.group or nranks // self.group < 2:
            raise ValueError(
                f"Hierarchical(group={self.group}) needs nranks a "
                f"multiple of {self.group} with >= 2 groups, got {nranks}")
        self.outer.validate(nranks // self.group)

    def n_atoms(self, nranks: int) -> int:
        return self.outer.n_atoms(nranks // self.group)

    def atom_widths(self, nranks: int) -> np.ndarray:
        return self.outer.atom_widths(nranks // self.group)

    def lower(self, ranks, a0, step0):
        ranks = list(ranks)
        p = len(ranks)
        q = self.group
        na = self.n_atoms(p)
        leaders = [ranks[g * q] for g in range(p // q)]
        up = tuple(DataSend(ranks[g * q + c], ranks[g * q], a0, a0 + na, True)
                   for g in range(p // q) for c in range(1, q))
        rounds = [DataRound(step0, up, False, "hier_up")]
        inner = self.outer.lower(leaders, a0, step0 + 1)
        rounds.extend(inner)
        step = step0 + 1 + len(inner)
        down = tuple(
            DataSend(ranks[g * q], ranks[g * q + c], a0, a0 + na, False)
            for g in range(p // q) for c in range(1, q))
        rounds.append(DataRound(step, down, False, "hier_down"))
        return rounds

    def genome(self):
        return self.outer.genome()

    def _consume(self, genome):
        outer, rest = self.outer._consume(genome)
        return Hierarchical(self.group, outer), rest

    def structure_key(self):
        return ("hier", self.group, self.outer.structure_key())

    def spec(self):
        return ["hier", self.group, self.outer.spec()]


@dataclasses.dataclass(frozen=True)
class Pipeline(Term):
    """Software pipelining: the payload splits into ``chunks`` equal
    pieces, each running the inner term's round stream offset by its
    chunk index, so successive chunks overlap on the wire (round count
    grows by ``chunks - 1`` while per-round bytes shrink by ``chunks``).
    The inner term must lower to exchange-only rounds (merged rounds
    share one exchange flag)."""

    chunks: int
    inner: Term

    kind = "pipe"

    def validate(self, nranks: int) -> None:
        if self.chunks < 2:
            raise ValueError(f"chunks must be >= 2, got {self.chunks}")
        self.inner.validate(nranks)
        for rnd in self.inner.lower(range(nranks), 0, 0):
            if not rnd.exchange:
                raise ValueError(
                    "Pipeline inner term must lower to exchange-only "
                    f"rounds, got relay round {rnd.label!r}")

    def n_atoms(self, nranks: int) -> int:
        return self.chunks * self.inner.n_atoms(nranks)

    def atom_widths(self, nranks: int) -> np.ndarray:
        w = self.inner.atom_widths(nranks) / self.chunks
        return np.tile(w, self.chunks)

    def lower(self, ranks, a0, step0):
        na = self.inner.n_atoms(len(ranks))
        merged: dict[int, list[DataSend]] = {}
        for c in range(self.chunks):
            for rnd in self.inner.lower(ranks, a0 + c * na, c):
                merged.setdefault(rnd.step, []).extend(rnd.sends)
        return [DataRound(step0 + s, tuple(merged[s]), True, "pipeline")
                for s in sorted(merged)]

    def genome(self):
        return self.inner.genome()

    def _consume(self, genome):
        inner, rest = self.inner._consume(genome)
        return Pipeline(self.chunks, inner), rest

    def structure_key(self):
        return ("pipe", self.chunks, self.inner.structure_key())

    def spec(self):
        return ["pipe", self.chunks, self.inner.spec()]


def term_from_spec(spec) -> Term:
    """Inverse of :meth:`Term.spec` (the winner-cache wire format)."""
    kind = spec[0]
    if kind == "split":
        return Split(tuple(float(s) for s in spec[1]))
    if kind == "dissem":
        return Dissemination(int(spec[1]))
    if kind == "hier":
        return Hierarchical(int(spec[1]), term_from_spec(spec[2]))
    if kind == "pipe":
        return Pipeline(int(spec[1]), term_from_spec(spec[2]))
    raise ValueError(f"unknown term kind {kind!r}")


def _spec_json(term: Term) -> str:
    return json.dumps(term.spec(), separators=(",", ":"))


def term_digest(term: Term) -> str:
    return hashlib.sha1(_spec_json(term).encode()).hexdigest()[:10]


class TermSchedule(_CopyInOut):
    """Adapter lowering an algebra term to the ordinary
    :class:`~repro_torch.core.exanet.schedules.CollectiveSchedule` protocol.

    Byte counts are floor-scaled atom fractions (``max(1,
    int(frac * nbytes))``) so the balanced Split reproduces
    ``RabenseifnerAllreduce``'s ``nbytes * d // nranks`` arithmetic
    bit-for-bit; each round's ``reduce_bytes`` is the largest payload any
    receiver reduces (one reduction charge per round, as everywhere
    else).  ``one_way`` stays False: relay phases inside Hierarchical
    terms are costed with the conservative ping-pong transport rather
    than the accelerator's one-way model.
    """

    one_way = False

    def __init__(self, term: Term):
        self.term = term
        self.name = f"synth:{term_digest(term)}"
        self._spec = _spec_json(term)
        self._cache: dict[int, tuple] = {}

    def _lowered(self, nranks: int):
        hit = self._cache.get(nranks)
        if hit is None:
            self.term.validate(nranks)
            widths = self.term.atom_widths(nranks)
            cw = np.concatenate([[0.0], np.cumsum(widths)])
            hit = (self.term.data_rounds(nranks), cw)
            self._cache[nranks] = hit
        return hit

    def rounds(self, nranks: int, nbytes: int) -> Iterator[Round]:
        data_rounds, cw = self._lowered(nranks)
        for dr in data_rounds:
            nb = [max(1, int((cw[s.a_hi] - cw[s.a_lo]) * nbytes))
                  for s in dr.sends]
            red = max((b for s, b in zip(dr.sends, nb) if s.reduce),
                      default=0)
            yield Round(dr.step,
                        tuple((s.src, s.dst, b)
                              for s, b in zip(dr.sends, nb)),
                        exchange=dr.exchange, reduce_bytes=red,
                        label=dr.label)

    def program_key(self):
        # genome-bearing: two same-skeleton terms with different sigmas
        # bind different byte grids, so they must not share a lowered
        # program's size cache
        return ("synth", self._spec)

    def structure_key(self):
        return ("synth-skel", self.term.structure_key())

    def __repr__(self):
        return f"TermSchedule({self._spec})"


class SchedulePopulation:
    """First-class population binding on the schedule/compile seam.

    Wraps N same-skeleton schedules at one payload size as a single
    schedule-protocol object whose *size token* is the member index: the
    compiled executor's ``bind(sched, sizes)`` treats sizes as opaque
    tokens passed back to ``rounds``, so binding ``range(len(pop))``
    makes each member one batch column of ONE
    :class:`~repro.core.exanet.exec_compiled.RoundProgram` replay.  This
    replaces the earlier ``ButterflyPopulation`` hack (which overloaded the
    ``nbytes`` argument of an ordinary schedule) with an explicit type.

    ``program_key`` is skeleton-only, so the lowered program is reused
    across search generations; callers must therefore bind with
    ``cache=False`` (``ExanetMPI.run_schedule_population`` does) because
    member payloads change under the same token between generations.
    """

    one_way = False

    def __init__(self, members: Sequence, nbytes: int):
        members = tuple(members)
        if not members:
            raise ValueError("population needs at least one member")
        keys = {self._member_key(m) for m in members}
        if len(keys) != 1:
            raise ValueError(
                f"population members must share one skeleton, got {keys}")
        self.members = members
        self.nbytes = int(nbytes)
        self.name = f"population[{members[0].name} x{len(members)}]"
        self.one_way = bool(getattr(members[0], "one_way", False))

    @staticmethod
    def _member_key(m):
        sk = getattr(m, "structure_key", None)
        return sk() if sk is not None else (type(m).__name__,)

    def __len__(self) -> int:
        return len(self.members)

    def tokens(self) -> range:
        """The size tokens to bind: one batch column per member."""
        return range(len(self.members))

    def _member(self, token) -> object:
        # modulo so the compiled executor's structure probe (an arbitrary
        # token) lands on a member; all members share the probe structure
        return self.members[int(token) % len(self.members)]

    def rounds(self, nranks: int, token) -> Iterator[Round]:
        return self._member(token).rounds(nranks, self.nbytes)

    def pre_copy_bytes(self, token) -> int:
        return self._member(token).pre_copy_bytes(self.nbytes)

    def post_copy_bytes(self, token) -> int:
        return self._member(token).post_copy_bytes(self.nbytes)

    def program_key(self):
        return ("population", self._member_key(self.members[0]))
