"""Simulated LM serving as a first-class Program-IR workload (ROADMAP
item 1): continuous-batching decode/prefill steps emitted as per-rank
``Compute`` + embedded KV/activation ``Collective``\\ s, costed by the
closed-form roofline estimator
(:func:`repro_torch.roofline.analysis.lm_serve_step_cost`) and executed on the
ExaNeSt event engine — congestion, skewed collective entries and
per-rank arrival jitter are simulated, not modeled.

The fast path is the whole point (DESIGN.md §2.7): a continuous-batching
server only ever occupies finitely many *step states* — (decoding slots,
prefilling slots, KV-occupancy bucket) — so an entire load sweep needs
just one :meth:`~repro_torch.core.exanet.mpi.ExanetMPI.run_program_scenarios`
call: every (state x Monte-Carlo-draw) binds as one column of the
compiled artifact (per-column compute skew, per-column collective
payloads via the ``site_scale`` seam, per-rank arrival skew via the
``t0`` axis), and the open-loop traffic replay
(:mod:`repro_torch.serve.traffic`) then walks millions of simulated steps as
table lookups.  The per-step lane — rebind + ``run_program`` per
simulated step — is the baseline the speedup row in ``BENCH_serve.json``
measures against.

Step model
----------
One step advances every decoding slot by one token and pushes one
``prefill_chunk``-sized chunk through every prefilling slot (chunked
prefill: a P-token prompt occupies its slot for ``ceil(P/chunk)`` steps,
its final chunk emitting the first output token).  Per rank (tensor
parallelism over all ``nranks``) the step is::

    Compute(roofline max of flops/rate and bytes/bw, jittered)
    Collective(allgather,  act_bytes / nranks)   # per-token activations
    Collective(alltoall | allgather, kv_bytes / nranks)  # KV-shard moves

The KV-shard exchange is a pairwise ``alltoall`` up to
``alltoall_max_ranks`` and an ``allgather`` beyond it: the XOR-pairwise
schedule is O(nranks) exchange rounds, which a real system would never
run over thousands of ranks for a few migrated shards — and which would
also dominate the compiled replay itself.  Both ops resolve to a single
schedule regardless of payload, so per-column ``site_scale`` bindings
can never flip the probe tape (the hazard ``algo="auto"`` sites have).

The port's copy of the reference's ``repro.serve.sim``, whole: the same
names, layout and float arithmetic, with its imports rewritten to
``repro_torch``. ``tests/test_torch_serve_sim.py`` holds the two equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.program import Collective, Compute, Program


@dataclasses.dataclass(frozen=True)
class ServeSimSpec:
    """One simulated serving deployment: model config x machine shard."""
    arch: str = "exanest-lm-100m"
    nranks: int = 512
    slots: int = 8                 #: continuous-batching slots per replica
    window: int = 1024             #: KV capacity per slot (tokens)
    prefill_chunk: int = 256       #: prompt tokens per prefill step
    dtype_bytes: int = 2
    #: per-rank A53-class compute roofline: NEON peak (~8 flop/cycle at
    #: 1.5 GHz) and the per-core DDR copy bandwidth of params.HwParams
    core_rate_flops_per_us: float = 12000.0
    mem_bw_bytes_per_us: float = 2000.0
    #: fixed per-step dispatch overhead (kernel launches, batching glue)
    step_overhead_us: float = 25.0
    #: KV-occupancy buckets the step table quantizes decode context into
    kv_buckets: int = 4
    #: per-rank request-dispatch jitter, uniform [0, skew) us (t0 axis)
    arrival_skew_us: float = 2.0
    #: multiplicative per-rank compute noise, uniform 1 +/- jitter
    compute_jitter: float = 0.02
    #: pairwise alltoall is O(nranks) rounds; beyond this the KV-shard
    #: exchange emits as a recursive-doubling allgather instead
    alltoall_max_ranks: int = 128

    def kv_centers(self) -> np.ndarray:
        """Bucket-center KV occupancies (tokens) for the step table."""
        k = max(1, int(self.kv_buckets))
        return (np.arange(k) + 0.5) * (self.window / k)

    def kv_bucket(self, kv_mean: float) -> int:
        k = max(1, int(self.kv_buckets))
        return min(k - 1, max(0, int(kv_mean / self.window * k)))


@dataclasses.dataclass
class StepTable:
    """Batched step-latency table: one row per step state, one column
    per Monte-Carlo draw — the product of ONE ``run_program_scenarios``
    call.  ``cols`` maps a (state, draw) back to its scenario column so
    the per-step lane can rebind the *identical* payload."""
    states: list          #: [(n_decode, n_prefill, kv_bucket), ...]
    mc: int
    us: np.ndarray        #: (n_states, mc) simulated step latency
    index: dict           #: state -> row
    compute_scale: np.ndarray   #: (nranks, N) column compute skew
    site_scale: np.ndarray      #: (n_sites, N) column payload scale
    t0: np.ndarray              #: (nranks, N) column entry clocks

    def col(self, state, j: int) -> int:
        return self.index[state] * self.mc + int(j)

    def lookup(self, nd: int, npf: int, kvb: int, step: int) -> float:
        """Step latency for a replay step: deterministic draw rotation."""
        return float(self.us[self.index[(nd, npf, kvb)], step % self.mc])


class ServeSim:
    """Emit + cost serving-step Programs for one :class:`ServeSimSpec`.

    The simulation instance (base prototype or scaled-torus twin) is
    resolved per rank count through the same
    :meth:`~repro_torch.core.machine.ExanetMachine._mpi_for` tier cache the
    planner and app sweeps use.
    """

    def __init__(self, spec: ServeSimSpec, mpi=None):
        from repro_torch.configs import get
        self.spec = spec
        self.cfg = get(spec.arch)
        if mpi is None:
            from repro_torch.core.exanet.mpi import ExanetMPI
            from repro_torch.core.exanet.params import DEFAULT
            from repro_torch.core.machine import ExanetMachine
            mpi = ExanetMachine(mpi=ExanetMPI(DEFAULT))._mpi_for(spec.nranks)
        self.mpi = mpi
        if spec.nranks & (spec.nranks - 1):
            raise ValueError(
                f"nranks must be a power of two for the allgather/"
                f"alltoall schedules; got {spec.nranks}")
        self._base_state = (max(1, spec.slots), 1,
                            spec.kv_buckets // 2)
        self._base_prog = None

    # ------------------------------------------------------------- costing
    def step_cost(self, nd: float, npf: float, kv_mean: float) -> dict:
        """Whole-model cost of one (nd decode, npf prefill-chunk) step."""
        from repro_torch.roofline.analysis import lm_serve_step_cost
        sp = self.spec
        return lm_serve_step_cost(
            self.cfg, n_decode=nd, decode_kv=kv_mean,
            n_prefill=npf * sp.prefill_chunk,
            prefill_kv=0.0, dtype_bytes=sp.dtype_bytes)

    def rank_compute_us(self, nd: float, npf: float,
                        kv_mean: float) -> float:
        """Per-rank roofline step compute: the tensor-parallel shard of
        the whole-model flops/bytes, whichever roof binds, plus the
        fixed dispatch overhead."""
        sp = self.spec
        c = self.step_cost(nd, npf, kv_mean)
        return sp.step_overhead_us + max(
            c["flops"] / sp.nranks / sp.core_rate_flops_per_us,
            c["hbm_bytes"] / sp.nranks / sp.mem_bw_bytes_per_us)

    def site_bytes(self, nd: float, npf: float, kv_mean: float) -> tuple:
        """(act allgather, kv exchange) per-rank payloads in bytes."""
        c = self.step_cost(nd, npf, kv_mean)
        n = self.spec.nranks
        return (max(1, int(round(c["act_bytes"] / n))),
                max(1, int(round(c["kv_bytes"] / n))) if npf > 0 else 1)

    # ------------------------------------------------------------ emission
    def kv_exchange_op(self) -> tuple:
        """(op, algo) of the KV-shard exchange collective."""
        if self.spec.nranks <= self.spec.alltoall_max_ranks:
            return "alltoall", "pairwise"
        return "allgather", "recursive_doubling"

    def emit_step(self, nd: int, npf: int, kv_mean: float) -> Program:
        """One serving step as a Program: every rank computes its shard
        then enters the activation allgather and the KV-shard exchange.
        Structure is state-independent — only payloads move — so every
        step of every load point binds as a column of ONE artifact."""
        sp = self.spec
        us = self.rank_compute_us(nd, npf, kv_mean)
        act_b, kv_b = self.site_bytes(nd, npf, kv_mean)
        kv_op, kv_algo = self.kv_exchange_op()
        ops = (Compute(us=us),
               Collective(op="allgather", nbytes=act_b,
                          algo="recursive_doubling"),
               Collective(op=kv_op, nbytes=kv_b, algo=kv_algo))
        return Program(tuple(ops for _ in range(sp.nranks)))

    def base_program(self) -> Program:
        """The base binding every scenario column perturbs (all payloads
        strictly positive, so per-column multiplicative scales are
        well-defined)."""
        if self._base_prog is None:
            nd, npf, kvb = self._base_state
            kv = float(self.spec.kv_centers()[kvb])
            self._base_prog = self.emit_step(nd, npf, kv)
        return self._base_prog

    # --------------------------------------------------------- step states
    def step_states(self) -> list:
        """Every (n_decode, n_prefill, kv_bucket) a replay can occupy:
        occupancy up to ``slots``, KV bucketed only where decode reads
        it (pure-prefill states pin bucket 0)."""
        sp = self.spec
        out = []
        for nd in range(sp.slots + 1):
            for npf in range(sp.slots + 1 - nd):
                if nd == 0 and npf == 0:
                    continue
                for kvb in (range(sp.kv_buckets) if nd else (0,)):
                    out.append((nd, npf, kvb))
        return out

    # ------------------------------------------------------------ the table
    def build_table(self, *, mc: int = 3, rng=None, engine=None,
                    check: int = 0, rtol: float = 1e-9) -> StepTable:
        """Cost every step state x Monte-Carlo draw in ONE batched
        scenario replay.  ``check`` forwards to
        :meth:`~repro_torch.core.exanet.mpi.ExanetMPI.run_program_scenarios`
        (sampled columns re-run on the interpreter, <=1e-9 agreement or
        raise)."""
        sp = self.spec
        rng = np.random.default_rng(rng)
        states = self.step_states()
        centers = sp.kv_centers()
        base = self.base_program()
        base_us = self.rank_compute_us(
            self._base_state[0], self._base_state[1],
            float(centers[self._base_state[2]]))
        base_sites = np.array(self.site_bytes(
            self._base_state[0], self._base_state[1],
            float(centers[self._base_state[2]])), dtype=np.float64)
        n_states = len(states)
        N = n_states * mc
        cs = np.empty((sp.nranks, N))
        ss = np.empty((2, N))
        for i, (nd, npf, kvb) in enumerate(states):
            kv = float(centers[kvb])
            cols = slice(i * mc, (i + 1) * mc)
            cs[:, cols] = self.rank_compute_us(nd, npf, kv) / base_us
            a, k = self.site_bytes(nd, npf, kv)
            ss[0, cols] = a / base_sites[0]
            ss[1, cols] = k / base_sites[1]
        if sp.compute_jitter > 0:
            cs *= rng.uniform(1.0 - sp.compute_jitter,
                              1.0 + sp.compute_jitter, cs.shape)
        t0 = rng.uniform(0.0, max(sp.arrival_skew_us, 1e-30),
                         (sp.nranks, N))
        res = self.mpi.run_program_scenarios(
            base, compute_scale=cs, site_scale=ss, t0=t0,
            engine=engine, check=check, rtol=rtol)
        us = np.array([r.latency_us for r in res]).reshape(n_states, mc)
        return StepTable(states=states, mc=mc, us=us,
                         index={s: i for i, s in enumerate(states)},
                         compute_scale=cs, site_scale=ss, t0=t0)

    # ------------------------------------------------------ per-step lane
    def step_time_single(self, table: StepTable, state, j: int, *,
                         backend: str = "auto", engine=None) -> float:
        """The naive lane: rebind the column's exact payload as a fresh
        Program and run it alone — what a per-step simulator pays for
        every simulated step.  Bit-identical inputs to the batched
        column, so lane agreement is pure executor agreement."""
        from repro_torch.core.exanet.program_compiled import (
            extract_data, rebind_program)
        b = table.col(state, j)
        base = self.base_program()
        data = extract_data(base)
        comp = np.array(data[0]) * table.compute_scale[:, b]
        site = np.rint(np.array(data[2], dtype=np.float64)
                       * table.site_scale[:, b]).astype(np.int64)
        prog = rebind_program(base, compute_us=comp, site_nbytes=site)
        return self.mpi.run_program(prog, backend=backend, engine=engine,
                                    t0=table.t0[:, b]).latency_us
