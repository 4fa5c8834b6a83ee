"""The port's compiled executors and scan lanes against the reference's.

``repro_torch.core.exanet`` keeps copies of the reference's compiled
executors (``exec_compiled``: schedules as round programs;
``program_compiled``: whole Program-IR programs as level programs) and of
its scan-engine seam, whose jax lane the port replaces with a torch lane
(``TorchScanEngine``: the same Hillis-Steele passes in float64 torch ops).
Here, on the CPU:

* the torch lane's two scans equal the numpy lane's bit for bit on seeded
  inputs of every batch layout, and its masks stay on the device;
* the engine-parametrised tests of ``tests/test_batch_engine.py``,
  ``tests/test_exec_compiled.py`` and ``tests/test_program_compiled.py``
  run on the port's copies with ``engine="numpy"`` and
  ``TorchScanEngine(device="cpu")``: compiled equals interpreted to 1e-9
  relative, as there, and each result equals the reference's (exactly
  where both run the same float operations);
* ``get_scan_engine("torch")`` raises without a CUDA device, and a failing
  torch lane raises rather than handing its scans to numpy;
* the port's repair of the reference's ``_lower_coll`` (ROADMAP.md R7): a
  program whose collective resolves to a synthesized schedule compiles and
  equals the interpreter, where the reference raises ``KeyError``.

The on-card twin of the lane test is in ``tests/test_torch_kernels_cuda.py``.
Every random draw comes from a fixed seed.
"""

from __future__ import annotations

import dataclasses
import random
import sys

import numpy as np
import pytest
import torch

from repro.core import program as jprogram
from repro.core.exanet import schedules as jschedules
from repro.core.exanet import sim as jsim
from repro.core.exanet.mpi import ExanetMPI as JExanetMPI
from repro_torch.core import program as tprogram
from repro_torch.core.exanet import scan_engine as se
from repro_torch.core.exanet import schedules as tschedules
from repro_torch.core.exanet import sim as tsim
from repro_torch.core.exanet.exec_compiled import ProgramStructureError
from repro_torch.core.exanet.mpi import ExanetMPI
from repro_torch.core.exanet.params import DEFAULT, scaled_params
from repro_torch.core.exanet.program_compiled import (extract_data,
                                                      rebind_program)
from test_program_compiled import BYTES, _fuzz_program

#: the CPU instance of the torch lane the tests pass as an engine object
TORCH_CPU = se.TorchScanEngine(device="cpu")
ENGINES = {"numpy": "numpy", "torch": TORCH_CPU}
RTOL = 1e-9


@pytest.fixture(params=sorted(ENGINES))
def engine(request):
    return ENGINES[request.param]


def to_port(prog):
    """The reference's Program rebuilt op for op from the port's IR."""
    return tprogram.Program(tuple(
        tuple(getattr(tprogram, type(op).__name__)(**dataclasses.asdict(op))
              for op in ops) for ops in prog.rank_ops))


def _assert_prog_equal(a, b, tag, rel=RTOL):
    assert b.latency_us == pytest.approx(a.latency_us, rel=rel), tag
    assert a.n_sends == b.n_sends, tag
    assert a.n_collectives == b.n_collectives, tag
    for x, y in zip(a.clocks, b.clocks):
        assert y == pytest.approx(x, rel=rel, abs=1e-12), tag
    for x, y in zip(a.compute_us, b.compute_us):
        assert y == pytest.approx(x, rel=rel, abs=1e-12), tag


def _same_prog(a, b, tag):
    """Equal field for field: the two packages ran the same arithmetic."""
    assert (a.latency_us, tuple(a.clocks), tuple(a.compute_us), a.n_sends,
            a.n_collectives) == (b.latency_us, tuple(b.clocks),
                                 tuple(b.compute_us), b.n_sends,
                                 b.n_collectives), tag


def _assert_sched_equal(a, b, tag, rel=RTOL):
    assert b.latency_us == pytest.approx(a.latency_us, rel=rel), tag
    assert [tuple(h) for h in a.round_heads] == \
        [tuple(h) for h in b.round_heads], tag
    for x, y in zip(a.clocks, b.clocks):
        assert y == pytest.approx(x, rel=rel, abs=1e-12), tag


@pytest.fixture(scope="module", params=[None, 1], ids=["rpm4", "rpm1"])
def mpis(request):
    return (ExanetMPI(ranks_per_mpsoc=request.param),
            JExanetMPI(ranks_per_mpsoc=request.param))


# ------------------------------------------------------------ the scan lane
def _scan_case(seed, k, batch, p_first=0.3, p_inactive=0.2):
    rng = np.random.default_rng(seed)
    first = rng.random(k) < p_first
    first[0] = True
    starts = np.flatnonzero(np.r_[first, True])
    max_group = int(np.diff(starts).max())
    D = rng.uniform(0.0, 5.0, (k, *batch))
    T = rng.uniform(0.0, 50.0, (k, *batch)) + D
    inactive = rng.random((k, *batch)) < p_inactive
    D[inactive], T[inactive] = 0.0, -np.inf
    return first, max_group, D, T


@pytest.mark.parametrize("batch", [(1,), (23,), (6, 23), (2, 3, 4)])
@pytest.mark.parametrize("seed", range(3))
def test_torch_lane_scans_equal_numpy_lane_bit_for_bit(seed, batch):
    k = 97 + 31 * seed
    first, max_group, D, T = _scan_case(seed, k, batch)
    takes = tsim.scan_take_masks(first, max_group)
    assert _plain_takes(takes) == _plain_takes(
        jsim.scan_take_masks(first, max_group))
    Dn, Tn = se.NUMPY.maxplus_scan(D.copy(), T.copy(), takes)
    Dt, Tt = TORCH_CPU.maxplus_scan(D.copy(), T.copy(), takes)
    Dr, Tr = jsim.segmented_maxplus_scan(D, T, first, max_group)
    for got in (Dt, Dn):
        assert got.shape == D.shape and got.dtype == np.float64
        np.testing.assert_array_equal(got, Dr)
    for got in (Tt, Tn):
        np.testing.assert_array_equal(got, Tr)
    # D broadcast over the batch (one duration per acquire)
    Dc = D[(slice(None),) + (slice(0, 1),) * len(batch)]
    want = jsim.segmented_maxplus_scan(np.broadcast_to(Dc, D.shape), T,
                                       first, max_group)
    got = TORCH_CPU.maxplus_scan(Dc, T.copy(), takes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    v = T - D
    want = jsim.segmented_running_max(v.copy(), takes)
    np.testing.assert_array_equal(TORCH_CPU.running_max(v.copy(), takes),
                                  want)
    np.testing.assert_array_equal(se.NUMPY.running_max(v.copy(), takes),
                                  want)


def _plain_takes(takes):
    return [(s, m.tolist()) for s, m in takes]


def test_torch_lane_keeps_masks_on_its_device_per_takes_list():
    eng = se.TorchScanEngine(device="cpu")
    first, max_group, D, T = _scan_case(7, 64, (5,))
    takes = tsim.scan_take_masks(first, max_group)
    shifts, masks = eng._prep(takes)
    assert shifts == tuple(s for s, _ in takes)
    assert all(isinstance(m, torch.Tensor) and m.dtype == torch.bool
               and m.device == eng.device for m in masks)
    assert eng._prep(takes)[1] is masks          # uploaded once
    twin = [(s, m.copy()) for s, m in takes]     # equal, not the same list
    assert eng._prep(twin)[1] is not masks
    eng.maxplus_scan(D, T, takes)
    eng.running_max(T - D, takes)
    assert eng.calls == {"maxplus_scan": 1, "running_max": 1}
    # inputs are not written through the CPU tensors' shared buffers
    D0, T0 = D.copy(), T.copy()
    eng.maxplus_scan(D, T, takes)
    np.testing.assert_array_equal(D, D0)
    np.testing.assert_array_equal(T, T0)


# ----------------------------------------------------- engine resolution
def test_engine_names_and_resolution():
    with pytest.raises(ValueError, match=r"unknown scan engine 'jax'"):
        se.get_scan_engine("jax")
    with pytest.raises(ValueError, match=r"\['numpy', 'torch'\]"):
        se.get_scan_engine("cupy")
    assert se.resolve_engine(None) is se.NUMPY
    assert se.resolve_engine("numpy") is se.NUMPY
    assert se.resolve_engine(se.NUMPY) is se.NUMPY
    assert se.resolve_engine(TORCH_CPU) is TORCH_CPU
    with pytest.raises(ValueError, match="not a scan engine"):
        se.resolve_engine(3)


def test_torch_lane_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delitem(se._engines, "torch", raising=False)
    assert se.available_engines() == ["numpy"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        se.get_scan_engine("torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        se.TorchScanEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExanetMPI().run_schedule_many(
            tschedules.RecursiveDoublingAllreduce(), (4096,), 8,
            engine="torch")
    assert "torch" not in se._engines
    # the numpy default never touches torch
    monkeypatch.setitem(sys.modules, "torch", None)
    assert se.available_engines() == ["numpy"]
    r = ExanetMPI().run_schedule_many(
        tschedules.RecursiveDoublingAllreduce(), (4096,), 8, engine="numpy")
    assert r.latency_us.shape == (1,)


def test_a_failing_torch_lane_raises(monkeypatch):
    """Nothing hands a failing torch scan to numpy: the error reaches the
    caller of the replay."""
    def broken(*args, **kwargs):
        raise RuntimeError("torch.maximum failed")
    monkeypatch.setattr(torch, "maximum", broken)
    eng = se.TorchScanEngine(device="cpu")
    with pytest.raises(RuntimeError, match="torch.maximum failed"):
        ExanetMPI().run_schedule_many(
            tschedules.RecursiveDoublingAllreduce(), (4096, 65536), 16,
            engine=eng)


# ------------------------------------------------- compiled schedules
SCHEDULES = ("BinomialBroadcast", "RecursiveDoublingAllreduce",
             "RingAllreduce", "RabenseifnerAllreduce", "OneShotAllreduce",
             "AllGather", "AllToAll", "Barrier", "ScatterBinomial",
             "GatherBinomial", "HierarchicalAccelAllreduce")
SIZES = (1, 31, 32, 33, 4096, 1 << 20)


@pytest.mark.parametrize("name", SCHEDULES)
def test_compiled_schedules_match_interpreter_and_reference(mpis, name,
                                                            engine):
    """tests/test_exec_compiled.py::test_compiled_matches_interpreter on
    the port, each size grid in one batched replay through ``engine``; the
    interpreter equal to the reference's, the batch to its numpy lane."""
    mpi, jmpi = mpis
    sched, jsched = getattr(tschedules, name)(), getattr(jschedules, name)()
    for nranks in (4, 16):
        sizes, refs = [], []
        for size in SIZES:
            try:
                ref = jmpi.run_schedule(jsched, size, nranks,
                                        backend="interp")
            except (ValueError, AssertionError):
                with pytest.raises((ValueError, AssertionError)):
                    mpi.run_schedule(sched, size, nranks, backend="interp")
                continue
            a = mpi.run_schedule(sched, size, nranks, backend="interp")
            assert (a.latency_us, a.clocks) == (ref.latency_us, ref.clocks)
            sizes.append(size)
            refs.append(a)
        if not sizes:
            continue
        batch = mpi.run_schedule_many(sched, tuple(sizes), nranks,
                                      engine=engine)
        jbatch = jmpi.run_schedule_many(jsched, tuple(sizes), nranks)
        np.testing.assert_array_equal(batch.latency_us, jbatch.latency_us)
        np.testing.assert_array_equal(batch.clocks, jbatch.clocks)
        for i, a in enumerate(refs):
            assert batch.latency_us[i] == pytest.approx(a.latency_us,
                                                        rel=RTOL)
            np.testing.assert_allclose(batch.clocks[i], a.clocks,
                                       rtol=RTOL, atol=1e-12)


def _fixed_schedule(mod):
    class Fixed(mod.Schedule):
        """A literal round list."""
        name = "fixed"

        def __init__(self, rounds, one_way=False):
            self._rounds = tuple(rounds)
            self.one_way = one_way

        def rounds(self, nranks, nbytes):
            return iter(self._rounds)
    return Fixed


def test_seeded_fuzz_schedules_compiled_equals_interp(engine):
    """tests/test_exec_compiled.py's 60-seed fuzz of round structures
    (duplicate and self sends, mixed transports, exchange and one-way,
    reductions, sync skew, both placements) on the port through
    ``engine``; the interpreter equal to the reference's."""
    byts = [0, 1, 31, 32, 33, 100, 4096, 65536, 300000]
    mpis = {rpm: (ExanetMPI(ranks_per_mpsoc=rpm),
                  JExanetMPI(ranks_per_mpsoc=rpm)) for rpm in (None, 1)}
    TFixed, JFixed = _fixed_schedule(tschedules), _fixed_schedule(jschedules)
    for seed in range(60):
        rng = random.Random(seed)
        rpm = rng.choice([None, 1])
        n = rng.choice([2, 4, 8, 16])
        rounds = {"t": [], "j": []}
        for step in range(rng.randint(1, 4)):
            uniform = rng.random() < 0.5
            nb0 = rng.choice(byts)
            sends = tuple((rng.randrange(n), rng.randrange(n),
                           nb0 if uniform else rng.choice(byts))
                          for _ in range(rng.randint(1, 12)))
            kw = dict(exchange=rng.random() < 0.5,
                      reduce_bytes=rng.choice([0, 64, 4096]),
                      sync=rng.random() < 0.3)
            rounds["t"].append(tschedules.Round(step, sends, **kw))
            rounds["j"].append(jschedules.Round(step, sends, **kw))
        one_way = rng.random() < 0.5
        mpi, jmpi = mpis[rpm]
        a = mpi.run_schedule(TFixed(rounds["t"], one_way), 0, n,
                             backend="interp")
        ref = jmpi.run_schedule(JFixed(rounds["j"], one_way), 0, n,
                                backend="interp")
        assert (a.latency_us, a.clocks) == (ref.latency_us, ref.clocks)
        b = mpi.run_schedule_many(TFixed(rounds["t"], one_way), (0,), n,
                                  engine=engine)
        assert b.latency_us[0] == pytest.approx(a.latency_us, rel=RTOL), \
            seed
        np.testing.assert_allclose(b.clocks[0], a.clocks, rtol=RTOL,
                                   atol=1e-12)


def test_schedule_plumbing():
    """tests/test_exec_compiled.py's caching, tracing, structure and
    predictor tests on the port."""
    mpi = ExanetMPI()
    sched = tschedules.RecursiveDoublingAllreduce()
    prog = mpi.compiled_program(sched, 8)
    assert mpi.compiled_program(tschedules.RecursiveDoublingAllreduce(),
                                8) is prog
    b1 = prog.bind(sched, SIZES)
    assert prog.bind(sched, SIZES) is b1
    traced = ExanetMPI(trace=True)
    with pytest.raises(ValueError, match="trace"):
        traced.run_schedule_many(sched, (64,), 8)
    res = traced.run_schedule(sched, 64, 8)
    assert res.latency_us > 0 and len(traced.net.trace) > 0
    wide = ExanetMPI(ranks_per_mpsoc=1)
    assert not wide.compiled_profitable(tschedules.RingAllreduce(), 64)
    assert wide.compiled_profitable(sched, 64)
    assert wide.compiled_profitable(tschedules.BinomialBroadcast(), 64)
    p = scaled_params(4096)
    assert p.n_cores >= 4096
    assert p.mezz_torus_y * p.mezz_torus_z == p.mezzanines
    assert p.rdma_startup_us == DEFAULT.rdma_startup_us
    assert scaled_params(100) is DEFAULT


def test_size_varying_structure_rejected_and_auto_falls_back(monkeypatch):
    class SizeVarying(tschedules.Schedule):
        name = "size_varying"

        def rounds(self, nranks, nbytes):
            d = 1 + (nbytes > 64)
            yield tschedules.Round(0, tuple((r, (r + d) % nranks, nbytes)
                                            for r in range(nranks)),
                                   exchange=True)
    mpi = ExanetMPI()
    with pytest.raises(ProgramStructureError):
        mpi.run_schedule_many(SizeVarying(), (1, 4096), 8)
    monkeypatch.setattr(ExanetMPI, "COMPILED_AUTO_MIN_RANKS", 2)
    monkeypatch.setattr(ExanetMPI, "COMPILED_MIN_PARALLELISM", 0.0)
    a = mpi.run_schedule(SizeVarying(), 1, 8, backend="interp")
    b = mpi.run_schedule(SizeVarying(), 1, 8, backend="auto")
    _assert_sched_equal(a, b, "auto-fallback")


# -------------------------------------------- batched schedule runs
@pytest.mark.parametrize("name", ["RecursiveDoublingAllreduce",
                                  "RabenseifnerAllreduce"])
def test_size_grid_batched_equals_per_size_loop(engine, name):
    mpi, jmpi = ExanetMPI(), JExanetMPI()
    sched = getattr(tschedules, name)()
    batch = mpi.run_schedule_many(sched, BYTES, 16, engine=engine)
    jbatch = jmpi.run_schedule_many(getattr(jschedules, name)(), BYTES, 16)
    np.testing.assert_array_equal(batch.latency_us, jbatch.latency_us)
    for b, size in enumerate(BYTES):
        ref = mpi.run_schedule(sched, size, 16, backend="interp")
        assert batch.latency_us[b] == pytest.approx(ref.latency_us,
                                                    rel=RTOL), size
        np.testing.assert_allclose(batch.clocks[b], ref.clocks, rtol=RTOL,
                                   atol=1e-12)


def test_arrival_offset_columns_match_interp(engine):
    n, size, B = 16, 4096, 5
    t0 = np.random.default_rng(7).uniform(0.0, 5.0, size=(n, B))
    mpi = ExanetMPI()
    sched = tschedules.RecursiveDoublingAllreduce()
    batch = mpi.run_schedule_many(sched, (size,) * B, n, t0=t0,
                                  engine=engine)
    jbatch = JExanetMPI().run_schedule_many(
        jschedules.RecursiveDoublingAllreduce(), (size,) * B, n, t0=t0)
    np.testing.assert_array_equal(batch.clocks, jbatch.clocks)
    for b in range(B):
        ref = mpi.run_schedule(sched, size, n, backend="interp",
                               t0=list(t0[:, b]))
        assert batch.latency_us[b] == pytest.approx(ref.latency_us,
                                                    rel=RTOL), b
        np.testing.assert_allclose(batch.clocks[b], ref.clocks, rtol=RTOL,
                                   atol=1e-12)


def test_run_schedule_t0_exact_on_compiled_backend():
    n, size = 8, 65536
    t0 = [0.0, 3.25, 1.5, 0.75, 2.0, 0.0, 4.125, 0.5]
    mpi = ExanetMPI()
    sched = tschedules.RabenseifnerAllreduce()
    a = mpi.run_schedule(sched, size, n, backend="interp", t0=t0)
    b = mpi.run_schedule(sched, size, n, backend="compiled", t0=t0)
    _assert_sched_equal(a, b, "t0")
    with pytest.raises(ValueError, match="nonzero occupancy"):
        mpi.run_schedule(sched, size, n, backend="compiled", t0=t0,
                         reset=False)


def test_paper_scale_1024_ranks(engine):
    """1,024 ranks (1/MPSoC) on a scaled torus: the interpreter against
    the batched replay, and the torch lane against the reference's numpy
    lane on the OSU size grid."""
    mpi = ExanetMPI(scaled_params(4096), ranks_per_mpsoc=1)
    sched = tschedules.BinomialBroadcast()
    a = mpi.run_schedule(sched, 4096, 1024, backend="interp")
    grid = tuple(1 << i for i in range(23))
    batch = mpi.run_schedule_many(sched, grid, 1024, engine=engine)
    assert batch.latency_us[12] == pytest.approx(a.latency_us, rel=RTOL)
    jbatch = JExanetMPI(scaled_params(4096), ranks_per_mpsoc=1) \
        .run_schedule_many(jschedules.BinomialBroadcast(), grid, 1024)
    np.testing.assert_array_equal(batch.latency_us, jbatch.latency_us)
    assert mpi.compiled_profitable(sched, 1024)


# -------------------------------------------- compiled programs
def _check(mpi, prog, tag, engine=None):
    a = mpi.run_program(prog, backend="interp")
    b = mpi.run_program(prog, backend="compiled", engine=engine)
    _assert_prog_equal(a, b, tag)
    return a, b


@pytest.mark.parametrize("face", [1, 31, 33, 4096, 300000])
def test_halo3d_compiled_matches_interp(mpis, face, engine):
    mpi, jmpi = mpis
    for nranks, grid in ((8, None), (12, None), (16, (4, 2, 2)),
                         (2, None)):
        a, _ = _check(mpi, tprogram.halo3d(nranks, face, 12.5, grid=grid),
                      ("halo", nranks, face), engine)
        _same_prog(a, jmpi.run_program(
            jprogram.halo3d(nranks, face, 12.5, grid=grid),
            backend="interp"), ("halo-ref", nranks, face))


def test_overlap_and_selective_waits(mpis, engine):
    mpi, _ = mpis
    P = tprogram
    _check(mpi, P.halo3d(8, 4096, 40.0, overlap=True), "overlap", engine)
    ops0 = (P.Isend(1, 300000, tag=1, handle="a"),
            P.Isend(1, 8, tag=2, handle="b"), P.Wait(("a",)),
            P.Compute(5.0), P.Wait(("b",)))
    ops1 = (P.Irecv(0, 300000, tag=1), P.Irecv(0, 8, tag=2), P.Wait(),
            P.Compute(2.0))
    _check(mpi, P.Program((ops0, ops1)), "named-handles", engine)


@pytest.mark.parametrize("algo", ["recursive_doubling", "oneshot",
                                  "rabenseifner", "auto"])
def test_cg_iteration_with_embedded_collectives(mpis, algo, engine):
    mpi, jmpi = mpis
    a, _ = _check(mpi, tprogram.cg_iteration(8, 70000, 30.0,
                                             coll_algo=algo),
                  ("cg", algo), engine)
    _same_prog(a, jmpi.run_program(jprogram.cg_iteration(
        8, 70000, 30.0, coll_algo=algo), backend="interp"), ("cg-ref", algo))


def test_bsp_collectives_and_degenerate_programs(mpis, engine):
    mpi, _ = mpis
    P = tprogram
    _check(mpi, P.bsp_step(8, 10.0, "allreduce", 4096), "bsp", engine)
    for op in ("bcast", "allgather", "barrier", "alltoall"):
        ops = tuple((P.Compute(3.0), P.Collective(op, 512, "auto"))
                    for _ in range(8))
        _check(mpi, P.Program(ops), ("coll", op), engine)
    _check(mpi, P.Program(((P.Compute(7.0),
                            P.Collective("allreduce", 64, "auto")),)),
           "single-rank", engine)
    colls_only = P.Program(tuple((P.Collective("allreduce", 4096, "auto"),)
                                 for _ in range(8)))
    _check(mpi, colls_only, "colls-only", engine)
    pure = P.Program(tuple((P.Compute(5.0),) for _ in range(4)))
    _, b = _check(mpi, pure, "pure-compute", engine)
    assert b.latency_us == 5.0


def test_deep_wait_chain_compiles_iteratively():
    P = tprogram
    phases = 1200
    ops0 = tuple(x for _ in range(phases)
                 for x in (P.Isend(1, 64, 0), P.Wait()))
    ops1 = tuple(x for _ in range(phases)
                 for x in (P.Irecv(0, 64, 0), P.Wait()))
    _check(ExanetMPI(), P.Program((ops0, ops1)), "deep-chain")


def test_seeded_fuzz_programs_compiled_equals_interp(engine):
    """tests/test_program_compiled.py's 60-seed fuzz (tag bijections,
    mixed eager/rendez-vous sizes, compute skew, overlap, embedded
    collectives) on the port through ``engine``; the interpreter equal to
    the reference's."""
    mpis = {rpm: (ExanetMPI(ranks_per_mpsoc=rpm),
                  JExanetMPI(ranks_per_mpsoc=rpm)) for rpm in (None, 1)}
    for seed in range(60):
        rng = random.Random(seed)
        nranks = rng.choice([2, 4, 6, 8, 12, 16])
        jprog = _fuzz_program(rng, nranks)
        mpi, jmpi = mpis[rng.choice([None, 1])]
        a, _ = _check(mpi, to_port(jprog), ("fuzz", seed), engine)
        _same_prog(a, jmpi.run_program(jprog, backend="interp"),
                   ("fuzz-ref", seed))


def test_synthesized_collective_compiles_r7():
    """ROADMAP.md R7: at one rank per MPSoC, the 16-rank fuzz program of
    seed 1 resolves its 70,000-byte allreduce to a synthesized
    ``synth:<digest>`` schedule. The reference's compiled path looks the
    name up in the menu and raises KeyError; the port's resolves it as the
    interpreter does, and the two agree."""
    jprog = _fuzz_program(random.Random(1), 16)
    mpi, jmpi = ExanetMPI(ranks_per_mpsoc=1), JExanetMPI(ranks_per_mpsoc=1)
    prog = to_port(jprog)
    plans = mpi._plan_program_sites(prog, None)
    assert [pl.schedule[:6] for pl in plans.values()] == ["synth:"]
    ref = jmpi.run_program(jprog, backend="interp")
    with pytest.raises(KeyError, match="synth:"):
        jmpi.run_program(jprog, backend="compiled")
    a = mpi.run_program(prog, backend="interp")
    _same_prog(a, ref, "r7-interp")
    assert a.latency_us == pytest.approx(6784.4988, abs=1e-4)
    for eng in ENGINES.values():
        b = mpi.run_program(prog, backend="compiled", engine=eng)
        _assert_prog_equal(a, b, ("r7", eng))


def test_one_artifact_serves_a_size_sweep(mpis, engine):
    mpi, _ = mpis
    progs = [tprogram.halo3d(16, nb, us) for nb, us in
             ((16, 5.0), (1024, 50.0), (65536, 0.25), (300000, 11.0))]
    art = mpi.program_artifact(progs[0])
    for p in progs[1:]:
        assert mpi.program_artifact(p) is art
    outs = art.run(art.bind(progs), engine=engine)
    for p, b in zip(progs, outs):
        _assert_prog_equal(mpi.run_program(p, backend="interp"), b,
                           "rebind")
    assert len(art._tape_cache) == 1


def test_program_structure_guards():
    """tests/test_program_compiled.py's cache, structure and backend
    guards on the port."""
    P = tprogram
    mpi = ExanetMPI()
    p1, p2 = P.halo3d(8, 1024, 10.0), P.halo3d(8, 300000, 3.0)
    assert p1.structure_key() == p2.structure_key()
    a1, _ = _check(mpi, p1, "p1")
    a2, _ = _check(mpi, p2, "p2")
    assert abs(a1.latency_us - a2.latency_us) > 1e-6
    assert mpi.program_artifact(p1) is mpi.program_artifact(p2)
    art = mpi.program_artifact(P.halo3d(8, 1024, 10.0))
    with pytest.raises(ProgramStructureError):
        art.bind([P.halo3d(16, 1024, 10.0)])
    with pytest.raises(ProgramStructureError):
        art.bind([P.halo3d(8, 1024, 10.0, grid=(8, 1, 1))])
    good = P.Program(tuple((P.Compute(1.0), P.Collective(
        "allreduce", 1024, "recursive_doubling")) for _ in range(2)))
    bad = P.Program((
        (P.Compute(1.0), P.Collective("allreduce", 1024,
                                      "recursive_doubling")),
        (P.Compute(1.0), P.Collective("allreduce", 2048,
                                      "recursive_doubling"))))
    assert good.structure_key() == bad.structure_key()
    mpi.run_program(good, backend="compiled")
    for be in ("interp", "compiled"):
        with pytest.raises(P.ProgramError, match="collective mismatch"):
            mpi.run_program(bad, backend=be)
    with pytest.raises(ValueError, match="backend"):
        mpi.run_program(P.halo3d(4, 64, 1.0), backend="jit")
    traced = ExanetMPI(trace=True)
    with pytest.raises(ValueError, match="trace"):
        traced.run_program(P.halo3d(4, 64, 1.0), backend="compiled")
    res = traced.run_program(P.halo3d(4, 64, 1.0))
    assert res.latency_us > 0 and len(traced.net.trace) > 0


def test_auto_gates(monkeypatch):
    """The ``backend="auto"`` gates of tests/test_program_compiled.py and
    tests/test_batch_engine.py on the port: small programs and serial-
    chain splices stay interpreted; above the floor, auto compiles."""
    P = tprogram
    m = ExanetMPI()
    small = to_port(_fuzz_program(random.Random(3), 2))
    assert not m._program_auto_compiles(small, {})
    ref = m.run_program(small, backend="interp")
    _assert_prog_equal(ref, m.run_program(small, backend="auto"), "floor")
    for r in m.run_program_many([small, small], backend="auto"):
        _assert_prog_equal(ref, r, "floor-many")
    assert small.structure_key() not in getattr(m, "_app_program_cache", {})
    monkeypatch.setattr(ExanetMPI, "PROGRAM_COMPILED_AUTO_MIN_RANKS", 2)
    mpi = ExanetMPI()
    ring = P.Program(tuple((P.Collective("allreduce", 12288, "ring"),)
                           for _ in range(8)))
    wide = P.Program(tuple((P.Collective("allreduce", 12288,
                                         "recursive_doubling"),)
                           for _ in range(8)))
    assert not mpi._program_splices_profitable(ring, {})
    assert mpi._program_splices_profitable(wide, {})
    _assert_prog_equal(mpi.run_program(ring, backend="interp"),
                       mpi.run_program(ring, backend="auto"), "ring-auto")
    assert ring.structure_key() not in getattr(mpi, "_app_program_cache",
                                               {})
    halo = P.halo3d(8, 4096, 10.0)
    assert mpi._program_auto_compiles(halo, {})
    _assert_prog_equal(mpi.run_program(halo, backend="interp"),
                       mpi.run_program(halo, backend="auto"), "auto")
    assert halo.structure_key() in mpi._app_program_cache
    progs = [P.halo3d(8, 1024, 5.0), P.cg_iteration(8, 4096, 10.0),
             P.halo3d(8, 65536, 7.0), P.halo3d(6, 512, 3.0)]
    for i, (p, b) in enumerate(zip(progs, mpi.run_program_many(progs))):
        _assert_prog_equal(mpi.run_program(p, backend="interp"), b,
                           ("many", i))


# ----------------------------------------------- batched program runs
@pytest.mark.parametrize("seed", range(4))
def test_program_batch_equals_per_binding_loop(engine, seed):
    """tests/test_batch_engine.py: mixed-structure fuzz programs through
    run_program_many/bind_batch, every column equal to its own interpreted
    run, and to the reference's interpreter."""
    rng = random.Random(9000 + seed)
    jprogs = []
    for _ in range(2):
        base = _fuzz_program(rng, rng.choice([4, 8, 16]))
        comp, post, _ = extract_data(to_port(base))
        jprogs.append(base)
        for _ in range(2):
            f = rng.choice([0.0, 0.5, 1.0, 7.3, 130.0])
            g = rng.uniform(0.25, 4.0)
            jprogs.append(jprogram.Program(tuple(
                tuple(ops) for ops in _rebound_ops(base, comp, post, f, g))))
    rng.shuffle(jprogs)
    mpi, jmpi = ExanetMPI(), JExanetMPI()
    progs = [to_port(p) for p in jprogs]
    got = mpi.run_program_many(progs, backend="compiled", engine=engine)
    for i, (p, jp) in enumerate(zip(progs, jprogs)):
        ref = mpi.run_program(p, backend="interp")
        _same_prog(ref, jmpi.run_program(jp, backend="interp"), ("ref", i))
        _assert_prog_equal(ref, got[i], ("batch", seed, i))


def _rebound_ops(base, comp, post, f, g):
    """The reference's program with compute scaled by ``g`` and payloads
    by ``f``, as rebind_program builds it on the port."""
    rebound = rebind_program(to_port(base), compute_us=[c * g for c in comp],
                             post_nbytes=[int(round(x * f)) for x in post])
    return [[getattr(jprogram, type(op).__name__)(**dataclasses.asdict(op))
             for op in ops] for ops in rebound.rank_ops]


def test_scenario_sweep_matches_rebound_interp(engine):
    prog = tprogram.cg_iteration(8, 70000, 30.0)
    comp, post, _ = extract_data(prog)
    N = 6
    nrng = np.random.default_rng(11)
    cs = nrng.uniform(0.5, 2.0, size=N)
    bs = nrng.uniform(0.25, 3.0, size=N)
    mpi = ExanetMPI()
    res = mpi.run_program_scenarios(prog, compute_scale=cs, byte_scale=bs,
                                    engine=engine)
    jres = JExanetMPI().run_program_scenarios(
        jprogram.cg_iteration(8, 70000, 30.0), compute_scale=cs,
        byte_scale=bs)
    assert len(res) == N
    for b in range(N):
        _same_prog(res[b], jres[b], ("scenario-ref", b))
        pb = rebind_program(prog, compute_us=np.array(comp) * cs[b],
                            post_nbytes=np.rint(np.array(post) * bs[b]))
        _assert_prog_equal(mpi.run_program(pb, backend="interp"), res[b],
                           ("scenario", b))


def test_scenario_per_rank_skew_passes_internal_check(engine):
    prog = tprogram.halo3d(8, 4096, 40.0, overlap=True)
    cs = np.random.default_rng(5).uniform(0.5, 2.0, size=(8, 4))
    res = ExanetMPI().run_program_scenarios(prog, compute_scale=cs,
                                            engine=engine, check=4)
    jres = JExanetMPI().run_program_scenarios(
        jprogram.halo3d(8, 4096, 40.0, overlap=True), compute_scale=cs,
        check=4)
    for b, (x, y) in enumerate(zip(res, jres)):
        _same_prog(x, y, ("skew", b))


def test_scenario_check_and_argument_validation():
    """check= rejects a builder whose firing order moves with the payload;
    malformed scenario axes raise."""
    nrng = np.random.default_rng(11)
    mpi = ExanetMPI()
    for seed in range(20):
        prog = to_port(_fuzz_program(random.Random(4242 + seed), 8))
        try:
            mpi.run_program_scenarios(
                prog, compute_scale=nrng.uniform(0.5, 2.0, size=6),
                byte_scale=nrng.uniform(0.25, 3.0, size=6), check=6)
        except ProgramStructureError as e:
            assert "run_program_many" in str(e)
            break
    else:
        raise AssertionError("no payload-dependent program in 20 seeds")
    prog = to_port(_fuzz_program(random.Random(1), 4))
    with pytest.raises(ValueError, match="at least one of compute_scale"):
        mpi.run_program_scenarios(prog)
    with pytest.raises(ValueError, match="disagrees on N"):
        mpi.run_program_scenarios(prog, compute_scale=np.ones(3),
                                  byte_scale=np.ones(4))
    with pytest.raises(ValueError, match=r"\(N,\), \(nranks, N\) or "
                                         r"\(n_computes, N\)"):
        mpi.run_program_scenarios(prog, compute_scale=np.ones((3, 2)))


def test_scenario_sweep_of_1024_columns_through_the_torch_lane():
    """The card phase's sweep at its CPU size: cg_iteration at 64 ranks,
    1,024 seeded compute and byte scale columns, through the torch lane
    and the numpy lane (equal bit for bit) with 8 columns checked against
    the interpreter."""
    prog = tprogram.cg_iteration(64, 70000, 30.0)
    rng = np.random.default_rng(27)
    cs = rng.uniform(0.5, 2.0, size=1024)
    bs = rng.uniform(0.25, 3.0, size=1024)
    mpi = ExanetMPI()
    eng = se.TorchScanEngine(device="cpu")
    got = mpi.run_program_scenarios(prog, compute_scale=cs, byte_scale=bs,
                                    engine=eng, check=8)
    want = mpi.run_program_scenarios(prog, compute_scale=cs, byte_scale=bs)
    assert len(got) == 1024
    assert eng.calls["maxplus_scan"] + eng.calls["running_max"] > 0
    for b, (x, y) in enumerate(zip(got, want)):
        _same_prog(x, y, ("columns", b))


# ------------------------------------------------------- machine layer
def test_cost_program_backends_agree():
    from repro_torch.core.machine import ExanetMachine
    from repro.core.machine import ExanetMachine as JExanetMachine
    m = ExanetMachine()
    prog = tprogram.cg_iteration(16, 70000, 25.0)
    ci = m.cost_program(prog, backend="interp")
    cc = m.cost_program(prog, backend="compiled")
    assert cc == pytest.approx(ci, rel=RTOL)
    assert ci == JExanetMachine().cost_program(
        jprogram.cg_iteration(16, 70000, 25.0), backend="interp")
    batch = m.cost_program_many([prog, tprogram.halo3d(16, 1024, 5.0)],
                                backend="compiled")
    assert batch[0] == pytest.approx(ci, rel=RTOL)


def test_grad_sync_program_cost_compiled():
    from repro_torch.core.machine import ExanetMachine, TpuMachine
    from repro_torch.parallel.grad_sync import cost_sync_program_s
    from repro.core.machine import ExanetMachine as JExanetMachine
    from repro.parallel.grad_sync import cost_sync_program_s as jcost
    m = ExanetMachine()
    buckets = [1 << 20, 1 << 20, 4096]
    a = cost_sync_program_s(m, 16, buckets, compute_us_per_bucket=50.0,
                            backend="interp")
    b = cost_sync_program_s(m, 16, buckets, compute_us_per_bucket=50.0,
                            backend="compiled")
    assert b == pytest.approx(a, rel=RTOL)
    assert a == jcost(JExanetMachine(), 16, buckets,
                      compute_us_per_bucket=50.0, backend="interp")
    assert cost_sync_program_s(TpuMachine(), 16, buckets) > 0


def test_simulator_runs_without_torch_jax_or_reference():
    """The simulator is host code: with torch, jax and the reference
    blocked it imports, replays on the numpy lane, and lists no torch
    lane."""
    import os
    import pathlib
    import subprocess
    root = pathlib.Path(__file__).resolve().parents[1]
    code = ("import sys\n"
            "for name in ('torch', 'jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "from repro_torch.core.exanet import ExanetMPI\n"
            "from repro_torch.core.exanet.scan_engine import "
            "available_engines\n"
            "from repro_torch.core.machine import ExanetMachine\n"
            "from repro_torch.core.program import cg_iteration\n"
            "assert available_engines() == ['numpy']\n"
            "m = ExanetMPI()\n"
            "r = m.run_program(cg_iteration(8, 4096, 10.0), "
            "backend='compiled')\n"
            "assert r.latency_us > 10.0\n"
            "assert ExanetMachine().cost_program("
            "cg_iteration(8, 4096, 10.0)) > 0\n"
            "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0 and res.stdout.startswith("ok"), res.stderr
