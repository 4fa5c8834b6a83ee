"""The port's train-step co-simulator against the reference's.

``repro_torch.train.cosim`` (``TrainStepSpec``, ``SyncCandidate``,
``TrainSim``) is a copy of the reference's module. Both sides run the same
float operations, so the compute slots, the candidate grid, the analytic
baseline, every candidate's simulated step time and the plan of
``CollectivePlanner.plan_train_sync`` are held equal to the reference's
exactly; the torch scan lane on the CPU (``TorchScanEngine(device="cpu")``)
costs the same candidates within 1e-9 of the numpy lane and chooses the
same plan. Then the cases of ``tests/test_train_cosim.py`` and
``tests/test_fault_engine.py::test_trainsim_rank_compute_scale``, on the
port. Every random draw comes from a fixed seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.core.planner import CollectivePlanner as JCollectivePlanner
from repro.train.cosim import SyncCandidate as JSyncCandidate
from repro.train.cosim import TrainSim as JTrainSim
from repro.train.cosim import TrainStepSpec as JTrainStepSpec
from repro_torch.core.exanet.scan_engine import TorchScanEngine
from repro_torch.core.machine import ExanetMachine, TpuMachine
from repro_torch.core.planner import CollectivePlanner
from repro_torch.core.program import (Collective, Compute, Program,
                                      ProgramError, Wait)
from repro_torch.train.cosim import SyncCandidate, TrainSim, TrainStepSpec

TORCH_CPU = TorchScanEngine(device="cpu")
RTOL = 1e-9
KW = dict(arch="exanest-lm-100m", nranks=8, seq_len=256, rank_gflops=50.0)
SPEC = TrainStepSpec(**KW)


@pytest.fixture(scope="module")
def sim():
    return TrainSim(SPEC)


@pytest.fixture(scope="module")
def jsim():
    return JTrainSim(JTrainStepSpec(**KW))


def _j(c: SyncCandidate) -> JSyncCandidate:
    return JSyncCandidate(**dataclasses.asdict(c))


def family(sim, n, seed=7):
    """The reference train sweep's split-perturbed family of one 8-bucket
    candidate (``benchmarks/train_sweep.py``'s ``speedup_row``)."""
    base = SyncCandidate(8, sim.feasible_algos()[0], 1)
    rng = np.random.default_rng(seed)
    fam = [base]
    while len(fam) < n:
        m = sim.mutate(dataclasses.replace(base), rng)
        if m.family() == base.family() and m not in fam:
            fam.append(m)
    return fam


# ------------------------------------------------ equal to the reference
@pytest.mark.parametrize("kw", [
    KW, dict(arch="deepseek-7b", nranks=16, seq_len=512, batch_per_rank=2,
             rank_gflops=1000.0),
    dict(arch="granite-moe-1b-a400m", nranks=4, microbatches=2)],
    ids=["exanest", "deepseek", "granite"])
def test_costs_grid_and_baseline_equal_reference(kw):
    port, ref = TrainSim(TrainStepSpec(**kw)), JTrainSim(JTrainStepSpec(**kw))
    assert (port.fwd_us, port.bwd_us, port.opt_us, port.grad_bytes) == \
        (ref.fwd_us, ref.bwd_us, ref.opt_us, ref.grad_bytes)
    assert port.closed == ref.closed and port.hlo_cost == ref.hlo_cost
    assert port.feasible_algos() == ref.feasible_algos()
    grid = port.candidate_grid()
    assert [dataclasses.astuple(c) for c in grid] == \
        [dataclasses.astuple(c) for c in ref.candidate_grid()]
    assert dataclasses.astuple(port.analytic_candidate()) == \
        dataclasses.astuple(ref.analytic_candidate())
    got = port.cost_candidates(grid, check=1)
    want = ref.cost_candidates([_j(c) for c in grid])
    assert got.tolist() == want.tolist()
    cand = grid[-1]
    assert port.lower_bound_us(cand) == ref.lower_bound_us(_j(cand))
    # the TPU machine's analytic walk has no NI accelerator
    soft = [c for c in grid if c.algo != "accel"][-1]
    assert port.step_time_analytic(soft) == ref.step_time_analytic(_j(soft))
    assert repr(port.emit_step(cand).rank_ops) == \
        repr(ref.emit_step(_j(cand)).rank_ops)


def test_mutations_equal_reference(sim, jsim):
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    cand = SyncCandidate(4, "rabenseifner", 1)
    for _ in range(40):
        got, want = sim.mutate(cand, rng), jsim.mutate(_j(cand), jrng)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        cand = got


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_family_costs_equal_reference(engine, sim, jsim):
    fam = family(sim, 16)
    want = jsim.cost_candidates([_j(c) for c in fam])
    calls = sum(TORCH_CPU.calls.values())
    got = sim.cost_candidates(fam, engine=TORCH_CPU if engine == "torch"
                              else engine, check=2, rtol=RTOL)
    if engine == "numpy":
        assert got.tolist() == want.tolist()
    else:
        assert sum(TORCH_CPU.calls.values()) > calls
    assert np.max(np.abs(got - want) / want) <= RTOL
    assert len(set(got.tolist())) > 1


@pytest.fixture(scope="module")
def plans():
    """``plan_train_sync`` at 16 ranks through each package's planner,
    and through the port's on the torch lane."""
    kw = dict(KW, nranks=16)
    port, ref = TrainSim(TrainStepSpec(**kw)), JTrainSim(JTrainStepSpec(**kw))
    args = dict(generations=1, survivors=2, children=2, check=1, seed=0)
    return (CollectivePlanner(port.machine).plan_train_sync(port, **args),
            CollectivePlanner(port.machine).plan_train_sync(
                port, engine=TORCH_CPU, **args),
            JCollectivePlanner(ref.machine).plan_train_sync(ref, **args))


def _plan_fields(plan) -> tuple:
    return (dataclasses.astuple(plan.chosen), plan.step_us,
            dataclasses.astuple(plan.baseline), plan.baseline_step_us,
            plan.flipped, tuple(plan.flip_kinds), plan.margin,
            plan.evaluated)


def test_plan_train_sync_equals_reference(plans):
    got, _, want = plans
    assert _plan_fields(got) == _plan_fields(want)


def test_plan_train_sync_torch_lane_equals_numpy(plans):
    got, torch_plan, _ = plans
    assert dataclasses.astuple(torch_plan.chosen) == \
        dataclasses.astuple(got.chosen)
    assert torch_plan.flipped == got.flipped
    assert abs(torch_plan.step_us - got.step_us) <= RTOL * got.step_us


def test_package_exports_the_simulator():
    import repro_torch.train as train
    assert (train.TrainSim, train.TrainStepSpec, train.SyncCandidate) == \
        (TrainSim, TrainStepSpec, SyncCandidate)


# ------------------------------ tests/test_train_cosim.py, on the port
def test_candidate_rejects_auto_algo():
    with pytest.raises(ValueError, match="explicit algorithms"):
        SyncCandidate(4, "auto")


def test_candidate_rejects_split_mismatch():
    with pytest.raises(ValueError, match="split fractions"):
        SyncCandidate(4, "rabenseifner", split=(0.5, 0.5))


def test_candidate_fractions_normalize():
    c = SyncCandidate(2, "rabenseifner", split=(3.0, 1.0))
    assert c.fractions() == (0.75, 0.25)
    assert sum(SyncCandidate(5, "rabenseifner").fractions()) == \
        pytest.approx(1.0)


def test_family_saturates_depth_and_ignores_split():
    a = SyncCandidate(4, "rabenseifner", 2)
    b = SyncCandidate(4, "rabenseifner", 2, split=(0.4, 0.3, 0.2, 0.1))
    assert a.family() == b.family()
    assert SyncCandidate(2, "rabenseifner", 7).family() == \
        SyncCandidate(2, "rabenseifner", 2).family()
    assert SyncCandidate(2, "rabenseifner", 0).family() != \
        SyncCandidate(2, "rabenseifner", 1).family()


def test_emit_structure(sim):
    blocking = sim.emit_step(SyncCandidate(3, "rabenseifner", 0))
    row = blocking.rank_ops[0]
    assert all(r == row for r in blocking.rank_ops)
    colls = [op for op in row if isinstance(op, Collective)]
    assert len(colls) == 3 and all(c.handle is None for c in colls)
    assert not any(isinstance(op, Wait) for op in row)
    assert sum(c.nbytes for c in colls) == pytest.approx(
        sim.grad_bytes, rel=1e-6)
    over = sim.emit_step(SyncCandidate(3, "rabenseifner", 2))
    row = over.rank_ops[0]
    colls = [op for op in row if isinstance(op, Collective)]
    assert [c.handle for c in colls] == ["g0", "g1", "g2"]
    waits = [op for op in row if isinstance(op, Wait)]
    assert [w.handles for w in waits] == [("g0",), None]
    assert sum(isinstance(op, Compute) for op in row) == 5


def test_split_moves_payloads_not_structure(sim):
    a = SyncCandidate(4, "rabenseifner", 1)
    b = dataclasses.replace(a, split=(0.4, 0.3, 0.2, 0.1))
    sa, sb = sim.emit_step(a), sim.emit_step(b)
    assert [type(op).__name__ for op in sa.rank_ops[0]] == \
        [type(op).__name__ for op in sb.rank_ops[0]]
    assert sim.bucket_bytes(b)[0] > sim.bucket_bytes(a)[0]


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_batched_lane_matches_single_lane(engine, sim):
    cands = [SyncCandidate(4, "rabenseifner", 2),
             SyncCandidate(4, "rabenseifner", 2,
                           split=(0.4, 0.3, 0.2, 0.1)),
             SyncCandidate(4, "rabenseifner", 0),
             SyncCandidate(4, "recursive_doubling", 1)]
    us = sim.cost_candidates(cands, check=2, rtol=1e-9,
                             engine=TORCH_CPU if engine == "torch"
                             else engine)
    singles = np.array([sim.step_time_single(c) for c in cands])
    assert (np.abs(us - singles) / singles).max() <= 1e-9
    assert us[1] != us[0]


def test_batched_lane_engine_numpy(sim):
    cands = [SyncCandidate(2, "rabenseifner", 1),
             SyncCandidate(2, "rabenseifner", 1, split=(0.7, 0.3))]
    us = sim.cost_candidates(cands, engine="numpy", check=1)
    assert np.all(us > 0) and us[0] != us[1]


def test_overlap_emergent_between_bounds(sim):
    cand = SyncCandidate(4, "rabenseifner", 2)
    ov = sim.step_time_single(cand)
    assert ov < sim.serialized_us(cand)
    assert ov >= sim.lower_bound_us(cand) * (1 - 1e-9)


def test_overlap_emerges_through_analytic_hooks(sim):
    over = sim.step_time_analytic(SyncCandidate(4, "rabenseifner", 2))
    block = sim.step_time_analytic(SyncCandidate(4, "rabenseifner", 0))
    assert 0 < over < block


def test_plan_train_sync_flips_analytic_baseline(sim):
    plan = CollectivePlanner(sim.machine).plan_train_sync(
        sim, generations=1, survivors=3, children=3, seed=0, check=1)
    assert plan.baseline.overlap_depth == 0
    assert plan.step_us <= plan.baseline_step_us
    assert plan.flipped and plan.flip_kinds
    assert plan.margin > 0.05
    assert plan.evaluated >= len(sim.candidate_grid())
    assert plan.arch == SPEC.arch and plan.nranks == SPEC.nranks


def test_analytic_candidate_is_blocking_and_feasible(sim):
    base = sim.analytic_candidate()
    assert base.overlap_depth == 0 and base.split is None
    assert base.algo in sim.feasible_algos()
    assert 1 <= base.n_buckets <= 64


def test_async_handle_reuse_raises(sim):
    ops = (Collective("allreduce", 1024, "rabenseifner", handle="h"),
           Collective("allreduce", 1024, "rabenseifner", handle="h"),
           Wait())
    prog = Program(tuple(ops for _ in range(4)))
    with pytest.raises(ProgramError, match="reused"):
        sim.machine._mpi_for(4).run_program(prog, backend="interp")


def test_wait_unknown_handle_raises(sim):
    ops = (Collective("allreduce", 1024, "rabenseifner", handle="h"),
           Wait(("nope",)))
    prog = Program(tuple(ops for _ in range(4)))
    with pytest.raises(ProgramError, match="unknown handle"):
        sim.machine._mpi_for(4).run_program(prog, backend="interp")


def test_async_compiled_matches_interp(sim):
    mpi = sim.machine._mpi_for(8)
    ops = (Compute(us=50.0),
           Collective("allreduce", 1 << 16, "recursive_doubling",
                      handle="a"),
           Compute(us=200.0),
           Collective("allreduce", 1 << 14, "recursive_doubling",
                      handle="b"),
           Wait(("a",)),
           Compute(us=25.0),
           Wait())
    prog = Program(tuple(ops for _ in range(8)))
    ci = mpi.run_program(prog, backend="interp").latency_us
    cc = mpi.run_program(prog, backend="compiled").latency_us
    assert ci == pytest.approx(cc, rel=1e-9)


def test_cost_sync_program_memoized():
    from repro_torch.parallel import grad_sync as gs
    gs.clear_sync_cost_cache()
    m = ExanetMachine()
    buckets = [1 << 20, 1 << 19]
    a = gs.cost_sync_program_s(m, 8, buckets, compute_us_per_bucket=25.0)
    info = gs.sync_cost_cache_info()
    assert info["misses"] == 1 and info["hits"] == 0
    b = gs.cost_sync_program_s(m, 8, buckets, compute_us_per_bucket=25.0)
    info = gs.sync_cost_cache_info()
    assert info["hits"] == 1 and info["misses"] == 1 and a == b
    gs.cost_sync_program_s(m, 8, buckets, compute_us_per_bucket=25.0,
                           overlap_depth=1)
    gs.cost_sync_program_s(m, 8, buckets, compute_us_per_bucket=25.0,
                           algo="recursive_doubling")
    gs.cost_sync_program_s(TpuMachine(), 8, buckets,
                           compute_us_per_bucket=25.0)
    info = gs.sync_cost_cache_info()
    assert info["misses"] == 4 and info["hits"] == 1
    gs.clear_sync_cost_cache()
    assert gs.cost_sync_program_s(m, 8, buckets,
                                  compute_us_per_bucket=25.0) == a
    assert gs.sync_cost_cache_info()["size"] == 1


def test_emit_sync_program_overlap_depth():
    from repro_torch.parallel.grad_sync import emit_sync_program
    prog = emit_sync_program(4, [1 << 20] * 3, compute_us_per_bucket=10.0,
                             overlap_depth=1)
    row = prog.rank_ops[0]
    handles = [op.handle for op in row if isinstance(op, Collective)]
    assert handles == ["g0", "g1", "g2"]
    assert any(isinstance(op, Wait) and op.handles == ("g0",)
               for op in row)
    assert isinstance(row[-1], Wait) and row[-1].handles is None


# ------------- tests/test_fault_engine.py::test_trainsim_rank_compute_scale
def test_trainsim_rank_compute_scale():
    spec = TrainStepSpec(nranks=4)
    with pytest.raises(ValueError, match="rank_compute_scale"):
        TrainSim(spec, rank_compute_scale=np.ones(3))
    healthy = TrainSim(spec)
    rcs = np.ones(4)
    rcs[2] = 3.0
    slow = TrainSim(spec, rank_compute_scale=rcs)
    cand = healthy.analytic_candidate()
    t_h = float(healthy.cost_candidates([cand])[0])
    t_s = float(slow.cost_candidates([cand])[0])
    assert t_s > t_h * 1.5, (t_h, t_s)
    assert TrainSim(spec, rank_compute_scale=np.ones(4)) \
        .rank_compute_scale is None
    jslow = JTrainSim(JTrainStepSpec(nranks=4), rank_compute_scale=rcs)
    assert t_s == float(jslow.cost_candidates([_j(cand)])[0])
