"""The port's collective planner against the JAX package's, on the same inputs.

The planning layer is pure Python on both sides (``core/comm``,
``core/machine``, ``core/planner``, ``core/program``, ``core/exanet/
schedules``, ``core/synth``): the port keeps copies of the reference's
modules, so both run the same float operations and every plan, cost and
threshold must be equal exactly; program costs are held to rel 1e-12.
Then the reference's own planner and program tests, at their own
assertions, on the port's copies, for both machines: ``TpuMachine`` and
``ExanetMachine`` (the ExaNeSt prototype through the port's copy of the
event engine), whose plans and costs equal the reference's as well.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import pytest

from repro.core.comm import CommPolicy as JCommPolicy
from repro.core.exanet.mpi import ExanetMPI as JExanetMPI
from repro.core.machine import ExanetMachine as JExanetMachine
from repro.core.machine import TpuMachine as JTpuMachine
from repro.core import program as jprogram
from repro.core.synth.search import WinnerCache as JWinnerCache
from repro.parallel import grad_sync as jgrad_sync
from repro_torch.core import program as tprogram
from repro_torch.core.comm import CommPolicy
from repro_torch.core.exanet.allreduce_accel import (accel_allreduce_latency,
                                                     accel_cost_us)
from repro_torch.core.exanet.mpi import ExanetMPI
from repro_torch.core.exanet.schedules import ALLREDUCE_SCHEDULES
from repro_torch.core.machine import ExanetMachine, MachineModel, TpuMachine
from repro_torch.core.planner import CollectivePlanner, crossover_bytes
from repro_torch.core.synth.search import WinnerCache
from repro_torch.parallel import grad_sync as tgrad_sync

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: 1 B to 256 MB: the powers of two, odd sizes, and the bucket sizes of
#: full-width exanest-lm-100m on four ranks (24 of 20,000,000 B, the last
#: of 18,674,688 B)
SIZES = ([1 << k for k in range(29)]
         + [3, 1000, 4097, 65537, 999_999, 18_674_688, 20_000_000,
            123_456_789, 256_000_000])
#: the 1,024-rank flat candidate takes ~2 s a plan: one size there
GRAD_SYNC_GRID = [((2,), SIZES), ((4,), SIZES), ((2, 2), SIZES),
                  ((4, 2), SIZES), ((16, 4), SIZES), ((2, 512), [64 << 20])]


def _plan_fields(plan) -> tuple:
    return (plan.op, plan.nbytes, plan.participants, plan.schedule,
            plan.cost_s, plan.costs, plan.fidelity, plan.machine,
            plan.provenance, plan.margin)


# ------------------------------------------------------------------ plans
@pytest.mark.parametrize("p", [2, 4, 8, 16, 64, 256])
def test_allreduce_plans_equal_reference(p):
    mine, ref = CommPolicy().planner, JCommPolicy().planner
    for lossy in (False, True):
        for n in SIZES:
            got = mine.plan("allreduce", n, (p,), allow_lossy=lossy)
            want = ref.plan("allreduce", n, (p,), allow_lossy=lossy)
            assert _plan_fields(got) == _plan_fields(want), (p, n, lossy)


@pytest.mark.parametrize("participants,sizes", GRAD_SYNC_GRID,
                         ids=[str(p) for p, _ in GRAD_SYNC_GRID])
def test_grad_sync_plans_equal_reference(participants, sizes):
    mine, ref = CommPolicy(), JCommPolicy()
    for lossy in (False, True):
        for n in sizes:
            got = mine.planner.plan("grad_sync", n, participants,
                                    allow_lossy=lossy)
            want = ref.planner.plan("grad_sync", n, participants,
                                    allow_lossy=lossy)
            assert _plan_fields(got) == _plan_fields(want), (n, lossy)
            assert (tgrad_sync.plan_bucket_strategy(mine, n, participants,
                                                    lossy)
                    == jgrad_sync.plan_bucket_strategy(ref, n, participants,
                                                       lossy)
                    == got.schedule)


def test_dp_mesh_plans_by_bucket_size():
    """On the 2x2 mesh (intra ``data`` = 2, inter ``pod`` = 2) buckets of up
    to 4 KB stay flat and buckets from 64 KB to 20 MB go hierarchical, or
    compressed when lossy syncs are allowed."""
    pol = CommPolicy()
    for n, exact, lossy in ((256, "flat", "flat"), (4096, "flat", "flat"),
                            (65536, "hierarchical", "compressed"),
                            (18_674_688, "hierarchical", "compressed"),
                            (20_000_000, "hierarchical", "compressed")):
        assert pol.plan_bucket(n, 2, 2).schedule == exact
        assert pol.plan_bucket(n, 2, 2, allow_lossy=True).schedule == lossy


def test_plan_many_and_plan_program_equal_reference():
    sizes = [1, 256, 4096, 65537, 1 << 20, 20_000_000]
    for p in (4, 16):
        got = CommPolicy().planner.plan_many("allreduce", sizes, p)
        want = JCommPolicy().planner.plan_many("allreduce", sizes, p)
        assert [_plan_fields(x) for x in got] == [_plan_fields(x)
                                                  for x in want]
    progs = []
    for mod in (tprogram, jprogram):
        progs.append(mod.Program(tuple(
            (mod.Collective("allreduce", 256), mod.Compute(1.0),
             mod.Collective("allreduce", 1 << 20),
             mod.Collective("allreduce", 256),
             mod.Collective("barrier", 0))
            for _ in range(8))))
    planner = CollectivePlanner(TpuMachine())
    got = planner.plan_program(progs[0])
    want = CollectivePlanner(JTpuMachine()).plan_program(progs[1])
    assert set(got) == set(want) == {("allreduce", 256),
                                     ("allreduce", 1 << 20)}
    assert {k: _plan_fields(v) for k, v in got.items()} == \
        {k: _plan_fields(v) for k, v in want.items()}
    misses = planner.cache_info()["misses"]
    planner.plan_program(progs[0])
    assert planner.cache_info()["misses"] == misses


def test_infeasible_plans_raise_on_both_sides():
    """No silent fallback: a query with no feasible schedule raises, as the
    reference's ``_pick`` does, and so does an unknown op."""
    for pol in (CommPolicy(), JCommPolicy()):
        with pytest.raises(ValueError, match="no feasible schedule"):
            pol.planner.plan("allreduce", 4096, (1,))
        with pytest.raises(ValueError, match="no software allreduce"):
            pol.planner.plan("grad_sync", 4096, (1, 1))
        with pytest.raises(ValueError, match="unknown collective op"):
            pol.planner.plan("reduce", 4096, (4,))


# --------------------------------------------------------- facade numbers
@pytest.mark.parametrize("alpha", [2e-6, 1e-10])
def test_facade_numbers_equal_reference(alpha):
    mine, ref = CommPolicy(alpha_s=alpha), JCommPolicy(alpha_s=alpha)
    for p in (1, 2, 3, 4, 8, 16, 64, 256):
        assert mine.eager_threshold_bytes(p) == ref.eager_threshold_bytes(p)
        assert (mine.planner.eager_threshold_bytes(p)
                == ref.planner.eager_threshold_bytes(p))
        if p > 1:                   # p = 1 divides by zero on both sides
            assert mine.bucket_bytes(p) == ref.bucket_bytes(p)
        for n in (1, 32, 4096, 1 << 20, 20_000_000):
            assert mine.choose(n, p) == ref.choose(n, p)
            args = (n, p, mine.ici_bw, mine.alpha_s)
            assert mine.ring_allreduce_s(*args) == ref.ring_allreduce_s(*args)
            assert (mine.oneshot_allreduce_s(*args)
                    == ref.oneshot_allreduce_s(*args))
            for algo in ALLREDUCE_SCHEDULES:
                outs = []
                for pol in (mine, ref):
                    try:
                        outs.append(pol.schedule_allreduce_s(*args,
                                                             algo=algo))
                    except ValueError:
                        outs.append("ValueError")
                assert outs[0] == outs[1], (algo, n, p)
    bw, a = mine.ici_bw, mine.alpha_s
    from repro.core.planner import (crossover_bytes as jcrossover,
                                    oneshot_cost_s as jone,
                                    ring_cost_s as jring)
    for p in (2, 8, 64):
        assert crossover_bytes(lambda n: jone(n, p, bw, a),
                               lambda n: jring(n, p, bw, a)) == \
            jcrossover(lambda n: jone(n, p, bw, a),
                       lambda n: jring(n, p, bw, a))
    # bucket boundaries are the reference's at every p
    assert CommPolicy().bucket_bytes(4) == 20_000_000


# ------------------------------------------------------------- programs
def _programs(mod):
    return [mod.bsp_step(16, 50.0, "allreduce", 1 << 20),
            mod.bsp_step(8, 0.0, "allreduce", 4096, coll_algo="ring"),
            mod.bsp_step(4, 10.0, "barrier"),
            mod.bsp_step(8, 5.0, "bcast", 4096),
            mod.cg_iteration(8, 4096, 100.0),
            mod.cg_iteration(64, 65536, 20.0, overlap=True),
            mod.halo3d(8, 1024, 10.0),
            mod.halo3d(27, 8192, 5.0, overlap=True),
            mod.halo3d(2, 4096, 0.0)]


def test_program_costs_equal_reference():
    for got_p, want_p in zip(_programs(tprogram), _programs(jprogram)):
        assert repr(got_p.rank_ops) == repr(want_p.rank_ops)
        for level in (None, "intra", "inter"):
            got = TpuMachine().cost_program(got_p, level=level)
            want = JTpuMachine().cost_program(want_p, level=level)
            assert got == pytest.approx(want, rel=1e-12, abs=0.0)
        assert TpuMachine().cost_program_many([got_p]) == [
            TpuMachine().cost_program(got_p)]


@pytest.mark.parametrize("overlap_depth", [0, 2])
def test_sync_program_emission_and_cost_equal_reference(overlap_depth):
    sizes = [4 << 20, 64 << 10, 256, 20_000_000, 18_674_688]
    for algo in ("auto", "ring"):
        kw = dict(compute_us_per_bucket=100.0, algo=algo,
                  overlap_depth=overlap_depth)
        got = tgrad_sync.emit_sync_program(4, sizes, **kw)
        want = jgrad_sync.emit_sync_program(4, sizes, **kw)
        assert repr(got.rank_ops) == repr(want.rank_ops)
        assert [c.nbytes for c in got.collectives()] == sizes
        for fidelity in ("analytic", "sim"):
            c = tgrad_sync.cost_sync_program_s(TpuMachine(), 4, sizes,
                                               fidelity=fidelity, **kw)
            w = jgrad_sync.cost_sync_program_s(JTpuMachine(), 4, sizes,
                                               fidelity=fidelity, **kw)
            assert c == pytest.approx(w, rel=1e-12, abs=0.0)
    with pytest.raises(ValueError, match="buckets"):
        tgrad_sync.emit_sync_program(4, sizes, compute_us_per_bucket=[1.0])


def test_sync_cost_cache_memoizes_per_machine():
    tgrad_sync.clear_sync_cost_cache()
    assert tgrad_sync.sync_cost_cache_info() == {"hits": 0, "misses": 0,
                                                 "size": 0}
    m = TpuMachine(alpha_s=3e-6)
    a = tgrad_sync.cost_sync_program_s(m, 4, [1 << 20, 256],
                                       compute_us_per_bucket=10.0)
    b = tgrad_sync.cost_sync_program_s(m, 4, [1 << 20, 256],
                                       compute_us_per_bucket=10.0)
    assert a == b
    assert tgrad_sync.sync_cost_cache_info() == {"hits": 1, "misses": 1,
                                                 "size": 1}
    tgrad_sync.clear_sync_cost_cache()
    assert tgrad_sync.sync_cost_cache_info()["size"] == 0


# ------------------------------------------------------------ winner cache
def test_winner_cache_is_the_ports_own_copy_of_the_reference():
    port_path = ROOT / "src" / "repro_torch" / "core" / "synth" / \
        "winners.json"
    assert pathlib.Path(WinnerCache.DEFAULT_PATH) == port_path
    assert port_path.read_bytes() == pathlib.Path(
        JWinnerCache.DEFAULT_PATH).read_bytes()
    mine, ref = WinnerCache.default(), JWinnerCache.default()
    assert len(mine) == len(ref) == 9
    assert mine.entries == ref.entries
    for key, entry in mine.entries.items():
        got, want = mine.schedule(entry), ref.schedule(ref.entries[key])
        assert got.name == want.name
        n, p = entry["searched_nbytes"], entry["nranks"]
        assert TpuMachine().cost_s(got, p, n) == JTpuMachine().cost_s(
            want, p, n)
        assert TpuMachine().supports(got, p, n) == JTpuMachine().supports(
            want, p, n)


def test_winner_terms_pass_the_ports_semantic_gate():
    from repro_torch.core.exanet.schedule_algebra import term_from_spec
    from repro_torch.core.synth.verify import check_term
    for entry in WinnerCache.default().entries.values():
        if entry["nranks"] <= 64:
            check_term(term_from_spec(entry["spec"]), entry["nranks"])


# ----------------------------------------------- the planner is host code
def test_planning_layer_runs_without_torch_jax_or_reference():
    code = ("import sys\n"
            "for name in ('torch', 'jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "from repro_torch.core.comm import CommPolicy\n"
            "from repro_torch.core.machine import TpuMachine\n"
            "from repro_torch.core.program import bsp_step\n"
            "from repro_torch.core.synth.search import WinnerCache\n"
            "pol = CommPolicy()\n"
            "assert pol.plan_bucket(20_000_000, 2, 2).schedule == "
            "'hierarchical'\n"
            "assert TpuMachine().cost_program(bsp_step(4, 1.0, 'allreduce',"
            " 4096)) > 0\n"
            "assert len(WinnerCache.default()) == 9\n"
            "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0 and res.stdout.startswith("ok"), res.stderr


# ------------------------- the reference's planner and program tests, here
def test_machines_satisfy_protocol(exa):
    assert isinstance(TpuMachine(), MachineModel)
    assert isinstance(ExanetMachine(mpi=exa["port"][0]), MachineModel)


# ---------------------------------------- the ExaNeSt prototype's planner
SW_ALGOS = ("recursive_doubling", "ring", "rabenseifner", "oneshot")


@pytest.fixture(scope="module")
def exa():
    """(ExanetMPI at one rank per MPSoC, its planner) for each side."""
    out = {}
    for side, cls in (("port", ExanetMPI), ("reference", JExanetMPI)):
        mpi = cls(ranks_per_mpsoc=1)
        out[side] = (mpi, mpi.planner)
    return out


def _true_costs_us(mpi, size, nranks):
    sw = min(mpi.allreduce(size, nranks, a) for a in SW_ALGOS)
    return sw, accel_cost_us(size, nranks, mpi.p)


def _synth_truth_us(mpi, planner, size, nranks):
    machine = planner.machine
    entry = WinnerCache.default().get(machine.name, "allreduce", nranks,
                                      size, machine.placement)
    if entry is None:
        return None
    return mpi.allreduce(size, nranks,
                         WinnerCache.default().schedule(entry).name)


@pytest.mark.parametrize("nranks", [64, 128])
def test_exanet_plans_equal_reference_and_simulated_truth(exa, nranks):
    """tests/test_planner.py::test_planner_choice_matches_simulated_truth
    on the port: each plan is the argmin of the event-simulated software
    cost, the accelerator's closed form and the cached synthesized term,
    and equals the reference's plan field for field."""
    (mpi, planner), (_, jplanner) = exa["port"], exa["reference"]
    for size in (256, 1024, 4096, 8192, 16384, 65536):
        plan = planner.plan("allreduce", size, (nranks,))
        assert _plan_fields(plan) == _plan_fields(
            jplanner.plan("allreduce", size, (nranks,))), size
        sw, hw = _true_costs_us(mpi, size, nranks)
        syn = _synth_truth_us(mpi, planner, size, nranks)
        truth = min(sw, hw) if syn is None else min(sw, hw, syn)
        accel_wins = hw < sw and (syn is None or hw < syn)
        assert (plan.schedule == "accel") == accel_wins, (size, plan)
        synth_wins = syn is not None and syn < min(sw, hw)
        assert plan.provenance == ("synthesized" if synth_wins else "menu")
        assert plan.cost_s * 1e6 == pytest.approx(truth, rel=1e-9)


@pytest.mark.parametrize("nranks", [64, 128])
def test_fig19_accelerator_below_the_crossover(exa, nranks):
    """tests/test_planner.py::test_fig19_crossover_reproduced_from_cost:
    the plan flips from the section 4.7 accelerator to software exactly
    once over 256 B - 64 KB, as the reference's does, and the accelerator
    gives the paper's headline gain at the smallest size."""
    (mpi, planner), (_, jplanner) = exa["port"], exa["reference"]
    sizes = [256 << i for i in range(9)]
    choices = [planner.plan("allreduce", s, (nranks,)).schedule
               for s in sizes]
    assert choices == [jplanner.plan("allreduce", s, (nranks,)).schedule
                       for s in sizes]
    is_accel = [c == "accel" for c in choices]
    assert is_accel[0] and not is_accel[-1]
    assert sum(1 for a, b in zip(is_accel, is_accel[1:]) if a != b) == 1
    sw, hw = _true_costs_us(mpi, 256, nranks)
    assert hw < 0.25 * sw


def test_auto_allreduce_dispatches_on_plan(exa):
    (mpi, planner), (jmpi, _) = exa["port"], exa["reference"]
    for size, nranks in ((256, 64), (1024, 128), (16384, 128), (65536, 64)):
        got = mpi.allreduce(size, nranks, "auto")
        assert got == jmpi.allreduce(size, nranks, "auto")
        plan = planner.plan("allreduce", size, (nranks,))
        if plan.schedule == "accel":
            assert got == accel_cost_us(size, nranks, mpi.p)
            if size <= mpi.p.ar_accel_max_vector_bytes:
                assert got == accel_allreduce_latency(size, nranks, mpi.p)
        else:
            assert got == mpi.allreduce(size, nranks, plan.schedule)


def test_exanet_machine_costs_equal_reference(exa):
    """tests/test_planner.py::test_exanet_machine_analytic_vs_sim_fidelity,
    and every cost and linearization against the reference's machine."""
    mpi, jmpi = exa["port"][0], exa["reference"][0]
    machine, jmachine = ExanetMachine(mpi=mpi), JExanetMachine(mpi=jmpi)
    from repro.core.exanet import schedules as jsched
    from repro_torch.core.exanet import schedules as tsched
    rd = tsched.RecursiveDoublingAllreduce()
    sim = machine.cost_s(rd, 16, 4096, fidelity="sim")
    assert sim * 1e6 == pytest.approx(
        mpi.allreduce(4096, 16, "recursive_doubling"), rel=1e-12)
    for fidelity in ("analytic", "sim"):
        tiny_one = machine.cost_s(tsched.OneShotAllreduce(), 8, 1,
                                  fidelity=fidelity)
        assert tiny_one <= machine.cost_s(rd, 8, 1, fidelity=fidelity) * 1.5
    for level in ("intra", "inter"):
        assert machine.alpha_beta(level) == jmachine.alpha_beta(level)
    for name in ("RecursiveDoublingAllreduce", "RingAllreduce",
                 "RabenseifnerAllreduce", "OneShotAllreduce",
                 "BinomialBroadcast"):
        for fidelity in ("analytic", "sim"):
            for n, size in ((8, 1), (16, 4096), (64, 1 << 20)):
                got = machine.cost_s(getattr(tsched, name)(), n, size,
                                     fidelity=fidelity)
                want = jmachine.cost_s(getattr(jsched, name)(), n, size,
                                       fidelity=fidelity)
                assert got == want, (name, fidelity, n, size)


def test_exanet_plan_many_and_tiers_equal_reference():
    """tests/test_exec_compiled.py's batched planning and scaled tiers on
    the port's machine."""
    sizes = [1, 256, 4096, 1 << 16, 1 << 20]
    a_pl = CollectivePlanner(ExanetMachine(), fidelity="sim")
    plans = a_pl.plan_many("allreduce", sizes, (16,))
    b_pl = CollectivePlanner(ExanetMachine(), fidelity="sim")
    from repro.core.planner import CollectivePlanner as JCollectivePlanner
    j_pl = JCollectivePlanner(JExanetMachine(), fidelity="sim")
    want = j_pl.plan_many("allreduce", sizes, (16,))
    assert [_plan_fields(p) for p in plans] == [_plan_fields(p)
                                                for p in want]
    for plan, size in zip(plans, sizes):
        ref = b_pl.plan("allreduce", size, (16,))
        assert plan.schedule == ref.schedule
        assert plan.cost_s == pytest.approx(ref.cost_s, rel=1e-9)
    hits0 = a_pl.cache_info()["hits"]
    again = a_pl.plan_many("allreduce", sizes, (16,))
    assert [p.schedule for p in again] == [p.schedule for p in plans]
    assert a_pl.cache_info()["hits"] >= hits0 + len(sizes)
    from repro_torch.core.exanet.schedules import RecursiveDoublingAllreduce
    m = ExanetMachine()
    c = m.cost_s(RecursiveDoublingAllreduce(), 256, 4096, fidelity="sim")
    assert c > 0
    from repro.core.exanet.schedules import (
        RecursiveDoublingAllreduce as JRecursiveDoublingAllreduce)
    assert c == JExanetMachine().cost_s(JRecursiveDoublingAllreduce(), 256,
                                        4096, fidelity="sim")
    assert m._mpi_for(256) is m._mpi_for(256)
    assert m._mpi_for(16) is m.mpi


def test_exanet_program_costs_equal_reference():
    """tests/test_program.py's ExanetMachine half: the bsp/cg/halo programs
    and an accelerator program costed on the prototype, equal to the
    reference's."""
    m, jm = ExanetMachine(), JExanetMachine()
    for got_p, want_p in zip(_programs(tprogram), _programs(jprogram)):
        assert m.cost_program(got_p) == jm.cost_program(want_p)
    accel = [mod.bsp_step(8, 0.0, "allreduce", 4096, coll_algo="accel")
             for mod in (tprogram, jprogram)]
    for fidelity in ("analytic", "sim"):
        assert m.cost_program(accel[0], fidelity=fidelity) == \
            jm.cost_program(accel[1], fidelity=fidelity) > 0
    # tests/test_program.py: the section 4.7 engine is one closed form at
    # both fidelities; compute-only programs cost their compute
    assert m.cost_program(accel[0], fidelity="sim") == pytest.approx(
        m.cost_program(accel[0], fidelity="analytic"), rel=1e-12)
    auto = m.cost_program(tprogram.bsp_step(64, 0.0, "allreduce", 256),
                          fidelity="analytic")
    assert auto <= accel_cost_us(256, 64, m.params) * 1e-6 + 1e-12
    for fidelity in ("analytic", "sim"):
        assert m.cost_program(tprogram.bsp_step(8, 300.0),
                              fidelity=fidelity) == pytest.approx(
                                  300e-6, rel=1e-9)


@pytest.mark.parametrize("p", [8, 64])
def test_plan_is_oneshot_below_derived_eager_threshold(p):
    planner = CommPolicy().planner
    thr = planner.eager_threshold_bytes(p)
    assert 1 < thr < 1 << 31
    below = planner.plan("allreduce", max(1, thr // 2), (p,))
    above = planner.plan("allreduce", 4 * thr, (p,))
    assert below.schedule == "oneshot", below
    assert above.schedule != "oneshot", above


def test_plan_cache_hits_and_determinism():
    pol = CommPolicy()
    a = pol.planner.plan("grad_sync", 1 << 20, (16, 4))
    misses = pol.planner.cache_info()["misses"]
    b = pol.planner.plan("grad_sync", 1 << 20, (16, 4))
    assert b is a
    assert pol.planner.cache_info()["misses"] == misses
    assert pol.planner.cache_info()["hits"] >= 1
    c = CommPolicy().planner.plan("grad_sync", 1 << 20, (16, 4))
    assert (c.schedule, c.cost_s, c.costs) == (a.schedule, a.cost_s, a.costs)


def test_grad_sync_plan_regimes():
    plan_bucket_strategy = tgrad_sync.plan_bucket_strategy
    pol = CommPolicy()
    assert plan_bucket_strategy(pol, 256, (16, 4)) == "flat"
    assert plan_bucket_strategy(pol, 64 << 20, (16, 4)) == "hierarchical"
    assert "compressed" not in [k for k, _ in pol.plan_bucket(
        64 << 20, 16, 4).costs]
    lossy = plan_bucket_strategy(pol, 64 << 20, (16, 4), allow_lossy=True)
    assert lossy == "compressed"
    assert plan_bucket_strategy(pol, 64 << 20, (16,)) == "flat"
    plan = pol.plan_bucket(64 << 20, 16, 4)
    assert plan.cost_s < plan.cost_of("flat") / 2
    wide = CommPolicy().planner.plan("grad_sync", 64 << 20, (2, 512),
                                     allow_lossy=True)
    assert wide.cost_of("compressed") >= wide.cost_of("hierarchical")


def test_commpolicy_facade_numbers_unchanged():
    pol = CommPolicy()
    for p in (2, 4, 16, 256):
        lo, hi = 1, 1 << 32
        while lo < hi:
            mid = (lo + hi) // 2
            oneshot = pol.alpha_s + (p - 1) * mid / pol.ici_bw
            ring = 2 * (p - 1) * pol.alpha_s + \
                2 * (p - 1) / p * mid / pol.ici_bw
            if oneshot <= ring:
                lo = mid + 1
            else:
                hi = mid
        assert pol.eager_threshold_bytes(p) == lo
        if p > 1:
            alpha_total = 2 * (p - 1) * pol.alpha_s
            wire_per_byte = 2 * (p - 1) / p / pol.ici_bw
            assert pol.bucket_bytes(p) == \
                int(alpha_total / pol.alpha_amortization / wire_per_byte)


def test_balanced_grid3():
    assert sorted(tprogram.balanced_grid3(8)) == [2, 2, 2]
    assert sorted(tprogram.balanced_grid3(512)) == [8, 8, 8]
    px, py, pz = tprogram.balanced_grid3(2)
    assert px * py * pz == 2


def test_validate_rejects_out_of_range_peer():
    with pytest.raises(tprogram.ProgramError, match="outside"):
        tprogram.Program(((tprogram.Isend(3, 8),),)).validate()


def test_tpu_machine_rejects_accel_programs():
    # tests/test_program.py::test_accel_collective_costs_at_both_fidelities,
    # TpuMachine half: no NI accelerator on the TPU target
    prog = tprogram.bsp_step(8, 0.0, "allreduce", 4096, coll_algo="accel")
    with pytest.raises(ValueError, match="accelerator"):
        TpuMachine().cost_program(prog)


def test_tpu_machine_costs_programs():
    tpu = TpuMachine()
    prog = tprogram.bsp_step(16, 50.0, "allreduce", 1 << 20)
    cost = tpu.cost_program(prog)
    assert cost > 50e-6
    from repro_torch.core.exanet.schedules import RingAllreduce
    ring = tpu.cost_s(RingAllreduce(), 16, 1 << 20)
    assert cost <= 50e-6 + ring + 1e-12
