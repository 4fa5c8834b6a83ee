"""The port's serving simulator against the reference's, on the same inputs.

``repro_torch.serve.sim`` (the serve-step Program emitter and its batched
step table) and ``repro_torch.serve.traffic`` (the open-loop replay) are
copies of the reference's modules. Both sides run the same float
operations, so the step table, a replay through it and the goodput knee are
held equal to the reference's exactly on seeded inputs; the torch scan lane
on the CPU (``TorchScanEngine(device="cpu")``) builds the table within 1e-9
of the numpy lane. Then the cases of ``tests/test_serve_sim.py``, on the
port: the scenario-axis seams, the emitter, the table against the per-step
lane and the replay's queueing arithmetic. Every random draw comes from a
fixed seed.
"""

from __future__ import annotations

import numpy as np
import pytest

from repro.serve import traffic as jtraffic
from repro.serve.sim import ServeSim as JServeSim
from repro.serve.sim import ServeSimSpec as JServeSimSpec
from repro_torch.core.exanet.mpi import ExanetMPI
from repro_torch.core.exanet.params import DEFAULT
from repro_torch.core.exanet.scan_engine import TorchScanEngine
from repro_torch.core.program import (Collective, Compute, Irecv, Isend,
                                      Program, ProgramError, Wait)
from repro_torch.serve import traffic
from repro_torch.serve.sim import ServeSim, ServeSimSpec, StepTable

TORCH_CPU = TorchScanEngine(device="cpu")
RTOL = 1e-9
#: the reference serve sweep's load grid (benchmarks/serve_sweep.py)
LOAD_FRACS = (0.3, 0.5, 0.7, 0.85, 1.0, 1.2)


@pytest.fixture(scope="module")
def mpi():
    return ExanetMPI(DEFAULT)


def small_kw(**kw) -> dict:
    base = dict(arch="exanest-lm-100m", nranks=8, slots=3, window=128,
                prefill_chunk=32, kv_buckets=2, arrival_skew_us=1.0)
    base.update(kw)
    return base


def small_spec(**kw) -> ServeSimSpec:
    return ServeSimSpec(**small_kw(**kw))


def _table_fields(tab) -> tuple:
    return (tab.states, tab.mc, tab.us.tolist(), tab.index,
            tab.compute_scale.tolist(), tab.site_scale.tolist(),
            tab.t0.tolist())


def knee_of(pkg, spec, tab, *, n_requests, seed, prompt_mean=256,
            out_mean=24):
    """The reference serve sweep's knee on one table: the backlog's
    capacity, then seeded Poisson replays at LOAD_FRACS of it, goodput
    per load and ``knee_point`` at 0.95. Returns (capacity, replays, knee).
    """
    n = 8 * spec.slots
    kw = dict(slots=spec.slots, prefill_chunk=spec.prefill_chunk,
              window=spec.window, kv_bucket=spec.kv_bucket,
              step_time=tab.lookup)
    backlog = pkg.replay(pkg.trace_workload(
        np.zeros(n), np.full(n, prompt_mean, dtype=np.int64),
        np.full(n, out_mean, dtype=np.int64)), **kw)
    cap = n / float(backlog.done_us.max()) * 1e6
    offered, goodput, runs = [], [], []
    for f in LOAD_FRACS:
        wl = pkg.poisson_workload(f * cap, n_requests, seed,
                                  prompt_tokens=prompt_mean,
                                  out_tokens=out_mean)
        res = pkg.replay(wl, **kw)
        span = res.done_us.max() - res.arrive_us.min()
        offered.append(round(f * cap, 3))
        goodput.append(round(res.latency_us.size / span * 1e6, 3))
        runs.append(res)
    return cap, runs, pkg.knee_point(offered, goodput, 0.95)


def _replay_fields(res) -> tuple:
    return (res.arrive_us.tolist(), res.admit_us.tolist(),
            res.first_us.tolist(), res.done_us.tolist(), res.n_steps,
            res.sim_us, res.tokens_out)


@pytest.fixture(scope="module")
def deepseek_tables():
    """deepseek-7b on 16 ranks with the spec's defaults, one table per
    package from the same seed."""
    kw = dict(arch="deepseek-7b", nranks=16)
    port, ref = ServeSim(ServeSimSpec(**kw)), JServeSim(JServeSimSpec(**kw))
    return (port, port.build_table(mc=3, rng=16, check=2),
            ref, ref.build_table(mc=3, rng=16))


# ------------------------------------------------ equal to the reference
@pytest.mark.parametrize("kw", [small_kw(), small_kw(nranks=32,
                                                     alltoall_max_ranks=16),
                                small_kw(compute_jitter=0.0, slots=2)],
                         ids=["alltoall", "allgather", "no_jitter"])
def test_step_table_equals_reference(kw):
    port, ref = ServeSim(ServeSimSpec(**kw)), JServeSim(JServeSimSpec(**kw))
    assert port.step_states() == ref.step_states()
    assert repr(port.base_program().rank_ops) == \
        repr(ref.base_program().rank_ops)
    got = port.build_table(mc=2, rng=5, check=2)
    want = ref.build_table(mc=2, rng=5)
    assert _table_fields(got) == _table_fields(want)
    for state in got.states[::5]:
        nd, npf, kvb = state
        kv = float(port.spec.kv_centers()[kvb])
        assert port.step_cost(nd, npf, kv) == ref.step_cost(nd, npf, kv)
        assert port.site_bytes(nd, npf, kv) == ref.site_bytes(nd, npf, kv)


def test_deepseek_table_replay_and_knee_equal_reference(deepseek_tables):
    port, tab, ref, jtab = deepseek_tables
    assert _table_fields(tab) == _table_fields(jtab)
    cap, runs, knee = knee_of(traffic, port.spec, tab, n_requests=80,
                              seed=16000)
    jcap, jruns, jknee = knee_of(jtraffic, ref.spec, jtab, n_requests=80,
                                 seed=16000)
    assert cap == jcap
    for a, b in zip(runs, jruns):
        assert _replay_fields(a) == _replay_fields(b)
        assert traffic.quantiles(a.latency_us) == \
            jtraffic.quantiles(b.latency_us)
        assert traffic.cdf_points(a.latency_us, 16) == \
            jtraffic.cdf_points(b.latency_us, 16)
    assert knee == jknee
    assert knee is not None


def test_torch_lane_table_matches_numpy(deepseek_tables):
    port, tab, _, _ = deepseek_tables
    calls = sum(TORCH_CPU.calls.values())
    got = port.build_table(mc=3, rng=16, engine=TORCH_CPU, check=2)
    assert sum(TORCH_CPU.calls.values()) > calls
    rel = np.abs(got.us - tab.us) / np.abs(tab.us)
    assert rel.max() <= RTOL
    _, _, knee = knee_of(traffic, port.spec, got, n_requests=80, seed=16000)
    _, _, want = knee_of(traffic, port.spec, tab, n_requests=80, seed=16000)
    assert knee == want


def test_package_loads_the_simulator_lazily():
    import repro_torch.serve as serve
    assert serve.ServeSim is ServeSim
    assert serve.StepTable is StepTable
    with pytest.raises(AttributeError):
        serve.NoSuchName


# ------------------------------ tests/test_serve_sim.py, on the port
def serve_like_program(nranks=8, us=5.0, act=4096, kv=1024) -> Program:
    ops = (Compute(us=us),
           Collective(op="allgather", nbytes=act,
                      algo="recursive_doubling"),
           Collective(op="alltoall", nbytes=kv, algo="pairwise"))
    return Program(tuple(ops for _ in range(nranks)))


def test_t0_interp_matches_compiled(mpi):
    prog = serve_like_program()
    t0 = np.random.default_rng(0).uniform(0.0, 3.0, 8)
    a = mpi.run_program(prog, backend="interp", t0=t0)
    b = mpi.run_program(prog, backend="compiled", t0=t0)
    assert abs(a.latency_us - b.latency_us) <= 1e-9 * abs(a.latency_us)
    for x, y in zip(a.clocks, b.clocks):
        assert abs(x - y) <= 1e-9 * max(abs(x), 1e-12)


def test_t0_scalar_shifts_everything(mpi):
    prog = serve_like_program()
    a = mpi.run_program(prog, backend="interp")
    b = mpi.run_program(prog, backend="interp", t0=7.5)
    assert b.latency_us == pytest.approx(a.latency_us + 7.5, rel=1e-12)


def test_t0_wrong_length_rejected(mpi):
    with pytest.raises((ValueError, ProgramError)):
        mpi.run_program(serve_like_program(), backend="interp",
                        t0=[1.0, 2.0])


def test_t0_on_p2p_program_agrees(mpi):
    ops = []
    for r in range(4):
        ops.append((Compute(us=2.0), Isend(dst=(r + 1) % 4, nbytes=512,
                                           tag=3),
                    Irecv(src=(r - 1) % 4, nbytes=512, tag=3), Wait()))
    prog = Program(tuple(ops))
    t0 = np.array([0.0, 0.4, 0.1, 0.3])
    a = mpi.run_program(prog, backend="interp", t0=t0)
    b = mpi.run_program(prog, backend="compiled", t0=t0)
    assert abs(a.latency_us - b.latency_us) <= 1e-9 * abs(a.latency_us)


def test_scenarios_site_scale_and_t0_checked(mpi):
    prog = serve_like_program()
    rng = np.random.default_rng(1)
    N = 10
    cs = rng.uniform(0.5, 2.0, (8, N))
    ss = rng.uniform(0.25, 3.0, (2, N))
    t0 = rng.uniform(0.0, 4.0, (8, N))
    res = mpi.run_program_scenarios(prog, compute_scale=cs, site_scale=ss,
                                    t0=t0, check=N)
    assert len(res) == N
    assert all(r.latency_us > 0 for r in res)


def test_scenarios_t0_only_sweep(mpi):
    prog = serve_like_program()
    t0 = np.random.default_rng(2).uniform(0.0, 5.0, (8, 6))
    res = mpi.run_program_scenarios(prog, t0=t0, check=6)
    assert len(res) == 6
    assert all(r.latency_us >= t0[:, i].max() for i, r in enumerate(res))


def test_scenarios_per_post_byte_scale(mpi):
    ops = []
    for r in range(4):
        ops.append((Compute(us=1.0), Isend(dst=(r + 1) % 4, nbytes=2048,
                                           tag=7),
                    Irecv(src=(r - 1) % 4, nbytes=2048, tag=7), Wait()))
    prog = Program(tuple(ops))
    chan = np.random.default_rng(3).uniform(0.3, 4.0, (4, 5))
    bs = np.empty((8, 5))
    for r in range(4):
        bs[2 * r] = chan[r]
        bs[2 * ((r + 1) % 4) + 1] = chan[r]
    res = mpi.run_program_scenarios(prog, byte_scale=bs, check=5)
    assert len(res) == 5


def test_scenarios_inconsistent_per_post_scale_rejected(mpi):
    ops = []
    for r in range(4):
        ops.append((Isend(dst=(r + 1) % 4, nbytes=2048, tag=7),
                    Irecv(src=(r - 1) % 4, nbytes=2048, tag=7), Wait()))
    prog = Program(tuple(ops))
    bs = np.random.default_rng(4).uniform(0.3, 4.0, (8, 3))
    with pytest.raises(ProgramError):
        mpi.run_program_scenarios(prog, byte_scale=bs)


def test_emitted_structure_is_state_invariant():
    sim = ServeSim(small_spec())
    key = None
    for (nd, npf, kvb) in sim.step_states():
        prog = sim.emit_step(nd, npf, float(sim.spec.kv_centers()[kvb]))
        k = prog.structure_key()
        assert key is None or k == key
        key = k


def test_kv_exchange_op_switches_at_rank_cap():
    assert ServeSim(small_spec()).kv_exchange_op() == \
        ("alltoall", "pairwise")
    sim = ServeSim(small_spec(nranks=256, alltoall_max_ranks=128))
    assert sim.kv_exchange_op() == ("allgather", "recursive_doubling")


def test_step_cost_monotone_in_load_and_kv():
    sim = ServeSim(small_spec())
    base = sim.rank_compute_us(1, 0, 16.0)
    assert sim.rank_compute_us(3, 0, 16.0) > base
    assert sim.rank_compute_us(1, 1, 16.0) > base
    assert sim.rank_compute_us(1, 0, 100.0) > base


def test_nonpow2_ranks_rejected():
    with pytest.raises(ValueError, match="power of two"):
        ServeSim(small_spec(nranks=6))


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_table_matches_per_step_lane(engine):
    eng = TORCH_CPU if engine == "torch" else engine
    sim = ServeSim(small_spec())
    tab = sim.build_table(mc=2, rng=0, engine=eng, check=4)
    assert tab.us.shape == (len(tab.states), 2)
    for state in tab.states[::3]:
        for j in range(tab.mc):
            batched = tab.us[tab.index[state], j]
            single = sim.step_time_single(tab, state, j, backend="interp")
            assert abs(batched - single) <= 1e-9 * abs(single), (state, j)


def test_table_lookup_rotates_draws():
    sim = ServeSim(small_spec())
    tab = sim.build_table(mc=2, rng=0)
    s = tab.states[0]
    assert tab.lookup(*s, step=0) == tab.us[tab.index[s], 0]
    assert tab.lookup(*s, step=3) == tab.us[tab.index[s], 1]


def test_replay_hand_computed_timeline():
    wl = traffic.trace_workload([0.0, 0.0, 0.0], [64, 64, 64], [3, 3, 3])
    res = traffic.replay(wl, slots=2, prefill_chunk=64, window=256,
                         kv_bucket=lambda kv: 0,
                         step_time=lambda nd, npf, kvb, i: 10.0)
    assert res.admit_us.tolist() == [0.0, 0.0, 30.0]
    assert res.first_us.tolist() == [10.0, 10.0, 40.0]
    assert res.done_us.tolist() == [30.0, 30.0, 60.0]
    assert res.n_steps == 6
    assert res.tokens_out == 9


def test_replay_idle_jumps_to_next_arrival():
    wl = traffic.trace_workload([1000.0], [32], [2])
    res = traffic.replay(wl, slots=2, prefill_chunk=32, window=64,
                         kv_bucket=lambda kv: 0,
                         step_time=lambda nd, npf, kvb, i: 5.0)
    assert res.admit_us[0] == 1000.0
    assert res.done_us[0] == 1010.0


def test_replay_window_truncates():
    wl = traffic.trace_workload([0.0], [8], [1000])
    res = traffic.replay(wl, slots=1, prefill_chunk=8, window=16,
                         kv_bucket=lambda kv: 0,
                         step_time=lambda nd, npf, kvb, i: 1.0)
    assert res.tokens_out == 9
    assert np.isfinite(res.done_us[0])


def test_open_loop_overload_diverges():
    wl_lo = traffic.poisson_workload(100.0, 60, 0, prompt_tokens=16,
                                     out_tokens=8)
    wl_hi = traffic.poisson_workload(10000.0, 60, 0, prompt_tokens=16,
                                     out_tokens=8)
    kw = dict(slots=2, prefill_chunk=16, window=64,
              kv_bucket=lambda kv: 0,
              step_time=lambda nd, npf, kvb, i: 100.0)
    lo = traffic.replay(wl_lo, **kw)
    hi = traffic.replay(wl_hi, **kw)
    assert np.quantile(hi.latency_us, 0.99) > \
        5 * np.quantile(lo.latency_us, 0.99)


def test_workload_validation():
    with pytest.raises(ValueError, match="sorted"):
        traffic.trace_workload([3.0, 1.0], [4, 4], [2, 2])
    with pytest.raises(ValueError, match=">= 1"):
        traffic.trace_workload([0.0], [0], [2])
    with pytest.raises(ValueError, match="length"):
        traffic.trace_workload([0.0], [4, 4], [2])


def test_quantiles_and_cdf():
    v = np.arange(1, 1001, dtype=float)
    q = traffic.quantiles(v)
    assert q["p50"] == pytest.approx(500.5)
    assert q["p999"] == pytest.approx(999.001)
    fr = [p[1] for p in traffic.cdf_points(v, 16)]
    assert fr == sorted(fr) and fr[-1] == 1.0


def test_knee_point():
    assert traffic.knee_point([10, 20, 40], [10, 19.5, 25]) == 20.0
    assert traffic.knee_point([10, 20], [5, 6]) is None


# ------------------------------- the serve phase's schedule, for calibration
@pytest.mark.parametrize("slots,window,lens,new", [
    (8, 64, (3, 9, 5, 1, 12, 7, 2, 8, 4, 6, 11), 5),
    (3, 16, (20, 2, 7, 9), 4),
    (4, 32, (1,) * 10, 1)])
def test_chip_smoke_serve_schedule_is_the_engines(slots, window, lens, new):
    """``chip_smoke.serve_schedule`` (the rows and contexts that the serve
    phase hands serve_step_calibration) replays ServeEngine's admission,
    batched prefill and per-slot decode calls: the same rows per call and
    contexts per row as the engine's own calls, windows wrapping."""
    import importlib.util
    import pathlib

    import torch

    from repro_torch.config import reduced
    from repro_torch.configs import get
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_schedule",
                                                  path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = reduced(get("exanest-lm-100m"))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(model, params, slots=slots, window=window,
                      device="cpu")
    rows, contexts = [], []
    step_slots = eng._step_slots

    def counted(live, toks):
        rows.append(len(live))
        contexts.extend(min(int(eng.pos[s]) + 1, window) for s in live)
        step_slots(live, toks)

    eng._step_slots = counted
    rng = np.random.default_rng(0)
    for n in lens:
        eng.submit(rng.integers(0, cfg.vocab_size, n).tolist(),
                   max_new_tokens=new)
    eng.run_until_idle(max_steps=3)
    eng.run_until_idle(max_steps=100000)
    assert smoke.serve_schedule(lens, new, slots, window) == (rows, contexts)
    assert len(rows) == eng.decode_calls
