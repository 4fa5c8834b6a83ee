"""The port's ExaNet event engine against the reference's, on the same inputs.

``repro_torch.core.exanet`` keeps copies of the reference's topology,
faults, event engine, network and MPI layer: both sides run the same float
operations, so every figure is held equal to the reference's exactly. Then
the reference's own assertions, at their tolerances, on the port's figures:
the paper-validation anchors that the event engine alone gives (Tables 1
and 2, the section 6.1 microbenchmarks, broadcast, software allreduce and
the section 4.7 accelerator), the routing invariants of the torus and the
fault model (``tests/test_exanet_paper_validation.py``,
``tests/test_exanet_routing.py``, ``tests/test_fault_engine.py``). The
studies built on the engine (``apps``, ``interference``, ``ip_overlay``)
are held against the reference's in ``tests/test_torch_exanet_apps.py``.
Every random draw comes from a fixed seed.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest

from repro.core import program as jprogram
from repro.core.exanet import allreduce_accel as jaccel
from repro.core.exanet import faults as jfaults
from repro.core.exanet import params as jparams
from repro.core.exanet import schedules as jschedules
from repro.core.exanet.mpi import ExanetMPI as JExanetMPI
from repro.core.exanet.params import DEFAULT as JDEFAULT
from repro.core.exanet.topology import Topology as JTopology
from repro.core.machine import ExanetMachine as JExanetMachine
from repro_torch.core import program as tprogram
from repro_torch.core.exanet import allreduce_accel as taccel
from repro_torch.core.exanet import faults as tfaults
from repro_torch.core.exanet import params as tparams
from repro_torch.core.exanet import schedules as tschedules
from repro_torch.core.exanet.mpi import ExanetMPI
from repro_torch.core.exanet.params import DEFAULT
from repro_torch.core.exanet.topology import Topology
from repro_torch.core.machine import ExanetMachine

SIDES = {
    "reference": types.SimpleNamespace(
        MPI=JExanetMPI, Topology=JTopology, DEFAULT=JDEFAULT, faults=jfaults,
        accel=jaccel, program=jprogram, params=jparams,
        schedules=jschedules),
    "port": types.SimpleNamespace(
        MPI=ExanetMPI, Topology=Topology, DEFAULT=DEFAULT, faults=tfaults,
        accel=taccel, program=tprogram, params=tparams,
        schedules=tschedules),
}
RTOL = 1e-9


def _plain(x):
    """A value with every dataclass of either package turned into tuples,
    so that figures of the two packages compare with ``==``."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, dataclasses.astuple(x))
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def both(fn):
    """``fn`` on the reference's namespace and on the port's: the two
    results must be equal exactly; the port's is returned."""
    ref, got = fn(SIDES["reference"]), fn(SIDES["port"])
    assert _plain(got) == _plain(ref), (got, ref)
    return got


@pytest.fixture(scope="module")
def mpi():
    return {s: ns.MPI() for s, ns in SIDES.items()}


@pytest.fixture(scope="module")
def mpi1():  # one rank per MPSoC (section 6.1.5 accelerator comparisons)
    return {s: ns.MPI(ranks_per_mpsoc=1) for s, ns in SIDES.items()}


@pytest.fixture(scope="module")
def topo():
    return {s: ns.Topology() for s, ns in SIDES.items()}


def _side(ns) -> str:
    return "port" if ns is SIDES["port"] else "reference"


# ------------------------------------------------------------------ Table 2
TABLE2 = {  # path name -> (paper us, tolerance)
    "intra_fpga": (1.17, 0.02),
    "intra_qfdb_sh": (1.293, 0.05),
    "mezz_sh": (1.579, 0.05),
    "mezz_mh(2)": (2.0, 0.20),
    "mezz_mh(3)": (2.111, 0.20),
    "inter_mezz(3,1,2)": (2.555, 0.08),
}


@pytest.mark.parametrize("name", sorted(TABLE2))
def test_osu_latency_0B_paths(name, mpi, topo):
    def lat(ns):
        t = topo[_side(ns)]
        src, dst = t.table1_paths()[name]
        return mpi[_side(ns)].net.mpi_latency(0, t.route(src, dst))
    model = both(lat)
    paper, tol = TABLE2[name]
    assert abs(model - paper) / paper <= tol, (name, model, paper)


def test_path_structure_table1(topo):
    paths = both(lambda ns: {k: topo[_side(ns)].route(*v) for k, v in
                             topo[_side(ns)].table1_paths().items()})
    p = paths["intra_qfdb_sh"]
    assert p.n_intra_qfdb_links == 1 and p.n_mezz_links == 0
    p = paths["mezz_sh"]
    assert p.n_mezz_links == 1 and p.n_intra_qfdb_links == 0
    p = paths["mezz_mh(3)"]
    assert p.n_mezz_links == 1 and p.n_intra_qfdb_links == 2
    p = paths["inter_mezz(3,1,2)"]
    assert p.n_mezz_links == 4 and p.n_intra_qfdb_links == 2
    assert p.n_routers == 5


def test_rendezvous_64B_and_4MB_dma_rate(mpi, topo):
    def figs(ns):
        path = topo[_side(ns)].route(0, ns.DEFAULT.cores_per_mpsoc)
        net = mpi[_side(ns)].net
        return (net.mpi_latency(64, path), net.mpi_latency(4 << 20, path),
                net.rdma_single_stream_bw_gbps(path))
    l64, l4m, bw = both(figs)
    assert abs(l64 - 5.157) / 5.157 < 0.05
    assert abs(l4m - 2689.4) / 2689.4 < 0.02
    assert abs(bw - 12.475) / 12.475 < 0.02


def test_osu_bw_link_utilization(mpi):
    """Section 6.1.2: 13 Gb/s on a 16G link (81.9%); 6.42 Gb/s on a 10G
    link (64.3%)."""
    def bws(ns):
        m, c = mpi[_side(ns)], ns.DEFAULT.cores_per_mpsoc
        return (m.osu_bw(4 << 20, 0, c),
                m.osu_bw(4 << 20, 0, c * ns.DEFAULT.fpgas_per_qfdb))
    bw16, bw10 = both(bws)
    assert abs(bw16 - 13.0) < 0.1
    assert abs(bw16 / 16.0 - 0.819) < 0.01
    assert abs(bw10 - 6.42) < 0.1
    assert abs(bw10 / 10.0 - 0.643) < 0.01


def test_osu_bibw_deviations(mpi):
    def devs(ns):
        m = mpi[_side(ns)]
        return [1.0 - m.osu_bibw(s, 0, 4) / (2 * m.osu_bw(s, 0, 4))
                for s in (1 << 20, 4096, 64)]
    d1m, d4k, small = both(devs)
    assert abs(d1m - 0.059) < 0.02
    assert abs(d4k - 0.183) < 0.02
    assert 0.3 <= small <= 0.45


@pytest.mark.parametrize("size", [0, 1, 32, 33, 4096, 16384, 1 << 20])
def test_osu_latency_every_table1_path(size, mpi, topo):
    """Beyond the paper's rows: every named path at the eager/rendez-vous
    and RDMA-block edges, and the OSU ping-pong entry point."""
    def lats(ns):
        t, m = topo[_side(ns)], mpi[_side(ns)]
        return ({k: m.net.mpi_latency(size, t.route(*v))
                 for k, v in t.table1_paths().items()},
                m.osu_latency(size, 0, 4), m.osu_latency(size))
    both(lats)


# --------------------------------------------------------- section 6.1.4 bcast
@pytest.mark.parametrize("size,n", [(1, 4), (1, 512), (4096, 512),
                                    (512 * 1024, 4), (1 << 20, 64),
                                    (2 << 20, 64)])
def test_bcast_results_equal_reference(size, n, mpi):
    both(lambda ns: mpi[_side(ns)].bcast(size, n))


def test_bcast_paper_anchors(mpi):
    m = mpi["port"]
    r = m.bcast(1, 4)
    assert abs(r.observed_us - 1.93) / 1.93 < 0.10
    assert 0.15 <= r.deviation <= 0.30
    r512 = m.bcast(1, 512)
    assert r512.steps == {"mpsoc": 2, "qfdb": 2, "mezzanine": 5}
    assert r512.deviation <= 0.15
    assert abs(m.bcast(4096, 512).deviation) <= 0.12
    lat = [m.bcast(1, n).observed_us for n in (4, 16, 64, 256, 512)]
    assert all(b > a for a, b in zip(lat, lat[1:]))
    assert 0.2 <= m.bcast(512 * 1024, 4).deviation <= 0.4
    a = m.bcast(1 << 20, 64).observed_us
    b = m.bcast(2 << 20, 64).observed_us
    assert 1.8 <= b / a <= 2.2


# ------------------------------------------------ section 6.1.3/5 allreduce
def test_allreduce_sw_4ranks(mpi):
    s4, s64 = both(lambda ns: (mpi[_side(ns)].allreduce_sw(4, 4),
                               mpi[_side(ns)].allreduce_sw(64, 4)))
    assert abs(s4 - 5.34) / 5.34 < 0.15
    assert abs(s64 - 33.62) / 33.62 < 0.20


def test_allreduce_sw_scaling(mpi1):
    s16, s128 = both(lambda ns: (mpi1[_side(ns)].allreduce_sw(256, 16),
                                 mpi1[_side(ns)].allreduce_sw(256, 128)))
    assert abs(s16 - 39.7) / 39.7 < 0.20
    assert abs(s128 - 76.9) / 76.9 < 0.15
    assert 1.6 <= s128 / s16 <= 2.2


@pytest.mark.parametrize("algo", ["recursive_doubling", "ring",
                                  "rabenseifner", "oneshot", "auto"])
def test_allreduce_algorithms_equal_reference(algo, mpi1):
    both(lambda ns: [mpi1[_side(ns)].allreduce(s, n, algo)
                     for n in (16, 64) for s in (4, 256, 4096, 65536)])


def test_accel_allreduce_anchors():
    a = both(lambda ns: [ns.accel.accel_allreduce_latency(s, n)
                         for s, n in ((256, 16), (512, 16), (1024, 16),
                                      (256, 128))])
    assert abs(a[0] - 6.79) < 0.01
    assert abs(a[1] - 13.38) / 13.38 < 0.05
    assert abs(a[2] - 26.11) / 26.11 < 0.05
    assert abs(a[3] - 9.61) < 0.01


def test_accel_allreduce_improvement(mpi1):
    """Section 6.1.5 / abstract: up to 83.4/86.2/87.1/87.9% for 16/32/64/128
    ranks ('up to 88%')."""
    paper = {16: 0.834, 32: 0.862, 64: 0.871, 128: 0.879}

    def best(ns):
        m = mpi1[_side(ns)]
        return {n: max(1 - ns.accel.accel_allreduce_latency(s, n)
                       / m.allreduce_sw(s, n)
                       for s in (4, 64, 256, 1024, 4096)) for n in paper}
    got = both(best)
    for n, target in paper.items():
        assert abs(got[n] - target) < 0.04, (n, got[n], target)
    hw16 = taccel.accel_allreduce_latency(256, 16)
    hw128 = taccel.accel_allreduce_latency(256, 128)
    assert hw128 / hw16 < 1.5


# ------------------------------------------------------- the event engine
@pytest.mark.parametrize("rpm", [None, 1])
def test_trace_events_and_utilization_equal_reference(rpm):
    """The interpreter with tracing on: every send's TraceEvent and the
    engine's occupancy equal the reference's."""
    def run(ns):
        m = ns.MPI(ranks_per_mpsoc=rpm, trace=True)
        res = m.allreduce_sw(4096, 16)
        b = m.bcast(65536, 16)
        eng = m.net.engine
        return (res, b, list(m.net.trace),
                sorted(eng.utilization(b.observed_us).items()))
    _, _, trace, util = both(run)
    assert trace and util


def test_schedule_results_equal_reference_at_scale():
    """A 1,024-rank broadcast on a scaled torus, interpreted and compiled."""
    def run(ns):
        sched = ns.schedules.BinomialBroadcast()
        m = ns.MPI(ns.params.scaled_params(4096), ranks_per_mpsoc=1)
        return [m.run_schedule(sched, 4096, 1024, backend=b)
                for b in ("interp", "compiled")]
    a, b = both(run)
    assert b.latency_us == pytest.approx(a.latency_us, rel=RTOL)


# ----------------------------------------------------------------- routing
def _sample_pairs(topo, stride=37):
    n = topo.n_cores
    pairs = []
    for i, a in enumerate(range(0, n, stride)):
        b = (a * 7 + i * 113 + 5) % n
        pairs.append((a, b))
    pairs.extend(topo.table1_paths().values())
    return pairs


def test_routes_equal_reference(topo):
    routes = both(lambda ns: [topo[_side(ns)].route(a, b) for a, b in
                              _sample_pairs(topo[_side(ns)], stride=5)])
    assert len(routes) > 100


def test_routing_invariants(topo):
    """tests/test_exanet_routing.py on the port's torus: hop bound, reverse
    symmetry, a contiguous link chain, Table 1 classes."""
    t = topo["port"]
    bound = t.qfdbs_per_mezz // 2 + 4 // 2 + 2 // 2
    for a, b in _sample_pairs(t):
        p, rev = t.route(a, b), t.route(b, a)
        assert p.n_mezz_links <= bound, (a, b)
        assert p.n_mezz_links == rev.n_mezz_links, (a, b)
        assert p.n_intra_qfdb_links == rev.n_intra_qfdb_links, (a, b)
        assert p.n_routers == rev.n_routers, (a, b)
        assert len(p.links) == len(rev.links), (a, b)
        cur = t.core_to_mpsoc(a)
        for link in p.links:
            assert link.src_mpsoc == cur, (a, b, link)
            cur = link.dst_mpsoc
        assert cur == t.core_to_mpsoc(b), (a, b)
    expected_kind = {
        "intra_fpga": "intra_fpga", "intra_qfdb_sh": "intra_qfdb_sh",
        "mezz_sh": "mezz_sh", "mezz_mh(2)": "mezz_mh(2)",
        "mezz_mh(3)": "mezz_mh(3)", "inter_mezz(3,1,2)": "inter_mezz(4,2)",
    }
    for name, (src, dst) in t.table1_paths().items():
        assert t.route(src, dst).kind == expected_kind[name], name


def test_route_cache_consistency_and_eviction():
    cached, uncached = Topology(), Topology(route_cache_size=0)
    pairs = _sample_pairs(cached)
    for a, b in pairs:
        assert cached.route(a, b) == uncached.route(a, b), (a, b)
    misses = cached.route_misses
    for a, b in pairs:
        cached.route(a, b)
    assert cached.route_misses == misses
    assert cached.route_hits >= len(pairs)
    assert uncached.route_hits == 0 and uncached.route_misses == 0
    small = Topology(route_cache_size=8)
    for a in range(0, 64, 4):
        for b in range(1, 65, 4):
            small.route(a % small.n_cores, b % small.n_cores)
    assert len(small._route_cache) <= 8


def test_route_bounds_checked():
    with pytest.raises(ValueError, match="scaled_params"):
        Topology().route(0, DEFAULT.n_cores)


# ------------------------------------------------------------------ faults
def test_fault_spec_canonicalization_and_validation():
    def specs(ns):
        F = ns.faults.FaultSpec
        a = F(dead_links=[("mezz", 4, 0)],
              slow_links={("intra_qfdb", 2, 1): 3.0})
        b = F(dead_links=[("mezz", 0, 4)],
              slow_links={("intra_qfdb", 1, 2): 3.0})
        s = F(slow_links={("mezz", 0, 4): 2.0},
              lossy_links={("mezz", 0, 4): 0.5})
        return (a.signature(), b.signature(), ns.faults.HEALTHY.signature(),
                s.link_slow("mezz", 0, 4), s.degrades_structure,
                a.degrades_structure)
    sig_a, sig_b, healthy, slow, s_struct, a_struct = both(specs)
    assert sig_a == sig_b and healthy == "healthy"
    assert slow == pytest.approx(4.0) and not s_struct and a_struct
    F = tfaults.FaultSpec
    a = F(dead_links=[("mezz", 4, 0)])
    assert a == F(dead_links=[("mezz", 0, 4)])
    assert hash(a) == hash(F(dead_links=[("mezz", 0, 4)]))
    assert a.is_dead_link("mezz", 4, 0) and a.is_dead_link("mezz", 0, 4)
    with pytest.raises(ValueError):
        F(slow_links={("mezz", 0, 4): 0.5})
    with pytest.raises(ValueError):
        F(lossy_links={("mezz", 0, 4): 1.0})


def test_reroutes_and_relays_equal_reference():
    def routes(ns):
        F, T = ns.faults.FaultSpec, ns.Topology
        spec = F(dead_links=[("mezz", 0, 4)])
        relay = F(dead_links=[("intra_qfdb", 0, 1)])
        relay_down = F(dead_links=[("intra_qfdb", 0, 1)], dead_mpsocs=[2])
        return (T(ns.DEFAULT, faults=spec).route(0, 16),
                T(ns.DEFAULT).route(0, 16),
                T(ns.DEFAULT, faults=relay).route(0, 4),
                T(ns.DEFAULT, faults=relay_down).route(0, 4))
    rerouted, healthy, relay, relay_down = both(routes)
    spec = tfaults.FaultSpec(dead_links=[("mezz", 0, 4)])
    for link in rerouted.links:
        assert not spec.is_dead_link(link.kind, link.src_mpsoc,
                                     link.dst_mpsoc)
    assert rerouted.links != healthy.links
    assert [(x.src_mpsoc, x.dst_mpsoc) for x in relay.links] == \
        [(0, 2), (2, 1)]
    assert [(x.src_mpsoc, x.dst_mpsoc) for x in relay_down.links] == \
        [(0, 3), (3, 1)]


def test_unroutable_cuts_are_diagnosed():
    F, Unroutable = tfaults.FaultSpec, tfaults.UnroutableError
    cut = F(dead_links=[("intra_qfdb", 0, 1)], dead_mpsocs=[2, 3])
    with pytest.raises(Unroutable):
        Topology(DEFAULT, faults=cut).route(0, 4)
    ring_cut = F(dead_links=[("mezz", 0, 4), ("mezz", 0, 12)])
    with pytest.raises(Unroutable) as e:
        Topology(DEFAULT, faults=ring_cut).route(0, 32)
    assert str(e.value)
    with pytest.raises(Unroutable, match="dead"):
        Topology(DEFAULT, faults=F(dead_mpsocs=[1])).route(0, 4)


def _mezz_dims(topo, path):
    dims = []
    for link in path.links:
        if link.kind != "mezz":
            continue
        a = topo.qfdb_coords(link.src_mpsoc // topo.fpgas_per_qfdb)
        b = topo.qfdb_coords(link.dst_mpsoc // topo.fpgas_per_qfdb)
        dims.append(next(i for i in range(3) if a[i] != b[i]))
    return dims


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_fault_sets_at_512_ranks(seed):
    """Seeded fault sets on the 512-core prototype: the sampled spec, every
    route and every cut equal the reference's; each route is fault-free and
    dimension-ordered."""
    def sweep(ns):
        rng = np.random.default_rng(seed)
        spec = ns.faults.sample_fault_spec(
            rng, ns.Topology(ns.DEFAULT), n_dead_links=3, n_dead_mpsocs=2,
            n_slow_links=2)
        topo = ns.Topology(ns.DEFAULT, faults=spec)
        alive = [c for c in range(256, 512)
                 if not spec.is_dead_mpsoc(c // ns.DEFAULT.cores_per_mpsoc)]
        out = []
        for i, j in rng.choice(len(alive), size=(60, 2)):
            if i == j:
                continue
            try:
                out.append(topo.route(alive[i], alive[j]))
            except ns.faults.UnroutableError as e:
                out.append(("cut", str(e)))
        return spec, out
    spec, out = both(sweep)
    routes = [p for p in out if not isinstance(p, tuple)]
    assert routes, "every pair cut: degenerate sample"
    for path in routes:
        for link in path.links:
            assert not spec.is_dead_link(link.kind, link.src_mpsoc,
                                         link.dst_mpsoc)
            assert not spec.is_dead_mpsoc(link.src_mpsoc)
            assert not spec.is_dead_mpsoc(link.dst_mpsoc)
        dims = _mezz_dims(Topology(DEFAULT), path)
        assert dims == sorted(dims), dims


def test_route_cache_epoch_and_clear():
    topo = Topology(DEFAULT)
    topo.route(0, 16)
    info = topo.route_cache_info()
    assert info["size"] >= 1 and info["fault_epoch"] == 0
    topo.set_faults(tfaults.FaultSpec(dead_links=[("mezz", 0, 4)]))
    info = topo.route_cache_info()
    assert info["size"] == 0 and info["fault_epoch"] == 1
    for link in topo.route(0, 16).links:
        assert (link.kind, *sorted((link.src_mpsoc, link.dst_mpsoc))) != \
            ("mezz", 0, 4)
    topo.route_cache_clear()
    assert topo.route_cache_info()["size"] == 0


def _rel(a, b) -> float:
    rel = abs(b.latency_us - a.latency_us) / max(abs(a.latency_us), 1e-12)
    for x, y in zip(a.clocks, b.clocks):
        rel = max(rel, abs(y - x) / max(abs(x), 1e-12))
    return rel


def test_degraded_compiled_matches_interp_and_reference():
    def run(ns):
        spec = ns.faults.FaultSpec(
            dead_links=[("intra_qfdb", 0, 1)],
            slow_links={("mezz", 0, 4): 3.0},
            lossy_links={("mezz", 4, 8): 0.2},
            link_extra_latency_us={("intra_qfdb", 8, 9): 10.0})
        m = ns.MPI(faults=spec)
        prog = ns.program.cg_iteration(64, 32768, 120.0,
                                       coll_algo="recursive_doubling")
        return (m.run_program(prog, backend="interp"),
                m.run_program(prog, backend="compiled"),
                ns.MPI().run_program(prog, backend="compiled"))
    a, b, healthy = both(run)
    assert _rel(a, b) <= RTOL
    assert b.latency_us > healthy.latency_us


def test_network_static_degradation_slows_path():
    def run(ns):
        F = ns.faults.FaultSpec
        slow = F(slow_links={("intra_qfdb", 0, 1): 3.0},
                 link_extra_latency_us={("intra_qfdb", 0, 1): 5.0})
        h, d = ns.MPI(), ns.MPI(faults=slow, cache=False)
        ph, pd = h.topo.route(0, 4), d.topo.route(0, 4)
        return ([x.kind for x in ph.links], [x.kind for x in pd.links],
                h.net.rdv_latency(65536, ph), d.net.rdv_latency(65536, pd))
    kinds_h, kinds_d, lat_h, lat_d = both(run)
    assert kinds_h == kinds_d
    assert lat_d > lat_h + 10.0


def test_batched_link_axes_match_static_twins():
    """N non-structural fault sets as batch columns == N statically
    degraded machines, column by column, and the columns equal the
    reference's."""
    def run(ns):
        base = ns.MPI()
        rng = np.random.default_rng(3)
        specs = [ns.faults.sample_fault_spec(
            rng, base.topo, n_slow_links=2, n_lossy_links=1,
            extra_latency_us=4.0) for _ in range(4)]
        prog = ns.program.halo3d(32, 65536, compute_us=40.0)
        axes = ns.faults.batch_fault_axes(specs, prog)
        got = base.run_program_scenarios(prog, **axes, check=4, rtol=RTOL)
        twins = [ns.MPI(faults=s, cache=False).run_program(
            prog, backend="compiled") for s in specs]
        return got, twins
    got, twins = both(run)
    for j, (x, y) in enumerate(zip(twins, got)):
        assert _rel(x, y) <= RTOL, j


def test_batch_fault_axes_validation_and_slow_ranks():
    F = tfaults.FaultSpec
    with pytest.raises(ValueError, match="structural"):
        tfaults.batch_fault_axes([F(dead_links=[("mezz", 0, 4)])])
    slow = F(slow_ranks={1: 2.0})
    with pytest.raises(ValueError, match="slow_ranks"):
        tfaults.batch_fault_axes([slow])
    prog = tprogram.Program((tuple([tprogram.Compute(us=1.0)] * 3), ()))
    axes = tfaults.batch_fault_axes([slow, tfaults.HEALTHY], prog)
    assert axes["compute_scale"].shape == (3, 2)
    assert np.all(axes["compute_scale"][:, 1] == 1.0)

    def run(ns):
        prog = ns.program.halo3d(16, 16384, compute_us=200.0)
        spec = ns.faults.FaultSpec(slow_ranks={3: 4.0})
        axes = ns.faults.batch_fault_axes([ns.faults.HEALTHY, spec], prog)
        return ns.MPI().run_program_scenarios(prog, **axes, check=2,
                                              rtol=RTOL)
    res = both(run)
    assert res[1].latency_us > res[0].latency_us
    assert res[1].clocks[3] > res[0].clocks[3] * 2.0


def test_machine_degraded_variants():
    m = ExanetMachine()
    assert m.degraded(tfaults.HEALTHY) is m and m.degraded(None) is m
    spec = tfaults.FaultSpec(dead_links=[("mezz", 0, 4)])
    d = m.degraded(spec)
    assert d is m.degraded(spec)
    assert spec.signature() in d.name and d.name != m.name
    assert d.name == JExanetMachine().degraded(
        jfaults.FaultSpec(dead_links=[("mezz", 0, 4)])).name
    assert d.placement == m.placement
    assert d.mpi.faults == spec
    assert d._mpi_for(1024).faults == spec
