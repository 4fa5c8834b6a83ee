"""The port's ExaNet studies against the reference's, on the same inputs.

``repro_torch.core.exanet`` keeps copies of the reference's three studies:
``apps`` (the section 6.2 applications and Table 3), ``interference`` (two
tenants on shared QFDBs) and ``ip_overlay`` (the section 5.3 IP overlay).
Both sides run the same float operations, so every figure is held equal to
the reference's exactly: Table 3 cell for cell, each app's weak and strong
evaluations, the overlay's closed forms, the merged two-tenant Program and
its interference curve. Then the reference's own assertions, at their
tolerances, on the port's figures (``tests/test_exanet_paper_validation.py``'s
apps and overlay cases, ``tests/test_fault_engine.py``'s interference and
overlay cases), and the scenario lane of one app iteration at 64 ranks on
the numpy lane and on ``TorchScanEngine(device="cpu")``. Every random draw
comes from a fixed seed.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

from repro.core.exanet import apps as japps
from repro.core.exanet import interference as jinterference
from repro.core.exanet import ip_overlay as jip_overlay
from repro.core.exanet.mpi import ExanetMPI as JExanetMPI
from repro.core.program import halo3d as jhalo3d
from repro_torch.core.exanet import apps, interference, ip_overlay
from repro_torch.core.exanet.mpi import ExanetMPI
from repro_torch.core.exanet.scan_engine import TorchScanEngine
from repro_torch.core.program import ProgramError, cg_iteration, halo3d

TORCH_CPU = TorchScanEngine(device="cpu")
ENGINES = {"numpy": "numpy", "torch": TORCH_CPU}
RTOL = 1e-9
APPS = sorted(apps.ALL_APPS)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        1e-12)))


@pytest.fixture(scope="module")
def tables():
    return {"port": apps.table3(), "reference": japps.table3()}


@pytest.fixture(scope="module")
def models():
    """One model per app and package, so their simulation caches are
    shared by the tests below."""
    return {name: (apps.ALL_APPS[name](), japps.ALL_APPS[name]())
            for name in APPS}


# ------------------------------------------------ equal to the reference
def test_table3_equals_reference_cell_for_cell(tables):
    got, want = tables["port"], tables["reference"]
    assert got == want
    assert apps.PAPER_TABLE3 == japps.PAPER_TABLE3


@pytest.mark.parametrize("app", APPS)
def test_app_evaluations_equal_reference(app, models):
    port, ref = models[app]
    for n in (2, 8, 64, 512):
        assert port.weak(n) == ref.weak(n), (app, "weak", n)
        assert port.strong(n) == ref.strong(n), (app, "strong", n)
    for mode in ("weak", "strong"):
        for n in (8, 64):
            a, b = port.emit_iteration(mode, n), ref.emit_iteration(mode, n)
            assert repr(a.rank_ops) == repr(b.rank_ops)


@pytest.mark.parametrize("pkt", [64, 1500, 9000, 65507])
def test_ip_overlay_figures_equal_reference(pkt):
    assert ip_overlay.overlay_throughput_gbps(pkt) == \
        jip_overlay.overlay_throughput_gbps(pkt)
    assert ip_overlay.baseline_throughput_gbps(pkt) == \
        jip_overlay.baseline_throughput_gbps(pkt)
    assert ip_overlay.overlay_vs_native_gap(pkt) == \
        jip_overlay.overlay_vs_native_gap(pkt)
    for mode in ("poll", "sleep"):
        assert ip_overlay.overlay_rtt(mode=mode) == \
            jip_overlay.overlay_rtt(mode=mode)


def _mix(pkg, halo, n_app, n_bg):
    a_ranks, b_ranks = pkg.interleave_qfdb(n_app, n_bg)
    return pkg.merge_tenants(halo(n_app, 65536, compute_us=50.0),
                             pkg.background_stream(n_bg, iters=8,
                                                   nbytes=131072),
                             a_ranks, b_ranks)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_interference_curve_equals_reference(engine):
    """The merged two-tenant Program, its byte-scale columns and the app's
    latency at each load: exact on the numpy lane, within 1e-9 on the
    torch lane."""
    loads = (0.0, 0.5, 1.0, 2.0, 4.0)
    mix = _mix(interference, halo3d, 16, 16)
    jmix = _mix(jinterference, jhalo3d, 16, 16)
    assert repr(mix.program.rank_ops) == repr(jmix.program.rank_ops)
    assert (mix.app_ranks, mix.bg_ranks) == (jmix.app_ranks, jmix.bg_ranks)
    np.testing.assert_array_equal(mix.bg_post_mask, jmix.bg_post_mask)
    bs = interference.neighbor_load_byte_scale(mix, loads)
    np.testing.assert_array_equal(
        bs, jinterference.neighbor_load_byte_scale(jmix, loads))
    got = ExanetMPI().run_program_scenarios(
        mix.program, byte_scale=bs, engine=ENGINES[engine], check=2,
        rtol=RTOL)
    want = JExanetMPI().run_program_scenarios(jmix.program, byte_scale=bs,
                                              engine="numpy")
    app_us = [mix.app_latency_us(r) for r in got]
    want_us = [jmix.app_latency_us(r) for r in want]
    if engine == "numpy":
        assert app_us == want_us
    assert _rel(app_us, want_us) <= RTOL
    assert max(_rel(g.clocks, w.clocks) for g, w in zip(got, want)) <= RTOL
    eff = [app_us[0] / t for t in app_us]
    assert all(b <= a + 1e-9 for a, b in zip(eff, eff[1:])), eff


def test_size_background_equals_reference():
    for args in ((1000.0, 4, 37.5), (10.0, 8, 100.0), (5.0, 3, 0.0)):
        assert interference.size_background(*args) == \
            jinterference.size_background(*args)


# ------------------------ tests/test_exanet_paper_validation.py, on the port
def test_apps_table3(tables):
    model = tables["port"]
    for app, modes in apps.PAPER_TABLE3.items():
        for mode, pts in modes.items():
            assert abs(model[app][mode][512] - pts[512]) <= 0.5, (app, mode)
            assert abs(model[app][mode][2] - pts[2]) <= 7.0, (app, mode)


@pytest.mark.parametrize("app", APPS)
def test_apps_efficiency_at_least_69pct(app, models):
    m = models[app][0]
    for n in (2, 8, 64, 512):
        assert m.weak(n)["efficiency"] >= 0.685, (app, "weak", n)
        assert m.strong(n)["efficiency"] >= 0.685, (app, "strong", n)


def test_hpcg_comm_fraction(models):
    m = models["hpcg"][0]
    assert m.strong(512)["comm_fraction"] == pytest.approx(0.224, abs=0.03)
    assert m.strong(2)["comm_fraction"] < 0.02


def test_memory_contention_lammps_weak():
    assert 1 / apps.f_mem(2) == pytest.approx(0.96, abs=0.01)
    assert 1 / apps.f_mem(4) == pytest.approx(0.89, abs=0.01)


@pytest.mark.parametrize("app", APPS)
def test_apps_halo_congestion_is_simulated_not_calibrated(app, models):
    m = models[app][0]
    for mode in ("weak", "strong"):
        sim = m._simulate(mode, 512)
        assert sim.n_sends == 512 * 6, (app, mode)
        assert sim.n_collectives == m.allreduce_per_iter, (app, mode)
        closed = m._comm_closed_us(m._local_points(mode, 512), 512)
        assert sim.comm_us > closed, (app, mode)
        e = m._eval(mode, 512)
        assert 0.0 <= e["beta"] <= e["alpha_retired"], (app, mode, e)


def test_ip_overlay_throughput():
    ov = ip_overlay.overlay_throughput_gbps(65507)
    base = ip_overlay.baseline_throughput_gbps(65507)
    assert abs(ov - 4.7) / 4.7 < 0.15
    assert abs(base - 1.3) / 1.3 < 0.25
    assert ov > 3 * base


def test_ip_overlay_rtt():
    assert abs(ip_overlay.overlay_rtt(mode="poll") - 90.0) / 90.0 < 0.25
    assert ip_overlay.overlay_rtt(mode="sleep") > 1500.0


# ---------------------------------- tests/test_fault_engine.py, on the port
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_interference_is_emergent_and_monotone(engine):
    app = halo3d(16, 65536, compute_us=50.0)
    bg = interference.background_stream(16, iters=8, nbytes=131072)
    a_ranks, b_ranks = interference.interleave_qfdb(16, 16)
    mix = interference.merge_tenants(app, bg, a_ranks, b_ranks)
    assert set(a_ranks).isdisjoint(b_ranks)
    n_posts = sum(1 for ops in mix.program.rank_ops for op in ops
                  if type(op).__name__ in ("Isend", "Irecv"))
    assert mix.bg_post_mask.shape == (n_posts,)
    bs = interference.neighbor_load_byte_scale(mix, (0.0, 1.0, 4.0))
    res = ExanetMPI().run_program_scenarios(
        mix.program, byte_scale=bs, engine=ENGINES[engine], check=2,
        rtol=RTOL)
    app_us = [mix.app_latency_us(r) for r in res]
    assert app_us[0] < app_us[1] < app_us[2], app_us


def test_merge_tenants_rejects_collectives_and_overlap():
    coll = cg_iteration(4, 1024, 1.0)
    p2p = halo3d(4, 1024)
    with pytest.raises(ProgramError, match="Collective"):
        interference.merge_tenants(coll, p2p)
    with pytest.raises(ValueError, match="overlap"):
        interference.merge_tenants(p2p, p2p, app_ranks=(0, 1, 2, 3),
                                   bg_ranks=(3, 4, 5, 6))


def test_neighbor_load_rejects_bad_loads():
    mix = _mix(interference, halo3d, 4, 4)
    with pytest.raises(ValueError, match="negative"):
        interference.neighbor_load_byte_scale(mix, (1.0, -0.5))
    with pytest.raises(ValueError, match=r"\(N,\)"):
        interference.neighbor_load_byte_scale(mix, [[1.0]])


def test_overlay_vs_native_gap():
    assert ip_overlay.math is math
    gap = ip_overlay.overlay_vs_native_gap()
    assert gap["baseline_gbps"] < gap["overlay_gbps"] \
        < gap["native_wire_gbps"]
    assert gap["native_wire_gbps"] == pytest.approx(6.42, rel=0.05)
    assert gap["overlay_gbps"] == pytest.approx(4.7, rel=0.1)
    assert gap["baseline_gbps"] == pytest.approx(1.3, rel=0.1)


# ------------------------------------- an app iteration's scenario lane
@pytest.fixture(scope="module")
def app_sweeps(models):
    """Each app's weak iteration at 64 ranks over 8 seeded scenario
    columns (compute x0.9-1.1, bytes x0.8-1.2, as the reference's apps
    sweep draws them), on the reference's numpy lane."""
    out = {}
    for name in APPS:
        ref = models[name][1]
        rng = np.random.default_rng(64)
        cs, bs = rng.uniform(0.9, 1.1, 8), rng.uniform(0.8, 1.2, 8)
        want = ref.mpi_for(64).run_program_scenarios(
            ref.emit_iteration("weak", 64), compute_scale=cs, byte_scale=bs)
        out[name] = (cs, bs, want)
    return out


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("app", APPS)
def test_app_scenario_lane_equals_reference(app, engine, models,
                                            app_sweeps):
    m = models[app][0]
    cs, bs, want = app_sweeps[app]
    calls = sum(TORCH_CPU.calls.values())
    got = m.mpi_for(64).run_program_scenarios(
        m.emit_iteration("weak", 64), compute_scale=cs, byte_scale=bs,
        engine=ENGINES[engine], check=3, rtol=RTOL)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert _rel(g.latency_us, w.latency_us) <= RTOL
        assert _rel(g.clocks, w.clocks) <= RTOL
        assert (g.n_sends, g.n_collectives) == (w.n_sends, w.n_collectives)
        if engine == "numpy":
            assert g.latency_us == w.latency_us
    if engine == "torch":
        assert sum(TORCH_CPU.calls.values()) > calls
