"""The port's roofline cost modules against the reference's.

``repro_torch.roofline.hlo_cost`` and ``repro_torch.roofline.analysis`` are
copies of the reference's modules: arithmetic on the config and a parser
over HLO text that ``synth_train_hlo`` writes itself. Both sides run the
same float operations, so every figure is held equal to the reference's
exactly: the synthetic HLO text, ``analyze_hlo``'s dict and
``flash_block_report`` for every config at two ``microbatches`` values, and
the closed forms the serve and train simulators read
(``lm_serve_step_cost``, ``lm_train_step_cost``,
``serve_step_calibration``). Then the reference's own assertions
(``tests/test_hlo_cost_configs.py``, the roofline case of
``tests/test_serve_sim.py``) on the port's figures.
``roofline_from_compiled``, which reads a JAX compiled artifact, and the
two functions that only it calls are left out of the port (ROADMAP.md,
R12).
"""

from __future__ import annotations

import pytest

from repro.configs import get as jget
from repro.roofline import analysis as janalysis
from repro.roofline import hlo_cost as jhlo
from repro_torch.configs import ALL_ARCHS, EXTRA_ARCHS, get
from repro_torch.roofline import analysis, hlo_cost
from repro_torch.roofline.hlo_cost import (HloCostModel, _trip_multipliers,
                                           analyze_hlo, synth_train_hlo)
from repro_torch.roofline.hw import H100

ARCHS = ALL_ARCHS + EXTRA_ARCHS
SEQ = 512


def _analyzed(arch, *, microbatches=1):
    cfg = get(arch)
    hlo = synth_train_hlo(cfg, seq_len=SEQ, microbatches=microbatches)
    return cfg, hlo, analyze_hlo(hlo)


# ------------------------------------------------ equal to the reference
@pytest.mark.parametrize("mb", [1, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_synth_hlo_and_its_analysis_equal_reference(arch, mb):
    hlo = synth_train_hlo(get(arch), seq_len=SEQ, batch=2, microbatches=mb)
    want = jhlo.synth_train_hlo(jget(arch), seq_len=SEQ, batch=2,
                                microbatches=mb)
    assert hlo == want
    assert analyze_hlo(hlo) == jhlo.analyze_hlo(want)
    assert hlo_cost.flash_block_report(hlo) == \
        jhlo.flash_block_report(want)
    assert _trip_multipliers(HloCostModel(hlo)) == \
        jhlo._trip_multipliers(jhlo.HloCostModel(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_closed_forms_equal_reference(arch):
    cfg, jcfg = get(arch), jget(arch)
    for kw in (dict(seq_len=2048, batch=1),
               dict(seq_len=512, batch=4, dtype_bytes=4,
                    grad_dtype_bytes=4)):
        assert analysis.lm_train_step_cost(cfg, **kw) == \
            janalysis.lm_train_step_cost(jcfg, **kw)
    for kw in (dict(n_decode=0, decode_kv=0.0),
               dict(n_decode=1, decode_kv=64.0),
               dict(n_decode=7.5, decode_kv=812.25, n_prefill=256),
               dict(n_decode=3, decode_kv=100.0, n_prefill=32,
                    prefill_kv=64.0, dtype_bytes=4)):
        assert analysis.lm_serve_step_cost(cfg, **kw) == \
            janalysis.lm_serve_step_cost(jcfg, **kw)
    kw = dict(measured_step_us=18030.0, n_decode=6.25, decode_kv=530.5,
              rate_flops_per_us=H100.peak_bf16_flops / 1e6,
              bw_bytes_per_us=H100.hbm_bw / 1e6, overhead_us=2.0)
    assert analysis.serve_step_calibration(cfg, **kw) == \
        janalysis.serve_step_calibration(jcfg, **kw)


@pytest.mark.parametrize("kind", ["train", "decode", "prefill"])
def test_model_flops_equal_reference(kind):
    for b in (0.0, 0.4, 6.9, 671.0):
        meta = {"active_params_b": b}
        for tokens in (1, 4096):
            assert analysis.model_flops_per_step(meta, kind, tokens) == \
                janalysis.model_flops_per_step(meta, kind, tokens)
    assert analysis.model_flops_per_step({}, kind, 4096) == 0.0


@pytest.mark.parametrize("name", ["roofline_from_compiled",
                                  "collective_bytes_from_hlo",
                                  "roofline_terms"])
def test_compiled_roofline_is_left_out(name):
    """A recorded difference (R12): ``roofline_from_compiled`` reads a JAX
    compiled artifact that nothing in the port produces, and the other two
    serve only it (``roofline_terms`` defaults to the reference's TPU)."""
    assert hasattr(janalysis, name)
    assert not hasattr(analysis, name)


# ------------------------------------ tests/test_hlo_cost_configs.py, port
@pytest.mark.parametrize("arch,mb", [("deepseek-v3-671b", 2),
                                     ("mistral-large-123b", 3)])
def test_nested_trip_multipliers(arch, mb):
    cfg, hlo, _ = _analyzed(arch, microbatches=mb)
    mult = _trip_multipliers(HloCostModel(hlo))
    assert mult["%mb_body"] == mb
    if getattr(cfg, "moe", None):
        n_dense = getattr(cfg, "n_dense_layers", 0) or 0
        assert mult["%dense_body"] == n_dense * mb
        assert mult["%moe_body"] == (cfg.n_layers - n_dense) * mb
    else:
        assert mult["%dense_body"] == cfg.n_layers * mb
        assert "%moe_body" not in mult
    assert all(v >= 1 for v in mult.values())


def test_microbatch_near_invariance_of_totals():
    _, _, one = _analyzed("mistral-large-123b", microbatches=1)
    _, _, four = _analyzed("mistral-large-123b", microbatches=4)
    assert four["flops"] <= one["flops"]
    assert four["flops"] == pytest.approx(one["flops"], rel=0.02)


@pytest.mark.parametrize("arch,lo,hi", [("deepseek-v3-671b", 0.7, 1.3),
                                        ("mistral-large-123b", 0.7, 1.3),
                                        ("exanest-lm-100m", 0.6, 1.2)])
def test_hlo_flops_track_closed_form(arch, lo, hi):
    cfg, _, rep = _analyzed(arch)
    closed = analysis.lm_train_step_cost(cfg, seq_len=SEQ, batch=1)
    ratio = rep["flops"] / closed["fwd_flops"]
    assert lo < ratio < hi, ratio


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "exanest-lm-100m"])
def test_allreduce_bytes_are_fp32_gradient(arch):
    cfg, _, rep = _analyzed(arch)
    coll = rep["collectives"]
    assert coll["all-reduce"] == cfg.param_count() * 4
    assert coll["ops"]["all-reduce"] == 1
    assert coll["total"] == coll["all-reduce"]


def test_moe_layer_flops_scale_with_active_params():
    cfg, _, rep = _analyzed("deepseek-v3-671b")
    assert rep["flops"] < 0.5 * 2.0 * SEQ * cfg.param_count()
    assert rep["flops"] > 0.5 * 2.0 * SEQ * cfg.active_param_count()


def test_dense_layer_flops_per_token_bounds():
    cfg, _, rep = _analyzed("mistral-large-123b")
    per_tok = rep["flops"] / SEQ
    p = cfg.param_count()
    assert 2.0 * p * 0.9 < per_tok < 4.0 * p


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "mistral-large-123b",
                                  "exanest-lm-100m"])
def test_bytes_are_positive_and_dominated_by_weights(arch):
    cfg, _, rep = _analyzed(arch)
    assert rep["bytes"] > 0
    assert rep["bytes"] > cfg.param_count()


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "exanest-lm-100m"])
def test_kv_projection_width_in_emitted_hlo(arch):
    cfg, hlo, _ = _analyzed(arch)
    assert f"{2 * cfg.n_kv_heads * cfg.resolved_head_dim}]" in hlo
    gqa = get("exanest-lm-100m")
    assert gqa.n_kv_heads < gqa.n_heads


# --------------------------------- tests/test_serve_sim.py's roofline case
def test_lm_serve_step_cost_sanity():
    cfg = get("exanest-lm-100m")
    c1 = analysis.lm_serve_step_cost(cfg, n_decode=1, decode_kv=64.0)
    assert c1["flops"] >= 2 * cfg.param_count()
    c8 = analysis.lm_serve_step_cost(cfg, n_decode=8, decode_kv=64.0)
    assert c8["flops"] > c1["flops"]
    assert c8["hbm_bytes"] < 8 * c1["hbm_bytes"]
    c0 = analysis.lm_serve_step_cost(cfg, n_decode=0, decode_kv=0.0)
    assert c0["flops"] == 0.0 and c0["hbm_bytes"] == 0.0
    cp = analysis.lm_serve_step_cost(cfg, n_decode=0, decode_kv=0.0,
                                     n_prefill=32)
    assert cp["kv_bytes"] > 0 and c1["kv_bytes"] == 0.0


def test_serve_step_calibration_is_a_ratio_to_the_roofline():
    """The calibration the card's serve_sim phase prints: the prediction
    is the larger of the two roofs plus the overhead, and the ratio is the
    measurement over it."""
    cfg = get("exanest-lm-100m")
    rate, bw = H100.peak_bf16_flops / 1e6, H100.hbm_bw / 1e6
    cal = analysis.serve_step_calibration(
        cfg, measured_step_us=20000.0, n_decode=6.0, decode_kv=500.0,
        rate_flops_per_us=rate, bw_bytes_per_us=bw)
    c = analysis.lm_serve_step_cost(cfg, n_decode=6.0, decode_kv=500.0)
    want = max(c["flops"] / rate, c["hbm_bytes"] / bw)
    assert cal["predicted_step_us"] == want
    assert cal["measured_over_predicted"] == 20000.0 / want
    assert cal["measured_over_predicted"] >= 1.0
