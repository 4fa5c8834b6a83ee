"""Roofline analysis: the closed-form step costs the simulators read.

``model_flops_per_step`` gives MODEL_FLOPS per step; ``lm_serve_step_cost``
and ``lm_train_step_cost`` give the FLOPs and HBM bytes of one serving or
training step from the config alone; ``serve_step_calibration`` sets a
measured serving step beside the bound those costs give at a device's
peaks.

The port's copy of the reference's ``repro.roofline.analysis``: the same
names, layout and float arithmetic, with its imports rewritten to
``repro_torch``. ``tests/test_torch_roofline.py`` holds the two equal.
Three functions are left out: ``roofline_from_compiled``, which reads a
JAX compiled artifact (``cost_analysis()``, ``as_text()``) that nothing in
the port produces, and the two that only it calls,
``collective_bytes_from_hlo`` (collective bytes in compiled HLO text) and
``roofline_terms`` (three terms at a device spec that defaults to the
reference's TPU). ``repro_torch.roofline.hlo_cost.analyze_hlo`` counts the
collectives of the HLO the simulators synthesize.
"""

from __future__ import annotations


def model_flops_per_step(meta: dict, shape_kind: str, tokens: int) -> float:
    """MODEL_FLOPS: 6*N*D for dense training (fwd+bwd), 2*N*D inference;
    N = active params (MoE uses activated experts only)."""
    n = meta.get("active_params_b", 0.0) * 1e9
    mult = 6.0 if shape_kind == "train" else 2.0
    return mult * n * tokens


def lm_serve_step_cost(cfg, *, n_decode: float, decode_kv: float,
                       n_prefill: float = 0.0, prefill_kv: float = 0.0,
                       dtype_bytes: int = 2) -> dict:
    """Closed-form cost of ONE continuous-batching serving step for an
    :class:`~repro_torch.config.ArchConfig` — the config-derived twin of what
    :mod:`repro_torch.roofline.hlo_cost` measures on compiled HLO, cheap enough
    to evaluate per simulated step for any config (compiling a real
    deepseek-7b decode graph to read its HLO would dwarf the simulation).

    A step advances ``n_decode`` in-flight requests by one token (KV
    context ``decode_kv`` each, the batch mean) and pushes ``n_prefill``
    new prompt tokens through (on top of ``prefill_kv`` already-cached
    tokens; causal attention is charged at the mean context
    ``prefill_kv + n_prefill/2``).  FLOPs use the 2*N-per-token rule of
    :func:`model_flops_per_step` plus the KV-length-dependent attention
    term that rule omits; HBM bytes charge one weight sweep per step
    (shared by every token in the batch — the continuous-batching
    economy) plus KV reads/writes.  Returned collective payloads are
    whole-model totals; tensor-parallel sharding (the /nranks) is the
    caller's concern (:mod:`repro_torch.serve.sim`).
    """
    P = float(cfg.param_count())
    L, hd = cfg.n_layers, cfg.resolved_head_dim
    kv_tok = L * 2.0 * cfg.n_kv_heads * hd * dtype_bytes  # bytes/token
    attn_fl_tok = 4.0 * L * cfg.n_heads * hd              # flops/token/ctx
    nd, npf = float(n_decode), float(n_prefill)
    tokens = nd + npf
    pf_ctx = prefill_kv + npf / 2.0
    flops = (nd * (2.0 * P + attn_fl_tok * decode_kv)
             + npf * (2.0 * P + attn_fl_tok * pf_ctx))
    hbm = 0.0
    if tokens > 0:
        hbm += P * dtype_bytes                       # one weight sweep
        hbm += nd * decode_kv * kv_tok               # decode KV reads
        hbm += npf * pf_ctx * kv_tok                 # prefill KV reads
        hbm += tokens * kv_tok                       # KV writes
    return {
        "flops": flops,
        "hbm_bytes": hbm,
        # per-token activation gather payload (one hidden vector each)
        "act_bytes": tokens * cfg.d_model * dtype_bytes,
        # KV shards migrated for the newly-prefilled tokens
        "kv_bytes": npf * kv_tok,
        "kv_bytes_per_token": kv_tok,
    }


def lm_train_step_cost(cfg, *, seq_len: int, batch: int,
                       dtype_bytes: int = 2,
                       grad_dtype_bytes: int = 2) -> dict:
    """Closed-form cost of ONE data-parallel training step for an
    :class:`~repro_torch.config.ArchConfig` — the train-side twin of
    :func:`lm_serve_step_cost`, and the analytic cross-anchor for the
    synthetic-HLO estimate
    (:func:`repro_torch.roofline.hlo_cost.synth_train_hlo`
    through the same while-rollup cost model real dry-run artifacts use).

    FLOPs follow the 6N rule split as 2N forward + 4N backward per token
    (N = active params; MoE charges top-k + shared experts only) plus the
    context-dependent attention term that rule omits, charged at the mean
    causal context ``seq_len/2`` forward and twice that backward.  HBM
    bytes charge one weight sweep forward, two backward (read weights,
    write gradients) and one optimizer pass over master weights;
    ``grad_bytes`` is the full data-parallel gradient volume one rank
    contributes to the sync — bucketing/sharding is the caller's concern
    (:mod:`repro_torch.train.cosim`).
    """
    Na = float(cfg.active_param_count())
    P = float(cfg.param_count())
    L, hd = cfg.n_layers, cfg.resolved_head_dim
    tokens = float(seq_len) * float(batch)
    attn_fl_tok = 4.0 * L * cfg.n_heads * hd      # flops/token/ctx-token
    fwd = tokens * (2.0 * Na + attn_fl_tok * seq_len / 2.0)
    bwd = 2.0 * fwd
    act_tok = cfg.n_layers * cfg.d_model * dtype_bytes
    return {
        "tokens": tokens,
        "fwd_flops": fwd,
        "bwd_flops": bwd,
        "flops": fwd + bwd,
        "grad_bytes": P * grad_dtype_bytes,
        "param_bytes": P * dtype_bytes,
        "hbm_bytes": 4.0 * P * dtype_bytes + 2.0 * tokens * act_tok,
        "act_bytes_per_token": act_tok,
    }


def serve_step_calibration(cfg, *, measured_step_us: float,
                           n_decode: float, decode_kv: float,
                           n_prefill: float = 0.0, prefill_kv: float = 0.0,
                           dtype_bytes: int = 2,
                           rate_flops_per_us: float,
                           bw_bytes_per_us: float,
                           overhead_us: float = 0.0) -> dict:
    """Measured-vs-predicted anchor for :func:`lm_serve_step_cost`: fold a
    measured per-step time (e.g. ``launch/serve.py``'s wall-clock over
    engine steps) back onto the roofline prediction for the same step
    state and report the ratio — the single calibration constant that
    would make the closed form match the measurement
    (``BENCH_serve.json``'s ``calibration`` row)."""
    c = lm_serve_step_cost(cfg, n_decode=n_decode, decode_kv=decode_kv,
                           n_prefill=n_prefill, prefill_kv=prefill_kv,
                           dtype_bytes=dtype_bytes)
    predicted = overhead_us + max(c["flops"] / rate_flops_per_us,
                                  c["hbm_bytes"] / bw_bytes_per_us)
    return {
        "measured_step_us": float(measured_step_us),
        "predicted_step_us": float(predicted),
        "measured_over_predicted": float(measured_step_us) / predicted,
        "predicted_flops": c["flops"],
        "predicted_hbm_bytes": c["hbm_bytes"],
    }
