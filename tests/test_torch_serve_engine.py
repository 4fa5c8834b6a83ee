"""The port's ServeEngine: the reference engine's nine contracts on a torch
``EchoModel`` double, identical tokens and request steps to the JAX engine on
the same reduced LM, and the serving launcher on the CPU."""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.checkpoint.store import _leaf_name
from repro.config import reduced as jax_reduced
from repro.configs import get as jax_get
from repro.models import build_model as jax_build_model
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch.config import reduced
from repro_torch.configs import get
from repro_torch.models import build_model
from repro_torch.serve.engine import ServeEngine

VOCAB = 23
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def _leaves(params) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {_leaf_name(path): np.asarray(leaf, np.float32)
            for path, leaf in flat}


class EchoModel:
    """decode_step contract double: cache records fed tokens per (slot,
    pos); logits put all mass on (token + 1) % VOCAB."""

    def init_cache(self, slots, window, device=None):
        return {"toks": torch.full((slots, window), -1, dtype=torch.int32,
                                   device=device)}

    def decode_step(self, params, cache, batch):
        tok = batch["token"].long()
        pos = batch["pos"].long()
        toks = cache["toks"].clone()
        toks[torch.arange(tok.shape[0]), pos] = tok.int()
        logits = F.one_hot((tok + 1) % VOCAB, VOCAB).float()[:, None, :]
        return logits, {"toks": toks}


def make_engine(slots=2, window=32) -> ServeEngine:
    return ServeEngine(EchoModel(), {}, slots=slots, window=window,
                       device="cpu")


def expect(prompt, max_new, eos_id=None):
    out, tok = [], prompt[-1]
    for _ in range(max_new):
        tok = (tok + 1) % VOCAB
        out.append(tok)
        if eos_id is not None and tok == eos_id:
            break
    return out


# ------------------------------------------- the reference engine's contracts
def test_generation_is_deterministic_counting():
    eng = make_engine()
    rid = eng.submit([3, 4, 5], max_new_tokens=4)
    eng.run_until_idle()
    assert eng.result(rid) == [6, 7, 8, 9]


def test_eos_stops_early_and_recycles_slot():
    eng = make_engine(slots=1)
    rid = eng.submit([7], max_new_tokens=10, eos_id=9)
    eng.run_until_idle()
    assert eng.result(rid) == [8, 9]
    rid2 = eng.submit([1], max_new_tokens=3)
    eng.run_until_idle()
    assert eng.result(rid2) == [2, 3, 4]
    assert eng.active == [None]


def test_pos_resets_on_recycle():
    eng = make_engine(slots=1, window=16)
    eng.submit([5, 6], max_new_tokens=2)
    eng.run_until_idle()
    assert eng.pos[0] == 0
    rid = eng.submit([10, 11, 12], max_new_tokens=1)
    eng.run_until_idle()
    assert eng.result(rid) == [13]
    assert eng.cache["toks"][0][:3].tolist() == [10, 11, 12]


def test_queue_admission_is_fifo():
    eng = make_engine(slots=1)
    rids = [eng.submit([i], max_new_tokens=2) for i in range(4)]
    eng.run_until_idle()
    steps = eng.request_steps()
    assert sorted(rids, key=lambda r: steps[r][1]) == rids
    for i, rid in enumerate(rids):
        assert eng.result(rid) == expect([i], 2)


def test_results_survive_slot_reuse():
    eng = make_engine(slots=2)
    rids = [eng.submit([i], max_new_tokens=3) for i in range(7)]
    eng.run_until_idle()
    for i, rid in enumerate(rids):
        assert eng.result(rid) == expect([i], 3), f"request {i} clobbered"


def test_batched_prefill_handles_mixed_prompt_lengths():
    eng = make_engine(slots=2)
    ra = eng.submit([1, 2, 3, 4, 5], max_new_tokens=2)
    rb = eng.submit([9], max_new_tokens=2)
    eng.run_until_idle()
    assert eng.result(ra) == [6, 7]
    assert eng.result(rb) == [10, 11]


def test_concurrent_slots_do_not_cross_talk():
    eng = make_engine(slots=3)
    rids = [eng.submit([p], max_new_tokens=5) for p in (0, 10, 20)]
    eng.run_until_idle()
    assert eng.result(rids[0]) == [1, 2, 3, 4, 5]
    assert eng.result(rids[1]) == [11, 12, 13, 14, 15]
    assert eng.result(rids[2]) == [21, 22, 0, 1, 2]


def test_empty_prompt_rejected():
    eng = make_engine()
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit([], max_new_tokens=2)


def test_request_steps_monotone():
    eng = make_engine(slots=2)
    rids = [eng.submit([i], max_new_tokens=2) for i in range(3)]
    eng.run_until_idle()
    for rid in rids:
        s, d = eng.request_steps()[rid]
        assert d > s >= 0


# ----------------------------------------------- against the JAX engine
def test_tokens_and_request_steps_equal_jax_engine():
    """Reduced f32 exanest-lm-100m, window 32; requests 2 and 4 run past the
    window (prompt + new tokens > 32)."""
    jcfg = jax_reduced(jax_get("exanest-lm-100m"), dtype="float32")
    tcfg = reduced(get("exanest-lm-100m"), dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg)
    tp = bridge.load_params(tm, _leaves(jp), device="cpu")
    rng = np.random.default_rng(0)
    reqs = [(list(rng.integers(0, jcfg.vocab_size, n)), new)
            for n, new in [(5, 8), (12, 6), (20, 16), (3, 4), (30, 8),
                           (8, 12)]]
    engines = [JaxServeEngine(jm, jp, slots=3, window=32),
               ServeEngine(tm, tp, slots=3, window=32, device="cpu")]
    results = []
    for eng in engines:
        rids = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
        eng.run_until_idle()
        results.append(([eng.result(r) for r in rids], eng.request_steps()))
    assert all(len(t) == n for t, (_, n) in zip(results[1][0], reqs))
    assert results[1][0] == results[0][0]
    assert results[1][1] == results[0][1]


def test_launcher_serves_reduced_model_on_cpu():
    env = {**os.environ, "PYTHONPATH": SRC}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--requests", "4", "--max-new", "4"],
        capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "served 4/4 requests" in res.stdout
