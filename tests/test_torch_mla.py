"""The port's DeepSeek MLA attention and MTP head against the JAX reference,
on the CPU.

The reduced ``deepseek-v3-671b`` (2 layers: one dense, one MoE of 4
experts top 2 with a sigmoid router and one shared expert; MTP depth 1;
MLA with q_lora 32, kv_lora 16, nope 16, rope 8, v 16): ``mla_attention``
(the expanded form) with its cache and gradients, ``mla_decode`` (the
absorbed form) from the same cache, the full-width tree against
``jax.eval_shape``, ``loss_fn`` with MTP and ``_mtp_loss`` with every
gradient, prefill logits and the ``c_kv``/``k_rope`` caches, prefill then
absorbed decode against the full prefill, ``decode_step`` from the
reference's cache, the serving engine's tokens, a five-step ``Trainer``
trajectory, the launchers, and checkpoints of the train state both ways.
Parameters come from the reference's ``init(PRNGKey(0))``, moved across by
tree path (:mod:`repro_torch.bridge`). The JAX side is compiled with
``xla_allow_excess_precision=False`` (ROADMAP.md R5). Where the MoE layers
run, their routes are compared first, as ``tests/test_torch_moe.py`` does:
a route that flips at a near-tie is reported with its top-k margin, not
absorbed by a tolerance.
"""

from __future__ import annotations

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jax_store
from repro.config import reduced as jax_reduced
from repro.configs import get as jax_get
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.models import attention as jax_attn
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.train import loop as jax_loop
from repro.train import optimizer as jax_opt
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.checkpoint.store import restore_checkpoint, save_checkpoint
from repro_torch.config import reduced
from repro_torch.configs import get
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models import LM, build_model, moe
from repro_torch.models import attention as attn
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.loop import Trainer, _value_and_grad
from repro_torch.train.optimizer import AdamWConfig

ARCH = "deepseek-v3-671b"
EXACT = {"xla_allow_excess_precision": False}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# MODEL_TOL of test_torch_train_step.py: f32 summation order only; bf16:
# both round at the same ops, and one bf16 ulp flip in an activation moves
# a value by up to ~1e-2 relative
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# logits and caches of a forward pass (test_torch_train_step.py's prefill)
FWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax_store._leaf_name(path): np.asarray(
        leaf.astype(jnp.float32) if leaf.dtype == jnp.bfloat16 else leaf)
        for path, leaf in flat}


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)


def _run(fn, *args):
    return _compile(fn, *args)(*args)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, msg=""):
    """Within ``tol`` of the largest |value| (at least 1)."""
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got) / scale, want / scale, rtol=tol,
                               atol=tol, err_msg=msg)


def _cfgs(dtype="float32", **over):
    return (jax_reduced(jax_get(ARCH), dtype=dtype, **over),
            reduced(get(ARCH), dtype=dtype, **over))


@functools.cache
def _ref_params(dtype: str, over: tuple):
    """The reference's ``init(PRNGKey(0))``, jitted (the same values as
    eager, in one dispatch) and kept for the module."""
    jcfg, _ = _cfgs(dtype, **dict(over))
    return jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))


def _models(dtype="float32", **over):
    jcfg, tcfg = _cfgs(dtype, **over)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = _ref_params(dtype, tuple(sorted(over.items())))
    return jm, tm, jp, bridge.load_params(tm, _leaves(jp), device="cpu")


def _batch(vocab, B=2, S=40, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


def _pairs(tc, jc):
    """(name, port leaf, reference leaf) over two trees of one layout."""
    j = _leaves(jc)
    t = dict(tree_util.named_leaves(tc))
    assert sorted(t) == sorted(j)
    return [(name, t[name], j[name]) for name in sorted(t)]


def _to_port(jtree, template):
    """The reference's arrays as tensors shaped like ``template``."""
    return tree_util.unflatten(template, [
        torch.tensor(_np(leaf), dtype=t.dtype) for leaf, t in zip(
            jax.tree_util.tree_leaves(jtree), tree_util.leaves(template))])


# ---------------------------------------------------------------- routes
def _record_routes(mp):
    """Patch both MoE layers (through ``mp``, a pytest monkeypatch) to
    record each call's router input and weight: the reference's by a host
    callback from inside its jitted program, the port's by wrapping
    ``route``. Returns the two logs (the reference's, the port's)."""
    j_log, t_log = [], []
    j_orig, t_orig = jax_moe.apply_moe, moe.route

    def j_apply(p, x, cfg, pctx=None):
        jax.debug.callback(lambda h, w: j_log.append(
            (np.asarray(h), np.asarray(w))), x, p["router"])
        return j_orig(p, x, cfg, pctx)

    def t_route(x, router_w, cfg):
        t_log.append((x.detach().clone(), router_w.detach().clone()))
        return t_orig(x, router_w, cfg)

    mp.setattr(jax_moe, "apply_moe", j_apply)
    mp.setattr(moe, "route", t_route)
    return j_log, t_log


def _by_tokens(log, n):
    """The first call of each token count, most tokens first: the trunk's
    MoE layer sees B*S tokens, the MTP block B*(S-1); a recompute repeats
    a call on the same input."""
    first = {}
    for h, w in log:
        first.setdefault(int(np.prod(h.shape[:-1])), (h, w))
    assert len(first) == n, sorted(first)
    return [first[t] for t in sorted(first, reverse=True)]


def _assert_same_routes(j_log, t_log, cfg):
    """The top-k ids of every MoE call, token by token, in both; on a
    mismatch, the margin between the k-th and (k+1)-th logit of each
    differing token."""
    k = cfg.moe.top_k
    n = cfg.n_layers - cfg.n_dense_layers + cfg.mtp_depth
    for call, ((jh, jw), (th, tw)) in enumerate(zip(_by_tokens(j_log, n),
                                                    _by_tokens(t_log, n))):
        jh = jnp.asarray(jh).reshape(-1, jh.shape[-1])
        jl = (jh @ jnp.asarray(jw).astype(jh.dtype)).astype(jnp.float32)
        j_ids = np.asarray(jax.lax.top_k(jl, k)[1])
        _, t_ids, t_logits = moe.route(th.reshape(-1, th.shape[-1]), tw, cfg)
        assert t_ids.shape == j_ids.shape
        bad = np.nonzero((t_ids.numpy() != j_ids).any(-1))[0]
        if len(bad):
            srt = np.sort(np.asarray(jl)[bad], -1)[:, ::-1]
            raise AssertionError(
                f"MoE call {call}: routes differ on tokens {bad.tolist()}: "
                f"reference {j_ids[bad].tolist()}, port "
                f"{t_ids[bad].tolist()}; top-k margins "
                f"{(srt[:, k - 1] - srt[:, k]).tolist()}; port logits "
                f"{t_logits[bad].tolist()}")


# ------------------------------------------------------------ the layer
def _mla_params(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp = jax_attn.init_mla(jax.random.PRNGKey(0), jcfg, jcfg.d_model)
    template = attn.init_mla(torch.Generator(), tcfg, tcfg.d_model,
                             torch.device("meta"))
    return jcfg, tcfg, jp, bridge.load_tree(template, _leaves(jp),
                                            device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_attention_output_cache_and_grads_match_reference(dtype):
    """The expanded form (train and prefill): output, the compressed cache,
    and the gradients of sum(y * dy) with respect to x and every leaf."""
    jcfg, tcfg, jp, tp = _mla_params(dtype)
    B, S, d = 2, 40, jcfg.d_model
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, d), np.float32)
    dy = rng.standard_normal((B, S, d), np.float32)
    jpos = jnp.broadcast_to(jnp.arange(S), (B, S))

    def jloss(p, x):
        y, cache = jax_attn.mla_attention(p, x, jcfg, positions=jpos)
        return jnp.sum(y.astype(jnp.float32) * dy), (y, cache)

    jx = jnp.asarray(x).astype(JD[dtype])
    (_, (jy, jc)), (jgp, jgx) = _run(
        jax.value_and_grad(jloss, (0, 1), has_aux=True), jp, jx)
    tp = tree_util.tree_map(lambda t: t.detach().requires_grad_(True), tp)
    tx = torch.from_numpy(x).to(TD[dtype]).requires_grad_(True)
    ty, tc = attn.mla_attention(tp, tx, tcfg, positions=torch.arange(S)
                                .expand(B, S))
    (ty.float() * torch.from_numpy(dy)).sum().backward()
    assert ty.dtype == TD[dtype] and ty.shape == (B, S, d)
    assert tc["c_kv"].shape == (B, S, 16) and tc["k_rope"].shape == (B, S, 8)
    tol = TOL[dtype]
    _close(ty, jy, FWD_TOL[dtype], "y")
    for name, t, j in _pairs(tc, jc):
        _close(t, j, FWD_TOL[dtype], f"cache {name}")
    _close(tx.grad, jgx, tol, "dx")
    tg = dict(tree_util.named_leaves(tp))
    for name, g in _leaves(jgp).items():
        assert tg[name].grad.dtype == tg[name].dtype
        _close(tg[name].grad, g, tol, f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_reference(dtype):
    """The absorbed form from one cache (the reference's expanded prefill of
    S - 1 tokens written into an S window), per-row positions, one row past
    the window (the reference drops that write and attends to all of S):
    the output and the updated cache, which the port writes in place."""
    jcfg, tcfg, jp, tp = _mla_params(dtype)
    B, S, d = 3, 24, jcfg.d_model
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, S, d), np.float32)
    jx = jnp.asarray(x).astype(JD[dtype])
    _, jc = _run(lambda p, x: jax_attn.mla_attention(
        p, x, jcfg, positions=jnp.broadcast_to(jnp.arange(S - 1),
                                               (B, S - 1))), jp, jx[:, :-1])
    j_cache = {n: jnp.pad(c, [(0, 0), (0, 1), (0, 0)]) for n, c in jc.items()}
    pos = np.array([S - 1, 7, S + 2], np.int32)
    xn = rng.standard_normal((B, 1, d), np.float32)
    jy, j_new = _run(lambda p, x, c, pos: jax_attn.mla_decode(
        p, x, jcfg, c, pos), jp, jnp.asarray(xn).astype(JD[dtype]), j_cache,
        jnp.asarray(pos))
    t_cache = _to_port(j_cache, {n: torch.empty(c.shape, dtype=TD[dtype])
                                 for n, c in j_cache.items()})
    with torch.no_grad():
        ty, t_new = attn.mla_decode(tp, torch.from_numpy(xn).to(TD[dtype]),
                                    tcfg, t_cache, torch.from_numpy(pos))
    assert t_new is t_cache and ty.shape == (B, 1, d)
    _close(ty, jy, FWD_TOL[dtype], "y")
    for name, t, j in _pairs(t_new, j_new):
        _close(t, j, FWD_TOL[dtype], f"cache {name}")
    assert t_new["c_kv"][1, 7].abs().amax() > 0       # written at pos


# ------------------------------------------------------------ the model
def test_full_width_tree_is_the_references():
    """Full-width deepseek-v3-671b (61 layers, 256 experts, MTP): the
    port's parameter names, shapes and dtypes are the reference's, leaf for
    leaf (shapes only: meta tensors and ``jax.eval_shape``)."""
    shapes = jax.eval_shape(jax_build_model(jax_get(ARCH)).init,
                            jax.random.PRNGKey(0))
    want = {jax_store._leaf_name(path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    tm = build_model(get(ARCH))
    assert isinstance(tm, LM)
    got = {name: (tuple(t.shape), str(t.dtype).split(".")[-1])
           for name, t in tree_util.named_leaves(bridge._shape_tree(tm))}
    assert got == want
    assert want["dense_stack.attn.wkv_b"] == ((3, 512, 128, 256), "bfloat16")
    assert want["moe_stack.attn.q_norm.scale"] == ((58, 1536), "float32")
    assert want["mtp.proj"] == ((14336, 7168), "bfloat16")
    assert want["mtp.block.ffn.w_gate"] == ((256, 7168, 2048), "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_with_mtp_and_grads_match_reference(dtype, monkeypatch):
    """``loss_fn`` (main loss + 0.3 x MTP loss) and every gradient,
    ``mtp.*`` included; ``_mtp_loss`` alone on the reference's trunk output.
    The routes of both MoE calls (the trunk's layer and the MTP block's)
    are compared first."""
    jm, tm, jp, tp = _models(dtype)
    jb, tb = _batch(tm.cfg.vocab_size)

    def both(p, b):
        x, positions = jm._inputs(p, b)
        h, _ = jm._trunk(p, x, positions, None)
        return (jax.value_and_grad(jm.loss_fn)(p, b),
                jm._mtp_loss(p, h, b, None), h)

    with monkeypatch.context() as mp:
        j_log, t_log = _record_routes(mp)
        (j_loss, j_grads), j_mtp, jh = _run(both, jp, jb)
        jax.effects_barrier()
        t_loss, t_grads = _value_and_grad(tm, tp, tb, None)
    _assert_same_routes(j_log, t_log, tm.cfg)
    tol = TOL[dtype]
    _close(t_loss, j_loss, tol, "loss")
    jg = _leaves(j_grads)
    tg = bridge.tree_to_numpy(t_grads)
    assert sorted(jg) == sorted(tg)
    assert {n for n in jg if n.startswith("mtp.")} >= {
        "mtp.proj", "mtp.ln_h.scale", "mtp.ln_e.scale",
        "mtp.block.attn.wkv_b", "mtp.block.ffn.router",
        "mtp.block.ffn.shared.w_gate"}
    for name in jg:
        _close(tg[name], jg[name], tol, name)
    assert np.abs(tg["mtp.proj"]).max() > 0
    # the MTP loss alone, from the reference's final hidden states
    with torch.no_grad():
        t_mtp = tm._mtp_loss(tp, torch.tensor(_np(jh), dtype=TD[dtype]), tb)
    _close(t_mtp, j_mtp, tol, "mtp loss")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_caches_match_reference(dtype):
    jm, tm, jp, tp = _models(dtype)
    jb, tb = _batch(tm.cfg.vocab_size)
    j_lg, j_c = _run(jm.prefill, jp, {"tokens": jb["tokens"]})
    with torch.no_grad():
        t_lg, t_c = tm.prefill(tp, {"tokens": tb["tokens"]})
    assert t_lg.dtype == torch.float32 and t_lg.shape == (
        2, 1, tm.cfg.vocab_size)
    assert sorted(t_c) == ["dense", "moe"]
    assert t_c["moe"]["c_kv"].shape == (1, 2, 40, 16)
    assert t_c["dense"]["k_rope"].shape == (1, 2, 40, 8)
    tol = FWD_TOL[dtype]
    _close(t_lg, j_lg, tol, "logits")
    for name, t, j in _pairs(t_c, j_c):
        _close(t, j, tol, name)


def _padded(caches, n: int = 1):
    """Caches of a prefill with ``n`` more positions of zeros (the
    reference test's ``jnp.pad``)."""
    return tree_util.tree_map(
        lambda c: torch.nn.functional.pad(c, (0, 0, 0, n)), caches)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_absorbed_decode_matches_full_prefill(dtype):
    """The port's twin of tests/test_models_smoke.py::
    test_mla_absorbed_decode_matches_prefill: n_layers 2 (one dense), no
    MTP; the caches of a prefill of S - 1 tokens padded by one, then one
    absorbed ``decode_step`` gives the last logits of a prefill of all S
    tokens, at the reference test's 3e-2. The caches are written in place
    at S - 1."""
    over = dict(n_layers=2, mtp_depth=0, n_dense_layers=1)
    _, tm, _, tp = _models(dtype, **over)
    assert "mtp" not in tp
    S = 32
    _, tb = _batch(tm.cfg.vocab_size, S=S, seed=1)
    toks = tb["tokens"]
    with torch.no_grad():
        full, _ = tm.prefill(tp, {"tokens": toks})
        _, caches = tm.prefill(tp, {"tokens": toks[:, :-1]})
        cache = _padded(caches)
        lg, out = tm.decode_step(tp, cache, {"token": toks[:, -1],
                                             "pos": torch.tensor(S - 1)})
    assert out is cache
    for stack in ("dense", "moe"):
        assert cache[stack]["c_kv"][0, :, S - 1].abs().amax() > 0
    _close(lg, full, 3e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(dtype):
    """One absorbed decode step from the same caches (the reference's
    prefill of S - 1 tokens, padded by one, moved across): logits and every
    updated cache."""
    jm, tm, jp, tp = _models(dtype)
    S = 40
    jb, tb = _batch(tm.cfg.vocab_size, S=S)
    _, j_c = _run(jm.prefill, jp, {"tokens": jb["tokens"][:, :-1]})
    j_cache = jax.tree_util.tree_map(
        lambda c: jnp.pad(c, [(0, 0), (0, 0), (0, 1), (0, 0)]), j_c)
    t_cache = _to_port(j_cache, tm.init_cache(2, S, device="cpu"))
    step = {"token": jb["tokens"][:, -1], "pos": jnp.int32(S - 1)}
    j_lg, j_new = _run(jm.decode_step, jp, j_cache, step)
    with torch.no_grad():
        t_lg, t_new = tm.decode_step(tp, t_cache, {
            "token": tb["tokens"][:, -1], "pos": torch.tensor(S - 1)})
    assert t_new is t_cache
    tol = FWD_TOL[dtype]
    _close(t_lg, j_lg, tol, "logits")
    for name, t, j in _pairs(t_new, j_new):
        _close(t, j, tol, name)


def test_serve_engine_tokens_equal_reference_engine():
    """Reduced f32 deepseek without MTP (the engine never uses it), three
    slots over five requests, one past the window: the port's engine gives
    the reference engine's tokens and request steps on caches whose leaves
    are ``c_kv``/``k_rope``."""
    jm, tm, jp, tp = _models("float32", mtp_depth=0)
    rng = np.random.default_rng(0)
    reqs = [(list(rng.integers(0, tm.cfg.vocab_size, n)), new)
            for n, new in [(5, 8), (12, 6), (20, 16), (3, 4), (30, 8)]]
    engines = [JaxServeEngine(jm, jp, slots=3, window=32),
               ServeEngine(tm, tp, slots=3, window=32, device="cpu")]
    assert sorted(engines[1].cache["moe"]) == ["c_kv", "k_rope"]
    results = []
    for eng in engines:
        rids = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
        eng.run_until_idle()
        results.append(([eng.result(r) for r in rids], eng.request_steps()))
    assert all(len(t) == n for t, (_, n) in zip(results[1][0], reqs))
    assert results[1] == results[0]


# ---------------------------------------------------------------- training
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainer_five_step_trajectory_matches_reference(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    ocfg = dict(lr=3e-3, warmup_steps=1, decay_steps=5)
    jtr = jax_loop.Trainer(jm, jax_opt.AdamWConfig(**ocfg))
    ttr = Trainer(tm, AdamWConfig(**ocfg), device="cpu")
    # init_state(PRNGKey(0)) on the module's reference parameters
    jp = _ref_params(dtype, ())
    jstate = {"params": jp, "opt": jax_opt.adamw_init(jp, jtr.opt_cfg)}
    tstate = bridge.load_train_state(tm, ttr.opt_cfg, _leaves(jstate),
                                     device="cpu")
    jdata = JaxTokens(jcfg, batch=2, seq=32)
    tdata = SyntheticTokens(tcfg, batch=2, seq=32, device="cpu")
    jstep = _compile(jtr.make_step(jit=False), jstate, jdata.batch_at(0))
    tstep = ttr.make_step()
    j_losses, t_losses = [], []
    for i in range(5):
        jstate, jmet = jstep(jstate, jdata.batch_at(i))
        tstate, tmet = tstep(tstate, tdata.batch_at(i))
        j_losses.append(float(jmet["loss"]))
        t_losses.append(float(tmet["loss"]))
    # as TRAJ_TOL in test_torch_train_step.py
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    np.testing.assert_allclose(t_losses, j_losses, rtol=tol, atol=tol)
    assert t_losses[-1] < t_losses[0]


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_donated_step_equals_functional_step(quantize):
    """``Trainer(donate=True)`` (the step the card's deepseek training runs:
    its functional update would hold two train states) writes into the
    state it is given, and gives the functional step's parameters, moments
    and step bit for bit over three steps, float32 or int8 moments."""
    _, tcfg = _cfgs("bfloat16")
    ocfg = AdamWConfig(lr=6e-4, warmup_steps=1, decay_steps=3,
                       quantize_states=quantize, qblock=16)
    data = SyntheticTokens(tcfg, batch=2, seq=32, device="cpu")
    states = []
    for donate in (False, True):
        tr = Trainer(build_model(tcfg), ocfg, device="cpu", donate=donate)
        state = tr.init_state(torch.Generator().manual_seed(0))
        ptrs = [t.data_ptr() for t in tree_util.leaves(
            {"p": state["params"], "m": state["opt"]["m"]})]
        step = tr.make_step()
        for i in range(3):
            state, _ = step(state, data.batch_at(i))
        now = [t.data_ptr() for t in tree_util.leaves(
            {"p": state["params"], "m": state["opt"]["m"]})]
        assert (now == ptrs) == donate
        states.append(state)
    assert int(states[1]["opt"]["step"]) == 3
    for name, a in tree_util.named_leaves(states[0]):
        b = dict(tree_util.named_leaves(states[1]))[name]
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_launchers_run_reduced_deepseek_on_cpu(tmp_path):
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    run = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--steps", "6", "--batch", "2", "--seq", "32",
                             "--ckpt-dir", str(tmp_path / "ckpt")])
    assert run["arch"] == ARCH and len(run["losses"]) == 6
    assert all(np.isfinite(run["losses"]))
    assert (tmp_path / "ckpt" / "step-00000000" / "manifest.json").exists()
    assert run["state"]["params"]["mtp"]["proj"].shape == (128, 64)
    launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--requests", "3", "--max-new", "4"])


@functools.cache
def _reference_state(quantize: bool):
    """The reference's bf16 deepseek train state (int8 moments with their
    scales when ``quantize``) with the moments and the step moved off zero
    by seeded noise, so values and dtypes matter; and the port's trainer
    of the same config."""
    jcfg, tcfg = _cfgs("bfloat16")
    ocfg = dict(quantize_states=quantize, qblock=16)
    jtr = jax_loop.Trainer(jax_build_model(jcfg), jax_opt.AdamWConfig(**ocfg))
    jp = _ref_params("bfloat16", ())
    jstate = {"params": jp, "opt": jax_opt.adamw_init(jp, jtr.opt_cfg)}
    rng = np.random.default_rng(7)

    def noise(leaf):
        if leaf.dtype == jnp.int8:
            return jnp.asarray(rng.integers(-127, 128, leaf.shape), jnp.int8)
        if leaf.dtype == jnp.int32:
            return leaf + 3
        return jnp.asarray(np.abs(rng.standard_normal(leaf.shape)) * 1e-3,
                           leaf.dtype)

    jstate = {"params": jstate["params"],
              "opt": jax.tree_util.tree_map(noise, jstate["opt"])}
    return jstate, Trainer(build_model(tcfg), AdamWConfig(**ocfg),
                           device="cpu")


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_deepseek_checkpoint_crosses_frameworks(tmp_path, writer, quantize):
    """A deepseek train state (bf16 MLA, MoE and unstacked ``mtp.*``
    parameters, AdamW moments in float32 or int8 with scales, the step),
    written by one side and restored by the other: names, dtypes and values
    agree, and both write the same manifest."""
    jstate, ttr = _reference_state(quantize)
    if writer == "reference":
        jax_store.save_checkpoint(str(tmp_path / "w"), 1, jstate)
        template = bridge.train_state_template(ttr.model, ttr.opt_cfg)
        state, _ = restore_checkpoint(str(tmp_path / "w"), 1, template,
                                      device="cpu")
        save_checkpoint(str(tmp_path / "r"), 1, state)
    else:
        state = bridge.load_train_state(ttr.model, ttr.opt_cfg,
                                        _leaves(jstate), device="cpu")
        save_checkpoint(str(tmp_path / "w"), 1, state)
        restored, _ = jax_store.restore_checkpoint(str(tmp_path / "w"), 1,
                                                   jstate)
        jax_store.save_checkpoint(str(tmp_path / "r"), 1, restored)
        jstate = restored
    got = dict(tree_util.named_leaves(state))
    flat = jax.tree_util.tree_flatten_with_path(jstate)[0]
    assert sorted(got) == sorted(jax_store._leaf_name(p) for p, _ in flat)
    assert "params.mtp.proj" in got and "params.moe_stack.attn.wkv_b" in got
    assert got["params.mtp.block.attn.wkv_b"].dim() == 3      # unstacked
    assert any(n.startswith("opt.m.mtp.block.") for n in got)
    for path, leaf in flat:
        name = jax_store._leaf_name(path)
        t = got[name]
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), name
        np.testing.assert_array_equal(_np(t), _np(leaf), err_msg=name)
    manifests = [json.loads((tmp_path / d / "step-00000001" /
                             "manifest.json").read_text())["leaves"]
                 for d in ("w", "r")]
    assert manifests[0] == manifests[1]
