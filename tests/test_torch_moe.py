"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
reference's ``repro.models.moe`` on the CPU, local path (no mesh).

Same numpy inputs and the reference's ``init_moe(PRNGKey(0))`` parameters
moved across by tree path: ``apply_moe`` and its gradients (a scalar loss on
``y``) for a softmax router without shared experts (reduced
``granite-moe-1b-a400m``) and a sigmoid router with one shared expert (the
MoE block of reduced ``deepseek-v3-671b``, alone; the whole deepseek model,
MLA and MTP included, is held in ``tests/test_torch_mla.py``), in float32
and bfloat16; ``_pack`` bit for bit on a router skewed so
that capacity binds, and the layer there; top-k ties broken to the lower
expert id; at model level, the reference's tree at full width, prefill
logits and caches, batch-1 decode after prefill, the serving engine's tokens,
and the launchers. The JAX side is compiled with ``xla_allow_excess_precision=False``
(ROADMAP.md R5). The routing is compared first: a route that flips at a
near-tie is reported with its top-k margin, not absorbed by a tolerance.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import _leaf_name
from repro.config import reduced as jax_reduced
from repro.configs import get as jax_get
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.config import reduced
from repro_torch.configs import get
from repro_torch.models import build_model, moe
from repro_torch.serve.engine import ServeEngine

EXACT = {"xla_allow_excess_precision": False}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: f32: summation order; bf16: both round at the same ops (the reference
#: test_torch_train_step.py's MODEL_TOL)
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
#: (id, arch, router_softmax, MoEConfig overrides): the reduced config
#: keeps its arch's router; the top-8 case sums 8 contributions a token in
#: bf16, one rounding per add as the reference's segment_sum (a single
#: float32 sum of the 8 rounds differently on about half the outputs)
CASES = [("granite-softmax", "granite-moe-1b-a400m", True, {}),
         ("deepseek-v3-sigmoid-shared", "deepseek-v3-671b", False, {}),
         ("granite-top8-of-16", "granite-moe-1b-a400m", True,
          {"n_experts": 16, "top_k": 8})]


def _cfgs(arch, softmax, dtype, **moe_over):
    out = []
    for red, getter in ((jax_reduced, jax_get), (reduced, get)):
        cfg = red(getter(arch), dtype=dtype)
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, router_softmax=softmax, **moe_over)))
    return out


def _leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {_leaf_name(path): np.asarray(leaf.astype(jnp.float32))
            for path, leaf in flat}


def _params(jcfg, tcfg):
    jp = jax_moe.init_moe(jax.random.PRNGKey(0), jcfg, jcfg.d_model)
    template = moe.init_moe(torch.Generator(), tcfg, tcfg.d_model,
                            torch.device("meta"))
    return jp, bridge.load_tree(template, _leaves(jp), device="cpu")


def _close(got, want, tol, msg):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol,
                               err_msg=msg)


def _assert_same_routes(jx, jp, tx, tp, jcfg, tcfg):
    """The top-k ids of both sides, token by token; on a mismatch, the
    margin between the k-th and (k+1)-th logit of each differing token."""
    k = jcfg.moe.top_k
    jl = (jx @ jp["router"].astype(jx.dtype)).astype(jnp.float32)
    jl = jl.reshape(-1, jl.shape[-1])
    j_ids = np.asarray(jax.lax.top_k(jl, k)[1])
    _, t_ids, t_logits = moe.route(tx.reshape(-1, tx.shape[-1]),
                                   tp["router"], tcfg)
    bad = np.nonzero((t_ids.numpy() != j_ids).any(-1))[0]
    if len(bad):
        srt = np.sort(np.asarray(jl)[bad], -1)[:, ::-1]
        raise AssertionError(
            f"routes differ on tokens {bad.tolist()}: reference "
            f"{j_ids[bad].tolist()}, port {t_ids[bad].tolist()}; top-k "
            f"margins {(srt[:, k - 1] - srt[:, k]).tolist()}; port logits "
            f"{t_logits[bad].tolist()}")


def _run_both(jcfg, tcfg, jp, tp, x, dy, dtype):
    """y and the gradients of sum(y * dy) w.r.t. the parameters and x."""
    def jloss(p, x):
        y = jax_moe.apply_moe(p, x, jcfg)
        return jnp.sum(y.astype(jnp.float32) * dy), y

    jx = jnp.asarray(x).astype(JD[dtype])
    fn = jax.jit(jax.value_and_grad(jloss, (0, 1), has_aux=True))
    (_, jy), (jgp, jgx) = fn.lower(jp, jx).compile(
        compiler_options=EXACT)(jp, jx)
    tx = torch.from_numpy(x).to(TD[dtype]).requires_grad_(True)
    tp = tree_util.tree_map(lambda t: t.detach().requires_grad_(True), tp)
    _assert_same_routes(jx, jp, tx.detach(), tp, jcfg, tcfg)
    ty = moe.apply_moe(tp, tx, tcfg)
    (ty.float() * torch.from_numpy(dy)).sum().backward()
    return jy, jgp, jgx, ty, tp, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_apply_moe_and_grads_match_reference(case, dtype):
    _, arch, softmax, over = case
    jcfg, tcfg = _cfgs(arch, softmax, dtype, **over)
    jp, tp = _params(jcfg, tcfg)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 32, jcfg.d_model), np.float32)
    dy = rng.standard_normal(x.shape, np.float32)
    jy, jgp, jgx, ty, tp, tx = _run_both(jcfg, tcfg, jp, tp, x, dy, dtype)
    tol = TOL[dtype]
    assert ty.dtype == TD[dtype] and ty.shape == x.shape
    if dtype == "bfloat16":
        # the forward rounds where the reference rounds, op for op (the
        # combine's 8 adds included): equal bit for bit
        np.testing.assert_array_equal(
            ty.detach().float().numpy(), np.asarray(jy.astype(jnp.float32)))
    _close(ty, jy, tol, "y")
    _close(tx.grad, jgx, tol, "dx")
    jg = _leaves(jgp)
    tg = dict(tree_util.named_leaves(tp))
    assert sorted(jg) == sorted(tg)
    for name in jg:
        assert tg[name].grad.dtype == tg[name].dtype
        _close(tg[name].grad, jg[name], tol, f"d{name}")


# ------------------------------------------------------------ routing internals
def _skewed(jp, tp, jcfg):
    """Bias the router toward expert 0 and then 1, so that their buffers
    overflow: the same change on both sides."""
    bias = np.zeros((jcfg.d_model, jcfg.moe.n_experts), np.float32)
    bias[:, 0], bias[:, 1] = 0.3, 0.15
    jp = {**jp, "router": jp["router"] + bias}
    tp = {**tp, "router": tp["router"] + torch.from_numpy(bias)}
    return jp, tp


def test_pack_equals_reference_where_capacity_binds():
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m", True, "float32")
    jp, tp = _params(jcfg, tcfg)
    jp, tp = _skewed(jp, tp, jcfg)
    rng = np.random.default_rng(12)
    x = np.abs(rng.standard_normal((64, jcfg.d_model), np.float32))
    _, ids, _ = moe.route(torch.from_numpy(x), tp["router"], tcfg)
    dest = ids.reshape(-1).numpy().astype(np.int32)
    payload = np.repeat(x, jcfg.moe.top_k, axis=0)
    E, cap = jcfg.moe.n_experts, 20
    for pl in (payload, (dest + 1).astype(np.int32)):
        jb, jpos, jvalid = jax_moe._pack(jnp.asarray(dest), E, cap,
                                         jnp.asarray(pl))
        tb, tpos, tvalid = moe._pack(torch.from_numpy(dest), E, cap,
                                     torch.from_numpy(pl))
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        assert not tvalid.all() and tvalid.any()       # capacity binds


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_matches_reference_with_dropped_tokens(dtype):
    """The whole layer where the skewed router overflows the per-expert
    buffers: the same tokens drop on both sides, forward and gradients."""
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m", True, dtype)
    jp, tp = _params(jcfg, tcfg)
    jp, tp = _skewed(jp, tp, jcfg)
    rng = np.random.default_rng(13)
    x = np.abs(rng.standard_normal((2, 32, jcfg.d_model), np.float32))
    dy = rng.standard_normal(x.shape, np.float32)
    moe.drop_log = []
    try:
        jy, jgp, jgx, ty, tp, tx = _run_both(jcfg, tcfg, jp, tp, x, dy,
                                             dtype)
        (routed, kept), = moe.drop_log
    finally:
        moe.drop_log = None
    assert routed == 64 * jcfg.moe.top_k and 0 < int(kept) < routed
    tol = TOL[dtype]
    _close(ty, jy, tol, "y")
    _close(tx.grad, jgx, tol, "dx")
    tg = dict(tree_util.named_leaves(tp))
    for name, g in _leaves(jgp).items():
        _close(tg[name].grad, g, tol, f"d{name}")


def test_top_k_ties_go_to_the_lower_expert_id():
    """Planted ties in bf16 logits: ids and their order as jax.lax.top_k
    gives them (the order decides who is dropped first)."""
    cfg = reduced(get("granite-moe-1b-a400m"), dtype="bfloat16")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=8, top_k=3))
    router = np.zeros((4, 8), np.float32)
    router[0] = [1, 2, 2, 0.5, 2, 1, 1, 0]       # a three-way tie at the top
    router[1] = [0, 0, 0, 0, 0, 0, 0, 0]         # all tied
    router[2] = [0, 1, 0, 1, 0, 1, 0, 1]
    router[3] = [3, 1, 3, 2, 2, 2, 0, 3]
    x = np.eye(4, dtype=np.float32)
    _, ids, _ = moe.route(torch.from_numpy(x).bfloat16(),
                          torch.from_numpy(router), cfg)
    jl = (jnp.asarray(x, jnp.bfloat16)
          @ jnp.asarray(router).astype(jnp.bfloat16)).astype(jnp.float32)
    want = np.asarray(jax.lax.top_k(jl, 3)[1])
    np.testing.assert_array_equal(ids.numpy(), want)
    np.testing.assert_array_equal(want, [[1, 2, 4], [0, 1, 2], [1, 3, 5],
                                         [0, 2, 7]])


def test_ep_size_picks_the_data_axis_and_refuses_model():
    cfg = reduced(get("granite-moe-1b-a400m"))

    class Mesh:
        def __init__(self, **shape):
            self.shape = shape

    class Ctx:
        def __init__(self, **shape):
            self.mesh = Mesh(**shape)

    assert moe.ep_size(None, cfg) == 1
    assert moe.ep_size(Ctx(pod=2, data=2), cfg) == 2
    assert moe.ep_size(Ctx(pod=4, data=1), cfg) == 1
    assert moe.ep_size(Ctx(data=3), cfg) == 1        # 3 does not divide 4
    assert moe.ep_size(Ctx(pod=2, data=2, model=1), cfg) == 2
    # a model axis splits the experts' hidden dim on top of EP over data
    assert moe.ep_size(Ctx(data=2, model=2), cfg) == 2
    assert moe.ep_size(Ctx(pod=2, data=1, model=2), cfg) == 1


# ------------------------------------------------------------- model level
def _lm_pair(dtype, **over):
    jcfg = jax_reduced(jax_get("granite-moe-1b-a400m"), dtype=dtype, **over)
    tcfg = reduced(get("granite-moe-1b-a400m"), dtype=dtype, **over)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jp, bridge.load_params(tm, _leaves(jp), device="cpu")


def test_full_width_granite_tree_is_the_references():
    """Full-width granite: the port's parameter names, shapes and dtypes
    are the reference's, leaf for leaf (shapes only: meta tensors and
    ``jax.eval_shape``)."""
    jm = jax_build_model(jax_get("granite-moe-1b-a400m"))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    want = {_leaf_name(path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    tm = build_model(get("granite-moe-1b-a400m"))
    got = {name: (tuple(t.shape), str(t.dtype).split(".")[-1])
           for name, t in tree_util.named_leaves(bridge._shape_tree(tm))}
    assert got == want
    assert want["moe_stack.ffn.w_gate"] == ((24, 32, 1024, 512), "bfloat16")
    assert want["moe_stack.ffn.router"] == ((24, 1024, 32), "float32")
    n = sum(int(np.prod(s)) for s, _ in want.values())
    assert 1.3e9 < n < 1.4e9


@pytest.mark.parametrize("over", [{}, {"n_dense_layers": 1}],
                         ids=["moe-only", "dense1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_caches_match_reference(dtype, over):
    jm, tm, jp, tp = _lm_pair(dtype, **over)
    toks = np.random.default_rng(14).integers(
        0, tm.cfg.vocab_size, (2, 40)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks)}
    j_lg, j_c = jax.jit(jm.prefill).lower(jp, jb).compile(
        compiler_options=EXACT)(jp, jb)
    with torch.no_grad():
        t_lg, t_c = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    assert sorted(t_c) == sorted(j_c) == (["dense", "moe"] if over
                                          else ["moe"])
    _close(t_lg, j_lg, tol, "logits")
    for stack in j_c:
        for name in ("k", "v"):
            _close(t_c[stack][name], j_c[stack][name], tol,
                   f"{stack} cache {name}")


@pytest.mark.parametrize("cf", [1.25, 2.0])
def test_batch1_decode_continues_prefill_iff_the_last_token_is_kept(cf):
    """Prefill of S-1 tokens, then one decode step, against the last logits
    of a prefill of S at batch 1. At S = 32 both prefills have the same
    per-expert capacity (ceil(T * 2 / 4 * cf^2) for T = 31 and 32: 25 at the
    config's capacity factor 1.25, 124 / 128 at 2.0, where no expert can
    fill), so tokens 0..S-2 keep their slots; the decode routes the last
    token alone (capacity 1 an expert, never full). So the two agree iff
    prefill(S) kept every slot of the last token, which the per-layer kept
    counts of the two prefills tell (their difference is top_k in each
    layer). At 1.25 this input drops it in layer 1, and the logits differ."""
    _, tm, _, tp = _lm_pair("float32")
    cfg = dataclasses.replace(tm.cfg, moe=dataclasses.replace(
        tm.cfg.moe, capacity_factor=cf))
    tm = build_model(cfg)
    S, k = 32, cfg.moe.top_k
    toks = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab_size, (1, S)).astype(np.int64))
    kept = {}
    with torch.no_grad():
        for n in (S, S - 1):
            moe.drop_log = []
            try:
                lg_n, caches = tm.prefill(tp, {"tokens": toks[:, :n]})
                kept[n] = [int(c) for _, c in moe.drop_log]
            finally:
                moe.drop_log = None
            if n == S:
                full = lg_n
        cache = tm.init_cache(1, S, device="cpu")
        for name in ("k", "v"):
            cache["moe"][name][:, :, :S - 1] = caches["moe"][name]
        lg, _ = tm.decode_step(tp, cache, {"token": toks[:, -1],
                                           "pos": torch.tensor(S - 1)})
    last_kept = [a - b for a, b in zip(kept[S], kept[S - 1])]
    agree = np.allclose(lg.numpy(), full.numpy(), rtol=1e-4, atol=1e-4)
    assert agree == (last_kept == [k] * cfg.n_layers), (last_kept, agree)
    if cf == 2.0:
        assert agree, last_kept


def test_serve_engine_tokens_equal_reference_engine():
    """Reduced f32 granite, three slots over six requests, two of them past
    the window: the port's engine gives the reference engine's tokens and
    request steps (the filler rows take expert slots on both, ROADMAP R9)."""
    jm, tm, jp, tp = _lm_pair("float32")
    rng = np.random.default_rng(0)
    reqs = [(list(rng.integers(0, tm.cfg.vocab_size, n)), new)
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
    assert results[1] == results[0]


def test_launchers_run_reduced_granite_on_cpu(tmp_path):
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    run = launch_train.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                             "--device", "cpu", "--steps", "12", "--batch",
                             "4", "--seq", "64", "--ckpt-dir",
                             str(tmp_path / "ckpt")])
    assert run["arch"] == "granite-moe-1b-a400m"
    assert all(np.isfinite(run["losses"]))
    assert np.mean(run["losses"][-3:]) < np.mean(run["losses"][:3])
    launch_serve.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                       "--device", "cpu", "--requests", "3", "--max-new",
                       "4"])
