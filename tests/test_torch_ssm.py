"""The port's Mamba-2 family (``SSMLM``) against the JAX reference, on the
CPU.

Same numpy inputs into both: ``rmsnorm_gated``, the causal conv with and
without left context, ``_segsum``, ``ssd_chunked`` (f32 and bf16, ragged
length), ``mamba2_forward``/``mamba2_decode``, ``SSMLM.loss_fn`` and its
gradients, ``prefill`` logits and states, prefill-then-decode against the
full prefill, a five-step ``Trainer`` trajectory, and the launcher. Model
parameters come from the reference's ``init(PRNGKey(0))``, moved across by
tree path (:mod:`repro_torch.bridge`). The JAX side is compiled with
``xla_allow_excess_precision=False`` so that its bf16 arithmetic rounds
where its source says, as the port's does (ROADMAP.md R5).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import _leaf_name
from repro.config import reduced as jax_reduced
from repro.configs import get as jax_get
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.models import ssm as jax_ssm
from repro.train import loop as jax_loop
from repro.train import optimizer as jax_opt
from repro_torch import bridge
from repro_torch.config import reduced
from repro_torch.configs import get
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models import SSMLM, build_model
from repro_torch.models import layers, ssm
from repro_torch.train.loop import Trainer, _value_and_grad
from repro_torch.train.optimizer import AdamWConfig

ARCH = "mamba2-2.7b"
EXACT = {"xla_allow_excess_precision": False}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# f32: summation order only; bf16: both round at the same ops, and one bf16
# ulp flip in an activation moves a value by up to ~1e-2 relative (as
# MODEL_TOL in test_torch_train_step.py)
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {_leaf_name(path): np.asarray(
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
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=msg)


def _cfgs(dtype="float32"):
    return (jax_reduced(jax_get(ARCH), dtype=dtype),
            reduced(get(ARCH), dtype=dtype))


def _models(dtype="float32"):
    jcfg, tcfg = _cfgs(dtype)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = bridge.load_params(tm, _leaves(jp), device="cpu")
    return jm, tm, jp, tp


def _batch(vocab, B=2, S=72, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


def _pair(arr, dtype):
    return jnp.asarray(arr).astype(JD[dtype]), torch.from_numpy(arr).to(
        TD[dtype])


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_gated_matches_reference(dtype):
    rng = np.random.default_rng(1)
    scale = rng.standard_normal(48).astype(np.float32)
    jx, tx = _pair(rng.standard_normal((2, 5, 48), np.float32), dtype)
    jg, tg = _pair(rng.standard_normal((2, 5, 48), np.float32) * 3, dtype)
    want = _run(jax_layers.rmsnorm_gated, jnp.asarray(scale), jx, jg)
    got = layers.rmsnorm_gated(torch.from_numpy(scale), tx, tg)
    assert got.dtype == TD[dtype]
    # same casts op by op: bit for bit in f32 up to summation order of the
    # mean; bf16 output rounds once more
    _close(got, want, {"float32": 1e-6, "bfloat16": 1e-2}[dtype])


@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(dtype, with_prev):
    rng = np.random.default_rng(2)
    W, C = 4, 24
    jx, tx = _pair(rng.standard_normal((2, 9, C), np.float32), dtype)
    jw, tw = _pair(rng.standard_normal((W, C), np.float32) * 0.3, dtype)
    jb, tb = _pair(rng.standard_normal(C).astype(np.float32) * 0.1, dtype)
    jprev = tprev = None
    if with_prev:
        jprev, tprev = _pair(rng.standard_normal((2, W - 1, C), np.float32),
                             dtype)
    j_out, j_state = _run(
        lambda x, w, b, pv: jax_ssm._causal_conv(x, w, b, pv), jx, jw, jb,
        jprev)
    t_out, t_state = ssm._causal_conv(tx, tw, tb, tprev)
    assert t_out.dtype == TD[dtype] and t_state.shape == (2, W - 1, C)
    _close(t_out, j_out, {"float32": 1e-6, "bfloat16": 1e-2}[dtype])
    _close(t_state, j_state, 0.0)


def test_segsum_matches_reference():
    x = np.random.default_rng(3).standard_normal((2, 3, 16)).astype(
        np.float32)
    want = np.asarray(jax_ssm._segsum(jnp.asarray(x)))
    got = ssm._segsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    live = np.isfinite(want)
    np.testing.assert_allclose(got[live], want[live], rtol=1e-5, atol=1e-5)


# the reference's chunked-form tolerances: f32 1e-4
# (test_ssd_scan_matches_model_chunked_form); bf16: both round M, x·dt, B,
# C, the decays and the entering states to bf16 at the same places, and a
# one-ulp flip of an operand moves an output by ~1e-2 relative
CHUNKED_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


@pytest.mark.parametrize("l", [64, 50])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_reference(dtype, l):
    b, h, p, n, chunk = 2, 4, 8, 16, 16
    rng = np.random.default_rng(l)
    jx, tx = _pair(rng.standard_normal((b, l, h, p), np.float32), dtype)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h).astype(np.float32) * 0.3)
    jB, tB = _pair(rng.standard_normal((b, l, 1, n), np.float32), dtype)
    jC, tC = _pair(rng.standard_normal((b, l, 1, n), np.float32), dtype)
    j_y, j_st = _run(lambda *a: jax_ssm.ssd_chunked(*a, chunk=chunk), jx,
                     jnp.asarray(dt), jnp.asarray(A), jB, jC)
    t_y, t_st = ssm.ssd_chunked(tx, torch.from_numpy(dt),
                                torch.from_numpy(A), tB, tC, chunk)
    assert t_y.shape == (b, l, h, p) and t_y.dtype == torch.float32
    scale = max(1.0, float(np.abs(_np(j_y)).max()))
    _close(t_y / scale, _np(j_y) / scale, CHUNKED_TOL[dtype], "y")
    scale = max(1.0, float(np.abs(_np(j_st)).max()))
    _close(t_st / scale, _np(j_st) / scale, CHUNKED_TOL[dtype], "state")


def _block_params(dtype):
    jm, tm, jp, tp = _models(dtype)
    jl = jax.tree_util.tree_map(lambda t: t[0], jp["stack"]["ssm"])
    tl = {k: v[0] for k, v in tp["stack"]["ssm"].items()}
    return tm.cfg, jm.cfg, jl, tl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_forward_and_decode_match_reference(dtype):
    """Layer 0 of the reduced model: the full-sequence form (ragged 40 on
    chunk 32) and one decode step continuing from its states."""
    tcfg, jcfg, jl, tl = _block_params(dtype)
    rng = np.random.default_rng(4)
    jx, tx = _pair(rng.standard_normal((2, 40, tcfg.d_model), np.float32),
                   dtype)
    jt, tt = _pair(rng.standard_normal((2, 1, tcfg.d_model), np.float32),
                   dtype)
    j_y, j_st = _run(lambda p, x: jax_ssm.mamba2_forward(p, x, jcfg), jl, jx)
    with torch.no_grad():
        t_y, t_st = ssm.mamba2_forward(tl, tx, tcfg)
    tol = TOL[dtype]
    _close(t_y, j_y, tol, "y")
    _close(t_st["ssm"], j_st["ssm"], tol, "ssm state")
    for i in range(3):
        _close(t_st["conv"][i], j_st["conv"][i], tol, f"conv state {i}")
    j_d, j_dst = _run(lambda p, x, s: jax_ssm.mamba2_decode(p, x, jcfg, s),
                      jl, jt, j_st)
    with torch.no_grad():
        t_d, t_dst = ssm.mamba2_decode(tl, tt, tcfg, t_st)
    _close(t_d, j_d, tol, "decode y")
    _close(t_dst["ssm"], j_dst["ssm"], tol, "decode ssm state")


# -------------------------------------------------------------------- model
def test_build_model_gives_ssmlm_with_the_reference_tree():
    """Full width: ``build_model`` gives the port's SSMLM, and its meta
    parameters have the reference's leaf names, shapes and dtypes."""
    jm = jax_build_model(jax_get(ARCH))
    tm = build_model(get(ARCH))
    assert isinstance(tm, SSMLM)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    want = {_leaf_name(path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    from repro_torch import tree as tree_util
    got = {name: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for name, t in tree_util.named_leaves(
               tm.init(torch.Generator(), device="meta"))}
    assert got == want
    assert got["stack.ssm.wx"][0] == (64, 2560, 5120)
    with pytest.raises(ValueError, match="SSMLM"):
        from repro_torch.models import LM
        LM(get(ARCH))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_and_grads_match_reference(dtype):
    jm, tm, jp, tp = _models(dtype)
    jb, tb = _batch(tm.cfg.vocab_size)
    j_loss, j_grads = _run(jax.value_and_grad(jm.loss_fn), jp, jb)
    t_loss, t_grads = _value_and_grad(tm, tp, tb, None)
    tol = TOL[dtype]
    _close(t_loss, j_loss, tol, "loss")
    jg = _leaves(j_grads)
    tg = bridge.tree_to_numpy(t_grads)
    assert sorted(jg) == sorted(tg)
    for name in jg:
        scale = max(1.0, float(np.abs(jg[name]).max()))
        np.testing.assert_allclose(tg[name] / scale, jg[name] / scale,
                                   rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_reference(dtype):
    jm, tm, jp, tp = _models(dtype)
    jb, tb = _batch(tm.cfg.vocab_size)
    j_lg, j_st = _run(jm.prefill, jp, {"tokens": jb["tokens"]})
    with torch.no_grad():
        t_lg, t_st = tm.prefill(tp, {"tokens": tb["tokens"]})
    assert t_lg.dtype == torch.float32 and t_lg.shape == (
        2, 1, tm.cfg.vocab_size)
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    _close(t_lg, j_lg, tol, "logits")
    L = tm.cfg.n_layers
    assert t_st["ssm"].shape[0] == L and len(t_st["conv"]) == 3
    _close(t_st["ssm"], j_st["ssm"], tol, "ssm states")
    for i in range(3):
        _close(t_st["conv"][i], j_st["conv"][i], tol, f"conv states {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_full_prefill(dtype):
    """Prefill S-1 tokens, then one decode step from its states gives the
    last logits of a prefill of all S tokens (the reference's
    test_ssm_decode_matches_prefill, 3e-2, on the port alone); the states
    are updated in place, and a zero cache of init_cache takes states."""
    _, tm, _, tp = _models(dtype)
    _, tb = _batch(tm.cfg.vocab_size, S=40)
    toks = tb["tokens"]
    with torch.no_grad():
        full, _ = tm.prefill(tp, {"tokens": toks})
        _, states = tm.prefill(tp, {"tokens": toks[:, :-1]})
        cache = tm.init_cache(2, 40, device="cpu")
        for dst, src in zip((*cache["conv"], cache["ssm"]),
                            (*states["conv"], states["ssm"])):
            assert dst.shape == src.shape and dst.dtype == src.dtype
            dst.copy_(src)
        before = cache["ssm"].clone()
        lg, out = tm.decode_step(tp, cache, {"token": toks[:, -1],
                                             "pos": torch.tensor(39)})
    assert out is cache and not torch.equal(cache["ssm"], before)
    _close(lg, full, 3e-2)


# ---------------------------------------------------------------- training
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainer_five_step_trajectory_matches_reference(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    ocfg = dict(lr=3e-3, warmup_steps=1, decay_steps=5)
    jtr = jax_loop.Trainer(jm, jax_opt.AdamWConfig(**ocfg))
    ttr = Trainer(tm, AdamWConfig(**ocfg), device="cpu")
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    tstate = bridge.load_train_state(tm, ttr.opt_cfg, _leaves(jstate),
                                     device="cpu")
    jdata = JaxTokens(jcfg, batch=2, seq=64)
    tdata = SyntheticTokens(tcfg, batch=2, seq=64, device="cpu")
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


def test_launcher_trains_mamba2_on_cpu(tmp_path):
    from repro_torch.launch import train as launch_train
    out = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--steps", "3", "--batch", "2", "--seq", "40",
                             "--ckpt-dir", str(tmp_path)])
    assert out["arch"] == ARCH and len(out["losses"]) == 3
    assert np.isfinite(out["losses"]).all()
    assert (tmp_path / "step-00000000" / "manifest.json").exists()
    assert out["state"]["params"]["stack"]["ssm"]["wx"].shape[0] == 2
