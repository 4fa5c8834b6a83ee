"""The port's VLM patch prefix (``LM`` on internvl2-1b) against the JAX
reference, on the CPU.

The reduced internvl2-1b (2 layers, d_model 64, 4 heads over 2 KV heads
with QKV bias, RoPE, 8 stub patches): the full-width tree against
``jax.eval_shape``, the synthetic batches (``patches`` included),
``loss_fn`` and every gradient, ``prefill``'s logits and caches (the patch
positions first), ``decode_step`` from the reference's caches at a ``pos``
that counts the patches, prefill-then-decode, a five-step ``Trainer``
trajectory and the launcher. Parameters come from the reference's
``init(PRNGKey(0))``, moved across by tree path (:mod:`repro_torch.bridge`).
The JAX side is compiled with ``xla_allow_excess_precision=False`` (R5).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jax_store
from repro.config import reduced as jax_reduced
from repro.configs import get as jax_get
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.models import build_model as jax_build_model
from repro.train import loop as jax_loop
from repro.train import optimizer as jax_opt
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.config import reduced
from repro_torch.configs import get
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models import LM, build_model
from repro_torch.train.loop import Trainer, _value_and_grad
from repro_torch.train.optimizer import AdamWConfig

ARCH = "internvl2-1b"
EXACT = {"xla_allow_excess_precision": False}
# as test_torch_model_decode.py: f32 summation order; bf16 ulp flips
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
NP = 8                                    # patches of the reduced config


def _leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax_store._leaf_name(path): np.asarray(
        leaf.astype(jnp.float32) if leaf.dtype == jnp.bfloat16 else leaf)
        for path, leaf in flat}


def _run(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)(*args)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=msg)


def _close_scaled(got, want, tol, msg=""):
    """Within ``tol`` of the largest |value| (at least 1), as the
    gradients are held."""
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got) / scale, want / scale, rtol=tol,
                               atol=tol, err_msg=msg)


def _cfgs(dtype="float32"):
    return (jax_reduced(jax_get(ARCH), dtype=dtype),
            reduced(get(ARCH), dtype=dtype))


def _models(dtype="float32"):
    jcfg, tcfg = _cfgs(dtype)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = bridge.load_params(tm, _leaves(jp), device="cpu")
    return jm, tm, jp, tp


def _batch(cfg, B=2, S=24, seed=3):
    """Tokens, labels and stub patches (float32, as the pipeline makes
    them: a bf16 model rounds them first), for both sides."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "patches": rng.standard_normal(
             (B, cfg.vision.n_patches, cfg.d_model)).astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _cache_pairs(tc, jc):
    j = dict(zip([jax_store._leaf_name(p) for p, _ in
                  jax.tree_util.tree_flatten_with_path(jc)[0]],
                 jax.tree_util.tree_leaves(jc)))
    t = dict(tree_util.named_leaves(tc))
    assert sorted(t) == sorted(j)
    return [(name, t[name], j[name]) for name in sorted(t)]


# -------------------------------------------------------------- the model
def test_build_model_gives_lm_with_the_reference_tree():
    """``build_model`` gives the port's LM; at full width its leaf names,
    shapes and dtypes are those of ``jax.eval_shape`` of the reference's
    init (QKV bias, 14 heads over 2 KV heads)."""
    cfg = get(ARCH)
    tm = build_model(cfg)
    assert isinstance(tm, LM) and isinstance(build_model(reduced(cfg)), LM)
    shapes = jax.eval_shape(jax_build_model(jax_get(ARCH)).init,
                            jax.random.PRNGKey(0))
    want = {jax_store._leaf_name(path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {name: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for name, t in tree_util.named_leaves(
               tm.init(torch.Generator(), device="meta"))}
    assert got == want
    assert got["dense_stack.attn.wq"][0] == (24, 896, 14, 64)
    assert got["dense_stack.attn.bk"][0] == (24, 2, 64)
    assert got["embed.head"][0] == (896, 151655)
    n = sum(int(np.prod(s)) for s, _ in got.values())
    assert 0.60e9 < n < 0.66e9


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("step", [0, 5])
def test_synthetic_batches_equal_reference(step, full):
    """``SyntheticTokens.batch_at`` gives the reference's tokens, labels
    and stub patches bit for bit (full width: 256 patches of 896)."""
    jcfg, tcfg = ((jax_get(ARCH), get(ARCH)) if full else _cfgs())
    want = JaxTokens(jcfg, batch=2, seq=16, seed=4).batch_at(step)
    got = SyntheticTokens(tcfg, batch=2, seq=16, seed=4,
                          device="cpu").batch_at(step)
    assert sorted(got) == sorted(want) == ["labels", "patches", "tokens"]
    assert got["patches"].shape == (2, tcfg.vision.n_patches, tcfg.d_model)
    assert got["patches"].dtype == torch.float32
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ----------------------------------------------------------------- training
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_and_grads_match_reference(dtype):
    jm, tm, jp, tp = _models(dtype)
    jb, tb = _batch(tm.cfg)
    j_loss, j_grads = _run(jax.value_and_grad(jm.loss_fn), jp, jb)
    t_loss, t_grads = _value_and_grad(tm, tp, tb, None)
    tol = TOL[dtype]
    _close(t_loss, j_loss, tol, "loss")
    jg = _leaves(j_grads)
    tg = bridge.tree_to_numpy(t_grads)
    assert sorted(jg) == sorted(tg)
    for name in jg:
        _close_scaled(tg[name], jg[name], tol, name)
    assert np.abs(tg["dense_stack.attn.bq"]).max() > 0


def test_loss_reads_the_token_positions_only():
    """The patches enter the trunk (the loss moves with them) but no
    patch position is scored: the loss of a batch equals the loss of the
    trunk's token positions alone, computed by hand."""
    from repro_torch.models.layers import lm_loss
    _, tm, _, tp = _models()
    _, tb = _batch(tm.cfg)
    with torch.no_grad():
        loss = tm.loss_fn(tp, tb)
        x, positions = tm._inputs(tp["embed"], tb)
        assert x.shape[1] == NP + 24 and positions[0, -1] == NP + 23
        h, _ = tm._trunk(tp, x, positions)
        want = lm_loss(tp["embed"], h[:, NP:-1], tb["labels"][:, 1:],
                       tm.cfg)
        other = tm.loss_fn(tp, {**tb, "patches": tb["patches"] * 2})
    assert torch.equal(loss, want)
    assert not torch.equal(loss, other)


# ------------------------------------------------------------------ serving
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_reference(dtype):
    jm, tm, jp, tp = _models(dtype)
    jb, tb = _batch(tm.cfg)
    pb = ("tokens", "patches")
    j_lg, j_c = _run(jm.prefill, jp, {k: jb[k] for k in pb})
    with torch.no_grad():
        t_lg, t_c = tm.prefill(tp, {k: tb[k] for k in pb})
    assert t_lg.dtype == torch.float32 and t_lg.shape == (
        2, 1, tm.cfg.vocab_size)
    _close(t_lg, j_lg, TOL[dtype], "logits")
    assert t_c["dense"]["k"].shape == (2, 2, NP + 24, 2, 16)
    for name, t, j in _cache_pairs(t_c, j_c):
        _close_scaled(t, j, TOL[dtype], name)


def _window(model, caches, B, S, xp):
    """The caches of a prefill of ``S - 1`` positions (patches included)
    written into a zero cache of an ``S`` window."""
    if xp is torch:
        out = model.init_cache(B, S, device="cpu")
        for name in ("k", "v"):
            out["dense"][name][:, :, :S - 1] = caches["dense"][name]
        return out
    out = model.init_cache(B, S)
    return {"dense": {name: out["dense"][name].at[:, :, :S - 1].set(
        caches["dense"][name]) for name in ("k", "v")}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(dtype):
    """One decode step from the same caches (the reference's prefill of
    the patches and 23 tokens, moved across) at ``pos`` = 8 + 23, which
    counts the patches: logits and the updated caches."""
    jm, tm, jp, tp = _models(dtype)
    S = 24
    jb, tb = _batch(tm.cfg, S=S)
    W = NP + S
    _, j_c = _run(jm.prefill, jp, {"tokens": jb["tokens"][:, :-1],
                                   "patches": jb["patches"]})
    j_cache = _window(jm, j_c, 2, W, jnp)
    template = tm.init_cache(2, W, device="cpu")
    t_cache = tree_util.unflatten(template, [
        torch.tensor(_np(leaf), dtype=t.dtype) for leaf, t in zip(
            jax.tree_util.tree_leaves(j_cache), tree_util.leaves(template))])
    j_lg, j_new = _run(jm.decode_step, jp, j_cache,
                       {"token": jb["tokens"][:, -1], "pos": jnp.int32(W - 1)})
    with torch.no_grad():
        t_lg, t_new = tm.decode_step(tp, t_cache, {
            "token": tb["tokens"][:, -1], "pos": torch.tensor(W - 1)})
    assert t_new is t_cache
    tol = TOL[dtype]
    _close(t_lg, j_lg, tol, "logits")
    for name, t, j in _cache_pairs(t_new, j_new):
        _close(t, j, tol, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_full_prefill(dtype):
    """Prefill the patches and S-1 tokens, then one decode step at ``pos``
    = patches + S - 1 gives the last logits of a prefill of all S tokens
    (3e-2, the reference's test_decode_matches_prefill_* on the port)."""
    _, tm, _, tp = _models(dtype)
    S = 24
    _, tb = _batch(tm.cfg, S=S)
    toks, patches = tb["tokens"], tb["patches"]
    W = NP + S
    with torch.no_grad():
        full, _ = tm.prefill(tp, {"tokens": toks, "patches": patches})
        _, caches = tm.prefill(tp, {"tokens": toks[:, :-1],
                                    "patches": patches})
        cache = _window(tm, caches, 2, W, torch)
        lg, _ = tm.decode_step(tp, cache, {"token": toks[:, -1],
                                           "pos": torch.tensor(W - 1)})
    assert cache["dense"]["k"][:, :, W - 1].abs().amax() > 0
    _close(lg, full, 3e-2)


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
    jdata = JaxTokens(jcfg, batch=2, seq=32)
    tdata = SyntheticTokens(tcfg, batch=2, seq=32, device="cpu")
    jstep = jax.jit(jtr.make_step(jit=False)).lower(
        jstate, jdata.batch_at(0)).compile(compiler_options=EXACT)
    tstep = ttr.make_step()
    j_losses, t_losses = [], []
    for i in range(5):
        jstate, jmet = jstep(jstate, jdata.batch_at(i))
        tstate, tmet = tstep(tstate, tdata.batch_at(i))
        j_losses.append(float(jmet["loss"]))
        t_losses.append(float(tmet["loss"]))
    tol = TOL[dtype]
    np.testing.assert_allclose(t_losses, j_losses, rtol=tol, atol=tol)
    # five fresh batches of noise patches: the loss need not fall in five
    # steps, in either; the steps move it
    assert len(set(t_losses)) == 5


def test_launcher_trains_internvl_on_cpu(tmp_path):
    from repro_torch.launch import train as launch_train
    out = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--steps", "5", "--batch", "2", "--seq", "24",
                             "--ckpt-dir", str(tmp_path)])
    assert out["arch"] == ARCH and len(out["losses"]) == 5
    assert np.isfinite(out["losses"]).all()
    assert (tmp_path / "step-00000000" / "manifest.json").exists()
    assert out["state"]["params"]["dense_stack"]["attn"]["bq"].shape == (
        2, 4, 16)
