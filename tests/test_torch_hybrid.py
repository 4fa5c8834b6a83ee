"""The port's Zamba2-style hybrid (``HybridLM``) against the JAX reference,
on the CPU.

The reduced zamba2-2.7b (4 Mamba-2 layers in 2 groups of 2, each group
followed by the one shared attention + gated-GELU block): the gated GELU
MLP, ``loss_fn`` and every gradient (the shared block's summed over its
uses), ``prefill``'s logits and both caches, ``decode_step`` from the same
caches, prefill-then-decode against the full prefill, a five-step
``Trainer`` trajectory, the launcher, and checkpoints of the hybrid train
state both ways. Model parameters come from the reference's
``init(PRNGKey(0))``, moved across by tree path (:mod:`repro_torch.bridge`)
over the nested ``(G, group_size, ...)`` stack. The JAX side is compiled
with ``xla_allow_excess_precision=False`` so that its bf16 arithmetic
rounds where its source says, as the port's does (ROADMAP.md R5).
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
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.train import loop as jax_loop
from repro.train import optimizer as jax_opt
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.checkpoint.store import restore_checkpoint, save_checkpoint
from repro_torch.config import reduced
from repro_torch.configs import get
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models import LM, SSMLM, HybridLM, build_model
from repro_torch.models import layers
from repro_torch.train.loop import Trainer, _value_and_grad
from repro_torch.train.optimizer import AdamWConfig

ARCH = "zamba2-2.7b"
EXACT = {"xla_allow_excess_precision": False}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# MODEL_TOL of test_torch_train_step.py: f32 summation order only; bf16:
# both round at the same ops, and one bf16 ulp flip in an activation moves
# a value by up to ~1e-2 relative
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


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


def _batch(vocab, B=2, S=72, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


def _cache_pairs(tc, jc):
    """(name, port leaf, reference leaf) over a hybrid cache tree."""
    j = dict(zip([jax_store._leaf_name(p) for p, _ in
                  jax.tree_util.tree_flatten_with_path(jc)[0]],
                 jax.tree_util.tree_leaves(jc)))
    t = dict(tree_util.named_leaves(tc))
    assert sorted(t) == sorted(j)
    return [(name, t[name], j[name]) for name in sorted(t)]


# -------------------------------------------------------------- the model
def test_build_model_gives_hybridlm_and_lm_ssmlm_refuse_hybrid():
    """``build_model`` gives the port's HybridLM, at full width with the
    reference's leaf names, shapes and dtypes; LM and SSMLM refuse hybrid
    configs."""
    cfg = get(ARCH)
    tm = build_model(cfg)
    assert isinstance(tm, HybridLM)
    assert (tm.n_groups, tm.group_size) == (9, 6)
    assert cfg.ssm.n_groups == 1               # B/C groups, not layer groups
    assert isinstance(build_model(reduced(cfg)), HybridLM)
    assert build_model(reduced(cfg)).n_groups == 2
    shapes = jax.eval_shape(jax_build_model(jax_get(ARCH)).init,
                            jax.random.PRNGKey(0))
    want = {jax_store._leaf_name(path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {name: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for name, t in tree_util.named_leaves(
               tm.init(torch.Generator(), device="meta"))}
    assert got == want
    assert got["groups.ssm.wx"][0] == (9, 6, 2560, 5120)
    assert got["shared.attn.wq"][0] == (2560, 32, 80)
    for c in (cfg, reduced(cfg)):
        for cls in (LM, SSMLM):
            with pytest.raises(ValueError, match="HybridLM"):
                cls(c)
    with pytest.raises(ValueError, match="not a hybrid"):
        HybridLM(get("mamba2-2.7b"))


def test_bridge_loads_the_nested_group_stack():
    """Leaf names over the nested (G, group_size, ...) stack; each layer's
    weights land in their group and slot; bad leaves are refused."""
    _, tm, jp, tp = _models()
    leaves = _leaves(jp)
    assert bridge.leaf_names(tm) == sorted(leaves)
    wx = leaves["groups.ssm.wx"]
    assert wx.shape[:2] == (2, 2)
    got = tp["groups"]["ssm"]["wx"]
    for g in range(2):
        for i in range(2):
            np.testing.assert_array_equal(got[g, i].numpy(), wx[g, i])
    assert not np.array_equal(wx[0, 0], wx[1, 0])
    np.testing.assert_array_equal(tp["shared"]["ffn"]["w_gate"].numpy(),
                                  leaves["shared.ffn.w_gate"])
    with pytest.raises(ValueError, match="missing"):
        bridge.load_params(tm, {k: v for k, v in leaves.items()
                                if k != "shared.ffn.w_gate"}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        bridge.load_params(tm, {**leaves, "groups.ssm.wx": wx[:, :1]},
                           device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_gelu_mlp_matches_reference(dtype):
    """zamba2's gated GELU (tanh form) MLP, op by op as jax.nn writes it:
    in bf16 the two round at the same ops."""
    jcfg, tcfg = _cfgs(dtype)
    assert tcfg.mlp_act == "gelu" and tcfg.mlp_gated
    rng = np.random.default_rng(5)
    p = {name: rng.standard_normal(shape, np.float32) * 0.3
         for name, shape in (("w_gate", (64, 128)), ("w_up", (64, 128)),
                             ("w_out", (128, 64)))}
    x = rng.standard_normal((2, 9, 64), np.float32) * 2
    jp = {k: jnp.asarray(v).astype(JD[dtype]) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(TD[dtype]) for k, v in p.items()}
    want = _run(lambda pp, xx: jax_layers.apply_mlp(pp, xx, jcfg), jp,
                jnp.asarray(x).astype(JD[dtype]))
    got = layers.apply_mlp(tp, torch.from_numpy(x).to(TD[dtype]), tcfg)
    assert got.dtype == TD[dtype]
    _close_scaled(got, want, {"float32": 1e-5, "bfloat16": 1e-2}[dtype])
    # the activation alone: bit for bit in bf16
    z = rng.standard_normal((4096,), np.float32) * 4
    j_act = _run(jax.nn.gelu, jnp.asarray(z).astype(JD[dtype]))
    t_act = layers._act(tcfg, torch.from_numpy(z).to(TD[dtype]))
    _close(t_act, j_act, {"float32": 1e-6, "bfloat16": 0.0}[dtype])


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
    assert any(name.startswith("shared.") for name in jg)
    for name in jg:
        _close_scaled(tg[name], jg[name], tol, name)
    # the shared block's gradient sums its uses: not zero
    assert np.abs(tg["shared.attn.wq"]).max() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_reference(dtype):
    jm, tm, jp, tp = _models(dtype)
    jb, tb = _batch(tm.cfg.vocab_size)
    j_lg, j_c = _run(jm.prefill, jp, {"tokens": jb["tokens"]})
    with torch.no_grad():
        t_lg, t_c = tm.prefill(tp, {"tokens": tb["tokens"]})
    assert t_lg.dtype == torch.float32 and t_lg.shape == (
        2, 1, tm.cfg.vocab_size)
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    _close(t_lg, j_lg, tol, "logits")
    assert t_c["ssm"]["ssm"].shape[:2] == (2, 2)
    assert t_c["attn"]["k"].shape == (2, 2, 72, 4, 16)
    # the caches of the later group sit behind four SSM layers and a shared
    # block, where a bf16 ulp flip of an activation (1/128 of it) moves the
    # projections after it: each cache is held within TOL of its largest
    # value, as the gradients are
    for name, t, j in _cache_pairs(t_c, j_c):
        _close_scaled(t, j, TOL[dtype], name)


def _window(model, caches, B, S, xp):
    """``caches`` of a prefill of S - 1 tokens written into a zero cache
    of an S window (``xp``: the port's tensors or the reference's)."""
    out = model.init_cache(B, S, **({"device": "cpu"} if xp is torch
                                    else {}))
    if xp is torch:
        for dst, src in zip(tree_util.leaves(out["ssm"]),
                            tree_util.leaves(caches["ssm"])):
            dst.copy_(src)
        for name in ("k", "v"):
            out["attn"][name][:, :, :S - 1] = caches["attn"][name]
        return out
    return {"ssm": caches["ssm"],
            "attn": {name: out["attn"][name].at[:, :, :S - 1].set(
                caches["attn"][name]) for name in ("k", "v")}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(dtype):
    """One decode step from the same caches (the reference's prefill of
    S - 1 tokens, moved across) in both: logits and every updated cache."""
    jm, tm, jp, tp = _models(dtype)
    S = 40
    jb, tb = _batch(tm.cfg.vocab_size, S=S)
    _, j_c = _run(jm.prefill, jp, {"tokens": jb["tokens"][:, :-1]})
    j_cache = _window(jm, j_c, 2, S, jnp)
    t_cache = tree_util.unflatten(
        tm.init_cache(2, S, device="cpu"),
        [torch.tensor(_np(leaf), dtype=t.dtype) for leaf, t in zip(
            jax.tree_util.tree_leaves(j_cache),
            tree_util.leaves(tm.init_cache(2, S, device="cpu")))])
    step = {"token": jb["tokens"][:, -1], "pos": jnp.int32(S - 1)}
    j_lg, j_new = _run(jm.decode_step, jp, j_cache, step)
    with torch.no_grad():
        t_lg, t_new = tm.decode_step(tp, t_cache, {
            "token": tb["tokens"][:, -1], "pos": torch.tensor(S - 1)})
    assert t_new is t_cache
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    _close(t_lg, j_lg, tol, "logits")
    for name, t, j in _cache_pairs(t_new, j_new):
        _close(t, j, tol, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_full_prefill(dtype):
    """Prefill S-1 tokens, then one decode step from its caches (copied
    into an S window) gives the last logits of a prefill of all S tokens
    (the reference's test_decode_matches_prefill_* at 3e-2, on the port
    alone); the caches are updated in place: every group's SSM state and
    position S - 1 of every group's KV cache."""
    _, tm, _, tp = _models(dtype)
    S = 40
    _, tb = _batch(tm.cfg.vocab_size, S=S)
    toks = tb["tokens"]
    with torch.no_grad():
        full, _ = tm.prefill(tp, {"tokens": toks})
        _, caches = tm.prefill(tp, {"tokens": toks[:, :-1]})
        cache = _window(tm, caches, 2, S, torch)
        before = cache["ssm"]["ssm"].clone()
        lg, out = tm.decode_step(tp, cache, {"token": toks[:, -1],
                                             "pos": torch.tensor(S - 1)})
    assert out is cache
    for g in range(tm.n_groups):
        assert not torch.equal(cache["ssm"]["ssm"][g], before[g])
        assert cache["attn"]["k"][g, :, S - 1].abs().amax() > 0
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


def test_launcher_trains_zamba2_on_cpu(tmp_path):
    from repro_torch.launch import train as launch_train
    out = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--steps", "5", "--batch", "2", "--seq", "40",
                             "--ckpt-dir", str(tmp_path)])
    assert out["arch"] == ARCH and len(out["losses"]) == 5
    assert np.isfinite(out["losses"]).all()
    assert (tmp_path / "step-00000000" / "manifest.json").exists()
    assert out["state"]["params"]["groups"]["ssm"]["wx"].shape[:2] == (2, 2)


@functools.cache
def _stepped_reference_state():
    """The reference's bf16 hybrid train state after one step (moments and
    step off zero), and the port's trainer of the same config."""
    jcfg, tcfg = _cfgs("bfloat16")
    ocfg = dict(warmup_steps=1, decay_steps=4)
    jtr = jax_loop.Trainer(jax_build_model(jcfg), jax_opt.AdamWConfig(**ocfg))
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    tokens = jnp.asarray(np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 32)).astype(np.int32))
    jstate, _ = jtr.make_step()(jstate, {"tokens": tokens, "labels": tokens})
    return jstate, Trainer(build_model(tcfg), AdamWConfig(**ocfg),
                           device="cpu")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_hybrid_checkpoint_crosses_frameworks(tmp_path, writer):
    """A hybrid train state after one step (bf16 parameters over the
    nested group stack, AdamW moments, the step), written by one side and
    restored by the other: names, dtypes and values agree, and both write
    the same manifest."""
    jstate, ttr = _stepped_reference_state()
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
    assert "params.groups.ssm.wx" in got and "opt.m.shared.attn.wq" in got
    for path, leaf in flat:
        name = jax_store._leaf_name(path)
        t = got[name]
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), name
        np.testing.assert_array_equal(_np(t), _np(leaf), err_msg=name)
    manifests = [json.loads((tmp_path / d / "step-00000001" /
                             "manifest.json").read_text())["leaves"]
                 for d in ("w", "r")]
    assert manifests[0] == manifests[1]
