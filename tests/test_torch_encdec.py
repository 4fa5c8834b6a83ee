"""The port's Whisper-style encoder-decoder (``EncDecLM``) against the JAX
reference, on the CPU.

The reduced whisper-small (2 encoder and 2 decoder layers, d_model 64, 4
heads over 2 KV heads, 16 stub frames, LayerNorm, GELU, learned positions):
the full-width tree against ``jax.eval_shape``, the synthetic batches
(``frames`` included), cross-attention and its decode route, ``loss_fn`` and
every gradient (``xattn``, ``enc_pos`` and ``embed.positions`` among them),
an encoder of 100 frames that the 64-wide key chunks pad to 128,
``prefill``'s logits and both caches (``"self"`` and ``"cross"``),
``decode_step`` from the reference's caches, prefill-then-decode, a
five-step ``Trainer`` trajectory and the launcher. Parameters come from the
reference's ``init(PRNGKey(0))``, moved across by tree path
(:mod:`repro_torch.bridge`). The JAX side is compiled with
``xla_allow_excess_precision=False`` so that its bf16 arithmetic rounds
where its source says, as the port's does (ROADMAP.md R5).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jax_store
from repro.config import EncDecConfig as JaxEncDecConfig
from repro.config import reduced as jax_reduced
from repro.configs import get as jax_get
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.models import attention as jax_attn
from repro.models import build_model as jax_build_model
from repro.train import loop as jax_loop
from repro.train import optimizer as jax_opt
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.config import EncDecConfig, reduced
from repro_torch.configs import get
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models import LM, EncDecLM, build_model
from repro_torch.models import attention as attn
from repro_torch.train.loop import Trainer, _value_and_grad
from repro_torch.train.optimizer import AdamWConfig

ARCH = "whisper-small"
EXACT = {"xla_allow_excess_precision": False}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# f32: the same math in another summation order; bf16: both round at the
# same ops, and 2e-2 (the reference's bf16 kernel tolerance, as
# test_torch_model_decode.py) covers the ulp flips that order still causes
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


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


def _cfgs(dtype="float32", **over):
    jover = dict(over)
    if "encdec" in over:
        jover["encdec"] = JaxEncDecConfig(**dataclasses.asdict(over["encdec"]))
    return (jax_reduced(jax_get(ARCH), dtype=dtype, **jover),
            reduced(get(ARCH), dtype=dtype, **over))


def _models(dtype="float32", **over):
    jcfg, tcfg = _cfgs(dtype, **over)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = bridge.load_params(tm, _leaves(jp), device="cpu")
    return jm, tm, jp, tp


def _batch(cfg, B=2, S=24, seed=3):
    """Tokens, labels and stub frames (float32, as the pipeline makes
    them), for both sides."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "frames": rng.standard_normal(
             (B, cfg.encdec.encoder_seq, cfg.d_model)).astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _cache_pairs(tc, jc):
    """(name, port leaf, reference leaf) over a cache tree."""
    j = dict(zip([jax_store._leaf_name(p) for p, _ in
                  jax.tree_util.tree_flatten_with_path(jc)[0]],
                 jax.tree_util.tree_leaves(jc)))
    t = dict(tree_util.named_leaves(tc))
    assert sorted(t) == sorted(j)
    return [(name, t[name], j[name]) for name in sorted(t)]


# -------------------------------------------------------------- the model
def test_build_model_gives_encdeclm_with_the_reference_tree():
    """``build_model`` gives the port's EncDecLM; at full width its leaf
    names, shapes and dtypes are those of ``jax.eval_shape`` of the
    reference's init; LM refuses an encoder-decoder config."""
    cfg = get(ARCH)
    tm = build_model(cfg)
    assert isinstance(tm, EncDecLM)
    assert isinstance(build_model(reduced(cfg)), EncDecLM)
    shapes = jax.eval_shape(jax_build_model(jax_get(ARCH)).init,
                            jax.random.PRNGKey(0))
    want = {jax_store._leaf_name(path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {name: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for name, t in tree_util.named_leaves(
               tm.init(torch.Generator(), device="meta"))}
    assert got == want
    assert got["embed.positions"][0] == (32776, 768)
    assert got["enc_pos"][0] == (1500, 768)
    assert got["decoder.xattn.wq"][0] == (12, 768, 12, 64)
    assert got["decoder.xattn.bk"][0] == (12, 12, 64)
    assert "xattn" not in {n.split(".")[1] for n in got
                           if n.startswith("encoder.")}
    n = sum(int(np.prod(s)) for s, _ in got.values())
    assert 0.28e9 < n < 0.32e9
    with pytest.raises(ValueError, match="EncDecLM"):
        LM(cfg)
    with pytest.raises(ValueError, match="not an encoder-decoder"):
        EncDecLM(get("exanest-lm-100m"))


def test_bridge_loads_the_whisper_tree():
    _, tm, jp, tp = _models()
    leaves = _leaves(jp)
    assert bridge.leaf_names(tm) == sorted(leaves)
    for name in ("enc_pos", "decoder.xattn.wq", "decoder.xattn.bv",
                 "decoder.ln_x.bias", "embed.positions"):
        t = dict(tree_util.named_leaves(tp))[name]
        np.testing.assert_array_equal(t.numpy(), leaves[name])
    with pytest.raises(ValueError, match="missing"):
        bridge.load_params(tm, {k: v for k, v in leaves.items()
                                if k != "decoder.xattn.wk"}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        bridge.load_params(tm, {**leaves, "enc_pos": leaves["enc_pos"][:3]},
                           device="cpu")


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("step", [0, 5])
def test_synthetic_batches_equal_reference(step, full):
    """``SyntheticTokens.batch_at`` gives the reference's tokens, labels
    and stub frames bit for bit (full width: 1,500 frames of 768)."""
    jcfg, tcfg = ((jax_get(ARCH), get(ARCH)) if full else _cfgs())
    want = JaxTokens(jcfg, batch=2, seq=16, seed=4).batch_at(step)
    got = SyntheticTokens(tcfg, batch=2, seq=16, seed=4,
                          device="cpu").batch_at(step)
    assert sorted(got) == sorted(want) == ["frames", "labels", "tokens"]
    assert got["frames"].shape == (2, tcfg.encdec.encoder_seq, tcfg.d_model)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# -------------------------------------------------------- cross-attention
@pytest.mark.parametrize("s_enc", [16, 100], ids=["whole", "ragged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_and_decode_match_reference(dtype, s_enc):
    """``cross_kv`` and ``cross_attention`` over an encoder of ``s_enc``
    frames (100 pads to two 64-wide key chunks), and ``cross_decode`` (the
    decode route: ``decode_attn`` at length S_enc) against the reference's
    query and ``decode_attention`` over the whole cache."""
    jcfg, tcfg = _cfgs(dtype)
    rng = np.random.default_rng(11)
    d, H, K, hd = 64, 4, 2, 16
    p = {"wq": (d, H, hd), "wk": (d, K, hd), "wv": (d, K, hd),
         "wo": (H, hd, d), "bq": (H, hd), "bk": (K, hd), "bv": (K, hd)}
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.2
         for k, s in p.items()}
    x = rng.standard_normal((2, 9, d)).astype(np.float32)
    enc = rng.standard_normal((2, s_enc, d)).astype(np.float32)
    jp = {k: jnp.asarray(v).astype(JD[dtype]) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(TD[dtype]) for k, v in p.items()}
    jx, jenc = (jnp.asarray(a).astype(JD[dtype]) for a in (x, enc))
    tx, tenc = (torch.from_numpy(a).to(TD[dtype]) for a in (x, enc))

    def jax_side(pp, xx, ee):
        kv = jax_attn.cross_kv(pp, ee, jcfg)
        full = jax_attn.cross_attention(pp, xx, jcfg, kv)
        q = jnp.einsum("bsd,dhk->bshk", xx[:, -1:], pp["wq"]) + pp["bq"]
        o = jax_attn.decode_attention(q, kv[0], kv[1], kv[0].shape[1] - 1)
        return kv, full, jnp.einsum("bshk,hkd->bsd", o, pp["wo"])

    (jk, jv), jfull, jdec = _run(jax_side, jp, jx, jenc)
    tk, tv = attn.cross_kv(tp, tenc, tcfg)
    tfull = attn.cross_attention(tp, tx, tcfg, (tk, tv))
    tdec = attn.cross_decode(tp, tx[:, -1:], tcfg, (tk, tv))
    assert tk.shape == (2, s_enc, K, hd) and tfull.dtype == TD[dtype]
    tol = TOL[dtype]
    for name, got, want in (("k", tk, jk), ("v", tv, jv), ("out", tfull, jfull),
                            ("decode", tdec, jdec)):
        _close(got, want, tol, name)


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
    # the encoder's and the cross path's leaves are trained
    for name in ("enc_pos", "encoder.attn.wq", "decoder.xattn.wk",
                 "decoder.xattn.wq", "decoder.ln_x.scale", "embed.positions"):
        assert np.abs(tg[name]).max() > 0, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_encoder_matches_reference(dtype):
    """An encoder of 100 frames (``EncDecConfig(2, 100)``): the non-causal
    encoder and the cross-attention pad 100 keys to 128 under 64-wide
    chunks and mask the padding; loss, every gradient and prefill's
    logits and caches."""
    jm, tm, jp, tp = _models(dtype, encdec=EncDecConfig(2, 100))
    assert tm.cfg.kv_chunk == 64 and tm.cfg.encdec.encoder_seq == 100
    jb, tb = _batch(tm.cfg, S=20)
    assert tb["frames"].shape == (2, 100, 64)
    j_loss, j_grads = _run(jax.value_and_grad(jm.loss_fn), jp, jb)
    t_loss, t_grads = _value_and_grad(tm, tp, tb, None)
    tol = TOL[dtype]
    _close(t_loss, j_loss, tol, "loss")
    jg, tg = _leaves(j_grads), bridge.tree_to_numpy(t_grads)
    for name in jg:
        _close_scaled(tg[name], jg[name], tol, name)
    pb = {k: jb[k] for k in ("tokens", "frames")}
    j_lg, j_c = _run(jm.prefill, jp, pb)
    with torch.no_grad():
        t_lg, t_c = tm.prefill(tp, {k: tb[k] for k in ("tokens", "frames")})
    _close(t_lg, j_lg, tol, "logits")
    assert t_c["cross"][0].shape == (2, 2, 100, 2, 16)
    for name, t, j in _cache_pairs(t_c, j_c):
        _close_scaled(t, j, tol, name)


# ------------------------------------------------------------------ serving
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_reference(dtype):
    jm, tm, jp, tp = _models(dtype)
    jb, tb = _batch(tm.cfg)
    pb = ("tokens", "frames")
    j_lg, j_c = _run(jm.prefill, jp, {k: jb[k] for k in pb})
    with torch.no_grad():
        t_lg, t_c = tm.prefill(tp, {k: tb[k] for k in pb})
    assert t_lg.dtype == torch.float32 and t_lg.shape == (
        2, 1, tm.cfg.vocab_size)
    _close(t_lg, j_lg, TOL[dtype], "logits")
    assert sorted(t_c) == ["cross", "self"] and isinstance(t_c["cross"],
                                                           tuple)
    assert t_c["self"]["k"].shape == (2, 2, 24, 2, 16)
    assert t_c["cross"][1].shape == (2, 2, 16, 2, 16)
    for name, t, j in _cache_pairs(t_c, j_c):
        _close_scaled(t, j, TOL[dtype], name)


def _window(model, caches, B, S, xp):
    """``caches`` of a prefill of S - 1 tokens with their self caches
    written into a zero cache of an S window (``xp``: the port's tensors
    or the reference's)."""
    if xp is torch:
        out = model.init_cache(B, S, device="cpu")
        for name in ("k", "v"):
            out["self"][name][:, :, :S - 1] = caches["self"][name]
        for dst, src in zip(out["cross"], caches["cross"]):
            dst.copy_(src)
        return out
    out = model.init_cache(B, S)
    return {"self": {name: out["self"][name].at[:, :, :S - 1].set(
        caches["self"][name]) for name in ("k", "v")},
        "cross": caches["cross"]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(dtype):
    """One decode step from the same caches (the reference's prefill of
    S - 1 tokens, moved across) in both: logits and the updated caches;
    the cross caches are read, not written."""
    jm, tm, jp, tp = _models(dtype)
    S = 24
    jb, tb = _batch(tm.cfg, S=S)
    _, j_c = _run(jm.prefill, jp, {"tokens": jb["tokens"][:, :-1],
                                   "frames": jb["frames"]})
    j_cache = _window(jm, j_c, 2, S, jnp)
    template = tm.init_cache(2, S, device="cpu")
    t_cache = tree_util.unflatten(template, [
        torch.tensor(_np(leaf), dtype=t.dtype) for leaf, t in zip(
            jax.tree_util.tree_leaves(j_cache), tree_util.leaves(template))])
    cross_before = [t.clone() for t in t_cache["cross"]]
    step = {"token": jb["tokens"][:, -1], "pos": jnp.int32(S - 1)}
    j_lg, j_new = _run(jm.decode_step, jp, j_cache, step)
    with torch.no_grad():
        t_lg, t_new = tm.decode_step(tp, t_cache, {
            "token": tb["tokens"][:, -1], "pos": torch.tensor(S - 1)})
    assert t_new is t_cache
    tol = TOL[dtype]
    _close(t_lg, j_lg, tol, "logits")
    for name, t, j in _cache_pairs(t_new, j_new):
        _close(t, j, tol, name)
    for t, before in zip(t_new["cross"], cross_before):
        assert torch.equal(t, before)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_full_prefill(dtype):
    """Prefill S-1 tokens, then one decode step from its caches (the self
    caches copied into an S window, per-row positions as a (B,) vector)
    gives the last logits of a prefill of all S tokens (the reference's
    test_decode_matches_prefill_* at 3e-2, on the port alone)."""
    _, tm, _, tp = _models(dtype)
    S = 24
    _, tb = _batch(tm.cfg, S=S)
    toks, frames = tb["tokens"], tb["frames"]
    with torch.no_grad():
        full, _ = tm.prefill(tp, {"tokens": toks, "frames": frames})
        _, caches = tm.prefill(tp, {"tokens": toks[:, :-1], "frames": frames})
        cache = _window(tm, caches, 2, S, torch)
        lg, out = tm.decode_step(tp, cache, {
            "token": toks[:, -1], "pos": torch.full((2,), S - 1)})
    assert out is cache
    assert cache["self"]["k"][:, :, S - 1].abs().amax() > 0
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
    jb0 = jdata.batch_at(0)
    jstep = jax.jit(jtr.make_step(jit=False)).lower(jstate, jb0).compile(
        compiler_options=EXACT)
    tstep = ttr.make_step()
    j_losses, t_losses = [], []
    for i in range(5):
        jstate, jmet = jstep(jstate, jdata.batch_at(i))
        tstate, tmet = tstep(tstate, tdata.batch_at(i))
        j_losses.append(float(jmet["loss"]))
        t_losses.append(float(tmet["loss"]))
    tol = TOL[dtype]
    np.testing.assert_allclose(t_losses, j_losses, rtol=tol, atol=tol)
    assert t_losses[-1] < t_losses[0]


def test_launcher_trains_whisper_on_cpu(tmp_path):
    from repro_torch.launch import train as launch_train
    out = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--steps", "5", "--batch", "2", "--seq", "24",
                             "--ckpt-dir", str(tmp_path)])
    assert out["arch"] == ARCH and len(out["losses"]) == 5
    assert np.isfinite(out["losses"]).all()
    assert (tmp_path / "step-00000000" / "manifest.json").exists()
    assert out["state"]["params"]["decoder"]["xattn"]["wq"].shape == (
        2, 64, 4, 16)


@pytest.mark.parametrize("arch", [ARCH, "internvl2-1b"])
def test_serve_engine_refuses_frames_and_patches(arch):
    """The engine teacher-forces prompts through ``decode_step``, which
    takes no frames or patches: it refuses both families (whisper would
    attend to a zero cross cache) rather than serve them wrong."""
    from repro_torch.serve.engine import ServeEngine
    model = build_model(reduced(get(arch)))
    with pytest.raises(NotImplementedError, match="item 5b"):
        ServeEngine(model, {}, slots=2, window=8, device="cpu")
