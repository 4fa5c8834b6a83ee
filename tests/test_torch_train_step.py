"""The port's training path against the JAX reference, on the CPU.

Same numpy inputs into both: flash attention forward and gradients,
``lm_loss``, ``LM.loss_fn`` and its gradients, ``LM.prefill``, one AdamW
update (float32 and int8-quantized moments), ``make_train_step`` with
microbatches, a five-step ``Trainer`` trajectory over ``SyntheticTokens``,
and the token stream itself. Model parameters come from the reference's
``init(PRNGKey(0))``, moved across by tree path
(:mod:`repro_torch.bridge`). The JAX side is compiled with
``xla_allow_excess_precision=False`` so that its bf16 arithmetic rounds
where its source says, as the port's does (ROADMAP.md R5).
"""

from __future__ import annotations

import dataclasses
import itertools

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
from repro.models.attention import flash_attention as jax_flash
from repro.models.layers import lm_loss as jax_lm_loss
from repro.train import loop as jax_loop
from repro.train import optimizer as jax_opt
from repro_torch import bridge
from repro_torch.config import reduced
from repro_torch.configs import get
from repro_torch.data.pipeline import Prefetcher, SyntheticTokens
from repro_torch.models import build_model
from repro_torch.models.attention import flash_attention
from repro_torch.models.layers import lm_loss
from repro_torch.train.loop import Trainer, _value_and_grad, make_train_step
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update

ARCH = "exanest-lm-100m"
EXACT = {"xla_allow_excess_precision": False}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {_leaf_name(path): np.asarray(
        leaf.astype(jnp.float32) if leaf.dtype == jnp.bfloat16 else leaf)
        for path, leaf in flat}


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)


def _models(dtype="float32", arch=ARCH, **over):
    jcfg = jax_reduced(jax_get(arch), dtype=dtype, **over)
    tcfg = reduced(get(arch), dtype=dtype, **over)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = bridge.load_params(tm, _leaves(jp), device="cpu")
    return jm, tm, jp, tp


def _batch(vocab, B=2, S=96, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


def _close(got, want, tol, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


# ----------------------------------------------------------- flash attention
# f32: the reference's oracle tolerance (test_model_flash_attention_oracle);
# bf16: both frameworks round p and ds to bf16 at the same places, so what
# is left is summation order inside float32 products flipping a bf16 ulp of
# the outputs (|values| < 4: one ulp is 2^-6)
FLASH_TOL = {"float32": 2e-3, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_forward_and_grads_match_reference(causal, rep, dtype):
    B, S, K, hd = 2, 96, 2, 32            # ragged: 96 is no multiple of 64
    H = K * rep
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal(s, np.float32)
               for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))
    dout = rng.standard_normal((B, S, H, hd), np.float32)
    jd, td = JD[dtype], TD[dtype]

    def jf(q, k, v):
        out = jax_flash(q, k, v, causal=causal, q_chunk=64, kv_chunk=64)
        return jnp.sum(out.astype(jnp.float32) * dout), out

    jargs = [jnp.asarray(x).astype(jd) for x in (q, k, v)]
    (_, j_out), j_grads = jax.value_and_grad(jf, (0, 1, 2), has_aux=True)(
        *jargs)
    targs = [torch.from_numpy(x).to(td).requires_grad_(True)
             for x in (q, k, v)]
    t_out = flash_attention(*targs, causal=causal, q_chunk=64, kv_chunk=64)
    (t_out.float() * torch.from_numpy(dout)).sum().backward()
    assert t_out.dtype == td and t_out.shape == (B, S, H, hd)
    tol = FLASH_TOL[dtype]
    _close(t_out, j_out, tol, "out")
    for name, t, g in zip("qkv", targs, j_grads):
        assert t.grad.dtype == td
        _close(t.grad, g, tol, f"d{name}")


def test_flash_attention_matches_naive_softmax():
    """The port on its own against plain softmax attention (the reference
    test's oracle), so a fault shared with the reference would show."""
    B, S, H, K, hd = 2, 96, 8, 2, 32
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((B, S, H, hd), np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, K, hd), np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, K, hd), np.float32))
    out = flash_attention(q, k, v, causal=True, q_chunk=64, kv_chunk=64)
    kk, vv = (t.repeat_interleave(H // K, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * hd ** -0.5
    s = s.masked_fill(~torch.tril(torch.ones(S, S, dtype=torch.bool)), -1e30)
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vv)
    _close(out, ref.numpy(), 2e-3)


# -------------------------------------------------------------------- loss
def test_lm_loss_with_padded_chunk_matches_reference():
    """T=100 with chunk 64 pads the last chunk with targets -1."""
    cfg_j = jax_reduced(jax_get(ARCH), dtype="float32")
    cfg_t = reduced(get(ARCH), dtype="float32")
    B, T, d, V = 2, 100, cfg_t.d_model, cfg_t.vocab_size
    rng = np.random.default_rng(4)
    h = rng.standard_normal((B, T, d), np.float32)
    w = rng.standard_normal((d, V), np.float32) * 0.1
    tg = rng.integers(0, V, (B, T)).astype(np.int32)

    def jf(h, w):
        return jax_lm_loss({"head": w}, h, jnp.asarray(tg), cfg_j, chunk=64)

    j_loss, (j_dh, j_dw) = jax.value_and_grad(jf, (0, 1))(jnp.asarray(h),
                                                          jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    t_loss = lm_loss({"head": tw}, th, torch.from_numpy(tg), cfg_t, chunk=64)
    t_loss.backward()
    _close(t_loss, j_loss, 1e-5, "loss")
    _close(th.grad, j_dh, 1e-5, "dh")
    _close(tw.grad, j_dw, 1e-5, "dw")


# f32: summation order only; bf16: both round at the same ops, and one bf16
# ulp flip in an activation moves a gradient entry by up to ~1e-2 relative
MODEL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


#: the other dense configs, reduced, beside exanest-lm-100m (whose cases
#: keep their ids): their training runs on the port as the decode does
DENSE_ARCHS = ["deepseek-7b", "starcoder2-7b", "command-r-35b",
               "mistral-large-123b"]


#: MoE configs, reduced: granite as it is (every layer MoE, softmax
#: router), and with one leading dense layer, so that both stacks run
MOE_ARCHS = [("granite-moe-1b-a400m", {}),
             ("granite-moe-1b-a400m", {"n_dense_layers": 1})]


def _arch_id(arch, over):
    return arch + "".join(f"-{k}{v}" for k, v in over.items())


@pytest.mark.parametrize("arch,over,dtype", [
    pytest.param(arch, over, dtype,
                 id=dtype if arch == ARCH else f"{_arch_id(arch, over)}-{dtype}")
    for arch, over in [(a, {}) for a in [ARCH] + DENSE_ARCHS] + MOE_ARCHS
    for dtype in ("float32", "bfloat16")])
def test_loss_fn_and_grads_match_reference(arch, over, dtype):
    jm, tm, jp, tp = _models(dtype, arch, **over)
    jb, tb = _batch(tm.cfg.vocab_size)
    j_loss, j_grads = _compile(jax.value_and_grad(jm.loss_fn), jp, jb)(jp, jb)
    t_loss, t_grads = _value_and_grad(tm, tp, tb, None)
    tol = MODEL_TOL[dtype]
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
    j_lg, j_c = _compile(jm.prefill, jp, jb)(jp, jb)
    with torch.no_grad():
        t_lg, t_c = tm.prefill(tp, tb)
    assert t_lg.dtype == torch.float32 and t_lg.shape == (2, 1,
                                                          tm.cfg.vocab_size)
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    _close(t_lg, j_lg, tol, "logits")
    for name in ("k", "v"):
        _close(t_c["dense"][name], j_c["dense"][name], tol, f"cache {name}")


def test_prefill_then_decode_matches_full_prefill():
    """Prefill of S-1 tokens, then one decode step on the prefill's cache,
    gives the last logits of a prefill of all S tokens (the reference's
    test_decode_matches_prefill_gqa, on the port alone)."""
    _, tm, _, tp = _models("float32")
    _, tb = _batch(tm.cfg.vocab_size, B=2, S=16)
    with torch.no_grad():
        full, _ = tm.prefill(tp, tb)
        _, caches = tm.prefill(tp, {"tokens": tb["tokens"][:, :-1]})
        cache = tm.init_cache(2, 16, device="cpu")
        for name in ("k", "v"):
            cache["dense"][name][:, :, :15] = caches["dense"][name]
        lg, _ = tm.decode_step(tp, cache, {"token": tb["tokens"][:, -1],
                                           "pos": torch.tensor(15)})
    _close(lg, full.numpy(), 1e-4)


# ---------------------------------------------------------------- optimizer
def _param_tree(rng):
    return {"a": rng.standard_normal((4, 512), np.float32),
            "b": {"c": rng.standard_normal((3, 7), np.float32),
                  "d": rng.standard_normal((1024,), np.float32)}}


@pytest.mark.parametrize("quantize", [False, True])
def test_adamw_update_matches_reference(quantize):
    """Two updates (the second reads moments the first wrote, int8-quantized
    in blocks of 256 where the leaf allows)."""
    cfg_kw = dict(quantize_states=quantize, warmup_steps=2, decay_steps=10)
    rng = np.random.default_rng(5)
    p = _param_tree(rng)
    gs = [_param_tree(rng) for _ in range(2)]
    jcfg, tcfg = jax_opt.AdamWConfig(**cfg_kw), AdamWConfig(**cfg_kw)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = jax.tree_util.tree_map(torch.from_numpy, p)
    jo, to = jax_opt.adamw_init(jp, jcfg), adamw_init(tp, tcfg)
    for g in gs:
        jp, jo, jm = jax_opt.adamw_update(
            jax.tree_util.tree_map(jnp.asarray, g), jo, jp, jcfg)
        tp, to, tm = adamw_update(
            jax.tree_util.tree_map(torch.from_numpy, g), to, tp, tcfg)
    want = _leaves({"params": jp, "opt": jo})
    got = bridge.tree_to_numpy({"params": tp, "opt": to})
    assert sorted(got) == sorted(want)
    if quantize:
        assert "opt.m.a.q" in got and got["opt.m.a.q"].dtype == np.int8
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        # int8 codes may flip by one where a float32 ulp moves x/scale
        # across a .5 boundary
        tol = 1.0 if name.endswith(".q") else 1e-5
        np.testing.assert_allclose(got[name].astype(np.float64),
                                   want[name].astype(np.float64), rtol=tol,
                                   atol=tol, err_msg=name)
    _close(tm["grad_norm"], jm["grad_norm"], 1e-6)
    _close(tm["lr"], jm["lr"], 1e-6)


def test_train_step_with_microbatches_matches_reference():
    jm, tm, jp, tp = _models("float32")
    jb, tb = _batch(tm.cfg.vocab_size, B=4, S=64)
    ocfg_j, ocfg_t = jax_opt.AdamWConfig(), AdamWConfig()
    jstep = jax_loop.make_train_step(jm, ocfg_j, None, microbatches=2)
    jo = jax_opt.adamw_init(jp, ocfg_j)
    jp2, jo2, jmet = _compile(jstep, jp, jo, jb)(jp, jo, jb)
    tstep = make_train_step(tm, ocfg_t, None, microbatches=2)
    tp2, to2, tmet = tstep(tp, adamw_init(tp, ocfg_t), tb)
    _close(tmet["loss"], jmet["loss"], 1e-5, "loss")
    _close(tmet["grad_norm"], jmet["grad_norm"], 1e-4, "grad_norm")
    want = _leaves({"params": jp2, "opt": jo2})
    got = bridge.tree_to_numpy({"params": tp2, "opt": to2})
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)


# -------------------------------------------------------------- trajectory
# float32: five steps from one state; AdamW's normalized update makes a
# 1e-6 gradient difference a ~lr-sized parameter step on near-zero moments,
# so losses drift slowly: 1e-4 holds with margin. bf16: parameters round to
# bf16 every step in both frameworks, and a rounding flip moves the loss by
# ~1e-3; 2e-2 is the reference's single-step bf16 tolerance.
TRAJ_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainer_five_step_trajectory_matches_reference(dtype):
    jcfg = jax_reduced(jax_get(ARCH), dtype=dtype)
    tcfg = reduced(get(ARCH), dtype=dtype)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    ocfg = dict(lr=3e-3, warmup_steps=1, decay_steps=5)
    jtr = jax_loop.Trainer(jm, jax_opt.AdamWConfig(**ocfg))
    ttr = Trainer(tm, AdamWConfig(**ocfg), device="cpu")
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    tstate = bridge.load_train_state(tm, ttr.opt_cfg, _leaves(jstate),
                                     device="cpu")
    jdata = JaxTokens(jcfg, batch=4, seq=64)
    tdata = SyntheticTokens(tcfg, batch=4, seq=64, device="cpu")
    jstep = _compile(jtr.make_step(jit=False), jstate, jdata.batch_at(0))
    tstep = ttr.make_step()
    j_losses, t_losses = [], []
    for i in range(5):
        jstate, jmet = jstep(jstate, jdata.batch_at(i))
        tstate, tmet = tstep(tstate, tdata.batch_at(i))
        j_losses.append(float(jmet["loss"]))
        t_losses.append(float(tmet["loss"]))
    np.testing.assert_allclose(t_losses, j_losses, rtol=TRAJ_TOL[dtype],
                               atol=TRAJ_TOL[dtype])
    assert t_losses[-1] < t_losses[0]


def test_synthetic_tokens_are_bit_identical():
    jcfg, tcfg = jax_reduced(jax_get(ARCH)), reduced(get(ARCH))
    jd = JaxTokens(jcfg, batch=3, seq=40, seed=7)
    td = SyntheticTokens(tcfg, batch=3, seq=40, seed=7, device="cpu")
    for step in range(3):
        jb, tb = jd.batch_at(step), td.batch_at(step)
        assert set(tb) == {"tokens", "labels"}
        for key in tb:
            assert tb[key].dtype == torch.int32
            np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]))


def test_prefetcher_yields_the_stream_in_order():
    td = SyntheticTokens(reduced(get(ARCH)), batch=2, seq=16, device="cpu")
    got = list(Prefetcher(itertools.islice(td, 4), depth=2))
    assert len(got) == 4
    for step, batch in enumerate(got):
        torch.testing.assert_close(batch["tokens"],
                                   td.batch_at(step)["tokens"], rtol=0, atol=0)


def test_trainer_with_mesh_builds_its_step_with_auto_strategy():
    """With a mesh and the default ``sync_strategy="auto"`` the Trainer
    builds its step: the sync asks the planner per bucket, exact only unless
    ``allow_lossy`` (the 2x2 gloo run in test_torch_grad_sync.py drives
    it)."""

    class TwoByTwo:
        axis_names = ("data", "pod")
        shape = {"data": 2, "pod": 2}

    _, tm, _, _ = _models("float32")
    tr = Trainer(tm, mesh=TwoByTwo())
    assert tr.sync_strategy == "auto" and tr.allow_lossy is False
    assert callable(tr.make_step())
    sync = tr.make_sync()
    assert (sync.keywords["strategy"], sync.keywords["allow_lossy"],
            sync.keywords["mean_over"]) == ("auto", False, 4)


def test_quantized_launcher_run_on_cpu(tmp_path):
    from repro_torch.launch import train as launch_train
    out = launch_train.main(["--reduced", "--device", "cpu", "--steps", "4",
                             "--batch", "2", "--seq", "32", "--quantize-opt",
                             "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    q = out["state"]["opt"]["m"]["embed"]["head"]
    assert isinstance(q, dict) and q["q"].dtype == torch.int8
    assert (tmp_path / "step-00000000" / "manifest.json").exists()


def test_dataclass_defaults_match_reference():
    assert dataclasses.asdict(AdamWConfig()) == dataclasses.asdict(
        jax_opt.AdamWConfig())
