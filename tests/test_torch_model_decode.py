"""The port's ``decode_step`` (dense and MoE ``LM``) against the JAX
reference.

Parameters come from the JAX package's ``init(PRNGKey(0))``, flattened by
tree path, widened to float32 numpy and loaded with ``repro_torch.bridge``.
Both models then take the same eight teacher-forced decode steps, each row
at its own position, one of them past the window (the reference drops such
a KV write and attends to all of S; so must the port).
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
from repro_torch import bridge
from repro_torch.config import reduced
from repro_torch.configs import get
from repro_torch.models import LM, build_model

ARCHS = ["exanest-lm-100m", "deepseek-7b", "starcoder2-7b", "command-r-35b",
         "mistral-large-123b", "granite-moe-1b-a400m"]
# f32: same math, summation order differs; bf16: both round where the
# reference's source rounds (see _run_both), and 2e-2 (the reference's bf16
# kernel tolerance) covers the ulp flips that summation order still causes
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, WINDOW, STEPS = 3, 8, 8
# per-row positions of each step: row 1 runs past the window (pos >= 8)
POS = np.array([[t, t + 3, [5, 1, 6, 0, 7, 2, 3, 4][t]] for t in range(STEPS)],
               np.int32)


def _leaves(params) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {_leaf_name(path): np.asarray(leaf, np.float32)
            for path, leaf in flat}


def _run_both(jcfg, tcfg, seed=0):
    """Eight decode steps through both models; returns per-step logits and
    final caches of each."""
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg)
    tp = bridge.load_params(tm, _leaves(jp), device="cpu")
    jc = jm.init_cache(B, WINDOW)
    tc = tm.init_cache(B, WINDOW, device="cpu")
    # XLA's excess precision would skip bf16 roundings the reference's code
    # asks for (e.g. of the residual sum before a norm widens it to f32);
    # off, the reference rounds where its source says, as torch does
    step = jax.jit(jm.decode_step).lower(
        jp, jc, {"token": jnp.zeros((B,), jnp.int32),
                 "pos": jnp.zeros((B,), jnp.int32)}).compile(
        compiler_options={"xla_allow_excess_precision": False})
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab_size,
                                                (STEPS, B)).astype(np.int32)
    j_out, t_out = [], []
    for t in range(STEPS):
        lg, jc = step(jp, jc, {"token": jnp.asarray(toks[t]),
                               "pos": jnp.asarray(POS[t])})
        j_out.append(np.asarray(lg))
        lg_t, tc = tm.decode_step(tp, tc, {"token": torch.from_numpy(toks[t]),
                                           "pos": torch.from_numpy(POS[t])})
        assert lg_t.dtype == torch.float32 and lg_t.shape == (B, 1,
                                                             jcfg.vocab_size)
        t_out.append(lg_t.numpy())
    return j_out, t_out, jc, tc


def _assert_close(j_out, t_out, jc, tc, tol):
    for t, (a, b) in enumerate(zip(j_out, t_out)):
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol,
                                   err_msg=f"logits of step {t}")
    assert sorted(tc) == sorted(jc)
    for stack in jc:
        for name in ("k", "v"):
            np.testing.assert_allclose(
                tc[stack][name].float().numpy(),
                np.asarray(jc[stack][name], np.float32), rtol=tol, atol=tol,
                err_msg=f"{stack} cache {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch, dtype):
    jcfg = jax_reduced(jax_get(arch), dtype=dtype)
    tcfg = reduced(get(arch), dtype=dtype)
    _assert_close(*_run_both(jcfg, tcfg), TOL[dtype])


def test_decode_options_learned_positions_gated_gelu():
    """Options no reduced arch above combines: learned positions
    (transformer.py:322) with a gated GELU MLP."""
    over = dict(dtype="float32", pos_embedding="learned", mlp_act="gelu")
    jcfg = dataclasses.replace(jax_reduced(jax_get("exanest-lm-100m")), **over)
    tcfg = dataclasses.replace(reduced(get("exanest-lm-100m")), **over)
    _assert_close(*_run_both(jcfg, tcfg), TOL["float32"])


@pytest.mark.parametrize("heads", [(3, 1, 4), (4, 2, 5)])
def test_pad_heads_decode_matches_reference(heads):
    """Head padding (tests/test_head_padding.py:44); (4, 2 -> 5) pads to a
    head count the KV heads do not divide, so KV is repeated per head."""
    n_heads, n_kv, pad = heads
    over = dict(n_heads=n_heads, n_kv_heads=n_kv, head_dim=16, d_model=48,
                dtype="float32", pad_heads_to=pad)
    jcfg = jax_reduced(jax_get("starcoder2-7b"), **over)
    tcfg = reduced(get("starcoder2-7b"), **over)
    _assert_close(*_run_both(jcfg, tcfg), TOL["float32"])


def test_pad_heads_is_exact_against_unpadded_port():
    cfg = reduced(get("starcoder2-7b"), n_heads=3, n_kv_heads=1, head_dim=16,
                  d_model=48, dtype="float32")
    cfgp = dataclasses.replace(cfg, pad_heads_to=4)
    m0, m1 = LM(cfg), LM(cfgp)
    g = torch.Generator().manual_seed(0)
    p0 = m0.init(g, device="cpu")
    p1 = m1.init(torch.Generator().manual_seed(1), device="cpu")
    attn0, attn1 = p0["dense_stack"]["attn"], p1["dense_stack"]["attn"]
    for name in ("wq", "bq"):
        attn1[name][..., :3, :] = attn0[name]
    attn1["wo"][:, :3] = attn0["wo"]
    for name in ("wk", "wv", "bk", "bv"):
        attn1[name] = attn0[name]
    p1 = {**p0, "dense_stack": {**p0["dense_stack"], "attn": attn1}}
    batch = {"token": torch.tensor([3, 5]), "pos": torch.tensor(4)}
    lg0, _ = m0.decode_step(p0, m0.init_cache(2, 16, device="cpu"), batch)
    lg1, _ = m1.decode_step(p1, m1.init_cache(2, 16, device="cpu"), batch)
    np.testing.assert_allclose(lg1.numpy(), lg0.numpy(), rtol=1e-4, atol=1e-4)


def test_bridge_names_and_rejects_bad_leaves():
    jcfg = jax_reduced(jax_get("starcoder2-7b"))
    tm = LM(reduced(get("starcoder2-7b")))
    leaves = _leaves(jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    assert bridge.leaf_names(tm) == sorted(leaves)
    wq = leaves["dense_stack.attn.wq"]
    assert wq.shape[0] == jcfg.n_layers            # layer axis kept
    p = bridge.load_params(tm, leaves, device="cpu")
    assert p["dense_stack"]["attn"]["wq"].dtype == torch.bfloat16
    assert p["dense_stack"]["ln1"]["scale"].dtype == torch.float32
    with pytest.raises(ValueError, match="missing"):
        bridge.load_params(tm, {k: v for k, v in leaves.items()
                                if k != "embed.head"}, device="cpu")
    with pytest.raises(ValueError, match="extra"):
        bridge.load_params(tm, {**leaves, "embed.bogus": wq}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        bridge.load_params(tm, {**leaves, "dense_stack.attn.wq": wq[:1]},
                           device="cpu")


@pytest.mark.parametrize("arch,item", [
    pytest.param(a, i, id=a) for a, i in [("internvl2-1b", 5),
                                         ("whisper-small", 5)]])
def test_unported_families_raise_naming_roadmap_item(arch, item):
    """The last families of ROADMAP.md queue 1 item 5 are ported:
    ``build_model`` gives internvl2-1b an ``LM`` (the patch prefix) and
    whisper-small an ``EncDecLM``, and the loss, prefill and a decode step
    run, each finite (tests/test_torch_vlm.py and test_torch_encdec.py hold
    them against the reference)."""
    from repro_torch.models import EncDecLM
    cfg = reduced(get(arch), dtype="float32")
    model = build_model(cfg)
    assert isinstance(model, EncDecLM if arch == "whisper-small" else LM)
    p = model.init(torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=g)
    batch = {"tokens": toks, "labels": toks}
    if cfg.vision is not None:
        batch["patches"] = torch.randn((2, cfg.vision.n_patches,
                                        cfg.d_model), generator=g)
    if cfg.encdec is not None:
        batch["frames"] = torch.randn((2, cfg.encdec.encoder_seq,
                                       cfg.d_model), generator=g)
    loss = model.loss_fn(p, batch)
    lg, _ = model.prefill(p, {k: v for k, v in batch.items()
                              if k != "labels"})
    lg2, _ = model.decode_step(p, model.init_cache(2, 32, device="cpu"),
                               {"token": toks[:, 0], "pos": torch.tensor(0)})
    assert lg.shape == lg2.shape == (2, 1, cfg.vocab_size)
    assert torch.isfinite(loss) and torch.isfinite(lg).all()
    assert torch.isfinite(lg2).all()


def test_deepseek_v3_builds_and_runs():
    """MLA and MTP are ported: deepseek-v3-671b builds with the reference's
    tree (one layer in ``dense_stack``, one in ``moe_stack``, the ``mtp``
    head), and its loss (with MTP), prefill and absorbed decode run."""
    model = build_model(reduced(get("deepseek-v3-671b"), dtype="float32"))
    assert isinstance(model, LM)
    p = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert p["dense_stack"]["attn"]["wkv_b"].shape == (1, 16, 4, 32)
    assert p["moe_stack"]["ffn"]["w_gate"].shape == (1, 4, 64, 32)
    assert sorted(p["mtp"]) == ["block", "ln_e", "ln_h", "proj"]
    assert p["mtp"]["block"]["ffn"]["router"].shape == (64, 4)
    toks = torch.randint(0, 256, (2, 12), generator=torch.Generator()
                         .manual_seed(1))
    loss = model.loss_fn(p, {"tokens": toks, "labels": toks})
    lg, caches = model.prefill(p, {"tokens": toks})
    assert sorted(caches) == ["dense", "moe"] and torch.isfinite(loss)
    assert sorted(caches["moe"]) == ["c_kv", "k_rope"]
    cache = model.init_cache(2, 16, device="cpu")
    assert cache["dense"]["c_kv"].shape == (1, 2, 16, 16)
    lg2, _ = model.decode_step(p, cache, {"token": toks[:, 0],
                                          "pos": torch.tensor(0)})
    assert lg.shape == lg2.shape == (2, 1, 256)
    assert torch.isfinite(lg).all() and torch.isfinite(lg2).all()


def test_granite_moe_builds_and_runs():
    """The MoE family is ported: granite builds with the reference's tree
    (every layer in ``moe_stack``, ``dense_stack`` None), and its loss,
    prefill and decode run."""
    model = build_model(reduced(get("granite-moe-1b-a400m"), dtype="float32"))
    assert isinstance(model, LM)
    p = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert p["dense_stack"] is None
    assert p["moe_stack"]["ffn"]["w_gate"].shape == (2, 4, 64, 32)
    assert p["moe_stack"]["ffn"]["router"].dtype == torch.float32
    toks = torch.randint(0, 256, (2, 12), generator=torch.Generator()
                         .manual_seed(1))
    loss = model.loss_fn(p, {"tokens": toks, "labels": toks})
    lg, caches = model.prefill(p, {"tokens": toks})
    assert sorted(caches) == ["moe"] and torch.isfinite(loss)
    cache = model.init_cache(2, 16, device="cpu")
    lg2, _ = model.decode_step(p, cache, {"token": toks[:, 0],
                                          "pos": torch.tensor(0)})
    assert lg.shape == lg2.shape == (2, 1, 256)
    assert torch.isfinite(lg).all() and torch.isfinite(lg2).all()
