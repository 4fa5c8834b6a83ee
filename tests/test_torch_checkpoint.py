"""Checkpoints cross frameworks both ways, and failure replay is exact.

A whole train state (bf16 parameters, float32 or int8-quantized AdamW
moments, the int32 step) saved by the port restores through the
reference's ``restore_checkpoint``, and one saved by the reference restores
through the port's: leaf names, recorded dtypes, shapes and sha256 agree.
``run_with_recovery`` with a ``FailureInjector`` reproduces the failure-free
run bit for bit (``tests/test_fault_tolerance.py::
test_failure_replay_is_exact``), on the toy step and on the port's own
train step.
"""

from __future__ import annotations

import json
import tempfile
import os
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jax_store
from repro.config import reduced as jax_reduced
from repro.configs import get as jax_get
from repro.models import build_model as jax_build_model
from repro.train import loop as jax_loop
from repro.train import optimizer as jax_opt
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.checkpoint.store import (CheckpointStore, latest_step,
                                          restore_checkpoint, save_checkpoint)
from repro_torch.config import reduced
from repro_torch.configs import get
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models import build_model
from repro_torch.runtime.fault import (FailureInjector, SimulatedFailure,
                                       StragglerMonitor, elastic_reshard,
                                       run_with_recovery)
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import AdamWConfig

ARCH = "exanest-lm-100m"


def _jax_state(quantize: bool):
    cfg = jax_reduced(jax_get(ARCH))
    tr = jax_loop.Trainer(jax_build_model(cfg), jax_opt.AdamWConfig(
        quantize_states=quantize, qblock=64))
    return tr.init_state(jax.random.PRNGKey(0))


def _port_state(quantize: bool):
    tr = Trainer(build_model(reduced(get(ARCH))), AdamWConfig(
        quantize_states=quantize, qblock=64), device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    # move the step and the moments off zero, so dtypes and bytes matter
    step = tr.make_step()
    data = SyntheticTokens(tr.model.cfg, batch=2, seq=32, device="cpu")
    return tr, step(state, data.batch_at(0))[0]


def _manifest(d, step):
    with open(os.path.join(d, f"step-{step:08d}", "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("quantize", [False, True])
def test_port_checkpoint_restores_through_reference(tmp_path, quantize):
    tr, state = _port_state(quantize)
    save_checkpoint(str(tmp_path), 1, state)
    template = _jax_state(quantize)
    restored, manifest = jax_store.restore_checkpoint(str(tmp_path), 1,
                                                      template)
    flat = jax.tree_util.tree_flatten_with_path(restored)[0]
    want = bridge.tree_to_numpy(state)
    names = [jax_store._leaf_name(p) for p, _ in flat]
    assert names == [n for n, _ in tree_util.named_leaves(state)]
    assert sorted(manifest["leaves"]) == sorted(want)
    for (path, leaf), name in zip(flat, names):
        tmpl = dict(zip(names, jax.tree_util.tree_leaves(template)))[name]
        assert leaf.dtype == tmpl.dtype, name
        np.testing.assert_array_equal(
            np.asarray(leaf.astype(jnp.float32) if leaf.dtype == jnp.bfloat16
                       else leaf), want[name], err_msg=name)
    assert manifest["leaves"]["params.embed.head"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["opt.step"]["dtype"] == "int32"
    if quantize:
        assert manifest["leaves"]["opt.m.embed.head.q"]["dtype"] == "int8"


@pytest.mark.parametrize("quantize", [False, True])
def test_reference_checkpoint_restores_through_port(tmp_path, quantize):
    jstate = _jax_state(quantize)
    # one reference step, so the moments and the step are not all zero
    cfg = jax_reduced(jax_get(ARCH))
    jtr = jax_loop.Trainer(jax_build_model(cfg), jax_opt.AdamWConfig(
        quantize_states=quantize, qblock=64))
    tokens = jnp.asarray(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32))
    jstate, _ = jtr.make_step()(jstate, {"tokens": tokens, "labels": tokens})
    jax_store.save_checkpoint(str(tmp_path / "jax"), 1, jstate)
    tr = Trainer(build_model(reduced(get(ARCH))), AdamWConfig(
        quantize_states=quantize, qblock=64), device="cpu")
    template = bridge.train_state_template(tr.model, tr.opt_cfg)
    state, manifest = restore_checkpoint(str(tmp_path / "jax"), 1, template,
                                         device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jstate)[0]
    got = dict(tree_util.named_leaves(state))
    assert sorted(got) == sorted(jax_store._leaf_name(p) for p, _ in flat)
    for path, leaf in flat:
        name = jax_store._leaf_name(path)
        want = np.asarray(leaf.astype(jnp.float32)
                          if leaf.dtype == jnp.bfloat16 else leaf)
        t = got[name]
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), name
        np.testing.assert_array_equal(
            (t.float() if t.dtype == torch.bfloat16 else t).numpy(), want,
            err_msg=name)
    # the port re-saves the same bytes: names, dtypes and sha256 agree
    save_checkpoint(str(tmp_path / "port"), 1, state)
    a = _manifest(str(tmp_path / "jax"), 1)["leaves"]
    b = _manifest(str(tmp_path / "port"), 1)["leaves"]
    assert a == b


def test_restore_detects_corruption(tmp_path):
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    d = save_checkpoint(str(tmp_path), 1, tree)
    np.save(f"{d}/w.npy", np.zeros(8, np.float32))
    with pytest.raises(IOError, match="corruption"):
        restore_checkpoint(str(tmp_path), 1, tree)


def test_async_store_and_gc(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        store.save_async(s, {"w": torch.full((3,), float(s))})
    store.wait()
    assert latest_step(str(tmp_path)) == 4
    restored, _ = restore_checkpoint(str(tmp_path), 4,
                                     {"w": torch.zeros(3)})
    np.testing.assert_allclose(restored["w"].numpy(), 4.0)
    assert len([d for d in os.listdir(tmp_path) if d.startswith("step-")]) <= 2


def _toy_step(state, step):
    # deterministic function of (state, step), like the data pipeline
    return {"w": state["w"] * 0.9 + torch.tensor(float(step))}


def test_failure_replay_is_exact(tmp_path):
    s0 = {"w": torch.ones(4)}
    ref, _ = run_with_recovery(s0, _toy_step, 25, ckpt_dir=str(tmp_path / "a"),
                               ckpt_every=5)
    inj = FailureInjector(frozenset({7, 13, 22}))
    out, log = run_with_recovery(s0, _toy_step, 25,
                                 ckpt_dir=str(tmp_path / "b"), ckpt_every=5,
                                 injector=inj)
    assert torch.equal(ref["w"], out["w"])
    assert log["failures"] == 3 and log["replayed_steps"] > 0


def test_run_with_recovery_drops_the_initial_state(tmp_path):
    """Once the first step has replaced it, nothing in run_with_recovery
    holds the state it was given (the launcher hands the initial state
    over, so a full-width train state is held once, not twice)."""
    refs = []

    def initial():
        w = torch.ones(4)
        refs.append(weakref.ref(w))
        return {"w": w}

    alive = []

    def step(st, i):
        alive.append(refs[0]() is not None)
        return {"w": st["w"] + 1}

    out, _ = run_with_recovery(initial(), step, 3,
                               ckpt_dir=str(tmp_path), ckpt_every=10)
    assert alive == [True, False, False]
    assert torch.equal(out["w"], torch.full((4,), 4.0))


def test_train_step_replay_is_exact(tmp_path):
    """The port's own train step (bf16 parameters, AdamW) under injected
    failures ends bit for bit where the failure-free run ends."""
    tr = Trainer(build_model(reduced(get(ARCH))),
                 AdamWConfig(warmup_steps=2, decay_steps=6), device="cpu")
    data = SyntheticTokens(tr.model.cfg, batch=2, seq=32, device="cpu")
    step_fn = tr.make_step()

    def one(st, i):
        return step_fn(st, data.batch_at(i))[0]

    s0 = tr.init_state(torch.Generator().manual_seed(0))
    ref, _ = run_with_recovery(s0, one, 6, ckpt_dir=str(tmp_path / "a"),
                               ckpt_every=2)
    out, log = run_with_recovery(s0, one, 6, ckpt_dir=str(tmp_path / "b"),
                                 ckpt_every=2,
                                 injector=FailureInjector(frozenset({3, 5})))
    assert log["failures"] == 2
    for (name, a), (_, b) in zip(tree_util.named_leaves(ref),
                                 tree_util.named_leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_straggler_detection_and_elastic_reshard_waits():
    mon = StragglerMonitor(deadline_factor=3.0)
    for i in range(20):
        mon.observe(i, 0.01)
    assert not mon.flagged
    assert mon.observe(20, 0.2) and mon.flagged == [20]
    # elastic_reshard cuts each rank's block of a checkpoint onto a mesh:
    # the four blocks of a (2, 2) ("data", "model") mesh, each restored as
    # its rank would, tile the saved leaf exactly
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.parallel.sharding import Sharding, Spec

    class RankView(AbstractMesh):
        def __init__(self, rank):
            super().__init__((2, 2), ("data", "model"))
            self.coords, self.device = self.coords_of(rank), torch.device("cpu")

    x = torch.arange(48, dtype=torch.float32).reshape(8, 6)
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 2, {"w": x})
        tmpl = {"w": torch.empty((8, 6), device="meta")}
        blocks = [elastic_reshard(d, 2, tmpl, {"w": Sharding(
            RankView(r), Spec("data", "model"))})["w"] for r in range(4)]
    assert all(b.shape == (4, 3) and b.device.type == "cpu" for b in blocks)
    assert torch.equal(torch.cat([torch.cat(blocks[:2], 1),
                                  torch.cat(blocks[2:], 1)]), x)
    assert issubclass(SimulatedFailure, RuntimeError)
