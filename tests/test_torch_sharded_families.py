"""Every model family on the port's (pod, data, model) = (2, 2, 2) mesh
against unsharded runs: the reference's ``tests/test_distributed.py:121``
check (a sharded train step against the unsharded one) for the Mamba-2,
hybrid, encoder-decoder and VLM families, and sharded prefill then decode
for them and for MLA's absorbed decode with the latent over ``model``.

Eight gloo processes on the CPU, started once for the module, each under a
timeout, on the ``reduced()`` configs with parameters from the reference's
``init`` (moved across by tree path, :mod:`repro_torch.bridge`), run:

* one sharded ``Trainer`` step of ``mamba2-2.7b``, ``zamba2-2.7b``,
  ``whisper-small`` and ``internvl2-1b``: in bf16 (held against the
  reference's unsharded step, run here, at its 2e-2) and in f32 (held
  against the port's unsharded step, run here, at F32_TOL);
* sharded prefill then decode of those four and of ``deepseek-v3-671b``
  (MLA's absorbed decode, its MoE layers EP over ``data``) in f32: every
  step's logits and each rank's caches (SSM and conv states, the hybrid's
  KV, MLA's latent and rope key) against its block of the unsharded
  model's;
* the hybrid's train state (two stack dims) saved on (data 2, model 4)
  and restored onto (data 4, model 2) with ``elastic_reshard``.
"""

from __future__ import annotations

import inspect
import json
import os
import socket
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import _leaf_name
from repro.config import reduced as jax_reduced
from repro.configs import get as jax_get
from repro.models import build_model as jax_build_model
from repro.models import transformer as jax_transformer
from repro.train.loop import make_train_step as jax_make_train_step
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.config import ShapeConfig, reduced
from repro_torch.configs import get
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import build_model, moe
from repro_torch.models import transformer
from repro_torch.parallel.ctx import make_parallel_ctx
from repro_torch.parallel.sharding import Sharding, cache_specs, is_spec
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
PROC_TIMEOUT_S = 300
#: the families a train step runs for; deepseek-v3's sharded step is
#: tests/test_torch_sharded_step.py's
TRAIN_ARCHS = ("mamba2-2.7b", "zamba2-2.7b", "whisper-small", "internvl2-1b")
DECODE_ARCHS = TRAIN_ARCHS + ("deepseek-v3-671b",)
#: the reference's test_distributed.py:121 tolerance (sharded vs unsharded)
REF_TOL = 2e-2
#: the port sharded against the port unsharded in float32: the same
#: arithmetic with the row-parallel products and the gated norm's mean of
#: squares summed in a different order
F32_TOL = 1e-5
#: decode logits and caches in float32: longer chains of such sums (the
#: MODEL_TOL of tests/test_torch_sharded_step.py)
DECODE_TOL = 1e-4
#: global batch rows x tokens: two chunks of the reduced SSM's 32
TOKENS = (8, 64)
PREFILL, DECODE = 48, 4
#: float32 steps move a weight by about 1e-3 (lr from the first step), far
#: above F32_TOL of it
STEP = dict(lr=1e-3, warmup_steps=1)
SEEDS = {a: i for i, a in enumerate(DECODE_ARCHS)}
#: the cache keys whose leaves do not grow with the window: the SSM and
#: conv states and whisper's cross K/V
STATES = ("conv", "ssm", "cross")

WORKER = """
import datetime, json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.checkpoint.store import save_checkpoint
from repro_torch.config import reduced
from repro_torch.configs import get
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.parallel.ctx import make_parallel_ctx
from repro_torch.parallel.sharding import (Sharding, Spec, gather_tree,
                                           opt_state_specs, param_specs,
                                           shard_tree)
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.runtime.fault import elastic_reshard
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import AdamWConfig, adamw_init

rank, port, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=8, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
pctx = make_parallel_ctx(mesh)
info = {"coords": mesh.coords}
inputs = dict(np.load(f"{d}/inputs.npz"))


def leaves_of(arch):
    # the parameters appear whole (written aside, then renamed)
    path = f"{d}/{arch}.npz"
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > 200:
            raise TimeoutError(path)
        time.sleep(0.05)
    return dict(np.load(path))


def batch_of(cfg, n=None):
    toks = torch.from_numpy(inputs["tokens"])[:, :n]
    b = {"tokens": toks, "labels": toks}
    if cfg.encdec is not None:
        b["frames"] = torch.from_numpy(inputs["frames"])
    if cfg.vision is not None:
        b["patches"] = torch.from_numpy(inputs["patches"])
    return b


def window(cache, n):
    # the attention caches grow by n positions; states do not
    def pad(name, t):
        if name.split(".")[0] in STATES:
            return t
        if name.split(".")[-1] in ("c_kv", "k_rope"):
            return F.pad(t, (0, 0, 0, n)).contiguous()
        return F.pad(t, (0, 0, 0, 0, 0, n)).contiguous()
    return tree_util.unflatten(cache, [pad(k, t) for k, t in
                                       tree_util.named_leaves(cache)])


def train_step(cfg, leaves, opt_cfg):
    model = build_model(cfg)
    params = bridge.load_params(model, leaves, device="cpu")
    tr = Trainer(model, opt_cfg, pctx=pctx, device="cpu")
    state = tr.shard_state({"params": params,
                            "opt": adamw_init(params, opt_cfg)})
    seen = {}
    sync = tr.make_sync()

    def capture(grads):
        seen["g"] = sync(grads)
        return seen["g"]

    state, m = tr.make_step(sync_fn=capture)(
        state, shard_batch(batch_of(cfg), pctx))
    specs = param_specs(params, cfg, pctx)
    out = {"loss": np.float32(m["loss"]),
           "grad_norm": np.float32(m["grad_norm"])}
    for pre, tree in (("p.", state["params"]), ("g.", seen["g"])):
        for k, v in bridge.tree_to_numpy(gather_tree(tree, specs,
                                                     mesh)).items():
            out[pre + k] = v
    return out, state


for arch in TRAIN_ARCHS:
    leaves = leaves_of(arch)
    for dtype in ("bfloat16", "float32"):
        cfg = reduced(get(arch), dtype=dtype)
        ocfg = AdamWConfig() if dtype == "bfloat16" else AdamWConfig(**STEP)
        out, state = train_step(cfg, leaves, ocfg)
        if rank == 0:
            np.savez(f"{d}/T-{arch}-{dtype}.npz", **out)
        if dtype == "float32":
            ssm = state["params"].get("stack", state["params"].get("groups"))
            if ssm is not None:
                info[f"{arch}-wx"] = list(ssm["ssm"]["wx"].shape)
                info[f"{arch}-wB"] = list(ssm["ssm"]["wB"].shape)

gather_dims = tp.gather_dims


def counted(*a):
    gathers[0] += 1
    return gather_dims(*a)


tp.gather_dims = counted
for arch in DECODE_ARCHS:
    cfg = reduced(get(arch), dtype="float32")
    model = build_model(cfg)
    full = bridge.load_params(model, leaves_of(arch), device="cpu")
    params = shard_tree(full, param_specs(full, cfg, pctx), mesh)
    local = shard_batch(batch_of(cfg), pctx)
    toks = local["tokens"]
    gathers = [0]
    with torch.no_grad(), tp.keep_gathered():
        lg, caches = model.prefill(
            params, {**local, "tokens": toks[:, :PREFILL]}, pctx)
        caches = window(caches, DECODE)
        info[f"K-{arch}-prefill"] = gathers[0]
        outs = [lg]
        for i in range(DECODE):
            lg, caches = model.decode_step(
                params, caches, {"token": toks[:, PREFILL + i],
                                 "pos": PREFILL + i}, pctx)
            outs.append(lg)
        info[f"K-{arch}-decode"] = gathers[0] - info[f"K-{arch}-prefill"]
    np.savez(f"{d}/r{rank}-D-{arch}.npz", logits=torch.cat(outs, 1).numpy(),
             **{"c." + k: v for k, v in bridge.tree_to_numpy(caches).items()})

# the hybrid's train state (two stack dims) re-sharded (2, 4) -> (4, 2)
m1 = make_mesh((2, 4), ("data", "model"), device="cpu")
m2 = make_mesh((4, 2), ("data", "model"), device="cpu")
cfg = reduced(get("zamba2-2.7b"), dtype="float32")
model = build_model(cfg)
full = bridge.load_params(model, dict(np.load(f"{d}/zamba2-2.7b.npz")),
                          device="cpu")
ocfg = AdamWConfig(quantize_states=True, qblock=32)
fstate = {"params": full, "opt": adamw_init(full, ocfg)}


def layout(m):
    c = make_parallel_ctx(m)
    sp = {"params": param_specs(full, cfg, c),
          "opt": opt_state_specs(fstate["opt"], full, cfg, c)}
    return [Sharding(m, s) for s in tree_util.leaves(
        sp, is_leaf=lambda s: isinstance(s, Spec))]


def cut(shs):
    return tree_util.unflatten(fstate, [s.shard(t) for s, t in zip(
        shs, tree_util.leaves(fstate))])


sh1, sh2 = layout(m1), layout(m2)
save_checkpoint(f"{d}/ckpt", 1, cut(sh1),
                shardings=tree_util.unflatten(fstate, sh1))
restored = elastic_reshard(
    f"{d}/ckpt", 1, tree_util.tree_map(lambda t: torch.empty(
        t.shape, dtype=t.dtype, device="meta"), fstate),
    tree_util.unflatten(fstate, sh2))
want = cut(sh2)
info["E-equal"] = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
                      zip(tree_util.leaves(restored), tree_util.leaves(want)))
info["E-wx"] = list(restored["params"]["groups"]["ssm"]["wx"].shape)

json.dump(info, open(f"{d}/r{rank}.json", "w"))
dist.barrier()
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {_leaf_name(path): np.asarray(leaf.astype(jnp.float32))
            for path, leaf in flat}


def _inputs() -> dict:
    rng = np.random.default_rng(29)
    w = reduced(get("whisper-small"))
    v = reduced(get("internvl2-1b"))
    return {"tokens": rng.integers(0, 256, TOKENS).astype(np.int64),
            "frames": rng.standard_normal(
                (TOKENS[0], w.encdec.encoder_seq, w.d_model), np.float32),
            "patches": rng.standard_normal(
                (TOKENS[0], v.vision.n_patches, v.d_model), np.float32)}


def _jax_batch(cfg, inputs) -> dict:
    toks = jnp.asarray(inputs["tokens"], jnp.int32)
    b = {"tokens": toks, "labels": toks}
    if cfg.encdec is not None:
        b["frames"] = jnp.asarray(inputs["frames"])
    if cfg.vision is not None:
        b["patches"] = jnp.asarray(inputs["patches"])
    return b


def _jax_step(arch, params, inputs):
    """The reference's unsharded bf16 step (test_distributed.py:121's
    ``step0``), its arithmetic rounded where its source says."""
    jcfg = jax_reduced(jax_get(arch))
    model = jax_build_model(jcfg)
    opt_cfg = JaxAdamWConfig()
    args = (params, jax_adamw_init(params, opt_cfg), _jax_batch(jcfg, inputs))
    step = jax.jit(jax_make_train_step(model, opt_cfg, None)).lower(
        *args).compile(compiler_options={"xla_allow_excess_precision": False})
    p, _, m = step(*args)
    return float(m["loss"]), _leaves(p)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Write the inputs and the reference's parameters, start the eight
    ranks, run the reference's unsharded bf16 steps meanwhile, wait for the
    ranks."""
    d = tmp_path_factory.mktemp("families")
    inputs = _inputs()
    np.savez(d / "inputs.npz", **inputs)

    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "OMP_NUM_THREADS": "1"}
    pre = (f"PREFILL, DECODE = {PREFILL}, {DECODE}\nSTEP = {STEP!r}\n"
           f"TRAIN_ARCHS = {TRAIN_ARCHS!r}\nDECODE_ARCHS = {DECODE_ARCHS!r}\n"
           f"STATES = {STATES!r}\n")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", pre + textwrap.dedent(WORKER), str(r), port,
         str(d)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]

    def reference(arch):
        # the parameters (the ranks wait for each family's), then the
        # unsharded bf16 step; the families' compiles run side by side
        model = jax_build_model(jax_reduced(jax_get(arch)))
        params = jax.jit(model.init)(jax.random.PRNGKey(SEEDS[arch]))
        np.savez(d / f"{arch}.tmp.npz", **_leaves(params))
        os.replace(d / f"{arch}.tmp.npz", d / f"{arch}.npz")
        if arch in TRAIN_ARCHS:
            loss, p = _jax_step(arch, params, inputs)
            np.savez(d / f"jax-{arch}.npz", loss=loss,
                     **{"p." + k: v for k, v in p.items()})

    try:
        with ThreadPoolExecutor(len(DECODE_ARCHS)) as ex:
            list(ex.map(reference, DECODE_ARCHS))
        logs = []
        for p in procs:
            so, se = p.communicate(timeout=PROC_TIMEOUT_S)
            logs.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, so, se in logs:
        assert rc == 0, f"STDOUT:\n{so}\nSTDERR:\n{se}"
    return d


def _info(runs) -> list[dict]:
    return [json.loads((runs / f"r{r}.json").read_text())
            for r in range(WORLD)]


def _close(got, want, tol, msg):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol,
                               err_msg=msg)


def _rows(coords) -> slice:
    i = 2 * coords["pod"] + coords["data"]
    return slice(2 * i, 2 * i + 2)


def _batch(cfg, inputs, n=None) -> dict:
    toks = torch.from_numpy(inputs["tokens"])[:, :n]
    b = {"tokens": toks, "labels": toks}
    if cfg.encdec is not None:
        b["frames"] = torch.from_numpy(inputs["frames"])
    if cfg.vision is not None:
        b["patches"] = torch.from_numpy(inputs["patches"])
    return b


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_step_matches_reference_unsharded_step(runs, arch):
    """test_distributed.py:121 on the port, family by family: one bf16
    step on the (2, 2, 2) mesh against the reference's unsharded step from
    the same parameters and batch: the loss and every updated leaf within
    2e-2."""
    got = dict(np.load(runs / f"T-{arch}-bfloat16.npz"))
    want = dict(np.load(runs / f"jax-{arch}.npz"))
    assert abs(float(got["loss"]) - float(want["loss"])) < REF_TOL
    keys = sorted(k for k in want if k.startswith("p."))
    assert keys == sorted(k for k in got if k.startswith("p."))
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=REF_TOL,
                                   atol=REF_TOL, err_msg=k)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_step_matches_port_unsharded_step_f32(runs, arch):
    """The same step in float32 (lr 1e-3 from the first step) against the
    port's unsharded step: the loss, the gradient norm and every synced
    gradient (the global mean) within F32_TOL; every updated leaf within
    F32_TOL of the unsharded AdamW's from the same parameters and the
    sharded step's synced gradients. (Adam's first step divides each
    gradient element by its magnitude plus 1e-8, so an element near 1e-7,
    whose float32 sums over ``model`` and ``data`` run in another order,
    moves its update by a few percent: the gradients are held to the
    unsharded step, the update to the unsharded optimizer.)"""
    cfg = reduced(get(arch), dtype="float32")
    model = build_model(cfg)
    leaves = dict(np.load(runs / f"{arch}.npz"))
    params = bridge.load_params(model, leaves, device="cpu")
    ocfg = AdamWConfig(**STEP)
    tr = Trainer(model, ocfg, device="cpu")
    seen = {}

    def capture(g):
        seen["g"] = g
        return g

    _, m = tr.make_step(sync_fn=capture)(
        {"params": params, "opt": adamw_init(params, ocfg)},
        _batch(cfg, dict(np.load(runs / "inputs.npz"))))
    got = dict(np.load(runs / f"T-{arch}-float32.npz"))
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]),
                               rtol=F32_TOL)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(m["grad_norm"]), rtol=F32_TOL)
    for k, v in bridge.tree_to_numpy(seen["g"]).items():
        assert np.abs(v).max() > 0, k
        _close(got["g." + k], v, F32_TOL, "grad " + k)
    grads = bridge.load_params(model, {k[2:]: v for k, v in got.items()
                                       if k.startswith("g.")}, device="cpu")
    p1, _, _ = adamw_update(grads, adamw_init(params, ocfg), params, ocfg)
    for k, v in bridge.tree_to_numpy(p1).items():
        assert np.abs(v - leaves[k]).max() > 0, k
        _close(got["p." + k], v, F32_TOL, "param " + k)


@pytest.fixture(scope="module")
def unsharded(runs):
    """Per family, the unsharded model's prefill-then-decode logits and
    caches on the whole batch in float32; deepseek's MoE layers by
    ``emulate_ep`` (EP over the two data ranks of each pod, as the sharded
    run routes them)."""
    inputs = dict(np.load(runs / "inputs.npz"))
    apply_moe = moe.apply_moe
    moe.apply_moe = lambda p, x, cfg, pctx=None: moe.emulate_ep(
        p, x, cfg, ep=2, pods=2)
    out = {}
    try:
        for arch in DECODE_ARCHS:
            cfg = reduced(get(arch), dtype="float32")
            model = build_model(cfg)
            params = bridge.load_params(
                model, dict(np.load(runs / f"{arch}.npz")), device="cpu")
            b = _batch(cfg, inputs)
            toks = b["tokens"]
            with torch.no_grad():
                lg, caches = model.prefill(params, {
                    **b, "tokens": toks[:, :PREFILL]})
                caches = tree_util.unflatten(caches, [
                    t if k.split(".")[0] in STATES else
                    torch.nn.functional.pad(
                        t, (0, 0, 0, DECODE)
                        if k.split(".")[-1] in ("c_kv", "k_rope")
                        else (0, 0, 0, 0, 0, DECODE))
                    for k, t in tree_util.named_leaves(caches)])
                outs = [lg]
                for i in range(DECODE):
                    lg, caches = model.decode_step(params, caches, {
                        "token": toks[:, PREFILL + i], "pos": PREFILL + i})
                    outs.append(lg)
            out[arch] = (cfg, torch.cat(outs, dim=1).numpy(), caches)
    finally:
        moe.apply_moe = apply_moe
    return out


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_sharded_prefill_then_decode_logits(runs, unsharded, arch):
    """Sharded prefill of 48 tokens then 4 decode steps, each rank on its
    rows and its blocks of the caches: every step's logits against the
    unsharded model's within DECODE_TOL in float32 (deepseek-v3: MLA's
    absorbed decode with the latent over ``model``)."""
    _, want, _ = unsharded[arch]
    for r, i in enumerate(_info(runs)):
        got = np.load(runs / f"r{r}-D-{arch}.npz")["logits"]
        _close(got, want[_rows(i["coords"])], DECODE_TOL, f"rank {r}")


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_sharded_caches_are_blocks_of_unsharded(runs, unsharded, arch):
    """After the decode steps each rank's caches are its block of the
    unsharded caches, laid out as ``cache_specs`` says: the SSM states with
    heads over ``model`` (40 of 80 at full width), the conv states with
    channels over ``model``, the attention KV with its KV heads, MLA's
    ``c_kv`` and ``k_rope`` with ``r`` over ``model`` (half of each);
    whisper's cross cache holds the rank's KV heads over every encoder
    row."""
    cfg, _, caches = unsharded[arch]
    caches = dict(caches)
    mesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    pctx = make_parallel_ctx(mesh)
    cross = caches.pop("cross", None)
    specs = tree_util.leaves(cache_specs(
        caches, cfg, ShapeConfig("d", PREFILL + DECODE, 8, "decode"), pctx),
        is_leaf=is_spec)
    for r, info in enumerate(_info(runs)):
        got = dict(np.load(runs / f"r{r}-D-{arch}.npz"))
        coords = info["coords"]
        for (k, t), spec in zip(tree_util.named_leaves(caches), specs,
                                strict=True):
            sh = Sharding(mesh, spec)
            blk = t[sh.slices(t.shape, coords)].numpy()
            assert got["c." + k].shape == blk.shape, (r, k)
            assert blk.size < t.numel(), (r, k)
            _close(got["c." + k], blk, DECODE_TOL, f"rank {r} {k}")
        if cross is not None:
            for n, t in enumerate(cross):
                h = t.shape[3] // 2
                blk = t[:, _rows(coords), :, coords["model"] * h:
                        (coords["model"] + 1) * h].numpy()
                _close(got[f"c.cross.{n}"], blk, DECODE_TOL, f"rank {r}")


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_steps_reuse_the_gathered_weights(runs, arch):
    """Under ``keep_gathered`` (the decode runs above) the prefill gathers
    the embedding and each layer's ``data`` shards once and the decode
    steps gather none again."""
    for i in _info(runs):
        assert i[f"K-{arch}-prefill"] > 0
        assert i[f"K-{arch}-decode"] == 0


def test_ssm_layers_hold_their_head_and_state_blocks(runs):
    """Each rank's Mamba-2 leaves after a step are its blocks: ``wx``
    holds half of d_inner's columns (its heads), ``wB`` half of d_state's,
    and both d_model rows are over ``data`` (half each)."""
    for i in _info(runs):
        for arch in ("mamba2-2.7b", "zamba2-2.7b"):
            cfg = reduced(get(arch))
            d, d_in = cfg.d_model, cfg.ssm.expand * cfg.d_model
            lead = [cfg.n_layers] if arch == "mamba2-2.7b" else [2, 2]
            assert i[f"{arch}-wx"] == lead + [d // 2, d_in // 2]
            assert i[f"{arch}-wB"] == lead + [d // 2, cfg.ssm.d_state // 2]


def test_elastic_reshard_of_the_hybrid_state(runs):
    """The hybrid's train state (parameters over two stack dims, int8
    moments) saved from its (data 2, model 4) blocks and restored onto
    (data 4, model 2) equals the new blocks cut from the full state bit for
    bit on every rank."""
    cfg = reduced(get("zamba2-2.7b"))
    for i in _info(runs):
        assert i["E-equal"]
        assert i["E-wx"] == [2, 2, cfg.d_model // 4,
                             cfg.ssm.expand * cfg.d_model // 2]


@pytest.mark.parametrize("arch", DECODE_ARCHS + ("deepseek-7b",))
def test_entry_points_take_the_reference_parameters(arch):
    """Every family's ``loss_fn``, ``prefill`` and ``decode_step`` take the
    reference's parameter names, ``pctx=None`` included."""
    ours = build_model(reduced(get(arch)))
    ref = jax_build_model(jax_reduced(jax_get(arch)))
    assert type(ours).__name__ == type(ref).__name__
    assert isinstance(ref, tuple(getattr(jax_transformer, n) for n in
                                 ("LM", "SSMLM", "HybridLM", "EncDecLM")))
    assert isinstance(ours, tuple(getattr(transformer, n) for n in
                                  ("LM", "SSMLM", "HybridLM", "EncDecLM")))
    for name in ("loss_fn", "prefill", "decode_step"):
        got = inspect.signature(getattr(ours, name)).parameters
        want = inspect.signature(getattr(ref, name)).parameters
        assert list(got) == list(want), name
        assert got["pctx"].default is None and want["pctx"].default is None
