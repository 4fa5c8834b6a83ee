"""The port's sharding on a (pod, data, model) = (2, 2, 2) process mesh
against unsharded runs: the reference's ``tests/test_distributed.py``
checks (:97 EP+TP MoE, :121 the sharded train step, :168 elastic re-shard,
:189 GVAS addressing) on the port.

Eight gloo processes on the CPU, started once for the module, each under a
timeout, run:

* one sharded ``Trainer`` step of the reduced ``deepseek-7b`` (2 layers)
  from the reference's parameters: bf16 (held against the reference's
  unsharded step, run here, at its 2e-2), f32 and f32 with int8 moments
  (held against the port's unsharded step, run here, at F32_TOL);
* the reduced granite MoE layer with EP over ``data`` and TP over
  ``model`` against the ``model``-size-1 EP run (``emulate_ep``);
* one sharded step of the reduced ``deepseek-v3-671b`` (MLA expanded under
  TP, MoE with EP+TP, MTP) against its unsharded step with every MoE layer
  run by ``emulate_ep``;
* sharded prefill then decode of the reduced ``deepseek-7b`` and of a
  variant whose 1 KV head does not split over ``model`` (the reference's
  ``mha_ize``), logits against the unsharded model's;
* a train state saved on (data 2, model 4) and restored onto (data 4,
  model 2) with ``elastic_reshard``; and GVAS addressing on (2, 4).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap

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
from repro.train.loop import make_train_step as jax_make_train_step
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.config import reduced
from repro_torch.configs import get
from repro_torch.models import build_model, moe
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
PROC_TIMEOUT_S = 300
#: the reference's test_distributed.py:121 tolerance (sharded vs unsharded)
REF_TOL = 2e-2
#: the port sharded against the port unsharded in float32: the same
#: arithmetic with the row-parallel products summed in a different order
#: (every value within 1e-5 of the largest of its kind)
F32_TOL = 1e-5
#: MoE, MLA and decode in float32 (longer chains of such sums), and bf16
#: the reference's MODEL_TOL (test_torch_train_step.py)
MODEL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
TOKENS = (8, 64)
MOE_X = (8, 16)
PREFILL, DECODE = 12, 4
#: (label, config overrides) of the decode cases: GQA with 2 KV heads (1 a
#: rank), 1 KV head repeated to the 4 query heads (the reference's
#: mha_ize: 2 a rank), and 6 query heads on a (data 2, model 4) mesh,
#: which do not split over model: attention runs whole on every model
#: rank while cache_specs splits the caches' head dim (4 of 16 a rank),
#: gathered for the kernel
D_CASES = (("gqa", {}), ("mha_ize", {"n_kv_heads": 1}),
           ("hd_split", {"n_heads": 6}))
#: int8 moments with blocks of 64: some shards cut a block (tokens, wo),
#: others hold whole blocks (w_gate)
INT8 = dict(quantize_states=True, qblock=64)
#: the float32 steps' schedule: lr 1e-3 from the first step (warmup 1), so
#: a step moves a weight by about 1e-3, three orders above F32_TOL of it
#: (the default warmup of 100 moves it by 3e-6, which no tolerance of the
#: updated leaves could tell from no step at all)
STEP = dict(lr=1e-3, warmup_steps=1)
#: the sharded optimizer's update p1 - p0 against the unsharded AdamW's
#: from the same (gathered) synced gradients, relative to the update's
#: largest element: the same arithmetic but for the order of the gradient
#: norm's sum, rounded to float32 weights of magnitude up to 1 (ulp 1.2e-7,
#: 1.2e-4 of an update of 1e-3); an update missing or applied twice reads 1
DELTA_TOL = 1e-3

WORKER = """
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.checkpoint.store import save_checkpoint
from repro_torch.config import reduced
from repro_torch.configs import get
from repro_torch.core.gvas import GlobalArray, addr_of, global_bytes, shard_of
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model, moe
from repro_torch.models.transformer import layer_specs
from repro_torch.parallel.ctx import make_parallel_ctx
from repro_torch.parallel.sharding import (Sharding, Spec, gather_tree,
                                           opt_state_specs, param_specs,
                                           shard_tree)
from repro_torch.parallel.tensor_parallel import gather_dims, sum_across
from repro_torch.runtime.fault import elastic_reshard
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import AdamWConfig, adamw_init

rank, port, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=8, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
pctx = make_parallel_ctx(mesh)
m1 = make_mesh((2, 4), ("data", "model"), device="cpu")
m2 = make_mesh((4, 2), ("data", "model"), device="cpu")
info = {"coords": mesh.coords}
toks = torch.from_numpy(np.load(f"{d}/tokens.npy"))
batch = {"tokens": toks, "labels": toks}


def save(name, arrays):
    if rank == 0:
        np.savez(f"{d}/{name}.npz", **arrays)


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

    state, m = tr.make_step(sync_fn=capture)(state, shard_batch(batch, pctx))
    specs = param_specs(params, cfg, pctx)
    out = {"loss": np.float32(m["loss"]),
           "grad_norm": np.float32(m["grad_norm"])}
    for pre, tree in (("p.", state["params"]), ("g.", seen["g"])):
        for k, v in bridge.tree_to_numpy(gather_tree(tree, specs,
                                                     mesh)).items():
            out[pre + k] = v
    ospecs = opt_state_specs(adamw_init(params, opt_cfg), params, cfg, pctx)
    full_opt = gather_tree(state["opt"], ospecs, mesh)
    for k, v in tree_util.named_leaves(full_opt):
        out["o." + k] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return out


# ---- A: the sharded step of the reduced deepseek-7b
ds7 = dict(np.load(f"{d}/ds7_params.npz"))
for dtype, qs in (("bfloat16", False), ("float32", False), ("float32", True)):
    cfg = reduced(get("deepseek-7b"), n_layers=2, dtype=dtype)
    # bf16: the reference's test, its default schedule; float32: STEP
    ocfg = AdamWConfig(**({} if dtype == "bfloat16" else STEP),
                       **(INT8 if qs else {}))
    save(f"A-{dtype}-{'int8' if qs else 'f32'}", train_step(cfg, ds7, ocfg))

# ---- B: granite's MoE layer, EP over data and TP over model
x_all, dy_all = np.load(f"{d}/x.npy"), np.load(f"{d}/dy.npy")
rows = slice(2 * (2 * mesh.coords["pod"] + mesh.coords["data"]),
             2 * (2 * mesh.coords["pod"] + mesh.coords["data"]) + 2)
routes = []
route_orig = moe.route


def route_rec(x, w, cfg):
    out = route_orig(x, w, cfg)
    routes.append(out[1])
    return out


moe.route = route_rec
for dtype in ("float32", "bfloat16"):
    cfg = reduced(get("granite-moe-1b-a400m"), dtype=dtype)
    specs = layer_specs(cfg, "moe", pctx)["ffn"]
    tmpl = moe.init_moe(torch.Generator(), cfg, cfg.d_model,
                        torch.device("meta"))
    full = bridge.load_tree(tmpl, dict(np.load(f"{d}/moe_params.npz")),
                            device="cpu")
    names = [n for n, _ in tree_util.named_leaves(full)]
    spec_of = dict(zip(names, tree_util.leaves(
        specs, is_leaf=lambda s: isinstance(s, Spec))))

    def layout(n):
        # expert stacks as stored; the rest as the layer's entry leaves
        # them (gathered over data)
        s = spec_of[n]
        if n.split(".")[-1] in ("w_gate", "w_up", "w_out") and "shared" \\
                not in n:
            return Sharding(mesh, s)
        return Sharding(mesh, Spec(*(None if e == "data" else e for e in s)))

    lay = {n: layout(n) for n in names}
    p = tree_util.unflatten(full, [lay[n].shard(t).requires_grad_(True)
                                   for n, t in tree_util.named_leaves(full)])
    td = getattr(torch, dtype)
    x = torch.from_numpy(x_all[rows]).to(td).requires_grad_(True)
    routes.clear()
    y = moe.apply_moe(p, x, cfg, pctx)
    (y.float() * torch.from_numpy(dy_all[rows])).sum().backward()
    out = {"y": y.detach().float().numpy(), "dx": x.grad.float().numpy(),
           "ids": routes[0].numpy()}
    for n, t in tree_util.named_leaves(p):
        g = gather_dims(t.grad, lay[n], range(t.dim()))
        expert = lay[n].spec != Spec(*(None if e == "data" else e
                                       for e in lay[n].spec))
        # one copy per pod for the expert stacks, per DP rank otherwise
        g = sum_across(g, mesh.group("pod" if expert else ("pod", "data")))
        out["d." + n] = g.float().numpy()
    info[f"B-{dtype}-local_experts"] = int(p["w_gate"].shape[0])
    info[f"B-{dtype}-local_hidden"] = int(p["w_gate"].shape[2])
    np.savez(f"{d}/r{rank}-B-{dtype}.npz", **out)
moe.route = route_orig

# ---- C: the reduced deepseek-v3 (MLA expanded under TP, EP+TP, MTP)
cfg = reduced(get("deepseek-v3-671b"), dtype="float32")
save("C", train_step(cfg, dict(np.load(f"{d}/dsv3_params.npz")),
                     AdamWConfig(**STEP)))

# ---- D: sharded prefill, then decode
for label, over in D_CASES:
    cfg = reduced(get("deepseek-7b"), n_layers=2, dtype="float32", **over)
    model = build_model(cfg)
    full = bridge.load_params(model, dict(np.load(f"{d}/ds7_{label}.npz")),
                              device="cpu")
    ctx = make_parallel_ctx(m1) if label == "hd_split" else pctx
    params = shard_tree(full, param_specs(full, cfg, ctx), ctx.mesh)
    local = shard_batch(batch, ctx)["tokens"]
    with torch.no_grad():
        lg, caches = model.prefill(params, {"tokens": local[:, :PREFILL]},
                                   ctx)
        caches = tree_util.tree_map(
            lambda t: F.pad(t, (0, 0, 0, 0, 0, DECODE)).contiguous(), caches)
        info[f"D-{label}-cache"] = list(caches["dense"]["k"].shape)
        outs = [lg]
        for i in range(DECODE):
            lg, caches = model.decode_step(
                params, caches, {"token": local[:, PREFILL + i],
                                 "pos": PREFILL + i}, ctx)
            outs.append(lg)
    np.savez(f"{d}/r{rank}-D-{label}.npz",
             logits=torch.cat(outs, dim=1).numpy())

# ---- E: elastic re-shard (data 2, model 4) -> (data 4, model 2)
cfg = reduced(get("deepseek-7b"), n_layers=2, dtype="float32")
model = build_model(cfg)
full = bridge.load_params(model, ds7, device="cpu")
ocfg = AdamWConfig(quantize_states=True, qblock=32)
fstate = {"params": full, "opt": adamw_init(full, ocfg)}
fstate["opt"]["m"] = tree_util.tree_map(
    lambda t: t + 0.5 if t.dtype == torch.float32 else t + 3,
    fstate["opt"]["m"])


def state_shardings(m):
    c = make_parallel_ctx(m)
    sp = {"params": param_specs(full, cfg, c),
          "opt": opt_state_specs(fstate["opt"], full, cfg, c)}
    return tree_util.unflatten(fstate, [
        Sharding(m, s) for s in tree_util.leaves(
            sp, is_leaf=lambda s: isinstance(s, Spec))])


sh1, sh2 = state_shardings(m1), state_shardings(m2)


def cut(tree, shs):
    return tree_util.unflatten(tree, [s.shard(t) for s, t in zip(
        tree_util.leaves(shs, is_leaf=lambda s: isinstance(s, Sharding)),
        tree_util.leaves(tree))])


ckpt = f"{d}/ckpt"
save_checkpoint(ckpt, 3, cut(fstate, sh1), shardings=sh1)
template = tree_util.tree_map(
    lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), fstate)
restored = elastic_reshard(ckpt, 3, template, sh2)
for t in tree_util.leaves(restored):
    assert t.device.type == "cpu"
want = cut(fstate, sh2)
info["E-equal"] = all(
    a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(tree_util.leaves(restored), tree_util.leaves(want)))
info["E-leaves"] = len(tree_util.leaves(want))
x = torch.randn((16, 8), generator=torch.Generator().manual_seed(0))
w1, w2 = (Sharding(m, Spec("data", "model")) for m in (m1, m2))
save_checkpoint(f"{d}/ckpt-w", 3, {"w": w1.shard(x)}, shardings={"w": w1})
r = elastic_reshard(f"{d}/ckpt-w", 3,
                    {"w": torch.empty((16, 8), device="meta")}, {"w": w2})
info["E-w"] = bool(torch.equal(r["w"], w2.shard(x))
                   and tuple(r["w"].shape) == (4, 4))

# ---- F: GVAS addressing on (data 2, model 4)
xs = torch.arange(64, dtype=torch.float32).reshape(8, 8)
sh = Sharding(m1, Spec("data", "model"))
arr = GlobalArray.of(sh.shard(xs), sh)
a = addr_of(arr, (5, 3))
info["F-replicas"] = a["replicas"]
owner = a["replicas"][0]["rank"]
local = shard_of(arr, owner)
info["F-owner-reads"] = (None if local is None else
                         float(local[a["replicas"][0]["local_index"]]))
info["F-other"] = (shard_of(arr, (rank + 1) % 8) is None
                   and shard_of(arr, rank) is arr.local)
info["F-bytes"] = global_bytes(arr)
rep = GlobalArray.of(Sharding(m1, Spec(None, "model")).shard(xs),
                     Sharding(m1, Spec(None, "model")))
info["F-rep-ranks"] = [r["rank"] for r in addr_of(rep, (5, 3))["replicas"]]

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


def _jax_step(jcfg, params, toks):
    """The reference's unsharded step (test_distributed.py:121's
    ``step0``)."""
    model = jax_build_model(jcfg)
    opt_cfg = JaxAdamWConfig()
    opt = jax_adamw_init(params, opt_cfg)
    batch = {"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(toks, jnp.int32)}
    p, _, m = jax.jit(jax_make_train_step(model, opt_cfg, None))(
        params, opt, batch)
    return float(m["loss"]), _leaves(p)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Write the inputs, start the eight ranks, run the reference's
    unsharded bf16 step meanwhile, wait for the ranks."""
    d = tmp_path_factory.mktemp("sharded")
    jcfg = jax_reduced(jax_get("deepseek-7b"), n_layers=2)
    jp = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    np.savez(d / "ds7_params.npz", **_leaves(jp))
    for label, over in D_CASES:
        c = jax_reduced(jax_get("deepseek-7b"), n_layers=2, dtype="float32",
                        **over)
        np.savez(d / f"ds7_{label}.npz", **_leaves(
            jax_build_model(c).init(jax.random.PRNGKey(1))))
    v3 = jax_reduced(jax_get("deepseek-v3-671b"), dtype="float32")
    np.savez(d / "dsv3_params.npz", **_leaves(
        jax_build_model(v3).init(jax.random.PRNGKey(2))))
    g = jax_reduced(jax_get("granite-moe-1b-a400m"), dtype="float32")
    np.savez(d / "moe_params.npz", **_leaves(
        jax_moe.init_moe(jax.random.PRNGKey(3), g, g.d_model)))
    rng = np.random.default_rng(24)
    np.save(d / "tokens.npy", rng.integers(0, 256, TOKENS).astype(np.int64))
    np.save(d / "x.npy", rng.standard_normal(MOE_X + (g.d_model,),
                                             np.float32))
    np.save(d / "dy.npy", rng.standard_normal(MOE_X + (g.d_model,),
                                              np.float32))
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "OMP_NUM_THREADS": "1"}
    pre = (f"PREFILL, DECODE = {PREFILL}, {DECODE}\n"
           f"D_CASES = {D_CASES!r}\nINT8, STEP = {INT8!r}, {STEP!r}\n")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", pre + textwrap.dedent(WORKER), str(r), port,
         str(d)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]
    try:
        loss, p = _jax_step(jcfg, jp, np.load(d / "tokens.npy"))
        np.savez(d / "jax-A.npz", loss=loss, **{"p." + k: v
                                                for k, v in p.items()})
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


def _close_to_own_scale(got, want, tol, msg):
    """``got`` within ``tol`` of ``want``'s largest element (no floor of 1:
    for leaves far below 1, such as the moments and their scales)."""
    scale = float(np.abs(want).max())
    assert scale > 0, msg
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol,
                               err_msg=msg)


def _check_update(got, leaves_file, cfg, ocfg, msg, runs):
    """The sharded optimizer against the unsharded ``adamw_update`` run on
    the sharded step's gathered synced gradients from the same parameters:
    the gradient norm (the sharded step's ``global_norm`` over shards
    against the unsharded one) within 1e-6, each leaf's update ``p1 - p0``
    within DELTA_TOL of its own largest element (every leaf moves), the
    float32 moments within 1e-6 of their own scale, int8 codes equal and
    their scales within 1e-6 of their own scale."""
    model = build_model(cfg)
    leaves = dict(np.load(runs / leaves_file))
    p0 = bridge.load_params(model, leaves, device="cpu")
    grads = bridge.load_params(model, {k[2:]: v for k, v in got.items()
                                       if k.startswith("g.")}, device="cpu")
    p1, opt, m = adamw_update(grads, adamw_init(p0, ocfg), p0, ocfg)
    np.testing.assert_allclose(float(got["grad_norm"]), float(m["grad_norm"]),
                               rtol=1e-6, err_msg=msg)
    for k, want in bridge.tree_to_numpy(p1).items():
        w0 = leaves[k].astype(np.float64)
        dw = want.astype(np.float64) - w0
        assert np.abs(dw).max() > 0, (msg, k)
        _close_to_own_scale(got["p." + k].astype(np.float64) - w0, dw,
                            DELTA_TOL, f"{msg} update {k}")
    for k, v in tree_util.named_leaves(opt):
        g, v = got["o." + k], v.float().numpy()
        if k.endswith(".q"):
            np.testing.assert_array_equal(g, v, err_msg=f"{msg} {k}")
        elif k == "step":
            assert int(g) == int(v) == 1, msg
        else:
            _close_to_own_scale(g, v, 1e-6, f"{msg} moment {k}")


def _port_step(runs, cfg, opt_cfg, leaves_file="ds7_params.npz"):
    """The port's unsharded step from the same parameters and batch: loss,
    metrics, gradients and the updated state."""
    model = build_model(cfg)
    params = bridge.load_params(model, dict(np.load(runs / leaves_file)),
                                device="cpu")
    toks = torch.from_numpy(np.load(runs / "tokens.npy"))
    tr = Trainer(model, opt_cfg, device="cpu")
    state = {"params": params, "opt": adamw_init(params, opt_cfg)}
    seen = {}

    def capture(g):
        seen["g"] = g
        return g

    state, m = tr.make_step(sync_fn=capture)(state, {"tokens": toks,
                                                     "labels": toks})
    return m, seen["g"], state


def test_mesh_coordinates_are_row_major(runs):
    assert [i["coords"] for i in _info(runs)] == [
        {"pod": p, "data": d, "model": m}
        for p in (0, 1) for d in (0, 1) for m in (0, 1)]


def test_sharded_step_matches_reference_unsharded_step(runs):
    """test_distributed.py:121 on the port: one bf16 step of the reduced
    deepseek-7b on the (2, 2, 2) mesh against the reference's unsharded
    step from the same parameters and batch: the loss and every updated
    leaf within 2e-2."""
    got = dict(np.load(runs / "A-bfloat16-f32.npz"))
    want = dict(np.load(runs / "jax-A.npz"))
    assert abs(float(got["loss"]) - float(want["loss"])) < REF_TOL
    keys = sorted(k for k in want if k.startswith("p."))
    assert keys == sorted(k for k in got if k.startswith("p."))
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=REF_TOL,
                                   atol=REF_TOL, err_msg=k)


@pytest.mark.parametrize("moments", ["f32", "int8"])
def test_sharded_step_matches_port_unsharded_step_f32(runs, moments):
    """The same step in float32 (STEP's schedule) against the port's
    unsharded step: loss, the gradient norm, synced gradients (the global mean), updated parameters within F32_TOL, the
    moments within F32_TOL of their own scale; with int8 moments (blocks of
    64) the codes within one step and the scales within F32_TOL of their
    own scale, where some shards cut a block and read their scales whole.
    Then the sharded optimizer against the unsharded one on the same
    gradients (``_check_update``)."""
    cfg = reduced(get("deepseek-7b"), n_layers=2, dtype="float32")
    ocfg = AdamWConfig(**STEP, **(INT8 if moments == "int8" else {}))
    m, grads, state = _port_step(runs, cfg, ocfg)
    got = dict(np.load(runs / f"A-float32-{moments}.npz"))
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]),
                               rtol=F32_TOL)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(m["grad_norm"]), rtol=F32_TOL)
    for k, v in bridge.tree_to_numpy(grads).items():
        _close(got["g." + k], v, F32_TOL, "grad " + k)
    for k, v in bridge.tree_to_numpy(state["params"]).items():
        _close(got["p." + k], v, F32_TOL, "param " + k)
    _check_update(got, "ds7_params.npz", cfg, ocfg, moments, runs)
    n_q = 0
    for k, v in tree_util.named_leaves(state["opt"]):
        g = got["o." + k]
        if k.endswith(".q"):
            n_q += 1
            assert np.abs(g.astype(np.int32) - v.numpy().astype(np.int32)
                          ).max() <= 1, k
        elif k != "step":
            _close_to_own_scale(g, v.float().numpy(), F32_TOL, "moment " + k)
        else:
            assert int(g) == int(v) == 1
    # m and v of tokens, head, wo, w_gate, w_up, w_out
    assert n_q == (0 if moments == "f32" else 12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ep_tp_matches_model_size_1_ep(runs, dtype):
    """test_distributed.py:97 on the port: granite's MoE layer with its
    experts stored over ``data`` (2 of 4 a rank) and their hidden dim split
    over ``model`` (16 of 32) against ``emulate_ep`` (EP over data with a
    ``model`` axis of 1) on the whole batch: the routes equal, the output,
    input gradient and parameter gradients within MODEL_TOL."""
    cfg = reduced(get("granite-moe-1b-a400m"), dtype=dtype)
    tmpl = moe.init_moe(torch.Generator(), cfg, cfg.d_model,
                        torch.device("meta"))
    p = bridge.load_tree(tmpl, dict(np.load(runs / "moe_params.npz")),
                         device="cpu")
    p = tree_util.tree_map(lambda t: t.requires_grad_(True), p)
    x = torch.from_numpy(np.load(runs / "x.npy")).to(getattr(torch, dtype))
    x.requires_grad_(True)
    ids = []
    orig = moe.route

    def rec(*a):
        out = orig(*a)
        ids.append(out[1])
        return out

    moe.route = rec
    try:
        y = moe.emulate_ep(p, x, cfg, ep=2, pods=2)
    finally:
        moe.route = orig
    (y.float() * torch.from_numpy(np.load(runs / "dy.npy"))).sum().backward()
    info = _info(runs)
    assert {i[f"B-{dtype}-local_experts"] for i in info} == {2}
    assert {i[f"B-{dtype}-local_hidden"] for i in info} == {16}
    tol = MODEL_TOL[dtype]
    for r, i in enumerate(info):
        got = dict(np.load(runs / f"r{r}-B-{dtype}.npz"))
        pod, dat = i["coords"]["pod"], i["coords"]["data"]
        np.testing.assert_array_equal(got["ids"][0], ids[pod][dat].numpy())
        rows = slice(2 * (2 * pod + dat), 2 * (2 * pod + dat) + 2)
        _close(got["y"], y.detach().float().numpy()[rows], tol, f"r{r} y")
        _close(got["dx"], x.grad.float().numpy()[rows], tol, f"r{r} dx")
        for k, t in tree_util.named_leaves(p):
            assert t.grad.abs().max() > 0, k
            _close(got["d." + k], t.grad.float().numpy(), tol, f"r{r} d{k}")


def test_mla_tp_step_matches_unsharded_with_emulated_ep(runs, monkeypatch):
    """One sharded step of the reduced deepseek-v3 (MLA's expanded form
    split over ``model`` by heads, its MoE layers EP over ``data`` and TP
    over ``model``, the MTP head) against the unsharded step with every MoE
    layer run by ``emulate_ep``: loss, synced gradients and updated
    parameters within MODEL_TOL in float32 (STEP's schedule); the sharded
    optimizer against the unsharded one on the same gradients
    (``_check_update``)."""
    cfg = reduced(get("deepseek-v3-671b"), dtype="float32")
    monkeypatch.setattr(moe, "apply_moe", lambda p, x, cfg, pctx=None:
                        moe.emulate_ep(p, x, cfg, ep=2, pods=2))
    m, grads, state = _port_step(runs, cfg, AdamWConfig(**STEP),
                                 "dsv3_params.npz")
    got = dict(np.load(runs / "C.npz"))
    tol = MODEL_TOL["float32"]
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]),
                               rtol=tol)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(m["grad_norm"]), rtol=tol)
    want = bridge.tree_to_numpy(grads)
    assert {"mtp.proj", "moe_stack.attn.wkv_b", "moe_stack.ffn.w_gate"
            } <= set(want)
    for k, v in want.items():
        _close(got["g." + k], v, tol, "grad " + k)
    for k, v in bridge.tree_to_numpy(state["params"]).items():
        _close(got["p." + k], v, tol, "param " + k)
    _check_update(got, "dsv3_params.npz", cfg, AdamWConfig(**STEP),
                  "deepseek-v3", runs)


@pytest.mark.parametrize("label", [c[0] for c in D_CASES])
def test_sharded_prefill_then_decode_logits(runs, label):
    """Sharded prefill of 12 tokens then 4 decode steps, each rank on its
    rows and its block of the caches (D_CASES): every step's logits
    against the unsharded model's within MODEL_TOL in float32."""
    over = dict(D_CASES)[label]
    cfg = reduced(get("deepseek-7b"), n_layers=2, dtype="float32", **over)
    model = build_model(cfg)
    params = bridge.load_params(model, dict(np.load(runs / f"ds7_{label}.npz")),
                                device="cpu")
    toks = torch.from_numpy(np.load(runs / "tokens.npy"))
    with torch.no_grad():
        lg, caches = model.prefill(params, {"tokens": toks[:, :PREFILL]})
        caches = tree_util.tree_map(lambda t: torch.nn.functional.pad(
            t, (0, 0, 0, 0, 0, DECODE)).contiguous(), caches)
        outs = [lg]
        for i in range(DECODE):
            lg, caches = model.decode_step(params, caches, {
                "token": toks[:, PREFILL + i], "pos": PREFILL + i})
            outs.append(lg)
    want = torch.cat(outs, dim=1).numpy()
    cache = {"gqa": [2, 2, PREFILL + DECODE, 1, 16],
             "mha_ize": [2, 2, PREFILL + DECODE, 2, 16],
             "hd_split": [2, 4, PREFILL + DECODE, 2, 4]}[label]
    for r, i in enumerate(_info(runs)):
        assert i[f"D-{label}-cache"] == cache
        got = np.load(runs / f"r{r}-D-{label}.npz")["logits"]
        if label == "hd_split":          # (data 2, model 4): 4 rows a rank
            rows = slice(4 * (r // 4), 4 * (r // 4) + 4)
        else:
            pod, dat = i["coords"]["pod"], i["coords"]["data"]
            rows = slice(2 * (2 * pod + dat), 2 * (2 * pod + dat) + 2)
        _close(got, want[rows], MODEL_TOL["float32"], f"rank {r}")


def test_elastic_reshard_from_2x4_to_4x2(runs):
    """test_distributed.py:168 on the port: a train state (parameters and
    int8 moments) saved from its (data 2, model 4) blocks and restored onto
    (data 4, model 2) equals the new blocks cut from the full state bit for
    bit on every rank, and the reference's (16, 8) leaf over ("data",
    "model") comes back as (4, 4) blocks."""
    for i in _info(runs):
        assert i["E-equal"] and i["E-w"] and i["E-leaves"] > 30


def test_gvas_addressing(runs):
    """test_distributed.py:189 on the port: element (5, 3) of an 8x8 leaf
    over ("data", "model") on (2, 4) lives on one rank, at (data 1, model
    1), local index (1, 1), and reads back there; a leaf replicated over
    data lives on both data ranks of its model block."""
    info = _info(runs)
    for i in info:
        assert i["F-replicas"] == [{"rank": 5, "coords": {"data": 1,
                                                          "model": 1},
                                    "local_index": [1, 1]}]
        assert i["F-other"] and i["F-bytes"] == 64 * 4
        assert i["F-rep-ranks"] == [1, 5]
    assert info[5]["F-owner-reads"] == 43.0
    assert all(i["F-owner-reads"] is None for r, i in enumerate(info)
               if r != 5)
