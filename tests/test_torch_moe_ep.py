"""Expert parallelism over ``data`` on a 2x2 process mesh against the JAX
reference's ``shard_map``.

Four gloo processes on the CPU (``pod`` = 2, ``data`` = 2) run the port's
``apply_moe`` with a ``ParallelCtx``: each rank takes its quarter of the
flat tokens and computes experts ``r*E/2 .. (r+1)*E/2 - 1`` for its pod's
data group through ``all_to_all``. The reference runs ``apply_moe`` under
``shard_map`` on a ``("pod", "data", "model") = (2, 2, 1)`` mesh of four
host devices in a subprocess, as ``tests/test_distributed.py`` does. Both
run the same EP semantics with the same capacities, so each rank's output,
its input gradient and the sum over ranks of its parameter gradients equal
the reference's, exact and int8 (``a2a_quant``), in float32 and bfloat16.
The ranks also take one ``Trainer`` step with EP; its synced gradients equal
those of the whole batch in one process with every MoE layer replaced by
``emulate_ep`` (the all_to_all as a transpose of the ranks' buffers). Every
process runs under a timeout.
"""

from __future__ import annotations

import dataclasses
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
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.config import reduced
from repro_torch.configs import get
from repro_torch.models import build_model, moe
from repro_torch.train.loop import _value_and_grad

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
ARCH = "granite-moe-1b-a400m"
#: (id, dtype, a2a_quant)
CASES = [(f"{dt}-{'int8' if q else 'exact'}", dt, q)
         for dt in ("float32", "bfloat16") for q in (False, True)]
#: the same EP semantics and capacities on both sides: f32 summation order,
#: bf16 the reference test_torch_train_step.py's MODEL_TOL
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
#: global batch of the module cases (each rank: 2 rows = 32 tokens) and of
#: the train step (each rank: 2 rows of 32)
X_SHAPE = (8, 16)
TRAIN_SHAPE = (8, 32)
PROC_TIMEOUT_S = 300

WORKER = """
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.config import reduced
from repro_torch.configs import get
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model, moe
from repro_torch.parallel.ctx import make_parallel_ctx
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import AdamWConfig

rank, port, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=4, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
mesh = make_mesh((2, 2), ("pod", "data"), device="cpu")
pctx = make_parallel_ctx(mesh)
cases = json.load(open(f"{d}/cases.json"))
res = {"coords": mesh.coords}
for name, dtype, quant in cases:
    cfg = reduced(get("granite-moe-1b-a400m"), dtype=dtype)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           a2a_quant=quant))
    leaves = dict(np.load(f"{d}/moe_params.npz"))
    tmpl = moe.init_moe(torch.Generator(), cfg, cfg.d_model,
                        torch.device("meta"))
    p = bridge.load_tree(tmpl, leaves, device="cpu")
    p = tree_util.tree_map(lambda t: t.requires_grad_(True), p)
    x, dy = np.load(f"{d}/x.npy"), np.load(f"{d}/dy.npy")
    rows = slice(rank * 2, rank * 2 + 2)
    td = getattr(torch, dtype)
    xl = torch.from_numpy(x[rows]).to(td).requires_grad_(True)
    y = moe.apply_moe(p, xl, cfg, pctx)
    (y.float() * torch.from_numpy(dy[rows])).sum().backward()
    out = {"y": y.detach().float().numpy(), "dx": xl.grad.float().numpy()}
    for k, t in tree_util.named_leaves(p):
        out["d." + k] = t.grad.float().numpy()
    np.savez(f"{d}/r{rank}-{name}.npz", **out)

# one EP train step of the reduced f32 LM; the synced gradients are kept
cfg = reduced(get("granite-moe-1b-a400m"), dtype="float32")
model = build_model(cfg)
params = bridge.load_params(model, dict(np.load(f"{d}/lm_params.npz")),
                            device="cpu")
tr = Trainer(model, AdamWConfig(lr=1e-3, warmup_steps=1, decay_steps=10),
             pctx=pctx, mesh=mesh, device="cpu")
seen = {}

def capture(sync):
    def fn(grads):
        seen["local"] = grads
        seen["synced"] = sync(grads)
        return seen["synced"]
    return fn

toks = np.load(f"{d}/tokens.npy")
rows = slice(rank * 2, rank * 2 + 2)
batch = {"tokens": torch.from_numpy(toks[rows]),
         "labels": torch.from_numpy(toks[rows])}
from repro_torch.train.optimizer import adamw_init
state = {"params": params, "opt": adamw_init(params, tr.opt_cfg)}
state, metrics = tr.make_step(sync_fn=capture(tr.make_sync()))(state, batch)
r = mesh.coords["data"]
w = seen["local"]["moe_stack"]["ffn"]["w_gate"]
E_l = cfg.moe.n_experts // 2
res["loss"] = float(metrics["loss"])
res["zero_outside_slice"] = bool(
    (w[:, :r * E_l] == 0).all() and (w[:, (r + 1) * E_l:] == 0).all()
    and (w[:, r * E_l:(r + 1) * E_l] != 0).any())
np.savez(f"{d}/r{rank}-train.npz",
         **{"g." + k: v for k, v in bridge.tree_to_numpy(seen["synced"]).items()},
         **{"p." + k: v for k, v in bridge.tree_to_numpy(state["params"]).items()})
json.dump(res, open(f"{d}/r{rank}.json", "w"))
dist.barrier()
dist.destroy_process_group()
"""

JAX_RUN = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from repro.config import reduced
from repro.configs import get
from repro.launch.mesh import make_mesh, make_parallel_ctx
from repro.models import moe

d = sys.argv[1]
mesh = make_mesh((2, 2, 1), ("pod", "data", "model"))
pctx = make_parallel_ctx(mesh)
x, dy = np.load(f"{d}/x.npy"), np.load(f"{d}/dy.npy")
for name, dtype, quant in json.load(open(f"{d}/cases.json")):
    cfg = reduced(get("granite-moe-1b-a400m"), dtype=dtype)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           a2a_quant=quant))
    p = moe.init_moe(jax.random.PRNGKey(0), cfg, cfg.d_model)

    def loss(p, x):
        y = moe.apply_moe(p, x, cfg, pctx)
        return jnp.sum(y.astype(jnp.float32) * dy), y

    jx = jnp.asarray(x).astype(dtype)
    fn = jax.jit(jax.value_and_grad(loss, (0, 1), has_aux=True))
    with mesh:
        (_, y), (gp, gx) = fn.lower(p, jx).compile(compiler_options={
            "xla_allow_excess_precision": False})(p, jx)
    out = {"y": np.asarray(y.astype(jnp.float32)),
           "dx": np.asarray(gx.astype(jnp.float32))}
    for k, v in gp.items():
        out["d." + k] = np.asarray(v.astype(jnp.float32))
    np.savez(f"{d}/jax-{name}.npz", **out)
print("OK")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {_leaf_name(path): np.asarray(leaf.astype(jnp.float32))
            for path, leaf in flat}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Write the inputs, start the four port ranks and the reference's run
    together, wait for all five."""
    d = tmp_path_factory.mktemp("moe_ep")
    jcfg = jax_reduced(jax_get(ARCH), dtype="float32")
    np.savez(d / "moe_params.npz", **_leaves(
        jax_moe.init_moe(jax.random.PRNGKey(0), jcfg, jcfg.d_model)))
    np.savez(d / "lm_params.npz", **_leaves(
        jax_build_model(jcfg).init(jax.random.PRNGKey(0))))
    rng = np.random.default_rng(21)
    np.save(d / "x.npy", rng.standard_normal(X_SHAPE + (jcfg.d_model,),
                                             np.float32))
    np.save(d / "dy.npy", rng.standard_normal(X_SHAPE + (jcfg.d_model,),
                                              np.float32))
    np.save(d / "tokens.npy", rng.integers(0, jcfg.vocab_size, TRAIN_SHAPE
                                           ).astype(np.int64))
    (d / "cases.json").write_text(__import__("json").dumps(CASES))
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "OMP_NUM_THREADS": "1"}
    pre = "import dataclasses\n"
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", pre + textwrap.dedent(WORKER), str(r), port,
         str(d)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_RUN), str(d)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    logs = []
    try:
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


def _close(got, want, tol, msg):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol,
                               err_msg=msg)


def _rank_rows(a, r):
    return a[r * 2:(r + 1) * 2]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_ep_output_and_grads_match_reference_shard_map(runs, case):
    name, dtype, _ = case
    want = dict(np.load(runs / f"jax-{name}.npz"))
    ranks = [dict(np.load(runs / f"r{r}-{name}.npz")) for r in range(WORLD)]
    tol = TOL[dtype]
    for r, got in enumerate(ranks):
        _close(got["y"], _rank_rows(want["y"], r), tol, f"rank {r} y")
        _close(got["dx"], _rank_rows(want["dx"], r), tol, f"rank {r} dx")
    for k in [k for k in want if k.startswith("d.")]:
        _close(sum(g[k] for g in ranks), want[k], tol, f"sum of ranks' {k}")


def _moe_inputs(dtype, quant):
    cfg = reduced(get(ARCH), dtype=dtype)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           a2a_quant=quant))
    return cfg


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_ep_equals_single_process_emulation(runs, case):
    """``emulate_ep`` on the gathered inputs: the same code with the
    all_to_all as a transpose, so the outputs are equal bit for bit and the
    gradients (the emulation's over the whole batch, against the ranks'
    summed) within float32 summation order (f32) or one bf16 ulp of the
    largest value (bf16, 2**-7 relative)."""
    name, dtype, quant = case
    cfg = _moe_inputs(dtype, quant)
    tmpl = moe.init_moe(torch.Generator(), cfg, cfg.d_model,
                        torch.device("meta"))
    p = bridge.load_tree(tmpl, dict(np.load(runs / "moe_params.npz")),
                         device="cpu")
    p = tree_util.tree_map(lambda t: t.requires_grad_(True), p)
    x = torch.from_numpy(np.load(runs / "x.npy")).to(getattr(torch, dtype))
    x.requires_grad_(True)
    y = moe.emulate_ep(p, x, cfg, ep=2, pods=2)
    (y.float() * torch.from_numpy(np.load(runs / "dy.npy"))).sum().backward()
    ranks = [dict(np.load(runs / f"r{r}-{name}.npz")) for r in range(WORLD)]
    np.testing.assert_array_equal(
        np.concatenate([g["y"] for g in ranks]), y.detach().float().numpy())
    tol = {"float32": 1e-6, "bfloat16": 2 ** -7}[dtype]
    _close(np.concatenate([g["dx"] for g in ranks]),
           x.grad.float().numpy(), tol, "dx")
    for k, t in tree_util.named_leaves(p):
        _close(sum(g["d." + k] for g in ranks), t.grad.float().numpy(), tol,
               f"d{k}")


def test_ep_train_step_synced_grads_are_the_global_mean(runs, monkeypatch):
    """One Trainer step with EP on every rank: the synced (world-mean)
    gradient equals the gradient of the whole batch's loss in one process
    with every MoE layer run by ``emulate_ep``: the experts' zero-padded
    gradients, averaged over the world, are the global mean."""
    cfg = reduced(get(ARCH), dtype="float32")
    model = build_model(cfg)
    params = bridge.load_params(model, dict(np.load(runs / "lm_params.npz")),
                                device="cpu")
    toks = torch.from_numpy(np.load(runs / "tokens.npy"))
    monkeypatch.setattr(moe, "apply_moe", lambda p, x, cfg, pctx=None:
                        moe.emulate_ep(p, x, cfg, ep=2, pods=2))
    loss, grads = _value_and_grad(model, params,
                                  {"tokens": toks, "labels": toks}, None)
    infos = [__import__("json").loads((runs / f"r{r}.json").read_text())
             for r in range(WORLD)]
    assert [i["coords"] for i in infos] == [
        {"pod": p, "data": d} for p in (0, 1) for d in (0, 1)]
    np.testing.assert_allclose(np.mean([i["loss"] for i in infos]),
                               float(loss), rtol=1e-5)
    got = dict(np.load(runs / "r0-train.npz"))
    want = bridge.tree_to_numpy(grads)
    assert sorted(k[2:] for k in got if k.startswith("g.")) == sorted(want)
    for k, v in want.items():
        _close(got["g." + k], v, 1e-4, k)


def test_ep_train_step_expert_grads_and_params_per_rank(runs):
    """Before the sync each rank's expert gradient is zero outside its own
    slice; after it, gradients and updated parameters are bitwise equal on
    all four ranks."""
    infos = [__import__("json").loads((runs / f"r{r}.json").read_text())
             for r in range(WORLD)]
    assert all(i["zero_outside_slice"] for i in infos)
    r0 = dict(np.load(runs / "r0-train.npz"))
    for r in range(1, WORLD):
        other = dict(np.load(runs / f"r{r}-train.npz"))
        assert sorted(other) == sorted(r0)
        for k, v in r0.items():
            np.testing.assert_array_equal(other[k], v, err_msg=f"rank {r} {k}")
