"""Sharded decode over a KV cache whose sequence is split over ``data``.

Where a decode batch does not divide the batch axes (the reference's
``long_500k``, batch 1), ``cache_specs`` splits each cache's sequence over
``data`` and the reference's GSPMD merges the softmax across it. The port
does the same by hand: the rank whose block holds ``pos`` writes the new
K/V, every rank attends its block through ``decode_attn``'s log-sum-exp
form (MLA: by its float32 scores), and ``merge_softmax`` merges the parts
over ``data`` (ROADMAP.md F1).

Eight gloo processes on the CPU, started once for the module, each under a
timeout, on the (pod, data, model) = (2, 2, 2) mesh, at batch 1 in float32,
with parameters from the reference's ``init`` moved across by tree path
(:mod:`repro_torch.bridge`): the reduced ``zamba2-2.7b``,
``exanest-lm-100m`` and ``whisper-small`` (``gqa_decode`` on the rank's
heads), ``exanest-lm-100m`` with 3 query heads over 1 KV head (heads that
do not split over ``model``: the replicated branch, its cache cut in the
head dim) and ``exanest-lm-100m`` on (pod, data, model) = (2, 4, 1) (no
tensor parallelism: the unsharded-heads branch, four blocks of 16) each
take the port's unsharded prefill of 28 tokens into a window of 64
positions, cut by ``cache_specs`` to each rank's block, then 8 sharded
``decode_step``s from position 28 across a block boundary. Each step's
logits and each rank's final caches are held against the port's unsharded
decode, and that decode against the reference's ``decode_step`` on the same
caches. A function-level case runs ``mla_decode`` on a layer of the reduced
``deepseek-v3-671b`` with ``c_kv``/``k_rope`` split over ``data`` (and
their latent over ``model``) against the reference's ``mla_decode`` on the
whole cache.
"""

from __future__ import annotations

import dataclasses
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
from repro.models import attention as jax_attention
from repro.models import build_model as jax_build_model
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.config import ShapeConfig, reduced
from repro_torch.configs import get
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import build_model
from repro_torch.parallel.ctx import make_parallel_ctx
from repro_torch.parallel.sharding import Sharding, Spec, cache_specs, is_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
PROC_TIMEOUT_S = 240
#: case -> (arch, reduced() overrides, mesh): each branch of gqa_decode
CASES = {
    "zamba2-2.7b": ("zamba2-2.7b", {}, (2, 2, 2)),
    "exanest-lm-100m": ("exanest-lm-100m", {}, (2, 2, 2)),
    "whisper-small": ("whisper-small", {}, (2, 2, 2)),
    "exanest-heads-3": ("exanest-lm-100m", {"n_heads": 3, "n_kv_heads": 1},
                        (2, 2, 2)),
    "exanest-data-4": ("exanest-lm-100m", {}, (2, 4, 1)),
}
MLA_ARCH = "deepseek-v3-671b"
SEEDS = {c: i for i, c in enumerate(tuple(CASES) + (MLA_ARCH,))}
#: the window (two blocks of 32 positions over data, four of 16 on the
#: (2, 4, 1) mesh), the prefill, and the decode steps: positions 28..35
#: cross the boundary at 32
WINDOW, PREFILL, DECODE = 64, 28, 8
#: float32 decode against decode: the tolerance of
#: tests/test_torch_sharded_families.py (its DECODE_TOL), and that of the
#: existing tests for these families against the reference's decode_step
#: (test_torch_hybrid.py, test_torch_model_decode.py, test_torch_encdec.py,
#: test_torch_mla.py: f32 1e-4)
DECODE_TOL = 1e-4
REF_TOL = 1e-4
#: the cache keys whose leaves do not grow with the window
STATES = ("conv", "ssm", "cross")

WORKER = """
import dataclasses, datetime, json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.config import ShapeConfig, reduced
from repro_torch.configs import get
from repro_torch.core import collectives
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention, build_model, transformer
from repro_torch.parallel.ctx import make_parallel_ctx
from repro_torch.parallel.sharding import (Sharding, Spec, cache_specs,
                                           is_spec, param_specs, shard_tree)
from repro_torch.parallel import tensor_parallel as tp

rank, port, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=8, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
meshes = {m: make_mesh(m, ("pod", "data", "model"), device="cpu")
          for m in sorted({m for _, _, m in CASES.values()})}
shape = ShapeConfig("decode", WINDOW, 1, "decode")
info = {"coords": {str(m): mesh.coords for m, mesh in meshes.items()}}


def wait(name):
    # the main process writes each file aside, then renames it
    path = f"{d}/{name}.npz"
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > 200:
            raise TimeoutError(path)
        time.sleep(0.05)
    return dict(np.load(path))


def block(tree, specs, mesh):
    # this rank's blocks, copies of their own (decode writes in place)
    return tree_util.unflatten(tree, [
        Sharding(mesh, s).shard(t).clone() for t, s in zip(
            tree_util.leaves(tree), tree_util.leaves(specs, is_leaf=is_spec))])


inputs = wait("inputs")
toks = torch.from_numpy(inputs["tokens"])
for case, (arch, over, m) in CASES.items():
    mesh = meshes[m]
    pctx = dataclasses.replace(make_parallel_ctx(mesh),
                               decode_shape=(1, WINDOW))
    cfg = reduced(get(arch), dtype="float32", **over)
    model = build_model(cfg)
    full = bridge.load_params(model, wait(case), device="cpu")
    params = shard_tree(full, param_specs(full, cfg, pctx), mesh)
    whole = bridge.load_tree(model.init_cache(1, WINDOW, device="meta"),
                             wait("cache-" + case), device="cpu")
    specs = cache_specs(whole, cfg, shape, pctx)
    if "cross" in whole:
        # whisper's cross K/V: every encoder row, the rank's KV heads
        # (cache_specs reads it by its shape as a conv state; R13)
        specs["cross"] = tuple(Spec(None, None, None, "model", None)
                               for _ in whole["cross"])
    caches = block(whole, specs, mesh)
    outs = []
    with torch.no_grad(), tp.keep_gathered(), \\
            collectives.counting() as wire:
        for i in range(DECODE):
            lg, caches = model.decode_step(
                params, caches, {"token": toks[:, PREFILL + i],
                                 "pos": PREFILL + i}, pctx)
            outs.append(lg)
    info["wire-" + case] = wire["by_op"]
    np.savez(f"{d}/r{rank}-{case}.npz", logits=torch.cat(outs, 1).numpy(),
             **{"c." + k: v for k, v in bridge.tree_to_numpy(caches).items()})

# mla_decode on layer 0 of the reduced deepseek-v3's dense stack
mesh = meshes[(2, 2, 2)]
pctx = dataclasses.replace(make_parallel_ctx(mesh), decode_shape=(1, WINDOW))
cfg = reduced(get(MLA_ARCH), dtype="float32")
model = build_model(cfg)
full = bridge.load_params(model, wait(MLA_ARCH), device="cpu")
params = shard_tree(full, param_specs(full, cfg, pctx), mesh)
layer = tree_util.tree_map(lambda t: t[0], params["dense_stack"])
mla = wait("mla")
whole = {n: torch.from_numpy(mla[n]) for n in ("c_kv", "k_rope")}
cache = block(whole, cache_specs(whole, cfg, shape, pctx), mesh)
ys = []
with torch.no_grad():
    p, specs = transformer._unfsdp(layer, cfg, pctx, "dense")
    for i in range(DECODE):
        y, cache = attention.mla_decode(
            p["attn"], torch.from_numpy(mla["x"][i]), cfg, cache,
            PREFILL + i, pctx, specs=specs["attn"])
        ys.append(y)
np.savez(f"{d}/r{rank}-mla.npz", y=torch.cat(ys, 1).numpy(),
         **{"c." + k: v.numpy() for k, v in cache.items()})

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
    return {_leaf_name(path): np.asarray(leaf, np.float32)
            for path, leaf in flat}


def _jax_tree(template, leaves: dict):
    """``template`` (a reference tree) with its leaves from ``leaves``
    (name -> array), by tree path."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    names = [_leaf_name(path) for path, _ in flat]
    assert sorted(names) == sorted(leaves)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.array(leaves[n], leaf.dtype)
                  for n, (_, leaf) in zip(names, flat)])


def _save(d, name: str, arrays: dict) -> None:
    np.savez(d / f"{name}.tmp.npz", **arrays)
    os.replace(d / f"{name}.tmp.npz", d / f"{name}.npz")


def _window(caches):
    """``caches`` of the prefill grown to WINDOW positions (zeros after)."""
    return tree_util.unflatten(caches, [
        t if k.split(".")[0] in STATES else torch.nn.functional.pad(
            t, (0, 0, 0, 0, 0, WINDOW - t.shape[-3])).contiguous()
        for k, t in tree_util.named_leaves(caches)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the eight ranks; meanwhile write the inputs, the reference's
    parameters and, per family, the port's unsharded prefill caches (which
    the ranks cut to their blocks), then run the port's unsharded decode
    and the reference's ``decode_step`` from those caches; wait for the
    ranks. Returns (dir, {case: (unsharded logits, unsharded final caches,
    reference logits, reference final caches)}, MLA's reference)."""
    d = tmp_path_factory.mktemp("seq_decode")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "OMP_NUM_THREADS": "1"}
    pre = (f"WINDOW, PREFILL, DECODE = {WINDOW}, {PREFILL}, {DECODE}\n"
           f"CASES = {CASES!r}\nMLA_ARCH = {MLA_ARCH!r}\n")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", pre + textwrap.dedent(WORKER), str(r), port,
         str(d)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]
    try:
        rng = np.random.default_rng(31)
        w = reduced(get("whisper-small"))
        inputs = {"tokens": rng.integers(0, 256, (1, PREFILL + DECODE)),
                  "frames": rng.standard_normal(
                      (1, w.encdec.encoder_seq, w.d_model), np.float32)}
        _save(d, "inputs", inputs)
        toks = torch.from_numpy(inputs["tokens"])
        out = {}
        for case, (arch, over, _) in CASES.items():
            jm = jax_build_model(jax_reduced(jax_get(arch), dtype="float32",
                                             **over))
            jp = jax.jit(jm.init)(jax.random.PRNGKey(SEEDS[case]))
            leaves = _leaves(jp)
            _save(d, case, leaves)
            model = build_model(reduced(get(arch), dtype="float32", **over))
            params = bridge.load_params(model, leaves, device="cpu")
            batch = {"tokens": toks[:, :PREFILL]}
            if model.cfg.encdec is not None:
                batch["frames"] = torch.from_numpy(inputs["frames"])
            with torch.no_grad():
                _, caches = model.prefill(params, batch)
            caches = _window(caches)
            # copies: the port's decode writes its caches in place
            whole = {k: v.copy() for k, v in
                     bridge.tree_to_numpy(caches).items()}
            _save(d, "cache-" + case, whole)
            j_caches = _jax_tree(jm.init_cache(1, WINDOW), whole)
            step = jax.jit(jm.decode_step)
            lg_t, lg_j = [], []
            with torch.no_grad():
                for i in range(DECODE):
                    lg, caches = model.decode_step(params, caches, {
                        "token": toks[:, PREFILL + i], "pos": PREFILL + i})
                    lg_t.append(lg)
                    lg, j_caches = step(jp, j_caches, {
                        "token": jnp.asarray(inputs["tokens"][:, PREFILL + i],
                                             jnp.int32),
                        "pos": jnp.int32(PREFILL + i)})
                    lg_j.append(np.asarray(lg, np.float32))
            out[case] = (torch.cat(lg_t, 1).numpy(), caches,
                         np.concatenate(lg_j, 1), _leaves(j_caches))
        # MLA: one layer's attention, the reference on the whole cache
        jcfg = jax_reduced(jax_get(MLA_ARCH), dtype="float32")
        jp = jax.jit(jax_build_model(jcfg).init)(
            jax.random.PRNGKey(SEEDS[MLA_ARCH]))
        _save(d, MLA_ARCH, _leaves(jp))
        m = jcfg.mla
        mla = {"x": rng.standard_normal((DECODE, 1, 1, jcfg.d_model),
                                        np.float32),
               "c_kv": rng.standard_normal((1, WINDOW, m.kv_lora_rank),
                                           np.float32),
               "k_rope": rng.standard_normal(
                   (1, WINDOW, m.qk_rope_head_dim), np.float32)}
        _save(d, "mla", mla)
        p_attn = jax.tree_util.tree_map(lambda t: t[0],
                                        jp["dense_stack"]["attn"])
        cache = {n: jnp.asarray(mla[n]) for n in ("c_kv", "k_rope")}
        fn = jax.jit(lambda p, x, c, pos: jax_attention.mla_decode(
            p, x, jcfg, c, pos))
        ys = []
        for i in range(DECODE):
            y, cache = fn(p_attn, jnp.asarray(mla["x"][i]), cache,
                          jnp.int32(PREFILL + i))
            ys.append(np.asarray(y, np.float32))
        mla_ref = (np.concatenate(ys, 1),
                   {n: np.asarray(t, np.float32) for n, t in cache.items()})
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
    return d, out, mla_ref


def _info(d) -> list[dict]:
    return [json.loads((d / f"r{r}.json").read_text()) for r in range(WORLD)]


def _close(got, want, tol, msg):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol,
                               err_msg=msg)


def _layout(mesh_shape, cfg, caches: dict) -> tuple:
    """(the abstract mesh, name -> its spec of each cache leaf): whisper's
    cross K/V by KV heads, as the ranks cut it."""
    mesh = AbstractMesh(mesh_shape, ("pod", "data", "model"))
    specs = cache_specs(caches, cfg, ShapeConfig("d", WINDOW, 1, "decode"),
                        make_parallel_ctx(mesh))
    out = dict(zip((n for n, _ in tree_util.named_leaves(caches)),
                   tree_util.leaves(specs, is_leaf=is_spec)))
    for n in out:
        if n.startswith("cross"):
            out[n] = Spec(None, None, None, "model", None)
    return mesh, out


@pytest.mark.parametrize("case", CASES)
def test_seq_split_decode_logits_match_unsharded(runs, case):
    """Every rank's 8 decode steps across a block boundary (positions 28
    to 35; on (2, 2, 2) data 0's block holds 0-31 and data 1's 32-63, so
    data 1 attends to no position until step 5) against the unsharded
    decode within DECODE_TOL, and the merge over data counted on every
    rank."""
    d, out, _ = runs
    want = out[case][0]
    for r, info in enumerate(_info(d)):
        got = np.load(d / f"r{r}-{case}.npz")["logits"]
        assert got.shape == want.shape
        _close(got, want, DECODE_TOL, f"rank {r}")
        assert info["wire-" + case].get("kv_seq_merge", 0) > 0, r


@pytest.mark.parametrize("case", CASES)
def test_seq_split_caches_are_blocks_of_unsharded(runs, case):
    """After the 8 steps each rank's caches are its block of the unsharded
    final caches as ``cache_specs`` lays them out at batch 1: K/V over
    ``data`` by position (32 of 64; 16 on (2, 4, 1)) and ``model`` by KV
    head (by head dim where the KV heads do not split), the SSM and conv
    states by head and channel over ``model``; the new K/V went to the
    rank whose block holds each position, and nowhere else."""
    d, out, _ = runs
    arch, over, mesh_shape = CASES[case]
    whole = dict(tree_util.named_leaves(out[case][1]))
    mesh, specs = _layout(mesh_shape, reduced(get(arch), **over),
                          out[case][1])
    for r, info in enumerate(_info(d)):
        got = dict(np.load(d / f"r{r}-{case}.npz"))
        coords = info["coords"][str(mesh_shape)]
        for n, t in whole.items():
            blk = t[Sharding(mesh, specs[n]).slices(t.shape, coords)]
            assert got["c." + n].shape == tuple(blk.shape), (r, n)
            if n.split(".")[0] not in STATES:
                assert blk.shape[-3] == WINDOW // mesh_shape[1], (r, n)
            _close(got["c." + n], blk.numpy(), DECODE_TOL, f"rank {r} {n}")


@pytest.mark.parametrize("case", CASES)
def test_unsharded_decode_matches_reference_decode_step(runs, case):
    """The unsharded decode the ranks are held to, against the reference's
    ``decode_step`` from the same caches: each step's logits and the final
    caches within the families' float32 tolerance."""
    _, out, _ = runs
    lg_t, c_t, lg_j, c_j = out[case]
    _close(lg_t, lg_j, REF_TOL, "logits")
    for n, t in tree_util.named_leaves(c_t):
        _close(t.numpy(), c_j[n], REF_TOL, n)


def test_mla_decode_seq_split_matches_reference(runs):
    """``mla_decode`` on a layer of the reduced deepseek-v3, its ``c_kv``
    and ``k_rope`` split over ``data`` by position and over ``model`` by
    latent (half each), 8 steps from position 28: every rank's outputs
    against the reference's ``mla_decode`` on the whole cache, and its
    caches against their blocks of the reference's."""
    d, _, (want_y, want_c) = runs
    mesh, specs = _layout((2, 2, 2), reduced(get(MLA_ARCH)), {
        n: torch.empty(t.shape, device="meta") for n, t in want_c.items()})
    for r, info in enumerate(_info(d)):
        got = dict(np.load(d / f"r{r}-mla.npz"))
        _close(got["y"], want_y, REF_TOL, f"rank {r} y")
        coords = info["coords"][str((2, 2, 2))]
        for n, t in want_c.items():
            blk = t[Sharding(mesh, specs[n]).slices(t.shape, coords)]
            assert blk.shape == (1, WINDOW // 2, t.shape[-1] // 2)
            _close(got["c." + n], blk, REF_TOL, f"rank {r} {n}")


@pytest.mark.parametrize("mesh_shape", [(2, 2, 2), (16, 16), (2, 16, 16)])
def test_cache_specs_split_the_sequence_where_kv_seq_axis_says(mesh_shape):
    """One rule for the layout: ``cache_specs`` puts a KV cache's and a
    latent's sequence over ``ParallelCtx.kv_seq_axis(batch, seq_len)``
    (``data`` exactly where the batch does not divide the batch axes and
    the sequence does), and ``kv_seq_block`` gives a rank its block's first
    position from the context's ``decode_shape``; a block of another size
    is refused."""
    axes = ("pod", "data", "model")[-len(mesh_shape):]
    mesh = AbstractMesh(mesh_shape, axes)
    pctx = make_parallel_ctx(mesh)
    n = pctx.dp_size
    for B, S in ((1, 64 * n), (n, 64 * n), (2 * n, 40), (1, 64 * n + 1),
                 (3, 128 * n)):
        want = "data" if (B % n and not S % n) else None
        assert pctx.kv_seq_axis(B, S) == want, (B, S)
        cache = {"k": torch.empty(2, B, S, 16, 64, device="meta"),
                 "c_kv": torch.empty(2, B, S, 512, device="meta")}
        specs = cache_specs(cache, reduced(get("deepseek-7b")),
                            ShapeConfig("d", S, B, "decode"), pctx)
        assert specs["k"][2] == want and specs["c_kv"][2] == want, (B, S)
        assert pctx.kv_seq_block(S) is None
        ctx = dataclasses.replace(pctx, decode_shape=(B, S))
        for rank in (0, mesh.size - 1):
            mesh.coords = mesh.coords_of(rank)
            nd = mesh.shape["data"]
            if want is None:
                assert ctx.kv_seq_block(S) is None
                continue
            assert ctx.kv_seq_block(S // nd) == (
                mesh.coords["data"] * (S // nd), "data")
            with pytest.raises(ValueError, match="not 1/"):
                ctx.kv_seq_block(S)
