"""The port's sharding rules against the reference's, in one process.

``param_specs``, ``opt_state_specs`` (float32 and int8 moments),
``batch_specs`` (train, prefill, decode) and ``cache_specs`` of
:mod:`repro_torch.parallel.sharding` equal ``repro.parallel.sharding``'s
exactly, entry for entry, on the (2, 2, 2) test mesh and the reference's
production meshes (16, 16) and (2, 16, 16), for every config the port's
``build_model`` builds (dense, MoE with MLA and MTP, Mamba-2, hybrid,
encoder-decoder, VLM). The
port's trees come from meta init, the reference's from
``jax.eval_shape``; both meshes are abstract (no devices, no processes).
Then the layout: ``Sharding``'s blocks tile every leaf exactly as
``shard_tree`` cuts it, and ``addr_of`` names the replicas the reference's
``addr_of`` names on eight host devices (a subprocess).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.checkpoint.store import _leaf_name
from repro.config import SHAPES as JAX_SHAPES
from repro.configs import get as jax_get
from repro.launch import mesh as jax_mesh
from repro.launch.mesh import make_parallel_ctx as jax_pctx
from repro.models import build_model as jax_build_model
from repro.parallel import sharding as jax_sharding
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro_torch import tree as tree_util
from repro_torch.config import SHAPES
from repro_torch.configs import ALL_ARCHS, EXTRA_ARCHS, get
from repro_torch.core.gvas import GlobalArray, addr_of, global_bytes
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch import mesh as torch_mesh
from repro_torch.launch.mesh import AbstractMesh as TorchAbstractMesh
from repro_torch.models import build_model
from repro_torch.parallel import sharding
from repro_torch.parallel.ctx import make_parallel_ctx
from repro_torch.train.optimizer import AdamWConfig, adamw_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = ALL_ARCHS + EXTRA_ARCHS


def _ctxs(mesh):
    shape, axes = MESHES[mesh]
    return (jax_pctx(AbstractMesh(shape, axes)),
            make_parallel_ctx(TorchAbstractMesh(shape, axes)))


def _jax_named(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {_leaf_name(p): tuple(s) for p, s in flat}


def _port_named(tree) -> dict:
    return {n: tuple(s) for n, s in
            tree_util.named_leaves(tree, is_leaf=sharding.is_spec)}


@pytest.fixture(scope="module")
def trees():
    """(reference params, port params) shape trees per arch."""
    out = {}
    for arch in ARCHS:
        jm = jax_build_model(jax_get(arch))
        out[arch] = (jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                     build_model(get(arch)).init(None, device="meta"))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_specs_equal_reference(trees, mesh):
    jctx, tctx = _ctxs(mesh)
    for arch in ARCHS:
        jp, tp = trees[arch]
        want = _jax_named(jax_sharding.param_specs(jp, jax_get(arch), jctx))
        got = _port_named(sharding.param_specs(tp, get(arch), tctx))
        assert got == want, arch


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_opt_state_specs_equal_reference(trees, mesh, quant):
    jctx, tctx = _ctxs(mesh)
    for arch in ARCHS:
        jp, tp = trees[arch]
        jo = jax.eval_shape(lambda p: jax_adamw_init(p, JaxAdamWConfig(
            quantize_states=quant)), jp)
        to = adamw_init(tp, AdamWConfig(quantize_states=quant))
        want = _jax_named(jax_sharding.opt_state_specs(jo, jp, jax_get(arch),
                                                       jctx))
        got = _port_named(sharding.opt_state_specs(to, tp, get(arch), tctx))
        assert got == want, arch
        if quant:
            assert any(k.endswith(".scale") for k in got)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_and_cache_specs_equal_reference(mesh):
    """Every assigned shape (train, prefill, decode, the batch-1 long
    decode whose caches shard their sequence instead), the caches of every
    family (GQA KV, MLA latent, Mamba-2 conv and SSM states, hybrid)."""
    jctx, tctx = _ctxs(mesh)
    for arch in ARCHS:
        for name, shape in SHAPES.items():
            jshape = JAX_SHAPES[name]
            want = {k: tuple(v) for k, v in jax_sharding.batch_specs(
                jax_get(arch), jshape, jctx).items()}
            got = {k: tuple(v) for k, v in sharding.batch_specs(
                get(arch), shape, tctx).items()}
            assert got == want, (arch, name)
            if shape.kind != "decode":
                continue
            jm = jax_build_model(jax_get(arch))
            jc = jax.eval_shape(lambda: jm.init_cache(shape.global_batch,
                                                      shape.seq_len))
            tc = build_model(get(arch)).init_cache(
                shape.global_batch, shape.seq_len, device="meta")
            want = _jax_named(jax_sharding.cache_specs(jc, jax_get(arch),
                                                       jshape, jctx))
            got = _port_named(sharding.cache_specs(tc, get(arch), shape,
                                                   tctx))
            assert got == want, (arch, name)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["single_pod", "multi_pod"])
def test_make_production_mesh_is_the_references(monkeypatch, multi_pod):
    """``make_production_mesh`` lays out the reference's production mesh:
    the same axes and sizes. Both meshes are made abstract (neither a
    world of 256 or 512 ranks nor as many devices is at hand), so the
    shape and axes each function picks are what is compared."""
    monkeypatch.setattr(jax, "make_mesh", lambda shape, axes, **_:
                        AbstractMesh(shape, axes))
    monkeypatch.setattr(torch_mesh, "ProcessMesh", lambda shape, axes, **_:
                        TorchAbstractMesh(shape, axes))
    want = jax_mesh.make_production_mesh(multi_pod=multi_pod)
    got = torch_mesh.make_production_mesh(multi_pod=multi_pod)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert got.size == (512 if multi_pod else 256)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_make_batch_specs_is_the_train_batch_specs(mesh):
    """``make_batch_specs`` gives a train batch's specs: the reference's
    ``batch_specs`` of the train shape, for every config."""
    jctx, tctx = _ctxs(mesh)
    for arch in ARCHS:
        want = {k: tuple(v) for k, v in jax_sharding.batch_specs(
            jax_get(arch), JAX_SHAPES["train_4k"], jctx).items()}
        got = {k: tuple(v) for k, v in make_batch_specs(get(arch),
                                                        tctx).items()}
        assert got == want, arch


class _RankView(TorchAbstractMesh):
    """One rank's view of an abstract mesh (its coordinates)."""

    def __init__(self, shape, axes, rank):
        super().__init__(shape, axes)
        self.rank, self.coords = rank, self.coords_of(rank)


def test_blocks_tile_every_leaf_as_shard_tree_cuts_it():
    """On the (2, 2, 2) mesh, the full reduced deepseek-v3 tree (MLA,
    experts over data, MTP) and its int8 AdamW state: every rank's
    ``shard_tree`` blocks sit at ``Sharding.slices`` of the full leaf and
    the blocks of one copy (the ranks at coordinate 0 on the axes a spec
    does not name) tile it exactly once; ``global_shape`` of a block is
    the leaf's."""
    from repro_torch.config import reduced
    cfg = reduced(get("deepseek-v3-671b"), dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    ocfg = AdamWConfig(quantize_states=True, qblock=16)
    state = {"params": params, "opt": adamw_init(params, ocfg)}
    state["opt"]["m"] = tree_util.tree_map(
        lambda t: t + torch.arange(t.numel()).reshape(t.shape).to(t.dtype),
        state["opt"]["m"])
    shape, axes = MESHES["2x2x2"]
    ctx = make_parallel_ctx(TorchAbstractMesh(shape, axes))
    specs = {"params": sharding.param_specs(params, cfg, ctx),
             "opt": sharding.opt_state_specs(state["opt"], params, cfg, ctx)}
    flat_specs = tree_util.leaves(specs, is_leaf=sharding.is_spec)
    full = tree_util.leaves(state)
    views = [_RankView(shape, axes, r) for r in range(8)]
    blocks = [tree_util.leaves(sharding.shard_tree(state, specs, v))
              for v in views]
    n_split = 0
    for i, (leaf, spec) in enumerate(zip(full, flat_specs, strict=True)):
        named = {a for e in spec for a in sharding.spec_axes(e)}
        n_split += bool(named)
        cover = torch.zeros(leaf.shape, dtype=torch.int32)
        for v, b in zip(views, blocks):
            sh = sharding.Sharding(v, spec)
            win = sh.slices(tuple(leaf.shape), v.coords)
            assert torch.equal(b[i], leaf[win])
            assert sh.global_shape(tuple(b[i].shape)) == tuple(leaf.shape)
            if all(v.coords[a] == 0 for a in axes if a not in named):
                cover[win] += 1
        assert (cover == 1).all()
    assert n_split > 20


def test_spec_refuses_what_it_cannot_serve():
    """A dim that does not split into its axes' blocks, or an axis the
    mesh lacks, raises: nothing is silently replicated."""
    mesh = TorchAbstractMesh((2, 4), ("data", "model"))
    with pytest.raises(ValueError, match="does not split"):
        sharding.Sharding(mesh, sharding.Spec("model")).local_shape((6,))
    with pytest.raises(ValueError, match="no axis"):
        sharding.Sharding(mesh, sharding.Spec("pod"))


GVAS_CASES = [  # mesh shape, axes, spec, leaf shape, global indices
    ((2, 4), ("data", "model"), ("data", "model"), (8, 8),
     [(5, 3), (0, 0), (7, 7)]),
    ((2, 4), ("data", "model"), (None, "model"), (8, 8), [(5, 3)]),
    ((2, 2, 2), ("pod", "data", "model"), (("pod", "data"), None), (8, 4),
     [(0, 1), (3, 2), (6, 3)]),
    ((2, 2, 2), ("pod", "data", "model"), ("model", ("data", "pod")),
     (4, 8), [(1, 5), (3, 2)]),
]

JAX_GVAS = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core.gvas import addr_of
from repro.launch.mesh import make_mesh
out = []
for shape, axes, spec, leaf, idx in json.loads(sys.argv[1]):
    mesh = make_mesh(tuple(shape), tuple(axes))
    coords = {int(d.id): dict(zip(axes, map(int, c)))
              for c, d in np.ndenumerate(mesh.devices)}
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    x = jnp.arange(int(np.prod(leaf)), dtype=jnp.float32).reshape(leaf)
    arr = jax.device_put(x, NamedSharding(mesh, P(*spec)))
    out.append([[{"coords": coords[r["device"]],
                  "local_index": list(r["local_index"])}
                 for r in addr_of(arr, tuple(i))["replicas"]] for i in idx])
print(json.dumps(out))
"""


def test_addr_of_names_the_references_replicas():
    """The reference's ``addr_of`` on eight host devices and the port's on
    the same abstract layout name the same owners (by mesh coordinates, in
    the same order) and local indices, for blocks over one axis, a
    replicated dim, and dims over tuples of axes in and out of the mesh's
    order; ``global_bytes`` is the whole leaf's."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_GVAS),
                        json.dumps(GVAS_CASES)], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    want = json.loads(r.stdout.strip().splitlines()[-1])
    for (shape, axes, spec, leaf, idx), w in zip(GVAS_CASES, want,
                                                 strict=True):
        mesh = TorchAbstractMesh(shape, axes)
        sh = sharding.Sharding(mesh, sharding.Spec(*spec))
        arr = GlobalArray.of(torch.zeros(sh.local_shape(leaf)), sh)
        assert arr.shape == tuple(leaf)
        assert global_bytes(arr) == int(np.prod(leaf)) * 4
        for i, wi in zip(idx, w, strict=True):
            got = addr_of(arr, i)["replicas"]
            assert [{"coords": g["coords"],
                     "local_index": list(g["local_index"])} for g in got] \
                == wi, (spec, i)
            assert [g["rank"] for g in got] == sorted(g["rank"] for g in got)
