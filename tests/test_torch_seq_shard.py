"""``seq_shard``, Megatron-style sequence parallelism of the residual
stream (the reference's ``_hint``, ``src/repro/models/transformer.py:36``),
on the port's (pod, data, model) = (2, 2, 2) mesh.

Between blocks a rank holds its ``S/tp`` rows of the stream; each block
gathers them whole at its entry and cuts them again after its closing sum.
The block's math does not change (the MoE layer routes the whole
sequence, Mamba-2's conv and scan see it whole, the final norm, head and
loss see the gathered stream), so a ``seq_shard=True`` step is the
``seq_shard=False`` step bit for bit.

Eight gloo processes on the CPU, started once for the module, each under a
timeout, on the ``reduced()`` bf16 configs with the reference's parameters
(:mod:`repro_torch.bridge`), for the dense, MoE, MLA (with its MTP head),
Mamba-2, hybrid and encoder-decoder families: each rank's loss and every
gradient of its blocks before the sync, and its prefill logits and caches,
with ``seq_shard`` on against off, bit for bit; the ``combine`` launches
equal; the stream's gathers counted on and absent off; the loss against
the reference's unsharded loss at test_torch_sharded_step.py's tolerance;
and a length that the ``model`` size does not divide, which keeps the
stream whole.
"""

from __future__ import annotations

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

from repro.checkpoint.store import _leaf_name
from repro.config import reduced as jax_reduced
from repro.configs import get as jax_get
from repro.models import build_model as jax_build_model
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.parallel.ctx import ParallelCtx, make_parallel_ctx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
PROC_TIMEOUT_S = 300
#: (label, arch) of the families that go through ``block_forward``
FAMILIES = (("dense", "deepseek-7b"), ("moe", "granite-moe-1b-a400m"),
            ("mla", "deepseek-v3-671b"), ("ssm", "mamba2-2.7b"),
            ("hybrid", "zamba2-2.7b"), ("encdec", "whisper-small"))
ARCHS = tuple(a for _, a in FAMILIES)
#: the reference's test_distributed.py:121 tolerance (sharded vs unsharded)
REF_TOL = 2e-2
#: global rows x tokens: 64 splits over model 2 (two of the reduced SSM's
#: chunks of 32); ODD tokens do not split
TOKENS = (8, 64)
ODD = 63
PREFILL = 48

WORKER = """
import dataclasses, datetime, json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.config import reduced
from repro_torch.configs import get
from repro_torch.core import collectives
from repro_torch.data.pipeline import shard_batch
from repro_torch.kernels.allreduce_combine import ops as combine_ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.parallel.ctx import make_parallel_ctx
from repro_torch.parallel.sharding import param_specs, shard_tree
from repro_torch.train.loop import _value_and_grad

rank, port, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=8, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
ctx = {False: make_parallel_ctx(mesh)}
ctx[True] = dataclasses.replace(ctx[False], seq_shard=True)
inputs = dict(np.load(f"{d}/inputs.npz"))
info = {}
launches = [0]
plain = combine_ops.combine_ref


def counted(*a, **k):
    launches[0] += 1
    return plain(*a, **k)


combine_ops.combine_ref = counted


def leaves_of(arch):
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
    return b


def run(model, params, batch, on):
    pctx = ctx[on]
    launches[0] = 0
    with collectives.counting() as wire:
        loss, grads = _value_and_grad(model, params, batch, pctx)
    n_step = launches[0]
    with torch.no_grad():
        lg, caches = model.prefill(
            params, {**batch, "tokens": batch["tokens"][:, :PREFILL]}, pctx)
    return {"loss": loss, "grads": grads, "logits": lg, "caches": caches,
            "combines": n_step,
            "seq_bytes": wire["by_op"].get("seq_gather", 0)}


def differ(a, b):
    return [k for (k, x), (_, y) in zip(tree_util.named_leaves(a),
                                         tree_util.named_leaves(b))
            if not (x.dtype == y.dtype and torch.equal(x, y))]


for arch in ARCHS:
    cfg = reduced(get(arch))
    model = build_model(cfg)
    full = bridge.load_params(model, leaves_of(arch), device="cpu")
    params = shard_tree(full, param_specs(full, cfg, ctx[False]), mesh)
    for label, n in (("", None), ("odd-", ODD)):
        if label and arch != "deepseek-7b":
            continue
        batch = shard_batch(batch_of(cfg, n), ctx[False])
        off, on = (run(model, params, batch, s) for s in (False, True))
        key = label + arch
        info[key] = {
            "loss": [float(off["loss"]), float(on["loss"])],
            "loss_equal": torch.equal(off["loss"], on["loss"]),
            "grads_differ": differ(off["grads"], on["grads"]),
            "logits_equal": torch.equal(off["logits"], on["logits"]),
            "caches_differ": differ(off["caches"], on["caches"]),
            "combines": [off["combines"], on["combines"]],
            "seq_bytes": [off["seq_bytes"], on["seq_bytes"]],
            "n_grads": len(tree_util.leaves(off["grads"]))}

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
    rng = np.random.default_rng(30)
    w = jax_reduced(jax_get("whisper-small"))
    return {"tokens": rng.integers(0, 256, TOKENS).astype(np.int64),
            "frames": rng.standard_normal(
                (TOKENS[0], w.encdec.encoder_seq, w.d_model), np.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Write the inputs and the reference's parameters (each family's as it
    is drawn), start the eight ranks, compute the reference's unsharded
    bf16 losses meanwhile, wait for the ranks."""
    d = tmp_path_factory.mktemp("seq_shard")
    inputs = _inputs()
    np.savez(d / "inputs.npz", **inputs)
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "OMP_NUM_THREADS": "1"}
    pre = (f"ARCHS = {ARCHS!r}\nPREFILL = {PREFILL}\nODD = {ODD}\n")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", pre + textwrap.dedent(WORKER), str(r), port,
         str(d)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]

    def reference(i_arch):
        i, arch = i_arch
        cfg = jax_reduced(jax_get(arch))
        model = jax_build_model(cfg)
        params = jax.jit(model.init)(jax.random.PRNGKey(40 + i))
        np.savez(d / f"{arch}.tmp.npz", **_leaves(params))
        os.replace(d / f"{arch}.tmp.npz", d / f"{arch}.npz")
        toks = jnp.asarray(inputs["tokens"], jnp.int32)
        batch = {"tokens": toks, "labels": toks}
        if cfg.encdec is not None:
            batch["frames"] = jnp.asarray(inputs["frames"])
        loss = jax.jit(model.loss_fn).lower(params, batch).compile(
            compiler_options={"xla_allow_excess_precision": False})(
                params, batch)
        return arch, float(loss)

    try:
        with ThreadPoolExecutor(len(ARCHS)) as ex:
            ref = dict(ex.map(reference, enumerate(ARCHS)))
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
    return ref, [json.loads((d / f"r{r}.json").read_text())
                 for r in range(WORLD)]


@pytest.mark.parametrize("family,arch", FAMILIES)
def test_seq_shard_step_is_the_unsharded_stream_step_bit_for_bit(
        runs, family, arch):
    """On every rank: the loss and every gradient of the rank's blocks
    (before the sync) of a ``seq_shard`` step equal the ``seq_shard=False``
    step's bit for bit, with the same ``combine`` launches; the stream's
    gathers move bytes only with ``seq_shard``."""
    for r, info in enumerate(runs[1]):
        got = info[arch]
        assert got["loss_equal"], (r, got["loss"])
        assert got["grads_differ"] == [], (r, got["grads_differ"])
        assert got["n_grads"] > 0
        assert got["combines"][0] == got["combines"][1] > 0, (r, got)
        assert got["seq_bytes"][0] == 0 < got["seq_bytes"][1], (r, got)


@pytest.mark.parametrize("family,arch", FAMILIES)
def test_seq_shard_prefill_logits_and_caches_bit_for_bit(runs, family,
                                                         arch):
    """A ``seq_shard`` prefill of 48 tokens: its last logits and every
    cache leaf (KV, MLA's latent, SSM and conv states, whisper's cross K/V)
    on every rank equal the ``seq_shard=False`` prefill's bit for bit."""
    for r, info in enumerate(runs[1]):
        got = info[arch]
        assert got["logits_equal"], r
        assert got["caches_differ"] == [], (r, got["caches_differ"])


@pytest.mark.parametrize("family,arch", FAMILIES)
def test_seq_shard_loss_matches_reference_unsharded_loss(runs, family, arch):
    """The sharded bf16 loss with ``seq_shard`` (the mean over the batch
    ranks) against the reference's unsharded loss on the same parameters
    and batch, within test_distributed.py:121's 2e-2."""
    ref, infos = runs
    losses = [info[arch]["loss"][1] for info in infos]
    assert abs(float(np.mean(losses)) - ref[arch]) < REF_TOL, (losses,
                                                              ref[arch])


def test_length_the_model_size_does_not_divide_keeps_the_stream_whole(runs):
    """63 tokens on 2 ``model`` ranks: no block cuts the stream (no bytes
    of its gathers), and the step equals the ``seq_shard=False`` one."""
    for r, info in enumerate(runs[1]):
        got = info[f"odd-deepseek-7b"]
        assert got["seq_bytes"] == [0, 0], (r, got)
        assert got["loss_equal"] and got["grads_differ"] == [], (r, got)


def test_seq_split_rule_is_the_reference_hint_rule():
    """``ParallelCtx.seq_split``: the reference's rule (more than one
    position that the ``model`` size divides, only with ``seq_shard``), on
    a sharded context of more than one ``model`` rank; decode's one token
    never splits; off by default as in the reference."""
    mesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    off = make_parallel_ctx(mesh)
    on = ParallelCtx(mesh=mesh, dp_axes=off.dp_axes, seq_shard=True)
    assert not off.seq_shard
    assert [on.seq_split(s) for s in (1, 2, 63, 64, 4096)] == \
        [False, True, False, True, True]
    assert not any(off.seq_split(s) for s in (2, 64))
    one = ParallelCtx(mesh=AbstractMesh((4, 1), ("data", "model")),
                      seq_shard=True)
    assert not one.seq_split(64)
    dp = ParallelCtx(mesh=AbstractMesh((2, 2), ("pod", "data")),
                     dp_axes=("pod", "data"), seq_shard=True)
    assert not dp.seq_split(64)
