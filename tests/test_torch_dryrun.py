"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``) and against hand reckonings.

The reference's dry run sets ``XLA_FLAGS`` to 512 host devices when it is
imported, so its side runs in one subprocess, started first and read
last: for every ``ALL_ARCHS x SHAPES x mesh`` cell its ``cell_runnable``
skip, ``input_specs`` shapes and dtypes, ``_train_policy`` (with
``_opt_config``) and the static keys its ``lower_cell`` records, assembled
from its own functions without lowering; and the reduced cell
``lower_cell("exanest-lm-100m", "train_4k", False, {"cfg_overrides":
{"n_layers": 2}})`` compiled, for its ``memory_analysis()``'s argument
bytes (4,825,092 a device on 16x16).

On the port's side, on ``meta`` tensors: the same keys for every cell; the
argument bytes of rank 0's blocks to the byte; a reduced dense prefill's
FLOPs against a formula written here; each kernel's meta output against
its plain version's on the CPU (``matmul_tile`` on meta raises); every
family's reduced train, prefill and decode traced on a (2, 2, 2) dry mesh;
a reduced sharded prefill's collective bytes against a reckoning from the
specs; the counters against ``FlopCounterMode`` and the live bytes against
the step's own tensors; the CLI.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree as tree_util
from repro_torch.config import SHAPES, ShapeConfig, reduced
from repro_torch.configs import ALL_ARCHS, get
from repro_torch.core import collectives
from repro_torch.kernels.allreduce_combine.ops import combine_parts
from repro_torch.kernels.flash_decode.ops import decode_attn
from repro_torch.kernels.matmul_tile.ops import matmul
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import DryMesh
from repro_torch.models import build_model
from repro_torch.models.transformer import top_specs, layer_specs
from repro_torch.parallel.ctx import make_parallel_ctx
from repro_torch.parallel.sharding import Sharding, is_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the reduced cell the reference's memory_analysis is read on
ARG_CELL = ("exanest-lm-100m", "train_4k", False,
            {"cfg_overrides": {"n_layers": 2}})
#: the reference's memory_analysis().argument_size_in_bytes on ARG_CELL
#: (read in a CPU run of the reference; the subprocess reads it again)
ARG_BYTES = 4_825_092
#: small cells for the traces: 8 rows of 32 tokens, a window of 32
SMALL = {"train": ShapeConfig("t", 32, 8, "train"),
         "prefill": ShapeConfig("p", 32, 8, "prefill"),
         "decode": ShapeConfig("d", 32, 8, "decode")}
#: one config of each family
FAMILIES = ("deepseek-7b", "granite-moe-1b-a400m", "deepseek-v3-671b",
            "mamba2-2.7b", "zamba2-2.7b", "whisper-small", "internvl2-1b")

REFERENCE = r"""
import dataclasses, json, sys
import repro.launch.dryrun as d          # sets XLA_FLAGS first
import jax
from repro.checkpoint.store import _leaf_name
from repro.config import SHAPES, cell_runnable
from repro.configs import ALL_ARCHS, get
from repro.launch.mesh import make_parallel_ctx, make_production_mesh
from repro.models import build_model

cell = json.loads(sys.argv[1])
out = {}
for arch in ALL_ARCHS:
    cfg = get(arch)
    model = build_model(cfg)
    out[f"opt|{arch}"] = d._opt_config(cfg).quantize_states
    for name, shape in SHAPES.items():
        for mp in (False, True):
            key = f"{arch}|{name}|{mp}"
            ok, why = cell_runnable(cfg, shape)
            if not ok:
                out[key] = {"skipped": why}
                continue
            pctx = make_parallel_ctx(make_production_mesh(multi_pod=mp))
            meta = {"arch": arch, "shape": name,
                    "mesh": "2x16x16" if mp else "16x16",
                    "params_b": cfg.param_count() / 1e9,
                    "active_params_b": cfg.active_param_count() / 1e9}
            if shape.kind == "train":
                pctx_t = dataclasses.replace(pctx, seq_shard=False,
                                             gather_weights=False)
                pol = d._train_policy(cfg, shape, pctx_t)
                meta["opt_quantized"] = pol["opt_cfg"].quantize_states
                meta["microbatches"] = pol["microbatches"]
                meta["accum_dtype"] = str(pol["accum_dtype"].__name__)
                meta["seq_shard"] = pctx_t.seq_shard
            ins = d.input_specs(cfg, shape, model)
            flat = jax.tree_util.tree_flatten_with_path(ins)[0]
            out[key] = {"meta": meta, "inputs": {
                _leaf_name(p): [list(s.shape), str(s.dtype)]
                for p, s in flat}}
lowered, _ = d.lower_cell(*cell)
ma = lowered.compile().memory_analysis()
out["argument_bytes"] = ma.argument_size_in_bytes
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    """The reference's side, in one subprocess (started when the first
    test asks, read when it has finished)."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu"}
    p = subprocess.run([sys.executable, "-c", REFERENCE,
                        json.dumps(list(ARG_CELL))], env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_static_cell_keys_equal_the_references(reference):
    """For every ALL_ARCHS x SHAPES x mesh cell: the ``cell_runnable``
    skip, ``input_specs``' shapes and dtypes, and the keys the reference's
    ``lower_cell`` records before lowering (``params_b``,
    ``active_params_b``, ``mesh``; for train cells ``opt_quantized``,
    ``microbatches``, ``accum_dtype``, ``seq_shard`` from ``_train_policy``
    and ``_opt_config``) equal the reference's."""
    for arch in ALL_ARCHS:
        cfg = get(arch)
        assert dryrun._opt_config(cfg).quantize_states == \
            reference[f"opt|{arch}"], arch
        for arch_, name, mp in ((arch, s, m) for s in SHAPES
                                for m in (False, True)):
            want = reference[f"{arch_}|{name}|{mp}"]
            cell, meta = dryrun.lower_cell(arch_, name, mp)
            if cell is None:
                assert meta == want, (arch_, name, mp)
                continue
            assert meta == want["meta"], (arch_, name, mp)
            ins = dryrun.input_specs(cfg, SHAPES[name], build_model(cfg))
            got = {k: [list(t.shape), str(t.dtype).split(".")[-1]]
                   for k, t in tree_util.named_leaves(ins)}
            assert got == want["inputs"], (arch_, name, mp)


def test_argument_bytes_equal_the_references_memory_analysis(reference):
    """The reduced cell's per-rank argument bytes (rank 0's blocks of the
    parameters and moments, its rows of the batch) equal the reference's
    ``memory_analysis().argument_size_in_bytes`` to the byte."""
    assert reference["argument_bytes"] == ARG_BYTES
    cell, _ = dryrun.lower_cell(*ARG_CELL)
    assert dryrun.argument_bytes(cell.make_args()) == ARG_BYTES


def test_train_policy_matches_the_reference_thresholds():
    """``_train_policy`` halves the microbatch while the saved layer inputs
    pass 4e9 bytes a device, up to 16 and the rows a rank holds; bf16
    accumulation with int8 moments (``_opt_config``: over 256 x 12e9 / 10
    parameters)."""
    mesh = DryMesh((16, 16), ("data", "model"))
    pctx = make_parallel_ctx(mesh)
    pol = dryrun._train_policy(get("deepseek-v3-671b"), SHAPES["train_4k"],
                               pctx)
    assert (pol["microbatches"], pol["accum_dtype"]) == (16, torch.bfloat16)
    assert pol["opt_cfg"].quantize_states
    pol = dryrun._train_policy(get("exanest-lm-100m"), SHAPES["train_4k"],
                               pctx)
    assert (pol["microbatches"], pol["accum_dtype"]) == (1, torch.float32)


def _dense_prefill_flops(cfg, B: int, S: int) -> int:
    """The products of an unsharded dense prefill of B x S tokens: per
    layer the q, k, v and output projections, the causal attention's
    blocks on or below the diagonal (scores and P.V), the gated MLP's three
    products; then the head at the last position. 2 per multiply-add."""
    d, H, K, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.resolved_head_dim, cfg.d_ff)
    nq = S // cfg.q_chunk
    blocks = nq * (nq + 1) // 2
    qc = cfg.q_chunk
    layer = (2 * B * S * d * (2 * H + 2 * K) * hd
             + 2 * 2 * B * H * qc * qc * hd * blocks
             + 3 * 2 * B * S * d * f)
    return cfg.n_layers * layer + 2 * B * d * cfg.vocab_size


@pytest.mark.parametrize("S", [64, 128])
def test_dense_prefill_flops_equal_the_hand_formula(S):
    """A reduced dense prefill (one attention block at 64 tokens, three at
    128) counts exactly the products of :func:`_dense_prefill_flops`."""
    cfg = reduced(get("deepseek-7b"))
    cell, meta = dryrun.lower_cell(cfg, ShapeConfig("p", S, 2, "prefill"),
                                   False, mesh_shape=())
    got = dryrun.analyze(cell, meta)
    assert got["flops"] == _dense_prefill_flops(cfg, 2, S)
    assert got["mesh"] == "1" and got["collective_bytes"]["total"] == 0


def test_counters_equal_flop_counter_mode_and_the_steps_tensors():
    """On a reduced dense train step with no kernel on its path, run on
    real CPU tensors: ``FlopCounterMode`` counts what the dry run counts on
    meta; the argument bytes are the step's inputs; the step's outputs
    alias its donated parameters and moments (all but the int32 step
    count, which the update makes anew)."""
    cfg = reduced(get("deepseek-7b"), dtype="float32")
    shape = ShapeConfig("t", 64, 4, "train")
    cell, meta = dryrun.lower_cell(cfg, shape, False, mesh_shape=())
    got = dryrun.analyze(cell, meta)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    from repro_torch.train.optimizer import adamw_init
    opt = adamw_init(params, dryrun._opt_config(cfg))
    toks = torch.randint(0, cfg.vocab_size, (shape.global_batch,
                                             shape.seq_len), dtype=torch.int32)
    fn = cell.make_fn()
    with FlopCounterMode(display=False) as fc:
        fn(params, opt, {"tokens": toks, "labels": toks})
    assert fc.get_total_flops() == got["flops"] > 0
    nbytes = sum(t.numel() * t.element_size() for t in
                 tree_util.leaves((params, opt))) + 2 * toks.numel() * 4
    assert got["memory"]["argument_bytes"] == nbytes
    assert got["memory"]["alias_gb"] * 2 ** 30 == \
        nbytes - 2 * toks.numel() * 4 - 4
    assert got["memory"]["peak_gb"] >= got["memory"]["argument_gb"]
    assert got["fits_h100"] and got["roofline"]["hw"] == "h100-sxm5-80gb"


def test_kernels_on_meta_give_their_plain_versions_shapes_and_dtypes():
    """``flash_decode``, ``ssd_scan`` and ``combine`` on meta: the output
    shapes and dtypes of their plain versions on the CPU, each counted once
    as its kernel with its own FLOPs; ``matmul_tile`` on meta still
    raises."""
    g = torch.Generator().manual_seed(0)
    cases = {
        "combine": (combine_parts, (torch.randn(3, 40, generator=g)
                                    .bfloat16(),), {"op": "sum"}),
        "flash_decode": (decode_attn, (
            torch.randn(2, 8, 64, generator=g).bfloat16(),
            torch.randn(2, 48, 2, 64, generator=g).bfloat16(),
            torch.randn(2, 48, 2, 64, generator=g).bfloat16(), 48), {}),
        "ssd_scan": (ssd, (torch.randn(1, 64, 4, 16, generator=g),
                           torch.rand(1, 64, 4, generator=g),
                           -torch.rand(4, generator=g),
                           torch.randn(1, 64, 1, 16, generator=g),
                           torch.randn(1, 64, 1, 16, generator=g)),
                     {"chunk": 32}),
    }
    for name, (fn, args, kw) in cases.items():
        want = fn(*args, **kw)
        meta_args = [a.to("meta") if isinstance(a, torch.Tensor) else a
                     for a in args]
        dc = dryrun.DryCounters()
        with dc:
            got = fn(*meta_args, **kw)
        for w, o in zip(tree_util.leaves(want), tree_util.leaves(got)):
            assert (o.device.type, o.shape, o.dtype) == \
                ("meta", w.shape, w.dtype), name
        assert dc.kernels[name]["calls"] == 1 and \
            dc.kernels[name]["flops"] == dc.flops > 0, name
    with pytest.raises(ValueError, match="cpu or cuda"):
        matmul(torch.empty(128, 128, device="meta"),
               torch.empty(128, 128, device="meta"))


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_traces_train_prefill_and_decode(arch):
    """Each family's reduced config (head dim 64, a shape ``flash_decode``
    takes) traces a train, a prefill and a decode cell on rank 0 of a
    (2, 2, 2) dry mesh: finite positive FLOPs, a peak above the arguments,
    collectives on every cell, the kernels its path runs."""
    cfg = reduced(get(arch), head_dim=64)
    ran = set()
    for kind, shape in SMALL.items():
        cell, meta = dryrun.lower_cell(cfg, shape, False,
                                       mesh_shape=(2, 2, 2))
        got = dryrun.analyze(cell, meta)
        assert got["flops"] > 0 and got["bytes_accessed"] > 0, kind
        mem = got["memory"]
        assert mem["peak_gb"] >= mem["argument_gb"] > 0, kind
        assert got["collective_bytes"]["total"] > 0, kind
        assert got["mesh"] == "2x2x2"
        ran |= set(got["kernels"])
    assert "combine" in ran
    if cfg.ssm is not None:
        assert "ssd_scan" in ran
    if cfg.mla is None and cfg.family != "ssm":
        assert "flash_decode" in ran


def _gathered(shape, spec, mesh, axes=None) -> int:
    """Output bytes (f32) of gathering a leaf's block dim by dim over the
    axes its spec names (``axes``: only dims over these)."""
    sh = Sharding(mesh, spec)
    local = list(sh.local_shape(shape))
    total = 0
    for d, e in enumerate(sh._entries(len(shape))):
        names = () if e is None else ((e,) if isinstance(e, str) else e)
        if not names or (axes is not None and not set(names) <= set(axes)):
            continue
        local[d] *= math.prod(mesh.shape[a] for a in names)
        total += math.prod(local) * 4
    return total


def test_sharded_prefill_collective_bytes_equal_a_hand_reckoning():
    """A reduced float32 dense prefill of 8 x 32 on rank 0 of (2, 2, 2):
    the embedding and head gathered whole, each layer's ``data`` shards
    gathered, and the sums over ``model`` after attention and the MLP (an
    all-gather of the (2, 32, d) partials from both ranks): nothing else
    crosses the wire."""
    cfg = reduced(get("deepseek-7b"), dtype="float32")
    mesh = DryMesh((2, 2, 2), ("pod", "data", "model"))
    pctx = make_parallel_ctx(mesh)
    cell, meta = dryrun.lower_cell(cfg, SMALL["prefill"], False,
                                   mesh_shape=(2, 2, 2))
    got = dryrun.analyze(cell, meta)["collective_bytes"]
    model = build_model(cfg)
    params = model.init(None, device="meta")
    top = top_specs(cfg, pctx)
    want_gather = sum(_gathered(params["embed"][k].shape, top["embed"][k],
                                mesh) for k in params["embed"])
    lspecs = layer_specs(cfg, "dense", pctx)
    layer = tree_util.tree_map(lambda t: t[0], params["dense_stack"])
    per_layer = sum(_gathered(t.shape, s, mesh, axes=("data",)) for t, s in
                    zip(tree_util.leaves(layer),
                        tree_util.leaves(lspecs, is_leaf=is_spec)))
    want_gather += cfg.n_layers * per_layer
    rows = SMALL["prefill"].global_batch // pctx.dp_size
    want_sums = cfg.n_layers * 2 * (2 * rows * 32 * cfg.d_model * 4)
    assert got["by_op"] == {"weight_gather": want_gather,
                            "sum_over_model": want_sums}
    assert got["all_gather"] == got["total"] == want_gather + want_sums
    assert got["all_to_all"] == got["all_reduce"] == 0
    assert got["cross_pod"] == 0


def test_seq_shard_moves_the_stream_and_shrinks_nothing_it_must_not():
    """A reduced train cell with ``seq_shard``: the same FLOPs as without
    (the blocks run on the whole stream), the stream's gathers counted, the
    same sums over ``model``."""
    cfg = reduced(get("deepseek-7b"))
    runs = {}
    for seq in (False, True):
        cell, meta = dryrun.lower_cell(cfg, SMALL["train"], False,
                                       {"seq_shard": seq},
                                       mesh_shape=(2, 2, 2))
        runs[seq] = dryrun.analyze(cell, meta)
    off, on = runs[False], runs[True]
    assert on["seq_shard"] and not off["seq_shard"]
    assert on["flops"] == off["flops"]
    assert "seq_gather" not in off["collective_bytes"]["by_op"]
    assert on["collective_bytes"]["by_op"]["seq_gather"] > 0
    assert on["collective_bytes"]["by_op"]["sum_over_model"] == \
        off["collective_bytes"]["by_op"]["sum_over_model"]


def test_gather_weights_is_refused_naming_r10():
    with pytest.raises(ValueError, match="R10"):
        dryrun.lower_cell("deepseek-7b", "train_4k", False,
                          {"gather_weights": True})


def test_cli_writes_one_json_per_cell_and_skips_existing(tmp_path, capsys):
    """``main``: one JSON per (arch, shape, mesh) cell under ``--out``, a
    ``cell_runnable`` skip recorded as the reference records it, a cell
    whose file exists skipped, and ``--all`` narrowed by ``--shape``."""
    out = tmp_path / "grid"
    argv = ["--arch", "deepseek-7b", "--shape", "long_500k", "--mesh",
            "both", "--out", str(out)]
    dryrun.main(argv)
    files = sorted(p.name for p in out.iterdir())
    assert files == ["deepseek-7b__long_500k__multi.json",
                     "deepseek-7b__long_500k__single.json"]
    rec = json.loads((out / files[0]).read_text())
    assert rec["skipped"].startswith("skipped(full-attention arch")
    dryrun.main(argv)
    assert capsys.readouterr().out.count("[skip existing]") == 2
    # --shape narrows --all: one file per arch, the two sub-quadratic
    # archs traced, every other one skipped by cell_runnable
    dryrun.main(["--all", "--shape", "long_500k", "--mesh", "single",
                 "--out", str(out)])
    runs = {p.name: json.loads(p.read_text())
            for p in out.glob("*long_500k__single.json")}
    assert len(runs) == len(ALL_ARCHS)
    assert sorted(k for k, r in runs.items() if "skipped" not in r) == [
        "mamba2-2.7b__long_500k__single.json",
        "zamba2-2.7b__long_500k__single.json"]


def test_counting_counts_the_real_transport_as_the_dry_groups():
    """The counter is the same with and without processes: a one-rank gloo
    group's all-gather, all-to-all and all-reduce count their output bytes
    by kind and tag, as the dry groups do."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    if dist.is_initialized():
        pytest.skip("a process group is already initialized")
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        real = make_mesh((1,), ("data",), device="cpu")
        dry = DryMesh((1,), ("data",))
        counts = []
        for mesh, dev in ((real, "cpu"), (dry, "meta")):
            x = torch.ones(6, 5, device=dev)
            with collectives.counting() as c, collectives.tagged("t"):
                collectives.all_gather_stack(x, mesh.group("data"))
                collectives.all_to_all(x, mesh.group("data"))
                collectives.flat_allreduce(x, mesh, ("data",))
            counts.append(c)
        assert counts[0] == counts[1]
        assert counts[0]["bytes"] == {"all_gather": 120, "all_to_all": 120,
                                      "all_reduce": 120}
        assert counts[0]["by_op"] == {"t": 360}
    finally:
        dist.destroy_process_group()


SEQ_WORKER = r"""
import dataclasses, datetime, json, sys
import torch
import torch.distributed as dist
from repro_torch import tree as tree_util
from repro_torch.config import ShapeConfig, reduced
from repro_torch.configs import get
from repro_torch.core import collectives
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.parallel.ctx import make_parallel_ctx
from repro_torch.parallel.sharding import (cache_specs, param_specs,
                                           shard_tree)

rank, port, out, S = int(sys.argv[1]), sys.argv[2], sys.argv[3], int(sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=8, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
pctx = dataclasses.replace(make_parallel_ctx(mesh), decode_shape=(1, S))
cfg = reduced(get("zamba2-2.7b"), head_dim=64, dtype="float32")
model = build_model(cfg)
full = model.init(torch.Generator().manual_seed(0), device="cpu")
params = shard_tree(full, param_specs(full, cfg, pctx), mesh)
whole = model.init_cache(1, S, device="cpu")
caches = shard_tree(whole, cache_specs(
    whole, cfg, ShapeConfig("long", S, 1, "decode"), pctx), mesh)
with torch.no_grad(), collectives.counting() as wire:
    lg, _ = model.decode_step(params, caches, {
        "token": torch.tensor([3]), "pos": torch.tensor(S // 2 + 5)}, pctx)
json.dump({"wire": wire, "local_k": list(caches["attn"]["k"].shape),
           "finite": bool(torch.isfinite(lg).all())},
          open(f"{out}/r{rank}.json", "w"))
dist.barrier()
dist.destroy_process_group()
"""


def test_seq_split_decode_merge_bytes_equal_the_gloo_run(tmp_path):
    """The reduced zamba2 (head dim 64, float32) decoding one token at
    batch 1 over a window of 128 positions on (2, 2, 2), the cell's caches
    split over ``data`` by position (``kv_seq_axis``): the dry run's
    reckoning of each rank's collective bytes (the merge's ``kv_seq_merge``
    all-gathers of the lse and of ``[w out, w]`` included) equals what
    eight gloo processes count on each rank in the same decode step."""
    import socket
    S = 128
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", SEQ_WORKER, str(r),
                               port, str(tmp_path), str(S)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(8)]
    cfg = reduced(get("zamba2-2.7b"), head_dim=64, dtype="float32")
    shape = ShapeConfig("long", S, 1, "decode")
    reckoned = []
    try:
        for r in range(8):
            cell, meta = dryrun.lower_cell(cfg, shape, False,
                                           mesh_shape=(2, 2, 2), rank=r)
            reckoned.append(dryrun.analyze(cell, meta))
        logs = [p.communicate(timeout=120) + (p.returncode,) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for so, se, rc in logs:
        assert rc == 0, f"STDOUT:\n{so}\nSTDERR:\n{se}"
    # one merge a shared-attention call: the lse (B=1, 2 heads a model
    # rank) and [w out, w] (2 x 64 + 2 floats) gathered from 2 data ranks
    per_call = 2 * 2 * 4 + 2 * (2 * 64 + 2) * 4
    for r, want in enumerate(reckoned):
        got = json.loads((tmp_path / f"r{r}.json").read_text())
        assert got["finite"] and got["local_k"][2] == S // 2
        coll = want["collective_bytes"]
        assert got["wire"]["by_op"] == coll["by_op"], r
        assert got["wire"]["bytes"] == {k: coll[k] for k in
                                        collectives.KINDS}, r
        assert coll["by_op"]["kv_seq_merge"] == 2 * per_call
        assert want["kernels"]["flash_decode_lse"]["calls"] == 2
        assert "flash_decode" not in want["kernels"]
