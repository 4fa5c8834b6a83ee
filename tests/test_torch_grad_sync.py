"""The port's gradient sync on a 2x2 process mesh against the JAX reference.

Four gloo processes on the CPU (``pod`` = 2 inter, ``data`` = 2 intra) run
``sync_gradients`` with the ``flat``, ``hierarchical``, ``compressed`` and
``auto`` strategies on one numpy tree; the reference runs its own
``sync_gradients`` on four host devices in a subprocess, as
``tests/test_distributed.py`` runs it. Both sets of processes are started
once for the module. A second tree differs per rank and is checked against
the numpy sum; the results must be bitwise equal on all four ranks.
``auto`` is also run under three policies whose plans differ (all ``flat``,
all ``hierarchical``, and one of each on a larger tree), with and without
``allow_lossy``: each bucket's plan and the result against the reference's.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core.comm import CommPolicy
from repro_torch.parallel.grad_sync import (bucket_sizes,
                                            combine_launches_per_sync,
                                            flatten_to_buckets, plan_buckets,
                                            unflatten_from_buckets)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
#: 1000-byte buckets (250 f32): the tree of 567 elements spans three, the
#: last one odd-sized, so the intra reduce-scatter pads it
SMALL_ALPHA = 1e-10
#: 200,000-byte buckets (50,000 f32): the big tree's last bucket is 40 B,
#: below the planner's flat/hierarchical crossover at this alpha (~105 B)
MIXED_ALPHA = 2e-8
STRATS = ("flat", "hierarchical", "compressed")

TREE_CODE = """
def make_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal(513).astype(np.float32),
            "b": {"c": rng.standard_normal((7, 3)).astype(np.float32),
                  "d": (rng.standard_normal(33) * 3).astype(np.float32)}}

def make_big_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal(50_000).astype(np.float32),
            "b": rng.standard_normal(10).astype(np.float32)}

AUTO_TREES = {"tree": make_tree, "big": make_big_tree}
""" + f"""AUTO_ALPHAS = {{"default": None, "small": {SMALL_ALPHA!r},
               "mixed": {MIXED_ALPHA!r}}}
""" + """# (policy, tree): the big tree only where its buckets are few (the
# reference compiles one program per bucket shape)
AUTO_CASES = (("default", "tree"), ("small", "tree"), ("mixed", "tree"),
              ("mixed", "big"))
"""

WORKER = TREE_CODE + """
import datetime, json, sys
import torch
import torch.distributed as dist
from repro_torch.core.comm import CommPolicy
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.grad_sync import (CompressedSync, plan_buckets,
                                            sync_gradients)
from repro_torch import tree as tree_util
from repro_torch.train.loop import Trainer

rank, port, out_dir, alpha = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                              float(sys.argv[4]))
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=4, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
mesh = make_mesh((2, 2), ("pod", "data"), device="cpu")
res = {"coords": mesh.coords}
as_t = lambda t: tree_util.tree_map(torch.from_numpy, t)
flat = lambda t: {k: v.float().numpy() for k, v in tree_util.named_leaves(t)}
for label, policy in (("default", None), ("small", CommPolicy(alpha_s=alpha))):
    for strat in ("flat", "hierarchical", "compressed", "auto"):
        for tree_label, seed in (("same", 0), ("own", 100 + rank)):
            out = sync_gradients(as_t(make_tree(seed)), mesh, strategy=strat,
                                 policy=policy, mean_over=4)
            for name, arr in flat(out).items():
                np.save(f"{out_dir}/r{rank}-{label}-{strat}-{tree_label}-"
                        f"{name}.npy", arr)
for strat in ("flat", "hierarchical", "compressed", "auto"):
    out = Trainer(None, mesh=mesh, sync_strategy=strat).make_sync()(
        as_t(make_tree(100 + rank)))
    for name, arr in flat(out).items():
        np.save(f"{out_dir}/r{rank}-trainer-{strat}-{name}.npy", arr)
ef = CompressedSync(mesh, mean_over=4)
for step in range(3):
    out = ef(as_t(make_tree(200 + 10 * step + rank)))
np.save(f"{out_dir}/r{rank}-ef-a.npy", out["a"].numpy())
np.save(f"{out_dir}/r{rank}-ef-residual-a.npy", ef.residual["a"].numpy())
res["plans"] = {}
for label, tree_label in AUTO_CASES:
    a = AUTO_ALPHAS[label]
    policy = None if a is None else CommPolicy(alpha_s=a)
    for lossy in (False, True):
        key = f"{label}-{tree_label}-{'lossy' if lossy else 'exact'}"
        tree = as_t(AUTO_TREES[tree_label](0))
        res["plans"][key] = plan_buckets(tree, mesh, policy, lossy)
        out = sync_gradients(tree, mesh, strategy="auto", policy=policy,
                             allow_lossy=lossy, mean_over=4)
        for name, arr in flat(out).items():
            np.save(f"{out_dir}/r{rank}-auto-{key}-{name}.npy", arr)
json.dump(res, open(f"{out_dir}/r{rank}.json", "w"))
dist.barrier()
dist.destroy_process_group()
"""

JAX_RUN = TREE_CODE + """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro.core.comm import CommPolicy
from repro.launch.mesh import make_mesh
from repro.parallel.grad_sync import (flatten_to_buckets,
                                      plan_bucket_strategy, sync_gradients)
out_dir, alpha = sys.argv[1], float(sys.argv[2])
mesh = make_mesh((2, 2), ("pod", "data"))
as_j = lambda t: jax.tree_util.tree_map(jax.numpy.asarray, t)
named = lambda out: [(".".join(str(k.key) for k in path), leaf) for path, leaf
                     in jax.tree_util.tree_flatten_with_path(out)[0]]
tree = as_j(make_tree(0))
for label, policy in (("default", None), ("small", CommPolicy(alpha_s=alpha))):
    for strat in ("flat", "hierarchical", "compressed", "auto"):
        out = sync_gradients(tree, mesh, strategy=strat, policy=policy,
                             mean_over=4)
        for name, arr in named(out):
            np.save(f"{out_dir}/jax-{label}-{strat}-{name}.npy",
                    np.asarray(arr, np.float32))
plans = {}
for label, tree_label in AUTO_CASES:
    a = AUTO_ALPHAS[label]
    policy = CommPolicy() if a is None else CommPolicy(alpha_s=a)
    for lossy in (False, True):
        key = f"{label}-{tree_label}-{'lossy' if lossy else 'exact'}"
        t = as_j(AUTO_TREES[tree_label](0))
        buckets, _ = flatten_to_buckets(t, policy.bucket_bytes(4))
        plans[key] = [plan_bucket_strategy(
            policy, int(b.size) * b.dtype.itemsize, (2, 2), lossy)
            for b in buckets]
        out = sync_gradients(t, mesh, strategy="auto", policy=policy,
                             allow_lossy=lossy, mean_over=4)
        for name, arr in named(out):
            np.save(f"{out_dir}/jax-auto-{key}-{name}.npy",
                    np.asarray(arr, np.float32))
json.dump(plans, open(f"{out_dir}/jax-plans.json", "w"))
print("OK")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the four port ranks and the reference's run together; wait."""
    out = tmp_path_factory.mktemp("grad_sync")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "OMP_NUM_THREADS": "1"}
    pre = "import numpy as np\n"
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", pre + textwrap.dedent(WORKER), str(r), port,
         str(out), str(SMALL_ALPHA)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", pre + textwrap.dedent(JAX_RUN), str(out),
         str(SMALL_ALPHA)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    logs = []
    try:
        for p in procs + [jax_proc]:
            so, se = p.communicate(timeout=600)
            logs.append((p.returncode, so, se))
    finally:
        for p in procs + [jax_proc]:
            if p.poll() is None:
                p.kill()
    for rc, so, se in logs:
        assert rc == 0, f"STDOUT:\n{so}\nSTDERR:\n{se}"
    return out


def _load(out, stem):
    return np.load(out / f"{stem}.npy")


NAMES = ("a", "b.c", "b.d")


@pytest.mark.parametrize("policy", ["default", "small"])
@pytest.mark.parametrize("strategy", STRATS + ("auto",))
def test_sync_matches_reference_on_2x2_mesh(runs, strategy, policy):
    # flat/hierarchical: sums of four equal f32 values in another order, and
    # the mean's division, agree to 1e-5 relative (test_distributed.py's
    # tolerance); compressed: the same int8 codes and scales on both sides;
    # auto: flat (default policy) or hierarchical (small) on this tree
    tol = 1e-6 if strategy == "compressed" else 1e-5
    for name in NAMES:
        want = _load(runs, f"jax-{policy}-{strategy}-{name}")
        for r in range(WORLD):
            got = _load(runs, f"r{r}-{policy}-{strategy}-same-{name}")
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                       err_msg=f"rank {r} leaf {name}")


@pytest.mark.parametrize("policy", ["default", "small"])
@pytest.mark.parametrize("strategy", STRATS + ("auto",))
def test_sync_is_bitwise_equal_across_ranks(runs, strategy, policy):
    for tree in ("same", "own"):
        for name in NAMES:
            r0 = _load(runs, f"r0-{policy}-{strategy}-{tree}-{name}")
            for r in range(1, WORLD):
                np.testing.assert_array_equal(
                    _load(runs, f"r{r}-{policy}-{strategy}-{tree}-{name}"),
                    r0, err_msg=f"rank {r} leaf {name}")


def _numpy_mean_of_own_trees():
    ns: dict = {"np": np}
    exec(TREE_CODE, ns)
    trees = [ns["make_tree"](100 + r) for r in range(WORLD)]
    return {"a": sum(t["a"].astype(np.float64) for t in trees) / WORLD,
            "b.c": sum(t["b"]["c"].astype(np.float64) for t in trees) / WORLD,
            "b.d": sum(t["b"]["d"].astype(np.float64) for t in trees) / WORLD}


@pytest.mark.parametrize("policy", ["default", "small"])
@pytest.mark.parametrize("strategy", ["flat", "hierarchical"])
def test_sync_of_distinct_gradients_equals_numpy_mean(runs, strategy, policy):
    want = _numpy_mean_of_own_trees()
    for name in NAMES:
        got = _load(runs, f"r0-{policy}-{strategy}-own-{name}")
        np.testing.assert_allclose(got, want[name], rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def _numpy_compressed_mean(bucket_elems: int) -> dict:
    """The compressed sync written out in numpy float32 for the four own
    trees: per bucket, the intra (data) pair sums, int8 codes of each shard
    with one scale per (pod, shard), codes summed across pods, dequantized
    by the mean of the scales, divided by the world size."""
    ns: dict = {"np": np}
    exec(TREE_CODE, ns)
    trees = [ns["make_tree"](100 + r) for r in range(WORLD)]
    flat = [np.concatenate([t["a"], t["b"]["c"].ravel(), t["b"]["d"]])
            for t in trees]                      # sorted keys: a, b.c, b.d
    out = []
    for lo in range(0, flat[0].size, bucket_elems):
        parts = [f[lo:lo + bucket_elems] for f in flat]
        n = parts[0].size
        parts = [np.pad(x, (0, n % 2)) for x in parts]
        pods = [parts[0] + parts[1], parts[2] + parts[3]]   # rank = 2 pod + data
        half = pods[0].size // 2
        res = []
        for i in range(2):
            shards = [x[i * half:(i + 1) * half] for x in pods]
            scales = [np.maximum(np.abs(x).max() / np.float32(127.0),
                                 np.float32(1e-20)) for x in shards]
            q = sum(np.round(x / sc).astype(np.int32)
                    for x, sc in zip(shards, scales))
            res.append(q.astype(np.float32)
                       * ((scales[0] + scales[1]) / np.float32(2)))
        out.append((np.concatenate(res)[:n] / np.float32(WORLD)))
    big = np.concatenate(out)
    return {"a": big[:513], "b.c": big[513:534].reshape(7, 3),
            "b.d": big[534:]}


@pytest.mark.parametrize("policy", ["default", "small"])
def test_compressed_sync_of_distinct_gradients_equals_numpy(runs, policy):
    """Distinct gradients per rank give distinct scales per pod: the result
    is the compressed algorithm's (codes summed, the mean of the scales),
    not the exact mean. The numpy version computes the same float32 steps."""
    per = (CommPolicy(alpha_s=SMALL_ALPHA) if policy == "small"
           else CommPolicy()).bucket_bytes(WORLD) // 4
    want = _numpy_compressed_mean(per)
    exact = _numpy_mean_of_own_trees()
    for name in NAMES:
        got = _load(runs, f"r0-{policy}-compressed-own-{name}")
        np.testing.assert_allclose(got, want[name], rtol=1e-6, atol=1e-6,
                                   err_msg=name)
        # and it stays an approximation of the exact mean
        assert np.abs(got - exact[name]).max() <= 0.1 * np.abs(
            exact[name]).max(), name


def test_compressed_sync_error_feedback_keeps_residual_bounded(runs):
    for r in range(WORLD):
        res = _load(runs, f"r{r}-ef-residual-a")
        # the residual is one local quantization step at most
        assert np.isfinite(res).all() and np.abs(res).max() < 0.05
    a0 = _load(runs, "r0-ef-a")
    for r in range(1, WORLD):
        np.testing.assert_array_equal(_load(runs, f"r{r}-ef-a"), a0)


@pytest.mark.parametrize("strategy", STRATS + ("auto",))
def test_trainer_sync_averages_over_the_mesh_dp_size(runs, strategy):
    """Trainer(mesh=...).make_sync() is sync_gradients over the mesh's
    ParallelCtx divided by its DP size, 4: the same bits as the direct
    call with mean_over=4."""
    for r in range(WORLD):
        for name in NAMES:
            np.testing.assert_array_equal(
                _load(runs, f"r{r}-trainer-{strategy}-{name}"),
                _load(runs, f"r{r}-default-{strategy}-own-{name}"),
                err_msg=f"rank {r} leaf {name}")


def test_parallel_ctx_and_trainer_sync_guards():
    from types import SimpleNamespace

    from repro_torch.parallel.ctx import make_parallel_ctx
    from repro_torch.parallel.grad_sync import sync_gradients
    from repro_torch.train.loop import Trainer
    mesh = SimpleNamespace(axis_names=("pod", "data"),
                           shape={"pod": 2, "data": 3})
    ctx = make_parallel_ctx(mesh)
    assert ctx.dp_axes == ("pod", "data") and ctx.dp_size == 6
    sync = Trainer(None, mesh=mesh).make_sync()     # sync_strategy="auto"
    assert sync.func is sync_gradients
    assert sync.keywords == {"mesh": mesh, "strategy": "auto",
                             "mean_over": 6, "allow_lossy": False}
    assert Trainer(None, mesh=mesh, allow_lossy=True).make_sync().keywords[
        "allow_lossy"] is True
    with pytest.raises(ValueError, match="'data'/'pod'"):
        Trainer(None, mesh=SimpleNamespace(axis_names=("model",),
                                           shape={"model": 4}),
                sync_strategy="flat").make_sync()


@pytest.mark.parametrize("lossy", [False, True])
def test_auto_strategy_matches_reference_plan_and_result(runs, lossy):
    """Each rank's ``auto`` plan is the reference's ``plan_bucket_strategy``
    bucket for bucket, and its result the reference's ``auto`` result at the
    hierarchical tolerance; the three policies give an all-flat, an
    all-hierarchical (all-compressed with ``allow_lossy``) and a mixed
    plan."""
    import json
    sfx = "lossy" if lossy else "exact"
    big = "compressed" if lossy else "hierarchical"
    ref = json.loads((runs / "jax-plans.json").read_text())
    assert ref[f"default-tree-{sfx}"] == ["flat"]
    assert ref[f"small-tree-{sfx}"] == [big] * 3
    assert ref[f"mixed-big-{sfx}"] == [big, "flat"]
    keys = [k for k in ref if k.endswith(sfx)]
    assert len(keys) == 4
    for r in range(WORLD):
        res = json.loads((runs / f"r{r}.json").read_text())
        # row-major layout, last axis fastest: pod = r // 2, data = r % 2
        assert res["coords"] == {"pod": r // 2, "data": r % 2}
        for key in keys:
            assert res["plans"][key] == ref[key], key
            names = NAMES if "-tree-" in key else ("a", "b")
            for name in names:
                np.testing.assert_allclose(
                    _load(runs, f"r{r}-auto-{key}-{name}"),
                    _load(runs, f"jax-auto-{key}-{name}"), rtol=1e-5,
                    atol=1e-5, err_msg=f"rank {r} {key} leaf {name}")


def test_plan_buckets_counts_launches_of_a_mixed_plan():
    """``plan_buckets`` gives the reference's planner choice per bucket of a
    tree (shapes only), and ``combine_launches_per_sync`` counts a mixed
    plan: full-width exanest-lm-100m's 124,668,672 parameters make 25
    buckets of 20,000,000 B at most, all hierarchical (compressed with
    ``allow_lossy``); 5,000,000 + 1,000 floats make one hierarchical and
    one flat bucket."""
    from types import SimpleNamespace

    from repro.core.comm import CommPolicy as JaxPolicy
    from repro.parallel.grad_sync import plan_bucket_strategy
    mesh = SimpleNamespace(axis_names=("pod", "data"),
                           shape={"pod": 2, "data": 2})
    full = {"w": torch.empty(124_668_672, device="meta")}
    sizes = bucket_sizes(full, CommPolicy().bucket_bytes(WORLD))
    assert len(sizes) == 25 and sizes[-1] * 4 == 18_674_688
    for lossy, strat, launches in ((False, "hierarchical", 50),
                                   (True, "compressed", 75)):
        plan = plan_buckets(full, mesh, allow_lossy=lossy)
        assert plan == [plan_bucket_strategy(JaxPolicy(), n * 4, (2, 2),
                                             lossy) for n in sizes]
        assert plan == [strat] * 25
        assert combine_launches_per_sync(mesh, plan) == launches
    mixed = {"a": torch.empty(5_000_000, device="meta"),
             "b": torch.empty(1_000, device="meta")}
    plan = plan_buckets(mixed, mesh)
    assert plan == ["hierarchical", "flat"]
    assert combine_launches_per_sync(mesh, plan) == 2
    one = SimpleNamespace(axis_names=("pod", "data"),
                          shape={"pod": 1, "data": 4})
    assert plan_buckets(mixed, one) == ["flat", "flat"]
    assert combine_launches_per_sync(one, ["hierarchical", "flat"]) == 0
    assert plan_buckets(mixed, SimpleNamespace(
        axis_names=("data",), shape={"data": 1})) == []
    with pytest.raises(ValueError, match="unknown strategies"):
        combine_launches_per_sync(mesh, ["hierarchical", "auto"])


def test_sync_refuses_unknown_strategy_and_infeasible_plans():
    """No fallback: an unknown strategy name raises ``ValueError``, and a
    bucket the planner finds no feasible schedule for raises rather than
    becoming ``flat``."""
    from types import SimpleNamespace

    from repro_torch.parallel.grad_sync import (plan_bucket_strategy,
                                                sync_gradients)
    mesh = SimpleNamespace(axis_names=("pod", "data"),
                           shape={"pod": 2, "data": 2})
    with pytest.raises(ValueError, match="strategy must be one of"):
        sync_gradients({"g": torch.zeros(4)}, mesh, strategy="ring")
    with pytest.raises(ValueError, match="no software allreduce feasible"):
        plan_bucket_strategy(CommPolicy(), 4096, (1,))


def test_bucket_plan_matches_reference_policy():
    from repro.core.comm import CommPolicy as JaxPolicy
    for p in (2, 4, 8, 256):
        assert CommPolicy().bucket_bytes(p) == JaxPolicy().bucket_bytes(p)
        assert (CommPolicy(alpha_s=SMALL_ALPHA).bucket_bytes(p)
                == JaxPolicy(alpha_s=SMALL_ALPHA).bucket_bytes(p))
    # 4 ranks: 20,000,000 B, i.e. 5,000,000 float32 per bucket
    assert CommPolicy().bucket_bytes(4) == 20_000_000
    tree = {"w": torch.zeros(12_000_001), "b": torch.zeros(3)}
    assert bucket_sizes(tree, 20_000_000) == [5_000_000, 5_000_000, 2_000_004]
    from types import SimpleNamespace
    mesh = SimpleNamespace(axis_names=("pod", "data"),
                           shape={"pod": 2, "data": 2})
    assert combine_launches_per_sync(mesh, ["hierarchical"] * 3) == 6
    assert combine_launches_per_sync(mesh, ["compressed"] * 3) == 9
    assert combine_launches_per_sync(mesh, ["flat"] * 3) == 0
    # one DP axis of more than one rank: every strategy is a flat all-reduce
    one = SimpleNamespace(axis_names=("pod", "data"),
                          shape={"pod": 1, "data": 4})
    assert combine_launches_per_sync(one, ["hierarchical"] * 3) == 0
    assert combine_launches_per_sync(one, ["compressed"] * 3) == 0


def test_buckets_round_trip_in_reference_leaf_order():
    tree = {"z": torch.arange(5, dtype=torch.float32),
            "a": {"y": torch.ones(2, 2, dtype=torch.bfloat16),
                  "b": torch.full((3,), 7.0)}}
    buckets, spec = flatten_to_buckets(tree, 16)          # 4 f32 per bucket
    assert [b.numel() for b in buckets] == [4, 4, 4]
    # sorted keys: a.b, a.y, z
    np.testing.assert_array_equal(torch.cat(buckets).numpy(),
                                  [7, 7, 7, 1, 1, 1, 1, 0, 1, 2, 3, 4])
    back = unflatten_from_buckets(buckets, spec)
    assert back["a"]["y"].dtype == torch.bfloat16
    for k in ("z",):
        assert torch.equal(back[k], tree[k])
    assert torch.equal(back["a"]["b"], tree["a"]["b"])
