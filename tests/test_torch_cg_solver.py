"""The port's conjugate-gradient example and its halo exchange against the
JAX reference's ``examples/cg_solver.py`` and ``jax.lax.ppermute``.

One rank in this process: the stencil on seeded asymmetric inputs, the
eigenvector solve at n = 16 and a seeded right-hand side at n = 12 after
1, 5 and 10 iterations. Four gloo processes on the CPU, started once for
the module beside the reference on four host devices (a subprocess that
sets ``XLA_FLAGS``): the slab solve at n = 16 on a ``(4,)`` data mesh, its
``combine_parts`` calls a rank, ``main`` on the four ranks, and
``ppermute`` on the groups of a 2x2 ``(pod, data)`` mesh (neither is the
world; the pod groups are ranks {0, 2} and {1, 3}) with its byte counts.
"""

from __future__ import annotations

import importlib.util
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import collectives
from repro_torch.examples import cg_solver
from repro_torch.launch.mesh import DryMesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
WORLD = 4
N_MESH, ITERS_MESH = 16, 10

_spec = importlib.util.spec_from_file_location(
    "reference_cg_solver", os.path.join(REPO, "examples", "cg_solver.py"))
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

CASES = """
import numpy as np

def seeded_b(n):
    return np.random.default_rng(0).standard_normal((n, n, n)).astype(
        np.float32)

def ppermute_input(rank):
    return np.random.default_rng(10 + rank).standard_normal((3, 5)).astype(
        np.float32)

# (label, mesh axis, perm, dtype)
PERMUTES = (("ring-data", "data", [(0, 1), (1, 0)], "float32"),
            ("partial-data", "data", [(0, 1)], "float32"),
            ("ring-pod-bf16", "pod", [(1, 0), (0, 1)], "bfloat16"),
            ("self-pod", "pod", [(1, 1)], "float32"))
"""
exec(CASES)

WORKER = CASES + """
import datetime, json, sys
import torch
import torch.distributed as dist
from repro_torch.core import collectives
from repro_torch.examples import cg_solver
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel import tensor_parallel

rank, port, out_dir, n, iters = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                 int(sys.argv[4]), int(sys.argv[5]))
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=4, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
res = {}
calls = [0]
plain = tensor_parallel.combine_parts

def counted(*a, **k):
    calls[0] += 1
    return plain(*a, **k)

tensor_parallel.combine_parts = counted
mesh = make_mesh((4,), ("data",), device="cpu")
rows = slice(rank * n // 4, (rank + 1) * n // 4)
with collectives.counting() as c:
    x, r = cg_solver.make_cg(mesh, n, iters)(torch.from_numpy(
        seeded_b(n)[rows].copy()))
np.save(f"{out_dir}/cg-x-{rank}.npy", x.numpy())
res["residual"] = float(r)
res["combine_calls"] = calls[0]
res["cg_bytes"] = c["bytes"]
res["main"] = cg_solver.main(["--device", "cpu", "--n", str(n),
                              "--iters", str(iters)])

pmesh = make_mesh((2, 2), ("pod", "data"), device="cpu")
res["groups"] = {a: [dist.get_global_rank(pmesh.group(a), i)
                     for i in range(2)] for a in ("pod", "data")}
res["permute_bytes"] = {}
for label, axis, perm, dtype in PERMUTES:
    x = torch.from_numpy(ppermute_input(rank)).to(
        getattr(torch, dtype))
    with collectives.counting() as c:
        y = collectives.ppermute(x, perm, pmesh.group(axis))
    assert y.dtype == x.dtype and y.shape == x.shape
    np.save(f"{out_dir}/pp-{label}-{rank}.npy", y.float().numpy())
    res["permute_bytes"][label] = [c["bytes"]["ppermute"],
                                   c["ops"]["ppermute"]]
json.dump(res, open(f"{out_dir}/r{rank}.json", "w"))
dist.barrier()
dist.destroy_process_group()
"""

JAX_RUN = CASES + """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import importlib.util
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_mesh
repo, out_dir, n, iters = sys.argv[1], sys.argv[2], int(sys.argv[3]), \\
    int(sys.argv[4])
spec = importlib.util.spec_from_file_location(
    "reference_cg_solver", os.path.join(repo, "examples", "cg_solver.py"))
ref = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ref)
mesh = make_mesh((4,), ("data",))
b = jax.device_put(jnp.asarray(seeded_b(n)),
                   NamedSharding(mesh, P("data", None, None)))
x, r = ref.make_cg(mesh, n, iters)(b)
np.save(f"{out_dir}/jax-cg-x.npy", np.asarray(x))
np.save(f"{out_dir}/jax-cg-r.npy", np.asarray(r))
pmesh = make_mesh((2, 2), ("pod", "data"))
for label, axis, perm, dtype in PERMUTES:
    xs = jnp.stack([jnp.asarray(ppermute_input(r), dtype)
                    for r in range(4)])
    f = jax.shard_map(lambda v: jax.lax.ppermute(v, axis, perm), mesh=pmesh,
                      in_specs=P(("pod", "data")),
                      out_specs=P(("pod", "data")))
    np.save(f"{out_dir}/jax-pp-{label}.npy",
            np.asarray(jax.jit(f)(xs), np.float32))
print("OK")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four port ranks and the reference's run, started together."""
    out = tmp_path_factory.mktemp("cg")
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(WORKER), str(r), port,
         str(out), str(N_MESH), str(ITERS_MESH)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_RUN), REPO, str(out),
         str(N_MESH), str(ITERS_MESH)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
    logs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=300)
            logs.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for rc, so, se in logs:
        assert rc == 0, f"STDOUT:\n{so}\nSTDERR:\n{se}"
    ranks = [json.loads((out / f"r{r}.json").read_text())
             for r in range(WORLD)]
    return out, ranks


# ------------------------------------------------------------- one rank
def test_apply_stencil_matches_reference():
    """Seeded asymmetric u and halos: a pad on the wrong axis would show."""
    rng = np.random.default_rng(3)
    u = rng.standard_normal((5, 7, 9)).astype(np.float32)
    lo, hi = (rng.standard_normal((7, 9)).astype(np.float32)
              for _ in range(2))
    want = np.asarray(ref.apply_stencil(jnp.asarray(u), jnp.asarray(lo),
                                        jnp.asarray(hi), 0.01))
    got = cg_solver.apply_stencil(torch.from_numpy(u), torch.from_numpy(lo),
                                  torch.from_numpy(hi), 0.01)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_eigen_rhs_is_the_reference_meshgrid():
    n = 16
    h = 1.0 / (n + 1)
    pts = (jnp.arange(n) + 1) * h
    zz, yy, xx = jnp.meshgrid(pts, pts, pts, indexing="ij")
    want = np.asarray(jnp.sin(np.pi * xx) * jnp.sin(np.pi * yy)
                      * jnp.sin(np.pi * zz))
    np.testing.assert_allclose(cg_solver.eigen_rhs(n, device="cpu").numpy(),
                               want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        cg_solver.eigen_rhs(n, (4, 8), device="cpu").numpy(), want[4:8],
        rtol=1e-6, atol=1e-7)


def test_one_rank_eigenvector_solve_matches_reference():
    n, iters = 16, 10
    b = cg_solver.eigen_rhs(n, device="cpu")
    xj, _ = ref.make_cg(None, n, iters)(jnp.asarray(b.numpy()))
    xt, _ = cg_solver.make_cg(None, n, iters, device="cpu")(b)
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= 1e-5 * np.abs(xj).max()
    expected = b.numpy() / cg_solver.eigenvalue(n)
    for x in (xt.numpy(), xj):
        assert np.abs(x - expected).max() / np.abs(expected).max() < 5e-2
    assert cg_solver.analytic_error(xt, b, n) < 5e-2


@pytest.mark.parametrize("iters", [1, 5, 10])
def test_one_rank_seeded_rhs_matches_reference(iters):
    n = 12
    b = seeded_b(n)
    xj, rj = ref.make_cg(None, n, iters)(jnp.asarray(b))
    xt, rt = cg_solver.make_cg(None, n, iters, device="cpu")(
        torch.from_numpy(b))
    xj, rj = np.asarray(xj), float(rj)
    assert xt.shape == (n, n, n) and rt.shape == ()
    assert np.abs(xt.numpy() - xj).max() <= 1e-4 * np.abs(xj).max()
    assert abs(float(rt) - rj) <= 1e-4 * rj


def test_cli_solves_on_cpu():
    env = {**os.environ, "PYTHONPATH": SRC}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.cg_solver", "--device",
         "cpu", "--n", "16", "--iters", "10"], capture_output=True,
        text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "n=16^3 iters=10 residual=" in res.stdout
    assert res.stdout.rstrip().endswith("cg_solver OK")


def test_cli_on_two_ranks_through_env():
    """Two processes that join gloo through ``env://`` (MASTER_ADDR, ...)
    solve on slabs and agree with one rank."""
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": "2"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.examples.cg_solver", "--device",
         "cpu", "--n", "8", "--iters", "4"], env={**env, "RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) + (p.returncode,) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for so, se, rc in outs:
        assert rc == 0, se
    lines = outs[0][0].splitlines()
    assert lines[0] == "slab decomposition over 2 devices"
    assert lines[-1] == "cg_solver OK" and outs[1][0] == ""
    one = cg_solver.main(["--device", "cpu", "--n", "8", "--iters", "4"])
    err = float(lines[1].split("rel_err_vs_analytic=")[1])
    assert abs(err - one["rel_err_vs_analytic"]) <= 1e-3 * 5e-2


# ------------------------------------------------------------ ppermute
def test_ppermute_on_a_dry_group_counts_and_checks_perm():
    g = DryMesh((2, 4), ("pod", "data")).group("data")
    x = torch.ones(3, 5, device="meta", dtype=torch.bfloat16)
    with collectives.counting() as c, collectives.tagged("halo"):
        y = collectives.ppermute(x, [(i, (i + 1) % 4) for i in range(4)], g)
    assert y.shape == x.shape and y.dtype == x.dtype and y.is_meta
    assert c["bytes"]["ppermute"] == 30 and c["ops"]["ppermute"] == 1
    assert c["by_op"] == {"halo": 30}
    for bad in ([(0, 1), (0, 2)], [(0, 1), (2, 1)], [(0, 4)]):
        with pytest.raises(ValueError, match="distinct"):
            collectives.ppermute(x, bad, g)


def test_ppermute_groups_are_not_the_world(runs):
    _, ranks = runs
    assert [r["groups"] for r in ranks] == [
        {"pod": [0, 2], "data": [0, 1]}, {"pod": [1, 3], "data": [0, 1]},
        {"pod": [0, 2], "data": [2, 3]}, {"pod": [1, 3], "data": [2, 3]}]


@pytest.mark.parametrize("case", PERMUTES, ids=lambda c: c[0])
def test_ppermute_matches_jax(runs, case):
    out, ranks = runs
    label, _, perm, dtype = case
    want = np.load(out / f"jax-pp-{label}.npy")
    itemsize = 4 if dtype == "float32" else 2
    for r in range(WORLD):
        got = np.load(out / f"pp-{label}-{r}.npy")
        np.testing.assert_array_equal(got, want[r])
        assert ranks[r]["permute_bytes"][label] == [15 * itemsize, 1]
    # a rank no pair sends to gets zeros
    if label == "partial-data":
        assert not want[0].any() and want[1].any()


# ------------------------------------------------------ four-rank solve
def test_four_rank_solve_matches_reference(runs):
    out, ranks = runs
    want = np.load(out / "jax-cg-x.npy")
    got = np.concatenate([np.load(out / f"cg-x-{r}.npy")
                          for r in range(WORLD)])
    assert got.shape == (N_MESH,) * 3
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    rj = float(np.load(out / "jax-cg-r.npy"))
    for r in ranks:
        assert abs(r["residual"] - rj) <= 1e-4 * rj
        assert r["residual"] == ranks[0]["residual"]


def test_four_rank_solve_sums_by_combine_and_exchanges_faces(runs):
    _, ranks = runs
    face = N_MESH * N_MESH * 4
    for r in ranks:
        assert r["combine_calls"] == 1 + 2 * ITERS_MESH
        # one A(x) before the loop and one per iteration, two faces each
        assert r["cg_bytes"]["ppermute"] == 2 * (ITERS_MESH + 1) * face
        assert r["cg_bytes"]["all_gather"] == (1 + 2 * ITERS_MESH) * WORLD * 4


def test_main_on_four_ranks(runs):
    _, ranks = runs
    for r in ranks:
        m = r["main"]
        assert m["ranks"] == WORLD and m["n"] == N_MESH
        assert m["rel_err_vs_analytic"] < 5e-2
        assert m == ranks[0]["main"]
