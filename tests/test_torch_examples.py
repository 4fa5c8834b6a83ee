"""The port's four thin examples (``repro_torch.examples``) against the
reference's ``examples/``: quickstart's ExaNet figure and its mesh demo,
the accelerator demo's Fig. 19 rows, round counts, schedules and napkin
bytes, serve_lm's tokens from the reference's parameters, and train_lm's
injected failure and replay. The reference's serve_lm and train_lm run as
scripts in subprocesses, serve_lm with ``--xla_allow_excess_precision=
false`` so that its bf16 arithmetic rounds where its source says, as the
port's does (ROADMAP.md R5)."""

from __future__ import annotations

import importlib.util
import os
import re
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.store import _leaf_name
from repro.config import reduced as jax_reduced
from repro.configs import get as jax_get
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.models import build_model as jax_build_model
from repro_torch.examples import (allreduce_accel_demo, cg_solver,
                                  quickstart, serve_lm, train_lm)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
TRAIN_ARGS = ["--small", "--steps", "12"]


def _reference(name: str):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _leaves(params) -> dict:
    return {_leaf_name(path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's serve_lm and train_lm, started together; each
    test reads its own with ``communicate``."""
    env = {**os.environ, "PYTHONPATH": SRC,
           "XLA_FLAGS": "--xla_allow_excess_precision=false"}
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.join(REPO, "examples", f"{name}.py"),
         *args], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name, args in (("serve_lm", []),
                                      ("train_lm", TRAIN_ARGS))}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)


def _stdout(proc) -> str:
    so, se = proc.communicate(timeout=300)
    assert proc.returncode == 0, f"STDOUT:\n{so}\nSTDERR:\n{se}"
    return so


# ----------------------------------------------------------- quickstart
def test_quickstart_layer_a_matches_reference(capsys):
    _reference("quickstart").layer_a()
    want = capsys.readouterr().out
    quickstart.layer_a()
    got = capsys.readouterr().out
    assert got == want
    assert "(paper: 87.9%)" in got and "% faster" in got


def test_quickstart_layer_b_skips_on_one_process(capsys):
    _reference("quickstart").layer_b()
    want = capsys.readouterr().out
    assert quickstart.layer_b("cpu") is None
    got = capsys.readouterr().out
    assert got.split(" (see")[0] == want.split(" (see")[0]
    assert got.startswith("[tpu-adapt] single device (1) — skipping")


def test_quickstart_layer_b_on_four_ranks():
    code = textwrap.dedent("""
        import datetime, sys
        import torch.distributed as dist
        from repro_torch.examples import quickstart
        rank, port = int(sys.argv[1]), sys.argv[2]
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=4, rank=rank,
                                timeout=datetime.timedelta(seconds=120))
        assert quickstart.layer_b("cpu") is True
        dist.destroy_process_group()
    """)
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), port],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    try:
        outs = [p.communicate(timeout=120) + (p.returncode,) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for so, se, rc in outs:
        assert rc == 0, se
        assert so == "[tpu-adapt] hierarchical == flat allreduce: True\n"


def test_quickstart_tiny_training_from_reference_params():
    """The reference's parameters through ``bridge.load_params``: the first
    loss is the reference model's on the same batch (bf16, the reference's
    2e-2), and the loss falls."""
    jcfg = jax_reduced(jax_get("exanest-lm-100m"))
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    want = float(jax.jit(jm.loss_fn)(jp, JaxTokens(jcfg, batch=4,
                                                   seq=64).batch_at(0)))
    hist = quickstart.tiny_training("cpu", _leaves(jp), steps=6)
    assert hist[0]["step"] == 0 and hist[-1]["step"] == 5
    assert abs(hist[0]["loss"] - want) <= 2e-2 * abs(want)
    assert hist[-1]["loss"] < hist[0]["loss"]


# -------------------------------------------------- allreduce_accel_demo
def test_allreduce_demo_matches_reference(capsys):
    """Fig. 19's rows, the accelerator's round counts, the three
    schedules' microseconds and the napkin bytes, line for line."""
    parts = ("model_fig19", "schedule_structure", "schedule_alternatives",
             "schedule_napkin")
    ref = _reference("allreduce_accel_demo")
    for name in parts:
        getattr(ref, name)()
    want = capsys.readouterr().out
    for name in parts:
        getattr(allreduce_accel_demo, name)()
    got = capsys.readouterr().out
    assert got == want
    assert len(got.splitlines()) == 8
    assert "recursive_doubling=" in got and "rabenseifner=" in got


def test_allreduce_demo_combine_on_cpu_says_plain_only(capsys):
    assert allreduce_accel_demo.kernel_combine("cpu") == 0.0
    line = capsys.readouterr().out
    assert "the plain version only" in line and line.rstrip().endswith("OK")


# ------------------------------------------------------------- serve_lm
def test_serve_lm_tokens_equal_reference(reference_runs):
    cfg = jax_reduced(jax_get("exanest-lm-100m"), n_layers=2, d_model=64,
                      vocab_size=512, n_heads=4, n_kv_heads=2, d_ff=128)
    jp = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    got = serve_lm.serve("cpu", _leaves(jp))
    want = {int(r): [int(t) for t in toks.split(",")] for r, toks in
            re.findall(r"^request (\d+): \[([\d, ]+)\]$",
                       _stdout(reference_runs["serve_lm"]), re.M)}
    assert len(want) == 6
    assert got == want
    assert [len(got[r]) for r in range(6)] == [8, 8, 8, 6, 6, 6]


# ------------------------------------------------------------- train_lm
def test_train_lm_replays_injected_failure_and_loss_falls(reference_runs):
    run = train_lm.main(TRAIN_ARGS + ["--device", "cpu"])
    m = re.search(r"^done\. failures=(\d+) replayed=(\d+)",
                  _stdout(reference_runs["train_lm"]), re.M)
    assert (run["log"]["failures"], run["log"]["replayed_steps"]) == (
        int(m[1]), int(m[2])) == (1, 4)
    # step 0 is logged twice: before the failure at step 4 and on replay
    assert [i for i, _ in run["losses"]] == [0, 0, 11]
    assert run["losses"][0][1] == run["losses"][1][1]
    assert run["losses"][-1][1] < run["losses"][0][1]


# ---------------------------------------------------------- entry points
@pytest.mark.parametrize("module,args,last", [
    ("allreduce_accel_demo", [], "allreduce_accel_demo OK"),
    ("serve_lm", [], "serve_lm OK")])
def test_cli_on_cpu(module, args, last):
    env = {**os.environ, "PYTHONPATH": SRC}
    res = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{module}", *args,
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.rstrip().splitlines()[-1] == last


def test_examples_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: cg_solver.main(["--n", "8", "--iters", "1"]),
                 lambda: serve_lm.main([]),
                 lambda: train_lm.main(TRAIN_ARGS),
                 lambda: allreduce_accel_demo.kernel_combine(),
                 lambda: quickstart.tiny_training(steps=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
