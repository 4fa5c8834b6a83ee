"""The port stands alone: no JAX and nothing of the JAX package in it, and
no silent run on the CPU."""

from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import bridge
from repro_torch.config import reduced
from repro_torch.configs import get
from repro_torch.models import LM
from repro_torch.serve.engine import ServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_every_module_imports_without_jax_or_reference():
    modules = sorted(
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok', len(sys.modules))\n")
    env = {**os.environ, "PYTHONPATH": str(PORT.parent)}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = LM(reduced(get("exanest-lm-100m")))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(2, 8)
    params = model.init(gen, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params, slots=2, window=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.load_params(model, {})
    ServeEngine(model, params, slots=2, window=8, device="cpu")


def test_training_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The training slice's entry points default to cuda as well, and the
    scan above covers its modules (``PORT.rglob``)."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import train as launch_train
    from repro_torch.train.loop import Trainer
    for mod in ("train/loop.py", "parallel/grad_sync.py",
                "kernels/allreduce_combine/ops.py", "checkpoint/store.py"):
        assert PORT / mod in FILES
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get("exanest-lm-100m"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticTokens(cfg, batch=2, seq=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(LM(cfg)).init_state(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--reduced", "--ckpt-dir", str(tmp_path)])


def test_ssm_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The Mamba-2 slice's entry points (SSMLM's init, its states, its
    training through Trainer and the launcher) default to cuda too."""
    from repro_torch.launch import train as launch_train
    from repro_torch.models import SSMLM
    from repro_torch.train.loop import Trainer
    for mod in ("models/ssm.py", "kernels/ssd_scan/ops.py",
                "kernels/ssd_scan/kernel.py"):
        assert PORT / mod in FILES
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = SSMLM(reduced(get("mamba2-2.7b")))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model).init_state(gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "mamba2-2.7b", "--reduced",
                           "--ckpt-dir", str(tmp_path)])


def test_matmul_slice_is_scanned_builds_nothing_and_names_no_tpu_spec():
    """The section 7 slice's modules are in the scan above, importing them
    builds no kernel, and the port's roofline holds the card's spec only."""
    for mod in ("kernels/matmul_tile/kernel.py", "kernels/matmul_tile/ops.py",
                "kernels/matmul_tile/ref.py", "roofline/hw.py",
                "roofline/paper.py", "core/exanet/params.py"):
        assert PORT / mod in FILES
    code = ("import repro_torch.kernels, repro_torch.roofline.paper\n"
            "from repro_torch.kernels import _build\n"
            "assert not _build._libs and not _build.build_logs\n"
            "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(PORT.parent)}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0 and res.stdout.startswith("ok"), res.stderr
    from repro_torch.roofline import hw
    specs = [v for v in vars(hw).values() if isinstance(v, hw.HwSpec)]
    # H100 is the card's spec. V5E is the reference's machine-model constant,
    # copied for the collective planner, which prices the reference's mesh;
    # no bound or time of the card reads it
    assert specs == [hw.H100, hw.V5E]
    for sub in ("roofline", "kernels/matmul_tile", "core/exanet"):
        for p in (PORT / sub).rglob("*.py"):
            if p != PORT / "roofline" / "hw.py":
                assert "v5e" not in p.read_text().lower(), p
    readers = sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.py")
                     if p != PORT / "roofline" / "hw.py"
                     and "V5E" in p.read_text())
    assert readers == ["core/comm.py", "core/machine.py"]


def test_dry_run_is_scanned_builds_nothing_and_names_no_tpu_spec():
    """The dry run and the kernels' meta route are in the scan above;
    importing them builds no kernel; the dry run's roofline is the H100's
    and its module names no TPU spec, as the port's roofline modules."""
    for mod in ("launch/dryrun.py", "kernels/_meta.py"):
        assert PORT / mod in FILES
    code = ("import repro_torch.launch.dryrun\n"
            "from repro_torch.kernels import _build\n"
            "assert not _build._libs and not _build.build_logs\n"
            "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(PORT.parent)}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0 and res.stdout.startswith("ok"), res.stderr
    from repro_torch.launch import dryrun
    from repro_torch.roofline import hw
    text = (PORT / "launch" / "dryrun.py").read_text()
    assert "v5e" not in text.lower()
    assert dryrun.roofline.__defaults__ == (hw.H100,)
    assert dryrun.H100 is hw.H100
