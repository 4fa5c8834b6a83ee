"""Build the port's CUDA sources with ``nvcc`` at first use and load them.

Each kernel's ``csrc/*.cu`` exposes a plain C interface and is compiled into
a shared library under ``build/kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of its sources and flags, so a changed
source is rebuilt and an unchanged one is loaded as it is. The library is
loaded with ``ctypes``; the caller declares ``argtypes``/``restype``.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

#: name -> loaded library (one load per process)
_libs: dict[str, ctypes.CDLL] = {}
#: name -> nvcc's output of the build this process ran (ptxas register and
#: shared-memory report); absent when the library was already built
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{cand.parent}); the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path(name: str, sources: list[Path]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load(name: str, sources: list[Path]) -> ctypes.CDLL:
    """Return the loaded library for ``sources``, building it if needed.

    Raises ``RuntimeError`` with nvcc's output when the build fails."""
    if name in _libs:
        return _libs[name]
    so = library_path(name, sources)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(s) for s in sources]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed building {name} "
                               f"(exit {res.returncode}):\n{' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, so)     # atomic: a concurrent loader sees all or none
        build_logs[name] = res.stdout + res.stderr
    _libs[name] = ctypes.CDLL(str(so))
    return _libs[name]
