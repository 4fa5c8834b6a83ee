"""Pluggable scan-engine seam for the compiled executors (DESIGN.md §2.5).

The two kernels every compiled replay spends its time in — the segmented
max-plus scan and the segmented running maximum of
:mod:`repro_torch.core.exanet.sim` — are pure array programs over a
``(k, *batch)`` layout with data-independent combine masks.  That makes
them retargetable: this module defines the engine interface the
:class:`~repro_torch.core.exanet.exec_compiled.VecTransport` kernels call
through, with two implementations:

* :class:`NumpyScanEngine` (``engine="numpy"``, the default) — delegates
  to the in-place masked-ufunc scans in ``sim.py``.  No dependencies
  beyond NumPy; the reference for the ≤1e-9 agreement tests.
* :class:`TorchScanEngine` (``engine="torch"``) — the same Hillis-Steele
  passes in float64 torch ops on the engine's device (``cuda`` unless the
  caller names another), every batch column at once.  The compiled
  executor is held to ≤1e-9 agreement with the interpreter, which float32
  cannot meet.  torch is imported when the engine is built, so the rest of
  the simulator stays host code that needs NumPy only.

Engines are stateless beyond caches, so one instance serves every
compiled program; executors resolve a per-call ``engine=`` argument
through :func:`resolve_engine` (``None`` → numpy).  The combine masks
arrive as the precomputed ``takes`` lists of
:func:`~repro_torch.core.exanet.sim.scan_take_masks`; the torch lane keeps
each list's masks on its device.

The port's copy of the reference's ``repro.core.exanet.scan_engine``: the
numpy lane, :func:`available_engines`, :func:`get_scan_engine` and
:func:`resolve_engine` as they are there; the torch lane takes the place of
the reference's jax lane.  ``tests/test_torch_exanet_compiled.py`` holds
the lanes equal.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.exanet.sim import (segmented_maxplus_scan,
                                         segmented_running_max)


class NumpyScanEngine:
    """The default engine: sim.py's in-place masked-ufunc scans."""

    name = "numpy"

    def maxplus_scan(self, D, T, takes):
        """Segmented max-plus scan; may clobber ``D``/``T`` (callers pass
        freshly-built per-stage arrays)."""
        return segmented_maxplus_scan(D, T, None, 0, takes=takes,
                                      copy=False)

    def running_max(self, v, takes):
        return segmented_running_max(v, takes)


class TorchScanEngine:
    """The scan kernels as float64 torch ops on one device.

    Each ``(shift, mask)`` stage of a ``takes`` list is one Hillis-Steele
    pass over the ``(k, C)`` view of the batch (``C`` the trailing dims
    flattened).  A pass builds its result out of place and then copies it
    in: numpy buffers the overlapping views of ``sim.py``'s in-place form,
    torch would read values it already wrote.  The masks are uploaded once
    per ``takes`` list, keyed by the list's identity — the cache holds a
    reference to the list itself, so a recycled ``id()`` can never alias a
    dead stage.  Inputs and outputs are NumPy arrays: the conversion
    happens at this boundary only, and the surrounding gather/scatter
    bookkeeping stays NumPy.  ``calls`` counts the scans this engine ran.
    """

    name = "torch"

    def __init__(self, device=None):
        from repro_torch.device import resolve_device
        self.device = resolve_device(device)
        self._takes_cache: dict = {}
        self.calls = {"maxplus_scan": 0, "running_max": 0}

    def _prep(self, takes):
        import torch
        key = id(takes)
        ent = self._takes_cache.get(key)
        if ent is None or ent[0] is not takes:
            shifts = tuple(int(s) for s, _ in takes)
            masks = tuple(
                torch.from_numpy(np.ascontiguousarray(m[:, 0]))
                .to(self.device)[:, None] for _, m in takes)
            ent = self._takes_cache[key] = (takes, shifts, masks)
        return ent[1], ent[2]

    def _put(self, a, shape):
        import torch
        # a fresh buffer: the passes write into it, and on the CPU the
        # tensor shares it
        a = np.array(np.broadcast_to(a, shape), dtype=np.float64)
        return torch.from_numpy(a.reshape(shape[0], -1)).to(self.device)

    def maxplus_scan(self, D, T, takes):
        """Segmented max-plus scan: per stage, ``T[s:] ← where(m,
        max(T[:-s] + D[s:], T[s:]), T[s:])``, then ``D[s:] ← where(m,
        D[:-s] + D[s:], D[s:])``; ``D`` broadcasts to ``T``'s shape."""
        import torch
        shifts, masks = self._prep(takes)
        shape = T.shape
        Dt, Tt = self._put(D, shape), self._put(T, shape)
        for s, m in zip(shifts, masks):
            Tn = torch.where(m, torch.maximum(Tt[:-s] + Dt[s:], Tt[s:]),
                             Tt[s:])
            Dn = torch.where(m, Dt[:-s] + Dt[s:], Dt[s:])
            Tt[s:] = Tn
            Dt[s:] = Dn
        self.calls["maxplus_scan"] += 1
        return (Dt.cpu().numpy().reshape(shape),
                Tt.cpu().numpy().reshape(shape))

    def running_max(self, v, takes):
        """Segmented running maximum: per stage, ``v[s:] ← where(m,
        max(v[:-s], v[s:]), v[s:])``."""
        import torch
        shifts, masks = self._prep(takes)
        shape = v.shape
        vt = self._put(v, shape)
        for s, m in zip(shifts, masks):
            vt[s:] = torch.where(m, torch.maximum(vt[:-s], vt[s:]), vt[s:])
        self.calls["running_max"] += 1
        return vt.cpu().numpy().reshape(shape)


#: the default engine instance (module-level: every compiled program
#: shares it, and ``resolve_engine(None)`` is an attribute read)
NUMPY = NumpyScanEngine()

_engines: dict = {"numpy": NUMPY}


def available_engines() -> list[str]:
    """Engine names usable in this environment (``torch`` only when torch
    imports and sees a CUDA device)."""
    names = ["numpy"]
    try:
        import torch
    except ImportError:
        return names
    if torch.cuda.is_available():
        names.append("torch")
    return names


def get_scan_engine(name: str = "numpy"):
    """The shared engine instance for ``name``.  Raises ``ValueError``
    for unknown names and ``RuntimeError`` when ``"torch"`` is requested
    without a CUDA device (a caller that wants the torch lane on another
    device builds its own :class:`TorchScanEngine`)."""
    eng = _engines.get(name)
    if eng is None:
        if name != "torch":
            raise ValueError(f"unknown scan engine {name!r}; "
                             f"options: ['numpy', 'torch']")
        eng = _engines["torch"] = TorchScanEngine()
    return eng


def resolve_engine(engine):
    """Normalize a per-call ``engine=`` argument: ``None`` → the numpy
    default, a name → the shared instance, an engine object → itself."""
    if engine is None:
        return NUMPY
    if isinstance(engine, str):
        return get_scan_engine(engine)
    if hasattr(engine, "maxplus_scan") and hasattr(engine, "running_max"):
        return engine
    raise ValueError(f"not a scan engine: {engine!r} (pass 'numpy', "
                     f"'torch', or an object with maxplus_scan/running_max)")
