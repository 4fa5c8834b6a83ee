"""Fault tolerance: checkpoint/restart, failure replay, stragglers.

Counterpart of ``repro.runtime.fault``. The unit of replay is the training
step: deterministic data (seed, step) plus periodic checkpoints make any
step replayable after a failure, bit for bit.

* ``run_with_recovery`` drives a step function with injected failures;
  recovery restores the latest checkpoint and replays. Invariant (tested):
  the final state equals the failure-free run's.
* ``StragglerMonitor`` flags steps slower than a running-median deadline.
* ``elastic_reshard`` restores a checkpoint onto a different mesh.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable

import torch

from repro_torch import tree as tree_util
from repro_torch.checkpoint.store import (latest_step, restore_checkpoint,
                                          save_checkpoint)


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Deterministically fail at given steps (once each)."""
    fail_at: frozenset
    _hit: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at and step not in self._hit:
            self._hit.add(step)
            raise SimulatedFailure(f"injected node failure at step {step}")


class StragglerMonitor:
    def __init__(self, deadline_factor: float = 3.0, window: int = 32,
                 on_straggle: Callable | None = None):
        """``on_straggle(step, dt, deadline)`` fires when a step exceeds its
        running-median deadline (default: record only)."""
        self.factor = deadline_factor
        self.window = window
        self.on_straggle = on_straggle
        self.times: list[float] = []
        self.flagged: list[int] = []

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if the step straggled past the deadline."""
        hist = self.times[-self.window:]
        self.times.append(dt)
        if len(hist) >= 8:
            deadline = self.factor * statistics.median(hist)
            if dt > deadline:
                self.flagged.append(step)
                if self.on_straggle is not None:
                    self.on_straggle(step, dt, deadline)
                return True
        return False


def run_with_recovery(state, step_fn: Callable, n_steps: int, *,
                      ckpt_dir: str, ckpt_every: int = 10,
                      injector: FailureInjector | None = None,
                      straggler: StragglerMonitor | None = None,
                      delay_fn: Callable | None = None) -> tuple:
    """Run ``state = step_fn(state, step)`` for ``n_steps`` with periodic
    checkpoints; on SimulatedFailure, restore + replay. Returns
    (final_state, log). The template for restoring holds shapes and dtypes
    only (meta tensors), and restored leaves go back to the device the
    state's leaves were on. Nothing here keeps a reference to ``state``
    once the first step has replaced it, so a caller that passes it
    without keeping it holds one train state, not two."""
    device = next((x.device for x in tree_util.leaves(state)), None)
    template = tree_util.tree_map(
        lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), state)
    save_checkpoint(ckpt_dir, 0, state)
    log = {"failures": 0, "replayed_steps": 0, "straggles": 0}
    step = 0
    while step < n_steps:
        try:
            if injector is not None:
                injector.check(step)
            t0 = time.perf_counter()
            if delay_fn is not None:
                delay_fn(step)
            state = step_fn(state, step)
            dt = time.perf_counter() - t0
            if straggler is not None and straggler.observe(step, dt):
                log["straggles"] += 1
            step += 1
            if step % ckpt_every == 0:
                save_checkpoint(ckpt_dir, step, state)
        except SimulatedFailure:
            log["failures"] += 1
            last = latest_step(ckpt_dir)
            state, _ = restore_checkpoint(ckpt_dir, last, template,
                                          device=device)
            log["replayed_steps"] += step - last
            step = last
    return state, log


def elastic_reshard(ckpt_dir: str, step: int, template, new_shardings):
    """Restore a checkpoint onto a different mesh (elastic shrink/grow):
    each rank takes its block of every leaf under ``new_shardings`` (a
    tree of :class:`~repro_torch.parallel.sharding.Sharding`)."""
    return restore_checkpoint(ckpt_dir, step, template,
                              shardings=new_shardings)[0]
