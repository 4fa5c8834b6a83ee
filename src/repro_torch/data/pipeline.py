"""Deterministic synthetic data pipeline.

Counterpart of ``repro.data.pipeline`` (``SyntheticTokens`` and
``Prefetcher``). Every batch is a pure function of (seed, step), drawn with
numpy exactly as the reference draws it, so the port's batches are the
reference's int32 tokens bit for bit, placed on the requested device (cuda
unless the caller says otherwise). Restarts resume exactly, which is what
makes failure replay exact (:mod:`repro_torch.runtime.fault`).
``make_batch_specs`` and ``shard_batch`` lay a global batch out over a
mesh's batch axes (:mod:`repro_torch.parallel.sharding`).
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from repro_torch.config import ArchConfig
from repro_torch.device import resolve_device


class SyntheticTokens:
    """Markov-ish synthetic LM tokens: learnable structure (not uniform
    noise) so training shows a real loss curve."""

    def __init__(self, cfg: ArchConfig, batch: int, seq: int, seed: int = 0,
                 device=None):
        self.cfg, self.batch, self.seq, self.seed = cfg, batch, seq, seed
        self.device = resolve_device(device)

    def _tokens(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        v = self.cfg.vocab_size
        # token t+1 = (a * t + drift) % v on easy positions, noise elsewhere
        base = rng.integers(0, v, size=(self.batch, 1))
        mult = 31
        idx = np.arange(self.seq)
        toks = (base + mult * idx) % v
        noise_mask = rng.random((self.batch, self.seq)) < 0.15
        noise = rng.integers(0, v, size=(self.batch, self.seq))
        return np.where(noise_mask, noise, toks).astype(np.int32)

    def batch_at(self, step: int) -> dict:
        toks = torch.from_numpy(self._tokens(step)).to(self.device)
        out = {"tokens": toks, "labels": toks}
        cfg = self.cfg
        rng = np.random.default_rng((self.seed, step, 7))
        if cfg.vision is not None:
            out["patches"] = torch.from_numpy(rng.standard_normal(
                (self.batch, cfg.vision.n_patches, cfg.d_model),
                dtype=np.float32)).to(self.device)
        if cfg.encdec is not None:
            out["frames"] = torch.from_numpy(rng.standard_normal(
                (self.batch, cfg.encdec.encoder_seq, cfg.d_model),
                dtype=np.float32)).to(self.device)
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_batch_specs(cfg: ArchConfig, pctx) -> dict:
    """The specs of a train batch: rows over the batch axes."""
    from repro_torch.config import ShapeConfig
    from repro_torch.parallel.sharding import batch_specs
    return batch_specs(cfg, ShapeConfig("train", 0, 0, "train"), pctx)


def shard_batch(batch: dict, pctx) -> dict:
    """This rank's rows of a global ``batch``: block ``i`` of the rows for
    the rank whose ``(pod, data)`` coordinate is ``i`` in row-major order,
    the same rows on every ``model`` rank."""
    from repro_torch.parallel.sharding import Sharding, Spec
    rows = Sharding(pctx.mesh, Spec(tuple(pctx.dp_axes)))
    return {k: rows.shard(v) for k, v in batch.items()}


class Prefetcher:
    """Depth-k background prefetch (host->device overlap)."""

    def __init__(self, it, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = iter(it)
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
