"""Integrity-checked, atomic, optionally asynchronous checkpoint store.

Counterpart of ``repro.checkpoint.store`` with the **same on-disk format**,
so checkpoints cross frameworks both ways: a directory ``step-%08d`` holding
one ``.npy`` per leaf, named by tree path (:mod:`repro_torch.tree`: sorted
dict keys joined by dots, ``None`` subtrees skipped), and a
``manifest.json`` with each leaf's shape, original dtype and the sha256 of
the saved bytes. bfloat16 leaves are widened losslessly to float32 on disk
with ``"dtype": "bfloat16"`` in the manifest. A save writes into ``.tmp-N``
and commits with one rename. A sharded tree (this rank's blocks, with a
tree of :class:`~repro_torch.parallel.sharding.Sharding`) is saved whole:
every leaf gathered, rank 0 writing; a restore with ``shardings`` cuts
each rank's block, so a checkpoint taken on one mesh restores onto another
(``runtime.fault.elastic_reshard``).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from repro_torch import tree as tree_util

#: torch dtype -> the numpy dtype name the reference's manifest records
_DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16",
               torch.float16: "float16", torch.float64: "float64",
               torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
               torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}


def _sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()


def to_numpy(x) -> tuple[np.ndarray, str]:
    """``(array as saved, original dtype name)``: bf16 widened to float32."""
    if isinstance(x, torch.Tensor):
        name = _DTYPE_NAME[x.dtype]
        t = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy(), name
    arr = np.asarray(x)
    return arr, str(arr.dtype)


def save_checkpoint(path: str, step: int, tree, *, extra: dict | None = None,
                    shardings=None) -> str:
    """Atomic checkpoint write; returns the committed directory. With
    ``shardings`` (a tree of ``Sharding`` shaped like ``tree``), ``tree``
    holds this rank's blocks: every rank gathers each leaf (a collective),
    rank 0 writes, and every rank returns once the checkpoint is
    committed."""
    if shardings is not None:
        import torch.distributed as dist
        shards = tree_util.leaves(shardings, is_leaf=_is_sharding)
        mesh = shards[0].mesh if shards else None
        full = [s.gather(x) for s, x in zip(shards, tree_util.leaves(tree),
                                             strict=True)]
        final = os.path.join(path, f"step-{step:08d}")
        if mesh is None or mesh.rank == 0:
            final = save_checkpoint(path, step,
                                    tree_util.unflatten(tree, full),
                                    extra=extra)
        del full
        dist.barrier()
        return final
    tmp = os.path.join(path, f".tmp-{step}")
    final = os.path.join(path, f"step-{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for name, leaf in tree_util.named_leaves(tree):
        arr, orig_dtype = to_numpy(leaf)
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"][name] = {
            "shape": list(arr.shape), "dtype": orig_dtype,
            "sha256": _sha256(arr),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for d in os.listdir(path)
             if (m := re.fullmatch(r"step-(\d+)", d))]
    return max(steps) if steps else None


def _is_sharding(x) -> bool:
    from repro_torch.parallel.sharding import Sharding
    return isinstance(x, Sharding)


def restore_checkpoint(path: str, step: int, template, *, device=None,
                       verify: bool = True, shardings=None):
    """Restore into the structure of ``template`` (a tree of tensors; meta
    tensors give shapes and dtypes only). Each leaf takes its template's
    dtype and goes to ``device``, or else to its template's device. With
    ``shardings`` (a tree of ``Sharding`` shaped like ``template``, whose
    leaves hold the global shapes) each leaf is this rank's block, on the
    mesh's device unless ``device`` says otherwise.
    Returns (tree, manifest); raises ``IOError`` on a sha256 mismatch."""
    shards = (tree_util.leaves(shardings, is_leaf=_is_sharding)
              if shardings is not None else None)
    d = os.path.join(path, f"step-{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    for i, (name, tmpl) in enumerate(tree_util.named_leaves(template)):
        arr = np.load(os.path.join(d, name + ".npy"))
        meta = manifest["leaves"][name]
        if verify and _sha256(arr) != meta["sha256"]:
            raise IOError(f"checkpoint corruption in leaf {name}")
        if list(arr.shape) != list(tmpl.shape):
            raise ValueError(f"{name}: checkpoint shape {list(arr.shape)}, "
                             f"template {list(tmpl.shape)}")
        dev = (device if device is not None else
               shards[i].mesh.device if shards is not None else tmpl.device)
        t = torch.from_numpy(np.array(arr))         # a copy; 0-d stays 0-d
        if shards is not None:
            t = shards[i].shard(t)
        out.append(t.to(device=dev, dtype=tmpl.dtype))
    return tree_util.unflatten(template, out), manifest


class CheckpointStore:
    """Async (background-thread) checkpointing with a bounded queue of one
    in-flight save: training never blocks on I/O longer than one save."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        self._pending: threading.Thread | None = None
        os.makedirs(path, exist_ok=True)

    def save_async(self, step: int, tree, extra=None):
        self.wait()
        # copy to the host NOW so training can replace buffers after we return
        host = tree_util.tree_map(
            lambda x: x.detach().to("cpu", copy=True)
            if isinstance(x, torch.Tensor) else np.asarray(x), tree)
        self._pending = threading.Thread(
            target=self._save, args=(step, host, extra), daemon=True)
        self._pending.start()

    def _save(self, step, tree, extra):
        save_checkpoint(self.path, step, tree, extra=extra)
        self._gc()

    def _gc(self):
        steps = sorted(int(d.split("-")[1]) for d in os.listdir(self.path)
                       if d.startswith("step-"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step-{s:08d}"),
                          ignore_errors=True)

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
