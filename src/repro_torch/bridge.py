"""Parameters by tree path: load numpy leaves into the port's parameter tree.

Leaf names follow the reference checkpoint store's naming
(``repro.checkpoint.store._leaf_name``): dict keys joined by dots, e.g.
``dense_stack.attn.wq``, with the leading layer axis of stacked blocks kept.
So parameters made by the JAX package (``tree_flatten_with_path``, widened to
float32 numpy) load into the port one to one, and the two can be run on
identical weights.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    for key, sub in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(sub, dict):
            out.update(_flatten(sub, name))
        elif sub is not None:
            out[name] = sub
    return out


def _shape_tree(model) -> dict:
    return model.init(torch.Generator(), device="meta")


def leaf_names(model) -> list[str]:
    """Sorted tree-path names of ``model``'s parameters."""
    return sorted(_flatten(_shape_tree(model)))


def load_params(model, leaves: dict, device=None) -> dict:
    """Build ``model``'s parameter tree from ``leaves`` (name -> array), each
    cast to the dtype the model gives that leaf, on ``device`` (default
    cuda). Raises ``ValueError`` on a missing, extra or misshapen leaf."""
    device = resolve_device(device)
    tree = _shape_tree(model)
    spec = _flatten(tree)
    missing = sorted(spec.keys() - leaves.keys())
    extra = sorted(leaves.keys() - spec.keys())
    if missing or extra:
        raise ValueError(f"parameter names differ: missing {missing}, "
                         f"extra {extra}")
    loaded = {}
    for name, ref in spec.items():
        arr = np.asarray(leaves[name])
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, expected "
                             f"{tuple(ref.shape)}")
        loaded[name] = torch.tensor(arr, dtype=ref.dtype, device=device)

    def rebuild(tree, prefix=""):
        out = {}
        for key, sub in tree.items():
            name = f"{prefix}.{key}" if prefix else str(key)
            out[key] = rebuild(sub, name) if isinstance(sub, dict) else (
                None if sub is None else loaded[name])
        return out

    return rebuild(tree)
