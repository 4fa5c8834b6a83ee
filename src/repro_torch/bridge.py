"""Trees by tree path: numpy leaves in and out of the port's trees.

Leaf names follow the reference checkpoint store's naming
(``repro.checkpoint.store._leaf_name``): dict keys joined by dots, e.g.
``dense_stack.attn.wq``, with the leading layer axis of stacked blocks kept.
So parameters made by the JAX package (``tree_flatten_with_path``, widened to
float32 numpy) load into the port one to one, and the two can be run on
identical weights. The same holds for a whole train state (parameters,
optimizer moments, step): :func:`load_train_state`, :func:`tree_to_numpy`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.device import resolve_device


def _shape_tree(model) -> dict:
    return model.init(torch.Generator(), device="meta")


def leaf_names(model) -> list[str]:
    """Sorted tree-path names of ``model``'s parameters."""
    return sorted(name for name, _ in tree_util.named_leaves(
        _shape_tree(model)))


def load_params(model, leaves: dict, device=None) -> dict:
    """Build ``model``'s parameter tree from ``leaves`` (name -> array), each
    cast to the dtype the model gives that leaf, on ``device`` (default
    cuda). Raises ``ValueError`` on a missing, extra or misshapen leaf."""
    return load_tree(_shape_tree(model), leaves, device)


# ------------------------------------------------------- whole trees / states
def tree_to_numpy(tree) -> dict:
    """name -> numpy array for every leaf of a tree of tensors, by tree
    path; bfloat16 widened to float32 (lossless), other dtypes kept."""
    out = {}
    for name, leaf in tree_util.named_leaves(tree):
        t = leaf.detach().cpu()
        out[name] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out


def load_tree(template, leaves: dict, device=None):
    """A tree shaped like ``template`` (tensors; meta gives shapes and
    dtypes) built from ``leaves`` (name -> array), each cast to its
    template leaf's dtype, on ``device`` (default cuda). Raises
    ``ValueError`` on a missing, extra or misshapen leaf."""
    device = resolve_device(device)
    spec = dict(tree_util.named_leaves(template))
    missing = sorted(spec.keys() - leaves.keys())
    extra = sorted(leaves.keys() - spec.keys())
    if missing or extra:
        raise ValueError(f"leaf names differ: missing {missing}, "
                         f"extra {extra}")
    out = []
    for name, ref in spec.items():
        arr = np.asarray(leaves[name])
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, expected "
                             f"{tuple(ref.shape)}")
        out.append(torch.tensor(arr, dtype=ref.dtype, device=device))
    return tree_util.unflatten(template, out)


def train_state_template(model, opt_cfg) -> dict:
    """``{"params", "opt"}`` of meta tensors: the train state's names,
    shapes and dtypes (the reference's ``Trainer.init_state`` layout)."""
    from repro_torch.train.optimizer import adamw_init
    params = _shape_tree(model)
    return {"params": params, "opt": adamw_init(params, opt_cfg)}


def load_train_state(model, opt_cfg, leaves: dict, device=None) -> dict:
    """A whole train state (parameters, AdamW moments, int8 ``{"q",
    "scale"}`` moments when quantized, and the step) from numpy leaves named
    ``params.*`` and ``opt.*`` as the reference's checkpoint names them."""
    return load_tree(train_state_template(model, opt_cfg), leaves, device)
