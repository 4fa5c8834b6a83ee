"""Training loop: the train-step builder and a small ``Trainer``.

Counterpart of ``repro.train.loop``. PyTorch runs eagerly, so there is no
``jit``: ``make_train_step`` returns a plain function. Gradients come from
``torch.autograd.grad`` over detached copies of the parameter leaves; the
step is functional like the reference's (new parameter and optimizer
tensors, the inputs untouched).

With a sharded :class:`~repro_torch.parallel.ctx.ParallelCtx` (a mesh with
a ``model`` axis) the state is this rank's blocks (``param_specs``,
``opt_state_specs``): the step runs the model on them, syncs as
:func:`~repro_torch.parallel.grad_sync.sync_sharded_gradients` says and
updates the blocks; the loss it reports is the mean over the batch ranks.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable

import torch

from repro_torch import tree as tree_util
from repro_torch.core.collectives import tagged
from repro_torch.device import resolve_device
from repro_torch.parallel.ctx import make_parallel_ctx
from repro_torch.parallel.grad_sync import (sync_gradients,
                                            sync_sharded_gradients)
from repro_torch.parallel.sharding import (opt_state_specs, param_shardings,
                                           param_specs, shard_tree)
from repro_torch.parallel.tensor_parallel import sum_across
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update


def _value_and_grad(model, params, batch, pctx):
    leaves = [p.detach().requires_grad_(True)
              for p in tree_util.leaves(params)]
    with torch.enable_grad():
        loss = model.loss_fn(tree_util.unflatten(params, leaves), batch, pctx)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_util.unflatten(params, list(grads))


def shardings_of(model, pctx):
    """The tree of :class:`~repro_torch.parallel.sharding.Sharding` of
    ``model``'s parameters on a sharded ``pctx``, else None."""
    if pctx is None or not pctx.sharded:
        return None
    return param_shardings(model.init(None, device="meta"), model.cfg, pctx)


def make_train_step(model, opt_cfg: AdamWConfig, pctx=None,
                    microbatches: int = 1,
                    accum_dtype: torch.dtype = torch.float32,
                    sync_fn: Callable | None = None,
                    donate: bool = False) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). With ``microbatches > 1``, gradients accumulate in
    ``accum_dtype`` over sequential slices of the batch rows. ``sync_fn``
    (grads -> grads) runs after accumulation, before the optimizer: the
    data-parallel gradient sync hook (see ``Trainer.make_step``). With
    ``donate`` the step writes the new parameters and moments into the
    given ones (``adamw_update(donate=True)``) and returns them. On a
    sharded ``pctx`` the trees are this rank's blocks and ``batch`` its
    rows; the reported loss is the mean of the batch ranks' losses."""
    shardings = shardings_of(model, pctx)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = _value_and_grad(model, params, batch, pctx)
        else:
            loss = torch.zeros((), dtype=torch.float32)
            grads = None
            for i in range(microbatches):
                mb = {k: v[i * (v.shape[0] // microbatches):
                           (i + 1) * (v.shape[0] // microbatches)]
                      for k, v in batch.items()}
                l_i, g_i = _value_and_grad(model, params, mb, pctx)
                loss = loss.to(l_i.device) + l_i
                if grads is None:
                    grads = tree_util.tree_map(
                        lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                              device=p.device), params)
                grads = tree_util.tree_map(lambda a, b: a + b.to(a.dtype),
                                           grads, g_i)
            loss = loss / microbatches
            grads = tree_util.tree_map(lambda g: g / microbatches, grads)
        with torch.no_grad(), tagged("grad_sync"):
            if sync_fn is not None:
                grads = sync_fn(grads)
            new_params, new_opt, metrics = adamw_update(grads, opt_state,
                                                        params, opt_cfg,
                                                        donate=donate,
                                                        shardings=shardings)
            if shardings is not None:
                dp = pctx.mesh.group(pctx.dp_axes)
                loss = sum_across(loss.reshape(1), dp)[0] / pctx.dp_size
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return train_step


@dataclasses.dataclass
class Trainer:
    """Minimal driver used by the launcher and the fault-tolerance tests.

    With ``mesh`` set (a :class:`repro_torch.launch.mesh.ProcessMesh`),
    gradients are synchronized across its data-parallel axes each step via
    :func:`repro_torch.parallel.grad_sync.sync_gradients` and divided by the
    DP world size (:meth:`make_sync`). ``sync_strategy="auto"`` (the
    default, as in the reference) lets the collective planner pick the
    cheapest exact sync per bucket by predicted cost; ``"flat"``,
    ``"hierarchical"`` and ``"compressed"`` name one for every bucket.
    Lossy int8 compression is never chosen silently: opt in with
    ``allow_lossy=True`` (and consider ``CompressedSync`` for error
    feedback). With ``donate=True`` each step updates the state's tensors
    in place (``make_train_step(donate=True)``): the state passed in is
    consumed, and the step's peak loses the second copy of the parameters
    and moments."""
    model: Any
    opt_cfg: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    pctx: Any = None
    mesh: Any = None
    sync_strategy: str = "auto"
    allow_lossy: bool = False
    device: Any = None
    donate: bool = False

    @property
    def sharded(self) -> bool:
        return self.pctx is not None and self.pctx.sharded

    def init_state(self, gen: torch.Generator) -> dict:
        """The full state drawn from ``gen``; on a sharded ``pctx``, this
        rank's blocks of it (the full tree is drawn on every rank, so the
        blocks are the unsharded model's)."""
        params = self.model.init(gen, device=resolve_device(self.device))
        return self.shard_state({"params": params,
                                 "opt": adamw_init(params, self.opt_cfg)})

    def shard_state(self, state: dict) -> dict:
        """A full train state cut to this rank's blocks on a sharded
        ``pctx`` (as it is otherwise)."""
        if not self.sharded:
            return state
        cfg, mesh = self.model.cfg, self.pctx.mesh
        params, opt = state["params"], state["opt"]
        return {"params": shard_tree(params, param_specs(params, cfg,
                                                         self.pctx), mesh),
                "opt": shard_tree(opt, opt_state_specs(opt, params, cfg,
                                                       self.pctx), mesh)}

    def make_sync(self) -> Callable:
        """The mesh's gradient sync, grads -> grads: ``sync_gradients`` with
        ``sync_strategy`` and ``allow_lossy`` over the :class:`ParallelCtx`
        of the mesh, the sum divided by its DP size; on a sharded ``pctx``,
        ``sync_sharded_gradients`` over its mesh."""
        if self.sharded:
            return functools.partial(
                sync_sharded_gradients,
                shardings=shardings_of(self.model, self.pctx),
                mesh=self.pctx.mesh, strategy=self.sync_strategy,
                mean_over=self.pctx.dp_size, allow_lossy=self.allow_lossy)
        ctx = make_parallel_ctx(self.mesh)
        if not ctx.dp_axes:
            raise ValueError(
                "Trainer(mesh=...) synchronizes over DP axes named "
                f"'data'/'pod'; mesh has {self.mesh.axis_names}")
        return functools.partial(sync_gradients, mesh=ctx.mesh,
                                 strategy=self.sync_strategy,
                                 mean_over=ctx.dp_size,
                                 allow_lossy=self.allow_lossy)

    def make_step(self, sync_fn: Callable | None = None) -> Callable:
        """``fn(state, batch) -> (state, metrics)``. ``sync_fn`` replaces the
        mesh's :meth:`make_sync` (e.g. a ``CompressedSync`` carrying error
        feedback between steps)."""
        if sync_fn is None and (self.mesh is not None or self.sharded):
            sync_fn = self.make_sync()
        step = make_train_step(self.model, self.opt_cfg, self.pctx,
                               sync_fn=sync_fn, donate=self.donate)

        def fn(state, batch):
            p, o, m = step(state["params"], state["opt"], batch)
            return {"params": p, "opt": o}, m

        return fn

    def fit(self, state, data_iter, n_steps: int, *, log_every: int = 10,
            callback=None) -> tuple[dict, list]:
        step_fn = self.make_step()
        history = []
        t0 = time.perf_counter()
        for i, batch in enumerate(data_iter):
            if i >= n_steps:
                break
            state, metrics = step_fn(state, batch)
            if i % log_every == 0 or i == n_steps - 1:
                loss = float(metrics["loss"])
                history.append({"step": i, "loss": loss,
                                "t": time.perf_counter() - t0})
                if callback:
                    callback(history[-1])
        return state, history
