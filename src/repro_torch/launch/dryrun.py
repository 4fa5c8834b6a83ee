"""Multi-pod dry run on ``meta`` tensors: the port's counterpart of
``repro.launch.dryrun``, a torch design rather than a copy.

For one (arch x shape x mesh) cell it builds the step the real launcher
runs and traces it on ``meta`` tensors as rank 0 of the mesh
(:class:`~repro_torch.launch.mesh.DryMesh`: no process, no allocation, the
collectives give results of the right shape and count their bytes), and
records, per rank:

* ``memory``: the bytes of the arguments, outputs, temporaries and
  donated aliases, and the peak, from the live storages a
  ``TorchDispatchMode`` tracks op by op (``peak_gb`` is the most bytes
  alive at once; ``temp_gb`` is what the reference's identity
  ``peak = argument + output + temp - alias`` leaves), and ``fits_h100``:
  the peak against the H100's 80 GiB;
* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s formulas over
  the trace's ops, each kernel counted by its own formula
  (:mod:`repro_torch.kernels._meta`);
* ``bytes_accessed``: every op's inputs plus outputs (views and empty
  allocations move nothing; a kernel its own least bytes). An upper bound
  with no fusion: the card reads what eager PyTorch reads, so a fused
  kernel would move less;
* ``collective_bytes``: each collective's output bytes on this rank, by
  kind (``all_gather``, ``all_to_all``, ``all_reduce``; the port's
  reduce-scatters are an all-to-all plus ``combine``), by the port's
  logical op and crossing pods (:func:`repro_torch.core.collectives.
  counting`);
* ``roofline``: the terms against :data:`repro_torch.roofline.hw.H100`, each
  named after the field it divides by, and ``trace_s`` in place of the
  reference's ``compile_s``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-v3-671b \\
      --shape train_4k --mesh multi --out results/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Needs no card and no process group. ``extra_flags`` takes the reference's
``cfg_overrides``, ``seq_shard`` and ``train_policy``; ``gather_weights`` is
refused: the port always gathers ``data``-sharded weights at use (ROADMAP.md
R10).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils import flop_counter
from torch.utils._pytree import tree_leaves

from repro_torch import tree as tree_util
from repro_torch.config import SHAPES, ArchConfig, ShapeConfig, cell_runnable
from repro_torch.configs import ALL_ARCHS, get
from repro_torch.core import collectives
from repro_torch.kernels._meta import KERNEL_BYTES
from repro_torch.launch.mesh import DryMesh, production_shape
from repro_torch.models import build_model
from repro_torch.parallel.ctx import make_parallel_ctx
from repro_torch.parallel.sharding import (Sharding, batch_specs, cache_specs,
                                           is_spec, opt_state_specs,
                                           param_specs)
from repro_torch.roofline.analysis import model_flops_per_step
from repro_torch.roofline.hw import H100
from repro_torch.train.loop import Trainer, make_train_step
from repro_torch.train.optimizer import AdamWConfig, adamw_init

META = torch.device("meta")
GB = 2 ** 30


def input_specs(cfg: ArchConfig, shape: ShapeConfig, model) -> dict:
    """Meta stand-ins (global shapes) for every model input of a shape
    cell: the reference's ``input_specs``."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": torch.empty((B, S), dtype=i32, device=META)}
        if shape.kind == "train":
            batch["labels"] = torch.empty((B, S), dtype=i32, device=META)
        if cfg.vision is not None:
            batch["patches"] = torch.empty((B, cfg.vision.n_patches,
                                            cfg.d_model), device=META)
        if cfg.encdec is not None:
            batch["frames"] = torch.empty((B, cfg.encdec.encoder_seq,
                                           cfg.d_model), device=META)
        return batch
    # decode: one new token against a seq_len cache
    return {"cache": model.init_cache(B, S, device=META),
            "batch": {"token": torch.empty((B,), dtype=i32, device=META),
                      "pos": torch.empty((), dtype=i32, device=META)}}


def _opt_config(cfg: ArchConfig) -> AdamWConfig:
    # int8 optimizer states once f32 m/v would not fit a 256-chip pod
    quantize = cfg.param_count() * 10 > 256 * 12e9
    return AdamWConfig(quantize_states=quantize)


def _train_policy(cfg: ArchConfig, shape: ShapeConfig, pctx) -> dict:
    """Microbatch count + grad-accumulation dtype so remat-saved layer
    inputs fit HBM: act ~= tokens/dev * d_model * n_layers * 2B / mb (the
    reference's thresholds, its policy and not a reading of any card)."""
    dp = pctx.dp_size if pctx is not None else 1
    tokens_dev = shape.global_batch * shape.seq_len // dp
    act = tokens_dev * cfg.d_model * cfg.n_layers * 2
    mb = 1
    max_mb = max(1, shape.global_batch // dp)
    while act / mb > 4e9 and mb * 2 <= min(max_mb, 16):
        mb *= 2
    opt_cfg = _opt_config(cfg)
    accum = torch.bfloat16 if opt_cfg.quantize_states else torch.float32
    return {"microbatches": mb, "accum_dtype": accum, "opt_cfg": opt_cfg}


def dry_mesh(multi_pod: bool, mesh_shape=None, rank: int = 0):
    """Rank ``rank`` of the production mesh, or of ``mesh_shape`` (two axes
    ``(data, model)``, three ``(pod, data, model)``); ``()``: one device
    and no mesh (None)."""
    if mesh_shape is None:
        return DryMesh(*production_shape(multi_pod), rank=rank)
    if not mesh_shape:
        return None
    axes = ("pod", "data", "model")[-len(mesh_shape):]
    return DryMesh(tuple(mesh_shape), axes, rank=rank)


def _mesh_label(mesh) -> str:
    if mesh is None:
        return "1"
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


def _local(tree, specs, mesh):
    """Meta leaves of this rank's blocks of ``tree``, laid out by ``specs``
    (``tree`` whole where there is no mesh)."""
    if mesh is None:
        return tree_util.tree_map(lambda t: t.new_empty(t.shape), tree)
    shards = [Sharding(mesh, s) for s in tree_util.leaves(specs,
                                                          is_leaf=is_spec)]
    return tree_util.unflatten(tree, [
        t.new_empty(sh.local_shape(t.shape)) for sh, t in
        zip(shards, tree_util.leaves(tree), strict=True)])


def _local_cache(cache, cfg: ArchConfig, shape: ShapeConfig, pctx, mesh):
    """This rank's meta blocks of a decode cell's cache as the port's own
    prefill leaves them, which is ``cache_specs``' layout but where
    attention splits over ``model`` (``gqa_tp``) on KV heads that do not
    (the reference's ``mha_ize``): there each rank holds its block of the
    KV repeated to the query heads, whole in the head dim, where
    ``cache_specs`` cuts the head dim; and an encoder-decoder's cross K/V
    lies over all of S_enc, on the rank's heads under ``gqa_tp``, else
    whole (ROADMAP.md R13, R14)."""
    from repro_torch.models.attention import (_mha_ize, _padded_heads,
                                              gqa_tp)
    local = _local(cache, cache_specs(cache, cfg, shape, pctx), mesh)
    tp = pctx.tp_size
    split = cfg.n_kv_heads > 0 and gqa_tp(cfg, pctx)
    mha = split and _mha_ize(cfg, tp)
    heads = _padded_heads(cfg) if mha else cfg.n_kv_heads
    names = [n for n, _ in tree_util.named_leaves(cache)]
    out = []
    for name, full, blk in zip(names, tree_util.leaves(cache),
                               tree_util.leaves(local)):
        parts = name.split(".")
        if parts[0] == "cross":     # the batch rows of the self cache
            rows = local["self"]["k"].shape[-4]
            K = heads // tp if split else full.shape[-2]
            blk = blk.new_empty(full.shape[:-4] + (rows, full.shape[-3], K,
                                                   full.shape[-1]))
        elif parts[-1] in ("k", "v") and mha:
            blk = blk.new_empty(blk.shape[:-2] + (heads // tp,
                                                  full.shape[-1]))
        out.append(blk)
    return tree_util.unflatten(cache, out)


@dataclasses.dataclass
class DryCell:
    """What :func:`lower_cell` lowers: functions that make the step
    (``make_fn``) and its meta arguments, this rank's blocks
    (``make_args``), with the argument positions donated as the
    reference's ``donate_argnums`` donates them. Nothing is made until
    :func:`trace` asks."""
    kind: str
    make_fn: object
    make_args: object
    donate: tuple[int, ...]
    tokens: int = 0     # the step's tokens over the whole mesh
    ranks: int = 1      # ranks of the mesh


def lower_cell(arch, shape_name, multi_pod: bool,
               extra_flags: dict | None = None, *, mesh_shape=None,
               rank: int = 0, donate: bool = True):
    """Returns (cell, meta), or (None, {"skipped": why}) for a cell
    ``cell_runnable`` skips. ``arch`` is a config id or an
    :class:`ArchConfig`, ``shape_name`` a key of ``SHAPES`` or a
    :class:`ShapeConfig`. ``extra_flags``: ``cfg_overrides``
    (``dataclasses.replace`` on the config), ``seq_shard``, ``train_policy``
    overrides. ``mesh_shape``/``rank``: the mesh rank traced (default rank
    0 of the production mesh; see :func:`dry_mesh`). ``donate=False``
    traces the functional train step (``Trainer``'s default) in place of
    the donated one."""
    flags = dict(extra_flags or {})
    if flags.get("gather_weights"):
        raise ValueError("gather_weights: the port always gathers its "
                         "data-sharded weights at use and has no switch "
                         "(ROADMAP.md R10)")
    unknown = set(flags) - {"cfg_overrides", "seq_shard", "train_policy",
                            "gather_weights"}
    if unknown:
        raise ValueError(f"unknown extra_flags {sorted(unknown)}")
    cfg = get(arch) if isinstance(arch, str) else arch
    if flags.get("cfg_overrides"):
        cfg = dataclasses.replace(cfg, **flags["cfg_overrides"])
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    ok, why = cell_runnable(cfg, shape)
    if not ok:
        return None, {"skipped": why}
    mesh = dry_mesh(multi_pod, mesh_shape, rank)
    pctx = None if mesh is None else make_parallel_ctx(mesh)
    model = build_model(cfg)
    meta = {"arch": arch if isinstance(arch, str) else cfg.name,
            "shape": shape.name, "mesh": _mesh_label(mesh),
            "params_b": cfg.param_count() / 1e9,
            "active_params_b": cfg.active_param_count() / 1e9}
    seq = bool(flags.get("seq_shard", False))
    if pctx is not None:
        pctx = dataclasses.replace(pctx, seq_shard=seq)
        if shape.kind == "decode":     # the caches' layout (kv_seq_axis)
            pctx = dataclasses.replace(pctx, decode_shape=(
                shape.global_batch, shape.seq_len))

    def params_and_specs():
        params = model.init(None, device=META)
        specs = None if pctx is None else param_specs(params, cfg, pctx)
        return params, specs

    def local_batch(batch):
        specs = None if pctx is None else batch_specs(cfg, shape, pctx)
        return _local(batch, specs, mesh)

    if shape.kind == "train":
        pol = _train_policy(cfg, shape, pctx)
        pol.update(flags.get("train_policy", {}))
        opt_cfg = pol["opt_cfg"]

        def step():
            sync = (Trainer(model, opt_cfg, pctx=pctx).make_sync()
                    if pctx is not None else None)
            return make_train_step(model, opt_cfg, pctx,
                                   microbatches=pol["microbatches"],
                                   accum_dtype=pol["accum_dtype"],
                                   sync_fn=sync, donate=donate)

        def make_args():
            params, specs = params_and_specs()
            opt = adamw_init(params, opt_cfg)
            ospecs = (None if pctx is None
                      else opt_state_specs(opt, params, cfg, pctx))
            return (_local(params, specs, mesh), _local(opt, ospecs, mesh),
                    local_batch(input_specs(cfg, shape, model)))

        cell = DryCell("train", step, make_args, (0, 1) if donate else ())
        meta["opt_quantized"] = opt_cfg.quantize_states
        meta["microbatches"] = pol["microbatches"]
        meta["accum_dtype"] = str(pol["accum_dtype"]).split(".")[-1]
        meta["seq_shard"] = seq
    elif shape.kind == "prefill":
        def prefill(p, b):
            with torch.no_grad():
                return model.prefill(p, b, pctx)

        def make_args():
            params, specs = params_and_specs()
            return (_local(params, specs, mesh),
                    local_batch(input_specs(cfg, shape, model)))

        cell = DryCell("prefill", lambda: prefill, make_args, ())
    else:  # decode
        def decode(p, c, b):
            with torch.no_grad():
                return model.decode_step(p, c, b, pctx)

        def make_args():
            params, specs = params_and_specs()
            ins = input_specs(cfg, shape, model)
            cache = (_local(ins["cache"], None, None) if pctx is None
                     else _local_cache(ins["cache"], cfg, shape, pctx, mesh))
            return (_local(params, specs, mesh), cache,
                    local_batch(ins["batch"]))

        cell = DryCell("decode", lambda: decode, make_args, (1,))
    cell.tokens = (shape.global_batch * shape.seq_len
                   if shape.kind != "decode" else shape.global_batch)
    cell.ranks = 1 if mesh is None else mesh.size
    return cell, meta


# ------------------------------------------------------------------ tracing
#: ops that allocate without writing: no bytes accessed
_NO_DATA = {"aten::empty", "aten::empty_strided", "aten::new_empty",
            "aten::new_empty_strided", "aten::empty_like"}


def _meta_tensors(tree) -> list:
    return [t for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor) and t.device.type == "meta"]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DryCounters(TorchDispatchMode):
    """The dry run's counters, op by op while it is on. Memory: each op's
    meta outputs join the live storages when first seen and leave when
    their storage is freed (a weak reference's finalizer), so ``peak`` is
    the most bytes alive at once. FLOPs: ``FlopCounterMode``'s formulas
    (``torch.utils.flop_counter.flop_registry``, where each kernel's custom
    op has its own), applied to the same ops. ``bytes_accessed``: see the
    module docstring. Per kernel: calls, FLOPs and bytes."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = self.bytes_accessed = self.flops = 0
        self._held: dict[int, int] = {}
        self.kernels: dict[str, dict] = {}

    def hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    @staticmethod
    def storages(tensors) -> dict:
        """{storage key: bytes} of ``tensors``' storages."""
        return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in tensors}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _meta_tensors(out)
        for t in outs:
            self.hold(t)
        formula = flop_counter.flop_registry.get(func._overloadpacket)
        flops = 0 if formula is None else int(formula(*args, **kwargs,
                                                      out_val=out))
        self.flops += flops
        if func in KERNEL_BYTES:
            n = KERNEL_BYTES[func](*args, **kwargs)
            k = self.kernels.setdefault(func.name().split("::")[1],
                                        {"calls": 0, "flops": 0, "bytes": 0})
            k["calls"] += 1
            k["flops"] += flops
            k["bytes"] += n
            self.bytes_accessed += n
        elif not func.is_view and func.name() not in _NO_DATA:
            ins = _meta_tensors((args, kwargs))
            self.bytes_accessed += (sum(map(_nbytes, ins))
                                    + sum(map(_nbytes, outs)))
        return out


def argument_bytes(args) -> int:
    """Bytes of the storages of ``args``' meta tensors (each once)."""
    return sum(DryCounters.storages(_meta_tensors(args)).values())


def trace(cell: DryCell) -> dict:
    """Run ``cell`` once on meta under the counters: memory, FLOPs, bytes
    accessed, collective bytes, kernels, trace seconds."""
    t0 = time.perf_counter()
    fn, args = cell.make_fn(), list(cell.make_args())
    dc = DryCounters()
    arg_tensors = _meta_tensors(args)
    for t in arg_tensors:
        dc.hold(t)
    arg_st = dc.storages(arg_tensors)
    donated = dc.storages(_meta_tensors([args[i] for i in cell.donate]))
    with dc, collectives.counting() as wire:
        out = fn(*args)
    out_st = dc.storages(_meta_tensors(out))
    argument = sum(arg_st.values())
    output = sum(out_st.values())
    alias = sum(n for key, n in out_st.items() if key in donated)
    wire = dict(wire, total=sum(wire["bytes"].values()))
    return {"argument": argument, "output": output, "alias": alias,
            "temp": dc.peak - argument - output + alias, "peak": dc.peak,
            "flops": dc.flops, "bytes_accessed": dc.bytes_accessed,
            "collectives": wire, "kernels": dc.kernels,
            "trace_s": time.perf_counter() - t0}


def roofline(flops: float, bytes_accessed: float, coll: dict, hw=H100
             ) -> dict:
    """The step's terms in seconds against ``hw``, each named after the
    field it divides by: FLOPs over ``peak_bf16_flops``, bytes accessed
    over ``hbm_bw``, the collective bytes within a pod over ``ici_links *
    ici_link_bw`` (NVLink 4 on the H100) and those crossing pods over
    ``dcn_bw``; the bottleneck is the largest."""
    cross = coll["cross_pod_bytes"]
    terms = {"peak_bf16_flops_s": flops / hw.peak_bf16_flops,
             "hbm_bw_s": bytes_accessed / hw.hbm_bw,
             "ici_link_bw_s": (coll["total"] - cross)
             / (hw.ici_links * hw.ici_link_bw),
             "dcn_bw_s": cross / hw.dcn_bw}
    bound = max(terms.values())
    return {"hw": hw.name, **terms,
            "bottleneck": max(terms, key=terms.get),
            "step_bound_s": bound,
            "compute_fraction": terms["peak_bf16_flops_s"] / bound
            if bound else 0.0}


def analyze(cell: DryCell, meta: dict) -> dict:
    """Trace ``cell`` and add its readings to ``meta`` (under the
    reference's keys where they mean the same)."""
    r = trace(cell)
    meta = dict(meta)
    meta["trace_s"] = round(r["trace_s"], 3)
    meta["memory"] = {f"{k}_gb": r[k] / GB for k in
                      ("argument", "output", "temp", "alias", "peak")}
    meta["memory"]["peak_bytes"] = r["peak"]
    meta["memory"]["argument_bytes"] = r["argument"]
    meta["fits_h100"] = r["peak"] <= H100.hbm_bytes
    meta["flops"] = r["flops"]
    meta["bytes_accessed"] = r["bytes_accessed"]
    coll = r["collectives"]
    meta["collective_bytes"] = {**coll["bytes"], "total": coll["total"],
                                "ops": coll["ops"], "by_op": coll["by_op"],
                                "cross_pod": coll["cross_pod_bytes"]}
    meta["kernels"] = r["kernels"]
    meta["roofline"] = roofline(r["flops"], r["bytes_accessed"], coll)
    model_fl = model_flops_per_step(meta, cell.kind, cell.tokens) / cell.ranks
    meta["model_flops_per_device"] = model_fl
    meta["useful_flops_ratio"] = model_fl / r["flops"] if r["flops"] else 0.0
    return meta


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             extra_flags: dict | None = None) -> dict:
    cell, meta = lower_cell(arch, shape_name, multi_pod, extra_flags)
    if cell is None:
        return meta
    return analyze(cell, meta)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ALL_ARCHS + ["exanest-lm-100m"])
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--seq-shard", action="store_true",
                    help="extra_flags seq_shard=True (train cells)")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = ALL_ARCHS if args.all else [args.arch]
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    flags = {"seq_shard": True} if args.seq_shard else None
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]
    for arch, shp, mp in cells:
        tag = (f"{arch}__{shp}__{'multi' if mp else 'single'}"
               + ("__seq" if flags else ""))
        out_path = os.path.join(args.out, tag + ".json")
        if os.path.exists(out_path):
            print(f"[skip existing] {tag}")
            continue
        print(f"[dryrun] {tag} ...", flush=True)
        try:
            res = run_cell(arch, shp, mp, flags)
        except Exception as e:  # noqa: BLE001 — record the failure
            res = {"arch": arch, "shape": shp,
                   "mesh": "2x16x16" if mp else "16x16",
                   "error": f"{type(e).__name__}: {e}"}
            print(f"  FAILED: {res['error']}", file=sys.stderr)
        with open(out_path, "w") as f:
            json.dump(res, f, indent=1, default=str)
        print(f"  -> {out_path}", flush=True)


if __name__ == "__main__":
    main()
