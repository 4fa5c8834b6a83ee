"""Static cost analyzer for optimized HLO text with while-loop rollup.

Motivation (verified experimentally, see EXPERIMENTS.md §Dry-run): XLA's
``compiled.cost_analysis()`` counts a while-loop body ONCE, regardless of
trip count — scan-over-layers models therefore under-report FLOPs by ~L and
collective bytes are similarly wrong. The optimized HLO text, however,
annotates every while op with ``backend_config={"known_trip_count":...}``,
so an exact rollup is possible:

  cost(computation) = own ops
                    + Σ while ops: trip x (cost(body) + cost(cond))
                    + Σ fusion ops: flops(called comp)   [bytes counted at
                      the fusion call site: operands + outputs once]

Per-op model:
* dot: 2 x out_elems x contraction_size (operand/result types resolved via
  a per-computation symbol table)
* convolution: 2 x out_elems x prod(window dims)
* collectives (incl. -start variants): output bytes, by category
* bytes: every op writes its outputs once; dot/conv/fusion/gather/scatter/
  custom-call additionally read their operands (elementwise ops inside
  fusions live in registers and are not charged)

The port's copy of the reference's ``repro.roofline.hlo_cost``, whole: the same
names, layout and float arithmetic, with its imports rewritten to
``repro_torch``. ``tests/test_torch_roofline.py`` holds the two equal.
"""

from __future__ import annotations

import dataclasses
import json
import re
from collections import defaultdict

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "c64": 8, "c128": 16,
    # 'pred' intentionally 0: the CPU backend materializes broadcast
    # iota-compare masks that Mosaic/TPU fuses into consumers — counting
    # them would charge the TPU roofline for phantom HBM traffic.
    "pred": 0,
}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_SHAPE_RE = re.compile(r"\b([a-z0-9]+)\[([0-9,]*)\]")
_OP_RE = re.compile(r"^\s*(?:ROOT\s+)?(%[\w.\-]+)\s*=\s*(.+?)\s+"
                    r"([\w\-]+)\((.*)$")
_HDR_RE = re.compile(r"^(?:ENTRY\s+)?(%[\w.\-]+)\s*\((.*?)\)\s*->")


def _shape_dims(txt: str) -> list[tuple[str, list[int]]]:
    out = []
    for m in _SHAPE_RE.finditer(txt):
        dt = m.group(1)
        if dt not in _DTYPE_BYTES:
            continue
        dims = [int(d) for d in m.group(2).split(",") if d]
        out.append((dt, dims))
    return out

def _bytes_of(txt: str) -> int:
    total = 0
    for dt, dims in _shape_dims(txt):
        n = 1
        for d in dims:
            n *= d
        total += n * _DTYPE_BYTES[dt]
    return total


def _elems_of_first(txt: str) -> tuple[list[int], int]:
    sd = _shape_dims(txt)
    if not sd:
        return [], 0
    dims = sd[0][1]
    n = 1
    for d in dims:
        n *= d
    return dims, n


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    coll_ops: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLLECTIVES})

    def add(self, other: "Cost", times: float = 1.0, bytes_too: bool = True):
        self.flops += other.flops * times
        if bytes_too:
            self.bytes += other.bytes * times
        for k in COLLECTIVES:
            self.coll[k] += other.coll[k] * times
            self.coll_ops[k] += other.coll_ops[k] * times


class HloCostModel:
    def __init__(self, hlo_text: str):
        self.computations = self._split(hlo_text)
        self._memo: dict[str, Cost] = {}
        self.entry = next((n for n, c in self.computations.items()
                           if c["entry"]), None)

    # ------------------------------------------------------------ parsing
    @staticmethod
    def _split(text: str) -> dict:
        comps: dict = {}
        cur = None
        for line in text.splitlines():
            if cur is None:
                m = _HDR_RE.match(line.strip()) if line.rstrip().endswith("{") \
                    else None
                if m:
                    cur = m.group(1)
                    comps[cur] = {"entry": line.startswith("ENTRY"),
                                  "params": m.group(2), "lines": []}
                continue
            if line.startswith("}"):
                cur = None
                continue
            comps[cur]["lines"].append(line)
        return comps

    @staticmethod
    def _symbols(comp: dict) -> dict:
        """name -> type text (for params and op results)."""
        table = {}
        # params: "name: TYPE, name2: TYPE2" (types may be tuples)
        for m in re.finditer(r"([\w.\-]+)\s*:\s*((?:\([^)]*\)|[a-z0-9]+"
                             r"\[[0-9,]*\](?:\{[^}]*\})?))",
                             comp["params"]):
            table["%" + m.group(1)] = m.group(2)
        for line in comp["lines"]:
            m = _OP_RE.match(line)
            if m:
                table[m.group(1)] = m.group(2)
        return table

    # --------------------------------------------------------------- costs
    def cost(self, name: str | None = None) -> Cost:
        name = name or self.entry
        if name in self._memo:
            return self._memo[name]
        comp = self.computations.get(name)
        total = Cost()
        self._memo[name] = total
        if comp is None:
            return total
        table = self._symbols(comp)
        for line in comp["lines"]:
            m = _OP_RE.match(line)
            if not m:
                continue
            _, out_type, op, rest = m.groups()
            out_bytes = _bytes_of(out_type)
            # ---- flops
            if op == "dot":
                out_dims, out_elems = _elems_of_first(out_type)
                contract = self._dot_contraction(line, rest, table)
                total.flops += 2.0 * out_elems * contract
                total.bytes += out_bytes + self._operand_bytes(rest, table)
            elif op == "convolution":
                _, out_elems = _elems_of_first(out_type)
                win = re.search(r"window=\{size=([\dx]+)", line)
                k = 1
                if win:
                    for d in win.group(1).split("x"):
                        k *= int(d)
                total.flops += 2.0 * out_elems * k
                total.bytes += out_bytes + self._operand_bytes(rest, table)
            elif op == "fusion":
                # Heuristics for a TPU-proxy HBM model (see see module doc +
                # EXPERIMENTS.md §Roofline methodology):
                # * dynamic-update-slice fusions alias in place: traffic is
                #   ~2x the update slice (read-modify-write), not the buffer;
                # * pure layout fusions (copy/transpose/convert/bitcast) are
                #   CPU-backend artifacts — TPU fuses them into consumers;
                # * slice/copy fusions read only ~output-sized windows of
                #   big operands -> cap operands at output size;
                # * reduce fusions genuinely read full operands.
                name_l = m.group(1)
                ops_b = self._operand_list_bytes(rest, table)
                if "dynamic-update-slice" in line or "dynamic_update" in line:
                    nonscalar = [b for b in ops_b if b > 256]
                    upd = min(nonscalar) if nonscalar else out_bytes
                    total.bytes += 2 * min(upd, out_bytes)
                elif re.fullmatch(r"%?[_.\d]*(copy|transpose|convert|bitcast"
                                  r"|reshape)[_.\w]*(copy|transpose|convert"
                                  r"|bitcast|reshape|fusion|[_.\d])*",
                                  name_l):
                    pass  # pure layout plumbing: fused away on TPU
                elif "reduce" in name_l:
                    total.bytes += out_bytes + sum(ops_b)
                else:
                    total.bytes += out_bytes + sum(min(b, out_bytes)
                                                   for b in ops_b)
            elif op in ("copy", "transpose", "convert", "reshape",
                        "broadcast", "iota"):
                pass  # layout/manifest ops: fused on TPU
            elif op == "custom-call":
                total.bytes += out_bytes + self._operand_bytes(rest, table)
            elif op in ("dynamic-slice", "gather"):
                # reads only the sliced/gathered rows, not the whole operand
                total.bytes += 2 * out_bytes
            elif op in ("dynamic-update-slice", "scatter"):
                # in-place aliased update: read+write of the update region
                upd = self._operand_bytes(rest, table, skip_first=True)
                total.bytes += 2 * min(upd, out_bytes)
            elif op == "while":
                body = re.search(r"body=(%[\w.\-]+)", line)
                trip = 1
                bc = re.search(r'known_trip_count[^0-9]*(\d+)', line)
                if bc:
                    trip = int(bc.group(1))
                if body:
                    total.add(self.cost(body.group(1)), times=trip)
                cond = re.search(r"condition=(%[\w.\-]+)", line)
                if cond:
                    total.add(self.cost(cond.group(1)), times=trip)
            elif any(op == k or op.startswith(k + "-") for k in COLLECTIVES):
                base = next(k for k in COLLECTIVES
                            if op == k or op.startswith(k + "-"))
                if op.endswith("-done"):
                    continue
                total.coll[base] += _bytes_of(out_type)
                total.coll_ops[base] += 1
                total.bytes += out_bytes
            elif op in ("tuple", "get-tuple-element", "parameter", "bitcast",
                        "constant", "after-all", "partition-id",
                        "replica-id"):
                pass  # aliasing / metadata ops move no HBM bytes
            else:
                total.bytes += out_bytes
            # roll up flops of called fusions (their dots, if any)
            cm = re.search(r"calls=(%[\w.\-]+)", line)
            if cm and op == "fusion":
                total.add(self.cost(cm.group(1)), bytes_too=False)
        return total

    def _dot_contraction(self, line: str, rest: str, table: dict) -> int:
        lc = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", line)
        ops = re.findall(r"%[\w.\-]+", rest.split("),")[0])
        if not lc or not ops:
            return 1
        lhs_type = table.get(ops[0], "")
        dims, _ = _elems_of_first(lhs_type)
        contract = 1
        for idx in lc.group(1).split(","):
            if idx and int(idx) < len(dims):
                contract *= dims[int(idx)]
        return contract

    @staticmethod
    def _operand_bytes(rest: str, table: dict, skip_first: bool = False
                       ) -> int:
        args = rest.split("),")[0]
        total = 0
        for i, nm in enumerate(re.findall(r"%[\w.\-]+", args)):
            if skip_first and i == 0:
                continue
            total += _bytes_of(table.get(nm, ""))
        return total

    @staticmethod
    def _operand_list_bytes(rest: str, table: dict) -> list[int]:
        args = rest.split("),")[0]
        return [_bytes_of(table.get(nm, ""))
                for nm in re.findall(r"%[\w.\-]+", args)]


def analyze_hlo(hlo_text: str) -> dict:
    model = HloCostModel(hlo_text)
    c = model.cost()
    coll_total = sum(c.coll.values())
    return {
        "flops": c.flops,
        "bytes": c.bytes,
        "collectives": {**{k: c.coll[k] for k in COLLECTIVES},
                        "ops": dict(c.coll_ops), "total": coll_total},
    }


# ------------------------------------------------- fused-attention projection
def _trip_multipliers(model: HloCostModel) -> dict:
    """Total execution multiplier of every computation, walking from ENTRY
    through while bodies (x trip count) and fusion calls (x1)."""
    mult: dict[str, float] = {}

    def walk(name: str, m: float):
        mult[name] = mult.get(name, 0.0) + m
        comp = model.computations.get(name)
        if comp is None:
            return
        for line in comp["lines"]:
            wm = re.search(r"condition=(%[\w.\-]+), body=(%[\w.\-]+)", line)
            if wm:
                t = re.search(r"known_trip_count[^0-9]*(\d+)", line)
                trip = int(t.group(1)) if t else 1
                walk(wm.group(2), m * trip)
                continue
            cm = re.search(r"calls=(%[\w.\-]+)", line)
            if cm:
                walk(cm.group(1), m)

    walk(model.entry, 1.0)
    return mult


# -------------------------------------------------- synthetic train modules
def synth_train_hlo(cfg, *, seq_len: int, batch: int = 1,
                    microbatches: int = 1, dtype: str = "bf16") -> str:
    """Parser-compatible HLO text of one *forward* training step for an
    :class:`~repro_torch.config.ArchConfig` — the compute anchor the train
    co-sim (:mod:`repro_torch.train.cosim`) feeds through :func:`analyze_hlo`
    instead of compiling a multi-hundred-B-parameter graph to read its
    text.  The module is shaped like a real scan-over-layers lowering:

    * an outer ``while`` over microbatches (``known_trip_count``),
    * nested ``while`` loops over the dense and MoE layer stacks,
    * per-layer ``dot`` ops sized from the config (attention projections,
      full-context score/value matmuls, gated MLP or top-k + shared
      experts), and the LM head per microbatch,
    * one ``all-reduce`` of the f32 gradient at ENTRY (the DP sync whose
      bucketing the co-sim searches over).

    The nested loops are exactly what ``cost_analysis()`` mis-counts and
    the while-rollup (:class:`HloCostModel`, :func:`_trip_multipliers`)
    exists to fix, so this generator doubles as their test surface.
    Backward cost is the caller's multiplier (the standard 2x forward).
    """
    d, L = cfg.d_model, cfg.n_layers
    hd = cfg.resolved_head_dim
    T = max(1, (seq_len * batch) // max(1, microbatches))
    qh, kvh = cfg.n_heads * hd, 2 * cfg.n_kv_heads * hd
    up_mult = 2 if getattr(cfg, "mlp_gated", True) else 1
    state = f"(s32[], {dtype}[{T},{d}])"
    lines: list[str] = []

    def attn(tag: str) -> list[str]:
        return [
            f"  %{tag}.wq = {dtype}[{d},{qh}]{{1,0}} constant(0)",
            f"  %{tag}.wkv = {dtype}[{d},{kvh}]{{1,0}} constant(0)",
            f"  %{tag}.wo = {dtype}[{qh},{d}]{{1,0}} constant(0)",
            f"  %{tag}.q = {dtype}[{T},{qh}]{{1,0}} dot(%x, %{tag}.wq), "
            f"lhs_contracting_dims={{1}}, rhs_contracting_dims={{0}}",
            f"  %{tag}.kv = {dtype}[{T},{kvh}]{{1,0}} dot(%x, %{tag}.wkv), "
            f"lhs_contracting_dims={{1}}, rhs_contracting_dims={{0}}",
            # per-head score/value matmuls, heads folded into the rows:
            # [H*T, hd] x [hd, T] charges the full 2*H*T*T*hd like XLA's
            # unfused lowering (causal masking discards, not skips, work)
            f"  %{tag}.qh = {dtype}[{cfg.n_heads * T},{hd}]{{1,0}} "
            f"reshape(%{tag}.q)",
            f"  %{tag}.kt = {dtype}[{hd},{T}]{{1,0}} reshape(%{tag}.kv)",
            f"  %{tag}.s = {dtype}[{cfg.n_heads * T},{T}]{{1,0}} "
            f"dot(%{tag}.qh, %{tag}.kt), "
            f"lhs_contracting_dims={{1}}, rhs_contracting_dims={{0}}",
            f"  %{tag}.vt = {dtype}[{T},{hd}]{{1,0}} reshape(%{tag}.kv)",
            f"  %{tag}.av = {dtype}[{cfg.n_heads * T},{hd}]{{1,0}} "
            f"dot(%{tag}.s, %{tag}.vt), "
            f"lhs_contracting_dims={{1}}, rhs_contracting_dims={{0}}",
            f"  %{tag}.ctx = {dtype}[{T},{qh}]{{1,0}} reshape(%{tag}.av)",
            f"  %{tag}.o = {dtype}[{T},{d}]{{1,0}} dot(%{tag}.ctx, "
            f"%{tag}.wo), lhs_contracting_dims={{1}}, "
            f"rhs_contracting_dims={{0}}",
        ]

    def mlp(tag: str, width: int, rows: int = 0) -> list[str]:
        """Gated MLP dots at hidden ``width``; ``rows`` > 0 folds a
        top-k token replication into the row dimension (MoE routing)."""
        R = rows or T
        out = []
        if rows:
            out.append(f"  %{tag}.xr = {dtype}[{R},{d}]{{1,0}} "
                       f"reshape(%x)")
        src = f"%{tag}.xr" if rows else "%x"
        out += [
            f"  %{tag}.wu = {dtype}[{d},{up_mult * width}]{{1,0}} "
            f"constant(0)",
            f"  %{tag}.wd = {dtype}[{width},{d}]{{1,0}} constant(0)",
            f"  %{tag}.up = {dtype}[{R},{up_mult * width}]{{1,0}} "
            f"dot({src}, %{tag}.wu), lhs_contracting_dims={{1}}, "
            f"rhs_contracting_dims={{0}}",
            f"  %{tag}.h = {dtype}[{R},{width}]{{1,0}} reshape(%{tag}.up)",
            f"  %{tag}.dn = {dtype}[{R},{d}]{{1,0}} dot(%{tag}.h, "
            f"%{tag}.wd), lhs_contracting_dims={{1}}, "
            f"rhs_contracting_dims={{0}}",
        ]
        return out

    def layer_comp(name: str, body_mid: list[str]) -> None:
        lines.extend([
            f"%{name} (p: {state}) -> {state} {{",
            f"  %p = {state} parameter(0)",
            f"  %i = s32[] get-tuple-element(%p), index=0",
            f"  %x = {dtype}[{T},{d}]{{1,0}} get-tuple-element(%p), index=1",
            *body_mid,
            f"  ROOT %out = {state} tuple(%i, %x)",
            "}", "",
            f"%{name}.cond (pc: {state}) -> pred[] {{",
            f"  %pc = {state} parameter(0)",
            f"  %ic = s32[] get-tuple-element(%pc), index=0",
            f"  %lim = s32[] constant(0)",
            f"  ROOT %lt = pred[] compare(%ic, %lim), direction=LT",
            "}", "",
        ])

    n_dense = cfg.n_dense_layers if cfg.moe is not None else L
    if n_dense:
        layer_comp("dense_body", attn("a") + mlp("m", cfg.d_ff))
    moe_layers = L - n_dense
    if cfg.moe is not None and moe_layers:
        m = cfg.moe
        body = attn("a") + [
            f"  %r.wg = {dtype}[{d},{m.n_experts}]{{1,0}} constant(0)",
            f"  %r.gate = {dtype}[{T},{m.n_experts}]{{1,0}} dot(%x, "
            f"%r.wg), lhs_contracting_dims={{1}}, "
            f"rhs_contracting_dims={{0}}",
        ] + mlp("e", m.d_expert, rows=m.top_k * T)
        if m.n_shared_experts:
            body += mlp("s", m.n_shared_experts * m.d_shared)
        layer_comp("moe_body", body)

    def while_line(out: str, name: str, trip: int) -> str:
        return (f"  %{out} = {state} while(%init), "
                f"condition=%{name}.cond, body=%{name}, "
                f'backend_config={{"known_trip_count":{{"n":"{trip}"}}}}')

    mb_mid = [f"  %init = {state} tuple(%i, %x)"]
    if n_dense:
        mb_mid.append(while_line("dense", "dense_body", n_dense))
    if cfg.moe is not None and moe_layers:
        mb_mid.append(while_line("moe", "moe_body", moe_layers))
    mb_mid += [
        f"  %wv = {dtype}[{d},{cfg.vocab_size}]{{1,0}} constant(0)",
        f"  %logits = {dtype}[{T},{cfg.vocab_size}]{{1,0}} dot(%x, %wv), "
        f"lhs_contracting_dims={{1}}, rhs_contracting_dims={{0}}",
    ]
    layer_comp("mb_body", mb_mid)

    P = int(cfg.param_count())
    lines.extend([
        f"ENTRY %train_step.{cfg.name if hasattr(cfg, 'name') else 'lm'} "
        f"(x0: {dtype}[{T},{d}]) -> {state} {{",
        f"  %x0 = {dtype}[{T},{d}]{{1,0}} parameter(0)",
        f"  %z = s32[] constant(0)",
        f"  %init = {state} tuple(%z, %x0)",
        f"  %mb = {state} while(%init), condition=%mb_body.cond, "
        f"body=%mb_body, "
        f'backend_config={{"known_trip_count":{{"n":"{microbatches}"}}}}',
        f"  %grads = f32[{P}]{{0}} constant(0)",
        f"  %gsync = f32[{P}]{{0}} all-reduce(%grads), to_apply=%mb_body",
        f"  ROOT %res = {state} get-tuple-element(%mb), index=0",
        "}",
    ])
    return "\n".join(lines)


def flash_block_report(hlo_text: str) -> dict:
    """Identify flash-attention block bodies (innermost while bodies that
    contain an `exponential` fusion plus >=2 dots) and report:

    * ``block_bytes``: their total rolled-up HBM traffic under this XLA
      lowering (score/probability tensors round-trip per block);
    * ``fused_bytes``: the projected traffic if the block ran as a fused
      Pallas kernel — only the non-score dot operands (q/k/v/dout tiles)
      and non-score outputs stream from HBM; everything (qc x kc)-shaped
      stays in VMEM.

    Used by the §Perf 'pallas-attention (projected)' variants.
    """
    model = HloCostModel(hlo_text)
    model.cost()
    mult = _trip_multipliers(model)
    block_bytes = 0.0
    fused_bytes = 0.0
    for name, comp in model.computations.items():
        if name not in mult:
            continue
        text = "\n".join(comp["lines"])
        n_dots = len(re.findall(r"\bdot\(", text))
        if n_dots < 2 or "exponential" not in text:
            continue
        if re.search(r"condition=", text):
            continue  # not innermost
        table = model._symbols(comp)
        own = 0.0
        fused = 0.0
        # square-chunk (score) shapes to exclude from the fused stream
        for line in comp["lines"]:
            mm = _OP_RE.match(line)
            if not mm:
                continue
            _, out_type, op, rest = mm.groups()
            if op in ("tuple", "get-tuple-element", "parameter", "constant",
                      "bitcast", "copy", "transpose", "convert", "reshape",
                      "broadcast", "iota"):
                continue
            dims, _ = _elems_of_first(out_type)
            score_like = len(dims) >= 2 and dims[-1] == dims[-2] >= 256
            ob = _bytes_of(out_type)
            if op == "dot":
                own += ob + model._operand_bytes(rest, table)
                for nm_ in re.findall(r"%[\w.\-]+",
                                      rest.split("),")[0]):
                    t = table.get(nm_, "")
                    d2, _ = _elems_of_first(t)
                    if not (len(d2) >= 2 and d2[-1] == d2[-2] >= 256):
                        fused += _bytes_of(t)
                if not score_like:
                    fused += ob
            elif op == "fusion":
                ops_b = model._operand_list_bytes(rest, table)
                own += ob + sum(min(b, ob) for b in ops_b)
                if not score_like:
                    fused += ob
            else:
                own += ob
                if not score_like:
                    fused += ob
        block_bytes += own * mult[name]
        fused_bytes += fused * mult[name]
    return {"block_bytes": block_bytes, "fused_bytes": fused_bytes,
            "savings_bytes": block_bytes - fused_bytes}
