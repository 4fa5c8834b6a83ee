"""The dry run's grid as one markdown table.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \
        --out results/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --shape \
        train_4k --mesh both --seq-shard --out results/dryrun_torch
    python3 scripts/dryrun_table.py results/dryrun_torch

One row per (arch, shape) cell that runs, each mesh's figures side by side
as ``16x16 / 2x16x16``: the per-rank peak in GiB (with ``seq_shard`` for the
train cells where that run exists), whether it fits an H100, TFLOP a rank,
the collective GB a rank by kind (all-gather, all-to-all, all-reduce), the
four roofline terms in seconds on 16x16 (against roofline/hw.py's H100
data sheet, 700 W; each named after the field it divides by), the
bottleneck and bound on both meshes, and the trace's host seconds. Then the cells
``cell_runnable`` skips, any cell that recorded an error, and the sum of
the trace seconds.
"""

import json
import sys
from pathlib import Path

MESHES = ("single", "multi")
TERMS = {"peak_bf16_flops_s": "flops", "hbm_bw_s": "hbm",
         "ici_link_bw_s": "nvlink", "dcn_bw_s": "dcn"}


def load(d: Path) -> dict:
    return {p.stem: json.loads(p.read_text())
            for p in sorted(d.glob("*.json"))}


def pair(fmt, a, b) -> str:
    return " / ".join("–" if x is None else fmt(x) for x in (a, b))


def main(argv) -> int:
    cells = load(Path(argv[1]))
    archs = sorted({k.split("__")[0] for k in cells})
    shapes = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
    print("| arch | shape | peak GiB | fits | TFLOP | all-gather GB | "
          "all-to-all GB | all-reduce GB | roofline s, 16x16: flops / hbm "
          "/ nvlink / dcn | bound | trace s |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- "
          "| --- |")
    skipped, errors, trace = [], [], 0.0
    for arch in archs:
        for shape in shapes:
            runs = [cells.get(f"{arch}__{shape}__{m}") for m in MESHES]
            if any(r is None for r in runs):
                continue
            if all("skipped" in r for r in runs):
                skipped.append(f"{arch} {shape}")
                continue
            bad = [r for r in runs if "error" in r]
            if bad:
                errors += [f"{arch} {shape} {r['mesh']}: {r['error']}"
                           for r in bad]
                continue
            seq = [cells.get(f"{arch}__{shape}__{m}__seq") for m in MESHES]
            trace += sum(r["trace_s"] for r in runs + seq if r)
            peak = pair(lambda x: f"{x:.2f}",
                        *(r["memory"]["peak_gb"] for r in runs))
            if all(seq):
                peak += " (seq " + pair(lambda x: f"{x:.2f}", *(
                    r["memory"]["peak_gb"] for r in seq)) + ")"
            coll = [r["collective_bytes"] for r in runs]
            bound = pair(lambda r: f"{TERMS[r['bottleneck']]} "
                                   f"{r['step_bound_s']:.3g}",
                         *(r["roofline"] for r in runs))
            print(f"| {arch} | {shape} | {peak} | "
                  + pair(lambda x: "yes" if x else "no",
                         *(r["fits_h100"] for r in runs)) + " | "
                  + pair(lambda x: f"{x / 1e12:.1f}",
                         *(r["flops"] for r in runs)) + " | "
                  + " | ".join(pair(lambda x: f"{x / 1e9:.2f}",
                                    *(c[k] for c in coll))
                               for k in ("all_gather", "all_to_all",
                                         "all_reduce"))
                  + " | " + " / ".join(f"{runs[0]['roofline'][t]:.3g}"
                                       for t in TERMS)
                  + f" | {bound} | "
                  + pair(lambda x: f"{x:.1f}", *(r["trace_s"] for r in runs))
                  + " |")
    print()
    print("skipped (cell_runnable): " + ", ".join(skipped))
    print("errors: " + ("; ".join(errors) if errors else "none"))
    print(f"trace seconds summed over the cells: {trace:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
