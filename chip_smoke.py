#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is non-zero:

1. env      nvidia-smi's card name and power limit, torch and CUDA versions.
2. build    builds the flash_decode kernel from its CUDA source with nvcc
            (into build/kernels/) and reports the seconds and ptxas' report.
3. kernels  holds the kernel against its plain PyTorch version on the card:
            the reference package's three test shapes (f32 1e-4, bf16 2e-2),
            the serving shape B=8 H=12 K=4 d=64 S=2048 in bf16 and a ragged
            S=1000, each with per-row lengths in [1, S] (1 and S included) and
            a NaN-poisoned tail past each row's length; then times kernel,
            plain version and one library call (scaled_dot_product_attention,
            a yardstick the port never calls) at the serving shape against the
            least time the card could take.
4. serve    the port's main path: full-width exanest-lm-100m in bf16 with
            random weights from torch.Generator seed 0, ServeEngine(slots=8,
            window=2048), 16 requests with prompt lengths 64-1024 (numpy seed
            0) and 32 new tokens each. Checks 16/16 done with every token in
            the vocabulary, that flash_decode launched once per layer per
            decode_step, and the kernel against the plain version on the
            engine's own layer-0 cache taken mid-run.
5. profile  8 of the engine's decode_step calls under torch.profiler:
            device time per step by kernel and the device's idle share (the
            trace goes to chiprun_out/decode_step_trace.json).

Then one {"kernels": [...]} line, nvidia-smi's name/power line, and last
{"ok": true, "device": {...}}. Needs torch with CUDA and nvcc; writes the
same lines to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
TPU_SRC = "src/repro/kernels/flash_decode/kernel.py:55"
KERNEL_SRC = "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu"
SERVE_SHAPE = dict(B=8, H=12, K=4, dk=64, dv=64, S=2048)
LINES: list[dict] = []


def emit(obj: dict) -> None:
    LINES.append(obj)
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 48, batches: int = 7) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a CUDA
    graph, replayed ``batches`` times between CUDA events; the median replay
    over ``reps``. A graph replay has no host work between launches, so this
    is the time on the card, not the Python wrapper's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def time_eager_ms(fn, reps: int = 200) -> float:
    """Wall time of one eager ``fn()`` call, host work included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def ptxas_report(log: str) -> list[str]:
    """``kernel<dtype,dk[,dv]>: registers, shared memory`` per compiled
    kernel, from nvcc's -Xptxas=-v output; empty when the library was
    already built. Spills are listed when there are any."""
    out, entry = [], "?"
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            # mangled name: ...fd_split_kernelI13__nv_bfloat16Li64ELi64EE...
            m = re.search(r"(fd_[a-z]+_kernel)I(13__nv_bfloat16|f)((?:Li\d+E)+)",
                          ln)
            if m:
                dtype = "bf16" if m[2] != "f" else "f32"
                dims = ",".join(re.findall(r"Li(\d+)E", m[3]))
                entry = f"{m[1]}<{dtype},{dims}>"
            else:
                entry = ln.strip()
        elif "Used" in ln:
            out.append(f"{entry}: {ln.split(':', 1)[1].strip()}")
        elif "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" \
                not in ln:
            out.append(f"{entry}: {ln.strip()}")
    return out


def profile_summary(prof, steps: int, wall_s: float, smi: str) -> dict:
    """Device time per decode step by kernel, from the profiler's CUDA-side
    entries; the idle share is the wall time no kernel ran."""
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((e.key, us / 1e3 / steps, e.count / steps))
    if not kernels:
        raise AssertionError("the profiler traced no device time")
    kernels.sort(key=lambda x: -x[1])
    busy = sum(ms for _, ms, _ in kernels)
    wall_ms = wall_s / steps * 1e3
    fd_ms = sum(ms for name, ms, _ in kernels if "fd_" in name)
    return {"phase": "profile", "steps": steps, "ms_per_step_wall": wall_ms,
            "device_busy_ms_per_step": busy, "idle_share": 1 - busy / wall_ms,
            "kernels_per_step": sum(n for *_, n in kernels),
            "flash_decode_ms_per_step": fd_ms,
            "top": [[name[:80], ms, n] for name, ms, n in kernels[:8]],
            "card": smi}


def make_case(B, H, K, dk, dv, S, dtype, seed):
    """q, k, v on the card; lengths per row in [1, S] with 1 and S present;
    NaN past each row's length in the kernel's copy of k and v."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    q = torch.from_numpy(rng.standard_normal((B, H, dk), np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, K, dk), np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, K, dv), np.float32))
    q, k, v = (t.to(dev, dtype) for t in (q, k, v))
    lengths = rng.integers(1, S + 1, B)
    lengths[0] = 1
    if B > 1:
        lengths[1] = S
    lengths = torch.from_numpy(lengths.astype(np.int32)).to(dev)
    live = torch.arange(S, device=dev)[None, :] < lengths[:, None].long()
    kp = k.masked_fill(~live[:, :, None, None], float("nan"))
    vp = v.masked_fill(~live[:, :, None, None], float("nan"))
    return q, k, v, kp, vp, lengths


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.flash_decode.ops import decode_attn, hbm_bytes
    from repro_torch.kernels.flash_decode.ref import decode_attention_ref
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)

    # ------------------------------------------------------------- 1. env
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": kind,
          "sms": torch.cuda.get_device_properties(0).multi_processor_count})

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    fd.build()
    build_s = time.perf_counter() - t0
    log = _build.build_logs.get("flash_decode", "")
    emit({"phase": "build", "seconds": build_s,
          "library": str(_build.library_path("flash_decode", fd.SOURCES)
                         .relative_to(ROOT)),
          "ptxas": ptxas_report(log)})

    # --------------------------------------------------------- 3. kernels
    cases = [  # (label, B, H, K, dk, dv, S)
        ("jax-test-1", 2, 8, 2, 64, 64, 512),
        ("jax-test-2", 1, 4, 4, 128, 128, 1024),
        ("jax-test-3", 2, 8, 1, 64, 128, 256),
    ]
    checks = []
    for i, (label, B, H, K, dk, dv, S) in enumerate(cases):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            checks.append((label, B, H, K, dk, dv, S, dtype, tol, 10 + i))
    sv = SERVE_SHAPE
    checks.append(("serving", sv["B"], sv["H"], sv["K"], sv["dk"], sv["dv"],
                   sv["S"], torch.bfloat16, 2e-2, 20))
    checks.append(("ragged-S1000", sv["B"], sv["H"], sv["K"], sv["dk"],
                   sv["dv"], 1000, torch.bfloat16, 2e-2, 21))
    results = []
    for label, B, H, K, dk, dv, S, dtype, tol, seed in checks:
        q, k, v, kp, vp, lengths = make_case(B, H, K, dk, dv, S, dtype, seed)
        got = decode_attn(q, kp, vp, lengths)
        want = decode_attention_ref(q, k, v, lengths)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = bool(torch.isfinite(got).all().item()) and err <= tol
        results.append({"case": label, "dtype": str(dtype).split(".")[-1],
                        "shape": [B, H, K, dk, dv, S], "max_err": err,
                        "tol": tol, "ok": ok})
        if not ok:
            emit({"phase": "kernels", "checks": results})
            raise AssertionError(f"flash_decode disagrees on {label}: "
                                 f"err {err} > tol {tol}")
    serve_err = max(r["max_err"] for r in results if r["dtype"] == "bfloat16"
                    and r["case"] in ("serving", "ragged-S1000"))

    # timings at the serving shape; eight distinct caches (~134 MB, ~63 MB of
    # it live) in turn, so each launch finds its cache cold in the 50 MB L2,
    # as a decode step's twelve layers do
    B, H, K, dk, dv, S = (sv[x] for x in ("B", "H", "K", "dk", "dv", "S"))
    sets = [make_case(B, H, K, dk, dv, S, torch.bfloat16, 30 + j)
            for j in range(8)]
    lengths = sets[0][5]
    sets = [(q, k, v) for q, k, v, *_ in sets]
    turn = {"i": 0}

    def nxt():
        turn["i"] = (turn["i"] + 1) % len(sets)
        return sets[turn["i"]]

    kernel_ms = time_ms(lambda: decode_attn(*nxt(), lengths))
    kernel_eager_ms = time_eager_ms(lambda: decode_attn(*nxt(), lengths))
    plain_ms = time_ms(lambda: decode_attention_ref(*nxt(), lengths), reps=16)
    mask = (torch.arange(S, device="cuda")[None, :]
            < lengths[:, None].long())[:, None, None, :]

    def library_call():
        q, k, v = nxt()
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    try:
        library_ms = time_ms(library_call, reps=16)
        library_note = "scaled_dot_product_attention(enable_gqa=True, bool mask)"
    except TypeError as exc:          # a torch without enable_gqa
        library_ms, library_note = None, f"not available: {exc}"
    lens = lengths.cpu().tolist()
    nbytes = hbm_bytes(lens, H, K, dk, dv, dtype_bytes=2)
    flops = sum(lens) * H * 2 * (dk + dv)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    emit({"phase": "kernels", "checks": results, "timing_shape":
          dict(sv, lengths=lens), "n_splits": fd.num_splits(
              B, K, H // K, S, torch.cuda.get_device_properties(0)
              .multi_processor_count),
          "kernel_us": kernel_ms * 1e3,
          "kernel_eager_us": kernel_eager_ms * 1e3, "ref_us": plain_ms * 1e3,
          "library_us": None if library_ms is None else library_ms * 1e3,
          "library": library_note, "bound_us": bound_ms * 1e3,
          "bound_bytes": nbytes, "bound_flops": flops,
          "achieved_GBps": nbytes / (kernel_ms * 1e-3) / 1e9,
          "card": smi})

    # ----------------------------------------------------------- 4. serve
    cfg = get("exanest-lm-100m")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    warm = ServeEngine(model, params, slots=2, window=64, device="cuda")
    warm.submit([1, 2, 3], max_new_tokens=2)
    warm.run_until_idle()
    del warm
    eng = ServeEngine(model, params, slots=8, window=2048, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 1025, 16)]
    torch.cuda.synchronize()
    fd.launches = 0
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=32) for p in prompts]
    eng.run_until_idle(max_steps=16)          # mid-decode of the first wave
    k0 = eng.cache["dense"]["k"][0].clone()
    v0 = eng.cache["dense"]["v"][0].clone()
    pos0 = eng.pos.copy()
    eng.run_until_idle(max_steps=100000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fd.launches
    calls = eng.decode_calls
    outs = [eng.result(r) for r in rids]
    done = sum(o is not None and len(o) == 32 for o in outs)
    if done != 16:
        raise AssertionError(f"served {done}/16 requests")
    if not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        raise AssertionError("a generated token lies outside the vocabulary")
    if launches != cfg.n_layers * calls or calls == 0:
        raise AssertionError(f"flash_decode launched {launches} times over "
                             f"{calls} decode_step calls; expected "
                             f"{cfg.n_layers} per call")
    lens0 = torch.from_numpy(np.minimum(pos0 + 1, 2048).astype(np.int32)).cuda()
    q0 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, cfg.n_heads, cfg.resolved_head_dim), np.float32)).cuda().bfloat16()
    got = decode_attn(q0, k0, v0, lens0)
    want = decode_attention_ref(q0, k0, v0, lens0)
    cache_err = (got.float() - want.float()).abs().max().item()
    if not cache_err <= 2e-2:
        raise AssertionError(f"flash_decode on the engine's cache: err "
                             f"{cache_err} > 2e-2")
    n_tok = sum(len(o) for o in outs)
    prompt_tok = sum(len(p) for p in prompts)
    emit({"phase": "serve", "arch": cfg.name, "dtype": cfg.dtype,
          "slots": 8, "window": 2048, "requests": 16, "done": done,
          "prompt_tokens": prompt_tok, "new_tokens": n_tok,
          "decode_step_calls": calls, "flash_decode_launches": launches,
          "wall_s": wall, "ms_per_decode_step": wall / calls * 1e3,
          "tok_per_s": (prompt_tok + n_tok) / wall,
          "new_tok_per_s": n_tok / wall,
          "engine_cache_check": {"lengths": lens0.cpu().tolist(),
                                 "max_err": cache_err, "tol": 2e-2},
          "first_tokens": outs[0][:8], "card": smi})

    # --------------------------------------------------------- 5. profile
    # where a decode_step's time goes: the engine's own call (decode_step on
    # its cache at the mid-run positions, logits back to the host), traced
    batch = {"token": torch.zeros(8, dtype=torch.int32, device="cuda"),
             "pos": torch.from_numpy(pos0).cuda()}

    def one_step():
        lg, _ = model.decode_step(params, eng.cache, batch)
        lg[:, 0].float().cpu()

    for _ in range(3):
        one_step()
    torch.cuda.synchronize()
    n_prof = 8
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            one_step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    emit(profile_summary(prof, n_prof, prof_wall, smi))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out_dir / "decode_step_trace.json"))

    # ---------------------------------------------------------- summary
    emit({"kernels": [{
        "name": "flash_decode", "route": "cuda", "source": KERNEL_SRC,
        "replaces": TPU_SRC, "launches": launches,
        "max_abs_err": max(r["max_err"] for r in results),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "tpu_src": TPU_SRC, "max_err": serve_err, "tol": 2e-2,
        "kernel_us": kernel_ms * 1e3, "ref_us": plain_ms * 1e3,
        "library_us": None if library_ms is None else library_ms * 1e3,
        "bound_us": bound_ms * 1e3,
        "launches_per_decode_step": launches / calls}]})
    (out_dir / "chip_smoke.json").write_text(json.dumps(LINES, indent=1))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
