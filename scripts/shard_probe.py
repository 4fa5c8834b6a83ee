"""Where the port's sharded steps spend their time, on one GPU.

    python3 scripts/shard_probe.py

Eight processes (spawn) on a (pod 2, data 2, model 2) mesh over gloo, all
on cuda:0, run full-width exanest-lm-100m as chip_smoke.py's shard phase
does: two sharded train steps of a global batch 8 x 512, then a prefill of
500 tokens and three decode steps. Around each, every all-gather and
all-to-all of ``repro_torch.core.collectives`` is counted and timed (bytes
in, seconds, the card synchronized on both sides). Then a bare all-gather
over ``data`` of 24 MB and of 1 KB, five times each. Rank 0 prints one
JSON line, then nvidia-smi's card name and power limit.
"""

import collections
import datetime
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402


def worker(rank: int, port: int) -> None:
    import torch.distributed as dist
    import torch.nn.functional as F

    import repro_torch.core.collectives as C
    import repro_torch.parallel.tensor_parallel as TP
    from repro_torch import tree as tree_util
    from repro_torch.configs import get
    from repro_torch.data.pipeline import SyntheticTokens, shard_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel.ctx import make_parallel_ctx
    from repro_torch.train.loop import Trainer
    from repro_torch.train.optimizer import AdamWConfig

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=8, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    stats = collections.defaultdict(lambda: [0, 0, 0.0])

    def timed(name):
        f = getattr(C, name)

        def g(x, group, *a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = f(x, group, *a, **k)
            torch.cuda.synchronize()
            s = stats[name]
            s[0] += 1
            s[1] += x.numel() * x.element_size()
            s[2] += time.perf_counter() - t
            return out

        setattr(C, name, g)

    timed("all_gather_stack")
    timed("all_to_all")
    TP.all_gather_stack = C.all_gather_stack

    def record(label, fn):
        stats.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        rec[label] = {"wall_s": time.perf_counter() - t,
                      **{k: dict(zip(("calls", "bytes_in", "seconds"), v))
                         for k, v in stats.items()}}
        return out

    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device=dev)
    pctx = make_parallel_ctx(mesh)
    cfg = get("exanest-lm-100m")
    model = build_model(cfg)
    tr = Trainer(model, AdamWConfig(lr=1e-3, warmup_steps=1), pctx=pctx,
                 device=dev)
    state = tr.init_state(torch.Generator(dev).manual_seed(0))
    data = SyntheticTokens(cfg, batch=8, seq=512, device=dev)
    step = tr.make_step()
    rec: dict = {}
    for i in range(2):
        state, _ = record(f"train_step_{i}", lambda: step(
            state, shard_batch(data.batch_at(i), pctx)))
    local = shard_batch(data.batch_at(5), pctx)["tokens"]
    with torch.no_grad():
        _, caches = model.prefill(state["params"],
                                  {"tokens": local[:, :500]}, pctx)
        caches = tree_util.tree_map(
            lambda t: F.pad(t, (0, 0, 0, 0, 0, 12)).contiguous(), caches)
        for i in range(3):
            _, caches = record(f"decode_step_{i}", lambda: model.decode_step(
                state["params"], caches,
                {"token": local[:, 500 + i], "pos": 500 + i}, pctx))
    for n in (12_000_000, 512):
        x = torch.ones(n, dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        for _ in range(5):
            C.all_gather_stack(x, mesh.group("data"))
        torch.cuda.synchronize()
        rec[f"bare_gather_over_data_{2 * n}_B_s"] = (time.perf_counter()
                                                     - t) / 5
    if rank == 0:
        print(json.dumps(rec), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("shard_probe: no CUDA device", file=sys.stderr)
        return 1
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.multiprocessing.start_processes(worker, args=(port,), nprocs=8,
                                          join=True, start_method="spawn")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
