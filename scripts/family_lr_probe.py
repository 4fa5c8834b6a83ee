"""Held-out loss of the whisper and VLM train phases by (lr, steps), on one GPU.

    python3 scripts/family_lr_probe.py

For each (arch, lr, steps) of GRID: full-width whisper-small (8 rows of 448
tokens over 1,500 stub frames) or internvl2-1b (4 rows of 256 patches and
2,048 tokens), bf16, weights drawn on the card from torch.Generator seed 0,
``Trainer.make_step`` with AdamW (warmup 4, cosine decay over the steps),
SyntheticTokens seed 0, as chip_smoke.py's whisper_train and vlm_train
phases run them. It reads the mean loss of 8 held-out batches (steps
10,000-10,007, never trained on) before the steps, after every fourth step
from the eighth, and after the last. One JSON line a run, then nvidia-smi's
card name and power limit.
"""

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: (arch, rows, tokens a row): the phases' batches
SHAPES = {"whisper-small": (8, 448), "internvl2-1b": (4, 2048)}
GRID = [("whisper-small", lr, steps) for lr, steps in
        ((1e-3, 16), (1e-3, 24), (1e-3, 32), (6e-4, 16), (6e-4, 20),
         (3e-4, 16))] + \
       [("internvl2-1b", lr, steps) for lr, steps in
        ((1e-3, 16), (6e-4, 16), (6e-4, 24), (3e-4, 16), (3e-4, 24))]


def run(arch: str, lr: float, steps: int) -> dict:
    from repro_torch.configs import get
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.train.loop import Trainer
    from repro_torch.train.optimizer import AdamWConfig
    cfg = get(arch)
    model = build_model(cfg)
    tr = Trainer(model, AdamWConfig(lr=lr, warmup_steps=4,
                                    decay_steps=steps), device="cuda")
    state = tr.init_state(torch.Generator("cuda").manual_seed(0))
    rows, seq = SHAPES[arch]
    data = SyntheticTokens(cfg, batch=rows, seq=seq, seed=0, device="cuda")
    held = [data.batch_at(i) for i in range(10_000, 10_008)]

    def held_loss():
        with torch.no_grad():
            return [float(model.loss_fn(state["params"], b)) for b in held]

    before = held_loss()
    step_fn = tr.make_step()
    losses, drops = [], {}
    t0 = time.perf_counter()
    for i in range(steps):
        new, metrics = step_fn(state, data.batch_at(i))
        state.update(new)
        del new
        losses.append(float(metrics["loss"]))
        if i + 1 >= 8 and (i + 1) % 4 == 0 and i + 1 < steps:
            drops[i + 1] = float(np.mean(before) - np.mean(held_loss()))
    after = held_loss()
    drops[steps] = float(np.mean(before) - np.mean(after))
    out = {"arch": arch, "lr": lr, "steps": steps,
           "held_out_mean_drop": drops[steps],
           "held_out_drop_by_step": drops,
           "per_batch_drop": [b - a for b, a in zip(before, after)],
           "losses": losses, "wall_s": time.perf_counter() - t0}
    del state, tr, model, held
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("family_lr_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch, lr, steps in GRID:
        print(json.dumps(run(arch, lr, steps)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
