"""Assigned architecture configs (``--arch <id>``).

Each module defines ``ARCH``; ``get(name)`` resolves ids with dashes or
underscores. ``ALL_ARCHS`` lists the 10 assigned ids plus the repo's own
example config (``exanest-lm-100m``).
"""

from __future__ import annotations

import importlib

ALL_ARCHS = [
    "deepseek-v3-671b",
    "granite-moe-1b-a400m",
    "mamba2-2.7b",
    "starcoder2-7b",
    "command-r-35b",
    "deepseek-7b",
    "mistral-large-123b",
    "internvl2-1b",
    "whisper-small",
    "zamba2-2.7b",
]

EXTRA_ARCHS = ["exanest-lm-100m"]


def _modname(name: str) -> str:
    return name.replace("-", "_").replace(".", "p")


def get(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{_modname(name)}")
    return mod.ARCH


def all_configs() -> dict:
    return {n: get(n) for n in ALL_ARCHS + EXTRA_ARCHS}
