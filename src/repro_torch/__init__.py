"""PyTorch/CUDA port of the JAX package ``repro`` (the reference).

The port keeps the reference's module and function names and its public
layouts (caches ``(L, B, S, K, hd)``, ``wq`` ``(d, H, hd)``, ``wo``
``(H, hd, d)``) so the two can be checked against each other on identical
inputs. It imports ``torch`` and numpy only: never ``jax``, and nothing of
``repro``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`).
"""
