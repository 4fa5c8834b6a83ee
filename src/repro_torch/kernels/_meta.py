"""The kernels on the ``meta`` device, as the dry run traces them.

Each kernel on a model's path (``flash_decode``, ``ssd_scan``,
``combine``) is also a ``torch.library`` custom op under the
``repro_torch`` namespace, defined in its ``ops`` module: its fake
implementation checks the inputs as the kernel's wrapper does and returns
the kernel's output shapes and dtypes; its FLOP formula
(``torch.utils.flop_counter.register_flop_formula``) is the kernel's own
count, so ``FlopCounterMode`` counts what the kernel does; and
:data:`KERNEL_BYTES` holds the least bytes it moves, which the dry run
takes in place of its inputs plus outputs. The ``ops`` entry points send a
meta tensor there and nowhere else: never to the plain version, whose
step-by-step arithmetic is not the kernel's work. The custom op has no
implementation for any other device (CPU tensors take the plain version,
CUDA tensors the kernel, as before).
"""

from __future__ import annotations

from typing import Callable

#: op overload -> fn(*args) -> the least bytes the kernel moves
KERNEL_BYTES: dict = {}


def meta_only(name: str) -> Callable:
    """The body of a kernel's custom op off ``meta``: it raises."""
    def body(*args, **kwargs):
        raise ValueError(f"repro_torch::{name} is the {name} kernel on the "
                         "meta device; its ops entry point runs it on cpu "
                         "or cuda")
    return body
