"""miniFE/HPCG analog: distributed conjugate-gradient solve of a 3-D
7-point Poisson problem, the workload class the paper scales to 512 ranks
(section 6.2), with its two communication patterns: a halo exchange between
neighbouring slabs and an 8-byte sum of dot products every iteration.

Counterpart of the reference's ``examples/cg_solver.py``. The grid is cut
into slabs of planes over the ``data`` axis of a process mesh; the halo
exchange is :func:`repro_torch.core.collectives.ppermute` (the reference's
``jax.lax.ppermute`` ring, wrapped faces zeroed at the global boundary), and
each dot product's partials are summed in rank order by ``combine``
(:func:`repro_torch.parallel.tensor_parallel.sum_across`, the reference's
``psum``): one ``combine`` launch per dot product on a CUDA mesh, ``1 + 2 *
iters`` a solve. The stencil is plain torch ops, as the reference's is
plain jnp. The loop's scalars stay on the device.

Run: PYTHONPATH=src python -m repro_torch.examples.cg_solver [--n 32]
[--iters 120] [--device cpu]. On several ranks, start one process per rank
with ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` set (the
script joins a gloo group through ``env://``), or call :func:`main` in
processes that have initialised ``torch.distributed``; the slabs go over
all ranks when ``n`` divides by their number, as in the reference. Every
rank runs on the current card of ``--device cuda`` (choose it with
``CUDA_VISIBLE_DEVICES``).
"""

from __future__ import annotations

import argparse
import math
import os

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.collectives import all_gather_stack, ppermute
from repro_torch.device import resolve_device
from repro_torch.kernels.allreduce_combine.ops import combine_parts
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.tensor_parallel import sum_across

AXIS = "data"


def apply_stencil(u: torch.Tensor, halo_lo: torch.Tensor,
                  halo_hi: torch.Tensor, h2: float) -> torch.Tensor:
    """7-point Laplacian with Dirichlet boundaries; u: (nz_local, ny, nx).
    halo_lo/hi: (ny, nx) neighbour planes (zeros at the global boundary).
    ``F.pad`` lists the last dimension first: ``(0, 0, 1, 0)`` pads y."""
    up = torch.cat([halo_lo[None], u, halo_hi[None]])
    lap = (6.0 * u
           - up[:-2] - up[2:]
           - F.pad(u[:, :-1], (0, 0, 1, 0))
           - F.pad(u[:, 1:], (0, 0, 0, 1))
           - F.pad(u[:, :, :-1], (1, 0))
           - F.pad(u[:, :, 1:], (0, 1)))
    return lap / h2


def make_cg(mesh, n: int, iters: int, *, device=None):
    """``cg(b) -> (x, residual)``: ``iters`` CG iterations from x = 0 on
    this rank's slab ``b`` (n / k, n, n) of the n^3 grid, planes in rank
    order over the mesh's ``data`` axis of k ranks (the whole grid when
    ``mesh`` is None). The residual ``sqrt(r . r)`` is a 0-d tensor, the
    same on every rank. Runs on the mesh's device, else ``device``. Two
    parts of the solve are its attributes, for timing them alone:
    ``cg.pdot(a, b)`` and ``cg.halo_exchange(u) -> (lo, hi)``."""
    k = mesh.shape[AXIS] if mesh is not None else 1
    group = mesh.group(AXIS) if k > 1 else None
    dev = mesh.device if mesh is not None else resolve_device(device)
    me = mesh.coords[AXIS] if mesh is not None else 0
    h2 = (1.0 / (n + 1)) ** 2
    to_next = [(i, (i + 1) % k) for i in range(k)]
    to_prev = [(i, (i - 1) % k) for i in range(k)]

    def halo_exchange(u):
        if k == 1:
            z = torch.zeros_like(u[0])
            return z, z
        lo = ppermute(u[-1], to_next, group)   # rank i-1's last plane
        hi = ppermute(u[0], to_prev, group)    # rank i+1's first plane
        if me == 0:                             # global boundary
            lo.zero_()
        if me == k - 1:
            hi.zero_()
        return lo, hi

    def pdot(a, b):
        d = torch.vdot(a.reshape(-1), b.reshape(-1))
        return sum_across(d.reshape(1), group).reshape(()) if k > 1 else d

    def A(u):
        lo, hi = halo_exchange(u)
        return apply_stencil(u, lo, hi, h2)

    def cg(b):
        b = b.to(dev)
        x = torch.zeros_like(b)
        r = b - A(x)
        p = r
        rs = pdot(r, r)
        for _ in range(iters):
            Ap = A(p)
            alpha = rs / torch.clamp_min(pdot(p, Ap), 1e-30)
            x = x + alpha * p
            r = r - alpha * Ap
            rs_new = pdot(r, r)
            p = r + (rs_new / torch.clamp_min(rs, 1e-30)) * p
            rs = rs_new
        return x, torch.sqrt(rs)

    cg.pdot, cg.halo_exchange = pdot, halo_exchange
    return cg


def eigen_rhs(n: int, rows: tuple[int, int] | None = None, *,
              device=None) -> torch.Tensor:
    """Planes ``rows`` (default all) of the reference's right-hand side:
    the discrete Laplacian's lowest eigenfunction ``sin(pi x) sin(pi y)
    sin(pi z)`` on the interior points ``(i + 1) h``, h = 1 / (n + 1), in
    float32. The reference's meshgrid product, each axis's sine computed
    once and broadcast (the same products, without three n^3 grids)."""
    lo, hi = rows if rows is not None else (0, n)
    h = 1.0 / (n + 1)
    pts = (torch.arange(n, dtype=torch.float32, device=device) + 1) * h
    s = torch.sin(math.pi * pts)
    return s[None, None, :] * s[None, :, None] * s[lo:hi, None, None]


def eigenvalue(n: int) -> float:
    """The 7-point operator's exact eigenvalue for :func:`eigen_rhs`."""
    h = 1.0 / (n + 1)
    return 3 * (2 - 2 * math.cos(math.pi * h)) / h ** 2


def analytic_error(x: torch.Tensor, b: torch.Tensor, n: int,
                   group=None) -> float:
    """``max|x - b / lam| / max|b / lam|`` over the whole grid; on a
    ``group``, the slabs' maxima combined (``combine``, max) first."""
    expected = b / eigenvalue(n)
    m = torch.stack([(x - expected).abs().max(), expected.abs().max()])
    if group is not None:
        m = combine_parts(all_gather_stack(m, group), op="max")
    return float(m[0] / m[1])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=32, help="grid points per dim")
    ap.add_argument("--iters", type=int, default=120)
    ap.add_argument("--device", default="cuda",
                    help="torch device to solve on (default cuda)")
    args = ap.parse_args(argv)
    n = args.n

    joined = False
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE",
                                                        "1")) > 1:
        dist.init_process_group("gloo", init_method="env://")
        joined = True
    device = resolve_device(args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    mesh, rows = None, None
    try:
        if world > 1 and n % world == 0:
            mesh = make_mesh((world,), (AXIS,), device=device)
            rows = (rank * n // world, (rank + 1) * n // world)
            if rank == 0:
                print(f"slab decomposition over {world} devices")
        b = eigen_rhs(n, rows, device=device)
        x, res = make_cg(mesh, n, args.iters, device=device)(b)
        err = analytic_error(x, b, n,
                             mesh.group(AXIS) if mesh is not None else None)
        residual = float(res)
    finally:
        if joined:
            dist.destroy_process_group()
    if rank == 0:
        print(f"n={n}^3 iters={args.iters} residual={residual:.3e} "
              f"rel_err_vs_analytic={err:.3e}")
    assert err < 5e-2, "CG failed to converge to the analytic solution"
    if rank == 0:
        print("cg_solver OK")
    return {"n": n, "iters": args.iters, "ranks": world if mesh else 1,
            "residual": residual, "rel_err_vs_analytic": err}


if __name__ == "__main__":
    main()
