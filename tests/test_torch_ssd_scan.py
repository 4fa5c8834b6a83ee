"""The port's SSD scan against the JAX reference, on the CPU.

Same numpy inputs into both: the port's plain version (``ssd_ref``, the
sequential recurrence) against the reference's ``ssd_ref`` and its Pallas
kernel in interpret mode, at the reference's kernel test shapes; the
model's SSD route (:class:`repro_torch.models.ssm.SSDFunction`) and its
gradients against ``jax.grad`` of the reference's float32
``ssd_chunked``; the entry point's device dispatch, the route's padding of
a ragged length, and the bound's byte and operation counts. The CUDA kernel
itself is checked on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ops import ssd, ssd_cost
from repro_torch.kernels.ssd_scan.ref import ssd_ref
from repro_torch.models import ssm

JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, l, h, p, n, seed, g=1):
    """x, dt (post-softplus), A (<0), B, C as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h), np.float32)))
    A = -np.exp(rng.standard_normal(h).astype(np.float32) * 0.3)
    B = rng.standard_normal((b, l, g, n), np.float32)
    C = rng.standard_normal((b, l, g, n), np.float32)
    return x, dt.astype(np.float32), A, B, C


def _to_jax(arrs, dtype):
    x, dt, A, B, C = arrs
    jd = JD[dtype]
    return (jnp.asarray(x).astype(jd), jnp.asarray(dt), jnp.asarray(A),
            jnp.asarray(B).astype(jd), jnp.asarray(C).astype(jd))


def _to_torch(arrs, dtype):
    x, dt, A, B, C = arrs
    td = TD[dtype]
    return (torch.from_numpy(x).to(td), torch.from_numpy(dt),
            torch.from_numpy(A), torch.from_numpy(B).to(td),
            torch.from_numpy(C).to(td))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol * 10, err_msg=msg)


# (b, l, h, p, n, chunk, hb): tests/test_kernels.py::test_ssd_scan's shapes
SHAPES = [(2, 128, 8, 16, 16, 32, 4), (1, 256, 4, 32, 64, 64, 4),
          (2, 64, 16, 16, 32, 64, 8)]
# the reference's kernel tolerances: f32 summation order; bf16 inputs
TOL = {"float32": 1e-4, "bfloat16": 6e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_ssd_ref_matches_reference_ref_and_pallas_kernel(shape, dtype):
    b, l, h, p, n, chunk, hb = shape
    arrs = _inputs(b, l, h, p, n, seed=sum(shape))
    jargs = _to_jax(arrs, dtype)
    j_y, j_st = jax_ssd_ref(*jargs)
    k_y, k_st = jax_ssd_scan(*jargs, chunk=chunk, head_block=hb,
                             interpret=True)
    t_y, t_st = ssd(*_to_torch(arrs, dtype), chunk=chunk)
    assert t_y.dtype == torch.float32 and t_y.shape == (b, l, h, p)
    assert t_st.dtype == torch.float32 and t_st.shape == (b, h, p, n)
    tol = TOL[dtype]
    _close(t_y, j_y, tol, "y vs ssd_ref")
    _close(t_st, j_st, tol, "state vs ssd_ref")
    _close(t_y, k_y, tol, "y vs the Pallas kernel")
    _close(t_st, k_st, tol, "state vs the Pallas kernel")


@pytest.mark.parametrize("l,chunk", [(64, 16), (40, 16)])
def test_ssd_route_grads_match_reference_chunked_form(l, chunk):
    """Forward and gradients of the model's SSD route (CPU: ``ssd_chunked``
    forward, float32 chunked backward) against ``jax.value_and_grad`` of
    the reference's float32 ``ssd_chunked``, ragged length included, with
    cotangents on both outputs."""
    b, h, p, n = 2, 4, 8, 16
    arrs = _inputs(b, l, h, p, n, seed=l)
    rng = np.random.default_rng(99)
    gy = rng.standard_normal((b, l, h, p), np.float32)
    gst = rng.standard_normal((b, h, p, n), np.float32)

    def jf(*args):
        y, st = jax_ssd_chunked(*args, chunk=chunk)
        return jnp.sum(y * gy) + jnp.sum(st * gst), (y, st)

    (_, (j_y, j_st)), j_g = jax.value_and_grad(
        jf, argnums=(0, 1, 2, 3, 4), has_aux=True)(*_to_jax(arrs, "float32"))
    targs = [t.requires_grad_(True) for t in _to_torch(arrs, "float32")]
    t_y, t_st = ssm.ssd(*targs, chunk)
    ((t_y * torch.from_numpy(gy)).sum()
     + (t_st * torch.from_numpy(gst)).sum()).backward()
    _close(t_y, j_y, 1e-4, "y")
    _close(t_st, j_st, 1e-4, "state")
    for name, t, g in zip(("x", "dt", "A", "B", "C"), targs, j_g):
        scale = max(1.0, float(np.abs(np.asarray(g)).max()))
        np.testing.assert_allclose(t.grad.numpy() / scale,
                                   np.asarray(g) / scale, rtol=1e-4,
                                   atol=1e-4, err_msg=f"d{name}")


def test_ssd_route_grads_keep_input_dtypes():
    """bf16 inputs get bf16 gradients (dt and A stay float32); an unused
    final state sends no cotangent."""
    arrs = _inputs(1, 32, 2, 8, 16, seed=5)
    targs = [t.requires_grad_(True) for t in _to_torch(arrs, "bfloat16")]
    y, _ = ssm.ssd(*targs, 16)
    y.sum().backward()
    assert [t.grad.dtype for t in targs] == [
        torch.bfloat16, torch.float32, torch.float32, torch.bfloat16,
        torch.bfloat16]
    assert all(torch.isfinite(t.grad.float()).all() for t in targs)


def test_card_route_pads_ragged_length_and_checks_groups():
    """The CUDA route's wrapper logic (pad to a chunk multiple with dt = 0,
    drop the padded outputs) on CPU tensors, where the entry point takes the
    plain version: the same y and final state as the unpadded recurrence."""
    arrs = _to_torch(_inputs(2, 45, 4, 8, 16, seed=6), "float32")
    y, st = ssm._ssd_on_card(*arrs, 16)
    y_r, st_r = ssd_ref(*arrs)
    assert y.shape == (2, 45, 4, 8)
    torch.testing.assert_close(y, y_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(st, st_r, rtol=1e-5, atol=1e-5)
    two = _to_torch(_inputs(1, 16, 4, 8, 16, seed=7, g=2), "float32")
    with pytest.raises(ValueError, match="n_groups=1"):
        ssm._ssd_on_card(*two, 16)


def test_entry_point_dispatch_and_kernel_checks():
    arrs = _to_torch(_inputs(1, 32, 2, 8, 16, seed=8), "float32")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ssd(*(t.to("meta") for t in arrs), chunk=16)
    # the kernel wrapper takes CUDA tensors only; nothing falls back
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_kernel.ssd_scan(*arrs, chunk=16)
    with pytest.raises(ValueError, match="l % chunk"):
        ssd_kernel.ssd_scan(*arrs, chunk=24)
    x, dt, A, B, C = arrs
    with pytest.raises(ValueError, match="head_dim"):
        ssd_kernel.ssd_scan(x.repeat(1, 1, 1, 9), dt, A, B, C, chunk=16)
    with pytest.raises(ValueError, match="dtypes"):
        ssd_kernel.ssd_scan(x.bfloat16(), dt, A, B, C, chunk=16)


def test_ssd_cost_counts():
    """The bound's counts at the training shape of mamba2-2.7b (b=2,
    l=4096, h=80, p=64, n=128, chunk 256, bf16 inputs)."""
    nbytes, flops = ssd_cost(2, 4096, 80, 64, 128, 256, in_bytes=2)
    rows = 2 * 4096
    assert nbytes == (rows * 80 * 64 * 2 + rows * 80 * 4 + 80 * 4
                      + 2 * rows * 128 * 2 + rows * 80 * 64 * 4
                      + 2 * 80 * 64 * 128 * 4)
    pairs = 256 * 257 // 2
    assert flops == (32 * pairs * 128 * 2 + 32 * 80 * pairs * 64 * 2
                     + 2 * 32 * 80 * 256 * 64 * 128 * 2)
    assert 260e6 < nbytes < 270e6 and 32e9 < flops < 33e9
