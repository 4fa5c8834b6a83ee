"""The port's SSD scan against the JAX reference, on the CPU.

Same numpy inputs into both: the port's plain version (``ssd_ref``, the
sequential recurrence) against the reference's ``ssd_ref`` and its Pallas
kernel in interpret mode, at the reference's kernel test shapes; the
model's SSD route (:class:`repro_torch.models.ssm.SSDFunction`) and its
gradients against ``jax.grad`` of the reference's float32
``ssd_chunked``; the plain version of the tensor-core variant's rounding
contract (``ssd_chunked_tc``) against the reference's bf16 ``ssd_chunked``
and the port's; the entry point's device dispatch, the route's padding of
a ragged length, which variant ``variant_for`` picks and what the wrapper
refuses, and the bound's byte and operation counts by variant. The CUDA
kernel itself is checked on the card (``tests/test_torch_kernels_cuda.py``,
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
from repro.models import ssm as jax_ssm
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ops import ssd, ssd_bound, ssd_cost
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_tc, ssd_ref
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
    # meta tensors take the kernel's custom op (the dry run's route): its
    # output shapes, never the plain version, and the kernel's refusals
    y, final = ssd(*(t.to("meta") for t in arrs), chunk=16)
    assert (y.device.type, tuple(y.shape), y.dtype) == \
        ("meta", (1, 32, 2, 8), torch.float32)
    assert tuple(final.shape) == (1, 2, 8, 16)
    with pytest.raises(ValueError, match="l % chunk"):
        ssd(*(t.to("meta") for t in arrs), chunk=24)
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


# (dtype, p, n, chunk) -> the variant: mamba2-2.7b's layer (64, 128, 256),
# zamba2-2.7b's (64, 64, 256), the reduced configs' (16, 16, 32), the
# reference's test shapes
VARIANT_CASES = [("float32", 64, 128, 256, "ffma"),
                 ("float32", 20, 24, 40, "ffma"),
                 ("bfloat16", 64, 128, 256, "mma_sync"),
                 ("bfloat16", 64, 64, 256, "mma_sync"),
                 ("bfloat16", 16, 16, 32, "mma_sync"),
                 ("bfloat16", 32, 64, 64, "mma_sync")]


@pytest.mark.parametrize("dtype,p,n,chunk,want", VARIANT_CASES)
def test_variant_for_by_dtype_and_shape(dtype, p, n, chunk, want):
    assert ssd_kernel.variant_for(TD[dtype], p, n, chunk) == want
    assert want in ssd_kernel.VARIANTS


@pytest.mark.parametrize("p,n,chunk", [(24, 128, 256), (64, 120, 256),
                                       (64, 128, 40)])
def test_tensor_core_variant_refuses_shapes_off_its_granule(p, n, chunk):
    """bf16 shapes mma_sync does not take raise, in variant_for, in the
    entry point and in _launch; they never go to ffma."""
    with pytest.raises(ValueError, match="multiples of 16"):
        ssd_kernel.variant_for(torch.bfloat16, p, n, chunk)
    x, dt, A, B, C = _to_torch(_inputs(1, 2 * chunk, 2, p, n, seed=p + n),
                               "bfloat16")
    with pytest.raises(ValueError, match="multiples of 16"):
        ssd_kernel.ssd_scan(x, dt, A, B, C, chunk=chunk)
    with pytest.raises(ValueError, match="multiples of 16"):
        ssd_kernel._launch(x, dt, A, B, C, chunk=chunk, variant="mma_sync")


def test_launch_refuses_what_no_variant_takes():
    """_launch: an unknown variant, mma_sync on float32, float16 inputs, and
    (the shapes aside) CPU tensors: nothing runs a plain version instead."""
    f32 = _to_torch(_inputs(1, 32, 2, 16, 16, seed=9), "float32")
    bf = _to_torch(_inputs(1, 32, 2, 16, 16, seed=9), "bfloat16")
    with pytest.raises(ValueError, match="variant must be one of"):
        ssd_kernel._launch(*bf, chunk=16, variant="wgmma")
    with pytest.raises(ValueError, match="mma_sync does not take"):
        ssd_kernel._launch(*f32, chunk=16, variant="mma_sync")
    with pytest.raises(ValueError, match="no ssd_scan variant"):
        ssd_kernel.variant_for(torch.float16, 16, 16, 16)
    before = dict(ssd_kernel.launches_by_variant)
    for args, variant in ((bf, "mma_sync"), (bf, "ffma"), (f32, "ffma")):
        with pytest.raises(ValueError, match="CUDA device"):
            ssd_kernel._launch(*args, chunk=16, variant=variant)
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_kernel.ssd_scan(*bf, chunk=16)
    assert ssd_kernel.launches_by_variant == before


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ssd_chunked_tc against the port's bf16 ssd_chunked: the two round every
# operand at the same places except one: ssd_chunked_tc rounds each
# decay * x·dt product of the chunk states to bf16 (at most 2^-9 of it).
# Summed over a chunk with signs at random, that moves a state entry by
# ~2^-9 of the size of its terms, and a flipped bf16 rounding of the
# entering state moves y_off by 2^-8 of one term: at most 3.0e-3 of the
# largest |y| or |state| over these cases on the CPU. Tolerance 1e-2 of the
# largest value (3x that). Against the reference's bf16 ssd_chunked, the
# port's chunked-form bf16 tolerance (tests/test_torch_ssm.py CHUNKED_TOL,
# 3e-2 of the largest value), and against its ssd_ref, its bf16 kernel
# tolerance (rtol 6e-2, atol 6e-1).
TC_TIGHT = 1e-2
# (b, l, h, p, n, chunk): the reference's kernel test shapes, one the head
# group of 8 does not divide (h = 12), and one chunk of mamba2-2.7b's layer
TC_SHAPES = [(2, 128, 8, 16, 16, 32), (1, 256, 4, 32, 64, 64),
             (2, 64, 16, 16, 32, 64), (1, 128, 12, 32, 16, 64),
             (1, 256, 4, 64, 128, 256)]


@pytest.mark.parametrize("dt_scale", [None, 5.0, 1e-4])
@pytest.mark.parametrize("shape", TC_SHAPES)
def test_ssd_chunked_tc_matches_reference_and_port_chunked(shape, dt_scale):
    """Same numpy inputs in bf16: ssd_chunked_tc against the reference's
    ssd_chunked (compiled so that it rounds where its source says) and
    ssd_ref, and tightly against the port's ssd_chunked; dt as drawn, as
    strong decay (dt = 5) and near 0 (dt = 1e-4)."""
    b, l, h, p, n, chunk = shape
    x, dt, A, B, C = _inputs(b, l, h, p, n, seed=sum(shape))
    if dt_scale is not None:
        dt = np.full_like(dt, dt_scale)
    arrs = (x, dt, A, B, C)
    t_y, t_st = ssd_chunked_tc(*_to_torch(arrs, "bfloat16"), chunk)
    assert t_y.dtype == torch.float32 and t_y.shape == (b, l, h, p)
    assert t_st.dtype == torch.float32 and t_st.shape == (b, h, p, n)
    jargs = _to_jax(arrs, "bfloat16")
    j_y, j_st = jax.jit(lambda *a: jax_ssm.ssd_chunked(*a, chunk=chunk)).lower(
        *jargs).compile(compiler_options={
            "xla_allow_excess_precision": False})(*jargs)
    assert _rel(t_y, j_y) <= 3e-2 and _rel(t_st, j_st) <= 3e-2
    r_y, r_st = jax_ssd_ref(*jargs)
    _close(t_y, r_y, TOL["bfloat16"], "y vs the reference's ssd_ref")
    _close(t_st, r_st, TOL["bfloat16"], "state vs the reference's ssd_ref")
    p_y, p_st = ssm.ssd_chunked(*_to_torch(arrs, "bfloat16"), chunk)
    assert _rel(t_y, p_y) <= TC_TIGHT, _rel(t_y, p_y)
    assert _rel(t_st, p_st) <= TC_TIGHT, _rel(t_st, p_st)


def test_ssd_bound_by_variant():
    """The bound at mamba2-2.7b's training shape: bf16 inputs on the tensor
    cores (mma_sync) are bound by bytes, 263,717,184 B at 3.35 TB/s =
    0.0787 ms (the products, 0.0329 ms at 989.4 TFLOP/s, are less); ffma is
    bound by float32 operations, 32,523,681,792 FLOP at 66.9 TFLOP/s =
    0.486 ms. Both count the same work (ssd_cost)."""
    args = (2, 4096, 80, 64, 128, 256, 2)
    nbytes, flops = ssd_cost(*args)
    assert (nbytes, flops) == (263_717_184, 32_523_681_792)
    ms, by = ssd_bound(*args, "mma_sync")
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e9)
    assert round(ms, 4) == 0.0787 and flops / 989.4e9 < ms
    ms, by = ssd_bound(*args, "ffma")
    assert by == "operations" and ms == pytest.approx(flops / 66.9e9)
    assert round(ms, 3) == 0.486
    with pytest.raises(KeyError):
        ssd_bound(*args, "wgmma")
