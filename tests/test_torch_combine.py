"""The port's combine (allreduce reduction arithmetic) against the reference.

On the CPU, :func:`combine_parts` takes the plain version; both it and
``combine_ref`` are held against the reference's Pallas kernel in interpret
mode and its ``combine_ref``, at the shapes, ops and dtypes of
``tests/test_kernels.py::test_combine`` and its tolerance (1e-2). The CUDA
kernel itself is checked on the card (``tests/test_torch_kernels_cuda.py``
and ``chip_smoke.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.allreduce_combine.kernel import combine as jax_combine
from repro.kernels.allreduce_combine.ref import combine_ref as jax_combine_ref
from repro_torch.kernels.allreduce_combine import kernel as ck
from repro_torch.kernels.allreduce_combine.ops import combine_parts
from repro_torch.kernels.allreduce_combine.ref import combine_ref

JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16,
      "int32": torch.int32}


def _inputs(shape, dtype, seed=1):
    """The reference test's values (normal * 8), drawn with numpy and cast
    identically on both sides (float32 -> dtype)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 8
    j = jnp.asarray(x).astype(JD[dtype])
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(TD[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("shape", [(4, 1024), (3, 4096), (8, 8192)])
def test_combine_matches_reference(shape, op, dtype):
    j, t = _inputs(shape, dtype)
    want_kernel = np.asarray(jax_combine(j, op=op, interpret=True), np.float32)
    want_ref = np.asarray(jax_combine_ref(j, op=op), np.float32)
    for got in (combine_ref(t, op), combine_parts(t, op=op)):
        assert got.dtype == t.dtype and got.shape == (shape[1],)
        for want in (want_kernel, want_ref):
            np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                                       atol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["max", "min"])
def test_combine_propagates_nan(op, dtype):
    """A NaN in any part makes that output NaN (as jnp.max/min do); the
    other outputs are unaffected."""
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4).to(TD[dtype])
    x[1, 2] = float("nan")
    got = combine_parts(x, op=op)
    want = np.asarray(jax_combine_ref(jnp.asarray(x.float().numpy()).astype(
        JD[dtype]), op=op), np.float32)
    assert torch.isnan(got[2]) and np.isnan(want[2])
    assert not torch.isnan(got[[0, 1, 3]]).any()
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_combine_int32_sum_is_exact_below_2_24():
    """int32 sums run through float32 (as the reference's do, ROADMAP R3):
    exact while every partial sum stays below 2^24."""
    rng = np.random.default_rng(2)
    x = rng.integers(-(1 << 21), 1 << 21, (8, 4099)).astype(np.int32)
    got = combine_parts(torch.from_numpy(x), op="sum")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), x.sum(0, dtype=np.int64))
    want = np.asarray(jax_combine(jnp.asarray(x), op="sum", interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


def test_combine_bf16_odd_length_sums_in_part_order():
    """Odd L (no multiple of the 8-wide bf16 vector): the sum accumulates in
    float32 over the parts in order 0..P-1 and rounds once to bf16."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((5, 1001)).astype(
        np.float32)).bfloat16()
    got = combine_parts(x, op="sum")
    acc = x[0].float()
    for p in range(1, 5):
        acc = acc + x[p].float()
    assert torch.equal(got, acc.bfloat16())
    want = np.asarray(jax_combine_ref(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16), op="sum"), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int64,
                                   torch.int8])
def test_combine_rejects_other_dtypes(dtype):
    x = torch.zeros((2, 8), dtype=dtype)
    with pytest.raises(TypeError, match="combine takes"):
        combine_parts(x, op="sum")
    with pytest.raises(TypeError, match="combine takes"):
        combine_ref(x)


def test_combine_rejects_bad_op_and_shape():
    with pytest.raises(ValueError, match="op must be"):
        combine_parts(torch.zeros((2, 4)), op="prod")
    with pytest.raises(ValueError, match=r"\(P, L\)"):
        combine_parts(torch.zeros(4), op="sum")


def test_kernel_wrapper_refuses_cpu_tensors_and_counts_nothing():
    """The CUDA wrapper never takes a CPU tensor (no fallback), and raises
    before it builds or launches anything."""
    before = ck.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        ck.combine(torch.zeros((2, 8)), "sum")
    assert ck.launches == before


def test_vector_path_needs_aligned_rows():
    x = torch.zeros((2, 64))
    assert ck.vectorized(x)
    # a view at an odd element offset, or rows 4 bytes apart, is scalar
    assert not ck.vectorized(torch.zeros(130)[1:129].view(2, 64))
    assert not ck.vectorized(torch.zeros((2, 63)))
