"""The port's flash-decode against the JAX reference.

On the CPU the port's ``decode_attn`` runs its plain version, which is held
against the JAX package's Pallas kernel (interpret mode), its oracle and the
model's decode attention on the same numpy inputs. The CUDA kernel itself is
held against the plain version on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode.kernel import flash_decode as jax_flash_decode
from repro.kernels.flash_decode.ref import decode_attention_ref as jax_ref
from repro.models.attention import decode_attention as jax_decode_attention
from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode import kernel as fd_kernel
from repro_torch.kernels.flash_decode import ops
from repro_torch.models.attention import decode_attention

# (B, H, K, dk, dv, S, chunk): the shapes of tests/test_kernels.py
SHAPES = [(2, 8, 2, 64, 64, 512, 128), (1, 4, 4, 128, 128, 1024, 256),
          (2, 8, 1, 64, 128, 256, 256)]
# f32: both sides compute in f32 and differ only in summation order;
# bf16: the reference's own kernel tolerance (test_kernels.py)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, B, H, K, dk, dv, S):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, dk), np.float32),
            rng.standard_normal((B, S, K, dk), np.float32),
            rng.standard_normal((B, S, K, dv), np.float32))


def _jax(arrs, dtype):
    return [jnp.asarray(a).astype(JNP[dtype]) for a in arrs]


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(TORCH[dtype]) for a in arrs]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_kernel_and_oracle(shape, dtype):
    B, H, K, dk, dv, S, chunk = shape
    arrs = _inputs(2, B, H, K, dk, dv, S)
    length = S - 37
    jq, jk, jv = _jax(arrs, dtype)
    want_kernel = jax_flash_decode(jq, jk, jv, length, chunk=chunk,
                                   interpret=True)
    want_ref = jax_ref(jq, jk, jv, length)
    tq, tk, tv = _torch(arrs, dtype)
    got = ops.decode_attn(tq, tk, tv, length)
    assert got.dtype == TORCH[dtype] and got.shape == (B, H, dv)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want_ref), rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(got), _f32(want_kernel), rtol=tol,
                               atol=tol)


def test_plain_respects_length_poisoned_tail():
    """Entries past ``length`` must not contribute (test_kernels.py:80)."""
    B, H, K, dk, S, length = 1, 4, 2, 32, 256, 100
    q, k, v = _inputs(3, B, H, K, dk, dk, S)
    k2, v2 = k.copy(), v.copy()
    k2[:, length:] = 1e4
    v2[:, length:] = -1e4
    out = ops.decode_attn(*_torch([q, k, v], "float32"), length)
    out2 = ops.decode_attn(*_torch([q, k2, v2], "float32"), length)
    np.testing.assert_allclose(out.numpy(), out2.numpy(), rtol=1e-5)
    want = jax_flash_decode(*_jax([q, k2, v2], "float32"), length, chunk=64,
                            interpret=True)
    np.testing.assert_allclose(out2.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_row_lengths_match_model_decode_attention(dtype):
    """Per-row lengths (1 and S included) == the JAX model's decode
    attention at pos = length - 1."""
    B, H, K, dk, dv, S = 5, 8, 2, 64, 64, 96
    q, k, v = _inputs(4, B, H, K, dk, dv, S)
    lengths = np.array([1, S, 17, 64, 95], np.int32)
    jq, jk, jv = _jax([q, k, v], dtype)
    want = jax_decode_attention(jq[:, None], jk, jv,
                                jnp.asarray(lengths - 1))[:, 0]
    tq, tk, tv = _torch([q, k, v], dtype)
    got_ops = ops.decode_attn(tq, tk, tv, torch.from_numpy(lengths))
    got_model = decode_attention(tq[:, None], tk, tv,
                                 torch.from_numpy(lengths - 1))[:, 0]
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got_ops), _f32(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(got_model), _f32(want), rtol=tol,
                               atol=tol)


def test_cpu_dispatch_never_launches_kernel(monkeypatch):
    monkeypatch.setattr(fd_kernel, "launches", 0)
    q, k, v = _torch(_inputs(5, 2, 4, 2, 64, 64, 32), "bfloat16")
    ops.decode_attn(q, k, v, torch.tensor([3, 32], dtype=torch.int32))
    ops.decode_attn(q, k, v)
    assert fd_kernel.launches == 0


def test_kernel_wrapper_refuses_cpu_and_unsupported_inputs(monkeypatch):
    monkeypatch.setattr(fd_kernel, "launches", 0)
    q, k, v = _torch(_inputs(6, 2, 4, 2, 64, 64, 32), "float32")
    lengths = torch.tensor([1, 32], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        fd_kernel.flash_decode(q, k, v, lengths)
    q32, k32, v32 = _torch(_inputs(6, 2, 4, 2, 32, 32, 32), "float32")
    with pytest.raises(ValueError, match="dk, dv"):
        fd_kernel.flash_decode(q32, k32, v32, lengths)
    with pytest.raises(ValueError, match="int32"):
        fd_kernel.flash_decode(q, k, v, lengths.long())
    with pytest.raises(ValueError, match="dtypes"):
        fd_kernel.flash_decode(q.half(), k.half(), v.half(), lengths)
    assert fd_kernel.launches == 0


def test_hbm_bytes_counts_live_rows_once():
    # 2 rows of lengths 3 and 5, K=2 heads of dk=dv=64 in bf16, H=4
    got = ops.hbm_bytes([3, 5], heads=4, kv_heads=2, dk=64, dv=64)
    assert got == 8 * 2 * 128 * 2 + 2 * 4 * 128 * 2 + 2 * 4


def test_build_names_library_by_source_hash_and_needs_nvcc(tmp_path,
                                                           monkeypatch):
    src = tmp_path / "a.cu"
    src.write_text("// one\n")
    p1 = _build.library_path("x", [src])
    src.write_text("// two\n")
    assert _build.library_path("x", [src]) != p1
    assert p1.parent == _build.BUILD_DIR
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
