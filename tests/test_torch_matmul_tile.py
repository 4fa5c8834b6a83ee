"""The port's section 7 MatMul path against the reference, on the CPU.

On the CPU, :func:`repro_torch.kernels.matmul` takes the plain version;
it is held against the reference's Pallas kernel in interpret mode and its
``matmul_ref`` at the shapes and tolerances of
``tests/test_kernels.py::test_matmul_tile``, with the exact K=2048 sweep of
ones. ``check_args`` is held against the Pallas kernel's own contract
(traced with ``jax.eval_shape``, so its asserts run and nothing computes),
and the copied ``params``, ``HwSpec`` and ``matmul_accel_rows`` against the
reference's. The CUDA kernel itself is checked on the card
(``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.paper_tables import matmul_accel_rows as jax_accel_rows
from repro.core.exanet import params as jax_params
from repro.kernels import matmul as jax_matmul
from repro.kernels.matmul_tile.kernel import matmul_tile as jax_matmul_tile
from repro.kernels.matmul_tile.ops import flops_per_byte as jax_fpb
from repro.kernels.matmul_tile.ref import matmul_ref as jax_matmul_ref
from repro.roofline import hw as jax_hw
from repro_torch.core.exanet import params
from repro_torch.kernels import _build, matmul
from repro_torch.kernels.matmul_tile import kernel as mk
from repro_torch.kernels.matmul_tile.ops import flops_per_byte
from repro_torch.kernels.matmul_tile.ref import check_args, matmul_ref
from repro_torch.roofline import hw
from repro_torch.roofline.paper import SHAPES, matmul_accel_rows

JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
      "float16": jnp.float16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16,
      "float16": torch.float16}
#: the reference's tolerances (tests/test_kernels.py): rtol, atol = 8 rtol
TOL = {"float32": 1e-3, "bfloat16": 2e-2, "float16": 2e-2}
#: the reference's matmul test shapes, (M, N, K)
REF_SHAPES = [(128, 128, 128), (256, 128, 512), (384, 256, 256),
              (128, 384, 640)]


def _inputs(m, n, k, dtype, seed=0):
    """Normal values drawn with numpy, cast to ``dtype`` by JAX and handed
    to torch through float32 (exact), so both sides hold the same bits."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((m, k), (k, n)):
        j = jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                        ).astype(JD[dtype])
        out.append((j, torch.tensor(np.asarray(j.astype(jnp.float32)))
                    .to(TD[dtype])))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("mnk", REF_SHAPES)
def test_matmul_matches_reference_kernel_and_ref(mnk, dtype):
    m, n, k = mnk
    (ja, ta), (jb, tb) = _inputs(m, n, k, dtype)
    want_kernel = np.asarray(jax_matmul_tile(ja, jb, bm=128, bn=128, bk=128,
                                             interpret=True), np.float32)
    want_ref = np.asarray(jax_matmul_ref(ja, jb), np.float32)
    tol = TOL[dtype]
    for got in (matmul(ta, tb, bk=128), matmul_ref(ta, tb)):
        assert got.dtype == TD[dtype] and got.shape == (m, n)
        for want in (want_kernel, want_ref):
            np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                       atol=tol * 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_kblocks_accumulate_exactly(dtype):
    """The reference's exact case: a K sweep of 2048 ones gives 2048."""
    a = torch.ones((128, 2048), dtype=TD[dtype])
    b = torch.ones((2048, 128), dtype=TD[dtype])
    got = matmul(a, b, bk=256)
    assert bool((got.float() == 2048.0).all())
    want = jax_matmul_tile(jnp.ones((128, 2048), JD[dtype]),
                           jnp.ones((2048, 128), JD[dtype]), bm=128, bn=128,
                           bk=256, interpret=True)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def _reference_accepts(M, K, K2, N, **tile):
    """Whether the Pallas kernel's contract takes these shapes: trace it
    (its asserts run at trace time; nothing is computed)."""
    fn = lambda a, b: jax_matmul_tile(a, b, interpret=True, **tile)  # noqa: E731
    try:
        jax.eval_shape(fn, jax.ShapeDtypeStruct((M, K), jnp.bfloat16),
                       jax.ShapeDtypeStruct((K2, N), jnp.bfloat16))
    except AssertionError:
        return False
    return True


# (M, K, K2, N, tile kwargs): the reference's test shapes with bk 128; an
# exanest-lm-100m projection (K 768) with the default bk 512 and with bk
# 256; the down projection (K 2048); a K mismatch; mamba2-2.7b's in_proj
# (N 10576); shapes below one tile (each tile clamps to its dimension);
# one dimension above a tile that no tile divides; the logits (N 32000)
CONTRACT_CASES = [
    *[(m, k, k, n, {"bk": 128}) for m, n, k in REF_SHAPES],
    (4096, 768, 768, 768, {}),
    (4096, 768, 768, 768, {"bk": 256}),
    (4096, 768, 768, 2048, {"bk": 256}),
    (4096, 2048, 2048, 768, {}),
    (4096, 768, 512, 768, {"bk": 256}),
    (8192, 2560, 2560, 10576, {}),
    (100, 100, 100, 100, {}),
    (128, 301, 301, 128, {}),
    (200, 128, 128, 128, {}),
    (128, 600, 600, 128, {}),
    (4096, 768, 768, 32000, {"bk": 256}),
    (256, 512, 512, 384, {"bm": 256, "bn": 64, "bk": 128}),
]


@pytest.mark.parametrize("case", CONTRACT_CASES,
                         ids=lambda c: f"{c[0]}x{c[1]}-{c[2]}x{c[3]}-{c[4]}")
def test_check_args_takes_exactly_what_the_pallas_kernel_takes(case):
    M, K, K2, N, tile = case
    want = _reference_accepts(M, K, K2, N, **tile)
    a = torch.empty((M, K), dtype=torch.bfloat16)
    b = torch.empty((K2, N), dtype=torch.bfloat16)
    if want:
        check_args(a, b, **tile)
    else:
        with pytest.raises(ValueError):
            check_args(a, b, **tile)


def test_check_args_refuses_dtypes_ranks_and_empty_tiles():
    a = torch.empty((128, 128))
    for bad in (a.double(), a.int()):
        with pytest.raises(ValueError, match="dtype"):
            check_args(bad, bad)
    with pytest.raises(ValueError, match="dtype"):
        check_args(a, a.bfloat16())
    with pytest.raises(ValueError, match="2-D"):
        check_args(a[None], a)
    with pytest.raises(ValueError, match="positive"):
        check_args(a, a, bk=0)
    with pytest.raises(ValueError, match="empty"):
        check_args(torch.empty((0, 128)), a)
    check_args(a.half(), a.half())


def test_matmul_takes_any_shape_on_the_cpu():
    """As the reference's route off the TPU: the plain version, for shapes
    the tile contract refuses too."""
    (ja, ta), (jb, tb) = _inputs(200, 100, 768, "float32", seed=3)
    got = matmul(ta, tb)
    want = np.asarray(jax_matmul(ja, jb), np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=8e-3)


def test_matmul_routes_by_device_and_builds_nothing(monkeypatch):
    monkeypatch.setattr(mk, "_lib", lambda: pytest.fail("library loaded"))
    monkeypatch.setattr(_build, "load", lambda *a: pytest.fail("built"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        matmul(torch.empty((8, 8), device="meta"),
               torch.empty((8, 8), device="meta"))
    # the kernel's own wrapper takes no CPU tensor: there is no CPU route
    # through it, and it raises before touching the library
    with pytest.raises(ValueError, match="CUDA device"):
        mk.matmul_tile(torch.ones((128, 128)), torch.ones((128, 128)))
    with pytest.raises(ValueError, match="CUDA device"):
        mk._launch(torch.ones((128, 128)), torch.ones((128, 128)), "ffma")
    with pytest.raises(ValueError, match="CUDA device"):
        mk.wgmma_probe(torch.ones((64, 64), dtype=torch.bfloat16),
                       torch.ones((64, 256), dtype=torch.bfloat16))
    # choosing the variant reads shapes and pointers only
    h = torch.ones((4096, 4096), dtype=torch.bfloat16)
    assert mk.variant_for(h, h, h) == ("wgmma", (128, 256))
    launches, by_variant = mk.launches, dict(mk.launches_by_variant)
    matmul(torch.ones((128, 128)), torch.ones((128, 128)))
    assert mk.launches == launches and mk.launches_by_variant == by_variant


@pytest.mark.parametrize("dtype,mnk,want", [
    (torch.bfloat16, (256, 256, 256), True),
    (torch.bfloat16, (128, 128, 301), False),
    (torch.bfloat16, (100, 100, 100), False),
    (torch.float32, (100, 100, 100), True),
    (torch.float32, (128, 128, 301), False),
    (torch.float16, (256, 100, 512), False),
])
def test_vectorized_needs_16_byte_rows(dtype, mnk, want):
    M, N, K = mnk
    a, b = torch.empty((M, K), dtype=dtype), torch.empty((K, N), dtype=dtype)
    assert mk.vectorized(a, b, torch.empty((M, N), dtype=dtype)) is want


@pytest.mark.parametrize("mnk", [(1024, 1024, 1024), (4096, 768, 2048),
                                 (8192, 8192, 8192), (3, 5, 7)])
@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_flops_per_byte_matches_reference(mnk, dtype_bytes):
    assert flops_per_byte(*mnk, dtype_bytes) == jax_fpb(*mnk, dtype_bytes)


def test_params_copy_equals_reference_field_by_field():
    assert dataclasses.asdict(params.DEFAULT) == dataclasses.asdict(
        jax_params.DEFAULT)
    assert ([(f.name, f.default) for f in dataclasses.fields(params.HwParams)]
            == [(f.name, f.default)
                for f in dataclasses.fields(jax_params.HwParams)])
    for prop in ("cell_efficiency", "mezz_torus_z", "n_qfdbs", "n_mpsocs",
                 "n_cores"):
        assert getattr(params.DEFAULT, prop) == getattr(jax_params.DEFAULT,
                                                        prop)
    for cores in (256, 512, 1024, 4096, 20000):
        assert dataclasses.asdict(params.scaled_params(cores)) == \
            dataclasses.asdict(jax_params.scaled_params(cores))


def test_hwspec_fields_equal_reference():
    assert [f.name for f in dataclasses.fields(hw.HwSpec)] == \
        [f.name for f in dataclasses.fields(jax_hw.HwSpec)]
    # the H100 spec: NVIDIA's published H100 SXM5 80 GB figures
    assert hw.H100.peak_bf16_flops == 989.4e12
    assert hw.H100.hbm_bw == 3.35e12 and hw.H100.hbm_bytes == 80 * 2 ** 30
    assert hw.H100_PEAK_F32_FLOPS == 66.9e12


def test_matmul_accel_rows_match_reference_for_its_spec():
    """The reference's rows come from its own chip spec; the port's, given
    a spec built here from the same fields, must give the same values and
    notes (row names carry the spec's name)."""
    spec = hw.HwSpec(**dataclasses.asdict(jax_hw.V5E))
    got, want = matmul_accel_rows(spec), jax_accel_rows()
    assert len(got) == len(want) == 2 + len(SHAPES)
    for (gn, gv, gnote), (wn, wv, wnote) in zip(got, want):
        assert gv == wv and gnote == wnote
        assert gn.replace(spec.name, "SPEC") == wn.replace("v5e", "SPEC")


def test_matmul_accel_rows_for_the_h100():
    rows = dict((name, (us, note))
                for name, us, note in matmul_accel_rows(hw.H100))
    us, note = rows["matmul_accel/h100-sxm5-80gb/4096^3"]
    assert us == pytest.approx(2 * 4096 ** 3 / 989.4e12 * 1e6)
    assert note == "AI=1365 flops/B ridge=295 -> compute-bound"
    assert rows["matmul_accel/h100-sxm5-80gb/1024^3"][1].endswith(
        "ridge=295 -> compute-bound")


def test_section7_path_on_the_cpu_matches_reference():
    """The slice as a whole at a small size: the section 7 products through
    the port's public entry point against the reference's entry point."""
    for dtype in ("bfloat16", "float32"):
        (ja, ta), (jb, tb) = _inputs(256, 256, 256, dtype, seed=5)
        got = matmul(ta, tb).float().numpy()
        want = np.asarray(jax_matmul(ja, jb), np.float32)
        tol = TOL[dtype]
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * 8)


# (M, N, K, dtype, variant, tile) the kernel should run: the section 7
# products; exanest-lm-100m's projections at 4096 tokens (q/out, k/v,
# gate/up, down, logits); the on-card edge shapes; the shapes TMA cannot
# address (K = 301, N = 100, 100 cubed in 16 bits)
VARIANT_CASES = [
    *[(n, n, n, "bfloat16", "wgmma", t)
      for n, t in ((1024, (64, 128)), (4096, (128, 256)),
                   (8192, (128, 256)))],
    *[(n, n, n, "float32", "ffma", (128, 128)) for n in (1024, 4096, 8192)],
    (4096, 768, 768, "bfloat16", "wgmma", (128, 128)),
    (4096, 256, 768, "bfloat16", "wgmma", (64, 128)),
    (4096, 2048, 768, "bfloat16", "wgmma", (128, 256)),
    (4096, 768, 2048, "float16", "wgmma", (128, 128)),
    (4096, 32000, 768, "bfloat16", "wgmma", (128, 256)),
    (4096, 32000, 768, "float32", "ffma", (128, 128)),
    (72, 120, 200, "bfloat16", "wgmma", (64, 128)),
    (1, 128, 512, "float16", "wgmma", (64, 128)),
    (384, 640, 1024, "bfloat16", "wgmma", (64, 128)),
    (128, 128, 301, "bfloat16", "mma_sync", (128, 128)),
    (100, 100, 100, "float16", "mma_sync", (128, 128)),
    (256, 100, 512, "bfloat16", "mma_sync", (128, 128)),
    (100, 100, 100, "float32", "ffma", (128, 128)),
]


@pytest.mark.parametrize("case", VARIANT_CASES,
                         ids=lambda c: f"{c[0]}x{c[1]}x{c[2]}-{c[3]}")
def test_variant_for_picks_by_dtype_alignment_and_size(case):
    M, N, K, dtype, variant, tile = case
    a = torch.empty((M, K), dtype=TD[dtype])
    b = torch.empty((K, N), dtype=TD[dtype])
    out = torch.empty((M, N), dtype=TD[dtype])
    assert mk.variant_for(a, b, out) == (variant, tile)
    if variant == "wgmma":
        assert mk.wgmma_tile(M, N, K) == tile


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_variant_for_sends_unaligned_views_to_mma_sync(dtype):
    """A contiguous view whose rows start 2 bytes off 16: TMA cannot
    address it, whatever K and N are."""
    flat = torch.empty(256 * 512 + 8, dtype=TD[dtype])
    a = flat[1:1 + 256 * 512].view(256, 512)
    b = torch.empty((512, 256), dtype=TD[dtype])
    out = torch.empty((256, 256), dtype=TD[dtype])
    assert a.is_contiguous() and a.data_ptr() % 16 == 2
    assert mk.variant_for(a, b, out) == ("mma_sync", (128, 128))
    assert mk.variant_for(flat[8:].view(256, 512), b, out)[0] == "wgmma"


@pytest.mark.parametrize("mnk", [(1, 1, 1), (64, 128, 8), (8448, 8448, 64),
                                 (128 * 128, 128, 8), (10**6, 8, 8)])
def test_wgmma_tile_fills_the_card_with_the_largest_tile(mnk):
    """The largest tile with at least FILL_TILES tiles, else the smallest;
    a pure function of the shape."""
    M, N, K = mnk
    tile = mk.wgmma_tile(M, N, K)
    assert tile in mk.WGMMA_TILES
    count = lambda t: -(-M // t[0]) * -(-N // t[1])  # noqa: E731
    larger = mk.WGMMA_TILES[:mk.WGMMA_TILES.index(tile)]
    assert all(count(t) < mk.FILL_TILES for t in larger)
    assert count(tile) >= mk.FILL_TILES or tile == mk.WGMMA_TILES[-1]
    assert mk.wgmma_tile(M, N, K) == mk.wgmma_tile(M, N, K + 8)


@pytest.mark.parametrize("dtype,variant", [("float32", "wgmma"),
                                           ("float32", "mma_sync"),
                                           ("bfloat16", "ffma"),
                                           ("float16", "ffma"),
                                           ("bfloat16", "tf32")])
def test_launch_refuses_a_variant_that_does_not_take_the_dtype(dtype,
                                                               variant):
    a = torch.ones((128, 128), dtype=TD[dtype])
    with pytest.raises(ValueError, match="variant|does not take"):
        mk._launch(a, a, variant)


def test_launch_counters_start_per_variant():
    assert set(mk.launches_by_variant) == set(mk.VARIANTS) == {
        "ffma", "mma_sync", "wgmma"}
    assert all(isinstance(n, int) for n in mk.launches_by_variant.values())
