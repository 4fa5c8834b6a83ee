"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device. This file imports
torch and the port only, so it runs where JAX is absent:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.allreduce_combine import kernel as combine_kernel
from repro_torch.kernels.allreduce_combine.ref import combine_ref
from repro_torch.kernels.flash_decode import kernel as fd_kernel
from repro_torch.kernels.flash_decode.ref import decode_attention_ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_tc, ssd_ref

# (B, H, K, dk, dv, S): the reference's kernel test shapes, the serving
# shape of exanest-lm-100m at a window S that is no multiple of a span, and
# zamba2-2.7b's shared attention (MHA, head dim 80)
SHAPES = [(2, 8, 2, 64, 64, 512), (1, 4, 4, 128, 128, 1024),
          (2, 8, 1, 64, 128, 256), (8, 12, 4, 64, 64, 1000),
          (2, 32, 32, 80, 80, 1024)]


#: flash_decode against its plain version, (rtol, atol): f32 differs by
#: summation order only; bf16 by at most one step of the bf16 output (2^-7
#: of it) where the two float32 results round apart
FD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-3)}


def _fd_close(got, want):
    rtol, atol = FD_TOL[want.dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_decode_matches_plain_on_card(shape, dtype, cuda_device):
    B, H, K, dk, dv, S = shape
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32))
               .to(cuda_device, dtype)
               for s in ((B, H, dk), (B, S, K, dk), (B, S, K, dv)))
    lengths = rng.integers(1, S + 1, B).astype(np.int32)
    lengths[0] = S
    lengths = torch.from_numpy(lengths).to(cuda_device)
    before = fd_kernel.launches
    got = fd_kernel.flash_decode(q, k, v, lengths)
    want = decode_attention_ref(q, k, v, lengths)
    torch.cuda.synchronize()
    assert fd_kernel.launches == before + 1
    _fd_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 32, 32, 80, 80, 1000),
                                   (4, 12, 4, 64, 64, 4096),
                                   (2, 8, 1, 128, 128, 32768)])
def test_flash_decode_lse_form_matches_plain_on_card(shape, dtype,
                                                     cuda_device):
    """The log-sum-exp form (the blocks of a sequence split over ``data``):
    ``out`` in float32 and ``lse`` against the plain version's, rows of
    length 0 included (out 0, lse -inf, no NaN), one launch; the plain
    form's call on the same inputs unchanged bit for bit by the lse one
    between them."""
    B, H, K, dk, dv, S = shape
    rng = np.random.default_rng(13)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32))
               .to(cuda_device, dtype)
               for s in ((B, H, dk), (B, S, K, dk), (B, S, K, dv)))
    lengths = rng.integers(0, S + 1, B).astype(np.int32)
    lengths[0], lengths[-1] = 0, S
    lengths = torch.from_numpy(lengths).to(cuda_device)
    plain = fd_kernel.flash_decode(q, k, v, lengths.clamp(min=1))
    before = fd_kernel.launches
    got, lse = fd_kernel.flash_decode(q, k, v, lengths, lse=True)
    assert fd_kernel.launches == before + 1
    again = fd_kernel.flash_decode(q, k, v, lengths.clamp(min=1))
    want, want_lse = decode_attention_ref(q, k, v, lengths, lse=True)
    torch.cuda.synchronize()
    assert got.dtype == lse.dtype == torch.float32
    assert torch.equal(plain, again)
    assert torch.isfinite(got).all()
    assert (got[0] == 0).all() and torch.isneginf(lse[0]).all()
    assert torch.isfinite(lse[1:]).all()
    rtol, atol = FD_TOL[dtype]
    for g, w in ((got, want), (lse[1:], want_lse[1:])):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=rtol, atol=atol)


def _fd_case(B, H, K, dk, dv, S, dtype, device, seed):
    """q, k, v; ragged lengths with 1 and S; NaN past each row's length in
    the caches the kernel gets (kp, vp), not in those the reference gets."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32))
               .to(device, dtype)
               for s in ((B, H, dk), (B, S, K, dk), (B, S, K, dv)))
    lengths = rng.integers(1, S + 1, B).astype(np.int32)
    lengths[0], lengths[-1] = 1, S
    lengths = torch.from_numpy(lengths).to(device)
    dead = (torch.arange(S, device=device)[None, :]
            >= lengths[:, None].long())[:, :, None, None]
    return (q, k, v, k.masked_fill(dead, float("nan")),
            v.masked_fill(dead, float("nan")), lengths)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 12, 4, 64, 64, 2048),
                                   (3, 36, 4, 128, 128, 300),
                                   (2, 32, 2, 64, 128, 700)])
def test_flash_decode_is_deterministic_and_ignores_dead_rows_on_card(
        shape, dtype, cuda_device):
    """Two calls give the same bits (the partials merge in a fixed order,
    whichever CTA comes last), and NaN past each row's length never reaches
    the output (rep 3, 9 in two tiles, 16 in two tiles)."""
    q, k, v, kp, vp, lengths = _fd_case(*shape, dtype, cuda_device, 11)
    got = fd_kernel.flash_decode(q, kp, vp, lengths)
    again = fd_kernel.flash_decode(q, kp, vp, lengths)
    want = decode_attention_ref(q, k, v, lengths)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _fd_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_merges_a_unit_in_several_passes_on_card(dtype,
                                                              cuda_device):
    """A row of 32768 positions on one kv head: more CTAs share its unit
    than one pass of the merge stages, so the running max and sum carry
    across passes."""
    B, H, K, dk, dv, S = 2, 8, 1, 128, 128, 32768
    q, k, v, kp, vp, lengths = _fd_case(B, H, K, dk, dv, S, dtype,
                                        cuda_device, 12)
    n_ctas = fd_kernel._grid(cuda_device.index or 0,
                             fd_kernel._DTYPE_CODE[dtype], dk, dv, B, K,
                             H // K, S)
    segs = fd_kernel.schedule(lengths.tolist(), B, K, 1, n_ctas)
    ctas_of_long_row = sum(seg[1] == B - 1 for seg in segs)
    assert ctas_of_long_row > fd_kernel.merge_chunk(dtype, dk, dv, H // K)
    got = fd_kernel.flash_decode(q, kp, vp, lengths)
    again = fd_kernel.flash_decode(q, kp, vp, lengths)
    want = decode_attention_ref(q, k, v, lengths)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _fd_close(got, want)


def _static_inputs(case):
    static = [torch.empty_like(t) for t in (case[0], case[3], case[4],
                                            case[5])]

    def load(case):
        for dst, src in zip(static, (case[0], case[3], case[4], case[5])):
            dst.copy_(src)

    load(case)
    return static, load


@pytest.mark.cuda
def test_flash_decode_replays_in_a_cuda_graph_on_card(cuda_device):
    """Two graphs captured on one stream, after one eager call there made
    its tickets (so no zeroing is captured), replayed in turns with an eager
    call on that stream between and other q, caches and lengths copied in:
    each output matches the plain version, so every launch set its tickets
    back to 0 and no length was read on the host."""
    shape = (8, 12, 4, 64, 64, 2048)
    cases = [_fd_case(*shape, torch.bfloat16, cuda_device, 30 + i)
             for i in range(2)]
    static, load = _static_inputs(cases[0])
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fd_kernel.flash_decode(*static)
    torch.cuda.current_stream().wait_stream(stream)
    graphs, outs = [], []
    for _ in range(2):
        graphs.append(torch.cuda.CUDAGraph())
        with torch.cuda.graph(graphs[-1], stream=stream):
            outs.append(fd_kernel.flash_decode(*static))
    for what, i in ((1, 1), (0, 0), ("eager", 1), (0, 1), (1, 0)):
        q, k, v, _, _, lengths = cases[i]
        load(cases[i])
        torch.cuda.synchronize()
        if what == "eager":
            with torch.cuda.stream(stream):
                out = fd_kernel.flash_decode(*static)
        else:
            graphs[what].replay()
            out = outs[what]
        want = decode_attention_ref(q, k, v, lengths)
        torch.cuda.synchronize()
        _fd_close(out, want)


@pytest.mark.cuda
def test_flash_decode_refuses_capture_on_a_stream_without_buffers_on_card(
        cuda_device):
    """A stream's tickets are made outside capture only: capturing on a
    stream that never ran the kernel raises instead of capturing their
    zeroing into the graph."""
    case = _fd_case(8, 12, 4, 64, 64, 2048, torch.bfloat16, cuda_device, 32)
    static, _ = _static_inputs(case)
    fd_kernel.flash_decode(*static)       # the shapes' grid is known
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    # torch hands out pooled streams: retire what this one may hold already
    key = (cuda_device.index or 0, stream.cuda_stream)
    fd_kernel._retired.extend(fd_kernel._stream_buffers.pop(key, ()))
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="outside capture"):
        with torch.cuda.graph(graph, stream=stream):
            fd_kernel.flash_decode(*static)


# (P, L): the reference's combine test shapes, the sync's intra reduce of a
# 5,000,000-element bucket, and an odd L (scalar tail)
COMBINE_SHAPES = [(4, 1024), (3, 4096), (8, 8192), (2, 2_500_000), (3, 1001)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("shape", COMBINE_SHAPES)
def test_combine_matches_plain_on_card(shape, op, dtype, cuda_device):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 8)
    x = x.to(cuda_device, dtype)
    before = combine_kernel.launches
    got = combine_kernel.combine(x, op)
    want = combine_ref(x, op)
    torch.cuda.synchronize()
    assert combine_kernel.launches == before + 1
    # the sum adds parts in the same order in float32 as the plain version,
    # and max/min pick an input: bit for bit
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_combine_unaligned_view_nan_and_int32_on_card(cuda_device):
    rng = np.random.default_rng(12)
    base = torch.from_numpy(rng.standard_normal(2 * 4099 + 1).astype(
        np.float32)).to(cuda_device)
    view = base[1:].view(2, 4099)           # rows start 4 bytes off 16
    assert not combine_kernel.vectorized(view)
    assert torch.equal(combine_kernel.combine(view, "sum"),
                       combine_ref(view, "sum"))
    nan = view.clone()
    nan[1, 7] = float("nan")
    for op in ("max", "min"):
        out = combine_kernel.combine(nan, op)
        assert torch.isnan(out[7]) and torch.isfinite(out[:7]).all()
    ints = torch.from_numpy(rng.integers(-(1 << 21), 1 << 21, (8, 4097))
                            .astype(np.int32)).to(cuda_device)
    np.testing.assert_array_equal(
        combine_kernel.combine(ints, "sum").cpu().numpy(),
        ints.cpu().numpy().sum(0, dtype=np.int64))


# (b, l, h, p, n, chunk): the reference's ssd_scan test shapes, then a
# slice of mamba2-2.7b's layer (80 heads of 64, d_state 128, chunk 256)
SSD_SHAPES = [(2, 128, 8, 16, 16, 32), (1, 256, 4, 32, 64, 64),
              (2, 64, 16, 16, 32, 64), (1, 512, 80, 64, 128, 256)]
# the edge shapes of the tensor-core variant: chunk 64, 128 and 256; p 16,
# 32 and 64; n 16, 32, 64 and 128; h = 12, which the head group of 8 does
# not divide; l equal to one chunk
SSD_EDGE_SHAPES = [(1, 64, 12, 16, 16, 64), (1, 256, 12, 32, 32, 128),
                   (1, 256, 12, 64, 64, 256), (2, 512, 12, 64, 128, 256),
                   (1, 384, 8, 16, 128, 128), (1, 128, 12, 64, 16, 64)]
# mma_sync against ssd_chunked_tc, as max|got - want| / max|want| over y and
# over the final state: both round at the same places; the cumsum's order
# and exp differ by a few float32 ulps, which now and then flips the bf16
# rounding of an M, decay or entering-state element: one bf16 ulp of that
# element times its partner, up to ~1e-2 of the largest |y| for one flip
# with N(0, 1) inputs (|C.B| ~40, |x dt| ~3). Measured on the card: at most
# 2.5e-3 (chip_smoke.py's ref-shape-3, H100 80GB HBM3 at 700 W)
SSD_TC_TIGHT = 1e-2


def _ssd_case(b, l, h, p, n, dtype, device, seed, dt_scale=None):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, l, h, p), np.float32))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((b, l, h), np.float32)))
    if dt_scale is not None:
        dt = torch.full_like(dt, dt_scale)
    A = -torch.exp(torch.from_numpy(rng.standard_normal(h).astype(
        np.float32)) * 0.3)
    B, C = (torch.from_numpy(rng.standard_normal((b, l, 1, n), np.float32))
            for _ in range(2))
    x, B, C = (t.to(device, dtype) for t in (x, B, C))
    return x, dt.to(device), A.to(device), B, C


def _ssd_close(got, want, tol):
    # the reference's kernel tolerances (tests/test_kernels.py): f32
    # summation order; bf16 inputs
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=tol, atol=tol * 10)


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_scan_matches_plain_on_card(shape, dtype, cuda_device):
    """The entry point: f32 through ffma against ssd_ref at 1e-4; bf16
    through mma_sync against ssd_ref at the reference's 6e-2 and against
    ssd_chunked_tc tightly."""
    b, l, h, p, n, chunk = shape
    x, dt, A, B, C = _ssd_case(b, l, h, p, n, dtype, cuda_device, 13)
    before = ssd_kernel.launches
    by_variant = dict(ssd_kernel.launches_by_variant)
    y, st = ssd_kernel.ssd_scan(x, dt, A, B, C, chunk=chunk)
    y_r, st_r = ssd_ref(x, dt, A, B, C)
    torch.cuda.synchronize()
    assert ssd_kernel.launches == before + 1
    variant = "ffma" if dtype == torch.float32 else "mma_sync"
    assert ssd_kernel.launches_by_variant[variant] == by_variant[variant] + 1
    _ssd_close((y, st), (y_r, st_r), 1e-4 if dtype == torch.float32 else 6e-2)
    if dtype == torch.bfloat16:
        y_t, st_t = ssd_chunked_tc(x, dt, A, B, C, chunk)
        assert _rel(y, y_t) <= SSD_TC_TIGHT and _rel(st, st_t) <= SSD_TC_TIGHT


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 64])
def test_ssd_scan_on_a_head_block_equals_that_block_on_card(n, cuda_device):
    """A rank's share of a sharded Mamba-2 layer: ssd_scan on 40 of 80
    heads of 64 with all of d_state (mamba2-2.7b's 128, zamba2-2.7b's 64)
    equals, bit for bit, that block of the 80-head call (the heads share
    B and C and nothing else)."""
    b, l, h, p, chunk = 2, 512, 80, 64, 256
    x, dt, A, B, C = _ssd_case(b, l, h, p, n, torch.bfloat16, cuda_device,
                               29)
    y, st = ssd_kernel.ssd_scan(x, dt, A, B, C, chunk=chunk)
    for blk in (slice(0, h // 2), slice(h // 2, h)):
        yb, sb = ssd_kernel.ssd_scan(x[:, :, blk].contiguous(),
                                     dt[:, :, blk].contiguous(),
                                     A[blk].contiguous(), B, C, chunk=chunk)
        torch.cuda.synchronize()
        assert torch.equal(yb, y[:, :, blk])
        assert torch.equal(sb, st[:, blk])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 32, 32, 80, 80, 512),
                                   (2, 12, 12, 64, 64, 1500),
                                   (2, 14, 2, 64, 64, 512)])
def test_flash_decode_on_a_head_block_matches_that_block_on_card(
        shape, cuda_device):
    """A rank's share of a sharded decode (zamba2's shared block, whisper's
    cross read over 1,500 rows, internvl's 7 query heads over 1 KV head):
    flash_decode on half the query heads and their KV heads against that
    block of the whole-head call, within FD_TOL (the kernel splits the
    rows of fewer units over more CTAs, so its merges run in another
    order)."""
    B, H, K, dk, dv, S = shape
    rng = np.random.default_rng(31)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32))
               .to(cuda_device, torch.bfloat16)
               for s in ((B, H, dk), (B, S, K, dk), (B, S, K, dv)))
    lengths = torch.tensor([S, S // 3], dtype=torch.int32,
                           device=cuda_device)
    whole = fd_kernel.flash_decode(q, k, v, lengths)
    for m in range(2):
        qh, kh = slice(m * H // 2, (m + 1) * H // 2), \
            slice(m * K // 2, (m + 1) * K // 2)
        got = fd_kernel.flash_decode(q[:, qh].contiguous(),
                                     k[:, :, kh].contiguous(),
                                     v[:, :, kh].contiguous(), lengths)
        torch.cuda.synchronize()
        _fd_close(got, whole[:, qh])


@pytest.mark.cuda
@pytest.mark.parametrize("dt_scale", [None, 5.0, 1e-4])
@pytest.mark.parametrize("shape", SSD_EDGE_SHAPES)
def test_ssd_scan_tensor_core_edges_on_card(shape, dt_scale, cuda_device):
    """mma_sync at its edge shapes, dt as drawn, as strong decay (dt = 5)
    and near 0 (dt = 1e-4): against ssd_ref at the reference's bf16
    tolerance and against ssd_chunked_tc tightly."""
    b, l, h, p, n, chunk = shape
    x, dt, A, B, C = _ssd_case(b, l, h, p, n, torch.bfloat16, cuda_device,
                               17, dt_scale)
    assert ssd_kernel.variant_for(x.dtype, p, n, chunk) == "mma_sync"
    before = ssd_kernel.launches_by_variant["mma_sync"]
    y, st = ssd_kernel.ssd_scan(x, dt, A, B, C, chunk=chunk)
    y_r, st_r = ssd_ref(x, dt, A, B, C)
    y_t, st_t = ssd_chunked_tc(x, dt, A, B, C, chunk)
    torch.cuda.synchronize()
    assert ssd_kernel.launches_by_variant["mma_sync"] == before + 1
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    _ssd_close((y, st), (y_r, st_r), 6e-2)
    assert _rel(y, y_t) <= SSD_TC_TIGHT and _rel(st, st_t) <= SSD_TC_TIGHT


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_SHAPES[1:] + SSD_EDGE_SHAPES[:2])
def test_ssd_scan_ffma_on_bf16_on_card(shape, cuda_device):
    """The ffma variant run through _launch on bf16 inputs (the same-run
    comparison): float32 products of the widened inputs, so against ssd_ref
    at the reference's float32 tolerance."""
    b, l, h, p, n, chunk = shape
    x, dt, A, B, C = _ssd_case(b, l, h, p, n, torch.bfloat16, cuda_device, 19)
    before = ssd_kernel.launches_by_variant["ffma"]
    got = ssd_kernel._launch(x, dt, A, B, C, chunk=chunk, variant="ffma")
    want = ssd_ref(x, dt, A, B, C)
    torch.cuda.synchronize()
    assert ssd_kernel.launches_by_variant["ffma"] == before + 1
    _ssd_close(got, want, 1e-4)


# (M, N, K, bk): the reference's matmul test shapes (bk 128), one
# exanest-lm-100m projection (4096 tokens, gate/up 768 -> 2048, bk 256), and
# shapes the contract takes that no tile divides: depth 301 (element-wise
# path in every dtype), 100 x 100 x 100 (vectors in f32 only) and N = 100
MATMUL_SHAPES = [(128, 128, 128, 128), (256, 128, 512, 128),
                 (384, 256, 256, 128), (128, 384, 640, 128),
                 (4096, 2048, 768, 256), (128, 128, 301, 512),
                 (100, 100, 100, 512), (256, 100, 512, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", MATMUL_SHAPES)
def test_matmul_tile_matches_plain_on_card(shape, dtype, cuda_device):
    from repro_torch.kernels.matmul_tile import kernel as mm_kernel
    from repro_torch.kernels.matmul_tile.ref import matmul_ref
    M, N, K, bk = shape
    rng = np.random.default_rng(17)
    a = torch.from_numpy(rng.standard_normal((M, K), np.float32))
    b = torch.from_numpy(rng.standard_normal((K, N), np.float32))
    a, b = a.to(cuda_device, dtype), b.to(cuda_device, dtype)
    # float32 on the CUDA cores; 16-bit rows TMA can address (K, N
    # multiples of 8) through wgmma, the others through mma_sync
    variant = ("ffma" if dtype == torch.float32
               else "mma_sync" if K % 8 or N % 8 else "wgmma")
    before = mm_kernel.launches
    by_variant = mm_kernel.launches_by_variant[variant]
    got = mm_kernel.matmul_tile(a, b, bk=bk)
    want = matmul_ref(a, b)
    torch.cuda.synchronize()
    assert mm_kernel.launches == before + 1
    assert mm_kernel.launches_by_variant[variant] == by_variant + 1
    assert got.dtype == dtype and got.shape == (M, N)
    # the reference's kernel tolerances (tests/test_kernels.py): f32 sums in
    # another order; bf16 and f16 outputs rounded once from float32 sums
    tol = 1e-3 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol * 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_tile_kblocks_accumulate_exactly_on_card(dtype, cuda_device):
    """A K sweep of 2048 ones gives exactly 2048 (the reference's case)."""
    from repro_torch.kernels.matmul_tile import kernel as mm_kernel
    a = torch.ones((128, 2048), dtype=dtype, device=cuda_device)
    b = torch.ones((2048, 128), dtype=dtype, device=cuda_device)
    got = mm_kernel.matmul_tile(a, b, bk=256)
    assert bool((got.float() == 2048.0).all())


# (M, N, K, bk): shapes through wgmma where TMA zero-fills an edge: M, N and
# K all ragged; one row; a 640-wide N (half a 256-wide tile); the logits
# projection of exanest-lm-100m at 4096 tokens (bk 256)
WGMMA_EDGE_SHAPES = [(72, 120, 200, 512), (1, 128, 512, 512),
                     (384, 640, 1024, 512), (4096, 32000, 768, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [None, (128, 256), (128, 128), (64, 128)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", WGMMA_EDGE_SHAPES)
def test_matmul_tile_wgmma_edges_match_plain_on_card(shape, dtype, tile,
                                                     cuda_device):
    """Through the entry point (tile None: the tile variant_for picks) and
    through each wgmma tile, against the plain version."""
    from repro_torch.kernels.matmul_tile import kernel as mm_kernel
    from repro_torch.kernels.matmul_tile.ref import matmul_ref
    M, N, K, bk = shape
    rng = np.random.default_rng(19)
    a = torch.from_numpy(rng.standard_normal((M, K), np.float32))
    b = torch.from_numpy(rng.standard_normal((K, N), np.float32))
    a, b = a.to(cuda_device, dtype), b.to(cuda_device, dtype)
    before = mm_kernel.launches_by_variant["wgmma"]
    if tile is None:
        got = mm_kernel.matmul_tile(a, b, bk=bk)
    else:
        got = mm_kernel._launch(a, b, "wgmma", tile)
    want = matmul_ref(a, b)
    torch.cuda.synchronize()
    assert mm_kernel.launches_by_variant["wgmma"] == before + 1
    assert got.dtype == dtype and got.shape == (M, N)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=2e-2,
                               atol=0.16)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["wgmma", "mma_sync"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_matmul_tile_variants_accumulate_exactly_on_card(dtype, variant,
                                                         cuda_device):
    """The K = 2048 sweep of ones through each 16-bit variant: exactly 2048."""
    from repro_torch.kernels.matmul_tile import kernel as mm_kernel
    a = torch.ones((128, 2048), dtype=dtype, device=cuda_device)
    b = torch.ones((2048, 128), dtype=dtype, device=cuda_device)
    got = mm_kernel._launch(a, b, variant)
    assert bool((got.float() == 2048.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_wgmma_descriptor_probe_matches_plain_on_card(dtype, cuda_device):
    """One TMA stage, one warpgroup: C (64 x 256) = A (64 x 64) @ B (64 x
    256) on random inputs. A swapped leading and stride offset, a wrong
    swizzle or an untransposed B gives wrong values here, where a sweep of
    ones cannot see them."""
    from repro_torch.kernels.matmul_tile import kernel as mm_kernel
    from repro_torch.kernels.matmul_tile.ref import matmul_ref
    rng = np.random.default_rng(23)
    a = torch.from_numpy(rng.standard_normal((64, 64), np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 256), np.float32))
    a, b = a.to(cuda_device, dtype), b.to(cuda_device, dtype)
    got = mm_kernel.wgmma_probe(a, b)
    want = matmul_ref(a, b)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=2e-2,
                               atol=0.16)


@pytest.mark.cuda
def test_matmul_tile_refuses_what_the_contract_refuses_on_card(cuda_device):
    from repro_torch.kernels.matmul_tile.ops import matmul
    a = torch.zeros((4096, 768), dtype=torch.bfloat16, device=cuda_device)
    b = torch.zeros((768, 768), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="not divisible"):
        matmul(a, b)                       # bk 512 does not divide 768
    assert matmul(a, b, bk=256).shape == (4096, 768)
    with pytest.raises(ValueError, match="contiguous"):
        matmul(a, b.t(), bk=256)


# ------------------------------------------------------------ HybridLM decode
def _hybrid_decode(dtype, device, plain: bool, monkeypatch):
    """One decode_step of the reduced zamba2 (two groups; head dim 80, the
    shared block's on the full config) on the caches of a prefill of 39
    tokens, rows at positions 39 and 35; with ``plain`` its decode attention
    is the plain decode_attention_ref. Returns (logits, flash_decode
    launches in the step, groups)."""
    from repro_torch.config import reduced
    from repro_torch.configs import get
    from repro_torch.models import HybridLM, attention, build_model
    model = build_model(reduced(get("zamba2-2.7b"), head_dim=80,
                                dtype=dtype))
    assert isinstance(model, HybridLM)
    params = model.init(torch.Generator().manual_seed(0), device=device)
    B, S = 2, 40
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, model.cfg.vocab_size, (B, S))).to(device)
    if plain:
        monkeypatch.setattr(attention, "decode_attn", decode_attention_ref)
    with torch.no_grad():
        _, caches = model.prefill(params, {"tokens": toks[:, :-1]})
        cache = model.init_cache(B, S, device=device)
        for dst, src in zip((*cache["ssm"]["conv"], cache["ssm"]["ssm"]),
                            (*caches["ssm"]["conv"], caches["ssm"]["ssm"])):
            dst.copy_(src)
        for name in ("k", "v"):
            cache["attn"][name][:, :, :S - 1] = caches["attn"][name]
        before = fd_kernel.launches
        lg, _ = model.decode_step(params, cache, {
            "token": toks[:, -1], "pos": torch.tensor([S - 1, S - 5])})
        torch.cuda.synchronize()
    return lg, fd_kernel.launches - before, model.n_groups


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_decode_step_launches_flash_decode_per_group_on_card(
        dtype, cuda_device, monkeypatch):
    lg, launched, groups = _hybrid_decode(dtype, cuda_device, False,
                                          monkeypatch)
    assert groups == 2 and launched == groups
    assert bool(torch.isfinite(lg).all())


@pytest.mark.cuda
def test_hybrid_decode_step_matches_plain_attention_on_card(cuda_device,
                                                            monkeypatch):
    """The float32 model through the kernel against the same model with the
    plain decode attention, at FD_TOL (in bf16 a one-step difference of the
    attention output grows through the layers after it)."""
    got, launched, groups = _hybrid_decode("float32", cuda_device, False,
                                           monkeypatch)
    want, plain_launched, _ = _hybrid_decode("float32", cuda_device, True,
                                             monkeypatch)
    assert launched == groups and plain_launched == 0
    _fd_close(got, want)


@pytest.mark.cuda
def test_exanet_torch_scan_lane_matches_numpy_on_card(cuda_device):
    """The simulator's torch scan lane on the card against the numpy lane:
    the scans on seeded inputs bit for bit, and a 256-rank size grid and a
    scenario sweep replayed through ``engine="torch"`` within 1e-9."""
    from repro_torch.core.exanet import scan_engine as se
    from repro_torch.core.exanet import sim
    from repro_torch.core.exanet.mpi import ExanetMPI
    from repro_torch.core.exanet.params import DEFAULT, scaled_params
    from repro_torch.core.exanet.schedules import RecursiveDoublingAllreduce
    from repro_torch.core.program import cg_iteration
    eng = se.get_scan_engine("torch")
    assert eng.device.type == "cuda" and "torch" in se.available_engines()
    rng = np.random.default_rng(11)
    for batch in ((23,), (4, 23)):
        first = rng.random(300) < 0.2
        first[0] = True
        takes = sim.scan_take_masks(first, 300)
        D = rng.uniform(0.0, 5.0, (300, *batch))
        T = rng.uniform(0.0, 50.0, (300, *batch)) + D
        T[rng.random(T.shape) < 0.2] = -np.inf
        want = se.NUMPY.maxplus_scan(D.copy(), T.copy(), takes)
        for g, w in zip(eng.maxplus_scan(D, T, takes), want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            eng.running_max(T - D, takes),
            se.NUMPY.running_max(T - D, takes))
    mpi = ExanetMPI(scaled_params(255 * DEFAULT.cores_per_mpsoc + 1),
                    ranks_per_mpsoc=1)
    grid = tuple(1 << i for i in range(23))
    got = mpi.run_schedule_many(RecursiveDoublingAllreduce(), grid, 256,
                                engine="torch")
    want = mpi.run_schedule_many(RecursiveDoublingAllreduce(), grid, 256)
    np.testing.assert_allclose(got.latency_us, want.latency_us, rtol=1e-9)
    prog = cg_iteration(64, 70000, 30.0)
    cs, bs = rng.uniform(0.5, 2.0, 256), rng.uniform(0.25, 3.0, 256)
    got = mpi.run_program_scenarios(prog, compute_scale=cs, byte_scale=bs,
                                    engine="torch", check=4)
    want = mpi.run_program_scenarios(prog, compute_scale=cs, byte_scale=bs)
    for x, y in zip(got, want):
        assert x.latency_us == pytest.approx(y.latency_us, rel=1e-9)


@pytest.mark.cuda
def test_serve_and_train_sim_torch_lane_match_numpy_on_card(cuda_device):
    """The serve and train simulators' batched replays through the torch
    scan lane on the card against the numpy lane: a serve step table and
    a train candidate family within 1e-9, with scans on the card."""
    import dataclasses

    from repro_torch.core.exanet import scan_engine as se
    from repro_torch.serve.sim import ServeSim, ServeSimSpec
    from repro_torch.train.cosim import SyncCandidate, TrainSim, TrainStepSpec
    eng = se.get_scan_engine("torch")
    assert eng.device.type == "cuda"
    calls = sum(eng.calls.values())
    sim = ServeSim(ServeSimSpec(arch="deepseek-7b", nranks=32))
    got = sim.build_table(mc=2, rng=3, engine="torch", check=2)
    want = sim.build_table(mc=2, rng=3)
    np.testing.assert_allclose(got.us, want.us, rtol=1e-9, atol=0)
    tsim = TrainSim(TrainStepSpec(nranks=32, seq_len=512))
    base = SyncCandidate(8, tsim.feasible_algos()[0], 1)
    rng = np.random.default_rng(7)
    fam = [base] + [tsim.mutate(dataclasses.replace(base), rng)
                    for _ in range(12)]
    got = tsim.cost_candidates(fam, engine="torch", check=2)
    want = tsim.cost_candidates(fam)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
    assert sum(eng.calls.values()) > calls
