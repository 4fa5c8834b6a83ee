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
from hypothesis import given, settings, strategies as st

from repro.kernels.flash_decode.kernel import flash_decode as jax_flash_decode
from repro.kernels.flash_decode.ref import decode_attention_ref as jax_ref
from repro.models.attention import decode_attention as jax_decode_attention
from repro_torch.kernels import _build
from repro_torch.kernels.allreduce_combine.ops import combine_parts
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


def _merge_blocks(outs, lses):
    """The merge over ``data`` of a sequence split into blocks, as
    ``tensor_parallel.merge_softmax`` does it across ranks: the largest
    lse by ``combine`` (max), each block's weight exp(lse - M) (0 for an
    empty block), ``combine`` (sum) of ``[w out, w]`` in block order, the
    quotient."""
    lse = torch.stack(lses)
    m = combine_parts(lse.reshape(len(lses), -1), op="max").reshape(
        lse.shape[1:])
    packed = []
    for o, l in zip(outs, lses):
        w = torch.where(torch.isneginf(l), 0.0, torch.exp(l - m))
        packed.append(torch.cat([(o * w[..., None]).reshape(-1),
                                 w.reshape(-1)]))
    tot = combine_parts(torch.stack(packed), op="sum")
    num, den = tot.split([outs[0].numel(), lses[0].numel()])
    return num.reshape(outs[0].shape) / den.reshape(lses[0].shape)[..., None]


@settings(max_examples=30, deadline=None)
@given(n_blocks=st.sampled_from([1, 2, 3, 4, 8]),
       block=st.integers(1, 24), B=st.integers(1, 3),
       shape=st.sampled_from([(4, 2, 8, 8), (8, 8, 16, 8), (6, 2, 8, 16)]),
       data=st.data())
def test_lse_blocks_merge_to_the_whole_cache(n_blocks, block, B, shape,
                                             data):
    """The plain version's log-sum-exp form on each block of a split
    sequence (each row's block lengths in [0, block]: blocks past a row's
    length are empty), merged as the split decode merges over ``data``,
    equals the whole cache's attention at f32 1e-6, and the reference's
    jax decode attention on the whole cache."""
    H, K, dk, dv = shape
    S = n_blocks * block
    lengths = np.array(data.draw(st.lists(st.integers(1, S), min_size=B,
                                          max_size=B)), np.int32)
    q, k, v = _inputs(data.draw(st.integers(0, 2 ** 16)), B, H, K, dk, dv,
                      S)
    tq, tk, tv = _torch([q, k, v], "float32")
    whole = ops.decode_attn(tq, tk, tv, torch.from_numpy(lengths))
    outs, lses = [], []
    for j in range(n_blocks):
        n = torch.from_numpy(np.clip(lengths - j * block, 0, block))
        cut = slice(j * block, (j + 1) * block)
        o, l = ops.decode_attn(tq, tk[:, cut], tv[:, cut], n, lse=True)
        assert o.dtype == l.dtype == torch.float32 and l.shape == (B, H)
        assert (torch.isneginf(l) == (n == 0)[:, None]).all()
        outs.append(o)
        lses.append(l)
    got = _merge_blocks(outs, lses)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)
    want = jax_decode_attention(jnp.asarray(q)[:, None], jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(lengths - 1))
    np.testing.assert_allclose(got.numpy(), _f32(want[:, 0]),
                               rtol=TOL["float32"], atol=TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lse_form_on_empty_rows_and_its_output_rounded_is_the_plain(dtype):
    """A row of length 0 gives ``out`` 0 and ``lse`` -inf with no NaN (and
    the plain form 0 too); a live row's lse is the log-sum-exp of its
    scaled scores, and its float32 ``out`` rounded to q's dtype is the
    plain form's output bit for bit."""
    B, H, K, dk, dv, S = 3, 8, 2, 64, 64, 40
    q, k, v = _torch(_inputs(9, B, H, K, dk, dv, S), dtype)
    lengths = torch.tensor([0, 17, S], dtype=torch.int32)
    out, lse = ops.decode_attn(q, k, v, lengths, lse=True)
    plain = ops.decode_attn(q, k, v, lengths)
    assert out.dtype == lse.dtype == torch.float32
    assert torch.isfinite(out).all() and (out[0] == 0).all()
    assert (plain[0] == 0).all() and torch.isneginf(lse[0]).all()
    assert torch.equal(out.to(plain.dtype), plain)
    s = torch.einsum("bgrh,bkgh->bgrk", q.float().reshape(B, K, H // K, dk),
                     k.float()) * dk ** -0.5
    for b in (1, 2):
        want = torch.logsumexp(s[b, ..., :int(lengths[b])], -1).reshape(H)
        np.testing.assert_allclose(lse[b].numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
    empty, empty_lse = ops.decode_attn(q, k, v, 0, lse=True)
    assert (empty == 0).all() and torch.isneginf(empty_lse).all()


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
    for d in (32, 96):           # head dims with no instance
        qd, kd, vd = _torch(_inputs(6, 2, 4, 2, d, d, 32), "float32")
        with pytest.raises(ValueError, match="dk, dv"):
            fd_kernel.flash_decode(qd, kd, vd, lengths)
    with pytest.raises(ValueError, match="int32"):
        fd_kernel.flash_decode(q, k, v, lengths.long())
    with pytest.raises(ValueError, match="dtypes"):
        fd_kernel.flash_decode(q.half(), k.half(), v.half(), lengths)
    assert fd_kernel.launches == 0


def test_hbm_bytes_counts_live_rows_once():
    # 2 rows of lengths 3 and 5, K=2 heads of dk=dv=64 in bf16, H=4
    got = ops.hbm_bytes([3, 5], heads=4, kv_heads=2, dk=64, dv=64)
    assert got == 8 * 2 * 128 * 2 + 2 * 4 * 128 * 2 + 2 * 4


def test_hbm_bytes_of_the_lse_form():
    # the output in float32 and one f32 lse a row and head
    got = ops.hbm_bytes([3, 5], heads=4, kv_heads=2, dk=64, dv=64, lse=True)
    assert got == (8 * 2 * 128 * 2 + 2 * 4 * 64 * 2 + 2 * 4 * (64 + 1) * 4
                   + 2 * 4)


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


# ------------------------------------------------------------------ schedule
# (lengths, K, rep, n_ctas): rows of length 1 and S, ragged, all equal; CTAs
# fewer and more than the spans; the group sizes of the repo's configs (1, 3,
# 8, 9, 12) and 16
S_SCHED = 2048
SCHED_CASES = [
    ([1] * 8, 4, 3, 264),
    ([S_SCHED] * 8, 4, 3, 264),
    ([1, S_SCHED, 1230, 211, 573, 1001, 1200, 1407], 4, 3, 528),
    ([1, S_SCHED, 1230, 211, 573, 1001, 1200, 1407], 8, 8, 132),
    ([700] * 3, 4, 9, 120),
    ([33, 64, 65, 1], 8, 12, 7),
    ([S_SCHED, 1], 2, 16, 1000),
    ([5], 1, 1, 132),
    ([0, 96, 1], 2, 4, 5),
]


def _spans(lengths, K, rep, T):
    return K * fd_kernel.row_tiles(rep) * sum(max(1, -(-n // T))
                                             for n in lengths)


@pytest.mark.parametrize("case", SCHED_CASES)
def test_schedule_covers_each_live_position_once(case):
    lengths, K, rep, n_ctas = case
    B, tiles = len(lengths), fd_kernel.row_tiles(rep)
    segs = fd_kernel.schedule(lengths, B, K, tiles, n_ctas)
    seen = {}
    for cta, b, g, tile, start, end in segs:
        assert 0 <= cta < n_ctas and 0 <= g < K and 0 <= tile < tiles
        assert start % fd_kernel.SPAN == 0 and start <= end <= lengths[b]
        for pos in range(start, end):
            key = (b, g, tile, pos)
            assert key not in seen, f"{key} covered twice"
            seen[key] = cta
    want = {(b, g, t, pos) for b, n in enumerate(lengths) for g in range(K)
            for t in range(tiles) for pos in range(n)}
    assert set(seen) == want
    # every unit appears, so a row of length 0 still gets its output
    units = {(b, g, t) for _, b, g, t, *_ in segs}
    assert units == {(b, g, t) for b in range(B) for g in range(K)
                     for t in range(tiles)}


@pytest.mark.parametrize("case", SCHED_CASES)
def test_schedule_balances_spans_and_keeps_units_on_consecutive_ctas(case):
    lengths, K, rep, n_ctas = case
    B, T, tiles = len(lengths), fd_kernel.SPAN, fd_kernel.row_tiles(rep)
    segs = fd_kernel.schedule(lengths, B, K, tiles, n_ctas)
    per_cta = [0] * n_ctas
    for cta, b, g, tile, start, end in segs:
        per_cta[cta] += max(1, -(-(end - start) // T))
    N = _spans(lengths, K, rep, T)
    assert sum(per_cta) == N
    mean = N / n_ctas
    assert max(per_cta) <= mean + 1 and min(per_cta) >= mean - 1
    # empty CTAs only at the end; a unit's CTAs consecutive, in order
    busy = [n > 0 for n in per_cta]
    assert busy == sorted(busy, reverse=True)
    by_unit = {}
    for cta, b, g, tile, start, end in segs:
        by_unit.setdefault((b, g, tile), []).append((cta, start, end))
    for parts in by_unit.values():
        ctas = [c for c, _, _ in parts]
        assert ctas == list(range(ctas[0], ctas[0] + len(ctas)))
        assert all(parts[i][2] == parts[i + 1][1]
                   for i in range(len(parts) - 1))
        # each CTA holds at most two units in part: its first and its last
    for cta in range(n_ctas):
        mine = [(b, g, t) for c, b, g, t, *_ in segs if c == cta]
        shared = [u for u in mine if len(by_unit[u]) > 1]
        assert len(shared) <= 2
        assert all(u in (mine[0], mine[-1]) for u in shared)


@pytest.mark.parametrize("n_ctas", [1, 3, 132])
def test_schedule_same_shape_at_lengths_one_and_s(n_ctas):
    """At lengths of 1 each unit is one span; at S each unit is S / T spans;
    both partitions balance and cover, and CTAs beyond the spans idle."""
    B, K, rep, T = 8, 4, 3, fd_kernel.SPAN
    for n in (1, S_SCHED):
        segs = fd_kernel.schedule([n] * B, B, K, 1, n_ctas)
        N = B * K * -(-n // T)
        per_cta = [0] * n_ctas
        for cta, *_ , start, end in segs:
            per_cta[cta] += -(-(end - start) // T)
        assert sum(per_cta) == N
        assert max(per_cta) - min(per_cta) <= 1
        assert sum(1 for x in per_cta if x) == min(n_ctas, N)


@pytest.mark.parametrize("rep", [1, 3, 8, 9, 12, 16, 17])
def test_row_tiles_split_groups_evenly_without_padding(rep):
    tiles = fd_kernel.row_tiles(rep)
    rows = [fd_kernel.tile_rows(rep, t) for t in range(tiles)]
    assert rows[0][0] == 0 and rows[-1][1] == rep
    assert all(rows[i][1] == rows[i + 1][0] for i in range(tiles - 1))
    sizes = [r1 - r0 for r0, r1 in rows]
    assert max(sizes) <= fd_kernel.ROW_TILE and max(sizes) - min(sizes) <= 1
    if rep <= fd_kernel.ROW_TILE:
        assert sizes == [rep]                    # rep = 3: one tile of 3


def test_grid_depends_on_shapes_only():
    g = fd_kernel.grid_ctas(8, 4, 3, 2048, 132, 4)
    assert g == 528
    assert fd_kernel.grid_ctas(1, 1, 1, 32, 132, 4) == 1      # one span
    assert fd_kernel.grid_ctas(2, 2, 9, 100, 132, 2) == 2 * 2 * 2 * 4


def _split_merge(q, k, v, lengths, n_ctas, chunk=None, p_terms=None):
    """The kernel's arithmetic in float32 torch ops: each segment of
    :func:`schedule` gives a partial (m, l, acc) in log2 units, and each
    unit's partials are merged in CTA order, ``chunk`` at a time (all at
    once by default) with the running max and sum carried from pass to
    pass, as the merging CTA stages them. ``p_terms`` = 1 or 2: P enters
    P.V as one bf16 term, or as two (hi + lo, the bf16 kernel's form)."""
    B, H, dk = q.shape
    _, S, K, dv = v.shape
    rep = H // K
    tiles = fd_kernel.row_tiles(rep)
    scale = dk ** -0.5 * np.log2(np.e)
    parts = {}
    for cta, b, g, tile, start, end in fd_kernel.schedule(
            lengths.tolist(), B, K, tiles, n_ctas):
        r0, r1 = fd_kernel.tile_rows(rep, tile)
        qq = q[b, g * rep + r0:g * rep + r1].float() * scale
        s = qq @ k[b, start:end, g].float().T              # (rows, n)
        m = s.max(dim=1).values if end > start else torch.full(
            (r1 - r0,), -np.inf)
        p = torch.exp2(s - m[:, None])
        vv = v[b, start:end, g].float()
        if p_terms is None:
            pv = p @ vv
        else:
            hi = p.bfloat16().float()
            pv = hi @ vv + ((p - hi).bfloat16().float() @ vv
                            if p_terms == 2 else 0)
        parts.setdefault((b, g, tile), []).append((m, p.sum(dim=1), pv))
    out = torch.empty((B, H, dv))
    for (b, g, tile), ps in parts.items():
        r0, r1 = fd_kernel.tile_rows(rep, tile)
        M = torch.full((r1 - r0,), -np.inf)
        L, A = torch.zeros(r1 - r0), torch.zeros(r1 - r0, dv)
        n = chunk or len(ps)
        for c0 in range(0, len(ps), n):
            part = ps[c0:c0 + n]
            Mn = torch.maximum(M, torch.stack([m for m, _, _ in part])
                               .max(dim=0).values)
            so = torch.where(M == -np.inf, 0.0, torch.exp2(M - Mn))
            w = [torch.where(m == -np.inf, 0.0, torch.exp2(m - Mn))
                 for m, _, _ in part]
            L = L * so + sum(wi * l for wi, (_, l, _) in zip(w, part))
            A = A * so[:, None] + sum(wi[:, None] * a
                                      for wi, (_, _, a) in zip(w, part))
            M = Mn
        out[b, g * rep + r0:g * rep + r1] = A / L.clamp_min(1e-30)[:, None]
    return out


@pytest.mark.parametrize("n_ctas", [1, 5, 37, 528])
@pytest.mark.parametrize("shape", [(5, 8, 2, 64, 64, 200),
                                   (3, 36, 4, 80, 80, 97),
                                   (2, 32, 2, 64, 128, 130)])
def test_schedule_split_and_merge_match_reference(shape, n_ctas):
    """The partition and the merge the kernel runs give decode attention:
    the kernel's arithmetic on the CPU against the plain version and the
    JAX model's decode attention (rep 4, 9 in two tiles, 16)."""
    B, H, K, dk, dv, S = shape
    q, k, v = _torch(_inputs(8, B, H, K, dk, dv, S), "float32")
    lengths = np.random.default_rng(9).integers(1, S + 1, B).astype(np.int32)
    lengths[0], lengths[-1] = 1, S
    got = _split_merge(q, k, v, torch.from_numpy(lengths), n_ctas)
    want = ops.decode_attn(q, k, v, torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    jq, jk, jv = _jax([t.numpy() for t in (q, k, v)], "float32")
    want_jax = jax_decode_attention(jq[:, None], jk, jv,
                                    jnp.asarray(lengths - 1))[:, 0]
    np.testing.assert_allclose(got.numpy(), _f32(want_jax), rtol=1e-5,
                               atol=1e-5)



@pytest.mark.parametrize("chunk", [1, 2, 7])
@pytest.mark.parametrize("shape, n_ctas", [((2, 8, 1, 64, 64, 2000), 37),
                                           ((3, 36, 4, 80, 80, 700), 528)])
def test_merge_in_passes_matches_reference(shape, n_ctas, chunk):
    """The merge staged ``chunk`` partials at a time, where a unit is shared
    by more CTAs than that (the row of 2000 has 63 spans on 37 CTAs; rep 9
    in two tiles), gives what one pass gives: decode attention."""
    B, H, K, dk, dv, S = shape
    q, k, v = _torch(_inputs(8, B, H, K, dk, dv, S), "float32")
    lengths = np.random.default_rng(9).integers(1, S + 1, B).astype(np.int32)
    lengths[0], lengths[-1] = 1, S
    lengths = torch.from_numpy(lengths)
    segs = fd_kernel.schedule(lengths.tolist(), B, K,
                              fd_kernel.row_tiles(H // K), n_ctas)
    assert max(sum(seg[1:4] == u for seg in segs)
               for u in {seg[1:4] for seg in segs}) > chunk
    got = _split_merge(q, k, v, lengths, n_ctas, chunk=chunk)
    want = ops.decode_attn(q, k, v, lengths)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 8, 1, 64, 64, 2000),
                                   (3, 36, 4, 80, 80, 97),
                                   (4, 12, 4, 64, 64, 1000)])
def test_p_in_two_bf16_terms_keeps_pv_at_float32(shape):
    """The bf16 kernel's P.V on the tensor cores takes P as hi + lo in
    bf16: on bf16 inputs it stays at float32's accuracy, as the reference's
    float32 P.V, where P in one bf16 term would be far off."""
    B, H, K, dk, dv, S = shape
    q, k, v = (t.bfloat16().float() for t in
               _torch(_inputs(8, B, H, K, dk, dv, S), "float32"))
    lengths = np.random.default_rng(9).integers(1, S + 1, B).astype(np.int32)
    lengths[0], lengths[-1] = 1, S
    lengths = torch.from_numpy(lengths)
    want = ops.decode_attn(q, k, v, lengths)
    two = _split_merge(q, k, v, lengths, 37, p_terms=2)
    one = _split_merge(q, k, v, lengths, 37, p_terms=1)
    np.testing.assert_allclose(two.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert (one - want).abs().max() > 30 * (two - want).abs().max()
