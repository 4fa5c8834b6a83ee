// Flash-decoding for Hopper (sm_90a): one query token per head against a
// KV cache, with a per-row live length, in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode/kernel.py
// (flash_decode, body _fd_kernel): out[b,h] = softmax(q[b,h] . k[b,:len_b,g]
// * dk^-0.5) @ v[b,:len_b,g] with g = h / (H/K), softmax and accumulation in
// float32, the output in q's dtype. Unlike the TPU kernel it takes one length
// per row (the serving engine's slots sit at different depths), and S need
// not be a multiple of a chunk.
//
// What bounds it: bytes. Each live K/V row is read once and used for one
// multiply-add per query head in its group, so the work is
//   sum_b len_b * K * (dk + dv) * dtype_bytes  (+ q, the output, lengths)
// over the card's 3.35 TB/s: at rep = H/K <= 16 query heads per KV head,
// <= 16 flop per byte, far below the ~295 where the tensor cores would bound
// it. The design is about bytes in flight, fixed costs and balance:
//
// * One launch, on a grid fixed by the shapes and the SM count (the caller
//   passes it: kernel.grid_ctas), so a CUDA graph can capture the call. The
//   live positions of every unit (b, kv head g, query-row tile) are cut into
//   spans of kSpan positions. Each CTA reads the B lengths from device
//   memory, counts the spans (N in all) and takes a contiguous range of the
//   list ordered by (b, unit, span): the first N % C CTAs take N / C + 1
//   spans, the rest N / C, however ragged the rows; CTAs left empty are the
//   last ones, so the CTAs that share a unit are consecutive.
//   kernel.schedule in Python is the same partition; the CPU tests hold its
//   properties.
// * The merge in the same launch. A unit that lies within one CTA's range is
//   written to the output directly. Otherwise each CTA that holds part of it
//   writes its (m, l, acc) partial to f32 scratch (slot 0 for the first
//   segment of its range, 1 for the last), and one thread takes a ticket
//   from the unit's int32 counter with a release atomic whose value it
//   reads only when the range is done, so no barrier waits on the round
//   trip. The CTA that drew a unit's last ticket sets the counter back to 0
//   (so the next call and every graph replay start clean), stages the
//   partials through its free ring with cp.async and merges them in CTA
//   order, so every call gives the same bits. A thread-block cluster merge
//   through distributed shared memory would fix the number of CTAs per
//   unit, which fights the balance by live rows; tickets do not.
// * K and V through a cp.async ring in shared memory: kStages stages of one
//   span each (16-byte copies, up to 4 stages), prefetched across segment
//   boundaries. Positions >= len_b are zero-filled (src-size 0): they are
//   neither read nor attended to, and their scores are masked by a select,
//   never by a product.
// * Softmax per stage, not per position: each warp takes kPW = 8 positions
//   of the stage, computes their scores for the unit's rows, takes one max
//   and one rescale of its accumulator per stage and row (exp2, with
//   log2(e) * dk^-0.5 folded into the scale), then P.V. The rows of a GQA
//   group stay together (a tile of at most kRowTile rows; larger groups are
//   split evenly). In bfloat16 the two products run on the tensor cores
//   (mma.sync: q.K^T as m16n8k16, P.V as m16n8k8, the group's rows padded to
//   16, f32 accumulators): at rep = 8, d = 128 an FFMA form took longer than
//   streaming the bytes (PERF.md section 6). The reference multiplies P by V
//   in float32; a bf16 operand would round each weight by up to 2^-9, so P
//   goes in as two bf16 terms, hi + lo, which hold it to 2^-17, and l sums
//   it in f32. In float32 the products stay on the CUDA cores (FFMA), one
//   register row per unit row, none padded.
// * Rows in shared memory are padded to an odd number of 16-byte vectors,
//   so 8 lanes reading one vector each of 8 rows (ldmatrix, or a 16-byte
//   load) hit 8 different bank groups whatever the head dim (d = 80 in bf16
//   is 10 vectors: not a power of two).
//
// * The log-sum-exp form (kernel.flash_decode(..., lse=True)): the CTA that
//   writes a unit's output (the one whose range holds it whole, or the one
//   that merges its partials) also writes each row's natural log-sum-exp of
//   the scaled scores, (M + log2 L) ln 2, to an f32 (B, H) array, and the
//   output in f32, so that a merge of several blocks of one sequence (a
//   cache split over ranks) rounds once. A row of length 0 then gives
//   out = 0 and lse = -inf: its one span is all masked, so M stays -inf, L
//   and the accumulator 0, and no NaN arises. Nothing else changes: without
//   it the same arithmetic writes the same bits.
//
// The C entry point allocates nothing (the caller passes the output, the f32
// scratch and the zeroed tickets), launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSpan = 32;             // positions per span and stage (SPAN)
constexpr int kRowTile = 8;           // most query rows of a unit (ROW_TILE)
constexpr int kPW = kSpan / kWarps;   // positions per warp per stage
constexpr int kLP = 32 / kPW;         // f32: lanes that share one score
constexpr int kSmemBudget = 200 * 1024;  // the rest of 227 KB: lengths
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLn2 = 0.69314718055994531f;
constexpr int kMaxDevices = 64;
static_assert(kPW == 8, "a warp's positions are one mma n-tile");

template <typename T> struct Vec;     // elements in one 16-byte vector
template <> struct Vec<float> { static constexpr int kElems = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int kElems = 8; };

template <typename T>
constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;

// Shared memory of one CTA: the ring, then fixed areas, then the lengths.
template <typename T, int DK, int DV>
struct Layout {
  static constexpr int kVE = Vec<T>::kElems;
  static constexpr int kKCh = DK / kVE;             // 16-byte vectors per row
  static constexpr int kVCh = DV / kVE;
  static_assert(DK % 16 == 0 && DV % 16 == 0, "head dims in 16s");
  static_assert(kKCh % 2 == 0 && kVCh % 2 == 0, "padding makes it odd");
  static constexpr int kKRow = (kKCh + 1) * 16;     // bytes, padded
  static constexpr int kVRow = (kVCh + 1) * 16;
  static constexpr int kQRaw = kRowTile * DK * (int)sizeof(T);
  static constexpr int kStage = kSpan * (kKRow + kVRow) + kQRaw;
  // f32 P.V: lane = (vector of the V row, group of positions)
  static constexpr int kG = 32 / kVCh;
  static_assert(kTensorCores<T> || (kG >= 1 && kG <= kPW),
                "a V row fits one warp");
  // the warps' accumulator rows, padded by 8 floats: 8 rows' float2
  // stores at one column hit 8 different 32-byte bank windows
  static constexpr int kMwRow = DV + 8;
  // floats: f32 q, p, the warps' accumulators, their (m, l), (M, L)
  static constexpr int kFixedFloats = kRowTile * DK + kWarps * kRowTile * kPW
      + kWarps * kRowTile * kMwRow + 2 * kWarps * kRowTile + 2 * kRowTile;
  static constexpr int kFixed = 4 * kFixedFloats + 16;   // + 4 ints of flags
  static constexpr int kStagesFit = (kSmemBudget - kFixed) / kStage;
  static constexpr int kStages = kStagesFit < 4 ? kStagesFit : 4;
  static_assert(kStages >= 2, "two ring stages fit");
  static constexpr int kBytes = kStages * kStage + kFixed;
  // a partial in scratch: acc (kRowTile x DV), m (kRowTile), l (kRowTile)
  static constexpr int kPart = kRowTile * (DV + 2);
};

// four consecutive outputs x * inv in one store (8 or 16 bytes)
__device__ __forceinline__ void store4(float* p, float4 x, float inv) {
  *reinterpret_cast<float4*>(p) =
      make_float4(x.x * inv, x.y * inv, x.z * inv, x.w * inv);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x,
                                       float inv) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x * inv, x.y * inv);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z * inv, x.w * inv);
  uint2 v;
  v.x = *reinterpret_cast<const uint32_t*>(&lo);
  v.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two 8x8 b16 matrices; lane i < 16 gives the address of row i % 8 of
// matrix i / 8
__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_addr(p)));
}

// d += a (16x16) . b (16x8), a given by its rows 0..7 (a0: columns 0..7, a2:
// 8..15); rows 8..15 are padding (zero)
__device__ __forceinline__ void mma_k16(float* d, uint32_t a0, uint32_t a2,
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// d += a (16x8, rows 0..7 in a0, rows 8..15 zero) . b (8x8)
__device__ __forceinline__ void mma_k8(float* d, uint32_t a0, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(b0));
}

// the old value of *p, incremented by one after this thread's earlier
// writes, and those the CTA's barrier ordered before them, are visible to
// the GPU (a release, as CUTLASS's split-k semaphore)
__device__ __forceinline__ int atomic_add_release(int* p) {
  int old;
  asm volatile("atom.add.release.gpu.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

// (lo, hi) -> bf16x2 with lo in the low half, rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ int live_length(int len, int S) {
  return min(max(len, 0), S);
}

// Spans of a row of live length len: at least one, so a row of length 0
// still gets its output (zeros).
__device__ __forceinline__ int spans_of(int len) {
  return max(1, (len + kSpan - 1) / kSpan);
}

// The split of N spans over C CTAs: the first N % C CTAs take one span more
// than the rest, so CTAs left empty (N < C) are the last ones and the CTAs
// that share a unit are consecutive.
struct Split {
  long long q, rem;   // N / C, N % C
  __device__ __forceinline__ long long start(long long c) const {
    return c * q + min(c, rem);
  }
  // the CTA whose range holds span j
  __device__ __forceinline__ int cta_of(long long j) const {
    const long long big = rem * (q + 1);
    return (int)(j < big ? j / (q + 1) : rem + (j - big) / q);
  }
};

// One span of a CTA's range: row b, unit u = g * row_tiles + tile of that
// row, span s of the unit. The order is (b, u, s), as kernel.schedule's.
struct Cursor {
  int b, u, s;
};

__device__ __forceinline__ Cursor locate(const int* pre, int B, int units,
                                         long long j) {
  int lo = 0, hi = B - 1;   // the last b with units * pre[b] <= j
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if ((long long)units * pre[mid] <= j) lo = mid; else hi = mid - 1;
  }
  const int nb = pre[lo + 1] - pre[lo];
  const long long r = j - (long long)units * pre[lo];
  return {lo, (int)(r / nb), (int)(r % nb)};
}

__device__ __forceinline__ void advance(Cursor& c, const int* pre,
                                        int units) {
  if (++c.s == pre[c.b + 1] - pre[c.b]) {
    c.s = 0;
    if (++c.u == units) {
      c.u = 0;
      ++c.b;
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* out;
  float* part;      // (2 * C, kRowTile, DV + 2) f32: acc, then m, then l
  int* tickets;     // (B * K * row_tiles,) int32, zero at rest
  float* lse;       // (B, H) f32 (the lse form: out in f32), or null
  int B, H, S, K, rep, row_tiles;
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale_log2;   // dk^-0.5 * log2(e)
};

// A unit this CTA shares with others: it takes the unit's ticket, and
// merges it if last, once its range is done.
struct Merge {
  long long U0, orow;   // the unit's first span; its first output row
  int cf, cl, nrows;    // its CTAs; its rows
  int unit;             // its ticket: b * units + u
};

// Output row `row`'s four values from column d, times inv: in T, or in f32
// for the lse form.
template <typename T, int DV>
__device__ __forceinline__ void store_out(const Args& a, long long row, int d,
                                          float4 x, float inv) {
  if (a.lse != nullptr)
    store4(static_cast<float*>(a.out) + row * DV + d, x, inv);
  else
    store4(static_cast<T*>(a.out) + row * DV + d, x, inv);
}

// A row's natural log-sum-exp from its max M (log2 units: the scores times
// log2(e)) and its sum L of 2^(x - M); -inf for a row with no live position.
__device__ __forceinline__ float lse_of(float M, float L) {
  return L > 0.f ? (M + log2f(L)) * kLn2 : -INFINITY;
}

// Start the copies of span cur into a ring stage (K and V rows, and the
// unit's q rows when a segment starts there).
template <typename T, int DK, int DV>
__device__ __forceinline__ void issue(const Args& a, const Cursor& cur,
                                      unsigned char* stage, const int* lens,
                                      bool with_q) {
  using L = Layout<T, DK, DV>;
  const int g = cur.u / a.row_tiles, tile = cur.u % a.row_tiles;
  const int len = lens[cur.b];
  const int p0 = cur.s * kSpan;
  const T* kb = static_cast<const T*>(a.k) + cur.b * a.k_sb + g * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + cur.b * a.v_sb + g * a.v_sh;
  unsigned char* ks = stage;
  unsigned char* vs = stage + kSpan * L::kKRow;
  for (int i = threadIdx.x; i < kSpan * L::kKCh; i += kThreads) {
    const int t = i / L::kKCh, c = i % L::kKCh;
    const bool live = p0 + t < len;
    cp_async16(ks + t * L::kKRow + c * 16,
               kb + (live ? (long long)(p0 + t) * a.k_ss : 0) + c * L::kVE,
               live);
  }
  for (int i = threadIdx.x; i < kSpan * L::kVCh; i += kThreads) {
    const int t = i / L::kVCh, c = i % L::kVCh;
    const bool live = p0 + t < len;
    cp_async16(vs + t * L::kVRow + c * 16,
               vb + (live ? (long long)(p0 + t) * a.v_ss : 0) + c * L::kVE,
               live);
  }
  if (with_q) {
    const int r0 = tile * a.rep / a.row_tiles;
    const int nrows = (tile + 1) * a.rep / a.row_tiles - r0;
    const T* qb = static_cast<const T*>(a.q)
        + ((long long)cur.b * a.H + g * a.rep + r0) * DK;
    unsigned char* qs = vs + kSpan * L::kVRow;
    for (int i = threadIdx.x; i < nrows * L::kKCh; i += kThreads)
      cp_async16(qs + i * 16, qb + i * L::kVE, true);
  }
}

// Partials of nrows rows that one pass of merge_partials stages in the ring
// (kernel.merge_chunk reads it through fd_merge_chunk).
template <typename T, int DK, int DV>
__host__ __device__ constexpr int merge_chunk(int nrows) {
  return Layout<T, DK, DV>::kStages * Layout<T, DK, DV>::kStage
         / (4 * (nrows * DV + 2 * kRowTile));
}

// The partial of CTA c for the unit whose first span is U0: slot 0 if the
// unit starts the CTA's range, else 1 (the CTA's last segment).
template <int DV>
__device__ __forceinline__ const float* partial(const Args& a, const Split& sp,
                                                int c, long long U0) {
  return a.part + (2 * (long long)c + (sp.start(c) >= U0 ? 0 : 1))
                      * kRowTile * (DV + 2);
}

// Merge the partials of CTAs cf..cl, in CTA order, through the free ring: a
// chunk of partials (their nrows acc rows, their m and l) copied with
// cp.async in one round trip; per row (one warp each) the running max, the
// weights in place of the m's and L; then the weighted sums.
template <typename T, int DK, int DV>
__device__ void merge_partials(const Args& a, const Split& sp, const Merge& w,
                               unsigned char* ring, float* sc, float* Ms,
                               float* Ls) {
  using L = Layout<T, DK, DV>;
  constexpr int kEl = (kRowTile * DV / 4 + kThreads - 1) / kThreads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nrows = w.nrows;
  const int per = nrows * DV + 2 * kRowTile;        // floats per partial
  const int chunk = merge_chunk<T, DK, DV>(nrows);
  const int v_row = nrows * DV / 4, v_all = v_row + kRowTile / 2;
  float* st = reinterpret_cast<float*>(ring);
  float4 A[kEl];
#pragma unroll
  for (int e = 0; e < kEl; ++e) A[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();   // an earlier merge's reads of Ms, Ls are done
  if (tid < nrows) {
    Ms[tid] = -INFINITY;
    Ls[tid] = 0.f;
  }
  for (int c0 = w.cf; c0 <= w.cl; c0 += chunk) {
    const int nc = min(chunk, w.cl - c0 + 1);
    __syncthreads();   // the ring is free; Ms, Ls are set
    for (int i = tid; i < nc * v_all; i += kThreads) {
      const int cc = i / v_all, v = i % v_all;
      const float* pc = partial<DV>(a, sp, c0 + cc, w.U0);
      // acc rows 0..nrows-1 are contiguous; then the m, l block
      const float* src = v < v_row ? pc + 4 * v
                                   : pc + kRowTile * DV + 4 * (v - v_row);
      cp_async16(st + cc * per + 4 * v, src, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int r = warp; r < nrows; r += kWarps) {
      const float m_old = Ms[r];
      float M = -INFINITY;
      for (int cc = lane; cc < nc; cc += 32)
        M = fmaxf(M, st[cc * per + nrows * DV + r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        M = fmaxf(M, __shfl_xor_sync(kFull, M, off));
      M = fmaxf(M, m_old);
      float lsum = 0.f;
      for (int cc = lane; cc < nc; cc += 32) {
        float* mp = st + cc * per + nrows * DV + r;
        const float wv = *mp == -INFINITY ? 0.f : exp2f(*mp - M);
        *mp = wv;
        lsum = fmaf(mp[kRowTile], wv, lsum);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        lsum += __shfl_xor_sync(kFull, lsum, off);
      if (lane == 0) {
        const float so = m_old == -INFINITY ? 0.f : exp2f(m_old - M);
        Ms[r] = M;
        Ls[r] = fmaf(Ls[r], so, lsum);
        sc[r] = so;
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kEl; ++e) {
      const int idx = tid + e * kThreads;     // four columns of one row
      if (idx < nrows * DV / 4) {
        const int r = idx / (DV / 4);
        const float so = sc[r];
        float4 x = A[e];
        x.x *= so; x.y *= so; x.z *= so; x.w *= so;
        for (int cc = 0; cc < nc; ++cc) {
          const float wv = st[cc * per + nrows * DV + r];
          const float4 v = reinterpret_cast<const float4*>(st + cc * per)[idx];
          x.x = fmaf(wv, v.x, x.x);
          x.y = fmaf(wv, v.y, x.y);
          x.z = fmaf(wv, v.z, x.z);
          x.w = fmaf(wv, v.w, x.w);
        }
        A[e] = x;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kEl; ++e) {
    const int idx = tid + e * kThreads;
    if (idx < nrows * DV / 4) {
      const int r = idx / (DV / 4), d = 4 * (idx % (DV / 4));
      store_out<T, DV>(a, w.orow + r, d, A[e], 1.f / fmaxf(Ls[r], 1e-30f));
    }
  }
  if (a.lse != nullptr && tid < nrows)   // Ms, Ls are final since the pass
    a.lse[w.orow + tid] = lse_of(Ms[tid], Ls[tid]);
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
fd_decode_kernel(const Args a) {
  using L = Layout<T, DK, DV>;
  constexpr int kVE = L::kVE;
  constexpr bool kTC = kTensorCores<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qf = reinterpret_cast<float*>(smem + L::kStages * L::kStage);
  float* ps = qf + kRowTile * DK;               // [warp][row][kPW]
  float* mw = ps + kWarps * kRowTile * kPW;     // [warp][row][kMwRow]
  float* mm = mw + kWarps * kRowTile * L::kMwRow;   // [warp][row]
  float* ml = mm + kWarps * kRowTile;
  float* Ms = ml + kWarps * kRowTile;           // [row]
  float* Ls = Ms + kRowTile;
  int* flag = reinterpret_cast<int*>(Ls + kRowTile);
  int* lens = flag + 4;                         // [B]
  int* pre = lens + a.B;                        // [B + 1] spans before row b

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = a.B, C = gridDim.x;

  // ---- the schedule (kernel.schedule is the same partition)
  for (int b = tid; b < B; b += kThreads) {
    const int len = live_length(a.lengths[b], a.S);
    lens[b] = len;
    pre[b + 1] = spans_of(len);
  }
  __syncthreads();
  if (warp == 0) {   // inclusive scan of pre[1..B]
    int carry = 0;
    for (int base = 1; base <= B; base += 32) {
      const int idx = base + lane;
      int x = idx <= B ? pre[idx] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, x, off);
        if (lane >= off) x += y;
      }
      x += carry;
      if (idx <= B) pre[idx] = x;
      carry = __shfl_sync(kFull, x, 31);
    }
    if (lane == 0) pre[0] = 0;
  }
  __syncthreads();
  const int units = a.K * a.row_tiles;
  const long long N = (long long)units * pre[B];
  const Split sp{N / C, N % C};
  const long long J0 = sp.start(blockIdx.x), J1 = sp.start(blockIdx.x + 1);
  if (J0 >= J1) return;
  const int nsp = (int)(J1 - J0);

  // ---- prologue: the first kStages - 1 spans in flight
  Cursor ld = locate(pre, B, units, J0);
  Cursor cu = ld;
#pragma unroll
  for (int i = 0; i < L::kStages - 1; ++i) {
    if (i < nsp) {
      issue<T, DK, DV>(a, ld, smem + i * L::kStage, lens, i == 0 || ld.s == 0);
      advance(ld, pre, units);
    }
    cp_async_commit();
  }

  // bf16 (mma fragments): lane = (row gq of the group, pair tq of positions)
  const int gq = lane >> 2, tq = lane & 3;
  // f32: scores lane = (position p, part h of the row); P.V lane = (vector
  // ch of the V row, group grp of positions)
  const int p = lane % kPW, h = lane / kPW;
  const int ch = lane % L::kVCh, grp = lane / L::kVCh;

  // bf16: row gq's (m, l); o[j] the m16n8 accumulator of columns 8j..8j+7
  // (entries 2, 3: the padded rows 8..15); qa the q fragments
  float mq = -INFINITY, lq = 0.f;
  float o[kTC ? DV / 8 : 1][4];
  uint32_t qa[kTC ? DK / 16 : 1][2];
  // f32: every row's (m, l, acc)
  float m[kRowTile], l[kRowTile], acc[kTC ? 1 : kRowTile][kVE];
  auto reset = [&]() {
    mq = -INFINITY;
    lq = 0.f;
#pragma unroll
    for (int j = 0; j < (kTC ? DV / 8 : 1); ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < kVE; ++e) acc[kTC ? 0 : r][e] = 0.f;
    }
  };
  reset();

  Merge todo[2];       // at most the first and the last segment are shared
  int ticket[2] = {0, 0}, n_todo = 0;

  for (int i = 0; i < nsp; ++i) {
    cp_async_wait<L::kStages - 2>();   // span i has landed (this thread's)
    __syncthreads();                   // ... everyone's; span i-1 is done
    {
      const int li = i + L::kStages - 1;
      if (li < nsp) {
        issue<T, DK, DV>(a, ld, smem + (li % L::kStages) * L::kStage, lens,
                         ld.s == 0);
        advance(ld, pre, units);
      }
      cp_async_commit();
    }
    const unsigned char* stage = smem + (i % L::kStages) * L::kStage;
    const unsigned char* ks = stage;
    const unsigned char* vs = stage + kSpan * L::kKRow;
    const T* qraw = reinterpret_cast<const T*>(vs + kSpan * L::kVRow);
    const int b = cu.b, g = cu.u / a.row_tiles, tile = cu.u % a.row_tiles;
    const int r0 = tile * a.rep / a.row_tiles;
    const int nrows = (tile + 1) * a.rep / a.row_tiles - r0;
    const int len = lens[b];
    const int nb = pre[b + 1] - pre[b];
    const bool seg_start = i == 0 || cu.s == 0;
    const int pos0 = cu.s * kSpan + warp * kPW;   // the warp's positions

    if constexpr (kTC) {
      // ---- bf16: q.K^T and P.V on the tensor cores
      if (seg_start) {   // the unit's q rows as A fragments (rows >= nrows: 0)
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk) {
          const uint32_t* qr = reinterpret_cast<const uint32_t*>(
              qraw + gq * DK + kk * 16 + 2 * tq);
          qa[kk][0] = gq < nrows ? qr[0] : 0u;
          qa[kk][1] = gq < nrows ? qr[4] : 0u;
        }
      }
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
      const unsigned char* krow =
          ks + (warp * kPW + (lane & 7)) * L::kKRow + ((lane >> 3) & 1) * 16;
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        uint32_t b0, b1;
        ldmatrix_x2(b0, b1, krow + kk * 32);
        mma_k16(s4, qa[kk][0], qa[kk][1], b0, b1);
      }
      // row gq, positions 2tq and 2tq + 1 of the warp's eight
      const bool v0 = pos0 + 2 * tq < len, v1 = pos0 + 2 * tq + 1 < len;
      const float x0 = v0 ? s4[0] * a.scale_log2 : -INFINITY;
      const float x1 = v1 ? s4[1] * a.scale_log2 : -INFINITY;
      float mx = fmaxf(x0, x1);
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float mn = fmaxf(mq, mx);
      const float c = mn == -INFINITY ? 1.f : exp2f(mq - mn);
      const float p0 = v0 ? exp2f(x0 - mn) : 0.f;
      const float p1 = v1 ? exp2f(x1 - mn) : 0.f;
      lq = fmaf(lq, c, p0 + p1);
      mq = mn;
      // P = hi + lo in bf16: hi rounds p, lo rounds what hi left out
      const __nv_bfloat162 ph = __floats2bfloat162_rn(p0, p1);
      const uint32_t pa = *reinterpret_cast<const uint32_t*>(&ph);
      const uint32_t pl =
          pack_bf16(p0 - __low2float(ph), p1 - __high2float(ph));
      const unsigned char* vrow =
          vs + (warp * kPW + (lane & 7)) * L::kVRow + ((lane >> 3) & 1) * 16;
#pragma unroll
      for (int j = 0; j < DV / 8; j += 2) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vrow + j * 16);
        o[j][0] *= c;
        o[j][1] *= c;
        o[j + 1][0] *= c;
        o[j + 1][1] *= c;
        mma_k8(o[j], pa, b0);
        mma_k8(o[j + 1], pa, b1);
        mma_k8(o[j], pl, b0);
        mma_k8(o[j + 1], pl, b1);
      }
    } else {
      // ---- f32: FFMA, one register row per unit row
      if (seg_start) {   // the unit's q rows, scaled
        for (int idx = tid; idx < nrows * DK; idx += kThreads)
          qf[idx] = qraw[idx] * a.scale_log2;
        __syncthreads();
      }
      const int t = warp * kPW + p;
      const bool valid = pos0 + p < len;
      float s[kRowTile];
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) s[r] = 0.f;
#pragma unroll
      for (int it = 0; it < (L::kKCh + kLP - 1) / kLP; ++it) {
        const int c = h + it * kLP;
        if (c < L::kKCh) {
          const float4 kf =
              *reinterpret_cast<const float4*>(ks + t * L::kKRow + c * 16);
#pragma unroll
          for (int r = 0; r < kRowTile; ++r) {
            if (r < nrows) {
              const float4 qq =
                  *reinterpret_cast<const float4*>(qf + r * DK + c * kVE);
              float x = s[r];
              x = fmaf(qq.x, kf.x, x);
              x = fmaf(qq.y, kf.y, x);
              x = fmaf(qq.z, kf.z, x);
              x = fmaf(qq.w, kf.w, x);
              s[r] = x;
            }
          }
        }
      }
      // one max and one rescale per stage and row; p by a select
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) {
        if (r < nrows) {
#pragma unroll
          for (int off = kPW; off < 32; off <<= 1)
            s[r] += __shfl_xor_sync(kFull, s[r], off);
          const float x = valid ? s[r] : -INFINITY;
          float mx = x;
#pragma unroll
          for (int off = 1; off < kPW; off <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
          const float mn = fmaxf(m[r], mx);
          const float c = mn == -INFINITY ? 1.f : exp2f(m[r] - mn);
          const float pr = valid ? exp2f(x - mn) : 0.f;
          l[r] = fmaf(l[r], c, pr);
          m[r] = mn;
#pragma unroll
          for (int e = 0; e < kVE; ++e) acc[kTC ? 0 : r][e] *= c;
          if (h == 0) ps[(warp * kRowTile + r) * kPW + p] = pr;
        }
      }
      __syncwarp();
      if (lane < L::kG * L::kVCh) {
#pragma unroll
        for (int tt0 = 0; tt0 < kPW; tt0 += L::kG) {
          const int tt = tt0 + grp;
          if (tt < kPW) {
            const float4 vf = *reinterpret_cast<const float4*>(
                vs + (warp * kPW + tt) * L::kVRow + ch * 16);
#pragma unroll
            for (int r = 0; r < kRowTile; ++r) {
              if (r < nrows) {
                const float pr = ps[(warp * kRowTile + r) * kPW + tt];
                float* ar = acc[kTC ? 0 : r];
                ar[0] = fmaf(pr, vf.x, ar[0]);
                ar[1] = fmaf(pr, vf.y, ar[1]);
                ar[2] = fmaf(pr, vf.z, ar[2]);
                ar[3] = fmaf(pr, vf.w, ar[3]);
              }
            }
          }
        }
      }
    }

    if (i == nsp - 1 || cu.s == nb - 1) {
      // ---- segment end: each warp's (m, l, acc) to shared memory ...
      const long long U0 = (long long)units * pre[b] + (long long)cu.u * nb;
      const int cf = sp.cta_of(U0), cl = sp.cta_of(U0 + nb - 1);
      const long long orow = (long long)b * a.H + g * a.rep + r0;
      if constexpr (kTC) {
        lq += __shfl_xor_sync(kFull, lq, 1);
        lq += __shfl_xor_sync(kFull, lq, 2);
        if (gq < nrows) {
          float* dst = mw + (warp * kRowTile + gq) * L::kMwRow + 2 * tq;
#pragma unroll
          for (int j = 0; j < DV / 8; ++j)
            *reinterpret_cast<float2*>(dst + 8 * j) =
                make_float2(o[j][0], o[j][1]);
          if (tq == 0) {
            mm[warp * kRowTile + gq] = mq;
            ml[warp * kRowTile + gq] = lq;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < kRowTile; ++r) {
          if (r < nrows) {
#pragma unroll
            for (int off = 1; off < kPW; off <<= 1)
              l[r] += __shfl_xor_sync(kFull, l[r], off);
#pragma unroll
            for (int e = 0; e < kVE; ++e) {
              const float x = acc[kTC ? 0 : r][e];
              float sum = x;
#pragma unroll
              for (int gi = 1; gi < L::kG; ++gi)
                sum += __shfl_down_sync(kFull, x, gi * L::kVCh);
              if (lane < L::kVCh)
                mw[(warp * kRowTile + r) * L::kMwRow + lane * kVE + e] = sum;
            }
            if (lane == 0) {
              mm[warp * kRowTile + r] = m[r];
              ml[warp * kRowTile + r] = l[r];
            }
          }
        }
      }
      __syncthreads();
      // ... merged over the warps in a fixed order, each element on its own
      const bool whole = cf == cl;
      const int slot = 2 * blockIdx.x + (J0 >= U0 ? 0 : 1);
      float* mine = a.part + (long long)slot * L::kPart;
      for (int idx = tid; idx < nrows * DV / 4; idx += kThreads) {
        const int r = idx / (DV / 4), d = 4 * (idx % (DV / 4));
        float M = -INFINITY;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) M = fmaxf(M, mm[w * kRowTile + r]);
        float Lsum = 0.f;
        float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float mv = mm[w * kRowTile + r];
          const float wv = mv == -INFINITY ? 0.f : exp2f(mv - M);
          const float4 x = *reinterpret_cast<const float4*>(
              mw + (w * kRowTile + r) * L::kMwRow + d);
          Lsum = fmaf(ml[w * kRowTile + r], wv, Lsum);
          A.x = fmaf(x.x, wv, A.x);
          A.y = fmaf(x.y, wv, A.y);
          A.z = fmaf(x.z, wv, A.z);
          A.w = fmaf(x.w, wv, A.w);
        }
        if (whole) {
          store_out<T, DV>(a, orow + r, d, A, 1.f / fmaxf(Lsum, 1e-30f));
          if (a.lse != nullptr && d == 0) a.lse[orow + r] = lse_of(M, Lsum);
        } else {
          *reinterpret_cast<float4*>(mine + r * DV + d) = A;
          if (d == 0) {
            mine[kRowTile * DV + r] = M;
            mine[kRowTile * DV + kRowTile + r] = Lsum;
          }
        }
      }
      if (!whole) {   // ---- the unit's ticket; read at the end of the range
        __syncthreads();          // the partial is written ...
        if (tid == 0)             // ... and released to the last CTA
          ticket[n_todo] = atomic_add_release(a.tickets + b * units + cu.u);
        todo[n_todo++] = {U0, orow, cf, cl, nrows, b * units + cu.u};
      }
      reset();
    }
    advance(cu, pre, units);
  }
  cp_async_wait<0>();
  if (n_todo == 0) return;
  // ---- the range is done: merge the shared units whose last ticket this
  // CTA drew
  if (tid == 0) {
    __threadfence();              // acquire: after the tickets were read
    for (int k = 0; k < n_todo; ++k) {
      const Merge& w = todo[k];
      flag[k] = ticket[k] == w.cl - w.cf;
      if (flag[k]) a.tickets[w.unit] = 0;   // clean for the next call
    }
  }
  __syncthreads();
  for (int k = 0; k < n_todo; ++k)
    if (flag[k]) merge_partials<T, DK, DV>(a, sp, todo[k], smem, mm, Ms, Ls);
}

template <typename T, int DK, int DV>
size_t smem_bytes(int B) {
  return Layout<T, DK, DV>::kBytes + sizeof(int) * (2 * (size_t)B + 1);
}

// once per device and instance: more than the default 48 KB of dynamic
// shared memory (the most any B can ask for)
template <typename T, int DK, int DV>
cudaError_t allow_smem(int device) {
  static bool set[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (set[device]) return cudaSuccess;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fd_decode_kernel<T, DK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err == cudaSuccess) set[device] = true;
  return err;
}

template <typename T, int DK, int DV>
cudaError_t launch(int device, const Args& a, int n_ctas,
                   cudaStream_t stream) {
  cudaError_t err = allow_smem<T, DK, DV>(device);
  if (err != cudaSuccess) return err;
  fd_decode_kernel<T, DK, DV>
      <<<n_ctas, kThreads, smem_bytes<T, DK, DV>(a.B), stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DK, int DV>
cudaError_t occupancy(int device, int B, int* blocks) {
  cudaError_t err = allow_smem<T, DK, DV>(device);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fd_decode_kernel<T, DK, DV>, kThreads,
      smem_bytes<T, DK, DV>(B));
}

template <typename T> constexpr int dtype_code();
template <> constexpr int dtype_code<float>() { return 0; }
template <> constexpr int dtype_code<__nv_bfloat16>() { return 1; }

}  // namespace

// the instances: (dtype, dk, dv); kernel.HEAD_DIMS. (16, 16) is the reduced
// configs' head dim (the serve_lm example's model)
#define FD_INSTANCES(X)                                                       \
  X(float, 64, 64) X(float, 128, 128) X(float, 64, 128) X(float, 80, 80)      \
  X(float, 16, 16)                                                            \
  X(__nv_bfloat16, 64, 64) X(__nv_bfloat16, 128, 128)                         \
  X(__nv_bfloat16, 64, 128) X(__nv_bfloat16, 80, 80)                          \
  X(__nv_bfloat16, 16, 16)

// dtype: 0 = float32, 1 = bfloat16; (dk, dv) as in FD_INSTANCES. q (B,H,dk)
// and out (B,H,dv) are contiguous; lse is a contiguous (B,H) f32 array, and
// out then in float32, or null, and out in q's dtype; k/v strides are in
// elements (batch, position, kv head) with the head dim contiguous; lengths
// is (B,) int32; part is (2 * n_ctas, 8, dv + 2) f32; tickets is (B * K *
// row_tiles,) int32, all zero. n_ctas is the grid (kernel.grid_ctas).
extern "C" int fd_launch(int device, int dtype, int dk, int dv, const void* q,
                         const void* k, const void* v, const void* lengths,
                         void* out, void* part, void* tickets, void* lse,
                         int B, int H, int S, int K, long long k_sb,
                         long long k_ss, long long k_sh, long long v_sb,
                         long long v_ss, long long v_sh, int n_ctas,
                         float scale_log2, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int rep = H / K;
  Args a{q, k, v, static_cast<const int*>(lengths), out,
         static_cast<float*>(part), static_cast<int*>(tickets),
         static_cast<float*>(lse), B, H, S, K, rep,
         (rep + kRowTile - 1) / kRowTile, k_sb, k_ss, k_sh, v_sb, v_ss,
         v_sh, scale_log2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FD_CASE(T, DK_, DV_)                                                  \
  if (dtype == dtype_code<T>() && dk == DK_ && dv == DV_)                     \
    return (int)launch<T, DK_, DV_>(device, a, n_ctas, st);
  FD_INSTANCES(FD_CASE)
#undef FD_CASE
  return (int)cudaErrorInvalidValue;
}

// CTAs of the instance one SM holds at once, for a batch of B rows.
extern "C" int fd_blocks_per_sm(int device, int dtype, int dk, int dv, int B,
                                int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
#define FD_CASE(T, DK_, DV_)                                                  \
  if (dtype == dtype_code<T>() && dk == DK_ && dv == DV_)                     \
    return (int)occupancy<T, DK_, DV_>(device, B, blocks);
  FD_INSTANCES(FD_CASE)
#undef FD_CASE
  return (int)cudaErrorInvalidValue;
}

// Partials of nrows rows that one merge pass of the instance stages; 0 for
// an instance the library does not have.
extern "C" int fd_merge_chunk(int dtype, int dk, int dv, int nrows) {
#define FD_CASE(T, DK_, DV_)                                                  \
  if (dtype == dtype_code<T>() && dk == DK_ && dv == DV_)                     \
    return merge_chunk<T, DK_, DV_>(nrows);
  FD_INSTANCES(FD_CASE)
#undef FD_CASE
  return 0;
}

extern "C" const char* fd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
