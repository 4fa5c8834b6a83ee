// Tiled matrix product C = A @ B for Hopper: float32 accumulation over the
// whole K sweep, C written once in A's dtype.
//
// Replaces the Pallas TPU kernel repro.kernels.matmul_tile.kernel.matmul_tile
// (body _mm_kernel), the repository's form of the paper's section 7 MatMul
// accelerator: an output tile whose accumulator stays on chip across the K
// sweep. A is (M,K) and B is (K,N), both row-major and contiguous.
//
// What bounds it on the H100: operations, at the sizes it is used at. A
// square bf16 product of side n does 2n^3 operations on 6n^2 bytes, n/3 a
// byte, against the ~295 the card needs before its tensor cores rather than
// its memory are the limit: from n ~ 900 the tensor cores are the limit (in
// float32, outside them, from n ~ 120). Three variants, chosen by dtype and
// alignment before the launch (the wrapper's variant_for):
//
//   wgmma      bf16/f16 where K and N are multiples of 8 and the pointers
//              16-byte aligned (TMA's own conditions). Only wgmma reaches the
//              tensor cores' full rate on Hopper, and it must be fed without
//              the multiplying warps spending instructions on copies: one
//              producer thread starts TMA loads of A (M,K: K-major) and B
//              (K,N: MN-major, the instruction's transpose-B) into a ring of
//              128-byte-swizzled stages, K 64 deep, completed on mbarriers;
//              one or two consumer warpgroups (registers moved to them with
//              setmaxnreg) run wgmma m64nBNk16 on each stage and hand it back
//              through an "empty" mbarrier while the next stage's products
//              run. Persistent: min(tiles, SMs) blocks walk the output tiles
//              in groups of 8 tile rows, so blocks running together share A
//              rows and B columns in L2, and the producer loads the next tile
//              while the consumers store this one. Each consumer writes its
//              tile into a swizzled 16 KB staging buffer, 128 columns at a
//              time, and one of its threads stores it by TMA, so the global
//              stores run under the next tile's products (stored straight
//              from registers, the tensor cores waited out every epilogue).
//              TMA fills past M, N and K with zeros on loads and clips at M
//              and N on stores. Tile by problem size (variant_for): 128x256
//              (two consumers, 4 stages) where that gives at least 128 tiles,
//              else 128x128 (two consumers, 6 stages), else 64x128 (one
//              consumer, 8 stages): a tile count under the 132 SMs leaves SMs
//              idle, and a smaller tile re-reads A and B more often. No
//              split-K: it would change the order of the float32 sum and need
//              a second pass.
//   mma_sync   bf16/f16 rows TMA cannot address (K or N not a multiple of 8,
//              or a pointer off 16 bytes): a 128x128 tile per block of 8
//              warps, K 32 deep through a 3-stage cp.async ring (element by
//              element where rows are not 16-byte aligned); ldmatrix (.trans
//              for B) feeds mma.sync m16n8k16, the Ampere form, about half of
//              wgmma's rate here. Shared rows padded by 16 bytes against
//              ldmatrix bank conflicts.
//   ffma       float32 on the CUDA cores, never TF32 (the reference's float32
//              tolerance is 1e-3 and its 2048-ones sweep is exact): bound by
//              the FFMA instruction rate. A 128x128 tile per block of 256
//              threads, 8x8 outputs a thread, K 32 deep through a 3-stage
//              cp.async ring (one block an SM: 167 registers a thread, 104 KB
//              of ring). A's tile is stored as it lies (rows 36 floats apart,
//              so the two rows a warp reads together sit 16 banks apart; no
//              transposing store) and read as 4-deep float4 runs, B's as
//              4-wide float4 runs: one barrier per 32 depths, 1024 FMAs a
//              thread between barriers. Each output adds its K products in
//              order. Deeper or shallower rings, two blocks an SM at 128
//              registers and fragments loaded a step ahead were each no
//              faster on the H100 (PERF.md).
//
// Any M, N, K >= 1: rows, columns and depth past an edge load as zeros and
// outputs past an edge are not stored. The TPU kernel's tile contract (M, N,
// K divisible by its clamped bm, bn, bk) is the wrapper's check_args; this
// kernel picks its own tiles.
//
// Plain C interface, bound with ctypes (repro_torch/kernels/matmul_tile/
// kernel.py): mm_launch returns cudaGetLastError() after the launch, or
// kTmaError + the CUresult of cuTensorMapEncodeTiled when a TMA descriptor
// cannot be made.

#include <cuda.h>   // CUtensorMap and its enums; cuTensorMapEncodeTiled is
                    // looked up at run time, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2 };
enum Variant { kFfma = 0, kMmaSync = 1, kWgmma = 2 };

constexpr int kBM = 128, kBN = 128;
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr int kTmaError = 10000;

// ------------------------------------------------- bf16 / f16: mma_sync
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kALd = kBK + 8;         // 40 elements: 80 bytes a row
constexpr int kBLd = kBN + 8;         // 136 elements: 272 bytes a row
constexpr int kAStage = kBM * kALd;   // elements of one stage's A tile
constexpr int kBStage = kBK * kBLd;   // elements of one stage's B tile
constexpr int kSmem16 = kStages * (kAStage + kBStage) * 2;   // 56,832 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid false no byte is read and the 16
// bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (16x16, row) * b (16x8, col), float32 accumulators
template <typename T>
struct Mma;
template <>
struct Mma<__nv_bfloat16> {
  __device__ __forceinline__ static void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __device__ __forceinline__ static __nv_bfloat16 out(float x) {
    return __float2bfloat16_rn(x);
  }
  // (x0, x1) rounded, x0 at the lower address
  __device__ __forceinline__ static uint32_t pack2(float x0, float x1) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};
template <>
struct Mma<__half> {
  __device__ __forceinline__ static void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __device__ __forceinline__ static __half out(float x) {
    return __float2half_rn(x);
  }
  __device__ __forceinline__ static uint32_t pack2(float x0, float x1) {
    const __half2 v = __floats2half2_rn(x0, x1);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

// One stage: A rows m0.. x depth k0..k0+31 and B depth k0.. x columns
// n0..n0+127, as raw 16-bit values, zeros past the edges. Each thread moves
// 2 chunks of 8 elements of each.
template <bool kVec>
__device__ __forceinline__ void load_stage16(uint16_t* as, uint16_t* bs,
                                             const uint16_t* A,
                                             const uint16_t* B, int M, int N,
                                             int K, int m0, int n0, int k0,
                                             int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 2, col = (c & 3) * 8;      // 128 rows x 4 chunks
    const int gm = m0 + r, gk = k0 + col;
    uint16_t* dst = as + r * kALd + col;
    if (kVec) {   // K % 8 == 0: a chunk lies wholly inside or outside
      const bool ok = gm < M && gk < K;
      cp_async16(dst, ok ? A + (size_t)gm * K + gk : A, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gm < M && gk + e < K) ? A[(size_t)gm * K + gk + e] : 0;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 4, col = (c & 15) * 8;     // 32 rows x 16 chunks
    const int gk = k0 + r, gn = n0 + col;
    uint16_t* dst = bs + r * kBLd + col;
    if (kVec) {   // N % 8 == 0
      const bool ok = gk < K && gn < N;
      cp_async16(dst, ok ? B + (size_t)gk * N + gn : B, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gk < K && gn + e < N) ? B[(size_t)gk * N + gn + e] : 0;
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
mm16_kernel(const uint16_t* __restrict__ A, const uint16_t* __restrict__ B,
            T* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(16) uint16_t smem16[];
  uint16_t* As = smem16;                        // kStages x (128 x kALd)
  uint16_t* Bs = smem16 + kStages * kAStage;    // kStages x (32 x kBLd)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;      // warp tile 64 x 32
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int ktiles = (K + kBK - 1) / kBK;

  float acc[4][4][4];                           // [m16 tile][n8 tile][4]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles)
      load_stage16<kVec>(As + s * kAStage, Bs + s * kBStage, A, B, M, N, K,
                         m0, n0, s * kBK, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();   // stage kt has landed (this thread's)
    __syncthreads();                // ... everyone's; stage kt-1 is free
    const int nxt = kt + kStages - 1;
    if (nxt < ktiles)
      load_stage16<kVec>(As + (nxt % kStages) * kAStage,
                         Bs + (nxt % kStages) * kBStage, A, B, M, N, K, m0,
                         n0, nxt * kBK, tid);
    cp_async_commit();
    const uint16_t* as = As + (kt % kStages) * kAStage;
    const uint16_t* bs = Bs + (kt % kStages) * kBStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        // lanes 0-15 give rows 0-15 at depth kk, lanes 16-31 at kk + 8:
        // the four 8x8 matrices are a0..a3 of the mma's A fragment
        const int r = wm * 64 + mt * 16 + (lane & 15);
        ldmatrix_x4(af[mt], as + r * kALd + kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        // matrices: (depth kk, n tile 2np), (kk + 8, 2np), (kk, 2np + 1),
        // (kk + 8, 2np + 1); transposed, each is a b0 or b1 fragment
        const int q = lane >> 3;
        const int r = kk + (q & 1) * 8 + (lane & 7);
        const int col = wn * 32 + (np * 2 + (q >> 1)) * 8;
        uint32_t t[4];
        ldmatrix_x4_trans(t, bs + r * kBLd + col);
        bf[np * 2][0] = t[0];
        bf[np * 2][1] = t[1];
        bf[np * 2 + 1][0] = t[2];
        bf[np * 2 + 1][1] = t[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) Mma<T>::run(acc[mt][nt], af[mt], bf[nt]);
    }
  }
  cp_async_wait<0>();

  // accumulator fragment: rows lane/4 and lane/4 + 8, columns 2(lane%4) + 0/1
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + wm * 64 + mt * 16 + (lane >> 2) + half * 8;
      if (r >= M) continue;
      T* row = C + (size_t)r * N;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = n0 + wn * 32 + nt * 8 + (lane & 3) * 2;
        const float x0 = acc[mt][nt][half * 2], x1 = acc[mt][nt][half * 2 + 1];
        if (kVec) {   // N % 8 == 0: both columns inside or both outside
          if (c < N)
            *reinterpret_cast<uint32_t*>(row + c) = Mma<T>::pack2(x0, x1);
        } else {
          if (c < N) row[c] = Mma<T>::out(x0);
          if (c + 1 < N) row[c + 1] = Mma<T>::out(x1);
        }
      }
    }
  }
}

// ----------------------------------------------------------------- f32
constexpr int kFBK = 32;
constexpr int kFStages = 3;
constexpr int kFALd = kFBK + 4;       // 36: rows r, r + 4 16 banks apart
constexpr int kFAStage = kBM * kFALd;
constexpr int kFBStage = kFBK * kBN;
constexpr int kSmem32 = kFStages * (kFAStage + kFBStage) * 4;   // 104,448 B

// 4 bytes global -> shared, zero-filled when valid is false
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}

// One stage: A rows m0..m0+127 x depth k0..k0+31 as they lie ([m][k]), B
// depth k0..k0+31 x columns n0..n0+127, zeros past the edges. Each thread
// moves 4 chunks of 4 floats of each.
template <bool kVec>
__device__ __forceinline__ void load_stage32(float* as, float* bs,
                                             const float* A, const float* B,
                                             int M, int N, int K, int m0,
                                             int n0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 3, col = (c & 7) * 4;      // 128 rows x 8 chunks
    const int gm = m0 + r, gk = k0 + col;
    float* dst = as + r * kFALd + col;
    if (kVec) {   // K % 4 == 0: a chunk lies wholly inside or outside
      const bool ok = gm < M && gk < K;
      cp_async16(dst, ok ? A + (size_t)gm * K + gk : A, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = gm < M && gk + e < K;
        cp_async4(dst + e, ok ? A + (size_t)gm * K + gk + e : A, ok);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 5, col = (c & 31) * 4;     // 32 rows x 32 chunks
    const int gk = k0 + r, gn = n0 + col;
    float* dst = bs + r * kBN + col;
    if (kVec) {   // N % 4 == 0
      const bool ok = gk < K && gn < N;
      cp_async16(dst, ok ? B + (size_t)gk * N + gn : B, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = gk < K && gn + e < N;
        cp_async4(dst + e, ok ? B + (size_t)gk * N + gn + e : B, ok);
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
mm32_kernel(const float* __restrict__ A, const float* __restrict__ B,
            float* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(16) float smem32[];
  float* As = smem32;                           // kFStages x (128 x kFALd)
  float* Bs = smem32 + kFStages * kFAStage;     // kFStages x (32 x 128)
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int ktiles = (K + kFBK - 1) / kFBK;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < ktiles)
      load_stage32<kVec>(As + s * kFAStage, Bs + s * kFBStage, A, B, M, N, K,
                         m0, n0, s * kFBK, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kFStages - 2>();  // stage kt has landed (this thread's)
    __syncthreads();                // ... everyone's; stage kt-1 is free
    const int nxt = kt + kFStages - 1;
    if (nxt < ktiles)
      load_stage32<kVec>(As + (nxt % kFStages) * kFAStage,
                         Bs + (nxt % kFStages) * kFBStage, A, B, M, N, K, m0,
                         n0, nxt * kFBK, tid);
    cp_async_commit();
    const float* as = As + (kt % kFStages) * kFAStage;
    const float* bs = Bs + (kt % kFStages) * kFBStage;
#pragma unroll
    for (int kq = 0; kq < kFBK; kq += 4) {
      // rows ty*4 + i and 64 + ty*4 + i, depths kq..kq+3
      float a[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            as + ((i >> 2) * 64 + ty * 4 + (i & 3)) * kFALd + kq);
        a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow = bs + (kq + kk) * kBN;
        const float4 b0 = *reinterpret_cast<const float4*>(brow + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(brow + 64 + tx * 4);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

  // rows ty*4 + i and 64 + ty*4 + i; columns tx*4 + j and 64 + tx*4 + j
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i >> 2) * 64 + ty * 4 + (i & 3);
    if (r >= M) continue;
    float* row = C + (size_t)r * N;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int c = n0 + s * 64 + tx * 4;
      const float* v = &acc[i][s * 4];
      if (kVec) {   // N % 4 == 0
        if (c < N)
          *reinterpret_cast<float4*>(row + c) =
              make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < N) row[c + e] = v[e];
      }
    }
  }
}

// ---------------------------------------------------- bf16 / f16: wgmma
constexpr int kWBK = 64;              // K step: 64 16-bit values
constexpr int kRow = kWBK * 2;        // 128 bytes: one 128-byte swizzle row
constexpr int kBox = 64;              // TMA box width, in elements (128 B)
constexpr int kGroupM = 8;            // tile rows per raster group

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// the box of `map` at (c0 innermost, c1) into shared memory at dst;
// completes `bytes` of bar's transaction count
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at `addr`
// (its swizzle atoms, 8 rows of 128 bytes, 1024-byte aligned): bits 0-13
// address / 16, 16-29 leading byte offset / 16, 32-45 stride byte offset /
// 16, 62-63 layout (1: 128-byte swizzle)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// A (K-major): rows 128 bytes apart, 8-row atoms 1024 bytes apart (the
// leading offset is not read); a 16-deep slice starts 32 bytes further on
__device__ __forceinline__ uint64_t desc_a(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 32, 16, 8 * kRow);
}
// B (MN-major, kBox columns a box, boxes kWBK rows of 128 bytes): depths 128
// bytes apart, 8-deep atoms 1024 bytes apart (stride), the next 64 columns
// one box on (leading); a 16-deep slice starts 16 rows further on
__device__ __forceinline__ uint64_t desc_b(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 16 * kRow, kWBK * kRow, 8 * kRow);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads of the accumulators above a wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (m64n256, float32) += A (64x16, K-major) * B (16x256, MN-major), both
// read through shared-memory descriptors; with scale_d 0, d = A * B
#define MM_WGMMA_N256(TY)                                                     \
  asm volatile(                                                               \
      "{\n.reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %130, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." #TY "." #TY " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "                              \
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "                    \
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "                    \
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "                    \
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "                    \
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "                    \
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "                    \
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "                    \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "                    \
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "                    \
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "          \
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "          \
      "%120, %121, %122, %123, %124, %125, %126, %127"                        \
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),      \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),      \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),      \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),      \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),      \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),      \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),      \
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),      \
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),      \
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),      \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),      \
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),      \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),      \
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),      \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), \
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), \
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), \
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), \
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])                              \
      : "l"(da), "l"(db), "r"(scale_d))

// d (m64n128, float32) += A (64x16, K-major) * B (16x128, MN-major), both
// read through shared-memory descriptors; with scale_d 0, d = A * B
#define MM_WGMMA_N128(TY)                                                     \
  asm volatile(                                                               \
      "{\n.reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %66, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." #TY "." #TY " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "                              \
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "                    \
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "                    \
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "                    \
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "                    \
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "                    \
      "%60, %61, %62, %63"                                                    \
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"                                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),      \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),      \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),      \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),      \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),      \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),      \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                    \
      : "l"(da), "l"(db), "r"(scale_d))

template <typename T>
struct Wgmma;
template <>
struct Wgmma<__nv_bfloat16> {
  __device__ __forceinline__ static void n256(float (&d)[128], uint64_t da,
                                              uint64_t db, int scale_d) {
    MM_WGMMA_N256(bf16);
  }
  __device__ __forceinline__ static void n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
    MM_WGMMA_N128(bf16);
  }
};
template <>
struct Wgmma<__half> {
  __device__ __forceinline__ static void n256(float (&d)[128], uint64_t da,
                                              uint64_t db, int scale_d) {
    MM_WGMMA_N256(f16);
  }
  __device__ __forceinline__ static void n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
    MM_WGMMA_N128(f16);
  }
};

// one K step of 64 for one consumer warpgroup: 4 products of depth 16 into
// its 64 x BN accumulator; scale_d 0 on the tile's first overwrites it
template <typename T, int BN>
__device__ __forceinline__ void wgmma_step(float (&d)[BN / 2], uint32_t a,
                                           uint32_t b, bool first) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kWBK / 16; ++kk) {
    const int scale_d = (first && kk == 0) ? 0 : 1;
    if constexpr (BN == 256)
      Wgmma<T>::n256(d, desc_a(a, kk), desc_b(b, kk), scale_d);
    else
      Wgmma<T>::n128(d, desc_a(a, kk), desc_b(b, kk), scale_d);
  }
  wgmma_commit();
}

// a warpgroup's 64 x BN accumulator to C at (row0, n0): thread t holds rows
// 16 (t/32) + (t%32)/4 and 8 below it, columns 8j + 2(t%4) + 0/1
template <typename T, int BN>
__device__ __forceinline__ void store_tile(T* C, const float (&d)[BN / 2],
                                           int M, int N, int row0, int n0) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r0 = row0 + (t / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = n0 + j * 8 + (lane % 4) * 2;
    if (c >= N) continue;       // N % 8 == 0: both columns inside or out
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + h * 8;
      if (r < M)
        *reinterpret_cast<uint32_t*>(C + (size_t)r * N + c) =
            Mma<T>::pack2(d[j * 4 + h * 2], d[j * 4 + h * 2 + 1]);
    }
  }
}

// tile t's origin in a raster of groups of kGroupM tile rows: down a group's
// rows first, then across its columns
template <int BM, int BN>
__device__ __forceinline__ void tile_origin(int t, int tiles_m, int tiles_n,
                                            int& m0, int& n0) {
  const int per_group = kGroupM * tiles_n;
  const int first = (t / per_group) * kGroupM;
  const int rows = min(tiles_m - first, kGroupM);
  const int r = t % per_group;
  m0 = (first + r % rows) * BM;
  n0 = (r / rows) * BN;
}

// The epilogue goes through shared memory and TMA stores: a consumer
// warpgroup writes 64 x kOutCols of its tile at a time into its staging
// buffer, as kOutCols / kBox boxes of 64 rows x 128 bytes, 128-byte
// swizzled like the loads (so the 8 rows a warp writes at once fall in 8
// distinct bank groups), and one thread stores the boxes while the
// warpgroup goes on to its next tile. TMA clips rows and columns past M, N.
constexpr int kOutCols = 128;
constexpr int kStageOut = 64 * kOutCols * 2;   // 16 KB a consumer

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// the box at (c0 innermost, c1) of `map` from shared memory at src
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// warpgroup c's 64 x BN accumulator to C at (row0, n0) through `stage`
template <typename T, int BN>
__device__ __forceinline__ void store_tile_tma(const CUtensorMap* map_c,
                                               uint32_t stage,
                                               const float (&d)[BN / 2],
                                               int c, int row0, int n0) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const bool leader = t == 0;
#pragma unroll
  for (int pass = 0; pass < BN / kOutCols; ++pass) {
    // the previous stores have read the buffer
    if (leader) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    named_sync(1 + c, 128);
#pragma unroll
    for (int jj = 0; jj < kOutCols / 8; ++jj) {
      const int j = pass * (kOutCols / 8) + jj;
      const int col = jj * 8 + (lane % 4) * 2;      // within the pass
      const int box = col / kBox, cb = (col % kBox) * 2;   // byte in a row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (t / 32) * 16 + lane / 4 + h * 8;
        const uint32_t at = stage + box * 64 * kRow + r * kRow +
                            (((cb >> 4) ^ (r & 7)) << 4) + (cb & 15);
        const uint32_t v =
            Mma<T>::pack2(d[j * 4 + h * 2], d[j * 4 + h * 2 + 1]);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(v) : "memory");
      }
    }
    // the writes above are seen by the TMA unit, then one thread stores
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(1 + c, 128);
    if (leader) {
#pragma unroll
      for (int box = 0; box < kOutCols / kBox; ++box)
        tma_store(map_c, stage + box * 64 * kRow,
                  n0 + pass * kOutCols + box * kBox, row0);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
}

template <int BM, int BN, int STAGES>
struct WgmmaShape {
  static constexpr int kConsumers = BM / 64;
  static constexpr int kThreadsW = (kConsumers + 1) * 128;
  static constexpr int kABytes = BM * kRow, kBBytes = BN * kRow;
  // + a staging buffer per consumer, + 1024 to align the ring to a swizzle
  // atom, + the 2 x STAGES barriers
  static constexpr int kSmem = STAGES * (kABytes + kBBytes) +
                               kConsumers * kStageOut + 1024 + 2 * STAGES * 8;
};

// Warpgroup 0 produces (one thread starts the TMA loads), warpgroups 1..
// consume, each 64 rows of the BM x BN tile.
template <typename T, int BM, int BN, int STAGES>
__global__ void __launch_bounds__(WgmmaShape<BM, BN, STAGES>::kThreadsW, 1)
mm_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                const __grid_constant__ CUtensorMap tma_b,
                const __grid_constant__ CUtensorMap tma_c, int M, int N,
                int K) {
  using S = WgmmaShape<BM, BN, STAGES>;
  extern __shared__ uint8_t smem_w[];
  const uint32_t base = (smem_u32(smem_w) + 1023) & ~1023u;
  const uint32_t a_ring = base, b_ring = base + STAGES * S::kABytes;
  const uint32_t out = b_ring + STAGES * S::kBBytes;
  const uint32_t full = out + S::kConsumers * kStageOut;
  const uint32_t empty = full + STAGES * 8;
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int ntiles = tiles_m * tiles_n, ktiles = (K + kWBK - 1) / kWBK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * S::kConsumers);   // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: a few registers are enough to start copies
    if constexpr (S::kConsumers == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    int s = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      int m0, n0;
      tile_origin<BM, BN>(t, tiles_m, tiles_n, m0, n0);
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(empty + 8 * s, phase ^ 1);   // the first pass finds it free
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, S::kABytes + S::kBBytes);
        tma_load(a_ring + s * S::kABytes, &tma_a, bar, kt * kWBK, m0);
#pragma unroll
        for (int j = 0; j < BN / kBox; ++j)
          tma_load(b_ring + s * S::kBBytes + j * kWBK * kRow, &tma_b, bar,
                   n0 + j * kBox, kt * kWBK);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    if constexpr (S::kConsumers == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1, lane = threadIdx.x % 32;
    float acc[BN / 2];
    int s = 0, prev = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      int m0, n0;
      tile_origin<BM, BN>(t, tiles_m, tiles_n, m0, n0);
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(full + 8 * s, phase);
        wgmma_step<T, BN>(acc, a_ring + s * S::kABytes + c * 64 * kRow,
                          b_ring + s * S::kBBytes, kt == 0);
        // this step's products may still run; the previous step's are done,
        // so its stage goes back to the producer
        wgmma_wait<1>();
        if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
        prev = s;
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + 8 * prev);
      store_tile_tma<T, BN>(&tma_c, out + c * kStageOut, acc, c,
                            m0 + c * 64, n0);
    }
    // the last stores have read shared memory before the block ends
    if (threadIdx.x % 128 == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// The descriptor check: one warpgroup, one stage, C (64 x 256) = A (64 x 64)
// @ B (64 x 256), through the same TMA boxes, descriptors and instruction
// as mm_wgmma_kernel's 128x256 tile.
template <typename T>
__global__ void __launch_bounds__(128)
mm_wgmma_probe_kernel(const __grid_constant__ CUtensorMap tma_a,
                      const __grid_constant__ CUtensorMap tma_b, T* C) {
  extern __shared__ uint8_t smem_p[];
  const uint32_t a = (smem_u32(smem_p) + 1023) & ~1023u;
  const uint32_t b = a + 64 * kRow, bar = b + 256 * kRow;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, (64 + 256) * kRow);
    tma_load(a, &tma_a, bar, 0, 0);
    for (int j = 0; j < 256 / kBox; ++j)
      tma_load(b + j * kWBK * kRow, &tma_b, bar, j * kBox, 0);
  }
  mbar_wait(bar, 0);
  float acc[128];
  wgmma_step<T, 256>(acc, a, b, true);
  wgmma_wait<0>();
  fence_regs(acc);
  store_tile<T, 256>(C, acc, 64, 256, 0, 0);
}

// ----------------------------------------------------------------- launch
// once per device and kernel: more than the default 48 KB of dynamic
// shared memory
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int device, int bytes, bool* set) {
  if (set[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) set[device] = true;
  return err;
}

template <typename T, bool kVec>
cudaError_t launch16(int device, const void* a, const void* b, void* c, int M,
                     int N, int K, dim3 grid, cudaStream_t stream) {
  static bool set[kMaxDevices] = {};
  const cudaError_t err =
      allow_smem(mm16_kernel<T, kVec>, device, kSmem16, set);
  if (err != cudaSuccess) return err;
  mm16_kernel<T, kVec><<<grid, kThreads, kSmem16, stream>>>(
      static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b),
      static_cast<T*>(c), M, N, K);
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t launch32(int device, const void* a, const void* b, void* c, int M,
                     int N, int K, dim3 grid, cudaStream_t stream) {
  static bool set[kMaxDevices] = {};
  const cudaError_t err = allow_smem(mm32_kernel<kVec>, device, kSmem32, set);
  if (err != cudaSuccess) return err;
  mm32_kernel<kVec><<<grid, kThreads, kSmem32, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), M, N, K);
  return cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The TMA descriptor of a row-major (rows, cols) 16-bit matrix read in
// boxes of box_rows x 64 columns, 128-byte swizzled, zeros past its edges.
// Returns 0, or kTmaError + the CUresult.
int make_map(CUtensorMap* map, int dtype, const void* ptr, int rows, int cols,
             int box_rows) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                         cudaEnableDefault,
                                         &found) != cudaSuccess ||
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
#endif
        found != cudaDriverEntryPointSuccess || fn == nullptr)
      return kTmaError + (int)CUDA_ERROR_NOT_FOUND;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};   // bytes
  const cuuint32_t box[2] = {(cuuint32_t)kBox, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(
      map,
      dtype == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      2, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kTmaError + (int)res;
}

int sm_count(int device) {
  static int sms[kMaxDevices] = {};
  if (sms[device] == 0 &&
      cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    return 0;
  return sms[device];
}

template <typename T, int BM, int BN, int STAGES>
int launch_wgmma(int device, int dtype, const void* a, const void* b, void* c,
                 int M, int N, int K, cudaStream_t stream) {
  using S = WgmmaShape<BM, BN, STAGES>;
  static bool set[kMaxDevices] = {};
  const cudaError_t err =
      allow_smem(mm_wgmma_kernel<T, BM, BN, STAGES>, device, S::kSmem, set);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_a, map_b, map_c;
  int code = make_map(&map_a, dtype, a, M, K, BM);
  if (code == 0) code = make_map(&map_b, dtype, b, K, N, kWBK);
  if (code == 0) code = make_map(&map_c, dtype, c, M, N, 64);
  if (code != 0) return code;
  const long long tiles =
      (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int sms = sm_count(device);
  if (sms == 0 || tiles > (1LL << 31) - 1)
    return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  mm_wgmma_kernel<T, BM, BN, STAGES><<<grid, S::kThreadsW, S::kSmem,
                                       stream>>>(map_a, map_b, map_c, M, N,
                                                 K);
  return (int)cudaGetLastError();
}

// the three tiles (rows x columns) and their stages: 4 x 48 KB, 6 x 32 KB,
// 8 x 24 KB of ring
template <typename T>
int launch_wgmma_tile(int device, int dtype, const void* a, const void* b,
                      void* c, int M, int N, int K, int bm, int bn,
                      cudaStream_t s) {
  if (bm == 128 && bn == 256)
    return launch_wgmma<T, 128, 256, 4>(device, dtype, a, b, c, M, N, K, s);
  if (bm == 128 && bn == 128)
    return launch_wgmma<T, 128, 128, 6>(device, dtype, a, b, c, M, N, K, s);
  if (bm == 64 && bn == 128)
    return launch_wgmma<T, 64, 128, 8>(device, dtype, a, b, c, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16 (A, B and C alike). A (M,K), B
// (K,N) and C (M,N) contiguous row-major on `device`; vectorized: K and N
// multiples of 16 bytes' worth of elements and all three pointers 16-byte
// aligned. variant: 0 ffma (float32), 1 mma_sync (16-bit), 2 wgmma (16-bit,
// vectorized only) with the output tile bm x bn (128x256, 128x128 or
// 64x128); the other variants take 128x128. Returns a CUDA error code, 0 on
// success, or kTmaError + a CUresult.
int mm_launch(int device, int dtype, const void* a, const void* b, void* c,
              int M, int N, int K, int vectorized, int variant, int bm,
              int bn, void* stream) {
  if (M < 1 || N < 1 || K < 1 || device < 0 || device >= kMaxDevices ||
      variant < kFfma || variant > kWgmma)
    return (int)cudaErrorInvalidValue;
  const bool vec = vectorized != 0, f32 = dtype == kF32;
  const bool half = dtype == kBF16 || dtype == kF16;
  if ((variant == kFfma) != f32 || (!f32 && !half) ||
      (variant == kWgmma && !vec) ||
      (variant != kWgmma && (bm != kBM || bn != kBN)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kWgmma)
    return dtype == kBF16
               ? launch_wgmma_tile<__nv_bfloat16>(device, dtype, a, b, c, M,
                                                  N, K, bm, bn, s)
               : launch_wgmma_tile<__half>(device, dtype, a, b, c, M, N, K,
                                           bm, bn, s);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  if (f32)
    err = vec ? launch32<true>(device, a, b, c, M, N, K, grid, s)
              : launch32<false>(device, a, b, c, M, N, K, grid, s);
  else if (dtype == kBF16)
    err = vec ? launch16<__nv_bfloat16, true>(device, a, b, c, M, N, K, grid,
                                              s)
              : launch16<__nv_bfloat16, false>(device, a, b, c, M, N, K, grid,
                                               s);
  else
    err = vec ? launch16<__half, true>(device, a, b, c, M, N, K, grid, s)
              : launch16<__half, false>(device, a, b, c, M, N, K, grid, s);
  return (int)err;
}

// The descriptor check: C (64 x 256) = A (64 x 64) @ B (64 x 256), 16-bit,
// contiguous, 16-byte aligned, in one stage of one warpgroup.
int mm_wgmma_probe(int device, int dtype, const void* a, const void* b,
                   void* c, void* stream) {
  if (device < 0 || device >= kMaxDevices || (dtype != kBF16 && dtype != kF16))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_a, map_b;
  int code = make_map(&map_a, dtype, a, 64, 64, 64);
  if (code == 0) code = make_map(&map_b, dtype, b, 64, 256, kWBK);
  if (code != 0) return code;
  const int smem = (64 + 256) * kRow + 1024 + 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    mm_wgmma_probe_kernel<__nv_bfloat16><<<1, 128, smem, s>>>(
        map_a, map_b, static_cast<__nv_bfloat16*>(c));
  else
    mm_wgmma_probe_kernel<__half><<<1, 128, smem, s>>>(
        map_a, map_b, static_cast<__half*>(c));
  return (int)cudaGetLastError();
}

const char* mm_error_string(int err) {
  if (err >= kTmaError)
    return "cuTensorMapEncodeTiled failed (the code less 10000 is its "
           "CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
