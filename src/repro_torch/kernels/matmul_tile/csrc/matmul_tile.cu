// Tiled matrix product C = A @ B for Hopper: float32 accumulation over the
// whole K sweep, C written once in A's dtype.
//
// Replaces the Pallas TPU kernel repro.kernels.matmul_tile.kernel.matmul_tile
// (body _mm_kernel), the repository's form of the paper's section 7 MatMul
// accelerator: a 128x128 output tile whose accumulator stays on chip across
// the K sweep. A is (M,K) and B is (K,N), both row-major and contiguous.
//
// What bounds it on the H100: operations, at the sizes it is used at. A
// square bf16 product of side n does 2n^3 operations on 6n^2 bytes, n/3 a
// byte, against the ~295 the card needs before its tensor cores rather than
// its memory are the limit: from n ~ 900 the tensor cores are the limit (in
// float32, outside them, from n ~ 120). So the design keeps the tensor cores
// (bf16, f16) or the FMA pipes (f32) fed from shared memory:
//
//   bf16, f16  a 128x128 output tile per block of 8 warps (2 x 4 warps, each
//              64x32), K in steps of 32 through a ring of 3 stages in shared
//              memory filled by cp.async; ldmatrix (.trans for B, which is
//              (K,N) row-major) feeds mma.sync m16n8k16 with float32
//              accumulators: the Ampere form. Shared rows are padded by 16
//              bytes, so the 8 rows one ldmatrix phase reads fall in 8
//              distinct groups of 4 banks.
//   f32        FFMA, never TF32 (the reference's float32 tolerance is 1e-3):
//              a 128x128 tile per block of 256 threads, 8x8 outputs a thread
//              in two 4-wide strips each way, K in steps of 8; the next
//              step's tiles are fetched to registers while this step's are
//              multiplied (two shared buffers, one barrier a step). Each
//              output adds its K products in order k = 0..K-1.
//
// Any M, N, K >= 1: rows, columns and depth past an edge load as zeros and
// outputs past an edge are not stored. Where K, N and the pointers allow
// 16-byte vectors (the wrapper's `vectorized`), tiles move as vectors
// (cp.async, float4); otherwise element by element. The TPU kernel's tile
// contract (M, N, K divisible by its clamped bm, bn, bk) is the wrapper's
// check_args; this kernel picks its own tiles. Not done yet: wgmma, TMA,
// clusters, a persistent grid.
//
// Plain C interface, bound with ctypes (repro_torch/kernels/matmul_tile/
// kernel.py): mm_launch returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2 };

constexpr int kBM = 128, kBN = 128;
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

// ------------------------------------------------------------ bf16 / f16
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
constexpr int kFBK = 8;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
mm32_kernel(const float* __restrict__ A, const float* __restrict__ B,
            float* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float As[2][kFBK][kBM];   // A transposed: [k][m]
  __shared__ __align__(16) float Bs[2][kFBK][kBN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int ktiles = (K + kFBK - 1) / kFBK;
  // what this thread fetches: A row ar, depth ak..ak+3; B depth bk, columns
  // bn..bn+3
  const int ar = tid >> 1, ak = (tid & 1) * 4;
  const int bk = tid >> 5, bn = (tid & 31) * 4;
  float ra[4], rb[4];

  auto fetch = [&](int k0) {
    const int gm = m0 + ar, gk = k0 + ak;
    if (kVec) {   // K % 4 == 0: four depths wholly inside or outside
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gm < M && gk < K)
        v = *reinterpret_cast<const float4*>(A + (size_t)gm * K + gk);
      ra[0] = v.x; ra[1] = v.y; ra[2] = v.z; ra[3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ra[e] = (gm < M && gk + e < K) ? A[(size_t)gm * K + gk + e] : 0.f;
    }
    const int gk2 = k0 + bk, gn = n0 + bn;
    if (kVec) {   // N % 4 == 0
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gk2 < K && gn < N)
        v = *reinterpret_cast<const float4*>(B + (size_t)gk2 * N + gn);
      rb[0] = v.x; rb[1] = v.y; rb[2] = v.z; rb[3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        rb[e] = (gk2 < K && gn + e < N) ? B[(size_t)gk2 * N + gn + e] : 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int e = 0; e < 4; ++e) As[buf][ak + e][ar] = ra[e];
    *reinterpret_cast<float4*>(&Bs[buf][bk][bn]) =
        make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles) fetch((kt + 1) * kFBK);
#pragma unroll
    for (int k = 0; k < kFBK; ++k) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[cur][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[cur][k][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read in step kt - 1, before the barrier
    // that ended it
    if (kt + 1 < ktiles) stash(cur ^ 1);
    __syncthreads();
  }

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

// ----------------------------------------------------------------- launch
template <typename T, bool kVec>
cudaError_t launch16(int device, const void* a, const void* b, void* c, int M,
                     int N, int K, dim3 grid, cudaStream_t stream) {
  // once per device: more than the default 48 KB of dynamic shared memory
  static bool attr_set[kMaxDevices] = {};
  if (!attr_set[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        mm16_kernel<T, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem16);
    if (err != cudaSuccess) return err;
    attr_set[device] = true;
  }
  mm16_kernel<T, kVec><<<grid, kThreads, kSmem16, stream>>>(
      static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b),
      static_cast<T*>(c), M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16 (A, B and C alike). A (M,K), B
// (K,N) and C (M,N) contiguous row-major on `device`; vectorized: K and N
// multiples of 16 bytes' worth of elements and all three pointers 16-byte
// aligned. Returns a CUDA error code, 0 on success.
int mm_launch(int device, int dtype, const void* a, const void* b, void* c,
              int M, int N, int K, int vectorized, void* stream) {
  if (M < 1 || N < 1 || K < 1 || device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = vectorized != 0;
  switch (dtype) {
    case kF32: {
      const float* fa = static_cast<const float*>(a);
      const float* fb = static_cast<const float*>(b);
      float* fc = static_cast<float*>(c);
      if (vec)
        mm32_kernel<true><<<grid, kThreads, 0, s>>>(fa, fb, fc, M, N, K);
      else
        mm32_kernel<false><<<grid, kThreads, 0, s>>>(fa, fb, fc, M, N, K);
      err = cudaGetLastError();
      break;
    }
    case kBF16:
      err = vec ? launch16<__nv_bfloat16, true>(device, a, b, c, M, N, K,
                                                grid, s)
                : launch16<__nv_bfloat16, false>(device, a, b, c, M, N, K,
                                                 grid, s);
      break;
    case kF16:
      err = vec ? launch16<__half, true>(device, a, b, c, M, N, K, grid, s)
                : launch16<__half, false>(device, a, b, c, M, N, K, grid, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* mm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
