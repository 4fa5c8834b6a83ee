// Mamba-2 SSD chunk scan for Hopper (sm_90a), float32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel repro.kernels.ssd_scan.kernel.ssd_scan
// (src/repro/kernels/ssd_scan/kernel.py). It computes the SSD chunked dual
// form (arXiv:2405.21060) for n_groups = 1:
//
//   y[t]  = sum_{s<=t in chunk} (C_t . B_s) exp(cs_t - cs_s) dt_s x_s
//         + exp(cs_t) C_t . state_in(chunk)
//   state = state * exp(cs_end) + sum_s B_s exp(cs_end - cs_s) dt_s x_s
//
// where cs is the cumulative sum of dt * A inside each chunk. Every product
// is taken in float32 from inputs widened to float32, as the TPU kernel does.
//
// What bounds it here: at the training shape (b=2, l=4096, h=80, p=64,
// n=128, chunk 256) it needs ~32 GFLOP of float32 products against ~264 MB
// of traffic, so the f32 CUDA-core rate (67 TFLOP/s) bounds it, not HBM.
// The TPU kernel holds a whole (chunk x chunk x head_block) cell in VMEM;
// that is 2 MiB and does not fit the 227 KB of shared memory a block may
// use. So the work is split into three kernels:
//
//   1. ssd_state_kernel, one block per (head, chunk, batch): the chunk's
//      own state contribution (p x n), and the chunk's total decay cs_end.
//   2. ssd_pass_kernel, one thread per (batch, head, p, n) element: the
//      sequential pass over the chunks. The recurrence is elementwise in
//      (p, n), so it needs no block-wide work; it overwrites each chunk's
//      contribution with the state entering that chunk, and writes the
//      final state.
//   3. ssd_output_kernel, one block per (query tile of 64 rows, chunk,
//      batch x group of 8 heads): C.B^T for the tile (computed once and
//      shared by the 8 heads, since n_groups = 1), then per head the
//      decay-masked intra-chunk product and the entering-state term.
//
// Each thread keeps a 4x4 (or 4x8) register tile and reads shared memory
// as float4. No tensor cores, no TMA: a simple kernel that is right first.
//
// Cumulative sum order (the same in kernels 1 and 3, so both see the same
// bits): one warp per head; lane k sums steps 8k..8k+7 in order, then the
// lane totals are combined by a Hillis-Steele shuffle scan and each lane
// adds the exclusive prefix of the lanes before it. XLA's cumsum sums in
// another order; the difference is a few float32 ulps of cs.
//
// exp(cs_i - cs_j) is evaluated only for i >= j (the masked branch), so a
// large positive difference above the diagonal never reaches a product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunkMax = 256;  // chunk length at most
constexpr int kP = 64;          // head_dim at most
constexpr int kN = 128;         // d_state at most
constexpr int kTile = 64;       // query rows and key columns per tile
constexpr int kHeadGroup = 8;   // heads sharing one C.B^T tile
constexpr int kSBlk = 32;       // sequence rows per stage in kernel 1
constexpr int kPad = 68;        // row stride of the n-major tiles (16-B rows)

constexpr int kSmemOutput =
    (kN * kPad                     // ct: C rows of the tile, n-major
     + kChunkMax * kTile           // cbt: (C.B^T)^T, [key][query row]
     + kN * kPad                   // work: bt | mt + xs | stt
     + 2 * kHeadGroup * kChunkMax  // cumsums and dt of the head group
     ) * 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Inclusive cumulative sum of in[0..255] into out[0..255] by the calling
// warp (in == out is allowed: each lane reads its own 8 entries first).
__device__ __forceinline__ void warp_cumsum(const float* in, float* out) {
  const int lane = threadIdx.x & 31;
  float v[8];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    run += in[lane * 8 + k];
    v[k] = run;
  }
  float inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) out[lane * 8 + k] = excl + v[k];
}

// 1. The chunk's own state contribution:
//    states[b,z,h,pp,nn] = sum_s x[s,pp] dt[s] exp(cs_end - cs[s]) B[s,nn].
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ B,
                 float* __restrict__ states, float* __restrict__ cs_end,
                 int l, int h, int p, int n, int chunk) {
  const int head = blockIdx.x, z = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y;
  __shared__ float cs[kChunkMax];
  __shared__ float w[kChunkMax];
  __shared__ __align__(16) float us[kSBlk][kP];
  __shared__ __align__(16) float bs[kSBlk][kN];
  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)b * l + (int64_t)z * chunk;
  const float a = A[head];
  for (int s = tid; s < kChunkMax; s += kThreads)
    w[s] = s < chunk ? dt[(row0 + s) * h + head] * a : 0.f;
  __syncthreads();
  if (tid < 32) warp_cumsum(w, cs);
  __syncthreads();
  const float end = cs[chunk - 1];
  for (int s = tid; s < kChunkMax; s += kThreads)
    w[s] = s < chunk ? expf(end - cs[s]) * dt[(row0 + s) * h + head] : 0.f;
  if (tid == 0) cs_end[((int64_t)b * nc + z) * h + head] = end;
  __syncthreads();

  const int ty = tid / 16, tx = tid % 16;  // rows pp = 4ty.., cols nn = 8tx..
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int s0 = 0; s0 < chunk; s0 += kSBlk) {
    for (int e = tid; e < kSBlk * kP; e += kThreads) {
      const int s = e / kP, pp = e % kP;
      float v = 0.f;
      if (s0 + s < chunk && pp < p)
        v = to_f32(x[((row0 + s0 + s) * h + head) * p + pp]) * w[s0 + s];
      us[s][pp] = v;
    }
    for (int e = tid; e < kSBlk * kN; e += kThreads) {
      const int s = e / kN, nn = e % kN;
      bs[s][nn] = (s0 + s < chunk && nn < n)
                      ? to_f32(B[(row0 + s0 + s) * n + nn]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int s = 0; s < kSBlk; ++s) {
      const float4 u = *reinterpret_cast<const float4*>(&us[s][ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[s][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[s][tx * 8 + 4]);
      const float uu[4] = {u.x, u.y, u.z, u.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(uu[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = states + (((int64_t)b * nc + z) * h + head) * (int64_t)p * n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pp = ty * 4 + i;
    if (pp >= p) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int nn = tx * 8 + j;
      if (nn < n) out[(int64_t)pp * n + nn] = acc[i][j];
    }
  }
}

// 2. The pass over the chunks, one thread per (b, h, pp, nn): each chunk's
//    contribution is replaced by the state entering the chunk.
__global__ void __launch_bounds__(kThreads)
ssd_pass_kernel(float* __restrict__ states, const float* __restrict__ cs_end,
                float* __restrict__ final_state, int nc, int h, int pn,
                int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int e = (int)(i % pn);
  const int64_t bh = i / pn;
  const int head = (int)(bh % h);
  const int64_t b = bh / h;
  float carry = 0.f;
  for (int z = 0; z < nc; ++z) {
    const int64_t zh = (b * nc + z) * h + head;
    const int64_t idx = zh * pn + e;
    const float s = states[idx];
    states[idx] = carry;
    carry = carry * expf(cs_end[zh]) + s;
  }
  final_state[bh * pn + e] = carry;
}

// 3. The output of one tile of query rows for a group of heads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_output_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ B,
                  const T* __restrict__ C, const float* __restrict__ states,
                  float* __restrict__ y, int l, int h, int p, int n,
                  int chunk, int head_groups) {
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;                         // [kN][kPad]
  float* cbt = ct + kN * kPad;              // [kChunkMax][kTile]
  float* work = cbt + kChunkMax * kTile;    // [kN * kPad]
  float* csh = work + kN * kPad;            // [kHeadGroup][kChunkMax]
  float* dth = csh + kHeadGroup * kChunkMax;

  const int qt = blockIdx.x, z = blockIdx.y;
  const int b = blockIdx.z / head_groups, hg = blockIdx.z % head_groups;
  const int nc = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32;
  const int64_t row0 = (int64_t)b * l + (int64_t)z * chunk;
  const int r0 = qt * kTile;               // first query row, within the chunk
  const int rows = min(kTile, chunk - r0);
  const int h0 = hg * kHeadGroup;

  for (int e = tid; e < kHeadGroup * kChunkMax; e += kThreads) {
    const int g = e / kChunkMax, s = e % kChunkMax, head = h0 + g;
    const float d = (head < h && s < chunk) ? dt[(row0 + s) * h + head] : 0.f;
    dth[e] = d;
    csh[e] = head < h ? d * A[head] : 0.f;  // dt*A, scanned in place below
  }
  for (int e = tid; e < kTile * kN; e += kThreads) {
    const int r = e / kN, nn = e % kN;
    ct[nn * kPad + r] = (r < rows && nn < n)
                            ? to_f32(C[(row0 + r0 + r) * n + nn]) : 0.f;
  }
  __syncthreads();
  if (warp < kHeadGroup)
    warp_cumsum(csh + warp * kChunkMax, csh + warp * kChunkMax);

  const int ty = tid / 16, tx = tid % 16;
  const int nblk = qt + 1;                 // causal: key blocks 0..qt

  // (C.B^T)^T for the tile: cbt[s][r] = C[r0 + r] . B[s]
  float* bt = work;
  for (int sb = 0; sb < nblk; ++sb) {
    const int s0 = sb * kTile;
    __syncthreads();
    for (int e = tid; e < kTile * kN; e += kThreads) {
      const int s = e / kN, nn = e % kN;
      bt[nn * kPad + s] = (s0 + s < chunk && nn < n)
                              ? to_f32(B[(row0 + s0 + s) * n + nn]) : 0.f;
    }
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int nn = 0; nn < n; ++nn) {
      const float4 bv = *reinterpret_cast<const float4*>(&bt[nn * kPad + ty * 4]);
      const float4 cv = *reinterpret_cast<const float4*>(&ct[nn * kPad + tx * 4]);
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
      const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(bb[i], cc[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(&cbt[(s0 + ty * 4 + i) * kTile + tx * 4]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }

  float* mt = work;                  // [kTile key][kTile query row]
  float* xs = work + kTile * kTile;  // [kTile key][kTile pp]
  float* stt = work;                 // [kTile nn][kPad]: state_in^T slice
  for (int g = 0; g < kHeadGroup; ++g) {
    const int head = h0 + g;
    if (head >= h) break;
    const float* cs = csh + g * kChunkMax;
    const float* dd = dth + g * kChunkMax;
    float acc[4][4], acc2[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = acc2[i][j] = 0.f;

    // intra-chunk: sum_s (C.B^T)[r,s] exp(cs_r - cs_s) dt_s x_s
    for (int sb = 0; sb < nblk; ++sb) {
      const int s0 = sb * kTile;
      __syncthreads();
      for (int e = tid; e < kTile * kTile; e += kThreads) {
        const int s = e / kTile, r = e % kTile;
        const int i = r0 + r, j = s0 + s;
        float m = 0.f;
        if (j <= i && i < chunk)
          m = cbt[j * kTile + r] * expf(cs[i] - cs[j]) * dd[j];
        mt[e] = m;
        xs[e] = (j < chunk && r < p)
                    ? to_f32(x[((row0 + j) * h + head) * p + r]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int s = 0; s < kTile; ++s) {
        const float4 mv = *reinterpret_cast<const float4*>(&mt[s * kTile + ty * 4]);
        const float4 xv = *reinterpret_cast<const float4*>(&xs[s * kTile + tx * 4]);
        const float mm[4] = {mv.x, mv.y, mv.z, mv.w};
        const float xx[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(mm[i], xx[j], acc[i][j]);
      }
    }

    // entering state: C_r . state_in[pp, :]
    const float* st = states + (((int64_t)b * nc + z) * h + head) * (int64_t)p * n;
    for (int n0 = 0; n0 < n; n0 += kTile) {
      __syncthreads();
      for (int e = tid; e < kTile * kTile; e += kThreads) {
        const int pp = e / kTile, nn = e % kTile;
        stt[nn * kPad + pp] = (pp < p && n0 + nn < n)
                                  ? st[(int64_t)pp * n + n0 + nn] : 0.f;
      }
      __syncthreads();
      const int nlim = min(kTile, n - n0);
      for (int nn = 0; nn < nlim; ++nn) {
        const float4 cv = *reinterpret_cast<const float4*>(&ct[(n0 + nn) * kPad + ty * 4]);
        const float4 sv = *reinterpret_cast<const float4*>(&stt[nn * kPad + tx * 4]);
        const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
        const float ss[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc2[i][j] = fmaf(cc[i], ss[j], acc2[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      if (r >= rows) continue;
      const float dec = expf(cs[r0 + r]);
      float* yr = y + ((row0 + r0 + r) * h + head) * p;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pp = tx * 4 + j;
        if (pp < p) yr[pp] = acc[i][j] + dec * acc2[i][j];
      }
    }
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, float* y, float* final_state, float* states,
           float* cs_end, int b, int l, int h, int p, int n, int chunk,
           cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_output_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemOutput);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int nc = l / chunk;
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(B);
  const T* Ct = static_cast<const T*>(C);
  ssd_state_kernel<T><<<dim3(h, nc, b), kThreads, 0, stream>>>(
      xt, dt, A, Bt, states, cs_end, l, h, p, n, chunk);
  const int64_t total = (int64_t)b * h * p * n;
  ssd_pass_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads,
                    0, stream>>>(states, cs_end, final_state, nc, h, p * n,
                                 total);
  const int head_groups = (h + kHeadGroup - 1) / kHeadGroup;
  ssd_output_kernel<T><<<dim3((chunk + kTile - 1) / kTile, nc,
                              b * head_groups),
                         kThreads, kSmemOutput, stream>>>(
      xt, dt, A, Bt, Ct, states, y, l, h, p, n, chunk, head_groups);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (x, B and C; dt and A are float32).
// x (b,l,h,p), dt (b,l,h), B and C (b,l,n), all contiguous; y (b,l,h,p)
// and final_state (b,h,p,n) float32 out; states (b,l/chunk,h,p,n) and
// cs_end (b,l/chunk,h) float32 scratch. Needs l % chunk == 0,
// chunk <= 256, p <= 64, n <= 128 (the wrapper checks). Returns a CUDA
// error code, 0 on success.
int ssd_launch(int dtype, const void* x, const float* dt, const float* A,
               const void* B, const void* C, float* y, float* final_state,
               float* states, float* cs_end, int b, int l, int h, int p,
               int n, int chunk, void* stream) {
  if (chunk <= 0 || chunk > kChunkMax || l % chunk != 0 || p <= 0 ||
      p > kP || n <= 0 || n > kN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, B, C, y, final_state, states, cs_end, b,
                         l, h, p, n, chunk, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, B, C, y, final_state, states,
                                 cs_end, b, l, h, p, n, chunk, s);
  return (int)cudaErrorInvalidValue;
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
