// Mamba-2 SSD chunk scan for Hopper (sm_90a): a tensor-core variant for
// bfloat16 inputs and a float32 variant on the CUDA cores.
//
// Replaces the Pallas TPU kernel repro.kernels.ssd_scan.kernel.ssd_scan
// (src/repro/kernels/ssd_scan/kernel.py). It computes the SSD chunked dual
// form (arXiv:2405.21060) for n_groups = 1:
//
//   y[t]  = sum_{s<=t in chunk} (C_t . B_s) exp(cs_t - cs_s) dt_s x_s
//         + exp(cs_t) C_t . state_in(chunk)
//   state = state * exp(cs_end) + sum_s B_s exp(cs_end - cs_s) dt_s x_s
//
// where cs is the cumulative sum of dt * A inside each chunk. The TPU
// kernel holds a whole (chunk x chunk x head_block) cell in VMEM; that is
// 2 MiB and does not fit the 227 KB of shared memory a block may use. So
// each variant splits the work into three kernels: the chunk's own state
// contribution, a pass over the chunks that carries the state, and the
// output.
//
// ffma (float32 inputs; bf16 inputs only for same-run comparisons): every
// product in float32 from inputs widened to float32, as the TPU kernel
// does; it holds the reference's float32 tolerance. Its bound is the f32
// CUDA-core rate: ~32.5 GFLOP at the training shape (b=2, l=4096, h=80,
// p=64, n=128, chunk 256) at 67 TFLOP/s, 0.49 ms. It runs at ~11% of that:
// each thread's 4x4 register tile reads two float4 from shared memory per
// 16 FMAs, every tile load is scalar and fenced by __syncthreads, and its
// pass over the chunks rewrites the scratch in place, so no load runs ahead
// of the chain (ssd_state_kernel, ssd_pass_kernel, ssd_output_kernel). It
// is the variant float32 inputs need, not the model's, so it stays simple.
//
// mma_sync (bfloat16 inputs): the products on the tensor cores, bf16 in and
// float32 accumulators, rounded where the reference MODEL rounds
// (repro/models/ssm.py::ssd_chunked rounds each operand to x's dtype before
// its product):
//   C.B^T        from the bf16 C and B;
//   y_diag       M = bf16(CB * exp(cs_i - cs_j)) (j <= i) times
//                xdt = bf16(x * dt);
//   state        B^T times U = bf16(bf16(exp(cs_end - cs_j)) * xdt). This
//                rounds once more than the model, which multiplies B, the
//                decay and xdt in float32: the decay cannot be factored out
//                of the sum over the chunk, so the tensor core needs the
//                product as one bf16 operand;
//   y_off        bf16(exp(cs_i)), applied in float32 to C . bf16(state_in)^T
//                (the decay factors out of the sum over n: no extra
//                rounding);
//   carry        float32 across chunks; only the entering state that y_off
//                reads is rounded, so the pass writes it in bf16.
// ref.py::ssd_chunked_tc is the plain version of exactly this. The products
// take 0.033 ms at the bf16 peak, so with them on the tensor cores the
// bound is the ~264 MB the call must move (0.079 ms at 3.35 TB/s). What the
// design does about the ffma variant's limits:
//   1. ssd_tc_state_kernel, one block per (head, chunk, batch): x and B of
//      the chunk move by 16-byte cp.async in slices of 64 keys through a
//      two-stage ring (56 KB of shared memory, four blocks an SM, since the
//      kernel is bound by its loads); each slice is turned into U in place
//      by the threads that loaded it while the next slice loads, then goes
//      through ldmatrix(.trans) into mma.sync m16n8k16 (p x n per block,
//      K = chunk). It writes the contribution in float32 to a scratch of
//      its own.
//   2. ssd_tc_pass_kernel, four state elements per thread: reads the
//      contributions of 8 chunks (float4 each) before it runs their part of
//      the recurrence, writes the entering states in bf16 to another buffer
//      and the final state in float32. Nothing is read and rewritten in
//      place, so the loads stream ahead of the chain.
//   3. ssd_tc_output_kernel<p>, one block per (128 query rows, chunk,
//      batch x group of 8 heads), one warp per 16 rows: C.B^T for the
//      warp's rows and the key blocks on or below the diagonal, once, kept
//      in mma accumulator registers (up to 32 x 4 floats a thread) and
//      shared by the 8 heads; per head M is made from those registers in
//      the layout of mma's A operand (as flash attention reuses S = QK^T),
//      so M never touches memory. x and the entering state of the next head
//      load by cp.async into the other stage of a two-stage ring while this
//      head's products run; each x tile is read from global memory once per
//      block.
// What bounds kernel 3 is latency inside a warp (one block of 8 warps fits
// an SM at ~240 registers a thread), not bytes: a third ring stage and a
// balance of key blocks between the warps that share a scheduler each
// changed nothing on an H100 (PERF.md). So the 16-key step of the
// intra-chunk product is kept short: its x fragments are loaded at its top,
// so their latency runs under the exponentials; only the diagonal step
// tests the mask; exp is ex2.approx.ftz (no denormal fix-up, whose results
// are 0 in bf16 terms anyway). The head dim is a template parameter, so no
// fragment load sits under a runtime test (such an ldmatrix costs a warp
// sync).
// mma.sync rather than wgmma: every product is small (K = 128 or <= 256,
// 16-row warp tiles, causal key extents that differ per warp), and keeping
// C.B^T in registers per warp is what lets 8 heads share it; the products
// are not the limit once they run on the tensor cores at all.
//
// Cumulative sum order (the same in every kernel of both variants, so all
// see the same bits): one warp per head; lane k sums steps 8k..8k+7 in
// order, then the lane totals are combined by a Hillis-Steele shuffle scan
// and each lane adds the exclusive prefix of the lanes before it. XLA's and
// torch's cumsums sum in another order; the difference is a few float32
// ulps of cs.
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

// ------------------------------------------------ mma_sync variant (bf16)

typedef __nv_bfloat16 bf16;

constexpr int kXLd = kP + 8;    // row pitch of x tiles (144 B: the 8 rows of
                                // one ldmatrix 8x8 matrix fall in 8 banks)
constexpr int kNLd = kN + 8;    // row pitch of B, C and state tiles (272 B)
constexpr int kSlice = 64;      // keys per ring stage in kernel 1
constexpr int kRows = 128;      // query rows per block of kernel 3 (8 warps)

constexpr int kSmemTcState =
    2 * (kSlice * kXLd + kSlice * kNLd) * 2    // 2 stages of x -> U and B
    + 3 * kChunkMax * 4;                       // cs, dt, decay out
constexpr int kSmemTcOutput =
    2 * kHeadGroup * kChunkMax * 4             // cumsums and dt of the group
    + kRows * kNLd * 2                         // C rows of the tile
    + kChunkMax * kXLd * 2                     // x stage 0
    + 2 * kP * kNLd * 2                        // entering state, 2 stages
    + kChunkMax * kNLd * 2;                    // B, then x stage 1

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
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
// d += a (16x16, row) * (b0, b1) (16x8, col), bf16 in, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// (lo, hi) rounded to bf16, lo at the lower address
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// two bf16 times d, rounded to bf16
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float d) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack_bf16(f.x * d, f.y * d);
}
// 8 bf16 in shared memory times d, rounded to bf16, in place
__device__ __forceinline__ void scale_piece(bf16* q, float d) {
  uint4 v = *reinterpret_cast<uint4*>(q);
  v.x = scale_bf16x2(v.x, d);
  v.y = scale_bf16x2(v.y, d);
  v.z = scale_bf16x2(v.z, d);
  v.w = scale_bf16x2(v.w, d);
  *reinterpret_cast<uint4*>(q) = v;
}

// Start the loads of keys s0..s1 of x (one head) and B into one stage.
__device__ __forceinline__ void load_slice(bf16* us, bf16* bs,
                                           const bf16* __restrict__ x,
                                           const bf16* __restrict__ B,
                                           int64_t row0, int head, int h,
                                           int p, int n, int s0, int s1) {
  const int pc = p / 8, nq = n / 8;
  for (int e = threadIdx.x; e < (s1 - s0) * pc; e += kThreads) {
    const int s = e / pc, c = e % pc;
    cp_async16(us + s * kXLd + c * 8,
               x + ((row0 + s0 + s) * h + head) * p + c * 8);
  }
  for (int e = threadIdx.x; e < (s1 - s0) * nq; e += kThreads) {
    const int s = e / nq, c = e % nq;
    cp_async16(bs + s * kNLd + c * 8, B + (row0 + s0 + s) * n + c * 8);
  }
}

// 1. The chunk's own state contribution on the tensor cores:
//    contrib[b,z,h] (p x n) = U^T B, U[s,pp] = bf16(bf16(exp(cs_end - cs_s))
//    * bf16(x[s,pp] dt_s)). Warp w computes rows pp 16(w%4).. and columns
//    nn 64(w/4)..; the depth runs over the chunk's keys, 16 at a time. The
//    kernel is bound by its loads (without its products it takes nearly as
//    long), so the keys move in slices of 64 through a two-stage ring: a
//    block needs 56 KB of shared memory and four blocks share an SM.
__global__ void __launch_bounds__(kThreads, 4)
ssd_tc_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const bf16* __restrict__ B,
                    float* __restrict__ contrib, float* __restrict__ cs_end,
                    int l, int h, int p, int n, int chunk) {
  constexpr int kStageS = kSlice * kXLd + kSlice * kNLd;  // x, then B
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  float* cs = reinterpret_cast<float*>(ring + 2 * kStageS);
  float* dts = cs + kChunkMax;
  float* dec = dts + kChunkMax;                  // bf16(exp(cs_end - cs))

  const int head = blockIdx.x, z = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t row0 = (int64_t)b * l + (int64_t)z * chunk;
  const int pc = p / 8;
  const int nsl = (chunk + kSlice - 1) / kSlice;

  // slices 0 and 1 in flight; one group committed per slice, empty past
  // the chunk, so that slice sl's group is the second newest at its turn
  for (int sl = 0; sl < 2; ++sl) {
    bf16* st = ring + sl * kStageS;
    if (sl < nsl)
      load_slice(st, st + kSlice * kXLd, x, B, row0, head, h, p, n,
                 sl * kSlice, min(chunk, (sl + 1) * kSlice));
    cp_async_commit();
  }
  const float a = A[head];
  for (int s = tid; s < kChunkMax; s += kThreads) {
    const float d = s < chunk ? dt[(row0 + s) * h + head] : 0.f;
    dts[s] = d;
    cs[s] = s < chunk ? d * a : 0.f;
  }
  __syncthreads();
  if (warp == 0) warp_cumsum(cs, cs);
  __syncthreads();
  const float end = cs[chunk - 1];
  for (int s = tid; s < chunk; s += kThreads)
    dec[s] = bf16_round(expf(end - cs[s]));
  if (tid == 0) cs_end[((int64_t)b * nc + z) * h + head] = end;

  const int wm = warp & 3, wn = warp >> 2;
  const bool active = 16 * wm < p && 64 * wn < n;
  const int j = lane >> 3, r8 = lane & 7;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;

  for (int sl = 0; sl < nsl; ++sl) {
    const int s0 = sl * kSlice, s1 = min(chunk, s0 + kSlice);
    bf16* us = ring + (sl & 1) * kStageS;
    const bf16* bs = us + kSlice * kXLd;
    cp_async_wait<1>();
    __syncthreads();  // dec written (first slice)
    // x -> U in place, by the threads that loaded each piece
    for (int e = tid; e < (s1 - s0) * pc; e += kThreads) {
      const int s = e / pc, c = e % pc;
      bf16* q = us + s * kXLd + c * 8;
      scale_piece(q, dts[s0 + s]);
      scale_piece(q, dec[s0 + s]);
    }
    __syncthreads();
    if (active) {
      for (int k0 = 0; k0 < s1 - s0; k0 += 16) {
        uint32_t af[4];  // A = U^T: rows pp, depth keys; U is [key][pp]
        ldmatrix_x4_trans(
            af, us + (k0 + 8 * (j >> 1) + r8) * kXLd + 16 * wm + 8 * (j & 1));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          const int n0 = 64 * wn + 16 * np;
          if (n0 < n) {
            uint32_t bf[4];  // B [key][nn]: depth keys, columns nn
            ldmatrix_x4_trans(
                bf, bs + (k0 + 8 * (j & 1) + r8) * kNLd + n0 + 8 * (j >> 1));
            mma_bf16(acc[2 * np], af, bf[0], bf[1]);
            mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is free for slice sl + 2
    if (sl + 2 < nsl)
      load_slice(us, us + kSlice * kXLd, x, B, row0, head, h, p, n,
                 s0 + 2 * kSlice, min(chunk, s0 + 3 * kSlice));
    cp_async_commit();
  }
  if (!active) return;
  float* out = contrib + (((int64_t)b * nc + z) * h + head) * (int64_t)p * n;
  const int pp = 16 * wm + (lane >> 2);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int nn = 64 * wn + 8 * nt + 2 * (lane & 3);
    if (64 * wn + 8 * nt < n) {
      *reinterpret_cast<float2*>(out + (int64_t)pp * n + nn) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(out + (int64_t)(pp + 8) * n + nn) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// 2. The pass over the chunks, four (pp, nn) elements of one (b, h) per
//    thread: the contributions of 8 chunks are loaded before their part of
//    the recurrence runs; the state entering each chunk goes out in bf16
//    (what y_off reads), the carry stays float32.
__global__ void __launch_bounds__(kThreads)
ssd_tc_pass_kernel(const float* __restrict__ contrib,
                   const float* __restrict__ cs_end, bf16* __restrict__ states,
                   float* __restrict__ final_state, int nc, int h, int pn,
                   int64_t quads) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= quads) return;
  const int e = (int)(i * 4 % pn);
  const int64_t bh = i * 4 / pn;
  const int head = (int)(bh % h);
  const int64_t b = bh / h;
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int z0 = 0; z0 < nc; z0 += 8) {
    float4 v[8];
    float end[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      end[k] = 0.f;
      if (z0 + k < nc) {
        const int64_t zh = (b * nc + z0 + k) * h + head;
        v[k] = __ldg(reinterpret_cast<const float4*>(contrib + zh * pn + e));
        end[k] = __ldg(cs_end + zh);
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (z0 + k < nc) {
        const int64_t zh = (b * nc + z0 + k) * h + head;
        *reinterpret_cast<uint2*>(states + zh * pn + e) = make_uint2(
            pack_bf16(carry.x, carry.y), pack_bf16(carry.z, carry.w));
        const float d = expf(end[k]);
        carry.x = fmaf(carry.x, d, v[k].x);
        carry.y = fmaf(carry.y, d, v[k].y);
        carry.z = fmaf(carry.z, d, v[k].z);
        carry.w = fmaf(carry.w, d, v[k].w);
      }
    }
  }
  *reinterpret_cast<float4*>(final_state + bh * pn + e) = carry;
}

// Start the loads of one head's x tile (keys 0..kmax) and entering state
// (p x n) into one stage of the ring.
__device__ __forceinline__ void load_head(bf16* xs, bf16* ss,
                                          const bf16* __restrict__ x,
                                          const bf16* __restrict__ st,
                                          int64_t row0, int head, int h,
                                          int p, int n, int kmax) {
  const int pc = p / 8, nq = n / 8;
  for (int e = threadIdx.x; e < kmax * pc; e += kThreads) {
    const int s = e / pc, c = e % pc;
    cp_async16(xs + s * kXLd + c * 8, x + ((row0 + s) * h + head) * p + c * 8);
  }
  for (int e = threadIdx.x; e < p * nq; e += kThreads) {
    const int pp = e / nq, c = e % nq;
    cp_async16(ss + pp * kNLd + c * 8, st + (int64_t)pp * n + c * 8);
  }
}

// exp(x) as __expf computes it (ex2 of x log2 e on the MUFU), with results
// below 2^-126 flushed to 0 rather than fixed up: such an M element is 0 in
// bf16 terms either way
__device__ __forceinline__ float exp_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// M[r, s], M[r, s+1] for one row r and keys s, s+1, as one A-operand
// register: bf16(CB * exp(cs_r - cs_s)) on and below the diagonal, 0 above
// (only the diagonal key block, kDiag, needs the test).
template <bool kDiag>
__device__ __forceinline__ uint32_t m_pair(float cb0, float cb1, float cr,
                                           float2 cs2, int r, int s) {
  const float m0 = (!kDiag || s <= r) ? cb0 * exp_ftz(cr - cs2.x) : 0.f;
  const float m1 = (!kDiag || s + 1 <= r) ? cb1 * exp_ftz(cr - cs2.y) : 0.f;
  return pack_bf16(m0, m1);
}

// acc += M (the warp's 16 rows x keys 16 kb..) . xdt (those keys x p), M
// made from the C.B^T accumulators cl (keys 16 kb..) and ch (16 kb + 8..).
// The x fragments are loaded first, so their latency runs under the
// exponentials.
template <bool kDiag, int P>
__device__ __forceinline__ void intra_block(
    float (&acc)[P / 8][4], const float (&cl)[4], const float (&ch)[4],
    const float* cg, const bf16* xs, int kb, float csa, float csb, int ra,
    int rb, int lane) {
  const int j = lane >> 3, r8 = lane & 7, s = 16 * kb + 2 * (lane & 3);
  uint32_t bx[P / 16][4];  // xdt [key][pp]: depth keys, columns pp
#pragma unroll
  for (int pt = 0; pt < P / 16; ++pt)
    ldmatrix_x4_trans(bx[pt], xs + (16 * kb + 8 * (j & 1) + r8) * kXLd +
                                  16 * pt + 8 * (j >> 1));
  const float2 c0 = *reinterpret_cast<const float2*>(cg + s);
  const float2 c8 = *reinterpret_cast<const float2*>(cg + s + 8);
  uint32_t af[4];
  af[0] = m_pair<kDiag>(cl[0], cl[1], csa, c0, ra, s);
  af[1] = m_pair<kDiag>(cl[2], cl[3], csb, c0, rb, s);
  af[2] = m_pair<kDiag>(ch[0], ch[1], csa, c8, ra, s + 8);
  af[3] = m_pair<kDiag>(ch[2], ch[3], csb, c8, rb, s + 8);
#pragma unroll
  for (int pt = 0; pt < P / 16; ++pt) {
    mma_bf16(acc[2 * pt], af, bx[pt][0], bx[pt][1]);
    mma_bf16(acc[2 * pt + 1], af, bx[pt][2], bx[pt][3]);
  }
}

// 3. The output of 128 query rows for a group of 8 heads. Warp w owns rows
//    r0 + 16w.. and the key blocks 0..(r0 + 16w)/16, on or below the
//    diagonal. P is the head dim p, so that no fragment load or product
//    depends on a runtime test (an ldmatrix under one costs a warp sync).
template <int P>
__global__ void __launch_bounds__(kThreads, 1)
ssd_tc_output_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const bf16* __restrict__ B,
                     const bf16* __restrict__ C,
                     const bf16* __restrict__ states, float* __restrict__ y,
                     int l, int h, int n, int chunk, int head_groups) {
  constexpr int p = P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* csh = reinterpret_cast<float*>(smem_raw);  // [kHeadGroup][kChunkMax]
  float* dth = csh + kHeadGroup * kChunkMax;
  bf16* ct = reinterpret_cast<bf16*>(dth + kHeadGroup * kChunkMax);
  bf16* xs0 = ct + kRows * kNLd;                    // [kChunkMax][kXLd]
  bf16* ss0 = xs0 + kChunkMax * kXLd;               // [2][kP][kNLd]
  bf16* bx1 = ss0 + 2 * kP * kNLd;                  // B, then x stage 1

  const int qt = blockIdx.x, z = blockIdx.y;
  const int b = blockIdx.z / head_groups, hg = blockIdx.z % head_groups;
  const int nc = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t row0 = (int64_t)b * l + (int64_t)z * chunk;
  const int r0 = qt * kRows;
  const int rows = min(kRows, chunk - r0), kmax = r0 + rows;
  const int h0 = hg * kHeadGroup, ng = min(kHeadGroup, h - h0);
  const int nq = n / 8, pc = p / 8;
  const int64_t pn = (int64_t)p * n;
  const bf16* st_base = states + ((int64_t)b * nc + z) * h * pn;

  // group 0: C rows of the tile and B keys 0..kmax; group 1: head 0
  for (int e = tid; e < rows * nq; e += kThreads) {
    const int r = e / nq, c = e % nq;
    cp_async16(ct + r * kNLd + c * 8, C + (row0 + r0 + r) * n + c * 8);
  }
  for (int e = tid; e < kmax * nq; e += kThreads) {
    const int s = e / nq, c = e % nq;
    cp_async16(bx1 + s * kNLd + c * 8, B + (row0 + s) * n + c * 8);
  }
  cp_async_commit();
  load_head(xs0, ss0, x, st_base + h0 * pn, row0, h0, h, p, n, kmax);
  cp_async_commit();

  for (int e = tid; e < kHeadGroup * kChunkMax; e += kThreads) {
    const int g = e / kChunkMax, s = e % kChunkMax, head = h0 + g;
    const float d = (g < ng && s < chunk) ? dt[(row0 + s) * h + head] : 0.f;
    dth[e] = d;
    csh[e] = (g < ng && s < chunk) ? d * A[head] : 0.f;
  }
  __syncthreads();
  if (warp < ng) warp_cumsum(csh + warp * kChunkMax, csh + warp * kChunkMax);
  cp_async_wait<1>();
  __syncthreads();

  const int j = lane >> 3, r8 = lane & 7, t = lane & 3;
  const int rw = r0 + 16 * warp;  // the warp's first row in the chunk
  const bool active = 16 * warp < rows;
  const int nkb = rw / 16 + 1;    // key blocks of 16 the warp needs
  const int ra = rw + (lane >> 2), rb = ra + 8;

  // C.B^T for the warp's 16 rows and keys 0..16 nkb, in registers (the
  // accumulator layout: cb[i] holds keys 8i.., rows ra and rb)
  float cb[32][4];
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) cb[i][k] = 0.f;
  if (active) {
    for (int kn = 0; kn < n; kn += 16) {
      uint32_t af[4];
      ldmatrix_x4(af, ct + (16 * warp + 8 * (j & 1) + r8) * kNLd + kn +
                          8 * (j >> 1));
#pragma unroll
      for (int kb = 0; kb < kChunkMax / 16; ++kb) {
        if (kb < nkb) {
          uint32_t bf[4];  // B [key][nn]: columns keys, depth nn
          ldmatrix_x4(bf, bx1 + (16 * kb + 8 * (j >> 1) + r8) * kNLd + kn +
                              8 * (j & 1));
          mma_bf16(cb[2 * kb], af, bf[0], bf[1]);
          mma_bf16(cb[2 * kb + 1], af, bf[2], bf[3]);
        }
      }
    }
  }
  __syncthreads();  // B is no longer read: its space becomes x stage 1

  for (int g = 0; g < ng; ++g) {
    const int head = h0 + g;
    bf16* xs = (g & 1) ? bx1 : xs0;
    const bf16* ss = ss0 + (g & 1) * kP * kNLd;
    if (g + 1 < ng) {
      load_head((g & 1) ? xs0 : bx1, ss0 + ((g + 1) & 1) * kP * kNLd, x,
                st_base + (head + 1) * pn, row0, head + 1, h, p, n, kmax);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // x -> bf16(x dt), by the threads that loaded each piece
    const float* dg = dth + g * kChunkMax;
    for (int e = tid; e < kmax * pc; e += kThreads) {
      const int s = e / pc, c = e % pc;
      scale_piece(xs + s * kXLd + c * 8, dg[s]);
    }
    __syncthreads();

    if (active) {
      const float* cg = csh + g * kChunkMax;
      float acc[P / 8][4];
#pragma unroll
      for (int i = 0; i < P / 8; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
      // entering state: C (rows x n) . state_in^T (n x p)
      for (int kn = 0; kn < n; kn += 16) {
        uint32_t af[4];
        ldmatrix_x4(af, ct + (16 * warp + 8 * (j & 1) + r8) * kNLd + kn +
                            8 * (j >> 1));
#pragma unroll
        for (int pt = 0; pt < P / 16; ++pt) {
          uint32_t bf[4];  // state [pp][nn]: columns pp, depth nn
          ldmatrix_x4(bf, ss + (16 * pt + 8 * (j >> 1) + r8) * kNLd + kn +
                              8 * (j & 1));
          mma_bf16(acc[2 * pt], af, bf[0], bf[1]);
          mma_bf16(acc[2 * pt + 1], af, bf[2], bf[3]);
        }
      }
      const float csa = cg[ra], csb = cg[rb];
      const float da = bf16_round(expf(csa)), db = bf16_round(expf(csb));
#pragma unroll
      for (int i = 0; i < P / 8; ++i) {
        acc[i][0] *= da;
        acc[i][1] *= da;
        acc[i][2] *= db;
        acc[i][3] *= db;
      }
      // intra-chunk: M (rows x keys) . xdt (keys x p); the key blocks
      // before the warp's rows need no mask, the last (diagonal) one does
#pragma unroll
      for (int kb = 0; kb < kChunkMax / 16; ++kb) {
        if (kb < nkb - 1)
          intra_block<false, P>(acc, cb[2 * kb], cb[2 * kb + 1], cg, xs, kb,
                                csa, csb, ra, rb, lane);
        else if (kb == nkb - 1)
          intra_block<true, P>(acc, cb[2 * kb], cb[2 * kb + 1], cg, xs, kb,
                               csa, csb, ra, rb, lane);
      }
      float* ya = y + ((row0 + ra) * h + head) * p;
      float* yb = y + ((row0 + rb) * h + head) * p;
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt) {
        const int col = 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(ya + col) =
            make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(yb + col) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
    }
    __syncthreads();  // this stage is free for the head after next
  }
}

template <int P>
cudaError_t launch_tc_output(const bf16* x, const float* dt, const float* A,
                             const bf16* B, const bf16* C, const bf16* states,
                             float* y, int b, int l, int h, int n, int chunk,
                             cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_tc_output_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemTcOutput);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int head_groups = (h + kHeadGroup - 1) / kHeadGroup;
  ssd_tc_output_kernel<P><<<dim3((chunk + kRows - 1) / kRows, l / chunk,
                                 b * head_groups),
                            kThreads, kSmemTcOutput, stream>>>(
      x, dt, A, B, C, states, y, l, h, n, chunk, head_groups);
  return cudaGetLastError();
}

int launch_tc(const bf16* x, const float* dt, const float* A, const bf16* B,
              const bf16* C, float* y, float* final_state, float* contrib,
              bf16* states, float* cs_end, int b, int l, int h, int p, int n,
              int chunk, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_tc_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemTcState);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int nc = l / chunk;
  ssd_tc_state_kernel<<<dim3(h, nc, b), kThreads, kSmemTcState, stream>>>(
      x, dt, A, B, contrib, cs_end, l, h, p, n, chunk);
  const int64_t quads = (int64_t)b * h * p * n / 4;
  ssd_tc_pass_kernel<<<(unsigned)((quads + kThreads - 1) / kThreads),
                       kThreads, 0, stream>>>(contrib, cs_end, states,
                                              final_state, nc, h, p * n,
                                              quads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (p) {
    case 16: err = launch_tc_output<16>(x, dt, A, B, C, states, y, b, l, h,
                                        n, chunk, stream); break;
    case 32: err = launch_tc_output<32>(x, dt, A, B, C, states, y, b, l, h,
                                        n, chunk, stream); break;
    case 48: err = launch_tc_output<48>(x, dt, A, B, C, states, y, b, l, h,
                                        n, chunk, stream); break;
    case 64: err = launch_tc_output<64>(x, dt, A, B, C, states, y, b, l, h,
                                        n, chunk, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // namespace

extern "C" {

// variant: 0 ffma, 1 mma_sync. dtype: 0 float32, 1 bfloat16 (x, B and C;
// dt and A are float32); mma_sync takes bfloat16 only. x (b,l,h,p), dt
// (b,l,h), B and C (b,l,n), all contiguous; y (b,l,h,p) and final_state
// (b,h,p,n) float32 out; states (b,l/chunk,h,p,n) float32 scratch (ffma:
// the contributions, then in place the entering states; mma_sync: the
// contributions); states_bf16 (b,l/chunk,h,p,n) bfloat16 scratch (mma_sync:
// the entering states; null for ffma); cs_end (b,l/chunk,h) float32
// scratch. Needs l % chunk == 0, chunk <= 256, p <= 64, n <= 128; mma_sync
// also p, n and chunk multiples of 16 and 16-byte aligned pointers (the
// wrapper checks). Returns a CUDA error code, 0 on success.
int ssd_launch(int variant, int dtype, const void* x, const float* dt,
               const float* A, const void* B, const void* C, float* y,
               float* final_state, float* states, void* states_bf16,
               float* cs_end, int b, int l, int h, int p, int n, int chunk,
               void* stream) {
  if (chunk <= 0 || chunk > kChunkMax || l % chunk != 0 || p <= 0 ||
      p > kP || n <= 0 || n > kN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (dtype != 1 || p % 16 || n % 16 || chunk % 16 || !states_bf16)
      return (int)cudaErrorInvalidValue;
    return launch_tc(static_cast<const bf16*>(x), dt, A,
                     static_cast<const bf16*>(B), static_cast<const bf16*>(C),
                     y, final_state, states, static_cast<bf16*>(states_bf16),
                     cs_end, b, l, h, p, n, chunk, s);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
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
