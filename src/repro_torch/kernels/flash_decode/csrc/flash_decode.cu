// Flash-decoding for Hopper (sm_90a): one query token per head against a
// KV cache, with a per-row live length.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode/kernel.py
// (flash_decode, body _fd_kernel): out[b,h] = softmax(q[b,h] . k[b,:len_b,g]
// * dk^-0.5) @ v[b,:len_b,g] with g = h / (H/K), online softmax in float32.
// Unlike the TPU kernel it takes one length per row (the serving engine's
// slots sit at different depths), and S need not be a multiple of a chunk.
//
// What bounds it: bytes. Each live K/V row is read once and used for one
// multiply-add per query head in its group, so the work is
//   sum_b len_b * K * (dk + dv) * dtype_bytes  (+ q, the output, lengths)
// over the card's 3.35 TB/s; at rep = H/K <= 16 query heads per KV head that
// is far below the ~295 flop/byte where the tensor cores would bound it.
//
// What the design does about it: the TPU sweeps S in order in one program per
// (b, kv head), which at B*K = 32 would leave most of the 132 SMs idle. Here
// S is split across CTAs (flash-decoding): the grid is (n_splits, K *
// row_tiles, B); each CTA streams its span of K/V rows with 16-byte loads,
// several rows in flight per lane, keeps its query rows in registers (each
// lane only ever needs its own 16-byte slice of q), runs the online softmax
// (m, l, acc in f32), and writes partial (m, l, acc) to scratch. A second
// small kernel merges the live splits and casts to the output dtype. A row's
// live length is divided evenly over the splits, so every CTA of a row gets a
// share of its work; splits that start at or past len_b return at once and
// are not read by the merge: only live positions are read.
//
// The C entry point allocates nothing (the caller passes the output and the
// f32 split scratch), launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowTile = 4;   // query rows per CTA (rows of one KV head)
constexpr int kUnroll = 4;    // K/V rows each lane has in flight per step

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int kElems = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int kElems = 8; };

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* out);

template <>
__device__ __forceinline__ void unpack<float>(const uint4& raw, float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

// bf16 -> f32 is exact: the bf16 bits are the high half of the f32 bits.
// Element 2i sits in the low half of word i (little endian).
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& raw,
                                                      float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);   // round to nearest even, as torch's cast
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ int live_length(const int* lengths, int b, int S) {
  return min(max(lengths[b], 0), S);
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
fd_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const int* __restrict__ lengths,
                float* __restrict__ m_part, float* __restrict__ l_part,
                float* __restrict__ acc_part, int B, int H, int S, int K,
                int n_splits, int row_tiles, long long k_sb, long long k_ss,
                long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                float scale) {
  constexpr int kVec = Vec<T>::kElems;
  constexpr int kLanes = DK / kVec;          // lanes sharing one K row
  static_assert(kLanes <= 32 && 32 % kLanes == 0, "a K row maps onto a warp");
  constexpr int kRowsPerWarp = 32 / kLanes;
  constexpr int kGroups = kWarps * kRowsPerWarp;  // K/V rows per CTA pass
  constexpr int kVE = DV / kLanes;           // V elements held by one lane
  static_assert(kVE % kVec == 0, "a lane's V slice is whole 16-byte vectors");
  constexpr int kVV = kVE / kVec;

  const int split = blockIdx.x;
  const int g = blockIdx.y / row_tiles;
  const int r0 = (blockIdx.y % row_tiles) * kRowTile;
  const int b = blockIdx.z;
  const int rep = H / K;
  const int len = live_length(lengths, b, S);
  const int span = (len + n_splits - 1) / n_splits;
  const int start = split * span;
  if (start >= len) return;   // uniform over the CTA: nothing live here
  const int end = min(start + span, len);

  const int lane = threadIdx.x & 31;
  const int grp = (threadIdx.x >> 5) * kRowsPerWarp + lane / kLanes;
  const int sub = lane % kLanes;
  const int nrows = min(kRowTile, rep - r0);

  float qf[kRowTile][kVec];
#pragma unroll
  for (int r = 0; r < kRowTile; ++r) {
    if (r < nrows) {
      const long long row = (long long)b * H + g * rep + r0 + r;
      unpack<T>(load16(q + row * DK + sub * kVec), qf[r]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) qf[r][e] = 0.f;
    }
  }

  float m[kRowTile], l[kRowTile], acc[kRowTile][kVE];
#pragma unroll
  for (int r = 0; r < kRowTile; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kVE; ++e) acc[r][e] = 0.f;
  }

  const T* kb = k + (long long)b * k_sb + (long long)g * k_sh + sub * kVec;
  const T* vb = v + (long long)b * v_sb + (long long)g * v_sh + sub * kVE;

  for (int p0 = start; p0 < end; p0 += kGroups * kUnroll) {
    uint4 kr[kUnroll];
    uint4 vr[kUnroll][kVV];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u * kGroups + grp;
      if (p < end) {
        kr[u] = load16(kb + (long long)p * k_ss);
#pragma unroll
        for (int j = 0; j < kVV; ++j)
          vr[u][j] = load16(vb + (long long)p * v_ss + j * kVec);
      } else {
        kr[u] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int j = 0; j < kVV; ++j) vr[u][j] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[kVec];
      unpack<T>(kr[u], kf);
      float s[kRowTile];
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) a = fmaf(qf[r][e], kf[e], a);
        s[r] = a;
      }
      // every lane of the warp takes part, live position or not
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int r = 0; r < kRowTile; ++r)
          s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
      }
      const int p = p0 + u * kGroups + grp;
      if (p < end) {
        float vf[kVE];
#pragma unroll
        for (int j = 0; j < kVV; ++j) unpack<T>(vr[u][j], vf + j * kVec);
#pragma unroll
        for (int r = 0; r < kRowTile; ++r) {
          const float sr = s[r] * scale;
          const float mn = fmaxf(m[r], sr);
          const float c = expf(m[r] - mn);   // 0 while m is still -inf
          const float pr = expf(sr - mn);
          l[r] = fmaf(l[r], c, pr);
#pragma unroll
          for (int e = 0; e < kVE; ++e) acc[r][e] = fmaf(pr, vf[e], acc[r][e] * c);
          m[r] = mn;
        }
      }
    }
  }

  // merge the CTA's kGroups partial softmaxes, then write this split's part
  __shared__ float sm_m[kGroups][kRowTile];
  __shared__ float sm_l[kGroups][kRowTile];
  __shared__ float sm_acc[kGroups][kRowTile][DV];
#pragma unroll
  for (int r = 0; r < kRowTile; ++r) {
    if (sub == 0) {
      sm_m[grp][r] = m[r];
      sm_l[grp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < kVE; ++e) sm_acc[grp][r][sub * kVE + e] = acc[r][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nrows * DV; idx += kThreads) {
    const int r = idx / DV, d = idx % DV;
    float mx = -INFINITY;
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) mx = fmaxf(mx, sm_m[gi][r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
      const float mg = sm_m[gi][r];
      if (mg == -INFINITY) continue;    // this group saw no live position
      const float w = expf(mg - mx);
      L = fmaf(sm_l[gi][r], w, L);
      A = fmaf(sm_acc[gi][r][d], w, A);
    }
    const long long row = ((long long)split * B + b) * H + g * rep + r0 + r;
    acc_part[row * DV + d] = A;
    if (d == 0) {
      m_part[row] = mx;
      l_part[row] = L;
    }
  }
}

template <typename T, int DV>
__global__ void __launch_bounds__(DV)
fd_combine_kernel(const float* __restrict__ m_part,
                  const float* __restrict__ l_part,
                  const float* __restrict__ acc_part,
                  const int* __restrict__ lengths, T* __restrict__ out, int B,
                  int H, int S, int n_splits) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int len = live_length(lengths, b, S);
  const int span = (len + n_splits - 1) / n_splits;
  const int live = span > 0 ? (len + span - 1) / span : 0;  // splits written
  float mx = -INFINITY;
  for (int s = 0; s < live; ++s)
    mx = fmaxf(mx, m_part[((long long)s * B + b) * H + h]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < live; ++s) {
    const long long row = ((long long)s * B + b) * H + h;
    const float w = expf(m_part[row] - mx);
    L = fmaf(l_part[row], w, L);
    A = fmaf(acc_part[row * DV + d], w, A);
  }
  store(out + ((long long)b * H + h) * DV + d, A / fmaxf(L, 1e-30f));
}

template <typename T, int DK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, float* m_part, float* l_part,
                   float* acc_part, int B, int H, int S, int K,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh,
                   int n_splits, float scale, cudaStream_t stream) {
  const int rep = H / K;
  const int row_tiles = (rep + kRowTile - 1) / kRowTile;
  const dim3 grid(n_splits, K * row_tiles, B);
  fd_split_kernel<T, DK, DV><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, m_part, l_part, acc_part, B, H, S, K,
      n_splits, row_tiles, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fd_combine_kernel<T, DV><<<dim3(H, B), DV, 0, stream>>>(
      m_part, l_part, acc_part, lengths, static_cast<T*>(out), B, H, S,
      n_splits);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. (dk, dv) in {(64,64), (128,128), (64,128)}.
// q (B,H,dk) and out (B,H,dv) are contiguous; k/v strides are in elements
// (batch, position, kv head) with the head dim contiguous; lengths is (B,)
// int32; m_part/l_part are (n_splits,B,H) and acc_part (n_splits,B,H,dv) f32.
extern "C" int fd_launch(int device, int dtype, int dk, int dv, const void* q,
                         const void* k, const void* v, const void* lengths,
                         void* out, void* m_part, void* l_part, void* acc_part,
                         int B, int H, int S, int K, long long k_sb,
                         long long k_ss, long long k_sh, long long v_sb,
                         long long v_ss, long long v_sh, int n_splits,
                         float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int* len = static_cast<const int*>(lengths);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FD_CASE(T, DK_, DV_)                                                  \
  if (dk == DK_ && dv == DV_)                                                 \
    return (int)launch<T, DK_, DV_>(q, k, v, len, out, mp, lp, ap, B, H, S, K, \
                                    k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,        \
                                    n_splits, scale, st);
  if (dtype == 0) {
    FD_CASE(float, 64, 64)
    FD_CASE(float, 128, 128)
    FD_CASE(float, 64, 128)
  } else if (dtype == 1) {
    FD_CASE(__nv_bfloat16, 64, 64)
    FD_CASE(__nv_bfloat16, 128, 128)
    FD_CASE(__nv_bfloat16, 64, 128)
  }
#undef FD_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
