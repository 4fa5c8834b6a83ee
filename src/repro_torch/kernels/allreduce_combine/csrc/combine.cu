// Multi-operand elementwise reduction (the allreduce "combine") for Hopper.
//
// Replaces the Pallas TPU kernel repro.kernels.allreduce_combine.kernel.combine
// (the paper's section 4.7 Allreduce-accelerator arithmetic): out[j] = op over
// p of x[p, j], for a (P, L) tensor whose rows may sit at any stride.
//
//   sum      accumulate in float32 over the parts in order 0..P-1, then
//            convert to the input dtype (int32 too: summed through float32,
//            exact below 2^24, as the reference's combine_ref does)
//   max/min  in the native dtype; a NaN in any part makes the output NaN
//            (as jnp.max does; fmaxf would drop it and hide a diverged
//            gradient)
//
// What bounds it on the H100: bytes. Each element is read P times and
// written once, one add or compare per element read: ~0.25 operations per
// byte against the ~20 the card needs before arithmetic matters. So the
// design is all about the load path: one thread per 16-byte vector of L
// (4 float/int32 or 8 bf16), a grid-stride loop over vectors, and the loads
// of up to kUnroll parts issued before any add so that several 16-byte loads
// are in flight per thread. A scalar masked tail covers L % vec; when a row
// is not 16-byte aligned (a shard of a bucket is a view at an offset of
// i*n/k elements, which need not be aligned) the whole call takes the
// scalar path. The TPU kernel's fixed 2048-wide blocks do not carry over:
// blocks here are 256 threads and the grid is sized from the SM count.
//
// Plain C interface, bound with ctypes (repro_torch/kernels/allreduce_combine
// /kernel.py): combine_launch returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

enum Op { kSum = 0, kMax = 1, kMin = 2 };
enum Dtype { kF32 = 0, kBF16 = 1, kI32 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int x) { return __int2float_rn(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ int from_f32<int>(float x) {
  return __float2int_rz(x);   // astype(int32) truncates toward zero
}

// running = op(running, v); NaN in either operand wins for floats
template <int OP, typename T>
__device__ __forceinline__ T pick(T running, T v) {
  if constexpr (std::is_same<T, int>::value) {
    if (OP == kMax) return v > running ? v : running;
    return v < running ? v : running;
  } else {
    const float r = to_f32(running), x = to_f32(v);
    if (r != r) return running;
    if (x != x) return v;
    if (OP == kMax) return x > r ? v : running;
    return x < r ? v : running;
  }
}

// Accumulator of one element: float for sum, the native type otherwise.
template <int OP, typename T>
struct Acc {
  using type = T;
  __device__ __forceinline__ static T first(T v) { return v; }
  __device__ __forceinline__ static T step(T a, T v) { return pick<OP>(a, v); }
  __device__ __forceinline__ static T out(T a) { return a; }
};
template <typename T>
struct Acc<kSum, T> {
  using type = float;
  __device__ __forceinline__ static float first(T v) { return to_f32(v); }
  __device__ __forceinline__ static float step(float a, T v) {
    return a + to_f32(v);
  }
  __device__ __forceinline__ static T out(float a) { return from_f32<T>(a); }
};

// One output element from P parts, strided by `row` elements.
template <int OP, typename T>
__device__ __forceinline__ void reduce_one(const T* __restrict__ x,
                                           T* __restrict__ out, int P,
                                           long long row, long long j) {
  using A = Acc<OP, T>;
  typename A::type acc = A::first(x[j]);
  for (int p = 1; p < P; ++p) acc = A::step(acc, x[p * row + j]);
  out[j] = A::out(acc);
}

template <int OP, typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const T* __restrict__ x, T* __restrict__ out, int P,
               long long row, long long L) {
  using A = Acc<OP, T>;
  constexpr int kVec = 16 / sizeof(T);
  const long long tid = blockIdx.x * (long long)kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  if (!kVector) {
    for (long long j = tid; j < L; j += stride) reduce_one<OP>(x, out, P, row, j);
    return;
  }
  const long long nvec = L / kVec;
  for (long long v = tid; v < nvec; v += stride) {
    const T* base = x + v * kVec;
    typename A::type acc[kVec];
    for (int p0 = 0; p0 < P; p0 += kUnroll) {
      uint4 buf[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (p0 + u < P)
          buf[u] = __ldg(reinterpret_cast<const uint4*>(base + (p0 + u) * row));
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p0 + u >= P) break;
        const T* e = reinterpret_cast<const T*>(&buf[u]);
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          acc[i] = (p0 + u == 0) ? A::first(e[i]) : A::step(acc[i], e[i]);
      }
    }
    alignas(16) T res[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) res[i] = A::out(acc[i]);
    *reinterpret_cast<uint4*>(out + v * kVec) = *reinterpret_cast<uint4*>(res);
  }
  // masked scalar tail: the last L % kVec elements, one per thread
  const long long j = nvec * kVec + tid;
  if (j < L) reduce_one<OP>(x, out, P, row, j);
}

template <int OP, typename T>
cudaError_t launch_typed(const void* x, void* out, int P, long long row,
                         long long L, int vectorized, int blocks,
                         cudaStream_t stream) {
  const T* xs = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (vectorized)
    combine_kernel<OP, T, true><<<blocks, kThreads, 0, stream>>>(xs, o, P, row, L);
  else
    combine_kernel<OP, T, false><<<blocks, kThreads, 0, stream>>>(xs, o, P, row, L);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_op(int op, const void* x, void* out, int P, long long row,
                      long long L, int vectorized, int blocks,
                      cudaStream_t stream) {
  switch (op) {
    case kSum: return launch_typed<kSum, T>(x, out, P, row, L, vectorized, blocks, stream);
    case kMax: return launch_typed<kMax, T>(x, out, P, row, L, vectorized, blocks, stream);
    case kMin: return launch_typed<kMin, T>(x, out, P, row, L, vectorized, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int combine_launch(int dtype, int op, const void* x, void* out,
                              int P, long long row, long long L,
                              int vectorized, int blocks, void* stream) {
  if (P < 1 || L < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kF32: err = launch_op<float>(op, x, out, P, row, L, vectorized, blocks, s); break;
    case kBF16: err = launch_op<__nv_bfloat16>(op, x, out, P, row, L, vectorized, blocks, s); break;
    case kI32: err = launch_op<int>(op, x, out, P, row, L, vectorized, blocks, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* combine_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
