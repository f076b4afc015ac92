// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace lt {

// Accumulator type: f32 tiles accumulate in f32 (the Pallas kernels'
// preferred_element_type), f64 in f64.
template <typename T>
struct Acc;
template <>
struct Acc<float> {
  using type = float;
};
template <>
struct Acc<double> {
  using type = double;
};

// One 16-byte vector of T: the widest load a thread can issue.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
};

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

inline size_t round_up16(size_t b) { return (b + 15u) & ~size_t(15u); }

// Internal linkage: every translation unit that includes this header gets
// its own copy of the kernels and device functions below.
namespace {

// A CTA of THREADS threads covers one row segment of THREADS*U*VN elements
// starting at `base`; thread x owns the U 16-byte vectors at
// base + (u*THREADS + x)*VN.  `vec_ok` (n a multiple of VN and 16-byte
// aligned rows) selects vector loads; elements past n read as zero.
template <typename T, int THREADS, int U>
__device__ __forceinline__ void load_seg(const T* __restrict__ row, int64_t base, int64_t n,
                                         bool vec_ok, T (&out)[U * Vec<T>::n]) {
  using V = typename Vec<T>::type;
  constexpr int VN = Vec<T>::n;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t e0 = base + (int64_t(u) * THREADS + threadIdx.x) * VN;
    if (vec_ok) {
      if (e0 < n) {
        const V t = *reinterpret_cast<const V*>(row + e0);
        const T* tt = reinterpret_cast<const T*>(&t);
#pragma unroll
        for (int c = 0; c < VN; ++c) out[u * VN + c] = tt[c];
      } else {
#pragma unroll
        for (int c = 0; c < VN; ++c) out[u * VN + c] = T(0);
      }
    } else {
#pragma unroll
      for (int c = 0; c < VN; ++c) out[u * VN + c] = e0 + c < n ? row[e0 + c] : T(0);
    }
  }
}

// The store matching load_seg: writes the thread's elements below n,
// rounded from the accumulator type A to T.
template <typename T, int THREADS, int U, typename A>
__device__ __forceinline__ void store_seg(T* __restrict__ row, int64_t base, int64_t n, bool vec_ok,
                                          const A (&vals)[U * Vec<T>::n]) {
  using V = typename Vec<T>::type;
  constexpr int VN = Vec<T>::n;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t e0 = base + (int64_t(u) * THREADS + threadIdx.x) * VN;
    if (vec_ok) {
      if (e0 < n) {
        V out;
        T* oo = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int q = 0; q < VN; ++q) oo[q] = T(vals[u * VN + q]);
        *reinterpret_cast<V*>(row + e0) = out;
      }
    } else {
#pragma unroll
      for (int q = 0; q < VN; ++q)
        if (e0 + q < n) row[e0 + q] = T(vals[u * VN + q]);
    }
  }
}

// out[j] = sum_t part[j, t] over the n_tiles partial sums of row j, one CTA
// per row, in a fixed order (no atomics: the same result on every run).
template <typename A, int THREADS>
__global__ void __launch_bounds__(THREADS)
    reduce_rows_kernel(const A* __restrict__ part, A* __restrict__ out, int64_t n_tiles) {
  constexpr int kWarps = THREADS / 32;
  __shared__ A red[kWarps];
  const int64_t j = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  A s = A(0);
  for (int64_t t = threadIdx.x; t < n_tiles; t += THREADS) s += part[j * n_tiles + t];
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    A tot = A(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tot += red[w];
    out[j] = tot;
  }
}

}  // namespace
}  // namespace lt
