// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace lt {

// Complex values: two words, re then im, the storage of torch.complex64
// and torch.complex128, so a tensor is read where it lies.  The type and its
// arithmetic live in their own namespace, where argument-dependent lookup
// finds them from the kernels' unqualified fma() calls, and no name of lt
// hides the real fma() overloads.
namespace cx {

template <typename R>
struct alignas(2 * sizeof(R)) Cplx {
  R re, im;
  Cplx() = default;  // trivial, so arrays of it may be __shared__
  __host__ __device__ constexpr Cplx(R r) : re(r), im(R(0)) {}
  __host__ __device__ constexpr Cplx(R r, R i) : re(r), im(i) {}
  template <typename S>
  __host__ __device__ explicit constexpr Cplx(const Cplx<S>& o) : re(R(o.re)), im(R(o.im)) {}
};

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename R>
__host__ __device__ __forceinline__ Cplx<R> operator-(Cplx<R> a) {
  return Cplx<R>(-a.re, -a.im);
}

template <typename R>
__host__ __device__ __forceinline__ Cplx<R>& operator+=(Cplx<R>& a, Cplx<R> b) {
  a.re += b.re;
  a.im += b.im;
  return a;
}

// a * b + c: four real FMAs in a fixed order (CUDA cores, no tensor cores).
template <typename R>
__device__ __forceinline__ Cplx<R> fma(Cplx<R> a, Cplx<R> b, Cplx<R> c) {
  R re = fma_rn(a.re, b.re, c.re);
  re = fma_rn(-a.im, b.im, re);
  R im = fma_rn(a.re, b.im, c.im);
  im = fma_rn(a.im, b.re, im);
  return Cplx<R>(re, im);
}

// conj(a) * b + c, in the same fixed order.
template <typename R>
__device__ __forceinline__ Cplx<R> fma_conj(Cplx<R> a, Cplx<R> b, Cplx<R> c) {
  R re = fma_rn(a.re, b.re, c.re);
  re = fma_rn(a.im, b.im, re);
  R im = fma_rn(a.re, b.im, c.im);
  im = fma_rn(-a.im, b.re, im);
  return Cplx<R>(re, im);
}

}  // namespace cx

using cfloat = cx::Cplx<float>;
using cdouble = cx::Cplx<double>;

// conj(a) * b + c: a plain FMA for real types (the inner products'
// projections conjugate their first argument).
template <typename T>
__device__ __forceinline__ T fma_conj(T a, T b, T c) {
  return fma(a, b, c);
}
template <typename R>
__device__ __forceinline__ cx::Cplx<R> fma_conj(cx::Cplx<R> a, cx::Cplx<R> b, cx::Cplx<R> c) {
  return cx::fma_conj(a, b, c);
}

// Accumulator type: f32 tiles accumulate in f32 (the Pallas kernels'
// preferred_element_type), f64 in f64, complex in its own type.
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
template <>
struct Acc<cfloat> {
  using type = cfloat;
};
template <>
struct Acc<cdouble> {
  using type = cdouble;
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
template <>
struct Vec<cfloat> {
  using type = float4;
  static constexpr int n = 2;
};
template <>
struct Vec<cdouble> {
  using type = double2;
  static constexpr int n = 1;
};
template <>
struct Vec<__nv_bfloat16> {
  using type = uint4;
  static constexpr int n = 8;
};

// A stored value in the type its arithmetic runs in: bfloat16 (a storage
// type: tiles only, never a vector) widens to float, which is exact, so a
// product of widened values is the product of the stored ones; every other
// type as it is.
template <typename T>
__device__ __forceinline__ T arith(T v) {
  return v;
}
__device__ __forceinline__ float arith(__nv_bfloat16 v) { return __bfloat162float(v); }

// The next lanes' value, o lanes down; a complex value moves as its two words.
template <typename A>
__device__ __forceinline__ A shfl_down(A v, int o) {
  return __shfl_down_sync(0xffffffffu, v, o);
}
template <typename R>
__device__ __forceinline__ cx::Cplx<R> shfl_down(cx::Cplx<R> v, int o) {
  return cx::Cplx<R>(__shfl_down_sync(0xffffffffu, v.re, o), __shfl_down_sync(0xffffffffu, v.im, o));
}

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += shfl_down(v, o);
  return v;
}

// One value read evict-first (ld.global.cs); a complex value is one 8- or
// 16-byte load of its two words.
template <typename T>
__device__ __forceinline__ T ldcs(const T* p) {
  return __ldcs(p);
}
__device__ __forceinline__ cfloat ldcs(const cfloat* p) {
  const float2 t = __ldcs(reinterpret_cast<const float2*>(p));
  return cfloat(t.x, t.y);
}
__device__ __forceinline__ cdouble ldcs(const cdouble* p) {
  const double2 t = __ldcs(reinterpret_cast<const double2*>(p));
  return cdouble(t.x, t.y);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

__host__ __device__ constexpr size_t round_up16(size_t b) { return (b + 15u) & ~size_t(15u); }

// Make `device` current for this library's own runtime, with no
// cudaSetDevice when it already is (a launch path's host time).
inline cudaError_t make_current(int device) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  return cur == device ? cudaSuccess : cudaSetDevice(device);
}

// Internal linkage: every translation unit that includes this header gets
// its own copy of the kernels and device functions below.
namespace {

// A CTA of THREADS threads covers one row segment of THREADS*U*VN elements
// starting at `base`; thread x owns the U 16-byte vectors at
// base + (u*THREADS + x)*VN.  `vec_ok` (n a multiple of VN and 16-byte
// aligned rows) selects vector loads; elements past n read as zero.
// `stream` marks the loads evict-first (ld.global.cs: read once, the first
// lines L1 and L2 give up).
template <typename T, int THREADS, int U>
__device__ __forceinline__ void load_seg(const T* __restrict__ row, int64_t base, int64_t n,
                                         bool vec_ok, T (&out)[U * Vec<T>::n], bool stream = false) {
  using V = typename Vec<T>::type;
  constexpr int VN = Vec<T>::n;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t e0 = base + (int64_t(u) * THREADS + threadIdx.x) * VN;
    if (vec_ok) {
      if (e0 < n) {
        const V* p = reinterpret_cast<const V*>(row + e0);
        const V t = stream ? __ldcs(p) : *p;
        const T* tt = reinterpret_cast<const T*>(&t);
#pragma unroll
        for (int c = 0; c < VN; ++c) out[u * VN + c] = tt[c];
      } else {
#pragma unroll
        for (int c = 0; c < VN; ++c) out[u * VN + c] = T(0);
      }
    } else {
#pragma unroll
      for (int c = 0; c < VN; ++c) out[u * VN + c] = e0 + c < n ? (stream ? ldcs(row + e0 + c) : row[e0 + c]) : T(0);
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
