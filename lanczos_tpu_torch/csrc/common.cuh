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

}  // namespace lt
