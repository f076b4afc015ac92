// E3: write the vector w into row k of a (cap1, n) buffer in place, with k
// a word in device memory that the host never reads.
//
// Replaces the Pallas TPU kernel experiments/carry_copy_bench.py
// row_set_pallas (kernel _row_write_kernel), the in-place row write of the
// Krylov-buffer carry study: there k is a scalar-prefetch operand and the
// buffer is aliased to the output, so only one row moves.  Here one launch
// reads k itself and copies n values into row k, one 16-byte vector per
// thread; a k outside [0, cap1) writes nothing (the Pallas index map has no
// defined behaviour there).
//
// What bounds it on the H100: bytes, 2 n sizeof(T) (w read once, the row
// written once): 2.5 us at n = 2^20 in float32 at the data sheet's 3.35
// TB/s, which is the order of one launch's own latency, so at the study's
// sizes the launch, not the copy, sets the time.  The design does nothing
// more than stream the copy: no host sync for k, no second launch.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    row_set_kernel(T* __restrict__ buf, const int* __restrict__ k, const T* __restrict__ w, int cap1, int64_t n,
                   bool vec_ok) {
  using V = typename lt::Vec<T>::type;
  constexpr int VN = lt::Vec<T>::n;
  const int kk = *k;
  if (kk < 0 || kk >= cap1) return;
  T* row = buf + int64_t(kk) * n;
  const int64_t e0 = (int64_t(blockIdx.x) * kThreads + threadIdx.x) * VN;
  if (vec_ok) {
    if (e0 < n) *reinterpret_cast<V*>(row + e0) = *reinterpret_cast<const V*>(w + e0);
  } else {
#pragma unroll
    for (int c = 0; c < VN; ++c)
      if (e0 + c < n) row[e0 + c] = w[e0 + c];
  }
}

template <typename T>
cudaError_t row_set(T* buf, const int* k, const T* w, int cap1, int64_t n, cudaStream_t stream) {
  constexpr int VN = lt::Vec<T>::n;
  if (n <= 0 || cap1 <= 0) return cudaErrorInvalidValue;
  const bool vec_ok = n % VN == 0 && lt::aligned16(buf) && lt::aligned16(w);
  const int64_t blocks = (n + int64_t(kThreads) * VN - 1) / (int64_t(kThreads) * VN);
  row_set_kernel<T><<<unsigned(blocks), kThreads, 0, stream>>>(buf, k, w, cap1, n, vec_ok);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// `k` points to one int32 on the device.  `device` is the CUDA ordinal the
// tensors and `stream` belong to (made current here: this library has its
// own runtime).
int lt_row_set_f32(float* buf, const int* k, const float* w, int cap1, long long n, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(row_set<float>(buf, k, w, cap1, n, static_cast<cudaStream_t>(stream)));
}

int lt_row_set_f64(double* buf, const int* k, const double* w, int cap1, long long n, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(row_set<double>(buf, k, w, cap1, n, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
