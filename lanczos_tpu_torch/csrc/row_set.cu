// E3: write the vector w into row k of a (cap1, n) buffer in place, with k
// a word in device memory that the host never reads.
//
// Replaces the Pallas TPU kernel experiments/carry_copy_bench.py
// row_set_pallas (kernel _row_write_kernel), the in-place row write of the
// Krylov-buffer carry study: there k is a scalar-prefetch operand and the
// buffer is aliased to the output, so only one row moves.  Here one launch
// reads k itself and copies n values into row k; a k outside [0, cap1)
// writes nothing (the Pallas index map has no defined behaviour there).
//
// What bounds it on the H100: bytes, 2 n sizeof(T) (w read once, the row
// written once): 2.5 us at n = 2^20 in float32 at the data sheet's 3.35
// TB/s, the order of one launch's own latency.  Eagerly the host's launch
// path sets the time, so the entry points below do no more than the launch
// needs: the device is made current only when it is not, and the SM count
// is read once per device.  Inside a captured CUDA graph (k a device word
// the graph advances, which is what k on the device is for) the copy
// itself counts, and k is the output of the node before: so each thread
// issues the loads of its kUnroll 16-byte vectors of w first and reads k
// after them (one latency instead of two in a row; w does not depend on k),
// then stores to row k.  The grid is ceil(n / (kThreads kUnroll VN)) CTAs,
// at most kBlocksPerSm per SM with a grid-stride loop past that.  Rows
// that are not 16-byte aligned (n % VN != 0) are copied element by element.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;       // 16-byte vectors in flight per thread
constexpr int kBlocksPerSm = 8;  // 2048 resident threads per SM
constexpr int kMaxDevices = 64;

int g_sms[kMaxDevices];  // SMs per device ordinal, 0 until read

// Loads pinned in program order by asm volatile, so that the loads of w
// stay ahead of the read of k.
__device__ __forceinline__ int load_k(const int* k) {
  int v;
  asm volatile("ld.global.u32 %0, [%1];" : "=r"(v) : "l"(k) : "memory");
  return v;
}

__device__ __forceinline__ float4 load_w(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ double2 load_w(const double2* p) {
  double2 v;
  asm volatile("ld.global.nc.v2.f64 {%0, %1}, [%2];" : "=d"(v.x), "=d"(v.y) : "l"(p) : "memory");
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    row_set_kernel(T* __restrict__ buf, const int* __restrict__ k, const T* __restrict__ w, int cap1, int64_t n,
                   bool vec_ok) {
  using V = typename lt::Vec<T>::type;
  constexpr int VN = lt::Vec<T>::n;
  if (!vec_ok) {
    const int kk = load_k(k);
    if (kk < 0 || kk >= cap1) return;
    T* row = buf + int64_t(kk) * n;
    const int64_t step = int64_t(gridDim.x) * kThreads;
    for (int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x; i < n; i += step) row[i] = w[i];
    return;
  }
  const V* src = reinterpret_cast<const V*>(w);
  V* dst = nullptr;  // row k, once k is read
  const int64_t nv = n / VN;
  const int64_t step = int64_t(gridDim.x) * kThreads * kUnroll;
  for (int64_t base = int64_t(blockIdx.x) * kThreads * kUnroll + threadIdx.x; base < nv; base += step) {
    V t[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (base + u * kThreads < nv) t[u] = load_w(src + base + u * kThreads);
    if (dst == nullptr) {
      const int kk = load_k(k);
      if (kk < 0 || kk >= cap1) return;
      dst = reinterpret_cast<V*>(buf + int64_t(kk) * n);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (base + u * kThreads < nv) dst[base + u * kThreads] = t[u];
  }
}

// Makes `device` current if it is not (this library has its own runtime,
// whose current device need not be PyTorch's) and returns its SM count.
cudaError_t prepare(int device, int* sms) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  if (cur != device && (e = cudaSetDevice(device)) != cudaSuccess) return e;
  if (g_sms[device] == 0) {
    int count = 0;
    e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    g_sms[device] = count;
  }
  *sms = g_sms[device];
  return cudaSuccess;
}

template <typename T>
cudaError_t row_set(T* buf, const int* k, const T* w, int cap1, int64_t n, int device, cudaStream_t stream) {
  constexpr int VN = lt::Vec<T>::n;
  if (n <= 0 || cap1 <= 0) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = prepare(device, &sms);
  if (e != cudaSuccess) return e;
  const bool vec_ok = n % VN == 0 && lt::aligned16(buf) && lt::aligned16(w);
  const int64_t per_block = vec_ok ? int64_t(kThreads) * kUnroll * VN : int64_t(kThreads);
  int64_t blocks = (n + per_block - 1) / per_block;
  const int64_t cap = int64_t(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  row_set_kernel<T><<<unsigned(blocks), kThreads, 0, stream>>>(buf, k, w, cap1, n, vec_ok);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// `k` points to one int32 on the device.  `device` is the CUDA ordinal the
// tensors and `stream` belong to.
int lt_row_set_f32(float* buf, const int* k, const float* w, int cap1, long long n, int device, void* stream) {
  return int(row_set<float>(buf, k, w, cap1, n, device, static_cast<cudaStream_t>(stream)));
}

int lt_row_set_f64(double* buf, const int* k, const double* w, int cap1, long long n, int device, void* stream) {
  return int(row_set<double>(buf, k, w, cap1, n, device, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
