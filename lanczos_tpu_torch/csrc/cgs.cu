// K3: one classical Gram-Schmidt pass, v <- v - B[:k]^T (B[:k] v).
//
// Replaces the Pallas TPU kernel lanczos_tpu/ops/pallas_cgs.py cgs_pass
// (kernel _kernel): phase 0 collects the k coefficients against the
// unmodified v over n-tiles, phase 1 applies the update.  On the TPU the
// phase boundary is a sequential grid dimension; on the H100 CTAs run in no
// order, so the dependency across the whole grid becomes three launches on
// one stream:
//   1. cgs_project_kernel: part[j, t] = B[j, tile t] . v[tile t] for j < k;
//   2. cgs_reduce_kernel:  c[j] = sum_t part[j, t], in a fixed order;
//   3. cgs_update_kernel:  v[tile] -= sum_j c[j] B[j, tile], in place.
//
// What bounds it on the H100: bytes.  The pass sweeps the k live rows of the
// basis twice (2 k n values) and does 2 FMAs per value read, so the card's
// memory stream is the limit.  The design serves that stream:
//   * each CTA owns one n-tile and keeps its slice of v in registers for
//     the whole sweep, so v is read once per launch and the basis rows are
//     the only traffic that scales with k;
//   * rows are streamed with 16-byte loads, eight rows at a time in the
//     projection so each thread has 16 independent loads in flight;
//   * only the live rows [0, k) are read, so the traffic follows k and not
//     the buffer's capacity (the Pallas kernel's dynamic chunk count);
//   * no atomics: partial sums are reduced in a fixed order by a second
//     launch, so the result is the same from run to run.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;     // 16-byte vectors per thread per row
constexpr int kRowGroup = 8;   // rows projected together
constexpr int kCChunk = 1024;  // coefficients staged in shared memory at a time

template <typename T>
__host__ __device__ constexpr int64_t tile_width() {
  return int64_t(kThreads) * kUnroll * lt::Vec<T>::n;
}

template <typename T>
int64_t num_tiles(int64_t n) {
  return (n + tile_width<T>() - 1) / tile_width<T>();
}

// Loads the thread's kUnroll*VN elements of one row segment starting at
// tile_base (zeros past n).
template <typename T>
__device__ __forceinline__ void load_seg(const T* __restrict__ row, int64_t tile_base, int64_t n,
                                         bool vec_ok, T (&out)[kUnroll * lt::Vec<T>::n]) {
  using V = typename lt::Vec<T>::type;
  constexpr int VN = lt::Vec<T>::n;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t e0 = tile_base + (int64_t(u) * kThreads + threadIdx.x) * VN;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cgs_project_kernel(const T* __restrict__ basis, const T* __restrict__ v,
                       typename lt::Acc<T>::type* __restrict__ part, int64_t n, int k,
                       int64_t n_tiles, bool vec_ok) {
  using A = typename lt::Acc<T>::type;
  constexpr int E = kUnroll * lt::Vec<T>::n;
  __shared__ A red[2][kWarps][kRowGroup];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = blockIdx.x;
  const int64_t tile_base = t * tile_width<T>();

  T vr[E];
  load_seg<T>(v, tile_base, n, vec_ok, vr);

  for (int j0 = 0, g = 0; j0 < k; j0 += kRowGroup, g ^= 1) {
    A s[kRowGroup];
#pragma unroll
    for (int q = 0; q < kRowGroup; ++q) {
      s[q] = A(0);
      if (j0 + q < k) {
        T br[E];
        load_seg<T>(basis + int64_t(j0 + q) * n, tile_base, n, vec_ok, br);
#pragma unroll
        for (int e = 0; e < E; ++e) s[q] = fma(A(br[e]), A(vr[e]), s[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kRowGroup; ++q) {
      const A w = lt::warp_sum(s[q]);
      if (lane == 0) red[g][warp][q] = w;
    }
    // red is double-buffered by group parity: the next group writes the
    // other buffer, and the one after it passes this barrier first.
    __syncthreads();
    if (threadIdx.x < kRowGroup && j0 + threadIdx.x < k) {
      A tot = A(0);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) tot += red[g][w][threadIdx.x];
      part[int64_t(j0 + threadIdx.x) * n_tiles + t] = tot;
    }
  }
}

template <typename A>
__global__ void __launch_bounds__(kThreads)
    cgs_reduce_kernel(const A* __restrict__ part, A* __restrict__ c, int64_t n_tiles) {
  __shared__ A red[kWarps];
  const int j = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  A s = A(0);
  for (int64_t t = threadIdx.x; t < n_tiles; t += kThreads) s += part[int64_t(j) * n_tiles + t];
  s = lt::warp_sum(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    A tot = A(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tot += red[w];
    c[j] = tot;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cgs_update_kernel(const T* __restrict__ basis, T* __restrict__ v,
                      const typename lt::Acc<T>::type* __restrict__ c, int64_t n, int k,
                      bool vec_ok) {
  using A = typename lt::Acc<T>::type;
  using V = typename lt::Vec<T>::type;
  constexpr int VN = lt::Vec<T>::n;
  constexpr int E = kUnroll * VN;
  __shared__ A cs[kCChunk];
  const int64_t tile_base = int64_t(blockIdx.x) * tile_width<T>();

  T vt[E];
  load_seg<T>(v, tile_base, n, vec_ok, vt);
  A acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = A(vt[e]);

  for (int j0 = 0; j0 < k; j0 += kCChunk) {
    const int nj = min(kCChunk, k - j0);
    __syncthreads();  // the previous chunk's readers are done with cs
    for (int j = threadIdx.x; j < nj; j += kThreads) cs[j] = c[j0 + j];
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < nj; ++j) {
      T br[E];
      load_seg<T>(basis + int64_t(j0 + j) * n, tile_base, n, vec_ok, br);
      const A cj = cs[j];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fma(-cj, A(br[e]), acc[e]);
    }
  }

#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t e0 = tile_base + (int64_t(u) * kThreads + threadIdx.x) * VN;
    if (vec_ok) {
      if (e0 < n) {
        V out;
        T* oo = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int q = 0; q < VN; ++q) oo[q] = T(acc[u * VN + q]);
        *reinterpret_cast<V*>(v + e0) = out;
      }
    } else {
#pragma unroll
      for (int q = 0; q < VN; ++q)
        if (e0 + q < n) v[e0 + q] = T(acc[u * VN + q]);
    }
  }
}

template <typename T>
cudaError_t cgs_pass(const T* basis, T* v, typename lt::Acc<T>::type* part,
                     typename lt::Acc<T>::type* c, int64_t n, int k, cudaStream_t stream) {
  constexpr int VN = lt::Vec<T>::n;
  if (n <= 0 || k < 0) return cudaErrorInvalidValue;
  if (k == 0) return cudaSuccess;
  const int64_t n_tiles = num_tiles<T>(n);
  const bool vec_ok = n % VN == 0 && lt::aligned16(basis) && lt::aligned16(v);
  cgs_project_kernel<T><<<unsigned(n_tiles), kThreads, 0, stream>>>(basis, v, part, n, k,
                                                                    n_tiles, vec_ok);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cgs_reduce_kernel<<<k, kThreads, 0, stream>>>(part, c, n_tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cgs_update_kernel<T><<<unsigned(n_tiles), kThreads, 0, stream>>>(basis, v, c, n, k, vec_ok);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of n-tiles one pass uses: the wrapper sizes the (k, n_tiles)
// partial-sum scratch with it.
long long lt_cgs_num_tiles_f32(long long n) { return num_tiles<float>(n); }
long long lt_cgs_num_tiles_f64(long long n) { return num_tiles<double>(n); }

// `device` is the CUDA ordinal the tensors and `stream` belong to (made
// current here: this library has its own runtime).
int lt_cgs_pass_f32(const float* basis, float* v, float* part, float* c, long long n, int k,
                    int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(cgs_pass<float>(basis, v, part, c, n, k, static_cast<cudaStream_t>(stream)));
}

int lt_cgs_pass_f64(const double* basis, double* v, double* part, double* c, long long n, int k,
                    int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(cgs_pass<double>(basis, v, part, c, n, k, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
