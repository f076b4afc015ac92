// K4: one classical Gram-Schmidt pass of a (b, n) block V against rows
// [0, k) of a (cap, n) basis B:
//   C = B[:k] V^T   (k x b),   V <- V - C^T B[:k].
//
// Replaces the Pallas TPU kernel lanczos_tpu/ops/pallas_cgs.py
// cgs_pass_block (kernel _kernel_block): phase 0 collects the k*b
// coefficients against the unmodified block over n-tiles, phase 1 applies
// the update.  On the TPU the phase boundary is a sequential grid dimension
// and C lives in a VMEM scratch; on the H100 CTAs run in no order, so, as
// for K3 (cgs.cu), the dependency across the grid becomes three launches on
// one stream:
//   1. block_project_kernel: part[j*b + q, t] = B[j, tile t] . V[q, tile t];
//   2. lt::reduce_rows_kernel: C[j, q] = sum_t part[j*b + q, t], in a fixed
//      order (no atomics: the same result on every run);
//   3. block_update_kernel: V[q, tile] -= sum_j C[j, q] B[j, tile], in place.
//
// What bounds it on the H100: bytes.  A pass reads the k live basis rows
// twice (2 k n values) and the block twice (2 b n); it does 2 b FMAs per
// basis value, about b/2 flop per byte, far below the card's f32/f64 FMA
// rate for b <= 16.  The design serves the basis stream:
//   * every launch reads each basis tile ONCE for all b vectors — the
//     reason the kernel exists (b K3 passes read the basis b times);
//   * each CTA owns one n-tile and keeps its slice of the whole block in
//     registers for the whole sweep, so V is read once per launch;
//   * rows are streamed with 16-byte loads; only the live rows [0, k) are
//     read, so the traffic follows k and not the buffer's capacity;
//   * the block width is a template bucket (1, 2, 4, 8, 16) so the
//     per-vector registers are fixed at compile time; a width inside a
//     bucket masks the spare vectors (no loads, zero coefficients).
// Plain FMAs in the storage precision (f32 or f64), no tensor cores, no
// TF32.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 16;

// Launch shape of a block-width bucket of at most BMAX vectors.
template <typename T, int BMAX>
struct Shape {
  using A = typename lt::Acc<T>::type;
  // 16-byte vectors per thread per row: narrow blocks take two to keep
  // loads in flight, wide ones one to bound the registers holding the block.
  static constexpr int U = BMAX <= 4 ? 2 : 1;
  static constexpr int E = U * lt::Vec<T>::n;          // elements per thread per row
  static constexpr int64_t W = int64_t(kThreads) * E;  // tile width
  static constexpr int RG = BMAX >= 16 ? 1 : (BMAX >= 8 ? 2 : 4);  // rows projected together
  static constexpr int CCHUNK = 16384 / int(BMAX * sizeof(A));      // coefficient rows per smem stage
};

template <typename T, int BMAX>
__global__ void __launch_bounds__(kThreads)
    block_project_kernel(const T* __restrict__ basis, const T* __restrict__ v,
                         typename lt::Acc<T>::type* __restrict__ part, int64_t n, int k, int b,
                         int64_t n_tiles, bool vec_ok) {
  using S = Shape<T, BMAX>;
  using A = typename S::A;
  constexpr int E = S::E;
  constexpr int RG = S::RG;
  __shared__ A red[2][kWarps][RG * BMAX];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = blockIdx.x;
  const int64_t base = t * S::W;

  T vr[BMAX][E];
#pragma unroll
  for (int q = 0; q < BMAX; ++q) {
    if (q < b) {
      lt::load_seg<T, kThreads, S::U>(v + int64_t(q) * n, base, n, vec_ok, vr[q]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) vr[q][e] = T(0);
    }
  }

  for (int j0 = 0, g = 0; j0 < k; j0 += RG, g ^= 1) {
    A s[RG][BMAX];
#pragma unroll
    for (int r = 0; r < RG; ++r) {
#pragma unroll
      for (int q = 0; q < BMAX; ++q) s[r][q] = A(0);
      if (j0 + r < k) {
        T br[E];
        lt::load_seg<T, kThreads, S::U>(basis + int64_t(j0 + r) * n, base, n, vec_ok, br);
#pragma unroll
        for (int q = 0; q < BMAX; ++q) {
#pragma unroll
          for (int e = 0; e < E; ++e) s[r][q] = fma(A(br[e]), A(vr[q][e]), s[r][q]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RG; ++r) {
#pragma unroll
      for (int q = 0; q < BMAX; ++q) {
        if (q < b) {  // uniform across the CTA: every lane takes the shuffle
          const A w = lt::warp_sum(s[r][q]);
          if (lane == 0) red[g][warp][r * BMAX + q] = w;
        }
      }
    }
    // red is double-buffered by group parity: the next group writes the
    // other buffer, and the one after it passes this barrier first.
    __syncthreads();
    if (threadIdx.x < RG * BMAX) {
      const int r = threadIdx.x / BMAX;
      const int q = threadIdx.x % BMAX;
      if (q < b && j0 + r < k) {
        A tot = A(0);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) tot += red[g][w][threadIdx.x];
        part[(int64_t(j0 + r) * b + q) * n_tiles + t] = tot;
      }
    }
  }
}

template <typename T, int BMAX>
__global__ void __launch_bounds__(kThreads)
    block_update_kernel(const T* __restrict__ basis, T* __restrict__ v,
                        const typename lt::Acc<T>::type* __restrict__ c, int64_t n, int k, int b,
                        bool vec_ok) {
  using S = Shape<T, BMAX>;
  using A = typename S::A;
  constexpr int E = S::E;
  constexpr int CCH = S::CCHUNK;
  __shared__ A cs[CCH * BMAX];
  const int64_t base = int64_t(blockIdx.x) * S::W;

  A acc[BMAX][E];
#pragma unroll
  for (int q = 0; q < BMAX; ++q) {
    T vt[E];
    if (q < b) {
      lt::load_seg<T, kThreads, S::U>(v + int64_t(q) * n, base, n, vec_ok, vt);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) vt[e] = T(0);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) acc[q][e] = A(vt[e]);
  }

  for (int j0 = 0; j0 < k; j0 += CCH) {
    const int nj = min(CCH, k - j0);
    __syncthreads();  // the previous stage's readers are done with cs
    for (int i = threadIdx.x; i < nj * BMAX; i += kThreads) {
      const int jj = i / BMAX;
      const int q = i % BMAX;
      cs[i] = q < b ? c[int64_t(j0 + jj) * b + q] : A(0);
    }
    __syncthreads();
#pragma unroll 2
    for (int jj = 0; jj < nj; ++jj) {
      T br[E];
      lt::load_seg<T, kThreads, S::U>(basis + int64_t(j0 + jj) * n, base, n, vec_ok, br);
#pragma unroll
      for (int q = 0; q < BMAX; ++q) {
        const A cq = cs[jj * BMAX + q];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[q][e] = fma(-cq, A(br[e]), acc[q][e]);
      }
    }
  }

#pragma unroll
  for (int q = 0; q < BMAX; ++q) {
    if (q < b) lt::store_seg<T, kThreads, S::U>(v + int64_t(q) * n, base, n, vec_ok, acc[q]);
  }
}

template <typename T, int BMAX>
cudaError_t launch(const T* basis, T* v, typename lt::Acc<T>::type* part,
                   typename lt::Acc<T>::type* c, int64_t n, int k, int b, cudaStream_t stream) {
  using S = Shape<T, BMAX>;
  const int64_t n_tiles = (n + S::W - 1) / S::W;
  // Row q of the block starts at q*n: 16-byte aligned for every q only
  // when n is a multiple of the vector width.
  const bool vec_ok = n % lt::Vec<T>::n == 0 && lt::aligned16(basis) && lt::aligned16(v);
  block_project_kernel<T, BMAX><<<unsigned(n_tiles), kThreads, 0, stream>>>(basis, v, part, n, k,
                                                                           b, n_tiles, vec_ok);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  lt::reduce_rows_kernel<typename S::A, kThreads><<<unsigned(k * b), kThreads, 0, stream>>>(
      part, c, n_tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  block_update_kernel<T, BMAX><<<unsigned(n_tiles), kThreads, 0, stream>>>(basis, v, c, n, k, b,
                                                                          vec_ok);
  return cudaGetLastError();
}

// Tile width of the bucket that serves block width b (0 for b out of range).
template <typename T>
int64_t tile_width(int b) {
  if (b < 1 || b > kMaxB) return 0;
  if (b <= 1) return Shape<T, 1>::W;
  if (b <= 2) return Shape<T, 2>::W;
  if (b <= 4) return Shape<T, 4>::W;
  if (b <= 8) return Shape<T, 8>::W;
  return Shape<T, 16>::W;
}

template <typename T>
cudaError_t cgs_pass_block(const T* basis, T* v, typename lt::Acc<T>::type* part,
                           typename lt::Acc<T>::type* c, int64_t n, int k, int b,
                           cudaStream_t stream) {
  if (n <= 0 || k < 0 || b < 1 || b > kMaxB) return cudaErrorInvalidValue;
  if (k == 0) return cudaSuccess;
  if (b <= 1) return launch<T, 1>(basis, v, part, c, n, k, b, stream);
  if (b <= 2) return launch<T, 2>(basis, v, part, c, n, k, b, stream);
  if (b <= 4) return launch<T, 4>(basis, v, part, c, n, k, b, stream);
  if (b <= 8) return launch<T, 8>(basis, v, part, c, n, k, b, stream);
  return launch<T, 16>(basis, v, part, c, n, k, b, stream);
}

}  // namespace

extern "C" {

// Number of n-tiles one pass of a width-b block uses (0 for b outside
// [1, 16]): the wrapper sizes the (k*b, n_tiles) partial-sum scratch with it.
long long lt_cgs_block_num_tiles_f32(long long n, int b) {
  const int64_t w = tile_width<float>(b);
  return w ? (n + w - 1) / w : 0;
}
long long lt_cgs_block_num_tiles_f64(long long n, int b) {
  const int64_t w = tile_width<double>(b);
  return w ? (n + w - 1) / w : 0;
}

// `device` is the CUDA ordinal the tensors and `stream` belong to (made
// current here: this library has its own runtime).
int lt_cgs_block_pass_f32(const float* basis, float* v, float* part, float* c, long long n, int k,
                          int b, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(cgs_pass_block<float>(basis, v, part, c, n, k, b, static_cast<cudaStream_t>(stream)));
}

int lt_cgs_block_pass_f64(const double* basis, double* v, double* part, double* c, long long n,
                          int k, int b, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(cgs_pass_block<double>(basis, v, part, c, n, k, b, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
