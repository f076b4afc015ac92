// K3: one classical Gram-Schmidt pass, v <- v - B[:k]^T (B[:k] v).
//
// Replaces the Pallas TPU kernel lanczos_tpu/ops/pallas_cgs.py cgs_pass
// (kernel _kernel): phase 0 collects the k coefficients against the
// unmodified v over n-tiles, phase 1 applies the update.  On the TPU the
// phase boundary is a sequential grid dimension; on the H100 CTAs run in no
// order, so the dependency across the whole grid becomes three launches on
// one stream:
//   1. cgs_project_kernel: part[j, t] = B[j, tile t] . v[tile t] for j < k;
//   2. lt::reduce_rows_kernel: c[j] = sum_t part[j, t], in a fixed order;
//   3. cgs_update_kernel:  v[tile] -= sum_j c[j] B[j, tile], in place.
//
// What bounds it on the H100: bytes.  The pass sweeps the k live rows of the
// basis twice (2 k n values) and does 2 FMAs per value read, so the card's
// memory stream is the limit.  Every coefficient has to be complete before
// the first update, and the live rows do not fit on the chip (537 MB at
// (2^20, k = 128) against 50 MB of L2), so both sweeps stay.  What the
// design can remove is the bytes the chip still holds at the phase
// boundary:
//   * the projection's CTAs walk the rows backwards, k-1 -> 0, a wave of
//     resident CTAs at a time, so rows 0, 1, ... of the last wave's tiles
//     are what L2 holds when it ends.  It reads rows 0 .. keep-1 normally
//     and the rows above them evict-first (ld.global.cs), so those are the
//     lines L2 keeps; `keep` is as many rows of one wave's tiles as fit
//     60% of L2 (ops/cgs.py l2_keep_rows: 7 at n = 2^20 and 2^22 on the
//     H100, where the sweep recorded in PERF.md is best);
//   * the update walks the rows forwards, 0 -> k-1, and the tiles from the
//     last to the first, so its first wave starts on what the projection
//     left in L2, and reads every row evict-first, since no row is read
//     again (its misses then do not push out the kept lines that its later
//     waves still need);
//   * each row's partial dot products and the update's FMA chain are the
//     same operations in the same order whatever order the rows are
//     visited in, so the visiting order changes no bit of the result;
//   * one cooperative launch that also kept each CTA's share of the first
//     rows in shared memory across a grid barrier was measured slower
//     (PERF.md): the many short-lived CTAs stream faster;
//   * each CTA owns one n-tile and keeps its slice of v in registers for
//     the whole sweep, so v is read once per launch and the basis rows are
//     the only traffic that scales with k;
//   * rows are streamed with 16-byte loads, eight rows at a time in the
//     projection so each thread has 16 independent loads in flight;
//   * only the live rows [0, k) are read, so the traffic follows k and not
//     the buffer's capacity (the Pallas kernel's dynamic chunk count);
//   * no atomics: partial sums are reduced in a fixed order by a second
//     launch, and the update's order is fixed, so the result is the same
//     from run to run.
//
// Over rows split across ranks each rank's coefficients are partial sums:
// the caller runs launches 1-2 (phases = 1), sums c over the ranks in the
// scratch (an all-reduce) and then launch 3 (phases = 2) on the summed c.
// phases = 3 is the whole pass.
//
// Complex bases (complex64, complex128) run the same three launches over
// lt::cfloat / lt::cdouble: the coefficients conjugate the basis, c_j =
// sum_n conj(B_jn) v_n (lt::fma_conj), the update is v -= sum_j c_j B_j
// (cx::fma), each a fixed sequence of four real FMAs per value, so the
// visiting orders above still change no bit and a run repeats bit for
// bit.  A tile is the same 8 KB: 1024 complex64 or 512 complex128 values.
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cgs_project_kernel(const T* __restrict__ basis, const T* __restrict__ v,
                       typename lt::Acc<T>::type* __restrict__ part, int64_t n, int k, int keep,
                       int64_t n_tiles, bool vec_ok) {
  using A = typename lt::Acc<T>::type;
  constexpr int E = kUnroll * lt::Vec<T>::n;
  __shared__ A red[2][kWarps][kRowGroup];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = blockIdx.x;
  const int64_t tile_base = t * tile_width<T>();

  T vr[E];
  lt::load_seg<T, kThreads, kUnroll>(v, tile_base, n, vec_ok, vr);

  // Row groups [j0, j0 + kRowGroup) from the top down; rows below keep
  // stay in L2 for the update.
  for (int j0 = (k - 1) / kRowGroup * kRowGroup, g = 0; j0 >= 0; j0 -= kRowGroup, g ^= 1) {
    A s[kRowGroup];
#pragma unroll
    for (int q = 0; q < kRowGroup; ++q) {
      s[q] = A(0);
      if (j0 + q < k) {
        T br[E];
        lt::load_seg<T, kThreads, kUnroll>(basis + int64_t(j0 + q) * n, tile_base, n, vec_ok, br,
                                           j0 + q >= keep);
#pragma unroll
        for (int e = 0; e < E; ++e) s[q] = lt::fma_conj(A(br[e]), A(vr[e]), s[q]);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cgs_update_kernel(const T* __restrict__ basis, T* __restrict__ v,
                      const typename lt::Acc<T>::type* __restrict__ c, int64_t n, int k,
                      bool vec_ok) {
  using A = typename lt::Acc<T>::type;
  constexpr int E = kUnroll * lt::Vec<T>::n;
  __shared__ A cs[kCChunk];
  const int64_t tile_base = int64_t(gridDim.x - 1 - blockIdx.x) * tile_width<T>();  // last tile first

  T vt[E];
  lt::load_seg<T, kThreads, kUnroll>(v, tile_base, n, vec_ok, vt);
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
      lt::load_seg<T, kThreads, kUnroll>(basis + int64_t(j0 + j) * n, tile_base, n, vec_ok, br, true);
      const A cj = cs[j];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fma(-cj, A(br[e]), acc[e]);
    }
  }

  lt::store_seg<T, kThreads, kUnroll>(v, tile_base, n, vec_ok, acc);
}

// `scratch` holds scratch_len accumulator values: the (k, n_tiles) partial
// sums, then the k coefficients.  `phases`: 1 the projection and the
// reduction into the coefficients, 2 the update from them, 3 both.
template <typename T>
cudaError_t cgs_pass(const T* basis, T* v, typename lt::Acc<T>::type* scratch, int64_t scratch_len, int64_t n,
                     int k, int keep, int phases, cudaStream_t stream) {
  using A = typename lt::Acc<T>::type;
  constexpr int VN = lt::Vec<T>::n;
  if (n <= 0 || k < 0 || keep < 0 || phases < 1 || phases > 3) return cudaErrorInvalidValue;
  if (k == 0) return cudaSuccess;
  const int64_t n_tiles = num_tiles<T>(n);
  if (n_tiles > INT32_MAX || scratch_len < int64_t(k) * (n_tiles + 1)) return cudaErrorInvalidValue;
  A* part = scratch;
  A* c = scratch + int64_t(k) * n_tiles;
  const bool vec_ok = n % VN == 0 && lt::aligned16(basis) && lt::aligned16(v);
  if (phases & 1) {
    cgs_project_kernel<T><<<unsigned(n_tiles), kThreads, 0, stream>>>(basis, v, part, n, k, keep, n_tiles, vec_ok);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    lt::reduce_rows_kernel<A, kThreads><<<k, kThreads, 0, stream>>>(part, c, n_tiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (phases & 2) {
    cgs_update_kernel<T><<<unsigned(n_tiles), kThreads, 0, stream>>>(basis, v, c, n, k, vec_ok);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// One pass.  `scratch` holds `scratch_len` values of the basis's type, at
// least k * (ceil(n / tile) + 1) with a tile of 8 KB: 2048 float32, 1024
// float64 or complex64, 512 complex128 values (ops/cgs.py TILE_BYTES); a
// shorter one is refused.  `keep`
// is the number of first rows the projection leaves in L2 for the update.
// `phases` (1, 2 or 3) selects the launches, as cgs_pass above: the
// coefficients are scratch[k * ceil(n / tile) :][: k] between them.
// `device` is the CUDA ordinal the tensors and `stream` belong to (made
// current here if it is not: this library has its own runtime).
int lt_cgs_pass_f32(const float* basis, float* v, float* scratch, long long scratch_len, long long n, int k,
                    int keep, int phases, int device, void* stream) {
  cudaError_t e = lt::make_current(device);
  if (e != cudaSuccess) return int(e);
  return int(cgs_pass<float>(basis, v, scratch, scratch_len, n, k, keep, phases, static_cast<cudaStream_t>(stream)));
}

int lt_cgs_pass_f64(const double* basis, double* v, double* scratch, long long scratch_len, long long n, int k,
                    int keep, int phases, int device, void* stream) {
  cudaError_t e = lt::make_current(device);
  if (e != cudaSuccess) return int(e);
  return int(
      cgs_pass<double>(basis, v, scratch, scratch_len, n, k, keep, phases, static_cast<cudaStream_t>(stream)));
}

// The complex instances: conjugated coefficients, complex scratch.
int lt_cgs_pass_c64(const lt::cfloat* basis, lt::cfloat* v, lt::cfloat* scratch, long long scratch_len, long long n,
                    int k, int keep, int phases, int device, void* stream) {
  cudaError_t e = lt::make_current(device);
  if (e != cudaSuccess) return int(e);
  return int(
      cgs_pass<lt::cfloat>(basis, v, scratch, scratch_len, n, k, keep, phases, static_cast<cudaStream_t>(stream)));
}

int lt_cgs_pass_c128(const lt::cdouble* basis, lt::cdouble* v, lt::cdouble* scratch, long long scratch_len,
                     long long n, int k, int keep, int phases, int device, void* stream) {
  cudaError_t e = lt::make_current(device);
  if (e != cudaSuccess) return int(e);
  return int(
      cgs_pass<lt::cdouble>(basis, v, scratch, scratch_len, n, k, keep, phases, static_cast<cudaStream_t>(stream)));
}

// Resident CTAs per SM of the projection kernel for the basis type `code`
// (0 float, 1 double, 2 complex64, 3 complex128): the wrapper sizes the
// projection's wave of tiles with it (ops/cgs.py l2_keep_rows).
int lt_cgs_project_occupancy(int code, int device, int* out) {
  cudaError_t e = lt::make_current(device);
  if (e != cudaSuccess) return int(e);
  switch (code) {
    case 0: return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, cgs_project_kernel<float>, kThreads, 0));
    case 1: return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, cgs_project_kernel<double>, kThreads, 0));
    case 2: return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, cgs_project_kernel<lt::cfloat>, kThreads, 0));
    case 3: return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, cgs_project_kernel<lt::cdouble>, kThreads, 0));
    default: return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
