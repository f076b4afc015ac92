// E2b-c: the single-drain CGS-pass variants of the experiment studies, as
// one persistent cooperative kernel.
//
// Replaces the Pallas TPU kernels of the CGS variant study:
//   E2b experiments/pallas_bcgs_kernel2.py make_pass (v2): one classical pass,
//       every coefficient against the original v, then one update;
//   E2c experiments/pallas_bcgs_kernel3.py make_pass (v3): E2b whose
//       projection reads a bf16 shadow of the basis, the update the f32 rows.
// (E2a, the block-MGS pass of pallas_bcgs_kernel.py, is bcgs_ring.cu.)
// On the TPU each is one pallas_call whose phases are a sequential grid
// dimension.  On the H100 CTAs run in no order, so K3 (csrc/cgs.cu) spends
// three launches on the dependency across the grid.  Here the pass is ONE
// cooperative launch: the grid is persistent (ctas_per_sm() CTAs per SM,
// never more than the column tiles), each CTA owns the
// column tiles t = blockIdx.x + i * gridDim.x of v for the whole pass, and
//   1. each CTA writes its partial coefficients of rows [0, k) over its
//      own tiles (one slot per row and CTA, in a fixed order);
//   2. one grid barrier (cooperative_groups::this_grid().sync());
//   3. every CTA sums each row's partials in the same fixed order (the
//      same bits in every CTA, no atomics) and updates its own tiles of v
//      in place.
// Rows >= k are never read.
//
// What bounds it on the H100: bytes.  A pass reads the k live rows twice
// (2 k n values; E2c reads the projection's copy in bf16, k n (2 + 4)
// bytes) and does 2 FMAs per value read.  The design serves the stream as
// K3 does: 16-byte loads, eight rows at a time in the projection; the rows
// are read-only for the pass and go through the read-only path, while v and
// the partials, which the kernel rewrites, are read and written at L2
// (__ldcg/__stcg), so no CTA sees a stale line.  The price of one launch is
// the redundant reduction: every CTA reads the k * gridDim.x partials (at
// (257, 2^22) and three CTAs per SM about 0.41 MB per CTA, from L2).
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;     // 16-byte vectors of T per thread per row
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

// Start of the thread's u-th 16-byte vector of T in the tile at `base`.
// The strided layout (neighbouring threads on neighbouring vectors) is
// load_seg's; the contiguous one gives each thread 8 neighbouring floats,
// which one 16-byte load of the bf16 shadow covers.
template <typename T, bool kContig>
__device__ __forceinline__ int64_t vec_start(int64_t base, int u) {
  constexpr int VN = lt::Vec<T>::n;
  return kContig ? base + (int64_t(threadIdx.x) * kUnroll + u) * VN
                 : base + (int64_t(u) * kThreads + threadIdx.x) * VN;
}

// v's elements of a tile, read at L2: v is rewritten by this kernel.
template <typename T, bool kContig>
__device__ __forceinline__ void load_v(const T* v, int64_t base, int64_t n, bool vec_ok,
                                       T (&out)[kUnroll * lt::Vec<T>::n]) {
  using V = typename lt::Vec<T>::type;
  constexpr int VN = lt::Vec<T>::n;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t e0 = vec_start<T, kContig>(base, u);
    if (vec_ok) {
      V t;
      if (e0 < n) {
        t = __ldcg(reinterpret_cast<const V*>(v + e0));
      } else {
        T* tt = reinterpret_cast<T*>(&t);
#pragma unroll
        for (int c = 0; c < VN; ++c) tt[c] = T(0);
      }
      const T* tt = reinterpret_cast<const T*>(&t);
#pragma unroll
      for (int c = 0; c < VN; ++c) out[u * VN + c] = tt[c];
    } else {
#pragma unroll
      for (int c = 0; c < VN; ++c) out[u * VN + c] = e0 + c < n ? __ldcg(v + e0 + c) : T(0);
    }
  }
}

// The store matching load_v<T, false>.
template <typename T, typename A>
__device__ __forceinline__ void store_v(T* v, int64_t base, int64_t n, bool vec_ok,
                                        const A (&vals)[kUnroll * lt::Vec<T>::n]) {
  using V = typename lt::Vec<T>::type;
  constexpr int VN = lt::Vec<T>::n;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t e0 = vec_start<T, false>(base, u);
    if (vec_ok) {
      if (e0 < n) {
        V out;
        T* oo = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int c = 0; c < VN; ++c) oo[c] = T(vals[u * VN + c]);
        __stcg(reinterpret_cast<V*>(v + e0), out);
      }
    } else {
#pragma unroll
      for (int c = 0; c < VN; ++c)
        if (e0 + c < n) __stcg(v + e0 + c, T(vals[u * VN + c]));
    }
  }
}

// One projection row's elements of a tile as the accumulator type.  For
// P == T they lie as load_seg lays them; for the bf16 shadow each thread
// reads its 8 contiguous values with one 16-byte load.
template <typename T, typename P, typename A>
__device__ __forceinline__ void load_proj_row(const P* __restrict__ row, int64_t base, int64_t n,
                                              bool vec_ok, A (&out)[kUnroll * lt::Vec<T>::n]) {
  constexpr int E = kUnroll * lt::Vec<T>::n;
  if constexpr (std::is_same<P, T>::value) {
    T r[E];
    lt::load_seg<T, kThreads, kUnroll>(row, base, n, vec_ok, r);
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = A(r[e]);
  } else {
    static_assert(E == 8, "the bf16 shadow takes 8 float32 elements per thread");
    const int64_t e0 = vec_start<T, true>(base, 0);
    if (vec_ok) {
      if (e0 < n) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row + e0));
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(h[i]);
          out[2 * i] = f.x;
          out[2 * i + 1] = f.y;
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) out[e] = A(0);
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) out[e] = e0 + e < n ? __bfloat162float(row[e0 + e]) : A(0);
    }
  }
}

// CTAs per SM of the persistent grid.  The grid fixes which tiles each CTA
// sums, and so the order of every coefficient sum: these are the
// occupancies the kernels had as first built (float32 and the bf16 shadow
// at 79 registers, float64 at 86), pinned so that a change of register
// allocation changes no bit of E2b or E2c.
template <typename T, typename P>
constexpr int ctas_per_sm() {
  return std::is_same<T, double>::value ? 2 : 3;
}

// `proj` holds the rows the coefficients are measured with (the basis
// itself, or its bf16 shadow), `basis` the rows of the update.  `part` is
// k * gridDim.x accumulators.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads, ctas_per_sm<T, P>())
    cgs_variant_kernel(const P* __restrict__ proj, const T* __restrict__ basis, T* v,
                       typename lt::Acc<T>::type* part, int64_t n, int k, int64_t n_tiles, bool vec_ok) {
  using A = typename lt::Acc<T>::type;
  constexpr bool kShadow = !std::is_same<P, T>::value;
  constexpr int E = kUnroll * lt::Vec<T>::n;
  __shared__ A red[2][kWarps][kRowGroup];
  __shared__ A cs[kCChunk];
  cg::grid_group grid = cg::this_grid();
  const int64_t G = gridDim.x;
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // red is double-buffered by the parity of a row group, so a group never
  // overwrites the buffer that the previous group's reducing threads may
  // still be reading.
  int g = 0;

  // 1. this CTA's partial coefficients of rows [0, k) over its tiles.
  for (int64_t t = b; t < n_tiles; t += G) {
    const int64_t base = t * tile_width<T>();
    T vr[E];
    load_v<T, kShadow>(v, base, n, vec_ok, vr);
    for (int j0 = 0; j0 < k; j0 += kRowGroup, g ^= 1) {
      A s[kRowGroup];
#pragma unroll
      for (int q = 0; q < kRowGroup; ++q) {
        s[q] = A(0);
        if (j0 + q < k) {
          A br[E];
          load_proj_row<T, P, A>(proj + int64_t(j0 + q) * n, base, n, vec_ok, br);
#pragma unroll
          for (int e = 0; e < E; ++e) s[q] = fma(br[e], A(vr[e]), s[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < kRowGroup; ++q) {
        const A w = lt::warp_sum(s[q]);
        if (lane == 0) red[g][warp][q] = w;
      }
      __syncthreads();
      if (threadIdx.x < kRowGroup && j0 + threadIdx.x < k) {
        A tot = A(0);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) tot += red[g][w][threadIdx.x];
        // The same thread owns this row's slot over all of the CTA's tiles.
        A* slot = part + int64_t(j0 + threadIdx.x) * G + b;
        __stcg(slot, t == b ? tot : __ldcg(slot) + tot);
      }
    }
  }

  grid.sync();

  // 3. the coefficients, kCChunk at a time, and the update of this CTA's
  //    tiles.
  for (int s0 = 0; s0 < k; s0 += kCChunk) {
    const int ns = min(kCChunk, k - s0);
    __syncthreads();  // the previous stage's readers are done with cs
    for (int r = warp; r < ns; r += kWarps) {
      const A* p = part + int64_t(s0 + r) * G;
      A acc = A(0);
#pragma unroll 4
      for (int64_t q = lane; q < G; q += 32) acc += __ldcg(p + q);
      acc = lt::warp_sum(acc);
      if (lane == 0) cs[r] = acc;
    }
    __syncthreads();
    for (int64_t t = b; t < n_tiles; t += G) {
      const int64_t base = t * tile_width<T>();
      T vt[E];
      load_v<T, false>(v, base, n, vec_ok, vt);
      A acc[E];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = A(vt[e]);
#pragma unroll 4
      for (int j = 0; j < ns; ++j) {
        T br[E];
        lt::load_seg<T, kThreads, kUnroll>(basis + int64_t(s0 + j) * n, base, n, vec_ok, br);
        const A cj = cs[j];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = fma(-cj, A(br[e]), acc[e]);
      }
      store_v<T, A>(v, base, n, vec_ok, acc);
    }
  }
}

// The divisor of n under which every row starts on 16 bytes: the elements
// of one 16-byte vector of T, or 8 with the bf16 shadow.
template <typename T, typename P>
constexpr int vec_elems() {
  return std::is_same<P, T>::value ? lt::Vec<T>::n : 8;
}

// The persistent grid of a pass over n columns: ctas_per_sm() CTAs per SM,
// which must be resident at once, at most one per column tile.
template <typename T, typename P>
cudaError_t variant_grid(int64_t n, int device, int* grid) {
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaSetDevice(device);  // the occupancy query reads the current device
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cgs_variant_kernel<T, P>, kThreads, 0);
  if (e != cudaSuccess) return e;
  if (per_sm < ctas_per_sm<T, P>()) return cudaErrorCooperativeLaunchTooLarge;
  per_sm = ctas_per_sm<T, P>();
  const int64_t tiles = num_tiles<T>(n);
  *grid = int(tiles < int64_t(per_sm) * sms ? tiles : int64_t(per_sm) * sms);
  return cudaSuccess;
}

template <typename T, typename P>
cudaError_t variant_pass(const P* proj, const T* basis, T* v, typename lt::Acc<T>::type* part, int64_t n, int k,
                         int grid, cudaStream_t stream) {
  constexpr int VN = vec_elems<T, P>();
  int64_t n_tiles = num_tiles<T>(n);
  if (n <= 0 || k < 0 || grid < 1 || grid > n_tiles) return cudaErrorInvalidValue;
  if (k == 0) return cudaSuccess;
  bool vec_ok = n % VN == 0 && lt::aligned16(proj) && lt::aligned16(basis) && lt::aligned16(v);
  void* args[] = {&proj, &basis, &v, &part, &n, &k, &n_tiles, &vec_ok};
  cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(cgs_variant_kernel<T, P>),
                                              dim3(unsigned(grid)), dim3(kThreads), args, 0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The grid a pass over n columns launches with (written to *grid): the
// wrapper sizes the partial-coefficient scratch with it.  Fails where the
// device has no cooperative launch.
int lt_cgsv_grid_f32(long long n, int device, int* grid) {
  return int(variant_grid<float, float>(n, device, grid));
}
int lt_cgsv_grid_f64(long long n, int device, int* grid) {
  return int(variant_grid<double, double>(n, device, grid));
}
int lt_cgsv_grid_shadow(long long n, int device, int* grid) {
  return int(variant_grid<float, __nv_bfloat16>(n, device, grid));
}

// E2b: v <- the classical pass of v against rows [0, k) of basis, in
// place.  `device` is the CUDA ordinal the tensors and `stream` belong to
// (made current here: this library has its own runtime).
int lt_cgsv_pass_f32(const float* basis, float* v, float* part, long long n, int k, int grid, int device,
                     void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(variant_pass<float, float>(basis, basis, v, part, n, k, grid, static_cast<cudaStream_t>(stream)));
}
int lt_cgsv_pass_f64(const double* basis, double* v, double* part, long long n, int k, int grid, int device,
                     void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(variant_pass<double, double>(basis, basis, v, part, n, k, grid, static_cast<cudaStream_t>(stream)));
}

// E2c: the coefficients from the bf16 shadow, the update from the float32
// basis.
int lt_cgsv_shadow_pass(const void* shadow, const float* basis, float* v, float* part, long long n, int k,
                        int grid, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(variant_pass<float, __nv_bfloat16>(static_cast<const __nv_bfloat16*>(shadow), basis, v, part, n, k,
                                                grid, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
