// E2c: the classical CGS pass whose coefficients are measured against a
// bf16 shadow of the basis, as one persistent cooperative kernel.
//
// Replaces the Pallas TPU kernel experiments/pallas_bcgs_kernel3.py
// make_pass (v3): one classical pass, every coefficient against the
// original v from the bf16 rows, then one update from the float32 rows.
// (E2a and E2b, the block-MGS pass and its one-chunk case, are
// bcgs_ring.cu.)  On the TPU the pass is one pallas_call whose phases are a
// sequential grid dimension.  On the H100 CTAs run in no order, so K3
// (csrc/cgs.cu) spends three launches on the dependency across the grid.
// Here the pass is ONE cooperative launch: the grid is persistent
// (kCtasPerSm CTAs per SM, never more than the column tiles), each CTA owns
// the column tiles t = blockIdx.x + i * gridDim.x of v for the whole pass,
// and
//   1. each CTA writes its partial coefficients of rows [0, k) over its
//      own tiles (one slot per row and CTA, in a fixed order);
//   2. one grid barrier (cooperative_groups::this_grid().sync());
//   3. every CTA sums each row's partials in the same fixed order (the
//      same bits in every CTA, no atomics) and updates its own tiles of v
//      in place.
// Rows >= k are never read.
//
// What bounds it on the H100: bytes.  A pass reads the k live rows once in
// bf16 and once in float32 (k n (2 + 4) bytes) and does 2 FMAs per float32
// value.  The design serves the stream as K3 does: 16-byte loads, eight
// rows at a time in the projection (each thread reads its 8 contiguous
// bf16 values with one load); the rows are read-only for the pass and go
// through the read-only path, while v and the partials, which the kernel
// rewrites, are read and written at L2 (__ldcg/__stcg), so no CTA sees a
// stale line.  The price of one launch is the redundant reduction: every
// CTA reads the k * gridDim.x partials (at (257, 2^22) about 0.41 MB per
// CTA, from L2).  Float32 accumulation; the grid and the order of every
// sum are fixed, so a pass gives the same bits on every run.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using T = float;
using P = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;     // 16-byte vectors of float per thread per row
constexpr int kVN = lt::Vec<T>::n;
constexpr int kE = kUnroll * kVN;  // float32 elements per thread per tile
constexpr int kRowGroup = 8;   // rows projected together
constexpr int kCChunk = 1024;  // coefficients staged in shared memory at a time
// CTAs per SM of the persistent grid.  The grid fixes which tiles each CTA
// sums, and so the order of every coefficient sum: this is the occupancy
// the kernel had as first built (79 registers), pinned so that a change of
// register allocation changes no bit.
constexpr int kCtasPerSm = 3;
constexpr int64_t kTileWidth = int64_t(kThreads) * kE;

int64_t num_tiles(int64_t n) { return (n + kTileWidth - 1) / kTileWidth; }

// Start of the thread's u-th 16-byte vector of float in the tile at
// `base`.  The strided layout (neighbouring threads on neighbouring
// vectors) is load_seg's; the contiguous one gives each thread 8
// neighbouring floats, which one 16-byte load of the bf16 shadow covers.
template <bool kContig>
__device__ __forceinline__ int64_t vec_start(int64_t base, int u) {
  return kContig ? base + (int64_t(threadIdx.x) * kUnroll + u) * kVN
                 : base + (int64_t(u) * kThreads + threadIdx.x) * kVN;
}

// v's elements of a tile, read at L2: v is rewritten by this kernel.
template <bool kContig>
__device__ __forceinline__ void load_v(const T* v, int64_t base, int64_t n, bool vec_ok, T (&out)[kE]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t e0 = vec_start<kContig>(base, u);
    if (vec_ok) {
      float4 t;
      if (e0 < n) {
        t = __ldcg(reinterpret_cast<const float4*>(v + e0));
      } else {
        t = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const T* tt = reinterpret_cast<const T*>(&t);
#pragma unroll
      for (int c = 0; c < kVN; ++c) out[u * kVN + c] = tt[c];
    } else {
#pragma unroll
      for (int c = 0; c < kVN; ++c) out[u * kVN + c] = e0 + c < n ? __ldcg(v + e0 + c) : T(0);
    }
  }
}

// The store matching load_v<false>.
__device__ __forceinline__ void store_v(T* v, int64_t base, int64_t n, bool vec_ok, const T (&vals)[kE]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t e0 = vec_start<false>(base, u);
    if (vec_ok) {
      if (e0 < n) {
        float4 out;
        T* oo = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int c = 0; c < kVN; ++c) oo[c] = vals[u * kVN + c];
        __stcg(reinterpret_cast<float4*>(v + e0), out);
      }
    } else {
#pragma unroll
      for (int c = 0; c < kVN; ++c)
        if (e0 + c < n) __stcg(v + e0 + c, vals[u * kVN + c]);
    }
  }
}

// One shadow row's 8 contiguous elements of a tile, as float32.
__device__ __forceinline__ void load_shadow_row(const P* __restrict__ row, int64_t base, int64_t n, bool vec_ok,
                                                T (&out)[kE]) {
  static_assert(kE == 8, "the bf16 shadow takes 8 float32 elements per thread");
  const int64_t e0 = vec_start<true>(base, 0);
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
      for (int e = 0; e < kE; ++e) out[e] = T(0);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kE; ++e) out[e] = e0 + e < n ? __bfloat162float(row[e0 + e]) : T(0);
  }
}

// `proj` holds the bf16 rows the coefficients are measured with, `basis`
// the float32 rows of the update.  `part` is k * gridDim.x accumulators.
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    cgs_shadow_kernel(const P* __restrict__ proj, const T* __restrict__ basis, T* v, T* part, int64_t n, int k,
                      int64_t n_tiles, bool vec_ok) {
  __shared__ T red[2][kWarps][kRowGroup];
  __shared__ T cs[kCChunk];
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
    const int64_t base = t * kTileWidth;
    T vr[kE];
    load_v<true>(v, base, n, vec_ok, vr);
    for (int j0 = 0; j0 < k; j0 += kRowGroup, g ^= 1) {
      T s[kRowGroup];
#pragma unroll
      for (int q = 0; q < kRowGroup; ++q) {
        s[q] = T(0);
        if (j0 + q < k) {
          T br[kE];
          load_shadow_row(proj + int64_t(j0 + q) * n, base, n, vec_ok, br);
#pragma unroll
          for (int e = 0; e < kE; ++e) s[q] = fma(br[e], vr[e], s[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < kRowGroup; ++q) {
        const T w = lt::warp_sum(s[q]);
        if (lane == 0) red[g][warp][q] = w;
      }
      __syncthreads();
      if (threadIdx.x < kRowGroup && j0 + threadIdx.x < k) {
        T tot = T(0);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) tot += red[g][w][threadIdx.x];
        // The same thread owns this row's slot over all of the CTA's tiles.
        T* slot = part + int64_t(j0 + threadIdx.x) * G + b;
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
      const T* p = part + int64_t(s0 + r) * G;
      T acc = T(0);
#pragma unroll 4
      for (int64_t q = lane; q < G; q += 32) acc += __ldcg(p + q);
      acc = lt::warp_sum(acc);
      if (lane == 0) cs[r] = acc;
    }
    __syncthreads();
    for (int64_t t = b; t < n_tiles; t += G) {
      const int64_t base = t * kTileWidth;
      T acc[kE];
      load_v<false>(v, base, n, vec_ok, acc);
#pragma unroll 4
      for (int j = 0; j < ns; ++j) {
        T br[kE];
        lt::load_seg<T, kThreads, kUnroll>(basis + int64_t(s0 + j) * n, base, n, vec_ok, br);
        const T cj = cs[j];
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[e] = fma(-cj, br[e], acc[e]);
      }
      store_v(v, base, n, vec_ok, acc);
    }
  }
}

// The persistent grid of a pass over n columns: kCtasPerSm CTAs per SM,
// which must be resident at once, at most one per column tile.
cudaError_t shadow_grid(int64_t n, int device, int* grid) {
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaSetDevice(device);  // the occupancy query reads the current device
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cgs_shadow_kernel, kThreads, 0);
  if (e != cudaSuccess) return e;
  if (per_sm < kCtasPerSm) return cudaErrorCooperativeLaunchTooLarge;
  const int64_t tiles = num_tiles(n);
  *grid = int(tiles < int64_t(kCtasPerSm) * sms ? tiles : int64_t(kCtasPerSm) * sms);
  return cudaSuccess;
}

cudaError_t shadow_pass(const P* proj, const T* basis, T* v, T* part, int64_t n, int k, int grid,
                        cudaStream_t stream) {
  int64_t n_tiles = num_tiles(n);
  if (n <= 0 || k < 0 || grid < 1 || grid > n_tiles) return cudaErrorInvalidValue;
  if (k == 0) return cudaSuccess;
  // Every row starts on 16 bytes when n is a multiple of 8 (one 16-byte
  // load of the shadow).
  bool vec_ok = n % 8 == 0 && lt::aligned16(proj) && lt::aligned16(basis) && lt::aligned16(v);
  void* args[] = {&proj, &basis, &v, &part, &n, &k, &n_tiles, &vec_ok};
  cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(cgs_shadow_kernel), dim3(unsigned(grid)),
                                              dim3(kThreads), args, 0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The grid a pass over n columns launches with (written to *grid): the
// wrapper sizes the partial-coefficient scratch with it.  Fails where the
// device has no cooperative launch.
int lt_cgsv_grid_shadow(long long n, int device, int* grid) { return int(shadow_grid(n, device, grid)); }

// E2c: v <- the classical pass of v against rows [0, k) of basis, in
// place, the coefficients from the bf16 shadow, the update from the float32
// basis.  `device` is the CUDA ordinal the tensors and `stream` belong to
// (made current here: this library has its own runtime).
int lt_cgsv_shadow_pass(const void* shadow, const float* basis, float* v, float* part, long long n, int k, int grid,
                        int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(shadow_pass(static_cast<const P*>(shadow), basis, v, part, n, k, grid, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
