// E1: the three BSR SpMV variants of the SpMV study, y = A x with G row
// blocks per CTA.
//
// Replaces the Pallas TPU kernels of experiments/pallas_spmv_bench.py:
//   * spmv_v2 with vpu=False (kernel _kernel_v2, MXU form): canonical
//     "rsmk" tiles (R, S, bm, bk); per row block, S products of a tile and
//     its x segment, each a jnp.dot, added into the row block's sum;
//   * spmv_v2 with vpu=True (the same kernel, VPU form): each product is an
//     elementwise tile * x multiply followed by a row sum;
//   * spmv_v3 (kernel _kernel_v3): pre-transposed "rmsk" tiles
//     (R, bm, S, bk); per row block the S x segments are gathered into an
//     (S, bk) scratch, then one (bm, S*bk) . (S*bk) dot.
// These were the prototypes of K2 and K1 (csrc/bsr_spmv.cu).  The TPU's
// sequential grid step of G row blocks becomes one CTA that owns G row
// blocks, so a launch has ceil(R / G) CTAs: the last one owns the R mod G
// tail (the Pallas grid, r // G steps, leaves that tail unwritten).
//
// What bounds them on the H100: bytes.  Every stored tile element is read
// once for one FMA, far below the card's FLOP:byte balance.  The variants
// keep what the TPU study varied, the work split and the reduction order:
//   * v2 (dot form): one warp per tile row; for each of the row's S tiles
//     the lanes read the tile row and its x segment from device memory
//     (the segment is reused by every row of the tile, so it comes from
//     L1), FMA in registers, and reduce the dot with warp shuffles; the dot
//     is added to the row's sum tile by tile, in the order of the tiles;
//   * v2 (VPU form): the same split, but each tile is multiplied
//     elementwise into a product tile in shared memory (every thread on
//     neighbouring elements), and then each row of products is summed by a
//     warp and added to the row's sum: a store and a reload of every
//     product, as the TPU's VPU product and cross-lane row reduction;
//   * v3: the S x segments of a row block are gathered into shared memory
//     once, then one warp per row takes the (S*bk)-long dot over the
//     row's contiguous run of tiles and reduces it once.
// All three multiply on CUDA cores with FMAs (no tensor cores, so no TF32),
// accumulate in float32 for float32 tiles and float64 for float64, and read
// tiles with 16-byte loads marked evict-first.  At the study's size
// (R = 512, G = 8) a launch has only 64 CTAs for the card's 132 SMs, so a
// CTA has 1024 threads to keep loads in flight on the SMs it has.  Entries
// of col_blocks outside the x table read zeros; no atomics, so each output
// is summed in one fixed order.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr size_t kProductBytes = 32 * 1024;  // the VPU form's product piece
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

// Whether column block c is a row of the x table (outside it x reads zero).
__device__ __forceinline__ bool in_table(int c, int64_t n_rows) {
  return uint64_t(int64_t(c)) < uint64_t(n_rows);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    spmv_v2_dot_kernel(const T* __restrict__ blocks, const int* __restrict__ col_blocks,
                       const T* __restrict__ x, T* __restrict__ y, int R, int S, int bm, int bk,
                       int G, int64_t x_rows, bool vec_ok) {
  using A = typename lt::Acc<T>::type;
  using V = typename lt::Vec<T>::type;
  constexpr int VN = lt::Vec<T>::n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * G;
  const int r1 = min(r0 + G, R);
  for (int r = r0; r < r1; ++r) {
    const int* cb = col_blocks + int64_t(r) * S;
    for (int i = warp; i < bm; i += kWarps) {
      A acc = A(0);
#pragma unroll 4
      for (int s = 0; s < S; ++s) {
        const int c = cb[s];
        A d = A(0);
        if (in_table(c, x_rows)) {
          const T* row = blocks + ((int64_t(r) * S + s) * bm + i) * bk;
          const T* xs = x + int64_t(c) * bk;
          if (vec_ok) {
            const V* rv = reinterpret_cast<const V*>(row);
            const V* xv = reinterpret_cast<const V*>(xs);
            for (int q = lane; q < bk / VN; q += 32) {
              const V t = __ldcs(rv + q);
              const V u = xv[q];
              const T* tt = reinterpret_cast<const T*>(&t);
              const T* uu = reinterpret_cast<const T*>(&u);
#pragma unroll
              for (int e = 0; e < VN; ++e) d = fma(A(tt[e]), A(uu[e]), d);
            }
          } else {
            for (int k = lane; k < bk; k += 32) d = fma(A(row[k]), A(xs[k]), d);
          }
        }
        acc += lt::warp_sum(d);  // the tile's dot, added in tile order
      }
      if (lane == 0) y[int64_t(r) * bm + i] = T(acc);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    spmv_v2_vpu_kernel(const T* __restrict__ blocks, const int* __restrict__ col_blocks,
                       const T* __restrict__ x, T* __restrict__ y, int R, int S, int bm, int bk,
                       int G, int64_t x_rows, int piece_rows, size_t acc_bytes, bool vec_ok) {
  using A = typename lt::Acc<T>::type;
  using V = typename lt::Vec<T>::type;
  constexpr int VN = lt::Vec<T>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  A* acc = reinterpret_cast<A*>(smem);
  A* prod = reinterpret_cast<A*>(smem + acc_bytes);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * G;
  const int r1 = min(r0 + G, R);
  for (int r = r0; r < r1; ++r) {
    __syncthreads();  // the previous row block's sums are written out
    for (int i = threadIdx.x; i < bm; i += kThreads) acc[i] = A(0);
    for (int s = 0; s < S; ++s) {
      const int c = col_blocks[int64_t(r) * S + s];
      if (!in_table(c, x_rows)) continue;  // the whole tile multiplies zeros
      const T* tile = blocks + (int64_t(r) * S + s) * bm * bk;
      const T* xs = x + int64_t(c) * bk;
      for (int i0 = 0; i0 < bm; i0 += piece_rows) {
        const int len = min(piece_rows, bm - i0) * bk;
        const T* src = tile + int64_t(i0) * bk;
        __syncthreads();  // the reducers are done with the previous piece
        // The elementwise products of the piece, neighbouring threads on
        // neighbouring elements.
        if (vec_ok) {
          for (int e = threadIdx.x * VN; e < len; e += kThreads * VN) {
            const V t = __ldcs(reinterpret_cast<const V*>(src + e));
            const V u = *reinterpret_cast<const V*>(xs + e % bk);
            const T* tt = reinterpret_cast<const T*>(&t);
            const T* uu = reinterpret_cast<const T*>(&u);
#pragma unroll
            for (int q = 0; q < VN; ++q) prod[e + q] = A(tt[q]) * A(uu[q]);
          }
        } else {
          for (int e = threadIdx.x; e < len; e += kThreads) prod[e] = A(src[e]) * A(xs[e % bk]);
        }
        __syncthreads();
        // The row sums of the piece, one warp per row.
        for (int i = warp; i < len / bk; i += kWarps) {
          A sum = A(0);
          for (int k = lane; k < bk; k += 32) sum += prod[i * bk + k];
          sum = lt::warp_sum(sum);
          if (lane == 0) acc[i0 + i] += sum;
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < bm; i += kThreads) y[int64_t(r) * bm + i] = T(acc[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    spmv_v3_kernel(const T* __restrict__ blocks, const int* __restrict__ col_blocks,
                   const T* __restrict__ x, T* __restrict__ y, int R, int S, int bm, int bk, int G,
                   int64_t x_rows, bool vec_ok) {
  using A = typename lt::Acc<T>::type;
  using V = typename lt::Vec<T>::type;
  constexpr int VN = lt::Vec<T>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xg = reinterpret_cast<T*>(smem);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int len = S * bk;
  const int r0 = blockIdx.x * G;
  const int r1 = min(r0 + G, R);
  for (int r = r0; r < r1; ++r) {
    const int* cb = col_blocks + int64_t(r) * S;
    __syncthreads();  // the previous row block's readers are done with xg
    for (int e = threadIdx.x; e < len; e += kThreads) {
      const int s = e / bk;
      const int c = cb[s];
      xg[e] = in_table(c, x_rows) ? x[int64_t(c) * bk + (e - s * bk)] : T(0);
    }
    __syncthreads();
    for (int i = warp; i < bm; i += kWarps) {
      const T* row = blocks + (int64_t(r) * bm + i) * len;
      A sum = A(0);
      if (vec_ok) {
        const V* rv = reinterpret_cast<const V*>(row);
        const V* xv = reinterpret_cast<const V*>(xg);
#pragma unroll 4
        for (int q = lane; q < len / VN; q += 32) {
          const V t = __ldcs(rv + q);
          const V u = xv[q];
          const T* tt = reinterpret_cast<const T*>(&t);
          const T* uu = reinterpret_cast<const T*>(&u);
#pragma unroll
          for (int e = 0; e < VN; ++e) sum = fma(A(tt[e]), A(uu[e]), sum);
        }
      } else {
        for (int e = lane; e < len; e += 32) sum = fma(A(row[e]), A(xg[e]), sum);
      }
      sum = lt::warp_sum(sum);
      if (lane == 0) y[int64_t(r) * bm + i] = T(sum);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  return cudaSuccess;
}

bool shape_ok(int R, int S, int bm, int bk, int G, int64_t n_x) {
  return R > 0 && S > 0 && bm > 0 && bk > 0 && G > 0 && n_x >= 0 && n_x % bk == 0;
}

template <typename T>
cudaError_t spmv_v2(const T* blocks, const int* col_blocks, const T* x, T* y, int R, int S, int bm,
                    int bk, int G, int64_t n_x, bool vpu, cudaStream_t stream) {
  using A = typename lt::Acc<T>::type;
  constexpr int VN = lt::Vec<T>::n;
  if (!shape_ok(R, S, bm, bk, G, n_x)) return cudaErrorInvalidValue;
  const bool vec_ok = bk % VN == 0 && lt::aligned16(blocks) && lt::aligned16(x);
  const unsigned grid = unsigned((int64_t(R) + G - 1) / G);
  const int64_t x_rows = n_x / bk;
  if (!vpu) {
    spmv_v2_dot_kernel<T><<<grid, kThreads, 0, stream>>>(blocks, col_blocks, x, y, R, S, bm, bk, G,
                                                         x_rows, vec_ok);
    return cudaGetLastError();
  }
  int piece_rows = int(kProductBytes / (size_t(bk) * sizeof(A)));
  piece_rows = piece_rows < 1 ? 1 : (piece_rows > bm ? bm : piece_rows);
  const size_t acc_bytes = lt::round_up16(size_t(bm) * sizeof(A));
  const size_t smem = acc_bytes + size_t(piece_rows) * bk * sizeof(A);
  cudaError_t e = allow_smem(spmv_v2_vpu_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  spmv_v2_vpu_kernel<T><<<grid, kThreads, smem, stream>>>(blocks, col_blocks, x, y, R, S, bm, bk, G,
                                                          x_rows, piece_rows, acc_bytes, vec_ok);
  return cudaGetLastError();
}

template <typename T>
cudaError_t spmv_v3(const T* blocks, const int* col_blocks, const T* x, T* y, int R, int S, int bm,
                    int bk, int G, int64_t n_x, cudaStream_t stream) {
  constexpr int VN = lt::Vec<T>::n;
  if (!shape_ok(R, S, bm, bk, G, n_x)) return cudaErrorInvalidValue;
  const bool vec_ok = (int64_t(S) * bk) % VN == 0 && lt::aligned16(blocks);
  const size_t smem = size_t(S) * bk * sizeof(T);
  cudaError_t e = allow_smem(spmv_v3_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const unsigned grid = unsigned((int64_t(R) + G - 1) / G);
  spmv_v3_kernel<T><<<grid, kThreads, smem, stream>>>(blocks, col_blocks, x, y, R, S, bm, bk, G,
                                                      n_x / bk, vec_ok);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// v2: (R, S, bm, bk) tiles; `vpu` selects the VPU form.  x is a table of
// n_x / bk rows of width bk that col_blocks index; y has R * bm entries.
// `device` is the CUDA ordinal the tensors and `stream` belong to (made
// current here: this library has its own runtime).
int lt_spmv_v2_f32(const float* blocks, const int* col_blocks, const float* x, float* y, int R,
                   int S, int bm, int bk, int G, long long n_x, int vpu, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(spmv_v2<float>(blocks, col_blocks, x, y, R, S, bm, bk, G, n_x, vpu != 0,
                            static_cast<cudaStream_t>(stream)));
}

int lt_spmv_v2_f64(const double* blocks, const int* col_blocks, const double* x, double* y, int R,
                   int S, int bm, int bk, int G, long long n_x, int vpu, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(spmv_v2<double>(blocks, col_blocks, x, y, R, S, bm, bk, G, n_x, vpu != 0,
                             static_cast<cudaStream_t>(stream)));
}

// v3: (R, bm, S, bk) tiles; the same x table and y.
int lt_spmv_v3_f32(const float* blocks, const int* col_blocks, const float* x, float* y, int R,
                   int S, int bm, int bk, int G, long long n_x, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(spmv_v3<float>(blocks, col_blocks, x, y, R, S, bm, bk, G, n_x,
                            static_cast<cudaStream_t>(stream)));
}

int lt_spmv_v3_f64(const double* blocks, const int* col_blocks, const double* x, double* y, int R,
                   int S, int bm, int bk, int G, long long n_x, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(spmv_v3<double>(blocks, col_blocks, x, y, R, S, bm, bk, G, n_x,
                             static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
