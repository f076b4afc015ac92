// K1 and K2: BSR sparse matvec y = A x over tiles in the "rmsk" (K1) and
// the canonical "rsmk" (K2) layouts.
//
// K1 replaces the Pallas TPU kernel lanczos_tpu/ops/pallas_spmv.py
// bsr_matvec_pallas_t (kernel _spmv_kernel_t): per row block, gather the S
// input segments x[col_blocks[r, s]] of width bk, then contract the
// contiguous (bm, S*bk) slab of tiles against them.
//
// K2 replaces _bsr_pallas_call (reached through bsr_matvec_pallas, kernel
// _spmv_kernel), the local SpMV of the row-partitioned operator
// (lanczos_tpu/parallel/sharded.py ShardedBSROperator._local_spmv).  Its
// tiles are (R, S, bm, bk): tile s of row block r is one contiguous (bm, bk)
// block, so row i of the block row is S runs of bk values, bm*bk apart.  The
// tiles are read where they lie (no transposed copy: a sharded operator
// exists for matrices too big to hold twice).  Its x is a table of rows of
// width bk that col_blocks index; the table need not be the whole vector (a
// footprint exchange passes just the received blocks), so its length n_x is
// an argument of its own.  The TPU kernel's per-tile dots, one grid step per
// row block, are not carried over: both layouts run the same CTA below and
// differ only in where element (i, s, k) of a block row lies.
//
// What bounds them on the H100: bytes.  Every stored tile element is read
// once (4 bytes per stored nonzero in f32) and used for one FMA, far below
// the card's FLOP:byte balance, so the kernel is only as fast as its tile
// stream.  The design serves that stream:
//   * one CTA per row block; its tiles are bm*S*bk values in one (K1) or S
//     (K2) contiguous runs;
//   * the S*bk needed x values are gathered once into shared memory (in
//     pieces of S when they do not fit), so the tile stream is the only
//     device-memory traffic that scales with nnz;
//   * each warp streams whole rows of the block row with 16-byte loads
//     marked evict-first (a tile is never reused), multiplies on CUDA cores
//     with FMAs and reduces with warp shuffles; no tensor cores, so no TF32;
//     lanes run over the flattened (s, k) of the row, so a narrow tile
//     (bk/4 < 32) still keeps every lane loading;
//   * x is read with a bound check (entries outside [0, n_x) read as zero;
//     the wrapper refuses col_blocks that index past the table) and y is
//     written only below n_out, so the caller passes unpadded vectors and no
//     pad/slice copies are made per call;
//   * no atomics: each output row is summed by one warp in a fixed order,
//     so results are the same from run to run.  For bm = bk = 128 in f32,
//     lane q of a row reads element (s, 4q..4q+3) in both layouts, so K1 and
//     K2 sum in the same order and give the same bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Budget for the gathered x piece; the row accumulators come on top.
constexpr size_t kXPieceBytes = 32 * 1024;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

template <typename T, bool RSMK>
__global__ void __launch_bounds__(kThreads)
    bsr_spmv_kernel(const T* __restrict__ blocks, const int* __restrict__ col_blocks,
                    const T* __restrict__ x, T* __restrict__ y, int bm, int S, int bk,
                    int64_t n_x, int64_t n_out, int s_piece, size_t acc_bytes, bool vec_ok) {
  using A = typename lt::Acc<T>::type;
  using V = typename lt::Vec<T>::type;
  constexpr int VN = lt::Vec<T>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  A* acc = reinterpret_cast<A*>(smem);
  T* xg = reinterpret_cast<T*>(smem + acc_bytes);

  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row_len = int64_t(S) * bk;
  const T* slab = blocks + int64_t(r) * bm * row_len;
  const int* cb = col_blocks + int64_t(r) * S;
  // Distance between the runs of one row: the next tile (K2) or none (K1,
  // where the row is one run).
  const int64_t tile_stride = RSMK ? int64_t(bm) * bk : int64_t(bk);
  const int vpt = bk / VN;  // 16-byte vectors per tile row (when vec_ok)

  for (int i = threadIdx.x; i < bm; i += kThreads) acc[i] = A(0);

  for (int s0 = 0; s0 < S; s0 += s_piece) {
    const int len = min(s_piece, S - s0) * bk;
    __syncthreads();  // the previous piece's readers are done with xg
    for (int e = threadIdx.x; e < len; e += kThreads) {
      const int s = e / bk;
      const int64_t col = int64_t(cb[s0 + s]) * bk + (e - s * bk);
      xg[e] = uint64_t(col) < uint64_t(n_x) ? x[col] : T(0);  // also refuses col < 0
    }
    __syncthreads();
    for (int i = warp; i < bm; i += kWarps) {
      // Element (s, k) of this row, s counted from s0, lies at
      // row[s * tile_stride + k].
      const T* row = RSMK ? slab + (int64_t(s0) * bm + i) * bk
                          : slab + int64_t(i) * row_len + int64_t(s0) * bk;
      A sum = A(0);
      if (vec_ok) {
        const V* rv = reinterpret_cast<const V*>(row);
        const V* xv = reinterpret_cast<const V*>(xg);
        const int nv = len / VN;
        const int64_t vstride = tile_stride / VN;
#pragma unroll 4
        for (int q = lane; q < nv; q += 32) {
          int64_t off = q;
          if (RSMK) {
            const int s = q / vpt;
            off = s * vstride + (q - s * vpt);
          }
          const V t = __ldcs(rv + off);
          const V u = xv[q];
          const T* tt = reinterpret_cast<const T*>(&t);
          const T* uu = reinterpret_cast<const T*>(&u);
#pragma unroll
          for (int c = 0; c < VN; ++c) sum = fma(A(tt[c]), A(uu[c]), sum);
        }
      } else {
        for (int e = lane; e < len; e += 32) {
          int64_t off = e;
          if (RSMK) {
            const int s = e / bk;
            off = s * tile_stride + (e - s * bk);
          }
          sum = fma(A(row[off]), A(xg[e]), sum);
        }
      }
      sum = lt::warp_sum(sum);
      if (lane == 0) acc[i] += sum;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bm; i += kThreads) {
    const int64_t gi = int64_t(r) * bm + i;
    if (gi < n_out) y[gi] = T(acc[i]);
  }
}

template <typename T, bool RSMK>
cudaError_t bsr_spmv(const T* blocks, const int* col_blocks, const T* x, T* y, int R, int bm,
                     int S, int bk, int64_t n_x, int64_t n_out, cudaStream_t stream) {
  using A = typename lt::Acc<T>::type;
  constexpr int VN = lt::Vec<T>::n;
  if (R <= 0 || bm <= 0 || S <= 0 || bk <= 0) return cudaErrorInvalidValue;
  const size_t acc_bytes = lt::round_up16(size_t(bm) * sizeof(A));
  int s_piece = int(kXPieceBytes / (size_t(bk) * sizeof(T)));
  s_piece = s_piece < 1 ? 1 : (s_piece > S ? S : s_piece);
  const size_t smem = acc_bytes + size_t(s_piece) * bk * sizeof(T);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(bsr_spmv_kernel<T, RSMK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  const bool vec_ok = bk % VN == 0 && lt::aligned16(blocks);
  bsr_spmv_kernel<T, RSMK><<<R, kThreads, smem, stream>>>(blocks, col_blocks, x, y, bm, S, bk,
                                                          n_x, n_out, s_piece, acc_bytes, vec_ok);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// `device` is the CUDA ordinal the tensors and `stream` belong to; this
// library has its own runtime, so it is made current here on every call.
int lt_bsr_spmv_f32(const float* blocks, const int* col_blocks, const float* x, float* y, int R,
                    int bm, int S, int bk, long long n_x, long long n_out, int device,
                    void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(bsr_spmv<float, false>(blocks, col_blocks, x, y, R, bm, S, bk, n_x, n_out,
                                    static_cast<cudaStream_t>(stream)));
}

int lt_bsr_spmv_f64(const double* blocks, const int* col_blocks, const double* x, double* y,
                    int R, int bm, int S, int bk, long long n_x, long long n_out, int device,
                    void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(bsr_spmv<double, false>(blocks, col_blocks, x, y, R, bm, S, bk, n_x, n_out,
                                     static_cast<cudaStream_t>(stream)));
}

// K2: the same for (R, S, bm, bk) tiles; x is a table of n_x / bk rows.
int lt_bsr_spmv_rsmk_f32(const float* blocks, const int* col_blocks, const float* x, float* y,
                         int R, int bm, int S, int bk, long long n_x, long long n_out, int device,
                         void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(bsr_spmv<float, true>(blocks, col_blocks, x, y, R, bm, S, bk, n_x, n_out,
                                   static_cast<cudaStream_t>(stream)));
}

int lt_bsr_spmv_rsmk_f64(const double* blocks, const int* col_blocks, const double* x,
                         double* y, int R, int bm, int S, int bk, long long n_x, long long n_out,
                         int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(bsr_spmv<double, true>(blocks, col_blocks, x, y, R, bm, S, bk, n_x, n_out,
                                    static_cast<cudaStream_t>(stream)));
}

const char* lt_error_string(int code) { return cudaGetErrorString(cudaError_t(code)); }

}  // extern "C"
