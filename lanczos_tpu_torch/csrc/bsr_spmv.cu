// K1: BSR sparse matvec y = A x over tiles in the "rmsk" layout.
//
// Replaces the Pallas TPU kernel lanczos_tpu/ops/pallas_spmv.py
// bsr_matvec_pallas_t (kernel _spmv_kernel_t): per row block, gather the S
// input segments x[col_blocks[r, s]] of width bk, then contract the
// contiguous (bm, S*bk) slab of tiles against them.
//
// What bounds it on the H100: bytes.  Every stored tile element is read once
// (4 bytes per stored nonzero in f32) and used for one FMA, far below the
// card's FLOP:byte balance, so the kernel is only as fast as its tile
// stream.  The design serves that stream:
//   * one CTA per row block; its slab is one contiguous run of bm*S*bk
//     values, so the stream has no gaps;
//   * the S*bk needed x values are gathered once into shared memory (in
//     pieces of S when they do not fit), so the tile stream is the only
//     device-memory traffic that scales with nnz;
//   * each warp streams whole rows of the slab with 16-byte loads marked
//     evict-first (a tile is never reused), multiplies on CUDA cores with
//     FMAs and reduces with warp shuffles; no tensor cores, so no TF32;
//   * x is read with a bound check (entries at or past n_x read as zero)
//     and y is written only below n_out, so the caller passes the unpadded
//     vectors and no pad/slice copies are made per call;
//   * no atomics: each output row is summed by one warp in a fixed order,
//     so results are the same from run to run.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Budget for the gathered x piece; the row accumulators come on top.
constexpr size_t kXPieceBytes = 32 * 1024;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

template <typename T>
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

  for (int i = threadIdx.x; i < bm; i += kThreads) acc[i] = A(0);

  for (int s0 = 0; s0 < S; s0 += s_piece) {
    const int len = min(s_piece, S - s0) * bk;
    __syncthreads();  // the previous piece's readers are done with xg
    for (int e = threadIdx.x; e < len; e += kThreads) {
      const int s = e / bk;
      const int64_t col = int64_t(cb[s0 + s]) * bk + (e - s * bk);
      xg[e] = col < n_x ? x[col] : T(0);
    }
    __syncthreads();
    for (int i = warp; i < bm; i += kWarps) {
      const T* row = slab + int64_t(i) * row_len + int64_t(s0) * bk;
      A sum = A(0);
      if (vec_ok) {
        const V* rv = reinterpret_cast<const V*>(row);
        const V* xv = reinterpret_cast<const V*>(xg);
        const int nv = len / VN;
#pragma unroll 4
        for (int q = lane; q < nv; q += 32) {
          const V t = __ldcs(rv + q);
          const V u = xv[q];
          const T* tt = reinterpret_cast<const T*>(&t);
          const T* uu = reinterpret_cast<const T*>(&u);
#pragma unroll
          for (int c = 0; c < VN; ++c) sum = fma(A(tt[c]), A(uu[c]), sum);
        }
      } else {
        for (int e = lane; e < len; e += 32) sum = fma(A(row[e]), A(xg[e]), sum);
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

template <typename T>
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
    cudaError_t e = cudaFuncSetAttribute(bsr_spmv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  const bool vec_ok = bk % VN == 0 && lt::aligned16(blocks);
  bsr_spmv_kernel<T><<<R, kThreads, smem, stream>>>(blocks, col_blocks, x, y, bm, S, bk, n_x,
                                                    n_out, s_piece, acc_bytes, vec_ok);
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
  return int(bsr_spmv<float>(blocks, col_blocks, x, y, R, bm, S, bk, n_x, n_out,
                             static_cast<cudaStream_t>(stream)));
}

int lt_bsr_spmv_f64(const double* blocks, const int* col_blocks, const double* x, double* y,
                    int R, int bm, int S, int bk, long long n_x, long long n_out, int device,
                    void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(bsr_spmv<double>(blocks, col_blocks, x, y, R, bm, S, bk, n_x, n_out,
                              static_cast<cudaStream_t>(stream)));
}

const char* lt_error_string(int code) { return cudaGetErrorString(cudaError_t(code)); }

}  // extern "C"
