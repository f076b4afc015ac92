// E1: the three BSR SpMV variants of the SpMV study, y = A x.
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
// These were the prototypes of K2 and K1 (csrc/bsr_spmv.cu).
//
// What bounds them on the H100: bytes.  Every stored tile element is read
// once for one FMA (or one product and one add), far below the card's
// FLOP:byte balance.  The variants keep what the TPU study varied, the work
// split and the reduction order.
//
// v3 carries the TPU's sequential grid step of G row blocks over as one
// CTA of 1024 threads that owns G row blocks, so a launch has ceil(R / G)
// CTAs (the last one owns the R mod G tail, which the Pallas grid, r // G
// steps, leaves unwritten): the S x segments of a row block are gathered
// into shared memory once, then one warp per row takes the (S*bk)-long dot
// over the row's contiguous run of tiles and reduces it once.  At the
// study's size (R = 512, G = 8) it has only 64 CTAs for the card's 132 SMs.
//
// v2's two forms are one kernel designed for the card instead (launch plan
// in experiments/spmv_bench.py vpu_plan; G changes nothing, since the H100
// has no sequential grid step for it to size), with a compile-time choice
// of the product:
//   * the grid fills the card: CTA c of 256 threads covers kVpuWarps *
//     rows_per_warp tile rows of row block c / ctas_per_block (1024 CTAs of
//     64 rows at the study's size), warp w the rows_per_warp rows from
//     (c mod ctas_per_block) * kVpuWarps * rows_per_warp + w * rows_per_warp;
//   * the x segments of the row block are gathered into shared memory once
//     (in pieces of s_piece tiles where S * bk values do not fit), as K2
//     does, with a flag per tile whether its column block is in the table;
//   * a warp streams each of its tile rows with 16-byte evict-first loads,
//     lane l on the row's vectors l, l + 32, ... of each tile, kVpuBatch
//     loads in flight per lane, and keeps the products in registers; the
//     kernel is held to 64 registers a thread, so four CTAs (32 warps) fit
//     an SM;
//   * the dot form (the TPU's jnp.dot per tile) chains each lane's values
//     of a tile row through FMAs; the VPU form (an elementwise multiply,
//     then a row sum) rounds each product in the accumulator type on its
//     own: __fmul_rn / __dmul_rn, which nvcc never contracts into an FMA (a
//     plain `s += a * b` would be, and would turn the VPU form into the dot
//     form), then adds it.  Either way a lane takes its values of a tile in
//     order, a warp shuffle tree sums the tile row, and the tile row sums
//     are added into the row's total in tile order (the dot form's
//     arithmetic as it was when it had G row blocks per CTA, so its bits
//     are unchanged);
//   * no product tile in shared memory, no barrier inside the tile loop
//     (two per x piece), no atomics.
// All three multiply on CUDA cores (no tensor cores, so no TF32),
// accumulate in float32 for float32 tiles and float64 for float64, and read
// tiles with 16-byte loads marked evict-first where bk is a multiple of the
// vector width.  Entries of col_blocks outside the x table read zeros (v2
// skips such a tile's loads); each output is summed in one fixed order, so
// a launch gives the same bits on every run.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;  // v3's CTA
constexpr int kWarps = kThreads / 32;
constexpr int kVpuThreads = 256;  // v2's CTA (both forms)
constexpr int kVpuWarps = kVpuThreads / 32;
constexpr int kVpuBatch = 8;  // v2's loads in flight per lane
constexpr int kVpuCtasPerSm = 4;  // v2's occupancy floor: at most 64 registers
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

// Whether column block c is a row of the x table (outside it x reads zero).
__device__ __forceinline__ bool in_table(int c, int64_t n_rows) {
  return uint64_t(int64_t(c)) < uint64_t(n_rows);
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// One tile value times one x value, added into a lane's sum: one FMA (the
// dot form) or a separately rounded product, then the add (the VPU form).
template <bool kFma, typename A>
__device__ __forceinline__ A madd(A t, A x, A s) {
  if constexpr (kFma) {
    return fma(t, x, s);
  } else {
    return s + mul_rn(t, x);
  }
}

// v2's shared memory: [x segments: s_piece * bk T][in-table flag:
// s_piece int][the warps' row totals between x pieces: kVpuWarps *
// rows_per_warp A], each part from a 16-byte boundary.
template <typename T>
size_t vpu_smem_bytes(int rows_per_warp, int s_piece, int bk) {
  using A = typename lt::Acc<T>::type;
  return lt::round_up16(size_t(s_piece) * bk * sizeof(T)) + lt::round_up16(size_t(s_piece) * sizeof(int)) +
         size_t(kVpuWarps) * rows_per_warp * sizeof(A);
}

// kVec: 16-byte loads (bk a multiple of the vector width, aligned tiles),
// else one value per load.  kFma: the dot form, else the VPU form.
template <typename T, bool kVec, bool kFma>
__global__ void __launch_bounds__(kVpuThreads, kVpuCtasPerSm)
    spmv_v2_kernel(const T* __restrict__ blocks, const int* __restrict__ col_blocks, const T* __restrict__ x,
                   T* __restrict__ y, int S, int bm, int bk, int64_t x_rows, int rows_per_warp, int s_piece,
                   int ctas_per_block) {
  using A = typename lt::Acc<T>::type;
  using L = typename std::conditional<kVec, typename lt::Vec<T>::type, T>::type;
  constexpr int W = kVec ? lt::Vec<T>::n : 1;  // values per load
  extern __shared__ __align__(16) unsigned char smem[];
  T* xg = reinterpret_cast<T*>(smem);
  int* live = reinterpret_cast<int*>(smem + lt::round_up16(size_t(s_piece) * bk * sizeof(T)));
  A* totals =
      reinterpret_cast<A*>(reinterpret_cast<unsigned char*>(live) + lt::round_up16(size_t(s_piece) * sizeof(int)));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x / ctas_per_block;
  const int row0 = (blockIdx.x - r * ctas_per_block) * kVpuWarps * rows_per_warp + warp * rows_per_warp;
  const int nrows = max(0, min(rows_per_warp, bm - row0));
  const int nw = bk / W;          // loads per tile row
  const int nq = (nw + 31) / 32;  // a lane's loads per tile row
  const int64_t tile = int64_t(bm) * bk;
  const int* cb = col_blocks + int64_t(r) * S;
  for (int s0 = 0; s0 < S; s0 += s_piece) {
    const int ns = min(s_piece, S - s0);
    __syncthreads();  // the previous piece's readers are done with xg and live
    for (int e = threadIdx.x; e < ns * bk; e += kVpuThreads) {
      const int s = e / bk;
      const int c = cb[s0 + s];
      xg[e] = in_table(c, x_rows) ? x[int64_t(c) * bk + (e - s * bk)] : T(0);
    }
    for (int s = threadIdx.x; s < ns; s += kVpuThreads) live[s] = in_table(cb[s0 + s], x_rows);
    __syncthreads();
    // A lane's loads of a tile row, (tile s, load j) in tile-major order,
    // go kVpuBatch at a time: first all of a batch's loads, then their
    // products.
    const int slots = ns * nq;
    for (int i = 0; i < nrows; ++i) {
      const T* row = blocks + (int64_t(r) * S + s0) * tile + int64_t(row0 + i) * bk;
      A acc = s0 == 0 ? A(0) : totals[warp * rows_per_warp + i];
      A part = A(0);
      int s = 0, j = 0;  // the lane's next (tile, load)
      for (int u0 = 0; u0 < slots; u0 += kVpuBatch) {
        const int s_first = s, j_first = j;
        L t[kVpuBatch];
#pragma unroll
        for (int b = 0; b < kVpuBatch; ++b) {
          const int q = lane + 32 * j;
          if (u0 + b < slots && q < nw && live[s]) {
            t[b] = __ldcs(reinterpret_cast<const L*>(row + s * tile) + q);
          } else {
            T* tz = reinterpret_cast<T*>(&t[b]);
#pragma unroll
            for (int c = 0; c < W; ++c) tz[c] = T(0);
          }
          if (++j == nq) {
            j = 0;
            ++s;
          }
        }
        s = s_first;
        j = j_first;
#pragma unroll
        for (int b = 0; b < kVpuBatch; ++b) {
          if (u0 + b >= slots) break;  // warp-uniform
          const int q = lane + 32 * j;
          if (q < nw) {
            const L xv = reinterpret_cast<const L*>(xg + s * bk)[q];
            const T* tt = reinterpret_cast<const T*>(&t[b]);
            const T* xx = reinterpret_cast<const T*>(&xv);
#pragma unroll
            for (int c = 0; c < W; ++c) part = madd<kFma>(A(tt[c]), A(xx[c]), part);
          }
          if (++j == nq) {  // the tile row is in: its sum, added in tile order (lane 0's acc)
            j = 0;
            ++s;
            acc += lt::warp_sum(part);
            part = A(0);
          }
        }
      }
      if (lane == 0) {
        if (s0 + ns == S) {
          y[int64_t(r) * bm + row0 + i] = T(acc);
        } else {
          totals[warp * rows_per_warp + i] = acc;
        }
      }
    }
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

template <typename T, bool kVec, bool kFma>
cudaError_t launch_v2(const T* blocks, const int* col_blocks, const T* x, T* y, int S, int bm, int bk,
                      int64_t n_x, int ctas, int rows_per_warp, int s_piece, int per_block, size_t smem,
                      cudaStream_t stream) {
  cudaError_t e = allow_smem(spmv_v2_kernel<T, kVec, kFma>, smem);
  if (e != cudaSuccess) return e;
  spmv_v2_kernel<T, kVec, kFma><<<unsigned(ctas), kVpuThreads, smem, stream>>>(
      blocks, col_blocks, x, y, S, bm, bk, n_x / bk, rows_per_warp, s_piece, per_block);
  return cudaGetLastError();
}

// v2 (the VPU form where `vpu`, else the dot form) at the wrapper's plan
// (experiments/spmv_bench.py vpu_plan), checked against the kernel's own
// layout before the launch.
template <typename T>
cudaError_t spmv_v2(const T* blocks, const int* col_blocks, const T* x, T* y, int R, int S, int bm, int bk,
                    int64_t n_x, bool vpu, int ctas, int threads, int rows_per_warp, int s_piece, int64_t smem,
                    cudaStream_t stream) {
  constexpr int VN = lt::Vec<T>::n;
  if (!shape_ok(R, S, bm, bk, 1, n_x)) return cudaErrorInvalidValue;
  if (threads != kVpuThreads || rows_per_warp < 1 || s_piece < 1 || s_piece > S) return cudaErrorInvalidValue;
  const int64_t rows_per_cta = int64_t(kVpuWarps) * rows_per_warp;
  const int64_t per_block = (bm + rows_per_cta - 1) / rows_per_cta;
  if (int64_t(ctas) != int64_t(R) * per_block) return cudaErrorInvalidValue;
  if (smem < 0 || size_t(smem) != vpu_smem_bytes<T>(rows_per_warp, s_piece, bk)) return cudaErrorInvalidValue;
  // The dot form took one value per load for an x off a 16-byte boundary
  // when it read x from device memory; it still does, so its bits are kept.
  const bool vec = bk % VN == 0 && lt::aligned16(blocks) && (vpu || lt::aligned16(x));
  auto go = [&](auto launch) {
    return launch(blocks, col_blocks, x, y, S, bm, bk, n_x, ctas, rows_per_warp, s_piece, int(per_block),
                  size_t(smem), stream);
  };
  if (vpu) return vec ? go(launch_v2<T, true, false>) : go(launch_v2<T, false, false>);
  return vec ? go(launch_v2<T, true, true>) : go(launch_v2<T, false, true>);
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

// Registers, local (spill) bytes, shared memory and resident CTAs per SM of
// v2's kernel at `smem` bytes of dynamic shared memory.
template <typename T, bool kVec, bool kFma>
cudaError_t v2_info(size_t smem, int* out) {
  cudaError_t e = allow_smem(spmv_v2_kernel<T, kVec, kFma>, smem);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes a{};
  if ((e = cudaFuncGetAttributes(&a, spmv_v2_kernel<T, kVec, kFma>)) != cudaSuccess) return e;
  int occ = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, spmv_v2_kernel<T, kVec, kFma>, kVpuThreads, smem);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = int(a.localSizeBytes);
  out[2] = int(smem);
  out[3] = occ;
  return cudaSuccess;
}

template <typename T>
cudaError_t v2_info(bool vec, bool vpu, size_t smem, int* out) {
  if (vpu) return vec ? v2_info<T, true, false>(smem, out) : v2_info<T, false, false>(smem, out);
  return vec ? v2_info<T, true, true>(smem, out) : v2_info<T, false, true>(smem, out);
}

}  // namespace

extern "C" {

// v2: (R, S, bm, bk) tiles.  x is a table of n_x / bk rows of width bk
// that col_blocks index; y has R * bm entries.  `vpu` picks the VPU form,
// else the dot form, both at the plan (ctas, threads, rows_per_warp,
// s_piece, smem bytes) of experiments/spmv_bench.py vpu_plan; a plan that
// does not match the kernel's layout is refused.  `device` is the CUDA
// ordinal the tensors and `stream` belong to (made current here if it is
// not: this library has its own runtime).
int lt_spmv_v2_f32(const float* blocks, const int* col_blocks, const float* x, float* y, int R, int S, int bm,
                   int bk, long long n_x, int vpu, int ctas, int threads, int rows_per_warp, int s_piece,
                   long long smem, int device, void* stream) {
  cudaError_t e = lt::make_current(device);
  if (e != cudaSuccess) return int(e);
  return int(spmv_v2<float>(blocks, col_blocks, x, y, R, S, bm, bk, n_x, vpu != 0, ctas, threads, rows_per_warp,
                            s_piece, smem, static_cast<cudaStream_t>(stream)));
}

int lt_spmv_v2_f64(const double* blocks, const int* col_blocks, const double* x, double* y, int R, int S, int bm,
                   int bk, long long n_x, int vpu, int ctas, int threads, int rows_per_warp, int s_piece,
                   long long smem, int device, void* stream) {
  cudaError_t e = lt::make_current(device);
  if (e != cudaSuccess) return int(e);
  return int(spmv_v2<double>(blocks, col_blocks, x, y, R, S, bm, bk, n_x, vpu != 0, ctas, threads, rows_per_warp,
                             s_piece, smem, static_cast<cudaStream_t>(stream)));
}

// v2's registers, local (spill) bytes, shared memory and resident CTAs per
// SM (out[0..3]) at `smem` bytes of dynamic shared memory; f64 selects the
// double kernel, vec the one of 16-byte loads, vpu the VPU form.
int lt_spmv_v2_info(int f64, int vec, int vpu, long long smem, int device, int* out) {
  cudaError_t e = lt::make_current(device);
  if (e != cudaSuccess) return int(e);
  if (smem < 0) return int(cudaErrorInvalidValue);
  return int(f64 ? v2_info<double>(vec != 0, vpu != 0, size_t(smem), out)
                 : v2_info<float>(vec != 0, vpu != 0, size_t(smem), out));
}

// v3: (R, bm, S, bk) tiles; the same x table and y.
int lt_spmv_v3_f32(const float* blocks, const int* col_blocks, const float* x, float* y, int R,
                   int S, int bm, int bk, int G, long long n_x, int device, void* stream) {
  cudaError_t e = lt::make_current(device);
  if (e != cudaSuccess) return int(e);
  return int(spmv_v3<float>(blocks, col_blocks, x, y, R, S, bm, bk, G, n_x,
                            static_cast<cudaStream_t>(stream)));
}

int lt_spmv_v3_f64(const double* blocks, const int* col_blocks, const double* x, double* y, int R,
                   int S, int bm, int bk, int G, long long n_x, int device, void* stream) {
  cudaError_t e = lt::make_current(device);
  if (e != cudaSuccess) return int(e);
  return int(spmv_v3<double>(blocks, col_blocks, x, y, R, S, bm, bk, G, n_x,
                             static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
