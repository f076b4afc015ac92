// K1 and K2: BSR sparse matvec y = A x over tiles in the "rmsk" (K1) and
// the canonical "rsmk" (K2) layouts; K1x: the same two forms with float32
// tiles against a float64 x (float64 y and accumulation).
//
// K1x is the precise paths' product (the JAX package's BSROperator.matvec_df,
// lanczos_tpu/ops/operators.py, XLA ops there): an f32 entry is exact in f64,
// so A x in float64 is the f32 tiles streamed once, each value converted
// exactly and multiplied into a DFMA accumulator.  The tile stream, 4 bytes
// a stored value, still bounds it; x's gathered pieces double in bytes
// (bk * 8 a tile column), so a piece holds half the tiles it does in f32.
//
// The bfloat16 instances serve the JAX package's BSROperator(dtype=
// bfloat16), whose docstring (lanczos_tpu/ops/operators.py:364-368) offers
// half the tile stream at float32 accumulation; its matvec there is the
// einsum path, the tiles promoted against a float32 x.  bfloat16 is a
// storage type only: no engine builds a bfloat16 vector, so the tiles meet
// a float32 x, y and accumulator (K1, K2) or a float64 one (K1x, the
// precise tier's product).  A 16-byte tile vector holds 8 values; each is
// widened exactly (bfloat16 -> float is a shift) and multiplied on the CUDA
// cores with FMAs, as for float32 tiles.  No tensor cores: a bfloat16 mma
// would round x to bfloat16, a different function from the JAX einsum's.
// A lane reads 8 values where it reads 4 of float32 tiles, so K1 bfloat16
// sums in another order than K1 float32 over the widened tiles; K1 and K2
// bfloat16 still cover the same flattened (s, k) per lane at bm = bk = 128
// and give the same bits.  The bytes bound them as they bound the float32
// instances: 2 bytes a stored value halve the tile stream.
//
// K1x over bfloat16 tiles (and its rsmk form) has a body of its own,
// bsr_spmv_bf16x64_kernel below.  In the shared template a 16-byte tile
// vector of 8 values needs 64 bytes of float64 x, read from shared memory
// for every row as four 16-byte loads with lanes 64 bytes apart: sixteen
// lanes of a warp meet in one bank group, 16 wavefronts a load, 64 for
// 512 bytes of tiles.  At the main path's 402 M stored values that is
// ~100 M wavefronts, ~0.4 ms at one a clock on 132 SMs: shared memory, not
// the 0.245 ms tile stream, bound it.  The new body gives each lane fixed
// (s, k) positions for a whole chunk of the row, loads their x values into
// registers once (from a swizzled piece, so each quarter-warp's loads hit
// eight distinct 16-byte bank groups) and then streams every row it owns
// with no shared-memory read in the inner loop; lanes per row and vectors
// per lane are planned so that every lane works (16 lanes of 3 vectors, two
// rows a warp step, at the main path's 384 values a row).
//
// The complex instances (complex64 and complex128 tiles against a vector of
// their own type, and K1x's complex64 tiles against a complex128 vector)
// are the same body over lt::cfloat / lt::cdouble: a stored value is one
// 8- or 16-byte word pair, a product four real FMAs in a fixed order
// (common.cuh cx::fma), so a 16-byte tile vector holds two complex64 or one
// complex128 value.  The JAX package serves complex tiles through its
// einsum path (no Pallas kernel); a complex Hermitian solve on the TPU runs
// K1 over the real 2n embedding's parts instead.  K2 has the same three
// complex instances in its rsmk form, for complex row-partitioned operators.
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
// The bfloat16 x float64 body keeps these rules (one CTA per row block,
// pieces of x in shared memory, evict-first 16-byte tile loads, DFMAs on
// the CUDA cores, a fixed order with no atomics) and differs in who reads
// what: a row belongs to a group of lpr lanes (a power of two), lane l of
// the group holds the x of vectors q = c0 + j*lpr + l, j < VPL, of chunk c0
// in registers, and the group's rows follow one another under that x, two
// at a time so that 2*VPL tile loads a lane are in flight.  Both layouts
// map q to the same flattened (s, k), so K1x and K1x-rsmk over bfloat16
// tiles give the same bits at any shape the body takes (bk % 8 == 0 and
// 16-byte aligned tiles; the shared template's scalar loop takes the rest).
#include <climits>
#include <tuple>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Budget for the gathered x piece; the row accumulators come on top.
constexpr size_t kXPieceBytes = 32 * 1024;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

// T is the tile type, X the type of x, y and the accumulator: X = T for
// K1 and K2, float (complex64) tiles against double (complex128) vectors
// for K1x (each tile value converted exactly, every product and sum a DFMA
// on the CUDA cores), and bfloat16 tiles against float (K1, K2) or double
// (K1x) vectors, each tile value widened exactly by lt::arith.
template <typename T, typename X, bool RSMK>
__global__ void __launch_bounds__(kThreads)
    bsr_spmv_kernel(const T* __restrict__ blocks, const int* __restrict__ col_blocks,
                    const X* __restrict__ x, X* __restrict__ y, int bm, int S, int bk,
                    int64_t n_x, int64_t n_out, int s_piece, size_t acc_bytes, bool vec_ok) {
  using A = typename lt::Acc<X>::type;
  using V = typename lt::Vec<T>::type;
  constexpr int VN = lt::Vec<T>::n;
  // x's values for one 16-byte tile vector: one 16-byte load when X = T,
  // two for double against float.
  using XV = typename lt::Vec<X>::type;
  constexpr int XN = lt::Vec<X>::n;
  static_assert(VN % XN == 0, "a tile vector must cover whole x vectors");
  extern __shared__ __align__(16) unsigned char smem[];
  A* acc = reinterpret_cast<A*>(smem);
  X* xg = reinterpret_cast<X*>(smem + acc_bytes);

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
      xg[e] = uint64_t(col) < uint64_t(n_x) ? x[col] : X(0);  // also refuses col < 0
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
        const XV* xv = reinterpret_cast<const XV*>(xg);
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
          XV u[VN / XN];
#pragma unroll
          for (int h = 0; h < VN / XN; ++h) u[h] = xv[q * (VN / XN) + h];
          const T* tt = reinterpret_cast<const T*>(&t);
          const X* uu = reinterpret_cast<const X*>(u);
#pragma unroll
          for (int c = 0; c < VN; ++c) sum = fma(A(lt::arith(tt[c])), A(uu[c]), sum);
        }
      } else {
        for (int e = lane; e < len; e += 32) {
          int64_t off = e;
          if (RSMK) {
            const int s = e / bk;
            off = s * tile_stride + (e - s * bk);
          }
          sum = fma(A(lt::arith(row[off])), A(xg[e]), sum);
        }
      }
      sum = lt::warp_sum(sum);
      if (lane == 0) acc[i] += sum;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bm; i += kThreads) {
    const int64_t gi = int64_t(r) * bm + i;
    if (gi < n_out) y[gi] = X(acc[i]);
  }
}

// The launch plan: x pieces of s_piece tiles (the largest that fits
// kXPieceBytes, at least one), shared memory for the row accumulators and
// one piece, and whether that passes the default 48 KB (the kernel opts in
// to more).  The kernel has no static shared memory.
struct Plan {
  int s_piece;
  size_t acc_bytes, smem;
};

inline Plan plan(int bm, int S, int bk, size_t x_bytes) {
  Plan p;
  p.acc_bytes = lt::round_up16(size_t(bm) * x_bytes);
  int s_piece = int(kXPieceBytes / (size_t(bk) * x_bytes));
  p.s_piece = s_piece < 1 ? 1 : (s_piece > S ? S : s_piece);
  p.smem = p.acc_bytes + size_t(p.s_piece) * bk * x_bytes;
  return p;
}

// ---- K1x over bfloat16 tiles: x in registers across the block row ----------

// Vectors of x a lane holds in registers at most (8 float64 values each).
constexpr int kMaxVpl = 4;

// Where element e of a gathered piece lies in shared memory: the four
// 16-byte chunks of each 64-byte vector q are permuted by q's bits 1-2, so
// that the eight lanes of a quarter-warp reading chunk h of vectors q0 ..
// q0+7 (q0 a multiple of 8) hit eight distinct 16-byte bank groups.
__device__ __forceinline__ int x_swizzle(int e) {
  const int c = e >> 1;
  return ((c ^ ((c >> 3) & 3)) << 1) | (e & 1);
}

// Element c (0..7) of a 16-byte vector of bfloat16 values, widened exactly
// to float64 (bfloat16 -> float is a shift, float -> double is exact).
__device__ __forceinline__ double bf16_at(const uint4& t, int c) {
  const unsigned w = c < 2 ? t.x : c < 4 ? t.y : c < 6 ? t.z : t.w;
  return double(__uint_as_float((c & 1) ? (w & 0xffff0000u) : (w << 16)));
}

// One CTA per row block, kThreads threads in groups of lpr = 1 << lpr_log2
// lanes; group g owns rows g, g + G, g + 2G, ... (G = kThreads / lpr).  Per
// piece of s_piece tiles the x segments are gathered into xg (swizzled),
// then per chunk of lpr*VPL 16-byte tile vectors each lane loads the x of
// its VPL vectors into registers and streams its group's rows two at a
// time: VPL evict-first loads a row, 8 DFMAs a vector in order j, then c,
// the group's partial sums reduced by an xor butterfly and added to the
// row's accumulator by the group's first lane.  Needs bk % 8 == 0 and
// 16-byte aligned tiles.
template <int VPL, bool RSMK>
__global__ void __launch_bounds__(kThreads, 2)
    bsr_spmv_bf16x64_kernel(const __nv_bfloat16* __restrict__ blocks, const int* __restrict__ col_blocks,
                            const double* __restrict__ x, double* __restrict__ y, int bm, int S, int bk,
                            int64_t n_x, int64_t n_out, int s_piece, size_t acc_bytes, int lpr_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* acc = reinterpret_cast<double*>(smem);
  double* xg = reinterpret_cast<double*>(smem + acc_bytes);
  const double2* xg2 = reinterpret_cast<const double2*>(xg);

  const int r = blockIdx.x;
  const int lpr = 1 << lpr_log2;
  const int l = threadIdx.x & (lpr - 1);
  const int g = threadIdx.x >> lpr_log2;
  const int groups = kThreads >> lpr_log2;
  const int steps = (bm + groups - 1) / groups;  // the same for every group: shuffles stay warp-wide
  const int64_t row_len = int64_t(S) * bk;
  const uint4* slab = reinterpret_cast<const uint4*>(blocks + int64_t(r) * bm * row_len);
  const int* cb = col_blocks + int64_t(r) * S;
  const int vpt = bk / 8;  // 16-byte vectors per tile row
  // Vectors between tile s and s + 1 of one row: none apart (rmsk, one run)
  // or a whole (bm, bk) tile (rsmk).
  const int64_t vstride = RSMK ? int64_t(bm) * vpt : int64_t(vpt);
  const int cw = lpr * VPL;

  for (int i = threadIdx.x; i < bm; i += kThreads) acc[i] = 0.0;

  for (int s0 = 0; s0 < S; s0 += s_piece) {
    const int len = min(s_piece, S - s0) * bk;
    __syncthreads();  // the previous piece's readers are done with xg
    for (int e = threadIdx.x; e < len; e += kThreads) {
      const int s = e / bk;
      const int64_t col = int64_t(cb[s0 + s]) * bk + (e - s * bk);
      xg[x_swizzle(e)] = uint64_t(col) < uint64_t(n_x) ? x[col] : 0.0;  // also refuses col < 0
    }
    __syncthreads();
    // Vector 0 of this piece in row i: row i's run from tile s0 on (rmsk),
    // or row i of tile s0 (rsmk).
    const int64_t piece0 = RSMK ? int64_t(s0) * bm * vpt : int64_t(s0) * vpt;
    const int64_t row_step = RSMK ? int64_t(vpt) : row_len / 8;
    const int nv = len / 8;
    for (int c0 = 0; c0 < nv; c0 += cw) {
      double xr[VPL][8];
      int64_t off[VPL];
      bool ok[VPL];
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int q = c0 + j * lpr + l;
        ok[j] = q < nv;
        const int s = q / vpt;
        off[j] = ok[j] ? piece0 + s * vstride + (q - s * vpt) : 0;
        const int sw = (q >> 1) & 3;
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const double2 u = ok[j] ? xg2[4 * q + (h ^ sw)] : make_double2(0.0, 0.0);
          xr[j][2 * h] = u.x;
          xr[j][2 * h + 1] = u.y;
        }
      }
      for (int k = 0; k < steps; k += 2) {
        const int ia = k * groups + g, ib = ia + groups;
        const bool va = ia < bm, vb = ib < bm;
        const uint4* ra = slab + int64_t(ia) * row_step;
        const uint4* rb = slab + int64_t(ib) * row_step;
        uint4 ta[VPL], tb[VPL];
#pragma unroll
        for (int j = 0; j < VPL; ++j) ta[j] = va && ok[j] ? __ldcs(ra + off[j]) : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int j = 0; j < VPL; ++j) tb[j] = vb && ok[j] ? __ldcs(rb + off[j]) : make_uint4(0, 0, 0, 0);
        double sa = 0.0, sb = 0.0;
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
#pragma unroll
          for (int c = 0; c < 8; ++c) sa = fma(bf16_at(ta[j], c), xr[j][c], sa);
        }
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
#pragma unroll
          for (int c = 0; c < 8; ++c) sb = fma(bf16_at(tb[j], c), xr[j][c], sb);
        }
        for (int o = lpr >> 1; o > 0; o >>= 1) {
          sa += __shfl_xor_sync(0xffffffffu, sa, o);
          sb += __shfl_xor_sync(0xffffffffu, sb, o);
        }
        if (l == 0) {
          if (va) acc[ia] += sa;
          if (vb) acc[ib] += sb;
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bm; i += kThreads) {
    const int64_t gi = int64_t(r) * bm + i;
    if (gi < n_out) y[gi] = acc[i];
  }
}

// The bfloat16 x float64 plan: lanes per row (a power of two, 1..32) and
// 16-byte vectors per lane (1..kMaxVpl) for rows of nv vectors (a full
// piece) in row blocks of bm rows.  It minimises the vector slots a lane
// walks (steps x chunks x VPL, steps = ceil(bm / groups)), then the chunks
// (each reloads x and reduces every row), then VPL (registers), and takes
// the most lanes a row on a tie.
struct XPlan {
  int lpr_log2, vpl;
};

inline XPlan x_plan(int bm, int nv) {
  XPlan best{5, 1};
  std::tuple<long long, long long, int> best_key{LLONG_MAX, 0, 0};
  for (int lg = 5; lg >= 0; --lg) {
    const long long groups = kThreads >> lg, steps = (bm + groups - 1) / groups;
    for (int vpl = 1; vpl <= kMaxVpl; ++vpl) {
      const long long chunks = (nv + (vpl << lg) - 1) / (vpl << lg);
      const std::tuple<long long, long long, int> key{steps * chunks * vpl, chunks, vpl};
      if (key < best_key) {
        best_key = key;
        best = XPlan{lg, vpl};
      }
    }
  }
  return best;
}

// The instance of a plan's VPL, as a function pointer.
template <bool RSMK>
const void* bf16x64_kernel(int vpl) {
  switch (vpl) {
    case 1: return reinterpret_cast<const void*>(bsr_spmv_bf16x64_kernel<1, RSMK>);
    case 2: return reinterpret_cast<const void*>(bsr_spmv_bf16x64_kernel<2, RSMK>);
    case 3: return reinterpret_cast<const void*>(bsr_spmv_bf16x64_kernel<3, RSMK>);
    default: return reinterpret_cast<const void*>(bsr_spmv_bf16x64_kernel<4, RSMK>);
  }
}

template <bool RSMK>
cudaError_t launch_bf16x64(const __nv_bfloat16* blocks, const int* col_blocks, const double* x, double* y, int R,
                           int bm, int S, int bk, int64_t n_x, int64_t n_out, const Plan& p, XPlan xp,
                           cudaStream_t stream) {
  const void* fn = bf16x64_kernel<RSMK>(xp.vpl);
  if (p.smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(p.smem));
    if (e != cudaSuccess) return e;
  }
  int s_piece = p.s_piece, lpr_log2 = xp.lpr_log2;
  size_t acc_bytes = p.acc_bytes;
  void* args[] = {&blocks, &col_blocks, &x, &y, &bm, &S, &bk, &n_x, &n_out, &s_piece, &acc_bytes, &lpr_log2};
  return cudaLaunchKernel(fn, dim3(R), dim3(kThreads), args, p.smem, stream);
}

template <typename T, typename X, bool RSMK>
cudaError_t bsr_spmv(const T* blocks, const int* col_blocks, const X* x, X* y, int R, int bm,
                     int S, int bk, int64_t n_x, int64_t n_out, cudaStream_t stream) {
  constexpr int VN = lt::Vec<T>::n;
  static_assert(sizeof(typename lt::Acc<X>::type) == sizeof(X), "the accumulator is x's type");
  if (R <= 0 || bm <= 0 || S <= 0 || bk <= 0) return cudaErrorInvalidValue;
  const Plan p = plan(bm, S, bk, sizeof(X));
  if (p.smem > kMaxSmem) return cudaErrorInvalidValue;
  const bool vec_ok = bk % VN == 0 && lt::aligned16(blocks);
  if constexpr (std::is_same_v<T, __nv_bfloat16> && std::is_same_v<X, double>) {
    if (vec_ok)
      return launch_bf16x64<RSMK>(blocks, col_blocks, x, y, R, bm, S, bk, n_x, n_out, p, x_plan(bm, p.s_piece * bk / VN),
                                  stream);
  }
  if (p.smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(bsr_spmv_kernel<T, X, RSMK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(p.smem));
    if (e != cudaSuccess) return e;
  }
  bsr_spmv_kernel<T, X, RSMK><<<R, kThreads, p.smem, stream>>>(
      blocks, col_blocks, x, y, bm, S, bk, n_x, n_out, p.s_piece, p.acc_bytes, vec_ok);
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
  return int(bsr_spmv<float, float, false>(blocks, col_blocks, x, y, R, bm, S, bk, n_x, n_out,
                                    static_cast<cudaStream_t>(stream)));
}

int lt_bsr_spmv_f64(const double* blocks, const int* col_blocks, const double* x, double* y,
                    int R, int bm, int S, int bk, long long n_x, long long n_out, int device,
                    void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(bsr_spmv<double, double, false>(blocks, col_blocks, x, y, R, bm, S, bk, n_x, n_out,
                                     static_cast<cudaStream_t>(stream)));
}

// K2: the same for (R, S, bm, bk) tiles; x is a table of n_x / bk rows.
int lt_bsr_spmv_rsmk_f32(const float* blocks, const int* col_blocks, const float* x, float* y,
                         int R, int bm, int S, int bk, long long n_x, long long n_out, int device,
                         void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(bsr_spmv<float, float, true>(blocks, col_blocks, x, y, R, bm, S, bk, n_x, n_out,
                                   static_cast<cudaStream_t>(stream)));
}

int lt_bsr_spmv_rsmk_f64(const double* blocks, const int* col_blocks, const double* x,
                         double* y, int R, int bm, int S, int bk, long long n_x, long long n_out,
                         int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(bsr_spmv<double, double, true>(blocks, col_blocks, x, y, R, bm, S, bk, n_x, n_out,
                                    static_cast<cudaStream_t>(stream)));
}

// K1x: float tiles against a double x, double y, double accumulation; the
// rmsk (K1's) and rsmk (K2's) forms.
int lt_bsr_spmv_f32x64(const float* blocks, const int* col_blocks, const double* x, double* y,
                       int R, int bm, int S, int bk, long long n_x, long long n_out, int device,
                       void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(bsr_spmv<float, double, false>(blocks, col_blocks, x, y, R, bm, S, bk, n_x, n_out,
                                            static_cast<cudaStream_t>(stream)));
}

int lt_bsr_spmv_rsmk_f32x64(const float* blocks, const int* col_blocks, const double* x,
                            double* y, int R, int bm, int S, int bk, long long n_x,
                            long long n_out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(bsr_spmv<float, double, true>(blocks, col_blocks, x, y, R, bm, S, bk, n_x, n_out,
                                           static_cast<cudaStream_t>(stream)));
}

// The complex instances: complex64 and complex128 tiles against a vector of
// their own type (K1), and complex64 tiles against a complex128 vector with
// complex128 accumulation (K1x); the rsmk forms (K2) follow below.
int lt_bsr_spmv_c64(const lt::cfloat* blocks, const int* col_blocks, const lt::cfloat* x, lt::cfloat* y, int R,
                    int bm, int S, int bk, long long n_x, long long n_out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(bsr_spmv<lt::cfloat, lt::cfloat, false>(blocks, col_blocks, x, y, R, bm, S, bk, n_x, n_out,
                                                     static_cast<cudaStream_t>(stream)));
}

int lt_bsr_spmv_c128(const lt::cdouble* blocks, const int* col_blocks, const lt::cdouble* x, lt::cdouble* y,
                     int R, int bm, int S, int bk, long long n_x, long long n_out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(bsr_spmv<lt::cdouble, lt::cdouble, false>(blocks, col_blocks, x, y, R, bm, S, bk, n_x, n_out,
                                                       static_cast<cudaStream_t>(stream)));
}

int lt_bsr_spmv_c64x128(const lt::cfloat* blocks, const int* col_blocks, const lt::cdouble* x, lt::cdouble* y,
                        int R, int bm, int S, int bk, long long n_x, long long n_out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(bsr_spmv<lt::cfloat, lt::cdouble, false>(blocks, col_blocks, x, y, R, bm, S, bk, n_x, n_out,
                                                      static_cast<cudaStream_t>(stream)));
}

// K2's complex instances, the local product of a complex sharded operator:
// complex64 and complex128 (R, S, bm, bk) tiles against a table of their own
// type, and complex64 tiles against a complex128 table (K1x-rsmk's complex
// form, the precise product of a complex sharded operator).
int lt_bsr_spmv_rsmk_c64(const lt::cfloat* blocks, const int* col_blocks, const lt::cfloat* x, lt::cfloat* y,
                         int R, int bm, int S, int bk, long long n_x, long long n_out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(bsr_spmv<lt::cfloat, lt::cfloat, true>(blocks, col_blocks, x, y, R, bm, S, bk, n_x, n_out,
                                                    static_cast<cudaStream_t>(stream)));
}

int lt_bsr_spmv_rsmk_c128(const lt::cdouble* blocks, const int* col_blocks, const lt::cdouble* x,
                          lt::cdouble* y, int R, int bm, int S, int bk, long long n_x, long long n_out, int device,
                          void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(bsr_spmv<lt::cdouble, lt::cdouble, true>(blocks, col_blocks, x, y, R, bm, S, bk, n_x, n_out,
                                                      static_cast<cudaStream_t>(stream)));
}

int lt_bsr_spmv_rsmk_c64x128(const lt::cfloat* blocks, const int* col_blocks, const lt::cdouble* x,
                             lt::cdouble* y, int R, int bm, int S, int bk, long long n_x, long long n_out,
                             int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(bsr_spmv<lt::cfloat, lt::cdouble, true>(blocks, col_blocks, x, y, R, bm, S, bk, n_x, n_out,
                                                     static_cast<cudaStream_t>(stream)));
}

// The bfloat16 instances: bfloat16 tiles against a float x, y and
// accumulator (K1, and K2 in the rsmk form) and against a double one (K1x
// and its rsmk form).
int lt_bsr_spmv_bf16(const __nv_bfloat16* blocks, const int* col_blocks, const float* x, float* y, int R, int bm,
                     int S, int bk, long long n_x, long long n_out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(bsr_spmv<__nv_bfloat16, float, false>(blocks, col_blocks, x, y, R, bm, S, bk, n_x, n_out,
                                                   static_cast<cudaStream_t>(stream)));
}

int lt_bsr_spmv_rsmk_bf16(const __nv_bfloat16* blocks, const int* col_blocks, const float* x, float* y, int R,
                          int bm, int S, int bk, long long n_x, long long n_out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(bsr_spmv<__nv_bfloat16, float, true>(blocks, col_blocks, x, y, R, bm, S, bk, n_x, n_out,
                                                  static_cast<cudaStream_t>(stream)));
}

int lt_bsr_spmv_bf16x64(const __nv_bfloat16* blocks, const int* col_blocks, const double* x, double* y, int R,
                        int bm, int S, int bk, long long n_x, long long n_out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(bsr_spmv<__nv_bfloat16, double, false>(blocks, col_blocks, x, y, R, bm, S, bk, n_x, n_out,
                                                    static_cast<cudaStream_t>(stream)));
}

int lt_bsr_spmv_rsmk_bf16x64(const __nv_bfloat16* blocks, const int* col_blocks, const double* x, double* y,
                             int R, int bm, int S, int bk, long long n_x, long long n_out, int device,
                             void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(bsr_spmv<__nv_bfloat16, double, true>(blocks, col_blocks, x, y, R, bm, S, bk, n_x, n_out,
                                                   static_cast<cudaStream_t>(stream)));
}

// The plan of a launch with x values of x_bytes bytes (4, 8 or 16: float,
// double or complex64, complex128): out = {s_piece,
// dynamic shared bytes, whether it opts in past 48 KB, static shared bytes
// of the f32x64 rmsk kernel}.
int lt_bsr_spmv_info(int bm, int S, int bk, int x_bytes, int* out) {
  if (bm <= 0 || S <= 0 || bk <= 0 || (x_bytes != 4 && x_bytes != 8 && x_bytes != 16)) return int(cudaErrorInvalidValue);
  const Plan p = plan(bm, S, bk, size_t(x_bytes));
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, bsr_spmv_kernel<float, double, false>);
  if (e != cudaSuccess) return int(e);
  out[0] = p.s_piece;
  out[1] = int(p.smem);
  out[2] = p.smem > kDefaultSmem ? 1 : 0;
  out[3] = int(attr.sharedSizeBytes);
  return 0;
}

// A study of the bfloat16 x float64 body's plan: one launch with 1 <<
// lpr_log2 lanes a row and vpl vectors a lane forced in place of x_plan's
// choice (rsmk != 0: the rsmk form).  chip_ab.py times it beside the plan;
// the wrappers never call it.
int lt_bsr_spmv_bf16x64_forced(const __nv_bfloat16* blocks, const int* col_blocks, const double* x, double* y, int R,
                               int bm, int S, int bk, long long n_x, long long n_out, int rsmk, int lpr_log2, int vpl,
                               int device, void* stream) {
  if (R <= 0 || bm <= 0 || S <= 0 || bk <= 0 || bk % 8 || !lt::aligned16(blocks) || lpr_log2 < 0 || lpr_log2 > 5 ||
      vpl < 1 || vpl > kMaxVpl)
    return int(cudaErrorInvalidValue);
  const Plan p = plan(bm, S, bk, sizeof(double));
  if (p.smem > kMaxSmem) return int(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  const XPlan xp{lpr_log2, vpl};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(rsmk ? launch_bf16x64<true>(blocks, col_blocks, x, y, R, bm, S, bk, n_x, n_out, p, xp, st)
                  : launch_bf16x64<false>(blocks, col_blocks, x, y, R, bm, S, bk, n_x, n_out, p, xp, st));
}

// The bfloat16 x float64 body's plan and attributes for tiles of bm rows,
// S tiles a row block and bk columns (rsmk != 0: the rsmk form): out =
// {lanes a row, vectors a lane, s_piece, dynamic shared bytes, whether it
// opts in past 48 KB, registers a thread, local (spill) bytes a thread,
// resident CTAs a multiprocessor}.  bk % 8 != 0 takes the shared
// template's scalar loop: lanes and vectors 0, that kernel's attributes.
int lt_bsr_spmv_bf16x64_info(int bm, int S, int bk, int rsmk, int* out) {
  if (bm <= 0 || S <= 0 || bk <= 0) return int(cudaErrorInvalidValue);
  const Plan p = plan(bm, S, bk, sizeof(double));
  if (p.smem > kMaxSmem) return int(cudaErrorInvalidValue);
  const bool vec = bk % 8 == 0;
  const XPlan xp = x_plan(bm, p.s_piece * bk / 8);
  const void* fn = !vec ? (rsmk ? reinterpret_cast<const void*>(bsr_spmv_kernel<__nv_bfloat16, double, true>)
                                : reinterpret_cast<const void*>(bsr_spmv_kernel<__nv_bfloat16, double, false>))
                        : (rsmk ? bf16x64_kernel<true>(xp.vpl) : bf16x64_kernel<false>(xp.vpl));
  cudaError_t e = cudaSuccess;
  if (p.smem > kDefaultSmem) e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(p.smem));
  if (e != cudaSuccess) return int(e);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return int(e);
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, kThreads, p.smem);
  if (e != cudaSuccess) return int(e);
  out[0] = vec ? 1 << xp.lpr_log2 : 0;
  out[1] = vec ? xp.vpl : 0;
  out[2] = p.s_piece;
  out[3] = int(p.smem);
  out[4] = p.smem > kDefaultSmem ? 1 : 0;
  out[5] = attr.numRegs;
  out[6] = int(attr.localSizeBytes);
  out[7] = ctas;
  return 0;
}

const char* lt_error_string(int code) { return cudaGetErrorString(cudaError_t(code)); }

}  // extern "C"
