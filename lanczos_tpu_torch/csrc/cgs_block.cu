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
//   1. project_kernel: part[j*b + q, cta] = B[j, range] . V[q, range];
//   2. lt::reduce_rows_kernel: C[j, q] = sum_cta part[j*b + q, cta], in a
//      fixed order (no atomics: the same bits on every run);
//   3. update_kernel: V[q, range] -= sum_j C[j, q] B[j, range], in place.
// Over rows split across ranks C is a partial sum on each rank: the caller
// runs launches 1-2 (phases = 1), all-reduces C and runs launch 3 (phases =
// 2) on the sum; phases = 3 is the whole pass.
//
// What bounds it on the H100: bytes.  A pass reads the k live basis rows
// twice (2 k n values: once to project, once to update; at the flagship's
// k = 255 the rows are 4.3 GB, far beyond L2 and shared memory, so no
// one-pass form exists) and the block twice.  It does b FMAs per basis
// value and phase, far below the card's FMA rate for b <= 16.  The design
// keeps the basis stream busy and spends few instructions around it:
//   * each CTA owns one column range of `cols` values (at most
//     256 * NV 16-byte vectors, NV = 4 for b <= 4), sized by the caller
//     from n and the SM count (ops/cgs.py block_plan) so the grid fills
//     whole waves of two resident CTAs per SM, and 128-byte aligned where
//     that keeps two CTAs per SM;
//   * one producer warp streams the live rows' segments of that range
//     through a ring of `stages` shared-memory buffers with 1-D bulk copies
//     (cp.async.bulk, no tensor map, so no libcuda) tracked by mbarriers;
//     rows that are not 16-byte aligned (n % VN != 0) go by 4- or 8-byte
//     cp.async into the same ring.  Loads in flight cost no registers.  The
//     ring holds ~32 KB (two 16 KB stages at the flagship's plan), and a
//     proxy fence on both sides of a stage's release orders the consumers'
//     reads before its refill.  The ring's PTX helpers are ring.cuh's,
//     shared with E2a (bcgs_ring.cu);
//   * eight consumer warps keep their slice of V in registers for the
//     whole range (V is read once per launch), accumulate each row's
//     partial dot products over the whole range and warp-reduce each
//     (row, vector) once per CTA; eight rows share one barrier of the
//     consumer warps and one write of the CTA's partials;
//   * the update runs on the same ring, with C staged in shared memory;
//   * b <= 4 are exact template widths (no padded FMAs); 5..8 and 9..16
//     run in the buckets 8 and 16 with the spare vectors masked.
// Plain FMAs in the storage precision (f32 or f64), no tensor cores, no
// TF32, no atomics.
//
// Complex bases (complex64, complex128) run the same kernels over
// lt::cfloat / lt::cdouble: the coefficients conjugate the basis,
// C[j, q] = sum_n conj(B[j, n]) V[q, n] (lt::fma_conj), the update is
// V[q] -= sum_j C[j, q] B[j] (cx::fma), each four real FMAs per value in a
// fixed order, as in K3's complex instances (cgs.cu), so a run repeats bit
// for bit.  A 16-byte vector holds two complex64 or one complex128 value,
// so the slice of V a thread keeps costs the registers it does in f32 or
// f64 for the same bytes.  The real instances' arithmetic is unchanged
// (fma_conj is fma for real types).
#include "common.cuh"
#include "ring.cuh"

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;  // threads that compute
constexpr int kThreads = kConsumers + 32;         // and one producer warp
constexpr int kMaxB = 16;
constexpr int kMinStages = 2;
constexpr int kMaxStages = 8;
constexpr int kRowGroup = 8;          // projection: rows per reduction round
constexpr int kConsumerBarrier = 1;   // named barrier of the consumer warps (0 is __syncthreads)
constexpr int kCoefBytes = 8192;      // update: coefficients staged in shared memory at a time
constexpr size_t kMaxSmem = 227 * 1024;

// 16-byte vectors per consumer thread per row: the range holds at most
// kConsumers * NV vectors, and the slice of V (B * NV vectors) stays in
// 64 registers or fewer.
template <int B>
__host__ __device__ constexpr int vectors_per_thread() {
  return B <= 4 ? 4 : (B <= 8 ? 2 : 1);
}

// ---- the consumers' barrier (the ring's PTX helpers are in ring.cuh) ---

__device__ __forceinline__ void consumer_sync() { lt::bar_sync<kConsumerBarrier, kConsumers>(); }

// ---- shared memory ---------------------------------------------------------

// [ring: stages x cols T][full: stages mbarriers][empty: stages][scratch]
template <typename T>
__host__ __device__ constexpr size_t ring_bytes(int cols, int stages) {
  return size_t(stages) * size_t(cols) * sizeof(T);
}

template <typename T, int B>
__host__ __device__ constexpr size_t project_scratch() {
  return size_t(2) * kConsumerWarps * kRowGroup * B * sizeof(typename lt::Acc<T>::type);
}

template <typename T, int B>
__host__ __device__ constexpr int coef_rows() {
  return kCoefBytes / int(B * sizeof(typename lt::Acc<T>::type));
}

template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int cols, int stages, size_t scratch) {
  return ring_bytes<T>(cols, stages) + size_t(2) * stages * sizeof(uint64_t) + scratch;
}

// The ring's mbarriers (lt::init_ring): full[s] completes when row
// segment s has landed, empty[s] when every consumer warp has read it.
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int stages, bool bulk) {
  lt::init_ring(full, empty, stages, bulk, kConsumerWarps);
}

// The producer warp: rows [0, k) of the range [c0, c0 + cols_here) into
// the ring, row j into stage j % stages.
template <typename T>
__device__ __forceinline__ void produce(const T* __restrict__ basis, int64_t n, int k, int64_t c0,
                                        int cols_here, int cols, int stages, T* ring, uint64_t* full,
                                        uint64_t* empty, bool bulk) {
  constexpr int VN = lt::Vec<T>::n;
  const int padded = (cols_here + VN - 1) / VN * VN;  // the consumers read whole vectors
  int s = 0;
  uint32_t phase = 0;
  for (int j = 0; j < k; ++j) {
    lt::mbar_wait(&empty[s], phase ^ 1u);
    lt::proxy_fence();  // the consumers' reads of this stage before the async copy's writes
    lt::issue_segment<T>(ring + size_t(s) * cols, basis + int64_t(j) * n + c0, cols_here, padded, bulk, &full[s]);
    if (++s == stages) {
      s = 0;
      phase ^= 1u;
    }
  }
}

// One 16-byte vector of a row of V at column `col` (zeros past n).
template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ row, int64_t col, int64_t n, bool vec_ok,
                                         T (&out)[lt::Vec<T>::n]) {
  using V = typename lt::Vec<T>::type;
  constexpr int VN = lt::Vec<T>::n;
  if (vec_ok) {
    if (col < n) {
      const V t = *reinterpret_cast<const V*>(row + col);
      const T* tt = reinterpret_cast<const T*>(&t);
#pragma unroll
      for (int c = 0; c < VN; ++c) out[c] = tt[c];
    } else {
#pragma unroll
      for (int c = 0; c < VN; ++c) out[c] = T(0);
    }
  } else {
#pragma unroll
    for (int c = 0; c < VN; ++c) out[c] = col + c < n ? row[col + c] : T(0);
  }
}

template <typename T, typename A>
__device__ __forceinline__ void store_vec(T* __restrict__ row, int64_t col, int64_t n, bool vec_ok,
                                          const A (&vals)[lt::Vec<T>::n]) {
  using V = typename lt::Vec<T>::type;
  constexpr int VN = lt::Vec<T>::n;
  if (vec_ok) {
    if (col < n) {
      V out;
      T* oo = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int c = 0; c < VN; ++c) oo[c] = T(vals[c]);
      *reinterpret_cast<V*>(row + col) = out;
    }
  } else {
#pragma unroll
    for (int c = 0; c < VN; ++c)
      if (col + c < n) row[col + c] = T(vals[c]);
  }
}

// ---- the two phases ----------------------------------------------------------

// Consumer thread x owns the vectors x + i*kConsumers (i < NV) of its CTA's
// range, in the ring as in V.
template <typename T, int B>
__global__ void __launch_bounds__(kThreads, 2)
    project_kernel(const T* __restrict__ basis, const T* __restrict__ v,
                   typename lt::Acc<T>::type* __restrict__ part, int64_t n, int k, int b, int cols,
                   int stages, bool vec_ok) {
  using A = typename lt::Acc<T>::type;
  using V = typename lt::Vec<T>::type;
  constexpr int VN = lt::Vec<T>::n;
  constexpr int NV = vectors_per_thread<B>();
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ring_bytes<T>(cols, stages));
  uint64_t* empty = full + stages;
  A* red = reinterpret_cast<A*>(empty + stages);  // [2][kConsumerWarps][kRowGroup * B]
  const int64_t c0 = int64_t(blockIdx.x) * cols;
  const int cols_here = n - c0 < cols ? int(n - c0) : cols;
  const int nvec = (cols_here + VN - 1) / VN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  init_ring(full, empty, stages, vec_ok);
  if (warp == kConsumerWarps) {
    produce<T>(basis, n, k, c0, cols_here, cols, stages, ring, full, empty, vec_ok);
    return;
  }

  T vr[B][NV][VN];
#pragma unroll
  for (int q = 0; q < B; ++q) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int iv = threadIdx.x + i * kConsumers;
      if (q < b && iv < nvec) {
        load_vec<T>(v + int64_t(q) * n, c0 + int64_t(iv) * VN, n, vec_ok, vr[q][i]);
      } else {
#pragma unroll
        for (int c = 0; c < VN; ++c) vr[q][i][c] = T(0);
      }
    }
  }

  int s = 0;
  uint32_t phase = 0;
  for (int j0 = 0, g = 0; j0 < k; j0 += kRowGroup, g ^= 1) {
    const int rows = min(kRowGroup, k - j0);
    A* red_g = red + g * (kConsumerWarps * kRowGroup * B);
    for (int r = 0; r < rows; ++r) {
      lt::mbar_wait(&full[s], phase);
      const T* row = ring + size_t(s) * cols;
      A acc[B];
#pragma unroll
      for (int q = 0; q < B; ++q) acc[q] = A(0);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int iv = threadIdx.x + i * kConsumers;
        if (iv < nvec) {
          const V x = *reinterpret_cast<const V*>(row + iv * VN);
          const T* xx = reinterpret_cast<const T*>(&x);
#pragma unroll
          for (int q = 0; q < B; ++q) {
#pragma unroll
            for (int c = 0; c < VN; ++c) acc[q] = lt::fma_conj(A(xx[c]), A(vr[q][i][c]), acc[q]);
          }
        }
      }
      lt::proxy_fence();  // this stage's reads before the refill's writes (async proxy)
      __syncwarp();
      if (lane == 0) lt::mbar_arrive(&empty[s]);
      if (++s == stages) {
        s = 0;
        phase ^= 1u;
      }
#pragma unroll
      for (int q = 0; q < B; ++q) {
        if (B <= 4 || q < b) {  // uniform: every lane takes the shuffles
          const A w = lt::warp_sum(acc[q]);
          if (lane == 0) red_g[warp * (kRowGroup * B) + r * B + q] = w;
        }
      }
    }
    // red is double-buffered by group parity: the next group writes the
    // other half, and the one after it passes this barrier first.
    consumer_sync();
    if (threadIdx.x < rows * B) {
      const int r = threadIdx.x / B;
      const int q = threadIdx.x % B;
      if (B <= 4 || q < b) {
        A tot = A(0);
#pragma unroll
        for (int w = 0; w < kConsumerWarps; ++w) tot += red_g[w * (kRowGroup * B) + threadIdx.x];
        part[(int64_t(j0 + r) * b + q) * gridDim.x + blockIdx.x] = tot;
      }
    }
  }
}

template <typename T, int B>
__global__ void __launch_bounds__(kThreads, 2)
    update_kernel(const T* __restrict__ basis, T* __restrict__ v,
                  const typename lt::Acc<T>::type* __restrict__ coef, int64_t n, int k, int b, int cols,
                  int stages, bool vec_ok) {
  using A = typename lt::Acc<T>::type;
  using V = typename lt::Vec<T>::type;
  constexpr int VN = lt::Vec<T>::n;
  constexpr int NV = vectors_per_thread<B>();
  constexpr int CR = coef_rows<T, B>();
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ring_bytes<T>(cols, stages));
  uint64_t* empty = full + stages;
  A* cs = reinterpret_cast<A*>(empty + stages);  // [CR][B]
  const int64_t c0 = int64_t(blockIdx.x) * cols;
  const int cols_here = n - c0 < cols ? int(n - c0) : cols;
  const int nvec = (cols_here + VN - 1) / VN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  init_ring(full, empty, stages, vec_ok);
  if (warp == kConsumerWarps) {
    produce<T>(basis, n, k, c0, cols_here, cols, stages, ring, full, empty, vec_ok);
    return;
  }

  A acc[B][NV][VN];
#pragma unroll
  for (int q = 0; q < B; ++q) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int iv = threadIdx.x + i * kConsumers;
      T t[VN];
      if (q < b && iv < nvec) {
        load_vec<T>(v + int64_t(q) * n, c0 + int64_t(iv) * VN, n, vec_ok, t);
      } else {
#pragma unroll
        for (int c = 0; c < VN; ++c) t[c] = T(0);
      }
#pragma unroll
      for (int c = 0; c < VN; ++c) acc[q][i][c] = A(t[c]);
    }
  }

  int s = 0;
  uint32_t phase = 0;
  for (int j0 = 0; j0 < k; j0 += CR) {
    const int rows = min(CR, k - j0);
    consumer_sync();  // the previous chunk's readers are done with cs
    for (int i = threadIdx.x; i < rows * B; i += kConsumers) {
      const int jj = i / B;
      const int q = i % B;
      cs[i] = q < b ? coef[int64_t(j0 + jj) * b + q] : A(0);
    }
    consumer_sync();
    for (int jj = 0; jj < rows; ++jj) {
      lt::mbar_wait(&full[s], phase);
      const T* row = ring + size_t(s) * cols;
      A cq[B];
#pragma unroll
      for (int q = 0; q < B; ++q) cq[q] = cs[jj * B + q];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int iv = threadIdx.x + i * kConsumers;
        if (iv < nvec) {
          const V x = *reinterpret_cast<const V*>(row + iv * VN);
          const T* xx = reinterpret_cast<const T*>(&x);
#pragma unroll
          for (int q = 0; q < B; ++q) {
#pragma unroll
            for (int c = 0; c < VN; ++c) acc[q][i][c] = fma(-cq[q], A(xx[c]), acc[q][i][c]);
          }
        }
      }
      lt::proxy_fence();  // this stage's reads before the refill's writes (async proxy)
      __syncwarp();
      if (lane == 0) lt::mbar_arrive(&empty[s]);
      if (++s == stages) {
        s = 0;
        phase ^= 1u;
      }
    }
  }

#pragma unroll
  for (int q = 0; q < B; ++q) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int iv = threadIdx.x + i * kConsumers;
      if (q < b && iv < nvec) store_vec<T>(v + int64_t(q) * n, c0 + int64_t(iv) * VN, n, vec_ok, acc[q][i]);
    }
  }
}

// ---- host side -----------------------------------------------------------------

template <typename T, int B>
cudaError_t check_plan(int cols, int stages) {
  constexpr int VN = lt::Vec<T>::n;
  if (cols < VN || cols % VN != 0 || cols > kConsumers * vectors_per_thread<B>() * VN)
    return cudaErrorInvalidValue;
  if (stages < kMinStages || stages > kMaxStages) return cudaErrorInvalidValue;
  const size_t scratch = project_scratch<T, B>() > size_t(kCoefBytes) ? project_scratch<T, B>() : size_t(kCoefBytes);
  if (smem_bytes<T>(cols, stages, scratch) > kMaxSmem) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Dynamic shared memory past 48 KB is opt-in per kernel; the carveout asks
// for the whole of the SM's 228 KB so two CTAs fit.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              int(cudaSharedmemCarveoutMaxShared));
}

template <typename T, int B>
cudaError_t launch(const T* basis, T* v, typename lt::Acc<T>::type* part, typename lt::Acc<T>::type* c,
                   int64_t n, int k, int b, int cols, int stages, int phases, cudaStream_t stream) {
  cudaError_t e = check_plan<T, B>(cols, stages);
  if (e != cudaSuccess) return e;
  const int64_t grid = (n + cols - 1) / cols;
  if (grid > INT32_MAX) return cudaErrorInvalidValue;
  // Row q of the block (and row j of the basis) starts at q*n: 16-byte
  // aligned for every q only when n is a multiple of the vector width.
  const bool vec_ok = n % lt::Vec<T>::n == 0 && lt::aligned16(basis) && lt::aligned16(v);
  const size_t smem_p = smem_bytes<T>(cols, stages, project_scratch<T, B>());
  const size_t smem_u = smem_bytes<T>(cols, stages, size_t(kCoefBytes));
  if ((e = allow_smem(project_kernel<T, B>, smem_p)) != cudaSuccess) return e;
  if ((e = allow_smem(update_kernel<T, B>, smem_u)) != cudaSuccess) return e;
  if (phases & 1) {
    project_kernel<T, B><<<unsigned(grid), kThreads, smem_p, stream>>>(basis, v, part, n, k, b, cols, stages,
                                                                       vec_ok);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    lt::reduce_rows_kernel<typename lt::Acc<T>::type, 256><<<unsigned(k * b), 256, 0, stream>>>(part, c, grid);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (phases & 2) {
    update_kernel<T, B><<<unsigned(grid), kThreads, smem_u, stream>>>(basis, v, c, n, k, b, cols, stages, vec_ok);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t cgs_pass_block(const T* basis, T* v, typename lt::Acc<T>::type* part,
                           typename lt::Acc<T>::type* c, int64_t n, int k, int b, int cols, int stages,
                           int phases, cudaStream_t stream) {
  if (n <= 0 || k < 0 || b < 1 || b > kMaxB || phases < 1 || phases > 3) return cudaErrorInvalidValue;
  if (k == 0) return cudaSuccess;
  switch (b) {
    case 1: return launch<T, 1>(basis, v, part, c, n, k, b, cols, stages, phases, stream);
    case 2: return launch<T, 2>(basis, v, part, c, n, k, b, cols, stages, phases, stream);
    case 3: return launch<T, 3>(basis, v, part, c, n, k, b, cols, stages, phases, stream);
    case 4: return launch<T, 4>(basis, v, part, c, n, k, b, cols, stages, phases, stream);
    default: break;
  }
  if (b <= 8) return launch<T, 8>(basis, v, part, c, n, k, b, cols, stages, phases, stream);
  return launch<T, 16>(basis, v, part, c, n, k, b, cols, stages, phases, stream);
}

// What the compiler and the occupancy calculator make of one width:
// out = {project registers, project local bytes, update registers, update
// local bytes, project smem bytes, update smem bytes, project CTAs per SM,
// update CTAs per SM}.
template <typename T, int B>
cudaError_t info(int cols, int stages, int* out) {
  cudaError_t e = check_plan<T, B>(cols, stages);
  if (e != cudaSuccess) return e;
  const size_t smem_p = smem_bytes<T>(cols, stages, project_scratch<T, B>());
  const size_t smem_u = smem_bytes<T>(cols, stages, size_t(kCoefBytes));
  if ((e = allow_smem(project_kernel<T, B>, smem_p)) != cudaSuccess) return e;
  if ((e = allow_smem(update_kernel<T, B>, smem_u)) != cudaSuccess) return e;
  cudaFuncAttributes ap{}, au{};
  if ((e = cudaFuncGetAttributes(&ap, project_kernel<T, B>)) != cudaSuccess) return e;
  if ((e = cudaFuncGetAttributes(&au, update_kernel<T, B>)) != cudaSuccess) return e;
  int occ_p = 0, occ_u = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ_p, project_kernel<T, B>, kThreads, smem_p)) !=
      cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ_u, update_kernel<T, B>, kThreads, smem_u)) !=
      cudaSuccess)
    return e;
  const int vals[8] = {ap.numRegs, int(ap.localSizeBytes), au.numRegs, int(au.localSizeBytes),
                       int(smem_p), int(smem_u), occ_p, occ_u};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return cudaSuccess;
}

template <typename T>
cudaError_t info_any(int b, int cols, int stages, int* out) {
  switch (b) {
    case 1: return info<T, 1>(cols, stages, out);
    case 2: return info<T, 2>(cols, stages, out);
    case 3: return info<T, 3>(cols, stages, out);
    case 4: return info<T, 4>(cols, stages, out);
    default: break;
  }
  if (b < 1 || b > kMaxB) return cudaErrorInvalidValue;
  if (b <= 8) return info<T, 8>(cols, stages, out);
  return info<T, 16>(cols, stages, out);
}

}  // namespace

extern "C" {

// One pass.  `cols` (the column range per CTA) and `stages` (ring depth)
// come from the wrapper's plan (ops/cgs.py block_plan); `part` holds
// (k*b, ceil(n / cols)) partial sums and `c` the (k, b) coefficients;
// `phases` (1, 2 or 3) selects the launches, as cgs_pass_block above.
// `device` is the CUDA ordinal the tensors and `stream` belong to (made
// current here: this library has its own runtime).
int lt_cgs_block_pass_f32(const float* basis, float* v, float* part, float* c, long long n, int k, int b,
                          int cols, int stages, int phases, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(cgs_pass_block<float>(basis, v, part, c, n, k, b, cols, stages, phases,
                                   static_cast<cudaStream_t>(stream)));
}

int lt_cgs_block_pass_f64(const double* basis, double* v, double* part, double* c, long long n, int k, int b,
                          int cols, int stages, int phases, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(cgs_pass_block<double>(basis, v, part, c, n, k, b, cols, stages, phases,
                                    static_cast<cudaStream_t>(stream)));
}

// The complex instances: conjugated coefficients, complex partial sums.
int lt_cgs_block_pass_c64(const lt::cfloat* basis, lt::cfloat* v, lt::cfloat* part, lt::cfloat* c, long long n,
                          int k, int b, int cols, int stages, int phases, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(cgs_pass_block<lt::cfloat>(basis, v, part, c, n, k, b, cols, stages, phases,
                                        static_cast<cudaStream_t>(stream)));
}

int lt_cgs_block_pass_c128(const lt::cdouble* basis, lt::cdouble* v, lt::cdouble* part, lt::cdouble* c,
                           long long n, int k, int b, int cols, int stages, int phases, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(cgs_pass_block<lt::cdouble>(basis, v, part, c, n, k, b, cols, stages, phases,
                                         static_cast<cudaStream_t>(stream)));
}

// Registers, spills, shared memory and resident CTAs per SM of the width-b
// kernels at a plan (see info above); `code` selects the basis type: 0
// float, 1 double, 2 complex64, 3 complex128.
int lt_cgs_block_info(int code, int b, int cols, int stages, int device, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  switch (code) {
    case 0: return int(info_any<float>(b, cols, stages, out));
    case 1: return int(info_any<double>(b, cols, stages, out));
    case 2: return int(info_any<lt::cfloat>(b, cols, stages, out));
    case 3: return int(info_any<lt::cdouble>(b, cols, stages, out));
    default: return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
