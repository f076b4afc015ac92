// K5: the Chebyshev filter's three-term recurrence chain, time-tiled.
//
// Replaces the Pallas TPU kernel lanczos_tpu/ops/pallas_cheby.py
// cheby_chain_apply (kernel _cheby_kernel).  With the operator prescaled on
// the host (data' = (2/e) data, -2c/e on the 0-offset row) one recurrence
// step is
//
//     t_next[i] = sum_d data'[d, i] * t[i + off_d] - t_prev[i]
//
// and the chain is `steps` such steps; the first step of an apply is the
// half step t_1 = 0.5 * sum_d data'[d, i] * x[i + off_d].  Cells outside
// [0, n) read as zero.  The diagonals are summed in `offsets` order: the
// first product, then one fmaf per further diagonal.
//
// What bounds it on the H100: operations.  Unfused, every step streams the
// iterates and the rows from device memory (about 5 n floats per step); a
// degree-400 apply at n = 2^22 is then ~16 GB of traffic.  Both routes here
// keep a window of the iterates and the rows on chip and advance it `steps`
// steps per device-memory round trip (overlapped, trapezoidal time tiling):
// CTA b owns the core [b L, b L + L) of the window [b L - H, b L + L + H);
// the window edges go stale by at most w = max |off| cells a step, so
// H >= steps * w keeps the core exact, and only the core is written back,
// both t and t_prev, so launches chain.  `steps` is a runtime argument, so
// the same kernels run the remainder steps and degree 1.
//
// The register route (bands of width w <= 1 with distinct offsets, as the
// flagship's chain): 256 threads, each owning 16 contiguous cells of
// the window, keep t, t_prev and the prescaled rows of those cells in
// registers for all of a launch's steps.  A cell's neighbours come from the
// thread's own registers, from the next lane by one __shfl_up_sync and one
// __shfl_down_sync, and across warps from a two-cell edge buffer per warp
// in shared memory (double-buffered by step parity: one __syncthreads per
// step).  The run's inner cells need none of these, so they are summed
// while the shuffles and the barrier are in flight.  The rows never move
// after the launch's first load.  The offsets are compile-time (one kernel
// per ordered pattern of one to three distinct offsets in [-1, 1], 15 in
// all), so every register index is fixed and no step dispatches on an
// offset: a per-step dispatch on runtime offsets cost a quarter of the
// time on the H100 (PERF.md).  A launch advances 256 steps.  Window
// loads and core stores are 16-byte vectors where the rows are aligned.
//
// The shared-memory route (wider bands or repeated offsets; ops/cheby.py
// plan() chooses): the window of t, t_prev and every row
// lives in up to 227 KB of shared memory, one 1024-thread CTA per SM; each
// step reads t's neighbours at flat offsets and writes t_next over t_prev in
// place, one __syncthreads() per step.
//
// Plain float32 FMAs on the CUDA cores in both routes, no tensor cores, no
// TF32.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstdlib>

namespace {

constexpr int kMaxDiags = 32;

struct Offsets {
  int v[kMaxDiags];
};

// ---- the shared-memory route -----------------------------------------------

constexpr int kSmemThreads = 1024;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;  // opt-in dynamic shared memory per block on sm_90

// Shared memory of one window of m cells: two iterate buffers with w zero
// cells on each side (the shifted reads at the window edge land there) and
// ndiag prescaled rows.
size_t smem_bytes(int ndiag, int m, int w) {
  return (size_t(2) * (size_t(m) + 2 * size_t(w)) + size_t(ndiag) * size_t(m)) * sizeof(float);
}

__global__ void __launch_bounds__(kSmemThreads, 1)
    cheby_chain_smem_kernel(const float* __restrict__ data, const Offsets offs, int ndiag,
                            const float* __restrict__ t_in, const float* __restrict__ tp_in,
                            float* __restrict__ t_out, float* __restrict__ tp_out, int64_t n, int w,
                            int L, int H, int steps, int first_half) {
  extern __shared__ float smem[];
  const int M = L + 2 * H;
  float* buf0 = smem;                // cell j of the window at buf0[w + j]
  float* buf1 = smem + (M + 2 * w);  // likewise
  float* D = smem + 2 * (M + 2 * w);  // D[d * M + j]: prescaled row d at cell j
  const int64_t base = int64_t(blockIdx.x) * L - H;  // global index of window cell 0

  for (int i = threadIdx.x; i < w; i += kSmemThreads) {
    buf0[i] = 0.f;
    buf0[w + M + i] = 0.f;
    buf1[i] = 0.f;
    buf1[w + M + i] = 0.f;
  }
  for (int j = threadIdx.x; j < M; j += kSmemThreads) {
    const int64_t g = base + j;
    const bool in = g >= 0 && g < n;
    buf0[w + j] = in ? t_in[g] : 0.f;
    buf1[w + j] = (in && !first_half) ? tp_in[g] : 0.f;
  }
  for (int d = 0; d < ndiag; ++d) {
    const float* row = data + int64_t(d) * n;
    for (int j = threadIdx.x; j < M; j += kSmemThreads) {
      const int64_t g = base + j;
      D[d * M + j] = (g >= 0 && g < n) ? row[g] : 0.f;
    }
  }
  __syncthreads();

  float* t = buf0 + w;
  float* tp = buf1 + w;
  for (int st = 0; st < steps; ++st) {
    const bool half = first_half && st == 0;
    for (int j = threadIdx.x; j < M; j += kSmemThreads) {
      // The diagonals in offsets order, as the plain version sums them.
      float acc = D[j] * t[j + offs.v[0]];
#pragma unroll
      for (int d = 1; d < kMaxDiags; ++d) {
        if (d >= ndiag) break;
        acc = fmaf(D[d * M + j], t[j + offs.v[d]], acc);
      }
      tp[j] = half ? 0.5f * acc : acc - tp[j];  // t_next over t_prev, in place
    }
    __syncthreads();  // every read of t is done before the next step writes it
    float* s = t;
    t = tp;
    tp = s;
  }

  for (int j = H + threadIdx.x; j < H + L; j += kSmemThreads) {
    const int64_t g = base + j;
    if (g < n) {
      t_out[g] = t[j];
      tp_out[g] = tp[j];
    }
  }
}

cudaError_t launch_smem(const float* data, const Offsets& offs, int ndiag, const float* t_in,
                        const float* tp_in, float* t_out, float* tp_out, int64_t n, int w, int L, int H,
                        int steps, int first_half, cudaStream_t stream) {
  if (int64_t(L) + 2 * int64_t(H) > INT_MAX / kMaxDiags) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(ndiag, L + 2 * H, w);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(cheby_chain_smem_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  const int64_t grid = (n + L - 1) / L;
  if (grid > INT_MAX) return cudaErrorInvalidValue;
  cheby_chain_smem_kernel<<<unsigned(grid), kSmemThreads, smem, stream>>>(
      data, offs, ndiag, t_in, tp_in, t_out, tp_out, n, w, L, H, steps, first_half);
  return cudaGetLastError();
}

// ---- the register route ------------------------------------------------------

constexpr int kRegThreads = 256;
constexpr int kRegWarps = kRegThreads / 32;
constexpr int kRegCells = 16;  // cells per thread: (3 rows + t, t_prev, sums) * 16 <= 128 registers

// The offsets, each in [-1, 1], are compile-time: pattern PAT holds offset
// d + 1 as its base-3 digit d, so every register index is fixed and no step
// dispatches on an offset.
__host__ __device__ constexpr int pow3(int d) { return d == 0 ? 1 : 3 * pow3(d - 1); }
__host__ __device__ constexpr int pattern_offset(int pat, int d) { return pat / pow3(d) % 3 - 1; }

// C cells from g0 on (zeros outside [0, n)); 16-byte loads when the cells
// are inside and `vec_ok` says the rows are aligned.
template <int C>
__device__ __forceinline__ void load_cells(const float* __restrict__ p, int64_t g0, int64_t n, bool vec_ok,
                                           float (&out)[C]) {
  if (vec_ok && g0 >= 0 && g0 + C <= n) {
#pragma unroll
    for (int i = 0; i < C / 4; ++i) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p + g0) + i);
      out[4 * i] = x.x;
      out[4 * i + 1] = x.y;
      out[4 * i + 2] = x.z;
      out[4 * i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int64_t g = g0 + c;
      out[c] = (g >= 0 && g < n) ? p[g] : 0.f;
    }
  }
}

template <int C>
__device__ __forceinline__ void store_cells(float* __restrict__ p, int64_t g0, int64_t n, bool vec_ok,
                                            const float (&vals)[C]) {
  if (vec_ok && g0 + C <= n) {
#pragma unroll
    for (int i = 0; i < C / 4; ++i)
      reinterpret_cast<float4*>(p + g0)[i] =
          make_float4(vals[4 * i], vals[4 * i + 1], vals[4 * i + 2], vals[4 * i + 3]);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (g0 + c < n) p[g0 + c] = vals[c];
  }
}

// One diagonal's term over the run's two end cells (ENDS) or the cells
// between them: ext[1 + c + O] is t at cell c + O.
template <int O, bool ENDS>
__device__ __forceinline__ void diag_term(const float (&row)[kRegCells], const float (&ext)[kRegCells + 2],
                                          float (&acc)[kRegCells], bool first) {
#pragma unroll
  for (int c = 0; c < kRegCells; ++c) {
    if ((c == 0 || c == kRegCells - 1) != ENDS) continue;
    acc[c] = first ? row[c] * ext[1 + c + O] : fmaf(row[c], ext[1 + c + O], acc[c]);
  }
}

// acc = sum_d D[d] * t[. + off_d], the diagonals in offsets order.
template <int ND, int PAT, bool ENDS>
__device__ __forceinline__ void chain_sum(const float (&D)[ND][kRegCells], const float (&ext)[kRegCells + 2],
                                          float (&acc)[kRegCells]) {
  diag_term<pattern_offset(PAT, 0), ENDS>(D[0], ext, acc, true);
  if constexpr (ND > 1) diag_term<pattern_offset(PAT, 1), ENDS>(D[1], ext, acc, false);
  if constexpr (ND > 2) diag_term<pattern_offset(PAT, 2), ENDS>(D[2], ext, acc, false);
}

// One step's sums for the thread's run `cur`.  ext = [the cell left of the
// run | cur | the cell right of it]: in-warp neighbours by shuffles, the
// warp's outer neighbours through `edge` ([2 parities][kRegWarps][left,
// right]; zeros past the window).  The run's inner cells need only the
// thread's own registers, so they are summed while the shuffles and the
// barrier are in flight; the two end cells follow the barrier.
template <int ND, int PAT>
__device__ __forceinline__ void chain_step(const float (&D)[ND][kRegCells], const float (&cur)[kRegCells],
                                           float (&ext)[kRegCells + 2], float (&acc)[kRegCells], float* edge,
                                           int parity) {
  constexpr int C = kRegCells;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* e = edge + parity * (kRegWarps * 2);
  if (lane == 0) e[warp * 2] = cur[0];
  if (lane == 31) e[warp * 2 + 1] = cur[C - 1];
  ext[0] = __shfl_up_sync(0xffffffffu, cur[C - 1], 1);
  ext[C + 1] = __shfl_down_sync(0xffffffffu, cur[0], 1);
#pragma unroll
  for (int c = 0; c < C; ++c) ext[1 + c] = cur[c];
  chain_sum<ND, PAT, false>(D, ext, acc);
  __syncthreads();  // edges written; the buffer of this parity is next written two steps on
  if (lane == 0) ext[0] = warp > 0 ? e[(warp - 1) * 2 + 1] : 0.f;
  if (lane == 31) ext[C + 1] = warp < kRegWarps - 1 ? e[(warp + 1) * 2] : 0.f;
  chain_sum<ND, PAT, true>(D, ext, acc);
}

template <int ND, int PAT>
__global__ void __launch_bounds__(kRegThreads, 2)
    cheby_chain_reg_kernel(const float* __restrict__ data, const float* __restrict__ t_in,
                           const float* __restrict__ tp_in, float* __restrict__ t_out,
                           float* __restrict__ tp_out, int64_t n, int L, int H, int steps, int first_half,
                           bool vec_ok) {
  constexpr int C = kRegCells;
  __shared__ float edge[2 * kRegWarps * 2];
  const int j0 = threadIdx.x * C;                       // the thread's first window cell
  const int64_t g0 = int64_t(blockIdx.x) * L - H + j0;  // ... and its global index

  float D[ND][C], t[C], tp[C], ext[C + 2], acc[C];
#pragma unroll
  for (int d = 0; d < ND; ++d) load_cells<C>(data + int64_t(d) * n, g0, n, vec_ok, D[d]);
  load_cells<C>(t_in, g0, n, vec_ok, t);
  if (first_half) {
#pragma unroll
    for (int c = 0; c < C; ++c) tp[c] = 0.f;
  } else {
    load_cells<C>(tp_in, g0, n, vec_ok, tp);
  }

  int parity = 0;
  int st = 0;
  if (first_half) {  // t_1 = 0.5 * step(x), t_0 = x
    chain_step<ND, PAT>(D, t, ext, acc, edge, parity);
    parity ^= 1;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      tp[c] = t[c];
      t[c] = 0.5f * acc[c];
    }
    st = 1;
  }
  // Two steps per trip, the arrays trading roles: t_next overwrites t_prev.
  for (; st + 2 <= steps; st += 2) {
    chain_step<ND, PAT>(D, t, ext, acc, edge, parity);
    parity ^= 1;
#pragma unroll
    for (int c = 0; c < C; ++c) tp[c] = acc[c] - tp[c];
    chain_step<ND, PAT>(D, tp, ext, acc, edge, parity);
    parity ^= 1;
#pragma unroll
    for (int c = 0; c < C; ++c) t[c] = acc[c] - t[c];
  }
  if (st < steps) {
    chain_step<ND, PAT>(D, t, ext, acc, edge, parity);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float next = acc[c] - tp[c];
      tp[c] = t[c];
      t[c] = next;
    }
  }

  if (j0 >= H && j0 < H + L) {  // H and L are multiples of C: a run is all core or all halo
    store_cells<C>(t_out, g0, n, vec_ok, t);
    store_cells<C>(tp_out, g0, n, vec_ok, tp);
  }
}

// True when the ND offsets of pattern `pat` differ from one another.
__host__ __device__ constexpr bool distinct_offsets(int pat, int nd) {
  for (int i = 0; i < nd; ++i)
    for (int j = 0; j < i; ++j)
      if (pattern_offset(pat, i) == pattern_offset(pat, j)) return false;
  return true;
}

using RegKernel = void (*)(const float*, const float*, const float*, float*, float*, int64_t, int, int, int, int,
                           bool);

// The kernel of pattern `pat` among the 3**ND patterns of ND rows (null
// when pat is out of range or repeats an offset).
template <int ND, int PAT = 0>
RegKernel reg_kernel(int pat) {
  if constexpr (PAT == pow3(ND)) {
    return nullptr;
  } else if constexpr (distinct_offsets(PAT, ND)) {
    return pat == PAT ? &cheby_chain_reg_kernel<ND, PAT> : reg_kernel<ND, PAT + 1>(pat);
  } else {
    return reg_kernel<ND, PAT + 1>(pat);
  }
}

// The register route's kernel for ndiag rows at distinct `offsets` in [-1, 1].
RegKernel reg_kernel_for(int ndiag, const int* offsets) {
  int pat = 0;
  for (int d = 0; d < ndiag; ++d) {
    if (offsets[d] < -1 || offsets[d] > 1) return nullptr;
    pat += (offsets[d] + 1) * pow3(d);
  }
  switch (ndiag) {
    case 1: return reg_kernel<1>(pat);
    case 2: return reg_kernel<2>(pat);
    case 3: return reg_kernel<3>(pat);
    default: return nullptr;
  }
}

cudaError_t launch_reg(const float* data, const int* offsets, int ndiag, const float* t_in, const float* tp_in,
                       float* t_out, float* tp_out, int64_t n, int L, int H, int steps, int first_half,
                       cudaStream_t stream) {
  const RegKernel kernel = reg_kernel_for(ndiag, offsets);
  if (kernel == nullptr) return cudaErrorInvalidValue;  // the shared-memory route's band
  if (L + 2 * H != kRegThreads * kRegCells || H % kRegCells != 0 || L <= 0) return cudaErrorInvalidValue;
  const int64_t grid = (n + L - 1) / L;
  if (grid > INT_MAX) return cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0; };
  const bool vec_ok = n % 4 == 0 && aligned(data) && aligned(t_in) && (tp_in == nullptr || aligned(tp_in)) &&
                      aligned(t_out) && aligned(tp_out);
  kernel<<<unsigned(grid), kRegThreads, 0, stream>>>(data, t_in, tp_in, t_out, tp_out, n, L, H, steps, first_half,
                                                     vec_ok);
  return cudaGetLastError();
}

// Route 0: registers, 1: shared memory.
cudaError_t cheby_chain(int route, const float* data, const int* offsets, int ndiag, const float* t_in,
                        const float* tp_in, float* t_out, float* tp_out, int64_t n, int w, int L, int H,
                        int steps, int first_half, cudaStream_t stream) {
  if (n <= 0 || ndiag < 1 || ndiag > kMaxDiags || w < 0 || L < 1 || H < 0 || steps < 1)
    return cudaErrorInvalidValue;
  if (int64_t(steps) * w > H) return cudaErrorInvalidValue;  // the core would go stale
  if (!first_half && tp_in == nullptr) return cudaErrorInvalidValue;
  Offsets offs{};
  for (int d = 0; d < ndiag; ++d) {
    if (std::abs(offsets[d]) > w) return cudaErrorInvalidValue;
    offs.v[d] = offsets[d];
  }
  if (route == 1)
    return launch_smem(data, offs, ndiag, t_in, tp_in, t_out, tp_out, n, w, L, H, steps, first_half, stream);
  if (route != 0) return cudaErrorInvalidValue;
  return launch_reg(data, offsets, ndiag, t_in, tp_in, t_out, tp_out, n, L, H, steps, first_half, stream);
}

template <typename K>
cudaError_t kernel_info(K kernel, int threads, size_t dyn_smem, int* out) {
  cudaFuncAttributes a{};
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return e;
  int occ = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads, dyn_smem)) != cudaSuccess) return e;
  const int vals[5] = {a.numRegs, int(a.localSizeBytes), threads, int(a.sharedSizeBytes + dyn_smem), occ};
  for (int i = 0; i < 5; ++i) out[i] = vals[i];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// One launch on `route` (0: registers, 1: shared memory; ops/cheby.py
// plan() chooses): `steps` recurrence steps from (t_in, tp_in) into (t_out,
// tp_out); with first_half set the first step is the half step from t_in
// alone (tp_in is not read and may be null).  `data` is (ndiag, n)
// prescaled rows, `offsets` a host array of ndiag offsets with |off| <= w;
// L is the core per CTA and H >= steps * w the halo (the register route
// takes distinct offsets in [-1, 1] and L + 2H = 256 threads x 16 cells).  `device` is the CUDA
// ordinal the tensors and `stream` belong to (made current here: this
// library has its own runtime).
int lt_cheby_chain_f32(int route, const float* data, const int* offsets, int ndiag, const float* t_in,
                       const float* tp_in, float* t_out, float* tp_out, long long n, int w, int L, int H,
                       int steps, int first_half, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(cheby_chain(route, data, offsets, ndiag, t_in, tp_in, t_out, tp_out, n, w, L, H, steps, first_half,
                         static_cast<cudaStream_t>(stream)));
}

// What the compiler and the occupancy calculator make of the kernel a
// route takes for ndiag rows at `offsets` (a host array) of bandwidth w and
// a window of L + 2H cells:
// out = {registers, local (spill) bytes, threads per CTA, shared memory
// bytes, resident CTAs per SM}.
int lt_cheby_chain_info(int route, const int* offsets, int ndiag, int w, int L, int H, int device, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  if (ndiag < 1 || ndiag > kMaxDiags || w < 0) return int(cudaErrorInvalidValue);
  if (route == 1) {
    const size_t smem = smem_bytes(ndiag, L + 2 * H, w);
    if (smem > kMaxSmem) return int(cudaErrorInvalidValue);
    e = cudaFuncSetAttribute(cheby_chain_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    return int(kernel_info(cheby_chain_smem_kernel, kSmemThreads, smem, out));
  }
  const RegKernel kernel = route == 0 ? reg_kernel_for(ndiag, offsets) : nullptr;
  if (kernel == nullptr) return int(cudaErrorInvalidValue);
  return int(kernel_info(kernel, kRegThreads, 0, out));
}

}  // extern "C"
