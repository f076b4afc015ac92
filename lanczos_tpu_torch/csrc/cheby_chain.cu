// K5: the Chebyshev filter's three-term recurrence chain, time-tiled in
// shared memory.
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
// [0, n) read as zero.
//
// What bounds it on the H100: operations.  Unfused, every step streams the
// iterates and the rows from device memory (about 5 n floats per step); a
// degree-400 apply at n = 2^22 is then ~16 GB of traffic.  This kernel
// keeps a window of the iterates and the rows in shared memory and advances
// it `steps` steps per device-memory round trip (overlapped, trapezoidal
// time tiling):
//   * CTA b owns the core [b L, b L + L) and loads the window
//     [b L - H, b L + L + H) of t, t_prev and every prescaled row into
//     shared memory (zeros outside [0, n));
//   * each step reads t's neighbours at flat shared-memory offsets (the
//     shift is an index, not the TPU's lane and sublane rolls) and writes
//     t_next over t_prev in place: cell j reads only t_prev[j] and t's
//     neighbours of j, so one __syncthreads() per step separates the
//     readers of t from the next step's writers, and the two buffers swap
//     roles;
//   * the window edges go stale by at most w cells a step (w = max |off|);
//     H >= steps * w, so the core is exact and only the core is written
//     back, both t and t_prev, so launches chain;
//   * `steps` is a runtime argument, so the same kernel runs the remainder
//     steps and degree 1 (the Pallas grid is static and leaves both to
//     plain jnp);
//   * plain float32 FMAs on the CUDA cores, no tensor cores, no TF32.
// Device-memory traffic per launch is (2 + ndiag) window reads and 2 core
// writes per cell, so at steps = 128 the HBM side is ~1/100 of the unfused
// chain's; what remains is shared-memory traffic (8 accesses per cell and
// step for three diagonals).  Register-resident iterates, cp.async/TMA
// loads and warp-shuffle shifts are later work.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstdlib>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxDiags = 32;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;  // opt-in dynamic shared memory per block on sm_90

struct Offsets {
  int v[kMaxDiags];
};

// Shared memory of one window of m cells: two iterate buffers with w zero
// cells on each side (the shifted reads at the window edge land there) and
// ndiag prescaled rows.
size_t smem_bytes(int ndiag, int m, int w) {
  return (size_t(2) * (size_t(m) + 2 * size_t(w)) + size_t(ndiag) * size_t(m)) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads, 1)
    cheby_chain_kernel(const float* __restrict__ data, const Offsets offs, int ndiag,
                       const float* __restrict__ t_in, const float* __restrict__ tp_in,
                       float* __restrict__ t_out, float* __restrict__ tp_out, int64_t n, int w,
                       int L, int H, int steps, int first_half) {
  extern __shared__ float smem[];
  const int M = L + 2 * H;
  float* buf0 = smem;                // cell j of the window at buf0[w + j]
  float* buf1 = smem + (M + 2 * w);  // likewise
  float* D = smem + 2 * (M + 2 * w);  // D[d * M + j]: prescaled row d at cell j
  const int64_t base = int64_t(blockIdx.x) * L - H;  // global index of window cell 0

  for (int i = threadIdx.x; i < w; i += kThreads) {
    buf0[i] = 0.f;
    buf0[w + M + i] = 0.f;
    buf1[i] = 0.f;
    buf1[w + M + i] = 0.f;
  }
  for (int j = threadIdx.x; j < M; j += kThreads) {
    const int64_t g = base + j;
    const bool in = g >= 0 && g < n;
    buf0[w + j] = in ? t_in[g] : 0.f;
    buf1[w + j] = (in && !first_half) ? tp_in[g] : 0.f;
  }
  for (int d = 0; d < ndiag; ++d) {
    const float* row = data + int64_t(d) * n;
    for (int j = threadIdx.x; j < M; j += kThreads) {
      const int64_t g = base + j;
      D[d * M + j] = (g >= 0 && g < n) ? row[g] : 0.f;
    }
  }
  __syncthreads();

  float* t = buf0 + w;
  float* tp = buf1 + w;
  for (int st = 0; st < steps; ++st) {
    const bool half = first_half && st == 0;
    for (int j = threadIdx.x; j < M; j += kThreads) {
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

  for (int j = H + threadIdx.x; j < H + L; j += kThreads) {
    const int64_t g = base + j;
    if (g < n) {
      t_out[g] = t[j];
      tp_out[g] = tp[j];
    }
  }
}

cudaError_t cheby_chain(const float* data, const int* offsets, int ndiag, const float* t_in,
                        const float* tp_in, float* t_out, float* tp_out, int64_t n, int w, int L,
                        int H, int steps, int first_half, cudaStream_t stream) {
  if (n <= 0 || ndiag < 1 || ndiag > kMaxDiags || w < 0 || L < 1 || H < 0 || steps < 1)
    return cudaErrorInvalidValue;
  if (int64_t(steps) * w > H || int64_t(L) + 2 * int64_t(H) > INT_MAX / kMaxDiags)
    return cudaErrorInvalidValue;  // the core would go stale, or the window is absurd
  if (!first_half && tp_in == nullptr) return cudaErrorInvalidValue;
  Offsets offs{};
  for (int d = 0; d < ndiag; ++d) {
    if (std::abs(offsets[d]) > w) return cudaErrorInvalidValue;
    offs.v[d] = offsets[d];
  }
  const size_t smem = smem_bytes(ndiag, L + 2 * H, w);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(cheby_chain_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  const int64_t grid = (n + L - 1) / L;
  if (grid > INT_MAX) return cudaErrorInvalidValue;
  cheby_chain_kernel<<<unsigned(grid), kThreads, smem, stream>>>(
      data, offs, ndiag, t_in, tp_in, t_out, tp_out, n, w, L, H, steps, first_half);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch: `steps` recurrence steps from (t_in, tp_in) into (t_out,
// tp_out); with first_half set the first step is the half step from t_in
// alone (tp_in is not read and may be null).  `data` is (ndiag, n) prescaled
// rows, `offsets` a host array of ndiag offsets with |off| <= w; L is the
// core per CTA and H >= steps * w the halo.  `device` is the CUDA ordinal
// the tensors and `stream` belong to (made current here: this library has
// its own runtime).
int lt_cheby_chain_f32(const float* data, const int* offsets, int ndiag, const float* t_in,
                       const float* tp_in, float* t_out, float* tp_out, long long n, int w, int L,
                       int H, int steps, int first_half, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  return int(cheby_chain(data, offsets, ndiag, t_in, tp_in, t_out, tp_out, n, w, L, H, steps,
                         first_half, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
