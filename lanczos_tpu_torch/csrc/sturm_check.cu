// K6: the fused Lanczos engine's convergence check, one launch per check.
//
// Replaces no pallas_call.  In the JAX package the check is XLA ops inside
// the fused engine's device loop: lanczos_tpu/core/tridiagonal.py:322
// extremal_eigenvalues_device (a Sturm multisection), run under lax.cond at
// lanczos_tpu/solvers/lanczos_fused.py:406-423 with the breakdown screen
// and the relative-change test beside it.  PyTorch has no device loop, and
// eagerly the multisection is a few thousand tiny launches, so the port
// ran it on the host CPU; this kernel puts it back on the card.
//
// What it computes, bit for bit what the plain version (core/tridiagonal.py
// extremal_eigenvalues_reference) computes from the same `limit`: `rounds`
// rounds of multisection for each of `nroot` roots, `points` equally spaced
// cuts a round, each cut's Sturm count by the plain version's doubling
// (Hillis-Steele) scan of 2x2 products.  Step s multiplies each row's
// partial product by the one s rows earlier, P[i] <- P[i] P[i-s] for
// i >= s, every product rescaled by its max-abs entry (clamped at the
// smallest normal).  The scan runs over the `size` live rows only: a row
// below `size` reads only rows below it, so the plain version's identity
// rows past `size` never reach a count.  Every product and sum is rounded
// on its own (__fmul_rn, __fadd_rn, ...): an FMA chain would change the
// bits, and at float32's noise floor the bits decide when the check fires.
// torch.maximum, torch.minimum, clamp_min, amin and amax keep their NaN
// semantics.  `limit` and the cut fractions come in as device tensors made
// by the plain version's own torch ops.
//
// In check mode it also takes the decision the host took before: the
// first beta below `breakdown_eps` in [screened, k) stops the build there;
// otherwise the new estimate is tested against `evs` (the previous one) by
// the relative change |new - prev| < min(|new|, |prev|) eps, gated by
// `gate` (a previous estimate exists and eps > 0, both known to the
// host), and replaces it.  out = {stop, itern}, stop 1 for a breakdown
// and 2 for convergence: eight bytes, the only thing the host reads.
//
// What bounds it on the H100: latency.  The work is a few MFLOP, but a
// round is ceil(log2 size) dependent scan steps, each a barrier, and the
// rounds are sequential: 12 x 7 = 84 dependent steps at size 128 in
// float32.  Each cell of a step is ~250 instructions (four IEEE divisions
// among them), so one SM per root is bound by its issue rate: a first
// draft with one CTA per root took 0.2 ms at size 128.  So: a cluster of
// eight CTAs per root (the roots' brackets never meet), each CTA with
// every eighth cut; a CTA's cuts x `size` column of products in shared
// memory (two copies of the four entries, read one step and written the
// next) when it fits, else in global scratch that stays in L2
// (ops/sturm_check.py plan); one CTA barrier a step; counts by shared
// atomics (integers: any order gives the same sum), handed to every CTA
// of the cluster through distributed shared memory with one cluster
// barrier a round; and the bracket update on one thread of each CTA, the
// same in all eight.  The decision needs every root: the cluster that
// finishes last (a ticket counter it resets) takes it.
#include <cooperative_groups.h>

#include <cfloat>
#include <climits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxPoints = 64;
constexpr int kCluster = 8;  // CTAs of one root, each with a share of its cuts (a portable cluster)
constexpr int kMaxDevices = 64;

enum Mode { kEvsOnly = 0, kCheck = 1, kScreenOnly = 2 };

// Each operation rounded on its own: no FMA contraction.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float abs_(float a) { return fabsf(a); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double abs_(double a) { return fabs(a); }

template <typename T>
struct Lim;
template <>
struct Lim<float> {
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
};
template <>
struct Lim<double> {
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
};

// torch.maximum / torch.minimum: NaN when either operand is NaN.
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? b : a;
}

// float32 in one instruction (sm_80+).  Only the NaN-ness of a NaN result
// matters: a NaN scale makes every entry it divides NaN.
template <>
__device__ __forceinline__ float max_nan<float>(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

template <typename T>
__device__ __forceinline__ int sign_(T x) {
  return (T(0) < x) - (x < T(0));  // torch.sign; 0 for NaN
}

template <typename T>
struct Args {
  const T* alpha;    // (>= size,) diagonal
  const T* beta;     // (>= max(size - 1, k),) off-diagonal
  const T* limit;    // 0-d: the Gershgorin-style bound
  const T* fracs;    // (points,) cut fractions
  T* evs;            // (nroot,): the output (evs-only mode) or the previous estimate, replaced (check mode)
  T* evs_new;        // (nroot,) scratch of check mode
  int* out;          // (2,) {stop (0, 1 breakdown, 2 converged), itern} (check and screen modes)
  int* ticket;       // one counter, 0 between launches (check mode)
  T* gbuf;           // global scratch of 8 values a cell for every CTA, or null: shared memory
  int size, nroot, find_maximum, rounds, points, screened, k, gate, mode;
  T breakdown_eps, eps;
};

template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kMaxThreads)
    sturm_check_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T s_pts[kMaxPoints];
  __shared__ int s_loc[kMaxPoints];        // this CTA's counts of its own cuts
  __shared__ int s_cnt[2][kMaxPoints];     // every cut's count, by round parity (written by the cluster)
  __shared__ T s_lower, s_upper;
  __shared__ int s_flag;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int rank = int(cluster.block_rank());  // this CTA's share of the cuts
  const int r = blockIdx.x / kCluster;          // the root

  if (a.mode != kEvsOnly) {
    // The breakdown screen, in every CTA (a few betas): a breakdown skips
    // the multisection in the whole grid.
    if (tid == 0) s_flag = INT_MAX;
    __syncthreads();
    for (int i = a.screened + tid; i < a.k; i += nthr)
      if (a.beta[i] < a.breakdown_eps) atomicMin(&s_flag, i);
    __syncthreads();
    const int broke = s_flag;
    if (broke != INT_MAX || a.mode == kScreenOnly) {
      if (blockIdx.x == 0 && tid == 0) {
        a.out[0] = broke != INT_MAX;
        a.out[1] = broke != INT_MAX ? broke + 1 : 0;
      }
      return;
    }
  }

  const int n = a.size;
  const int P = a.points;
  // This CTA's cuts: p = rank, rank + kCluster, ... (local index lp).
  const int own = rank < P ? (P - rank + kCluster - 1) / kCluster : 0;
  const int cells = ((P + kCluster - 1) / kCluster) * n;  // the column of the CTA with the most cuts
  // Threads as (cut lane, row lane): rows i = tx, tx + R, ...; local cuts
  // lp = ty, ty + Q, ... (no division in the loops).  The threads past
  // the Q whole lanes of R rows take no cell.
  const int R = min(n, nthr);
  const int Q = nthr / R;
  const int tx = tid % R;
  const int ty = tid / R < Q ? tid / R : kMaxPoints;
  T* buf = a.gbuf != nullptr ? a.gbuf + size_t(blockIdx.x) * 8 * cells : reinterpret_cast<T*>(smem_raw);
  T *ca = buf, *cb = buf + cells, *cc = buf + 2 * cells, *cd = buf + 3 * cells;
  T *na = buf + 4 * cells, *nb = buf + 5 * cells, *nc = buf + 6 * cells, *nd = buf + 7 * cells;
  const int m_index = a.find_maximum ? max(n - 1 - r, 0) : min(r, n - 1);
  const T tiny = Lim<T>::tiny();

  if (tid == 0) {
    const T lim = *a.limit;
    s_lower = -lim;
    s_upper = lim;
  }
  __syncthreads();
  for (int round = 0; round < a.rounds; ++round) {
    const int parity = round & 1;
    if (tid < P) {  // every CTA makes all the cuts, the same ones
      const T lo = s_lower, up = s_upper;
      const T pt = add_rn(lo, mul_rn(a.fracs[tid], sub_rn(up, lo)));
      s_pts[tid] = min_nan(max_nan(pt, lo), up);
      s_loc[tid] = 0;
    }
    __syncthreads();
    // Row i's matrix [[alpha_i - c, -beta_{i-1}^2], [1, 0]] (row 0: -0).
    for (int lp = ty; lp < own; lp += Q) {
      const T c = s_pts[rank + lp * kCluster];
      for (int i = tx; i < n; i += R) {
        const int e = lp * n + i;
        ca[e] = sub_rn(a.alpha[i], c);
        const T bm = i > 0 ? a.beta[i - 1] : T(0);
        cb[e] = -(i > 0 ? mul_rn(bm, bm) : T(0));
        cc[e] = T(1);
        cd[e] = T(0);
      }
    }
    __syncthreads();
    for (int s = 1; s < n; s <<= 1) {
      for (int lp = ty; lp < own; lp += Q) {
        for (int i = tx; i < n; i += R) {
          const int e = lp * n + i;
          if (i >= s) {
            // z = y x, y the later partial product, x the one s rows earlier.
            const T ya = ca[e], yb = cb[e], yc = cc[e], yd = cd[e];
            const T xa = ca[e - s], xb = cb[e - s], xc = cc[e - s], xd = cd[e - s];
            const T za = add_rn(mul_rn(ya, xa), mul_rn(yb, xc));
            const T zb = add_rn(mul_rn(ya, xb), mul_rn(yb, xd));
            const T zc = add_rn(mul_rn(yc, xa), mul_rn(yd, xc));
            const T zd = add_rn(mul_rn(yc, xb), mul_rn(yd, xd));
            T sc = max_nan(max_nan(abs_(za), abs_(zb)), max_nan(abs_(zc), abs_(zd)));
            sc = sc != sc ? sc : (sc < tiny ? tiny : sc);  // clamp_min(tiny), NaN kept
            na[e] = div_rn(za, sc);
            nb[e] = div_rn(zb, sc);
            nc[e] = div_rn(zc, sc);
            nd[e] = div_rn(zd, sc);
          } else {
            na[e] = ca[e];
            nb[e] = cb[e];
            nc[e] = cc[e];
            nd[e] = cd[e];
          }
        }
      }
      __syncthreads();
      T* t;
      t = ca, ca = na, na = t;
      t = cb, cb = nb, nb = t;
      t = cc, cc = nc, nc = t;
      t = cd, cd = nd, nd = t;
    }
    // [d_k, d_{k-1}] = P_k [1, 0]^T = [a, c]: a sign change of the minors
    // counts; a zero (or NaN) previous minor counts as positive.
    for (int lp = ty; lp < own; lp += Q) {
      int count = 0;
      for (int i = tx; i < n; i += R) {
        const int s_a = sign_(ca[lp * n + i]);
        int s_c = sign_(cc[lp * n + i]);
        if (s_c == 0) s_c = 1;
        count += s_a * s_c < 0;
      }
      if (count) atomicAdd(&s_loc[lp], count);
    }
    __syncthreads();
    // Each CTA hands its cuts' counts to every CTA of the cluster; the
    // parity keeps a round's writes off the counts the last round read.
    if (tid < own * kCluster) {
      const int lp = tid / kCluster, q = tid % kCluster;
      int* dst = cluster.map_shared_rank(&s_cnt[parity][0], q);
      dst[rank + lp * kCluster] = s_loc[lp];
    }
    cluster.sync();
    if (tid == 0) {
      // Counts are monotone in the cut: the smallest cut at or above the
      // root is the new upper end, the largest below it the new lower end
      // (the same in every CTA of the cluster).
      const T lo = s_lower, up = s_upper;
      T new_up = up, new_lo = lo;
      for (int p = 0; p < P; ++p) {
        const bool ge = s_cnt[parity][p] >= m_index + 1;
        const T u = ge ? s_pts[p] : up;
        const T l = ge ? lo : s_pts[p];
        new_up = p == 0 ? u : min_nan(new_up, u);
        new_lo = p == 0 ? l : max_nan(new_lo, l);
      }
      s_upper = new_up;
      s_lower = new_lo;
    }
    __syncthreads();
  }

  if (rank != 0) return;
  if (a.mode == kEvsOnly) {
    if (tid == 0) a.evs[r] = s_lower;
    return;
  }
  if (tid == 0) {
    a.evs_new[r] = s_lower;
    __threadfence();
    s_flag = atomicAdd(a.ticket, 1) == a.nroot - 1;
  }
  __syncthreads();
  if (s_flag == 0 || tid != 0) return;
  // The last cluster: every root's estimate is in evs_new.
  __threadfence();
  bool ok = true;
  for (int q = 0; q < a.nroot; ++q) {
    const T ev = __ldcg(a.evs_new + q);
    const T prev = a.evs[q];
    ok = ok && abs_(sub_rn(ev, prev)) < mul_rn(min_nan(abs_(ev), abs_(prev)), a.eps);
  }
  for (int q = 0; q < a.nroot; ++q) a.evs[q] = __ldcg(a.evs_new + q);
  const bool converged = a.gate && ok;
  a.out[0] = converged ? 2 : 0;
  a.out[1] = converged ? a.k : 0;
  *a.ticket = 0;
}

int g_smem_set[2][kMaxDevices];  // dynamic shared bytes allowed so far, per dtype and device

template <typename T>
cudaError_t sturm_check(Args<T> a, int threads, int smem_bytes, int device, cudaStream_t stream) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (a.mode < kEvsOnly || a.mode > kScreenOnly || threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      smem_bytes < 0)
    return cudaErrorInvalidValue;
  cudaError_t e = lt::make_current(device);
  if (e != cudaSuccess) return e;
  if (a.mode == kScreenOnly) {
    if (a.out == nullptr || a.beta == nullptr || a.screened < 0) return cudaErrorInvalidValue;
    sturm_check_kernel<T><<<kCluster, threads, 0, stream>>>(a);  // one cluster
    return cudaGetLastError();
  }
  const int per_cta = (a.points + kCluster - 1) / kCluster;  // cuts of the CTA with the most
  const long long cells = (long long)per_cta * a.size;
  if (a.size < 1 || a.nroot < 1 || a.nroot > INT_MAX / kCluster || a.points < 1 || a.points > kMaxPoints ||
      a.points > threads || per_cta * kCluster > threads || a.rounds < 0 || cells > INT_MAX / 8)
    return cudaErrorInvalidValue;
  if (a.gbuf == nullptr && (long long)smem_bytes < 8 * cells * (long long)sizeof(T)) return cudaErrorInvalidValue;
  if (a.mode == kCheck && (a.out == nullptr || a.ticket == nullptr || a.evs_new == nullptr || a.screened < 0))
    return cudaErrorInvalidValue;
  // Opt in to every size past the last one allowed: the default 48 KB
  // covers dynamic and static shared memory together.
  int& allowed = g_smem_set[sizeof(T) == 8][device];
  if (smem_bytes > allowed) {
    e = cudaFuncSetAttribute(sturm_check_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
    allowed = smem_bytes;
  }
  sturm_check_kernel<T><<<a.nroot * kCluster, threads, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int entry(const T* alpha, const T* beta, const T* limit, const T* fracs, T* evs, T* evs_new, int* out, int* ticket,
          T* gbuf, int size, int nroot, int find_maximum, int rounds, int points, int screened, int k,
          double breakdown_eps, double eps, int gate, int mode, int threads, int smem_bytes, int device,
          void* stream) {
  Args<T> a{alpha, beta, limit, fracs, evs, evs_new, out, ticket, gbuf, size, nroot, find_maximum, rounds, points,
            screened, k, gate, mode, T(breakdown_eps), T(eps)};
  return int(sturm_check<T>(a, threads, smem_bytes, device, static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// One check (ops/sturm_check.py says what each argument is).  `mode` 0:
// the multisection alone, into evs; 1: screen, multisection and decision
// (evs is the previous estimate, replaced; out = {stop, itern}); 2: the
// breakdown screen alone (eps == 0).  `gbuf` null selects the
// shared-memory route, which needs `smem_bytes` >= 8 ceil(points / 8)
// size sizeof(T).  The grid is eight CTAs (one cluster) per root.  Breakdown_eps and eps are rounded to the buffers' type, as
// a comparison with a Python float is in PyTorch.  `device` is the CUDA
// ordinal the tensors and `stream` belong to.
int lt_sturm_check_f32(const float* alpha, const float* beta, const float* limit, const float* fracs, float* evs,
                       float* evs_new, int* out, int* ticket, float* gbuf, int size, int nroot, int find_maximum,
                       int rounds, int points, int screened, int k, double breakdown_eps, double eps, int gate,
                       int mode, int threads, int smem_bytes, int device, void* stream) {
  return entry<float>(alpha, beta, limit, fracs, evs, evs_new, out, ticket, gbuf, size, nroot, find_maximum, rounds,
                      points, screened, k, breakdown_eps, eps, gate, mode, threads, smem_bytes, device, stream);
}

int lt_sturm_check_f64(const double* alpha, const double* beta, const double* limit, const double* fracs,
                       double* evs, double* evs_new, int* out, int* ticket, double* gbuf, int size, int nroot,
                       int find_maximum, int rounds, int points, int screened, int k, double breakdown_eps,
                       double eps, int gate, int mode, int threads, int smem_bytes, int device, void* stream) {
  return entry<double>(alpha, beta, limit, fracs, evs, evs_new, out, ticket, gbuf, size, nroot, find_maximum,
                       rounds, points, screened, k, breakdown_eps, eps, gate, mode, threads, smem_bytes, device,
                       stream);
}

}  // extern "C"
