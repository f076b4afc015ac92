// E2a: one block-MGS pass of v against rows [0, k) of a (cap, n) basis B,
// in chunks of `chunk` rows taken in order: for each chunk [c0, c1),
//   c = B[c0:c1] v   (against the current v),   v <- v - c^T B[c0:c1].
// E2b, the classical pass in a single drain, is its one-chunk case
// (chunk = k): every coefficient against the original v, then one update.
//
// Replaces two Pallas TPU kernels: experiments/pallas_bcgs_kernel.py
// make_pass (v1, kernel _kernel), whose chunks are a sequential grid
// dimension, and experiments/pallas_bcgs_kernel2.py make_pass (v2), whose
// projection and update phases are.  On the H100 the pass is ONE
// cooperative launch with one grid barrier per chunk: a persistent grid of
// `grid` CTAs (two per SM), each owning one contiguous range of `cols`
// columns of v for the whole pass (the plan in
// experiments/_cgs_variants.py mgs_plan: ceil(n / grid) rounded to 128
// bytes), so every CTA streams the same bytes in every phase.
//
// What bounds it on the H100: bytes.  A pass reads the k live rows twice
// (2 k n values: the projection and the update of each chunk; a 64-row
// chunk at n = 2^22 is 1 GB, against 50 MB of L2 and ~30 MB of shared
// memory, so no one-read form exists) and does 2 FMAs per value read.  The
// floor is the two-read stream (K4 reaches 0.97 of it with the same ring).
// The design keeps the stream busy through the grid barriers:
//   * v's range lives on chip for the whole pass, in shared memory (route
//     "smem": read once at the start, written once at the end) where the
//     plan finds room for it beside the ring at two CTAs per SM; otherwise
//     (route "l2", f64 at the study's width or a very wide f32 basis) it
//     stays in global memory and is read and written at L2 (__ldcg /
//     __stcg).  Each consumer thread owns the same 16-byte vectors of the
//     range in both phases, so v needs no barrier of its own;
//   * one producer warp streams the chunk's row segments of the range
//     through a ring of `stages` shared-memory stages of `piece` columns
//     (ring.cuh, shared with K4: 1-D bulk copies on 128-byte aligned
//     segments, mbarriers, the proxy fence before each refill, element
//     cp.async for ragged n).  Its sequence does not depend on any
//     coefficient, so it runs on into the update's rows and the next
//     chunk's rows while the consumers wait at the grid barrier;
//   * the projection walks each row's pieces in order; a consumer thread
//     keeps its partial dot product over the whole range, and each
//     (row, CTA) is warp-reduced once and written once, eight rows to one
//     barrier of the consumer warps; the partials of row j sit in
//     part[j * grid + cta], a slot no other chunk touches;
//   * the grid barrier is the consumers' alone: they meet at a named
//     barrier and one thread per CTA adds to a global arrive-counter and
//     waits for grid * (chunks so far).  The cooperative launch guarantees
//     that every CTA is resident;
//   * after the barrier every CTA sums each row's partials in the same
//     fixed order (the same bits in every CTA, no atomics), stages up to
//     kCoefRows coefficients in shared memory, and updates its range piece
//     by piece, each piece of v held in registers over the staged rows.  A
//     chunk of more than kCoefRows rows (E2b at k > 512) is staged and
//     applied in rounds after its one barrier, in the producer's order.
// Plain FMAs in the storage precision, no tensor cores, no atomics in any
// sum: a pass gives the same bits on every run.
#include "common.cuh"
#include "ring.cuh"

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;  // threads that compute
constexpr int kThreads = kConsumers + 32;         // and one producer warp
constexpr int kConsumerBarrier = 1;               // named barrier of the consumer warps
constexpr int kRowGroup = 8;                      // projection: rows per reduction round
constexpr int kCoefRows = 512;                    // update: coefficients staged at a time
constexpr int kNV = 4;                            // 16-byte vectors per consumer thread and piece
constexpr int kMinStages = 2;
constexpr int kMaxStages = 8;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ void consumer_sync() { lt::bar_sync<kConsumerBarrier, kConsumers>(); }

// [ring: stages x piece T][v: cols T when resident][full, empty: stages
// mbarriers each][red: 2 x warps x kRowGroup A][cs: kCoefRows A]
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int cols, int piece, int stages, bool resident) {
  using A = typename lt::Acc<T>::type;
  return size_t(stages) * piece * sizeof(T) + (resident ? size_t(cols) * sizeof(T) : 0) +
         size_t(2) * stages * sizeof(uint64_t) + (size_t(2) * kConsumerWarps * kRowGroup + kCoefRows) * sizeof(A);
}

// Vector `gv` of the CTA's range of v (range-local vector index; the range
// starts at column c0 and holds cols_here values).  Resident: shared
// memory.  Otherwise global memory at L2, element by element where the
// rows are not 16-byte aligned; values past the range read as zero.
template <typename T, bool kResident>
__device__ __forceinline__ void load_v(const T* vs, const T* v, int64_t c0, int cols_here, int gv, bool vec_ok,
                                       T (&out)[lt::Vec<T>::n]) {
  using V = typename lt::Vec<T>::type;
  constexpr int VN = lt::Vec<T>::n;
  const int e0 = gv * VN;  // first column of the vector in the range
  if (kResident) {
    const V t = reinterpret_cast<const V*>(vs)[gv];
    const T* tt = reinterpret_cast<const T*>(&t);
#pragma unroll
    for (int c = 0; c < VN; ++c) out[c] = tt[c];
  } else if (vec_ok) {
    V t;
    if (e0 < cols_here) {
      t = __ldcg(reinterpret_cast<const V*>(v + c0 + e0));
    } else {
      T* tt = reinterpret_cast<T*>(&t);
#pragma unroll
      for (int c = 0; c < VN; ++c) tt[c] = T(0);
    }
    const T* tt = reinterpret_cast<const T*>(&t);
#pragma unroll
    for (int c = 0; c < VN; ++c) out[c] = tt[c];
  } else {
#pragma unroll
    for (int c = 0; c < VN; ++c) out[c] = e0 + c < cols_here ? __ldcg(v + c0 + e0 + c) : T(0);
  }
}

template <typename T, bool kResident, typename A>
__device__ __forceinline__ void store_v(T* vs, T* v, int64_t c0, int cols_here, int gv, bool vec_ok,
                                        const A (&vals)[lt::Vec<T>::n]) {
  using V = typename lt::Vec<T>::type;
  constexpr int VN = lt::Vec<T>::n;
  const int e0 = gv * VN;
  V t;
  T* tt = reinterpret_cast<T*>(&t);
#pragma unroll
  for (int c = 0; c < VN; ++c) tt[c] = T(vals[c]);
  if (kResident) {
    reinterpret_cast<V*>(vs)[gv] = t;
  } else if (vec_ok) {
    if (e0 < cols_here) __stcg(reinterpret_cast<V*>(v + c0 + e0), t);
  } else {
#pragma unroll
    for (int c = 0; c < VN; ++c)
      if (e0 + c < cols_here) __stcg(v + c0 + e0 + c, tt[c]);
  }
}

// v's range between global memory and its resident copy (thread-owned
// vectors, no barrier needed).
template <typename T>
__device__ __forceinline__ void copy_range_in(T* vs, const T* v, int64_t c0, int cols_here, bool vec_ok) {
  constexpr int VN = lt::Vec<T>::n;
  const int nvec = (cols_here + VN - 1) / VN;
  for (int gv = threadIdx.x; gv < nvec; gv += kConsumers) {
    T t[VN];
    load_v<T, false>(nullptr, v, c0, cols_here, gv, vec_ok, t);
    store_v<T, true, T>(vs, nullptr, c0, cols_here, gv, vec_ok, t);
  }
}

template <typename T>
__device__ __forceinline__ void copy_range_out(const T* vs, T* v, int64_t c0, int cols_here, bool vec_ok) {
  constexpr int VN = lt::Vec<T>::n;
  const int nvec = (cols_here + VN - 1) / VN;
  for (int gv = threadIdx.x; gv < nvec; gv += kConsumers) {
    T t[VN];
    load_v<T, true>(vs, nullptr, c0, cols_here, gv, vec_ok, t);
    store_v<T, false, T>(nullptr, v, c0, cols_here, gv, vec_ok, t);
  }
}

// The consumers' grid barrier: every consumer of this CTA is past its
// writes, one thread publishes the arrival and waits until all `target`
// arrivals of this and the earlier barriers are in.
__device__ __forceinline__ void grid_barrier(unsigned int* arrived, unsigned int target) {
  consumer_sync();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrived, 1u);
    unsigned int seen = 0;
    while (true) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(arrived) : "memory");
      if (seen >= target) break;
      __nanosleep(32);
    }
    __threadfence();
  }
  consumer_sync();
}

// The ring position shared by producer and consumers.
struct RingPos {
  int s = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++s == stages) {
      s = 0;
      phase ^= 1u;
    }
  }
};

struct Range {
  int64_t c0;     // first column
  int cols_here;  // columns of this CTA (the last CTA's may be fewer)
  int piece;      // columns per segment
  int npieces;
  __device__ __forceinline__ int piece_cols(int p) const { return min(piece, cols_here - p * piece); }
};

// The producer warp: every segment the consumers will read, in their order.
template <typename T>
__device__ __forceinline__ void produce(const T* __restrict__ basis, int64_t n, int k, int chunk,
                                        const Range& r, int stages, T* ring, uint64_t* full, uint64_t* empty,
                                        bool bulk) {
  constexpr int VN = lt::Vec<T>::n;
  RingPos pos;
  auto issue = [&](int j, int p) {
    lt::mbar_wait(&empty[pos.s], pos.phase ^ 1u);
    lt::proxy_fence();  // the consumers' reads of this stage before the async copy's writes
    const int pc = r.piece_cols(p);
    lt::issue_segment<T>(ring + size_t(pos.s) * r.piece, basis + int64_t(j) * n + r.c0 + int64_t(p) * r.piece, pc,
                         (pc + VN - 1) / VN * VN, bulk, &full[pos.s]);
    pos.next(stages);
  };
  for (int c0 = 0; c0 < k; c0 += chunk) {
    const int c1 = min(c0 + chunk, k);
    for (int j = c0; j < c1; ++j)  // projection: row by row
      for (int p = 0; p < r.npieces; ++p) issue(j, p);
    for (int s0 = c0; s0 < c1; s0 += kCoefRows) {  // update: piece by piece over the staged rows
      const int s1 = min(s0 + kCoefRows, c1);
      for (int p = 0; p < r.npieces; ++p)
        for (int j = s0; j < s1; ++j) issue(j, p);
    }
  }
}

template <typename T, bool kResident>
__global__ void __launch_bounds__(kThreads, 2)
    bcgs_ring_kernel(const T* __restrict__ basis, T* v, typename lt::Acc<T>::type* part, unsigned int* arrived,
                     int64_t n, int k, int chunk, int cols, int piece, int stages, bool vec_ok) {
  using A = typename lt::Acc<T>::type;
  using V = typename lt::Vec<T>::type;
  constexpr int VN = lt::Vec<T>::n;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  T* vs = ring + size_t(stages) * piece;  // v's range, when resident
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(vs) +
                                               (kResident ? size_t(cols) * sizeof(T) : 0));
  uint64_t* empty = full + stages;
  A* red = reinterpret_cast<A*>(empty + stages);  // [2][kConsumerWarps][kRowGroup]
  A* cs = red + 2 * kConsumerWarps * kRowGroup;   // [kCoefRows]
  const unsigned int G = gridDim.x;
  Range r;
  r.c0 = int64_t(blockIdx.x) * cols;
  r.cols_here = n - r.c0 < cols ? int(n - r.c0) : cols;
  r.piece = piece;
  r.npieces = (r.cols_here + piece - 1) / piece;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pvecs_full = piece / VN;

  lt::init_ring(full, empty, stages, vec_ok, kConsumerWarps);
  if (warp == kConsumerWarps) {
    produce<T>(basis, n, k, chunk, r, stages, ring, full, empty, vec_ok);
    return;
  }
  if (kResident) copy_range_in<T>(vs, v, r.c0, r.cols_here, vec_ok);

  RingPos pos;
  int g = 0;  // red's half, by the parity of row groups over the whole pass
  unsigned int barriers = 0;
  for (int c0 = 0; c0 < k; c0 += chunk) {
    const int c1 = min(c0 + chunk, k);

    // 1. this CTA's partial coefficients of rows [c0, c1) over its range.
    for (int j0 = c0; j0 < c1; j0 += kRowGroup, g ^= 1) {
      const int rows = min(kRowGroup, c1 - j0);
      A* red_g = red + g * (kConsumerWarps * kRowGroup);
      for (int q = 0; q < rows; ++q) {
        A acc = A(0);
        for (int p = 0; p < r.npieces; ++p) {
          const int pvecs = (r.piece_cols(p) + VN - 1) / VN;
          lt::mbar_wait(&full[pos.s], pos.phase);
          const T* seg = ring + size_t(pos.s) * piece;
#pragma unroll
          for (int i = 0; i < kNV; ++i) {
            const int iv = threadIdx.x + i * kConsumers;
            if (iv < pvecs) {
              const V x = reinterpret_cast<const V*>(seg)[iv];
              const T* xx = reinterpret_cast<const T*>(&x);
              T vv[VN];
              load_v<T, kResident>(vs, v, r.c0, r.cols_here, p * pvecs_full + iv, vec_ok, vv);
#pragma unroll
              for (int c = 0; c < VN; ++c) acc = fma(A(xx[c]), A(vv[c]), acc);
            }
          }
          lt::proxy_fence();  // this stage's reads before the refill's writes (async proxy)
          __syncwarp();
          if (lane == 0) lt::mbar_arrive(&empty[pos.s]);
          pos.next(stages);
        }
        const A w = lt::warp_sum(acc);
        if (lane == 0) red_g[warp * kRowGroup + q] = w;
      }
      // red is double-buffered by group parity: the next group writes the
      // other half, and the one after it passes this barrier first.
      consumer_sync();
      if (threadIdx.x < rows) {
        A tot = A(0);
#pragma unroll
        for (int w = 0; w < kConsumerWarps; ++w) tot += red_g[w * kRowGroup + threadIdx.x];
        part[int64_t(j0 + threadIdx.x) * G + blockIdx.x] = tot;
      }
    }

    // 2. every CTA's partials of the chunk are in.
    grid_barrier(arrived, G * ++barriers);

    // 3. the coefficients, kCoefRows at a time, each summed over the CTAs
    //    in a fixed order, and the update of this CTA's range.
    for (int s0 = c0; s0 < c1; s0 += kCoefRows) {
      const int ns = min(kCoefRows, c1 - s0);
      consumer_sync();  // the previous stage's readers are done with cs
      for (int q = warp; q < ns; q += kConsumerWarps) {
        const A* pr = part + int64_t(s0 + q) * G;
        A acc = A(0);
#pragma unroll 4
        for (unsigned int t = lane; t < G; t += 32) acc += __ldcg(pr + t);
        acc = lt::warp_sum(acc);
        if (lane == 0) cs[q] = acc;
      }
      consumer_sync();
      for (int p = 0; p < r.npieces; ++p) {
        const int pvecs = (r.piece_cols(p) + VN - 1) / VN;
        A acc[kNV][VN];
#pragma unroll
        for (int i = 0; i < kNV; ++i) {
          const int iv = threadIdx.x + i * kConsumers;
          T t[VN];
          if (iv < pvecs) {
            load_v<T, kResident>(vs, v, r.c0, r.cols_here, p * pvecs_full + iv, vec_ok, t);
          } else {
#pragma unroll
            for (int c = 0; c < VN; ++c) t[c] = T(0);
          }
#pragma unroll
          for (int c = 0; c < VN; ++c) acc[i][c] = A(t[c]);
        }
        for (int q = 0; q < ns; ++q) {
          lt::mbar_wait(&full[pos.s], pos.phase);
          const T* seg = ring + size_t(pos.s) * piece;
          const A cq = cs[q];
#pragma unroll
          for (int i = 0; i < kNV; ++i) {
            const int iv = threadIdx.x + i * kConsumers;
            if (iv < pvecs) {
              const V x = reinterpret_cast<const V*>(seg)[iv];
              const T* xx = reinterpret_cast<const T*>(&x);
#pragma unroll
              for (int c = 0; c < VN; ++c) acc[i][c] = fma(-cq, A(xx[c]), acc[i][c]);
            }
          }
          lt::proxy_fence();
          __syncwarp();
          if (lane == 0) lt::mbar_arrive(&empty[pos.s]);
          pos.next(stages);
        }
#pragma unroll
        for (int i = 0; i < kNV; ++i) {
          const int iv = threadIdx.x + i * kConsumers;
          if (iv < pvecs) store_v<T, kResident, A>(vs, v, r.c0, r.cols_here, p * pvecs_full + iv, vec_ok, acc[i]);
        }
      }
    }
  }
  if (kResident) copy_range_out<T>(vs, v, r.c0, r.cols_here, vec_ok);
}

// ---- host side -----------------------------------------------------------------

template <typename T>
cudaError_t check_plan(int64_t n, int cols, int piece, int stages, bool resident) {
  constexpr int VN = lt::Vec<T>::n;
  if (cols < VN || cols % VN != 0 || piece < VN || piece % VN != 0 || piece > cols) return cudaErrorInvalidValue;
  if (piece / VN > kNV * kConsumers) return cudaErrorInvalidValue;
  if (stages < kMinStages || stages > kMaxStages) return cudaErrorInvalidValue;
  if (smem_bytes<T>(cols, piece, stages, resident) > kMaxSmem) return cudaErrorInvalidValue;
  if ((n + cols - 1) / cols > INT32_MAX) return cudaErrorInvalidValue;
  return cudaSuccess;
}

constexpr int kMaxDevices = 64;

// Dynamic shared memory past 48 KB is opt-in per kernel and device; the
// carveout asks for the whole of the SM's 228 KB so two CTAs fit.  Each
// setting only grows, so a call asks the runtime only when it needs more
// on the current device.
template <typename T, bool kResident>
cudaError_t allow_smem(size_t bytes) {
  static size_t allowed[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= allowed[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(bcgs_ring_kernel<T, kResident>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(bcgs_ring_kernel<T, kResident>, cudaFuncAttributePreferredSharedMemoryCarveout,
                           int(cudaSharedmemCarveoutMaxShared));
  if (e == cudaSuccess) allowed[dev] = bytes;
  return e;
}

template <typename T, bool kResident>
cudaError_t launch(const T* basis, T* v, typename lt::Acc<T>::type* part, unsigned int* arrived, int64_t n, int k,
                   int chunk, int cols, int piece, int stages, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(cols, piece, stages, kResident);
  cudaError_t e = allow_smem<T, kResident>(smem);
  if (e != cudaSuccess) return e;
  if ((e = cudaMemsetAsync(arrived, 0, sizeof(unsigned int), stream)) != cudaSuccess) return e;
  const unsigned grid = unsigned((n + cols - 1) / cols);
  // Row j of the basis starts at j*n: 16-byte aligned for every j only when
  // n is a multiple of the vector width.
  bool vec_ok = n % lt::Vec<T>::n == 0 && lt::aligned16(basis) && lt::aligned16(v);
  void* args[] = {&basis, &v, &part, &arrived, &n, &k, &chunk, &cols, &piece, &stages, &vec_ok};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(bcgs_ring_kernel<T, kResident>), dim3(grid),
                                  dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t bcgs_pass(const T* basis, T* v, typename lt::Acc<T>::type* part, unsigned int* arrived, int64_t n,
                      int k, int chunk, int cols, int piece, int stages, bool resident, cudaStream_t stream) {
  if (n <= 0 || k < 0 || chunk < 1) return cudaErrorInvalidValue;
  cudaError_t e = check_plan<T>(n, cols, piece, stages, resident);
  if (e != cudaSuccess) return e;
  if (k == 0) return cudaSuccess;
  return resident ? launch<T, true>(basis, v, part, arrived, n, k, chunk, cols, piece, stages, stream)
                  : launch<T, false>(basis, v, part, arrived, n, k, chunk, cols, piece, stages, stream);
}

// out = {registers, local bytes, smem bytes, CTAs per SM}.
template <typename T, bool kResident>
cudaError_t info(int cols, int piece, int stages, int* out) {
  const size_t smem = smem_bytes<T>(cols, piece, stages, kResident);
  cudaError_t e = allow_smem<T, kResident>(smem);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes a{};
  if ((e = cudaFuncGetAttributes(&a, bcgs_ring_kernel<T, kResident>)) != cudaSuccess) return e;
  int occ = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, bcgs_ring_kernel<T, kResident>, kThreads, smem);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = int(a.localSizeBytes);
  out[2] = int(smem);
  out[3] = occ;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// One pass.  `cols` (the range per CTA), `piece` (columns per ring stage),
// `stages` and `resident` (v's range in shared memory) come from the
// wrapper's plan (experiments/_cgs_variants.py mgs_plan); the grid is
// ceil(n / cols).  `part` holds k * grid partial sums, `arrived` one
// counter, zeroed here on `stream` before the launch.  `device` is the CUDA ordinal the tensors and `stream`
// belong to (made current here if it is not: this library has its own
// runtime).
int lt_bcgs_ring_f32(const float* basis, float* v, float* part, unsigned int* arrived, long long n, int k, int chunk,
                     int cols, int piece, int stages, int resident, int device, void* stream) {
  cudaError_t e = lt::make_current(device);
  if (e != cudaSuccess) return int(e);
  return int(bcgs_pass<float>(basis, v, part, arrived, n, k, chunk, cols, piece, stages, resident != 0,
                              static_cast<cudaStream_t>(stream)));
}

int lt_bcgs_ring_f64(const double* basis, double* v, double* part, unsigned int* arrived, long long n, int k,
                     int chunk, int cols, int piece, int stages, int resident, int device, void* stream) {
  cudaError_t e = lt::make_current(device);
  if (e != cudaSuccess) return int(e);
  return int(bcgs_pass<double>(basis, v, part, arrived, n, k, chunk, cols, piece, stages, resident != 0,
                               static_cast<cudaStream_t>(stream)));
}

// Registers, spills, shared memory and resident CTAs per SM of the kernel
// at a plan (see info above); f64 selects the double kernel.
int lt_bcgs_ring_info(int f64, int resident, int cols, int piece, int stages, int device, int* out) {
  cudaError_t e = lt::make_current(device);
  if (e != cudaSuccess) return int(e);
  if (f64) {
    e = check_plan<double>(1, cols, piece, stages, resident != 0);
    if (e != cudaSuccess) return int(e);
    return int(resident ? info<double, true>(cols, piece, stages, out) : info<double, false>(cols, piece, stages, out));
  }
  e = check_plan<float>(1, cols, piece, stages, resident != 0);
  if (e != cudaSuccess) return int(e);
  return int(resident ? info<float, true>(cols, piece, stages, out) : info<float, false>(cols, piece, stages, out));
}

}  // extern "C"
