// Native host kernels for the TPU Lanczos framework.
//
// The reference library is header-only C++ (see SURVEY.md); the pieces that
// remain host-side in the TPU design are re-realized here:
//   * symmetric tridiagonal eigensolver (counterpart of the reference's
//     implicit-shift QR, lambda_lanczos_tridiagonal_impl.hpp:181-343) —
//     implemented as the classic implicit-shift QL sweep (EISPACK tql2
//     lineage, Golub & Van Loan sec. 8.3), written fresh for this repo.
//   * Sturm-count bisection eigenvalues (counterpart of
//     tridiagonal_impl.hpp:22-134).
//   * COO -> BSR block packing for the Pallas SpMV data path (no reference
//     counterpart; the reference's user lambda iterates tuple lists,
//     src/samples/sample2_sparse.cpp:43-47).
//
// Exposed with a C ABI and loaded via ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <numeric>
#include <vector>

namespace {

double hypot2(double a, double b) { return std::hypot(a, b); }

// Implicit-shift QL with eigenvector accumulation.
// d: diagonal (n), e: offdiagonal (n, e[n-1] unused), z: row-major n*n,
// z[k*n + :] accumulates the k-th eigenvector (row-per-vector layout, matching
// the reference's convention at tridiagonal_impl.hpp:177-179).
// Returns the number of blocks that hit the iteration cap (0 == converged).
int tql_implicit(double* d, double* e, double* z, std::int64_t n, bool want_z) {
  if (n <= 0) return 0;
  e[n - 1] = 0.0;
  int unconverged = 0;
  const double eps = std::numeric_limits<double>::epsilon();
  // Absolute deflation floor: with d[m] ~ d[m+1] ~ 0 a denormal e[m] never
  // satisfies the relative test and the sweep spins to the iteration cap
  // (observed on tridiagonals whose tail a breakdown zeroed out).
  const double tinyf = std::numeric_limits<double>::min();

  for (std::int64_t l = 0; l < n; ++l) {
    int iter = 0;
    std::int64_t m;
    do {
      for (m = l; m + 1 < n; ++m) {
        double dd = std::fabs(d[m]) + std::fabs(d[m + 1]);
        if (std::fabs(e[m]) <= eps * dd + tinyf) break;
      }
      if (m != l) {
        if (iter++ == 80) {
          ++unconverged;
          break;
        }
        // Wilkinson shift from the leading 2x2 of the block.
        double g = (d[l + 1] - d[l]) / (2.0 * e[l]);
        double r = hypot2(g, 1.0);
        g = d[m] - d[l] + e[l] / (g + std::copysign(r, g));
        double s = 1.0, c = 1.0, p = 0.0;
        std::int64_t i;
        for (i = m - 1; i >= l; --i) {
          double f = s * e[i];
          double b = c * e[i];
          r = hypot2(f, g);
          e[i + 1] = r;
          if (r == 0.0) {
            d[i + 1] -= p;
            e[m] = 0.0;
            break;
          }
          s = f / r;
          c = g / r;
          g = d[i + 1] - p;
          r = (d[i] - g) * s + 2.0 * c * b;
          p = s * r;
          d[i + 1] = g + p;
          g = c * r - b;
          if (want_z) {
            double* zi = z + i * n;
            double* zj = z + (i + 1) * n;
            for (std::int64_t k = 0; k < n; ++k) {
              double v0 = zi[k], v1 = zj[k];
              zj[k] = s * v0 + c * v1;
              zi[k] = c * v0 - s * v1;
            }
          }
        }
        if (r == 0.0 && i >= l) continue;
        d[l] -= p;
        e[l] = g;
        e[m] = 0.0;
      }
    } while (m != l);
  }
  return unconverged;
}

}  // namespace

extern "C" {

// Eigen-decomposition of a symmetric tridiagonal matrix.
// alpha (n), beta (n-1) inputs; eigvals (n) output ascending; eigvecs
// (n*n, row-per-vector) output if want_vectors. Returns unconverged count.
int lt_tridiagonal_eigh(const double* alpha, const double* beta, std::int64_t n,
                        double* eigvals, double* eigvecs, int want_vectors) {
  std::vector<double> d(alpha, alpha + n);
  std::vector<double> e(n, 0.0);
  if (n > 1) std::memcpy(e.data(), beta, sizeof(double) * (n - 1));

  if (want_vectors) {
    std::memset(eigvecs, 0, sizeof(double) * n * n);
    for (std::int64_t i = 0; i < n; ++i) eigvecs[i * n + i] = 1.0;
  }

  int rc = tql_implicit(d.data(), e.data(), eigvecs, n, want_vectors != 0);

  // Sort ascending, co-permuting eigenvector rows (counterpart of
  // util::sort_eigenpairs, common.hpp:141-174).
  std::vector<std::int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(),
            [&](std::int64_t a, std::int64_t b) { return d[a] < d[b]; });
  for (std::int64_t i = 0; i < n; ++i) eigvals[i] = d[order[i]];
  if (want_vectors) {
    std::vector<double> tmp(n * n);
    for (std::int64_t i = 0; i < n; ++i)
      std::memcpy(tmp.data() + i * n, eigvecs + order[i] * n, sizeof(double) * n);
    std::memcpy(eigvecs, tmp.data(), sizeof(double) * n * n);
  }
  return rc;
}

// Sturm-sequence count: number of eigenvalues < c.
static std::int64_t sturm_count(double c, const double* alpha, const double* beta,
                                std::int64_t n) {
  std::int64_t count = 0;
  double q = alpha[0] - c;
  if (q < 0) ++count;
  for (std::int64_t i = 1; i < n; ++i) {
    if (q == 0) q = std::numeric_limits<double>::epsilon();
    q = alpha[i] - c - beta[i - 1] * beta[i - 1] / q;
    if (q < 0) ++count;
  }
  return count;
}

// Bisection eigenvalues: the m-th..(m+k-1)-th smallest eigenvalues.
void lt_tridiagonal_eigvals_bisect(const double* alpha, const double* beta,
                                   std::int64_t n, std::int64_t first,
                                   std::int64_t count, double* out) {
  double r = 0.0;
  for (std::int64_t i = 0; i < n; ++i) r = std::max(r, std::fabs(alpha[i]));
  double b = 0.0;
  for (std::int64_t i = 0; i + 1 < n; ++i) b = std::max(b, std::fabs(beta[i]));
  double limit = r + 2.0 * b + 1.0;

  for (std::int64_t j = 0; j < count; ++j) {
    std::int64_t target = first + j;
    double lo = -limit, hi = limit;
    for (int it = 0; it < 200; ++it) {
      double mid = 0.5 * (lo + hi);
      if (mid == lo || mid == hi) break;
      if (sturm_count(mid, alpha, beta, n) >= target + 1)
        hi = mid;
      else
        lo = mid;
    }
    out[j] = lo;
  }
}

// Eigenvector for a (converged) eigenvalue of a symmetric tridiagonal matrix
// by the backward three-term recurrence (counterpart of the reference's
// bisection eigen*pairs* path, lambda_lanczos_tridiagonal_impl.hpp:93-115;
// written fresh: start from the last row instead of the first, rescale on
// overflow, and substitute +eps for exactly-zero couplings).
//
// Row k of (T - lam) v = 0:
//   beta[k-1] v[k-1] + (alpha[k] - lam) v[k] + beta[k] v[k+1] = 0
// Starting from v[n-1] = 1 the recurrence solves upward:
//   v[k-1] = ((lam - alpha[k]) v[k] - beta[k] v[k+1]) / beta[k-1]
void lt_tridiagonal_eigvec_backward(const double* alpha, const double* beta,
                                    std::int64_t n, double lam, double* v) {
  if (n <= 0) return;
  const double eps = std::numeric_limits<double>::epsilon();
  v[n - 1] = 1.0;
  if (n == 1) return;
  double bn = beta[n - 2];
  if (bn == 0.0) bn = eps;
  v[n - 2] = (lam - alpha[n - 1]) / bn;
  const double big = 1e100;
  for (std::int64_t k = n - 2; k >= 1; --k) {
    double bkm1 = beta[k - 1];
    if (bkm1 == 0.0) bkm1 = eps;
    double w = ((lam - alpha[k]) * v[k] - beta[k] * v[k + 1]) / bkm1;
    if (!(std::fabs(w) <= big)) {  // catches > big, inf AND NaN
      // Rescale the tail computed so far to keep the recurrence finite; the
      // final normalization makes the absolute scale irrelevant.  When w
      // itself overflowed to inf, 1/|w| is 0 (and w*inv would be NaN) — the
      // numpy fallback's semantics (sign(w)*1.0, tail scaled toward zero)
      // are mirrored exactly.
      double aw = std::fabs(w);
      double inv = std::isfinite(aw) ? 1.0 / aw : 0.0;
      for (std::int64_t j = k; j < n; ++j) v[j] *= inv;
      w = std::isnan(w) ? 1.0 : (w >= 0 ? 1.0 : -1.0);
    }
    v[k - 1] = w;
  }
  double nrm = 0.0;
  for (std::int64_t j = 0; j < n; ++j) nrm += v[j] * v[j];
  nrm = std::sqrt(nrm);
  if (nrm > 0.0) {
    for (std::int64_t j = 0; j < n; ++j) v[j] /= nrm;
  }
}

// One inverse-iteration refinement sweep: solve (T - lam) w = v by Gaussian
// elimination with partial pivoting (tridiagonal + one fill-in
// superdiagonal, the LAPACK xSTEIN factorization shape), normalize, write
// back.  Fixes the backward recurrence's known inaccuracy for localized
// eigenvectors — an improvement over the reference's pure-recurrence path.
void lt_tridiagonal_inverse_iter(const double* alpha, const double* beta,
                                 std::int64_t n, double lam, double* v) {
  if (n <= 1) return;
  const double eps = std::numeric_limits<double>::epsilon();
  double scale = 0.0;
  for (std::int64_t i = 0; i < n; ++i) scale = std::max(scale, std::fabs(alpha[i]));
  for (std::int64_t i = 0; i + 1 < n; ++i) scale = std::max(scale, std::fabs(beta[i]));
  const double pivmin = eps * std::max(scale, 1.0);

  std::vector<double> d(n), du(n, 0.0), du2(n, 0.0), dl(n, 0.0), rhs(v, v + n);
  for (std::int64_t i = 0; i < n; ++i) d[i] = alpha[i] - lam;
  for (std::int64_t i = 0; i + 1 < n; ++i) {
    du[i] = beta[i];
    dl[i] = beta[i];  // dl[i] couples row i+1 to column i
  }

  for (std::int64_t i = 0; i + 1 < n; ++i) {
    // Row i: (d[i], du[i], du2[i]) at columns i, i+1, i+2.
    // Row i+1: (dl[i], d[i+1], du[i+1]) at columns i, i+1, i+2 (du2 zero).
    if (std::fabs(dl[i]) > std::fabs(d[i])) {
      std::swap(d[i], dl[i]);
      double t1 = du[i]; du[i] = d[i + 1]; d[i + 1] = t1;
      double t2 = du2[i]; du2[i] = du[i + 1]; du[i + 1] = t2;
      std::swap(rhs[i], rhs[i + 1]);
    }
    if (std::fabs(d[i]) < pivmin) d[i] = std::copysign(pivmin, d[i] == 0.0 ? 1.0 : d[i]);
    const double m = dl[i] / d[i];
    d[i + 1] -= m * du[i];
    du[i + 1] -= m * du2[i];
    rhs[i + 1] -= m * rhs[i];
  }
  if (std::fabs(d[n - 1]) < pivmin)
    d[n - 1] = std::copysign(pivmin, d[n - 1] == 0.0 ? 1.0 : d[n - 1]);

  // Back substitution.
  rhs[n - 1] /= d[n - 1];
  if (n >= 2) rhs[n - 2] = (rhs[n - 2] - du[n - 2] * rhs[n - 1]) / d[n - 2];
  for (std::int64_t i = n - 3; i >= 0; --i)
    rhs[i] = (rhs[i] - du[i] * rhs[i + 1] - du2[i] * rhs[i + 2]) / d[i];

  double nrm = 0.0;
  for (std::int64_t i = 0; i < n; ++i) nrm += rhs[i] * rhs[i];
  nrm = std::sqrt(nrm);
  if (nrm > 0.0 && std::isfinite(nrm)) {
    for (std::int64_t i = 0; i < n; ++i) v[i] = rhs[i] / nrm;
  }
}

// Bisection eigen*pairs*: eigenvalues with ascending indices
// [first, first+count) plus their eigenvectors (row-per-vector layout):
// backward recurrence seeded, one pivoted inverse-iteration refinement.
// The self-contained analogue of the reference's
// tridiagonal_eigenpairs_bisection driver (tridiagonal_impl.hpp:120-134).
void lt_tridiagonal_eigh_bisect(const double* alpha, const double* beta,
                                std::int64_t n, std::int64_t first,
                                std::int64_t count, double* eigvals,
                                double* eigvecs) {
  lt_tridiagonal_eigvals_bisect(alpha, beta, n, first, count, eigvals);

  // Cluster tolerance for within-cluster orthogonalization (LAPACK xSTEIN
  // discipline): bisected eigenvalues closer than this seed the SAME
  // backward recurrence and inverse iteration, so without Gram-Schmidt the
  // returned "eigenbasis" is rank-deficient for degenerate spectra.
  double scale = 0.0;
  for (std::int64_t i = 0; i < n; ++i) scale = std::max(scale, std::fabs(alpha[i]));
  for (std::int64_t i = 0; i + 1 < n; ++i) scale = std::max(scale, std::fabs(beta[i]));
  const double ctol = 1e-7 * std::max(scale, 1.0);

  auto gs_cluster = [&](std::int64_t j, double* v) {
    for (std::int64_t i = 0; i < j; ++i) {
      if (std::fabs(eigvals[j] - eigvals[i]) > ctol) continue;
      const double* u = eigvecs + i * n;
      double dot = 0.0;
      for (std::int64_t t = 0; t < n; ++t) dot += u[t] * v[t];
      for (std::int64_t t = 0; t < n; ++t) v[t] -= dot * u[t];
    }
    double nrm = 0.0;
    for (std::int64_t t = 0; t < n; ++t) nrm += v[t] * v[t];
    return std::sqrt(nrm);
  };

  for (std::int64_t j = 0; j < count; ++j) {
    double* v = eigvecs + j * n;
    lt_tridiagonal_eigvec_backward(alpha, beta, n, eigvals[j], v);
    // Two sweeps: the recurrence seed can be nearly orthogonal to the target
    // when the eigenvector is localized at the recurrence's starting end
    // (one sweep then recovers only a gap-limited component).
    lt_tridiagonal_inverse_iter(alpha, beta, n, eigvals[j], v);
    lt_tridiagonal_inverse_iter(alpha, beta, n, eigvals[j], v);
    double nrm = gs_cluster(j, v);
    if (nrm < 0.1) {
      // The seed collapsed onto earlier cluster members (degenerate
      // eigenvalue): restart inverse iteration from a deterministic
      // pseudo-random vector, Gram-Schmidting after every sweep.
      std::uint64_t s = 0x9E3779B97F4A7C15ull * (std::uint64_t)(j + 1);
      for (std::int64_t t = 0; t < n; ++t) {
        s = s * 6364136223846793005ull + 1442695040888963407ull;
        v[t] = ((double)(s >> 11) / (double)(1ull << 53)) - 0.5;
      }
      gs_cluster(j, v);
      for (int sweep = 0; sweep < 3; ++sweep) {
        lt_tridiagonal_inverse_iter(alpha, beta, n, eigvals[j], v);
        nrm = gs_cluster(j, v);
        if (nrm >= 0.1) break;
      }
    }
    if (nrm > 0.0) {
      for (std::int64_t t = 0; t < n; ++t) v[t] /= nrm;
    }
  }
}

// COO -> BSR packing, pass 1: count the distinct (bm x bk) blocks touched.
// block ids are row_block * num_col_blocks + col_block.
std::int64_t lt_bsr_count(const std::int64_t* rows, const std::int64_t* cols,
                          std::int64_t nnz, std::int64_t bm, std::int64_t bk,
                          std::int64_t n_col_blocks, std::int64_t* scratch_ids) {
  for (std::int64_t i = 0; i < nnz; ++i)
    scratch_ids[i] = (rows[i] / bm) * n_col_blocks + (cols[i] / bk);
  std::sort(scratch_ids, scratch_ids + nnz);
  std::int64_t nb = nnz > 0 ? 1 : 0;
  for (std::int64_t i = 1; i < nnz; ++i)
    if (scratch_ids[i] != scratch_ids[i - 1]) ++nb;
  return nb;
}

// COO -> BSR packing, pass 2 (f32 block values).
// sorted_ids: output of pass 1 (sorted, length nnz). Fills:
//   block_ids   (nblocks)            sorted unique block ids
//   blocks      (nblocks * bm * bk)  dense block values (duplicates summed)
void lt_bsr_fill_f32(const std::int64_t* rows, const std::int64_t* cols,
                     const float* vals, std::int64_t nnz, std::int64_t bm,
                     std::int64_t bk, std::int64_t n_col_blocks,
                     const std::int64_t* sorted_ids, std::int64_t nblocks,
                     std::int64_t* block_ids, float* blocks) {
  std::int64_t nb = 0;
  for (std::int64_t i = 0; i < nnz; ++i) {
    if (i == 0 || sorted_ids[i] != sorted_ids[i - 1]) block_ids[nb++] = sorted_ids[i];
  }
  std::memset(blocks, 0, sizeof(float) * nblocks * bm * bk);
  for (std::int64_t i = 0; i < nnz; ++i) {
    std::int64_t id = (rows[i] / bm) * n_col_blocks + (cols[i] / bk);
    const std::int64_t* p =
        std::lower_bound(block_ids, block_ids + nblocks, id);
    std::int64_t slot = p - block_ids;
    std::int64_t r = rows[i] % bm, c = cols[i] % bk;
    blocks[slot * bm * bk + r * bk + c] += vals[i];
  }
}

// COO -> BSR packing, pass 2 (f64 block values) — same contract as the f32
// variant; used when the target block dtype is float64 (CPU/f64 path).
void lt_bsr_fill_f64(const std::int64_t* rows, const std::int64_t* cols,
                     const double* vals, std::int64_t nnz, std::int64_t bm,
                     std::int64_t bk, std::int64_t n_col_blocks,
                     const std::int64_t* sorted_ids, std::int64_t nblocks,
                     std::int64_t* block_ids, double* blocks) {
  std::int64_t nb = 0;
  for (std::int64_t i = 0; i < nnz; ++i) {
    if (i == 0 || sorted_ids[i] != sorted_ids[i - 1]) block_ids[nb++] = sorted_ids[i];
  }
  std::memset(blocks, 0, sizeof(double) * nblocks * bm * bk);
  for (std::int64_t i = 0; i < nnz; ++i) {
    std::int64_t id = (rows[i] / bm) * n_col_blocks + (cols[i] / bk);
    const std::int64_t* p =
        std::lower_bound(block_ids, block_ids + nblocks, id);
    std::int64_t slot = p - block_ids;
    std::int64_t r = rows[i] % bm, c = cols[i] % bk;
    blocks[slot * bm * bk + r * bk + c] += vals[i];
  }
}

}  // extern "C"
