// Native host kernels for latency-bound small-matrix hot loops.
//
// JAX rebuild of tensor4all-tcicore's dense pivot kernels
// (crates/tensor4all-tcicore/src/matrixlu.rs:69 `RrLU`, :713
// `rrlu_inplace`): the full-pivot rank-revealing LU loop is sequential
// and data-dependent — on-device it belongs to the jitted while_loop
// kernel (ops/rrlu.py), but host-side callers at CPU-class sizes
// (TT compression bonds, journal configs) are dominated by per-op
// interpreter overhead in the numpy twin. This file is that twin in
// C++: same pivot/stop rule, bit-for-bit the same elimination order.
//
// Build: make -C tensor4all_tpu/native  (pure C++17, no Python deps;
// loaded via ctypes by tensor4all_tpu/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>

namespace {

template <typename T>
double mag(T v) {
  return std::abs(v);
}

// Full-pivot rank-revealing LU on a row-major n x m matrix.
// Outputs: L (n x max_rank, row-major), U (max_rank x m, row-major),
// rows/cols/pivs (max_rank), lastdrop (first discarded pivot magnitude).
// Returns the accepted rank. Matches ops/rrlu.py::_rrlu_np exactly
// (same elimination arithmetic and first-occurrence tie-breaking).
//
// The per-pivot global argmax is the latency killer; instead of a
// separate full-matrix scan we keep a per-row running max (rowmax),
// refreshed inside the same vectorizable pass that applies the rank-1
// update — one sweep of the matrix per pivot instead of three.
template <typename T>
int64_t rrlu_impl(const T* a_in, int64_t n, int64_t m, double rtol,
                  double atol, int64_t max_rank, T* L, T* U, int64_t* rows,
                  int64_t* cols, double* pivs, double* lastdrop) {
  T* A = new T[n * m];
  std::memcpy(A, a_in, sizeof(T) * n * m);
  double* rowmax = new double[n];
  for (int64_t r = 0; r < n; ++r) {
    const T* Ar = A + r * m;
    double mx = 0.0;
#pragma omp simd reduction(max : mx)
    for (int64_t cc = 0; cc < m; ++cc) mx = std::max(mx, mag(Ar[cc]));
    rowmax[r] = mx;
  }
  // threshold is relative to the largest |entry| of the input
  double amax = 0.0;
  for (int64_t r = 0; r < n; ++r) amax = std::max(amax, rowmax[r]);
  const double thresh = std::max(rtol * amax, atol);
  std::fill(L, L + n * max_rank, T(0));
  std::fill(U, U + max_rank * m, T(0));
  *lastdrop = 0.0;
  int64_t k = 0;
  while (k < max_rank) {
    // global argmax: first row attaining the max (ties resolve to the
    // smallest flat index, same as numpy argmax), then first col in it
    int64_t i = 0;
    double bmag = -1.0;
    for (int64_t r = 0; r < n; ++r) {
      if (rowmax[r] > bmag) {
        bmag = rowmax[r];
        i = r;
      }
    }
    if (bmag <= thresh) {
      *lastdrop = bmag;
      break;
    }
    int64_t j = 0;
    {
      const T* Ai = A + i * m;
      for (int64_t cc = 0; cc < m; ++cc) {
        if (mag(Ai[cc]) == bmag) {
          j = cc;
          break;
        }
      }
    }
    const T piv = A[i * m + j];
    // rowv = A[i, :] (unchanged until zeroed below)
    T* rowv = U + k * m;
    std::memcpy(rowv, A + i * m, sizeof(T) * m);
    for (int64_t r = 0; r < n; ++r) {
      T* Ar = A + r * m;
      const T c = Ar[j] / piv;  // colv entry (1 at r == i)
      L[r * max_rank + k] = c;
      if (r == i) continue;  // pivot row is zeroed wholesale below
      double mx = 0.0;
      if (c != T(0)) {
#pragma omp simd reduction(max : mx)
        for (int64_t cc = 0; cc < m; ++cc) {
          const T v = Ar[cc] - c * rowv[cc];
          Ar[cc] = v;
          mx = std::max(mx, mag(v));
        }
        // the eliminated column is exactly zero by construction; the
        // fused max counted its (tiny) floating residual, so if that
        // residual could have been the max, recompute over the zeroed row
        const double mj = mag(Ar[j]);
        Ar[j] = T(0);
        if (mj == mx) {
          mx = 0.0;
#pragma omp simd reduction(max : mx)
          for (int64_t cc = 0; cc < m; ++cc) mx = std::max(mx, mag(Ar[cc]));
        }
      } else {
        Ar[j] = T(0);
#pragma omp simd reduction(max : mx)
        for (int64_t cc = 0; cc < m; ++cc) mx = std::max(mx, mag(Ar[cc]));
      }
      rowmax[r] = mx;
    }
    std::fill(A + i * m, A + (i + 1) * m, T(0));
    rowmax[i] = 0.0;
    rows[k] = i;
    cols[k] = j;
    pivs[k] = bmag;
    ++k;
  }
  delete[] A;
  delete[] rowmax;
  return k;
}

// One-sided Jacobi SVD of a p x q row-major matrix X with p <= q:
// X = U diag(s) Vh with U (p x p), s (p), Vh (p x q). Rows of X are
// orthogonalized by Givens rotations; high relative accuracy (better
// than bidiagonalization for graded matrices). Shipped as a
// LAPACK-free fallback behind native.jacobi_svd — NOT wired into the
// default host SVD path: on the target hosts OpenBLAS gesdd wins above
// ~16x32 (measured), so the default stays LAPACK.
template <typename T>
void jacobi_svd_impl(const T* x_in, int64_t p, int64_t q, T* U, double* s,
                     T* Vh) {
  T* X = new T[p * q];
  std::memcpy(X, x_in, sizeof(T) * p * q);
  // W accumulates the row rotations: X_final = W X  =>  U = W^H
  T* W = new T[p * p];
  std::fill(W, W + p * p, T(0));
  for (int64_t i = 0; i < p; ++i) W[i * p + i] = T(1);
  double* nrm = new double[p];  // squared row norms
  const double eps = 2.2204460492503131e-16;
  const double tol2 = (16.0 * eps) * (16.0 * eps);
  for (int sweep = 0; sweep < 60; ++sweep) {
    // exact norm refresh once per sweep; rotations update analytically
    // (Rutishauser: a' = a - t|c|, b' = b + t|c|) within the sweep
    for (int64_t i = 0; i < p; ++i) {
      const T* __restrict Xi = X + i * q;
      double a = 0.0;
#pragma omp simd reduction(+ : a)
      for (int64_t t = 0; t < q; ++t) a += std::norm(Xi[t]);
      nrm[i] = a;
    }
    bool rotated = false;
    for (int64_t i = 0; i < p - 1; ++i) {
      for (int64_t j = i + 1; j < p; ++j) {
        T* __restrict Xi = X + i * q;
        T* __restrict Xj = X + j * q;
        // c = <x_i, x_j> (conjugate-linear in the first argument)
        T c(0);
        if constexpr (std::is_same_v<T, std::complex<double>>) {
          for (int64_t t = 0; t < q; ++t) c += std::conj(Xi[t]) * Xj[t];
        } else {
          double acc = 0.0;
#pragma omp simd reduction(+ : acc)
          for (int64_t t = 0; t < q; ++t) acc += Xi[t] * Xj[t];
          c = T(acc);
        }
        const double a = nrm[i], b = nrm[j];
        const double cm = mag(c);
        if (cm * cm <= tol2 * (a * b) || cm == 0.0) continue;
        rotated = true;
        // 2x2 Hermitian eigenproblem [[a, c],[conj(c), b]]
        const double zeta = (b - a) / (2.0 * cm);
        const double t2 = (zeta >= 0.0 ? 1.0 : -1.0) /
                          (std::fabs(zeta) + std::sqrt(1.0 + zeta * zeta));
        const double cs = 1.0 / std::sqrt(1.0 + t2 * t2);
        const double sn = cs * t2;
        // phase of c: rotate with e^{i phi} so the rotated pair stays
        // orthogonal for complex inputs (phi = 0 for real)
        T phase;
        if constexpr (std::is_same_v<T, std::complex<double>>) {
          phase = c / T(cm);
        } else {
          phase = c > T(0) ? T(1) : T(-1);
        }
        const T sphase = T(sn) * phase;
        T* __restrict Wi = W + i * p;
        T* __restrict Wj = W + j * p;
        if constexpr (std::is_same_v<T, std::complex<double>>) {
          const T sconj = std::conj(sphase);
          for (int64_t t = 0; t < q; ++t) {
            const T xi = Xi[t], xj = Xj[t];
            Xi[t] = T(cs) * xi - sconj * xj;
            Xj[t] = sphase * xi + T(cs) * xj;
          }
          for (int64_t t = 0; t < p; ++t) {
            const T wi = Wi[t], wj = Wj[t];
            Wi[t] = T(cs) * wi - sconj * wj;
            Wj[t] = sphase * wi + T(cs) * wj;
          }
        } else {
          const T sr = sphase;
#pragma omp simd
          for (int64_t t = 0; t < q; ++t) {
            const T xi = Xi[t], xj = Xj[t];
            Xi[t] = T(cs) * xi - sr * xj;
            Xj[t] = sr * xi + T(cs) * xj;
          }
#pragma omp simd
          for (int64_t t = 0; t < p; ++t) {
            const T wi = Wi[t], wj = Wj[t];
            Wi[t] = T(cs) * wi - sr * wj;
            Wj[t] = sr * wi + T(cs) * wj;
          }
        }
        nrm[i] = a - t2 * cm;
        nrm[j] = b + t2 * cm;
      }
    }
    if (!rotated) break;
  }
  // final exact norms (the analytic updates drift at ~eps/rotation)
  for (int64_t i = 0; i < p; ++i) {
    const T* __restrict Xi = X + i * q;
    double a = 0.0;
#pragma omp simd reduction(+ : a)
    for (int64_t t = 0; t < q; ++t) a += std::norm(Xi[t]);
    nrm[i] = a;
  }
  // sort rows by descending norm; normalized rows -> Vh, W^H cols -> U
  int64_t* order = new int64_t[p];
  for (int64_t i = 0; i < p; ++i) order[i] = i;
  std::sort(order, order + p,
            [&](int64_t x, int64_t y) { return nrm[x] > nrm[y]; });
  for (int64_t r = 0; r < p; ++r) {
    const int64_t i = order[r];
    const double sv = std::sqrt(nrm[i]);
    s[r] = sv;
    const T* Xi = X + i * q;
    T* Vr = Vh + r * q;
    if (sv > 0.0) {
      const double inv = 1.0 / sv;
      for (int64_t t = 0; t < q; ++t) Vr[t] = Xi[t] * T(inv);
    } else {
      std::fill(Vr, Vr + q, T(0));
    }
    // U[:, r] = conj(W[i, :])  (U = W^H)
    const T* Wi = W + i * p;
    for (int64_t t = 0; t < p; ++t) {
      if constexpr (std::is_same_v<T, std::complex<double>>) {
        U[t * p + r] = std::conj(Wi[t]);
      } else {
        U[t * p + r] = Wi[t];
      }
    }
  }
  delete[] X;
  delete[] W;
  delete[] nrm;
  delete[] order;
}

}  // namespace

extern "C" {

int64_t t4a_rrlu_f64(const double* a, int64_t n, int64_t m, double rtol,
                     double atol, int64_t max_rank, double* L, double* U,
                     int64_t* rows, int64_t* cols, double* pivs,
                     double* lastdrop) {
  return rrlu_impl<double>(a, n, m, rtol, atol, max_rank, L, U, rows, cols,
                           pivs, lastdrop);
}

int64_t t4a_rrlu_c128(const void* a, int64_t n, int64_t m, double rtol,
                      double atol, int64_t max_rank, void* L, void* U,
                      int64_t* rows, int64_t* cols, double* pivs,
                      double* lastdrop) {
  using C = std::complex<double>;
  return rrlu_impl<C>(static_cast<const C*>(a), n, m, rtol, atol, max_rank,
                      static_cast<C*>(L), static_cast<C*>(U), rows, cols,
                      pivs, lastdrop);
}

void t4a_jacobi_svd_f64(const double* x, int64_t p, int64_t q, double* U,
                        double* s, double* Vh) {
  jacobi_svd_impl<double>(x, p, q, U, s, Vh);
}

void t4a_jacobi_svd_c128(const void* x, int64_t p, int64_t q, void* U,
                         double* s, void* Vh) {
  using C = std::complex<double>;
  jacobi_svd_impl<C>(static_cast<const C*>(x), p, q, static_cast<C*>(U), s,
                     static_cast<C*>(Vh));
}

}  // extern "C"
