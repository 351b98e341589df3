// Gauss–Jordan elimination for small dense systems on the host: the CPU
// path of nonlinearsolve_tpu_torch.ops.linear_solve.gauss_jordan_solve.
//
// The same one-hot row algebra as that function's tensor version (and the
// JAX package's), element for element, so that both round alike: every
// product with a one-hot vector is exact, the row swap, the pivot-row
// insert and the elimination are each one fused multiply-add, and the row
// extraction ``e @ M`` is a sum in which a non-finite entry of another row
// turns 0·x into NaN.  Built with -ffp-contract=off: the only fused
// operations are the explicit std::fma calls.
//
// M is the row-major augmented matrix [A | B], n rows of w = n + k
// columns, overwritten with [* | X]; row, tmp and prow are scratch of w
// entries.  The batched entry points take `batch` such matrices one after
// another and eliminate each on its own.

#include <cmath>
#include <cstdint>
#include <limits>

namespace {

template <typename T>
void row_of(const T* M, int64_t n, int64_t w, int64_t r, T* out) {
    // out = e_r @ M, summed in row order
    for (int64_t j = 0; j < w; ++j) out[j] = T(0);
    for (int64_t i = 0; i < n; ++i) {
        const T e = (i == r) ? T(1) : T(0);
        for (int64_t j = 0; j < w; ++j) out[j] = out[j] + e * M[i * w + j];
    }
}

template <typename T>
void gauss_jordan(T* M, int64_t n, int64_t w, T* row_k, T* row_p, T* prow) {
    for (int64_t k = 0; k < n; ++k) {
        // the pivot: argmax over rows ≥ k of |M[:, k]|, the first maximum
        // (a NaN counts as the maximum, its first occurrence wins)
        int64_t piv = 0;
        T best = -std::numeric_limits<T>::infinity();
        bool found_nan = false;
        for (int64_t i = 0; i < n; ++i) {
            const T c = (i >= k) ? std::fabs(M[i * w + k])
                                 : -std::numeric_limits<T>::infinity();
            if (std::isnan(c)) { piv = i; found_nan = true; break; }
            if (i == 0 || c > best) { best = c; piv = i; }
        }
        (void)found_nan;
        row_of(M, n, w, k, row_k);
        row_of(M, n, w, piv, row_p);
        for (int64_t i = 0; i < n; ++i) {
            const T ek = (i == k) ? T(1) : T(0);
            const T ep = (i == piv) ? T(1) : T(0);
            for (int64_t j = 0; j < w; ++j) {
                const T d = row_p[j] - row_k[j];
                T m = std::fma(ek, d, M[i * w + j]);
                M[i * w + j] = std::fma(-ep, d, m);
            }
        }
        const T pivot = row_p[k];
        for (int64_t j = 0; j < w; ++j) prow[j] = row_p[j] / pivot;
        for (int64_t i = 0; i < n; ++i) {
            const T ek = (i == k) ? T(1) : T(0);
            for (int64_t j = 0; j < w; ++j)
                M[i * w + j] = std::fma(ek, prow[j], M[i * w + j] * (T(1) - ek));
        }
        for (int64_t i = 0; i < n; ++i) {
            const T ek = (i == k) ? T(1) : T(0);
            const T factor = M[i * w + k] * (T(1) - ek);
            for (int64_t j = 0; j < w; ++j)
                M[i * w + j] = std::fma(-factor, prow[j], M[i * w + j]);
        }
    }
}

}  // namespace

extern "C" {

void gauss_jordan_f64(double* M, int64_t n, int64_t w, double* scratch) {
    gauss_jordan(M, n, w, scratch, scratch + w, scratch + 2 * w);
}

void gauss_jordan_f32(float* M, int64_t n, int64_t w, float* scratch) {
    gauss_jordan(M, n, w, scratch, scratch + w, scratch + 2 * w);
}

void gauss_jordan_batch_f64(double* M, int64_t batch, int64_t n, int64_t w,
                            double* scratch) {
    for (int64_t b = 0; b < batch; ++b)
        gauss_jordan(M + b * n * w, n, w, scratch, scratch + w,
                     scratch + 2 * w);
}

void gauss_jordan_batch_f32(float* M, int64_t batch, int64_t n, int64_t w,
                            float* scratch) {
    for (int64_t b = 0; b < batch; ++b)
        gauss_jordan(M + b * n * w, n, w, scratch, scratch + w,
                     scratch + 2 * w);
}

}  // extern "C"
