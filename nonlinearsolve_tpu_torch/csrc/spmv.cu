// Sparse matrix-vector kernels for Hopper (sm_90a), with a plain C interface
// loaded by ctypes (nonlinearsolve_tpu_torch/ops/spmv.py holds the wrappers).
// f32 and f64 values, int32 indices.
//
// K4  dia_spmv       replaces nonlinearsolve_tpu/ops/pallas_stencil.py
//                    _dia_kernel_factory (dia_spmv_pallas), whose function is
//                    also DIA.matvec / DiaPlan.matvec_packed
//                    (ops/sparse.py, ops/spmv_dia.py):
//
//                      y[i] = sum_d data[d, i] * x[i + off_d]
//
//                    summed in ascending-offset order, over 0 <= i + off_d < n
//                    only: a slot whose column falls outside [0, n) is never
//                    read, so an inf or NaN in a pad slot cannot reach y.
//
// K5  csr_spmv       replaces nonlinearsolve_tpu/ops/pallas_spmv.py
//                    _ell_spmv_call (ell_spmv_pallas, csr_spmv_pallas,
//                    csr_spmv_staged):  y[r] = sum_k data[k] * x[indices[k]]
//                    over indptr[r] <= k < indptr[r+1], summed in CSR order.
//     csr_select     K5's unit-data variant, the static selection of
//                    ops/selection.py (which rides _ell_spmv_packed with its
//                    validity table as data): each output row has at most one
//                    source, y[i] = values[src[i]], and a pad row
//                    (src[i] == n_src) gives 0.
//
// K7  band_spmv      replaces nonlinearsolve_tpu/ops/pallas_spmv_stream.py
//                    _band_spmv_call (band_spmv_pallas, band_spmv_staged):
//                      y[r] = sum_s data[s, r] * x[cols[s, r]]
//                    over the w slots of a slot-major (w, n_pad) band-ELL
//                    table, in slot order (bands ascending, rank within a
//                    band ascending: the row's sorted column order, K5's
//                    sum order on a sorted CSR).  A pad slot (col -1) is
//                    skipped, its data never read.
//
// K8  scatter_expand  and  scatter_regroup  replace
//                    nonlinearsolve_tpu/ops/pallas_spmv_scatter.py
//                    (scatter_spmv_pallas, scatter_spmv_staged: two passes
//                    of _ell_spmv_call):
//                      expand   p[k] = gdata[k] * x[gcol[k]]  (0 where -1)
//                      regroup  y[r] = sum_k p[pos[k]], indptr[r] <= k <
//                               indptr[r+1] (unit data: no data array)
//
// K6  bsr_spmm       replaces nonlinearsolve_tpu/ops/pallas_spmv.py
//                    _bsr_spmm_kernel / _bsr_spmm_call (bsr_spmm_pallas):
//                    Y = A X for A in block CSR (dense b x b blocks) and a
//                    dense row-major X (n_cols x nrhs):
//                      Y[i*b + r, c] = sum_{k in block row i} sum_j
//                                      data[k, r, j] * X[indices[k]*b + j, c]
//                    summed in block order k, then j ascending, in the value
//                    type (the Pallas kernel's f32 / f64 accumulator).  It
//                    reads the block CSR as it is: the TPU kernel's ELL
//                    padding of block rows and 8-sublane X tiles are its
//                    layout, not its function.  An empty block row writes 0;
//                    every entry of a block is multiplied, zeros included, so
//                    a NaN in X reaches every row whose block row references
//                    it, as the dense block product does.
//
// Bound on the H100: bytes, for all of them.  At the 512^2 Brusselator
// (n = 524,288, 11 diagonals, 3,145,728 nonzeros) in f64, reading every input
// once and writing y once:
//   K4  in-band data (44.9 MB) + x + y (8.4 MB)                ~ 16 us
//   K5  data (25.2 MB) + indices (12.6 MB) + indptr (2.1 MB)
//       + x + y (8.4 MB)                                        ~ 14 us
//   selection: src (23.1 MB) + the 3.1M values it reads (25.2 MB)
//       + y (46.1 MB)                                           ~ 28 us
// at 3.35 TB/s, against at most two flops per nonzero (a few us of f64
// arithmetic at 34 TFLOP/s).  K7 on the 256^3 periodic 7-point Jacobian
// (n = 16,777,216, 117,440,512 nonzeros, w = 11 slots), f32: cols 11 x 4 B
// + the data of the 7 occupied slots 7 x 4 B + x, y 8 B = 80 B a row,
// 1.34 GB, ~ 401 us, where K5 on the same matrix as CSR moves 1.14 GB
// (~ 341 us): the band sub-slots pad 7 nonzeros to 11 slots.  K8 on the
// permuted 96^3 Jacobian (884,736 rows, 6.2M nonzeros, 3 column parts of
// ~2.1M positions), f32: the expand and regroup passes of the three parts
// and the parts' sum move ~ 150 MB (~ 45 us) where K5 moves ~ 60 MB
// (~ 18 us): x (3.5 MB) sits in the 50 MB L2 here, so the locality the
// two passes buy on a TPU buys nothing on this card.  K6 on the same 512^2
// matrix reblocked with b = 2 (262,144 block rows, 1,310,720 blocks), f64:
// data (41.9 MB) + block indices (5.2 MB) + block indptr (1.0 MB) + X and Y
// once (33.5 MB each at nrhs 8) = 115 MB ~ 34 us; at nrhs 37 ~ 359 MB
// ~ 107 us; 2 b^2 nrhs flops a block (84M at nrhs 8) are ~ 2.5 us of f64
// arithmetic.  The TPU kernels
// were shaped by the lack of scalar gathers (windowed slot-major ELL,
// register gathers inside an (8, 128) tile); Hopper gathers through L1/L2,
// so the port keeps the CSR and DIA layouts as they are and lets the caches
// serve x.
//
// Design: one thread per output row, 256 threads a block.  K4 walks the
// diagonals in a loop; the offsets (at most 48, as DiaPlan allows) travel by
// value in the kernel's parameters, so every thread of a warp reads data and
// x at consecutive addresses (coalesced) for each diagonal.  K5 walks its
// row's nonzeros; neighbouring threads read neighbouring CSR segments, which
// L1 merges into lines.  x is read through the read-only path (const
// __restrict__).  K7 is K5 on the band table: one thread per row walks its
// w slots; the slot-major layout makes each slot's cols and data reads
// coalesced across a warp, and its offsets are 64-bit (w * n_pad is 184.5M
// at 256^3).  K8's expand is one thread per position, its regroup one
// thread per output row (K5 without data).  K6 is one thread per output
// (block row i, row r of the block, column c), c fastest: a warp's reads of
// an X row segment are consecutive (coalesced) and its reads of a block's
// row are one address (a broadcast); the thread walks its block row's
// blocks in CSR order, no atomics, and its offsets are 64-bit.  No
// shared-memory tiling, no warp-per-row split, no vector loads, no tensor
// cores for K6: making these fast is later work.
// a*b + c is contracted into an FMA, so the sums differ from the plain
// versions' in the last bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOffsets = 48;

struct DiaOffsets {
  int ndiag;
  int off[kMaxOffsets];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const T* __restrict__ data, const T* __restrict__ x,
                T* __restrict__ y, int n, DiaOffsets offs) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  T acc = T(0);
  for (int d = 0; d < offs.ndiag; ++d) {
    const long long j = static_cast<long long>(i) + offs.off[d];
    if (j >= 0 && j < n) {
      acc += data[static_cast<size_t>(d) * n + i] * x[j];
    }
  }
  y[i] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
csr_spmv_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                const T* __restrict__ data, const T* __restrict__ x,
                T* __restrict__ y, int n_rows) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rows) return;
  const int k1 = indptr[r + 1];
  T acc = T(0);
  for (int k = indptr[r]; k < k1; ++k) {
    acc += data[k] * x[indices[k]];
  }
  y[r] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
csr_select_kernel(const int* __restrict__ src, const T* __restrict__ values,
                  T* __restrict__ y, int n_out, int n_src) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_out) return;
  const int s = src[i];
  y[i] = (s >= 0 && s < n_src) ? values[s] : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
band_spmv_kernel(const int* __restrict__ cols, const T* __restrict__ data,
                 const T* __restrict__ x, T* __restrict__ y, int n_rows,
                 int n_x, long long n_pad, int w) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rows) return;
  T acc = T(0);
  for (int s = 0; s < w; ++s) {
    const long long k = static_cast<long long>(s) * n_pad + r;
    const int c = cols[k];
    if (c >= 0 && c < n_x) acc += data[k] * x[c];
  }
  y[r] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_expand_kernel(const int* __restrict__ gcol, const T* __restrict__ gdata,
                      const T* __restrict__ x, T* __restrict__ p, int n,
                      int n_x) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  const int c = gcol[k];
  p[k] = (c >= 0 && c < n_x) ? gdata[k] * x[c] : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_regroup_kernel(const int* __restrict__ indptr,
                       const int* __restrict__ pos, const T* __restrict__ p,
                       T* __restrict__ y, int n_rows) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rows) return;
  const int k1 = indptr[r + 1];
  T acc = T(0);
  for (int k = indptr[r]; k < k1; ++k) acc += p[pos[k]];
  y[r] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                const T* __restrict__ data, const T* __restrict__ X,
                T* __restrict__ Y, long long n_out, int b, int nrhs) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n_out) return;
  const long long row = t / nrhs;          // scalar row i*b + r
  const int c = static_cast<int>(t - row * nrhs);
  const long long i = row / b;
  const int r = static_cast<int>(row - i * b);
  const int k1 = indptr[i + 1];
  T acc = T(0);
  for (int k = indptr[i]; k < k1; ++k) {
    const T* d = data + (static_cast<long long>(k) * b + r) * b;
    const T* x = X + static_cast<long long>(indices[k]) * b * nrhs + c;
    for (int j = 0; j < b; ++j) acc += d[j] * x[static_cast<long long>(j) * nrhs];
  }
  Y[t] = acc;
}

inline unsigned blocks_of(int n) {
  return static_cast<unsigned>((static_cast<long long>(n) + kThreads - 1) / kThreads);
}

template <typename T>
int launch_dia(const void* data, const void* x, void* y, int n,
               const int* offsets, int ndiag, void* stream) {
  if (n < 0 || ndiag < 0 || ndiag > kMaxOffsets) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  DiaOffsets offs;
  offs.ndiag = ndiag;
  for (int d = 0; d < kMaxOffsets; ++d) offs.off[d] = d < ndiag ? offsets[d] : 0;
  dia_spmv_kernel<T><<<blocks_of(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const T*>(x),
      static_cast<T*>(y), n, offs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_csr(const void* indptr, const void* indices, const void* data,
               const void* x, void* y, int n_rows, void* stream) {
  if (n_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  csr_spmv_kernel<T><<<blocks_of(n_rows), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      static_cast<const T*>(data), static_cast<const T*>(x),
      static_cast<T*>(y), n_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_select(const void* src, const void* values, void* y, int n_out,
                  int n_src, void* stream) {
  if (n_out < 0 || n_src < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_out == 0) return 0;
  csr_select_kernel<T><<<blocks_of(n_out), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src), static_cast<const T*>(values),
      static_cast<T*>(y), n_out, n_src);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_band(const void* cols, const void* data, const void* x, void* y,
                int n_rows, int n_x, long long n_pad, int w, void* stream) {
  if (n_rows < 0 || n_x < 0 || w < 0 || n_pad < n_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  band_spmv_kernel<T><<<blocks_of(n_rows), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cols), static_cast<const T*>(data),
      static_cast<const T*>(x), static_cast<T*>(y), n_rows, n_x, n_pad, w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_expand(const void* gcol, const void* gdata, const void* x, void* p,
                  int n, int n_x, void* stream) {
  if (n < 0 || n_x < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  scatter_expand_kernel<T><<<blocks_of(n), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(gcol), static_cast<const T*>(gdata),
      static_cast<const T*>(x), static_cast<T*>(p), n, n_x);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_regroup(const void* indptr, const void* pos, const void* p, void* y,
                   int n_rows, void* stream) {
  if (n_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  scatter_regroup_kernel<T><<<blocks_of(n_rows), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(pos),
      static_cast<const T*>(p), static_cast<T*>(y), n_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bsr_spmm(const void* indptr, const void* indices, const void* data,
                    const void* X, void* Y, int n_brows, int b, int nrhs,
                    void* stream) {
  if (n_brows < 0 || b < 1 || nrhs < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_out = static_cast<long long>(n_brows) * b * nrhs;
  if (n_out == 0) return 0;
  const long long grid = (n_out + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  bsr_spmm_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      static_cast<const T*>(data), static_cast<const T*>(X),
      static_cast<T*>(Y), n_out, b, nrhs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* nls_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int dia_spmv_f32(const void* data, const void* x, void* y, int n,
                 const int* offsets, int ndiag, void* stream) {
  return launch_dia<float>(data, x, y, n, offsets, ndiag, stream);
}

int dia_spmv_f64(const void* data, const void* x, void* y, int n,
                 const int* offsets, int ndiag, void* stream) {
  return launch_dia<double>(data, x, y, n, offsets, ndiag, stream);
}

int csr_spmv_f32(const void* indptr, const void* indices, const void* data,
                 const void* x, void* y, int n_rows, void* stream) {
  return launch_csr<float>(indptr, indices, data, x, y, n_rows, stream);
}

int csr_spmv_f64(const void* indptr, const void* indices, const void* data,
                 const void* x, void* y, int n_rows, void* stream) {
  return launch_csr<double>(indptr, indices, data, x, y, n_rows, stream);
}

int csr_select_f32(const void* src, const void* values, void* y, int n_out,
                   int n_src, void* stream) {
  return launch_select<float>(src, values, y, n_out, n_src, stream);
}

int csr_select_f64(const void* src, const void* values, void* y, int n_out,
                   int n_src, void* stream) {
  return launch_select<double>(src, values, y, n_out, n_src, stream);
}

int band_spmv_f32(const void* cols, const void* data, const void* x, void* y,
                  int n_rows, int n_x, long long n_pad, int w, void* stream) {
  return launch_band<float>(cols, data, x, y, n_rows, n_x, n_pad, w, stream);
}

int band_spmv_f64(const void* cols, const void* data, const void* x, void* y,
                  int n_rows, int n_x, long long n_pad, int w, void* stream) {
  return launch_band<double>(cols, data, x, y, n_rows, n_x, n_pad, w, stream);
}

int scatter_expand_f32(const void* gcol, const void* gdata, const void* x,
                       void* p, int n, int n_x, void* stream) {
  return launch_expand<float>(gcol, gdata, x, p, n, n_x, stream);
}

int scatter_expand_f64(const void* gcol, const void* gdata, const void* x,
                       void* p, int n, int n_x, void* stream) {
  return launch_expand<double>(gcol, gdata, x, p, n, n_x, stream);
}

int scatter_regroup_f32(const void* indptr, const void* pos, const void* p,
                        void* y, int n_rows, void* stream) {
  return launch_regroup<float>(indptr, pos, p, y, n_rows, stream);
}

int scatter_regroup_f64(const void* indptr, const void* pos, const void* p,
                        void* y, int n_rows, void* stream) {
  return launch_regroup<double>(indptr, pos, p, y, n_rows, stream);
}

int bsr_spmm_f32(const void* indptr, const void* indices, const void* data,
                 const void* X, void* Y, int n_brows, int b, int nrhs,
                 void* stream) {
  return launch_bsr_spmm<float>(indptr, indices, data, X, Y, n_brows, b, nrhs,
                                stream);
}

int bsr_spmm_f64(const void* indptr, const void* indices, const void* data,
                 const void* X, void* Y, int n_brows, int b, int nrhs,
                 void* stream) {
  return launch_bsr_spmm<double>(indptr, indices, data, X, Y, n_brows, b, nrhs,
                                 stream);
}

}  // extern "C"
