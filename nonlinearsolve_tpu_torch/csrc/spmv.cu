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
// K8  scatter_part   replaces nonlinearsolve_tpu/ops/pallas_spmv_scatter.py
//                    ScatterPlan.apply_staged (scatter_spmv_pallas,
//                    scatter_spmv_staged: per column part, two passes of
//                    _ell_spmv_call, an expand p = (G o data) x[c0:c1] and
//                    the R chain's regroup y_p = R p, then y = sum of y_p in
//                    part order).  One launch a part computes
//                      y[r] (+)= sum_k gdata[pos[k]] * x[gcol[pos[k]]],
//                               rptr[r] <= k < rptr[r+1]  (0 where gcol -1)
//                    with each product rounded alone and each row summed in
//                    the R chain's association (chunks of 32 positions, then
//                    the chunk sums, ...), no FMA: y is the two passes' to
//                    the bit.  Part 0 writes y, each later part adds to it.
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
//                    it, as the dense block product does.  Each output is one
//                    fma() chain in that order from +0, the contraction nvcc
//                    makes of one thread an output's acc += d * x, so the
//                    kernel's bits do not depend on its team shape.
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
// ~2.1M positions), f32: gcol and the staged data of the 6.29M positions
// (50.3 MB), pos (24.8 MB), the parts' rptr (10.6 MB), x and y (7.1 MB):
// ~ 93 MB, ~ 28 us (f64 ~ 125 MB, ~ 37 us).  K6 on the same 512^2 matrix
// reblocked with b = 2 (262,144 block rows, 1,310,720 blocks), f64:
// data (41.9 MB) + block indices (5.2 MB) + block indptr (1.0 MB) + X and Y
// once (33.5 MB each at nrhs 8) = 115 MB ~ 34 us; at nrhs 37 ~ 359 MB
// ~ 107 us; 2 b^2 nrhs flops a block (84M at nrhs 8) are ~ 2.5 us of f64
// arithmetic: 0.73 flop a byte, where the card's f64 units need about 10
// to be the limit.  Tensor cores do not pay for K6: at b = 2 a block holds
// 4 values, so an f64 DMMA m8n8k4 fragment would be more than 90 %
// padding, and the product is bound by the memory system, not by
// arithmetic.  Its X is read about five times (each block column is
// referenced by five block rows), from L2 where the rows lie 2N apart, so
// L2 traffic and the latency of each team's dependent loads (indptr, the
// staged blocks, then X) decide its time.  The TPU kernels were shaped by
// the lack of scalar gathers (windowed slot-major ELL, register gathers
// inside an (8, 128) tile);
// Hopper gathers through L1/L2, so the port keeps the CSR and DIA layouts
// as they are and lets the caches serve x.
//
// What bounds K5 and K8 on a scattered pattern is not HBM but the x
// gathers: each fetches a 32 B L2 sector for 4 or 8 useful bytes, and
// neighbouring rows share none.  On the permuted tables a lone
// torch.index_select of x over the column indices (the gathers and
// nothing else) takes 90-91 % of K5's time and 79 % of K8's in f32
// (PERF.md, kernel table).
//
// Design: one thread per output row, 256 threads a block, for K4, K5, K7
// and the selection.  K4 walks the diagonals in a loop; the offsets (at
// most 48, as DiaPlan allows) travel by value in the kernel's parameters,
// so every thread of a warp reads data and x at consecutive addresses
// (coalesced) for each diagonal.  K5 walks its row kCsrAhead entries at a
// time: their indices and data, then their x gathers, then the FMAs in
// CSR order, so that several gathers a thread are in flight and the sum
// is the one-at-a-time FMA chain's (csr_row).  Staging the block's CSR
// segment in shared memory, 8 loads ahead, several lanes a row, or x
// through ld.global.nc.L1::no_allocate were each slower on one of the
// three tables in a side-by-side timing (PERF.md, PR 7).
// x is read through the read-only path (const __restrict__).  K7 is K5 on
// the band table: one thread per row walks its w slots; the slot-major
// layout makes each slot's cols and data reads coalesced across a warp,
// and its offsets are 64-bit (w * n_pad is 184.5M at 256^3).  K8 is a
// block of kZoneThreads per zone of the plan (rows_per_zone rows, whose
// products are the zone's positions): the block reads the zone's gcol and
// staged data coalesced, kAhead a thread in flight, gathers x in the
// zone's column order and keeps the products in shared memory (at most
// kZoneSmemBytes; a larger zone forms each product where its row reads
// it, through L1); then each thread sums rows from there, their pos loads
// kRowAhead ahead and the next row's rptr and y loaded during the sum.
// The products never go to device memory, where a two-pass design (an
// expand kernel, then a regroup kernel a level of the R chain) writes
// and reads them back (2 x 25 MB at 96^3 f32), in 8 launches a product.
// A part after the first is launched as a programmatic dependent of the
// one before: it gathers its products while that one ends and waits
// (griddepcontrol.wait) before it reads y.  K6 is a team of T lanes a
// block row, lanes over X's columns, 256 / T consecutive block rows a
// thread block (ops/spmv.py bsr_spmm_plan picks T, the columns a load and
// the slots a lane from b, nrhs, the dtype and X's address): each lane
// holds b rows of its columns, so the team reads an X row segment once,
// coalesced, for all b rows of a block, 16 bytes a lane where nrhs and X
// allow (4 f32 or 2 f64 columns).  The thread block first copies its rows'
// blocks and block indices (one contiguous segment of each) into shared
// memory, coalesced, 16 bytes a thread, so no lane repeats another's load
// of them (in chunks where a segment passes kBsrStageBytes); each lane
// then loads the X of A blocks before their FMAs (bsr_ahead).  No integer
// division: the grid maps onto block rows and a thread onto its team and
// lane by shifts and masks; offsets that can pass 2^31 are 64-bit.  A
// block size other than 1, 2, 3, 4 or 8 takes bsr_spmm_any_kernel: a team
// a (block row, row of the block), blocks read in place.  A team wider
// than 8 lanes holds fewer rows a thread block and was slower, as were
// the blocks read in place by each lane, handed round by __shfl_sync,
// more blocks in flight, or more thread blocks an SM at fewer registers
// (bench/k6_designs.cu; PERF.md).  In K4, K5 and K7 a*b + c is
// contracted into an FMA, so their sums differ from the plain versions'
// in the last bits; K6's FMAs are written out (fma()), one chain an
// output; K8 rounds each operation alone (__fmul_rn, __fadd_rn).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOffsets = 48;
constexpr int kCsrAhead = 4;          // K5's loads in flight a thread
constexpr int kSlots = 32;            // the plan's MAX_SLOTS: R rows chain
constexpr int kMaxDepth = 7;          // kSlots^7 > 2^31 terms
constexpr int kAhead = 4;             // K8's product loads in flight
constexpr int kRowAhead = 8;          // K8's pos loads in flight a row
constexpr int kZoneThreads = 512;     // K8's block
constexpr int kZoneSmemBytes = 48 * 1024;   // K8's product buffer
constexpr int kBsrThreads = 256;            // K6's block
constexpr int kBsrStageBytes = 48 * 1024;   // K6's staged blocks, at most

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

// K5's row walk: the row's indices and data U entries at a time, then their
// x gathers, then the FMAs in CSR order, so that U gathers are in flight
// and the sum is the one-at-a-time FMA chain's to the bit.
template <typename T, int U>
__device__ __forceinline__ T csr_row(const int* __restrict__ indices,
                                     const T* __restrict__ data,
                                     const T* __restrict__ x, int k0, int k1) {
  T acc = T(0);
  for (int k = k0; k < k1; k += U) {
    int c[U];
    T d[U], v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k + u < k1) {
        c[u] = indices[k + u];
        d[u] = data[k + u];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k + u < k1) v[u] = x[c[u]];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k + u < k1) acc = fma(d[u], v[u], acc);
    }
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
csr_spmv_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                const T* __restrict__ data, const T* __restrict__ x,
                T* __restrict__ y, int n_rows) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rows) return;
  y[r] = csr_row<T, kCsrAhead>(indices, data, x, indptr[r], indptr[r + 1]);
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

// K8's arithmetic, each operation rounded alone (no FMA contraction)
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// The sum of term(k) over k0 <= k < k1 as the plan's R chain associates it:
// a row of at most kSlots terms is summed in order from 0; a longer one in
// chunks of kSlots from its first term, the chunk sums likewise, until at
// most kSlots sums remain.  (The plan chains every row when one row is
// long, but a chunk of one sum adds it to 0 exactly, and a sum begun at
// +0 is never -0, so each row's own depth gives the same bits.)
template <typename T, typename Term>
__device__ __forceinline__ T chain_sum(int k0, int k1, Term term) {
  const int c = k1 - k0;
  if (c <= kSlots) {
    T acc = T(0);
    for (int k = k0; k < k1; ++k) acc = add_rn(acc, term(k));
    return acc;
  }
  int depth = 2;
  for (long long cap = kSlots * kSlots; c > cap; cap *= kSlots) ++depth;
  T acc[kMaxDepth];
  int cnt[kMaxDepth];
  for (int l = 0; l < depth; ++l) {
    acc[l] = T(0);
    cnt[l] = 0;
  }
  for (int k = k0; k < k1; ++k) {
    acc[0] = add_rn(acc[0], term(k));
    // a full chunk moves its sum one level up, and so on up the chain
    for (int l = 0; ++cnt[l] == kSlots && l + 1 < depth; ++l) {
      acc[l + 1] = add_rn(acc[l + 1], acc[l]);
      acc[l] = T(0);
      cnt[l] = 0;
    }
  }
  for (int l = 0; l + 1 < depth; ++l) {
    if (cnt[l] > 0) {
      acc[l + 1] = add_rn(acc[l + 1], acc[l]);
      ++cnt[l + 1];
    }
  }
  return acc[depth - 1];
}

// One row of a K8 part: the sum of term(pos[k]) over k0 <= k < k1 in the
// chain's association, a row of at most kSlots positions with kRowAhead of
// its pos loads in flight.
template <typename T, typename Term>
__device__ __forceinline__ T part_row(const int* __restrict__ pos, int k0,
                                      int k1, Term term) {
  if (k1 - k0 > kSlots) {
    return chain_sum<T>(k0, k1, [&](int k) { return term(pos[k]); });
  }
  T acc = T(0);
  for (int k = k0; k < k1; k += kRowAhead) {
    int q[kRowAhead];
#pragma unroll
    for (int u = 0; u < kRowAhead; ++u) {
      if (k + u < k1) q[u] = pos[k + u];
    }
#pragma unroll
    for (int u = 0; u < kRowAhead; ++u) {
      if (k + u < k1) acc = add_rn(acc, term(q[u]));
    }
  }
  return acc;
}

// K8's rows of one zone, [r, r1) by kZoneThreads: each row's sum, added to y when
// accumulating.  The next row's rptr pair and y are loaded while this row
// sums, so a row waits on its pos loads alone.
template <typename T, typename Term>
__device__ __forceinline__ void part_rows(const int* __restrict__ rptr,
                                          const int* __restrict__ pos,
                                          T* __restrict__ y, int r, int r1,
                                          int accumulate, int k0, int k1,
                                          T y0, Term term) {
  for (; r < r1; r += kZoneThreads) {
    const int rn = r + kZoneThreads;
    int k0n = 0, k1n = 0;
    T yn = T(0);
    if (rn < r1) {
      k0n = rptr[rn];
      k1n = rptr[rn + 1];
      if (accumulate) yn = y[rn];
    }
    const T acc = part_row<T>(pos, k0, k1, term);
    y[r] = accumulate ? add_rn(y0, acc) : acc;
    k0 = k0n;
    k1 = k1n;
    y0 = yn;
  }
}

// K8, one column part: a block per zone of rows_per_zone rows.  A zone's
// positions [zstart[z], zstart[z+1]) are its rows' products, column-sorted;
// the block forms them into shared memory (coalesced gcol / gdata reads,
// kAhead a thread in flight, x gathered in column order), then each thread
// sums rows from there at their R positions.  A zone larger than the
// shared buffer forms each product where its row reads it (gdata, gcol
// through L1).  Only the rows read y, the previous part's output: a part
// launched to overlap its predecessor (programmatic dependent launch)
// forms its products while that one ends, and waits before its rows.
template <typename T>
__global__ void __launch_bounds__(kZoneThreads)
scatter_part_kernel(const int* __restrict__ gcol, const T* __restrict__ gdata,
                    const T* __restrict__ x, const int* __restrict__ zstart,
                    const int* __restrict__ rptr, const int* __restrict__ pos,
                    T* __restrict__ y, int n_rows, int n_x, int rows_per_zone,
                    int smem_elems, int accumulate) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* prod = reinterpret_cast<T*>(smem_raw);
  // the next part may start its products now
  asm volatile("griddepcontrol.launch_dependents;");
  const int z = blockIdx.x;
  const int p0 = zstart[z];
  const int len = zstart[z + 1] - p0;
  const long long r_lo = static_cast<long long>(z) * rows_per_zone;
  const int r1 = static_cast<int>(
      r_lo + rows_per_zone < n_rows ? r_lo + rows_per_zone : n_rows);
  const int r = static_cast<int>(r_lo) + threadIdx.x;
  const int k0 = r < r1 ? rptr[r] : 0;
  const int k1 = r < r1 ? rptr[r + 1] : 0;
  if (len <= smem_elems) {
    for (int i0 = threadIdx.x; i0 < len; i0 += kZoneThreads * kAhead) {
      int c[kAhead];
      T d[kAhead], v[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int i = i0 + u * kZoneThreads;
        c[u] = i < len ? gcol[p0 + i] : -1;
        d[u] = i < len ? gdata[p0 + i] : T(0);
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        v[u] = (c[u] >= 0 && c[u] < n_x) ? mul_rn(d[u], x[c[u]]) : T(0);
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int i = i0 + u * kZoneThreads;
        if (i < len) prod[i] = v[u];
      }
    }
    __syncthreads();
  }
  // the previous grid on the stream has ended and its y is visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const T y0 = (accumulate && r < r1) ? y[r] : T(0);
  if (len <= smem_elems) {
    part_rows<T>(rptr, pos, y, r, r1, accumulate, k0, k1, y0,
                 [&](int q) { return prod[q - p0]; });
  } else {
    part_rows<T>(rptr, pos, y, r, r1, accumulate, k0, k1, y0, [&](int q) {
      const int c = gcol[q];
      return (c >= 0 && c < n_x) ? mul_rn(gdata[q], x[c]) : T(0);
    });
  }
}

// K6's loads: V consecutive values of T as one load or store (16 bytes at
// most; the caller guarantees the alignment).
template <typename T, int V> struct VecOf;
template <> struct VecOf<float, 1> { using type = float; };
template <> struct VecOf<float, 2> { using type = float2; };
template <> struct VecOf<float, 4> { using type = float4; };
template <> struct VecOf<double, 1> { using type = double; };
template <> struct VecOf<double, 2> { using type = double2; };

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, T (&v)[V]) {
  using W = typename VecOf<T, V>::type;
  const W w = __ldg(reinterpret_cast<const W*>(p));
  const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
  for (int m = 0; m < V; ++m) v[m] = e[m];
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const T (&v)[V]) {
  using W = typename VecOf<T, V>::type;
  W w;
  T* e = reinterpret_cast<T*>(&w);
#pragma unroll
  for (int m = 0; m < V; ++m) e[m] = v[m];
  *reinterpret_cast<W*>(p) = w;
}

// K6's X values a lane holds for one block, B x V x C, at most (the
// launcher refuses a plan past it: more registers cost occupancy), and its
// blocks in flight: A blocks of them, at most 16 values (the B x B block is
// read from shared memory as it is used).
constexpr int kBsrMaxValues = 8;
constexpr int bsr_ahead(int per_block) {
  return per_block >= 8 ? 2 : per_block >= 4 ? 4 : 8;
}

// Copy blocks [s0, s1) of the tables into the stage: coalesced over the
// thread block, 16 bytes a thread where the data segment is aligned.
template <typename T>
__device__ __forceinline__ void bsr_stage(const int* __restrict__ indices,
                                          const T* __restrict__ data,
                                          int* s_idx, T* s_data, int s0,
                                          int s1, int bb) {
  constexpr int kW = 16 / static_cast<int>(sizeof(T));   // 4 or 2
  constexpr int kWShift = kW == 4 ? 2 : 1;
  const T* src = data + static_cast<long long>(s0) * bb;
  const int n_el = (s1 - s0) * bb;
  int e0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    using W = typename VecOf<T, kW>::type;
    const int nv = n_el >> kWShift;
    for (int q = threadIdx.x; q < nv; q += kBsrThreads) {
      reinterpret_cast<W*>(s_data)[q] = __ldg(reinterpret_cast<const W*>(src) + q);
    }
    e0 = nv << kWShift;
  }
  for (int e = e0 + threadIdx.x; e < n_el; e += kBsrThreads) {
    s_data[e] = __ldg(src + e);
  }
  for (int e = threadIdx.x; e < s1 - s0; e += kBsrThreads) {
    s_idx[e] = __ldg(indices + s0 + e);
  }
}

// One lane's walk over staged blocks [k0, k1) of its block row: A blocks'
// indices, then their X loads (V columns a load, C slots `slot` columns
// apart from column c0), then each block's B x B values from the stage and
// the FMAs, block by block, j ascending: each output one FMA chain.
template <typename T, int B, int V, int C, int A>
__device__ __forceinline__ void bsr_walk(const int* s_idx, const T* s_data,
                                         int k0, int k1,
                                         const T* __restrict__ X, int nrhs,
                                         int c0, int slot,
                                         T (&acc)[B][C][V]) {
  constexpr int kW = 16 / static_cast<int>(sizeof(T));
  for (int k = k0; k < k1; k += A) {
    int bc[A];
#pragma unroll
    for (int u = 0; u < A; ++u) bc[u] = k + u < k1 ? s_idx[k + u] : 0;
    T xv[A][B][C][V];
#pragma unroll
    for (int u = 0; u < A; ++u)
#pragma unroll
      for (int j = 0; j < B; ++j)
#pragma unroll
        for (int s = 0; s < C; ++s) {
          const int c = c0 + s * slot;
          if (k + u < k1 && c < nrhs) {
            load_vec<T, V>(X + (static_cast<long long>(bc[u]) * B + j) * nrhs + c,
                           xv[u][j][s]);
          } else {
#pragma unroll
            for (int m = 0; m < V; ++m) xv[u][j][s][m] = T(0);
          }
        }
#pragma unroll
    for (int u = 0; u < A; ++u) {
      if (k + u < k1) {
        const T* p = s_data + (k + u) * (B * B);
        T d[B * B];
        if constexpr ((B * B) % kW == 0) {
          using W = typename VecOf<T, kW>::type;
#pragma unroll
          for (int q = 0; q < B * B; q += kW) {
            const W w = *reinterpret_cast<const W*>(p + q);
            const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
            for (int m = 0; m < kW; ++m) d[q + m] = e[m];
          }
        } else {
#pragma unroll
          for (int q = 0; q < B * B; ++q) d[q] = p[q];
        }
#pragma unroll
        for (int r = 0; r < B; ++r)
#pragma unroll
          for (int j = 0; j < B; ++j)
#pragma unroll
            for (int s = 0; s < C; ++s)
#pragma unroll
              for (int m = 0; m < V; ++m)
                acc[r][s][m] = fma(d[r * B + j], xv[u][j][s][m], acc[r][s][m]);
      }
    }
  }
}

// K6 for b = B in {1, 2, 3, 4, 8}: a team of 2^team_shift lanes a block row,
// kBsrThreads >> team_shift consecutive block rows a thread block.  Lane l
// holds columns p0 + s * V * T + l * V + [0, V), s < C, of each pass p0 (V * C
// * T columns), B rows each.  The thread block's rows own one contiguous
// segment of the tables; it is copied into shared memory in chunks of at
// most stage_blocks blocks (once for all passes when it fits in one), and
// each lane walks its row's blocks in the chunk (bsr_walk).  Each output is
// one FMA chain in block order k, then j ascending, from +0: the sum of one
// thread an output, to the bit.
template <typename T, int B, int V, int C, int A>
__global__ void __launch_bounds__(kBsrThreads)
bsr_spmm_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                const T* __restrict__ data, const T* __restrict__ X,
                T* __restrict__ Y, int n_brows, int nrhs, int team_shift,
                int stage_blocks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_data = reinterpret_cast<T*>(smem_raw);
  int* s_idx = reinterpret_cast<int*>(s_data + stage_blocks * (B * B));
  const int rows = kBsrThreads >> team_shift;
  const long long i0 = static_cast<long long>(blockIdx.x) * rows;
  const int i_end = static_cast<int>(i0 + rows < n_brows ? i0 + rows : n_brows);
  const int i = static_cast<int>(i0) + (threadIdx.x >> team_shift);
  const int lane = threadIdx.x & ((1 << team_shift) - 1);
  const bool live = i < n_brows;
  const int kA = indptr[i0];
  const int kB = indptr[i_end];
  const int k0 = live ? indptr[i] : kA;
  const int k1 = live ? indptr[i + 1] : kA;
  const bool one_chunk = kB - kA <= stage_blocks;
  const int slot = V << team_shift;
  T* Yrow = Y + static_cast<long long>(i) * B * nrhs;
  for (int p0 = 0; p0 < nrhs; p0 += C * slot) {   // the same for all threads
    const int c0 = p0 + lane * V;
    T acc[B][C][V];
#pragma unroll
    for (int r = 0; r < B; ++r)
#pragma unroll
      for (int s = 0; s < C; ++s)
#pragma unroll
        for (int m = 0; m < V; ++m) acc[r][s][m] = T(0);
    for (int s0 = kA; s0 < kB; s0 += stage_blocks) {
      const int s1 = kB - s0 < stage_blocks ? kB : s0 + stage_blocks;
      if (p0 == 0 || !one_chunk) {
        __syncthreads();                 // the last chunk's readers are done
        bsr_stage<T>(indices, data, s_idx, s_data, s0, s1, B * B);
        __syncthreads();
      }
      const int lo = k0 > s0 ? k0 : s0;
      const int hi = k1 < s1 ? k1 : s1;
      if (lo < hi) {
        bsr_walk<T, B, V, C, A>(s_idx, s_data, lo - s0, hi - s0, X, nrhs, c0,
                                slot, acc);
      }
    }
    if (live) {
#pragma unroll
      for (int r = 0; r < B; ++r)
#pragma unroll
        for (int s = 0; s < C; ++s) {
          const int c = c0 + s * slot;
          if (c < nrhs) {
            store_vec<T, V>(Yrow + static_cast<long long>(r) * nrhs + c,
                            acc[r][s]);
          }
        }
    }
  }
}

// K6 for any other b: a thread block of (T, ry, rz) threads, T = blockDim.x
// lanes a team over the columns (one a lane in each pass), a team a pair
// (block row i, row r of the block): ry rows r of each of rz block rows, r
// walking by ry where b > ry, so that a block row's teams share their
// blocks and X rows in L1.  The lane reads each block's row r and the X
// values it meets in place (read-only path), the next block's index during
// this one's; the same sum order.
template <typename T>
__global__ void __launch_bounds__(kBsrThreads)
bsr_spmm_any_kernel(const int* __restrict__ indptr,
                    const int* __restrict__ indices, const T* __restrict__ data,
                    const T* __restrict__ X, T* __restrict__ Y, int n_brows,
                    int b, int nrhs) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.z + threadIdx.z;
  if (i >= n_brows) return;
  const int k0 = indptr[i];
  const int k1 = indptr[i + 1];
  const long long bb = static_cast<long long>(b) * b;
  for (int r = threadIdx.y; r < b; r += blockDim.y) {
    T* Yr = Y + (i * b + r) * nrhs;
    for (int c = threadIdx.x; c < nrhs; c += blockDim.x) {
      T acc = T(0);
      int bc = k0 < k1 ? __ldg(indices + k0) : 0;
      for (int k = k0; k < k1; ++k) {
        const int bc_next = k + 1 < k1 ? __ldg(indices + k + 1) : 0;
        const T* d = data + k * bb + static_cast<long long>(r) * b;
        const T* x = X + static_cast<long long>(bc) * b * nrhs + c;
        for (int j = 0; j < b; ++j) {
          acc = fma(__ldg(d + j), __ldg(x + static_cast<long long>(j) * nrhs),
                    acc);
        }
        bc = bc_next;
      }
      Yr[c] = acc;
    }
  }
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

// max_zone sizes the product buffer (at most kZoneSmemBytes): a zone past
// it is read through L1, so y does not depend on it.
template <typename T>
int launch_scatter_part(const void* gcol, const void* gdata, const void* x,
                        const void* zstart, const void* rptr, const void* pos,
                        void* y, int n_zones, int n_rows, int n_x,
                        int rows_per_zone, int max_zone, int accumulate,
                        int overlap, void* stream) {
  if (n_zones < 0 || n_rows < 0 || n_x < 0 || rows_per_zone < 1 ||
      max_zone < 0 ||
      static_cast<long long>(n_zones) * rows_per_zone < n_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_zones == 0 || n_rows == 0) return 0;
  const int cap = kZoneSmemBytes / static_cast<int>(sizeof(T));
  const int smem_elems = max_zone < cap ? max_zone : cap;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_zones));
  cfg.blockDim = dim3(kZoneThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_elems) * sizeof(T);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = overlap ? 1 : 0;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, scatter_part_kernel<T>, static_cast<const int*>(gcol),
      static_cast<const T*>(gdata), static_cast<const T*>(x),
      static_cast<const int*>(zstart), static_cast<const int*>(rptr),
      static_cast<const int*>(pos), static_cast<T*>(y), n_rows, n_x,
      rows_per_zone, smem_elems, accumulate);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

template <typename T, int B, int V, int C>
int launch_bsr_team(const void* indptr, const void* indices, const void* data,
                    const void* X, void* Y, int n_brows, int b, int nrhs,
                    int team_shift, int stage_blocks, void* stream) {
  const int rows = kBsrThreads >> team_shift;
  const unsigned grid =
      static_cast<unsigned>((static_cast<long long>(n_brows) + rows - 1) / rows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (B * V * C > kBsrMaxValues || (B == 0 && V * C > 1)) {
    return static_cast<int>(cudaErrorInvalidValue);   // not instantiated
  } else if constexpr (B == 0) {
    const int lanes = 1 << team_shift;
    const int ry = b < kBsrThreads / lanes ? b : kBsrThreads / lanes;
    const int rz = kBsrThreads / (lanes * ry);
    const unsigned groups =
        static_cast<unsigned>((static_cast<long long>(n_brows) + rz - 1) / rz);
    bsr_spmm_any_kernel<T><<<groups, dim3(lanes, ry, rz), 0, st>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(indices),
        static_cast<const T*>(data), static_cast<const T*>(X),
        static_cast<T*>(Y), n_brows, b, nrhs);
  } else {
    const size_t smem =
        static_cast<size_t>(stage_blocks) * (B * B * sizeof(T) + sizeof(int));
    bsr_spmm_kernel<T, B, V, C, bsr_ahead(B * V * C)>
        <<<grid, kBsrThreads, smem, st>>>(
            static_cast<const int*>(indptr), static_cast<const int*>(indices),
            static_cast<const T*>(data), static_cast<const T*>(X),
            static_cast<T*>(Y), n_brows, nrhs, team_shift, stage_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int B, int V>
int launch_bsr_c(int cols_per_lane, const void* indptr, const void* indices,
                 const void* data, const void* X, void* Y, int n_brows, int b,
                 int nrhs, int team_shift, int stage_blocks, void* stream) {
  switch (cols_per_lane) {
    case 1:
      return launch_bsr_team<T, B, V, 1>(indptr, indices, data, X, Y, n_brows,
                                         b, nrhs, team_shift, stage_blocks,
                                         stream);
    case 2:
      return launch_bsr_team<T, B, V, 2>(indptr, indices, data, X, Y, n_brows,
                                         b, nrhs, team_shift, stage_blocks,
                                         stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int B>
int launch_bsr_v(int vec, int cols_per_lane, const void* indptr,
                 const void* indices, const void* data, const void* X, void* Y,
                 int n_brows, int b, int nrhs, int team_shift,
                 int stage_blocks, void* stream) {
  switch (vec) {
    case 1:
      return launch_bsr_c<T, B, 1>(cols_per_lane, indptr, indices, data, X, Y,
                                   n_brows, b, nrhs, team_shift, stage_blocks,
                                   stream);
    case 2:
      return launch_bsr_c<T, B, 2>(cols_per_lane, indptr, indices, data, X, Y,
                                   n_brows, b, nrhs, team_shift, stage_blocks,
                                   stream);
    case 4:
      if constexpr (sizeof(T) == 4) {
        return launch_bsr_c<T, B, 4>(cols_per_lane, indptr, indices, data, X,
                                     Y, n_brows, b, nrhs, team_shift,
                                     stage_blocks, stream);
      }
      [[fallthrough]];
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K6 with the wrapper's plan (ops/spmv.py bsr_spmm_plan): vec columns a
// load (X and Y aligned to vec values, nrhs a multiple of vec), cols_per_lane
// slots a lane, teams of 2^team_shift lanes, chunks of stage_blocks blocks in
// shared memory (at least 1 where there are blocks, at most kBsrStageBytes).
// b = 1, 2, 3, 4 and 8 have their own instantiation; any other b takes the
// generic kernel (vec 1, one slot a lane, nothing staged: stage_blocks 0).
template <typename T>
int launch_bsr_spmm(const void* indptr, const void* indices, const void* data,
                    const void* X, void* Y, int n_brows, int b, int nrhs,
                    int vec, int cols_per_lane, int team_shift,
                    int stage_blocks, void* stream) {
  const long long stage_bytes =
      static_cast<long long>(stage_blocks) *
      (static_cast<long long>(b) * b * static_cast<long long>(sizeof(T)) + 4);
  const long long align = static_cast<long long>(vec) * sizeof(T);
  const bool staged = b == 1 || b == 2 || b == 3 || b == 4 || b == 8;
  if (n_brows < 0 || b < 1 || nrhs < 0 || vec < 1 || team_shift < 0 ||
      team_shift > 5 || stage_blocks < 0 || stage_bytes > kBsrStageBytes ||
      (staged ? stage_blocks < 1 : stage_blocks != 0) || nrhs % vec != 0 ||
      reinterpret_cast<uintptr_t>(X) % static_cast<uintptr_t>(align) != 0 ||
      reinterpret_cast<uintptr_t>(Y) % static_cast<uintptr_t>(align) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_brows == 0 || nrhs == 0) return 0;
  switch (b) {
    case 1:
      return launch_bsr_v<T, 1>(vec, cols_per_lane, indptr, indices, data, X,
                                Y, n_brows, b, nrhs, team_shift, stage_blocks,
                                stream);
    case 2:
      return launch_bsr_v<T, 2>(vec, cols_per_lane, indptr, indices, data, X,
                                Y, n_brows, b, nrhs, team_shift, stage_blocks,
                                stream);
    case 3:
      return launch_bsr_v<T, 3>(vec, cols_per_lane, indptr, indices, data, X,
                                Y, n_brows, b, nrhs, team_shift, stage_blocks,
                                stream);
    case 4:
      return launch_bsr_v<T, 4>(vec, cols_per_lane, indptr, indices, data, X,
                                Y, n_brows, b, nrhs, team_shift, stage_blocks,
                                stream);
    case 8:
      return launch_bsr_v<T, 8>(vec, cols_per_lane, indptr, indices, data, X,
                                Y, n_brows, b, nrhs, team_shift, stage_blocks,
                                stream);
    default:
      return launch_bsr_v<T, 0>(vec, cols_per_lane, indptr, indices, data, X,
                                Y, n_brows, b, nrhs, team_shift, stage_blocks,
                                stream);
  }
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

int scatter_part_f32(const void* gcol, const void* gdata, const void* x,
                     const void* zstart, const void* rptr, const void* pos,
                     void* y, int n_zones, int n_rows, int n_x,
                     int rows_per_zone, int max_zone, int accumulate,
                     int overlap, void* stream) {
  return launch_scatter_part<float>(gcol, gdata, x, zstart, rptr, pos, y,
                                    n_zones, n_rows, n_x, rows_per_zone,
                                    max_zone, accumulate, overlap, stream);
}

int scatter_part_f64(const void* gcol, const void* gdata, const void* x,
                     const void* zstart, const void* rptr, const void* pos,
                     void* y, int n_zones, int n_rows, int n_x,
                     int rows_per_zone, int max_zone, int accumulate,
                     int overlap, void* stream) {
  return launch_scatter_part<double>(gcol, gdata, x, zstart, rptr, pos, y,
                                     n_zones, n_rows, n_x, rows_per_zone,
                                     max_zone, accumulate, overlap, stream);
}

int bsr_spmm_f32(const void* indptr, const void* indices, const void* data,
                 const void* X, void* Y, int n_brows, int b, int nrhs, int vec,
                 int cols_per_lane, int team_shift, int stage_blocks,
                 void* stream) {
  return launch_bsr_spmm<float>(indptr, indices, data, X, Y, n_brows, b, nrhs,
                                vec, cols_per_lane, team_shift, stage_blocks,
                                stream);
}

int bsr_spmm_f64(const void* indptr, const void* indices, const void* data,
                 const void* X, void* Y, int n_brows, int b, int nrhs, int vec,
                 int cols_per_lane, int team_shift, int stage_blocks,
                 void* stream) {
  return launch_bsr_spmm<double>(indptr, indices, data, X, Y, n_brows, b,
                                 nrhs, vec, cols_per_lane, team_shift,
                                 stage_blocks, stream);
}

}  // extern "C"
