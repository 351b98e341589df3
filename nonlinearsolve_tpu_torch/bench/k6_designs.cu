// Design study of K6 (bsr_spmm, ../csrc/spmv.cu) on the card: one
// stand-alone program, built and run with
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o k6_designs nonlinearsolve_tpu_torch/bench/k6_designs.cu
//   ./k6_designs                                  (about a minute)
//
// Y = A X for A in block CSR and a dense row-major X (n_cols x nrhs), f32 and
// f64, nrhs 8 and 37, on
//   bru512    the 512^2 Brusselator Jacobian's pattern as BSR with b = 2: a
//             periodic grid point's two species one block, its 5-point
//             stencil five blocks (262,144 block rows, 1,310,720 blocks),
//             built here;
//   rand_b*   a seeded random pattern, b = 1, 3, 4, 5 and 12 (the generic
//             kernel) and 8: 0-8 blocks a row at random columns, every 50th
//             block row empty, block row 1000 holding 70 blocks (131,072
//             block rows; 32,768 at b = 8 and 12),
// with seeded data (one value in five an exact zero) and X.  It times one
// call of
//   per_output  the earlier design: one thread an output (row, c), two
//             64-bit divisions, the block row walked one block at a time
//   shipped   csrc/spmv.cu's K6 with the wrapper's plan (ops/spmv.py
//             bsr_spmm_plan, repeated below): a team of lanes a block row,
//             lanes over columns, the thread block's blocks staged in shared
//             memory, X loaded A blocks ahead
//   wide      the first plan tried: the smallest team of at most 32 lanes
//             that covers the columns, two slots a lane for 33-64 groups
//   v1        the shipped plan with one column a load (no 16-byte loads)
//   any chunk 8, 4  for b = 5 and 12 (the generic kernel): the shipped
//             teams loading 8 or 4 of a block row's values and their X
//             before the FMAs, not one at a time
//   any T8xC2, any T8xC1  teams of 8 lanes with two column slots a lane
//             or one, one value at a time (nrhs 37)
// and at b = 2 (bru512):
//   direct    the shipped teams with nothing staged: each lane reads its
//             row's indices and blocks itself (read-only path, broadcast
//             across the team), A blocks ahead
//   A2, A8    2 or 8 blocks in flight a lane instead of bsr_ahead's
//   TtxVvxCc  other team widths t, values a load v and column slots a lane
//             c (nrhs 37: one team of 32 in two passes, 32 + 5, against
//             more slots a lane or narrower teams in more passes)
//   shuffle   a team per block row with no shared memory: lane l loads
//             block k + l's index and data once, the team hands them round
//             by __shfl_sync
// as CUDA events over 5 replays of a CUDA graph of 20 calls (after one
// warm-up replay), three rounds (min-max printed, microseconds a call),
// beside the byte bound (each input read once, Y written once, at
// 3.35 TB/s).  Each design's output is held against per_output's bit for
// bit: the program prints the largest |difference| and the count of outputs
// whose bits differ, which must be 0, and exits 1 otherwise.

#include "../csrc/spmv.cu"

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <functional>
#include <string>
#include <vector>

namespace {

#define CK(x)                                                              \
  do {                                                                     \
    cudaError_t e_ = (x);                                                  \
    if (e_ != cudaSuccess) {                                               \
      std::fprintf(stderr, "%s:%d %s\n", __FILE__, __LINE__,               \
                   cudaGetErrorString(e_));                                \
      std::exit(1);                                                        \
    }                                                                      \
  } while (0)

constexpr double kHbmBytesPerS = 3.35e12;

// K6's earlier design: one thread an output
template <typename T>
__global__ void __launch_bounds__(256)
per_output_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
           const T* __restrict__ data, const T* __restrict__ X,
           T* __restrict__ Y, long long n_out, int b, int nrhs) {
  const long long t = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (t >= n_out) return;
  const long long row = t / nrhs;
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

// The shuffle design, b = 2: a team of 2^team_shift lanes a block row, V
// columns a load; blocks in stages of one a lane, each block's index and
// data loaded by one lane and handed round by __shfl_sync.
template <typename T, int V>
__global__ void __launch_bounds__(256)
shuffle_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
               const T* __restrict__ data, const T* __restrict__ X,
               T* __restrict__ Y, int n_brows, int nrhs, int team_shift) {
  constexpr int B = 2;
  const int tw = 1 << team_shift;
  const int i = static_cast<int>(
      (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) >> team_shift);
  const int lane = threadIdx.x & (tw - 1);
  const unsigned mask =
      tw == 32 ? 0xffffffffu
               : ((1u << tw) - 1) << ((threadIdx.x & 31) & ~(tw - 1));
  if (i >= n_brows) return;
  const int k0 = indptr[i];
  const int k1 = indptr[i + 1];
  T* Yrow = Y + static_cast<long long>(i) * B * nrhs;
  for (int p0 = 0; p0 < nrhs; p0 += V << team_shift) {
    const int c = p0 + lane * V;
    T acc[B][V];
#pragma unroll
    for (int r = 0; r < B; ++r)
#pragma unroll
      for (int m = 0; m < V; ++m) acc[r][m] = T(0);
    for (int k = k0; k < k1; k += tw) {
      const bool mine = k + lane < k1;
      const int my_bc = mine ? __ldg(indices + k + lane) : 0;
      T my_d[B * B];
#pragma unroll
      for (int q = 0; q < B * B; ++q) {
        my_d[q] = mine ? __ldg(data + static_cast<long long>(k + lane) * 4 + q)
                       : T(0);
      }
      const int n = k1 - k < tw ? k1 - k : tw;
      for (int s = 0; s < n; ++s) {
        const int bc = __shfl_sync(mask, my_bc, s, tw);
        T d[B * B];
#pragma unroll
        for (int q = 0; q < B * B; ++q) d[q] = __shfl_sync(mask, my_d[q], s, tw);
        T xv[B][V];
#pragma unroll
        for (int j = 0; j < B; ++j) {
          if (c < nrhs) {
            load_vec<T, V>(X + (static_cast<long long>(bc) * B + j) * nrhs + c,
                           xv[j]);
          } else {
#pragma unroll
            for (int m = 0; m < V; ++m) xv[j][m] = T(0);
          }
        }
#pragma unroll
        for (int r = 0; r < B; ++r)
#pragma unroll
          for (int j = 0; j < B; ++j)
#pragma unroll
            for (int m = 0; m < V; ++m)
              acc[r][m] = fma(d[r * B + j], xv[j][m], acc[r][m]);
      }
    }
    if (c < nrhs) {
#pragma unroll
      for (int r = 0; r < B; ++r)
        store_vec<T, V>(Yrow + static_cast<long long>(r) * nrhs + c, acc[r]);
    }
  }
}

// The direct design, b = 2: the shipped teams and columns with nothing
// staged: each lane reads its row's block indices and blocks itself through
// the read-only path (a broadcast across the team), A blocks' indices, data
// and X loaded before their FMAs.
template <typename T, int V, int C, int A>
__global__ void __launch_bounds__(256)
direct_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
              const T* __restrict__ data, const T* __restrict__ X,
              T* __restrict__ Y, int n_brows, int nrhs, int team_shift) {
  constexpr int B = 2;
  const int rows = 256 >> team_shift;
  const int i = static_cast<int>(static_cast<long long>(blockIdx.x) * rows) +
                (threadIdx.x >> team_shift);
  if (i >= n_brows) return;
  const int lane = threadIdx.x & ((1 << team_shift) - 1);
  const int slot = V << team_shift;
  const int k0 = indptr[i];
  const int k1 = indptr[i + 1];
  T* Yrow = Y + static_cast<long long>(i) * B * nrhs;
  for (int c0 = lane * V; c0 < nrhs; c0 += C * slot) {
    T acc[B][C][V] = {};
    for (int k = k0; k < k1; k += A) {
      int bc[A];
      T d[A][B * B];
#pragma unroll
      for (int u = 0; u < A; ++u) {
        bc[u] = k + u < k1 ? __ldg(indices + k + u) : 0;
#pragma unroll
        for (int q = 0; q < B * B; ++q) {
          d[u][q] = k + u < k1 ? __ldg(data + static_cast<long long>(k + u) * 4 + q)
                               : T(0);
        }
      }
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
#pragma unroll
          for (int r = 0; r < B; ++r)
#pragma unroll
            for (int j = 0; j < B; ++j)
#pragma unroll
              for (int s = 0; s < C; ++s)
#pragma unroll
                for (int m = 0; m < V; ++m)
                  acc[r][s][m] = fma(d[u][r * B + j], xv[u][j][s][m], acc[r][s][m]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < B; ++r)
#pragma unroll
      for (int s = 0; s < C; ++s) {
        const int c = c0 + s * slot;
        if (c < nrhs) store_vec<T, V>(Yrow + static_cast<long long>(r) * nrhs + c, acc[r][s]);
      }
  }
}

// The generic kernel's designs for any b: C column slots a lane, kChunk of
// a block row's values and their X loaded before the FMAs (the shipped one
// takes one slot and one value at a time).
template <typename T, int C, int kChunk>
__global__ void __launch_bounds__(kBsrThreads)
any_chunk_kernel(const int* __restrict__ indptr,
                 const int* __restrict__ indices, const T* __restrict__ data,
                 const T* __restrict__ X, T* __restrict__ Y, int n_brows,
                 int b, int nrhs) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.z + threadIdx.z;
  if (i >= n_brows) return;
  const int slot = blockDim.x;
  const int k0 = indptr[i];
  const int k1 = indptr[i + 1];
  const long long bb = static_cast<long long>(b) * b;
  for (int r = threadIdx.y; r < b; r += blockDim.y) {
    T* Yr = Y + (i * b + r) * nrhs;
    for (int c0 = threadIdx.x; c0 < nrhs; c0 += C * slot) {
      T acc[C];
#pragma unroll
      for (int s = 0; s < C; ++s) acc[s] = T(0);
      int bc = k0 < k1 ? __ldg(indices + k0) : 0;
      for (int k = k0; k < k1; ++k) {
        const int bc_next = k + 1 < k1 ? __ldg(indices + k + 1) : 0;
        const T* d = data + k * bb + static_cast<long long>(r) * b;
        const T* x = X + static_cast<long long>(bc) * b * nrhs;
        for (int j0 = 0; j0 < b; j0 += kChunk) {
          T dv[kChunk];
          T xv[kChunk][C];
#pragma unroll
          for (int q = 0; q < kChunk; ++q) {
            const int j = j0 + q;
            dv[q] = j < b ? __ldg(d + j) : T(0);
#pragma unroll
            for (int s = 0; s < C; ++s) {
              const int c = c0 + s * slot;
              xv[q][s] = (j < b && c < nrhs)
                             ? __ldg(x + static_cast<long long>(j) * nrhs + c)
                             : T(0);
            }
          }
#pragma unroll
          for (int q = 0; q < kChunk; ++q) {
            if (j0 + q < b) {
#pragma unroll
              for (int s = 0; s < C; ++s) acc[s] = fma(dv[q], xv[q][s], acc[s]);
            }
          }
        }
        bc = bc_next;
      }
#pragma unroll
      for (int s = 0; s < C; ++s) {
        const int c = c0 + s * slot;
        if (c < nrhs) Yr[c] = acc[s];
      }
    }
  }
}

// The device tables and the call shape of one case, for the b = 2 variants
template <typename T>
struct Args {
  const int* indptr;
  const int* indices;
  const T* data;
  const T* X;
  T* Y;
  int n_brows, nrhs;
  cudaStream_t st;
};

// csrc/spmv.cu's kernel at b = 2 with V, C and A given
template <typename T, int V, int C, int A>
std::function<void()> staged_b2(Args<T> a, int shift, int stage) {
  return [=] {
    const int rows = kBsrThreads >> shift;
    const unsigned grid = static_cast<unsigned>((a.n_brows + rows - 1) / rows);
    const size_t smem = static_cast<size_t>(stage) * (4 * sizeof(T) + 4);
    bsr_spmm_kernel<T, 2, V, C, A><<<grid, kBsrThreads, smem, a.st>>>(
        a.indptr, a.indices, a.data, a.X, a.Y, a.n_brows, a.nrhs, shift, stage);
  };
}

template <typename T, int V, int C, int A>
std::function<void()> direct_b2(Args<T> a, int shift) {
  return [=] {
    const int rows = 256 >> shift;
    const unsigned grid = static_cast<unsigned>((a.n_brows + rows - 1) / rows);
    direct_kernel<T, V, C, A><<<grid, 256, 0, a.st>>>(
        a.indptr, a.indices, a.data, a.X, a.Y, a.n_brows, a.nrhs, shift);
  };
}

struct Pattern {
  std::string name;
  int b = 0;
  int n_brows = 0;
  int n_bcols = 0;
  std::vector<int> indptr, indices;
};

// The 512^2 Brusselator's Jacobian pattern, point (x, y) = block row
// x * N + y, its block columns the points (x +- 1, y), (x, y +- 1) and
// itself, periodic, ascending.
Pattern brusselator(int N) {
  Pattern P;
  P.name = "bru512_b2";
  P.b = 2;
  P.n_brows = P.n_bcols = N * N;
  P.indptr.push_back(0);
  for (int x = 0; x < N; ++x) {
    for (int y = 0; y < N; ++y) {
      int c[5] = {((x + N - 1) % N) * N + y, x * N + (y + N - 1) % N,
                  x * N + y, x * N + (y + 1) % N, ((x + 1) % N) * N + y};
      std::sort(c, c + 5);
      for (int q = 0; q < 5; ++q) P.indices.push_back(c[q]);
      P.indptr.push_back(static_cast<int>(P.indices.size()));
    }
  }
  return P;
}

uint64_t splitmix(uint64_t& s) {
  uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

Pattern random_pattern(int b, int n_brows, uint64_t seed) {
  Pattern P;
  P.name = "rand_b" + std::to_string(b);
  P.b = b;
  P.n_brows = P.n_bcols = n_brows;
  P.indptr.push_back(0);
  std::vector<int> cols;
  for (int i = 0; i < n_brows; ++i) {
    int cnt = static_cast<int>(splitmix(seed) % 9);
    if (i % 50 == 0) cnt = 0;
    if (i == 1000) cnt = 70;
    cols.clear();
    while (static_cast<int>(cols.size()) < cnt) {
      const int c = static_cast<int>(splitmix(seed) % n_brows);
      if (std::find(cols.begin(), cols.end(), c) == cols.end()) cols.push_back(c);
    }
    std::sort(cols.begin(), cols.end());
    P.indices.insert(P.indices.end(), cols.begin(), cols.end());
    P.indptr.push_back(static_cast<int>(P.indices.size()));
  }
  return P;
}

template <typename T>
std::vector<T> seeded(size_t n, uint64_t seed, bool zeros) {
  std::vector<T> v(n);
  for (auto& e : v) {
    const uint64_t z = splitmix(seed);
    e = (zeros && z % 5 == 0)
            ? T(0)
            : static_cast<T>(static_cast<double>(z >> 11) * 0x1.0p-52 - 1.0);
  }
  return v;
}

// ops/spmv.py bsr_spmm_plan: block-size instantiation, values a load, column
// slots a lane, team width (log2), for an X whose address is a multiple of
// x_align bytes
struct Plan {
  int vec, cols_per_lane, team_shift;
};

constexpr int kMaxValues = 8;   // ops/spmv.py BSR_MAX_VALUES

Plan bsr_plan(int b, int nrhs, int item, int x_align) {
  const bool inst = b == 1 || b == 2 || b == 3 || b == 4 || b == 8;
  int vec = 1;
  if (inst) {
    for (int v = 16 / item; v > 1; v /= 2) {
      if (nrhs % v == 0 && x_align % (v * item) == 0 && b * v <= kMaxValues) {
        vec = v;
        break;
      }
    }
  }
  const int groups = std::max(1, (nrhs + vec - 1) / vec);
  int cols = 1, team = groups;
  if (groups > 8) {
    if (inst && b * vec * 2 <= kMaxValues) {
      cols = 2;
      team = 8;
    } else {
      team = std::min(groups, 32);
    }
  }
  int shift = 0;
  while ((1 << shift) < team) ++shift;
  return {vec, cols, shift};
}

// the first design's plan: the smallest team of at most 32 lanes that
// covers the column groups, two slots a lane where 33-64 are left and the
// block size is instantiated ("wide")
Plan wide_plan(int b, int nrhs, int item, int x_align) {
  Plan p = bsr_plan(b, nrhs, item, x_align);
  const bool inst = b == 1 || b == 2 || b == 3 || b == 4 || b == 8;
  const int groups = std::max(1, (nrhs + p.vec - 1) / p.vec);
  p.team_shift = 0;
  while ((1 << p.team_shift) < groups && p.team_shift < 5) ++p.team_shift;
  p.cols_per_lane =
      (inst && groups > 32 && groups <= 64 && b * p.vec * 2 <= kMaxValues)
          ? 2 : 1;
  return p;
}

// ops/spmv.py bsr_stage_blocks: the chunk of staged blocks, the largest
// segment of 256 >> team_shift block rows, at least 1, at most what
// kBsrStageBytes holds; 0 for the generic kernel
int stage_blocks_for(const Pattern& P, int team_shift, int item) {
  const int rows = 256 >> team_shift;
  int most = 0;
  for (int i0 = 0; i0 < P.n_brows; i0 += rows) {
    const int i1 = std::min(i0 + rows, P.n_brows);
    most = std::max(most, P.indptr[i1] - P.indptr[i0]);
  }
  const bool inst = P.b == 1 || P.b == 2 || P.b == 3 || P.b == 4 || P.b == 8;
  const int per = P.b * P.b * item + 4;
  return inst ? std::max(1, std::min(most, kBsrStageBytes / per)) : 0;
}

float graph_us(cudaStream_t st, const std::function<void()>& call,
               int calls = 20, int replays = 5) {
  cudaGraph_t g;
  cudaGraphExec_t ge;
  CK(cudaStreamBeginCapture(st, cudaStreamCaptureModeGlobal));
  for (int c = 0; c < calls; ++c) call();
  CK(cudaStreamEndCapture(st, &g));
  CK(cudaGraphInstantiate(&ge, g, 0));
  CK(cudaGraphLaunch(ge, st));
  cudaEvent_t a, e;
  CK(cudaEventCreate(&a));
  CK(cudaEventCreate(&e));
  CK(cudaEventRecord(a, st));
  for (int r = 0; r < replays; ++r) CK(cudaGraphLaunch(ge, st));
  CK(cudaEventRecord(e, st));
  CK(cudaEventSynchronize(e));
  float ms = 0;
  CK(cudaEventElapsedTime(&ms, a, e));
  CK(cudaGraphExecDestroy(ge));
  CK(cudaGraphDestroy(g));
  CK(cudaEventDestroy(a));
  CK(cudaEventDestroy(e));
  return ms * 1e3f / (calls * replays);
}

struct Design {
  std::string name;
  std::function<void()> call;
};

int g_failures = 0;

template <typename T>
void run_case(const Pattern& P, int nrhs, cudaStream_t st) {
  const int b = P.b;
  const int item = static_cast<int>(sizeof(T));
  const long long nblocks = P.indptr.back();
  const long long n_out = static_cast<long long>(P.n_brows) * b * nrhs;
  const long long n_x = static_cast<long long>(P.n_bcols) * b * nrhs;
  const auto h_data = seeded<T>(static_cast<size_t>(nblocks) * b * b, 11 + b, true);
  const auto h_x = seeded<T>(static_cast<size_t>(n_x), 23 + nrhs, false);
  int *indptr, *indices;
  T *data, *X, *Y, *Yref;
  CK(cudaMalloc(&indptr, P.indptr.size() * sizeof(int)));
  CK(cudaMalloc(&indices, std::max<size_t>(P.indices.size(), 1) * sizeof(int)));
  CK(cudaMalloc(&data, std::max<size_t>(h_data.size(), 1) * sizeof(T)));
  CK(cudaMalloc(&X, n_x * sizeof(T)));
  CK(cudaMalloc(&Y, n_out * sizeof(T)));
  CK(cudaMalloc(&Yref, n_out * sizeof(T)));
  CK(cudaMemcpy(indptr, P.indptr.data(), P.indptr.size() * sizeof(int),
                cudaMemcpyHostToDevice));
  CK(cudaMemcpy(indices, P.indices.data(), P.indices.size() * sizeof(int),
                cudaMemcpyHostToDevice));
  CK(cudaMemcpy(data, h_data.data(), h_data.size() * sizeof(T),
                cudaMemcpyHostToDevice));
  CK(cudaMemcpy(X, h_x.data(), n_x * sizeof(T), cudaMemcpyHostToDevice));

  const int n_brows = P.n_brows;
  auto shipped_call = [=](int vec, int cols, int shift, int stage) {
    return [=] {
      const int rc = launch_bsr_spmm<T>(indptr, indices, data, X, Y, n_brows,
                                        b, nrhs, vec, cols, shift, stage, st);
      if (rc != 0) {
        std::fprintf(stderr, "launch refused: %s\n",
                     cudaGetErrorString(static_cast<cudaError_t>(rc)));
        std::exit(1);
      }
    };
  };
  const Plan pl = bsr_plan(b, nrhs, item, 16);
  const int stage = stage_blocks_for(P, pl.team_shift, item);
  char label[160];
  std::vector<Design> designs;
  designs.push_back({"per_output", [=] {
    const long long grid = (n_out + 255) / 256;
    per_output_kernel<T><<<static_cast<unsigned>(grid), 256, 0, st>>>(
        indptr, indices, data, X, Y, n_out, b, nrhs);
  }});
  std::snprintf(label, sizeof label, "shipped T%dxV%dxC%d stage %d",
                1 << pl.team_shift, pl.vec, pl.cols_per_lane, stage);
  designs.push_back({label, shipped_call(pl.vec, pl.cols_per_lane,
                                         pl.team_shift, stage)});
  const Plan pw = wide_plan(b, nrhs, item, 16);
  if (pw.team_shift != pl.team_shift || pw.cols_per_lane != pl.cols_per_lane) {
    std::snprintf(label, sizeof label, "wide T%dxV%dxC%d", 1 << pw.team_shift,
                  pw.vec, pw.cols_per_lane);
    designs.push_back({label, shipped_call(pw.vec, pw.cols_per_lane,
                                           pw.team_shift,
                                           stage_blocks_for(P, pw.team_shift,
                                                            item))});
  }
  if (pl.vec > 1) {
    const Plan p1 = bsr_plan(b, nrhs, item, item);      // X not 16-aligned
    std::snprintf(label, sizeof label, "v1 T%dxC%d", 1 << p1.team_shift,
                  p1.cols_per_lane);
    designs.push_back({label, shipped_call(1, p1.cols_per_lane, p1.team_shift,
                                           stage_blocks_for(P, p1.team_shift,
                                                            item))});
  }
  const bool inst = b == 1 || b == 2 || b == 3 || b == 4 || b == 8;
  if (!inst) {                      // the generic kernel's chunk of loads
    const int lanes = 1 << pl.team_shift;
    const int ry = std::min(b, 256 / lanes);
    const int rz = 256 / (lanes * ry);
    const unsigned grid = static_cast<unsigned>((n_brows + rz - 1) / rz);
    const dim3 block(lanes, ry, rz);
    designs.push_back({"any chunk 8", [=] {
      any_chunk_kernel<T, 1, 8><<<grid, block, 0, st>>>(
          indptr, indices, data, X, Y, n_brows, b, nrhs);
    }});
    designs.push_back({"any chunk 4", [=] {
      any_chunk_kernel<T, 1, 4><<<grid, block, 0, st>>>(
          indptr, indices, data, X, Y, n_brows, b, nrhs);
    }});
    if (nrhs > 8) {                 // teams of 8: two slots a lane or one
      const int ry1 = std::min(b, 32);
      const int rz1 = 256 / (8 * ry1);
      const unsigned g1 = static_cast<unsigned>((n_brows + rz1 - 1) / rz1);
      designs.push_back({"any T8xC2", [=] {
        any_chunk_kernel<T, 2, 1><<<g1, dim3(8, ry1, rz1), 0, st>>>(
            indptr, indices, data, X, Y, n_brows, b, nrhs);
      }});
      designs.push_back({"any T8xC1", [=] {
        any_chunk_kernel<T, 1, 1><<<g1, dim3(8, ry1, rz1), 0, st>>>(
            indptr, indices, data, X, Y, n_brows, b, nrhs);
      }});
    }
  }
  if (b == 2) {
    constexpr int VW = 16 / sizeof(T);
    const Args<T> a{indptr, indices, data, X, Y, n_brows, nrhs, st};
    const int sh = pl.team_shift;
    auto stage_of = [&](int shift) { return stage_blocks_for(P, shift, item); };
    auto add = [&](const char* name, std::function<void()> f) {
      designs.push_back({name, std::move(f)});
    };
    if (nrhs <= 32) {                   // nrhs 8: one pass of 8 columns
      add("direct", direct_b2<T, VW, 1, 4>(a, sh));
      add("A2", staged_b2<T, VW, 1, 2>(a, sh, stage));
      add("A8", staged_b2<T, VW, 1, 8>(a, sh, stage));
      add("T4xV1xC2", staged_b2<T, 1, 2, 4>(a, 2, stage_of(2)));
      if constexpr (VW == 4) {
        add("T4xV2xC1", staged_b2<T, 2, 1, 4>(a, 2, stage_of(2)));
      } else {
        add("T2xV2xC2", staged_b2<T, 2, 2, 2>(a, 1, stage_of(1)));
      }
    } else {                            // nrhs 37: passes of 32 + 5, ...
      add("direct", direct_b2<T, 1, 2, 4>(a, sh));
      add("T32xC1", staged_b2<T, 1, 1, 8>(a, 5, stage_of(5)));
      add("T16xC2", staged_b2<T, 1, 2, 4>(a, 4, stage_of(4)));
      add("T8xC1", staged_b2<T, 1, 1, 8>(a, 3, stage_of(3)));
      add("T8xC2 A2", staged_b2<T, 1, 2, 2>(a, 3, stage_of(3)));
      add("T8xC4", staged_b2<T, 1, 4, 2>(a, 3, stage_of(3)));
      add("T4xC4", staged_b2<T, 1, 4, 2>(a, 2, stage_of(2)));
    }
    designs.push_back({"shuffle", [=] {
      const long long grid = ((static_cast<long long>(n_brows) << sh) + 255) / 256;
      if (pl.vec == VW) {
        shuffle_kernel<T, VW><<<static_cast<unsigned>(grid), 256, 0, st>>>(
            indptr, indices, data, X, Y, n_brows, nrhs, sh);
      } else {
        shuffle_kernel<T, 1><<<static_cast<unsigned>(grid), 256, 0, st>>>(
            indptr, indices, data, X, Y, n_brows, nrhs, sh);
      }
    }});
  }

  // per_output's output is the reference
  designs[0].call();
  CK(cudaStreamSynchronize(st));
  CK(cudaGetLastError());
  CK(cudaMemcpy(Yref, Y, n_out * sizeof(T), cudaMemcpyDeviceToDevice));
  std::vector<T> ref(n_out), got(n_out);
  CK(cudaMemcpy(ref.data(), Yref, n_out * sizeof(T), cudaMemcpyDeviceToHost));
  const double bytes = static_cast<double>(nblocks) * (b * b * item + 4) +
                       (P.n_brows + 1.0) * 4 +
                       static_cast<double>(n_x + n_out) * item;
  const double bound_us = bytes / kHbmBytesPerS * 1e6;
  std::vector<float> lo(designs.size(), 1e30f), hi(designs.size(), 0.f);
  std::vector<double> maxdiff(designs.size(), 0);
  std::vector<long long> ndiff(designs.size(), 0);
  for (size_t d = 0; d < designs.size(); ++d) {
    CK(cudaMemset(Y, 0xff, n_out * sizeof(T)));           // NaN everywhere
    designs[d].call();
    CK(cudaStreamSynchronize(st));
    CK(cudaGetLastError());
    CK(cudaMemcpy(got.data(), Y, n_out * sizeof(T), cudaMemcpyDeviceToHost));
    for (long long q = 0; q < n_out; ++q) {
      if (std::memcmp(&got[q], &ref[q], sizeof(T)) != 0) {
        ++ndiff[d];
        const double df = std::abs(static_cast<double>(got[q]) -
                                   static_cast<double>(ref[q]));
        maxdiff[d] = std::max(maxdiff[d], df != df ? INFINITY : df);
      }
    }
    if (ndiff[d] != 0) ++g_failures;
  }
  for (int round = 0; round < 3; ++round) {
    for (size_t d = 0; d < designs.size(); ++d) {
      const float us = graph_us(st, designs[d].call);
      lo[d] = std::min(lo[d], us);
      hi[d] = std::max(hi[d], us);
    }
  }
  std::printf("\n%s %s nrhs %d: %d block rows, %lld blocks, %.1f MB, bound "
              "%.2f us\n", P.name.c_str(), item == 8 ? "f64" : "f32", nrhs,
              P.n_brows, nblocks, bytes / 1e6, bound_us);
  for (size_t d = 0; d < designs.size(); ++d) {
    std::printf("  %-28s %9.2f - %9.2f us  share %.2f  max|diff| %.3g  "
                "differing %lld\n", designs[d].name.c_str(), lo[d], hi[d],
                bound_us / lo[d], maxdiff[d], ndiff[d]);
  }
  std::fflush(stdout);
  CK(cudaFree(indptr));
  CK(cudaFree(indices));
  CK(cudaFree(data));
  CK(cudaFree(X));
  CK(cudaFree(Y));
  CK(cudaFree(Yref));
}

}  // namespace

int main() {
  cudaDeviceProp prop;
  CK(cudaGetDeviceProperties(&prop, 0));
  std::printf("%s, %d SMs\n", prop.name, prop.multiProcessorCount);
  std::fflush(stdout);
  cudaStream_t st;
  CK(cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking));
  std::vector<Pattern> patterns;
  patterns.push_back(brusselator(512));
  for (int b : {1, 3, 4, 5, 8, 12}) {
    patterns.push_back(random_pattern(b, b >= 8 ? 32768 : 131072, 100 + b));
  }
  for (const auto& P : patterns) {
    for (int nrhs : {8, 37}) {
      run_case<float>(P, nrhs, st);
      run_case<double>(P, nrhs, st);
    }
  }
  CK(cudaStreamDestroy(st));
  std::printf("\n%s\n", g_failures == 0
                            ? "every design bit-equal to per_output"
                            : "SOME DESIGN DIFFERS FROM per_output");
  return g_failures == 0 ? 0 : 1;
}
