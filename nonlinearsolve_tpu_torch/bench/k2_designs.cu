// Design study of K2 (brusselator_jvp_scaled, ../csrc/stencil.cu) on the
// card: one stand-alone program, built and run with
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o k2_designs nonlinearsolve_tpu_torch/bench/k2_designs.cu
//   ./k2_designs
//
// At N=512 and 2048, f32, the interleaved (N, N, 2) layout, inv_scale a
// device scalar (as the chain passes it), it times one call of
//   k1         K1 (no scale, no max): the floor of the loads and arithmetic
//   parent     K2's kernel (one point a thread, one block a 32x8 tile, one
//              atomicMax a block into a zeroed word): alone (the word zeroed
//              once: the max of the same data again is the same), after a
//              memset node, after a one-thread zeroing kernel (as
//              torch.zeros zeroes it), or after that kernel as a
//              programmatic dependent launch (PDL)
//   one_point_atomic  the same kernel with no more blocks than the card
//              holds, walking the tiles (fewer atomics at N=2048)
//   two_point  two points a thread along j with 16-byte loads, neighbours
//              by warp shuffles, 8 or 16 rows a block, grid as above, with
//              or without PDL
//   one_point (cooperative), smem_tile (cooperative)  one launch, nothing
//              zeroed: a cooperative grid, partials, a grid barrier, block 0
//              reduces; smem_tile stages the tangent's 64x8 tile and its
//              halo in shared memory by 16-byte loads, two points a thread
//              (N a multiple of 64 only)
//   shipped    csrc/stencil.cu's launcher (the parent kernel after its
//              zeroing kernel), inv_scale by pointer and by value
//   no work    an empty kernel: launched plainly, launched cooperatively,
//              and cooperatively with one grid barrier (512 and 132 blocks)
// as CUDA events over 4 replays of a CUDA graph of 200 calls (after one
// warm-up replay), three rounds over all designs (min-max printed), and
// prints each design's largest difference from the parent's out and
// whether its max equals the parent's.

#include "../csrc/stencil.cu"

#include <cooperative_groups.h>

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <functional>
#include <type_traits>
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

template <typename P, typename T>
__device__ __forceinline__ P scaled(P t, T inv) {
  t.x *= inv;
  t.y *= inv;
  return t;
}

// the parent's K2, interleaved f32 (kPdl: launched as the zeroing kernel's
// programmatic dependent, waiting for it before the atomicMax)
template <bool kPdl>
__global__ void __launch_bounds__(BX * BY)
parent_kernel(const float* __restrict__ U, const float* __restrict__ Tg,
              const float* __restrict__ p, const float* __restrict__ inv_ptr,
              float* __restrict__ out, int* __restrict__ gmax, int N) {
  __shared__ int wmax[BX * BY / 32];
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  int m = 0;
  if (i < N && j < N) {
    const Scalars<float> s(p);
    const float inv = *inv_ptr;
    const Nbr nb(i, j, N);
    const float2* T2 = reinterpret_cast<const float2*>(Tg);
    const float2 uv = reinterpret_cast<const float2*>(U)[nb.c];
    float2 t = T2[nb.c], tim = T2[nb.im], tip = T2[nb.ip], tjm = T2[nb.jm],
           tjp = T2[nb.jp];
    t = scaled(t, inv); tim = scaled(tim, inv); tip = scaled(tip, inv);
    tjm = scaled(tjm, inv); tjp = scaled(tjp, inv);
    float ou, ov;
    point_jvp<float>(s, uv.x, uv.y, t.x, t.y,
                     lap5<float>(t.x, tim.x, tip.x, tjm.x, tjp.x),
                     lap5<float>(t.y, tim.y, tip.y, tjm.y, tjp.y), ou, ov);
    reinterpret_cast<float2*>(out)[nb.c] = make_float2(ou, ov);
    const int bu = Bits<float>::of(ou), bv = Bits<float>::of(ov);
    m = bu > bv ? bu : bv;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int o = __shfl_down_sync(0xffffffffu, m, off);
    m = o > m ? o : m;
  }
  const int tid = threadIdx.y * BX + threadIdx.x;
  if ((tid & 31) == 0) wmax[tid >> 5] = m;
  __syncthreads();
  if (tid < 32) {
    m = tid < BX * BY / 32 ? wmax[tid] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int o = __shfl_down_sync(0xffffffffu, m, off);
      m = o > m ? o : m;
    }
    if (tid == 0) {
      if constexpr (kPdl) cudaGridDependencySynchronize();
      atomicMax(gmax, m);
    }
  }
}

// one word set to 0, as torch.zeros does it (a kernel, not a memset node);
// with kPdl its dependent may start at once
template <bool kPdl>
__global__ void zero_kernel(int* w) {
  if constexpr (kPdl) cudaTriggerProgrammaticLaunchCompletion();
  *w = 0;
}

__device__ __forceinline__ float from_bits(unsigned long long b) {
  return __int_as_float(static_cast<int>(b));
}

constexpr int K2_PTS = 2;                  // two_point: points a thread
constexpr int K2_TJ = 32 * K2_PTS;         // a tile: K2_TJ x kRows points, a warp a row

__device__ __forceinline__ unsigned long long warp_max(unsigned long long m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, m, off);
    m = o > m ? o : m;
  }
  return m;
}

// The max of m over a block of kWarps warps; the result is valid in thread 0.
template <int kWarps>
__device__ __forceinline__ unsigned long long block_max(unsigned long long m,
                                                        unsigned long long* red) {
  const int tid = threadIdx.y * BX + threadIdx.x;
  m = warp_max(m);
  if ((tid & 31) == 0) red[tid >> 5] = m;
  __syncthreads();
  if (tid < 32) {
    m = tid < kWarps ? red[tid] : 0ull;
    m = warp_max(m);
  }
  return m;
}

// A point's (u, v) pair: from the interleaved (N, N, 2) array a, or from
// the planes a and b.
template <typename T, bool kInterleaved>
struct K2Io {
  using P = typename Pair<T>::type;
  static __device__ __forceinline__ P get(const T* a, const T* b, size_t k) {
    if constexpr (kInterleaved) {
      return reinterpret_cast<const P*>(a)[k];
    } else {
      P r;
      r.x = a[k];
      r.y = b[k];
      return r;
    }
  }
  // points k and k + 1, k even, the arrays 16-byte aligned: 16-byte loads
  static __device__ __forceinline__ void get2(const T* a, const T* b, size_t k,
                                              P* w) {
    if constexpr (kInterleaved && sizeof(T) == 4) {
      const float4 x = *reinterpret_cast<const float4*>(a + 2 * k);
      w[0] = make_float2(x.x, x.y);
      w[1] = make_float2(x.z, x.w);
    } else if constexpr (kInterleaved) {
      w[0] = reinterpret_cast<const P*>(a)[k];
      w[1] = reinterpret_cast<const P*>(a)[k + 1];
    } else {
      const P x = *reinterpret_cast<const P*>(a + k);
      const P y = *reinterpret_cast<const P*>(b + k);
      w[0].x = x.x; w[0].y = y.x;
      w[1].x = x.y; w[1].y = y.y;
    }
  }
  static __device__ __forceinline__ void put(T* a, T* b, size_t k, P w) {
    if constexpr (kInterleaved) {
      reinterpret_cast<P*>(a)[k] = w;
    } else {
      a[k] = w.x;
      b[k] = w.y;
    }
  }
  static __device__ __forceinline__ void put2(T* a, T* b, size_t k, const P* w) {
    if constexpr (kInterleaved && sizeof(T) == 4) {
      *reinterpret_cast<float4*>(a + 2 * k) = make_float4(w[0].x, w[0].y, w[1].x, w[1].y);
    } else if constexpr (kInterleaved) {
      reinterpret_cast<P*>(a)[k] = w[0];
      reinterpret_cast<P*>(a)[k + 1] = w[1];
    } else {
      P x, y;
      x.x = w[0].x; x.y = w[1].x;
      y.x = w[0].y; y.y = w[1].y;
      *reinterpret_cast<P*>(a + k) = x;
      *reinterpret_cast<P*>(b + k) = y;
    }
  }
};

// Points j and j + 1 of row r: one 16-byte load where the pair is aligned
// and inside the row, else one load a point at (j + q) mod N.
template <typename Io, typename T>
__device__ __forceinline__ void k2_row(const T* a, const T* b, size_t r, int j,
                                       int N, bool vec, typename Io::P* w) {
  const size_t base = r * static_cast<size_t>(N);
  if (vec && (base + j) % 2 == 0 && j + 1 < N) {
    Io::get2(a, b, base + j, w);
  } else {
    w[0] = Io::get(a, b, base + j % N);
    w[1] = Io::get(a, b, base + (j + 1) % N);
  }
}


// two_point: K2 with two neighbouring points along j a thread, 16-byte
// loads of the pair where it is aligned and inside the row (else one load a
// point), the j-1 and j+2 neighbours by warp shuffles; blocks of 32 x kRows
// threads walk 64 x kRows tiles, no more blocks than the card holds.
// absmax must hold 0 when the blocks' atomicMax reach it; with kPdl each
// block waits for the zeroing kernel first.  vec: every array is 16-byte
// aligned.
template <typename T, bool kInterleaved, int kRows, bool kPdl>
__global__ void __launch_bounds__(32 * kRows)
two_point_kernel(const T* __restrict__ u, const T* __restrict__ v,
                  const T* __restrict__ tu, const T* __restrict__ tv,
                  const T* __restrict__ p, const T* __restrict__ inv_ptr,
                  T inv_val, T* __restrict__ ou, T* __restrict__ ov,
                  T* __restrict__ absmax, int N, bool vec) {
  using Io = K2Io<T, kInterleaved>;
  using P = typename Pair<T>::type;
  __shared__ unsigned long long red[kRows];
  const int lane = threadIdx.x;
  const Scalars<T> s(p);
  const T inv = inv_ptr ? *inv_ptr : inv_val;
  const size_t n = static_cast<size_t>(N);
  const int tiles_j = (N + K2_TJ - 1) / K2_TJ;
  const int ntiles = tiles_j * ((N + kRows - 1) / kRows);
  unsigned long long m = 0ull;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int i = (tile / tiles_j) * kRows + threadIdx.y;
    if (i >= N) continue;                  // a whole warp: i is per warp
    const int j = (tile % tiles_j) * K2_TJ + lane * K2_PTS;
    const size_t im = i == 0 ? n - 1 : i - 1;
    const size_t ip = i == N - 1 ? 0 : i + 1;
    P uv[K2_PTS], c[K2_PTS + 2], up[K2_PTS], dn[K2_PTS];
    k2_row<Io>(u, v, i, j, N, vec, uv);
    k2_row<Io>(tu, tv, i, j, N, vec, c + 1);
    k2_row<Io>(tu, tv, im, j, N, vec, up);
    k2_row<Io>(tu, tv, ip, j, N, vec, dn);
    // j - 1 is the previous lane's last point, j + 2 the next lane's first
    c[0].x = __shfl_up_sync(0xffffffffu, c[K2_PTS].x, 1);
    c[0].y = __shfl_up_sync(0xffffffffu, c[K2_PTS].y, 1);
    c[K2_PTS + 1].x = __shfl_down_sync(0xffffffffu, c[1].x, 1);
    c[K2_PTS + 1].y = __shfl_down_sync(0xffffffffu, c[1].y, 1);
    if (lane == 0) c[0] = Io::get(tu, tv, i * n + (j - 1 + N) % N);
    if (lane == 31 || j + K2_PTS >= N)
      c[K2_PTS + 1] = Io::get(tu, tv, i * n + (j + K2_PTS) % N);
    // J(t * inv) = J(t) * inv, but the JAX kernel scales on read: do the same
#pragma unroll
    for (int q = 0; q < K2_PTS + 2; ++q) c[q] = scaled(c[q], inv);
    P o[K2_PTS];
#pragma unroll
    for (int q = 0; q < K2_PTS; ++q) {
      const P t = c[q + 1], tim = scaled(up[q], inv), tip = scaled(dn[q], inv);
      point_jvp<T>(s, uv[q].x, uv[q].y, t.x, t.y,
                   lap5<T>(t.x, tim.x, tip.x, c[q].x, c[q + 2].x),
                   lap5<T>(t.y, tim.y, tip.y, c[q].y, c[q + 2].y), o[q].x, o[q].y);
    }
    const size_t base = i * n;
    if (vec && (base + j) % 2 == 0 && j + 1 < N) {
      Io::put2(ou, ov, base + j, o);
    } else {
#pragma unroll
      for (int q = 0; q < K2_PTS; ++q)
        if (j + q < N) Io::put(ou, ov, base + j + q, o[q]);
    }
#pragma unroll
    for (int q = 0; q < K2_PTS; ++q) {
      if (j + q < N) {
        const unsigned long long bu = static_cast<unsigned long long>(Bits<T>::of(o[q].x));
        const unsigned long long bw = static_cast<unsigned long long>(Bits<T>::of(o[q].y));
        m = bu > m ? bu : m;
        m = bw > m ? bw : m;
      }
    }
  }
  // one atomicMax a block, on the bit patterns
  m = block_max<kRows>(m, red);
  if (threadIdx.y * BX + lane == 0) {
    using B = typename Bits<T>::type;
    if constexpr (kPdl) cudaGridDependencySynchronize();
    atomicMax(reinterpret_cast<B*>(absmax), static_cast<B>(m));
  }
}

// partials, the grid barrier, block 0's max: the cooperative designs' end
__device__ __forceinline__ void coop_finish(unsigned long long m,
                                            unsigned long long* red,
                                            unsigned long long* partial,
                                            float* absmax) {
  m = block_max<BY>(m, red);
  const int tid = threadIdx.y * BX + threadIdx.x;
  if (tid == 0) partial[blockIdx.x] = m;
  cooperative_groups::this_grid().sync();
  if (blockIdx.x != 0) return;
  unsigned long long g = 0ull;
  for (int b = tid; b < static_cast<int>(gridDim.x); b += BX * BY) {
    const unsigned long long f = __ldcg(&partial[b]);
    g = f > g ? f : g;
  }
  __syncthreads();
  g = block_max<BY>(g, red);
  if (tid == 0) *absmax = from_bits(g);
}

__device__ __forceinline__ unsigned long long max_bits(unsigned long long m,
                                                       float ou, float ov) {
  const unsigned long long bu = static_cast<unsigned long long>(Bits<float>::of(ou));
  const unsigned long long bv = static_cast<unsigned long long>(Bits<float>::of(ov));
  m = bu > m ? bu : m;
  return bv > m ? bv : m;
}

__global__ void __launch_bounds__(BX * BY)
one_point_kernel(const float* __restrict__ U, const float* __restrict__ Tg,
                 const float* __restrict__ p, const float* __restrict__ inv_ptr,
                 float* __restrict__ out, float* __restrict__ absmax,
                 unsigned long long* __restrict__ partial, int N) {
  __shared__ unsigned long long red[BY];
  const Scalars<float> s(p);
  const float inv = *inv_ptr;
  const int tiles_j = (N + BX - 1) / BX;
  const int ntiles = tiles_j * ((N + BY - 1) / BY);
  unsigned long long m = 0ull;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int j = (tile % tiles_j) * BX + threadIdx.x;
    const int i = (tile / tiles_j) * BY + threadIdx.y;
    if (i >= N || j >= N) continue;
    const Nbr nb(i, j, N);
    const float2* T2 = reinterpret_cast<const float2*>(Tg);
    const float2 uv = reinterpret_cast<const float2*>(U)[nb.c];
    float2 t = T2[nb.c], tim = T2[nb.im], tip = T2[nb.ip], tjm = T2[nb.jm],
           tjp = T2[nb.jp];
    t = scaled(t, inv); tim = scaled(tim, inv); tip = scaled(tip, inv);
    tjm = scaled(tjm, inv); tjp = scaled(tjp, inv);
    float ou, ov;
    point_jvp<float>(s, uv.x, uv.y, t.x, t.y,
                     lap5<float>(t.x, tim.x, tip.x, tjm.x, tjp.x),
                     lap5<float>(t.y, tim.y, tip.y, tjm.y, tjp.y), ou, ov);
    reinterpret_cast<float2*>(out)[nb.c] = make_float2(ou, ov);
    m = max_bits(m, ou, ov);
  }
  coop_finish(m, red, partial, absmax);
}

// one point a thread on K1's 32x8 tiles, a grid of at most the blocks the
// card holds walking them, one atomicMax a block into a zeroed word
template <bool kPdl>
__global__ void __launch_bounds__(BX * BY)
one_point_atomic_kernel(const float* __restrict__ U, const float* __restrict__ Tg,
                        const float* __restrict__ p, const float* __restrict__ inv_ptr,
                        float* __restrict__ out, int* __restrict__ gmax, int N) {
  __shared__ unsigned long long red[BY];
  const Scalars<float> s(p);
  const float inv = *inv_ptr;
  const int tiles_j = (N + BX - 1) / BX;
  const int ntiles = tiles_j * ((N + BY - 1) / BY);
  unsigned long long m = 0ull;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int j = (tile % tiles_j) * BX + threadIdx.x;
    const int i = (tile / tiles_j) * BY + threadIdx.y;
    if (i >= N || j >= N) continue;
    const Nbr nb(i, j, N);
    const float2* T2 = reinterpret_cast<const float2*>(Tg);
    const float2 uv = reinterpret_cast<const float2*>(U)[nb.c];
    float2 t = T2[nb.c], tim = T2[nb.im], tip = T2[nb.ip], tjm = T2[nb.jm],
           tjp = T2[nb.jp];
    t = scaled(t, inv); tim = scaled(tim, inv); tip = scaled(tip, inv);
    tjm = scaled(tjm, inv); tjp = scaled(tjp, inv);
    float ou, ov;
    point_jvp<float>(s, uv.x, uv.y, t.x, t.y,
                     lap5<float>(t.x, tim.x, tip.x, tjm.x, tjp.x),
                     lap5<float>(t.y, tim.y, tip.y, tjm.y, tjp.y), ou, ov);
    reinterpret_cast<float2*>(out)[nb.c] = make_float2(ou, ov);
    m = max_bits(m, ou, ov);
  }
  m = block_max<BY>(m, red);
  if (threadIdx.y * BX + threadIdx.x == 0) {
    if constexpr (kPdl) cudaGridDependencySynchronize();
    atomicMax(gmax, static_cast<int>(m));
  }
}

constexpr int ST_J = 64;                   // smem_tile: points a tile row

__global__ void __launch_bounds__(BX * BY)
smem_tile_kernel(const float* __restrict__ U, const float* __restrict__ Tg,
                 const float* __restrict__ p, const float* __restrict__ inv_ptr,
                 float* __restrict__ out, float* __restrict__ absmax,
                 unsigned long long* __restrict__ partial, int N) {
  __shared__ unsigned long long red[BY];
  __shared__ float2 tile_t[BY + 2][ST_J + 2];
  const Scalars<float> s(p);
  const float inv = *inv_ptr;
  const int tid = threadIdx.y * BX + threadIdx.x;
  const int tiles_j = N / ST_J;
  const int ntiles = tiles_j * (N / BY);
  const size_t n = static_cast<size_t>(N);
  const float2* T2 = reinterpret_cast<const float2*>(Tg);
  unsigned long long m = 0ull;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int i0 = (tile / tiles_j) * BY;
    const int j0 = (tile % tiles_j) * ST_J;
    // rows i0-1 .. i0+BY, 32 float4 (64 points) a row, then the halo columns
    for (int k = tid; k < (BY + 2) * 32; k += BX * BY) {
      const int r = k / 32, q = k % 32;
      const size_t row = static_cast<size_t>((i0 - 1 + r + N) % N);
      const float4 x = *reinterpret_cast<const float4*>(Tg + 2 * (row * n + j0 + 2 * q));
      tile_t[r][1 + 2 * q] = scaled(make_float2(x.x, x.y), inv);
      tile_t[r][2 + 2 * q] = scaled(make_float2(x.z, x.w), inv);
    }
    if (tid < 2 * (BY + 2)) {
      const int r = tid >> 1, right = tid & 1;
      const size_t row = static_cast<size_t>((i0 - 1 + r + N) % N);
      const int col = right ? (j0 + ST_J) % N : (j0 - 1 + N) % N;
      tile_t[r][right ? ST_J + 1 : 0] = scaled(T2[row * n + col], inv);
    }
    __syncthreads();
    const int r = threadIdx.y + 1, c = 1 + 2 * threadIdx.x;
    const size_t k = (i0 + threadIdx.y) * n + j0 + 2 * threadIdx.x;
    const float4 u4 = *reinterpret_cast<const float4*>(U + 2 * k);
    float o[4];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float2 t = tile_t[r][c + q], tim = tile_t[r - 1][c + q],
                   tip = tile_t[r + 1][c + q], tjm = tile_t[r][c + q - 1],
                   tjp = tile_t[r][c + q + 1];
      const float uu = q ? u4.z : u4.x, vv = q ? u4.w : u4.y;
      point_jvp<float>(s, uu, vv, t.x, t.y,
                       lap5<float>(t.x, tim.x, tip.x, tjm.x, tjp.x),
                       lap5<float>(t.y, tim.y, tip.y, tjm.y, tjp.y),
                       o[2 * q], o[2 * q + 1]);
      m = max_bits(m, o[2 * q], o[2 * q + 1]);
    }
    *reinterpret_cast<float4*>(out + 2 * k) = make_float4(o[0], o[1], o[2], o[3]);
    __syncthreads();                       // the tile is read before it is refilled
  }
  coop_finish(m, red, partial, absmax);
}

// blocks of a cooperative grid: the tiles, or as many as the card holds
template <typename K>
int coop_grid(K kern, int tiles) {
  int per_sm = 0, sms = 0, dev = 0;
  CK(cudaGetDevice(&dev));
  CK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, BX * BY, 0));
  CK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  return tiles < per_sm * sms ? tiles : per_sm * sms;
}

// no work: what a launch, a cooperative launch and its grid barrier cost
__global__ void __launch_bounds__(BX * BY) empty_kernel(float* out) {
  if (out && threadIdx.x == 0 && threadIdx.y == 0) out[blockIdx.x] = 0.f;
}

__global__ void __launch_bounds__(BX * BY) empty_sync_kernel(float* out) {
  cooperative_groups::this_grid().sync();
  if (out && threadIdx.x == 0 && threadIdx.y == 0) out[blockIdx.x] = 0.f;
}

// a plain launch, or (kPdl) one that may start before the kernel ahead of
// it in the stream ends
template <bool kPdl, typename... Exp, typename... Act>
void launch_after(void (*kern)(Exp...), dim3 grid, cudaStream_t st, Act... args) {
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(BX, BY);
  cfg.stream = st;
  cfg.attrs = pdl;
  cfg.numAttrs = kPdl ? 1 : 0;
  CK(cudaLaunchKernelEx(&cfg, kern, args...));
}

template <typename... Exp, typename... Act>
void launch_coop(void (*kern)(Exp...), int grid, cudaStream_t st, Act... args) {
  cudaLaunchAttribute coop[1];
  coop[0].id = cudaLaunchAttributeCooperative;
  coop[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(BX, BY);
  cfg.stream = st;
  cfg.attrs = coop;
  cfg.numAttrs = 1;
  CK(cudaLaunchKernelEx(&cfg, kern, args...));
}

// two_point's grid: the tiles, or as many blocks as the card holds at
// once, whichever is fewer (one wave; one atomicMax a block).
template <typename T, bool kInterleaved, int kRows, bool kPdl>
cudaError_t two_point_grid(int N, int* grid) {
  static int per_card[64] = {0};           // blocks the card holds, by device
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (per_card[dev] == 0) {
    int per_sm = 0, sms = 0;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, two_point_kernel<T, kInterleaved, kRows, kPdl>, 32 * kRows, 0);
    if (rc != cudaSuccess) return rc;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return rc;
    per_card[dev] = per_sm * sms;
  }
  const long long tiles = static_cast<long long>((N + K2_TJ - 1) / K2_TJ) *
                          ((N + kRows - 1) / kRows);
  *grid = static_cast<int>(tiles < per_card[dev] ? tiles : per_card[dev]);
  return cudaSuccess;
}

template <typename T, bool kInterleaved, int kRows, bool kPdl>
int launch_two_point(const void* u, const void* v, const void* tu, const void* tv,
                  const void* p, const void* inv_ptr, double inv_val, void* ou,
                  void* ov, void* absmax, int N, void* stream) {
  int grid = 0;
  cudaError_t rc = two_point_grid<T, kInterleaved, kRows, kPdl>(N, &grid);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  zero_kernel<kPdl><<<1, 1, 0, st>>>(static_cast<int*>(absmax));
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const bool vec = aligned16(u) && aligned16(v) && aligned16(tu) &&
                   aligned16(tv) && aligned16(ou) && aligned16(ov);
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(BX, kRows);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = pdl;
  cfg.numAttrs = kPdl ? 1 : 0;
  rc = cudaLaunchKernelEx(
      &cfg, two_point_kernel<T, kInterleaved, kRows, kPdl>,
      static_cast<const T*>(u), static_cast<const T*>(v),
      static_cast<const T*>(tu), static_cast<const T*>(tv),
      static_cast<const T*>(p), static_cast<const T*>(inv_ptr),
      static_cast<T>(inv_val), static_cast<T*>(ou), static_cast<T*>(ov),
      static_cast<T*>(absmax), N, vec);
  if (rc != cudaSuccess) {
    cudaGetLastError();                    // not sticky: clear it
    return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
double graph_us(F call, cudaStream_t st, int calls = 200, int replays = 4) {
  cudaGraph_t g;
  cudaGraphExec_t ge;
  CK(cudaStreamBeginCapture(st, cudaStreamCaptureModeGlobal));
  for (int c = 0; c < calls; ++c) call();
  CK(cudaStreamEndCapture(st, &g));
  CK(cudaGraphInstantiate(&ge, g, 0));
  CK(cudaGraphLaunch(ge, st));
  cudaEvent_t a, b;
  CK(cudaEventCreate(&a));
  CK(cudaEventCreate(&b));
  CK(cudaEventRecord(a, st));
  for (int r = 0; r < replays; ++r) CK(cudaGraphLaunch(ge, st));
  CK(cudaEventRecord(b, st));
  CK(cudaEventSynchronize(b));
  float ms = 0.f;
  CK(cudaEventElapsedTime(&ms, a, b));
  CK(cudaGraphExecDestroy(ge));
  CK(cudaGraphDestroy(g));
  return 1e3 * ms / (calls * replays);
}

}  // namespace

int main() {
  cudaStream_t st;
  CK(cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking));
  cudaDeviceProp prop;
  CK(cudaGetDeviceProperties(&prop, 0));
  std::printf("card %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  const int kWords = 4096;                 // the cooperative designs' partials
  for (int N : {512, 2048}) {
    const size_t vals = 2 * static_cast<size_t>(N) * N;
    std::vector<float> hU(vals), hT(vals);
    unsigned long long x = 88172645463325252ull;
    auto rnd = [&x]() {                    // xorshift64, uniform in [-1, 1)
      x ^= x << 13; x ^= x >> 7; x ^= x << 17;
      return static_cast<float>((x >> 11) * (1.0 / 4503599627370496.0)) - 1.0f;
    };
    for (size_t k = 0; k < vals; ++k) {
      hU[k] = (k % 2 ? 3.0f : 1.0f) + 0.1f * rnd();
      hT[k] = rnd();
    }
    const float hp[4] = {3.4f, 1.0f, 10.0f, 1.0f / (N - 1)};
    const float hinv = 0.5f;
    float *U, *T, *p, *inv, *out, *mx;
    int* imx;
    unsigned long long* partial;            // the cooperative designs' words
    CK(cudaMalloc(&U, vals * 4));
    CK(cudaMalloc(&T, vals * 4));
    CK(cudaMalloc(&out, vals * 4));
    CK(cudaMalloc(&p, 16));
    CK(cudaMalloc(&inv, 4));
    CK(cudaMalloc(&mx, 4));
    CK(cudaMalloc(&imx, 4));
    CK(cudaMalloc(&partial, kWords * 8));
    CK(cudaMemcpy(U, hU.data(), vals * 4, cudaMemcpyHostToDevice));
    CK(cudaMemcpy(T, hT.data(), vals * 4, cudaMemcpyHostToDevice));
    CK(cudaMemcpy(p, hp, 16, cudaMemcpyHostToDevice));
    CK(cudaMemcpy(inv, &hinv, 4, cudaMemcpyHostToDevice));

    const dim3 g1((N + BX - 1) / BX, (N + BY - 1) / BY);
    const int tiles1 = g1.x * g1.y;
    const int tiles2 = ((N + ST_J - 1) / ST_J) * ((N + BY - 1) / BY);
    const int grid1 = coop_grid(one_point_kernel, tiles1);
    const int grid2 = coop_grid(smem_tile_kernel, tiles2);
    std::printf("N=%d: one_point %d blocks, smem_tile %d blocks\n", N, grid1, grid2);
    auto k1 = [&]() { CK(static_cast<cudaError_t>(brusselator_jvp_f32(U, T, p, out, N, st))); };
    auto parent = [&]() {
      CK(cudaMemsetAsync(imx, 0, 4, st));
      parent_kernel<false><<<g1, dim3(BX, BY), 0, st>>>(U, T, p, inv, out, imx, N);
      CK(cudaGetLastError());
    };
    const int grid_pa = coop_grid(one_point_atomic_kernel<false>, tiles1);
    auto zero_then = [&](auto kPdl, auto kern, dim3 grid) {
      return [&, kern, grid]() {
        constexpr bool pdl = decltype(kPdl)::value;
        zero_kernel<pdl><<<1, 1, 0, st>>>(imx);
        CK(cudaGetLastError());
        launch_after<pdl>(kern, grid, st, (const float*)U, (const float*)T,
                          (const float*)p, (const float*)inv, out, imx, N);
      };
    };
    // two_point with 8 or 16 rows a block, with or without PDL
    auto two_point = [&](auto kRows, auto kPdl, bool by_value) {
      return [&, kRows, kPdl, by_value]() {
        CK(static_cast<cudaError_t>(
            launch_two_point<float, true, decltype(kRows)::value, decltype(kPdl)::value>(
                U, nullptr, T, nullptr, p, by_value ? nullptr : inv, 0.5, out,
                nullptr, mx, N, st)));
      };
    };
    using R8 = std::integral_constant<int, 8>;
    using R16 = std::integral_constant<int, 16>;
    using Plain = std::false_type;
    using Pdl = std::true_type;
    auto one_point = [&]() {
      launch_coop(one_point_kernel, grid1, st, (const float*)U, (const float*)T,
                  (const float*)p, (const float*)inv, out, mx, partial, N);
    };
    auto smem_tile = [&]() {
      launch_coop(smem_tile_kernel, grid2, st, (const float*)U, (const float*)T,
                  (const float*)p, (const float*)inv, out, mx, partial, N);
    };

    // the parent's result is the reference
    parent();
    CK(cudaStreamSynchronize(st));
    std::vector<float> ref(vals), got(vals);
    int ref_bits = 0;
    CK(cudaMemcpy(ref.data(), out, vals * 4, cudaMemcpyDeviceToHost));
    CK(cudaMemcpy(&ref_bits, imx, 4, cudaMemcpyDeviceToHost));
    float ref_max;
    std::memcpy(&ref_max, &ref_bits, 4);

    // max_in: 0 no max, 1 the float word mx, 2 the int word imx
    struct Design { const char* name; std::function<void()> call; bool scaled_out; int max_in; };
    std::vector<Design> designs = {
        {"k1 (no scale, no max)", k1, false, 0},
        {"parent (memset + atomicMax kernel)", parent, true, 2},
        {"parent's kernel alone (its word zeroed once, before)",
         [&]() { launch_after<false>(parent_kernel<false>, g1, st, (const float*)U,
                                     (const float*)T, (const float*)p,
                                     (const float*)inv, out, imx, N); },
         true, 2},
        {"parent (zero kernel + atomicMax kernel)",
         zero_then(Plain(), parent_kernel<false>, g1), true, 2},
        {"parent, PDL", zero_then(Pdl(), parent_kernel<true>, g1), true, 2},
        {"one_point_atomic (grid capped)",
         zero_then(Plain(), one_point_atomic_kernel<false>, dim3(grid_pa)), true, 2},
        {"one_point_atomic (grid capped), PDL",
         zero_then(Pdl(), one_point_atomic_kernel<true>, dim3(grid_pa)), true, 2},
        {"one_point (cooperative)", one_point, true, 1},
        {"smem_tile (cooperative)", smem_tile, true, 1},
        {"shipped (parent's kernel, zeroed in the launcher), inv by pointer",
         [&]() { CK(static_cast<cudaError_t>(brusselator_jvp_scaled_f32(
             U, T, p, inv, 0.0, out, mx, N, st))); }, true, 1},
        {"shipped, inv by value",
         [&]() { CK(static_cast<cudaError_t>(brusselator_jvp_scaled_f32(
             U, T, p, nullptr, 0.5, out, mx, N, st))); }, true, 1},
        {"two_point, 32x8 blocks", two_point(R8(), Plain(), false), true, 1},
        {"two_point, 32x8 blocks, PDL", two_point(R8(), Pdl(), false), true, 1},
        {"two_point, 32x16 blocks", two_point(R16(), Plain(), false), true, 1},
        {"no work, 512 blocks", [&]() { empty_kernel<<<512, dim3(BX, BY), 0, st>>>(nullptr); }, false, 0},
        {"no work, cooperative, 512 blocks", [&]() { launch_coop(empty_kernel, 512, st, (float*)nullptr); }, false, 0},
        {"grid barrier only, 512 blocks", [&]() { launch_coop(empty_sync_kernel, 512, st, (float*)nullptr); }, false, 0},
        {"grid barrier only, 132 blocks", [&]() { launch_coop(empty_sync_kernel, 132, st, (float*)nullptr); }, false, 0}};
    // correctness once, then three rounds of timings over all designs
    std::vector<std::vector<double>> times(designs.size());
    for (int round = 0; round < 3; ++round)
      for (size_t k = 0; k < designs.size(); ++k)
        times[k].push_back(graph_us(designs[k].call, st));
    for (size_t k = 0; k < designs.size(); ++k) {
      const Design& d = designs[k];
      CK(cudaMemset(out, 0, vals * 4));
      CK(cudaMemset(mx, 0xff, 4));
      CK(cudaMemset(imx, 0xff, 4));
      d.call();
      CK(cudaStreamSynchronize(st));
      CK(cudaMemcpy(got.data(), out, vals * 4, cudaMemcpyDeviceToHost));
      float m = 0.f;
      CK(cudaMemcpy(&m, d.max_in == 2 ? reinterpret_cast<float*>(imx) : mx, 4,
                    cudaMemcpyDeviceToHost));
      double diff = 0.0;
      for (size_t q = 0; q < vals; ++q) {
        const double e = std::fabs(static_cast<double>(got[q]) - ref[q]);
        diff = e > diff ? e : diff;
      }
      if (!d.scaled_out) diff = std::nan("");
      const auto mm = std::minmax_element(times[k].begin(), times[k].end());
      std::printf("N=%-5d %-40s %8.3f-%8.3f us  max|out - parent| %.3g  max %s\n",
                  N, d.name, *mm.first, *mm.second, diff,
                  d.max_in == 0 ? "-" : (m == ref_max ? "= parent's" : "DIFFERS"));
    }
    CK(cudaFree(U)); CK(cudaFree(T)); CK(cudaFree(out)); CK(cudaFree(p));
    CK(cudaFree(inv)); CK(cudaFree(mx)); CK(cudaFree(imx)); CK(cudaFree(partial));
  }
  return 0;
}
