// Fused Jacobian-vector products of the 2D periodic Brusselator for Hopper
// (sm_90a), with a plain C interface loaded by ctypes
// (nonlinearsolve_tpu_torch/ops/stencil.py holds the wrappers).
//
// K1  brusselator_jvp           replaces nonlinearsolve_tpu/ops/pallas_stencil.py
//                               _brusselator_jvp_kernel (brusselator_jvp)
// K2  brusselator_jvp_scaled    replaces nonlinearsolve_tpu/ops/pallas_stencil.py
//                               _brusselator_jvp_scaled_kernel
//                               (brusselator_jvp_scaled, _scaled_pair)
//
//   out_u = al*lap(t_u) + (2uv - (A+1))*t_u + u^2*t_v
//   out_v = al*lap(t_v) + (A - 2uv)*t_u     - u^2*t_v,   al = alpha/dx^2
//
// with lap the periodic 5-point Laplacian, summed in the JAX kernel's order
// (w[i-1] + w[i+1] + w[j-1] + w[j+1] - 4w).  K2 multiplies the tangent by
// inv_scale on read and also reduces max|out| over the whole grid.
//
// Bound on the H100: bytes.  At f32 N=512 a call reads U and T (4 MiB) and
// writes out (2 MiB), about 27 flops per point: 1.9 us at 3.35 TB/s against
// 0.1 us of f32 arithmetic at 67 TFLOP/s.  All operands fit the 50 MB L2 at
// N=512; at N=2048 (100.7 MB) they stream from HBM.
//
// K1's design is the simple one: one thread per grid point, 32x8 blocks so
// a warp reads 32 neighbouring points, neighbours loaded straight from
// global memory (L1/L2 serve the 5x reuse).
//
// Layout: the interleaved (N, N, 2) layout of the JAX package is read as is
// — one 8-byte (f32) or 16-byte (f64) load gets (t_u, t_v) of a point, one
// store writes (out_u, out_v).  The planar variant takes four (N, N) planes.
//
// Scalars: p = (A, B, alpha, dx) is read from device memory by pointer (the
// wrapper requires p in the state's dtype), and al = alpha/(dx*dx), A + 1
// are formed in that dtype exactly as the JAX wrapper forms them, so a
// launch never waits on a device-to-host read.  K2's inv_scale comes by
// pointer (a 0-d device tensor, so a chained loop never waits on the host)
// or by value (a Python float).
//
// K2's design is K1's, plus the grid-wide max: every block reduces |out|
// (warp shuffles, then shared memory) on the bit patterns of the
// non-negative values — for IEEE floats >= 0 the integer order is the float
// order, and a NaN (sign cleared by fabs) sorts above +inf, so NaN
// propagates as jnp.max does — then one atomicMax per block into the max's
// word, which a one-thread kernel launched just before K2 zeroes.  Nothing
// is kept between calls, so launches on any streams, and CUDA graphs
// replayed side by side, share no state.  nonlinearsolve_tpu_torch/bench/
// k2_designs.cu times this pair against one-launch designs (a cooperative
// grid with a grid barrier) and designs with several points a thread,
// 16-byte loads or the tangent staged in shared memory: none is faster at
// N=512, where the chain runs.
//
// K3  brusselator_jvp_bf16      replaces nonlinearsolve_tpu/ops/pallas_stencil.py
//                               make_brusselator_jvp_bf16 (K1's pallas_call at
//                               bf16)
//
// K1's function on bf16 state and tangent, bf16 out.  The scalars are
// formed in f32 from p (f32) as the JAX wrapper forms them — al =
// alpha/(dx*dx), A + 1, A — then rounded to bf16, as the Pallas kernel
// casts them.  Every operation is a native bf16x2 operation on the (u, v)
// channel pair of a point, rounded to nearest even (add.rn, sub.rn and
// mul.rn.bf16x2 in PTX; the .rn keeps them out of any FMA contraction):
//
//   lap          = (((t_im + t_ip) + t_jm) + t_jp) - (4, 4)*t   both channels
//   (2uv, u^2)   = ((u, u)*(2, 1))*(v, u)                       2u is exact
//   (c_u, c_v)   = (2uv, A) - (A+1, 2uv)
//   (w, -w)      = (u^2, u^2)*(t_v, -t_v)                       negation exact
//   out          = ((al, al)*lap + (c_u, c_v)*(t_u, t_u)) + (w, -w)
//
// which is the plain version's order (ops/stencil.py _jvp_planes), operand
// for operand.  A correctly rounded bf16 operation gives the bits of the f32
// operation rounded to bf16 (24 >= 2*8 + 2 bits), and RN(a + (-b)) =
// RN(a - b), so the kernel agrees with the plain version, which rounds every
// eager op to bf16, bit for bit.  Four points a thread: one 16-byte load of
// bf16 pairs for the centre row, the row above and the row below; the j-1
// and j+4 neighbours by warp shuffles.  A warp takes a row segment of 128
// points, a block 8 rows.  Rows that are not 16-byte aligned (N not a
// multiple of 4) and the ragged edge take 4-byte loads.
//
// K3's f32-tangent variant (brusselator_jvp_bf16_f32t) is the bf16 matvec
// mv(T) of make_brusselator_jvp_bf16 for an f32 tangent in one launch: T
// read in f32 and rounded to bf16 on read (cvt.rn.bf16x2.f32: round to
// nearest even, as .to(torch.bfloat16)), K3's operations, and the bf16
// result widened to f32 (exact), which is cast -> K3 -> cast bit for bit.
//
// Bound: bytes.  K3 moves U, T and out at 2 bytes a value (3 MiB at
// N=512); the variant reads T and writes out in f32 (5 MiB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

template <typename T> struct Bits;
template <> struct Bits<float> {
  using type = int;
  static __device__ __forceinline__ int of(float x) { return __float_as_int(fabsf(x)); }
};
template <> struct Bits<double> {
  using type = unsigned long long;
  static __device__ __forceinline__ unsigned long long of(double x) {
    return static_cast<unsigned long long>(__double_as_longlong(fabs(x)));
  }
};

template <typename T>
struct Scalars {
  T al, ap1, A;
  __device__ __forceinline__ explicit Scalars(const T* __restrict__ p) {
    A = p[0];
    const T alpha = p[2];
    const T dx = p[3];
    al = alpha / (dx * dx);
    ap1 = A + T(1);
  }
};

// Periodic neighbour indices of point (i, j) on the N x N grid.
struct Nbr {
  size_t c, im, ip, jm, jp;
  __device__ __forceinline__ Nbr(int i, int j, int N) {
    const int i_m = (i == 0) ? N - 1 : i - 1;
    const int i_p = (i == N - 1) ? 0 : i + 1;
    const int j_m = (j == 0) ? N - 1 : j - 1;
    const int j_p = (j == N - 1) ? 0 : j + 1;
    const size_t n = static_cast<size_t>(N);
    c = static_cast<size_t>(i) * n + j;
    im = static_cast<size_t>(i_m) * n + j;
    ip = static_cast<size_t>(i_p) * n + j;
    jm = static_cast<size_t>(i) * n + j_m;
    jp = static_cast<size_t>(i) * n + j_p;
  }
};

template <typename T>
__device__ __forceinline__ void point_jvp(const Scalars<T>& s, T u, T v,
                                          T tu, T tv, T lap_u, T lap_v,
                                          T& ou, T& ov) {
  const T two_uv = T(2) * u * v;
  const T u2 = u * u;
  ou = s.al * lap_u + (two_uv - s.ap1) * tu + u2 * tv;
  ov = s.al * lap_v + (s.A - two_uv) * tu - u2 * tv;
}

template <typename T>
__device__ __forceinline__ T lap5(T w, T wim, T wip, T wjm, T wjp) {
  return wim + wip + wjm + wjp - T(4) * w;
}

// K1: interleaved (N, N, 2) in, interleaved out.
template <typename T>
__global__ void __launch_bounds__(BX * BY)
jvp_kernel(const T* __restrict__ U, const T* __restrict__ Tg,
           const T* __restrict__ p, T* __restrict__ out, int N) {
  using P = typename Pair<T>::type;
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  if (i >= N || j >= N) return;
  const Scalars<T> s(p);
  const Nbr nb(i, j, N);
  const P* U2 = reinterpret_cast<const P*>(U);
  const P* T2 = reinterpret_cast<const P*>(Tg);
  const P uv = U2[nb.c];
  const P t = T2[nb.c];
  const P tim = T2[nb.im], tip = T2[nb.ip], tjm = T2[nb.jm], tjp = T2[nb.jp];
  T ou, ov;
  point_jvp<T>(s, uv.x, uv.y, t.x, t.y,
               lap5<T>(t.x, tim.x, tip.x, tjm.x, tjp.x),
               lap5<T>(t.y, tim.y, tip.y, tjm.y, tjp.y), ou, ov);
  P o;
  o.x = ou;
  o.y = ov;
  reinterpret_cast<P*>(out)[nb.c] = o;
}

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

// Block-wide max of non-negative bit patterns, then one atomic per block.
template <typename T>
__device__ __forceinline__ void block_absmax(typename Bits<T>::type m,
                                             typename Bits<T>::type* gmax) {
  using B = typename Bits<T>::type;
  __shared__ B warp_max[BX * BY / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const B o = __shfl_down_sync(0xffffffffu, m, off);
    m = o > m ? o : m;
  }
  const int tid = threadIdx.y * BX + threadIdx.x;
  if ((tid & 31) == 0) warp_max[tid >> 5] = m;
  __syncthreads();
  if (tid < 32) {
    m = tid < (BX * BY / 32) ? warp_max[tid] : B(0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const B o = __shfl_down_sync(0xffffffffu, m, off);
      m = o > m ? o : m;
    }
    if (tid == 0) atomicMax(gmax, m);
  }
}

// The max's word set to 0 before K2's blocks reach it.
template <typename T>
__global__ void zero_max_kernel(typename Bits<T>::type* gmax) {
  *gmax = 0;
}

// K2: tangent scaled on read, plus max|out|.  kInterleaved selects the
// (N, N, 2) layout (u = U, tu = T, ou = out; the v pointers are unused) or
// four planar (N, N) planes.  inv_scale is inv_val (kByValue) or *inv_ptr.
template <typename T, bool kInterleaved, bool kByValue>
__global__ void __launch_bounds__(BX * BY)
jvp_scaled_kernel(const T* __restrict__ u, const T* __restrict__ v,
                  const T* __restrict__ tu, const T* __restrict__ tv,
                  const T* __restrict__ p, const T* __restrict__ inv_ptr,
                  T inv_val, T* __restrict__ ou, T* __restrict__ ov,
                  typename Bits<T>::type* __restrict__ gmax, int N) {
  using P = typename Pair<T>::type;
  using B = typename Bits<T>::type;
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  B m = B(0);
  if (i < N && j < N) {
    const Scalars<T> s(p);
    const T inv = kByValue ? inv_val : *inv_ptr;
    const Nbr nb(i, j, N);
    T uc, vc, tuc, tvc, tu_im, tu_ip, tu_jm, tu_jp, tv_im, tv_ip, tv_jm, tv_jp;
    if (kInterleaved) {
      const P* U2 = reinterpret_cast<const P*>(u);
      const P* T2 = reinterpret_cast<const P*>(tu);
      const P uv = U2[nb.c];
      const P t = T2[nb.c];
      const P tim = T2[nb.im], tip = T2[nb.ip], tjm = T2[nb.jm], tjp = T2[nb.jp];
      uc = uv.x; vc = uv.y;
      tuc = t.x; tvc = t.y;
      tu_im = tim.x; tu_ip = tip.x; tu_jm = tjm.x; tu_jp = tjp.x;
      tv_im = tim.y; tv_ip = tip.y; tv_jm = tjm.y; tv_jp = tjp.y;
    } else {
      uc = u[nb.c]; vc = v[nb.c];
      tuc = tu[nb.c]; tvc = tv[nb.c];
      tu_im = tu[nb.im]; tu_ip = tu[nb.ip]; tu_jm = tu[nb.jm]; tu_jp = tu[nb.jp];
      tv_im = tv[nb.im]; tv_ip = tv[nb.ip]; tv_jm = tv[nb.jm]; tv_jp = tv[nb.jp];
    }
    // J(t * inv) = J(t) * inv, but the JAX kernel scales on read: do the same
    tuc *= inv; tvc *= inv;
    tu_im *= inv; tu_ip *= inv; tu_jm *= inv; tu_jp *= inv;
    tv_im *= inv; tv_ip *= inv; tv_jm *= inv; tv_jp *= inv;
    T o_u, o_v;
    point_jvp<T>(s, uc, vc, tuc, tvc,
                 lap5<T>(tuc, tu_im, tu_ip, tu_jm, tu_jp),
                 lap5<T>(tvc, tv_im, tv_ip, tv_jm, tv_jp), o_u, o_v);
    if (kInterleaved) {
      P o;
      o.x = o_u;
      o.y = o_v;
      reinterpret_cast<P*>(ou)[nb.c] = o;
    } else {
      ou[nb.c] = o_u;
      ov[nb.c] = o_v;
    }
    const B bu = Bits<T>::of(o_u);
    const B bv = Bits<T>::of(o_v);
    m = bu > bv ? bu : bv;
  }
  block_absmax<T>(m, gmax);
}

// ---------------------------------------------------------------------------
// K3
// ---------------------------------------------------------------------------

constexpr int K3_ROWS = 8;                 // warps (rows) a block
constexpr int K3_PTS = 4;                  // points a thread
constexpr int K3_SEG = 32 * K3_PTS;        // points a warp

// bf16x2 words: the low half is the first channel (u), the high half v.
__device__ __forceinline__ unsigned bf2_add(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned bf2_sub(unsigned a, unsigned b) {
  unsigned d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned bf2_mul(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// (lo, hi) rounded to bf16, nearest even
__device__ __forceinline__ unsigned bf2_of(float lo, float hi) {
  unsigned d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

constexpr unsigned BF2_TWO_ONE = 0x3f804000u;   // (2, 1)
constexpr unsigned BF2_FOUR = 0x40804080u;      // (4, 4)
constexpr unsigned BF2_SIGN_HI = 0x80000000u;

struct K3Scalars {
  unsigned al2, A2, ap12;                         // (al, al), (A, A), (A+1, A+1)
  __device__ __forceinline__ explicit K3Scalars(const float* __restrict__ p) {
    const float al = __fdiv_rn(p[2], __fmul_rn(p[3], p[3]));
    const float ap1 = __fadd_rn(p[0], 1.0f);
    al2 = bf2_of(al, al);
    A2 = bf2_of(p[0], p[0]);
    ap12 = bf2_of(ap1, ap1);
  }
};

__device__ __forceinline__ unsigned k3_point(const K3Scalars& s, unsigned uv,
                                             unsigned t, unsigned tim,
                                             unsigned tip, unsigned tjm,
                                             unsigned tjp) {
  const unsigned lap = bf2_sub(bf2_add(bf2_add(bf2_add(tim, tip), tjm), tjp),
                               bf2_mul(BF2_FOUR, t));
  const unsigned pp = bf2_mul(bf2_mul(__byte_perm(uv, 0, 0x1010), BF2_TWO_ONE),
                              __byte_perm(uv, 0, 0x1032));      // (2uv, u^2)
  const unsigned c = bf2_sub(__byte_perm(pp, s.A2, 0x5410),     // (2uv, A)
                             __byte_perm(s.ap12, pp, 0x5410));  // (A+1, 2uv)
  const unsigned w = bf2_mul(__byte_perm(pp, 0, 0x3232),        // (u^2, u^2)
                             __byte_perm(t, 0, 0x3232) ^ BF2_SIGN_HI);
  return bf2_add(bf2_add(bf2_mul(s.al2, lap),
                         bf2_mul(c, __byte_perm(t, 0, 0x1010))), w);
}

// A point of an array as a bf16x2 word: bf16 pairs as they are, f32 pairs
// rounded on read (and widened on write).
template <bool kF32> struct K3Io;
template <> struct K3Io<false> {
  using Elem = unsigned;
  static __device__ __forceinline__ unsigned get(const Elem* a, size_t k) { return a[k]; }
  static __device__ __forceinline__ void get4(const Elem* a, size_t k, unsigned* w) {
    const uint4 x = *reinterpret_cast<const uint4*>(a + k);
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  }
  static __device__ __forceinline__ void put(Elem* a, size_t k, unsigned w) { a[k] = w; }
  static __device__ __forceinline__ void put4(Elem* a, size_t k, const unsigned* w) {
    *reinterpret_cast<uint4*>(a + k) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <> struct K3Io<true> {
  using Elem = float2;
  static __device__ __forceinline__ float lo(unsigned w) { return __uint_as_float(w << 16); }
  static __device__ __forceinline__ float hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
  static __device__ __forceinline__ unsigned get(const Elem* a, size_t k) {
    const float2 x = a[k];
    return bf2_of(x.x, x.y);
  }
  static __device__ __forceinline__ void get4(const Elem* a, size_t k, unsigned* w) {
    const float4 x = *reinterpret_cast<const float4*>(a + k);
    const float4 y = *reinterpret_cast<const float4*>(a + k + 2);
    w[0] = bf2_of(x.x, x.y); w[1] = bf2_of(x.z, x.w);
    w[2] = bf2_of(y.x, y.y); w[3] = bf2_of(y.z, y.w);
  }
  static __device__ __forceinline__ void put(Elem* a, size_t k, unsigned w) {
    a[k] = make_float2(lo(w), hi(w));
  }
  static __device__ __forceinline__ void put4(Elem* a, size_t k, const unsigned* w) {
    *reinterpret_cast<float4*>(a + k) = make_float4(lo(w[0]), hi(w[0]), lo(w[1]), hi(w[1]));
    *reinterpret_cast<float4*>(a + k + 2) = make_float4(lo(w[2]), hi(w[2]), lo(w[3]), hi(w[3]));
  }
};

// Points j .. j+3 of row r: one vector load where the row is 16-byte
// aligned and the four lie inside it, else one load a point at (j+q) mod N.
template <typename Io>
__device__ __forceinline__ void k3_row(const typename Io::Elem* __restrict__ a,
                                       size_t r, int j, int N, bool vec,
                                       unsigned* w) {
  const size_t base = r * static_cast<size_t>(N);
  if (vec && base % K3_PTS == 0 && j + K3_PTS <= N) {
    Io::get4(a, base + j, w);
  } else {
#pragma unroll
    for (int q = 0; q < K3_PTS; ++q) w[q] = Io::get(a, base + (j + q) % N);
  }
}

// K3: interleaved (N, N, 2) bf16 state, tangent and out (kF32: tangent and
// out f32); p is f32.  vec: U, T and out are 16-byte aligned.
template <bool kF32>
__global__ void __launch_bounds__(32 * K3_ROWS)
jvp_bf16_kernel(const unsigned* __restrict__ U,
                const typename K3Io<kF32>::Elem* __restrict__ Tg,
                const float* __restrict__ p,
                typename K3Io<kF32>::Elem* __restrict__ out, int N, bool vec) {
  using Io = K3Io<kF32>;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.y * K3_ROWS + (threadIdx.x >> 5);
  if (i >= N) return;                       // a whole warp: i is per warp
  const int j = blockIdx.x * K3_SEG + lane * K3_PTS;
  const K3Scalars s(p);
  const size_t n = static_cast<size_t>(N);
  const size_t im = i == 0 ? n - 1 : i - 1;
  const size_t ip = i == N - 1 ? 0 : i + 1;
  unsigned uv[K3_PTS], c[K3_PTS + 2], up[K3_PTS], dn[K3_PTS], o[K3_PTS];
  k3_row<K3Io<false>>(U, i, j, N, vec, uv);
  k3_row<Io>(Tg, i, j, N, vec, c + 1);
  k3_row<Io>(Tg, im, j, N, vec, up);
  k3_row<Io>(Tg, ip, j, N, vec, dn);
  // j-1 is the previous lane's last point, j+4 the next lane's first
  c[0] = __shfl_up_sync(0xffffffffu, c[K3_PTS], 1);
  c[K3_PTS + 1] = __shfl_down_sync(0xffffffffu, c[1], 1);
  if (lane == 0) c[0] = Io::get(Tg, i * n + (j - 1 + N) % N);
  if (lane == 31) c[K3_PTS + 1] = Io::get(Tg, i * n + (j + K3_PTS) % N);
#pragma unroll
  for (int q = 0; q < K3_PTS; ++q)
    o[q] = k3_point(s, uv[q], c[q + 1], up[q], dn[q], c[q], c[q + 2]);
  const size_t base = i * n;
  if (vec && base % K3_PTS == 0 && j + K3_PTS <= N) {
    Io::put4(out, base + j, o);
  } else {
#pragma unroll
    for (int q = 0; q < K3_PTS; ++q)
      if (j + q < N) Io::put(out, base + j + q, o[q]);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

inline dim3 grid_of(int N) {
  return dim3((N + BX - 1) / BX, (N + BY - 1) / BY);
}

inline bool aligned16(const void* a) {
  return a == nullptr || reinterpret_cast<uintptr_t>(a) % 16 == 0;
}

template <typename T>
int launch_jvp(const void* U, const void* Tg, const void* p, void* out, int N,
               void* stream) {
  jvp_kernel<T><<<grid_of(N), dim3(BX, BY), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(U), static_cast<const T*>(Tg),
      static_cast<const T*>(p), static_cast<T*>(out), N);
  return static_cast<int>(cudaGetLastError());
}

// K2: its max's word zeroed, then K2 (two launches on the stream).
template <typename T, bool kInterleaved>
int launch_scaled(const void* u, const void* v, const void* tu, const void* tv,
                  const void* p, const void* inv_ptr, double inv_val, void* ou,
                  void* ov, void* absmax, int N, void* stream) {
  using B = typename Bits<T>::type;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  zero_max_kernel<T><<<1, 1, 0, st>>>(static_cast<B*>(absmax));
  auto kernel = inv_ptr ? jvp_scaled_kernel<T, kInterleaved, false>
                        : jvp_scaled_kernel<T, kInterleaved, true>;
  kernel<<<grid_of(N), dim3(BX, BY), 0, st>>>(
      static_cast<const T*>(u), static_cast<const T*>(v),
      static_cast<const T*>(tu), static_cast<const T*>(tv),
      static_cast<const T*>(p), static_cast<const T*>(inv_ptr),
      static_cast<T>(inv_val), static_cast<T*>(ou), static_cast<T*>(ov),
      static_cast<B*>(absmax), N);
  return static_cast<int>(cudaGetLastError());
}

template <bool kF32>
int launch_bf16(const void* U, const void* Tg, const void* p, void* out, int N,
                void* stream) {
  using E = typename K3Io<kF32>::Elem;
  const dim3 grid((N + K3_SEG - 1) / K3_SEG, (N + K3_ROWS - 1) / K3_ROWS);
  const bool vec = aligned16(U) && aligned16(Tg) && aligned16(out);
  jvp_bf16_kernel<kF32><<<grid, 32 * K3_ROWS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(U), static_cast<const E*>(Tg),
      static_cast<const float*>(p), static_cast<E*>(out), N, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* nls_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int brusselator_jvp_f32(const void* U, const void* T, const void* p, void* out,
                        int N, void* stream) {
  return launch_jvp<float>(U, T, p, out, N, stream);
}

int brusselator_jvp_f64(const void* U, const void* T, const void* p, void* out,
                        int N, void* stream) {
  return launch_jvp<double>(U, T, p, out, N, stream);
}

int brusselator_jvp_bf16(const void* U, const void* T, const void* p, void* out,
                         int N, void* stream) {
  return launch_bf16<false>(U, T, p, out, N, stream);
}

int brusselator_jvp_bf16_f32t(const void* U, const void* T, const void* p,
                              void* out, int N, void* stream) {
  return launch_bf16<true>(U, T, p, out, N, stream);
}

// inv_scale: the 0-d tensor at inv_ptr, or inv_val when inv_ptr is null.
int brusselator_jvp_scaled_f32(const void* U, const void* T, const void* p,
                               const void* inv_ptr, double inv_val, void* out,
                               void* absmax, int N, void* stream) {
  return launch_scaled<float, true>(U, nullptr, T, nullptr, p, inv_ptr, inv_val,
                                    out, nullptr, absmax, N, stream);
}

int brusselator_jvp_scaled_f64(const void* U, const void* T, const void* p,
                               const void* inv_ptr, double inv_val, void* out,
                               void* absmax, int N, void* stream) {
  return launch_scaled<double, true>(U, nullptr, T, nullptr, p, inv_ptr,
                                     inv_val, out, nullptr, absmax, N, stream);
}

int brusselator_jvp_scaled_pair_f32(const void* u, const void* v, const void* tu,
                                    const void* tv, const void* p,
                                    const void* inv_ptr, double inv_val,
                                    void* ou, void* ov, void* absmax, int N,
                                    void* stream) {
  return launch_scaled<float, false>(u, v, tu, tv, p, inv_ptr, inv_val, ou, ov,
                                     absmax, N, stream);
}

int brusselator_jvp_scaled_pair_f64(const void* u, const void* v, const void* tu,
                                    const void* tv, const void* p,
                                    const void* inv_ptr, double inv_val,
                                    void* ou, void* ov, void* absmax, int N,
                                    void* stream) {
  return launch_scaled<double, false>(u, v, tu, tv, p, inv_ptr, inv_val, ou, ov,
                                      absmax, N, stream);
}

}  // extern "C"
