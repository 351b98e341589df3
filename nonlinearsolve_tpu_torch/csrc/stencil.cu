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
// 0.1 us of f32 arithmetic at 67 TFLOP/s.  All operands fit the 50 MB L2,
// so in a chained loop the real limit is L2 bandwidth and the launch
// itself.  The design does
// nothing about that yet: one thread per grid point, 32x8 blocks so a warp
// reads 32 neighbouring points, neighbours loaded straight from global
// memory (L1/L2 serve the 5x reuse), no shared-memory tiling, no
// multi-point-per-thread work.  Making it fast is later work.
//
// Layout: the interleaved (N, N, 2) layout of the JAX package is read as is
// — one 8-byte (f32) or 16-byte (f64) load gets (t_u, t_v) of a point, one
// store writes (out_u, out_v).  The planar variant takes four (N, N) planes.
//
// Scalars: p = (A, B, alpha, dx) is read from device memory by pointer (the
// wrapper requires p in the state's dtype), and al = alpha/(dx*dx), A + 1
// are formed in that dtype exactly as the JAX wrapper forms them, so a
// launch never waits on a device-to-host read.  The same holds for K2's
// inv_scale, a 0-d device tensor.
//
// The grid-wide max: every block reduces |out| (warp shuffles, then shared
// memory) on the bit patterns of the non-negative values — for IEEE floats
// >= 0 the integer order is the float order, and a NaN (sign cleared by
// fabs) sorts above +inf, so NaN propagates as jnp.max does — then one
// atomicMax per block into an output the wrapper zeroes.
//
// K3  brusselator_jvp_bf16      replaces nonlinearsolve_tpu/ops/pallas_stencil.py
//                               make_brusselator_jvp_bf16 (K1's pallas_call at
//                               bf16)
//
// K1's function on bf16 state and tangent, bf16 out.  The scalars are
// formed in f32 from p (f32) as the JAX wrapper forms them — al =
// alpha/(dx*dx), A + 1, A — then rounded to bf16, as the Pallas kernel
// casts them.  Every operation rounds to bf16 in the order of the plain
// version (ops/stencil.py _jvp_planes): each is done in f32 with the _rn
// intrinsics (never contracted into an FMA) and rounded to bf16 at once.
// The f32 result of one operation on two bf16 values, rounded again to bf16,
// is the correctly rounded bf16 result (24 >= 2*8 + 2 bits), so the kernel
// agrees with the plain version, which rounds every eager op, bit for bit.
// Bound: bytes, half of K1's at the same N (U, T and out at 2 bytes a
// value: 3 MiB at N=512); the design is K1's.

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

// K2: tangent scaled on read, plus max|out|.  kInterleaved selects the
// (N, N, 2) layout (u = U, tu = T, ou = out; the v pointers are unused) or
// four planar (N, N) planes.
template <typename T, bool kInterleaved>
__global__ void __launch_bounds__(BX * BY)
jvp_scaled_kernel(const T* __restrict__ u, const T* __restrict__ v,
                  const T* __restrict__ tu, const T* __restrict__ tv,
                  const T* __restrict__ p, const T* __restrict__ inv_scale,
                  T* __restrict__ ou, T* __restrict__ ov,
                  typename Bits<T>::type* __restrict__ gmax, int N) {
  using P = typename Pair<T>::type;
  using B = typename Bits<T>::type;
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  B m = B(0);
  if (i < N && j < N) {
    const Scalars<T> s(p);
    const T inv = *inv_scale;
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

// One bf16 operation on bf16-valued floats, rounded to bf16.
__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float badd(float a, float b) { return rbf(__fadd_rn(a, b)); }
__device__ __forceinline__ float bsub(float a, float b) { return rbf(__fsub_rn(a, b)); }
__device__ __forceinline__ float bmul(float a, float b) { return rbf(__fmul_rn(a, b)); }

__device__ __forceinline__ float blap5(float w, float wim, float wip, float wjm,
                                       float wjp) {
  return bsub(badd(badd(badd(wim, wip), wjm), wjp), bmul(4.0f, w));
}

// K3: interleaved (N, N, 2) bf16 in, interleaved bf16 out; p is f32.
__global__ void __launch_bounds__(BX * BY)
jvp_bf16_kernel(const __nv_bfloat162* __restrict__ U,
                const __nv_bfloat162* __restrict__ Tg,
                const float* __restrict__ p, __nv_bfloat162* __restrict__ out,
                int N) {
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  if (i >= N || j >= N) return;
  const float al = rbf(__fdiv_rn(p[2], __fmul_rn(p[3], p[3])));
  const float ap1 = rbf(__fadd_rn(p[0], 1.0f));
  const float A = rbf(p[0]);
  const Nbr nb(i, j, N);
  const float2 uv = __bfloat1622float2(U[nb.c]);
  const float2 t = __bfloat1622float2(Tg[nb.c]);
  const float2 tim = __bfloat1622float2(Tg[nb.im]);
  const float2 tip = __bfloat1622float2(Tg[nb.ip]);
  const float2 tjm = __bfloat1622float2(Tg[nb.jm]);
  const float2 tjp = __bfloat1622float2(Tg[nb.jp]);
  const float two_uv = bmul(bmul(2.0f, uv.x), uv.y);
  const float u2 = bmul(uv.x, uv.x);
  const float lap_u = blap5(t.x, tim.x, tip.x, tjm.x, tjp.x);
  const float lap_v = blap5(t.y, tim.y, tip.y, tjm.y, tjp.y);
  const float ou = badd(badd(bmul(al, lap_u), bmul(bsub(two_uv, ap1), t.x)),
                        bmul(u2, t.y));
  const float ov = bsub(badd(bmul(al, lap_v), bmul(bsub(A, two_uv), t.x)),
                        bmul(u2, t.y));
  out[nb.c] = __floats2bfloat162_rn(ou, ov);
}

inline dim3 grid_of(int N) {
  return dim3((N + BX - 1) / BX, (N + BY - 1) / BY);
}

template <typename T>
int launch_jvp(const void* U, const void* Tg, const void* p, void* out, int N,
               void* stream) {
  jvp_kernel<T><<<grid_of(N), dim3(BX, BY), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(U), static_cast<const T*>(Tg),
      static_cast<const T*>(p), static_cast<T*>(out), N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kInterleaved>
int launch_scaled(const void* u, const void* v, const void* tu, const void* tv,
                  const void* p, const void* inv_scale, void* ou, void* ov,
                  void* absmax, int N, void* stream) {
  using B = typename Bits<T>::type;
  jvp_scaled_kernel<T, kInterleaved>
      <<<grid_of(N), dim3(BX, BY), 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(u), static_cast<const T*>(v),
          static_cast<const T*>(tu), static_cast<const T*>(tv),
          static_cast<const T*>(p), static_cast<const T*>(inv_scale),
          static_cast<T*>(ou), static_cast<T*>(ov), static_cast<B*>(absmax), N);
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
  jvp_bf16_kernel<<<grid_of(N), dim3(BX, BY), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat162*>(U), static_cast<const __nv_bfloat162*>(T),
      static_cast<const float*>(p), static_cast<__nv_bfloat162*>(out), N);
  return static_cast<int>(cudaGetLastError());
}

int brusselator_jvp_scaled_f32(const void* U, const void* T, const void* p,
                               const void* inv_scale, void* out, void* absmax,
                               int N, void* stream) {
  return launch_scaled<float, true>(U, nullptr, T, nullptr, p, inv_scale, out,
                                    nullptr, absmax, N, stream);
}

int brusselator_jvp_scaled_f64(const void* U, const void* T, const void* p,
                               const void* inv_scale, void* out, void* absmax,
                               int N, void* stream) {
  return launch_scaled<double, true>(U, nullptr, T, nullptr, p, inv_scale, out,
                                     nullptr, absmax, N, stream);
}

int brusselator_jvp_scaled_pair_f32(const void* u, const void* v, const void* tu,
                                    const void* tv, const void* p,
                                    const void* inv_scale, void* ou, void* ov,
                                    void* absmax, int N, void* stream) {
  return launch_scaled<float, false>(u, v, tu, tv, p, inv_scale, ou, ov, absmax,
                                     N, stream);
}

int brusselator_jvp_scaled_pair_f64(const void* u, const void* v, const void* tu,
                                    const void* tv, const void* p,
                                    const void* inv_scale, void* ou, void* ov,
                                    void* absmax, int N, void* stream) {
  return launch_scaled<double, false>(u, v, tu, tv, p, inv_scale, ou, ov, absmax,
                                      N, stream);
}

}  // extern "C"
