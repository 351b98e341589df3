// Jacobian-vector products of the 3D periodic reaction-diffusion operator
// F(u) = D*lap(u) + u - u^3 + g for Hopper (sm_90a), with a plain C
// interface loaded by ctypes (nonlinearsolve_tpu_torch/ops/stencil3d.py
// holds the wrappers).
//
// K9   rd3d_jvp         replaces nonlinearsolve_tpu/ops/pallas_stencil3d.py
//                       _rd3d_jvp_kernel / _rd3d_jvp_kernel_db
//                       (rd3d_jvp_blocked)
// K10  rd3d_jvp_scaled  replaces nonlinearsolve_tpu/ops/pallas_stencil3d.py
//                       _rd3d_jvp_kernel_db_scaled (rd3d_jvp_scaled)
// K11  rd3d_jvp_halo    replaces nonlinearsolve_tpu/ops/pallas_stencil3d.py
//                       _rd3d_jvp_kernel_halo (rd3d_jvp_blocked_halo)
//
//   out = d_h2 * (inplane + t[z-1] + t[z+1]) + (1 - 3u^2) * t,
//   inplane = t[y-1] + t[y+1] + t[x-1] + t[x+1] - 6t,   d_h2 = D / h^2
//
// on an (nz, ny, nx) grid, periodic in y and x, summed in the JAX kernel's
// order.  K10 multiplies the result by inv_scale (after the stencil, as the
// JAX kernel does) and also reduces max|out| over the whole grid.
//
// Bound on the H100: bytes.  A call reads u and t and writes out: at f32
// 256^3 that is 3 x 64 MiB = 201 MB, 60 us at 3.35 TB/s, against about 13
// flops a point (0.22 GFLOP, 3 us at 67 TFLOP/s).  The operands are four
// times the 50 MB L2, so this kernel streams from HBM.  The design moves
// each of u, t and out across HBM about once: one thread per (y, x) column
// marches bz planes in z and keeps t[z-1], t[z], t[z+1] in registers, so a
// plane of t is loaded once per z-block (plus one halo plane on each side:
// 2/bz extra); its four in-plane neighbours come from the lines that the
// neighbouring threads of the same 32x8 block load (L1), and the block's
// one-row y halo from L2.  No shared-memory tile, no TMA, no multi-column
// work per thread: making it fast is later work.
//
// Halo planes: the plane before z = 0 and the plane after z = nz-1 come in
// through their own pointers (lo, hi).  The periodic wrappers pass t's last
// and first planes; K11, the shard-local kernel of a z-sharded grid
// (pallas_stencil3d.py _rd3d_jvp_kernel_halo), is K9's entry point
// (rd3d_jvp_*) given the planes its neighbours sent and h of the global
// grid.  Its launch is K9's, so K11 on the shards of a grid, each given its
// neighbours' planes, is bit-equal to K9 on the whole grid.  Its bound is
// K9's bytes on the shard plus the two planes.
//
// Scalars: D is read from device memory by pointer and d_h2 = D / T(h2) is
// formed in the state's dtype, as the JAX wrapper forms it (h2 travels by
// value; a wrapper given D as a Python number passes D/h2 itself and
// h2 = 1).  K10's inv_scale is a 0-d device tensor too, so no launch waits
// on a device-to-host read.
//
// The grid-wide max: every block reduces |out| on the bit patterns of the
// non-negative values (for IEEE floats >= 0 the integer order is the float
// order, and a NaN, its sign cleared by fabs, sorts above +inf, so NaN
// propagates as jnp.max does), then one atomicMax per block into an output
// the wrapper zeroes; a block whose max does not exceed the value already
// there skips its atomic (the value only grows).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

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

// Block-wide max of non-negative bit patterns, then at most one atomic per
// block.
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
    const volatile B* seen = gmax;
    if (tid == 0 && m > *seen) atomicMax(gmax, m);
  }
}

// K9 (kScaled = false) and K10 (kScaled = true).  Block (32, 8) covers 32 x
// 8 columns of the (y, x) plane; blockIdx.z picks the z-block of bz planes.
template <typename T, bool kScaled>
__global__ void __launch_bounds__(BX * BY)
rd3d_kernel(const T* __restrict__ u, const T* __restrict__ t,
            const T* __restrict__ lo, const T* __restrict__ hi,
            const T* __restrict__ d, double h2,
            const T* __restrict__ inv_scale, T* __restrict__ out,
            typename Bits<T>::type* __restrict__ gmax,
            int nz, int ny, int nx, int bz) {
  using B = typename Bits<T>::type;
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  B m = B(0);
  if (x < nx && y < ny) {
    const T d_h2 = *d / static_cast<T>(h2);
    const T inv = kScaled ? *inv_scale : T(1);
    const size_t plane = static_cast<size_t>(ny) * static_cast<size_t>(nx);
    const int xm = (x == 0) ? nx - 1 : x - 1;
    const int xp = (x == nx - 1) ? 0 : x + 1;
    const int ym = (y == 0) ? ny - 1 : y - 1;
    const int yp = (y == ny - 1) ? 0 : y + 1;
    const size_t row = static_cast<size_t>(y) * nx;
    const size_t c = row + x;
    const size_t cxm = row + xm;
    const size_t cxp = row + xp;
    const size_t cym = static_cast<size_t>(ym) * nx + x;
    const size_t cyp = static_cast<size_t>(yp) * nx + x;
    const int z0 = blockIdx.z * bz;
    size_t zo = static_cast<size_t>(z0) * plane;
    T t_prev = (z0 == 0) ? lo[c] : t[zo - plane + c];
    T t_cur = t[zo + c];
    for (int k = 0; k < bz; ++k, zo += plane) {
      const int z = z0 + k;
      const T t_next = (z == nz - 1) ? hi[c] : t[zo + plane + c];
      const T* tp = t + zo;
      const T inplane = tp[cym] + tp[cyp] + tp[cxm] + tp[cxp] - T(6) * t_cur;
      const T uc = u[zo + c];
      T o = d_h2 * (inplane + t_prev + t_next) + (T(1) - T(3) * uc * uc) * t_cur;
      if (kScaled) {
        o *= inv;
        const B b = Bits<T>::of(o);
        m = b > m ? b : m;
      }
      out[zo + c] = o;
      t_prev = t_cur;
      t_cur = t_next;
    }
  }
  if (kScaled) block_absmax<T>(m, gmax);
}

template <typename T, bool kScaled>
int launch(const void* u, const void* t, const void* lo, const void* hi,
           const void* d, double h2, const void* inv_scale, void* out,
           void* absmax, int nz, int ny, int nx, int bz, void* stream) {
  if (nz < 1 || ny < 1 || nx < 1 || bz < 1 || nz % bz != 0 || nz / bz > 65535
      || (ny + BY - 1) / BY > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using B = typename Bits<T>::type;
  const dim3 grid((nx + BX - 1) / BX, (ny + BY - 1) / BY, nz / bz);
  rd3d_kernel<T, kScaled><<<grid, dim3(BX, BY), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(t), static_cast<const T*>(lo),
      static_cast<const T*>(hi), static_cast<const T*>(d), h2,
      static_cast<const T*>(inv_scale), static_cast<T*>(out), static_cast<B*>(absmax),
      nz, ny, nx, bz);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* nls_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int rd3d_jvp_f32(const void* u, const void* t, const void* lo, const void* hi,
                 const void* d, double h2, void* out, int nz, int ny, int nx,
                 int bz, void* stream) {
  return launch<float, false>(u, t, lo, hi, d, h2, nullptr, out, nullptr, nz, ny,
                              nx, bz, stream);
}

int rd3d_jvp_f64(const void* u, const void* t, const void* lo, const void* hi,
                 const void* d, double h2, void* out, int nz, int ny, int nx,
                 int bz, void* stream) {
  return launch<double, false>(u, t, lo, hi, d, h2, nullptr, out, nullptr, nz, ny,
                               nx, bz, stream);
}

int rd3d_jvp_scaled_f32(const void* u, const void* t, const void* lo,
                        const void* hi, const void* d, double h2,
                        const void* inv_scale, void* out, void* absmax, int nz,
                        int ny, int nx, int bz, void* stream) {
  return launch<float, true>(u, t, lo, hi, d, h2, inv_scale, out, absmax, nz, ny,
                             nx, bz, stream);
}

int rd3d_jvp_scaled_f64(const void* u, const void* t, const void* lo,
                        const void* hi, const void* d, double h2,
                        const void* inv_scale, void* out, void* absmax, int nz,
                        int ny, int nx, int bz, void* stream) {
  return launch<double, true>(u, t, lo, hi, d, h2, inv_scale, out, absmax, nz, ny,
                              nx, bz, stream);
}

}  // extern "C"
