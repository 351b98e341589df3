// Design study of K9 / K10 / K11 (rd3d_kernel, ../csrc/stencil3d.cu): the
// first design of the 3D reaction-diffusion JVP kernel, kept beside the
// redesign to hold it bit for bit and to time the two side by side on the
// card.  chip_smoke.py builds it with the package's nvcc flags into a shared
// library (a plain C interface, loaded by ctypes) and calls
//
//   column_rd3d_jvp_{f32,f64}(u, t, lo, hi, d, h2, out, nz, ny, nx, bz, stream)
//   column_rd3d_jvp_scaled_{f32,f64}(u, t, lo, hi, d, h2, inv_scale, out,
//                                    absmax, nz, ny, nx, bz, stream)
//
// with csrc/stencil3d.cu's arguments.  The design ("column"): one thread a
// (y, x) column of a 32 x 8 block, marching bz planes in z with t[z-1],
// t[z], t[z+1] in registers; each plane's t[z+1] and u are loaded only
// after the previous plane's arithmetic, one scalar each, and the four
// in-plane neighbours are four more scalar loads through L1 / L2.  On the
// H100 it reached 0.54 of the byte bound at f32 256^3 and 0.80 at f64: each
// thread has 8 bytes of new HBM data in flight a plane at f32 (16 at f64),
// so the f32 kernel waits out DRAM latency rather than bandwidth.  The
// per-point arithmetic, in the JAX kernel's order, is the redesign's, so
// the two give the same bits.

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
rd3d_column_kernel(const T* __restrict__ u, const T* __restrict__ t,
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
  rd3d_column_kernel<T, kScaled><<<grid, dim3(BX, BY), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(t), static_cast<const T*>(lo),
      static_cast<const T*>(hi), static_cast<const T*>(d), h2,
      static_cast<const T*>(inv_scale), static_cast<T*>(out), static_cast<B*>(absmax),
      nz, ny, nx, bz);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int column_rd3d_jvp_f32(const void* u, const void* t, const void* lo, const void* hi,
                 const void* d, double h2, void* out, int nz, int ny, int nx,
                 int bz, void* stream) {
  return launch<float, false>(u, t, lo, hi, d, h2, nullptr, out, nullptr, nz, ny,
                              nx, bz, stream);
}

int column_rd3d_jvp_f64(const void* u, const void* t, const void* lo, const void* hi,
                 const void* d, double h2, void* out, int nz, int ny, int nx,
                 int bz, void* stream) {
  return launch<double, false>(u, t, lo, hi, d, h2, nullptr, out, nullptr, nz, ny,
                               nx, bz, stream);
}

int column_rd3d_jvp_scaled_f32(const void* u, const void* t, const void* lo,
                        const void* hi, const void* d, double h2,
                        const void* inv_scale, void* out, void* absmax, int nz,
                        int ny, int nx, int bz, void* stream) {
  return launch<float, true>(u, t, lo, hi, d, h2, inv_scale, out, absmax, nz, ny,
                             nx, bz, stream);
}

int column_rd3d_jvp_scaled_f64(const void* u, const void* t, const void* lo,
                        const void* hi, const void* d, double h2,
                        const void* inv_scale, void* out, void* absmax, int nz,
                        int ny, int nx, int bz, void* stream) {
  return launch<double, true>(u, t, lo, hi, d, h2, inv_scale, out, absmax, nz, ny,
                              nx, bz, stream);
}

}  // extern "C"
