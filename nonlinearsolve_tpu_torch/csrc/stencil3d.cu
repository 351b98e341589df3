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
// times the 50 MB L2, so this kernel streams from HBM, and what keeps it
// from the bound is the bytes it has in flight: the first design (one
// thread a column, one scalar load of t[z+1] and of u a plane, issued after
// the previous plane's arithmetic; bench/rd3d_designs.cu) reached 0.54 of
// the bound at f32 and 0.80 at f64, whose loads carry twice the bytes.
//
// Design: a block of 32 x 8 threads owns a (y, x) tile of 8 rows
// and 32 x kVec columns (kVec = 16 bytes of T: 4 floats, 2 doubles) and
// marches the bz planes of its z-block.  Each thread owns kVec consecutive
// x points of one row.  A ring of kStages slots in shared memory holds, a
// slot a plane, the t tile with its one-point y and x halo and the u tile;
// cp.async fills slot k + kStages while plane k is computed, so up to three
// planes of t and u are in flight behind the one being computed, and every
// interior load and store is 16 bytes wide.  A plane's in-plane neighbours
// come from the shared t tile, t[z-1] from the registers of the previous
// plane, t[z+1] from the next slot.  Where nx is not a multiple of kVec or
// a pointer is not 16-byte aligned, the same kernel loads and stores one
// element at a time.
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
// Every point is computed by the same expression as in the first design
// (rd3d_point, the JAX kernel's order), so the two designs give the same
// bits; chip_smoke.py holds them to that on every shape it checks.
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

constexpr int kLanes = 32;                 // a warp: one row of the tile
constexpr int kRows = 8;                   // tile rows, one warp each
constexpr int kThreads = kLanes * kRows;
constexpr int kStages = 5;                 // ring slots (planes) in shared memory

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

// The layout of one ring slot: the t tile, kRows + 2 rows (row 0 is y0-1,
// row r is y0+r-1) of kPitch elements (kVec of padding, so that the
// interior starts 16-byte aligned; the x halo x0-1 sits just before the
// interior, x0+(valid columns) just after the last valid one), then the u
// tile, kRows rows of kTX.
template <typename T>
struct Tile {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kTX = kLanes * kVec;
  static constexpr int kPitch = kTX + 2 * kVec;
  static constexpr int kTElems = (kRows + 2) * kPitch;
  static constexpr int kSlot = kTElems + kRows * kTX;
  static constexpr size_t kSmemBytes = static_cast<size_t>(kStages) * kSlot * sizeof(T);
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(N)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// kVec consecutive elements from global to shared: one 16-byte copy, or
// one copy an element (the unaligned path), each only where x < nx.
template <typename T, bool kWide>
__device__ __forceinline__ void copy_run(T* dst, const T* src, int x, int nx) {
  constexpr int kVec = Tile<T>::kVec;
  if (kWide) {
    if (x < nx) cp_async16(dst, src);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if (x + e < nx) cp_async_small<sizeof(T)>(dst + e, src + e);
    }
  }
}

// One ring slot: the t tile (with its halo) of plane pz (pz = -1 is lo,
// pz = nz is hi) and, for a plane of the grid, the u tile.
template <typename T, bool kWide>
__device__ __forceinline__ void load_slot(T* slot, const T* __restrict__ u,
                                          const T* __restrict__ t,
                                          const T* __restrict__ lo,
                                          const T* __restrict__ hi, int pz, int nz,
                                          int ny, int nx, size_t plane, int x0, int y0,
                                          int tx_valid, int ty_valid, int tid) {
  using L = Tile<T>;
  const T* src = pz < 0 ? lo : (pz >= nz ? hi : t + static_cast<size_t>(pz) * plane);
  // t rows 0 .. ty_valid + 1, kLanes runs of kVec a row
  for (int j = tid; j < (ty_valid + 2) * kLanes; j += kThreads) {
    const int r = j / kLanes;
    const int q = j - r * kLanes;
    int y = y0 + r - 1;
    y = y < 0 ? ny - 1 : (y >= ny ? 0 : y);
    const int x = x0 + q * L::kVec;
    copy_run<T, kWide>(slot + r * L::kPitch + L::kVec + q * L::kVec,
                       src + static_cast<size_t>(y) * nx + x, x, nx);
  }
  // the x halo of rows 1 .. ty_valid: x0-1 and x0+tx_valid, periodic
  if (tid < 2 * ty_valid) {
    const int r = 1 + (tid >> 1);
    const int right = tid & 1;
    const int x = right ? (x0 + tx_valid == nx ? 0 : x0 + tx_valid) : (x0 == 0 ? nx - 1 : x0 - 1);
    const int col = right ? L::kVec + tx_valid : L::kVec - 1;
    cp_async_small<sizeof(T)>(slot + r * L::kPitch + col,
                              src + static_cast<size_t>(y0 + r - 1) * nx + x);
  }
  if (pz >= 0 && pz < nz) {
    T* us = slot + L::kTElems;
    const T* usrc = u + static_cast<size_t>(pz) * plane;
    const int r = tid / kLanes;
    const int q = tid - r * kLanes;
    if (r < ty_valid) {
      const int x = x0 + q * L::kVec;
      copy_run<T, kWide>(us + r * L::kTX + q * L::kVec,
                         usrc + static_cast<size_t>(y0 + r) * nx + x, x, nx);
    }
  }
}

// kVec results as one 16-byte store.
__device__ __forceinline__ void store_run(float* dst, const float* o) {
  *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store_run(double* dst, const double* o) {
  *reinterpret_cast<double2*>(dst) = make_double2(o[0], o[1]);
}

// One point, in the JAX kernel's order (the first design's expression).
template <typename T>
__device__ __forceinline__ T rd3d_point(T ym, T yp, T xm, T xp, T c, T prev, T next,
                                        T uc, T d_h2) {
  const T inplane = ym + yp + xm + xp - T(6) * c;
  return d_h2 * (inplane + prev + next) + (T(1) - T(3) * uc * uc) * c;
}

// Block-wide max of non-negative bit patterns, then at most one atomic per
// block.
template <typename T>
__device__ __forceinline__ void block_absmax(typename Bits<T>::type m,
                                             typename Bits<T>::type* gmax, int tid) {
  using B = typename Bits<T>::type;
  __shared__ B warp_max[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const B o = __shfl_down_sync(0xffffffffu, m, off);
    m = o > m ? o : m;
  }
  if ((tid & 31) == 0) warp_max[tid >> 5] = m;
  __syncthreads();
  if (tid < 32) {
    m = tid < (kThreads / 32) ? warp_max[tid] : B(0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const B o = __shfl_down_sync(0xffffffffu, m, off);
      m = o > m ? o : m;
    }
    const volatile B* seen = gmax;
    if (tid == 0 && m > *seen) atomicMax(gmax, m);
  }
}

// K9 (kScaled = false) and K10 (kScaled = true); kWide: 16-byte copies.
// Grid: (x tiles, y tiles, nz / bz); block: kThreads threads.
template <typename T, bool kScaled, bool kWide>
__global__ void __launch_bounds__(kThreads)
rd3d_kernel(const T* __restrict__ u, const T* __restrict__ t,
            const T* __restrict__ lo, const T* __restrict__ hi,
            const T* __restrict__ d, double h2,
            const T* __restrict__ inv_scale, T* __restrict__ out,
            typename Bits<T>::type* __restrict__ gmax,
            int nz, int ny, int nx, int bz) {
  using L = Tile<T>;
  using B = typename Bits<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & (kLanes - 1);
  const int row = tid / kLanes;
  const int x0 = blockIdx.x * L::kTX;
  const int y0 = blockIdx.y * kRows;
  const int tx_valid = min(L::kTX, nx - x0);
  const int ty_valid = min(kRows, ny - y0);
  const int z0 = blockIdx.z * bz;
  const size_t plane = static_cast<size_t>(ny) * static_cast<size_t>(nx);
  const int n_loads = bz + 2;               // load i is plane z0 - 1 + i

  // prologue: the first kStages planes (an empty group past the last)
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (i < n_loads) {
      load_slot<T, kWide>(ring + i * L::kSlot, u, t, lo, hi, z0 - 1 + i, nz, ny, nx, plane,
                          x0, y0, tx_valid, ty_valid, tid);
    }
    cp_async_commit();
  }

  const int x = x0 + lane * L::kVec;
  const bool mine = row < ty_valid && x < nx;
  const int col = L::kVec + lane * L::kVec;     // this thread's first column in a t row
  const T d_h2 = *d / static_cast<T>(h2);
  const T inv = kScaled ? *inv_scale : T(1);
  B m = B(0);

  // t[z0 - 1] of this thread's points, from slot 0
  T prev[L::kVec];
  cp_async_wait<kStages - 3>();
  __syncthreads();
#pragma unroll
  for (int e = 0; e < L::kVec; ++e) prev[e] = ring[(1 + row) * L::kPitch + col + e];

  for (int k = 0; k < bz; ++k) {
    // loads 0 .. k + 2 have landed; every thread is done with plane k - 1
    cp_async_wait<kStages - 3>();
    __syncthreads();
    // slot k % kStages held load k (plane z0 + k - 1), read for the last
    // time at step k - 1: refill it with load k + kStages
    const int i = k + kStages;
    if (i < n_loads) {
      load_slot<T, kWide>(ring + (k % kStages) * L::kSlot, u, t, lo, hi, z0 - 1 + i, nz, ny,
                          nx, plane, x0, y0, tx_valid, ty_valid, tid);
    }
    cp_async_commit();

    const T* cur = ring + ((k + 1) % kStages) * L::kSlot;   // plane z0 + k
    const T* nxt = ring + ((k + 2) % kStages) * L::kSlot;   // plane z0 + k + 1
    const T* c_row = cur + (1 + row) * L::kPitch + col;
    const T* ym_row = c_row - L::kPitch;
    const T* yp_row = c_row + L::kPitch;
    const T* n_row = nxt + (1 + row) * L::kPitch + col;
    const T* u_row = cur + L::kTElems + row * L::kTX + lane * L::kVec;
    T c[L::kVec + 2], ym[L::kVec], yp[L::kVec], nx_[L::kVec], uc[L::kVec];
#pragma unroll
    for (int e = 0; e < L::kVec + 2; ++e) c[e] = c_row[e - 1];
#pragma unroll
    for (int e = 0; e < L::kVec; ++e) {
      ym[e] = ym_row[e];
      yp[e] = yp_row[e];
      nx_[e] = n_row[e];
      uc[e] = u_row[e];
    }
    T o[L::kVec];
#pragma unroll
    for (int e = 0; e < L::kVec; ++e) {
      o[e] = rd3d_point<T>(ym[e], yp[e], c[e], c[e + 2], c[e + 1], prev[e], nx_[e], uc[e],
                           d_h2);
      if (kScaled) {
        o[e] *= inv;
        if (x + e < nx) {
          const B b = Bits<T>::of(o[e]);
          m = (mine && b > m) ? b : m;
        }
      }
      prev[e] = c[e + 1];
    }
    if (mine) {
      T* dst = out + static_cast<size_t>(z0 + k) * plane + static_cast<size_t>(y0 + row) * nx + x;
      if (kWide) {
        store_run(dst, o);
      } else {
#pragma unroll
        for (int e = 0; e < L::kVec; ++e) {
          if (x + e < nx) dst[e] = o[e];
        }
      }
    }
  }
  cp_async_wait<0>();
  if (kScaled) block_absmax<T>(m, gmax, tid);
}

template <typename T, bool kScaled, bool kWide>
int launch_as(const dim3& grid, size_t smem, const void* u, const void* t, const void* lo,
              const void* hi, const void* d, double h2, const void* inv_scale, void* out,
              void* absmax, int nz, int ny, int nx, int bz, cudaStream_t stream) {
  using B = typename Bits<T>::type;
  rd3d_kernel<T, kScaled, kWide><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(t), static_cast<const T*>(lo),
      static_cast<const T*>(hi), static_cast<const T*>(d), h2,
      static_cast<const T*>(inv_scale), static_cast<T*>(out), static_cast<B*>(absmax),
      nz, ny, nx, bz);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T, bool kScaled>
int launch(const void* u, const void* t, const void* lo, const void* hi,
           const void* d, double h2, const void* inv_scale, void* out,
           void* absmax, int nz, int ny, int nx, int bz, void* stream) {
  using L = Tile<T>;
  if (nz < 1 || ny < 1 || nx < 1 || bz < 1 || nz % bz != 0 || nz / bz > 65535
      || (ny + kRows - 1) / kRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static_assert(Tile<T>::kSmemBytes <= 48 * 1024, "the ring fits the default shared memory");
  const dim3 grid((nx + L::kTX - 1) / L::kTX, (ny + kRows - 1) / kRows, nz / bz);
  const bool wide = nx % L::kVec == 0 && aligned16(u) && aligned16(t) && aligned16(lo)
                    && aligned16(hi) && aligned16(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wide ? launch_as<T, kScaled, true>(grid, L::kSmemBytes, u, t, lo, hi, d, h2,
                                            inv_scale, out, absmax, nz, ny, nx, bz, s)
              : launch_as<T, kScaled, false>(grid, L::kSmemBytes, u, t, lo, hi, d, h2,
                                             inv_scale, out, absmax, nz, ny, nx, bz, s);
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
