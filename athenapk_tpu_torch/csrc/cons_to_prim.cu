// The EOS with floors and ceilings on Hopper: eos/adiabatic.py:cons_to_prim
// over a whole state in one launch,
//
//   prim      = cons_to_prim(cons)                     (always)
//   cons_out  = the floored cons                       (with a limit on)
//
// cell by cell through the device function hydro::cons_to_prim<T, NV> of
// hydro_device.cuh, which fused_stage.cu runs too.  Passive scalars are the
// rows NV .. nvar - 1: prim = cons * (1 / floored rho) and cons_out = cons,
// as the plain version computes them; any count runs.  With no floor and no
// ceiling on, the floored cons is the input bit for bit, so the wrapper
// (eos/adiabatic_cuda.py) returns the input and the kernel writes prim only.
//
// Replaces no TPU kernel: the JAX package leaves the EOS to XLA, which
// fuses it into the ops around it.  On the card the plain version is 21
// elementwise launches and two 9-row stacks a call; this is one launch.
//
// What bounds it: bytes.  A cell reads nvar values and writes nvar (2 nvar
// with a limit on) for ~40 floating-point operations, well under one
// operation per byte against the card's ~10 (FP64) at the ridge, so the
// only gain is to move each byte once.  Design: a pure streaming kernel, no
// shared memory.  A thread takes VEC neighbouring cells of a row (x fastest,
// so a warp's loads of one row are contiguous): VEC = 16 / sizeof(T), one
// 16-byte load a row, where the row length and the pointers allow it, else
// VEC = 1.  Every row of the cell is loaded before any arithmetic, through
// the read-only path, so a thread has nvar 16-byte loads in flight; blocks
// of 256 threads over all cells (blockIdx.y over the blocks of the state)
// fill the card many times over at the sizes the main path uses.
//
// Layout: [nb, nvar, ncell] contiguous, ncell = nz * ny * nx, ghosts
// included (every cell is converted, as the plain version converts the
// whole tensor); a row's stride is ncell.
//
// Plain C interface (loaded with ctypes): eos_cons_to_prim(...) returns the
// cudaError_t of the launch (0 on success); it never synchronises.  Built
// with --fmad=false like the other kernels, so it gives the plain version's
// numbers bit for bit (solver/sweep.py:build_library).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hydro_device.cuh"

namespace eos {

using hydro::Params;

constexpr int THREADS = 256;

// VEC neighbouring values of a row: one 16-byte load or store where VEC > 1
__device__ __forceinline__ void load(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}
__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load(const double* p, double (&v)[1]) {
  v[0] = __ldg(p);
}
__device__ __forceinline__ void load(const double* p, double (&v)[2]) {
  const double2 q = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = q.x; v[1] = q.y;
}
__device__ __forceinline__ void store(float* p, const float (&v)[1]) {
  p[0] = v[0];
}
__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store(double* p, const double (&v)[1]) {
  p[0] = v[0];
}
__device__ __forceinline__ void store(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// Thread (blockIdx.x, threadIdx.x) takes cells i .. i + VEC - 1 of every
// block blockIdx.y, blockIdx.y + gridDim.y, ...; ncell % VEC == 0.  uf is
// written only with WRITE_CONS.
template <typename T, int NV, bool WRITE_CONS, int VEC>
__global__ void __launch_bounds__(THREADS)
cons_to_prim_kernel(const T* __restrict__ u, T* __restrict__ uf,
                    T* __restrict__ w, const Params<T> p, int nb, int nvar,
                    long long ncell) {
  const long long i =
      ((long long)blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (i >= ncell) return;
  for (int b = blockIdx.y; b < nb; b += gridDim.y) {
    const long long base = (long long)b * nvar * ncell + i;
    T c[NV][VEC];
#pragma unroll
    for (int v = 0; v < NV; ++v) load(u + base + v * ncell, c[v]);
    T wv[NV][VEC], fv[NV][VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      T uc[NV], wc[NV], fc[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) uc[v] = c[v][k];
      hydro::cons_to_prim<T, NV>(uc, p, fc, wc);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        wv[v][k] = wc[v];
        fv[v][k] = fc[v];
      }
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      store(w + base + v * ncell, wv[v]);
      if constexpr (WRITE_CONS) store(uf + base + v * ncell, fv[v]);
    }
    if (nvar > NV) {
      // the plain version's di = 1 / rho after the density floor
      T di[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) di[k] = T(1) / wv[0][k];
      for (int s = NV; s < nvar; ++s) {
        T q[VEC], r[VEC];
        load(u + base + s * ncell, q);
#pragma unroll
        for (int k = 0; k < VEC; ++k) r[k] = q[k] * di[k];
        store(w + base + s * ncell, r);
        if constexpr (WRITE_CONS) store(uf + base + s * ncell, q);
      }
    }
  }
}

template <typename T, int NV, bool WRITE_CONS, int VEC>
cudaError_t launch(const void* u, void* uf, void* w, const Params<T>& p,
                   int nb, int nvar, long long ncell, cudaStream_t stream) {
  const long long groups = ncell / VEC;
  const long long blocks = (groups + THREADS - 1) / THREADS;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, nb < 65535 ? nb : 65535, 1);
  cons_to_prim_kernel<T, NV, WRITE_CONS, VEC><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(u), static_cast<T*>(uf), static_cast<T*>(w), p,
      nb, nvar, ncell);
  return cudaGetLastError();
}

template <typename T, int NV, bool WRITE_CONS>
cudaError_t launch_vec(const void* u, void* uf, void* w, const Params<T>& p,
                       int nb, int nvar, long long ncell,
                       cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const auto aligned = [](const void* q) {
    return q == nullptr || reinterpret_cast<std::uintptr_t>(q) % 16 == 0;
  };
  if (ncell % VEC == 0 && aligned(u) && aligned(uf) && aligned(w))
    return launch<T, NV, WRITE_CONS, VEC>(u, uf, w, p, nb, nvar, ncell,
                                          stream);
  return launch<T, NV, WRITE_CONS, 1>(u, uf, w, p, nb, nvar, ncell, stream);
}

template <typename T>
cudaError_t launch_any(const void* u, void* uf, void* w,
                       const hydro::EosArgs& e, int nv, int nb, int nvar,
                       long long ncell, cudaStream_t stream) {
  // c_h is not read by cons_to_prim
  const Params<T> p = hydro::make_params<T>(e, 1.0);
  if (nv == 5 && uf == nullptr)
    return launch_vec<T, 5, false>(u, uf, w, p, nb, nvar, ncell, stream);
  if (nv == 5)
    return launch_vec<T, 5, true>(u, uf, w, p, nb, nvar, ncell, stream);
  if (uf == nullptr)
    return launch_vec<T, 9, false>(u, uf, w, p, nb, nvar, ncell, stream);
  return launch_vec<T, 9, true>(u, uf, w, p, nb, nvar, ncell, stream);
}

}  // namespace eos

// prim (and, where cons_out is not null, the floored cons) of the
// contiguous [nb, nvar, ncell] state cons: dtype 0 float, 1 double; nv the
// fluid's variables (5 Euler, 9 GLM-MHD), nvar - nv the passive scalars;
// the floors (<= 0: off) and ceilings (>= 1e300: off) of eos/adiabatic.py's
// EOS.  cons_out and prim must not overlap cons.
extern "C" int eos_cons_to_prim(const void* cons, void* cons_out, void* prim,
                                int dtype, int nv, int nb, int nvar,
                                long long ncell, double gamma, double dfloor,
                                double pfloor, double efloor, double vceil,
                                double eceil, void* stream) {
  if ((nv != 5 && nv != 9) || nvar < nv || nb <= 0 || ncell <= 0)
    return (int)cudaErrorInvalidValue;
  const hydro::EosArgs e{gamma, dfloor, pfloor, efloor, vceil, eceil};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)eos::launch_any<float>(cons, cons_out, prim, e, nv, nb, nvar,
                                       ncell, s);
  if (dtype == 1)
    return (int)eos::launch_any<double>(cons, cons_out, prim, e, nv, nb,
                                        nvar, ncell, s);
  return (int)cudaErrorInvalidValue;
}
