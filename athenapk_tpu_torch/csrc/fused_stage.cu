// Whole-stage kernel on Hopper: cons_to_prim + the three -div(F) sweeps +
// the 2S stage update in one launch, for Euler (HLLE, HLLC) and GLM-MHD
// (HLLD) on 3-D blocks:
//
//   u0f, prim = cons_to_prim(u0)                       (floors applied)
//   u_new     = gam0*u0f + gam1*u1 + beta_dt * (-div F(prim))
//   dt_out    = per tile, min over its cells of min_d dx_d/(|v_d| + lam_d)
//               of cons_to_prim(u_new)                 (optional)
//   prim_out  = prim                                   (optional)
//
//   faces     = the Riemann fluxes at the block's two interior boundary
//               faces of each direction, sweep index g and n - g     (optional)
//
// Replaces two TPU kernels of athenapk_tpu/solver/pallas_sweep.py:
// make_fused_stage and, with the face output, make_fused_stage_faces (the
// refined-mesh stage: the coarse-fine flux correction reads the faces).
// Their halo slabs, tile fitters, lane packing, owner-tile epilogue and
// (8,128) dt tile work around the TPU's compiler and are not carried over;
// only the contract above is.  The plain PyTorch twins are stage_plain and
// stage_faces_plain in solver/stage.py; the
// device functions (hydro_device.cuh) follow the plain code operation by
// operation (build with --fmad=false to keep it that way).
//
// What bounds it: the stage reads u0 and u1 and writes u_new once (3 NV
// values per cell) and does the arithmetic of three sweeps (PPM + HLLD:
// ~2,500 floating-point operations per cell), ~70 operations per byte in
// f32, so the arithmetic pipes bound it, as they bound the sweep kernel.
// What the fusion saves is the device-memory traffic of the separate
// cons_to_prim, axpy and dt passes, not arithmetic.
//
// Design (simple first): one block per tile of TZ x TY x TX cells.
//  1. It loads u0 for the tile plus h cells on each side along each axis
//     (a "plus" shape without corners: every sweep is 1-D), wrapping each
//     index modulo the block's extent (torch.roll within a block: the
//     periodic boundary on the ghost-free layout, garbage confined to the
//     ghost rim on ghosted layouts), converts every loaded cell to prim
//     and keeps prim in shared memory (halo cells are converted again by
//     the neighbouring tile).
//  2. For each direction a thread walks a segment of SEG cells of one
//     pencil: it reconstructs the SEG+2 cells that touch the segment's
//     faces, solves the SEG+1 faces, and adds -(F[i+1]-F[i])/dx of its SEG
//     cells into a shared-memory accumulator.  Segments cost (SEG+2)/SEG of
//     the reconstruction and (SEG+1)/SEG of the Riemann work; in exchange
//     no edge states or fluxes are staged in shared memory.
//     A face at sweep index g or n - g is solved by two threads (the
//     segment starting at its cell and the one ending there); the first
//     writes it to the face output, so each face is written once.
//  3. Each cell converts u0 once more for the floored conserved state u0f
//     (it, not u0, enters the update), reads u1, and writes u_new; with
//     dt_out it also converts u_new and reduces the CFL bound over the
//     tile.
//
// Plain C interface (loaded with ctypes): fused_stage(...) returns the
// cudaError_t of the launch (0 on success); it never synchronises.

#include <cuda_runtime.h>

#include <limits>

#include "hydro_device.cuh"

namespace {

using namespace hydro;

// The tile is chosen at compile time per dtype, variable count and
// reconstruction; one shape serves all of them today (f64 + 9 variables +
// PPM is the largest, 170,496 bytes), and launch() asserts the size.
template <typename T, int NV, int RECON>
struct Tile {
  static constexpr int TZ = 4, TY = 8, TX = 16;
  static constexpr int SEG = 4;                  // cells a thread walks
  static constexpr int H = Halo<RECON>::h;
  static constexpr int NC = TZ * TY * TX;        // centre cells
  static constexpr int NHX = TZ * TY * 2 * H;    // x halo cells
  static constexpr int NHY = TZ * 2 * H * TX;
  static constexpr int NHZ = 2 * H * TY * TX;
  static constexpr int NP = NC + NHX + NHY + NHZ;
  static constexpr int NTHREADS = NC / SEG;      // one segment per thread
  static constexpr size_t SMEM = sizeof(T) * NV * (NP + NC);
  static_assert(TZ % SEG == 0 && TY % SEG == 0 && TX % SEG == 0,
                "segments tile every axis");
  static_assert(NTHREADS % 32 == 0 && NTHREADS <= 1024, "whole warps");
};

struct Shape {
  int nz, ny, nx;          // extent of a block (ghosts included)
  int ntz, nty, ntx;       // tiles per block along each axis
};

template <typename T>
struct Scalars {
  T gam0, gam1, beta_dt, dx1, dx2, dx3;
  T inf;   // +infinity: the CFL reduction's identity
};

// Face output: per direction [nb, NV, A, B, 2] (x: A, B = z, y; y: z, x;
// z: y, x), entry 0 at sweep index g, 1 at n - g; null pointers: none.
template <typename T>
struct Faces {
  T* d[3];
  int g;
};

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// Index into the shared prim array [NP] of the cell at tile coordinates
// (iz, iy, ix), of which only the coordinate along D may lie outside the
// tile (by up to H cells).
template <typename TL, int D>
__device__ __forceinline__ int plus_index(int iz, int iy, int ix) {
  constexpr int H = TL::H, TZ = TL::TZ, TY = TL::TY, TX = TL::TX;
  if (D == 1) {
    if (ix < 0) return TL::NC + (iz * TY + iy) * 2 * H + ix + H;
    if (ix >= TX) return TL::NC + (iz * TY + iy) * 2 * H + H + ix - TX;
  } else if (D == 2) {
    if (iy < 0) return TL::NC + TL::NHX + (iz * 2 * H + iy + H) * TX + ix;
    if (iy >= TY) return TL::NC + TL::NHX + (iz * 2 * H + H + iy - TY) * TX + ix;
  } else {
    if (iz < 0) return TL::NC + TL::NHX + TL::NHY + ((iz + H) * TY + iy) * TX + ix;
    if (iz >= TZ)
      return TL::NC + TL::NHX + TL::NHY + ((H + iz - TZ) * TY + iy) * TX + ix;
  }
  return (iz * TY + iy) * TX + ix;
}

// Tile coordinates of the i-th cell of the plus shape, enumerated in the
// order plus_index lays them out: centre, x halo, y halo, z halo.
template <typename TL>
__device__ __forceinline__ void plus_coords(int i, int& iz, int& iy, int& ix) {
  constexpr int H = TL::H, TZ = TL::TZ, TY = TL::TY, TX = TL::TX;
  if (i < TL::NC) {
    ix = i % TX; iy = (i / TX) % TY; iz = i / (TX * TY);
  } else if (i < TL::NC + TL::NHX) {
    const int j = i - TL::NC, k = j % (2 * H);
    iy = (j / (2 * H)) % TY; iz = j / (2 * H * TY);
    ix = k < H ? k - H : TX + k - H;
  } else if (i < TL::NC + TL::NHX + TL::NHY) {
    const int j = i - TL::NC - TL::NHX, k = (j / TX) % (2 * H);
    ix = j % TX; iz = j / (TX * 2 * H);
    iy = k < H ? k - H : TY + k - H;
  } else {
    const int j = i - TL::NC - TL::NHX - TL::NHY, k = j / (TX * TY);
    ix = j % TX; iy = (j / TX) % TY;
    iz = k < H ? k - H : TZ + k - H;
  }
}

// One direction of step 2: every thread walks its segments of direction D;
// with FACES it also writes the faces at sweep index g and n - g.
template <typename T, typename TL, int NV, int RECON, int SOLVER, int D,
          bool FACES>
__device__ __forceinline__ void sweep_direction(const T* prim_s, T* nd_s,
                                                const Params<T>& p, T dx,
                                                int vz, int vy, int vx,
                                                T* faces, int g,
                                                const Shape& sh, int z0,
                                                int y0, int x0) {
  constexpr int TZ = TL::TZ, TY = TL::TY, TX = TL::TX, SEG = TL::SEG;
  constexpr int R = TL::H - 1;   // stencil radius of one cell's edge states
  constexpr int NITEMS = TL::NC / SEG;
  for (int item = threadIdx.x; item < NITEMS; item += TL::NTHREADS) {
    int iz, iy, ix;   // first cell of the segment
    if (D == 1) {
      ix = (item % (TX / SEG)) * SEG; iy = (item / (TX / SEG)) % TY;
      iz = item / ((TX / SEG) * TY);
    } else if (D == 2) {
      ix = item % TX; iy = ((item / TX) % (TY / SEG)) * SEG;
      iz = item / (TX * (TY / SEG));
    } else {
      ix = item % TX; iy = (item / TX) % TY; iz = (item / (TX * TY)) * SEG;
    }
    if (iz >= vz || iy >= vy || ix >= vx) continue;   // outside the block
    const int s0 = D == 1 ? ix : (D == 2 ? iy : iz);
    T wl[NV], wr[NV], qp_c[NV], F[NV], F_prev[NV];
    // cells s0-1 .. s0+SEG; the face between c-1 and c is solved at c >= s0
    for (int c = s0 - 1; c <= s0 + SEG; ++c) {
      int idx[2 * R + 1];
#pragma unroll
      for (int k = -R; k <= R; ++k)
        idx[k + R] = D == 1 ? plus_index<TL, 1>(iz, iy, c + k)
                   : D == 2 ? plus_index<TL, 2>(iz, c + k, ix)
                            : plus_index<TL, 3>(c + k, iy, ix);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const T* q = prim_s + v * TL::NP;
        if constexpr (RECON == RECON_PPM)
          ppm_edges(q[idx[0]], q[idx[1]], q[idx[2]], q[idx[3]], q[idx[4]],
                    wr[v], qp_c[v]);
        else if constexpr (RECON == RECON_PLM)
          plm_edges(q[idx[0]], q[idx[1]], q[idx[2]], wr[v], qp_c[v]);
        else
          wr[v] = qp_c[v] = q[idx[0]];
      }
      if (c >= s0) {
        riemann_flux<T, SOLVER, D>(wl, wr, p, F);
        // face capture: the face before cell c, by the segment holding c
        // (a compile-time switch: without it the loop is the uniform
        // path's; a run-time branch here slowed DC stages by 8 % on an
        // H100)
        if (FACES && c < s0 + SEG) {
          const int n_d = D == 1 ? sh.nx : (D == 2 ? sh.ny : sh.nz);
          const int G = (D == 1 ? x0 : (D == 2 ? y0 : z0)) + c;
          const int k = G == g ? 0 : (G == n_d - g ? 1 : -1);
          if (k >= 0) {
            const long long A = D == 3 ? sh.ny : sh.nz;
            const long long B = D == 1 ? sh.ny : sh.nx;
            const long long a = D == 3 ? y0 + iy : z0 + iz;
            const long long b = D == 1 ? y0 + iy : x0 + ix;
#pragma unroll
            for (int v = 0; v < NV; ++v)
              faces[((((long long)blockIdx.y * NV + v) * A + a) * B + b) * 2
                    + k] = F[v];
          }
        }
        if (c > s0) {
          const int cell = D == 1 ? (iz * TY + iy) * TX + c - 1
                         : D == 2 ? (iz * TY + c - 1) * TX + ix
                                  : ((c - 1) * TY + iy) * TX + ix;
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const T r = -(F[v] - F_prev[v]) / dx;
            nd_s[v * TL::NC + cell] = D == 1 ? r : nd_s[v * TL::NC + cell] + r;
          }
        }
#pragma unroll
        for (int v = 0; v < NV; ++v) F_prev[v] = F[v];
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) wl[v] = qp_c[v];
    }
  }
}

template <typename T, int RECON, int SOLVER, bool FACES>
__global__ void __launch_bounds__((Tile<T, NVar<SOLVER>::value, RECON>::NTHREADS))
fused_stage_kernel(const T* __restrict__ u0, const T* __restrict__ u1,
                   T* __restrict__ out, T* __restrict__ dt_out,
                   T* __restrict__ prim_out, const Faces<T> fc,
                   const Shape sh, const Params<T> p, const Scalars<T> sc) {
  constexpr int NV = NVar<SOLVER>::value;
  using TL = Tile<T, NV, RECON>;
  constexpr int TZ = TL::TZ, TY = TL::TY, TX = TL::TX;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* prim_s = reinterpret_cast<T*>(smem_raw);   // [NV][NP]
  T* nd_s = prim_s + NV * TL::NP;               // [NV][NC]
  __shared__ T red_s[32];

  const int tile = blockIdx.x;
  const int x0 = (tile % sh.ntx) * TX;
  const int y0 = ((tile / sh.ntx) % sh.nty) * TY;
  const int z0 = (tile / (sh.ntx * sh.nty)) * TZ;
  // cells of the tile that lie inside the block
  const int vx = min(TX, sh.nx - x0), vy = min(TY, sh.ny - y0),
            vz = min(TZ, sh.nz - z0);
  const long long s_var = (long long)sh.nz * sh.ny * sh.nx;
  const long long base = (long long)blockIdx.y * NV * s_var;

  // 1. prim of the plus shape
  for (int i = threadIdx.x; i < TL::NP; i += TL::NTHREADS) {
    int iz, iy, ix;
    plus_coords<TL>(i, iz, iy, ix);
    const long long o = base
        + ((long long)wrap(z0 + iz, sh.nz) * sh.ny + wrap(y0 + iy, sh.ny)) * sh.nx
        + wrap(x0 + ix, sh.nx);
    T u[NV], w[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) u[v] = u0[o + v * s_var];
    cons_to_prim<T, NV>(u, p, u, w);
#pragma unroll
    for (int v = 0; v < NV; ++v) prim_s[v * TL::NP + i] = w[v];
    if (prim_out != nullptr && i < TL::NC && iz < vz && iy < vy && ix < vx) {
#pragma unroll
      for (int v = 0; v < NV; ++v) prim_out[o + v * s_var] = w[v];
    }
  }
  __syncthreads();

  // 2. -div(F), one direction after the other (x writes, y and z add)
  sweep_direction<T, TL, NV, RECON, SOLVER, 1, FACES>(
      prim_s, nd_s, p, sc.dx1, vz, vy, vx, fc.d[0], fc.g, sh, z0, y0, x0);
  __syncthreads();
  sweep_direction<T, TL, NV, RECON, SOLVER, 2, FACES>(
      prim_s, nd_s, p, sc.dx2, vz, vy, vx, fc.d[1], fc.g, sh, z0, y0, x0);
  __syncthreads();
  sweep_direction<T, TL, NV, RECON, SOLVER, 3, FACES>(
      prim_s, nd_s, p, sc.dx3, vz, vy, vx, fc.d[2], fc.g, sh, z0, y0, x0);
  __syncthreads();

  // 3. the stage update, and the CFL bound of the new state
  T dt_min = sc.inf;
  for (int i = threadIdx.x; i < TL::NC; i += TL::NTHREADS) {
    const int ix = i % TX, iy = (i / TX) % TY, iz = i / (TX * TY);
    if (iz >= vz || iy >= vy || ix >= vx) continue;
    const long long o = base + ((long long)(z0 + iz) * sh.ny + y0 + iy) * sh.nx
                        + x0 + ix;
    T u[NV], w[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) u[v] = u0[o + v * s_var];
    cons_to_prim<T, NV>(u, p, u, w);   // u is now u0f
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      u[v] = sc.gam0 * u[v] + sc.gam1 * u1[o + v * s_var]
             + sc.beta_dt * nd_s[v * TL::NC + i];
      out[o + v * s_var] = u[v];
    }
    if (dt_out != nullptr) {
      cons_to_prim<T, NV>(u, p, u, w);
      dt_min = nan_min(dt_min, cell_cfl_dt<T, NV>(w, p, sc.dx1, sc.dx2, sc.dx3));
    }
  }
  if (dt_out != nullptr) {
    for (int off = 16; off > 0; off >>= 1)
      dt_min = nan_min(dt_min, __shfl_down_sync(0xffffffffu, dt_min, off));
    if (threadIdx.x % 32 == 0) red_s[threadIdx.x / 32] = dt_min;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int k = 1; k < TL::NTHREADS / 32; ++k) dt_min = nan_min(dt_min, red_s[k]);
      dt_out[(long long)blockIdx.y * gridDim.x + tile] = dt_min;
    }
  }
}

struct Args {
  const void* u0;
  const void* u1;
  void* out;
  void* dt_out;     // null: no CFL bound
  void* prim_out;   // null: no prim
  void* faces[3];   // null: no face capture
  int g_face;
  int nb, nz, ny, nx;
  double dx1, dx2, dx3, gam0, gam1, beta_dt, c_h;
  EosArgs eos;
  cudaStream_t stream;
};

template <typename TL>
Shape shape_of(int nz, int ny, int nx) {
  Shape sh;
  sh.nz = nz; sh.ny = ny; sh.nx = nx;
  sh.ntz = (nz + TL::TZ - 1) / TL::TZ;
  sh.nty = (ny + TL::TY - 1) / TL::TY;
  sh.ntx = (nx + TL::TX - 1) / TL::TX;
  return sh;
}

template <typename T, int RECON, int SOLVER>
cudaError_t launch(const Args& a) {
  using TL = Tile<T, NVar<SOLVER>::value, RECON>;
  static_assert(TL::SMEM <= 232448, "tile exceeds a block's shared memory");
  auto kernel = a.faces[0] != nullptr
                    ? fused_stage_kernel<T, RECON, SOLVER, true>
                    : fused_stage_kernel<T, RECON, SOLVER, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TL::SMEM);
  if (err != cudaSuccess) return err;
  const Shape sh = shape_of<TL>(a.nz, a.ny, a.nx);
  // scalars arrive as doubles and are rounded to T once, as the plain
  // path's Python floats are
  const Params<T> p = make_params<T>(a.eos, a.c_h);
  Scalars<T> sc;
  sc.gam0 = T(a.gam0); sc.gam1 = T(a.gam1); sc.beta_dt = T(a.beta_dt);
  sc.dx1 = T(a.dx1); sc.dx2 = T(a.dx2); sc.dx3 = T(a.dx3);
  sc.inf = std::numeric_limits<T>::infinity();
  Faces<T> fc;
  for (int d = 0; d < 3; ++d) fc.d[d] = static_cast<T*>(a.faces[d]);
  fc.g = a.g_face;
  dim3 grid(sh.ntz * sh.nty * sh.ntx, a.nb);
  kernel<<<grid, TL::NTHREADS, TL::SMEM, a.stream>>>(
      static_cast<const T*>(a.u0), static_cast<const T*>(a.u1),
      static_cast<T*>(a.out), static_cast<T*>(a.dt_out),
      static_cast<T*>(a.prim_out), fc, sh, p, sc);
  return cudaGetLastError();
}

template <typename T, int RECON>
cudaError_t launch_solver(int solver, const Args& a) {
  switch (solver) {
    case SOLVER_EULER_HLLE:  return launch<T, RECON, SOLVER_EULER_HLLE>(a);
    case SOLVER_EULER_HLLC:  return launch<T, RECON, SOLVER_EULER_HLLC>(a);
    case SOLVER_GLMMHD_HLLD: return launch<T, RECON, SOLVER_GLMMHD_HLLD>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_recon(int recon, int solver, const Args& a) {
  switch (recon) {
    case RECON_DC:  return launch_solver<T, RECON_DC>(solver, a);
    case RECON_PLM: return launch_solver<T, RECON_PLM>(solver, a);
    case RECON_PPM: return launch_solver<T, RECON_PPM>(solver, a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Tiles that one [nz, ny, nx] block is cut into: dt_out holds nb times this
// many values.  One tile shape serves every instantiation.
extern "C" int fused_stage_tiles(int nz, int ny, int nx) {
  const Shape sh = shape_of<Tile<float, 5, RECON_DC>>(nz, ny, nx);
  return sh.ntz * sh.nty * sh.ntx;
}

// dtype: 0 = float32, 1 = float64.  solver: 0 = Euler HLLE, 1 = Euler HLLC,
// 2 = GLM-MHD HLLD.  recon: 0 = dc, 1 = plm, 2 = ppm.  u0, u1, out and
// prim_out: contiguous [nb, nvar, nz, ny, nx] on the current device, nvar = 5
// (Euler) or 9 (GLM-MHD); dt_out: nb * fused_stage_tiles(nz, ny, nx) values.
// dt_out and prim_out may be null.  eos: gamma, density floor, pressure
// floor, internal-energy floor, velocity ceiling, internal-energy ceiling
// (a floor <= 0 and an infinite ceiling are off).  fx, fy, fz (all null,
// or none): contiguous [nb, nvar, NZ, NY, 2], [nb, nvar, NZ, NX, 2] and
// [nb, nvar, NY, NX, 2], the fluxes at sweep index g_face and n - g_face of
// x, y and z, with 0 < g_face < min(nz, ny, nx) / 2.
extern "C" int fused_stage(const void* u0, const void* u1, void* out,
                           void* dt_out, void* prim_out, void* fx, void* fy,
                           void* fz, int g_face, int dtype, int solver,
                           int recon, int nb, int nvar, int nz, int ny, int nx,
                           double dx1, double dx2, double dx3, double gam0,
                           double gam1, double beta_dt, double c_h,
                           const double* eos, void* stream) {
  const int want = solver == SOLVER_GLMMHD_HLLD ? 9 : 5;
  const bool any_faces = fx != nullptr || fy != nullptr || fz != nullptr;
  if (nvar != want || nb <= 0 || nz <= 0 || ny <= 0 || nx <= 0
      || (any_faces && (fx == nullptr || fy == nullptr || fz == nullptr
                        || g_face <= 0 || 2 * g_face >= nz
                        || 2 * g_face >= ny || 2 * g_face >= nx)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.u0 = u0; a.u1 = u1; a.out = out; a.dt_out = dt_out; a.prim_out = prim_out;
  a.faces[0] = fx; a.faces[1] = fy; a.faces[2] = fz; a.g_face = g_face;
  a.nb = nb; a.nz = nz; a.ny = ny; a.nx = nx;
  a.dx1 = dx1; a.dx2 = dx2; a.dx3 = dx3;
  a.gam0 = gam0; a.gam1 = gam1; a.beta_dt = beta_dt; a.c_h = c_h;
  a.eos = EosArgs{eos[0], eos[1], eos[2], eos[3], eos[4], eos[5]};
  a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_recon<float>(recon, solver, a);
  if (dtype == 1) return (int)launch_recon<double>(recon, solver, a);
  return (int)cudaErrorInvalidValue;
}
