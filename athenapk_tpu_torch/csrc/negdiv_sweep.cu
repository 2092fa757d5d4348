// Fused -div(F) sweep on Hopper: reconstruction + Riemann solve + flux
// divergence for one direction per launch, for Euler (HLLE, HLLC) and
// GLM-MHD (HLLD).
//
// Replaces five TPU kernels of athenapk_tpu/solver/pallas_sweep.py:
// make_lane_sweep_negdiv (one direction, sweep axis on the lanes), as
// composed by make_fused_negdiv (sum over the active directions, y and z
// reached by transposes), and make_fused_negdiv_v2 (the same sum in the
// canonical layout, the default of 1-D and 2-D meshes); and, with the face
// output, their refined-mesh forms make_lane_sweep_negdiv_faces (composed
// by make_fused_negdiv_faces) and make_fused_negdiv_faces_v2 (3-D kernel
// and 2-D kernel2), which also return the Riemann fluxes at a block's two
// interior boundary faces of each direction, sweep index g and n - g (n
// the block's extent with ghosts): what the coarse-fine flux correction
// reads.  The launch of direction d writes that direction's slab
// [nb, nvar, A, B, 2] (x: A, B = z, y; y: z, x; z: y, x), entry 0 at g and
// 1 at n - g; the tile whose cells start at the face writes it from the
// fluxes it stages in shared memory, so each face is written once.
// Here no transpose and no halo slab is needed: the kernel reads along y
// or z with a stride, the direction only selects which momentum and field
// components are normal (template parameter DIR), and the caller launches
// it once per active direction, so a 2-D mesh takes two launches and a
// 1-D mesh one.
// The plain PyTorch twin is negdiv_plain in solver/sweep.py; the device
// functions (hydro_device.cuh) follow recon/schemes.py and
// riemann/solvers.py operation by operation (build with --fmad=false to
// keep it that way).
//
// What bounds it: per cell and direction, PPM costs ~100 floating-point
// operations per variable and HLLD a few hundred per face, against NV
// values read and NV written (2 NV more read-modify-written for the
// accumulating y/z launches).  That is ~50-100 operations per byte, above
// the card's FP32 and FP64 ridge points, so the arithmetic pipes, not HBM,
// bound the kernel; reconstructing in shared memory keeps the stencil
// re-reads off device memory (each tile reads its T+2h cells once).
//
// Design (simple first): a block covers TS cells along the sweep axis times
// TL lanes (x for the y/z sweeps, so loads coalesce; y for the x sweep,
// where the sweep axis itself is contiguous).  It loads TS+2h cells of all
// NV variables into shared memory (h = 1, 2, 3 for DC, PLM, PPM), computes
// the edge states of the TS+2 cells that touch the tile's faces, then the
// TS+1 face fluxes (one thread per face), and writes -(F[i+1]-F[i])/dx,
// or adds it to the output for the second and third direction.  The sweep
// axis wraps modulo the block's own extent, which is exactly jnp.roll /
// torch.roll within each block: the periodic boundary on the ghost-free
// layout, and garbage confined to the ghost rim on ghosted layouts.
//
// Plain C interface (loaded with ctypes): negdiv_sweep(...) returns the
// cudaError_t of the launch (0 on success); it never synchronises.

#include <cuda_runtime.h>

#include "hydro_device.cuh"

namespace {

using namespace hydro;

constexpr int TS = 15;           // cells per tile along the sweep axis
constexpr int TL = 16;           // lanes per tile
constexpr int NTHREADS = 256;    // == (TS + 1) * TL: one thread per face
static_assert((TS + 1) * TL == NTHREADS, "one thread per face");

struct Geom {
  int n_sweep;          // extent of the sweep axis within a block
  int n_lane;           // extent of the lane axis
  long long s_sweep;    // element strides
  long long s_lane;
  long long s_other;    // third axis (extent = gridDim.y)
  long long s_var;
  long long s_block;
};

// ----------------------------------------------------------------- kernel
template <int NV, int RECON>
constexpr int smem_elems() {
  constexpr int H = Halo<RECON>::h;
  constexpr int cells = NV * (TS + 2 * H) * TL;
  constexpr int edges = 2 * NV * (TS + 2) * TL;
  constexpr int flux = NV * (TS + 1) * TL;
  // DC keeps its fluxes after the cells; PLM/PPM reuse the cell buffer
  return RECON == RECON_DC ? cells + flux : cells + edges;
}

template <typename T, int RECON, int DIR, int SOLVER>
__global__ void __launch_bounds__(NTHREADS)
negdiv_sweep_kernel(const T* __restrict__ prim, T* __restrict__ out,
                    T* __restrict__ faces, const Geom g, const Params<T> p,
                    const T dx, const int accumulate, const int g_face) {
  constexpr int NV = NVar<SOLVER>::value;
  constexpr int H = Halo<RECON>::h;
  constexpr int NC = TS + 2 * H;   // cells loaded per lane
  constexpr int NE = TS + 2;       // cells whose edge states the faces need
  constexpr int NF = TS + 1;       // faces per lane
  constexpr bool SWEEP_CONTIG = DIR == 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cell = reinterpret_cast<T*>(smem_raw);      // [NV][NC][TL]
  T* qm_s = cell + NV * NC * TL;                 // [NV][NE][TL]
  T* qp_s = qm_s + NV * NE * TL;                 // [NV][NE][TL]
  T* flux = RECON == RECON_DC ? qm_s : cell;     // [NV][NF][TL]

  const int n = g.n_sweep;
  const int ntile_s = (n + TS - 1) / TS;
  const int s0 = (blockIdx.x % ntile_s) * TS;
  const int l0 = (blockIdx.x / ntile_s) * TL;
  const int ns = min(TS, n - s0);
  const int nl = min(TL, g.n_lane - l0);
  const long long base = blockIdx.z * g.s_block + blockIdx.y * g.s_other
                         + l0 * g.s_lane;

  // 1. load TS + 2h cells of every variable, wrapping the sweep axis
  for (int i = threadIdx.x; i < NV * NC * TL; i += NTHREADS) {
    int v, s, l;
    if (SWEEP_CONTIG) { s = i % NC; l = (i / NC) % TL; }
    else              { l = i % TL; s = (i / TL) % NC; }
    v = i / (NC * TL);
    if (l < nl) {
      int gs = (s0 + s - H) % n;
      if (gs < 0) gs += n;
      cell[(v * NC + s) * TL + l] =
          prim[base + v * g.s_var + gs * g.s_sweep + l * g.s_lane];
    }
  }
  __syncthreads();

  // 2. edge states of cells s0-1 .. s0+TS (tile cells H-1 .. H+TS)
  if (RECON != RECON_DC) {
    for (int i = threadIdx.x; i < NV * NE * TL; i += NTHREADS) {
      const int l = i % TL, c = (i / TL) % NE, v = i / (NE * TL);
      if (l < nl) {
        T qm, qp;
        cell_edges<T, RECON>(cell + (v * NC + c + H - 1) * TL + l, TL, qm, qp);
        qm_s[(v * NE + c) * TL + l] = qm;
        qp_s[(v * NE + c) * TL + l] = qp;
      }
    }
    __syncthreads();
  }

  // 3. face fluxes: face j sits between tile cells s0+j-1 and s0+j
  for (int i = threadIdx.x; i < NF * TL; i += NTHREADS) {
    const int l = i % TL, j = i / TL;
    if (l < nl && j <= ns) {
      T wl[NV], wr[NV], F[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (RECON == RECON_DC) {
          wl[v] = cell[(v * NC + j) * TL + l];
          wr[v] = cell[(v * NC + j + 1) * TL + l];
        } else {
          wl[v] = qp_s[(v * NE + j) * TL + l];
          wr[v] = qm_s[(v * NE + j + 1) * TL + l];
        }
      }
      riemann_flux<T, SOLVER, DIR>(wl, wr, p, F);
#pragma unroll
      for (int v = 0; v < NV; ++v) flux[(v * NF + j) * TL + l] = F[v];
    }
  }
  __syncthreads();

  // 3b. face capture, kept out of the Riemann loop above so that the loop
  // is the uniform path's: the faces at sweep index g and n - g, each by the
  // tile whose cells start there (j < ns), so each is written once
  if (faces != nullptr) {
    const long long n_other = gridDim.y;
    for (int k = 0; k < 2; ++k) {
      const int j = (k == 0 ? g_face : n - g_face) - s0;
      if (j < 0 || j >= ns) continue;
      for (int i = threadIdx.x; i < NV * TL; i += NTHREADS) {
        const int l = i % TL, v = i / TL;
        if (l < nl)
          faces[((((long long)blockIdx.z * NV + v) * n_other + blockIdx.y)
                 * g.n_lane + l0 + l) * 2 + k] = flux[(v * NF + j) * TL + l];
      }
    }
  }

  // 4. -(F[i+1] - F[i]) / dx, written or accumulated
  for (int i = threadIdx.x; i < NV * TS * TL; i += NTHREADS) {
    int v, s, l;
    if (SWEEP_CONTIG) { s = i % TS; l = (i / TS) % TL; }
    else              { l = i % TL; s = (i / TL) % TS; }
    v = i / (TS * TL);
    if (l < nl && s < ns) {
      const T r = -(flux[(v * NF + s + 1) * TL + l] - flux[(v * NF + s) * TL + l]) / dx;
      const long long o = base + v * g.s_var + (s0 + s) * g.s_sweep + l * g.s_lane;
      out[o] = accumulate ? out[o] + r : r;
    }
  }
}

struct Args {
  const void* prim;
  void* out;
  void* faces;      // null: no face capture
  int g_face;
  int nb, nz, ny, nx;
  double dx, c_h;
  EosArgs eos;
  int accumulate;
  cudaStream_t stream;
};

template <typename T, int RECON, int DIR, int SOLVER>
cudaError_t launch(const Args& a) {
  constexpr int NV = NVar<SOLVER>::value;
  Geom g;
  g.s_var = (long long)a.nz * a.ny * a.nx;
  g.s_block = NV * g.s_var;
  int n_other;
  if (DIR == 1) {         // sweep x, lanes y, other z
    g.n_sweep = a.nx; g.s_sweep = 1;
    g.n_lane = a.ny;  g.s_lane = a.nx;
    n_other = a.nz;   g.s_other = (long long)a.ny * a.nx;
  } else if (DIR == 2) {  // sweep y, lanes x, other z
    g.n_sweep = a.ny; g.s_sweep = a.nx;
    g.n_lane = a.nx;  g.s_lane = 1;
    n_other = a.nz;   g.s_other = (long long)a.ny * a.nx;
  } else {                // sweep z, lanes x, other y
    g.n_sweep = a.nz; g.s_sweep = (long long)a.ny * a.nx;
    g.n_lane = a.nx;  g.s_lane = 1;
    n_other = a.ny;   g.s_other = a.nx;
  }
  const int ntile_s = (g.n_sweep + TS - 1) / TS;
  const int ntile_l = (g.n_lane + TL - 1) / TL;
  const size_t smem = sizeof(T) * smem_elems<NV, RECON>();
  static_assert(sizeof(T) * smem_elems<NV, RECON>() <= 232448,
                "tile exceeds a block's shared memory");
  auto kernel = negdiv_sweep_kernel<T, RECON, DIR, SOLVER>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // scalar constants are folded in double, then rounded to T, exactly as
  // the plain path's Python-float scalars are
  const Params<T> p = make_params<T>(a.eos, a.c_h);
  dim3 grid(ntile_s * ntile_l, n_other, a.nb);
  kernel<<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.prim), static_cast<T*>(a.out),
      static_cast<T*>(a.faces), g, p, T(a.dx), a.accumulate, a.g_face);
  return cudaGetLastError();
}

template <typename T, int RECON, int DIR>
cudaError_t launch_solver(int solver, const Args& a) {
  switch (solver) {
    case SOLVER_EULER_HLLE:  return launch<T, RECON, DIR, SOLVER_EULER_HLLE>(a);
    case SOLVER_EULER_HLLC:  return launch<T, RECON, DIR, SOLVER_EULER_HLLC>(a);
    case SOLVER_GLMMHD_HLLD: return launch<T, RECON, DIR, SOLVER_GLMMHD_HLLD>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int RECON>
cudaError_t launch_dir(int dir, int solver, const Args& a) {
  switch (dir) {
    case 1: return launch_solver<T, RECON, 1>(solver, a);
    case 2: return launch_solver<T, RECON, 2>(solver, a);
    case 3: return launch_solver<T, RECON, 3>(solver, a);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_recon(int recon, int dir, int solver, const Args& a) {
  switch (recon) {
    case RECON_DC:  return launch_dir<T, RECON_DC>(dir, solver, a);
    case RECON_PLM: return launch_dir<T, RECON_PLM>(dir, solver, a);
    case RECON_PPM: return launch_dir<T, RECON_PPM>(dir, solver, a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  solver: 0 = Euler HLLE, 1 = Euler HLLC,
// 2 = GLM-MHD HLLD.  recon: 0 = dc, 1 = plm, 2 = ppm.  dir: 1, 2, 3.  prim
// and out: contiguous [nb, nvar, nz, ny, nx] on the current device, nvar = 5
// (Euler) or 9 (GLM-MHD).  accumulate != 0 adds into out instead of writing
// it.  faces (may be null): contiguous [nb, nvar, A, B, 2] of direction
// dir (see the top of this file), g_face the ghost width along dir, with
// 0 < g_face < extent / 2.
extern "C" int negdiv_sweep(const void* prim, void* out, int dtype, int solver,
                            int recon, int dir, int nb, int nvar, int nz,
                            int ny, int nx, double dx, double gamma,
                            double c_h, int accumulate, void* faces,
                            int g_face, void* stream) {
  const int want = solver == SOLVER_GLMMHD_HLLD ? 9 : 5;
  const int n_dir = dir == 1 ? nx : (dir == 2 ? ny : nz);
  if (nvar != want || nb <= 0 || nz <= 0 || ny <= 0 || nx <= 0
      || (faces != nullptr && (g_face <= 0 || 2 * g_face >= n_dir)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.prim = prim; a.out = out; a.faces = faces; a.g_face = g_face;
  a.nb = nb; a.nz = nz; a.ny = ny; a.nx = nx;
  a.dx = dx; a.c_h = c_h;
  a.eos = EosArgs{gamma, -1.0, -1.0, -1.0, NO_CEILING, NO_CEILING};   // no floors here
  a.accumulate = accumulate;
  a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_recon<float>(recon, dir, solver, a);
  if (dtype == 1) return (int)launch_recon<double>(recon, dir, solver, a);
  return (int)cudaErrorInvalidValue;
}
