// Whole-stage kernel on Hopper: cons_to_prim + the three -div(F) sweeps +
// the 2S stage update in one launch, for Euler (LLF, HLLE, HLLC) and
// GLM-MHD (LLF, HLLE, HLLD), with DC, PLM, PPM, WENO3, LimO3 or WENO-Z, on
// 3-D blocks:
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
// operation (built without contracted multiply-adds, so it keeps to the plain
// version's rounding).
//
// What bounds it: the stage reads u0 and u1 and writes u_new once (3 NV
// values per cell) and does the arithmetic of three sweeps (PPM + HLLD:
// ~2,500 floating-point operations per cell), ~70 operations per byte in
// f32, so the arithmetic pipes bound it, as they bound the sweep kernel.
// What the fusion saves is the device-memory traffic of the separate
// cons_to_prim, axpy and dt passes, not arithmetic; what keeps the pipes
// fed is latency hiding, and doing no work twice.
//
// Design: a block of 128 threads owns a column of TY x TX = 7 x 14 cells
// and marches along z over one segment of the block's z extent, one plane
// per step, thread t < 98 taking cell t of a plane.  The shape makes every
// edge-state and face phase of a plane one round of at most 128 items
// (8 x 16 cells left each phase a second round for one warp, 1.5x the
// latency per plane).
//  - A ring of NR planes of prim in shared memory (the 2h - 1 planes the
//    z stencil of one face needs, plus one in flight) holds each plane's
//    TY x TX cells; the next plane and the next plane's x and y halo (h
//    cells on each side: a plus shape in 2-D, no corners) arrive by
//    cp.async one step ahead, so loads overlap arithmetic.  Every loaded
//    cell is converted to prim once, on arrival; only the halo, 2h (TY +
//    TX) cells per plane, is loaded by the neighbouring columns too
//    (PPM: 2.3x the owned cells, against 3.6x for the earlier tile).
//  - Step zc: the x and then the y sweep of plane zc (edge states of the
//    row's cells and of the one beyond each end, staged in shared memory;
//    then each face once; then each cell's difference), and the z face
//    between zc and zc + 1 (edge states of plane zc + 1 from the ring; the
//    left state and the flux of the face below carried from the step
//    before, per cell in shared memory); then the update of plane zc.  So
//    each edge state is built once and each face solved once, except the
//    x and y faces at the column's sides, which the neighbouring column
//    solves too.
//  - -div(F) accumulates per cell in registers in the plain version's
//    order (x, then + y, then + z).  The update re-reads u0 for u0f (from
//    L2: the plane was read h steps before) rather than keep u0f in shared
//    memory or registers, which go to occupancy instead (loading u0 and u1
//    before the z face to hide their latency took 29 more registers and
//    cost the f32 DC stage a quarter of its resident warps).
//  - z is cut into segments while a launch has fewer than ~2048 blocks,
//    so that the small blocks of a refined level still fill the card.
//  - Every index wraps within the block's extent (torch.roll within a
//    block: the periodic boundary on the ghost-free layout, garbage
//    confined to the ghost rim on ghosted layouts), by compares, not
//    divisions.  Cells of a tile beyond the block's extent are computed
//    from wrapped data and not written.
//  - Faces: each face is written once, by the column (x, y) or segment
//    (z) that owns its right cell; a compile-time switch, so the uniform
//    instantiations carry no capture code.
//
// Passive scalars (nvar = 5 or 9 + nscalars), as in negdiv_sweep.cu: this
// kernel keeps the fluid's compile-time variable count; its instantiation
// for decks with scalars (SCAL) reads and writes the fluid rows of the
// [nb, nvar, ...] states (runtime block stride) and writes each face's
// mass flux per direction into three [nb, nz, ny, nx] arrays (entry c: the
// face before cell c), by the column or segment that owns the face's
// right cell, while the SCAL = false instantiations are the code without
// scalars, unchanged; the scalar kernel launched
// right after it on the same stream (stage_scalars) then does the scalar
// rows of the same stage: prim = u0 / rho with rho the floored density
// (eos/adiabatic.py), each direction's reconstruction and upwind flux
// fd >= 0 ? fd * wl : fd * wr, -div(F) summed x, + y, + z, and the update
// gam0 u0 + gam1 u1 + beta_dt (-div F); the scalar rows of prim_out and of
// the face slabs too.  One thread per cell.
//
// Plain C interface (loaded with ctypes): fused_stage(...) and
// stage_scalars(...) return the cudaError_t of the launch (0 on success);
// they never synchronise.
//
// Translation units, as negdiv_sweep.cu's: the 6 reconstructions x 6
// (fluid, solver) pairs x 2 face options x 2 dtypes x 2 (without and with
// scalars) make 288 instantiations (and the scalar kernel's 6 x 2 = 12);
// the source is compiled once per (reconstruction, dtype, scalars) with
// -DHYDRO_UNIT_RECON=r -DHYDRO_UNIT_DTYPE=t -DHYDRO_UNIT_SCAL=s, each unit
// defining launch_recon<T, r, s>, and once per s for the C entry points
// (-DHYDRO_ENTRY_SCAL=s); the units of one s link into one library.

#include <cuda_runtime.h>

#include <limits>

#include "hydro_device.cuh"

namespace stage {

struct Args {
  const void* u0;
  const void* u1;
  void* out;
  void* dt_out;     // null: no CFL bound
  void* prim_out;   // null: no prim
  void* faces[3];   // null: no face capture
  void* mflux[3];   // null: no mass-flux output (no scalars)
  int g_face;
  int nb, nvar, nz, ny, nx;
  double dx1, dx2, dx3, gam0, gam1, beta_dt, c_h;
  double recon_dx2[3], recon_rdx2[3];   // per direction: dx^2, (0.1 dx)^2
  hydro::EosArgs eos;
  cudaStream_t stream;
  bool with_faces;  // the instantiation with the face output
  int* query;       // non-null: report, do not launch (fused_stage_occupancy)
};

// The column's shape and shared-memory layout per dtype, variable count
// and reconstruction.
template <typename T, int NV, int RECON>
struct Col {
  static constexpr int TY = 7, TX = 14;
  static constexpr int NC = TY * TX;             // cells of a plane
  static constexpr int NT = 128;                 // threads: one per cell, 30 spare
  static constexpr int H = hydro::Halo<RECON>::h;
  static constexpr int R = H - 1;                // edge-state stencil radius
  // ring planes: zc .. zc + 1 (DC), zc + 1 - R .. zc + H, plus one in flight
  static constexpr int NR = (R >= 1 ? 2 * H - 1 : 2) + 1;
  static constexpr int PY = TY + 2 * H, PX = TX + 2 * H;   // plane + halo
  static constexpr int NHALO = 2 * H * (TY + TX);
  static constexpr int NEX = TY * (TX + 2), NEY = (TY + 2) * TX;
  static constexpr int NE = NEX > NEY ? NEX : NEY;
  static constexpr int NFX = TY * (TX + 1), NFY = (TY + 1) * TX;
  static constexpr int NF = NFX > NFY ? NFX : NFY;
  // offsets (elements of T) of the shared arrays, each [NV][...]
  static constexpr int RING = 0;                         // [NR][NV][NC]
  static constexpr int HALO = RING + NR * NV * NC;       // raw u0, [NV][NHALO]
  static constexpr int CUR = HALO + NV * NHALO;          // prim, [NV][PY][PX]
  static constexpr int QM = CUR + NV * PY * PX;          // [NV][NE]
  static constexpr int QP = QM + (RECON == hydro::RECON_DC ? 0 : NV * NE);
  static constexpr int FL = QP + (RECON == hydro::RECON_DC ? 0 : NV * NE);  // [NV][NF]
  static constexpr int ZQP = FL + NV * NF;               // z carries, [NV][NC]
  static constexpr int ZF = ZQP + NV * NC;
  static constexpr int RED = ZF + NV * NC;               // [NT]
  static constexpr size_t SMEM = sizeof(T) * (RED + NT);
  static_assert(NT % 32 == 0 && NC <= NT, "whole warps, a cell each");
  static_assert(NHALO <= NT, "one halo cell per thread at most");
  // every edge-state and face phase of a plane is one round of the threads
  static_assert(NEX <= NT && NEY <= NT && NFX <= NT && NFY <= NT,
                "one round per phase");
};

struct Shape {
  int nz, ny, nx;          // extent of a block (ghosts included)
  int ntx, nty;            // columns along x and y
  int nseg, seg_len;       // z segments of a column, planes per segment
};

// One column shape serves every instantiation.
using ColShape = Col<float, 5, hydro::RECON_DC>;

// Columns of nb blocks of [nz, ny, nx]; z is cut into segments of at least
// 8 planes while there are fewer than ~2048 blocks (a few waves over the
// card's 132 SMs), so small refined blocks march short columns.
inline Shape shape_of(int nb, int nz, int ny, int nx) {
  Shape sh;
  sh.nz = nz; sh.ny = ny; sh.nx = nx;
  sh.ntx = (nx + ColShape::TX - 1) / ColShape::TX;
  sh.nty = (ny + ColShape::TY - 1) / ColShape::TY;
  const long long columns = (long long)nb * sh.ntx * sh.nty;
  const long long want = 2048;
  long long nseg = (want + columns - 1) / columns;
  if (nseg > nz / 8) nseg = nz / 8;
  if (nseg < 1) nseg = 1;
  sh.seg_len = (int)((nz + nseg - 1) / nseg);
  sh.nseg = (nz + sh.seg_len - 1) / sh.seg_len;
  return sh;
}

// Defined by the unit of (T, RECON): dispatch over the solver.
template <typename T, int RECON, bool SCAL>
cudaError_t launch_recon(int solver, const Args& a);
// ... the scalar kernel of (T, RECON); nbase: the fluid's variable count
template <typename T, int RECON>
cudaError_t launch_scalars_recon(int nbase, const Args& a);

}  // namespace stage

#ifdef HYDRO_UNIT_RECON

namespace {

using namespace hydro;
using namespace stage;

// Resident blocks per SM that __launch_bounds__ asks for: what the
// registers of the solver allow (65536 / (128 * blocks) each), capped by
// what shared memory allows (228 KB per SM, 1 KB of it per block).
template <typename T, int RECON, int SOLVER>
struct MinBlocks {
  static constexpr bool MHD = is_glmmhd(SOLVER);
  static constexpr int by_regs = sizeof(T) == 4 ? (MHD ? 3 : 4) : 2;
  static constexpr int by_smem =
      233472 / (int)(Col<T, NVar<SOLVER>::value, RECON>::SMEM + 1024);
  static constexpr int value =
      by_smem < 1 ? 1 : (by_regs < by_smem ? by_regs : by_smem);
};

template <typename T>
struct Scalars {
  T gam0, gam1, beta_dt, dx1, dx2, dx3;
  T idx1, idx2, idx3;   // 1 / dx_d in T, as PyTorch divides by dx_d
  T inf;                // +infinity: the CFL reduction's identity
  ReconK<T> rk[3];      // the reconstruction's constants per direction
};

// Face output: per direction [nb, nvar, A, B, 2] (x: A, B = z, y; y: z,
// x; z: y, x), entry 0 at sweep index g, 1 at n - g; null pointers: none.
template <typename T>
struct Faces {
  T* d[3];
  int g;
};

// What a deck with scalars adds: the variables of the state (fluid +
// scalars) and the mass flux per direction, [nb, nz, ny, nx] (entry c: the
// face before cell c).  The last argument of the kernels, so that the
// instantiations without scalars see the arguments they always had.
template <typename T>
struct ScalarArgs {
  T* mf[3];
  int nvar;
};

// Plane coordinates (y, x) of halo cell i: the x halo (TY rows of h cells
// on each side), then the y halo (h rows of TX cells above and below).
template <typename CL>
__device__ __forceinline__ void halo_coords(int i, int& y, int& x) {
  constexpr int H = CL::H, TY = CL::TY, TX = CL::TX;
  if (i < TY * 2 * H) {
    const int k = i % (2 * H);
    y = i / (2 * H);
    x = k < H ? k - H : TX + k - H;
  } else {
    const int j = i - TY * 2 * H, k = j / TX;
    x = j % TX;
    y = k < H ? k - H : TY + k - H;
  }
}

// One in-plane sweep (D = 1: x, 2: y) of the current plane `cur`:
// edge states of the TY x (TX + 2) (or (TY + 2) x TX) cells that touch the
// tile's faces, then the faces, then -div(F) of this thread's cell written
// (x) or added (y) to nd.  With FACES the faces at sweep index g and n - g
// are written by the tile that owns their right cell.
template <typename T, typename CL, int NV, int RECON, int SOLVER, int D,
          bool FACES, bool SCAL>
__device__ __forceinline__ void plane_sweep(T* sm, T (&nd)[NV],
                                            const Params<T>& p,
                                            const ReconK<T>& rk, T idx,
                                            T* faces, T* mf, int nvar, int g,
                                            const Shape& sh,
                                            int b, int zc, int y0, int x0,
                                            int vy, int vx) {
  constexpr int TX = CL::TX, H = CL::H, PX = CL::PX, PY = CL::PY;
  constexpr int NT = CL::NT;
  constexpr int EW = D == 1 ? TX + 2 : TX;     // edge rows' width
  constexpr int NE = D == 1 ? CL::NEX : CL::NEY;
  constexpr int FW = D == 1 ? TX + 1 : TX;     // face rows' width
  constexpr int NF = D == 1 ? CL::NFX : CL::NFY;
  constexpr int ST = D == 1 ? 1 : PX;          // stencil stride in cur
  const T* cur = sm + CL::CUR;
  T* qm_s = sm + CL::QM;
  T* qp_s = sm + CL::QP;
  T* fl_s = sm + CL::FL;
  const int t = threadIdx.x;

  // position in cur of the cell at tile coordinates (y, x)
  auto pos = [&](int y, int x) { return (y + H) * PX + x + H; };

  if constexpr (RECON != RECON_DC) {
    // edge item i: cell (y, x) with x (D = 1) or y (D = 2) from -1 to TX
    // (TY) inclusive
    for (int i = t; i < NE; i += NT) {
      const int y = D == 1 ? i / EW : i / EW - 1;
      const int x = D == 1 ? i % EW - 1 : i % EW;
      const T* c = cur + pos(y, x);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const T* q = c + v * PY * PX;
        T st[2 * CL::R + 1], qm, qp;
#pragma unroll
        for (int o = 0; o <= 2 * CL::R; ++o) st[o] = q[(o - CL::R) * ST];
        cell_edges<T, RECON>(st, positive_var(v), rk, qm, qp);
        qm_s[v * CL::NE + i] = qm;
        qp_s[v * CL::NE + i] = qp;
      }
    }
    __syncthreads();
  }

  // face item i: the face before cell f of its row (D = 1: y = i / FW,
  // f = x; D = 2: f = y, x = i % FW)
  for (int i = t; i < NF; i += NT) {
    const int y = i / FW, x = i % FW;   // D = 2: y is the face's cell row
    T wl[NV], wr[NV], F[NV];
    if constexpr (RECON == RECON_DC) {
      const T* c = cur + pos(y, x);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        wl[v] = c[v * PY * PX - ST];
        wr[v] = c[v * PY * PX];
      }
    } else {
      // edge items of the cell before the face and of the cell after it
      const int e_l = y * EW + x;
      const int e_r = D == 1 ? e_l + 1 : e_l + EW;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        wl[v] = qp_s[v * CL::NE + e_l];
        wr[v] = qm_s[v * CL::NE + e_r];
      }
    }
    riemann_flux<T, SOLVER, D>(wl, wr, p, F);
#pragma unroll
    for (int v = 0; v < NV; ++v) fl_s[v * CL::NF + i] = F[v];
    if constexpr (SCAL) {
      if (x < vx && y < vy)
        mf[(((long long)b * sh.nz + zc) * sh.ny + y0 + y) * sh.nx + x0 + x] =
            F[IDN];
    }
    if constexpr (FACES) {
      const int G = D == 1 ? x0 + x : y0 + y;   // the face's right cell
      const int n_d = D == 1 ? sh.nx : sh.ny;
      if (x < vx && y < vy && (G == g || G == n_d - g)) {
        const long long A = sh.nz;
        const long long B = D == 1 ? sh.ny : sh.nx;
        const long long bb = D == 1 ? y0 + y : x0 + x;
        const long long o = (((long long)b * (SCAL ? nvar : NV) * A + zc)
                             * B + bb) * 2
                            + (G == g ? 0 : 1);
#pragma unroll
        for (int v = 0; v < NV; ++v) faces[o + 2 * v * A * B] = F[v];
      }
    }
  }
  __syncthreads();

  // -(F[i+1] - F[i]) / dx of this thread's cell
  if (t < CL::NC) {
    const int y = t / TX, x = t % TX;
    const int f0 = y * FW + x;
    const int f1 = D == 1 ? f0 + 1 : f0 + FW;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const T r = -((fl_s[v * CL::NF + f1] - fl_s[v * CL::NF + f0]) * idx);
      nd[v] = D == 1 ? r : nd[v] + r;
    }
  }
  if constexpr (RECON == RECON_DC && D == 1) {
    // the y faces come next and overwrite fl_s (with PLM and PPM the y
    // edge phase and its barrier come first)
    __syncthreads();
  }
}

template <typename T, int RECON, int SOLVER, bool FACES, bool SCAL>
__global__ void __launch_bounds__(
    (Col<T, NVar<SOLVER>::value, RECON>::NT),
    (MinBlocks<T, RECON, SOLVER>::value))
fused_stage_kernel(const T* __restrict__ u0, const T* __restrict__ u1,
                   T* __restrict__ out, T* __restrict__ dt_out,
                   T* __restrict__ prim_out, const Faces<T> fc,
                   const Shape sh, const Params<T> p, const Scalars<T> sc,
                   const ScalarArgs<T> xs) {
  constexpr int NV = NVar<SOLVER>::value;
  using CL = Col<T, NV, RECON>;
  constexpr int TY = CL::TY, TX = CL::TX, NC = CL::NC, NT = CL::NT;
  constexpr int H = CL::H, R = CL::R, NR = CL::NR, PX = CL::PX, PY = CL::PY;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* ring = sm + CL::RING;
  T* halo = sm + CL::HALO;
  T* cur = sm + CL::CUR;
  T* zqp = sm + CL::ZQP;
  T* zf = sm + CL::ZF;

  const int tile = blockIdx.x;
  const int col = tile / sh.nseg, seg = tile % sh.nseg;
  const int x0 = (col % sh.ntx) * TX, y0 = (col / sh.ntx) * TY;
  const int zs = seg * sh.seg_len, ze = min(zs + sh.seg_len, sh.nz);
  // cells of the tile that lie inside the block
  const int vx = min(TX, sh.nx - x0), vy = min(TY, sh.ny - y0);
  const long long s_var = (long long)sh.nz * sh.ny * sh.nx;
  const int b = blockIdx.y;
  const long long base = (long long)b * (SCAL ? xs.nvar : NV) * s_var;
  const int t = threadIdx.x;
  const bool has_cell = t < NC;
  const int ty = t / TX, tx = t % TX;
  const bool own_xy = has_cell && ty < vy && tx < vx;
  // this thread's cell and halo cell (t < NHALO) within a plane (wrapped)
  const long long xy_off =
      (long long)wrap_index(y0 + ty, sh.ny) * sh.nx + wrap_index(x0 + tx, sh.nx);
  const bool has_halo = t < CL::NHALO;
  int hy = 0, hx = 0;
  if (has_halo) halo_coords<CL>(t, hy, hx);
  const long long h_off = (long long)wrap_index(y0 + hy, sh.ny) * sh.nx
                          + wrap_index(x0 + hx, sh.nx);
  const int h_pos = (hy + H) * PX + hx + H;
  // ring slot of plane P (P >= zs - H)
  auto slot = [&](int P) { return (P - zs + H) % NR; };

  auto load_plane = [&](int P) {
    if (!has_cell) return;
    const long long o = base + (long long)wrap_index(P, sh.nz) * sh.ny * sh.nx
                        + xy_off;
    T* dst = ring + slot(P) * NV * NC + t;
#pragma unroll
    for (int v = 0; v < NV; ++v) cp_async(dst + v * NC, u0 + o + v * s_var);
  };
  auto load_halo = [&](int P) {
    if (!has_halo) return;
    const long long o = base + (long long)wrap_index(P, sh.nz) * sh.ny * sh.nx
                        + h_off;
#pragma unroll
    for (int v = 0; v < NV; ++v)
      cp_async(halo + v * CL::NHALO + t, u0 + o + v * s_var);
  };

  // the first step (zc = zs - 2) needs planes zs - H .. zs + H - 2
  for (int P = zs - H; P <= zs + H - 2; ++P) load_plane(P);
  cp_async_commit();
  int converted = zs - H;   // the first plane not yet converted to prim
  T dt_min = sc.inf;

  for (int zc = zs - 2; zc < ze; ++zc) {
    cp_async_wait_all();
    __syncthreads();   // planes up to zc + H and plane zc's halo have landed

    // 1. convert what has landed to prim, in place; set up plane zc
    for (; converted <= zc + H; ++converted) {
      if (!has_cell) continue;
      T* c = ring + slot(converted) * NV * NC + t;
      T u[NV], w[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) u[v] = c[v * NC];
      cons_to_prim<T, NV>(u, p, u, w);
#pragma unroll
      for (int v = 0; v < NV; ++v) c[v * NC] = w[v];
      if (prim_out != nullptr && own_xy && converted >= zs && converted < ze) {
        const long long o = base + (long long)converted * sh.ny * sh.nx
                            + (long long)(y0 + ty) * sh.nx + x0 + tx;
#pragma unroll
        for (int v = 0; v < NV; ++v) prim_out[o + v * s_var] = w[v];
      }
    }
    if (zc >= zs) {
      const T* c = ring + slot(zc) * NV * NC + t;
      const int pc = (ty + H) * PX + tx + H;
      if (has_cell) {
#pragma unroll
        for (int v = 0; v < NV; ++v) cur[v * PY * PX + pc] = c[v * NC];
      }
      if (has_halo) {
        T u[NV], w[NV];
#pragma unroll
        for (int v = 0; v < NV; ++v) u[v] = halo[v * CL::NHALO + t];
        cons_to_prim<T, NV>(u, p, u, w);
#pragma unroll
        for (int v = 0; v < NV; ++v) cur[v * PY * PX + h_pos] = w[v];
      }
    }
    __syncthreads();

    // 2. the next plane and the next plane's halo, in flight during 3-5
    if (zc + 1 < ze) {
      load_plane(zc + 1 + H);
      if (zc + 1 >= zs) load_halo(zc + 1);
    }
    cp_async_commit();

    // 3. the x and y sweeps of plane zc; -div(F) of this thread's cell
    // accumulates in nd in the plain version's order (x, + y, + z)
    T nd[NV];
    if (zc >= zs) {
      plane_sweep<T, CL, NV, RECON, SOLVER, 1, FACES, SCAL>(
          sm, nd, p, sc.rk[0], sc.idx1, fc.d[0], xs.mf[0], xs.nvar, fc.g, sh,
          b, zc,
          y0, x0, vy, vx);
      plane_sweep<T, CL, NV, RECON, SOLVER, 2, FACES, SCAL>(
          sm, nd, p, sc.rk[1], sc.idx2, fc.d[1], xs.mf[1], xs.nvar, fc.g, sh,
          b, zc,
          y0, x0, vy, vx);
    }

    // 4. the z face between zc and zc + 1: edge states of plane zc + 1;
    // the left state (the right edge state of plane zc) comes from the
    // carry, which takes plane zc + 1's
    if (!has_cell) continue;
    T wl[NV], qm[NV];
    {
      int s[2 * R + 1];
#pragma unroll
      for (int o = -R; o <= R; ++o) s[o + R] = slot(zc + 1 + o) * NV * NC + t;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const T* r = ring + v * NC;
        T st[2 * R + 1], qp;
#pragma unroll
        for (int o = 0; o <= 2 * R; ++o) st[o] = r[s[o]];
        cell_edges<T, RECON>(st, positive_var(v), sc.rk[2], qm[v], qp);
        wl[v] = zqp[v * NC + t];
        zqp[v * NC + t] = qp;
      }
    }
    if (zc + 1 >= zs) {
      T F[NV];
      riemann_flux<T, SOLVER, 3>(wl, qm, p, F);
      if constexpr (SCAL) {
        if (own_xy && zc + 1 < ze)
          xs.mf[2][(((long long)b * sh.nz + zc + 1) * sh.ny + y0 + ty) * sh.nx
                   + x0 + tx] = F[IDN];
      }
      if constexpr (FACES) {
        const int G = zc + 1;
        if (own_xy && G < ze && (G == fc.g || G == sh.nz - fc.g)) {
          const long long o = (((long long)b * (SCAL ? xs.nvar : NV) * sh.ny
                                + y0 + ty) * sh.nx
                               + x0 + tx) * 2 + (G == fc.g ? 0 : 1);
#pragma unroll
          for (int v = 0; v < NV; ++v)
            fc.d[2][o + 2LL * v * sh.ny * sh.nx] = F[v];
        }
      }
      // 5. the update of plane zc, and the CFL bound of its new state
      if (zc >= zs && own_xy) {
        const long long o = base + (long long)zc * sh.ny * sh.nx
                            + (long long)(y0 + ty) * sh.nx + x0 + tx;
        T u[NV], w[NV];
#pragma unroll
        for (int v = 0; v < NV; ++v) u[v] = u0[o + v * s_var];
        cons_to_prim<T, NV>(u, p, u, w);   // u is now u0f
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const T r = -((F[v] - zf[v * NC + t]) * sc.idx3);
          u[v] = sc.gam0 * u[v] + sc.gam1 * u1[o + v * s_var]
                 + sc.beta_dt * (nd[v] + r);
          out[o + v * s_var] = u[v];
        }
        if (dt_out != nullptr) {
          cons_to_prim<T, NV>(u, p, u, w);
          dt_min = nan_min(dt_min, cell_cfl_dt<T, NV>(w, p, sc.dx1, sc.dx2,
                                                       sc.dx3));
        }
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) zf[v * NC + t] = F[v];
    }
  }

  if (dt_out != nullptr) {
    T* red = sm + CL::RED;
    red[t] = dt_min;
    __syncthreads();
    if (t == 0) {
      for (int k = 1; k < NT; ++k) dt_min = nan_min(dt_min, red[k]);
      dt_out[(long long)b * gridDim.x + tile] = dt_min;
    }
  }
}

template <typename T, int RECON, int SOLVER, bool SCAL>
cudaError_t launch(const Args& a) {
  using CL = Col<T, NVar<SOLVER>::value, RECON>;
  static_assert(CL::TX == ColShape::TX && CL::TY == ColShape::TY,
                "one column shape");
  static_assert(CL::SMEM <= 232448, "column exceeds a block's shared memory");
  auto kernel = a.with_faces ? fused_stage_kernel<T, RECON, SOLVER, true, SCAL>
                             : fused_stage_kernel<T, RECON, SOLVER, false, SCAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CL::SMEM);
  if (err != cudaSuccess) return err;
  if (a.query != nullptr) {
    a.query[0] = (int)CL::SMEM;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a.query[1], kernel,
                                                         CL::NT, CL::SMEM);
  }
  const Shape sh = shape_of(a.nb, a.nz, a.ny, a.nx);
  // scalars arrive as doubles and are rounded to T once, as the plain
  // path's Python floats are; 1/dx is computed in T, as PyTorch on the
  // card divides by a Python scalar
  const Params<T> p = make_params<T>(a.eos, a.c_h);
  Scalars<T> sc;
  sc.gam0 = T(a.gam0); sc.gam1 = T(a.gam1); sc.beta_dt = T(a.beta_dt);
  sc.dx1 = T(a.dx1); sc.dx2 = T(a.dx2); sc.dx3 = T(a.dx3);
  sc.idx1 = T(1) / sc.dx1; sc.idx2 = T(1) / sc.dx2; sc.idx3 = T(1) / sc.dx3;
  sc.inf = std::numeric_limits<T>::infinity();
  for (int d = 0; d < 3; ++d)
    sc.rk[d] = make_recon_k<T>(a.recon_dx2[d], a.recon_rdx2[d]);
  Faces<T> fc;
  ScalarArgs<T> xs;
  for (int d = 0; d < 3; ++d) {
    fc.d[d] = static_cast<T*>(a.faces[d]);
    xs.mf[d] = static_cast<T*>(a.mflux[d]);
  }
  fc.g = a.g_face;
  xs.nvar = a.nvar;
  dim3 grid(sh.ntx * sh.nty * sh.nseg, a.nb);
  kernel<<<grid, CL::NT, CL::SMEM, a.stream>>>(
      static_cast<const T*>(a.u0), static_cast<const T*>(a.u1),
      static_cast<T*>(a.out), static_cast<T*>(a.dt_out),
      static_cast<T*>(a.prim_out), fc, sh, p, sc, xs);
  return cudaGetLastError();
}

// ------------------------------------------------------------ the scalars
// 128 threads a block, and one resident block asked for: ptxas then keeps
// every instantiation in registers (without the minimum it traded a few
// spills for occupancy on f32 PLM and WENO-Z and f64 WENO3)
constexpr int SCALAR_THREADS = 128;

// The scalar rows nbase .. nvar - 1 of the stage, after the fluid launch
// that wrote the mass fluxes: thread t takes cell t of the state (x
// fastest).  Per scalar and direction: the primitive scalar u0[v] * (1 /
// rho) (rho floored as cons_to_prim floors it) at the cell and its
// neighbours along the direction (wrapped within the block), the edge
// states of the cell and its two neighbours, the fluxes of its two faces
// and -(F[c+1] - F[c]) / dx, summed x, + y, + z; then the update.  The
// cells at sweep index g and n - g write their left face into the slab.
template <typename T, int RECON>
__global__ void __launch_bounds__(SCALAR_THREADS, 1)
stage_scalars_kernel(const T* __restrict__ u0, const T* __restrict__ u1,
                     T* __restrict__ out, T* __restrict__ prim_out,
                     const Faces<T> fc, const Shape sh, const int nb,
                     const int nbase, const Params<T> p, const Scalars<T> sc,
                     const ScalarArgs<T> xs) {
  constexpr int R = Halo<RECON>::h - 1;
  const long long s_var = (long long)sh.nz * sh.ny * sh.nx;
  const long long cell = (long long)blockIdx.x * SCALAR_THREADS + threadIdx.x;
  if (cell >= (long long)nb * s_var) return;
  const int b = (int)(cell / s_var);
  const long long in_b = cell - (long long)b * s_var;
  const int x = (int)(in_b % sh.nx);
  const long long zy = in_b / sh.nx;
  const int y = (int)(zy % sh.ny), z = (int)(zy / sh.ny);
  const int cell_b = (int)in_b;   // a block has < 2^31 cells
  const T* rho = u0 + (long long)b * xs.nvar * s_var;
  const bool has_dfloor = p.has_dfloor;
  const T dfloor = p.dfloor;
  for (int v = nbase; v < xs.nvar; ++v) {
    const long long row = ((long long)b * xs.nvar + v) * s_var;
    T nd = T(0);
    // one direction at a time, not unrolled: the three directions'
    // stencils together would not fit in registers
#pragma unroll 1
    for (int d = 0; d < 3; ++d) {
      const int c = d == 0 ? x : (d == 1 ? y : z);
      const int n = d == 0 ? sh.nx : (d == 1 ? sh.ny : sh.nz);
      const int stride = d == 0 ? 1 : (d == 1 ? sh.nx : sh.ny * sh.nx);
      // the direction's constants picked field by field (a struct picked
      // by a runtime index would go through local memory)
      ReconK<T> rk;
      rk.dx2 = d == 0 ? sc.rk[0].dx2 : (d == 1 ? sc.rk[1].dx2 : sc.rk[2].dx2);
      rk.inv_rdx2 = d == 0 ? sc.rk[0].inv_rdx2
                           : (d == 1 ? sc.rk[1].inv_rdx2 : sc.rk[2].inv_rdx2);
      const int off = cell_b - c * stride;
      T st[2 * R + 3];
      int at[2 * R + 3];
#pragma unroll
      for (int o = 0; o < 2 * R + 3; ++o) {
        at[o] = off + wrap_index(c - 1 - R + o, n) * stride;
        T d_o = rho[at[o]];
        if (has_dfloor) d_o = d_o < dfloor ? dfloor : d_o;
        st[o] = u0[row + at[o]] * (T(1) / d_o);
      }
      T qm_l, qp_l, qm_c, qp_c, qm_r, qp_r;
      cell_edges<T, RECON>(st, false, rk, qm_l, qp_l);
      cell_edges<T, RECON>(st + 1, false, rk, qm_c, qp_c);
      cell_edges<T, RECON>(st + 2, false, rk, qm_r, qp_r);
      T* const fdir = d == 0 ? fc.d[0] : (d == 1 ? fc.d[1] : fc.d[2]);
      const T* mf = (d == 0 ? xs.mf[0] : (d == 1 ? xs.mf[1] : xs.mf[2]))
                    + (long long)b * s_var;
      const T fdl = mf[at[R + 1]], fdr = mf[at[R + 2]];
      const T fl = fdl >= T(0) ? fdl * qp_l : fdl * qm_c;
      const T fr = fdr >= T(0) ? fdr * qp_c : fdr * qm_r;
      const T idx = d == 0 ? sc.idx1 : (d == 1 ? sc.idx2 : sc.idx3);
      const T res = -((fr - fl) * idx);
      nd = d == 0 ? res : nd + res;
      if (fdir != nullptr && (c == fc.g || c == n - fc.g)) {
        // the slab's pencil index (x: z, y; y: z, x; z: y, x)
        const long long q = d == 0 ? zy : (d == 1 ? (long long)z * sh.nx + x
                                                  : (long long)y * sh.nx + x);
        const long long npen = s_var / n;
        fdir[(((long long)b * xs.nvar + v) * npen + q) * 2
                + (c == fc.g ? 0 : 1)] = fl;
      }
    }
    const T u0v = u0[row + in_b];
    out[row + in_b] = sc.gam0 * u0v + sc.gam1 * u1[row + in_b]
                      + sc.beta_dt * nd;
    if (prim_out != nullptr) {
      T d_c = rho[in_b];
      if (has_dfloor) d_c = d_c < dfloor ? dfloor : d_c;
      prim_out[row + in_b] = u0v * (T(1) / d_c);
    }
  }
}

template <typename T, int RECON>
cudaError_t launch_scalars(int nbase, const Args& a) {
  auto kernel = stage_scalars_kernel<T, RECON>;
  if (a.query != nullptr) {
    a.query[0] = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &a.query[1], kernel, SCALAR_THREADS, 0);
  }
  Shape sh{};
  sh.nz = a.nz; sh.ny = a.ny; sh.nx = a.nx;
  const Params<T> p = make_params<T>(a.eos, a.c_h);
  Scalars<T> sc;
  sc.gam0 = T(a.gam0); sc.gam1 = T(a.gam1); sc.beta_dt = T(a.beta_dt);
  sc.dx1 = T(a.dx1); sc.dx2 = T(a.dx2); sc.dx3 = T(a.dx3);
  sc.idx1 = T(1) / sc.dx1; sc.idx2 = T(1) / sc.dx2; sc.idx3 = T(1) / sc.dx3;
  sc.inf = std::numeric_limits<T>::infinity();
  for (int d = 0; d < 3; ++d)
    sc.rk[d] = make_recon_k<T>(a.recon_dx2[d], a.recon_rdx2[d]);
  Faces<T> fc;
  ScalarArgs<T> xs;
  for (int d = 0; d < 3; ++d) {
    fc.d[d] = static_cast<T*>(a.faces[d]);
    xs.mf[d] = static_cast<T*>(a.mflux[d]);
  }
  fc.g = a.g_face;
  xs.nvar = a.nvar;
  const long long cells = (long long)a.nb * a.nz * a.ny * a.nx;
  const unsigned blocks = (unsigned)((cells + SCALAR_THREADS - 1) / SCALAR_THREADS);
  kernel<<<blocks, SCALAR_THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.u0), static_cast<const T*>(a.u1),
      static_cast<T*>(a.out), static_cast<T*>(a.prim_out), fc, sh, a.nb,
      nbase, p, sc, xs);
  return cudaGetLastError();
}

template <typename T, int RECON, bool S>
cudaError_t launch_solver(int solver, const Args& a) {
  switch (solver) {
    case SOLVER_EULER_HLLE:  return launch<T, RECON, SOLVER_EULER_HLLE, S>(a);
    case SOLVER_EULER_HLLC:  return launch<T, RECON, SOLVER_EULER_HLLC, S>(a);
    case SOLVER_GLMMHD_HLLD: return launch<T, RECON, SOLVER_GLMMHD_HLLD, S>(a);
    case SOLVER_EULER_LLF:   return launch<T, RECON, SOLVER_EULER_LLF, S>(a);
    case SOLVER_GLMMHD_LLF:  return launch<T, RECON, SOLVER_GLMMHD_LLF, S>(a);
    case SOLVER_GLMMHD_HLLE: return launch<T, RECON, SOLVER_GLMMHD_HLLE, S>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

#if HYDRO_UNIT_DTYPE == 0
#define HYDRO_UNIT_T float
#else
#define HYDRO_UNIT_T double
#endif

namespace stage {
template <>
cudaError_t launch_recon<HYDRO_UNIT_T, HYDRO_UNIT_RECON, HYDRO_UNIT_SCAL>(
    int solver, const Args& a) {
  return launch_solver<HYDRO_UNIT_T, HYDRO_UNIT_RECON, HYDRO_UNIT_SCAL>(solver,
                                                                        a);
}
#if HYDRO_UNIT_SCAL
template <>
cudaError_t launch_scalars_recon<HYDRO_UNIT_T, HYDRO_UNIT_RECON>(
    int nbase, const Args& a) {
  return launch_scalars<HYDRO_UNIT_T, HYDRO_UNIT_RECON>(nbase, a);
}
#endif
}  // namespace stage

#else  // the entry points

#ifndef HYDRO_ENTRY_SCAL
#define HYDRO_ENTRY_SCAL 0
#endif

namespace stage {

#define HYDRO_UNIT(T, R) \
  template <> cudaError_t launch_recon<T, R, false>(int, const Args&); \
  template <> cudaError_t launch_recon<T, R, true>(int, const Args&); \
  template <> cudaError_t launch_scalars_recon<T, R>(int, const Args&);
#define HYDRO_UNITS(T) \
  HYDRO_UNIT(T, 0) HYDRO_UNIT(T, 1) HYDRO_UNIT(T, 2) \
  HYDRO_UNIT(T, 3) HYDRO_UNIT(T, 4) HYDRO_UNIT(T, 5)
HYDRO_UNITS(float)
HYDRO_UNITS(double)

template <typename T, bool S>
cudaError_t launch_any(int recon, int solver, const Args& a) {
  switch (recon) {
    case hydro::RECON_DC:    return launch_recon<T, hydro::RECON_DC, S>(solver, a);
    case hydro::RECON_PLM:   return launch_recon<T, hydro::RECON_PLM, S>(solver, a);
    case hydro::RECON_PPM:   return launch_recon<T, hydro::RECON_PPM, S>(solver, a);
    case hydro::RECON_WENO3: return launch_recon<T, hydro::RECON_WENO3, S>(solver, a);
    case hydro::RECON_LIMO3: return launch_recon<T, hydro::RECON_LIMO3, S>(solver, a);
    case hydro::RECON_WENOZ: return launch_recon<T, hydro::RECON_WENOZ, S>(solver, a);
  }
  return cudaErrorInvalidValue;
}

// The library's own family: the instantiations without scalars, or
// (HYDRO_ENTRY_SCAL = 1, the library of decks with scalars) those that also
// write the mass fluxes; each library holds one family and refuses the
// other.
template <typename T>
cudaError_t launch_any(int recon, int solver, bool scal, const Args& a) {
  if (scal != (HYDRO_ENTRY_SCAL != 0)) return cudaErrorInvalidValue;
  return launch_any<T, (HYDRO_ENTRY_SCAL != 0)>(recon, solver, a);
}

template <typename T>
cudaError_t launch_scalars_any(int recon, int nbase, const Args& a) {
  switch (recon) {
    case hydro::RECON_DC:    return launch_scalars_recon<T, hydro::RECON_DC>(nbase, a);
    case hydro::RECON_PLM:   return launch_scalars_recon<T, hydro::RECON_PLM>(nbase, a);
    case hydro::RECON_PPM:   return launch_scalars_recon<T, hydro::RECON_PPM>(nbase, a);
    case hydro::RECON_WENO3: return launch_scalars_recon<T, hydro::RECON_WENO3>(nbase, a);
    case hydro::RECON_LIMO3: return launch_scalars_recon<T, hydro::RECON_LIMO3>(nbase, a);
    case hydro::RECON_WENOZ: return launch_scalars_recon<T, hydro::RECON_WENOZ>(nbase, a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace stage

// Tiles (column segments) that each of nb [nz, ny, nx] blocks is cut into:
// dt_out holds nb times this many values.  One shape serves every
// instantiation.
extern "C" int fused_stage_tiles(int nb, int nz, int ny, int nx) {
  const stage::Shape sh = stage::shape_of(nb, nz, ny, nx);
  return sh.ntx * sh.nty * sh.nseg;
}

// dtype: 0 = float32, 1 = float64.  solver: 0 = Euler HLLE, 1 = Euler HLLC,
// 2 = GLM-MHD HLLD, 3 = Euler LLF, 4 = GLM-MHD LLF, 5 = GLM-MHD HLLE.
// recon: 0 = dc, 1 = plm, 2 = ppm, 3 = weno3, 4 = limo3, 5 = wenoz.  u0,
// u1, out and prim_out: contiguous [nb, nvar, nz, ny, nx] on the current
// device, nvar = 5 (Euler) or 9 (GLM-MHD) + the scalars, of which this
// kernel reads and writes the fluid rows; with scalars mx, my, mz,
// contiguous [nb, nz, ny, nx] each, get the mass flux of every x, y and z
// face (entry c: the face before cell c), which stage_scalars reads; dt_out: nb *
// fused_stage_tiles(nb, nz, ny, nx) values.
// dt_out and prim_out may be null.  eos: gamma, density floor, pressure
// floor, internal-energy floor, velocity ceiling, internal-energy ceiling
// (a floor <= 0 and an infinite ceiling are off).  recon_k: per direction
// x, y, z the pair dx^2, (0.1 dx)^2 as the plain reconstruction computes
// them (recon/schemes.py).  fx, fy, fz (all null, or none): contiguous
// [nb, nvar, NZ, NY, 2], [nb, nvar, NZ, NX, 2] and [nb, nvar, NY, NX, 2],
// the fluxes at sweep index g_face and n - g_face of x, y and z, with
// 0 < g_face < min(nz, ny, nx) / 2.
extern "C" int fused_stage(const void* u0, const void* u1, void* out,
                           void* dt_out, void* prim_out, void* fx, void* fy,
                           void* fz, int g_face, int dtype, int solver,
                           int recon, int nb, int nvar, int nz, int ny, int nx,
                           double dx1, double dx2, double dx3, double gam0,
                           double gam1, double beta_dt, double c_h,
                           const double* eos, const double* recon_k,
                           void* mx, void* my, void* mz, void* stream) {
  if (solver < 0 || solver > 5) return (int)cudaErrorInvalidValue;
  const int want = hydro::is_glmmhd(solver) ? 9 : 5;
  const bool any_faces = fx != nullptr || fy != nullptr || fz != nullptr;
  const bool mflux = mx != nullptr && my != nullptr && mz != nullptr;
  if (nvar < want || (nvar > want) != mflux
      || (!mflux && (mx != nullptr || my != nullptr || mz != nullptr))
      || nb <= 0 || nz <= 0 || ny <= 0 || nx <= 0
      || (any_faces && (fx == nullptr || fy == nullptr || fz == nullptr
                        || g_face <= 0 || 2 * g_face >= nz
                        || 2 * g_face >= ny || 2 * g_face >= nx)))
    return (int)cudaErrorInvalidValue;
  stage::Args a;
  a.u0 = u0; a.u1 = u1; a.out = out; a.dt_out = dt_out; a.prim_out = prim_out;
  a.faces[0] = fx; a.faces[1] = fy; a.faces[2] = fz; a.g_face = g_face;
  a.mflux[0] = mx; a.mflux[1] = my; a.mflux[2] = mz;
  a.nb = nb; a.nvar = nvar; a.nz = nz; a.ny = ny; a.nx = nx;
  a.dx1 = dx1; a.dx2 = dx2; a.dx3 = dx3;
  a.gam0 = gam0; a.gam1 = gam1; a.beta_dt = beta_dt; a.c_h = c_h;
  for (int d = 0; d < 3; ++d) {
    a.recon_dx2[d] = recon_k[2 * d];
    a.recon_rdx2[d] = recon_k[2 * d + 1];
  }
  a.eos = hydro::EosArgs{eos[0], eos[1], eos[2], eos[3], eos[4], eos[5]};
  a.stream = static_cast<cudaStream_t>(stream);
  a.with_faces = any_faces;
  a.query = nullptr;
  if (dtype == 0) return (int)stage::launch_any<float>(recon, solver, mflux, a);
  if (dtype == 1)
    return (int)stage::launch_any<double>(recon, solver, mflux, a);
  return (int)cudaErrorInvalidValue;
}

#if HYDRO_ENTRY_SCAL
// The scalar rows nbase .. nvar - 1 of the stage, after the fused_stage
// launch (same stream, same arguments) that wrote mx, my and mz: u0, u1,
// out, prim_out (may be null), fx, fy, fz (all null, or none), eos and
// recon_k as fused_stage's.
extern "C" int stage_scalars(const void* u0, const void* u1, void* out,
                             void* prim_out, void* fx, void* fy, void* fz,
                             int g_face, int dtype, int recon, int nb,
                             int nvar, int nbase, int nz, int ny, int nx,
                             double dx1, double dx2, double dx3, double gam0,
                             double gam1, double beta_dt, const double* eos,
                             const double* recon_k, const void* mx,
                             const void* my, const void* mz, void* stream) {
  const bool any_faces = fx != nullptr || fy != nullptr || fz != nullptr;
  if ((nbase != 5 && nbase != 9) || nvar <= nbase || mx == nullptr
      || my == nullptr || mz == nullptr || nb <= 0 || nz <= 0 || ny <= 0
      || nx <= 0
      || (any_faces && (fx == nullptr || fy == nullptr || fz == nullptr
                        || g_face <= 0 || 2 * g_face >= nz
                        || 2 * g_face >= ny || 2 * g_face >= nx)))
    return (int)cudaErrorInvalidValue;
  stage::Args a{};
  a.u0 = u0; a.u1 = u1; a.out = out; a.prim_out = prim_out;
  a.faces[0] = fx; a.faces[1] = fy; a.faces[2] = fz; a.g_face = g_face;
  a.mflux[0] = const_cast<void*>(mx); a.mflux[1] = const_cast<void*>(my);
  a.mflux[2] = const_cast<void*>(mz);
  a.nb = nb; a.nvar = nvar; a.nz = nz; a.ny = ny; a.nx = nx;
  a.dx1 = dx1; a.dx2 = dx2; a.dx3 = dx3;
  a.gam0 = gam0; a.gam1 = gam1; a.beta_dt = beta_dt; a.c_h = 0.0;
  for (int d = 0; d < 3; ++d) {
    a.recon_dx2[d] = recon_k[2 * d];
    a.recon_rdx2[d] = recon_k[2 * d + 1];
  }
  a.eos = hydro::EosArgs{eos[0], eos[1], eos[2], eos[3], eos[4], eos[5]};
  a.stream = static_cast<cudaStream_t>(stream);
  a.query = nullptr;
  if (dtype == 0) return (int)stage::launch_scalars_any<float>(recon, nbase, a);
  if (dtype == 1) return (int)stage::launch_scalars_any<double>(recon, nbase, a);
  return (int)cudaErrorInvalidValue;
}

// The scalar kernel's instantiation for (dtype, recon): out[0] = its
// dynamic shared memory (none), out[1] = its resident blocks (128 threads)
// per SM.
extern "C" int stage_scalars_occupancy(int dtype, int recon, int* out) {
  stage::Args a{};
  a.query = out;
  if (dtype == 0) return (int)stage::launch_scalars_any<float>(recon, 5, a);
  if (dtype == 1) return (int)stage::launch_scalars_any<double>(recon, 5, a);
  return (int)cudaErrorInvalidValue;
}
#endif  // HYDRO_ENTRY_SCAL

// The instantiation fused_stage launches for (dtype, solver, recon, with
// or without faces, with or without scalars): out[0] = its dynamic shared
// memory in bytes, out[1] = how many of its blocks (128 threads) the
// current device keeps resident per SM.
extern "C" int fused_stage_occupancy(int dtype, int solver, int recon,
                                     int faces, int scal, int* out) {
  stage::Args a{};
  a.with_faces = faces != 0;
  a.query = out;
  if (dtype == 0)
    return (int)stage::launch_any<float>(recon, solver, scal != 0, a);
  if (dtype == 1)
    return (int)stage::launch_any<double>(recon, solver, scal != 0, a);
  return (int)cudaErrorInvalidValue;
}

#endif  // HYDRO_UNIT_RECON
