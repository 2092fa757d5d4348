// Fused -div(F) sweep on Hopper: reconstruction + Riemann solve + flux
// divergence for one direction per launch, for Euler (LLF, HLLE, HLLC) and
// GLM-MHD (LLF, HLLE, HLLD), with DC, PLM, PPM, WENO3, LimO3 or WENO-Z.
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
// 1 at n - g; the segment that owns the face's right cell writes it, so
// each face is written once.
// Here no transpose and no halo slab is needed: the kernel reads along y
// or z with a stride, the direction only selects which momentum and field
// components are normal (template parameter DIR), and the caller launches
// it once per active direction, so a 2-D mesh takes two launches and a
// 1-D mesh one.
// The plain PyTorch twin is negdiv_plain in solver/sweep.py; the device
// functions (hydro_device.cuh) follow recon/schemes.py and
// riemann/solvers.py operation by operation (built without contracted
// multiply-adds, so it keeps to the plain version's rounding).
//
// What bounds it: per cell and direction, PPM costs ~100 floating-point
// operations per variable and HLLD a few hundred per face, against NV
// values read and NV written (2 NV more read-modify-written for the
// accumulating y/z launches).  That is ~50-100 operations per byte, above
// the card's FP32 and FP64 ridge points, so the arithmetic pipes bound the
// kernel, and what keeps them fed is latency hiding: enough resident warps,
// no idle barrier waiting on device memory, no work done twice.
//
// Design: a block of 128 threads owns a bundle of TL pencils (lines along
// the sweep axis; consecutive pencils are consecutive x for the y and z
// sweeps, consecutive rows for the x sweep) and marches along the sweep
// axis over one segment of it, CS cells per step, thread (j, l) taking
// cell j of the step in pencil l.  The x sweep takes CS = 16 cells of 8
// rows, the y and z sweeps CS = 4 cells of 32 pencils (a warp reads 32
// consecutive x).
//  - Loads: each step's CS cells arrive by cp.async into a ring of 4 steps
//    of prim in shared memory, one step ahead of the compute, so loads
//    overlap arithmetic; the ring keeps the last 2h cells, so no halo is
//    read twice within a segment (only a segment's first h cells are read
//    by its neighbour too).  The x sweep copies 16 bytes of a row per
//    cp.async (4 f32 or 2 f64 cells; 3 or 5 copies per thread and step
//    instead of 9 single cells), its ring being cells-innermost already.
//  - Each step builds the edge states of CS cells once, solves CS faces
//    once (the left state of a step's first face and the flux of the face
//    before it come from the previous step through two small rings), and
//    writes -(F[i+1] - F[i]) / dx of CS cells, or adds it to the output
//    for the second and third direction.  Three barriers per step (two for
//    DC); with 3-4 blocks resident per SM one block's barrier is another's
//    issue slot.
//  - The sweep axis wraps within the block's own extent (torch.roll within
//    each block: the periodic boundary on the ghost-free layout, garbage
//    confined to the ghost rim on ghosted layouts), by a compare at the
//    extent's ends, not a division per element.
//  - Shared-memory layouts keep a warp's 32 accesses on 32 banks: pencil
//    innermost for the y/z sweeps; for the x sweep, cells innermost with
//    each row's pitch offset by 16 words, so the two rows a warp covers
//    fall on disjoint banks.
//  - Segments: a block marches the whole extent when there are enough
//    pencil bundles to fill the card, else the extent is cut into segments
//    (at least 8 steps each) until there are ~2048 blocks.
//
// Passive scalars (nvar = 5 or 9 fluid variables + nscalars): the fluid
// kernel keeps its compile-time variable count NV.  Its instantiation for
// decks with scalars (template switch SCAL) reads the fluid rows of the
// [nb, nvar, ...] state (runtime block and face-slab strides) and also
// writes each face's mass flux (the Riemann solver's density flux) into a
// [nb, nz, ny, nx] array, entry c the face before cell c; the scalar
// kernel that the caller launches right after it on the same stream
// (negdiv_scalars) reconstructs each scalar, takes the upwind flux
// fd >= 0 ? fd * wl : fd * wr (riemann/solvers.py:_scalar_fluxes) and
// writes or adds -(F[i+1] - F[i]) / dx and the scalar rows of the face
// slab.  The SCAL = false instantiations are the code without scalars,
// unchanged (a runtime stride and the store cost the stage kernel up to
// 16 registers and 10-20 % of its time when every deck took them); no
// template dimension follows the scalar count, so any count runs.  The
// scalar kernel takes one thread per cell: a face's scalar edge states are
// built by both cells beside it (1.5x the reconstructions), cheap beside
// the fluid's solve.
//
// Plain C interface (loaded with ctypes): negdiv_sweep(...) and
// negdiv_scalars(...) return the cudaError_t of the launch (0 on success);
// they never synchronise.
//
// Translation units: the 6 reconstructions x 6 (fluid, solver) pairs x 3
// directions x 2 dtypes x 2 (without and with scalars) make 432
// instantiations (and the scalar kernel's 6 x 3 x 2 = 36 small ones), so
// the source is compiled once per (reconstruction, dtype, scalars), with
// -DHYDRO_UNIT_RECON=r -DHYDRO_UNIT_DTYPE=t (0 float, 1 double)
// -DHYDRO_UNIT_SCAL=s (0, 1), each unit defining launch_recon<T, r, s>
// (and with s = 1 the scalar kernel's launch_scalars_recon<T, r>), and
// once per s for the C entry points (-DHYDRO_ENTRY_SCAL=s), which dispatch
// to the units; the units of one s compile in parallel and link into one
// library, so a run without scalars never builds the other
// (solver/sweep.py:build_library).

#include <cuda_runtime.h>

#include "hydro_device.cuh"

namespace negdiv {

struct Args {
  const void* prim;
  void* out;
  void* faces;      // null: no face capture
  void* mflux;      // null: no mass-flux output (no scalars)
  int g_face;
  int nb, nvar, nz, ny, nx;
  double dx, c_h;
  double recon_dx2, recon_rdx2;   // recon/schemes.py: dx^2, (0.1 dx)^2
  hydro::EosArgs eos;
  int accumulate;
  cudaStream_t stream;
  int* query;       // non-null: report, do not launch (negdiv_sweep_occupancy)
};

// Defined by the unit of (T, RECON, SCAL): dispatch over direction and
// solver.
template <typename T, int RECON, bool SCAL>
cudaError_t launch_recon(int dir, int solver, const Args& a);
// ... and over the direction of the scalar kernel (nbase: the fluid's
// variable count, the first scalar's row)
template <typename T, int RECON>
cudaError_t launch_scalars_recon(int dir, int nbase, const Args& a);

}  // namespace negdiv

#ifdef HYDRO_UNIT_RECON

namespace {

using namespace hydro;
using negdiv::Args;

constexpr int NTHREADS = 128;

// Block shape of direction DIR: CS cells per step times TL pencils, and
// the shared-memory layouts of the prim ring (RS cells per pencil) and of
// the edge-state and flux rings (QS per pencil).
template <int DIR>
struct Shape {
  static constexpr bool X = DIR == 1;     // the sweep axis is contiguous
  static constexpr int CS = X ? 16 : 4;
  static constexpr int TL = NTHREADS / CS;
  static constexpr int RS = 4 * CS;       // prim ring: 4 steps
  static constexpr int QS = 2 * CS;       // edge-state and flux rings
  static constexpr int RSP = X ? RS + 16 : RS;   // pitch of one pencil (x)
  static constexpr int QSP = X ? QS + 16 : QS;
  __device__ static int cell_of(int t) { return X ? t % CS : t / TL; }
  __device__ static int lane_of(int t) { return X ? t / CS : t % TL; }
  // offset of (slot s, pencil l) in a ring of S slots and pitch P; variable
  // v adds v * var_stride(S, P)
  __device__ static int at(int s, int l, int S, int P) {
    return X ? l * P + s : s * TL + l;
  }
  __host__ __device__ static constexpr int var_stride(int S, int P) {
    return X ? TL * P : S * TL;
  }
};

// Resident blocks per SM that __launch_bounds__ asks for, so registers cap
// at 65536 / (128 * blocks); the instantiations use fewer (HLLD: ~96 in
// f32, ~175 in f64), and the occupancy query reports what the card keeps.
template <typename T, int SOLVER>
struct MinBlocks {
  static constexpr bool MHD = is_glmmhd(SOLVER);
  static constexpr int value = sizeof(T) == 4 ? (MHD ? 3 : 4) : (MHD ? 2 : 3);
};

template <int DIR, int NV, int RECON>
constexpr size_t smem_elems() {
  using S = Shape<DIR>;
  constexpr size_t ring = (size_t)NV * S::TL * S::RSP;
  constexpr size_t q = (size_t)NV * S::TL * S::QSP;
  // DC takes its edge states from the prim ring
  return RECON == RECON_DC ? ring + q : ring + 2 * q;
}

struct Geom {
  int n;              // extent of the sweep axis within a block
  int seg_len;        // cells per segment (the last may be shorter)
  int npen;           // pencils per block
  int nx;             // x extent: pencil -> address for the y sweep
  long long npen_all; // nb * npen
  long long s_sweep;  // element strides
  long long s_plane;  // ny * nx
  long long s_var;
  long long s_block;
  int nvar;           // variables of the state (fluid + scalars)
};

template <typename T, int RECON, int DIR, int SOLVER, bool SCAL>
__global__ void __launch_bounds__(NTHREADS, (MinBlocks<T, SOLVER>::value))
negdiv_sweep_kernel(const T* __restrict__ prim, T* __restrict__ out,
                    T* __restrict__ faces, const Geom g, const Params<T> p,
                    const ReconK<T> rk, const T inv_dx, const int accumulate,
                    const int g_face, T* __restrict__ mflux) {
  constexpr int NV = NVar<SOLVER>::value;
  constexpr int H = Halo<RECON>::h;
  constexpr int R = H - 1;   // stencil radius of one cell's edge states
  using S = Shape<DIR>;
  constexpr int CS = S::CS, RS = S::RS, QS = S::QS;
  // x sweep: E cells per 16-byte copy, and the relative index starts H0 >= H
  // cells before the segment, H0 a multiple of E, so that each copy's cells
  // start on a 16-byte boundary of a row
  constexpr int E = 16 / sizeof(T);
  constexpr int H0 = S::X ? (H + E - 1) / E * E : H;
  constexpr int VR = S::var_stride(RS, S::RSP), VQ = S::var_stride(QS, S::QSP);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);        // prim, [NV] x ring
  T* flux = ring + NV * S::TL * S::RSP;             // face fluxes
  T* qp_r = flux + NV * S::TL * S::QSP;             // right edge states

  const int j = S::cell_of(threadIdx.x), l = S::lane_of(threadIdx.x);
  const long long pen = (long long)blockIdx.x * S::TL + l;
  const bool live = pen < g.npen_all;
  const int b = live ? (int)(pen / g.npen) : 0;
  const int q = live ? (int)(pen - (long long)b * g.npen) : 0;
  const long long base = b * g.s_block
      + (DIR == 1 ? (long long)q * g.nx
         : DIR == 2 ? (long long)(q / g.nx) * g.s_plane + q % g.nx
                    : (long long)q);
  const int n = g.n;
  const int a = blockIdx.y * g.seg_len;      // first cell of the segment
  const int N = min(g.seg_len, n - a);
  // Relative index p = cell - (a - H0).  Step k loads cells p in
  // [k CS, (k+1) CS) and builds the edge states of p = k CS - R + j; the
  // segment needs edge states for p in [H0 - 1, H0 + N], faces for p in
  // [H0, H0 + N] and writes cells p in [H0, H0 + N).
  const int K = (H0 + N + R) / CS + 1;

  // The x sweep's copies: thread t copies the E cells from cell
  // (t % CPR) E of row (t / CPR) % TL of variables t / (TL CPR) + m VSTEP.
  // Where rows are 16-byte aligned and E divides the extent (vec), a
  // copy's E cells wrap together, so each is one 16-byte copy; else the
  // thread copies them cell by cell.
  constexpr int CPR = CS / E, VSTEP = NTHREADS / (S::TL * CPR);
  const int lr = S::X ? threadIdx.x / CPR % S::TL : l;
  const int v0 = S::X ? threadIdx.x / (S::TL * CPR) : 0;
  const int e0 = S::X ? threadIdx.x % CPR * E : j;
  long long row = base;
  bool live_r = live;
  if constexpr (S::X) {
    const long long pr = (long long)blockIdx.x * S::TL + lr;
    live_r = pr < g.npen_all;
    const int br = live_r ? (int)(pr / g.npen) : 0;
    row = br * g.s_block + (live_r ? pr - (long long)br * g.npen : 0) * g.nx;
  }
  const bool vec = S::X && reinterpret_cast<unsigned long long>(prim) % 16 == 0
                   && g.nx % E == 0 && g.s_var % E == 0;

  auto load_step = [&](int k) {
    if (!live_r) return;
    if constexpr (S::X) {
      const int pk = k * CS + e0;
      const int c = a - H0 + pk;
      T* dst = ring + S::at(pk & (RS - 1), lr, RS, S::RSP);
      if (vec) {
        const T* src = prim + row + wrap_index(c, n);
#pragma unroll
        for (int v = v0; v < NV; v += VSTEP)
          cp_async16(dst + v * VR, src + v * g.s_var);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const T* src = prim + row + wrap_index(c + e, n);
#pragma unroll
          for (int v = v0; v < NV; v += VSTEP)
            cp_async(dst + e + v * VR, src + v * g.s_var);
        }
      }
    } else {
      const int pk = k * CS + j;
      const T* src = prim + base + wrap_index(a - H0 + pk, n) * g.s_sweep;
      T* dst = ring + S::at(pk & (RS - 1), l, RS, S::RSP);
#pragma unroll
      for (int v = 0; v < NV; ++v) cp_async(dst + v * VR, src + v * g.s_var);
    }
  };

  load_step(0);
  cp_async_commit();
  for (int k = 0; k < K; ++k) {
    cp_async_wait_all();
    __syncthreads();   // step k's cells have landed; step k-1 is done
    if (k + 1 < K) load_step(k + 1);
    cp_async_commit();

    const int pc = k * CS - R + j;   // this thread's cell and the face before it
    const bool face = live && pc >= H0 && pc <= H0 + N;
    T wr[NV];
    if constexpr (RECON != RECON_DC) {
      if (live && pc >= H0 - 1 && pc <= H0 + N) {
        int off[2 * R + 1];
#pragma unroll
        for (int o = -R; o <= R; ++o)
          off[o + R] = S::at((pc + o) & (RS - 1), l, RS, S::RSP);
        T* qp_dst = qp_r + S::at(pc & (QS - 1), l, QS, S::QSP);
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const T* r = ring + v * VR;
          T st[2 * R + 1], qp;
#pragma unroll
          for (int o = 0; o <= 2 * R; ++o) st[o] = r[off[o]];
          cell_edges<T, RECON>(st, positive_var(v), rk, wr[v], qp);
          qp_dst[v * VQ] = qp;
        }
      }
      __syncthreads();   // right edge states of this step are staged
    }

    T F[NV];
    if (face) {
      T wl[NV];
      if constexpr (RECON == RECON_DC) {
        const int ol = S::at((pc - 1) & (RS - 1), l, RS, S::RSP);
        const int orr = S::at(pc & (RS - 1), l, RS, S::RSP);
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          wl[v] = ring[ol + v * VR];
          wr[v] = ring[orr + v * VR];
        }
      } else {
        const int ol = S::at((pc - 1) & (QS - 1), l, QS, S::QSP);
#pragma unroll
        for (int v = 0; v < NV; ++v) wl[v] = qp_r[ol + v * VQ];
      }
      riemann_flux<T, SOLVER, DIR>(wl, wr, p, F);
      const int of = S::at(pc & (QS - 1), l, QS, S::QSP);
#pragma unroll
      for (int v = 0; v < NV; ++v) flux[of + v * VQ] = F[v];
    }
    __syncthreads();   // this step's fluxes are staged

    if (face) {
      const int c = a - H0 + pc;   // the face's right cell, in [a, a + N]
      // the mass flux for the scalar kernel, by the segment holding the
      // face's right cell
      if constexpr (SCAL) {
        if (c < a + N)
          mflux[base + b * (g.s_var - g.s_block)
                + (long long)c * g.s_sweep] = F[IDN];
      }
      // face capture, after the solve: the faces at sweep index g and n - g,
      // by the segment holding the face's right cell
      if (faces != nullptr && c < a + N && (c == g_face || c == n - g_face)) {
        const long long o = ((long long)b * (SCAL ? g.nvar : NV) * g.npen
                             + q) * 2
                            + (c == g_face ? 0 : 1);
#pragma unroll
        for (int v = 0; v < NV; ++v) faces[o + 2LL * v * g.npen] = F[v];
      }
      // -(F[i+1] - F[i]) / dx of the cell before the face, written or added
      if (pc > H0) {
        const int ol = S::at((pc - 1) & (QS - 1), l, QS, S::QSP);
        const long long o = base + (long long)(c - 1) * g.s_sweep;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const T r = -((F[v] - flux[ol + v * VQ]) * inv_dx);
          T* dst = out + o + v * g.s_var;
          *dst = accumulate ? *dst + r : r;
        }
      }
    }
  }
}

template <typename T, int RECON, int DIR, int SOLVER, bool SCAL>
cudaError_t launch(const Args& a) {
  constexpr int NV = NVar<SOLVER>::value;
  using S = Shape<DIR>;
  const size_t smem = sizeof(T) * smem_elems<DIR, NV, RECON>();
  static_assert(sizeof(T) * smem_elems<DIR, NV, RECON>() <= 232448,
                "block exceeds a block's shared memory");
  auto kernel = negdiv_sweep_kernel<T, RECON, DIR, SOLVER, SCAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (a.query != nullptr) {
    a.query[0] = (int)smem;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a.query[1], kernel,
                                                         NTHREADS, smem);
  }
  Geom g;
  g.nx = a.nx;
  g.nvar = a.nvar;
  g.s_plane = (long long)a.ny * a.nx;
  g.s_var = (long long)a.nz * a.ny * a.nx;
  g.s_block = a.nvar * g.s_var;
  if (DIR == 1) {
    g.n = a.nx; g.s_sweep = 1; g.npen = a.nz * a.ny;
  } else if (DIR == 2) {
    g.n = a.ny; g.s_sweep = a.nx; g.npen = a.nz * a.nx;
  } else {
    g.n = a.nz; g.s_sweep = g.s_plane; g.npen = a.ny * a.nx;
  }
  g.npen_all = (long long)a.nb * g.npen;
  const long long bundles = (g.npen_all + S::TL - 1) / S::TL;
  // cut the sweep axis into segments of at least 8 steps while there are
  // fewer than ~2048 blocks (a few waves over the card's 132 SMs)
  const long long want = 2048;
  int nseg = 1;
  if (bundles < want) {
    const long long by_blocks = (want + bundles - 1) / bundles;
    const int by_len = g.n / (8 * S::CS);
    nseg = (int)(by_blocks < by_len ? by_blocks : by_len);
    if (nseg < 1) nseg = 1;
  }
  g.seg_len = (g.n + nseg - 1) / nseg;
  g.seg_len = (g.seg_len + S::CS - 1) / S::CS * S::CS;
  nseg = (g.n + g.seg_len - 1) / g.seg_len;

  // scalar constants are folded in double, then rounded to T, exactly as
  // the plain path's Python-float scalars are; 1/dx is computed in T, as
  // PyTorch on the card divides by a Python scalar
  const Params<T> p = make_params<T>(a.eos, a.c_h);
  const ReconK<T> rk = make_recon_k<T>(a.recon_dx2, a.recon_rdx2);
  const T inv_dx = T(1) / T(a.dx);
  dim3 grid((unsigned)bundles, nseg, 1);
  kernel<<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.prim), static_cast<T*>(a.out),
      static_cast<T*>(a.faces), g, p, rk, inv_dx, a.accumulate, a.g_face,
      static_cast<T*>(a.mflux));
  return cudaGetLastError();
}

// ------------------------------------------------------------ the scalars
constexpr int SCALAR_THREADS = 256;

// -div(F) of the passive scalars along DIR, rows nbase .. nvar - 1, from
// the mass flux of that direction: thread t takes cell t of the state (x
// fastest) and, per scalar, the edge states of the cell and of its two
// neighbours along DIR (wrapped within the block), the fluxes of its two
// faces, and writes or adds -(F[c+1] - F[c]) / dx; the cell at sweep index
// g or n - g also writes its left face into the face slab.
template <typename T, int RECON, int DIR>
__global__ void __launch_bounds__(SCALAR_THREADS, 1)
negdiv_scalars_kernel(const T* __restrict__ prim, T* __restrict__ out,
                      T* __restrict__ faces, const T* __restrict__ mflux,
                      const Geom g, const int nbase, const ReconK<T> rk,
                      const T inv_dx, const int accumulate, const int g_face) {
  constexpr int R = Halo<RECON>::h - 1;
  const long long cell = (long long)blockIdx.x * SCALAR_THREADS + threadIdx.x;
  const long long nb = g.npen_all / g.npen;
  if (cell >= nb * g.s_var) return;
  const int b = (int)(cell / g.s_var);
  const long long in_b = cell - (long long)b * g.s_var;   // z, y, x in the block
  const int x = (int)(in_b % g.nx);
  const long long zy = in_b / g.nx;
  const int ny = (int)(g.s_plane / g.nx);
  const int y = (int)(zy % ny), z = (int)(zy / ny);
  const int c = DIR == 1 ? x : (DIR == 2 ? y : z);
  const long long off = in_b - (long long)c * g.s_sweep;   // c = 0 on the line
  // the face slab's pencil index (x: z, y; y: z, x; z: y, x)
  const long long q = DIR == 1 ? zy : (DIR == 2 ? (long long)z * g.nx + x
                                                : (long long)y * g.nx + x);
  const int n = g.n;
  long long at[2 * R + 3];   // stencil offsets: cells c - 1 - R .. c + 1 + R
#pragma unroll
  for (int o = 0; o < 2 * R + 3; ++o)
    at[o] = off + (long long)wrap_index(c - 1 - R + o, n) * g.s_sweep;
  const T* mf = mflux + (long long)b * g.s_var;
  const T fdl = mf[at[R + 1]];   // the face before c
  const T fdr = mf[at[R + 2]];   // the face before c + 1
  const bool capture = faces != nullptr && (c == g_face || c == n - g_face);
  for (int v = nbase; v < g.nvar; ++v) {
    const T* r = prim + ((long long)b * g.nvar + v) * g.s_var;
    T st[2 * R + 3];
#pragma unroll
    for (int o = 0; o < 2 * R + 3; ++o) st[o] = r[at[o]];
    T qm_l, qp_l, qm_c, qp_c, qm_r, qp_r;
    cell_edges<T, RECON>(st, false, rk, qm_l, qp_l);
    cell_edges<T, RECON>(st + 1, false, rk, qm_c, qp_c);
    cell_edges<T, RECON>(st + 2, false, rk, qm_r, qp_r);
    const T fl = fdl >= T(0) ? fdl * qp_l : fdl * qm_c;
    const T fr = fdr >= T(0) ? fdr * qp_c : fdr * qm_r;
    const T res = -((fr - fl) * inv_dx);
    T* dst = out + ((long long)b * g.nvar + v) * g.s_var + in_b;
    *dst = accumulate ? *dst + res : res;
    if (capture)
      faces[(((long long)b * g.nvar + v) * g.npen + q) * 2
            + (c == g_face ? 0 : 1)] = fl;
  }
}

template <typename T, int RECON, int DIR>
cudaError_t launch_scalars(int nbase, const Args& a) {
  auto kernel = negdiv_scalars_kernel<T, RECON, DIR>;
  if (a.query != nullptr) {
    a.query[0] = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &a.query[1], kernel, SCALAR_THREADS, 0);
  }
  Geom g;
  g.nx = a.nx;
  g.nvar = a.nvar;
  g.s_plane = (long long)a.ny * a.nx;
  g.s_var = (long long)a.nz * a.ny * a.nx;
  g.s_block = a.nvar * g.s_var;
  g.n = DIR == 1 ? a.nx : (DIR == 2 ? a.ny : a.nz);
  g.s_sweep = DIR == 1 ? 1 : (DIR == 2 ? a.nx : g.s_plane);
  g.npen = (int)(g.s_var / g.n);
  g.npen_all = (long long)a.nb * g.npen;
  g.seg_len = g.n;
  const ReconK<T> rk = make_recon_k<T>(a.recon_dx2, a.recon_rdx2);
  const T inv_dx = T(1) / T(a.dx);
  const long long cells = (long long)a.nb * g.s_var;
  const unsigned blocks = (unsigned)((cells + SCALAR_THREADS - 1) / SCALAR_THREADS);
  kernel<<<blocks, SCALAR_THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.prim), static_cast<T*>(a.out),
      static_cast<T*>(a.faces), static_cast<const T*>(a.mflux), g, nbase, rk,
      inv_dx, a.accumulate, a.g_face);
  return cudaGetLastError();
}

template <typename T, int RECON, int DIR, bool S>
cudaError_t launch_solver(int solver, const Args& a) {
  switch (solver) {
    case SOLVER_EULER_HLLE:  return launch<T, RECON, DIR, SOLVER_EULER_HLLE, S>(a);
    case SOLVER_EULER_HLLC:  return launch<T, RECON, DIR, SOLVER_EULER_HLLC, S>(a);
    case SOLVER_GLMMHD_HLLD: return launch<T, RECON, DIR, SOLVER_GLMMHD_HLLD, S>(a);
    case SOLVER_EULER_LLF:   return launch<T, RECON, DIR, SOLVER_EULER_LLF, S>(a);
    case SOLVER_GLMMHD_LLF:  return launch<T, RECON, DIR, SOLVER_GLMMHD_LLF, S>(a);
    case SOLVER_GLMMHD_HLLE: return launch<T, RECON, DIR, SOLVER_GLMMHD_HLLE, S>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int RECON, bool S>
cudaError_t launch_dir(int dir, int solver, const Args& a) {
  switch (dir) {
    case 1: return launch_solver<T, RECON, 1, S>(solver, a);
    case 2: return launch_solver<T, RECON, 2, S>(solver, a);
    case 3: return launch_solver<T, RECON, 3, S>(solver, a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

#if HYDRO_UNIT_DTYPE == 0
#define HYDRO_UNIT_T float
#else
#define HYDRO_UNIT_T double
#endif

namespace negdiv {
template <>
cudaError_t launch_recon<HYDRO_UNIT_T, HYDRO_UNIT_RECON, HYDRO_UNIT_SCAL>(
    int dir, int solver, const Args& a) {
  return launch_dir<HYDRO_UNIT_T, HYDRO_UNIT_RECON, HYDRO_UNIT_SCAL>(dir,
                                                                     solver, a);
}
#if HYDRO_UNIT_SCAL
template <>
cudaError_t launch_scalars_recon<HYDRO_UNIT_T, HYDRO_UNIT_RECON>(
    int dir, int nbase, const Args& a) {
  switch (dir) {
    case 1: return launch_scalars<HYDRO_UNIT_T, HYDRO_UNIT_RECON, 1>(nbase, a);
    case 2: return launch_scalars<HYDRO_UNIT_T, HYDRO_UNIT_RECON, 2>(nbase, a);
    case 3: return launch_scalars<HYDRO_UNIT_T, HYDRO_UNIT_RECON, 3>(nbase, a);
  }
  return cudaErrorInvalidValue;
}
#endif
}  // namespace negdiv

#else  // the entry points

#ifndef HYDRO_ENTRY_SCAL
#define HYDRO_ENTRY_SCAL 0
#endif

namespace negdiv {

#define HYDRO_UNIT(T, R) \
  template <> cudaError_t launch_recon<T, R, false>(int, int, const Args&); \
  template <> cudaError_t launch_recon<T, R, true>(int, int, const Args&); \
  template <> cudaError_t launch_scalars_recon<T, R>(int, int, const Args&);
#define HYDRO_UNITS(T) \
  HYDRO_UNIT(T, 0) HYDRO_UNIT(T, 1) HYDRO_UNIT(T, 2) \
  HYDRO_UNIT(T, 3) HYDRO_UNIT(T, 4) HYDRO_UNIT(T, 5)
HYDRO_UNITS(float)
HYDRO_UNITS(double)

template <typename T, bool S>
cudaError_t launch_any(int recon, int dir, int solver, const Args& a) {
  switch (recon) {
    case hydro::RECON_DC:    return launch_recon<T, hydro::RECON_DC, S>(dir, solver, a);
    case hydro::RECON_PLM:   return launch_recon<T, hydro::RECON_PLM, S>(dir, solver, a);
    case hydro::RECON_PPM:   return launch_recon<T, hydro::RECON_PPM, S>(dir, solver, a);
    case hydro::RECON_WENO3: return launch_recon<T, hydro::RECON_WENO3, S>(dir, solver, a);
    case hydro::RECON_LIMO3: return launch_recon<T, hydro::RECON_LIMO3, S>(dir, solver, a);
    case hydro::RECON_WENOZ: return launch_recon<T, hydro::RECON_WENOZ, S>(dir, solver, a);
  }
  return cudaErrorInvalidValue;
}

// The library's own family: the instantiations without scalars, or
// (HYDRO_ENTRY_SCAL = 1, the library of decks with scalars) those that also
// write the mass fluxes; each library holds one family and refuses the
// other.
template <typename T>
cudaError_t launch_any(int recon, int dir, int solver, bool scal,
                       const Args& a) {
  if (scal != (HYDRO_ENTRY_SCAL != 0)) return cudaErrorInvalidValue;
  return launch_any<T, (HYDRO_ENTRY_SCAL != 0)>(recon, dir, solver, a);
}

template <typename T>
cudaError_t launch_scalars_any(int recon, int dir, int nbase, const Args& a) {
  switch (recon) {
    case hydro::RECON_DC:    return launch_scalars_recon<T, hydro::RECON_DC>(dir, nbase, a);
    case hydro::RECON_PLM:   return launch_scalars_recon<T, hydro::RECON_PLM>(dir, nbase, a);
    case hydro::RECON_PPM:   return launch_scalars_recon<T, hydro::RECON_PPM>(dir, nbase, a);
    case hydro::RECON_WENO3: return launch_scalars_recon<T, hydro::RECON_WENO3>(dir, nbase, a);
    case hydro::RECON_LIMO3: return launch_scalars_recon<T, hydro::RECON_LIMO3>(dir, nbase, a);
    case hydro::RECON_WENOZ: return launch_scalars_recon<T, hydro::RECON_WENOZ>(dir, nbase, a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace negdiv

// dtype: 0 = float32, 1 = float64.  solver: 0 = Euler HLLE, 1 = Euler HLLC,
// 2 = GLM-MHD HLLD, 3 = Euler LLF, 4 = GLM-MHD LLF, 5 = GLM-MHD HLLE.
// recon: 0 = dc, 1 = plm, 2 = ppm, 3 = weno3, 4 = limo3, 5 = wenoz.  dir:
// 1, 2, 3.  prim and out: contiguous [nb, nvar, nz, ny, nx] on the current
// device, nvar = 5 (Euler) or 9 (GLM-MHD) + the scalars, of which this
// kernel reads and writes the fluid rows; with scalars (nvar above the
// fluid's) mflux, a contiguous [nb, nz, ny, nx], gets the mass flux of
// each face (entry c: the face before cell c along dir), which
// negdiv_scalars then reads.  recon_dx2, recon_rdx2: dx^2 and
// (0.1 dx)^2 of the direction as the plain reconstruction computes them
// (recon/schemes.py).  accumulate != 0 adds into out instead of writing
// it.  faces (may be null): contiguous [nb, nvar, A, B, 2] of direction
// dir (see the top of this file), g_face the ghost width along dir, with
// 0 < g_face < extent / 2.
extern "C" int negdiv_sweep(const void* prim, void* out, int dtype, int solver,
                            int recon, int dir, int nb, int nvar, int nz,
                            int ny, int nx, double dx, double gamma,
                            double c_h, double recon_dx2, double recon_rdx2,
                            int accumulate, void* faces, int g_face,
                            void* mflux, void* stream) {
  if (solver < 0 || solver > 5) return (int)cudaErrorInvalidValue;
  const int want = hydro::is_glmmhd(solver) ? 9 : 5;
  const int n_dir = dir == 1 ? nx : (dir == 2 ? ny : nz);
  if (nvar < want || (nvar > want) != (mflux != nullptr) || nb <= 0
      || nz <= 0 || ny <= 0 || nx <= 0
      || (faces != nullptr && (g_face <= 0 || 2 * g_face >= n_dir)))
    return (int)cudaErrorInvalidValue;
  negdiv::Args a;
  a.prim = prim; a.out = out; a.faces = faces; a.mflux = mflux;
  a.g_face = g_face;
  a.nb = nb; a.nvar = nvar; a.nz = nz; a.ny = ny; a.nx = nx;
  a.dx = dx; a.c_h = c_h;
  a.recon_dx2 = recon_dx2; a.recon_rdx2 = recon_rdx2;
  // no floors here
  a.eos = hydro::EosArgs{gamma, -1.0, -1.0, -1.0, hydro::NO_CEILING,
                         hydro::NO_CEILING};
  a.accumulate = accumulate;
  a.stream = static_cast<cudaStream_t>(stream);
  a.query = nullptr;
  const bool scal = nvar > want;
  if (dtype == 0)
    return (int)negdiv::launch_any<float>(recon, dir, solver, scal, a);
  if (dtype == 1)
    return (int)negdiv::launch_any<double>(recon, dir, solver, scal, a);
  return (int)cudaErrorInvalidValue;
}

// The instantiation negdiv_sweep launches for (dtype, solver, recon, dir,
// with scalars or not): out[0] = its dynamic shared memory in bytes,
// out[1] = how many of its blocks (128 threads) the current device keeps
// resident per SM.
extern "C" int negdiv_sweep_occupancy(int dtype, int solver, int recon,
                                      int dir, int scal, int* out) {
  negdiv::Args a{};
  a.query = out;
  if (dtype == 0)
    return (int)negdiv::launch_any<float>(recon, dir, solver, scal != 0, a);
  if (dtype == 1)
    return (int)negdiv::launch_any<double>(recon, dir, solver, scal != 0, a);
  return (int)cudaErrorInvalidValue;
}

#if HYDRO_ENTRY_SCAL
// The scalar rows nbase .. nvar - 1 of -div(F) along dir, after the
// negdiv_sweep launch of the same direction (same stream) that wrote
// mflux: prim, out and faces as negdiv_sweep's (the scalar rows of out
// are written, or added to with accumulate != 0; those of faces written).
extern "C" int negdiv_scalars(const void* prim, void* out, int dtype,
                              int recon, int dir, int nb, int nvar, int nbase,
                              int nz, int ny, int nx, double dx,
                              double recon_dx2, double recon_rdx2,
                              int accumulate, void* faces, int g_face,
                              const void* mflux, void* stream) {
  const int n_dir = dir == 1 ? nx : (dir == 2 ? ny : nz);
  if ((nbase != 5 && nbase != 9) || nvar <= nbase || mflux == nullptr
      || nb <= 0 || nz <= 0 || ny <= 0 || nx <= 0
      || (faces != nullptr && (g_face <= 0 || 2 * g_face >= n_dir)))
    return (int)cudaErrorInvalidValue;
  negdiv::Args a{};
  a.prim = prim; a.out = out; a.faces = faces;
  a.mflux = const_cast<void*>(mflux); a.g_face = g_face;
  a.nb = nb; a.nvar = nvar; a.nz = nz; a.ny = ny; a.nx = nx;
  a.dx = dx; a.recon_dx2 = recon_dx2; a.recon_rdx2 = recon_rdx2;
  a.accumulate = accumulate;
  a.stream = static_cast<cudaStream_t>(stream);
  a.query = nullptr;
  if (dtype == 0) return (int)negdiv::launch_scalars_any<float>(recon, dir, nbase, a);
  if (dtype == 1) return (int)negdiv::launch_scalars_any<double>(recon, dir, nbase, a);
  return (int)cudaErrorInvalidValue;
}

// The scalar kernel's instantiation for (dtype, recon, dir): out[0] = its
// dynamic shared memory (none), out[1] = its resident blocks (256 threads)
// per SM.
extern "C" int negdiv_scalars_occupancy(int dtype, int recon, int dir,
                                        int* out) {
  negdiv::Args a{};
  a.query = out;
  if (dtype == 0) return (int)negdiv::launch_scalars_any<float>(recon, dir, 5, a);
  if (dtype == 1) return (int)negdiv::launch_scalars_any<double>(recon, dir, 5, a);
  return (int)cudaErrorInvalidValue;
}
#endif  // HYDRO_ENTRY_SCAL

#endif  // HYDRO_UNIT_RECON
