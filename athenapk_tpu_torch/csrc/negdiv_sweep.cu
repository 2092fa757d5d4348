// Fused -div(F) sweep for GLM-MHD on Hopper: reconstruction + HLLD Riemann
// solve + flux divergence for one direction per launch.
//
// Replaces the TPU kernel athenapk_tpu/solver/pallas_sweep.py:
// make_lane_sweep_negdiv (one direction, sweep axis on the lanes), as
// composed by make_fused_negdiv (sum over the active directions, y and z
// reached by transposes).  Here no transpose is needed: the kernel reads
// along y or z with a stride, and the direction only selects which
// momentum and field components are normal (template parameter DIR).
// The plain PyTorch twin is negdiv_plain in solver/sweep.py; the
// arithmetic below follows recon/schemes.py and riemann/solvers.py
// operation by operation (build with --fmad=false to keep it that way).
//
// What bounds it: per cell and direction, PPM costs ~100 floating-point
// operations per variable (9 variables) and HLLD a few hundred per face,
// against 9 values read and 9 written (18 more read-modify-written for the
// accumulating y/z launches).  That is ~50-100 operations per byte, above
// the card's FP32 and FP64 ridge points, so the arithmetic pipes, not HBM,
// bound the kernel; reconstructing in shared memory keeps the stencil
// re-reads off device memory (each tile reads its T+2h cells once).
//
// Design (simple first): a block covers TS cells along the sweep axis times
// TL lanes (x for the y/z sweeps, so loads coalesce; y for the x sweep,
// where the sweep axis itself is contiguous).  It loads TS+2h cells of all
// 9 variables into shared memory (h = 1, 2, 3 for DC, PLM, PPM), computes
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

namespace {

constexpr int NV = 9;            // rho, v1, v2, v3, p, B1, B2, B3, psi
constexpr int IDN = 0, IPR = 4, IPS = 8;
constexpr int TS = 15;           // cells per tile along the sweep axis
constexpr int TL = 16;           // lanes per tile
constexpr int NTHREADS = 256;    // == (TS + 1) * TL: one thread per face
static_assert((TS + 1) * TL == NTHREADS, "one thread per face");

enum { RECON_DC = 0, RECON_PLM = 1, RECON_PPM = 2 };

template <int RECON>
struct Halo { static constexpr int h = RECON == RECON_DC ? 1 : (RECON == RECON_PLM ? 2 : 3); };

template <typename T>
struct Params {
  T dx;            // cell width along the sweep axis
  T gamma;         // adiabatic index
  T igm1;          // 1 / (gamma - 1), folded on the host as the plain path does
  T half_over_ch;  // 0.5 / c_h
  T half_ch;       // 0.5 * c_h
  T ch2;           // c_h * c_h
};

struct Geom {
  int n_sweep;          // extent of the sweep axis within a block
  int n_lane;           // extent of the lane axis
  long long s_sweep;    // element strides
  long long s_lane;
  long long s_other;    // third axis (extent = gridDim.y)
  long long s_var;
  long long s_block;
};

template <typename T>
__device__ __forceinline__ T sgn(T x) { return x >= T(0) ? T(1) : T(-1); }

// ------------------------------------------------------------------ recon
template <typename T>
__device__ __forceinline__ void plm_edges(T qm1, T q, T qp1, T& qm, T& qp) {
  T dql = q - qm1;
  T dqr = qp1 - q;
  T dq2 = dql * dqr;
  T denom = dq2 > T(0) ? dql + dqr : T(1);
  T dqm = dq2 > T(0) ? dq2 / denom : T(0);
  qm = q - dqm;
  qp = q + dqm;
}

// PPM with the Colella-Sekora 2008 limiter; recon/schemes.py:ppm.
template <typename T>
__device__ __forceinline__ void ppm_edges(T qm2, T qm1, T q, T qp1, T qp2,
                                          T& qm_out, T& qp_out) {
  const T C2 = T(1.25);
  T qa0 = q - qm1;
  T qb0 = qp1 - q;
  T dd_im1 = T(0.5) * qa0 + T(0.5) * (qm1 - qm2);
  T dd = T(0.5) * qb0 + T(0.5) * qa0;
  T dd_ip1 = T(0.5) * (qp2 - qp1) + T(0.5) * qb0;

  T dph = T(0.5) * (qm1 + q) + (dd_im1 - dd) / T(6);
  T dph_ip1 = T(0.5) * (q + qp1) + (dd - dd_ip1) / T(6);

  T d2qc_im1 = qm2 + q - T(2) * qm1;
  T d2qc = qm1 + qp1 - T(2) * q;
  T d2qc_ip1 = q + qp2 - T(2) * qp1;

  {  // limit the i-1/2 face value at local extrema
    T qa_t = dph - qm1;
    T qb_t = q - dph;
    T qa = T(3) * (qm1 + q - T(2) * dph);
    T qb = d2qc_im1;
    T qc = d2qc;
    bool same = (sgn(qa) == sgn(qb)) && (sgn(qa) == sgn(qc));
    T qd = same ? sgn(qa) * fmin(C2 * fabs(qb), fmin(C2 * fabs(qc), fabs(qa)))
                : T(0);
    if (qa_t * qb_t < T(0)) dph = T(0.5) * (qm1 + q) - qd / T(6);
  }
  {  // limit the i+1/2 face value
    T qa_t = dph_ip1 - q;
    T qb_t = qp1 - dph_ip1;
    T qa = T(3) * (q + qp1 - T(2) * dph_ip1);
    T qb = d2qc;
    T qc = d2qc_ip1;
    bool same = (sgn(qa) == sgn(qb)) && (sgn(qa) == sgn(qc));
    T qd = same ? sgn(qa) * fmin(C2 * fabs(qb), fmin(C2 * fabs(qc), fabs(qa)))
                : T(0);
    if (qa_t * qb_t < T(0)) dph_ip1 = T(0.5) * (q + qp1) - qd / T(6);
  }

  T d2qf = T(6) * (dph + dph_ip1 - T(2) * q);
  T qm = dph;
  T qp = dph_ip1;
  T dqf_minus = q - qm;
  T dqf_plus = qp - q;
  bool extrema = (dqf_minus * dqf_plus <= T(0)) || ((qp1 - q) * (q - qm1) <= T(0));

  T qe;
  {
    T qa = d2qc_im1, qb = d2qc, qc = d2qc_ip1, qd = d2qf;
    bool same = (sgn(qa) == sgn(qb)) && (sgn(qa) == sgn(qc)) && (sgn(qa) == sgn(qd));
    qe = same ? sgn(qd) * fmin(fmin(C2 * fabs(qa), C2 * fabs(qb)),
                               fmin(C2 * fabs(qc), fabs(qd)))
              : T(0);
  }
  T mag_m = fmax(fabs(qm1), fabs(qm2));
  T mag_p = fmax(fmax(fabs(q), fabs(qp1)), fabs(qp2));
  bool big = fabs(d2qf) > T(1.0e-12) * fmax(mag_m, mag_p);
  T rho = big ? qe / d2qf : T(0);

  T tmp_m = q - rho * dqf_minus;
  T tmp_p = q + rho * dqf_plus;
  T tmp2_m = q - T(2) * dqf_plus;
  T tmp2_p = q + T(2) * dqf_minus;

  bool limit_sm = rho <= (T(1) - T(1.0e-12));
  if (extrema && limit_sm) { qm = tmp_m; qp = tmp_p; }
  bool over_m = fabs(dqf_minus) >= T(2) * fabs(dqf_plus);
  bool over_p = fabs(dqf_plus) >= T(2) * fabs(dqf_minus);
  if (!extrema && over_m) qm = tmp2_m;
  if (!extrema && over_p) qp = tmp2_p;
  qm_out = qm;
  qp_out = qp;
}

// ---------------------------------------------------------------- Riemann
template <typename T>
__device__ __forceinline__ T fast_speed(T gamma, T rho, T p, T bx, T by, T bz) {
  T asq = gamma * p;
  T ct2 = by * by + bz * bz;
  T qsq = bx * bx + ct2 + asq;
  T tmp = bx * bx + ct2 - asq;
  return sqrt(T(0.5) * (qsq + sqrt(tmp * tmp + T(4) * asq * ct2)) / rho);
}

// GLM-HLLD (Miyoshi & Kusano 2005) for direction DIR; riemann/solvers.py:
// _glm_hlld, the same branch-free lattice per face.
template <typename T, int DIR>
__device__ __forceinline__ void glm_hlld(const T* wl, const T* wr,
                                         const Params<T>& p, T* F) {
  constexpr int IVX = 1 + (DIR - 1), IVY = 1 + DIR % 3, IVZ = 1 + (DIR + 1) % 3;
  constexpr int IBX = IVX + 4, IBY = IVY + 4, IBZ = IVZ + 4;
  const T SMALL = T(1.0e-4);

  const T dl = wl[IDN], vxl = wl[IVX], vyl = wl[IVY], vzl = wl[IVZ], pl = wl[IPR];
  const T bxl = wl[IBX], byl = wl[IBY], bzl = wl[IBZ], psil = wl[IPS];
  const T dr = wr[IDN], vxr = wr[IVX], vyr = wr[IVY], vzr = wr[IVZ], pr = wr[IPR];
  const T bxr = wr[IBX], byr = wr[IBY], bzr = wr[IBZ], psir = wr[IPS];

  // GLM 2x2 subsystem solved exactly (Dedner et al. 2002)
  const T bxi = T(0.5) * (bxl + bxr) - p.half_over_ch * (psir - psil);
  const T psii = T(0.5) * (psil + psir) - p.half_ch * (bxr - bxl);

  const T bxsq = bxi * bxi;
  const T pbl = T(0.5) * (bxsq + byl * byl + bzl * bzl);
  const T pbr = T(0.5) * (bxsq + byr * byr + bzr * bzr);
  const T kel = T(0.5) * dl * (vxl * vxl + vyl * vyl + vzl * vzl);
  const T ker = T(0.5) * dr * (vxr * vxr + vyr * vyr + vzr * vzr);

  // conserved L/R states
  const T ul_mx = vxl * dl, ul_my = vyl * dl, ul_mz = vzl * dl;
  const T ul_e = pl * p.igm1 + kel + pbl;
  const T ur_mx = vxr * dr, ur_my = vyr * dr, ur_mz = vzr * dr;
  const T ur_e = pr * p.igm1 + ker + pbr;

  const T cfl = fast_speed(p.gamma, dl, pl, bxl, byl, bzl);
  const T cfr = fast_speed(p.gamma, dr, pr, bxr, byr, bzr);
  const T spd0 = fmin(vxl - cfl, vxr - cfr);
  const T spd4 = fmax(vxl + cfl, vxr + cfr);

  const T ptl = pl + pbl;
  const T ptr = pr + pbr;

  const T fl[7] = {ul_mx,
                   ul_mx * vxl + ptl - bxsq,
                   ul_my * vxl - bxi * byl,
                   ul_mz * vxl - bxi * bzl,
                   vxl * (ul_e + ptl - bxsq) - bxi * (vyl * byl + vzl * bzl),
                   byl * vxl - bxi * vyl,
                   bzl * vxl - bxi * vzl};
  const T fr[7] = {ur_mx,
                   ur_mx * vxr + ptr - bxsq,
                   ur_my * vxr - bxi * byr,
                   ur_mz * vxr - bxi * bzr,
                   vxr * (ur_e + ptr - bxsq) - bxi * (vyr * byr + vzr * bzr),
                   byr * vxr - bxi * vyr,
                   bzr * vxr - bxi * vzr};

  const T sdl = spd0 - vxl;
  const T sdr = spd4 - vxr;
  const T spd2 = (sdr * ur_mx - sdl * ul_mx + (ptl - ptr)) / (sdr * dr - sdl * dl);
  const T sdml = spd0 - spd2;
  const T sdmr = spd4 - spd2;
  const T sdml_inv = T(1) / sdml;
  const T sdmr_inv = T(1) / sdmr;

  const T ulst_d = dl * sdl * sdml_inv;
  const T urst_d = dr * sdr * sdmr_inv;
  const T ulst_d_inv = T(1) / ulst_d;
  const T urst_d_inv = T(1) / urst_d;
  const T sqrtdl = sqrt(ulst_d);
  const T sqrtdr = sqrt(urst_d);
  const T spd1 = spd2 - fabs(bxi) / sqrtdl;
  const T spd3 = spd2 + fabs(bxi) / sqrtdr;

  const T ptstl = ptl + dl * sdl * (spd2 - vxl);
  const T ptstr = ptr + dr * sdr * (spd2 - vxr);
  const T ptst = T(0.5) * (ptstr + ptstl);

  // star states: {d, mx, my, mz, e, by, bz}
  T ulst[7], urst[7], vbstl, vbstr;
  {
    const T denom = dl * sdl * sdml - bxsq;
    const bool degen = fabs(denom) < SMALL * ptst;
    const T safe = degen ? T(1) : denom;
    const T tmp = bxi * (sdl - sdml) / safe;
    const T my = degen ? ulst_d * vyl : ulst_d * (vyl - byl * tmp);
    const T mz = degen ? ulst_d * vzl : ulst_d * (vzl - bzl * tmp);
    const T tmp2 = (dl * sdl * sdl - bxsq) / safe;
    const T by = degen ? byl : byl * tmp2;
    const T bz = degen ? bzl : bzl * tmp2;
    const T mx = ulst_d * spd2;
    vbstl = (mx * bxi + my * by + mz * bz) / ulst_d;
    const T e = (sdl * ul_e - ptl * vxl + ptst * spd2
                 + bxi * (vxl * bxi + vyl * byl + vzl * bzl - vbstl)) * sdml_inv;
    ulst[0] = ulst_d; ulst[1] = mx; ulst[2] = my; ulst[3] = mz;
    ulst[4] = e; ulst[5] = by; ulst[6] = bz;
  }
  {
    const T denom = dr * sdr * sdmr - bxsq;
    const bool degen = fabs(denom) < SMALL * ptst;
    const T safe = degen ? T(1) : denom;
    const T tmp = bxi * (sdr - sdmr) / safe;
    const T my = degen ? urst_d * vyr : urst_d * (vyr - byr * tmp);
    const T mz = degen ? urst_d * vzr : urst_d * (vzr - bzr * tmp);
    const T tmp2 = (dr * sdr * sdr - bxsq) / safe;
    const T by = degen ? byr : byr * tmp2;
    const T bz = degen ? bzr : bzr * tmp2;
    const T mx = urst_d * spd2;
    vbstr = (mx * bxi + my * by + mz * bz) / urst_d;
    const T e = (sdr * ur_e - ptr * vxr + ptst * spd2
                 + bxi * (vxr * bxi + vyr * byr + vzr * bzr - vbstr)) * sdmr_inv;
    urst[0] = urst_d; urst[1] = mx; urst[2] = my; urst[3] = mz;
    urst[4] = e; urst[5] = by; urst[6] = bz;
  }

  // double-star states (Alfven-rotated)
  const bool weak_b = T(0.5) * bxsq < SMALL * ptst;
  const T invsumd = T(1) / (sqrtdl + sqrtdr);
  const T bxsig = bxi > T(0) ? T(1) : T(-1);
  const T vy_dst = invsumd * (sqrtdl * (ulst[2] * ulst_d_inv) +
                              sqrtdr * (urst[2] * urst_d_inv) +
                              bxsig * (urst[5] - ulst[5]));
  const T vz_dst = invsumd * (sqrtdl * (ulst[3] * ulst_d_inv) +
                              sqrtdr * (urst[3] * urst_d_inv) +
                              bxsig * (urst[6] - ulst[6]));
  const T by_dst = invsumd * (sqrtdl * urst[5] + sqrtdr * ulst[5] +
                              bxsig * sqrtdl * sqrtdr *
                                  ((urst[2] * urst_d_inv) - (ulst[2] * ulst_d_inv)));
  const T bz_dst = invsumd * (sqrtdl * urst[6] + sqrtdr * ulst[6] +
                              bxsig * sqrtdl * sqrtdr *
                                  ((urst[3] * urst_d_inv) - (ulst[3] * ulst_d_inv)));
  const T vb_dst = spd2 * bxi + vy_dst * by_dst + vz_dst * bz_dst;

  const T uldst[7] = {
      ulst[0], ulst[1],
      weak_b ? ulst[2] : ulst[0] * vy_dst,
      weak_b ? ulst[3] : ulst[0] * vz_dst,
      weak_b ? ulst[4] : ulst[4] - sqrtdl * bxsig * (vbstl - vb_dst),
      weak_b ? ulst[5] : by_dst,
      weak_b ? ulst[6] : bz_dst};
  const T urdst[7] = {
      urst[0], urst[1],
      weak_b ? urst[2] : urst[0] * vy_dst,
      weak_b ? urst[3] : urst[0] * vz_dst,
      weak_b ? urst[4] : urst[4] + sqrtdr * bxsig * (vbstr - vb_dst),
      weak_b ? urst[5] : by_dst,
      weak_b ? urst[6] : bz_dst};
  const T ul[7] = {dl, ul_mx, ul_my, ul_mz, ul_e, byl, bzl};
  const T ur[7] = {dr, ur_mx, ur_my, ur_mz, ur_e, byr, bzr};

  T f7[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const T d_uldst = spd1 * (uldst[k] - ulst[k]);
    const T d_ulst = spd0 * (ulst[k] - ul[k]);
    const T d_urdst = spd3 * (urdst[k] - urst[k]);
    const T d_urst = spd4 * (urst[k] - ur[k]);
    f7[k] = spd0 >= T(0) ? fl[k]
          : spd4 <= T(0) ? fr[k]
          : spd1 >= T(0) ? fl[k] + d_ulst
          : spd2 >= T(0) ? fl[k] + d_ulst + d_uldst
          : spd3 > T(0)  ? fr[k] + d_urst + d_urdst
                         : fr[k] + d_urst;
  }
  F[IDN] = f7[0];
  F[IVX] = f7[1];
  F[IVY] = f7[2];
  F[IVZ] = f7[3];
  F[IPR] = f7[4];   // energy shares slot 4 with pressure
  F[IBY] = f7[5];
  F[IBZ] = f7[6];
  F[IBX] = psii;
  F[IPS] = p.ch2 * bxi;
}

// ----------------------------------------------------------------- kernel
template <int RECON>
constexpr int smem_elems() {
  constexpr int H = Halo<RECON>::h;
  constexpr int cells = NV * (TS + 2 * H) * TL;
  constexpr int edges = 2 * NV * (TS + 2) * TL;
  constexpr int flux = NV * (TS + 1) * TL;
  // DC keeps its fluxes after the cells; PLM/PPM reuse the cell buffer
  return RECON == RECON_DC ? cells + flux : cells + edges;
}

template <typename T, int RECON, int DIR>
__global__ void __launch_bounds__(NTHREADS)
negdiv_sweep_kernel(const T* __restrict__ prim, T* __restrict__ out,
                    const Geom g, const Params<T> p, const int accumulate) {
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
        const T* col = cell + v * NC * TL + l;
        const int cc = c + H - 1;
        T qm, qp;
        if (RECON == RECON_PPM)
          ppm_edges(col[(cc - 2) * TL], col[(cc - 1) * TL], col[cc * TL],
                    col[(cc + 1) * TL], col[(cc + 2) * TL], qm, qp);
        else
          plm_edges(col[(cc - 1) * TL], col[cc * TL], col[(cc + 1) * TL], qm, qp);
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
      glm_hlld<T, DIR>(wl, wr, p, F);
#pragma unroll
      for (int v = 0; v < NV; ++v) flux[(v * NF + j) * TL + l] = F[v];
    }
  }
  __syncthreads();

  // 4. -(F[i+1] - F[i]) / dx, written or accumulated
  for (int i = threadIdx.x; i < NV * TS * TL; i += NTHREADS) {
    int v, s, l;
    if (SWEEP_CONTIG) { s = i % TS; l = (i / TS) % TL; }
    else              { l = i % TL; s = (i / TL) % TS; }
    v = i / (TS * TL);
    if (l < nl && s < ns) {
      const T r = -(flux[(v * NF + s + 1) * TL + l] - flux[(v * NF + s) * TL + l]) / p.dx;
      const long long o = base + v * g.s_var + (s0 + s) * g.s_sweep + l * g.s_lane;
      out[o] = accumulate ? out[o] + r : r;
    }
  }
}

template <typename T, int RECON, int DIR>
cudaError_t launch(const T* prim, T* out, int nb, int nz, int ny, int nx,
                   const Params<T>& p, int accumulate, cudaStream_t stream) {
  Geom g;
  g.s_var = (long long)nz * ny * nx;
  g.s_block = NV * g.s_var;
  int n_other;
  if (DIR == 1) {         // sweep x, lanes y, other z
    g.n_sweep = nx; g.s_sweep = 1;
    g.n_lane = ny;  g.s_lane = nx;
    n_other = nz;   g.s_other = (long long)ny * nx;
  } else if (DIR == 2) {  // sweep y, lanes x, other z
    g.n_sweep = ny; g.s_sweep = nx;
    g.n_lane = nx;  g.s_lane = 1;
    n_other = nz;   g.s_other = (long long)ny * nx;
  } else {                // sweep z, lanes x, other y
    g.n_sweep = nz; g.s_sweep = (long long)ny * nx;
    g.n_lane = nx;  g.s_lane = 1;
    n_other = ny;   g.s_other = nx;
  }
  const int ntile_s = (g.n_sweep + TS - 1) / TS;
  const int ntile_l = (g.n_lane + TL - 1) / TL;
  const size_t smem = sizeof(T) * smem_elems<RECON>();
  auto kernel = negdiv_sweep_kernel<T, RECON, DIR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(ntile_s * ntile_l, n_other, nb);
  kernel<<<grid, NTHREADS, smem, stream>>>(prim, out, g, p, accumulate);
  return cudaGetLastError();
}

template <typename T, int RECON>
cudaError_t launch_dir(int dir, const void* prim, void* out, int nb, int nz,
                       int ny, int nx, const Params<T>& p, int accumulate,
                       cudaStream_t s) {
  const T* in = static_cast<const T*>(prim);
  T* o = static_cast<T*>(out);
  switch (dir) {
    case 1: return launch<T, RECON, 1>(in, o, nb, nz, ny, nx, p, accumulate, s);
    case 2: return launch<T, RECON, 2>(in, o, nb, nz, ny, nx, p, accumulate, s);
    case 3: return launch<T, RECON, 3>(in, o, nb, nz, ny, nx, p, accumulate, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_typed(int recon, int dir, const void* prim, void* out,
                         int nb, int nz, int ny, int nx, double dx,
                         double gamma, double igm1, double c_h,
                         int accumulate, cudaStream_t s) {
  // scalar constants are folded in double, then rounded to T, exactly as
  // the plain path's Python-float scalars are
  Params<T> p;
  p.dx = T(dx);
  p.gamma = T(gamma);
  p.igm1 = T(igm1);
  p.half_over_ch = T(0.5 / c_h);
  p.half_ch = T(0.5 * c_h);
  p.ch2 = T(c_h * c_h);
  switch (recon) {
    case RECON_DC:  return launch_dir<T, RECON_DC>(dir, prim, out, nb, nz, ny, nx, p, accumulate, s);
    case RECON_PLM: return launch_dir<T, RECON_PLM>(dir, prim, out, nb, nz, ny, nx, p, accumulate, s);
    case RECON_PPM: return launch_dir<T, RECON_PPM>(dir, prim, out, nb, nz, ny, nx, p, accumulate, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  recon: 0 = dc, 1 = plm, 2 = ppm.
// dir: 1, 2, 3.  prim and out: contiguous [nb, 9, nz, ny, nx] on the
// current device.  accumulate != 0 adds into out instead of writing it.
extern "C" int negdiv_sweep(const void* prim, void* out, int dtype, int recon,
                            int dir, int nb, int nvar, int nz, int ny, int nx,
                            double dx, double gamma, double igm1, double c_h,
                            int accumulate, void* stream) {
  if (nvar != NV || nb <= 0 || nz <= 0 || ny <= 0 || nx <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_typed<float>(recon, dir, prim, out, nb, nz, ny, nx, dx, gamma,
                              igm1, c_h, accumulate, s);
  else if (dtype == 1)
    err = launch_typed<double>(recon, dir, prim, out, nb, nz, ny, nx, dx, gamma,
                               igm1, c_h, accumulate, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
