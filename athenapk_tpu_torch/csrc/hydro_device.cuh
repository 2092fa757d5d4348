// Device functions shared by the Hopper kernels of this package
// (negdiv_sweep.cu and fused_stage.cu): reconstruction, the Riemann solvers
// and cons_to_prim.
//
// Every function is the scalar transcription, operation by operation, of
// its plain PyTorch version: recon/schemes.py (plm, ppm, weno3, limo3,
// wenoz), riemann/solvers.py (_euler_llf, _euler_hlle, _euler_hllc,
// _glm_llf, _glm_hlle, _glm_hlld) and eos/adiabatic.py (cons_to_prim).
// `x ** 2` is x * x on the card, as PyTorch computes it.  Scalar constants that the plain code
// folds as Python floats are folded in double on the host (make_params) and
// rounded to T once.  A division of a tensor by a Python scalar is, on the
// card, PyTorch's multiplication by the scalar's reciprocal computed in T
// (x / 6.0 is x * (1/6)), and a Python scalar divided by a tensor is
// reciprocal(tensor) * scalar on any device: the kernels do the same, with
// the reciprocals folded on the host in T (make_params, the launchers) or
// at compile time.  Built with --fmad=false, so that no multiply-add is
// contracted, the kernels give the plain version's numbers bit for bit on
// the card (contracted, f32 fails chip_smoke.py's 1e-4 gate and f64 its
// 1e-10 one: PERF.md).

#pragma once

#include <cuda_runtime.h>

#include <cfloat>

namespace hydro {

constexpr int IDN = 0, IPR = 4, IEN = 4, IPS = 8;

enum { RECON_DC = 0, RECON_PLM = 1, RECON_PPM = 2, RECON_WENO3 = 3,
       RECON_LIMO3 = 4, RECON_WENOZ = 5 };
// (fluid, Riemann solver) pairs the kernels take
enum { SOLVER_EULER_HLLE = 0, SOLVER_EULER_HLLC = 1, SOLVER_GLMMHD_HLLD = 2,
       SOLVER_EULER_LLF = 3, SOLVER_GLMMHD_LLF = 4, SOLVER_GLMMHD_HLLE = 5 };

__host__ __device__ constexpr bool is_glmmhd(int solver) {
  return solver == SOLVER_GLMMHD_HLLD || solver == SOLVER_GLMMHD_LLF
         || solver == SOLVER_GLMMHD_HLLE;
}

// variables per cell: rho, v1, v2, v3, p (Euler) + B1, B2, B3, psi (GLM-MHD)
template <int SOLVER>
struct NVar { static constexpr int value = is_glmmhd(SOLVER) ? 9 : 5; };

// cells of stencil on each side of a face (DC 1; PLM, WENO3, LimO3 2; PPM,
// WENO-Z 3: recon/schemes.py _NGHOST)
template <int RECON>
struct Halo {
  static constexpr int h = RECON == RECON_DC ? 1
      : (RECON == RECON_PPM || RECON == RECON_WENOZ) ? 3 : 2;
};

// Per-direction constants of the reconstructions, from the wrapper's
// doubles as the plain code's Python floats are: WENO3's dx^2 (added to a
// tensor: rounded to T) and LimO3's (0.1 dx)^2 (a tensor divided by it: a
// multiplication by its reciprocal in T).
template <typename T>
struct ReconK {
  T dx2;
  T inv_rdx2;
};

template <typename T>
inline ReconK<T> make_recon_k(double dx2, double rdx2) {
  ReconK<T> k;
  k.dx2 = T(dx2);
  k.inv_rdx2 = T(1) / T(rdx2);
  return k;
}

template <typename T>
struct Params {
  T gamma;         // adiabatic index
  T gm1;           // gamma - 1
  T gm1_minus_1;   // (gamma - 1) - 1, folded in double (a Python float)
  T igm1;          // 1 / (gamma - 1), folded in double (a Python float)
  T inv_gm1;       // T(1) / T(gamma - 1): what `x / gm1` multiplies by
  T hllc_coef;     // (gamma + 1) / (2 gamma)
  T half_over_ch;  // 0.5 / c_h
  T half_ch;       // 0.5 * c_h
  T ch2;           // c_h * c_h
  // cons_to_prim floors and ceilings (eos/adiabatic.py); has_* says whether
  // each one is enabled (a floor <= 0 and an infinite ceiling are off)
  T dfloor, pfloor, pfloor_over_gm1, efloor, vceil, vceil2, eceil;
  bool has_dfloor, has_pfloor, has_efloor, has_vceil, has_eceil;
};

// The EOS scalars as the wrapper passes them: gamma, density, pressure and
// internal-energy floors, velocity and internal-energy ceilings (infinite
// when off).
struct EosArgs {
  double gamma, dfloor, pfloor, efloor, vceil, eceil;
};
constexpr double NO_CEILING = 1.0e308;   // any ceiling >= 1e300 is off

template <typename T>
inline Params<T> make_params(const EosArgs& e, double c_h) {
  Params<T> p;
  const double gm1 = e.gamma - 1.0;
  p.gamma = T(e.gamma);
  p.gm1 = T(gm1);
  p.gm1_minus_1 = T(gm1 - 1.0);
  p.igm1 = T(1.0 / gm1);
  p.inv_gm1 = T(1) / T(gm1);
  p.hllc_coef = T((e.gamma + 1.0) / (2.0 * e.gamma));
  p.half_over_ch = T(0.5 / c_h);
  p.half_ch = T(0.5 * c_h);
  p.ch2 = T(c_h * c_h);
  p.has_dfloor = e.dfloor > 0.0;
  p.has_pfloor = e.pfloor > 0.0;
  p.has_efloor = e.efloor > 0.0;
  p.has_vceil = e.vceil < 1.0e300;
  p.has_eceil = e.eceil < 1.0e300;
  p.dfloor = T(e.dfloor);
  p.pfloor = T(e.pfloor);
  p.pfloor_over_gm1 = T(e.pfloor / gm1);
  p.efloor = T(e.efloor);
  p.vceil = p.has_vceil ? T(e.vceil) : T(0);
  p.vceil2 = p.has_vceil ? T(e.vceil * e.vceil) : T(0);
  p.eceil = p.has_eceil ? T(e.eceil) : T(0);
  return p;
}

template <typename T>
__device__ __forceinline__ T sgn(T x) { return x >= T(0) ? T(1) : T(-1); }

// minimum and maximum that pass a NaN operand on, as torch.minimum and
// torch.maximum do (fmin and fmax drop it): a reconstructed edge state with
// negative pressure gives NaN wave speeds, and the solvers' selects must
// then take the same side as the plain version's
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) { return (b < a || b != b) ? b : a; }
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) { return (b > a || b != b) ? b : a; }

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
  const T SIXTH = T(1) / T(6);   // x / 6.0 on the card
  T qa0 = q - qm1;
  T qb0 = qp1 - q;
  T dd_im1 = T(0.5) * qa0 + T(0.5) * (qm1 - qm2);
  T dd = T(0.5) * qb0 + T(0.5) * qa0;
  T dd_ip1 = T(0.5) * (qp2 - qp1) + T(0.5) * qb0;

  T dph = T(0.5) * (qm1 + q) + (dd_im1 - dd) * SIXTH;
  T dph_ip1 = T(0.5) * (q + qp1) + (dd - dd_ip1) * SIXTH;

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
    if (qa_t * qb_t < T(0)) dph = T(0.5) * (qm1 + q) - qd * SIXTH;
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
    if (qa_t * qb_t < T(0)) dph_ip1 = T(0.5) * (q + qp1) - qd * SIXTH;
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

// WENO3 with the Yamaleev-Carpenter indicators; recon/schemes.py:weno3.
template <typename T>
__device__ __forceinline__ void weno3_edges(T qm1, T q, T qp1, T dx2,
                                            T& qm, T& qp) {
  const T THIRD = T(1) / T(3);          // x / 3.0 on the card
  const T TWO_THIRDS = T(2.0 / 3.0);    // a Python float
  const T d0 = qp1 - q;
  const T d1 = q - qm1;
  const T beta0 = d0 * d0;
  const T beta1 = d1 * d1;
  const T t = qp1 - T(2) * q + qm1;
  const T tau = t * t;
  const T ind0 = tau / (beta0 + dx2);
  const T ind1 = tau / (beta1 + dx2);
  {
    const T f0 = q + qp1;
    const T f1 = -qm1 + T(3) * q;
    const T a0 = (T(1) + ind0) * TWO_THIRDS;
    const T a1 = (T(1) + ind1) * THIRD;
    qp = (a0 * f0 + a1 * f1) / (T(2) * (a0 + a1));
  }
  {
    const T f0 = q + qm1;
    const T f1 = -qp1 + T(3) * q;
    const T a0 = (T(1) + ind1) * TWO_THIRDS;
    const T a1 = (T(1) + ind0) * THIRD;
    qm = (a0 * f0 + a1 * f1) / (T(2) * (a0 + a1));
  }
}

// LimO3's limiter with its asymptotic-region switch; recon/schemes.py:
// _limo3_phi.  The switch half-width is 10 eps of T (limo3_eps); a tensor
// divided by it is a multiplication by its reciprocal on the card.
template <typename T>
__device__ __forceinline__ T limo3_phi(T dvp, T dvm, T inv_rdx2) {
  const T EPS = T(10) * (sizeof(T) == 8 ? T(DBL_EPSILON) : T(FLT_EPSILON));
  const T INV_EPS = T(1) / EPS;
  const T THIRD = T(1) / T(3);
  const T theta = dvm / (dvp + T(1.0e-20));
  const T qq = (T(2) + theta) * THIRD;
  const T qq_cap = qq > T(1.6) ? T(1.6) : qq;   // clamp(max=1.6): keeps NaN
  const T inner = nan_min(qq, nan_max(T(-0.5) * theta,
                                      nan_min(T(2) * theta, qq_cap)));
  const T phi = inner < T(0) ? T(0) : inner;    // clamp(min=0): keeps NaN
  const T eta = (dvm * dvm + dvp * dvp) * inv_rdx2;
  const T x = (eta - T(1)) * INV_EPS;
  const T blend = T(0.5) * ((T(1) - x) * qq + (T(1) + x) * phi);
  return eta <= T(1) - EPS ? qq : (eta >= T(1) + EPS ? phi : blend);
}

// LimO3; recon/schemes.py:limo3.  `positive`: a field of the positivity
// mask (density, pressure), whose edges fall back to minmod where either
// goes non-positive.
template <typename T>
__device__ __forceinline__ void limo3_edges(T qm1, T q, T qp1, T inv_rdx2,
                                            bool positive, T& qm, T& qp) {
  const T dqp = qp1 - q;
  const T dqm = q - qm1;
  qp = q + T(0.5) * dqp * limo3_phi(dqp, dqm, inv_rdx2);
  qm = q - T(0.5) * dqm * limo3_phi(dqm, dqp, inv_rdx2);
  if (positive && (qp <= T(0) || qm <= T(0))) {
    const T dqmm = dqp * dqm > T(0) ? (fabs(dqp) < fabs(dqm) ? dqp : dqm)
                                    : T(0);
    qp = q + T(0.5) * dqmm;
    qm = q - T(0.5) * dqmm;
  }
}

// WENO-Z+; recon/schemes.py:wenoz, with its epsL (wenoz_eps).
template <typename T>
__device__ __forceinline__ void wenoz_edges(T qm2, T qm1, T q, T qp1, T qp2,
                                            T& qm, T& qp) {
  const T B_HI = T(13.0 / 12.0);
  const T B_LO = T(0.25);
  const T EPSL = sizeof(T) == 8 ? T(1.0e-30) : T(1.0e-18);
  T a, b;
  a = qm2 + q - T(2) * qm1;
  b = qm2 + T(3) * q - T(4) * qm1;
  const T beta0 = B_HI * (a * a) + B_LO * (b * b);
  a = qm1 + qp1 - T(2) * q;
  b = qm1 - qp1;
  const T beta1 = B_HI * (a * a) + B_LO * (b * b);
  a = qp2 + q - T(2) * qp1;
  b = qp2 + T(3) * q - T(4) * qp1;
  const T beta2 = B_HI * (a * a) + B_LO * (b * b);
  const T tau5 = fabs(beta0 - beta2);
  const T ind0 = tau5 / (beta0 + EPSL);
  const T ind1 = tau5 / (beta1 + EPSL);
  const T ind2 = tau5 / (beta2 + EPSL);
  {
    const T f0 = T(2) * qm2 - T(7) * qm1 + T(11) * q;
    const T f1 = -qm1 + T(5) * q + T(2) * qp1;
    const T f2 = T(2) * q + T(5) * qp1 - qp2;
    const T a0 = T(0.1) * (T(1) + ind0 * ind0);
    const T a1 = T(0.6) * (T(1) + ind1 * ind1);
    const T a2 = T(0.3) * (T(1) + ind2 * ind2);
    qp = (f0 * a0 + f1 * a1 + f2 * a2) / (T(6) * (a0 + a1 + a2));
  }
  {
    const T f0 = T(2) * qp2 - T(7) * qp1 + T(11) * q;
    const T f1 = -qp1 + T(5) * q + T(2) * qm1;
    const T f2 = T(2) * q + T(5) * qm1 - qm2;
    const T a0 = T(0.1) * (T(1) + ind2 * ind2);
    const T a1 = T(0.6) * (T(1) + ind1 * ind1);
    const T a2 = T(0.3) * (T(1) + ind0 * ind0);
    qm = (f0 * a0 + f1 * a1 + f2 * a2) / (T(6) * (a0 + a1 + a2));
  }
}

// Edge states (qm, qp) of the cell s[R] from its stencil s[0 .. 2R]
// (R = Halo<RECON>::h - 1 cells on each side along the reconstruction
// axis).  `positive`: the variable is in LimO3's positivity mask.
template <typename T, int RECON>
__device__ __forceinline__ void cell_edges(const T* s, bool positive,
                                           const ReconK<T>& k, T& qm, T& qp) {
  if constexpr (RECON == RECON_PPM)
    ppm_edges(s[0], s[1], s[2], s[3], s[4], qm, qp);
  else if constexpr (RECON == RECON_WENOZ)
    wenoz_edges(s[0], s[1], s[2], s[3], s[4], qm, qp);
  else if constexpr (RECON == RECON_PLM)
    plm_edges(s[0], s[1], s[2], qm, qp);
  else if constexpr (RECON == RECON_WENO3)
    weno3_edges(s[0], s[1], s[2], k.dx2, qm, qp);
  else if constexpr (RECON == RECON_LIMO3)
    limo3_edges(s[0], s[1], s[2], k.inv_rdx2, positive, qm, qp);
  else
    qm = qp = s[0];
}

// Whether variable v is in LimO3's positivity mask (density, pressure).
__host__ __device__ constexpr bool positive_var(int v) {
  return v == IDN || v == IPR;
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

// L/R face states of the Euler solvers (riemann/solvers.py:_euler_faces)
// and the HLL-type flux of one side.
template <typename T>
struct EulerSide {
  T d, vx, vy, vz, p, e;
};

template <typename T, int DIR>
__device__ __forceinline__ EulerSide<T> euler_side(const T* w, const Params<T>& p) {
  constexpr int IVX = 1 + (DIR - 1), IVY = 1 + DIR % 3, IVZ = 1 + (DIR + 1) % 3;
  EulerSide<T> s;
  s.d = w[IDN]; s.vx = w[IVX]; s.vy = w[IVY]; s.vz = w[IVZ]; s.p = w[IPR];
  s.e = s.p * p.inv_gm1 + T(0.5) * s.d * (s.vx * s.vx + s.vy * s.vy + s.vz * s.vz);
  return s;
}

template <typename T, int DIR>
__device__ __forceinline__ void euler_store(T fd, T fmx, T fmy, T fmz, T fe, T* F) {
  constexpr int IVX = 1 + (DIR - 1), IVY = 1 + DIR % 3, IVZ = 1 + (DIR + 1) % 3;
  F[IDN] = fd; F[IVX] = fmx; F[IVY] = fmy; F[IVZ] = fmz; F[IEN] = fe;
}

// HLLE with Roe-averaged wave-speed bounds; riemann/solvers.py:_euler_hlle.
template <typename T, int DIR>
__device__ __forceinline__ void euler_hlle(const T* wl, const T* wr,
                                           const Params<T>& p, T* F) {
  const T TINY = T(1.0e-20);
  const EulerSide<T> L = euler_side<T, DIR>(wl, p), R = euler_side<T, DIR>(wr, p);
  const T sqrtdl = sqrt(L.d);
  const T sqrtdr = sqrt(R.d);
  const T isdlpdr = T(1) / (sqrtdl + sqrtdr);
  const T v1roe = (sqrtdl * L.vx + sqrtdr * R.vx) * isdlpdr;
  const T v2roe = (sqrtdl * L.vy + sqrtdr * R.vy) * isdlpdr;
  const T v3roe = (sqrtdl * L.vz + sqrtdr * R.vz) * isdlpdr;
  const T hroe = ((L.e + L.p) / sqrtdl + (R.e + R.p) / sqrtdr) * isdlpdr;
  const T cl = sqrt(p.gamma * L.p / L.d);
  const T cr = sqrt(p.gamma * R.p / R.d);
  const T q = hroe - T(0.5) * (v1roe * v1roe + v2roe * v2roe + v3roe * v3roe);
  const T a = q < T(0) ? T(0) : sqrt(p.gm1 * (q < T(0) ? T(0) : q));
  const T al = nan_min(v1roe - a, L.vx - cl);
  const T ar = nan_max(v1roe + a, R.vx + cr);
  const T bp = ar > T(0) ? ar : TINY;
  const T bm = al < T(0) ? al : TINY;

  const T uxl = L.vx - bm;
  const T uxr = R.vx - bp;
  const T fld = L.d * uxl;
  const T frd = R.d * uxr;
  const T flmx = L.d * L.vx * uxl + L.p;
  const T frmx = R.d * R.vx * uxr + R.p;
  const T flmy = L.d * L.vy * uxl;
  const T frmy = R.d * R.vy * uxr;
  const T flmz = L.d * L.vz * uxl;
  const T frmz = R.d * R.vz * uxr;
  const T fle = L.e * uxl + L.p * L.vx;
  const T fre = R.e * uxr + R.p * R.vx;

  const T tmp = bp != bm ? T(0.5) * (bp + bm) / (bp - bm) : T(0);
  euler_store<T, DIR>(T(0.5) * (fld + frd) + (fld - frd) * tmp,
                      T(0.5) * (flmx + frmx) + (flmx - frmx) * tmp,
                      T(0.5) * (flmy + frmy) + (flmy - frmy) * tmp,
                      T(0.5) * (flmz + frmz) + (flmz - frmz) * tmp,
                      T(0.5) * (fle + fre) + (fle - fre) * tmp, F);
}

// HLLC with the PVRS middle pressure (Toro 10.5.2);
// riemann/solvers.py:_euler_hllc.
template <typename T, int DIR>
__device__ __forceinline__ void euler_hllc(const T* wl, const T* wr,
                                           const Params<T>& p, T* F) {
  const T TINY = T(1.0e-20);
  const EulerSide<T> L = euler_side<T, DIR>(wl, p), R = euler_side<T, DIR>(wr, p);
  const T cl = sqrt(p.gamma * L.p / L.d);
  const T cr = sqrt(p.gamma * R.p / R.d);
  const T rhoa = T(0.5) * (L.d + R.d);
  const T ca = T(0.5) * (cl + cr);
  const T pmid = T(0.5) * (L.p + R.p + (L.vx - R.vx) * rhoa * ca);
  const T ql = pmid <= L.p ? T(1)
                           : sqrt(T(1) + p.hllc_coef * (pmid / L.p - T(1)));
  const T qr = pmid <= R.p ? T(1)
                           : sqrt(T(1) + p.hllc_coef * (pmid / R.p - T(1)));
  const T al = L.vx - cl * ql;
  const T ar = R.vx + cr * qr;
  const T bp = ar > T(0) ? ar : TINY;
  const T bm = al < T(0) ? al : -TINY;

  // contact speed and pressure
  T uxl = L.vx - al;
  T uxr = R.vx - ar;
  const T tl = L.p + uxl * L.d * L.vx;
  const T tr = R.p + uxr * R.d * R.vx;
  const T ml = L.d * uxl;
  const T mr = -(R.d * uxr);
  const T am = (tl - tr) / (ml + mr);
  const T cp_raw = (ml * tr + mr * tl) / (ml + mr);
  const T cp = cp_raw < T(0) ? T(0) : cp_raw;

  uxl = L.vx - bm;
  uxr = R.vx - bp;
  const T fld = L.d * uxl;
  const T frd = R.d * uxr;
  const T flmx = L.d * L.vx * uxl + L.p;
  const T frmx = R.d * R.vx * uxr + R.p;
  const T flmy = L.d * L.vy * uxl;
  const T frmy = R.d * R.vy * uxr;
  const T flmz = L.d * L.vz * uxl;
  const T frmz = R.d * R.vz * uxr;
  const T fle = L.e * uxl + L.p * L.vx;
  const T fre = R.e * uxr + R.p * R.vx;

  const bool pos = am >= T(0);
  const T sl = pos ? am / (am - bm) : T(0);
  const T sr = pos ? T(0) : -am / (bp - am);
  const T sm = pos ? -bm / (am - bm) : bp / (bp - am);

  euler_store<T, DIR>(sl * fld + sr * frd,
                      sl * flmx + sr * frmx + sm * cp,
                      sl * flmy + sr * frmy,
                      sl * flmz + sr * frmz,
                      sl * fle + sr * fre + sm * cp * am, F);
}

// GLM-HLLD (Miyoshi & Kusano 2005) for direction DIR; riemann/solvers.py:
// _glm_hlld.  The plain version computes every wave region's flux at every
// face and selects one (a branch-free lattice); here the face branches on
// its region, in the lattice's order of tests, and computes only what that
// region needs (no star state for the supersonic regions, one side's for
// L* and R*), each value by the lattice's own operations, so the two agree
// bit for bit.  L** and R** share one branch: both need both star states
// and the double-star state.
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
  const T spd0 = nan_min(vxl - cfl, vxr - cfr);
  const T spd4 = nan_max(vxl + cfl, vxr + cfr);

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

  T f7[7];
  if (spd0 >= T(0)) {
#pragma unroll
    for (int k = 0; k < 7; ++k) f7[k] = fl[k];
  } else if (spd4 <= T(0)) {
#pragma unroll
    for (int k = 0; k < 7; ++k) f7[k] = fr[k];
  } else {
    const T sdl = spd0 - vxl;
    const T sdr = spd4 - vxr;
    const T spd2 = (sdr * ur_mx - sdl * ul_mx + (ptl - ptr)) / (sdr * dr - sdl * dl);
    const T sdml = spd0 - spd2;
    const T sdmr = spd4 - spd2;
    const T sdml_inv = T(1) / sdml;
    const T sdmr_inv = T(1) / sdmr;

    const T ulst_d = dl * sdl * sdml_inv;
    const T urst_d = dr * sdr * sdmr_inv;
    const T sqrtdl = sqrt(ulst_d);
    const T sqrtdr = sqrt(urst_d);
    const T spd1 = spd2 - fabs(bxi) / sqrtdl;
    const T spd3 = spd2 + fabs(bxi) / sqrtdr;

    const T ptstl = ptl + dl * sdl * (spd2 - vxl);
    const T ptstr = ptr + dr * sdr * (spd2 - vxr);
    const T ptst = T(0.5) * (ptstr + ptstl);

    // star state {d, mx, my, mz, e, by, bz} of one side, and its v.B
    auto star = [&](T d, T sd, T sdm, T sdm_inv, T st_d, T vx, T vy, T vz,
                    T by0, T bz0, T u_e, T pt, T* st, T& vbst) {
      const T denom = d * sd * sdm - bxsq;
      const bool degen = fabs(denom) < SMALL * ptst;
      const T safe = degen ? T(1) : denom;
      const T tmp = bxi * (sd - sdm) / safe;
      const T my = degen ? st_d * vy : st_d * (vy - by0 * tmp);
      const T mz = degen ? st_d * vz : st_d * (vz - bz0 * tmp);
      const T tmp2 = (d * sd * sd - bxsq) / safe;
      const T by = degen ? by0 : by0 * tmp2;
      const T bz = degen ? bz0 : bz0 * tmp2;
      const T mx = st_d * spd2;
      vbst = (mx * bxi + my * by + mz * bz) / st_d;
      const T e = (sd * u_e - pt * vx + ptst * spd2
                   + bxi * (vx * bxi + vy * by0 + vz * bz0 - vbst)) * sdm_inv;
      st[0] = st_d; st[1] = mx; st[2] = my; st[3] = mz;
      st[4] = e; st[5] = by; st[6] = bz;
    };
    const T ul[7] = {dl, ul_mx, ul_my, ul_mz, ul_e, byl, bzl};
    const T ur[7] = {dr, ur_mx, ur_my, ur_mz, ur_e, byr, bzr};
    T ulst[7], urst[7], vbstl, vbstr;
    if (spd1 >= T(0)) {
      star(dl, sdl, sdml, sdml_inv, ulst_d, vxl, vyl, vzl, byl, bzl, ul_e,
           ptl, ulst, vbstl);
#pragma unroll
      for (int k = 0; k < 7; ++k) f7[k] = fl[k] + spd0 * (ulst[k] - ul[k]);
    } else if (spd2 >= T(0) || spd3 > T(0)) {
      star(dl, sdl, sdml, sdml_inv, ulst_d, vxl, vyl, vzl, byl, bzl, ul_e,
           ptl, ulst, vbstl);
      star(dr, sdr, sdmr, sdmr_inv, urst_d, vxr, vyr, vzr, byr, bzr, ur_e,
           ptr, urst, vbstr);
      const T ulst_d_inv = T(1) / ulst_d;
      const T urst_d_inv = T(1) / urst_d;
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
      if (spd2 >= T(0)) {
#pragma unroll
        for (int k = 0; k < 7; ++k)
          f7[k] = fl[k] + spd0 * (ulst[k] - ul[k]) + spd1 * (uldst[k] - ulst[k]);
      } else {
#pragma unroll
        for (int k = 0; k < 7; ++k)
          f7[k] = fr[k] + spd4 * (urst[k] - ur[k]) + spd3 * (urdst[k] - urst[k]);
      }
    } else {
      star(dr, sdr, sdmr, sdmr_inv, urst_d, vxr, vyr, vzr, byr, bzr, ur_e,
           ptr, urst, vbstr);
#pragma unroll
      for (int k = 0; k < 7; ++k) f7[k] = fr[k] + spd4 * (urst[k] - ur[k]);
    }
  }
  F[IDN] = f7[0];
  F[IVX] = f7[1];
  F[IVY] = f7[2];
  F[IVZ] = f7[3];
  F[IEN] = f7[4];
  F[IBY] = f7[5];
  F[IBZ] = f7[6];
  F[IBX] = psii;
  F[IPS] = p.ch2 * bxi;
}

// Rusanov flux; riemann/solvers.py:_euler_llf.
template <typename T, int DIR>
__device__ __forceinline__ void euler_llf(const T* wl, const T* wr,
                                          const Params<T>& p, T* F) {
  const EulerSide<T> L = euler_side<T, DIR>(wl, p), R = euler_side<T, DIR>(wr, p);
  const T qa = L.d * L.vx;
  const T qb = R.d * R.vx;
  const T fsum_d = qa + qb;
  const T fsum_mx = qa * L.vx + qb * R.vx + (L.p + R.p);
  const T fsum_my = qa * L.vy + qb * R.vy;
  const T fsum_mz = qa * L.vz + qb * R.vz;
  const T fsum_e = (L.e + L.p) * L.vx + (R.e + R.p) * R.vx;
  const T cl = sqrt(p.gamma * L.p / L.d);
  const T cr = sqrt(p.gamma * R.p / R.d);
  const T a = nan_max(fabs(L.vx) + cl, fabs(R.vx) + cr);
  euler_store<T, DIR>(T(0.5) * (fsum_d - a * (R.d - L.d)),
                      T(0.5) * (fsum_mx - a * (R.d * R.vx - L.d * L.vx)),
                      T(0.5) * (fsum_my - a * (R.d * R.vy - L.d * L.vy)),
                      T(0.5) * (fsum_mz - a * (R.d * R.vz - L.d * L.vz)),
                      T(0.5) * (fsum_e - a * (R.e - L.e)), F);
}

// Primitive face state of one side for the GLM-MHD LLF and HLLE solvers
// (riemann/solvers.py:_glm_faces), with its magnetic pressure pb =
// 0.5 (bxi^2 + by^2 + bz^2) and total energy e.
template <typename T>
struct GlmSide {
  T d, vx, vy, vz, p, bx, by, bz, pb, e;
};

template <typename T, int DIR>
__device__ __forceinline__ GlmSide<T> glm_side(const T* w, T bxi,
                                               const Params<T>& p) {
  constexpr int IVX = 1 + (DIR - 1), IVY = 1 + DIR % 3, IVZ = 1 + (DIR + 1) % 3;
  constexpr int IBX = IVX + 4, IBY = IVY + 4, IBZ = IVZ + 4;
  GlmSide<T> s;
  s.d = w[IDN]; s.vx = w[IVX]; s.vy = w[IVY]; s.vz = w[IVZ]; s.p = w[IPR];
  s.bx = w[IBX]; s.by = w[IBY]; s.bz = w[IBZ];
  s.pb = T(0.5) * (bxi * bxi + s.by * s.by + s.bz * s.bz);
  s.e = s.p * p.inv_gm1 + T(0.5) * s.d * (s.vx * s.vx + s.vy * s.vy + s.vz * s.vz)
        + s.pb;
  return s;
}

// Stores the 7 wave fluxes {d, mx, my, mz, e, by, bz} of direction DIR and
// the GLM pair (the normal field's flux psii, psi's c_h^2 bxi).
template <typename T, int DIR>
__device__ __forceinline__ void glm_store(const T (&f7)[7], T psii, T bxi,
                                          const Params<T>& p, T* F) {
  constexpr int IVX = 1 + (DIR - 1), IVY = 1 + DIR % 3, IVZ = 1 + (DIR + 1) % 3;
  constexpr int IBX = IVX + 4, IBY = IVY + 4, IBZ = IVZ + 4;
  F[IDN] = f7[0];
  F[IVX] = f7[1];
  F[IVY] = f7[2];
  F[IVZ] = f7[3];
  F[IEN] = f7[4];
  F[IBY] = f7[5];
  F[IBZ] = f7[6];
  F[IBX] = psii;
  F[IPS] = p.ch2 * bxi;
}

// GLM-MHD Rusanov flux; riemann/solvers.py:_glm_llf.
template <typename T, int DIR>
__device__ __forceinline__ void glm_llf(const T* wl, const T* wr,
                                        const Params<T>& p, T* F) {
  constexpr int IVX = 1 + (DIR - 1), IBX = IVX + 4;
  const T bxi = T(0.5) * (wl[IBX] + wr[IBX]) - p.half_over_ch * (wr[IPS] - wl[IPS]);
  const T psii = T(0.5) * (wl[IPS] + wr[IPS]) - p.half_ch * (wr[IBX] - wl[IBX]);
  const GlmSide<T> L = glm_side<T, DIR>(wl, bxi, p);
  const GlmSide<T> R = glm_side<T, DIR>(wr, bxi, p);
  auto flux_one = [&](const GlmSide<T>& S, T* f) {
    const T fd = S.d * S.vx;
    f[0] = fd;
    f[1] = fd * S.vx + S.p + S.pb - bxi * bxi;
    f[2] = fd * S.vy - bxi * S.by;
    f[3] = fd * S.vz - bxi * S.bz;
    f[4] = S.vx * (S.e + S.p + S.pb - bxi * bxi) - bxi * (S.vy * S.by + S.vz * S.bz);
    f[5] = S.by * S.vx - bxi * S.vy;
    f[6] = S.bz * S.vx - bxi * S.vz;
  };
  T fl[7], fr[7];
  flux_one(L, fl);
  flux_one(R, fr);
  const T cfl = fast_speed(p.gamma, L.d, L.p, L.bx, L.by, L.bz);
  const T cfr = fast_speed(p.gamma, R.d, R.p, R.bx, R.by, R.bz);
  const T a = nan_max(fabs(L.vx) + cfl, fabs(R.vx) + cfr);
  const T ul[7] = {L.d, L.d * L.vx, L.d * L.vy, L.d * L.vz, L.e, L.by, L.bz};
  const T ur[7] = {R.d, R.d * R.vx, R.d * R.vy, R.d * R.vz, R.e, R.by, R.bz};
  T f7[7];
#pragma unroll
  for (int k = 0; k < 7; ++k)
    f7[k] = T(0.5) * (fl[k] + fr[k]) - T(0.5) * a * (ur[k] - ul[k]);
  glm_store<T, DIR>(f7, psii, bxi, p, F);
}

// GLM-MHD HLLE with Roe-averaged fast-speed bounds; riemann/solvers.py:
// _glm_hlle.
template <typename T, int DIR>
__device__ __forceinline__ void glm_hlle(const T* wl, const T* wr,
                                         const Params<T>& p, T* F) {
  constexpr int IVX = 1 + (DIR - 1), IBX = IVX + 4;
  const T bxi = T(0.5) * (wl[IBX] + wr[IBX]) - p.half_over_ch * (wr[IPS] - wl[IPS]);
  const T psii = T(0.5) * (wl[IPS] + wr[IPS]) - p.half_ch * (wr[IBX] - wl[IBX]);
  const GlmSide<T> L = glm_side<T, DIR>(wl, bxi, p);
  const GlmSide<T> R = glm_side<T, DIR>(wr, bxi, p);
  const T gm1 = p.gm1;
  const T gm1m1 = p.gm1_minus_1;
  const T sqrtdl = sqrt(L.d);
  const T sqrtdr = sqrt(R.d);
  const T isdlpdr = T(1) / (sqrtdl + sqrtdr);
  const T droe = sqrtdl * sqrtdr;
  const T v1roe = (sqrtdl * L.vx + sqrtdr * R.vx) * isdlpdr;
  const T v2roe = (sqrtdl * L.vy + sqrtdr * R.vy) * isdlpdr;
  const T v3roe = (sqrtdl * L.vz + sqrtdr * R.vz) * isdlpdr;
  const T b2roe = (sqrtdr * L.by + sqrtdl * R.by) * isdlpdr;
  const T b3roe = (sqrtdr * L.bz + sqrtdl * R.bz) * isdlpdr;
  const T dby = L.by - R.by;
  const T dbz = L.bz - R.bz;
  const T x = T(0.5) * (dby * dby + dbz * dbz) * (isdlpdr * isdlpdr);
  const T y = T(0.5) * (L.d + R.d) / droe;
  const T hroe = ((L.e + L.p + L.pb) / sqrtdl + (R.e + R.p + R.pb) / sqrtdr) * isdlpdr;
  const T cfl = fast_speed(p.gamma, L.d, L.p, L.bx, L.by, L.bz);
  const T cfr = fast_speed(p.gamma, R.d, R.p, R.bx, R.by, R.bz);

  const T btsq = b2roe * b2roe + b3roe * b3roe;
  const T vaxsq = bxi * bxi / droe;
  const T bt_starsq = (gm1 - gm1m1 * y) * btsq;
  const T hp = hroe - (vaxsq + btsq / droe);
  const T vsq = v1roe * v1roe + v2roe * v2roe + v3roe * v3roe;
  const T tw = gm1 * (hp - T(0.5) * vsq) - gm1m1 * x;
  const T twid_asq = tw < T(0) ? T(0) : tw;      // clamp(min=0): keeps NaN
  const T ct2 = bt_starsq / droe;
  const T tsum = vaxsq + ct2 + twid_asq;
  const T tdif = vaxsq + ct2 - twid_asq;
  const T cf2_cs2 = sqrt(tdif * tdif + T(4) * twid_asq * ct2);
  const T a = sqrt(T(0.5) * (tsum + cf2_cs2));

  const T al = nan_min(v1roe - a, L.vx - cfl);
  const T ar = nan_max(v1roe + a, R.vx + cfr);
  const T bp = ar > T(0) ? ar : T(0);
  const T bm = al < T(0) ? al : T(0);
  const T uxl = L.vx - bm;
  const T uxr = R.vx - bp;
  auto flux_one = [&](const GlmSide<T>& S, T ux, T* f) {
    f[0] = S.d * ux;
    f[1] = S.d * S.vx * ux + S.pb - bxi * bxi + S.p;
    f[2] = S.d * S.vy * ux - bxi * S.by;
    f[3] = S.d * S.vz * ux - bxi * S.bz;
    f[4] = S.e * ux + S.vx * (S.p + S.pb - bxi * bxi) - bxi * (S.by * S.vy + S.bz * S.vz);
    f[5] = S.by * ux - bxi * S.vy;
    f[6] = S.bz * ux - bxi * S.vz;
  };
  T fl[7], fr[7];
  flux_one(L, uxl, fl);
  flux_one(R, uxr, fr);
  const T tmp = bp != bm ? T(0.5) * (bp + bm) / (bp - bm) : T(0);
  T f7[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) f7[k] = T(0.5) * (fl[k] + fr[k]) + (fl[k] - fr[k]) * tmp;
  glm_store<T, DIR>(f7, psii, bxi, p, F);
}

// Flux of all NVar<SOLVER> variables at one face of direction DIR from its
// primitive L/R states.
template <typename T, int SOLVER, int DIR>
__device__ __forceinline__ void riemann_flux(const T* wl, const T* wr,
                                             const Params<T>& p, T* F) {
  if constexpr (SOLVER == SOLVER_EULER_HLLE) euler_hlle<T, DIR>(wl, wr, p, F);
  else if constexpr (SOLVER == SOLVER_EULER_HLLC) euler_hllc<T, DIR>(wl, wr, p, F);
  else if constexpr (SOLVER == SOLVER_EULER_LLF) euler_llf<T, DIR>(wl, wr, p, F);
  else if constexpr (SOLVER == SOLVER_GLMMHD_LLF) glm_llf<T, DIR>(wl, wr, p, F);
  else if constexpr (SOLVER == SOLVER_GLMMHD_HLLE) glm_hlle<T, DIR>(wl, wr, p, F);
  else glm_hlld<T, DIR>(wl, wr, p, F);
}

// ------------------------------------------------------------ cons_to_prim
// eos/adiabatic.py:cons_to_prim for one cell: u (conserved) -> uf (conserved
// with the floors and ceilings applied) and w (primitive).  u, uf and w hold
// NV values; uf or w may alias u.
template <typename T, int NV>
__device__ __forceinline__ void cons_to_prim(const T* u, const Params<T>& p,
                                             T* uf, T* w) {
  constexpr bool MHD = NV == 9;
  T u_d = u[0];
  if (p.has_dfloor) u_d = u_d < p.dfloor ? p.dfloor : u_d;
  T u_m1 = u[1], u_m2 = u[2], u_m3 = u[3], u_e = u[4];
  T b1 = T(0), b2 = T(0), b3 = T(0), psi = T(0);

  const T di = T(1) / u_d;
  T w_vx = u_m1 * di;
  T w_vy = u_m2 * di;
  T w_vz = u_m3 * di;

  T e_k = T(0.5) * di * (u_m1 * u_m1 + u_m2 * u_m2 + u_m3 * u_m3);
  T e_b = T(0);
  if constexpr (MHD) {
    b1 = u[5]; b2 = u[6]; b3 = u[7]; psi = u[8];
    e_b = T(0.5) * (b1 * b1 + b2 * b2 + b3 * b3);
  }

  if (p.has_vceil) {
    const T w_v2 = w_vx * w_vx + w_vy * w_vy + w_vz * w_vz;
    const T w_v = sqrt(w_v2);
    const bool over = w_v2 > p.vceil2;
    const T scale = over ? (T(1) / w_v) * p.vceil : T(1);
    w_vx = w_vx * scale;
    w_vy = w_vy * scale;
    w_vz = w_vz * scale;
    u_m1 = u_m1 * scale;
    u_m2 = u_m2 * scale;
    u_m3 = u_m3 * scale;
    const T e_k_new = over ? T(0.5) * u_d * p.vceil2 : e_k;
    u_e = u_e - (e_k - e_k_new);
    e_k = e_k_new;
  }

  T w_p = p.gm1 * (u_e - e_k - e_b);

  if (p.has_pfloor) {
    const bool under = w_p < p.pfloor;
    u_e = under ? p.pfloor_over_gm1 + e_k + e_b : u_e;
    w_p = under ? p.pfloor : w_p;
  }
  if (p.has_efloor) {
    const T eff_floor = p.gm1 * u_d * p.efloor;
    const bool under = w_p < eff_floor;
    u_e = under ? u_d * p.efloor + e_k + e_b : u_e;
    w_p = under ? eff_floor : w_p;
  }
  if (p.has_eceil) {
    const T eff_ceil = p.gm1 * u_d * p.eceil;
    const bool over = w_p > eff_ceil;
    u_e = over ? u_d * p.eceil + e_k + e_b : u_e;
    w_p = over ? eff_ceil : w_p;
  }

  uf[0] = u_d; uf[1] = u_m1; uf[2] = u_m2; uf[3] = u_m3; uf[4] = u_e;
  w[0] = u_d; w[1] = w_vx; w[2] = w_vy; w[3] = w_vz; w[4] = w_p;
  if constexpr (MHD) {
    uf[5] = b1; uf[6] = b2; uf[7] = b3; uf[8] = psi;
    w[5] = b1; w[6] = b2; w[7] = b3; w[8] = psi;
  }
}

// min_d dx_d / (|v_d| + lam_d) of one primitive state: the raw hyperbolic
// CFL bound of a cell (HydroPackage.estimate_timestep), d over x, y, z;
// the plain code's `dx / tensor` is reciprocal(tensor) * dx.
template <typename T, int NV>
__device__ __forceinline__ T cell_cfl_dt(const T* w, const Params<T>& p,
                                         T dx1, T dx2, T dx3) {
  T l1, l2, l3;
  if constexpr (NV == 9) {
    l1 = fast_speed(p.gamma, w[0], w[4], w[5], w[6], w[7]);
    l2 = fast_speed(p.gamma, w[0], w[4], w[6], w[7], w[5]);
    l3 = fast_speed(p.gamma, w[0], w[4], w[7], w[5], w[6]);
  } else {
    l1 = l2 = l3 = sqrt(p.gamma * w[4] / w[0]);
  }
  const T t1 = (T(1) / (fabs(w[1]) + l1)) * dx1;
  const T t2 = (T(1) / (fabs(w[2]) + l2)) * dx2;
  const T t3 = (T(1) / (fabs(w[3]) + l3)) * dx3;
  return nan_min(nan_min(t1, t2), t3);
}

// ------------------------------------------------------ asynchronous copies
// One element from device memory into shared memory without passing through
// registers (cp.async).  The copies a thread has issued have landed after
// its cp_async_wait_all; a __syncthreads after that shows them to the block.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4- or 8-byte elements");
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               ::"r"(s), "l"(src), "n"(sizeof(T)) : "memory");
#else
  *dst = *src;
#endif
}

// 16 bytes (16 / sizeof(T) elements) the same way; both addresses 16-byte
// aligned.
template <typename T>
__device__ __forceinline__ void cp_async16(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(s), "l"(src) : "memory");
#else
  for (int e = 0; e < 16 / (int)sizeof(T); ++e) dst[e] = src[e];
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// i wrapped into [0, n): the periodic index within a block.  Callers pass
// indices at most a few extents away, so no division is needed.
__device__ __forceinline__ int wrap_index(int i, int n) {
  while (i < 0) i += n;
  while (i >= n) i -= n;
  return i;
}

}  // namespace hydro
