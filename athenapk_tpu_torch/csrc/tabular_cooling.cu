// The Townsend cooling and its dt limit on Hopper: srcterms/tabular_cooling.py's
// TabularCooling, two entry points over one table lookup,
//
//   cooling_townsend  E += rho (e1 - e0), e1 = _townsend(e0, rho, dt),
//                     in place on a whole state (ghosts included, as the
//                     plain update converts the whole tensor)   one launch
//   cooling_dt        cfl * min over the interior cells of |e / (de/dt)|,
//                     estimate_timestep's minimum               two launches
//
// cell by cell, in the plain code's order of operations and in the state's
// dtype, so the result is the plain code's on the card bit for bit.  What
// PyTorch does on the card that the plain code's text hides, and the kernel
// repeats:
//   * x / c, c a Python float, is x * (1 / c), the reciprocal taken in
//     double on the host and rounded to the dtype (ATen's
//     div_true_kernel_cuda);
//   * c / x, c a Python float, is x.reciprocal() * c (Tensor.__rtruediv__);
//   * x ** 2 is x * x; a Python float meets a tensor in the tensor's dtype
//     (clamp(min=1e-300) is clamp(min=0) in float32);
//   * .to(torch.int32) truncates with the card's saturating conversion (NaN
//     to 0), as (int) does here.
// The bin walks `(temps[1:] < temp).sum()` and `(Y_k >= tef_adj).sum()` are
// counts over monotone tables (temps rises, Y_k falls; the wrapper checks
// both in the dtype): a binary search returns the same count in
// ceil(log2 n) steps, 0 where every compare is false, NaN included.
//
// Replaces no TPU kernel: the JAX package leaves the cooling to XLA
// (athenapk_tpu/srcterms/tabular_cooling.py), which fuses its elementwise
// operations.  On the card the plain update is ~60 elementwise launches, a
// clone of the state and two [cells, n - 1] bool tables summed in int64 a
// stage, and the dt ~25 launches and a reduction.
//
// Work: a cell of the update reads 5 rows (8 with a field) and writes one;
// it takes two pow, six divisions and two searches.  The dt reads two rows
// of the interior, with a log10, a pow and two divisions.  Its operations
// are not counted, so whether bytes or the FP64 pipe bound either kernel is
// not known; the bytes alone do not account for their times.  Design:
// streaming kernels, the tables in shared memory (loaded once by each block,
// which then walks the cells grid-stride), no other shared memory.  The
// update takes VEC neighbouring cells a thread, VEC = 16 / sizeof(T), with
// one 16-byte load a row where the row length and the pointer allow it
// (else VEC = 1), every row loaded before any arithmetic.  The dt goes
// through the interior view's strides (no copy) and writes one partial
// minimum a block; a second launch of one block takes their minimum and
// scales it by the cfl.
// The minimum propagates NaN, as torch.min does, and is exact in any order.
//
// Layout of the update: [nb, nvar, ncell] contiguous, a row's stride ncell.
// Rows: IDN 0, IM1-IM3 1-3, IEN 4, IB1-IB3 5-7 (core/indices.py); IPR 4.
//
// Plain C interface (loaded with ctypes): each entry returns the
// cudaError_t of its launches (0 on success); neither synchronises.  Built
// with FMA contraction on, unlike the other kernels
// (srcterms/tabular_cooling_cuda.py:build_library): libdevice's double pow
// rounds as PyTorch's (built with contraction) only so.  Every product, sum
// and difference of this file's own goes through the rounded intrinsics
// mul, add and sub below, which the compiler never contracts, so each
// rounds once, as PyTorch's one-operation kernels do.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace cooling {

constexpr int THREADS = 256;
constexpr int IDN = 0, IM1 = 1, IM2 = 2, IM3 = 3, IEN = 4, IB1 = 5, IB2 = 6,
              IB3 = 7, IPR = 4;

// The Python floats of TabularCooling, as the wrapper computes them in
// double (srcterms/tabular_cooling_cuda.py:CoolArgs, field for field).
struct CoolArgs {
  double mgk;         // mbar_gm1_over_kb
  double tcf;         // temp_cool_floor = 10 ** log_temp_start
  double e_tcf;       // temp_cool_floor / mgk
  double e_floor;     // t_floor / mgk, or -inf with no floor
  double lam_fin;     // lambda_final
  double t_fin;       // temp_final
  double xh;          // x_h_over_mh2
  double coef;        // lambda_final * dt / temp_final * mgk
  double lts;         // log_temp_start
  double dlt;         // d_log_temp
  double ltf;         // log_temp_final
  double half_ltf;    // 0.5 * log_temp_final
  double gm1;         // gamma - 1
  double e_floor_dt;  // max(t_floor, temp_cool_floor) / mgk
  double cfl;         // cooling_time_cfl
};

// The same constants in the dtype: each Python float as PyTorch hands it to
// an operation on a T tensor, and the reciprocals of the divisors that
// PyTorch folds (1 / c in double, then rounded).
template <typename T>
struct Consts {
  T mgk, inv_mgk, tcf, e_tcf, e_floor, lam_fin, inv_lam_fin, t_fin,
      inv_t_fin, xh, coef, lts, dlt, inv_dlt, ltf, half_ltf, tiny, gm1,
      e_floor_dt, cfl;
};

template <typename T>
Consts<T> make_consts(const CoolArgs& a) {
  Consts<T> c;
  c.mgk = T(a.mgk);
  c.inv_mgk = T(1.0 / a.mgk);
  c.tcf = T(a.tcf);
  c.e_tcf = T(a.e_tcf);
  c.e_floor = T(a.e_floor);
  c.lam_fin = T(a.lam_fin);
  c.inv_lam_fin = T(1.0 / a.lam_fin);
  c.t_fin = T(a.t_fin);
  c.inv_t_fin = T(1.0 / a.t_fin);
  c.xh = T(a.xh);
  c.coef = T(a.coef);
  c.lts = T(a.lts);
  c.dlt = T(a.dlt);
  c.inv_dlt = T(1.0 / a.dlt);
  c.ltf = T(a.ltf);
  c.half_ltf = T(a.half_ltf);
  c.tiny = T(1e-300);
  c.gm1 = T(a.gm1);
  c.e_floor_dt = T(a.e_floor_dt);
  c.cfl = T(a.cfl);
  return c;
}

// one rounding each, never contracted into a fused multiply-add
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}

__device__ __forceinline__ float pow_(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double pow_(double a, double b) {
  return pow(a, b);
}
__device__ __forceinline__ float log10_(float a) { return log10f(a); }
__device__ __forceinline__ double log10_(double a) { return log10(a); }

// torch.clamp(v, min=lo) on the card: NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_min(T v, T lo) {
  return isnan(v) ? v : fmax(v, lo);
}

// torch.min's pairwise step: NaN wins
template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  return (isnan(a) || a < b) ? a : b;
}

// the number of a[0 .. m-1] below x, a non-decreasing: (a < x).sum()
template <typename T>
__device__ __forceinline__ int count_below(const T* a, int m, T x) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// the number of a[0 .. m-1] at or above x, a non-increasing: (a >= x).sum()
template <typename T>
__device__ __forceinline__ int count_at_least(const T* a, int m, T x) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] >= x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The tables of one dtype in shared memory: temps and lambdas (n rows),
// alpha_k and Y_k (n - 1 rows), log_lambdas (n rows, the dt's).
template <typename T>
struct Tables {
  const T* temps;
  const T* lambdas;
  const T* alpha_k;
  const T* y_k;
  const T* log_lambdas;
};

// _townsend(e0, rho, dt): the new specific internal energy
template <typename T>
__device__ __forceinline__ T townsend(T e0, T rho, const Consts<T>& c,
                                      const T* temps, const T* lambdas,
                                      const T* alpha_k, const T* y_k,
                                      int n) {
  const int nbins = n - 1;
  const T temp = mul(e0, c.mgk);
  int idx = count_below(temps + 1, n - 1, temp);
  idx = min(max(idx, 0), nbins - 1);
  const T a_m1 = sub(alpha_k[idx], T(1));
  // Y_k[idx] + (lam_fin / lambdas[idx]) * (temps[idx] / t_fin)
  //   * (_pow(temps[idx] / temp, a_m1) - 1.0) / a_m1
  const T r1 = mul(T(1) / lambdas[idx], c.lam_fin);
  const T r2 = mul(temps[idx], c.inv_t_fin);
  const T pw = pow_(temps[idx] / temp, a_m1);
  const T tef = add(y_k[idx], mul(mul(r1, r2), sub(pw, T(1))) / a_m1);
  // tef + lam_fin * dt / t_fin * mgk * (rho * x_h_over_mh2)
  const T tef_adj = add(tef, mul(mul(rho, c.xh), c.coef));
  const int kstar = count_at_least(y_k, nbins, tef_adj) - 1;
  const int idx2 = min(idx, max(kstar, 0));
  const T one_m_a = sub(T(1), alpha_k[idx2]);
  // temps[idx2] * _pow(1.0 - one_m_a * (lambdas[idx2] / lam_fin)
  //   * (t_fin / temps[idx2]) * (tef_adj - Y_k[idx2]), 1.0 / one_m_a)
  const T s1 = mul(one_m_a, mul(lambdas[idx2], c.inv_lam_fin));
  const T s2 = mul(s1, mul(T(1) / temps[idx2], c.t_fin));
  const T base = sub(T(1), mul(s2, sub(tef_adj, y_k[idx2])));
  const T temp_new =
      mul(temps[idx2], pow_(base, mul(T(1) / one_m_a, T(1))));
  T e_new = temp_new > c.tcf ? mul(temp_new, c.inv_mgk) : c.e_tcf;
  e_new = temp < c.tcf ? e0 : e_new;
  return e0 <= c.e_floor ? clamp_min(e0, c.e_floor) : e_new;
}

// dedt(e, rho): the specific-internal-energy loss rate
template <typename T>
__device__ __forceinline__ T dedt(T e, T rho, const Consts<T>& c,
                                  const T* ll, int n) {
  const T temp = mul(e, c.mgk);
  const T log_temp = log10_(clamp_min(temp, c.tiny));
  int i = (int)mul(sub(log_temp, c.lts), c.inv_dlt);
  i = min(max(i, 0), n - 2);
  const T lt_i = add(mul(T(i), c.dlt), c.lts);
  const T ll_i = ll[i];
  const T interp = add(
      ll_i, mul(mul(sub(log_temp, lt_i), sub(ll[i + 1], ll_i)), c.inv_dlt));
  const T ext = add(sub(mul(log_temp, T(0.5)), c.half_ltf), ll[n - 1]);
  const T log_lambda = log_temp > c.ltf ? ext : interp;
  const T out = mul(mul(-pow_(T(10), log_lambda), c.xh), rho);
  const bool invalid = e < T(0) || isnan(e) || log_temp < c.lts;
  return invalid ? T(0) : out;
}

// VEC neighbouring values of a row: one 16-byte load or store where VEC > 1
__device__ __forceinline__ void load(const float* p, float (&v)[1]) {
  v[0] = p[0];
}
__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load(const double* p, double (&v)[1]) {
  v[0] = p[0];
}
__device__ __forceinline__ void load(const double* p, double (&v)[2]) {
  const double2 q = *reinterpret_cast<const double2*>(p);
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

// the minimum of every thread's m, in thread 0 (a tree in shared memory;
// once a block)
template <typename T>
__device__ __forceinline__ T block_min(T m) {
  __shared__ T red[THREADS];
  red[threadIdx.x] = m;
  __syncthreads();
  for (int h = THREADS / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h)
      red[threadIdx.x] = min_nan(red[threadIdx.x], red[threadIdx.x + h]);
    __syncthreads();
  }
  return red[0];
}

template <typename T>
__device__ __forceinline__ T* shared_tables() {
  extern __shared__ __align__(16) unsigned char smem[];
  return reinterpret_cast<T*>(smem);
}

// Groups of VEC cells blockIdx.x * THREADS + threadIdx.x, + gridDim.x *
// THREADS, ... of every block blockIdx.y, + gridDim.y, ...; ncell % VEC == 0.
template <typename T, bool MHD, int VEC>
__global__ void __launch_bounds__(THREADS)
townsend_cool_kernel(T* __restrict__ u, const Tables<T> tab,
                     const Consts<T> c, int n, int nb, int nvar,
                     long long ncell) {
  T* temps = shared_tables<T>();
  T* lambdas = temps + n;
  T* alpha_k = lambdas + n;
  T* y_k = alpha_k + (n - 1);
  for (int t = threadIdx.x; t < n; t += THREADS) {
    temps[t] = tab.temps[t];
    lambdas[t] = tab.lambdas[t];
    if (t < n - 1) {
      alpha_k[t] = tab.alpha_k[t];
      y_k[t] = tab.y_k[t];
    }
  }
  __syncthreads();
  const long long groups = ncell / VEC;
  const long long stride = (long long)gridDim.x * THREADS;
  for (int b = blockIdx.y; b < nb; b += gridDim.y) {
    T* ub = u + (long long)b * nvar * ncell;
    for (long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
         g < groups; g += stride) {
      const long long i = g * VEC;
      T d[VEC], m1[VEC], m2[VEC], m3[VEC], en[VEC], b1[VEC], b2[VEC],
          b3[VEC];
      load(ub + IDN * ncell + i, d);
      load(ub + IM1 * ncell + i, m1);
      load(ub + IM2 * ncell + i, m2);
      load(ub + IM3 * ncell + i, m3);
      load(ub + IEN * ncell + i, en);
      if constexpr (MHD) {
        load(ub + IB1 * ncell + i, b1);
        load(ub + IB2 * ncell + i, b2);
        load(ub + IB3 * ncell + i, b3);
      }
      T out[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        // _internal_e: (E - 0.5 (M1^2 + M2^2 + M3^2) / rho
        //               [- 0.5 (B1^2 + B2^2 + B3^2)]) / rho
        const T rho = d[k];
        const T ke =
            add(add(mul(m1[k], m1[k]), mul(m2[k], m2[k])), mul(m3[k], m3[k]));
        T ie = sub(en[k], mul(ke, T(0.5)) / rho);
        if constexpr (MHD) {
          const T me = add(add(mul(b1[k], b1[k]), mul(b2[k], b2[k])),
                           mul(b3[k], b3[k]));
          ie = sub(ie, mul(me, T(0.5)));
        }
        const T e0 = ie / rho;
        const T e1 = townsend(e0, rho, c, temps, lambdas, alpha_k, y_k, n);
        out[k] = add(en[k], mul(rho, sub(e1, e0)));
      }
      store(ub + IEN * ncell + i, out);
    }
  }
}

// Interior cells idx = blockIdx.x * THREADS + threadIdx.x, + gridDim.x *
// THREADS, ... of w (sizes nb, nz, ny, nx, strides in elements); the
// block's minimum of ct into part[blockIdx.x].
template <typename T>
__global__ void __launch_bounds__(THREADS)
cooling_dt_kernel(const T* __restrict__ w, const T* __restrict__ ll_in,
                  const Consts<T> c, int n, unsigned nz, unsigned ny,
                  unsigned nx, unsigned ncells, long long sb, long long sv,
                  long long sz, long long sy, long long sx,
                  T* __restrict__ part) {
  T* ll = shared_tables<T>();
  for (int t = threadIdx.x; t < n; t += THREADS) ll[t] = ll_in[t];
  __syncthreads();
  T m = T(INFINITY);
  for (unsigned idx = blockIdx.x * THREADS + threadIdx.x; idx < ncells;
       idx += gridDim.x * THREADS) {
    unsigned r = idx;
    const unsigned i = r % nx;
    r /= nx;
    const unsigned j = r % ny;
    r /= ny;
    const unsigned k = r % nz;
    const unsigned b = r / nz;
    const T* p = w + b * sb + k * sz + j * sy + i * sx;
    const T rho = p[IDN * sv];
    const T e = p[IPR * sv] / mul(rho, c.gm1);
    const T de = dedt(e, rho, c, ll, n);
    const T ct = (de == T(0) || e < c.e_floor_dt)
                     ? T(INFINITY)
                     : fabs(e / (de != T(0) ? de : T(1)));
    m = min_nan(m, ct);
  }
  m = block_min(m);
  if (threadIdx.x == 0) part[blockIdx.x] = m;
}

// out = cfl * min(part[0 .. nparts-1]), one block
template <typename T>
__global__ void __launch_bounds__(THREADS)
cooling_dt_min_kernel(const T* __restrict__ part, int nparts, T cfl,
                      T* __restrict__ out) {
  T m = T(INFINITY);
  for (int q = threadIdx.x; q < nparts; q += THREADS) m = min_nan(m, part[q]);
  m = block_min(m);
  if (threadIdx.x == 0) out[0] = mul(m, cfl);
}

// blocks of the update a state block: enough to fill the card a few times
// over, each walking its share of the cells grid-stride
inline unsigned update_blocks(long long groups, int nb_y) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (groups + THREADS - 1) / THREADS;
  long long cap = 8LL * sms / nb_y;
  if (cap < 1) cap = 1;
  return (unsigned)(want < cap ? want : cap);
}

template <typename T, bool MHD, int VEC>
cudaError_t launch_update(void* u, const Tables<T>& tab, const Consts<T>& c,
                          int n, int nb, int nvar, long long ncell,
                          cudaStream_t stream) {
  const int ny = nb < 65535 ? nb : 65535;
  const dim3 grid(update_blocks(ncell / VEC, ny), ny, 1);
  const size_t smem = (size_t)(4 * n - 2) * sizeof(T);
  townsend_cool_kernel<T, MHD, VEC><<<grid, THREADS, smem, stream>>>(
      static_cast<T*>(u), tab, c, n, nb, nvar, ncell);
  return cudaGetLastError();
}

template <typename T, bool MHD>
cudaError_t launch_update_vec(void* u, const Tables<T>& tab,
                              const Consts<T>& c, int n, int nb, int nvar,
                              long long ncell, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (ncell % VEC == 0 && reinterpret_cast<std::uintptr_t>(u) % 16 == 0)
    return launch_update<T, MHD, VEC>(u, tab, c, n, nb, nvar, ncell, stream);
  return launch_update<T, MHD, 1>(u, tab, c, n, nb, nvar, ncell, stream);
}

template <typename T>
Tables<T> tables(const void* const* t) {
  return Tables<T>{static_cast<const T*>(t[0]), static_cast<const T*>(t[1]),
                   static_cast<const T*>(t[2]), static_cast<const T*>(t[3]),
                   static_cast<const T*>(t[4])};
}

template <typename T>
cudaError_t update_any(void* u, const void* const* tab, const CoolArgs& a,
                       int mhd, int n, int nb, int nvar, long long ncell,
                       cudaStream_t stream) {
  const Consts<T> c = make_consts<T>(a);
  const Tables<T> t = tables<T>(tab);
  if (mhd)
    return launch_update_vec<T, true>(u, t, c, n, nb, nvar, ncell, stream);
  return launch_update_vec<T, false>(u, t, c, n, nb, nvar, ncell, stream);
}

template <typename T>
cudaError_t dt_any(const void* w, const void* const* tab, const CoolArgs& a,
                   int n, const int* size, const long long* stride,
                   void* part, int nparts, void* out, cudaStream_t stream) {
  const Consts<T> c = make_consts<T>(a);
  const unsigned long long ncells =
      (unsigned long long)size[0] * size[1] * size[2] * size[3];
  cooling_dt_kernel<T><<<nparts, THREADS, n * sizeof(T), stream>>>(
      static_cast<const T*>(w), static_cast<const T*>(tab[4]), c, n,
      (unsigned)size[1], (unsigned)size[2], (unsigned)size[3],
      (unsigned)ncells, stride[0], stride[1], stride[2], stride[3], stride[4],
      static_cast<T*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cooling_dt_min_kernel<T><<<1, THREADS, 0, stream>>>(
      static_cast<const T*>(part), nparts, c.cfl, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace cooling

// The Townsend update in place on the contiguous [nb, nvar, ncell] state
// cons: dtype 0 float, 1 double; mhd 1 for GLM-MHD (the field's energy
// comes off); tables the device pointers of temps, lambdas, alpha_k, Y_k and
// log_lambdas in the dtype (n rows; n - 1 for alpha_k and Y_k).
extern "C" int cooling_townsend(void* cons, int dtype, int mhd, int nb,
                                int nvar, long long ncell,
                                const void* const* tables, int n,
                                const cooling::CoolArgs* args, void* stream) {
  if (nvar < (mhd ? 9 : 5) || nb <= 0 || ncell <= 0 || n < 2)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)cooling::update_any<float>(cons, tables, *args, mhd, n, nb,
                                           nvar, ncell, s);
  if (dtype == 1)
    return (int)cooling::update_any<double>(cons, tables, *args, mhd, n, nb,
                                            nvar, ncell, s);
  return (int)cudaErrorInvalidValue;
}

// cfl * min over the cells of the view prim (sizes [nb, nvar, nz, ny, nx],
// strides in elements) of the cooling time into the device scalar out;
// part holds nparts partial minima (one a block of the first launch).
extern "C" int cooling_dt(const void* prim, int dtype, const int* size,
                          const long long* stride, const void* const* tables,
                          int n, const cooling::CoolArgs* args, void* part,
                          int nparts, void* out, void* stream) {
  const unsigned long long ncells =
      (unsigned long long)size[0] * size[2] * size[3] * size[4];
  if (ncells == 0 || ncells > (unsigned long long)INT_MAX || size[1] <= 4 ||
      n < 2 || nparts <= 0)
    return (int)cudaErrorInvalidValue;
  const int sizes[4] = {size[0], size[2], size[3], size[4]};
  const long long strides[5] = {stride[0], stride[1], stride[2], stride[3],
                                stride[4]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)cooling::dt_any<float>(prim, tables, *args, n, sizes,
                                       strides, part, nparts, out, s);
  if (dtype == 1)
    return (int)cooling::dt_any<double>(prim, tables, *args, n, sizes,
                                        strides, part, nparts, out, s);
  return (int)cudaErrorInvalidValue;
}
