// Fused Radau5 (s=3) step attempt (K4): one whole attempt per lane, for
// sm_90a. The kernel, templated on the scalar type T and the right-hand
// side functor P; radau_fused.cu instantiates it for the hand-written
// functors of problems.cuh, and ops/rhs_codegen.py for each functor it
// generates from a traced f, each in a translation unit of its own.
//
// Replaces the TPU kernel janus_tpu/solve/radau_fused.py:solve_radau_fused,
// inner `kernel` (:170, pallas_call at :476). Its plain torch version is
// janus_tpu_torch/solve/radau_fused.py:_step_ref; the wrapper is
// janus_tpu_torch/ops/radau_fused.py:radau5_step.
//
// Layout: the packed SoA state of _row_layout, row r of lane m at
// state[r*M + m] (neighbouring threads on neighbouring addresses), the
// lane's final time at tf[m], parameter j at params[j*M + m]. The state is
// updated in place: the reference aliases it in -> out
// (input_output_aliases={2: 0}), and nothing else reads the old rows.
//
// Shape of the work: one thread per lane. Each attempt is a few thousand
// dependent flops (divides, sqrt and pow among them) on ~100 values per
// lane, against ~(5D+15) loads and stores per launch, so the kernel is bound
// by latency, and how much of it the SM can hide depends on how many warps
// it holds: by registers. The design is sized for that (measurements in
// PERF.md, by janus_tpu_torch/bench/kernels.py):
// - at most 128 registers a thread (__launch_bounds__(128, 4)): 16 warps on
//   each SM, 67,584 lanes resident on 132 SMs, so 65,536 lanes run in one
//   wave. D >= 3 in double asks for 2 blocks (up to 255 registers, 8
//   warps), where it spills nothing (min_blocks);
// - what does not fit is per-lane state in shared memory, element-major
//   (element e of the thread's lane at smem[e * 128 + threadIdx.x], so a
//   warp touches 32 neighbouring words: no bank conflicts): the factors
//   lu_r [D][D] and lu_c [2D][2D], and, where a block's share of the SM
//   still holds them, what is touched only at the start and the end of an
//   attempt: the warm-start coefficients q [3][D], f0 [D] and 12
//   bookkeeping scalars (Layout below; D = 2 f64: 40 values, 40 KB a
//   block). ptxas still spills 120 B a thread of VdP in double (PERF.md);
// - D = 5..8 (generated functors only): the 5 D^2 factor values (125-320 a
//   lane, up to 2,560 B in double) do not fit a block's share of the SM at
//   128 threads, so they live in the thread's local memory (the L1/L2-cached
//   stack, interleaved by the hardware so that a warp's accesses to one
//   element coalesce), with the elimination and substitution loops left
//   rolled so that they index it; 2 blocks a SM (up to 255 registers).
//   A simple layout, not the redesign for D > 4 (PERF.md);
// - one lane per thread, ceil(M/128) blocks: the hardware starts a block
//   as soon as one retires. A persistent grid whose warps take lanes from
//   a counter measured no faster at one wave and slower beyond it
//   (PERF.md), so there is none.
// The occupancy query and the shared-memory opt-in run once per device and
// instantiation.
// Two choices the TPU kernel could not make, neither of which changes a
// number:
// - a lane leaves the Newton loop once it is no longer running (every
//   carry is masked by `running` or its subset `app` in the reference; the
//   one that is not, `rate`, is never read after the loop);
// - a launch runs up to max_attempts attempts for its lane: an inactive
//   lane is a fixed point of the attempt (t, y, counters, nnewton hold), so
//   the attempts a launch skips for an inactive lane change nothing.
//
// Arithmetic: the reference kernel's, line for line -- reciprocal-multiply
// factor and divide in substitution, three stages per Newton trip, the
// divergence test with pow(srt, left) as a floating-point power, the
// refined error estimate computed every attempt, the Gustafsson controller
// and the write-back with nfev += nfev_n + 2 + D. Every tableau and
// controller constant comes in from Python (JanusRadauConsts, built from
// radau_tableau(3) and Options); in float the constants are rounded to
// float, as JAX's weak typing does (once, on the host: Consts). Built with
// -fmad=false (ops/_build.py:SOURCE_FLAGS): the step's cancellations turn
// FMA rounding differences into visible ones (3.7e-9 of h in f64 after one
// attempt), and without contraction the kernel does the plain version's
// IEEE operations, so the two agree to the bit on the card. The one exception to the flag
// is pow in double: the twin's is PyTorch's, built with contraction, so K4
// calls the same pow built the same way (pow_fmad.cu).
//
// f and its Jacobian columns come from the functor P (forward mode through
// Dual<T>): P::f<T, T> evaluates f, P::f<T, Dual<T>> with a one-hot tangent
// on y gives one Jacobian column.

#pragma once

#include <cuda_runtime.h>
#include <atomic>
#include <cstdint>
#include <cstring>

#include "dual.cuh"

// pow in double as PyTorch computes it (pow_fmad.cu).
__device__ double janus_pow_fmad(double x, double y);

extern "C" {
// Field for field the ctypes Structure of janus_tpu_torch/ops/radau_fused.py.
struct JanusRadauConsts {
  double mu_r, mu_cr, mu_ci;  // real and complex eigenvalue of A^-1
  double c[3];                // nodes
  double t_mat[9], ti_mat[9]; // transformation T, T^-1 (row-major 3x3)
  double e[3];                // error-estimate weights
  double p[9];                // warm-start polynomial P (row-major 3x3)
  double expo;                // controller exponent 1/(s+1)
  double newton_tol, eps, rtol, atol;
  double safety0, facl, facr, quot1, quot2, max_steps;
  int newton_maxiter;
  int st_success, st_max_steps, st_underflow, st_stall;
};
}

namespace {

// The constants in the kernel's scalar type, converted once on the host the
// way the kernel would convert them at use (T(double), round to nearest):
// the same values, read straight from the parameter bank, with no
// conversion in the kernel to hoist into registers (float).
template <typename T>
struct Consts {
  T mu_r, mu_cr, mu_ci, c[3], t_mat[9], ti_mat[9], e[3], p[9];
  T expo, newton_tol, eps, rtol, atol;
  T safety_num, two_maxiter;  // T(safety0 * (2 nm + 1)), T(2 nm)
  T facl, facr, quot1, quot2, max_steps;
  T st_success, st_max_steps, st_underflow, st_stall;
  int newton_maxiter;
};

template <typename T>
Consts<T> consts_as(const JanusRadauConsts& k) {
  Consts<T> c;
  c.mu_r = T(k.mu_r);
  c.mu_cr = T(k.mu_cr);
  c.mu_ci = T(k.mu_ci);
  for (int i = 0; i < 3; ++i) {
    c.c[i] = T(k.c[i]);
    c.e[i] = T(k.e[i]);
  }
  for (int i = 0; i < 9; ++i) {
    c.t_mat[i] = T(k.t_mat[i]);
    c.ti_mat[i] = T(k.ti_mat[i]);
    c.p[i] = T(k.p[i]);
  }
  c.expo = T(k.expo);
  c.newton_tol = T(k.newton_tol);
  c.eps = T(k.eps);
  c.rtol = T(k.rtol);
  c.atol = T(k.atol);
  c.safety_num = T(k.safety0 * (2 * k.newton_maxiter + 1));
  c.two_maxiter = T(2 * k.newton_maxiter);
  c.facl = T(k.facl);
  c.facr = T(k.facr);
  c.quot1 = T(k.quot1);
  c.quot2 = T(k.quot2);
  c.max_steps = T(k.max_steps);
  c.st_success = T(k.st_success);
  c.st_max_steps = T(k.st_max_steps);
  c.st_underflow = T(k.st_underflow);
  c.st_stall = T(k.st_stall);
  c.newton_maxiter = k.newton_maxiter;
  return c;
}

constexpr int kThreads = 128;
// Hopper: 228 KB of shared memory per SM, 1 KB of it reserved per block.
constexpr size_t kSmemPerSm = 228 * 1024;
constexpr size_t kSmemPerBlockReserved = 1024;

// Blocks per SM that __launch_bounds__ asks registers for: 4 (<= 128
// registers, 16 warps) except D >= 3 in double: squeezed into 128
// registers it spills ~0.5 KB a thread and runs no faster than with 2
// blocks (up to 255 registers, 8 warps), which spill nothing (PERF.md).
// D >= 5 (generated functors) asks for 2 in either type.
template <typename T, int D>
constexpr int min_blocks() {
  return (sizeof(T) == 8 && D >= 3) || D >= 5 ? 2 : 4;
}

// Whether min_blocks blocks holding `slots` values of T per lane fit on one
// SM.
template <typename T, int D>
constexpr bool smem_fits(int slots) {
  return (size_t)slots * sizeof(T) * kThreads + kSmemPerBlockReserved
         <= kSmemPerSm / min_blocks<T, D>();
}

// Which per-lane arrays live in shared memory, and how many bytes a block
// needs for them: the factors, then q, f0 and the bookkeeping scalars
// (h_old, err_old, h_prev, flags, counters) as long as min_blocks blocks
// still fit on one SM. The factors of D <= 4 always fit; where they do not
// (D >= 5 in double, D >= 7 in float) they go to local memory instead
// (kLuShared false) and the rest is placed as before.
template <typename T, int D>
struct Layout {
  static constexpr int kLu = 5 * D * D;  // lu_r D*D, then lu_c 4*D*D
  static constexpr int kBk = 12;         // the bookkeeping scalars
  static constexpr bool kLuShared = smem_fits<T, D>(kLu);
  static_assert(kLuShared || D >= 5, "K4: the factors of D <= 4 must fit");
  static constexpr int kLuSlots = kLuShared ? kLu : 0;
  static constexpr bool kQShared = smem_fits<T, D>(kLuSlots + 3 * D);
  static constexpr bool kF0Shared =
      kQShared && smem_fits<T, D>(kLuSlots + 4 * D);
  static constexpr bool kBkShared =
      kF0Shared && smem_fits<T, D>(kLuSlots + 4 * D + kBk);
  static constexpr int kQ = kLuSlots;                   // first q slot
  static constexpr int kF0 = kQ + (kQShared ? 3 * D : 0);
  static constexpr int kBkAt = kF0 + (kF0Shared ? D : 0);
  static constexpr int kSlots = kBkAt + (kBkShared ? kBk : 0);
  static constexpr size_t kBytes = (size_t)kSlots * sizeof(T) * kThreads;
};

// N values of one lane: in shared memory, element e at col[e * kThreads]
// (col = the block's shared array + threadIdx.x), or in registers.
template <typename T, int N, bool kShared>
struct LaneArray;

template <typename T, int N>
struct LaneArray<T, N, true> {
  T* col;
  __device__ T& operator[](int e) const { return col[e * kThreads]; }
};

template <typename T, int N>
struct LaneArray<T, N, false> {
  T v[N];
  __device__ LaneArray(T*) {}
  __device__ T& operator[](int e) { return v[e]; }
  __device__ const T& operator[](int e) const { return v[e]; }
};

// In-place pivot-free elimination of the row-major N x N matrix a.
template <typename T, int N, typename Mat>
__device__ __forceinline__ void factor_rows(Mat& a) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const T inv = T(1) / a[k * N + k];
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const T m = a[i * N + k] * inv;
      a[i * N + k] = m;
#pragma unroll
      for (int j = k + 1; j < N; ++j)
        a[i * N + j] = a[i * N + j] - m * a[k * N + j];
    }
  }
}

// The same elimination and substitution with the loops rolled, for
// factors in local memory (D >= 5 where they do not fit shared memory):
// the same operations in the same order.
template <typename T, int N, typename Mat>
__device__ void factor_rows_rolled(Mat& a) {
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    const T inv = T(1) / a[k * N + k];
#pragma unroll 1
    for (int i = k + 1; i < N; ++i) {
      const T m = a[i * N + k] * inv;
      a[i * N + k] = m;
#pragma unroll 1
      for (int j = k + 1; j < N; ++j)
        a[i * N + j] = a[i * N + j] - m * a[k * N + j];
    }
  }
}

template <typename T, int N, typename Mat>
__device__ void solve_lu_rows_rolled(const Mat& lu, const T (&rhs)[N],
                                     T (&x)[N]) {
  T y[N];
#pragma unroll 1
  for (int i = 0; i < N; ++i) y[i] = rhs[i];
#pragma unroll 1
  for (int i = 1; i < N; ++i)
#pragma unroll 1
    for (int j = 0; j < i; ++j) y[i] = y[i] - lu[i * N + j] * y[j];
#pragma unroll 1
  for (int i = N - 1; i >= 0; --i) {
    T acc = y[i];
#pragma unroll 1
    for (int j = i + 1; j < N; ++j) acc = acc - lu[i * N + j] * x[j];
    x[i] = acc / lu[i * N + i];
  }
}

template <typename T, int N, typename Mat>
__device__ __forceinline__ void solve_lu_rows(const Mat& lu,
                                              const T (&rhs)[N], T (&x)[N]) {
  T y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) y[i] = rhs[i];
#pragma unroll
  for (int i = 1; i < N; ++i)
#pragma unroll
    for (int j = 0; j < i; ++j) y[i] = y[i] - lu[i * N + j] * y[j];
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    T acc = y[i];
#pragma unroll
    for (int j = i + 1; j < N; ++j) acc = acc - lu[i * N + j] * x[j];
    x[i] = acc / lu[i * N + i];
  }
}

// Substitution on factors in shared memory (unrolled) or in local memory
// (rolled).
template <typename T, int N, bool kShared, typename Mat>
__device__ __forceinline__ void lane_solve(const Mat& lu, const T (&rhs)[N],
                                           T (&x)[N]) {
  if constexpr (kShared)
    solve_lu_rows<T, N>(lu, rhs, x);
  else
    solve_lu_rows_rolled<T, N>(lu, rhs, x);
}

// The twin's pow: PyTorch's, built with contraction (pow_fmad.cu) in
// double; in float the inline powf agrees with it.
__device__ __forceinline__ double k4_pow(double x, double y) {
  return janus_pow_fmad(x, y);
}
__device__ __forceinline__ float k4_pow(float x, float y) { return pow(x, y); }

// jnp.clip: NaN stays NaN
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename T>
__device__ __forceinline__ T sign_of(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
}

// sqrt(sum_i (err_i / sc_i)^2 / D), 1e10 where not finite
template <typename T, int D>
__device__ __forceinline__ T err_norm(const T (&err)[D], const T (&sc)[D]) {
  T esum = T(0);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const T r = err[i] / sc[i];
    esum = esum + r * r;
  }
  const T en = sqrt(esum / T(D));
  return isfinite(en) ? en : T(1e10);
}

// Up to max_attempts attempts for one lane; its state goes back to st.
template <typename T, typename P>
__device__ __forceinline__ void lane_attempts(
    T* __restrict__ st, const T* __restrict__ tf, const T* __restrict__ params,
    int64_t m, int64_t lane, const Consts<T>& k, int max_attempts,
    T* col) {
  constexpr int D = P::D;
  constexpr int D2 = 2 * D;
  using L = Layout<T, D>;
  // row offsets, as _row_layout
  constexpr int kT = 0, kY = 1, kF0 = 1 + D, kH = 1 + 2 * D;
  constexpr int kHOld = kH + 1, kErrOld = kH + 2, kQ = kH + 3;
  constexpr int kHPrev = kQ + 3 * D, kActive = kHPrev + 1;
  constexpr int kRejected = kActive + 1, kHaveSol = kActive + 2;
  constexpr int kNsing = kActive + 3, kStatus = kActive + 4;
  constexpr int kNsteps = kActive + 5, kNaccept = kActive + 6;
  constexpr int kNreject = kActive + 7, kNfev = kActive + 8;
  constexpr int kNnewton = kActive + 9;

  const T eps = k.eps, rtol = k.rtol, atol = k.atol;
  const T ntol = k.newton_tol;

#define ROW(r) st[(int64_t)(r) * m + lane]
  T active = ROW(kActive);
  if (!(active > T(0.5))) return;   // a fixed point: nothing to write

  T t = ROW(kT), h = ROW(kH);
  // touched at the start and the end of an attempt only
  LaneArray<T, L::kBk, L::kBkShared> bk{col + L::kBkAt * kThreads};
  T &h_old = bk[0], &err_old = bk[1], &h_prev = bk[2], &rejected = bk[3];
  T &have_sol = bk[4], &nsing = bk[5], &status = bk[6], &nsteps = bk[7];
  T &naccept = bk[8], &nreject = bk[9], &nfev = bk[10], &nnewton = bk[11];
  h_old = ROW(kHOld);
  err_old = ROW(kErrOld);
  h_prev = ROW(kHPrev);
  rejected = ROW(kRejected);
  have_sol = ROW(kHaveSol);
  nsing = ROW(kNsing);
  status = ROW(kStatus);
  nsteps = ROW(kNsteps);
  naccept = ROW(kNaccept);
  nreject = ROW(kNreject);
  nfev = ROW(kNfev);
  nnewton = ROW(kNnewton);
  T y[D];
  LaneArray<T, 3 * D, L::kQShared> q{col + L::kQ * kThreads};
  LaneArray<T, D, L::kF0Shared> f0{col + L::kF0 * kThreads};
  LaneArray<T, D * D, L::kLuShared> lu_r{col};
  LaneArray<T, 4 * D * D, L::kLuShared> lu_c{col + D * D * kThreads};
#pragma unroll
  for (int i = 0; i < D; ++i) {
    y[i] = ROW(kY + i);
    f0[i] = ROW(kF0 + i);
  }
#pragma unroll
  for (int e = 0; e < 3 * D; ++e) q[e] = ROW(kQ + e);
  T p[P::NP > 0 ? P::NP : 1];
#pragma unroll
  for (int j = 0; j < P::NP; ++j) p[j] = params[(int64_t)j * m + lane];
  const T tfv = tf[lane];

  for (int attempt = 0; attempt < max_attempts && active > T(0.5);
       ++attempt) {
    const T remaining = tfv - t;
    const bool last = fabs(h) >= fabs(remaining);
    T hh = last ? remaining : h;
    hh = hh == T(0) ? eps : hh;

    // ---- factorizations (pivot-free), the Jacobian by forward mode of the
    // inlined f written straight into them ------------------------------
    const T mr_h = k.mu_r / hh;
    const T mcr_h = k.mu_cr / hh;
    const T mci_h = k.mu_ci / hh;
#pragma unroll
    for (int jc = 0; jc < D; ++jc) {
      Dual<T> yd[D], colj[D];
#pragma unroll
      for (int i = 0; i < D; ++i)
        yd[i] = Dual<T>(y[i], i == jc ? T(1) : T(0));
      P::template f<T, Dual<T>>(t, yd, p, colj);
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const T jac = colj[i].d;
        lu_r[i * D + jc] = (i == jc ? mr_h : T(0)) - jac;
        const T arij = (i == jc ? mcr_h : T(0)) - jac;
        lu_c[i * D2 + jc] = arij;
        lu_c[i * D2 + jc + D] = i == jc ? -mci_h : T(0);
        lu_c[(i + D) * D2 + jc] = i == jc ? mci_h : T(0);
        lu_c[(i + D) * D2 + jc + D] = arij;
      }
    }
    if constexpr (L::kLuShared) {
      factor_rows<T, D>(lu_r);
      factor_rows<T, D2>(lu_c);
    } else {
      factor_rows_rolled<T, D>(lu_r);
      factor_rows_rolled<T, D2>(lu_c);
    }

    // ---- Newton warm start ---------------------------------------------
    const bool have = have_sol > T(0.5);
    T z[3][D], w[3][D];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const T th = T(1) + k.c[s] * (hh / h_prev);
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const T poly = q[0 * D + i] * th + q[1 * D + i] * th * th
                       + q[2 * D + i] * th * th * th;
        const T poly1 = q[0 * D + i] + q[1 * D + i] + q[2 * D + i];
        z[s][i] = have ? poly - poly1 : T(0);
      }
    }
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int i = 0; i < D; ++i)
        w[s][i] = k.ti_mat[s * 3 + 0] * z[0][i]
                  + k.ti_mat[s * 3 + 1] * z[1][i]
                  + k.ti_mat[s * 3 + 2] * z[2][i];
    T scale[D];
#pragma unroll
    for (int i = 0; i < D; ++i) scale[i] = atol + rtol * fabs(y[i]);

    // ---- simplified Newton: a lane leaves once it stops running --------
    T dwn_old = T(0), niter = T(0), nfev_n = T(0);
    bool running = true, converged = false;
    for (int it = 0; it < k.newton_maxiter && running; ++it) {
      T fs[3][D];
      bool finite = true;
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        T ys[D];
#pragma unroll
        for (int i = 0; i < D; ++i) ys[i] = y[i] + z[s][i];
        P::template f<T, T>(t + k.c[s] * hh, ys, p, fs[s]);
#pragma unroll
        for (int i = 0; i < D; ++i) finite = finite && isfinite(fs[s][i]);
      }
      T tif[3][D];
#pragma unroll
      for (int s = 0; s < 3; ++s)
#pragma unroll
        for (int i = 0; i < D; ++i)
          tif[s][i] = k.ti_mat[s * 3 + 0] * fs[0][i]
                      + k.ti_mat[s * 3 + 1] * fs[1][i]
                      + k.ti_mat[s * 3 + 2] * fs[2][i];
      T rhs_r[D], rhs_c[D2], dw[3][D], dwc[D2];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        rhs_r[i] = tif[0][i] - mr_h * w[0][i];
        rhs_c[i] = tif[1][i]
                   - (k.mu_cr * w[1][i] - k.mu_ci * w[2][i]) / hh;
        rhs_c[i + D] = tif[2][i]
                       - (k.mu_cr * w[2][i] + k.mu_ci * w[1][i]) / hh;
      }
      lane_solve<T, D, L::kLuShared>(lu_r, rhs_r, dw[0]);
      lane_solve<T, D2, L::kLuShared>(lu_c, rhs_c, dwc);
#pragma unroll
      for (int i = 0; i < D; ++i) {
        dw[1][i] = dwc[i];
        dw[2][i] = dwc[i + D];
      }
      T ssum = T(0);
#pragma unroll
      for (int s = 0; s < 3; ++s)
#pragma unroll
        for (int i = 0; i < D; ++i) {
          const T r = dw[s][i] / scale[i];
          ssum = ssum + r * r;
        }
      const T dwn = sqrt(ssum / T(3 * D));
      const bool hv = it > 0;
      const T rt = (hv && dwn_old > T(0))
                       ? dwn / (dwn_old == T(0) ? T(1) : dwn_old) : T(0);
      const T srt = clip(rt, T(1e-16), T(1.0 - 1e-16));
      const T left = T(k.newton_maxiter - it);
      const bool div =
          hv && (rt >= T(1) || k4_pow(srt, left) / (T(1) - srt) * dwn > ntol);
      const bool failn = !finite || div;
      const bool app = !failn;
      if (app) {
#pragma unroll
        for (int s = 0; s < 3; ++s)
#pragma unroll
          for (int i = 0; i < D; ++i) w[s][i] = w[s][i] + dw[s][i];
#pragma unroll
        for (int s = 0; s < 3; ++s)
#pragma unroll
          for (int i = 0; i < D; ++i)
            z[s][i] = k.t_mat[s * 3 + 0] * w[0][i]
                      + k.t_mat[s * 3 + 1] * w[1][i]
                      + k.t_mat[s * 3 + 2] * w[2][i];
        dwn_old = dwn;
      }
      const bool cnow = app && (dwn == T(0)
                                || (hv && rt < T(1)
                                    && srt / (T(1) - srt) * dwn < ntol));
      niter = T(it + 1);
      nfev_n = nfev_n + T(3);
      converged = converged || cnow;
      running = !failn && !cnow;
    }
    const bool conv = converged;
    const bool newton_fail = !converged;

    // ---- error estimate ------------------------------------------------
    T y_new[D], ze[D], sc[D], rhs[D], err[D], err2[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      y_new[i] = y[i] + z[2][i];
      ze[i] = (k.e[0] * z[0][i] + k.e[1] * z[1][i]
               + k.e[2] * z[2][i]) / hh;
      sc[i] = atol + rtol * fmax(fabs(y[i]), fabs(y_new[i]));
      rhs[i] = f0[i] + ze[i];
    }
    lane_solve<T, D, L::kLuShared>(lu_r, rhs, err);
    const T enorm1 = err_norm(err, sc);
    // refined estimate (always computed, as the reference kernel)
    T ye[D], fe[D];
#pragma unroll
    for (int i = 0; i < D; ++i) ye[i] = y[i] + err[i];
    P::template f<T, T>(t, ye, p, fe);
#pragma unroll
    for (int i = 0; i < D; ++i) rhs[i] = fe[i] + ze[i];
    lane_solve<T, D, L::kLuShared>(lu_r, rhs, err2);
    const T enorm2 = err_norm(err2, sc);
    T enorm = (rejected > T(0.5) && enorm1 > T(1)) ? enorm2 : enorm1;
    enorm = fmax(enorm, T(1e-16));
    const bool accept = conv && enorm <= T(1);
    const bool reject_err = conv && enorm > T(1);

    // ---- controller ----------------------------------------------------
    const T h_abs = fabs(hh);
    const T niter_s = fmax(niter, T(1));
    const T safety = k.safety_num
                     / (k.two_maxiter + niter_s);
    const bool have_old = h_old > T(0) && err_old > T(0);
    const T mult = have_old
        ? h_abs / (h_old == T(0) ? T(1) : h_old)
              * k4_pow(err_old / enorm, k.expo)
        : T(1);
    const T base = fmin(T(1), mult) * k4_pow(enorm, -k.expo);
    const T fac_rej = fmax(k.facl, safety * base);
    T fac_acc = clip(safety * base, k.facl, k.facr);
    const bool deadzone = accept && fac_acc >= k.quot1
                          && fac_acc < k.quot2;
    if (deadzone) fac_acc = T(1);

    // ---- f at the accepted point ---------------------------------------
    const T t_new = t + hh;
    T f_new[D];
    P::template f<T, T>(t_new, y_new, p, f_new);

    // ---- bookkeeping ---------------------------------------------------
    nsing = newton_fail ? nsing + T(1) : (accept ? T(0) : nsing);
    const bool stall = nsing >= T(7);
    nsteps = nsteps + T(1);
    const bool done = accept && last;
    const bool exceeded = nsteps >= k.max_steps && !done;
    const T h_next = accept ? h_abs * fac_acc
                     : reject_err ? h_abs * fac_rej
                     : newton_fail ? h_abs * T(0.5) : h_abs;
    const bool underflow = T(0.1) * h_next <= eps * fabs(t_new) && !done;
    if (done) status = k.st_success;
    if (exceeded) status = k.st_max_steps;
    if (underflow) status = k.st_underflow;
    if (stall) status = k.st_stall;

    // ---- write back (to the lane's values; stored after the last attempt)
    if (accept) {
#pragma unroll
      for (int qq = 0; qq < 3; ++qq)
#pragma unroll
        for (int i = 0; i < D; ++i)
          q[qq * D + i] = z[0][i] * k.p[0 * 3 + qq]
                          + z[1][i] * k.p[1 * 3 + qq]
                          + z[2][i] * k.p[2 * 3 + qq];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        y[i] = y_new[i];
        f0[i] = f_new[i];
      }
      t = t_new;
      h_old = h_abs;
      err_old = enorm;
      h_prev = hh;
      have_sol = T(1);
    }
    h = h_next * sign_of(hh);
    active = (!done && !exceeded && !underflow && !stall) ? T(1) : T(0);
    rejected = accept ? T(0) : ((reject_err || newton_fail) ? T(1) : rejected);
    naccept = naccept + (accept ? T(1) : T(0));
    nreject = nreject + ((reject_err || newton_fail) ? T(1) : T(0));
    nfev = nfev + (nfev_n + T(2) + T(D));
    nnewton = nnewton + niter;
  }

  ROW(kT) = t;
  ROW(kH) = h;
  ROW(kHOld) = h_old;
  ROW(kErrOld) = err_old;
  ROW(kHPrev) = h_prev;
  ROW(kActive) = active;
  ROW(kRejected) = rejected;
  ROW(kHaveSol) = have_sol;
  ROW(kNsing) = nsing;
  ROW(kStatus) = status;
  ROW(kNsteps) = nsteps;
  ROW(kNaccept) = naccept;
  ROW(kNreject) = nreject;
  ROW(kNfev) = nfev;
  ROW(kNnewton) = nnewton;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    ROW(kY + i) = y[i];
    ROW(kF0 + i) = f0[i];
  }
#pragma unroll
  for (int e = 0; e < 3 * D; ++e) ROW(kQ + e) = q[e];
#undef ROW
}

// One lane per thread.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads, (min_blocks<T, P::D>()))
radau5_step_kernel(T* __restrict__ st, const T* __restrict__ tf,
                   const T* __restrict__ params, int64_t m, Consts<T> k,
                   int max_attempts) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* const col = reinterpret_cast<T*>(smem) + threadIdx.x;
  const int64_t lane = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (lane < m)
    lane_attempts<T, P>(st, tf, params, m, lane, k, max_attempts, col);
}

constexpr int kMaxDevices = 64;

// Resident blocks per SM and SMs of the instantiation on the current
// device (occupancy query; once per device, and the shared-memory opt-in
// above 48 KB with it).
template <typename T, typename P>
cudaError_t residency(int* dev, int* blocks_per_sm, int* sms) {
  static std::atomic<int> blocks[kMaxDevices];
  static std::atomic<int> sm_count[kMaxDevices];
  constexpr size_t smem = Layout<T, P::D>::kBytes;
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  const bool cached = *dev < kMaxDevices;
  if (cached && blocks[*dev].load(std::memory_order_acquire) > 0) {
    *sms = sm_count[*dev].load(std::memory_order_relaxed);
    *blocks_per_sm = blocks[*dev].load(std::memory_order_relaxed);
    return cudaSuccess;
  }
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(radau5_step_kernel<T, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, radau5_step_kernel<T, P>, kThreads, smem);
  if (e == cudaSuccess && cached) {
    sm_count[*dev].store(*sms, std::memory_order_relaxed);
    blocks[*dev].store(*blocks_per_sm, std::memory_order_release);
  }
  return e;
}

template <typename T, typename P>
cudaError_t launch_t(void* state, const void* tf, const void* params,
                     int64_t m, const JanusRadauConsts& k, int max_attempts,
                     cudaStream_t s) {
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t e = residency<T, P>(&dev, &per_sm, &sms);  // the opt-in
  if (e != cudaSuccess) return e;
  radau5_step_kernel<T, P>
      <<<(int)((m + kThreads - 1) / kThreads), kThreads,
         Layout<T, P::D>::kBytes, s>>>(
          static_cast<T*>(state), static_cast<const T*>(tf),
          static_cast<const T*>(params), m, consts_as<T>(k), max_attempts);
  return cudaGetLastError();
}

template <typename P>
int launch(void* state, const void* tf, const void* params, int64_t m, int d,
           int n_params, int dtype, const JanusRadauConsts& k,
           int max_attempts, cudaStream_t s) {
  if (d != P::D || n_params != P::NP) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)launch_t<double, P>(state, tf, params, m, k, max_attempts, s);
  return (int)launch_t<float, P>(state, tf, params, m, k, max_attempts, s);
}

// out[0..5]: registers per thread, local (spill) bytes per thread, dynamic
// shared bytes per block, per-lane values in shared memory, resident blocks
// per SM, SMs.
template <typename T, typename P>
int attributes_t(int* out) {
  int dev = 0;
  cudaFuncAttributes a;
  cudaError_t e = residency<T, P>(&dev, &out[4], &out[5]);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, radau5_step_kernel<T, P>);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)Layout<T, P::D>::kBytes;
  out[3] = Layout<T, P::D>::kSlots;
  return 0;
}

template <typename P>
int attributes(int dtype, int* out) {
  return dtype == 1 ? attributes_t<double, P>(out)
                    : attributes_t<float, P>(out);
}

}  // namespace
