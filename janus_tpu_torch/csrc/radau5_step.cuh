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
// Shape of the work: an attempt is a few thousand dependent flops
// (divides, sqrt and pow among them) on ~100 values a lane plus the 5 D^2
// values of the two factors, against ~(5D+15) loads and stores a launch, so
// the kernel is bound by latency, and how much of it an SM hides depends on
// how many warps it holds: on registers. Two layouts, chosen at compile
// time by D (measurements in PERF.md, by janus_tpu_torch/bench/kernels.py
// and bench/fused_any.py):
// - the lane layout, at D <= 4 and D = 5, 6 in float (lane_attempts): one
//   lane a thread, 128 a block. At most
//   128 registers a thread (__launch_bounds__(128, 4)): 16 warps on each
//   SM, 67,584 lanes resident on 132 SMs, so 65,536 lanes run in one wave;
//   D >= 3 in double asks for 2 blocks (up to 255 registers, 8 warps),
//   where it spills nothing (min_blocks). What does not fit is per-lane
//   state in shared memory, element-major (element e of the thread's lane
//   at smem[e * 128 + threadIdx.x], so a warp touches 32 neighbouring
//   words: no bank conflicts): the factors lu_r [D][D] and lu_c [2D][2D],
//   and, where a block's share of the SM still holds them, what is touched
//   only at the start and the end of an attempt: q [3][D], f0 [D] and 12
//   bookkeeping scalars (Layout below; D = 2 f64: 40 values, 40 KB a
//   block; D = 5, 6 in float at 2 blocks a SM, where the group layout
//   measured 3-5x slower). ptxas still spills 120 B a thread of VdP in
//   double. A
//   persistent grid whose warps take lanes from a counter measured no
//   faster at one wave and slower beyond it, so there is none.
// - the group layout, at D = 5..8 in double and 7..8 in float (generated
//   functors only; group_attempts): the factors, up to 2,560 B a lane in
//   double, fit no block's share of shared memory at one lane a thread;
//   in the thread's local memory they make the kernel bound by that
//   memory's traffic (125 MB live at D = 8, past the 50 MB L2), and in
//   registers they take 80 of a thread's 128 and push the rest into local
//   memory. So a lane spreads over a group of 8 threads of one warp, 16
//   lanes a block, and thread i < D keeps row i of lu_r and rows i and
//   i + D of lu_c (5 D values, 320 B at D = 8 in double) in shared memory,
//   element-major over the block's threads (SmemRows; 40 KB a block, 4
//   blocks a SM at D = 8 in double), and component i of every per-lane
//   vector in registers. Only a thread itself touches its rows. An
//   elimination broadcasts pivot row k from its owner by shuffles and each
//   thread updates its rows; a substitution
//   broadcasts y[j] and x[i] as they become final, back substitution
//   staying a dependent chain (row i sums its terms in increasing j); the
//   two factorizations, and the two solves of a Newton trip, run step by
//   step side by side. The D Jacobian columns and the three stages of f run
//   on different threads, and a small scratch in shared memory turns
//   columns into rows and stages into components. The scalars run on every
//   thread on identical values, so a group takes every branch together.
//   The geometry (threads a lane, lanes a block, blocks a SM asked of the
//   register allocator, the scratch) is chosen in Python
//   (ops/radau_fused.py:geometry) and compiled into the unit; the launch
//   refuses any other. It stays latency bound, by the dependent chains of
//   the substitutions and the eliminations, each step a shuffle, a
//   shared-memory read and a divide.
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
// D = 5, 6 in float (generated functors) asks for 2.
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
// still fit on one SM. The factors of D <= 4 always fit, and of D = 5, 6
// in float; the rest take the group layout below.
template <typename T, int D>
struct Layout {
  static constexpr int kLu = 5 * D * D;  // lu_r D*D, then lu_c 4*D*D
  static constexpr int kBk = 12;         // the bookkeeping scalars
  static_assert(smem_fits<T, D>(kLu),
                "K4: one lane a thread where the factors fit shared memory");
  static constexpr int kLuSlots = kLu;
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
  LaneArray<T, D * D, true> lu_r{col};
  LaneArray<T, 4 * D * D, true> lu_c{col + D * D * kThreads};
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
    factor_rows<T, D>(lu_r);
    factor_rows<T, D2>(lu_c);

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
      solve_lu_rows<T, D>(lu_r, rhs_r, dw[0]);
      solve_lu_rows<T, D2>(lu_c, rhs_c, dwc);
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
    solve_lu_rows<T, D>(lu_r, rhs, err);
    const T enorm1 = err_norm(err, sc);
    // refined estimate (always computed, as the reference kernel)
    T ye[D], fe[D];
#pragma unroll
    for (int i = 0; i < D; ++i) ye[i] = y[i] + err[i];
    P::template f<T, T>(t, ye, p, fe);
#pragma unroll
    for (int i = 0; i < D; ++i) rhs[i] = fe[i] + ze[i];
    solve_lu_rows<T, D>(lu_r, rhs, err2);
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

// out[0..7]: registers per thread, local (spill) bytes per thread, dynamic
// shared bytes per block, per-lane values in shared memory, resident blocks
// per SM, SMs, threads a lane, lanes a block.
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
  out[6] = 1;
  out[7] = kThreads;
  return 0;
}

// launch_t for a generated unit at D <= 4, given the geometry the caller
// computed (ops/radau_fused.py:geometry): one lane a thread, kThreads lanes
// a block, no exchange scratch (Layout sizes the per-lane arrays it keeps in
// shared memory); cudaErrorInvalidValue for any other.
template <typename T, typename P>
cudaError_t launch_lanes(void* state, const void* tf, const void* params,
                         int64_t m, const JanusRadauConsts& k,
                         int max_attempts, int threads_per_lane,
                         int lanes_per_block, int64_t smem_bytes,
                         cudaStream_t s) {
  if (threads_per_lane != 1 || lanes_per_block != kThreads
      || smem_bytes != 0)
    return cudaErrorInvalidValue;
  return launch_t<T, P>(state, tf, params, m, k, max_attempts, s);
}

template <typename P>
int attributes(int dtype, int* out) {
  return dtype == 1 ? attributes_t<double, P>(out)
                    : attributes_t<float, P>(out);
}

// ---- the group layout: D = 5..8 in double, 7..8 in float ----------------------

// The geometry of a group instantiation, chosen by
// janus_tpu_torch/ops/radau_fused.py:geometry and written into the generated
// unit: G threads a lane, kLanes lanes a block, kMinBlocks blocks a SM asked
// of the register allocator, kScratch values of T a lane of exchange scratch
// in shared memory (lane-major, after the factors: group_smem_bytes).
template <int G_, int Lanes, int MinBlocks, int Scratch>
struct GroupGeometry {
  static constexpr int G = G_;
  static constexpr int kLanes = Lanes;
  static constexpr int kThreads = G_ * Lanes;
  static constexpr int kMinBlocks = MinBlocks;
  static constexpr int kScratch = Scratch;
  static_assert(32 % G_ == 0 && kThreads % 32 == 0 && kThreads <= 1024,
                "K4: a group lies in one warp, a block is whole warps");
};

// A block's dynamic shared memory: the factors, 5 D values a thread
// (SmemRows, element major), then kScratch values a lane.
template <typename T, int D, typename Geo>
constexpr size_t group_smem_bytes() {
  return ((size_t)5 * D * Geo::kThreads + (size_t)Geo::kLanes * Geo::kScratch)
         * sizeof(T);
}

// One lane's G threads, all in one warp: thread `me` of the group, the
// group's own lanes of the warp in `mask`.
template <int G>
struct Group {
  unsigned mask;
  int me;
  template <typename T>
  __device__ __forceinline__ T from(T v, int src) const {
    return __shfl_sync(mask, v, src, G);
  }
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
  __device__ __forceinline__ bool all(bool p) const {
    return __all_sync(mask, p) != 0;
  }
};

// This thread's R rows of N values of a factor in shared memory, element
// major over the block's Stride threads: value (r, j) at
// p[(r * N + j) * Stride], p = the factor's array + threadIdx.x, so a
// warp's 32 threads touch 32 neighbouring values (no bank conflicts). Only
// the thread itself reads and writes its rows; the others get a value of
// them by a shuffle.
template <typename T, int R, int N, int Stride>
struct SmemRows {
  T* p;
  __device__ __forceinline__ T& operator()(int r, int j) const {
    return p[(r * N + j) * Stride];
  }
};

// Step k of the in-place pivot-free elimination of the (R*D) x (R*D) matrix
// of which this thread holds rows me + r*D (r < R) in a (a thread with
// me >= D holds padding rows, never read): factor_rows's operations on each
// row below the pivot, element for element, with pivot row k broadcast
// from its owner (thread k % D).
template <typename T, int D, int R, int G, typename Rows>
__device__ __forceinline__ void factor_step(const Group<G>& g, const Rows& a,
                                            int k) {
  constexpr int N = R * D;
  T piv[N];
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j >= k) piv[j] = g.from(a(k / D, j), k % D);
  const T inv = T(1) / piv[k];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (g.me + r * D > k) {
      const T mul = a(r, k) * inv;
      a(r, k) = mul;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j > k) a(r, j) = a(r, j) - mul * piv[j];
    }
  }
}

// Both factorizations of an attempt, lu_r (D x D, row me) and lu_c
// (2D x 2D, rows me and me + D), their steps interleaved; each in the k
// order of factor_rows.
template <typename T, int D, int G, typename RowsR, typename RowsC>
__device__ __forceinline__ void group_factor(const Group<G>& g,
                                             const RowsR& lr,
                                             const RowsC& lc) {
#pragma unroll
  for (int k = 0; k < 2 * D; ++k) {
    factor_step<T, D, 2>(g, lc, k);
    if (k < D) factor_step<T, D, 1>(g, lr, k);
  }
}

// Substitution on the factors of factor_step with this thread's right-hand
// side entries y[r] (row me + r*D), in place: solve_lu_rows's operations
// element for element. Forward step j: y[j] broadcast once final, each row
// below subtracts its term (in increasing j, row by row). Back step i: row
// i sums its terms in increasing j once every x[j > i] is known, a
// dependent chain as in solve_lu_rows; x[i] is broadcast, and kept in
// mine[i / D] by its owner. Every thread ends with the whole x.
template <typename T, int D, int R, int G, typename Rows>
__device__ __forceinline__ void forward_step(const Group<G>& g, const Rows& a,
                                             T (&y)[R], int j) {
  const T yj = g.from(y[j / D], j % D);
#pragma unroll
  for (int r = 0; r < R; ++r)
    y[r] = g.me + r * D > j ? y[r] - a(r, j) * yj : y[r];
}

template <typename T, int D, int R, int G, typename Rows>
__device__ __forceinline__ void back_step(const Group<G>& g, const Rows& a,
                                          const T (&y)[R], T (&x)[R * D],
                                          T (&mine)[R], int i) {
  constexpr int N = R * D;
  T acc = y[i / D];
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j > i) acc = acc - a(i / D, j) * x[j];
  x[i] = g.from(acc / a(i / D, i), i % D);
  mine[i / D] = g.me == i % D ? x[i] : mine[i / D];
}

// One solve on lu_r: right-hand side entry b (row me); x whole, x[me] in
// mine.
template <typename T, int D, int G, typename RowsR>
__device__ __forceinline__ void group_solve(const Group<G>& g,
                                            const RowsR& lr, T b, T (&x)[D],
                                            T& mine) {
  T y[1] = {b}, m[1] = {T(0)};
#pragma unroll
  for (int j = 0; j < D - 1; ++j) forward_step<T, D, 1>(g, lr, y, j);
#pragma unroll
  for (int i = D - 1; i >= 0; --i) back_step<T, D, 1>(g, lr, y, x, m, i);
  mine = m[0];
}

// The two solves of a Newton trip, on lu_r (right-hand side br, row me)
// and lu_c (bc, rows me and me + D), their steps interleaved; this
// thread's solution entries in mr and mc.
template <typename T, int D, int G, typename RowsR, typename RowsC>
__device__ __forceinline__ void group_solve2(const Group<G>& g,
                                             const RowsR& lr, const RowsC& lc,
                                             T br, const T (&bc)[2], T& mr,
                                             T (&mc)[2]) {
  T yr[1] = {br}, yc[2] = {bc[0], bc[1]}, xr[D], xc[2 * D];
  T m1[1] = {T(0)};
  mc[0] = mc[1] = T(0);
#pragma unroll
  for (int j = 0; j < 2 * D - 1; ++j) {
    forward_step<T, D, 2>(g, lc, yc, j);
    if (j < D - 1) forward_step<T, D, 1>(g, lr, yr, j);
  }
#pragma unroll
  for (int s = 0; s < 2 * D; ++s) {
    back_step<T, D, 2>(g, lc, yc, xc, mc, 2 * D - 1 - s);
    if (s < D) back_step<T, D, 1>(g, lr, yr, xr, m1, D - 1 - s);
  }
  mr = m1[0];
}

// sqrt(sum_i (err_i / sc_i)^2 / D), 1e10 where not finite, as err_norm:
// thread i holds err_i and sc_i; the terms are added in increasing i on
// every thread.
template <typename T, int D, int G>
__device__ __forceinline__ T group_err_norm(const Group<G>& g, T err, T sc) {
  const T r = err / sc;
  const T term = r * r;
  T esum = T(0);
#pragma unroll
  for (int i = 0; i < D; ++i) esum = esum + g.from(term, i);
  const T en = sqrt(esum / T(D));
  return isfinite(en) ? en : T(1e10);
}

// v[me] of an array every thread holds (v[0] on padding threads).
template <typename T, int D>
__device__ __forceinline__ T entry(const T (&v)[D], int me) {
  T out = v[0];
#pragma unroll
  for (int i = 1; i < D; ++i) out = me == i ? v[i] : out;
  return out;
}

// Clock marks between the phases of group_attempts, compiled only into a
// unit built with JANUS_K4_CLOCKS defined (janus_tpu_torch/bench/k4_layout.py,
// which reads them by janus_k4_clocks_read): the cycles of each phase summed
// over the attempts of thread 0 of every group, K4_TICK(i) charging phase i
// with the cycles since the last mark, slot 9 counting the attempts. In any
// other build they are nothing.
#ifdef JANUS_K4_CLOCKS
__device__ unsigned long long janus_k4_clocks[16];
#define K4_CLOCK_START                       \
  unsigned long long k4_ck[10] = {};         \
  long long k4_c0 = clock64()
#define K4_TICK(i)                                           \
  do {                                                       \
    const long long k4_c1 = clock64();                       \
    k4_ck[i] += (unsigned long long)(k4_c1 - k4_c0);         \
    k4_c0 = k4_c1;                                           \
  } while (0)
#define K4_COUNT_ATTEMPT (++k4_ck[9])
#define K4_CLOCK_END                                                    \
  do {                                                                  \
    if (g.me == 0)                                                      \
      for (int i = 0; i < 10; ++i) atomicAdd(&janus_k4_clocks[i], k4_ck[i]); \
  } while (0)
#else
#define K4_CLOCK_START
#define K4_TICK(i)
#define K4_COUNT_ATTEMPT
#define K4_CLOCK_END
#endif

// Up to max_attempts attempts for one lane on its group: lane_attempts's
// arithmetic, element for element. Thread me < D holds component me of
// every per-lane vector (y, f0, q, z, w, the scales, the right-hand sides),
// and row me of lu_r and rows me and me + D of lu_c at fac (its column of
// the block's factors in shared memory); every thread holds y
// whole and the scalars. Each thread evaluates Jacobian column me and stage
// me % 3 of f; the scratch carries the columns into rows and the stages
// into components. The group writes each state row once.
template <typename T, typename P, typename Geo>
__device__ __forceinline__ void group_attempts(
    T* __restrict__ st, const T* __restrict__ tf, const T* __restrict__ params,
    int64_t m, int64_t lane, const Consts<T>& k, int max_attempts,
    T* __restrict__ fac, T* __restrict__ sc, const Group<Geo::G>& g) {
  constexpr int D = P::D;
  static_assert(D <= Geo::G && Geo::G >= 3, "K4: a group holds D rows");
  static_assert(Geo::kScratch >= D * D && Geo::kScratch >= 6 * D,
                "K4: the scratch holds the Jacobian and the stages");
  constexpr int kZ = 0, kF = 3 * D;   // stage scratch: z[s][i], f_s[i]
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
  const int me = g.me;
  const bool owns = me < D;
  const int ci = owns ? me : 0;       // padding threads read component 0
  // this thread's rows of the factors, in shared memory
  const SmemRows<T, 1, D, Geo::kThreads> lr{fac};
  const SmemRows<T, 2, 2 * D, Geo::kThreads> lc{fac + D * Geo::kThreads};
  K4_CLOCK_START;

#define ROW(r) st[(int64_t)(r) * m + lane]
  T active = ROW(kActive);
  if (!(active > T(0.5))) return;   // the whole group: nothing to write

  T t = ROW(kT), h = ROW(kH);
  T h_old = ROW(kHOld), err_old = ROW(kErrOld), h_prev = ROW(kHPrev);
  T rejected = ROW(kRejected), have_sol = ROW(kHaveSol);
  T nsing = ROW(kNsing), status = ROW(kStatus), nsteps = ROW(kNsteps);
  T naccept = ROW(kNaccept), nreject = ROW(kNreject), nfev = ROW(kNfev);
  T nnewton = ROW(kNnewton);
  T y[D];
#pragma unroll
  for (int i = 0; i < D; ++i) y[i] = ROW(kY + i);
  T ym = ROW(kY + ci), f0m = ROW(kF0 + ci);
  T qm[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) qm[s] = ROW(kQ + s * D + ci);
  T p[P::NP > 0 ? P::NP : 1];
#pragma unroll
  for (int j = 0; j < P::NP; ++j) p[j] = params[(int64_t)j * m + lane];
  const T tfv = tf[lane];
  const int sm = me % 3;              // the stage this thread evaluates
  const T c_sm = sm == 0 ? k.c[0] : (sm == 1 ? k.c[1] : k.c[2]);

  for (int attempt = 0; attempt < max_attempts && active > T(0.5);
       ++attempt) {
    const T remaining = tfv - t;
    const bool last = fabs(h) >= fabs(remaining);
    T hh = last ? remaining : h;
    hh = hh == T(0) ? eps : hh;

    // ---- factorizations (pivot-free): Jacobian column me by forward mode
    // of the inlined f, through the scratch into rows ---------------------
    K4_TICK(8);
    K4_COUNT_ATTEMPT;
    const T mr_h = k.mu_r / hh;
    const T mcr_h = k.mu_cr / hh;
    const T mci_h = k.mu_ci / hh;
    g.sync();                         // the last reads of the scratch
    {
      Dual<T> yd[D], colj[D];
#pragma unroll
      for (int i = 0; i < D; ++i)
        yd[i] = Dual<T>(y[i], i == me ? T(1) : T(0));
      P::template f<T, Dual<T>>(t, yd, p, colj);
      if (owns) {
#pragma unroll
        for (int i = 0; i < D; ++i) sc[i * D + me] = colj[i].d;
      }
    }
    g.sync();
#pragma unroll
    for (int jc = 0; jc < D; ++jc) {
      const T jac = owns ? sc[me * D + jc] : T(0);
      lr(0, jc) = (me == jc ? mr_h : T(0)) - jac;
      const T arij = (me == jc ? mcr_h : T(0)) - jac;
      lc(0, jc) = arij;
      lc(0, jc + D) = me == jc ? -mci_h : T(0);
      lc(1, jc) = me == jc ? mci_h : T(0);
      lc(1, jc + D) = arij;
    }
    g.sync();                         // read before the stages reuse it
    K4_TICK(0);
    group_factor<T, D>(g, lr, lc);
    K4_TICK(1);

    // ---- Newton warm start ---------------------------------------------
    const bool have = have_sol > T(0.5);
    T z[3], w[3];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const T th = T(1) + k.c[s] * (hh / h_prev);
      const T poly = qm[0] * th + qm[1] * th * th + qm[2] * th * th * th;
      const T poly1 = qm[0] + qm[1] + qm[2];
      z[s] = have ? poly - poly1 : T(0);
    }
#pragma unroll
    for (int s = 0; s < 3; ++s)
      w[s] = k.ti_mat[s * 3 + 0] * z[0] + k.ti_mat[s * 3 + 1] * z[1]
             + k.ti_mat[s * 3 + 2] * z[2];
    const T scale = atol + rtol * fabs(ym);

    K4_TICK(2);
    // ---- simplified Newton: the group leaves once its lane stops running
    const T t_sm = t + c_sm * hh;
    T dwn_old = T(0), niter = T(0), nfev_n = T(0);
    bool running = true, converged = false;
    for (int it = 0; it < k.newton_maxiter && running; ++it) {
      K4_TICK(5);
      if (owns) {
#pragma unroll
        for (int s = 0; s < 3; ++s) sc[kZ + s * D + me] = z[s];
      }
      g.sync();
      T ys[D], fs[D];
#pragma unroll
      for (int i = 0; i < D; ++i) ys[i] = y[i] + sc[kZ + sm * D + i];
      P::template f<T, T>(t_sm, ys, p, fs);
      bool fin = true;
#pragma unroll
      for (int i = 0; i < D; ++i) fin = fin && isfinite(fs[i]);
      const bool finite = g.all(fin);
      if (me < 3) {
#pragma unroll
        for (int i = 0; i < D; ++i) sc[kF + me * D + i] = fs[i];
      }
      g.sync();
      T fsm[3];
#pragma unroll
      for (int s = 0; s < 3; ++s) fsm[s] = owns ? sc[kF + s * D + me] : T(0);
      T tif[3];
#pragma unroll
      for (int s = 0; s < 3; ++s)
        tif[s] = k.ti_mat[s * 3 + 0] * fsm[0] + k.ti_mat[s * 3 + 1] * fsm[1]
                 + k.ti_mat[s * 3 + 2] * fsm[2];
      const T rhs_r = tif[0] - mr_h * w[0];
      const T rhs_c[2] = {
          tif[1] - (k.mu_cr * w[1] - k.mu_ci * w[2]) / hh,
          tif[2] - (k.mu_cr * w[2] + k.mu_ci * w[1]) / hh};
      T dw[3], dc[2];
      K4_TICK(3);
      group_solve2<T, D>(g, lr, lc, rhs_r, rhs_c, dw[0], dc);
      K4_TICK(4);
      dw[1] = dc[0];
      dw[2] = dc[1];
      T ssum = T(0);
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const T r = dw[s] / scale;
        const T term = r * r;
#pragma unroll
        for (int i = 0; i < D; ++i) ssum = ssum + g.from(term, i);
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
        for (int s = 0; s < 3; ++s) w[s] = w[s] + dw[s];
#pragma unroll
        for (int s = 0; s < 3; ++s)
          z[s] = k.t_mat[s * 3 + 0] * w[0] + k.t_mat[s * 3 + 1] * w[1]
                 + k.t_mat[s * 3 + 2] * w[2];
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
    K4_TICK(5);
    const bool conv = converged;
    const bool newton_fail = !converged;

    // ---- f at the accepted point (needed only on accept; computed here,
    // beside the error estimate, which does not depend on it) ------------
    const T y_newm = ym + z[2];
    const T t_new = t + hh;
    T y_new[D], f_new[D];
#pragma unroll
    for (int i = 0; i < D; ++i) y_new[i] = g.from(y_newm, i);
    P::template f<T, T>(t_new, y_new, p, f_new);

    // ---- error estimate ------------------------------------------------
    const T ze = (k.e[0] * z[0] + k.e[1] * z[1] + k.e[2] * z[2]) / hh;
    const T scm = atol + rtol * fmax(fabs(ym), fabs(y_newm));
    T err[D], em;
    group_solve<T, D>(g, lr, f0m + ze, err, em);
    const T enorm1 = group_err_norm<T, D>(g, em, scm);
    // refined estimate (always computed, as the reference kernel)
    T ye[D], fe[D];
#pragma unroll
    for (int i = 0; i < D; ++i) ye[i] = y[i] + err[i];
    P::template f<T, T>(t, ye, p, fe);
    group_solve<T, D>(g, lr, entry(fe, me) + ze, err, em);
    const T enorm2 = group_err_norm<T, D>(g, em, scm);
    T enorm = (rejected > T(0.5) && enorm1 > T(1)) ? enorm2 : enorm1;
    enorm = fmax(enorm, T(1e-16));
    const bool accept = conv && enorm <= T(1);
    const bool reject_err = conv && enorm > T(1);

    K4_TICK(6);
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
        qm[qq] = z[0] * k.p[0 * 3 + qq] + z[1] * k.p[1 * 3 + qq]
                 + z[2] * k.p[2 * 3 + qq];
#pragma unroll
      for (int i = 0; i < D; ++i) y[i] = y_new[i];
      ym = y_newm;
      f0m = entry(f_new, me);
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
    K4_TICK(7);
  }
  K4_CLOCK_END;

  if (me == 0) {
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
  }
  if (owns) {
    ROW(kY + me) = ym;
    ROW(kF0 + me) = f0m;
#pragma unroll
    for (int s = 0; s < 3; ++s) ROW(kQ + s * D + me) = qm[s];
  }
#undef ROW
}

// G threads a lane, Geo::kLanes lanes a block; a group whose lane is past
// the last returns before its first exchange.
template <typename T, typename P, typename Geo>
__global__ void __launch_bounds__(Geo::kThreads, Geo::kMinBlocks)
radau5_group_kernel(T* __restrict__ st, const T* __restrict__ tf,
                    const T* __restrict__ params, int64_t m, Consts<T> k,
                    int max_attempts) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int G = Geo::G;
  const int slot = threadIdx.x / G;
  const int64_t lane = (int64_t)blockIdx.x * Geo::kLanes + slot;
  if (lane >= m) return;
  Group<G> g;
  g.me = threadIdx.x % G;
  g.mask = (G == 32 ? 0xffffffffu : ((1u << G) - 1u))
           << ((threadIdx.x & 31) & ~(G - 1));
  T* const fac = reinterpret_cast<T*>(smem);
  T* const sc = fac + 5 * P::D * Geo::kThreads + slot * Geo::kScratch;
  group_attempts<T, P, Geo>(st, tf, params, m, lane, k, max_attempts,
                            fac + threadIdx.x, sc, g);
}

// Blocks resident per SM and SMs of a group instantiation on the current
// device (occupancy query, once per device; the shared-memory opt-in above
// 48 KB with it).
template <typename T, typename P, typename Geo>
cudaError_t group_residency(int* dev, int* blocks_per_sm, int* sms) {
  static std::atomic<int> blocks[kMaxDevices];
  static std::atomic<int> sm_count[kMaxDevices];
  constexpr size_t smem = group_smem_bytes<T, P::D, Geo>();
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  const bool cached = *dev < kMaxDevices;
  if (cached && blocks[*dev].load(std::memory_order_acquire) > 0) {
    *sms = sm_count[*dev].load(std::memory_order_relaxed);
    *blocks_per_sm = blocks[*dev].load(std::memory_order_relaxed);
    return cudaSuccess;
  }
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(radau5_group_kernel<T, P, Geo>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, radau5_group_kernel<T, P, Geo>, Geo::kThreads, smem);
  if (e == cudaSuccess && cached) {
    sm_count[*dev].store(*sms, std::memory_order_relaxed);
    blocks[*dev].store(*blocks_per_sm, std::memory_order_release);
  }
  return e;
}

// K4 in the group layout with the geometry the caller computed
// (ops/radau_fused.py:geometry): cudaErrorInvalidValue unless it is the one
// the unit was built for.
template <typename T, typename P, typename Geo>
cudaError_t launch_group(void* state, const void* tf, const void* params,
                         int64_t m, const JanusRadauConsts& k,
                         int max_attempts, int threads_per_lane,
                         int lanes_per_block, int64_t smem_bytes,
                         cudaStream_t s) {
  constexpr size_t smem = group_smem_bytes<T, P::D, Geo>();
  static_assert((smem + kSmemPerBlockReserved) * Geo::kMinBlocks <= kSmemPerSm,
                "K4: kMinBlocks blocks of the group layout fit an SM");
  if (threads_per_lane != Geo::G || lanes_per_block != Geo::kLanes
      || smem_bytes != (int64_t)smem)
    return cudaErrorInvalidValue;
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t e = group_residency<T, P, Geo>(&dev, &per_sm, &sms);
  if (e != cudaSuccess) return e;
  radau5_group_kernel<T, P, Geo>
      <<<(int)((m + Geo::kLanes - 1) / Geo::kLanes), Geo::kThreads, smem,
         s>>>(static_cast<T*>(state), static_cast<const T*>(tf),
              static_cast<const T*>(params), m, consts_as<T>(k),
              max_attempts);
  return cudaGetLastError();
}

// out[0..7] as attributes_t, for a group instantiation.
template <typename T, typename P, typename Geo>
int group_attributes(int* out) {
  int dev = 0;
  cudaFuncAttributes a;
  cudaError_t e = group_residency<T, P, Geo>(&dev, &out[4], &out[5]);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&a, radau5_group_kernel<T, P, Geo>);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)group_smem_bytes<T, P::D, Geo>();
  out[3] = Geo::kScratch;
  out[6] = Geo::G;
  out[7] = Geo::kLanes;
  return 0;
}

}  // namespace

#ifdef JANUS_K4_CLOCKS
// The clock marks' sums (16 slots), zeroed after the read if reset.
extern "C" int janus_k4_clocks_read(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, janus_k4_clocks,
                                       sizeof(unsigned long long) * 16);
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[16] = {};
    e = cudaMemcpyToSymbol(janus_k4_clocks, zero, sizeof(zero));
  }
  return (int)e;
}
#endif
