// Fused Radau5 (s=3) step attempt (K4): one whole attempt per lane, for
// sm_90a.
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
// Shape of the work: one thread per lane; the lane's rows, Jacobian,
// factors and Newton iterates live in registers. Each attempt is a few
// thousand dependent flops (divides, sqrt and pow among them) on ~100
// values per lane, against ~(5D+15) loads and stores per launch, so the
// kernel is bound by latency and by registers, not by memory: at D = 3 in
// f64 the live state is close to the 255-register limit (see ptxas -v in
// PERF.md). Two choices the TPU kernel could not make, neither of which
// changes a number:
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
// float at use, as JAX's weak typing does. Built with -fmad=false
// (ops/_build.py:NVCC_FLAGS): the step's cancellations turn FMA rounding
// differences into visible ones (3.7e-9 of h in f64 after one attempt), and
// without contraction the kernel does the plain version's IEEE operations,
// so the two agree to the bit on the card.
//
// f and its Jacobian columns come from the device functors of problems.cuh
// (forward mode through Dual<T>); the dispatch below names them.
//
// C interface (ctypes): returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an unknown problem or a D / parameter count
// that does not match the functor; dtype 0 = float, 1 = double.

#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

#include "dual.cuh"
#include "problems.cuh"

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

constexpr int kThreads = 128;

template <typename T, int N>
__device__ __forceinline__ void factor_rows(T (&a)[N][N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const T inv = T(1) / a[k][k];
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const T m = a[i][k] * inv;
      a[i][k] = m;
#pragma unroll
      for (int j = k + 1; j < N; ++j) a[i][j] = a[i][j] - m * a[k][j];
    }
  }
}

template <typename T, int N>
__device__ __forceinline__ void solve_lu_rows(const T (&lu)[N][N],
                                              const T (&rhs)[N], T (&x)[N]) {
  T y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) y[i] = rhs[i];
#pragma unroll
  for (int i = 1; i < N; ++i)
#pragma unroll
    for (int j = 0; j < i; ++j) y[i] = y[i] - lu[i][j] * y[j];
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    T acc = y[i];
#pragma unroll
    for (int j = i + 1; j < N; ++j) acc = acc - lu[i][j] * x[j];
    x[i] = acc / lu[i][i];
  }
}

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

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
radau5_step_kernel(T* __restrict__ st, const T* __restrict__ tf,
                   const T* __restrict__ params, int64_t m,
                   JanusRadauConsts k, int max_attempts) {
  constexpr int D = P::D;
  constexpr int D2 = 2 * D;
  // row offsets, as _row_layout
  constexpr int kT = 0, kY = 1, kF0 = 1 + D, kH = 1 + 2 * D;
  constexpr int kHOld = kH + 1, kErrOld = kH + 2, kQ = kH + 3;
  constexpr int kHPrev = kQ + 3 * D, kActive = kHPrev + 1;
  constexpr int kRejected = kActive + 1, kHaveSol = kActive + 2;
  constexpr int kNsing = kActive + 3, kStatus = kActive + 4;
  constexpr int kNsteps = kActive + 5, kNaccept = kActive + 6;
  constexpr int kNreject = kActive + 7, kNfev = kActive + 8;
  constexpr int kNnewton = kActive + 9;

  const T eps = T(k.eps), rtol = T(k.rtol), atol = T(k.atol);
  const T ntol = T(k.newton_tol);

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       lane < m; lane += stride) {
#define ROW(r) st[(int64_t)(r) * m + lane]
    T active = ROW(kActive);
    if (!(active > T(0.5))) continue;   // a fixed point: nothing to write

    T t = ROW(kT), h = ROW(kH), h_old = ROW(kHOld), err_old = ROW(kErrOld);
    T h_prev = ROW(kHPrev), rejected = ROW(kRejected);
    T have_sol = ROW(kHaveSol), nsing = ROW(kNsing), status = ROW(kStatus);
    T nsteps = ROW(kNsteps), naccept = ROW(kNaccept);
    T nreject = ROW(kNreject), nfev = ROW(kNfev), nnewton = ROW(kNnewton);
    T y[D], f0[D], q[3][D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      y[i] = ROW(kY + i);
      f0[i] = ROW(kF0 + i);
    }
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int i = 0; i < D; ++i) q[s][i] = ROW(kQ + s * D + i);
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

      // ---- Jacobian by forward mode of the inlined f ---------------------
      T jac[D][D];
#pragma unroll
      for (int jc = 0; jc < D; ++jc) {
        Dual<T> yd[D], col[D];
#pragma unroll
        for (int i = 0; i < D; ++i)
          yd[i] = Dual<T>(y[i], i == jc ? T(1) : T(0));
        P::template f<T, Dual<T>>(t, yd, p, col);
#pragma unroll
        for (int i = 0; i < D; ++i) jac[i][jc] = col[i].d;
      }

      // ---- factorizations (pivot-free, in registers) ---------------------
      const T mr_h = T(k.mu_r) / hh;
      const T mcr_h = T(k.mu_cr) / hh;
      const T mci_h = T(k.mu_ci) / hh;
      T lu_r[D][D], lu_c[D2][D2];
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) {
          lu_r[i][j] = (i == j ? mr_h : T(0)) - jac[i][j];
          const T arij = (i == j ? mcr_h : T(0)) - jac[i][j];
          lu_c[i][j] = arij;
          lu_c[i][j + D] = i == j ? -mci_h : T(0);
          lu_c[i + D][j] = i == j ? mci_h : T(0);
          lu_c[i + D][j + D] = arij;
        }
      factor_rows(lu_r);
      factor_rows(lu_c);

      // ---- Newton warm start ---------------------------------------------
      const bool have = have_sol > T(0.5);
      T z[3][D], w[3][D];
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const T th = T(1) + T(k.c[s]) * (hh / h_prev);
#pragma unroll
        for (int i = 0; i < D; ++i) {
          const T poly = q[0][i] * th + q[1][i] * th * th
                         + q[2][i] * th * th * th;
          const T poly1 = q[0][i] + q[1][i] + q[2][i];
          z[s][i] = have ? poly - poly1 : T(0);
        }
      }
#pragma unroll
      for (int s = 0; s < 3; ++s)
#pragma unroll
        for (int i = 0; i < D; ++i)
          w[s][i] = T(k.ti_mat[s * 3 + 0]) * z[0][i]
                    + T(k.ti_mat[s * 3 + 1]) * z[1][i]
                    + T(k.ti_mat[s * 3 + 2]) * z[2][i];
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
          P::template f<T, T>(t + T(k.c[s]) * hh, ys, p, fs[s]);
#pragma unroll
          for (int i = 0; i < D; ++i) finite = finite && isfinite(fs[s][i]);
        }
        T tif[3][D];
#pragma unroll
        for (int s = 0; s < 3; ++s)
#pragma unroll
          for (int i = 0; i < D; ++i)
            tif[s][i] = T(k.ti_mat[s * 3 + 0]) * fs[0][i]
                        + T(k.ti_mat[s * 3 + 1]) * fs[1][i]
                        + T(k.ti_mat[s * 3 + 2]) * fs[2][i];
        T rhs_r[D], rhs_c[D2], dw[3][D], dwc[D2];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          rhs_r[i] = tif[0][i] - mr_h * w[0][i];
          rhs_c[i] = tif[1][i]
                     - (T(k.mu_cr) * w[1][i] - T(k.mu_ci) * w[2][i]) / hh;
          rhs_c[i + D] = tif[2][i]
                         - (T(k.mu_cr) * w[2][i] + T(k.mu_ci) * w[1][i]) / hh;
        }
        solve_lu_rows(lu_r, rhs_r, dw[0]);
        solve_lu_rows(lu_c, rhs_c, dwc);
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
        const bool div = hv && (rt >= T(1)
                                || pow(srt, left) / (T(1) - srt) * dwn > ntol);
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
              z[s][i] = T(k.t_mat[s * 3 + 0]) * w[0][i]
                        + T(k.t_mat[s * 3 + 1]) * w[1][i]
                        + T(k.t_mat[s * 3 + 2]) * w[2][i];
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
        ze[i] = (T(k.e[0]) * z[0][i] + T(k.e[1]) * z[1][i]
                 + T(k.e[2]) * z[2][i]) / hh;
        sc[i] = atol + rtol * fmax(fabs(y[i]), fabs(y_new[i]));
        rhs[i] = f0[i] + ze[i];
      }
      solve_lu_rows(lu_r, rhs, err);
      const T enorm1 = err_norm(err, sc);
      // refined estimate (always computed, as the reference kernel)
      T ye[D], fe[D];
#pragma unroll
      for (int i = 0; i < D; ++i) ye[i] = y[i] + err[i];
      P::template f<T, T>(t, ye, p, fe);
#pragma unroll
      for (int i = 0; i < D; ++i) rhs[i] = fe[i] + ze[i];
      solve_lu_rows(lu_r, rhs, err2);
      const T enorm2 = err_norm(err2, sc);
      T enorm = (rejected > T(0.5) && enorm1 > T(1)) ? enorm2 : enorm1;
      enorm = fmax(enorm, T(1e-16));
      const bool accept = conv && enorm <= T(1);
      const bool reject_err = conv && enorm > T(1);

      // ---- controller ----------------------------------------------------
      const T h_abs = fabs(hh);
      const T niter_s = fmax(niter, T(1));
      const T safety = T(k.safety0 * (2 * k.newton_maxiter + 1))
                       / (T(2 * k.newton_maxiter) + niter_s);
      const bool have_old = h_old > T(0) && err_old > T(0);
      const T mult = have_old
          ? h_abs / (h_old == T(0) ? T(1) : h_old)
                * pow(err_old / enorm, T(k.expo))
          : T(1);
      const T base = fmin(T(1), mult) * pow(enorm, -T(k.expo));
      const T fac_rej = fmax(T(k.facl), safety * base);
      T fac_acc = clip(safety * base, T(k.facl), T(k.facr));
      const bool deadzone = accept && fac_acc >= T(k.quot1)
                            && fac_acc < T(k.quot2);
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
      const bool exceeded = nsteps >= T(k.max_steps) && !done;
      const T h_next = accept ? h_abs * fac_acc
                       : reject_err ? h_abs * fac_rej
                       : newton_fail ? h_abs * T(0.5) : h_abs;
      const bool underflow = T(0.1) * h_next <= eps * fabs(t_new) && !done;
      if (done) status = T(k.st_success);
      if (exceeded) status = T(k.st_max_steps);
      if (underflow) status = T(k.st_underflow);
      if (stall) status = T(k.st_stall);

      // ---- write back (to registers; stored after the last attempt) ------
      if (accept) {
#pragma unroll
        for (int qq = 0; qq < 3; ++qq)
#pragma unroll
          for (int i = 0; i < D; ++i)
            q[qq][i] = z[0][i] * T(k.p[0 * 3 + qq])
                       + z[1][i] * T(k.p[1 * 3 + qq])
                       + z[2][i] * T(k.p[2 * 3 + qq]);
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
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int i = 0; i < D; ++i) ROW(kQ + s * D + i) = q[s][i];
#undef ROW
  }
}

int grid_for(int64_t m) {
  const int64_t need = (m + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 64;
  return (int)(need < cap ? need : cap);
}

template <typename P>
int launch(void* state, const void* tf, const void* params, int64_t m, int d,
           int n_params, int dtype, const JanusRadauConsts& k,
           int max_attempts, cudaStream_t s) {
  if (d != P::D || n_params != P::NP) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    radau5_step_kernel<double, P><<<grid_for(m), kThreads, 0, s>>>(
        static_cast<double*>(state), static_cast<const double*>(tf),
        static_cast<const double*>(params), m, k, max_attempts);
  else
    radau5_step_kernel<float, P><<<grid_for(m), kThreads, 0, s>>>(
        static_cast<float*>(state), static_cast<const float*>(tf),
        static_cast<const float*>(params), m, k, max_attempts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4: up to max_attempts Radau5 step attempts per lane on the packed state
// [5D+15, M], in place. problem names the device functor: "vdp" or
// "robertson" (models/problems.py:DEVICE_PROBLEMS).
int janus_radau5_step(void* state, const void* tf_row, const void* params,
                      int64_t m, const char* problem, int d, int n_params,
                      int dtype, const JanusRadauConsts* consts,
                      int max_attempts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (std::strcmp(problem, "vdp") == 0)
    return launch<VdP>(state, tf_row, params, m, d, n_params, dtype, *consts,
                       max_attempts, s);
  if (std::strcmp(problem, "robertson") == 0)
    return launch<Robertson>(state, tf_row, params, m, d, n_params, dtype,
                             *consts, max_attempts, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
