// K1 (pivot-free LU factor) and K3 (fused factor and solve) above the
// unrolled sizes, for sm_90a: a tile of lanes held whole in shared memory.
//
// Replaces, above ops/smalllu.py:MAX_UNROLLED_D, the TPU kernels
// janus_tpu/ops/smalllu_pallas.py:lu_factor_t (K1) and :linsolve_fused
// (K3), and follows their shape: the Pallas kernel stages a [D*D, tile]
// block of lanes in VMEM, eliminates there and writes back once. Here a
// block takes `lanes` consecutive lanes, copies their [D*D, lanes] (K3: and
// [D, lanes] of b) into shared memory with cp.async, eliminates there and
// writes L\U (K3: x) back once. Each row e of the SoA input is a contiguous
// run of the block's lanes, so the loads and stores coalesce. (TMA needs
// 16-byte row strides, which an odd M does not give; cp.async copies
// element by element at any M.)
//
// Shared-memory layout (lane innermost): entry (i, j) of lane l at
// tile[i * rs + j * lanes + l], j < D (K3: j == D holds b, then x). The row
// stride rs >= (columns) * lanes is padded so that the rows a warp's
// threads own fall on distinct banks (ops/smalllu.py:tile_geometry, the one
// place the layout is chosen; the launch refuses any other).
//
// Work within a lane spreads over g <= 32 threads of one warp (so a warp
// barrier, __syncwarp, orders them): thread r of a lane owns rows
// r, r + g, ... (at most Q, a template parameter: 2, 4 or 8). The
// elimination is blocked by panels of kPanel columns (the last D mod
// kPanel columns one at a time), each element keeping its operations in k
// order, so the bits are those of the twins:
//   A. the panel's columns: for each k of the panel, the pivot row's panel
//      values read from shared memory into registers, the multipliers of
//      rows i > k, and those rows updated at the panel's columns (one
//      barrier a k);
//   B. the panel's rows right of the panel (the U rows), a column a thread,
//      the column's panel values and the panel's multipliers in registers;
//   C. the trailing rows: the panel's multipliers of each owned row held in
//      registers, each pivot-row value read once a column and applied to
//      every owned row, kPanel updates an element between its read and its
//      write, the next column read before this one is written.
// K3 then back-substitutes with one thread a lane (a dependent chain in the
// twin's order) and the block stores x.
//
// What bounds it: each lane moves 2 D^2 values (K1; K3 D^2 + 2 D) through
// HBM, and does ~D^3/3 multiply-subtracts in shared memory; at D = 24 in f64
// 9.2 KB a lane against ~4,300 updates. The blocking cuts shared-memory
// traffic to about (kPanel + 2 Q) / (kPanel Q) accesses an update, so HBM,
// not shared memory, should bound the mid sizes; FP64 issue (a multiply and
// a subtract an update, no FMA) joins it at D ~ 56.
//
// Arithmetic: as csrc/smalllu.cu (K1 divides by the pivot, a zero pivot
// guarded to 1; K3 multiplies by 1/a[k][k], no guard, b as column D, back
// substitution in ascending j dividing by the diagonal), built with
// -fmad=false: equal to the twins to the bit.
//
// C interface (ctypes): janus_lu_tile launches K1 (fused = 0: a_t -> out
// [D*D, M]) or K3 (fused = 1: a_t, b_t -> out [D, M]) with the geometry
// given, or returns cudaErrorInvalidValue for any other; it returns
// cudaGetLastError() after the launch. janus_lu_tile_attributes reports
// what a launch of that geometry would use. dtype 0 = float, 1 = double.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kPanel = 4;           // columns a panel

// The instantiation of Q (2, 4 or 8) that rows a thread take (0: more than
// any), and its register budget, as __launch_bounds__ states it: threads a
// block at most and blocks a SM, compiled in from ops/_build.py:TILE_BOUNDS,
// which gives Q = 2 64 registers, Q = 4 128 and Q = 8 255, where its 4 Q
// multipliers, 2 Q row values and Q offsets stay out of local memory.
// Above D = 64 (Q >= 4) a lane's tile bounds the block well below these
// threads.
constexpr int rows_instance(int rows) {
  return rows <= 2 ? 2 : rows <= 4 ? 4 : rows <= 8 ? 8 : 0;
}
constexpr int block_threads(int q) {
  return q == 2 ? JANUS_TILE_Q2_THREADS
                : q == 4 ? JANUS_TILE_Q4_THREADS : JANUS_TILE_Q8_THREADS;
}
constexpr int min_blocks(int q) {
  return q == 2 ? JANUS_TILE_Q2_BLOCKS
                : q == 4 ? JANUS_TILE_Q4_BLOCKS : JANUS_TILE_Q8_BLOCKS;
}

template <typename Real>
__device__ __forceinline__ void cp_async(Real* dst, const Real* src,
                                         bool valid) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? static_cast<int>(sizeof(Real)) : 0;   // 0: zero fill
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(to),
               "l"(src), "n"(static_cast<int>(sizeof(Real))), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One panel of NP columns, k0 .. k0 + NP - 1 (NP = kPanel but at the end),
// for the lane whose column of the tile starts at t; thread r owns rows
// r, r + g, ... Every element keeps the twins' operations in k order.
template <typename Real, int Q, int NP, bool kFused>
__device__ __forceinline__ void panel(Real* t, int rs, int lanes, int r,
                                      int g, int d, int ncols, int k0) {
#define R(i, j) t[(i) * rs + (j) * lanes]
  const int kb = k0 + NP;
  // A: the panel's columns; the pivot row's panel values in registers
#pragma unroll
  for (int kk = 0; kk < NP; ++kk) {
    const int k = k0 + kk;
    __syncwarp();
    const Real piv = R(k, k);
    Real pk[NP];
#pragma unroll
    for (int c = kk + 1; c < NP; ++c) pk[c] = R(k, k0 + c);
    // K1: the divisor, a zero pivot guarded to 1; K3: the reciprocal
    const Real scale = kFused ? Real(1) / piv
                              : (piv == Real(0) ? Real(1) : piv);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = r + g * q;
      if (i > k && i < d) {
        Real x[NP];
#pragma unroll
        for (int c = kk + 1; c < NP; ++c) x[c] = R(i, k0 + c);
        const Real mult = kFused ? R(i, k) * scale : R(i, k) / scale;
        R(i, k) = mult;
#pragma unroll
        for (int c = kk + 1; c < NP; ++c) R(i, k0 + c) = x[c] - mult * pk[c];
      }
    }
  }
  __syncwarp();
  // B: the panel's rows right of the panel, a column a thread, the
  // column's NP values and the panel's multipliers in registers
  Real lm[NP][NP];
#pragma unroll
  for (int a = 1; a < NP; ++a)
#pragma unroll
    for (int c = 0; c < a; ++c) lm[a][c] = R(k0 + a, k0 + c);
  for (int j = kb + r; j < ncols; j += g) {
    Real col[NP];
#pragma unroll
    for (int a = 0; a < NP; ++a) col[a] = R(k0 + a, j);
#pragma unroll
    for (int a = 1; a < NP; ++a) {
#pragma unroll
      for (int c = 0; c < a; ++c) col[a] = col[a] - lm[a][c] * col[c];
      R(k0 + a, j) = col[a];
    }
  }
  __syncwarp();
  // C: the trailing rows, NP updates an element between its read and its
  // write. An offset a row, advanced a column at a time (rows outside
  // [kb, d) read the lane's first entry and store nothing); the next
  // column's values are read before this column's are stored (C writes
  // only rows >= kb, reads the pivot rows < kb: nothing it reads ahead is
  // written).
  if (kb >= ncols) return;
  Real mq[Q][NP];
  int row[Q], step[Q];
  bool on[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = r + g * q;
    on[q] = i >= kb && i < d;
    row[q] = on[q] ? i * rs + kb * lanes : 0;
    step[q] = on[q] ? lanes : 0;
#pragma unroll
    for (int p = 0; p < NP; ++p) mq[q][p] = on[q] ? R(i, k0 + p) : Real(0);
  }
  int pv = k0 * rs + kb * lanes;
  Real pr[NP], v[Q];
#pragma unroll
  for (int p = 0; p < NP; ++p) pr[p] = t[pv + p * rs];
#pragma unroll
  for (int q = 0; q < Q; ++q) v[q] = t[row[q]];
  for (int j = kb; j < ncols; ++j) {
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int p = 0; p < NP; ++p) v[q] = v[q] - mq[q][p] * pr[p];
    Real vn[Q];
    if (j + 1 < ncols) {
      pv += lanes;
#pragma unroll
      for (int p = 0; p < NP; ++p) pr[p] = t[pv + p * rs];
#pragma unroll
      for (int q = 0; q < Q; ++q) vn[q] = t[row[q] + step[q]];
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (on[q]) t[row[q]] = v[q];
      row[q] += step[q];
      v[q] = vn[q];
    }
  }
#undef R
}

template <typename Real, int Q, bool kFused>
__global__ void __launch_bounds__(block_threads(Q), min_blocks(Q))
lu_tile_kernel(const Real* __restrict__ a, const Real* __restrict__ b,
               Real* __restrict__ out, int d, int64_t m, int g, int lanes,
               int rs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Real* const tile = reinterpret_cast<Real*>(smem_raw);
  const int ncols = kFused ? d + 1 : d;
  const int64_t lane0 = static_cast<int64_t>(blockIdx.x) * lanes;
  const int live = static_cast<int>(m - lane0 < lanes ? m - lane0 : lanes);

  // ---- load: [D*D, lanes] of A (and [D, lanes] of b), zero past M. The
  // block has g threads a lane: thread (e0, l) copies rows e0, e0 + g, ...
  // of lane l (a warp's threads take neighbouring lanes of a row).
  const int l_io = threadIdx.x % lanes;
  const int e0 = threadIdx.x / lanes;
  const bool in_m = l_io < live;
  {
    int i = e0 / d, j = e0 - (e0 / d) * d;
    for (int e = e0; e < d * d; e += g) {
      cp_async(&tile[i * rs + j * lanes + l_io],
               in_m ? a + static_cast<int64_t>(e) * m + lane0 + l_io : a,
               in_m);
      for (j += g; j >= d; j -= d) ++i;
    }
    if (kFused)
      for (int e = e0; e < d; e += g)
        cp_async(&tile[e * rs + d * lanes + l_io],
                 in_m ? b + static_cast<int64_t>(e) * m + lane0 + l_io : b,
                 in_m);
  }
  cp_async_wait_all();
  __syncthreads();

  // ---- eliminate: thread r of lane l owns rows r, r + g, ...
  const int l = threadIdx.x / g;
  const int r = threadIdx.x - l * g;
  Real* const t = tile + l;
  // panels of kPanel columns, then single columns to D
  for (int k0 = 0; k0 < d;) {
    if (d - k0 >= kPanel) {
      panel<Real, Q, kPanel, kFused>(t, rs, lanes, r, g, d, ncols, k0);
      k0 += kPanel;
    } else {
      panel<Real, Q, 1, kFused>(t, rs, lanes, r, g, d, ncols, k0);
      k0 += 1;
    }
  }
  if (kFused) {
    // back substitution, one thread a lane: x overwrites column D
    __syncwarp();
    if (r == 0) {
#define R(i, j) t[(i) * rs + (j) * lanes]
      for (int i = d - 1; i >= 0; --i) {
        Real acc = R(i, d);
        for (int j = i + 1; j < d; ++j) acc = acc - R(i, j) * R(j, d);
        R(i, d) = acc / R(i, i);
      }
#undef R
    }
  }
  __syncthreads();

  // ---- store: L\U (K1) or x (K3), the live lanes, as the load
  if (in_m) {
    if (kFused) {
      for (int e = e0; e < d; e += g)
        out[static_cast<int64_t>(e) * m + lane0 + l_io] =
            tile[e * rs + d * lanes + l_io];
    } else {
      int i = e0 / d, j = e0 - (e0 / d) * d;
      for (int e = e0; e < d * d; e += g) {
        out[static_cast<int64_t>(e) * m + lane0 + l_io] =
            tile[i * rs + j * lanes + l_io];
        for (j += g; j >= d; j -= d) ++i;
      }
    }
  }
}

// The geometry's invariants (tile_geometry's): g a power of two up to 32,
// rows a thread that an instantiation takes, whole warps a block within its
// launch bounds, the padded row stride, the shared memory it implies (a
// block's limit is the card's: cudaFuncSetAttribute refuses more).
bool geometry_ok(int d, int size, int fused, int g, int lanes, int rs,
                 int64_t smem) {
  if (d < 1 || g < 1 || g > 32 || (g & (g - 1)) != 0 || lanes < 1) return false;
  const int q = rows_instance((d + g - 1) / g);
  if (q == 0 || (lanes * g) % 32 != 0 || lanes * g > block_threads(q))
    return false;
  if (rs < (d + (fused ? 1 : 0)) * lanes) return false;
  return smem == static_cast<int64_t>(d) * rs * size;
}

template <typename Real, int Q, bool kFused>
cudaError_t launch(const void* a, const void* b, void* out, int d, int64_t m,
                   int g, int lanes, int rs, int64_t smem, cudaStream_t s) {
  auto kern = lu_tile_kernel<Real, Q, kFused>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks = (m + lanes - 1) / lanes;
  kern<<<static_cast<unsigned>(blocks), lanes * g, smem, s>>>(
      static_cast<const Real*>(a), static_cast<const Real*>(b),
      static_cast<Real*>(out), d, m, g, lanes, rs);
  return cudaGetLastError();
}

template <typename Real, int Q, bool kFused>
cudaError_t attributes(int g, int lanes, int64_t smem, int64_t* info) {
  auto kern = lu_tile_kernel<Real, Q, kFused>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem > 48 * 1024 ? smem : 48 * 1024));
  if (e != cudaSuccess) return e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, lanes * g,
                                                    static_cast<size_t>(smem));
  if (e != cudaSuccess) return e;
  info[0] = fa.numRegs;
  info[1] = static_cast<int64_t>(fa.localSizeBytes);
  info[2] = smem;
  info[3] = blocks;
  info[4] = fa.maxThreadsPerBlock;
  return cudaSuccess;
}

// Q, the rows a thread may own, is instantiated as 2, 4 and 8
// (rows_instance): a thread with fewer rows leaves the rest idle (rows >= D)
template <typename Real, bool kFused>
cudaError_t dispatch(const void* a, const void* b, void* out, int d,
                     int64_t m, int g, int lanes, int rs, int64_t smem,
                     cudaStream_t s, int64_t* info) {
  const int q = rows_instance((d + g - 1) / g);
#define JANUS_ROWS(Q)                                                     \
  if (q == Q)                                                             \
    return info ? attributes<Real, Q, kFused>(g, lanes, smem, info)       \
                : launch<Real, Q, kFused>(a, b, out, d, m, g, lanes, rs,  \
                                          smem, s);
  JANUS_ROWS(2) JANUS_ROWS(4) JANUS_ROWS(8)
#undef JANUS_ROWS
  return cudaErrorInvalidValue;
}

cudaError_t route(const void* a, const void* b, void* out, int d, int64_t m,
                  int dtype, int fused, int g, int lanes, int rs,
                  int64_t smem, cudaStream_t s, int64_t* info) {
  const int size = dtype == 1 ? 8 : 4;
  if (!geometry_ok(d, size, fused, g, lanes, rs, smem))
    return cudaErrorInvalidValue;
  if (dtype == 1)
    return fused ? dispatch<double, true>(a, b, out, d, m, g, lanes, rs, smem, s, info)
                 : dispatch<double, false>(a, b, out, d, m, g, lanes, rs, smem, s, info);
  return fused ? dispatch<float, true>(a, b, out, d, m, g, lanes, rs, smem, s, info)
               : dispatch<float, false>(a, b, out, d, m, g, lanes, rs, smem, s, info);
}

}  // namespace

extern "C" {

// K1 (fused = 0): out [D*D, M] = packed pivot-free L\U of a_t [D*D, M];
// K3 (fused = 1): out [D, M] = A^-1 b_t, factor and solve in one pass.
// threads_per_lane, lanes_per_block, row_stride, smem_bytes: the geometry
// of ops/smalllu.py:tile_geometry (any other is refused).
int janus_lu_tile(const void* a_t, const void* b_t, void* out, int d,
                  int64_t m, int dtype, int fused, int threads_per_lane,
                  int lanes_per_block, int row_stride, int64_t smem_bytes,
                  void* stream) {
  return static_cast<int>(route(a_t, b_t, out, d, m, dtype, fused,
                                threads_per_lane, lanes_per_block, row_stride,
                                smem_bytes, static_cast<cudaStream_t>(stream),
                                nullptr));
}

// What a launch of that geometry uses: info[0] registers a thread, [1]
// local bytes a thread, [2] dynamic shared bytes a block, [3] resident
// blocks a SM (occupancy query), [4] the kernel's most threads a block.
int janus_lu_tile_attributes(int d, int dtype, int fused,
                             int threads_per_lane, int lanes_per_block,
                             int row_stride, int64_t smem_bytes,
                             int64_t* info) {
  return static_cast<int>(route(nullptr, nullptr, nullptr, d, 0, dtype, fused,
                                threads_per_lane, lanes_per_block, row_stride,
                                smem_bytes, nullptr, info));
}

}  // extern "C"
