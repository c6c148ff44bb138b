// Masked, padded GP Gram matrix on Hopper (sm_90a): a tiled symmetric
// forward over restart lanes, and its backward in the hyperparameters and,
// on request, in the coordinates.
//
// The forward replaces bobe_tpu/ops/pallas_gram.py::gram_masked_pallas
// (kernel body _gram_kernel). For each restart lane r it computes
//
//   K[r, i, j] = m_i m_j * amp_r * corr(sum_k ((x_ik - x_jk) / l_rk)^2)
//                + (noise * m_i + 1 - m_i) * [i == j]
//
// with corr the RBF exp(-r^2 / 2) or the Matern-5/2
// (1 + sqrt5 r + 5/3 r^2) exp(-sqrt5 r). Pad rows (m_i = 0) come out as the
// identity, so the padded Cholesky factor is [[L, 0], [0, I]]. The
// coordinates x are (cap, d), shared by every lane, or (lanes, cap, d), one
// set per lane (the input warp: each restart lane warps the training points
// with its own parameters); the kernels take a lane stride on x, 0 or
// cap * d.
//
// The backward has no TPU counterpart (the TPU kernel has no custom_vjp;
// the JAX package differentiates its XLA Gram build instead). Given
// G = dL/dK (R, cap, cap), with Kc the kernel part without the diagonal
// term and D_ijk = x_ik - x_jk, it returns
//
//   dL/damp_r = sum_ij G_ij m_i m_j corr_ij
//   dL/dl_rk  = l_rk^-3 sum_ij G_ij Kc_ij D_ijk^2                (RBF)
//   dL/dl_rk  = l_rk^-3 sum_ij G_ij amp m_i m_j (5/3)(1 + sqrt5 r) e^{-sqrt5 r} D_ijk^2
//                                                               (Matern-5/2)
//
// and, when the caller asks for it (the input warp differentiates through
// the warped coordinates), with W_ij = (G_ij + G_ji) amp_r m_i m_j c'_ij
// and c' = corr (RBF) or (5/3)(1 + sqrt5 r) e^{-sqrt5 r} (Matern-5/2),
//
//   dL/dx_rik = -l_rk^-2 (x_ik sum_j W_ij - sum_j W_ij x_jk)
//
// Design.
// * Tiles. A block owns one 64x64 output tile pair (bi >= bj) of one lane;
//   the grid is (tile pairs, lanes), so all restart lanes go out in one
//   launch. 256 threads, each holding a 4x4 register micro-tile at rows
//   ty + 16a, columns tx + 16b.
// * Scale once per panel. The block stages the scaled row and column panels
//   x / l in shared memory, d in chunks of 32 dimensions, dividing each
//   element once as it is loaded (cap * d * tiles divisions per lane where
//   one per entry would be cap^2 * d). Chunking keeps the static shared
//   memory at 33 KB (f64) for any d, under the 48 KB a block gets without
//   cudaFuncSetAttribute, so no launch depends on an opt-in.
// * Exact differences. Each entry sums (xs_ik - xs_jk)^2, not the
//   |a|^2 + |b|^2 - 2ab expansion the TPU kernel feeds its matrix unit: no
//   cancellation near the diagonal. This is also why there are no tensor
//   cores here: the distance work is d * cap^2 / 2 FMAs with d <= ~30, the
//   store is 8 bytes per entry and lane, and an FP64 mma would buy nothing
//   at this arithmetic intensity and would cost the exactness.
// * Symmetry. Only tiles with bi >= bj are computed. The block stages its
//   finished tile in shared memory and writes it twice: as itself and,
//   read transposed, as the mirrored tile, so both stores run along rows
//   (coalesced, 16 bytes a thread where cap allows). Diagonal tiles write
//   every entry from their lower triangle. K == K^T therefore holds bit for
//   bit by construction.
// * The backward recomputes corr from the scaled panels in the same tile
//   loop (K is not kept), weights each entry by G_ij + G_ji (G_ji staged
//   through shared memory, so G need not be symmetric), then loops over the
//   dimensions again for sum W (xs_i - xs_j)^2. Block partials go to a
//   scratch buffer that a second kernel sums in a fixed order: no atomics,
//   so two launches give bit-identical gradients.
// * The coordinate gradient rides the same dimension loop (a template flag,
//   so the hyperparameter-only kernel is compiled without it). Every entry
//   (i, j) of a tile adds w (xs_i - xs_j) to row i and w (xs_j - xs_i) to
//   row j: a tile pair holds G_ij + G_ji off the diagonal and G_ij on it,
//   so either way row i collects sum_j W_ij (xs_i - xs_j). A block writes
//   its tile's row sums (a shuffle over the 16 threads of a row) and column
//   sums (a shuffle over the warp's two rows, then 8 warps through shared
//   memory) as partials: lanes * pairs * 2 * 64 * d doubles. A third kernel
//   folds the T partials of each row (tile pairs (t, 0..t) as rows,
//   (t..T-1, t) as columns) in a fixed order: no atomics, bit-identical
//   launches, and pad rows exactly 0 (their w is 0).
//   Why partials and not blocks that own a row tile and walk every column
//   tile (no scratch): that layout does every distinct pair twice and
//   launches lanes * T blocks, 48 at the planck-like warp fit's cap 384 with
//   8 lanes on a card of 132 SMs, where the pair layout launches 168 and the
//   scratch stays at 1 MB there (26 MB at cap 1280, d=30, 4 lanes).
//
// What bounds it: at cap 1024, d=8, f64 the forward stores 8.4 MB (2.5 us
// at 3.35 TB/s) and does about (3d + 20) f64 operations on each of the
// cap^2 / 2 distinct entries (0.7 us at 34 TFLOP/s): the store. The backward
// reads G (8 bytes per entry and lane) and needs about (5d + 25) operations
// per distinct entry (the squared difference and its sum, then one FMA for
// the gradient sum; this kernel recomputes the difference, one more): at
// d=30 the arithmetic.
//
// ls and amp are read through device pointers, so the caller never
// synchronises to pass them; noise is a host scalar.
#include <cuda_runtime.h>

// Output tile edge. 64 is the shipped value; a tile-size measurement builds
// with -DBOBE_GRAM_TILE=32 (ops/kernels.py build_library(tile=...)).
#ifndef BOBE_GRAM_TILE
#define BOBE_GRAM_TILE 64
#endif

namespace {

constexpr int kTile = BOBE_GRAM_TILE;     // output tile edge
constexpr int kEdge = 16;                 // threads along a tile edge
constexpr int kThreads = kEdge * kEdge;   // 256 threads a block
constexpr int kMicro = kTile / kEdge;     // 4x4 entries a thread
constexpr int kChunk = 32;                // dimensions staged at a time
constexpr int kPitch = kTile + 1;         // padded pitch: no bank conflicts
constexpr int kWarps = kThreads / 32;
constexpr double kSqrt5 = 2.23606797749978969641;
static_assert(kTile % kEdge == 0 && kTile <= 64,
              "the tile edge is a multiple of 16, at most 64 (shared memory)");

template <typename T>
union Smem {
  struct {
    T row[kChunk][kPitch];  // scaled row panel, dimension-major
    T col[kChunk][kPitch];  // scaled column panel
  } panel;
  T tile[kTile][kPitch];    // a finished output tile, or a tile of G
};

__device__ __forceinline__ double dev_exp(double v) { return exp(v); }
__device__ __forceinline__ float dev_exp(float v) { return expf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dev_fma(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float dev_fma(float a, float b, float c) {
  return fmaf(a, b, c);
}

__host__ __device__ __forceinline__ int num_tiles(int cap) {
  return (cap + kTile - 1) / kTile;
}

// Tile pair p (0 <= p < T(T+1)/2) -> (bi, bj) with bi >= bj, row-major over
// the lower triangle of tiles.
__device__ __forceinline__ void tile_pair(int p, int* bi, int* bj) {
  int i = static_cast<int>((sqrt(8.0 * p + 1.0) - 1.0) * 0.5);
  while (i * (i + 1) / 2 > p) --i;
  while ((i + 1) * (i + 2) / 2 <= p) ++i;
  *bi = i;
  *bj = p - i * (i + 1) / 2;
}

// Stage dimensions [k0, k0 + kc) of the scaled row panel (rows i0..) and
// column panel (rows j0..); rows past cap are 0. Ends with a barrier.
template <typename T>
__device__ __forceinline__ void load_panels(Smem<T>& sm, const T* x,
                                            const T* ls, int i0, int j0,
                                            int cap, int d, int k0, int kc) {
  for (int idx = threadIdx.x; idx < kTile * kc; idx += kThreads) {
    const int r = idx / kc;
    const int k = idx - r * kc;
    const T l = ls[k0 + k];
    const int i = i0 + r;
    const int j = j0 + r;
    sm.panel.row[k][r] = i < cap ? x[static_cast<size_t>(i) * d + k0 + k] / l
                                 : T(0);
    sm.panel.col[k][r] = j < cap ? x[static_cast<size_t>(j) * d + k0 + k] / l
                                 : T(0);
  }
  __syncthreads();
}

// acc[a][b] += sum over the staged dimensions of (row - col)^2.
template <typename T>
__device__ __forceinline__ void add_sq_dist(const Smem<T>& sm, int kc, int tx,
                                            int ty, T (&acc)[kMicro][kMicro]) {
  for (int k = 0; k < kc; ++k) {
    T ri[kMicro], cj[kMicro];
#pragma unroll
    for (int a = 0; a < kMicro; ++a) ri[a] = sm.panel.row[k][ty + kEdge * a];
#pragma unroll
    for (int b = 0; b < kMicro; ++b) cj[b] = sm.panel.col[k][tx + kEdge * b];
#pragma unroll
    for (int a = 0; a < kMicro; ++a) {
#pragma unroll
      for (int b = 0; b < kMicro; ++b) {
        const T diff = ri[a] - cj[b];
        acc[a][b] = dev_fma(diff, diff, acc[a][b]);
      }
    }
  }
}

// Squared scaled distances of the thread's micro-tile, over every
// dimension. With a single chunk the panels stay staged on return.
template <typename T>
__device__ __forceinline__ void sq_dist_tile(Smem<T>& sm, const T* x,
                                             const T* ls, int i0, int j0,
                                             int cap, int d, int tx, int ty,
                                             T (&acc)[kMicro][kMicro]) {
#pragma unroll
  for (int a = 0; a < kMicro; ++a)
#pragma unroll
    for (int b = 0; b < kMicro; ++b) acc[a][b] = T(0);
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    const int kc = min(kChunk, d - k0);
    if (k0 > 0) __syncthreads();  // every thread is done with the last chunk
    load_panels(sm, x, ls, i0, j0, cap, d, k0, kc);
    add_sq_dist(sm, kc, tx, ty, acc);
  }
}

// corr(dsq); with dcorr, also -2 d corr / d dsq for the backward: corr
// itself for the RBF, (5/3)(1 + sqrt5 r) e^{-sqrt5 r} for the Matern.
template <typename T, int KIND>
__device__ __forceinline__ T correlation(T dsq, T* dcorr) {
  if (KIND == 0) {
    const T c = dev_exp(T(-0.5) * dsq);
    if (dcorr) *dcorr = c;
    return c;
  }
  const T r = dev_sqrt(dsq > T(1e-30) ? dsq : T(1e-30));
  const T e = dev_exp(-T(kSqrt5) * r);
  if (dcorr) *dcorr = T(5.0 / 3.0) * (T(1) + T(kSqrt5) * r) * e;
  return (T(1) + T(kSqrt5) * r + T(5.0 / 3.0) * dsq) * e;
}

template <typename T>
__device__ __forceinline__ void store_row(T* dst, const T (&v)[16 / sizeof(T)],
                                          int n_left, bool vec);

template <>
__device__ __forceinline__ void store_row<double>(double* dst,
                                                  const double (&v)[2],
                                                  int n_left, bool vec) {
  if (vec && n_left >= 2) {
    *reinterpret_cast<double2*>(dst) = make_double2(v[0], v[1]);
  } else {
    for (int e = 0; e < 2 && e < n_left; ++e) dst[e] = v[e];
  }
}

template <>
__device__ __forceinline__ void store_row<float>(float* dst,
                                                 const float (&v)[4],
                                                 int n_left, bool vec) {
  if (vec && n_left >= 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int e = 0; e < 4 && e < n_left; ++e) dst[e] = v[e];
  }
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
gram_masked_fwd(const T* __restrict__ x, const T* __restrict__ mask,
                const T* __restrict__ ls, const T* __restrict__ amp, T noise,
                T* __restrict__ out, int cap, int d, size_t x_stride) {
  __shared__ Smem<T> sm;
  const int lane = blockIdx.y;
  int bi, bj;
  tile_pair(blockIdx.x, &bi, &bj);
  const int i0 = bi * kTile, j0 = bj * kTile;
  const int tx = threadIdx.x % kEdge, ty = threadIdx.x / kEdge;

  T acc[kMicro][kMicro];
  sq_dist_tile(sm, x + lane * x_stride, ls + static_cast<size_t>(lane) * d,
               i0, j0, cap, d, tx, ty, acc);

  const T a_amp = amp[lane];
  T mj[kMicro];
#pragma unroll
  for (int b = 0; b < kMicro; ++b) {
    const int j = j0 + tx + kEdge * b;
    mj[b] = j < cap ? mask[j] : T(0);
  }
  __syncthreads();  // the panels are dead; the tile reuses their memory
#pragma unroll
  for (int a = 0; a < kMicro; ++a) {
    const int i = i0 + ty + kEdge * a;
    const T mi = i < cap ? mask[i] : T(0);
#pragma unroll
    for (int b = 0; b < kMicro; ++b) {
      const int j = j0 + tx + kEdge * b;
      T k = (a_amp * correlation<T, KIND>(acc[a][b], nullptr)) * (mi * mj[b]);
      if (i == j) k += noise * mi + (T(1) - mi);
      sm.tile[ty + kEdge * a][tx + kEdge * b] = k;
    }
  }
  __syncthreads();

  constexpr int V = 16 / sizeof(T);  // entries in a 16-byte store
  constexpr int kRowVecs = kTile / V;
  const bool vec = cap % V == 0;     // then every row start is aligned
  const bool diag = bi == bj;
  T* o = out + static_cast<size_t>(lane) * cap * cap;
  for (int idx = threadIdx.x; idx < kTile * kRowVecs; idx += kThreads) {
    const int r = idx / kRowVecs;
    const int c = (idx - r * kRowVecs) * V;
    T v[V];
    // the tile itself: rows i0 + r, columns j0 + c..
    if (i0 + r < cap && j0 + c < cap) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int cc = c + e;
        v[e] = diag ? sm.tile[max(r, cc)][min(r, cc)] : sm.tile[r][cc];
      }
      store_row<T>(o + static_cast<size_t>(i0 + r) * cap + j0 + c, v,
                   cap - (j0 + c), vec);
    }
    // the mirrored tile: rows j0 + r, columns i0 + c..
    if (!diag && j0 + r < cap && i0 + c < cap) {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = sm.tile[c + e][r];
      store_row<T>(o + static_cast<size_t>(j0 + r) * cap + i0 + c, v,
                   cap - (i0 + c), vec);
    }
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Block partials of the backward: part[(lane * (d + 1) + c) * npairs + p],
// c < d the lengthscale sums (before the 1/l factor), c = d the amplitude.
// With DX, also the coordinate partials of the tile's rows (side 0) and
// columns (side 1): dxpart[(((lane * npairs + p) * 2 + side) * d + k) * 64
// + r], sum_j w (xs_rk - xs_jk) before the -1/l factor.
template <int KIND, bool DX>
__global__ void __launch_bounds__(kThreads)
gram_masked_bwd_partials(const double* __restrict__ x,
                         const double* __restrict__ mask,
                         const double* __restrict__ ls,
                         const double* __restrict__ amp,
                         const double* __restrict__ g,
                         double* __restrict__ part,
                         double* __restrict__ dxpart, int cap, int d,
                         int npairs, size_t x_stride) {
  __shared__ Smem<double> sm;
  __shared__ double red[kWarps][kChunk];
  __shared__ double red_col[DX ? kWarps : 1][DX ? kTile : 1];
  const int lane = blockIdx.y;
  const int p = blockIdx.x;
  int bi, bj;
  tile_pair(p, &bi, &bj);
  const int i0 = bi * kTile, j0 = bj * kTile;
  const int tx = threadIdx.x % kEdge, ty = threadIdx.x / kEdge;
  const int warp = threadIdx.x / 32, lane_id = threadIdx.x % 32;
  const double* gl = g + static_cast<size_t>(lane) * cap * cap;
  const double* lsl = ls + static_cast<size_t>(lane) * d;
  const double* xl = x + lane * x_stride;
  double* pl = part + static_cast<size_t>(lane) * (d + 1) * npairs + p;
  double* dxl = DX ? dxpart + (static_cast<size_t>(lane) * npairs + p) * 2 *
                             d * kTile
                   : nullptr;

  // w = G_ij (+ G_ji off the diagonal tiles), 0 outside the matrix
  double w[kMicro][kMicro];
#pragma unroll
  for (int a = 0; a < kMicro; ++a) {
    const int i = i0 + ty + kEdge * a;
#pragma unroll
    for (int b = 0; b < kMicro; ++b) {
      const int j = j0 + tx + kEdge * b;
      w[a][b] = (i < cap && j < cap) ? gl[static_cast<size_t>(i) * cap + j]
                                     : 0.0;
    }
  }
  if (bi != bj) {
    for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
      const int r = idx / kTile, c = idx % kTile;
      const int jj = j0 + r, ii = i0 + c;
      sm.tile[r][c] = (jj < cap && ii < cap)
                          ? gl[static_cast<size_t>(jj) * cap + ii] : 0.0;
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kMicro; ++a)
#pragma unroll
      for (int b = 0; b < kMicro; ++b)
        w[a][b] += sm.tile[tx + kEdge * b][ty + kEdge * a];
    __syncthreads();
  }

  double acc[kMicro][kMicro];
  sq_dist_tile(sm, xl, lsl, i0, j0, cap, d, tx, ty, acc);

  const double a_amp = amp[lane];
  double amp_sum = 0.0;
  double mj[kMicro];
#pragma unroll
  for (int b = 0; b < kMicro; ++b) {
    const int j = j0 + tx + kEdge * b;
    mj[b] = j < cap ? mask[j] : 0.0;
  }
#pragma unroll
  for (int a = 0; a < kMicro; ++a) {
    const int i = i0 + ty + kEdge * a;
    const double mi = i < cap ? mask[i] : 0.0;
#pragma unroll
    for (int b = 0; b < kMicro; ++b) {
      double dcorr;
      const double corr = correlation<double, KIND>(acc[a][b], &dcorr);
      const double gm = w[a][b] * (mi * mj[b]);
      amp_sum = fma(gm, corr, amp_sum);
      w[a][b] = gm * a_amp * dcorr;
    }
  }

  // sum_ij w_ij (xs_ik - xs_jk)^2 for every dimension k
  const int n_chunks = (d + kChunk - 1) / kChunk;
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    const int kc = min(kChunk, d - k0);
    __syncthreads();  // red, and the panels of the last chunk, are free
    if (n_chunks > 1) load_panels(sm, xl, lsl, i0, j0, cap, d, k0, kc);
    for (int k = 0; k < kc; ++k) {
      double ri[kMicro], cj[kMicro];
#pragma unroll
      for (int a = 0; a < kMicro; ++a) ri[a] = sm.panel.row[k][ty + kEdge * a];
#pragma unroll
      for (int b = 0; b < kMicro; ++b) cj[b] = sm.panel.col[k][tx + kEdge * b];
      double s = 0.0;
      double rs[kMicro], cs[kMicro];
#pragma unroll
      for (int a = 0; a < kMicro; ++a) rs[a] = cs[a] = 0.0;
#pragma unroll
      for (int a = 0; a < kMicro; ++a) {
#pragma unroll
        for (int b = 0; b < kMicro; ++b) {
          const double diff = ri[a] - cj[b];
          s = fma(w[a][b], diff * diff, s);
          if (DX) {
            const double wd = w[a][b] * diff;
            rs[a] += wd;
            cs[b] -= wd;
          }
        }
      }
      s = warp_sum(s);
      if (lane_id == 0) red[warp][k] = s;
      if (DX) {
        // rows: the 16 threads of a row are one half-warp (tx = lane % 16)
#pragma unroll
        for (int a = 0; a < kMicro; ++a) {
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            rs[a] += __shfl_xor_sync(0xffffffffu, rs[a], off);
        }
        double* dk = dxl + static_cast<size_t>(k0 + k) * kTile;
        if (tx == 0) {
#pragma unroll
          for (int a = 0; a < kMicro; ++a) dk[ty + kEdge * a] = rs[a];
        }
        // columns: the warp's two rows by a shuffle, then the 8 warps
#pragma unroll
        for (int b = 0; b < kMicro; ++b) {
          cs[b] += __shfl_xor_sync(0xffffffffu, cs[b], 16);
          if (lane_id < kEdge) red_col[warp][tx + kEdge * b] = cs[b];
        }
        __syncthreads();
        if (threadIdx.x < kTile) {
          double v = 0.0;
          for (int wp = 0; wp < kWarps; ++wp) v += red_col[wp][threadIdx.x];
          dk[static_cast<size_t>(d) * kTile + threadIdx.x] = v;
        }
        __syncthreads();
      }
    }
    __syncthreads();
    if (threadIdx.x < kc) {
      double v = 0.0;
      for (int wp = 0; wp < kWarps; ++wp) v += red[wp][threadIdx.x];
      pl[static_cast<size_t>(k0 + threadIdx.x) * npairs] = v;
    }
  }

  amp_sum = warp_sum(amp_sum);
  __syncthreads();
  if (lane_id == 0) red[warp][0] = amp_sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    double v = 0.0;
    for (int wp = 0; wp < kWarps; ++wp) v += red[wp][0];
    pl[static_cast<size_t>(d) * npairs] = v;
  }
}

// Sum the block partials of component blockIdx.x (< d: lengthscale, = d:
// amplitude) of lane blockIdx.y, in a fixed order.
__global__ void __launch_bounds__(kThreads)
gram_masked_bwd_reduce(const double* __restrict__ part,
                       const double* __restrict__ ls,
                       double* __restrict__ grad_ls,
                       double* __restrict__ grad_amp, int d, int npairs) {
  __shared__ double buf[kThreads];
  const int c = blockIdx.x, lane = blockIdx.y;
  const double* src = part + (static_cast<size_t>(lane) * (d + 1) + c) * npairs;
  double v = 0.0;
  for (int p = threadIdx.x; p < npairs; p += kThreads) v += src[p];
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) buf[threadIdx.x] += buf[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    if (c < d) {
      const size_t at = static_cast<size_t>(lane) * d + c;
      grad_ls[at] = buf[0] / ls[at];  // D^2 / l^3 = (D / l)^2 / l
    } else {
      grad_amp[lane] = buf[0];
    }
  }
}

// dL/dx of the rows of tile blockIdx.x in lane blockIdx.y: the row
// partials of tile pairs (t, 0..t), then the column partials of
// (t..T-1, t), in that fixed order, times -1/l. grad_x is (lanes, cap, d).
__global__ void __launch_bounds__(kThreads)
gram_masked_bwd_reduce_dx(const double* __restrict__ dxpart,
                          const double* __restrict__ ls,
                          double* __restrict__ grad_x, int cap, int d,
                          int npairs) {
  const int t = blockIdx.x, lane = blockIdx.y;
  const int n_t = num_tiles(cap);
  const double* base = dxpart + static_cast<size_t>(lane) * npairs * 2 * d *
                                    kTile;
  for (int idx = threadIdx.x; idx < kTile * d; idx += kThreads) {
    const int k = idx / kTile, r = idx - k * kTile;
    const int i = t * kTile + r;
    if (i >= cap) continue;
    double v = 0.0;
    for (int bj = 0; bj <= t; ++bj) {
      const int p = t * (t + 1) / 2 + bj;
      v += base[(static_cast<size_t>(p) * 2 * d + k) * kTile + r];
    }
    for (int bi = t; bi < n_t; ++bi) {
      const int p = bi * (bi + 1) / 2 + t;
      v += base[((static_cast<size_t>(p) * 2 + 1) * d + k) * kTile + r];
    }
    const size_t at = static_cast<size_t>(lane) * d + k;
    grad_x[(static_cast<size_t>(lane) * cap + i) * d + k] = -v / ls[at];
  }
}

int tile_pairs(int cap) {
  const int t = num_tiles(cap);
  return t * (t + 1) / 2;
}

template <typename T>
int launch_forward(const T* x, const T* mask, const T* ls, const T* amp,
                   double noise, T* out, int cap, int d, int lanes,
                   int x_per_lane, int kind, void* stream) {
  if (cap <= 0 || d <= 0 || lanes <= 0 || lanes > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(tile_pairs(cap), lanes);
  const size_t xs = x_per_lane ? static_cast<size_t>(cap) * d : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    gram_masked_fwd<T, 0><<<grid, kThreads, 0, s>>>(x, mask, ls, amp,
                                                    T(noise), out, cap, d, xs);
  } else if (kind == 1) {
    gram_masked_fwd<T, 1><<<grid, kThreads, 0, s>>>(x, mask, ls, amp,
                                                    T(noise), out, cap, d, xs);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Tile pairs of one lane at this capacity: the backward's scratch holds
// lanes * (d + 1) * bobe_gram_tile_pairs(cap) doubles.
extern "C" int bobe_gram_tile_pairs(int cap) { return tile_pairs(cap); }

// Output tile edge (the coordinate partials hold this many rows a side).
extern "C" int bobe_gram_tile() { return kTile; }

// kind: 0 = RBF, 1 = Matern-5/2. x is (cap, d) (x_per_lane = 0) or
// (lanes, cap, d) (x_per_lane = 1), ls (lanes, d), amp (lanes,), out
// (lanes, cap, cap). Returns the cudaError_t of the launch.
extern "C" int bobe_gram_masked_f64(const double* x, const double* mask,
                                    const double* ls, const double* amp,
                                    double noise, double* out, int cap, int d,
                                    int lanes, int x_per_lane, int kind,
                                    void* stream) {
  return launch_forward<double>(x, mask, ls, amp, noise, out, cap, d, lanes,
                                x_per_lane, kind, stream);
}

extern "C" int bobe_gram_masked_f32(const float* x, const float* mask,
                                    const float* ls, const float* amp,
                                    double noise, float* out, int cap, int d,
                                    int lanes, int x_per_lane, int kind,
                                    void* stream) {
  return launch_forward<float>(x, mask, ls, amp, noise, out, cap, d, lanes,
                               x_per_lane, kind, stream);
}

namespace {

template <bool DX>
int launch_backward(const double* x, const double* mask, const double* ls,
                    const double* amp, const double* g, double* part,
                    double* dxpart, double* grad_ls, double* grad_amp,
                    double* grad_x, int cap, int d, int lanes, int x_per_lane,
                    int kind, void* stream) {
  if (cap <= 0 || d <= 0 || lanes <= 0 || lanes > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int npairs = tile_pairs(cap);
  const size_t xs = x_per_lane ? static_cast<size_t>(cap) * d : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(npairs, lanes);
  if (kind == 0) {
    gram_masked_bwd_partials<0, DX><<<grid, kThreads, 0, s>>>(
        x, mask, ls, amp, g, part, dxpart, cap, d, npairs, xs);
  } else if (kind == 1) {
    gram_masked_bwd_partials<1, DX><<<grid, kThreads, 0, s>>>(
        x, mask, ls, amp, g, part, dxpart, cap, d, npairs, xs);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_masked_bwd_reduce<<<dim3(d + 1, lanes), kThreads, 0, s>>>(
      part, ls, grad_ls, grad_amp, d, npairs);
  if (DX) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    gram_masked_bwd_reduce_dx<<<dim3(num_tiles(cap), lanes), kThreads, 0,
                                s>>>(dxpart, ls, grad_x, cap, d, npairs);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g is dL/dK (lanes, cap, cap); part is scratch of
// lanes * (d + 1) * bobe_gram_tile_pairs(cap) doubles; writes grad_ls
// (lanes, d) and grad_amp (lanes,). Returns the first launch error.
extern "C" int bobe_gram_masked_backward_f64(
    const double* x, const double* mask, const double* ls, const double* amp,
    const double* g, double* part, double* grad_ls, double* grad_amp, int cap,
    int d, int lanes, int x_per_lane, int kind, void* stream) {
  return launch_backward<false>(x, mask, ls, amp, g, part, nullptr, grad_ls,
                                grad_amp, nullptr, cap, d, lanes, x_per_lane,
                                kind, stream);
}

// The same, and dL/dx into grad_x (lanes, cap, d); dxpart is scratch of
// lanes * bobe_gram_tile_pairs(cap) * 2 * 64 * d doubles.
extern "C" int bobe_gram_masked_backward_x_f64(
    const double* x, const double* mask, const double* ls, const double* amp,
    const double* g, double* part, double* dxpart, double* grad_ls,
    double* grad_amp, double* grad_x, int cap, int d, int lanes,
    int x_per_lane, int kind, void* stream) {
  return launch_backward<true>(x, mask, ls, amp, g, part, dxpart, grad_ls,
                               grad_amp, grad_x, cap, d, lanes, x_per_lane,
                               kind, stream);
}
