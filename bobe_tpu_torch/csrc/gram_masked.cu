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
// Design of the forward (gram_masked_fwd).
// * Tiles. A block owns one 64x64 output tile pair (bi >= bj) of one lane;
//   the grid is (tile pairs, lanes), so all restart lanes go out in one
//   launch. 256 threads, each holding a 4x4 register micro-tile at rows
//   ty + 16a, columns tx + 16b.
// * Scale once per panel. The block stages the scaled row and column panels
//   x / l in shared memory, d in chunks of 32 dimensions, dividing each
//   element once as it is loaded (cap * d * tiles divisions per lane where
//   one per entry would be cap^2 * d). Chunking keeps its static shared
//   memory at 33 KB (f64) for any d, under the 48 KB a block gets without
//   an opt-in.
// * Exact differences. Each entry sums (xs_ik - xs_jk)^2, not the
//   |a|^2 + |b|^2 - 2ab expansion the TPU kernel feeds its matrix unit: no
//   cancellation near the diagonal. This is also why the distances use no
//   tensor cores: the distance work is d * cap^2 / 2 FMAs with d <= ~30,
//   the store is 8 bytes per entry and lane, and an FP64 mma would buy
//   nothing at this arithmetic intensity and would cost the exactness.
// * Symmetry. Only tiles with bi >= bj are computed. The block stages its
//   finished tile in shared memory and writes it twice: as itself and,
//   read transposed, as the mirrored tile, so both stores run along rows
//   (coalesced, 16 bytes a thread where cap allows). Diagonal tiles write
//   every entry from their lower triangle. K == K^T therefore holds bit for
//   bit by construction.
//
// Design of the backward (gram_masked_bwd<KIND, TILE, NEED_X>), one launch
// a call with or without dL/dx (NEED_X, the coordinate variant).
// * Tiles. A block owns one tile pair (bi >= bj) of one lane, 256 threads
//   with the forward's micro-tiles; the tile edge (32 or 64) comes from the
//   shape (ops/kernels.py backward_tile): 64-row tiles
//   where lanes x tile pairs give every SM a block, else 32 (cap 128 with
//   one lane: 10 pairs of 32 rows where 64-row tiles give 3).
// * G in flight. G_ij comes straight into registers and G_ji through shared
//   memory by cp.async, issued first, with the loads of 1 / l (one division
//   a dimension); the panels of x (L2) follow, and G streams in while the
//   distances run. Its weight is W = (G_ij + G_ji) amp m_i m_j c'_ij, so G
//   need not be symmetric; without dL/dx W_ii = 0 (D_ii = 0 in every sum
//   below).
// * The lengthscale sums without dL/dx: a product. For the pair's rows I
//   and J, with u and v the scaled panels less an origin o (the column
//   panel's first row) and r, c W's row and column sums,
//     sum_{i, j} W_ij (u_ik - v_jk)^2
//       = sum_i u_ik (r_i u_ik - 2 (W v)_ik) + sum_j c_j v_jk^2.
//   (W v) runs on the FP64 tensor cores (mma.sync m16n8k16: each warp one
//   16-row tile of I and every other 8-dimension column tile, LsTasks); r
//   and c come from the weights in registers (a warp shuffle and kWarps
//   partials in shared memory); each lane's terms are summed over its
//   tile's 16 rows by one reduce-scatter (quad_sum8, 7 shuffles for 8
//   dimensions). The vector units keep the distances and the weight, about
//   3d + 25 FP64 operations a distinct entry where the exact-difference sum
//   takes 5d + 25, and no dimension needs a barrier or a sum across the
//   whole warp. The expansion loses at most (|u| / |u_i - v_j|)^2 of the
//   terms' digits, which the origin bounds by the pair's spread; chip_smoke.py
//   phase 2b holds the gradients to 1e-10 of sum_ij |G_ij dK_ij/dtheta| over
//   lengthscales down to 0.05 on the unit cube and prints the largest ratio.
//   The exact-difference sums of the coordinate variant (below) were timed
//   against it on a scratch build: slower at every shape timed, most at
//   d=30 (PERF.md).
// * With dL/dx. Row i of lane r needs sum_j W_ij (xs_ik - xs_jk) over all
//   j, for every dimension k; a tile pair (I, J) feeds rows I and rows J.
//   The row part is a product: sum_{j in J} W_ij (xs_ik - xs_jk) =
//   xs_ik r_i - (W xs_J)_ik, and the column part the same with W^T, both on
//   the FP64 tensor cores (mma.sync m8n8k4), each warp owning whole 8-row
//   output tiles of one side, so no output is shared between threads and no
//   dimension needs a barrier; r comes out of the same product as one more
//   column, of ones. The expansion costs at most |xs| / |xs_i - xs_j| of
//   the terms' digits (phase 2b holds dL/dx to 1e-10 of sum_j |W_ij (x_ik -
//   x_jk)| / l^2). Its lengthscale sums stay exact differences (vector
//   FP64), eight dimensions at a time reduced over the warp by one
//   reduce-scatter (9 shuffles where a warp sum each takes 40).
// * Shared memory. W (TILE x TILE, where G_ji was staged) and the two panels
//   (dimension-major, with dL/dx a ones row after the last chunk's
//   dimensions) take 79 KB at TILE 64, and the product form's column and
//   row sums 4.5 KB more, above the 48 KB a block gets by default, so the
//   launcher opts in with cudaFuncSetAttribute (up to 227 KB a block on the
//   H100); two blocks fit an SM (three at TILE 32). W's and the panels'
//   pitch is TILE + 4, 4 (mod 16) doubles, so the 32 addresses of every A
//   and B fragment load (row-major W, its transpose, the panels) fall on 16
//   distinct 8-byte bank pairs, two each.
// * Folding without floating-point atomics. Each tile pair writes its
//   lengthscale and amplitude partial to scratch, and with dL/dx the
//   contribution of its rows I (and, off the diagonal, of its rows J). A
//   ticket per lane hands the block that completes the lane's last pair
//   the sum of its pairs' partials, in pair order. With dL/dx, row tile t's
//   T contributions have a fixed order (pos = the pair's other tile: pairs
//   (t, 0..t) as rows, then (t+1..T-1, t) as columns) and are folded in
//   runs of fold_run(T) (all T up to 8, else ceil(sqrt(T))): an integer
//   ticket per (lane, tile, run) counts the run's contributions, and the
//   block that draws its last ticket sums the run in order (into dL/dx, or
//   into a run sum); with several runs a ticket per (lane, tile) hands the
//   block that completes the last run the sum of the run sums, in order.
//   Every sum has one order whichever block performs it, so two launches
//   are bit-identical. Runs keep the folds short (at cap 1280 with T = 20,
//   a block reads 5 slabs, not 20) and spread them over the run; a fold
//   stages its slabs in shared memory by cp.async. A ticket is an atomic
//   add with release and acquire semantics, drawn by one thread after a
//   barrier (the pattern of a grid barrier). The block that draws a
//   counter's last ticket resets it, so the ticket buffer (zeroed once when
//   it is allocated) is ready for the next call without a memset. Two calls
//   that share a ticket buffer must not run concurrently: the caller
//   (ops/kernels.py) keeps one buffer per device and stream, shared by both
//   variants, and the calls on one stream run one after another.
// * Column-major pair order. blockIdx.x walks the lower triangle of tile
//   pairs column by column, so a row tile's contributions, and so its runs,
//   complete in order as the columns do.
// * Diagonal tile pairs symmetrize G as well (w = G_ij + G_ji over the whole
//   tile) and so need only the row-side product; their hyperparameter
//   partials are halved, an exact scaling.
//
// What bounds it: at cap 1024, d=8, f64 the forward stores 8.4 MB (2.5 us
// at 3.35 TB/s) and does about (3d + 20) f64 operations on each of the
// cap^2 / 2 distinct entries (0.7 us at 34 TFLOP/s): the store. The
// backward reads G (8 bytes per entry and lane; 52.4 MB, 15.7 us at cap
// 1280 with 4 lanes) and needs about (3d + 25) vector operations per
// distinct entry (11 us at d=30) and 2d flops on the tensor cores (3 us),
// 4d with dL/dx: reading G bounds both variants. Neither runs near it
// (chip_smoke.py phase 3): at cap 1280, d=30, 4 lanes each block of 64
// rows spends about a third of its time staging its panels behind its own
// G loads, and the blocks of a wave run their phases in step, so the SM's
// FP64 units wait while G streams and the memory waits while they compute
// (clock64 stamps of each block's phases on a scratch build, PERF.md).
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

// ------------------------------------------------------------------------
// The backward, with and without dL/dx: one launch, deterministic folds (see
// the top).

constexpr int kPanelRows = kChunk + 8;  // a chunk, the ones row, mma padding

template <int TILE, bool NEED_X>
struct Bwd {
  static constexpr int kMicro = TILE / kEdge;  // micro-tile edge a thread
  static constexpr int kPitch = TILE + 4;      // 4 (mod 16) doubles
  static constexpr int kStage = TILE + 1;      // G^T staging pitch
  static constexpr int kMTiles = TILE / 8;     // 8-row mma tiles a side
  // the lengthscale sums by exact differences (else by the product form)
  static constexpr bool kExactLs = NEED_X;
  // a warp's dL/dx mma tasks: two 8-row tiles of one side at TILE 64, one
  // at 32
  static constexpr int kTasks = 2 * kMTiles / kWarps;
  static constexpr int kSmem =  // dynamic shared bytes: wt, panels, red,
      (TILE * kPitch + 2 * kPanelRows * kPitch + kWarps * kChunk +  // and
       (kExactLs ? 0 : (kWarps + 1) * TILE)) *  // W's column sums by warp
      static_cast<int>(sizeof(double));          // and row sums
  static_assert(TILE == 32 || TILE == 64, "tile edge 32 or 64");
  static_assert(kPitch % 16 == 4, "conflict-free mma fragments");
};

// Tile pair p -> (bi, bj), bi >= bj, column-major over the lower triangle
// of t_n x t_n tiles; pair_index is its inverse.
__device__ __forceinline__ void tile_pair_colmajor(int p, int t_n, int* bi,
                                                   int* bj) {
  int c = 0;
  while (p >= t_n - c) {
    p -= t_n - c;
    ++c;
  }
  *bj = c;
  *bi = c + p;
}

__host__ __device__ __forceinline__ int pair_index(int bi, int bj, int t_n) {
  return bj * t_n - bj * (bj - 1) / 2 + (bi - bj);
}

// Row tile t's T contributions, in their fixed order, are indexed by the
// other tile of their pair, pos = 0..T-1: pair (t, pos) side 0 for pos <= t,
// pair (pos, t) side 1 after. They are folded in runs of fold_run(T): each
// run by the block that completes it, then (with more than one run) the
// run sums by the block that completes the last run.
__host__ __device__ __forceinline__ int fold_run(int t_n) {
  if (t_n <= 8) return t_n;
  int g = 1;
  while (g * g < t_n) ++g;
  return g;
}

__host__ __device__ __forceinline__ int fold_runs(int t_n) {
  return (t_n + fold_run(t_n) - 1) / fold_run(t_n);
}

// D (8x8) += A (8x4, row-major) B (4x8, column-major) on the FP64 tensor
// cores. Lane l holds A[l / 4][l % 4], B[l % 4][l / 4] and
// D[l / 4][2 (l % 4) + {0, 1}].
__device__ __forceinline__ void mma_f64(double (&c)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

// Draw v tickets at p: an atomic add with release and acquire semantics at
// the GPU's scope. Called by one thread after a barrier, it publishes the
// whole block's earlier writes, and the ones it observed become visible to
// the block after the next barrier (the pattern of a grid barrier; readers
// bypass L1: ld.cg, cp.async.cg).
__device__ __forceinline__ unsigned draw_ticket(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// Over the eight lanes of each quad position (lane l = 4 g + q, g < 8):
// lane l returns the sum of v[g] over those eight lanes, a reduce-scatter
// over lane bits 4, 3, 2 (7 shuffles where a sum each takes 24).
__device__ __forceinline__ double quad_sum8(const double (&v)[8]) {
  const int l = threadIdx.x % 32;
  double a[4], b[2];
  const bool h4 = l & 16, h3 = l & 8, h2 = l & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const double send = h4 ? v[i] : v[4 + i];
    a[i] = (h4 ? v[4 + i] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const double send = h3 ? a[i] : a[2 + i];
    b[i] = (h3 ? a[2 + i] : a[i]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  return (h2 ? b[1] : b[0]) +
         __shfl_xor_sync(0xffffffffu, h2 ? b[0] : b[1], 4);
}

// The warp's sums of v[0..7]: lane l returns that of v[(l / 4) % 8].
__device__ __forceinline__ double warp_sum8(const double (&v)[8]) {
  double c = quad_sum8(v);
  c += __shfl_xor_sync(0xffffffffu, c, 2);
  c += __shfl_xor_sync(0xffffffffu, c, 1);
  return c;
}

// 8 bytes global -> shared without registers (zeros where !valid).
__device__ __forceinline__ void cp_async8(double* dst, const double* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// 1 / l of dimensions [k0, k0 + kc) into inv_l (kChunk doubles of shared
// memory): one division a dimension, not one an element (a double division
// is a few dozen instructions). Visible to load_panels_x after a barrier.
__device__ __forceinline__ void inverse_ls(double* inv_l, const double* ls,
                                           int k0, int kc) {
  if (threadIdx.x < kc) inv_l[threadIdx.x] = 1.0 / ls[k0 + threadIdx.x];
}

// Stage dimensions [k0, k0 + kc) of the scaled row panel (rows i0..) and
// column panel (rows j0..), dimension-major, rows past cap 0; with `ones`,
// row kc is all ones; rows up to `rows` are 0. x / l is x times inv_l
// (inverse_ls). The caller issues its loads of G before: they stream in
// while the distances run.
template <int TILE>
__device__ __forceinline__ void load_panels_x(double* rowp, double* colp,
                                              const double* x,
                                              const double* inv_l, int i0,
                                              int j0, int cap, int d, int k0,
                                              int kc, bool ones, int rows) {
  constexpr int P = Bwd<TILE, true>::kPitch;
  for (int idx = threadIdx.x; idx < TILE * rows; idx += kThreads) {
    const int r = idx / rows;
    const int k = idx - r * rows;
    double vr, vc;
    if (k < kc) {
      const double il = inv_l[k];
      const int i = i0 + r, j = j0 + r;
      vr = i < cap ? x[static_cast<size_t>(i) * d + k0 + k] * il : 0.0;
      vc = j < cap ? x[static_cast<size_t>(j) * d + k0 + k] * il : 0.0;
    } else {
      vr = vc = (ones && k == kc) ? 1.0 : 0.0;
    }
    rowp[k * P + r] = vr;
    colp[k * P + r] = vc;
  }
}

// One chunk's products for the warp's tasks. Task q (side q / (TILE / 8),
// 8-row tile q % (TILE / 8)) is side 0: rows I, (W xs_J)_ik, or side 1:
// rows J, (W^T xs_I)_jk; a warp owns tasks kTasks * warp .. (one side, so
// its tasks share the B fragments) below n_tasks. nt <= NT 8-column tiles
// (in the last chunk column kc multiplies the ones row: r, kept in rsum);
// each output tile keeps SPLIT accumulators over alternate k-steps, summed
// in a fixed order, so that with one column tile more independent mma
// chains are in flight. Writes each task row's contribution
// xs_ik r_i - (W xs)_ik to out + side * slab + row * d.
template <int TILE, int NT, int SPLIT>
__device__ __forceinline__ void chunk_products(
    const double* wt, const double* rowp, const double* colp, int n_tasks,
    int nt, int kc, bool ones, double* out, size_t slab, int d,
    double (&rsum)[Bwd<TILE, true>::kTasks]) {
  using C = Bwd<TILE, true>;
  constexpr int P = C::kPitch, MT = C::kMTiles, Q = C::kTasks;
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const int gq = lid >> 2, tq = lid & 3;
  const int q0 = warp * Q;
  if (q0 >= n_tasks) return;  // whole warps: the diagonal's idle half
  const int side = q0 / MT;
  const double* bp = side ? rowp : colp;  // B: the other side's panel
  bool on[Q];
  int m[Q];
#pragma unroll
  for (int s = 0; s < Q; ++s) {
    on[s] = q0 + s < n_tasks;
    m[s] = (q0 + s) % MT;
  }
  double acc[Q][NT][SPLIT][2];
#pragma unroll
  for (int s = 0; s < Q; ++s)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int h = 0; h < SPLIT; ++h) acc[s][n][h][0] = acc[s][n][h][1] = 0.0;
#pragma unroll 2
  for (int s4 = 0; s4 < TILE / 4; s4 += SPLIT) {
#pragma unroll
    for (int h = 0; h < SPLIT; ++h) {
      const int k4 = 4 * (s4 + h) + tq;
      double b[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        b[n] = n < nt ? bp[(8 * n + gq) * P + k4] : 0.0;
#pragma unroll
      for (int s = 0; s < Q; ++s) {
        if (!on[s]) continue;
        const double a = side ? wt[k4 * P + 8 * m[s] + gq]
                              : wt[(8 * m[s] + gq) * P + k4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
          if (n < nt) mma_f64(acc[s][n][h], a, b[n]);
      }
    }
  }
  const double* own = side ? colp : rowp;  // the rows' own panel
#pragma unroll
  for (int s = 0; s < Q; ++s) {
    if (!on[s]) continue;
    double res[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        res[n][e] = acc[s][n][0][e];
#pragma unroll
        for (int h = 1; h < SPLIT; ++h) res[n][e] += acc[s][n][h][e];
      }
    // r of row 8m + gq is column kc: element kc % 2 of tile kc / 8 on the
    // quad's lane (kc % 8) / 2
    if (ones) {
      double rv = 0.0;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (n == kc / 8) rv = (kc & 1) ? res[n][1] : res[n][0];
      rsum[s] = __shfl_sync(0xffffffffu, rv, (lid & ~3) | ((kc % 8) / 2));
    }
    const int row = 8 * m[s] + gq;
    double* o = out + side * slab + static_cast<size_t>(row) * d;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * tq + e;
        if (col < kc) o[col] = fma(own[col * P + row], rsum[s], -res[n][e]);
      }
  }
}

// Folds read other blocks' partials from L2 or memory, so their time is
// that latency: fold_sum keeps kFoldBatch loads in flight before it sums
// them.
constexpr int kFoldBatch = 16;

// sum_{c < n} *at(c), in order of c.
template <typename At>
__device__ __forceinline__ double fold_sum(At at, int n) {
  double v = 0.0;
  for (int c0 = 0; c0 < n; c0 += kFoldBatch) {
    double buf[kFoldBatch];
#pragma unroll
    for (int u = 0; u < kFoldBatch; ++u)
      buf[u] = c0 + u < n ? __ldcg(at(c0 + u)) : 0.0;
#pragma unroll
    for (int u = 0; u < kFoldBatch; ++u) v += buf[u];
  }
  return v;
}

// n_comp sums of n terms each, component i the terms *at(i, c) for c < n
// in order; a group of threads shares a component, each summing a
// contiguous run of its terms, then the runs are added in order (through
// buf, kThreads doubles of shared memory): a fixed order for each n and
// n_comp. Groups are 8 threads, or 16 or 32 where the runs would take more
// than one batch of loads and the components still go in one round (d=8 at
// cap 2048: 9 components of 528 terms). The whole block calls it.
template <typename At, typename Store>
__device__ __forceinline__ void block_fold(int n_comp, int n, double* buf,
                                           At at, Store store) {
  int width = 8;
  while (width < 32 && n > width * kFoldBatch && 2 * width * n_comp <= kThreads)
    width *= 2;
  const int grp = threadIdx.x % width;
  for (int c0 = 0; c0 < n_comp; c0 += kThreads / width) {
    const int comp = c0 + threadIdx.x / width;
    double v = 0.0;
    if (comp < n_comp) {
      const int per = (n + width - 1) / width;
      const int lo = min(n, grp * per), hi = min(n, lo + per);
      v = fold_sum([&](int c) { return at(comp, lo + c); }, hi - lo);
    }
    buf[threadIdx.x] = v;
    __syncthreads();
    if (grp == 0 && comp < n_comp) {
      double sum = 0.0;
      for (int g = 0; g < width; ++g) sum += buf[threadIdx.x + g];
      store(comp, sum);
    }
    __syncthreads();
  }
}

// 16 bytes global -> shared without registers.
__device__ __forceinline__ void cp_async16(double* dst, const double* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// n_jobs slab sums: element e < elems(j) of job j is the sum of
// src(j, c)[e] over c < count(j), in order of c; store(j, e, v). The
// slabs (of at least elems rounded up to even, 16-byte aligned) come into
// `stage` (n_stage doubles of shared memory) by cp.async, as many at once
// as fit, so the copies are in flight together; the sums then read shared
// memory. The whole block calls it.
template <typename Elems, typename Count, typename Src, typename Store>
__device__ __forceinline__ void fold_slabs(int n_jobs, double* stage,
                                           int n_stage, Elems elems,
                                           Count count, Src src,
                                           Store store) {
  for (int j = 0; j < n_jobs; ++j) {
    const int n = count(j), ne = elems(j);
    const int ne2 = (ne + 1) & ~1;
    const int piece = (n_stage / n) & ~1;  // elements a copy round, even
    for (int e0 = 0; e0 < ne2; e0 += piece) {
      const int m = min(piece, ne2 - e0), h = m / 2;
      for (int idx = threadIdx.x; idx < n * h; idx += kThreads) {
        const int c = idx / h, q = idx - c * h;
        cp_async16(stage + c * m + 2 * q, src(j, c) + e0 + 2 * q);
      }
      cp_async_wait_all();
      __syncthreads();
      for (int e = threadIdx.x; e < m && e0 + e < ne; e += kThreads) {
        double v = 0.0;
        for (int c = 0; c < n; ++c) v += stage[c * m + e];
        store(j, e0 + e, v);
      }
      __syncthreads();
    }
  }
}

// D (16x8) += A (16x16, row-major) B (16x8, column-major) on the FP64
// tensor cores (mma.sync m16n8k16, the deepest f64 shape of sm_90). Lane l
// (g = l / 4, t = l % 4) holds A[g + 8 (i % 2)][t + 4 (i / 2)] in a[i],
// B[t + 4 i][g] in b[i] and D[g + 8 (i / 2)][2 t + i % 2] in c[i].
__device__ __forceinline__ void mma16_f64(double (&c)[4], const double (&a)[8],
                                          const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// The product form's tasks: warp w owns the 16-row tile m = w % (TILE / 16)
// of rows I and the 8-column tiles n = q, q + G, ... (q = w / (TILE / 16),
// G = kWarps / (TILE / 16) groups), n < ceil(kc / 8).
template <int TILE>
struct LsTasks {
  static constexpr int kRowTiles = TILE / 16;
  static constexpr int kGroups = kWarps / kRowTiles;
  static constexpr int kColTiles = (kChunk / 8 + kGroups - 1) / kGroups;
  // the warp that holds column col's sum over row tile m in red
  __device__ static int warp_of(int col, int m) {
    return (col / 8 % kGroups) * kRowTiles + m;
  }
};

// One chunk's lengthscale sums by the product form. With u and v the row
// and column panels less the pair's origin o (the column panel's first row,
// o_k = xs_j0k), r and c W's row and column sums and rho a local row,
//
//   sum_{i in I, j in J} W_ij (u_ik - v_jk)^2
//     = sum_rho u_rho,k (r_rho u_rho,k - 2 (W v)_rho,k) + c_rho v_rho,k^2.
//
// (W v) comes from mma.sync m16n8k16 over the warp's tasks (LsTasks); r from
// rowsum, c from colsum (kWarps partial sums a column). Each lane's terms
// for its two rows are summed over the tile's 16 rows (quad_sum8) into
// red[warp * kChunk + k]: no dimension needs a barrier or a sum across the
// whole warp, and the vector units do O(TILE d) work a pair here.
template <int TILE>
__device__ __forceinline__ void ls_products(const double* wt,
                                            const double* rowp,
                                            const double* colp,
                                            const double* rowsum,
                                            const double* colsum, int kc,
                                            double* red) {
  using T = LsTasks<TILE>;
  constexpr int P = Bwd<TILE, false>::kPitch, NT = T::kColTiles;
  constexpr int K = 16;
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const int gq = lid >> 2, tq = lid & 3;
  const int m = warp % T::kRowTiles, q = warp / T::kRowTiles;
  const int nt = (kc + 7) / 8;
  if (q >= nt) return;  // no column tile for this warp
  const int r0 = 16 * m + gq;  // the lane's rows: r0 and r0 + 8
  double ob[NT];  // the origin of each B fragment's dimension
#pragma unroll
  for (int s = 0; s < NT; ++s) {
    const int k = 8 * (q + T::kGroups * s) + gq;
    ob[s] = k < kc ? colp[k * P] : 0.0;
  }
  double acc[NT][4];
#pragma unroll
  for (int s = 0; s < NT; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[s][i] = 0.0;
#pragma unroll 2
  for (int k0 = 0; k0 < TILE; k0 += K) {
    double a[K / 2];
#pragma unroll
    for (int i = 0; i < K / 2; ++i)
      a[i] = wt[(r0 + 8 * (i % 2)) * P + k0 + tq + 4 * (i / 2)];
#pragma unroll
    for (int s = 0; s < NT; ++s) {
      const int n = q + T::kGroups * s;
      if (n >= nt) continue;
      double b[K / 4];
#pragma unroll
      for (int i = 0; i < K / 4; ++i)
        b[i] = colp[(8 * n + gq) * P + k0 + tq + 4 * i] - ob[s];
      mma16_f64(acc[s], a, b);
    }
  }
  const double ra = rowsum[r0], rb = rowsum[r0 + 8];
  double ca = 0.0, cb = 0.0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    ca += colsum[w * TILE + r0];
    cb += colsum[w * TILE + r0 + 8];
  }
  // the two rows' terms of each of the lane's columns col = 8 n + 2 tq + e,
  // value index 2 s + e; summed over the 8 lanes of each quad position in
  // groups of 8 values
  constexpr int NV = (2 * NT + 7) / 8 * 8;
  double v[NV];
#pragma unroll
  for (int s = 0; s < NV / 2; ++s)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * (q + T::kGroups * s) + 2 * tq + e;
      double t = 0.0;
      if (s < NT && col < kc) {
        const int si = s < NT ? s : 0;
        const double o = colp[col * P];
        const double ua = rowp[col * P + r0] - o;
        const double va = colp[col * P + r0] - o;
        const double ub = rowp[col * P + r0 + 8] - o;
        const double vb = colp[col * P + r0 + 8] - o;
        t = fma(ua, fma(ra, ua, -2.0 * acc[si][e]), ca * va * va) +
            fma(ub, fma(rb, ub, -2.0 * acc[si][2 + e]), cb * vb * vb);
      }
      v[2 * s + e] = t;
    }
#pragma unroll
  for (int g0 = 0; g0 < NV; g0 += 8) {
    double grp[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) grp[i] = v[g0 + i];
    const double sum = quad_sum8(grp);
    const int u = g0 + gq;
    const int col = 8 * (q + T::kGroups * (u / 2)) + 2 * tq + (u & 1);
    if (u / 2 < NT && col < kc) red[warp * kChunk + col] = sum;
  }
}

// Scratch, per lane: part holds npairs x (d + 1) doubles (the tile pairs'
// hyperparameter partials). With NEED_X, dxpart npairs x 2 slabs of TILE x
// d doubles (each pair's contribution to the rows of tile bi, side 0, and
// of tile bj, side 1), then T x fold_runs(T) slabs (the run sums), and
// tickets T x fold_runs(T) + T + 1 unsigned (a run's count of
// contributions done, a row tile's count of runs done, the lane's count of
// pairs done); without it, one ticket (the lane's) and no dxpart. Tickets
// are zero between calls.
template <int KIND, int TILE, bool NEED_X>
__global__ void __launch_bounds__(kThreads, TILE == 32 ? 3 : 2)
gram_masked_bwd(const double* __restrict__ x,
                const double* __restrict__ mask,
                const double* __restrict__ ls,
                const double* __restrict__ amp,
                const double* __restrict__ g, double* __restrict__ part,
                double* __restrict__ dxpart, unsigned* __restrict__ tickets,
                double* __restrict__ grad_ls, double* __restrict__ grad_amp,
                double* __restrict__ grad_x, int cap, int d,
                size_t x_stride) {
  using C = Bwd<TILE, NEED_X>;
  constexpr int M = C::kMicro, P = C::kPitch, S = C::kStage;
  extern __shared__ double smem[];
  double* wt = smem;                     // G^T staging, then W (TILE x P)
  double* rowp = wt + TILE * P;          // kPanelRows x P
  double* colp = rowp + kPanelRows * P;  // kPanelRows x P
  double* red = colp + kPanelRows * P;   // kWarps x kChunk
  double* colsum = red + kWarps * kChunk;  // kWarps x TILE (product form)
  double* rowsum = colsum + kWarps * TILE;  // TILE (product form)
  __shared__ double amp_red[kWarps], inv_l[kChunk];
  __shared__ int jobs[2][2], lane_last;

  const int t_n = (cap + TILE - 1) / TILE;
  const int npairs = t_n * (t_n + 1) / 2;
  const int lane = blockIdx.y, p = blockIdx.x;
  int bi, bj;
  tile_pair_colmajor(p, t_n, &bi, &bj);
  const bool diag = bi == bj;
  const int i0 = bi * TILE, j0 = bj * TILE;
  const int tx = threadIdx.x % kEdge, ty = threadIdx.x / kEdge;
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const double* gl = g + static_cast<size_t>(lane) * cap * cap;
  const double* lsl = ls + static_cast<size_t>(lane) * d;
  const double* xl = x + lane * x_stride;
  const size_t slab = static_cast<size_t>(TILE) * d;  // one side's rows
  const int last = (d - 1) / kChunk;                  // the last chunk

  inverse_ls(inv_l, lsl, 0, min(kChunk, d));  // its load beside G's

  // w = G_ij + G_ji: direct into registers, transposed through shared
  // memory by cp.async, both in flight through the distances
  double w[M][M];
#pragma unroll
  for (int a = 0; a < M; ++a) {
    const int i = i0 + ty + kEdge * a;
#pragma unroll
    for (int b = 0; b < M; ++b) {
      const int j = j0 + tx + kEdge * b;
      w[a][b] = (i < cap && j < cap) ? gl[static_cast<size_t>(i) * cap + j]
                                     : 0.0;
    }
  }
#pragma unroll
  for (int u = 0; u < TILE * TILE / kThreads; ++u) {
    const int idx = threadIdx.x + u * kThreads;
    const int r = idx / TILE, c = idx % TILE;
    const int jj = j0 + r, ii = i0 + c;
    const bool in = jj < cap && ii < cap;
    cp_async8(wt + r * S + c, in ? gl + static_cast<size_t>(jj) * cap + ii : gl,
              in);
  }

  // squared scaled distances over every chunk; the last chunk, with its
  // ones row (NEED_X), stays staged
  double acc[M][M];
#pragma unroll
  for (int a = 0; a < M; ++a)
#pragma unroll
    for (int b = 0; b < M; ++b) acc[a][b] = 0.0;
  for (int c = 0; c <= last; ++c) {
    const int k0 = c * kChunk, kc = min(kChunk, d - k0);
    if (c > 0) {
      __syncthreads();  // every thread is done with the last chunk
      inverse_ls(inv_l, lsl, k0, kc);
    }
    __syncthreads();
    const bool ones = NEED_X && c == last;  // the dL/dx products' row sums
    load_panels_x<TILE>(rowp, colp, xl, inv_l, i0, j0, cap, d, k0, kc, ones,
                        c == last ? (kc + (ones ? 8 : 7)) & ~7 : kc);
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      double ri[M], cj[M];
#pragma unroll
      for (int a = 0; a < M; ++a) ri[a] = rowp[k * P + ty + kEdge * a];
#pragma unroll
      for (int b = 0; b < M; ++b) cj[b] = colp[k * P + tx + kEdge * b];
#pragma unroll
      for (int a = 0; a < M; ++a)
#pragma unroll
        for (int b = 0; b < M; ++b) {
          const double diff = ri[a] - cj[b];
          acc[a][b] = fma(diff, diff, acc[a][b]);
        }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // W = (G_ij + G_ji) amp m_i m_j c'_ij into shared memory, and the
  // amplitude sum. Without dL/dx W_ii = 0 (D_ii = 0: no term of the
  // lengthscale sums, whose product form it would only feed roundoff); the
  // dL/dx kernel keeps W_ii, inside phase 2b's tolerance either way and
  // faster so (PERF.md)
  const double a_amp = amp[lane];
  double amp_sum = 0.0;
  double mj[M];
#pragma unroll
  for (int b = 0; b < M; ++b) {
    const int j = j0 + tx + kEdge * b;
    mj[b] = j < cap ? mask[j] : 0.0;
  }
#pragma unroll
  for (int a = 0; a < M; ++a) {
    const int i = i0 + ty + kEdge * a;
    const double mi = i < cap ? mask[i] : 0.0;
#pragma unroll
    for (int b = 0; b < M; ++b) {
      double dcorr;
      const double wg = w[a][b] + wt[(tx + kEdge * b) * S + ty + kEdge * a];
      const double corr = correlation<double, KIND>(acc[a][b], &dcorr);
      const double gm = wg * (mi * mj[b]);
      amp_sum = fma(gm, corr, amp_sum);
      w[a][b] = !NEED_X && diag && ty + kEdge * a == tx + kEdge * b
                    ? 0.0 : gm * a_amp * dcorr;
    }
  }
  amp_sum = warp_sum(amp_sum);
  if (lid == 0) amp_red[warp] = amp_sum;
  if constexpr (!C::kExactLs) {
    // W's column sums (the thread's rows, then the warp's two rows of
    // threads) into colsum[warp][column], and its row sums (the thread's
    // columns, then the 16 threads of the row) into rowsum
#pragma unroll
    for (int b = 0; b < M; ++b) {
      double cs = w[0][b];
#pragma unroll
      for (int a = 1; a < M; ++a) cs += w[a][b];
      cs += __shfl_xor_sync(0xffffffffu, cs, 16);
      if (lid < 16) colsum[warp * TILE + tx + kEdge * b] = cs;
    }
#pragma unroll
    for (int a = 0; a < M; ++a) {
      double rs = w[a][0];
#pragma unroll
      for (int b = 1; b < M; ++b) rs += w[a][b];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      if (tx == 0) rowsum[ty + kEdge * a] = rs;
    }
  }
  __syncthreads();  // every thread is done with the staging
#pragma unroll
  for (int a = 0; a < M; ++a)
#pragma unroll
    for (int b = 0; b < M; ++b)
      wt[(ty + kEdge * a) * P + tx + kEdge * b] = w[a][b];

  // chunk by chunk, the staged last one first: the lengthscale sums (by
  // exact differences, W back from shared memory so that the products have
  // the registers, or by the product form), and with NEED_X the two
  // products on the tensor cores
  const double half = diag ? 0.5 : 1.0;
  double* pl = part + (static_cast<size_t>(lane) * npairs + p) * (d + 1);
  double* dxp = NEED_X ? dxpart + (static_cast<size_t>(lane) * npairs + p) *
                                      2 * slab
                       : nullptr;
  const int n_tasks = (diag ? 1 : 2) * C::kMTiles;
  double rsum[C::kTasks];  // r of the thread's row in each dL/dx task
  for (int c = last; c >= 0; --c) {
    const int k0 = c * kChunk, kc = min(kChunk, d - k0);
    const bool ones = NEED_X && c == last;
    if (c != last) {
      __syncthreads();  // the later chunk's products are done with the panels
      inverse_ls(inv_l, lsl, k0, kc);
      __syncthreads();
      load_panels_x<TILE>(rowp, colp, xl, inv_l, i0, j0, cap, d, k0, kc, false,
                          (kc + 7) & ~7);
    }
    __syncthreads();
    const int ntiles = (kc + (ones ? 1 : 0) + 7) / 8;
    if constexpr (C::kExactLs) {
      double wr[M][M];
#pragma unroll
      for (int a = 0; a < M; ++a)
#pragma unroll
        for (int b = 0; b < M; ++b)
          wr[a][b] = wt[(ty + kEdge * a) * P + tx + kEdge * b];
      // eight dimensions at a time, then one reduce-scatter over the warp
      for (int kg = 0; kg < kc; kg += 8) {
        double sg[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int k = kg + u;
          sg[u] = 0.0;
          if (k >= kc) continue;
          double ri[M], cj[M];
#pragma unroll
          for (int a = 0; a < M; ++a) ri[a] = rowp[k * P + ty + kEdge * a];
#pragma unroll
          for (int b = 0; b < M; ++b) cj[b] = colp[k * P + tx + kEdge * b];
          double sk = 0.0;
#pragma unroll
          for (int a = 0; a < M; ++a)
#pragma unroll
            for (int b = 0; b < M; ++b) {
              const double diff = ri[a] - cj[b];
              sk = fma(wr[a][b], diff * diff, sk);
            }
          sg[u] = sk;
        }
        const double sk = warp_sum8(sg);
        const int k = kg + (lid / 4) % 8;
        if (lid % 4 == 0 && k < kc) red[warp * kChunk + k] = sk;
      }
    } else {
      ls_products<TILE>(wt, rowp, colp, rowsum, colsum, kc, red);
    }
    if constexpr (NEED_X) {
      // three instances: one column tile (a last chunk of up to 7
      // dimensions, as at the warp fit's d=6) with four accumulators each;
      // four (a full chunk, or a last one of 24-31 dimensions, as at d=30);
      // else up to 5, the unused ones skipped (the 5-tile instance is 4 %
      // slower than the 4-tile one at d=30: tools/torch_port_tile_sweep.py
      // --backward-x)
      double* out = dxp + k0;
      if (ntiles == 1) {
        chunk_products<TILE, 1, 4>(wt, rowp, colp, n_tasks, 1, kc, ones, out,
                                   slab, d, rsum);
      } else if (ntiles == 4) {
        chunk_products<TILE, 4, 1>(wt, rowp, colp, n_tasks, 4, kc, ones, out,
                                   slab, d, rsum);
      } else {
        chunk_products<TILE, 5, 1>(wt, rowp, colp, n_tasks, ntiles, kc, ones,
                                   out, slab, d, rsum);
      }
    }
    __syncthreads();  // red is complete
    if (threadIdx.x < kc) {
      double v = 0.0;
      if constexpr (C::kExactLs) {
        for (int wp = 0; wp < kWarps; ++wp) v += red[wp * kChunk + threadIdx.x];
      } else {
        for (int m = 0; m < LsTasks<TILE>::kRowTiles; ++m)
          v += red[LsTasks<TILE>::warp_of(threadIdx.x, m) * kChunk +
                   threadIdx.x];
      }
      pl[k0 + threadIdx.x] = half * v;
    }
  }
  if (threadIdx.x == 0) {
    double v = 0.0;
    for (int wp = 0; wp < kWarps; ++wp) v += amp_red[wp];
    pl[d] = half * v;
  }

  // Tickets (draw_ticket: each publishes the block's writes and acquires
  // the other blocks').
  const int run = fold_run(t_n), runs = fold_runs(t_n);
  unsigned* tk =
      tickets + static_cast<size_t>(lane) * (NEED_X ? t_n * runs + t_n + 1 : 1);
  unsigned* tk_tile = tk + t_n * runs;
  unsigned* tk_lane = NEED_X ? tk_tile + t_n : tk;
  __syncthreads();
  // thread 2: the lane; with NEED_X threads 0 and 1: this pair's
  // contributions (tile bi at pos bj, tile bj at pos bi) to their runs
  if (threadIdx.x == 2) {
    lane_last = draw_ticket(tk_lane, 1u) == static_cast<unsigned>(npairs - 1);
    if (lane_last) *tk_lane = 0;
  } else if (NEED_X && threadIdx.x < 2) {
    const int side = threadIdx.x;
    const int t = side ? bj : bi, r0 = (side ? bi : bj) / run;
    bool done = false;
    if (side == 0 || !diag) {
      unsigned* tr = tk + t * runs + r0;
      done = draw_ticket(tr, 1u) ==
             static_cast<unsigned>(min(run, t_n - r0 * run) - 1);
      if (done) *tr = 0;  // every ticket of the run is drawn: reset
    }
    jobs[side][0] = done ? t : -1;
    jobs[side][1] = r0;
  }
  __syncthreads();
  if (lane_last) {
    // the lane's hyperparameter partials, in pair order
    const int nc = d + 1;
    const double* pl0 = part + static_cast<size_t>(lane) * npairs * nc;
    block_fold(
        nc, npairs, red,
        [&](int comp, int c) { return pl0 + static_cast<size_t>(c) * nc + comp; },
        [&](int comp, double v) {
          if (comp < d) {
            grad_ls[static_cast<size_t>(lane) * d + comp] = v / lsl[comp];
          } else {
            grad_amp[lane] = v;
          }
        });
  }
  if constexpr (!NEED_X) return;
  int job_t[2], job_r[2], nj = 0;  // the completed runs
  for (int j = 0; j < 2; ++j) {
    if (jobs[j][0] >= 0) {
      job_t[nj] = jobs[j][0];
      job_r[nj++] = jobs[j][1];
    }
  }
  if (nj == 0) return;
  double* run_sums =  // after every lane's contributions
      dxpart + (static_cast<size_t>(gridDim.y) * npairs * 2 +
                static_cast<size_t>(lane) * t_n * runs) * slab;
  const double* lane_dx = dxpart + static_cast<size_t>(lane) * npairs * 2 * slab;
  auto tile_elems = [&](int t) { return min(TILE, cap - t * TILE) * d; };
  auto store_dx = [&](int t, int e, double v) {
    const int r = e / d, k = e - r * d;
    grad_x[(static_cast<size_t>(lane) * cap + t * TILE + r) * d + k] =
        -v / lsl[k];
  };
  __syncthreads();  // the lane's fold is done with red
  // each completed run: its contributions in order, into the run's sum (or,
  // when the tile has one run, into dL/dx)
  fold_slabs(
      nj, smem, C::kSmem / static_cast<int>(sizeof(double)),
      [&](int j) { return tile_elems(job_t[j]); },
      [&](int j) { return min(run, t_n - job_r[j] * run); },
      [&](int j, int c) {
        const int t = job_t[j], pos = job_r[j] * run + c;
        const int q = pos <= t ? pair_index(t, pos, t_n)
                               : pair_index(pos, t, t_n);
        return lane_dx + (static_cast<size_t>(q) * 2 + (pos <= t ? 0 : 1)) *
                             slab;
      },
      [&](int j, int e, double v) {
        if (runs == 1) {
          store_dx(job_t[j], e, v);
        } else {
          run_sums[(static_cast<size_t>(job_t[j]) * runs + job_r[j]) * slab +
                   e] = v;
        }
      });
  if (runs == 1) return;
  // a tile whose last run this block completed: the run sums, in order
  __syncthreads();
  if (threadIdx.x < nj) {
    const int t = job_t[threadIdx.x];
    const bool done =
        draw_ticket(tk_tile + t, 1u) == static_cast<unsigned>(runs - 1);
    if (done) tk_tile[t] = 0;
    jobs[threadIdx.x][0] = done ? t : -1;
  }
  __syncthreads();
  int nt = 0;
  for (int j = 0; j < nj; ++j)
    if (jobs[j][0] >= 0) job_t[nt++] = jobs[j][0];
  fold_slabs(
      nt, smem, C::kSmem / static_cast<int>(sizeof(double)),
      [&](int j) { return tile_elems(job_t[j]); }, [&](int) { return runs; },
      [&](int j, int c) {
        return run_sums + (static_cast<size_t>(job_t[j]) * runs + c) * slab;
      },
      [&](int j, int e, double v) { store_dx(job_t[j], e, v); });
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

// Runs in which the coordinate backward folds a row tile's T contributions.
extern "C" int bobe_gram_fold_runs(int t_n) { return fold_runs(t_n); }

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

template <int KIND, int TILE, bool NEED_X>
int launch_bwd_kernel(const double* x, const double* mask, const double* ls,
                      const double* amp, const double* g, double* part,
                      double* dxpart, unsigned* tickets, double* grad_ls,
                      double* grad_amp, double* grad_x, int cap, int d,
                      int lanes, size_t xs, cudaStream_t s) {
  auto kernel = gram_masked_bwd<KIND, TILE, NEED_X>;
  constexpr int kSmem = Bwd<TILE, NEED_X>::kSmem;
  // the opt-in above 48 KB of dynamic shared memory, once per device
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = true;
  }
  const int t_n = (cap + TILE - 1) / TILE;
  kernel<<<dim3(t_n * (t_n + 1) / 2, lanes), kThreads, kSmem, s>>>(
      x, mask, ls, amp, g, part, dxpart, tickets, grad_ls, grad_amp, grad_x,
      cap, d, xs);
  return static_cast<int>(cudaGetLastError());
}

template <bool NEED_X>
int launch_bwd(const double* x, const double* mask, const double* ls,
               const double* amp, const double* g, double* part,
               double* dxpart, unsigned* tickets, double* grad_ls,
               double* grad_amp, double* grad_x, int cap, int d, int lanes,
               int x_per_lane, int kind, int tile, void* stream) {
  if (cap <= 0 || d <= 0 || lanes <= 0 || lanes > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t xs = x_per_lane ? static_cast<size_t>(cap) * d : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0 && tile == 32)
    return launch_bwd_kernel<0, 32, NEED_X>(x, mask, ls, amp, g, part, dxpart,
                                            tickets, grad_ls, grad_amp,
                                            grad_x, cap, d, lanes, xs, s);
  if (kind == 0 && tile == 64)
    return launch_bwd_kernel<0, 64, NEED_X>(x, mask, ls, amp, g, part, dxpart,
                                            tickets, grad_ls, grad_amp,
                                            grad_x, cap, d, lanes, xs, s);
  if (kind == 1 && tile == 32)
    return launch_bwd_kernel<1, 32, NEED_X>(x, mask, ls, amp, g, part, dxpart,
                                            tickets, grad_ls, grad_amp,
                                            grad_x, cap, d, lanes, xs, s);
  if (kind == 1 && tile == 64)
    return launch_bwd_kernel<1, 64, NEED_X>(x, mask, ls, amp, g, part, dxpart,
                                            tickets, grad_ls, grad_amp,
                                            grad_x, cap, d, lanes, xs, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// g is dL/dK (lanes, cap, cap); writes grad_ls (lanes, d) and grad_amp
// (lanes,) and, when grad_x is not null, dL/dx into grad_x (lanes, cap, d),
// in one launch with tile edge `tile` (32 or 64; T = ceil(cap / tile) row
// tiles, T (T + 1) / 2 pairs, R = bobe_gram_fold_runs(T)). Scratch: part
// lanes * pairs * (d + 1) doubles; with grad_x, dxpart lanes * (2 pairs +
// T R) * tile * d doubles and tickets lanes * (T R + T + 1) unsigned, else
// no dxpart and tickets lanes unsigned; tickets are 0 before the call and
// 0 again after it. Returns the cudaError_t of the launch.
extern "C" int bobe_gram_masked_backward_f64(
    const double* x, const double* mask, const double* ls, const double* amp,
    const double* g, double* part, double* dxpart, unsigned* tickets,
    double* grad_ls, double* grad_amp, double* grad_x, int cap, int d,
    int lanes, int x_per_lane, int kind, int tile, void* stream) {
  if (grad_x)
    return launch_bwd<true>(x, mask, ls, amp, g, part, dxpart, tickets,
                            grad_ls, grad_amp, grad_x, cap, d, lanes,
                            x_per_lane, kind, tile, stream);
  return launch_bwd<false>(x, mask, ls, amp, g, part, nullptr, tickets,
                           grad_ls, grad_amp, nullptr, cap, d, lanes,
                           x_per_lane, kind, tile, stream);
}
