// Backward (VJP) of the deep tile grid, B8: replaces the JAX package's
// Pallas TPU kernel repro/kernels/givens_mesh.py: deepgrid_bwd_kernel (via
// deepgrid_bwd_pallas_call).
//
// Forward (deepgrid_fwd.cu), per layer l and tile (o, i):
// s = g0 * in_i, v = V s, u = U (g1 * v), z = g2 * u, row_o = sum_i z_(o,i);
// layer l > 0 takes in_i = |row_i| of layer l - 1.  From the input x
// (complex64 [B, Ti n]), the saved stage boundaries sv, su (complex64
// [L, B, To, Ti, n], both before their gain) and the cotangent gout of the
// output (float32 magnitudes, or complex64 rows, [B, To n]) this computes
//
//   dcv, dcu [L, To, Ti, C, 8, P]   the coefficient gradients
//   dg [L, To, Ti, 12, P]           the gains gradient (rows 0-3 g0, 4-7 g1,
//                                   8-11 g2; even re, even im, odd re,
//                                   odd im)
//   dx                              dL/dRe x + i dL/dIm x, complex64
//                                   [B, Ti n]
//
// Per row, layers in reverse:
//   0. the readout: with detect_last the |.| backward gz = gout z / |z| of
//      the last layer's rows z (rebuilt from su and g2, no sweep), exactly 0
//      where |z| = 0; else gz = gout.  The combine is a sum, so every tile of
//      row o sees gz_o;
//   1. g2: dg rows 8-11 += conj(u) gz; the cotangent at u is conj(g2) gz;
//   2. U's reversed sweep from the saved post-U boundary;
//   3. g1: dg rows 4-7 += conj(v) gh; the cotangent at v is conj(g1) gh;
//   4. V's reversed sweep from the saved post-V boundary;
//   5. g0: dg rows 0-3 += conj(in) gs, with in rebuilt as x (l = 0) or
//      |row| of layer l - 1 from its saved post-U and g2 (no sweep);
//   6. the combine's transpose: input tile i's cotangent is the sum over the
//      To rows, in ascending order, of its tiles' cotangents.  At l > 0 only
//      its real part crosses the boundary (the input's imaginary part is 0),
//      through the |.| backward of layer l - 1's rows: that is gz for l - 1.
//      At l = 0 it is dx.
// A parked tile (g2 = 0) and a zero row give exact zeros, never NaN.
//
// Two paths, chosen by the caller's plan (givens_mesh.deepgrid_bwd_plan: by
// n, the grid and shared memory; an error, never a fallback).
//
// Register path, n in {2, 4, 8, 16, 32} and at most 32 tiles.  The
// coefficients stream through a ring of landing buffers by cp.async, in
// chunks of K columns of every tile of one mesh, in the reversed walk's
// order (layers from the last, U before V, columns from the last; every
// layer's gains staged once, the whole network at once where it fits, as
// at the depth-4 MNIST network); after a chunk lands the block stages its
// cells with their inverses cell-major, each inverse computed once a
// block, and marks each column's identity runs (mesh_sweep.cuh:
// stage_marked).  The sweeps skip those runs' inverse and adjoint but sum
// every slot's terms (an identity cell's coefficients have a gradient too).
// After each chunk, and each layer for the gains, the block writes its sums
// over its rows once, coalesced: straight into [dcv | dcu | dg] when one
// block covers the batch (one kernel a call), else into its slice of
// partial[blocks], which reduce_partials sums in block order.  Where the
// slices would exceed the plan's budget or one wave, blocks walk the
// batch's row tiles with a grid stride and add into their slice.
//  - A grid (deepgrid_bwd_reg_kernel<n>): a block owns 8 rows, one thread
//    per (row, tile), rows fastest, so a warp holds 4 tiles' 8 rows (the
//    64x64 cascade: 128 blocks of 128 threads at B = 1024).  A thread keeps
//    its tile's n channels of state and cotangent in registers, reads its
//    saved boundaries as 16-byte words and reverses a column group by group
//    (mesh_sweep.cuh: reverse_columns); each group's terms are summed over
//    the tile's 8 rows by shuffles (scatter_sum within 8 lanes) into the
//    chunk's sums in shared memory.  Barriers: three a chunk (landed;
//    staged; summed) and four a layer (the row combines of the readout, of
//    layer l - 1's rows and of the cotangent's transpose run through shared
//    memory).
//  - One tile (deepgrid_bwd_lane_kernel<n>: the depth-4 MNIST network):
//    n / 2 lanes a row, one cell a lane (mesh_sweep.cuh: lane_column), so a
//    warp's chain of columns is a cell long, not a row's n / 2 cells: with
//    one thread a row the SGD step's batch of 10 was one warp latency-bound
//    at 0.57 us a column (0.060 ms a call on an H100, PERF.md §6).  Each
//    lane stores its terms into its row's terms in shared memory, summed
//    over the block's rows in row order after each chunk (flush_rows); the
//    |.| backward, the gains and the layer boundaries are the lane's own.
//
// General path, any other even n (deepgrid_bwd_kernel): threads map over
// (row, tile, pair slot), as in the forward.  Shared memory per row: the
// state and cotangent of every tile (float2[To Ti][n] each), the gradient
// terms (float[To Ti][8 P]), the row cotangents gz and the previous
// layer's rows (float2[max(To, Ti) n] each): 9 KiB at 64 x 64.  512 threads
// take R = 512 / (To Ti P) rows (1 to 64) per block, each column's terms
// summed over them into the block's slice (mesh_sweep.cuh:
// grid_reverse_sweep, two barriers a column), then reduce_partials.
//
// Determinism: no float atomics.  Every sum runs in an order fixed by the
// plan (lanes, tiles of a block, blocks), and the plan depends only on B,
// the grid and the card: two calls on the same inputs give the same bits.
// A slice is L To Ti (2 C 8 P + 12 P) floats: 0.97 MB at the cascade.
//
// Bound: about three times the forward's operations (the inverse rebuild,
// the adjoint and the conjugate products per cell) against x, sv, su, gout
// and dx: operation-bound at 64 x 64, L = 4.

#include <cstdint>

#include "mesh_sweep.cuh"

namespace {

using mesh_sweep::cadd;
using mesh_sweep::cmul;
using mesh_sweep::cmulc;
using mesh_sweep::cp_async_commit;
using mesh_sweep::cp_async_wait;
using mesh_sweep::detect_bwd;
using mesh_sweep::gain_at;

constexpr int kBwdThreads = 512;
constexpr int kMaxRows = 64;
constexpr int kRegThreads = 256;   // a register-path block's threads, most
constexpr int kGridRows = 8;       // rows a block of a register-path grid
constexpr int kMaxStages = 8;      // landing buffers at most (cp_async_wait)

// Row o's combined output z of a layer: sum over its Ti tiles, in order, of
// g2 * u, from the layer's saved post-U boundary of this row (`u_row`,
// float2[To Ti][n]) and its gains `g`.
__device__ __forceinline__ float2 row_z(const float2* __restrict__ u_row,
                                        const float* __restrict__ g, int o,
                                        int ti, int k, int n) {
  const int p = n / 2;
  const int t0 = o * ti;
  float2 z = cmul(u_row[t0 * n + k], gain_at(g, t0, 8, k, p));
  for (int j = 1; j < ti; ++j) {
    z = cadd(z, cmul(u_row[(t0 + j) * n + k], gain_at(g, t0 + j, 8, k, p)));
  }
  return z;
}

// conj(a) * b into the 4 gain rows (even re, even im, odd re, odd im) of a
// tile's [8 P] terms.
__device__ __forceinline__ void gain_terms(float* tr, float2 a, float2 b,
                                           int k, int p) {
  const int s = k >> 1, o = k & 1;
  const float2 d = cmulc(a, b);
  tr[(2 * o) * p + s] = d.x;
  tr[(2 * o + 1) * p + s] = d.y;
}

template <bool kDetectLast>
__global__ void __launch_bounds__(kBwdThreads)
deepgrid_bwd_kernel(const float2* __restrict__ x, const float2* __restrict__ sv,
                    const float2* __restrict__ su,
                    const void* __restrict__ gout,
                    const float* __restrict__ coef_v,
                    const int* __restrict__ par_v,
                    const float* __restrict__ coef_u,
                    const int* __restrict__ par_u,
                    const float* __restrict__ gains,
                    float* __restrict__ partial, float2* __restrict__ dx,
                    int batch, int n, int n_layers, int to, int ti, int n_cols,
                    int rows_per_tile, int n_tiles) {
  extern __shared__ float2 smem[];
  const int p = n / 2;
  const int m = 8 * p;
  const int tiles = to * ti;
  const int tn = tiles * n;
  const int row_w = (to > ti ? to : ti) * n;
  float2* st = smem;                                   // [R][tiles][n]
  float2* gt = st + rows_per_tile * tn;                // [R][tiles][n]
  float2* gz = gt + rows_per_tile * tn;                // [R][row_w]
  float2* zp = gz + rows_per_tile * row_w;             // [R][row_w]
  float* terms = reinterpret_cast<float*>(zp + rows_per_tile * row_w);
  //                                                      [R][tiles][8 P]
  const long long coef_layer = static_cast<long long>(tiles) * n_cols * m;
  const int par_layer = tiles * n_cols;
  const int gain_layer = tiles * 12 * p;
  const long long slice = n_layers * (2 * coef_layer + gain_layer);
  float* part_v = partial + blockIdx.x * slice;
  float* part_u = part_v + n_layers * coef_layer;
  float* part_g = part_u + n_layers * coef_layer;
  const int in_w = ti * n, out_w = to * n;

  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * rows_per_tile;
    const long long left = batch - row0;
    const int rows = left < rows_per_tile ? static_cast<int>(left)
                                          : rows_per_tile;

    // 0: the readout's cotangent at the last layer's rows
    {
      const int l = n_layers - 1;
      const float* g = gains + l * gain_layer;
      const float2* u_blk = su + (static_cast<long long>(l) * batch + row0) * tn;
      for (int i = threadIdx.x; i < rows * out_w; i += blockDim.x) {
        const int r = i / out_w;
        const int q = i - r * out_w;
        const long long at = row0 * out_w + i;
        if (kDetectLast) {
          const int o = q / n, k = q - o * n;
          const float2 z = row_z(u_blk + r * tn, g, o, ti, k, n);
          gz[r * row_w + q] = detect_bwd(z, static_cast<const float*>(gout)[at]);
        } else {
          gz[r * row_w + q] = static_cast<const float2*>(gout)[at];
        }
      }
    }
    __syncthreads();

    for (int l = n_layers - 1; l >= 0; --l) {
      const float* g = gains + l * gain_layer;
      const long long stage = (static_cast<long long>(l) * batch + row0) * tn;
      float* dg_l = part_g + l * gain_layer;
      // layer l's input rows: layer l - 1's combined rows (To == Ti)
      if (l > 0) {
        const float* gp = gains + (l - 1) * gain_layer;
        const float2* u_prev = su + stage - static_cast<long long>(batch) * tn;
        for (int i = threadIdx.x; i < rows * in_w; i += blockDim.x) {
          const int r = i / in_w;
          const int q = i - r * in_w;
          const int o = q / n, k = q - o * n;
          zp[r * row_w + q] = row_z(u_prev + r * tn, gp, o, ti, k, n);
        }
      }
      // 1: g2, from the saved post-U boundary (every tile of row o sees gz_o)
      for (int i = threadIdx.x; i < rows * tn; i += blockDim.x) {
        const int r = i / tn;
        const int q = i - r * tn;
        const int t = q / n, k = q - t * n;
        const float2 u = su[stage + i];
        const float2 gzo = gz[r * row_w + (t / ti) * n + k];
        gain_terms(terms + (r * tiles + t) * m, u, gzo, k, p);
        st[i] = u;
        gt[i] = cmulc(gain_at(g, t, 8, k, p), gzo);
      }
      __syncthreads();
      mesh_sweep::grid_sum_rows(terms, rows, tiles, m, 4 * p, dg_l + 8 * p,
                                12 * p, first, nullptr, 0, p);
      __syncthreads();
      // 2: U's reversed sweep
      mesh_sweep::grid_reverse_sweep(st, gt, terms, coef_u + l * coef_layer,
                                     par_u + l * par_layer, n_cols, rows,
                                     tiles, n, part_u + l * coef_layer, first);
      // 3: g1, from the saved post-V boundary
      for (int i = threadIdx.x; i < rows * tn; i += blockDim.x) {
        const int r = i / tn;
        const int q = i - r * tn;
        const int t = q / n, k = q - t * n;
        const float2 v = sv[stage + i];
        const float2 gh = gt[i];
        gain_terms(terms + (r * tiles + t) * m, v, gh, k, p);
        st[i] = v;
        gt[i] = cmulc(gain_at(g, t, 4, k, p), gh);
      }
      __syncthreads();
      mesh_sweep::grid_sum_rows(terms, rows, tiles, m, 4 * p, dg_l + 4 * p,
                                12 * p, first, nullptr, 0, p);
      __syncthreads();
      // 4: V's reversed sweep
      mesh_sweep::grid_reverse_sweep(st, gt, terms, coef_v + l * coef_layer,
                                     par_v + l * par_layer, n_cols, rows,
                                     tiles, n, part_v + l * coef_layer, first);
      // 5: g0, on the layer's input tiles
      for (int i = threadIdx.x; i < rows * tn; i += blockDim.x) {
        const int r = i / tn;
        const int q = i - r * tn;
        const int t = q / n, k = q - t * n;
        const int at = (t % ti) * n + k;
        float2 in;
        if (l == 0) {
          in = x[(row0 + r) * in_w + at];
        } else {
          const float2 z = zp[r * row_w + at];
          in = make_float2(sqrtf(z.x * z.x + z.y * z.y), 0.f);
        }
        const float2 gs = gt[i];
        gain_terms(terms + (r * tiles + t) * m, in, gs, k, p);
        gt[i] = cmulc(gain_at(g, t, 0, k, p), gs);
      }
      __syncthreads();
      mesh_sweep::grid_sum_rows(terms, rows, tiles, m, 4 * p, dg_l, 12 * p,
                                first, nullptr, 0, p);
      // 6: the combine's transpose, then the boundary or dx
      for (int i = threadIdx.x; i < rows * in_w; i += blockDim.x) {
        const int r = i / in_w;
        const int q = i - r * in_w;
        const float2* gq = gt + r * tn + q;   // tile (0, q / n), channel q % n
        float2 d = gq[0];
        for (int o = 1; o < to; ++o) d = cadd(d, gq[o * in_w]);
        if (l > 0) {
          gz[r * row_w + q] = detect_bwd(zp[r * row_w + q], d.x);
        } else {
          dx[(row0 + r) * in_w + q] = d;
        }
      }
      __syncthreads();
    }
    first = false;
  }
}

// ---------------------------------------------------------------------------
// register path
// ---------------------------------------------------------------------------

// Shared memory of the register path, in floats: `stages` landing buffers,
// each [tiles][rts] coefficients (a tile's kcap [8][P] columns, padded)
// then [tiles][kcap] parities (int32);
// the staged cells [tiles][cts] (float4, cts = 4 kcap P + 1: an odd number
// of 16-byte words a tile, so lanes reading one word of four tiles fall on
// distinct banks); the marks [kcap][tiles]; every layer's gains
// [L][tiles][gstride]; for a grid the chunk's column sums [tiles][kcap][8
// P] and the layer's gain sums [tiles][12 P], for one tile each row's
// column terms [R][sstride] and gain terms [R][gsstride] (rows padded by 16
// bytes).  givens_mesh.py: _deep_bwd_smem computes the same bytes.
struct BwdLayout {
  int rts, raw, cts, cells, marks, gstride, gains, sums, sstride, gsums,
      gsstride, work;
  __host__ __device__ BwdLayout(int n, int n_layers, int tiles, int kcap,
                                int stages, int rows) {
    const int pars = (tiles * kcap + 3) & ~3;
    // a grid's tiles 8 floats apart: four tiles' slots on 32 banks
    rts = kcap * 4 * n + (tiles > 1 ? 8 : 0);
    raw = tiles * rts + pars;
    cts = 2 * kcap * n + 1;
    cells = stages * raw;
    marks = cells + 4 * tiles * cts;
    gstride = 6 * n + 4;
    gains = marks + pars;
    sums = gains + n_layers * tiles * gstride;
    if (tiles == 1) {  // one tile: each row's terms, rows padded
      sstride = kcap * 4 * n + 4;
      gsstride = 6 * n + 4;
      gsums = sums + rows * sstride;
      work = gsums + rows * gsstride;
    } else {           // a grid: each tile's sums over the block's rows
      sstride = kcap * 4 * n;
      gsstride = 6 * n;
      gsums = sums + tiles * sstride;
      work = gsums + tiles * gsstride;
    }
  }
};

// Dynamic shared bytes of a register-path block: BwdLayout, then, for a
// grid, float2 the tiles' values [RW][tiles][n], the row cotangents
// [RW][row_w] and layer l - 1's rows [RW][row_w] (row_w = max(To, Ti) n).
inline size_t reg_shared_bytes(int n, int n_layers, int to, int ti, int rows,
                               int kcap, int stages) {
  const BwdLayout lay(n, n_layers, to * ti, kcap, stages, rows);
  if (to * ti == 1) return 4 * static_cast<size_t>(lay.work);
  const size_t row_w = static_cast<size_t>(to > ti ? to : ti) * n;
  return 4 * static_cast<size_t>(lay.work)
         + 8 * static_cast<size_t>(rows)
               * (static_cast<size_t>(to) * ti * n + 2 * row_w);
}

// The K values d summed over the kGridRows rows of the lane's segment (its
// tile's rows: scatter_sum over 8 lanes) and, where `write`, stored into
// dst at (v / GR) P + v % GR for value v (GR values a row of the group) by
// the lanes that hold them.
template <int K, int GR, int P>
__device__ __forceinline__ void store_segment_sum(const float (&d)[K],
                                                  int lane, float* dst,
                                                  bool write) {
  constexpr int RW = kGridRows;
  constexpr int KO = K >= RW ? K / RW : 1;
  float sum[KO];
  mesh_sweep::scatter_sum<K, RW / 2, KO>(d, lane, sum);
  const int seg = lane & (RW - 1);
  if (!write) return;
  if constexpr (KO == 4 && GR == 4) {  // row `seg` of the group: 16 bytes
    *reinterpret_cast<float4*>(dst + seg * P) =
        make_float4(sum[0], sum[1], sum[2], sum[3]);
  } else if constexpr (K >= RW) {
#pragma unroll
    for (int j = 0; j < KO; ++j) {
      const int v = seg * KO + j;
      dst[(v / GR) * P + v % GR] = sum[j];
    }
  } else {
    constexpr int kShare = RW / K;  // lanes that hold each sum
    if ((seg & (kShare - 1)) == 0) {
      const int v = seg / kShare;
      dst[(v / GR) * P + v % GR] = sum[0];
    }
  }
}

// conj(a) b summed over the segment's rows into a tile's gain sums (gsum:
// its [12][P], `base` 0 g0, 4 g1, 8 g2), in groups of GG = min(P, 8) slots.
template <int N>
__device__ __forceinline__ void sum_gain(const float2 (&a)[N],
                                         const float2 (&b)[N], float* gsum,
                                         int base, int lane, bool write) {
  constexpr int P = N / 2;
  constexpr int GG = P < 8 ? P : 8;
#pragma unroll
  for (int g0 = 0; g0 < P; g0 += GG) {
    float d[4 * GG];
    mesh_sweep::gain_group<N, GG>(a, b, g0, d);
    store_segment_sum<4 * GG, GG, P>(d, lane, gsum + base * P + g0, write);
  }
}

// One-tile grids (the depth-4 MNIST network): P = n / 2 lanes a row, lane
// j holding channels 2 j and 2 j + 1 of the row's state and cotangent and
// reversing cell j of each column: a parity-0 cell is its own pair, a
// parity-1 cell j pairs its odd channel with lane j + 1's even one, which a
// shuffle brings and takes back (the wrap slot, lane P - 1, holds no
// cell).  With one tile nothing crosses rows, so the |.| backward, the
// gains and the layer boundaries are the lane's own.  Each lane stores its
// cell's eight terms and its gains' four into its row's terms in shared
// memory; after each chunk (and each layer, for the gains) the block sums
// them over its rows in row order (flush_rows) and writes the sums once.
template <int N, bool kDetectLast>
__global__ void __launch_bounds__(kRegThreads, 1)
deepgrid_bwd_lane_kernel(const float2* __restrict__ x,
                         const float2* __restrict__ sv,
                         const float2* __restrict__ su,
                         const void* __restrict__ gout,
                         const float* __restrict__ coef_v,
                         const int* __restrict__ par_v,
                         const float* __restrict__ coef_u,
                         const int* __restrict__ par_u,
                         const float* __restrict__ gains,
                         float* __restrict__ out, float2* __restrict__ dx,
                         int batch, int n_layers, int to, int ti, int n_cols,
                         int rows_per_block, int kcap, int stages,
                         int n_tiles) {
  constexpr int P = N / 2;
  constexpr int M = 8 * P;                 // gradient entries a column
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const BwdLayout lay(N, n_layers, 1, kcap, stages, rows_per_block);
  const float4* cells = reinterpret_cast<const float4*>(sm + lay.cells);
  unsigned* marks = reinterpret_cast<unsigned*>(sm + lay.marks);
  const int j = threadIdx.x % P;           // the lane's slot
  const int r = threadIdx.x / P;           // the lane's row in the block
  float* terms = sm + lay.sums + r * lay.sstride;    // its row's column terms
  float* gterms = sm + lay.gsums + r * lay.gsstride;  // its row's gain terms
  const int per_mesh = (n_cols + kcap - 1) / kcap;
  const int n_chunks = 2 * n_layers * per_mesh;
  const long long coef_layer = static_cast<long long>(n_cols) * M;
  const long long slice = (2 * coef_layer + 12 * P) * n_layers;
  float* dst = out + blockIdx.x * slice;   // [dcv | dcu | dg]
  const bool vec = ((reinterpret_cast<uintptr_t>(x)
                     | reinterpret_cast<uintptr_t>(sv)
                     | reinterpret_cast<uintptr_t>(su)
                     | reinterpret_cast<uintptr_t>(dx)) & 15) == 0;

  auto stage = [&](int jj) {               // as the grid kernel's
    const int l = n_layers - 1 - jj / (2 * per_mesh);
    const int m = 1 - (jj / per_mesh) % 2;
    const int c_end = n_cols - (jj % per_mesh) * kcap;
    const int c0 = c_end > kcap ? c_end - kcap : 0;
    float* buf = sm + (jj % stages) * lay.raw;
    mesh_sweep::copy_chunk(buf, lay.rts,
                           reinterpret_cast<int*>(buf + lay.rts), kcap,
                           (m ? coef_u : coef_v) + l * coef_layer,
                           (m ? par_u : par_v) + l * n_cols, 1, n_cols, c0,
                           c_end - c0, N);
  };
  // gain `base` (0 g0, 4 g1, 8 g2) of layer l at channel 2 j + o
  auto gain = [&](int l, int base, int o) {
    const float* g = sm + lay.gains + l * lay.gstride + (base + 2 * o) * P + j;
    return make_float2(g[0], g[P]);
  };
  // conj(a) b of the lane's two channels into its row's gain terms
  auto gain_terms = [&](float2 a0, float2 a1, float2 b0, float2 b1,
                        int base) {
    const float2 e = cmulc(a0, b0), o = cmulc(a1, b1);
    gterms[(base + 0) * P + j] = e.x;
    gterms[(base + 1) * P + j] = e.y;
    gterms[(base + 2) * P + j] = o.x;
    gterms[(base + 3) * P + j] = o.y;
  };

  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * rows_per_block;
    const long long left = batch - row0;
    const int rows = left < rows_per_block ? static_cast<int>(left)
                                           : rows_per_block;
    const bool active = r < rows;
    const long long at = (row0 + r) * N + 2 * j;  // the lane's channels
    if (first) {
      mesh_sweep::copy_gains(sm + lay.gains, gains, n_layers, 1, N,
                             lay.gstride);
    }
    for (int jj = 0; jj < stages - 1; ++jj) {
      if (jj < n_chunks) stage(jj);
      cp_async_commit();
    }
    cp_async_wait(stages - 2);
    __syncthreads();  // the gains landed
    const float2 zero = make_float2(0.f, 0.f);
    float2 s0 = zero, s1 = zero, g0 = zero, g1 = zero;  // state, cotangent
    // 0: the readout's cotangent at the last layer's row
    if (active) {
      const long long top = static_cast<long long>(n_layers - 1) * batch * N
                            + at;
      if (kDetectLast) {
        float2 u0, u1;
        mesh_sweep::load_pair(u0, u1, su + top, vec);
        const float* go = static_cast<const float*>(gout) + at;
        g0 = detect_bwd(cmul(u0, gain(n_layers - 1, 8, 0)), go[0]);
        g1 = detect_bwd(cmul(u1, gain(n_layers - 1, 8, 1)), go[1]);
      } else {
        mesh_sweep::load_pair(g0, g1, static_cast<const float2*>(gout) + at, vec);
      }
    }
    int jc = 0;  // the chunk to sweep next
    for (int l = n_layers - 1; l >= 0; --l) {
      const long long stg = static_cast<long long>(l) * batch * N + at;
      float2 v0 = zero, v1 = zero, z0 = zero, z1 = zero;
      if (active) {  // 1: g2, from the saved post-U boundary
        mesh_sweep::load_pair(s0, s1, su + stg, vec);
        mesh_sweep::load_pair(v0, v1, sv + stg, vec);    // for g1, loaded ahead
        if (l > 0) {  // layer l - 1's row, for g0 and the boundary
          mesh_sweep::load_pair(z0, z1, su + stg - static_cast<long long>(batch) * N,
                    vec);
          z0 = cmul(z0, gain(l - 1, 8, 0));
          z1 = cmul(z1, gain(l - 1, 8, 1));
        }
      }
      gain_terms(s0, s1, g0, g1, 8);
      g0 = cmulc(gain(l, 8, 0), g0);
      g1 = cmulc(gain(l, 8, 1), g1);
      // 2-4: U's reversed sweep, g1, V's reversed sweep
      for (int m = 1; m >= 0; --m) {
        for (int q = 0; q < per_mesh; ++q, ++jc) {
          const int c_end = n_cols - q * kcap;
          const int c0 = c_end > kcap ? c_end - kcap : 0;
          const int kc = c_end - c0;
          const float* buf = sm + (jc % stages) * lay.raw;
          cp_async_wait(stages - 2);
          __syncthreads();  // chunk jc landed; chunk jc - 1 written out
          if (jc + stages - 1 < n_chunks) stage(jc + stages - 1);
          cp_async_commit();
          mesh_sweep::stage_marked<P>(
              const_cast<float4*>(cells), 0, marks, buf, 0,
              reinterpret_cast<const int*>(buf + lay.rts), 0, 1, kc);
          __syncthreads();  // cells and marks staged
          for (int k = kc - 1; k >= 0; --k) {
            float d[8];
            mesh_sweep::lane_column<N>(s0, s1, g0, g1, cells + 4 * P * k,
                                       marks[k], j, d);
#pragma unroll
            for (int u = 0; u < 8; ++u) terms[k * M + u * P + j] = d[u];
          }
          __syncthreads();  // the chunk's terms written
          mesh_sweep::flush_rows(sm + lay.sums, lay.sstride, rows, kc * M,
                     dst + (m ? n_layers * coef_layer : 0) + l * coef_layer
                         + c0 * M,
                     first);
        }
        if (m == 1) {  // 3: g1, from the saved post-V boundary
          s0 = v0;
          s1 = v1;
          gain_terms(s0, s1, g0, g1, 4);
          g0 = cmulc(gain(l, 4, 0), g0);
          g1 = cmulc(gain(l, 4, 1), g1);
        }
      }
      // 5: g0, on the layer's input: x, or |row| of layer l - 1
      if (l == 0) {
        if (active) mesh_sweep::load_pair(s0, s1, x + at, vec);
      } else {
        s0 = make_float2(sqrtf(z0.x * z0.x + z0.y * z0.y), 0.f);
        s1 = make_float2(sqrtf(z1.x * z1.x + z1.y * z1.y), 0.f);
      }
      gain_terms(s0, s1, g0, g1, 0);
      g0 = cmulc(gain(l, 0, 0), g0);
      g1 = cmulc(gain(l, 0, 1), g1);
      // 6: one tile, so the combine's transpose is the identity
      if (l > 0) {
        g0 = detect_bwd(z0, g0.x);
        g1 = detect_bwd(z1, g1.x);
      } else if (active) {
        if (vec) {
          *reinterpret_cast<float4*>(dx + at) =
              make_float4(g0.x, g0.y, g1.x, g1.y);
        } else {
          dx[at] = g0;
          dx[at + 1] = g1;
        }
      }
      __syncthreads();  // the layer's gain terms written
      mesh_sweep::flush_rows(sm + lay.gsums, lay.gsstride, rows, 12 * P,
                 dst + 2 * n_layers * coef_layer + l * 12 * P, first);
      __syncthreads();
    }
    first = false;
  }
}

template <int N, bool kDetectLast>
__global__ void __launch_bounds__(kRegThreads, 1)
deepgrid_bwd_reg_kernel(const float2* __restrict__ x,
                        const float2* __restrict__ sv,
                        const float2* __restrict__ su,
                        const void* __restrict__ gout,
                        const float* __restrict__ coef_v,
                        const int* __restrict__ par_v,
                        const float* __restrict__ coef_u,
                        const int* __restrict__ par_u,
                        const float* __restrict__ gains,
                        float* __restrict__ out, float2* __restrict__ dx,
                        int batch, int n_layers, int to, int ti, int n_cols,
                        int rows_per_block, int kcap, int stages,
                        int n_tiles) {
  constexpr int RW = kGridRows;
  constexpr int P = N / 2;
  constexpr int M = 8 * P;                 // gradient entries a column
  constexpr int G = P < 4 ? P : 4;         // slots a group (reverse_group)
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tiles = to * ti;
  const BwdLayout lay(N, n_layers, tiles, kcap, stages, RW);
  float4* cells = reinterpret_cast<float4*>(sm + lay.cells);
  unsigned* marks = reinterpret_cast<unsigned*>(sm + lay.marks);
  float* sums = sm + lay.sums;             // [tiles][kcap][8 P]
  float* gsums = sm + lay.gsums;           // [tiles][12 P]
  const int row_w = (to > ti ? to : ti) * N;
  float2* work = reinterpret_cast<float2*>(sm + lay.work);  // [RW][tiles][N]
  float2* gzb = work + RW * tiles * N;     // [RW][row_w]
  float2* rowz = gzb + RW * row_w;         // [RW][row_w]
  const int lane = threadIdx.x & 31;
  const int r = threadIdx.x % RW;
  const int t = threadIdx.x / RW;
  const bool has_tile = t < tiles;
  const int tt = has_tile ? t : 0;  // lanes past the tiles hold zeros
  const int o = tt / ti, i = tt % ti;
  const int in_w = ti * N, out_w = to * N;
  const int per_mesh = (n_cols + kcap - 1) / kcap;
  const int n_chunks = 2 * n_layers * per_mesh;
  const long long coef_layer = static_cast<long long>(tiles) * n_cols * M;
  const long long slice = 2 * n_layers * coef_layer
                          + static_cast<long long>(n_layers) * tiles * 12 * P;
  float* dst = out + blockIdx.x * slice;   // [dcv | dcu | dg]
  const bool vec = ((reinterpret_cast<uintptr_t>(x)
                     | reinterpret_cast<uintptr_t>(sv)
                     | reinterpret_cast<uintptr_t>(su)) & 15) == 0;
  float* gsum = gsums + tt * lay.gsstride;  // this lane's tile's gain sums

  // chunk jj of the reversed walk into landing buffer jj % stages
  auto stage = [&](int jj) {
    const int l = n_layers - 1 - jj / (2 * per_mesh);
    const int m = 1 - (jj / per_mesh) % 2;
    const int c_end = n_cols - (jj % per_mesh) * kcap;
    const int c0 = c_end > kcap ? c_end - kcap : 0;
    const long long layer = static_cast<long long>(l) * tiles * n_cols;
    float* buf = sm + (jj % stages) * lay.raw;
    mesh_sweep::copy_chunk(buf, lay.rts,
                           reinterpret_cast<int*>(buf + tiles * lay.rts),
                           kcap, (m ? coef_u : coef_v) + layer * M,
                           (m ? par_u : par_v) + layer, tiles, n_cols, c0,
                           c_end - c0, N);
  };
  // gain `base` (0 g0, 4 g1, 8 g2) of this lane's tile in layer l, channel k
  auto gain = [&](int l, int base, int k) {
    const float* row = sm + lay.gains + (l * tiles + tt) * lay.gstride
                       + (base + 2 * (k & 1)) * P + (k >> 1);
    return make_float2(row[0], row[P]);
  };
  // the block's rows of layer l's saved boundary `b` for this lane's tile
  auto stage_row = [&](const float2* b, int l, long long row) {
    return b + ((static_cast<long long>(l) * batch + row) * tiles + tt) * N;
  };

  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * RW;
    const long long left = batch - row0;
    const int rows = left < RW ? static_cast<int>(left) : RW;
    const bool active = has_tile && r < rows;
    const long long row = row0 + r;
    // the ring: chunks 0 .. stages - 2 (and, once, every layer's gains with
    // chunk 0) in flight before the first sweep, one commit group a chunk
    if (first) {
      mesh_sweep::copy_gains(sm + lay.gains, gains, n_layers, tiles, N,
                             lay.gstride);
    }
    for (int jj = 0; jj < stages - 1; ++jj) {
      if (jj < n_chunks) stage(jj);
      cp_async_commit();
    }
    cp_async_wait(stages - 2);
    __syncthreads();  // the gains landed
    float2 st[N], gt[N];
    int j = 0;  // the chunk to sweep next
    for (int l = n_layers - 1; l >= 0; --l) {
      // 0: the readout's cotangent at the last layer's rows
      if (l == n_layers - 1) {
        if (kDetectLast) {
          if (active) {
            float2 u[N];
            mesh_sweep::load_row(u, stage_row(su, l, row), vec);
#pragma unroll
            for (int k = 0; k < N; ++k) {
              work[(r * tiles + t) * N + k] = cmul(u[k], gain(l, 8, k));
            }
          }
          __syncthreads();
        }
        for (int q = threadIdx.x; q < rows * out_w; q += blockDim.x) {
          const int rr = q / out_w, c = q - rr * out_w;
          const long long at = (row0 + rr) * out_w + c;
          if (kDetectLast) {
            const int oo = c / N, k = c - oo * N;
            const float2* z = work + (rr * tiles + oo * ti) * N + k;
            float2 sum = z[0];
            for (int ii = 1; ii < ti; ++ii) sum = cadd(sum, z[ii * N]);
            gzb[rr * row_w + c] =
                detect_bwd(sum, static_cast<const float*>(gout)[at]);
          } else {
            gzb[rr * row_w + c] = static_cast<const float2*>(gout)[at];
          }
        }
        __syncthreads();
      }
      // layer l's input rows: layer l - 1's combined rows (To == Ti)
      if (l > 0) {
        if (active) {
          mesh_sweep::load_row(gt, stage_row(su, l - 1, row), vec);
#pragma unroll
          for (int k = 0; k < N; ++k) {
            work[(r * tiles + t) * N + k] = cmul(gt[k], gain(l - 1, 8, k));
          }
        }
        __syncthreads();
        for (int q = threadIdx.x; q < rows * in_w; q += blockDim.x) {
          const int rr = q / in_w, c = q - rr * in_w;
          const int oo = c / N, k = c - oo * N;
          const float2* z = work + (rr * tiles + oo * ti) * N + k;
          float2 sum = z[0];
          for (int ii = 1; ii < ti; ++ii) sum = cadd(sum, z[ii * N]);
          rowz[rr * row_w + c] = sum;
        }
        __syncthreads();
      }
      // 1: g2, from the saved post-U boundary (every tile of row o sees gz_o)
      float2 vpre[N <= 16 ? N : 1];  // the post-V boundary, loaded ahead
      if (active) {
        mesh_sweep::load_row(st, stage_row(su, l, row), vec);
        if constexpr (N <= 16) {
          mesh_sweep::load_row(vpre, stage_row(sv, l, row), vec);
        }
#pragma unroll
        for (int k = 0; k < N; ++k) gt[k] = gzb[r * row_w + o * N + k];
      } else {
#pragma unroll
        for (int k = 0; k < N; ++k) st[k] = gt[k] = make_float2(0.f, 0.f);
      }
      sum_gain<N>(st, gt, gsum, 8, lane, has_tile);
#pragma unroll
      for (int k = 0; k < N; ++k) gt[k] = cmulc(gain(l, 8, k), gt[k]);
      // 2-4: U's reversed sweep, g1, V's reversed sweep
      for (int m = 1; m >= 0; --m) {
        for (int q = 0; q < per_mesh; ++q, ++j) {
          const int c_end = n_cols - q * kcap;
          const int c0 = c_end > kcap ? c_end - kcap : 0;
          const int kc = c_end - c0;
          const float* buf = sm + (j % stages) * lay.raw;
          cp_async_wait(stages - 2);
          __syncthreads();  // chunk j landed; chunk j - 1 written out
          if (j + stages - 1 < n_chunks) stage(j + stages - 1);
          cp_async_commit();
          mesh_sweep::stage_marked<P>(
              cells, lay.cts, marks, buf, lay.rts,
              reinterpret_cast<const int*>(buf + tiles * lay.rts), kcap,
              tiles, kc);
          __syncthreads();  // cells and marks staged
          mesh_sweep::reverse_columns<N>(
              st, gt, cells + tt * lay.cts, marks + tt, tiles, 0, kc,
              [&](const float (&d)[8 * G], int k, int g0) {
                store_segment_sum<8 * G, G, P>(
                    d, lane, sums + tt * lay.sstride + k * M + g0, has_tile);
              });
          __syncthreads();  // the chunk's sums written
          float* dm = dst + (m ? n_layers * coef_layer : 0)
                      + static_cast<long long>(l) * coef_layer;
          for (int t2 = 0; t2 < tiles; ++t2) {  // 16-byte words, in order
            const float4* src = reinterpret_cast<const float4*>(
                sums + t2 * lay.sstride);
            float4* d = reinterpret_cast<float4*>(
                dm + (static_cast<long long>(t2) * n_cols + c0) * M);
            for (int f = threadIdx.x; f < kc * M / 4; f += blockDim.x) {
              float4 v = src[f];
              if (!first) {
                const float4 o = d[f];
                v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
              }
              d[f] = v;
            }
          }
        }
        if (m == 1) {  // 3: g1, from the saved post-V boundary
          if (active) {
            if constexpr (N <= 16) {
#pragma unroll
              for (int k = 0; k < N; ++k) st[k] = vpre[k];
            } else {
              mesh_sweep::load_row(st, stage_row(sv, l, row), vec);
            }
          } else {
#pragma unroll
            for (int k = 0; k < N; ++k) st[k] = make_float2(0.f, 0.f);
          }
          sum_gain<N>(st, gt, gsum, 4, lane, has_tile);
#pragma unroll
          for (int k = 0; k < N; ++k) gt[k] = cmulc(gain(l, 4, k), gt[k]);
        }
      }
      // 5: g0, on the layer's input tile
      if (active) {
        if (l == 0) {
          mesh_sweep::load_row(st, x + row * in_w + i * N, vec);
        } else {
#pragma unroll
          for (int k = 0; k < N; ++k) {
            const float2 z = rowz[r * row_w + i * N + k];
            st[k] = make_float2(sqrtf(z.x * z.x + z.y * z.y), 0.f);
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < N; ++k) st[k] = make_float2(0.f, 0.f);
      }
      sum_gain<N>(st, gt, gsum, 0, lane, has_tile);
      // 6: the combine's transpose, then the boundary or dx
      if (active) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
          work[(r * tiles + t) * N + k] = cmulc(gain(l, 0, k), gt[k]);
        }
      }
      __syncthreads();
      float* dg = dst + 2 * n_layers * coef_layer
                  + static_cast<long long>(l) * tiles * 12 * P;
      for (int e = threadIdx.x; e < tiles * 12 * P; e += blockDim.x) {
        dg[e] = first ? gsums[e] : dg[e] + gsums[e];
      }
      for (int q = threadIdx.x; q < rows * in_w; q += blockDim.x) {
        const int rr = q / in_w, c = q - rr * in_w;
        const float2* gq = work + rr * tiles * N + c;  // tile (0, c / N)
        float2 d = gq[0];
        for (int oo = 1; oo < to; ++oo) d = cadd(d, gq[oo * in_w]);
        if (l > 0) {
          gzb[rr * row_w + c] = detect_bwd(rowz[rr * row_w + c], d.x);
        } else {
          dx[(row0 + rr) * in_w + c] = d;
        }
      }
      __syncthreads();
    }
    first = false;
  }
}

// ---------------------------------------------------------------------------
// plan checks and dispatch
// ---------------------------------------------------------------------------

inline int rows_per_tile(int n, int tiles) {
  const int r = kBwdThreads / (tiles * (n / 2));
  return r < 1 ? 1 : (r > kMaxRows ? kMaxRows : r);
}

inline size_t shared_bytes(int n, int to, int ti, int rows) {
  const size_t tn = static_cast<size_t>(to) * ti * n;
  const size_t row_w = static_cast<size_t>(to > ti ? to : ti) * n;
  // st, gt and the terms (4 floats a channel), then gz and zp
  return static_cast<size_t>(rows) * (tn * 2 * sizeof(float2)
                                      + tn * 4 * sizeof(float)
                                      + row_w * 2 * sizeof(float2));
}

inline bool templated(int n) {
  return n == 2 || n == 4 || n == 8 || n == 16 || n == 32;
}

template <typename Kernel>
int allow_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// The register path's kernel for (n, one tile or a grid, readout), or
// null.
using RegKernel = void (*)(const float2*, const float2*, const float2*,
                           const void*, const float*, const int*,
                           const float*, const int*, const float*, float*,
                           float2*, int, int, int, int, int, int, int, int,
                           int);

template <bool kDetectLast>
RegKernel reg_kernel(int n, int tiles) {
#define DEEPGRID_BWD_REG(NN)                                                  \
  case NN:                                                                    \
    return tiles == 1 ? deepgrid_bwd_lane_kernel<NN, kDetectLast>             \
                      : deepgrid_bwd_reg_kernel<NN, kDetectLast>;
  switch (n) {
    DEEPGRID_BWD_REG(2)
    DEEPGRID_BWD_REG(4)
    DEEPGRID_BWD_REG(8)
    DEEPGRID_BWD_REG(16)
    DEEPGRID_BWD_REG(32)
    default: return nullptr;
  }
#undef DEEPGRID_BWD_REG
}

}  // namespace

// Resident blocks an SM of the current device holds of the backward kernel
// on path `reg` (for the register path: width n, one tile or a grid, the
// readout) at `threads` threads and `smem` dynamic shared bytes a block;
// the plan caps its blocks at one wave of them (it is cached per batch,
// grid and card, so this runs once a shape).  Returns -(CUDA error) on
// failure, and -cudaErrorInvalidValue for a kernel that does not exist.
extern "C" int deepgrid_bwd_occupancy(int reg, int n, int tiles,
                                      int detect_last, int threads,
                                      long long smem) {
  const void* kernel;
  if (reg) {
    kernel = reinterpret_cast<const void*>(
        detect_last ? reg_kernel<true>(n, tiles)
                    : reg_kernel<false>(n, tiles));
  } else {
    kernel = reinterpret_cast<const void*>(
        detect_last ? deepgrid_bwd_kernel<true> : deepgrid_bwd_kernel<false>);
  }
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  const size_t sm = static_cast<size_t>(smem);
  if (sm > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sm));
    if (err != cudaSuccess) return -static_cast<int>(err);
  }
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, sm);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

// Plain C entry point (loaded with ctypes).  All pointers are device
// pointers; `stream` is a cudaStream_t.  `gout` is float32 [B, To n] when
// detect_last, else complex64.  The plan (givens_mesh.py:
// deepgrid_bwd_plan) gives the path (`reg`), the rows a block, the threads
// a block, the block count, the staged columns a chunk and the landing
// buffers (register path), and the dynamic shared bytes a block.
// `partial` is float32 scratch of [n_blocks, L To Ti (2 C 8 P + 12 P)],
// unused (may be null) when the register path runs one block, which writes
// `grads` itself; otherwise `grads` receives the block-order sum of the
// slices, [dcv | dcu | dg].  The caller guarantees batch > 0, even n >= 2,
// To == Ti when L > 1 and contiguous tensors.  Returns cudaGetLastError()
// after the launches, or cudaErrorInvalidValue for a plan this kernel
// cannot run.
extern "C" int deepgrid_bwd_launch(const void* x, const void* sv,
                                   const void* su, const void* gout,
                                   const void* coef_v, const void* par_v,
                                   const void* coef_u, const void* par_u,
                                   const void* gains, void* partial,
                                   void* grads, void* dx, int batch, int n,
                                   int n_layers, int to, int ti, int n_cols,
                                   int detect_last, int reg, int rows,
                                   int threads, int n_blocks, int kcap,
                                   int stages, long long smem, void* stream) {
  const int tiles = to * ti;
  const int n_tiles = mesh_sweep::tile_count(batch, rows);
  if (n_blocks < 1 || n_blocks > n_tiles
      || (n_blocks > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);  // a slice left unwritten
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  const auto* xx = static_cast<const float2*>(x);
  const auto* v = static_cast<const float2*>(sv);
  const auto* u = static_cast<const float2*>(su);
  const auto* cv = static_cast<const float*>(coef_v);
  const auto* pv = static_cast<const int*>(par_v);
  const auto* cu = static_cast<const float*>(coef_u);
  const auto* pu = static_cast<const int*>(par_u);
  const auto* gn = static_cast<const float*>(gains);
  auto* dxx = static_cast<float2*>(dx);
  int err = 0;
  if (reg) {
    const int per_mesh = (n_cols + kcap - 1) / kcap;
    // one tile: n / 2 lanes a row, whole warps; a grid: 8 rows a tile
    const bool shape_ok = tiles == 1
        ? threads == rows * (n / 2) && threads % 32 == 0
        : rows == kGridRows && threads == (rows * tiles + 31) / 32 * 32;
    if (!templated(n) || !shape_ok || threads > kRegThreads || kcap < 1
        || kcap > n_cols || stages < 2 || stages > kMaxStages
        || stages > 2 * n_layers * per_mesh
        || sm < reg_shared_bytes(n, n_layers, to, ti, rows, kcap, stages)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const RegKernel kernel = detect_last ? reg_kernel<true>(n, tiles)
                                         : reg_kernel<false>(n, tiles);
    err = allow_shared(kernel, sm);
    if (err != 0) return err;
    kernel<<<n_blocks, threads, sm, s>>>(
        xx, v, u, gout, cv, pv, cu, pu, gn,
        static_cast<float*>(n_blocks == 1 ? grads : partial), dxx, batch,
        n_layers, to, ti, n_cols, rows, kcap, stages, n_tiles);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0 || n_blocks == 1) return err;
  } else {
    if (rows != rows_per_tile(n, tiles) || threads != kBwdThreads
        || sm != shared_bytes(n, to, ti, rows)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    auto* part = static_cast<float*>(partial);
    if (detect_last) {
      err = allow_shared(deepgrid_bwd_kernel<true>, sm);
      if (err == 0) {
        deepgrid_bwd_kernel<true><<<n_blocks, kBwdThreads, sm, s>>>(
            xx, v, u, gout, cv, pv, cu, pu, gn, part, dxx, batch, n,
            n_layers, to, ti, n_cols, rows, n_tiles);
      }
    } else {
      err = allow_shared(deepgrid_bwd_kernel<false>, sm);
      if (err == 0) {
        deepgrid_bwd_kernel<false><<<n_blocks, kBwdThreads, sm, s>>>(
            xx, v, u, gout, cv, pv, cu, pu, gn, part, dxx, batch, n,
            n_layers, to, ti, n_cols, rows, n_tiles);
      }
    }
    if (err != 0) return err;
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  const long long p = n / 2;
  const int total = static_cast<int>(
      static_cast<long long>(n_layers) * tiles * (2 * n_cols * 8 * p + 12 * p));
  mesh_sweep::reduce_partials<<<(total + 31) / 32, dim3(32, 8), 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(grads),
      n_blocks, total);
  return static_cast<int>(cudaGetLastError());
}
