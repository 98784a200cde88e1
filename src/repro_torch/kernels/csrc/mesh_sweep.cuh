// Device code shared by the mesh kernels: the forward column sweep, the
// reversed sweep of the VJP (per-cell inverse, adjoint and coefficient
// gradient terms), the row sums of a tile's gradient terms, their stacked
// siblings for a grid of tiles sweeping together, the block-order reduce of
// per-block gradient slices, and the register sweeps (one thread a row,
// cells staged once a block, a warp's gradient terms summed by shuffles).
//
// Included by mesh_fwd.cu (B1), mesh_bwd.cu (B2), rfnn_fwd.cu (B3, B4),
// rfnn_bwd.cu (B5), deepgrid_fwd.cu (B6, B7) and deepgrid_bwd.cu (B8).
// cuda_build.py hashes every header under csrc/ into each library's file
// name, so an edit here rebuilds all six libraries.
//
// Layouts (see mesh_fwd.cu): a block owns a tile of `rows` batch rows of n
// complex channels, float2[rows][n] in shared memory.  Coefficients are
// float32 [C, 8, P] (t00, t01, t10, t11) x (re, im) per pair slot, P = n / 2;
// parity[c] = 0 pairs (2s, 2s+1), 1 pairs (2s+1, 2s+2) for s < P - 1.
// The shared-memory sweeps read coefficients from global memory through
// __ldg and never stage them: a Reck program has ~2n columns, and all
// columns of an n = 128 mesh would already take 256 KiB, above the 227 KiB
// a block may use.  The register sweeps (last section) stage them, for
// n <= 32.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace mesh_sweep {
namespace {  // internal linkage: each library keeps its own copy

constexpr int kThreads = 128;
constexpr float kDetEps = 1e-12f;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// conj(a) * b
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 cneg(float2 a) {
  return make_float2(-a.x, -a.y);
}

// Rows of a block's tile: 128 threads over (row, pair slot) work items.
inline int rows_per_tile(int n) {
  const int r = kThreads / (n / 2);
  return r < 1 ? 1 : r;
}

// Shared memory of a reversed sweep's block: the state and cotangent tiles
// (float2 [R][n] each) and the gradient terms (float [R][8 P]).
inline size_t reverse_shared_bytes(int n) {
  return static_cast<size_t>(rows_per_tile(n)) * n * 32;
}

inline int tile_count(int batch, int rows) {
  return static_cast<int>((static_cast<long long>(batch) + rows - 1) / rows);
}

// (a, b) <- t (a, b) for the cell in pair slot s of a column's [8, P]
// coefficients `cc`.
__device__ __forceinline__ void rotate_cell(const float* __restrict__ cc,
                                            int p, int s, float2& a,
                                            float2& b) {
  const float t00r = __ldg(cc + 0 * p + s), t00i = __ldg(cc + 1 * p + s);
  const float t01r = __ldg(cc + 2 * p + s), t01i = __ldg(cc + 3 * p + s);
  const float t10r = __ldg(cc + 4 * p + s), t10i = __ldg(cc + 5 * p + s);
  const float t11r = __ldg(cc + 6 * p + s), t11i = __ldg(cc + 7 * p + s);
  float2 a2, b2;
  a2.x = t00r * a.x - t00i * a.y + t01r * b.x - t01i * b.y;
  a2.y = t00r * a.y + t00i * a.x + t01r * b.y + t01i * b.x;
  b2.x = t10r * a.x - t10i * a.y + t11r * b.x - t11i * b.y;
  b2.y = t10r * a.y + t10i * a.x + t11r * b.y + t11i * b.x;
  a = a2;
  b = b2;
}

// Apply columns 0 .. n_cols-1 to the tile in place.  The caller has synced
// after filling the tile; the sweep ends with a barrier.
__device__ void forward_sweep(float2* tile, const float* __restrict__ coef,
                              const int* __restrict__ parity, int n_cols,
                              int rows, int n) {
  const int p = n / 2;
  for (int c = 0; c < n_cols; ++c) {
    const int par = __ldg(parity + c);
    const int slots = par ? p - 1 : p;  // 0 for n = 2, parity 1
    const float* cc = coef + static_cast<long long>(c) * 8 * p;
    const int work = rows * slots;
    for (int i = threadIdx.x; i < work; i += blockDim.x) {
      const int r = i / slots;
      const int s = i - r * slots;
      float2* row = tile + r * n;
      const int top = 2 * s + par;  // top + 1 <= n - 1
      float2 a = row[top];
      float2 b = row[top + 1];
      rotate_cell(cc, p, s, a, b);
      row[top] = a;
      row[top + 1] = b;
    }
    __syncthreads();
  }
}

// dst[j] (+)= sum over the tile's rows, in row order, of terms[r * stride + j]
// for j < entries; entries whose slot (j % p) is at or past `slots` get 0.
// One thread writes each entry: a store on the block's first tile, then
// read-add-store.  No barrier inside.
__device__ void sum_rows(const float* terms, int rows, int stride, int entries,
                         int p, int slots, float* __restrict__ dst,
                         bool first) {
  for (int j = threadIdx.x; j < entries; j += blockDim.x) {
    float sum = 0.f;
    if (j % p < slots) {
      for (int r = 0; r < rows; ++r) sum += terms[r * stride + j];
    }
    dst[j] = first ? sum : dst[j] + sum;
  }
}

// One cell of a reversed column, in place: from the column's output pair
// (s_pair[0], s_pair[1]) and the cotangent at it (g_pair[0], g_pair[1]),
// the cell's analytic inverse adj(t)/det(t) (|det|^2 floored at 1e-12)
// rebuilds the input pair, the four conjugate products conj(input) (x)
// cotangent go to tr[k * p + s] for the rows (00, 01, 10, 11) x (re, im),
// and the adjoint t^H carries the cotangent back.
__device__ __forceinline__ void reverse_cell(const float* __restrict__ cc,
                                             int p, int s, float2* s_pair,
                                             float2* g_pair, float* tr) {
  const float2 t00 = make_float2(__ldg(cc + 0 * p + s), __ldg(cc + 1 * p + s));
  const float2 t01 = make_float2(__ldg(cc + 2 * p + s), __ldg(cc + 3 * p + s));
  const float2 t10 = make_float2(__ldg(cc + 4 * p + s), __ldg(cc + 5 * p + s));
  const float2 t11 = make_float2(__ldg(cc + 6 * p + s), __ldg(cc + 7 * p + s));
  // inverse: adj(t) / det(t), 1 / det = conj(det) / max(|det|^2, eps)
  const float2 det = cadd(cmul(t00, t11), cneg(cmul(t01, t10)));
  const float d2 = fmaxf(det.x * det.x + det.y * det.y, kDetEps);
  const float2 inv_det = make_float2(det.x / d2, -det.y / d2);
  const float2 i00 = cmul(t11, inv_det);
  const float2 i01 = cneg(cmul(t01, inv_det));
  const float2 i10 = cneg(cmul(t10, inv_det));
  const float2 i11 = cmul(t00, inv_det);

  const float2 a = s_pair[0], b = s_pair[1];
  const float2 ga = g_pair[0], gb = g_pair[1];
  const float2 a_in = cadd(cmul(i00, a), cmul(i01, b));
  const float2 b_in = cadd(cmul(i10, a), cmul(i11, b));

  const float2 d00 = cmulc(a_in, ga), d01 = cmulc(b_in, ga);
  const float2 d10 = cmulc(a_in, gb), d11 = cmulc(b_in, gb);
  tr[0 * p + s] = d00.x;
  tr[1 * p + s] = d00.y;
  tr[2 * p + s] = d01.x;
  tr[3 * p + s] = d01.y;
  tr[4 * p + s] = d10.x;
  tr[5 * p + s] = d10.y;
  tr[6 * p + s] = d11.x;
  tr[7 * p + s] = d11.y;

  s_pair[0] = a_in;
  s_pair[1] = b_in;
  g_pair[0] = cadd(cmulc(t00, ga), cmulc(t10, gb));  // (t^H g)_a
  g_pair[1] = cadd(cmulc(t01, ga), cmulc(t11, gb));  // (t^H g)_b
}

// The reversed sweep of columns n_cols-1 .. 0 (the VJP of forward_sweep).
// On entry `st` holds the sweep's output state and `gt` the cotangent at it;
// on exit `st` holds the input state and `gt` the cotangent at the input.
// Per column, reverse_cell on every cell, then the gradient terms are summed
// over rows into part[c, 8, P] (store when `first`, else add).  The wrap slot of a parity-1 column holds no cell: its
// gradient is exactly 0.  `terms` holds float[rows][8 P].  The caller has
// synced after filling st and gt; the sweep ends with a barrier.
__device__ void reverse_sweep(float2* st, float2* gt, float* terms,
                              const float* __restrict__ coef,
                              const int* __restrict__ parity, int n_cols,
                              int rows, int n, float* __restrict__ part,
                              bool first) {
  const int p = n / 2;
  const int m = 8 * p;  // gradient entries per column
  for (int k = 0; k < n_cols; ++k) {
    const int c = n_cols - 1 - k;
    const int par = __ldg(parity + c);
    const int slots = par ? p - 1 : p;  // 0 for n = 2, parity 1
    const float* cc = coef + static_cast<long long>(c) * m;
    const int work = rows * slots;
    for (int i = threadIdx.x; i < work; i += blockDim.x) {
      const int r = i / slots;
      const int s = i - r * slots;
      const int top = r * n + 2 * s + par;  // the pair (top, top + 1)
      reverse_cell(cc, p, s, st + top, gt + top, terms + r * m);
    }
    __syncthreads();
    sum_rows(terms, rows, m, m, p, slots, part + static_cast<long long>(c) * m,
             first);
    __syncthreads();
  }
}

// out[j] = sum over blocks b, in order, of partial[b, j]: threadIdx.x picks
// the entry (coalesced), threadIdx.y a fixed stride of blocks, then the 8
// strided sums are added in order.  Launch with dim3(32, 8) threads and
// ceil(total / 32) blocks.
__global__ void reduce_partials(const float* __restrict__ partial,
                                float* __restrict__ out, int n_blocks,
                                int total) {
  __shared__ float red[8][32];
  const int j = blockIdx.x * 32 + threadIdx.x;
  float sum = 0.f;
  if (j < total) {
    for (int b = threadIdx.y; b < n_blocks; b += 8) {
      sum += partial[static_cast<long long>(b) * total + j];
    }
  }
  red[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && j < total) {
    float s = red[0][threadIdx.x];
    for (int q = 1; q < 8; ++q) s += red[q][threadIdx.x];
    out[j] = s;
  }
}

// ---------------------------------------------------------------------------
// stacked sweeps: `tiles` meshes of one layer of a tile grid at once
// ---------------------------------------------------------------------------
//
// Row r's tile t is work[(r * tiles + t) * n ...]; tile t's coefficients are
// coef[t][n_cols][8][P] and its parities parity[t][n_cols], so every tile
// reads its own pairing and a column where tiles disagree (a Reck tile beside
// a Clements one) needs no masked path.  Threads map over (row, tile, pair
// slot); the wrap slot of a parity-1 tile's column holds no cell and is
// skipped.  One barrier per column for all tiles.

// A deep grid layer's gain `base` (0 g0, 4 g1, 8 g2) of tile t at channel
// k, from its float32 [tiles][12][P] gains (even re, even im, odd re, odd im
// per gain).
__device__ __forceinline__ float2 gain_at(const float* __restrict__ g, int t,
                                          int base, int k, int p) {
  const int s = k >> 1, o = k & 1;
  const float* row = g + (t * 12 + base + 2 * o) * p + s;
  return make_float2(__ldg(row), __ldg(row + p));
}

__device__ void grid_forward_sweep(float2* work, const float* __restrict__ coef,
                                   const int* __restrict__ parity, int n_cols,
                                   int rows, int tiles, int n) {
  const int p = n / 2;
  const int items = rows * tiles * p;
  for (int c = 0; c < n_cols; ++c) {
    for (int i = threadIdx.x; i < items; i += blockDim.x) {
      const int rt = i / p;  // r * tiles + t
      const int s = i - rt * p;
      const int t = rt % tiles;
      const int par = __ldg(parity + t * n_cols + c);
      if (par && s == p - 1) continue;
      float2* row = work + rt * n;
      const int top = 2 * s + par;
      float2 a = row[top];
      float2 b = row[top + 1];
      rotate_cell(coef + (static_cast<long long>(t) * n_cols + c) * 8 * p, p,
                  s, a, b);
      row[top] = a;
      row[top + 1] = b;
    }
    __syncthreads();
  }
}

// dst[t * dst_stride + j] (+)= sum over the block's rows, in row order, of
// terms[(r * tiles + t) * src_stride + j], for t < tiles and j < entries.
// With `wrap` (a column's parities, tile t's at wrap[t * wrap_stride]), the
// wrap slot (j % p == p - 1) of a parity-1 tile gets exactly 0.  One thread
// writes each entry: a store when `first`, else read-add-store.  No barrier.
__device__ void grid_sum_rows(const float* terms, int rows, int tiles,
                              int src_stride, int entries,
                              float* __restrict__ dst, long long dst_stride,
                              bool first, const int* __restrict__ wrap,
                              int wrap_stride, int p) {
  const int total = tiles * entries;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int t = i / entries;
    const int j = i - t * entries;
    float sum = 0.f;
    if (!(wrap != nullptr && __ldg(wrap + t * wrap_stride) && j % p == p - 1)) {
      for (int r = 0; r < rows; ++r) {
        sum += terms[(r * tiles + t) * src_stride + j];
      }
    }
    float* d = dst + t * dst_stride + j;
    *d = first ? sum : *d + sum;
  }
}

// The stacked reversed sweep (the VJP of grid_forward_sweep): reverse_cell
// on every cell of every tile, column by column from the last, each column's
// terms (float[rows][tiles][8 P]) summed over rows into
// part[t][n_cols][8][P].  The caller has synced after filling st and gt; the
// sweep ends with a barrier.
__device__ void grid_reverse_sweep(float2* st, float2* gt, float* terms,
                                   const float* __restrict__ coef,
                                   const int* __restrict__ parity, int n_cols,
                                   int rows, int tiles, int n,
                                   float* __restrict__ part, bool first) {
  const int p = n / 2;
  const int m = 8 * p;
  const int items = rows * tiles * p;
  for (int k = 0; k < n_cols; ++k) {
    const int c = n_cols - 1 - k;
    for (int i = threadIdx.x; i < items; i += blockDim.x) {
      const int rt = i / p;
      const int s = i - rt * p;
      const int t = rt % tiles;
      const int par = __ldg(parity + t * n_cols + c);
      if (par && s == p - 1) continue;
      const int top = rt * n + 2 * s + par;
      reverse_cell(coef + (static_cast<long long>(t) * n_cols + c) * m, p, s,
                   st + top, gt + top, terms + rt * m);
    }
    __syncthreads();
    grid_sum_rows(terms, rows, tiles, m, m, part + static_cast<long long>(c) * m,
                  static_cast<long long>(n_cols) * m, first, parity + c,
                  n_cols, p);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// register sweeps: one thread a row, the row's n channels in registers
// ---------------------------------------------------------------------------
//
// For n in {2, 4, 8, 16, 32} (mesh_fwd.cu B1, mesh_bwd.cu B2).  A block
// stages the mesh's cells once in shared memory, cell-major: cell (c, s) is
// cells[(c P + s) W ...], W float4 — t as (t00, t01) and (t10, t11) and,
// for the VJP, its inverse adj(t) / det(t) likewise — so a warp reads a cell
// as broadcasts, and no barrier falls between columns.

constexpr int kRegRowsMax = 256;  // rows (threads) of a register-path block

// (a, b) <- t (a, b) for a cell's coefficients c[0..7] = (t00, t01, t10,
// t11) x (re, im) held in registers: rotate_cell's expressions.
__device__ __forceinline__ void rotate_regs(const float (&c)[8], float2& a,
                                            float2& b) {
  float2 a2, b2;
  a2.x = c[0] * a.x - c[1] * a.y + c[2] * b.x - c[3] * b.y;
  a2.y = c[0] * a.y + c[1] * a.x + c[2] * b.y + c[3] * b.x;
  b2.x = c[4] * a.x - c[5] * a.y + c[6] * b.x - c[7] * b.y;
  b2.y = c[4] * a.y + c[5] * a.x + c[6] * b.y + c[7] * b.x;
  a = a2;
  b = b2;
}

// inv = adj(t) / det(t) of a cell t = c[0..7] (|det|^2 floored at kDetEps):
// reverse_cell's expressions.
__device__ __forceinline__ void inverse_regs(const float (&c)[8],
                                             float (&inv)[8]) {
  const float2 t00 = make_float2(c[0], c[1]), t01 = make_float2(c[2], c[3]);
  const float2 t10 = make_float2(c[4], c[5]), t11 = make_float2(c[6], c[7]);
  const float2 det = cadd(cmul(t00, t11), cneg(cmul(t01, t10)));
  const float d2 = fmaxf(det.x * det.x + det.y * det.y, kDetEps);
  const float2 inv_det = make_float2(det.x / d2, -det.y / d2);
  const float2 i00 = cmul(t11, inv_det);
  const float2 i01 = cneg(cmul(t01, inv_det));
  const float2 i10 = cneg(cmul(t10, inv_det));
  const float2 i11 = cmul(t00, inv_det);
  inv[0] = i00.x; inv[1] = i00.y; inv[2] = i01.x; inv[3] = i01.y;
  inv[4] = i10.x; inv[5] = i10.y; inv[6] = i11.x; inv[7] = i11.y;
}

// One cell of a reversed column on registers, reverse_cell's expressions
// with the cell t and its inverse given: (a, b) from the column's output to
// its input, (ga, gb) from the cotangent at the output to the one at the
// input, and the four conjugate products into d[0..7] in coef's row order.
__device__ __forceinline__ void reverse_regs(const float (&t)[8],
                                             const float (&inv)[8], float2& a,
                                             float2& b, float2& ga, float2& gb,
                                             float (&d)[8]) {
  const float2 i00 = make_float2(inv[0], inv[1]);
  const float2 i01 = make_float2(inv[2], inv[3]);
  const float2 i10 = make_float2(inv[4], inv[5]);
  const float2 i11 = make_float2(inv[6], inv[7]);
  const float2 a_in = cadd(cmul(i00, a), cmul(i01, b));
  const float2 b_in = cadd(cmul(i10, a), cmul(i11, b));
  const float2 d00 = cmulc(a_in, ga), d01 = cmulc(b_in, ga);
  const float2 d10 = cmulc(a_in, gb), d11 = cmulc(b_in, gb);
  d[0] = d00.x; d[1] = d00.y; d[2] = d01.x; d[3] = d01.y;
  d[4] = d10.x; d[5] = d10.y; d[6] = d11.x; d[7] = d11.y;
  const float2 t00 = make_float2(t[0], t[1]), t01 = make_float2(t[2], t[3]);
  const float2 t10 = make_float2(t[4], t[5]), t11 = make_float2(t[6], t[7]);
  a = a_in;
  b = b_in;
  const float2 ga_in = cadd(cmulc(t00, ga), cmulc(t10, gb));  // (t^H g)_a
  gb = cadd(cmulc(t01, ga), cmulc(t11, gb));                  // (t^H g)_b
  ga = ga_in;
}

// Shared bytes of the staged cells: W float4 a cell, then the C parities
// (int32, padded to 16 bytes).
inline size_t staged_cell_bytes(int n, int n_cols, int w) {
  return static_cast<size_t>(n_cols) * (n / 2) * w * 16
         + static_cast<size_t>((n_cols + 3) & ~3) * 4;
}

// Stage the mesh's C columns cell-major into `cells` (kInverse: W = 4,
// else 2) and its parities after them.  No barrier.
template <bool kInverse>
__device__ void stage_cells(float4* cells, const float* __restrict__ coef,
                            const int* __restrict__ parity, int n_cols,
                            int p) {
  constexpr int W = kInverse ? 4 : 2;
  for (int i = threadIdx.x; i < n_cols * p; i += blockDim.x) {
    const int c = i / p, s = i - c * p;
    const float* cc = coef + static_cast<long long>(c) * 8 * p + s;
    float t[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) t[q] = __ldg(cc + q * p);
    cells[i * W] = make_float4(t[0], t[1], t[2], t[3]);
    cells[i * W + 1] = make_float4(t[4], t[5], t[6], t[7]);
    if constexpr (kInverse) {
      float v[8];
      inverse_regs(t, v);
      cells[i * W + 2] = make_float4(v[0], v[1], v[2], v[3]);
      cells[i * W + 3] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
  int* spar = reinterpret_cast<int*>(cells + n_cols * p * W);
  for (int c = threadIdx.x; c < n_cols; c += blockDim.x) {
    spar[c] = __ldg(parity + c);
  }
}

__device__ __forceinline__ void load_cell(const float4* w, float (&c)[8]) {
  const float4 lo = w[0], hi = w[1];
  c[0] = lo.x; c[1] = lo.y; c[2] = lo.z; c[3] = lo.w;
  c[4] = hi.x; c[5] = hi.y; c[6] = hi.z; c[7] = hi.w;
}

// Column `cc` (its P staged cells, W = 2) on a row's registers.  The wrap
// slot of a parity-1 column holds no cell; at n = 2 that leaves none.
template <int N, int kPar>
__device__ __forceinline__ void rotate_column(float2 (&st)[N],
                                              const float4* cc) {
  constexpr int P = N / 2;
#pragma unroll
  for (int s = 0; s < (kPar ? P - 1 : P); ++s) {
    float c[8];
    load_cell(cc + 2 * s, c);
    rotate_regs(c, st[2 * s + kPar], st[2 * s + kPar + 1]);
  }
}

// The sums over a segment of S = 2 O aligned lanes (a warp at O = 16) of
// each of the K values v[] (K a power of two), by a butterfly that halves
// what a lane carries at each level: at offset O a lane keeps the half of
// its values that its lane bit O selects and adds the partner's copy of
// that half.  After the levels from O down to 1, with K >= S, lane l holds
// in out[j] the value (l mod S) (K / S) + j summed over its segment (KO =
// K / S); with K < S, out[0] is value (l mod S) / (S / K) (KO = 1; the
// S / K lanes that share it hold the same bits: a + b == b + a).  The
// order of the adds is fixed by the lane numbers alone.
template <int K, int O, int KO>
__device__ __forceinline__ void scatter_sum(const float (&v)[K], int lane,
                                            float (&out)[KO]) {
  if constexpr (O == 0) {
    static_assert(K == KO, "KO values a lane at the end");
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = v[k];
  } else if constexpr (K == 1) {
    const float w[1] = {v[0] + __shfl_xor_sync(0xffffffffu, v[0], O)};
    scatter_sum<1, O / 2, KO>(w, lane, out);
  } else {
    constexpr int H = K / 2;
    const bool upper = (lane & O) != 0;
    float w[H];
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const float send = upper ? v[k] : v[H + k];
      const float keep = upper ? v[H + k] : v[k];
      w[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    scatter_sum<H, O / 2, KO>(w, lane, out);
  }
}

// The sum over a warp's 32 lanes of each of the K <= 32 values v[]: lane l
// holds value l / (32 / K) (scatter_sum over the whole warp).
template <int K, int O>
__device__ __forceinline__ float warp_scatter_sum(const float (&v)[K],
                                                  int lane) {
  float out[1];
  scatter_sum<K, O, 1>(v, lane, out);
  return out[0];
}

// Group g0 / G of column `cc` (its P staged cells and inverses, W = 4)
// reversed on a row's registers: the G = min(P, 4) cells from slot g0, and
// their gradient terms into d, value q G + u for row q of slot g0 + u.  The
// wrap slot of a parity-1 column holds no cell: its terms are exactly 0.
template <int N, int kPar>
__device__ __forceinline__ void reverse_group(float2 (&st)[N],
                                              float2 (&gt)[N],
                                              const float4* cc, int g0,
                                              float (&d)[8 * (N < 8 ? N / 2
                                                              : 4)]) {
  constexpr int P = N / 2;
  constexpr int G = P < 4 ? P : 4;
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const int s = g0 + u;
    if (kPar == 0 || s < P - 1) {
      float t[8], inv[8], dd[8];
      load_cell(cc + 4 * s, t);
      load_cell(cc + 4 * s + 2, inv);
      reverse_regs(t, inv, st[2 * s + kPar], st[2 * s + kPar + 1],
                   gt[2 * s + kPar], gt[2 * s + kPar + 1], dd);
#pragma unroll
      for (int q = 0; q < 8; ++q) d[q * G + u] = dd[q];
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) d[q * G + u] = 0.f;
    }
  }
}

// A group's V terms summed over the warp's rows (warp_scatter_sum: 31
// shuffles at V = 32) into the warp's accumulator `acc` (the group's V
// floats), stored when `first`, else added, each entry by one lane.
template <int V>
__device__ __forceinline__ void add_terms(const float (&d)[V], float* acc,
                                          int lane, bool first) {
  constexpr int kShare = 32 / V;  // lanes that hold each summed term
  const float sum = warp_scatter_sum<V, 16>(d, lane);
  if ((lane & (kShare - 1)) == 0) {
    float* a = acc + lane / kShare;
    *a = first ? sum : *a + sum;
  }
}

// Column `cc` reversed on a row's registers, group by group, each group's
// terms summed over the warp into `acc` (the column's 8 P floats).
template <int N, int kPar>
__device__ __forceinline__ void reverse_column(float2 (&st)[N],
                                               float2 (&gt)[N],
                                               const float4* cc, float* acc,
                                               int lane, bool first) {
  constexpr int P = N / 2;
  constexpr int G = P < 4 ? P : 4;
#pragma unroll
  for (int g0 = 0; g0 < P; g0 += G) {
    float d[8 * G];
    reverse_group<N, kPar>(st, gt, cc, g0, d);
    add_terms(d, acc + 8 * g0, lane, first);
  }
}

// A row's N channels between global memory and registers, as N / 2
// 16-byte words where `vec` (both pointers 16-byte aligned), else N 8-byte
// ones.
template <int N>
__device__ __forceinline__ void load_row(float2 (&r)[N],
                                         const float2* __restrict__ src,
                                         bool vec) {
  if (vec) {
    const float4* s = reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      const float4 w = s[k];
      r[2 * k] = make_float2(w.x, w.y);
      r[2 * k + 1] = make_float2(w.z, w.w);
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) r[k] = src[k];
  }
}

template <int N>
__device__ __forceinline__ void store_row(float2* __restrict__ dst,
                                          const float2 (&r)[N], bool vec) {
  if (vec) {
    float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      d[k] = make_float4(r[2 * k].x, r[2 * k].y, r[2 * k + 1].x,
                         r[2 * k + 1].y);
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) dst[k] = r[k];
  }
}

// ---------------------------------------------------------------------------
// staged sweeps with identity marks (rfnn_bwd.cu B5, deepgrid_bwd.cu B8)
// ---------------------------------------------------------------------------
//
// A mesh's cells are staged cell-major with their inverses (W = 4, as
// stage_cells<true>), each inverse computed once a block, and each column
// gets a mark word: bit s for a slot holding a cell that is not the
// identity, kParityBit for parity 1.  The reversed sweep skips the inverse
// and adjoint of a run of slots that holds no such cell (they give the pair
// back), but every slot's gradient terms are summed: an identity cell's
// coefficients have a gradient like any other's.

constexpr unsigned kParityBit = 0x80000000u;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` (0..6) of this thread's newest cp.async
// groups are still in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

// Copy columns [c0, c0 + kc) of one layer's [tiles][C][8][P] coefficients
// (`coef` and `par` at that layer) into shared memory: tile t's kc columns
// in their global order at dst + t * tstride floats (16-byte cp.async where
// coef is 16-byte aligned, 4-byte otherwise), their parities at
// pdst[t * kcap + k].  No commit.
__device__ __forceinline__ void copy_chunk(float* dst, int tstride, int* pdst,
                                           int kcap,
                                           const float* __restrict__ coef,
                                           const int* __restrict__ par,
                                           int tiles, int n_cols, int c0,
                                           int kc, int n) {
  const int col = 4 * n;                 // floats a column: 8 P
  const int per_tile = kc * n;           // 16-byte words a tile
  const float* src0 = coef + static_cast<long long>(c0) * col;
  const bool aligned = (reinterpret_cast<uintptr_t>(coef) & 15) == 0;
  int t = threadIdx.x / per_tile, f = threadIdx.x % per_tile;
  const int dt = blockDim.x / per_tile, df = blockDim.x % per_tile;
  for (int w = threadIdx.x; w < tiles * per_tile; w += blockDim.x) {
    const float* src = src0 + static_cast<long long>(t) * n_cols * col + 4 * f;
    float* d = dst + t * tstride + 4 * f;
    if (aligned) {
      cp_async16(d, src);
    } else {
      for (int u = 0; u < 4; ++u) cp_async4(d + u, src + u);
    }
    t += dt;
    f += df;
    if (f >= per_tile) {
      f -= per_tile;
      ++t;
    }
  }
  const int* psrc = par + c0;
  for (int w = threadIdx.x; w < tiles * kc; w += blockDim.x) {
    const int tt = w / kc, k = w - tt * kc;
    cp_async4(pdst + tt * kcap + k,
              psrc + static_cast<long long>(tt) * n_cols + k);
  }
}

// Stage every layer's gains, tile t of layer l at gbuf + (l tiles + t)
// gstride (its 12 P floats).  No commit.
__device__ __forceinline__ void copy_gains(float* gbuf,
                                           const float* __restrict__ gains,
                                           int n_layers, int tiles, int n,
                                           int gstride) {
  const int per_tile = 3 * n / 2;        // 16-byte words a tile: 12 P floats
  const bool aligned = (reinterpret_cast<uintptr_t>(gains) & 15) == 0;
  for (int w = threadIdx.x; w < n_layers * tiles * per_tile;
       w += blockDim.x) {
    const int lt = w / per_tile, f = w - lt * per_tile;  // lt = l tiles + t
    const float* src = gains + static_cast<long long>(lt) * 6 * n + 4 * f;
    float* dst = gbuf + lt * gstride + 4 * f;
    if (aligned) {
      cp_async16(dst, src);
    } else {
      for (int u = 0; u < 4; ++u) cp_async4(dst + u, src + u);
    }
  }
}

// Stage kc columns of `tiles` meshes cell-major: cell (t, k, s) at
// cells + t * cts + 4 (k P + s) as t (two float4) then its inverse
// adj(t) / det(t) (two float4), from tile t's column k at raw + t * rts +
// 8 P k (rows of P floats) and its parity at par[t * pts + k]; the column's
// mark word into marks[k * tiles + t].  The test for the identity
// [1,0,0,0,0,0,1,0] is on the bits (a -0 is not the identity).  One lane a
// slot, a column's P slots in adjacent lanes, so one ballot gathers a
// column's bits; every lane of a warp runs the loop.  No barrier.
template <int P>
__device__ void stage_marked(float4* cells, int cts, unsigned* marks,
                             const float* raw, int rts, const int* par,
                             int pts, int tiles, int kc) {
  constexpr unsigned kOne = 0x3f800000u;  // 1.0f
  const int total = tiles * kc * P;
  const int lane = threadIdx.x & 31;
  for (int e0 = threadIdx.x - lane; e0 < total; e0 += blockDim.x) {
    const int e = e0 + lane;
    bool real = false;
    int k = 0, t = 0, parity = 0;
    if (e < total) {
      const int s = e % P, kt = e / P;
      t = kt % tiles;
      k = kt / tiles;
      const float* cc = raw + t * rts + 8 * P * k + s;
      float c[8], v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) c[q] = cc[q * P];
      parity = par[t * pts + k];
      inverse_regs(c, v);
      float4* w = cells + t * cts + 4 * (k * P + s);
      w[0] = make_float4(c[0], c[1], c[2], c[3]);
      w[1] = make_float4(c[4], c[5], c[6], c[7]);
      w[2] = make_float4(v[0], v[1], v[2], v[3]);
      w[3] = make_float4(v[4], v[5], v[6], v[7]);
      unsigned diff = 0u;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        diff |= __float_as_uint(c[q]) ^ ((q == 0 || q == 6) ? kOne : 0u);
      }
      real = diff != 0u && !(parity && s == P - 1);
    }
    const unsigned bits = __ballot_sync(0xffffffffu, real);
    if (e < total && (lane & (P - 1)) == 0) {  // slot 0 of its column
      marks[k * tiles + t] = ((bits >> lane) & ((1u << P) - 1u))
                             | (parity ? kParityBit : 0u);
    }
  }
}

// A group's gradient terms from the pairs as they stand, for a run of
// identity cells (reverse_group's terms; state and cotangent unchanged).
template <int N, int kPar>
__device__ __forceinline__ void terms_group(const float2 (&st)[N],
                                            const float2 (&gt)[N], int g0,
                                            float (&d)[8 * (N < 8 ? N / 2
                                                            : 4)]) {
  constexpr int P = N / 2;
  constexpr int G = P < 4 ? P : 4;
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const int s = g0 + u;
    if (kPar == 0 || s < P - 1) {
      const float2 a = st[2 * s + kPar], b = st[2 * s + kPar + 1];
      const float2 ga = gt[2 * s + kPar], gb = gt[2 * s + kPar + 1];
      const float2 d00 = cmulc(a, ga), d01 = cmulc(b, ga);
      const float2 d10 = cmulc(a, gb), d11 = cmulc(b, gb);
      d[0 * G + u] = d00.x; d[1 * G + u] = d00.y;
      d[2 * G + u] = d01.x; d[3 * G + u] = d01.y;
      d[4 * G + u] = d10.x; d[5 * G + u] = d10.y;
      d[6 * G + u] = d11.x; d[7 * G + u] = d11.y;
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) d[q * G + u] = 0.f;
    }
  }
}

// Group g0 of a column with mark word w reversed at a lane into d
// (reverse_group, or terms_group where no lane of the warp has a live cell
// in the group), then after() in the same branch, so that work handed to
// it (a sink's shuffles) can overlap the group's arithmetic.  The branch
// is the warp's: lanes whose tiles disagree on the parity (a mixed grid)
// take the plain reversal.  Every lane of the warp calls it.
template <int N, class After>
__device__ __forceinline__ void reverse_marked(float2 (&st)[N],
                                               float2 (&gt)[N],
                                               const float4* cc, unsigned w,
                                               int g0,
                                               float (&d)[8 * (N < 8 ? N / 2
                                                               : 4)],
                                               After&& after) {
  constexpr int P = N / 2;
  constexpr int G = P < 4 ? P : 4;
  const bool par = (w & kParityBit) != 0u;
  const bool live = __any_sync(0xffffffffu,
                               ((w >> g0) & ((1u << G) - 1u)) != 0u);
  if (__all_sync(0xffffffffu, par)) {
    if (live) {
      reverse_group<N, 1>(st, gt, cc, g0, d);
    } else {
      terms_group<N, 1>(st, gt, g0, d);
    }
    after();
  } else if (!__any_sync(0xffffffffu, par)) {
    if (live) {
      reverse_group<N, 0>(st, gt, cc, g0, d);
    } else {
      terms_group<N, 0>(st, gt, g0, d);
    }
    after();
  } else {
    if (par) {
      reverse_group<N, 1>(st, gt, cc, g0, d);
    } else {
      reverse_group<N, 0>(st, gt, cc, g0, d);
    }
    after();
  }
}

// Columns k_end - 1 down to k_begin of a staged mesh (column k's cells and
// inverses at cells + 4 P k, its mark word at marks[k * mstride]) reversed
// on a row's registers, group by group, each group's terms handed to
// sink(d, k, g0).  For P <= 4 (one group a column) a column's sink runs
// while the next column is reversed.  Every lane of the warp runs it.
template <int N, class Sink>
__device__ __forceinline__ void reverse_columns(float2 (&st)[N],
                                                float2 (&gt)[N],
                                                const float4* cells,
                                                const unsigned* marks,
                                                int mstride, int k_begin,
                                                int k_end, Sink&& sink) {
  constexpr int P = N / 2;
  constexpr int G = P < 4 ? P : 4;
  constexpr int V = 8 * G;
  if (k_end <= k_begin) return;
  if constexpr (P <= 4) {
    float prev[V];
    int k = k_end - 1;
    reverse_marked<N>(st, gt, cells + 4 * P * k, marks[k * mstride], 0, prev,
                      [] {});
    for (; k > k_begin; --k) {
      float cur[V];
      reverse_marked<N>(st, gt, cells + 4 * P * (k - 1),
                        marks[(k - 1) * mstride], 0, cur,
                        [&] { sink(prev, k, 0); });
#pragma unroll
      for (int v = 0; v < V; ++v) prev[v] = cur[v];
    }
    sink(prev, k_begin, 0);
  } else {
    for (int k = k_end - 1; k >= k_begin; --k) {
      const unsigned w = marks[k * mstride];
#pragma unroll
      for (int g0 = 0; g0 < P; g0 += G) {
        float d[V];
        reverse_marked<N>(st, gt, cells + 4 * P * k, w, g0, d,
                          [&] { sink(d, k, g0); });
      }
    }
  }
}

// conj(a_k) b_k of the channels of slots g0 .. g0 + GG - 1 into d in a
// gain's row order: value q GG + u is row q (even re, even im, odd re, odd
// im) of slot g0 + u.
template <int N, int GG>
__device__ __forceinline__ void gain_group(const float2 (&a)[N],
                                           const float2 (&b)[N], int g0,
                                           float (&d)[4 * GG]) {
#pragma unroll
  for (int u = 0; u < GG; ++u) {
    const int s = g0 + u;
    const float2 e = cmulc(a[2 * s], b[2 * s]);
    const float2 o = cmulc(a[2 * s + 1], b[2 * s + 1]);
    d[0 * GG + u] = e.x;
    d[1 * GG + u] = e.y;
    d[2 * GG + u] = o.x;
    d[3 * GG + u] = o.y;
  }
}

// dst[e] (first: =, else +=) the sum over rows r < rows, in row order, of
// src[r * stride + e], for e < total; a thread carries four entries at once
// (their rows' loads in flight together).
__device__ __forceinline__ void flush_rows(const float* src, int stride,
                                           int rows, int total,
                                           float* __restrict__ dst,
                                           bool first) {
  constexpr int kE = 4;
  for (int e0 = threadIdx.x; e0 < total; e0 += kE * blockDim.x) {
    float v[kE];
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int e = e0 + j * blockDim.x;
      v[j] = e < total ? src[e] : 0.f;
    }
    for (int r = 1; r < rows; ++r) {
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        const int e = e0 + j * blockDim.x;
        if (e < total) v[j] += src[r * stride + e];
      }
    }
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int e = e0 + j * blockDim.x;
      if (e < total) dst[e] = first ? v[j] : dst[e] + v[j];
    }
  }
}

// The two channels (2 j, 2 j + 1) of a row at p (16-byte aligned where
// `vec`).
__device__ __forceinline__ void load_pair(float2& a, float2& b,
                                          const float2* p, bool vec) {
  if (vec) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    a = make_float2(w.x, w.y);
    b = make_float2(w.z, w.w);
  } else {
    a = p[0];
    b = p[1];
  }
}

// ... and back to memory.
__device__ __forceinline__ void store_pair(float2* p, float2 a, float2 b,
                                           bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(a.x, a.y, b.x, b.y);
  } else {
    p[0] = a;
    p[1] = b;
  }
}


// Column `cc` (its P cells and inverses, W = 4; mark word w) reversed at
// lane j of a row spread over P = N / 2 lanes, lane j holding channels 2 j
// and 2 j + 1 (state s0, s1; cotangent g0, g1): a parity-0 column's cell j
// is the lane's own pair; a parity-1 column's cell j pairs the lane's odd
// channel with lane j + 1's even one, which a shuffle brings and takes
// back (lane P - 1 holds the wrap slot: no cell, terms 0).  d gets the
// cell's terms in coef's row order.  A column that holds no live cell
// skips the inverse and adjoint (its identity cells give the pairs back).
// Every lane of the warp runs it, with the same w.
template <int N>
__device__ __forceinline__ void lane_column(float2& s0, float2& s1,
                                            float2& g0, float2& g1,
                                            const float4* cc, unsigned w,
                                            int j, float (&d)[8]) {
  constexpr int P = N / 2;
  const bool live = (w & ((1u << P) - 1u)) != 0u;
  auto terms = [&](float2 a, float2 b, float2 ga, float2 gb) {
    const float2 d00 = cmulc(a, ga), d01 = cmulc(b, ga);
    const float2 d10 = cmulc(a, gb), d11 = cmulc(b, gb);
    d[0] = d00.x; d[1] = d00.y; d[2] = d01.x; d[3] = d01.y;
    d[4] = d10.x; d[5] = d10.y; d[6] = d11.x; d[7] = d11.y;
  };
  if (!(w & kParityBit)) {
    if (live) {
      float t[8], inv[8];
      load_cell(cc + 4 * j, t);
      load_cell(cc + 4 * j + 2, inv);
      reverse_regs(t, inv, s0, s1, g0, g1, d);
    } else {
      terms(s0, s1, g0, g1);
    }
    return;
  }
  float2 b, gb;  // lane j + 1's even channel
  b.x = __shfl_down_sync(0xffffffffu, s0.x, 1);
  b.y = __shfl_down_sync(0xffffffffu, s0.y, 1);
  gb.x = __shfl_down_sync(0xffffffffu, g0.x, 1);
  gb.y = __shfl_down_sync(0xffffffffu, g0.y, 1);
  const bool cell = j < P - 1;
  if (cell && live) {
    float t[8], inv[8];
    load_cell(cc + 4 * j, t);
    load_cell(cc + 4 * j + 2, inv);
    reverse_regs(t, inv, s1, b, g1, gb, d);
  } else if (cell) {
    terms(s1, b, g1, gb);
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u) d[u] = 0.f;
  }
  b.x = __shfl_up_sync(0xffffffffu, b.x, 1);
  b.y = __shfl_up_sync(0xffffffffu, b.y, 1);
  gb.x = __shfl_up_sync(0xffffffffu, gb.x, 1);
  gb.y = __shfl_up_sync(0xffffffffu, gb.y, 1);
  if (j > 0) {
    s0 = b;
    g0 = gb;
  }
}

// The |.| backward: the real cotangent g of |z| carried to z, 0 at |z| = 0.
__device__ __forceinline__ float2 detect_bwd(float2 z, float g) {
  const float mag = sqrtf(z.x * z.x + z.y * z.y);
  const float w = mag > 0.f ? g / mag : 0.f;
  return make_float2(w * z.x, w * z.y);
}

}  // namespace
}  // namespace mesh_sweep
