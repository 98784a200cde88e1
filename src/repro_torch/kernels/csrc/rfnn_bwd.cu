// Backward (VJP) of the fused analog linear layer, B5: replaces the JAX
// package's Pallas TPU kernel repro/kernels/givens_mesh.py:
// rfnn_linear_bwd_kernel (via rfnn_linear_bwd_pallas_call).
//
// Forward (rfnn_fwd.cu): v = V x, u = U (g1 * v), out = |g2 * u|.  Given the
// saved stage boundaries v and u (complex64 [B, n], both before their gain)
// and the cotangent gout = dL/d out (float32 [B, n]), this computes
//
//   dcv [Cv, 8, P], dcu [Cu, 8, P]   the coefficient gradients (as B2)
//   dg [8, P]                        the real-plane gains gradient, rows
//                                    0-3 g1, 4-7 g2 (even re, even im,
//                                    odd re, odd im)
//   dx                               dL/dRe x + i dL/dIm x, complex64 [B, n]
//
// Per row:
//   1. the |.| backward: gz = gout * z / |z| with z = g2 * u, and exactly 0
//      where |z| = 0 (as the JAX kernel: no NaN from a zero input row);
//   2. g2: dg rows 4-7 += conj(u) gz; the cotangent at u is conj(g2) gz;
//   3. U's reversed sweep from the saved post-U boundary u (the per-cell
//      inverse and adjoint as in B2), which leaves the cotangent gh at U's
//      input;
//   4. g1: dg rows 0-3 += conj(v) gh; the cotangent at v is conj(g1) gh;
//   5. V's reversed sweep from the saved post-V boundary v, leaving dx.
// V's sweep starts from its own saved boundary, never from U's input divided
// by g1: a programmed rank-deficient matrix has exact zeros in g1.
//
// Two paths, chosen by the caller's plan (givens_mesh.rfnn_bwd_plan: by n,
// B and, through shared memory, Cv and Cu; an error, never a fallback):
//
// Register path, n in {2, 4, 8, 16, 32} (rfnn_bwd_reg_kernel<n>): one
// thread a row keeps the row's state and cotangent in registers, reads v, u
// and gout and writes dx as 16-byte words where they are 16-byte aligned,
// and does the |.| backward and both gains there.  The block stages V's and
// U's cells with their inverses once (mesh_sweep.cuh: stage_marked, each
// inverse computed once a block) and marks each column's identity runs;
// the sweeps skip those runs' inverse and adjoint (a Reck program at n = 8
// holds 28 cells in its 13 x 4 slots) but sum every slot's terms.  Each
// group of a column's terms, and of a gain's, is summed over the warp's 32
// rows by shuffles (warp_scatter_sum) into the warp's accumulator in
// shared memory (add_terms; for n <= 8 behind the next column's cells,
// mesh_sweep.cuh: reverse_columns).  No barrier falls inside the sweeps.
// At the end the block adds its warps' accumulators in warp order and writes
// them once: straight into [dcv | dcu | dg] when one block covers the batch
// (B <= 256: one kernel a call), else into its slice of partial[blocks],
// which reduce_partials sums in block order.  Blocks walk the batch's
// tiles with a grid stride, at most one wave of them.  Above 256 rows
// (rfnn_bwd_lane_kernel<n>, n >= 4) the plan spreads each row over n / 2
// lanes, one cell a lane, so that a warp's chain of columns is a cell
// long: a warp of one thread a row is latency-bound (0.0162 ms at the
// training step's B = 1000 on an H100, PERF.md §6); there each row's terms
// go to shared memory and the block sums them over its rows in row order.
//
// General path, any other even n (rfnn_bwd_kernel): a block stages a tile of
// R = 128 / P rows in shared memory and sweeps it with mesh_sweep.cuh:
// reverse_sweep (two barriers a column), each column's terms summed over
// the tile's rows into the block's slice [dcv | dcu | dg]
// ((Cv + Cu) * 8 P + 8 P floats), then reduce_partials.
//
// Determinism: no float atomics.  Every sum runs in an order fixed by the
// plan (lanes, warps, tiles a block, blocks), and the plan depends only on
// B, n, Cv, Cu and the card: two calls on the same inputs give the same
// bits.
//
// Bound: per row, read v, u, gout and write dx (28 n bytes) against ~88
// flops per cell of both meshes (as B2): at the paper's n = 8 both are far
// under a launch's own latency; a call costs the launch, the staging of
// both meshes and a warp's chain of Cv + Cu columns.

#include <cstdint>

#include "mesh_sweep.cuh"

namespace {

using mesh_sweep::cmul;
using mesh_sweep::cmulc;
using mesh_sweep::kThreads;

__global__ void __launch_bounds__(kThreads)
rfnn_bwd_kernel(const float2* __restrict__ sv, const float2* __restrict__ su,
                const float* __restrict__ gout,
                const float* __restrict__ coef_v, const int* __restrict__ par_v,
                int cols_v, const float* __restrict__ coef_u,
                const int* __restrict__ par_u, int cols_u,
                const float* __restrict__ gains, float* __restrict__ partial,
                float2* __restrict__ dx, int batch, int n, int rows_per_tile,
                int n_tiles) {
  extern __shared__ float2 smem[];
  const int p = n / 2;
  const int m = 8 * p;  // gradient entries per column
  float2* st = smem;                                   // [R][n] state
  float2* gt = smem + rows_per_tile * n;               // [R][n] cotangent
  float* terms = reinterpret_cast<float*>(gt + rows_per_tile * n);  // [R][m]
  const long long slice = static_cast<long long>(cols_v + cols_u) * m + m;
  float* part_v = partial + blockIdx.x * slice;
  float* part_u = part_v + static_cast<long long>(cols_v) * m;
  float* part_g = part_u + static_cast<long long>(cols_u) * m;

  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * rows_per_tile;
    const long long left = batch - row0;
    const int rows = left < rows_per_tile ? static_cast<int>(left)
                                          : rows_per_tile;
    const long long base = row0 * n;
    const int count = rows * n;

    // 1-2: |.| backward and the post gain g2
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      const int r = i / n, k = i - r * n;
      const int s = k >> 1, o = k & 1;
      const float2 u = su[base + i];
      const float2 g2 = make_float2(__ldg(gains + (4 + 2 * o) * p + s),
                                    __ldg(gains + (5 + 2 * o) * p + s));
      const float2 z = cmul(u, g2);
      const float mag = sqrtf(z.x * z.x + z.y * z.y);
      const float w = mag > 0.f ? __ldg(gout + base + i) / mag : 0.f;
      const float2 gz = make_float2(w * z.x, w * z.y);
      const float2 d = cmulc(u, gz);
      terms[r * m + (2 * o) * p + s] = d.x;
      terms[r * m + (2 * o + 1) * p + s] = d.y;
      st[i] = u;
      gt[i] = cmulc(g2, gz);
    }
    __syncthreads();
    mesh_sweep::sum_rows(terms, rows, m, 4 * p, p, p, part_g + 4 * p, first);
    __syncthreads();

    // 3: U's reversed sweep from the saved post-U boundary
    mesh_sweep::reverse_sweep(st, gt, terms, coef_u, par_u, cols_u, rows, n,
                              part_u, first);

    // 4: the mid gain g1, from the saved post-V boundary
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      const int r = i / n, k = i - r * n;
      const int s = k >> 1, o = k & 1;
      const float2 v = sv[base + i];
      const float2 gh = gt[i];
      const float2 g1 = make_float2(__ldg(gains + (2 * o) * p + s),
                                    __ldg(gains + (2 * o + 1) * p + s));
      const float2 d = cmulc(v, gh);
      terms[r * m + (2 * o) * p + s] = d.x;
      terms[r * m + (2 * o + 1) * p + s] = d.y;
      st[i] = v;
      gt[i] = cmulc(g1, gh);
    }
    __syncthreads();
    mesh_sweep::sum_rows(terms, rows, m, 4 * p, p, p, part_g, first);
    __syncthreads();

    // 5: V's reversed sweep from the saved post-V boundary
    mesh_sweep::reverse_sweep(st, gt, terms, coef_v, par_v, cols_v, rows, n,
                              part_v, first);
    for (int i = threadIdx.x; i < count; i += blockDim.x) dx[base + i] = gt[i];
    __syncthreads();
    first = false;
  }
}

// Shared bytes of a register-path block of `warps` warps: V's and U's cells
// and inverses (64 bytes a slot), the gains [8][P], the mark words, then
// each warp's accumulator [(Cv + Cu) 8 P + 8 P].
inline size_t reg_shared_bytes(int n, int cols_v, int cols_u, int warps) {
  const size_t p = n / 2, cols = cols_v + cols_u;
  return cols * p * 64 + 32 * p + ((cols + 3) & ~static_cast<size_t>(3)) * 4
         + static_cast<size_t>(warps) * (cols + 1) * 8 * p * sizeof(float);
}

// A gain's 4 P terms (rows as dg's) summed over the warp into its
// accumulator `acc`, in groups of GG = min(P, 8) slots: value q GG + u of
// group g0 / GG (row q, slot g0 + u) at acc[4 g0 + q GG + u].
template <int N>
__device__ __forceinline__ void add_gain(const float2 (&a)[N],
                                         const float2 (&b)[N], float* acc,
                                         int lane, bool first) {
  constexpr int P = N / 2;
  constexpr int GG = P < 8 ? P : 8;
#pragma unroll
  for (int g0 = 0; g0 < P; g0 += GG) {
    float d[4 * GG];
    mesh_sweep::gain_group<N, GG>(a, b, g0, d);
    mesh_sweep::add_terms(d, acc + 4 * g0, lane, first);
  }
}

template <int N>
__global__ void __launch_bounds__(mesh_sweep::kRegRowsMax, 1)
rfnn_bwd_reg_kernel(const float2* __restrict__ sv, const float2* __restrict__ su,
                    const float* __restrict__ gout,
                    const float* __restrict__ coef_v,
                    const int* __restrict__ par_v, int cols_v,
                    const float* __restrict__ coef_u,
                    const int* __restrict__ par_u, int cols_u,
                    const float* __restrict__ gains, float* __restrict__ out,
                    float2* __restrict__ dx, int batch, int n_tiles) {
  constexpr int P = N / 2;
  constexpr int M = 8 * P;                 // gradient entries a column
  constexpr int G = P < 4 ? P : 4;         // slots a group (reverse_group)
  constexpr int GG = P < 8 ? P : 8;        // slots a gain group (add_gain)
  extern __shared__ float4 staged[];
  float4* cells_v = staged;                          // [Cv][P][4]
  float4* cells_u = cells_v + 4 * cols_v * P;        // [Cu][P][4]
  float* sg = reinterpret_cast<float*>(cells_u + 4 * cols_u * P);  // [8][P]
  unsigned* marks_v = reinterpret_cast<unsigned*>(sg + 8 * P);
  unsigned* marks_u = marks_v + cols_v;
  float* acc = reinterpret_cast<float*>(marks_v + ((cols_v + cols_u + 3) & ~3));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int slice = (cols_v + cols_u + 1) * M;
  float* mine = acc + warp * slice;        // this warp's [dcv | dcu | dg]
  float* acc_u = mine + cols_v * M;
  float* acc_g = mine + (cols_v + cols_u) * M;

  const bool vec = ((reinterpret_cast<uintptr_t>(sv)
                     | reinterpret_cast<uintptr_t>(su)
                     | reinterpret_cast<uintptr_t>(gout)
                     | reinterpret_cast<uintptr_t>(dx)) & 15) == 0;
  mesh_sweep::stage_marked<P>(cells_v, 0, marks_v, coef_v, 0, par_v, 0, 1,
                              cols_v);
  mesh_sweep::stage_marked<P>(cells_u, 0, marks_u, coef_u, 0, par_u, 0, 1,
                              cols_u);
  for (int i = threadIdx.x; i < M; i += blockDim.x) sg[i] = gains[i];
  __syncthreads();
  // gain `base` (0 g1, 4 g2) at channel k, from the staged [8][P] gains
  auto gain = [&](int base, int k) {
    const float* row = sg + (base + 2 * (k & 1)) * P + (k >> 1);
    return make_float2(row[0], row[P]);
  };

  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row = static_cast<long long>(tile) * blockDim.x
                          + threadIdx.x;
    const bool live = row < batch;
    float2 st[N], gt[N];
    if (live) {  // 1-2: the |.| backward and g2
      mesh_sweep::load_row(st, su + row * N, vec);
      float go[N];
      if (vec && N >= 4) {
        const float4* s = reinterpret_cast<const float4*>(gout + row * N);
#pragma unroll
        for (int k = 0; k < N / 4; ++k) {
          const float4 w = s[k];
          go[4 * k] = w.x; go[4 * k + 1] = w.y;
          go[4 * k + 2] = w.z; go[4 * k + 3] = w.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < N; ++k) go[k] = gout[row * N + k];
      }
#pragma unroll
      for (int k = 0; k < N; ++k) {  // gz, for now
        gt[k] = mesh_sweep::detect_bwd(mesh_sweep::cmul(st[k], gain(4, k)),
                                       go[k]);
      }
    } else {  // rows past the batch add exact zeros
#pragma unroll
      for (int k = 0; k < N; ++k) st[k] = gt[k] = make_float2(0.f, 0.f);
    }
    add_gain<N>(st, gt, acc_g + 4 * P, lane, first);
#pragma unroll
    for (int k = 0; k < N; ++k) gt[k] = mesh_sweep::cmulc(gain(4, k), gt[k]);
    // 3: U's reversed sweep from the saved post-U boundary
    mesh_sweep::reverse_columns<N>(
        st, gt, cells_u, marks_u, 1, 0, cols_u,
        [&](const float (&d)[8 * G], int c, int g0) {
          mesh_sweep::add_terms(d, acc_u + c * M + 8 * g0, lane, first);
        });
    // 4: the mid gain g1, from the saved post-V boundary
    if (live) {
      mesh_sweep::load_row(st, sv + row * N, vec);
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) st[k] = make_float2(0.f, 0.f);
    }
    add_gain<N>(st, gt, acc_g, lane, first);
#pragma unroll
    for (int k = 0; k < N; ++k) gt[k] = mesh_sweep::cmulc(gain(0, k), gt[k]);
    // 5: V's reversed sweep from the saved post-V boundary
    mesh_sweep::reverse_columns<N>(
        st, gt, cells_v, marks_v, 1, 0, cols_v,
        [&](const float (&d)[8 * G], int c, int g0) {
          mesh_sweep::add_terms(d, mine + c * M + 8 * g0, lane, first);
        });
    if (live) mesh_sweep::store_row(dx + row * N, gt, vec);
    first = false;
  }
  __syncthreads();
  // The block's sum, warps in order, in [dcv | dcu | dg]'s layout: column
  // entry (c, q, s) sits in a warp's accumulator at c M + 8 (s - s % G) +
  // q G + s % G, gain entry (q, s) at (C M) + 4 (s - s % GG) + q GG + s % GG
  // (q < 8: g1's rows then g2's, each a 4 P block).
  const int col_entries = (cols_v + cols_u) * M;
  float* dst = out + static_cast<long long>(blockIdx.x) * slice;
  for (int e = threadIdx.x; e < slice; e += blockDim.x) {
    int at;
    if (e < col_entries) {
      const int c = e / M, r = e - c * M;
      const int q = r / P, s = r - q * P;
      at = c * M + 8 * (s - s % G) + q * G + s % G;
    } else {
      const int r = e - col_entries;
      const int half = r / (4 * P), r4 = r - half * 4 * P;
      const int q = r4 / P, s = r4 - q * P;
      at = col_entries + half * 4 * P + 4 * (s - s % GG) + q * GG + s % GG;
    }
    float sum = acc[at];
    for (int w = 1; w < warps; ++w) sum += acc[w * slice + at];
    dst[e] = sum;
  }
}

// Shared bytes of a lane-path block of `rows` rows: V's and U's cells and
// inverses, the gains, the mark words, then each row's terms [(Cv + Cu) 8
// P + 8 P] padded by 16 bytes.
inline size_t lane_shared_bytes(int n, int cols_v, int cols_u, int rows) {
  const size_t p = n / 2, cols = cols_v + cols_u;
  return cols * p * 64 + 32 * p + ((cols + 3) & ~static_cast<size_t>(3)) * 4
         + static_cast<size_t>(rows) * ((cols + 1) * 8 * p + 4)
               * sizeof(float);
}

// Above one block's rows (B > 256): P = n / 2 lanes a row, lane j holding
// channels 2 j and 2 j + 1 and reversing cell j of each column
// (mesh_sweep.cuh: lane_column, as the one-tile deep grid's B8), so a
// warp's chain of columns is a cell long, not a row's P cells.  Each lane
// stores its cell's terms, and its gains', into its row's terms in shared
// memory; at the end the block sums them over its rows in row order
// (mesh_sweep.cuh: flush_rows) into its slice, in [dcv | dcu | dg]'s
// layout.
template <int N>
__global__ void __launch_bounds__(mesh_sweep::kRegRowsMax, 1)
rfnn_bwd_lane_kernel(const float2* __restrict__ sv,
                     const float2* __restrict__ su,
                     const float* __restrict__ gout,
                     const float* __restrict__ coef_v,
                     const int* __restrict__ par_v, int cols_v,
                     const float* __restrict__ coef_u,
                     const int* __restrict__ par_u, int cols_u,
                     const float* __restrict__ gains, float* __restrict__ out,
                     float2* __restrict__ dx, int batch, int rows_per_block,
                     int n_tiles) {
  constexpr int P = N / 2;
  constexpr int M = 8 * P;                 // gradient entries a column
  extern __shared__ float4 staged[];
  float4* cells_v = staged;                          // [Cv][P][4]
  float4* cells_u = cells_v + 4 * cols_v * P;        // [Cu][P][4]
  float* sg = reinterpret_cast<float*>(cells_u + 4 * cols_u * P);  // [8][P]
  unsigned* marks_v = reinterpret_cast<unsigned*>(sg + 8 * P);
  unsigned* marks_u = marks_v + cols_v;
  float* terms0 = reinterpret_cast<float*>(
      marks_v + ((cols_v + cols_u + 3) & ~3));
  const int slice = (cols_v + cols_u + 1) * M;
  const int stride = slice + 4;            // a row's terms, padded
  const int j = threadIdx.x % P;           // the lane's slot
  const int r = threadIdx.x / P;           // the lane's row in the block
  float* terms = terms0 + r * stride;      // [dcv | dcu | dg] of its row
  const bool vec = ((reinterpret_cast<uintptr_t>(sv)
                     | reinterpret_cast<uintptr_t>(su)
                     | reinterpret_cast<uintptr_t>(dx)) & 15) == 0;
  mesh_sweep::stage_marked<P>(cells_v, 0, marks_v, coef_v, 0, par_v, 0, 1,
                              cols_v);
  mesh_sweep::stage_marked<P>(cells_u, 0, marks_u, coef_u, 0, par_u, 0, 1,
                              cols_u);
  for (int i = threadIdx.x; i < M; i += blockDim.x) sg[i] = gains[i];
  __syncthreads();
  // gain `base` (0 g1, 4 g2) at channel 2 j + o
  auto gain = [&](int base, int o) {
    const float* g = sg + (base + 2 * o) * P + j;
    return make_float2(g[0], g[P]);
  };
  // conj(a) b of the lane's two channels into its row's gain terms
  auto gain_terms = [&](float2 a0, float2 a1, float2 b0, float2 b1,
                        int base) {
    const float2 e = cmulc(a0, b0), o = cmulc(a1, b1);
    float* t = terms + (cols_v + cols_u) * M + base * P + j;
    t[0] = e.x;
    t[P] = e.y;
    t[2 * P] = o.x;
    t[3 * P] = o.y;
  };
  auto sweep = [&](float2& s0, float2& s1, float2& g0, float2& g1,
                   const float4* cells, const unsigned* marks, int n_cols,
                   float* dst) {
    for (int k = n_cols - 1; k >= 0; --k) {
      float d[8];
      mesh_sweep::lane_column<N>(s0, s1, g0, g1, cells + 4 * P * k, marks[k],
                                 j, d);
#pragma unroll
      for (int u = 0; u < 8; ++u) dst[k * M + u * P + j] = d[u];
    }
  };

  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * rows_per_block;
    const long long left = batch - row0;
    const int rows = left < rows_per_block ? static_cast<int>(left)
                                           : rows_per_block;
    const long long at = (row0 + r) * N + 2 * j;  // the lane's channels
    const float2 zero = make_float2(0.f, 0.f);
    float2 s0 = zero, s1 = zero, g0 = zero, g1 = zero, v0 = zero, v1 = zero;
    if (r < rows) {  // 1-2: the |.| backward and g2
      mesh_sweep::load_pair(s0, s1, su + at, vec);
      mesh_sweep::load_pair(v0, v1, sv + at, vec);  // for g1, loaded ahead
      g0 = mesh_sweep::detect_bwd(cmul(s0, gain(4, 0)), gout[at]);
      g1 = mesh_sweep::detect_bwd(cmul(s1, gain(4, 1)), gout[at + 1]);
    }
    gain_terms(s0, s1, g0, g1, 4);
    g0 = cmulc(gain(4, 0), g0);
    g1 = cmulc(gain(4, 1), g1);
    // 3: U's reversed sweep from the saved post-U boundary
    sweep(s0, s1, g0, g1, cells_u, marks_u, cols_u, terms + cols_v * M);
    // 4: the mid gain g1, from the saved post-V boundary
    s0 = v0;
    s1 = v1;
    gain_terms(s0, s1, g0, g1, 0);
    g0 = cmulc(gain(0, 0), g0);
    g1 = cmulc(gain(0, 1), g1);
    // 5: V's reversed sweep from the saved post-V boundary
    sweep(s0, s1, g0, g1, cells_v, marks_v, cols_v, terms);
    if (r < rows) {
      if (vec) {
        *reinterpret_cast<float4*>(dx + at) =
            make_float4(g0.x, g0.y, g1.x, g1.y);
      } else {
        dx[at] = g0;
        dx[at + 1] = g1;
      }
    }
    __syncthreads();  // every row's terms written
    mesh_sweep::flush_rows(terms0, stride, rows, slice,
                           out + static_cast<long long>(blockIdx.x) * slice,
                           first);
    __syncthreads();  // read before the next tile's rows overwrite them
    first = false;
  }
}

template <typename Kernel>
int allow_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// The register path's launch: one thread a row (lanes == 1) or n / 2 lanes
// a row.
template <int N>
int launch_reg(const float2* sv, const float2* su, const float* gout,
               const float* coef_v, const int* par_v, int cols_v,
               const float* coef_u, const int* par_u, int cols_u,
               const float* gains, float* out, float2* dx, int batch,
               int rows, int lanes, int blocks, size_t smem,
               cudaStream_t stream) {
  const int tiles = mesh_sweep::tile_count(batch, rows);
  int err = 0;
  if (lanes == 1) {
    err = allow_shared(rfnn_bwd_reg_kernel<N>, smem);
    if (err != 0) return err;
    rfnn_bwd_reg_kernel<N><<<blocks, rows, smem, stream>>>(
        sv, su, gout, coef_v, par_v, cols_v, coef_u, par_u, cols_u, gains,
        out, dx, batch, tiles);
  } else {
    err = allow_shared(rfnn_bwd_lane_kernel<N>, smem);
    if (err != 0) return err;
    rfnn_bwd_lane_kernel<N><<<blocks, rows * lanes, smem, stream>>>(
        sv, su, gout, coef_v, par_v, cols_v, coef_u, par_u, cols_u, gains,
        out, dx, batch, rows, tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks an SM holds of `kernel`; a register-path kernel is first
// allowed its dynamic shared memory above 48 KB, as its launch does.
int occupancy(const void* kernel, int threads, size_t smem, bool reg) {
  if (reg && smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return -static_cast<int>(err);
  }
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, smem);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

}  // namespace

// Resident blocks an SM of the current device holds of the backward kernel
// on path `reg` for width n (one thread a row, lanes == 1, or n / 2 lanes
// a row) at `threads` threads and `smem` dynamic shared bytes a block (the plan caps its blocks at one wave of them; the plan is
// cached per batch, width, columns and card, so this runs once a shape).
// Returns -(CUDA error) on failure, and -cudaErrorInvalidValue for a width
// the register path does not take.
extern "C" int rfnn_bwd_occupancy(int reg, int n, int lanes, int threads,
                                  long long smem) {
  const size_t sm = static_cast<size_t>(smem);
  if (!reg) {
    return occupancy(reinterpret_cast<const void*>(rfnn_bwd_kernel), threads,
                     sm, false);
  }
#define RFNN_BWD_OCC(NN)                                                     \
  case NN:                                                                   \
    return occupancy(lanes == 1                                              \
                         ? reinterpret_cast<const void*>(                    \
                               rfnn_bwd_reg_kernel<NN>)                      \
                         : reinterpret_cast<const void*>(                    \
                               rfnn_bwd_lane_kernel<NN>),                    \
                     threads, sm, true);
  switch (n) {
    RFNN_BWD_OCC(2)
    RFNN_BWD_OCC(4)
    RFNN_BWD_OCC(8)
    RFNN_BWD_OCC(16)
    RFNN_BWD_OCC(32)
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
#undef RFNN_BWD_OCC
}

// Plain C entry point (loaded with ctypes).  All pointers are device
// pointers; `stream` is a cudaStream_t.  The plan (givens_mesh.py:
// rfnn_bwd_plan) gives the path (`reg`), the rows a block tile, the lanes
// a row of the register path (1, or n / 2 above one block's rows), the
// block count and the dynamic shared bytes a block.  `partial` is float32 scratch
// of [n_blocks, (cols_v + cols_u + 1) * 8 * n/2], unused (may be null) when
// the register path runs one block, which writes `grads` itself; otherwise
// `grads` receives the block-order sum of the slices, [dcv | dcu | dg].
// The caller guarantees batch > 0, even n >= 2 and contiguous tensors.
// Returns cudaGetLastError() after the launches (a refused launch
// included: on the general path the tiles exceed the 48 KB of static
// shared memory above n = 1536), or cudaErrorInvalidValue for a plan this
// kernel cannot run.
extern "C" int rfnn_bwd_launch(const void* sv, const void* su,
                               const void* gout, const void* coef_v,
                               const void* par_v, int cols_v,
                               const void* coef_u, const void* par_u,
                               int cols_u, const void* gains, void* partial,
                               void* grads, void* dx, int batch, int n,
                               int reg, int rows, int lanes, int n_blocks,
                               long long smem, void* stream) {
  const int tiles = mesh_sweep::tile_count(batch, rows);
  if (n_blocks < 1 || n_blocks > tiles
      || (n_blocks > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);  // a slice left unwritten
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const float2*>(sv);
  const auto* u = static_cast<const float2*>(su);
  const auto* go = static_cast<const float*>(gout);
  const auto* cv = static_cast<const float*>(coef_v);
  const auto* pv = static_cast<const int*>(par_v);
  const auto* cu = static_cast<const float*>(coef_u);
  const auto* pu = static_cast<const int*>(par_u);
  const auto* gn = static_cast<const float*>(gains);
  auto* dxx = static_cast<float2*>(dx);
  const size_t sm = static_cast<size_t>(smem);
  int err = 0;
  if (reg) {
    const bool ok = lanes == 1
        ? rows >= 32 && rows <= mesh_sweep::kRegRowsMax && rows % 32 == 0
              && sm >= reg_shared_bytes(n, cols_v, cols_u, rows / 32)
        : lanes == n / 2 && rows * lanes % 32 == 0
              && rows * lanes <= mesh_sweep::kRegRowsMax
              && sm >= lane_shared_bytes(n, cols_v, cols_u, rows);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    float* out = static_cast<float*>(n_blocks == 1 ? grads : partial);
    switch (n) {
#define RFNN_BWD_REG(NN)                                                     \
  case NN:                                                                   \
    err = launch_reg<NN>(v, u, go, cv, pv, cols_v, cu, pu, cols_u, gn, out,  \
                         dxx, batch, rows, lanes, n_blocks, sm, s);          \
    break;
      RFNN_BWD_REG(2)
      RFNN_BWD_REG(4)
      RFNN_BWD_REG(8)
      RFNN_BWD_REG(16)
      RFNN_BWD_REG(32)
#undef RFNN_BWD_REG
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err != 0 || n_blocks == 1) return err;
  } else {
    if (rows != mesh_sweep::rows_per_tile(n)
        || sm != mesh_sweep::reverse_shared_bytes(n)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    rfnn_bwd_kernel<<<n_blocks, kThreads, sm, s>>>(
        v, u, go, cv, pv, cols_v, cu, pu, cols_u, gn,
        static_cast<float*>(partial), dxx, batch, n, rows, tiles);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  const int total = (cols_v + cols_u + 1) * 8 * (n / 2);
  mesh_sweep::reduce_partials<<<(total + 31) / 32, dim3(32, 8), 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(grads),
      n_blocks, total);
  return static_cast<int>(cudaGetLastError());
}
