// Forward of the fused analog linear layer (paper Eq. 31, Fig. 11): the
// V-mesh, the mid gain g1, the U-mesh, the post gain g2 and the detector's
// magnitude, for complex64 rows x [B, n]:
//
//   v = V x,   u = U (g1 * v),   out = |g2 * u|        out: float32 [B, n]
//
// V and U are meshes of arbitrary complex 2x2 cells in the [C, 8, P] float32
// coefficient layout with int32 [C] parities (see mesh_fwd.cu); Cv may differ
// from Cu (a Reck program has more columns than a Clements rectangle).  The
// gains keep the JAX package's float32 [8, P] layout: rows 0-3 are g1
// (even re, even im, odd re, odd im), rows 4-7 g2, so channel 2s + o takes
// g1 = (gains[2o][s], gains[2o + 1][s]) and g2 = (gains[4 + 2o][s],
// gains[5 + 2o][s]).  `out` is in channel order: the even and odd magnitudes
// interleaved, as the JAX package's jnp.stack([oe, oo], -1).reshape(-1, n).
//
// One template, two kernels:
//   kSaveStages = false  B3, replaces repro/kernels/givens_mesh.py:
//                        rfnn_linear_kernel (inference; writes only `out`);
//   kSaveStages = true   B4, replaces givens_mesh.py: rfnn_linear_fwd_kernel
//                        (training forward; also writes the post-V and post-U
//                        stage boundaries v and u, complex64 [B, n], both
//                        taken before their gain: the residuals of B5).
//
// Two paths, chosen by the caller's plan (givens_mesh.rfnn_fwd_plan: by n,
// B and, through shared memory, Cv and Cu; an error, never a fallback):
//
// Register path, n in {2, 4, 8, 16, 32}.  The block stages V's and U's
// cells once, cell-major (stage_layer: mesh_sweep.cuh: stage_cells<false>'s
// layout, 16 n (Cv + Cu) bytes, 3.3 KiB for the programmed processor's 13 +
// 13 Reck columns at n = 8; both meshes and the gains [8][P] in one round
// of loads), with a mark word a column: bit s where slot s holds a cell
// that is not the identity, and the parity.  One barrier; after it no
// thread waits for another.  Two layouts, by batch:
//   one thread a row (rfnn_fwd_reg_kernel<n>): the row's n channels in
//   registers, read and written as 16-byte words where aligned
//   (mesh_sweep.cuh: load_row, store_row); the thread walks V's columns,
//   applies g1, walks U's, applies g2 and |.|.  A slot that holds no live
//   cell is skipped (a Reck program at n = 8 holds 28 cells in its 46
//   slots a mesh).  Rows a block as B1's.
//   n / 2 lanes a row (rfnn_fwd_lane_kernel<n>, n >= 4): lane j holds
//   channels 2 j and 2 j + 1 and rotates cell j of each column; a parity-1
//   column's cell j pairs the lane's odd channel with lane j + 1's even one,
//   which one shuffle brings and one takes back (the forward twin of
//   mesh_sweep.cuh: lane_column).  The next column's mark word and cell are
//   read while a column is rotated, so a warp's chain is a cell a column,
//   not a row's P cells: with one thread a row a batch of 1000 is 32
//   warps, each a chain of P cells a column.  A column with no live cell is
//   skipped by the whole warp; the identity cells of a live column are
//   rotated without a branch (a lane's own test cost more than it saved).
//   At least 128 threads a block, so that the block's threads stage the
//   paper's meshes in one round of loads.
// Skipping an identity cell changes no value (for finite inputs it gives
// its pair back, up to the sign of a zero).  Both paths compute every value
// with the same pinned roundings (rotate, cmul, magnitude below), so with no
// slot skipped the register path's out, v and u are the general path's
// bits.
//
// General path, any other even n (rfnn_fwd_kernel), as before: a block
// stages a tile of R = 128 / P rows as float2[R][n] in shared memory, sweeps
// V's columns and then U's with a barrier per column (sweep_tile:
// mesh_sweep.cuh: forward_sweep's loop), coefficients through __ldg; the
// gains are applied elementwise in between.  The ragged last tile is
// masked to the rows that exist.
//
// Bound: per row the kernel reads x (8 n bytes) and writes out (4 n), plus
// 16 n for the two boundaries in B4, for 28 flops per live cell of both
// meshes: about 2.3 n flop/byte for B3 over two Clements meshes, under the
// H100's float32 ridge of 20 flop/byte up to n ~ 8.  At the paper's n = 8 a
// launch is bound by launch latency and the chain of Cv + Cu dependent
// columns: the bytes of B = 65536 rows take 1.9 us (B3).

#include <cstdint>

#include "mesh_sweep.cuh"

namespace {

using mesh_sweep::kParityBit;
using mesh_sweep::kThreads;

// ---------------------------------------------------------------------------
// arithmetic, every rounding pinned
// ---------------------------------------------------------------------------
//
// Both paths compute with these alone: explicit __fmul_rn / __fmaf_rn,
// which nvcc neither contracts nor reorders, so that a value's roundings do
// not depend on the code around it (with nvcc's own contraction the two
// paths differed by 1 to 5 ULP).  rotate_cell's expressions in their order:
// a' = t00 a + t01 b, b' = t10 a + t11 b, each a product and three FMAs.

// (tr + i ti) a + (ur + i ui) b
__device__ __forceinline__ float2 cell_out(float tr, float ti, float ur,
                                           float ui, float2 a, float2 b) {
  float x = __fmul_rn(tr, a.x);
  x = __fmaf_rn(-ti, a.y, x);
  x = __fmaf_rn(ur, b.x, x);
  x = __fmaf_rn(-ui, b.y, x);
  float y = __fmul_rn(tr, a.y);
  y = __fmaf_rn(ti, a.x, y);
  y = __fmaf_rn(ur, b.y, y);
  y = __fmaf_rn(ui, b.x, y);
  return make_float2(x, y);
}

// (a, b) <- t (a, b) for a cell c[0..7] = (t00, t01, t10, t11) x (re, im)
__device__ __forceinline__ void rotate(const float (&c)[8], float2& a,
                                       float2& b) {
  const float2 a2 = cell_out(c[0], c[1], c[2], c[3], a, b);
  b = cell_out(c[4], c[5], c[6], c[7], a, b);
  a = a2;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fmaf_rn(-a.y, b.y, __fmul_rn(a.x, b.x)),
                     __fmaf_rn(a.y, b.x, __fmul_rn(a.x, b.y)));
}

__device__ __forceinline__ float magnitude(float2 z) {
  return sqrtf(__fmaf_rn(z.y, z.y, __fmul_rn(z.x, z.x)));
}

// ---------------------------------------------------------------------------
// general path
// ---------------------------------------------------------------------------

// Columns 0 .. n_cols-1 on a block's tile in place (mesh_sweep.cuh:
// forward_sweep, its cells rotated by `rotate`).  The caller has synced
// after filling the tile; the sweep ends with a barrier.
__device__ void sweep_tile(float2* tile, const float* __restrict__ coef,
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
      float t[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) t[q] = __ldg(cc + q * p + s);
      float2 a = row[top];
      float2 b = row[top + 1];
      rotate(t, a, b);
      row[top] = a;
      row[top + 1] = b;
    }
    __syncthreads();
  }
}

template <bool kSaveStages>
__global__ void __launch_bounds__(kThreads)
rfnn_fwd_kernel(const float2* __restrict__ x, float* __restrict__ out,
                float2* __restrict__ sv, float2* __restrict__ su,
                const float* __restrict__ coef_v, const int* __restrict__ par_v,
                int cols_v, const float* __restrict__ coef_u,
                const int* __restrict__ par_u, int cols_u,
                const float* __restrict__ gains, int batch, int n,
                int rows_per_block) {
  extern __shared__ float2 tile[];  // [rows_per_block][n]
  const int p = n / 2;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long left = batch - row0;
  const int rows = left < rows_per_block ? static_cast<int>(left)
                                         : rows_per_block;
  const long long base = row0 * n;
  const int count = rows * n;

  for (int i = threadIdx.x; i < count; i += blockDim.x) tile[i] = x[base + i];
  __syncthreads();
  sweep_tile(tile, coef_v, par_v, cols_v, rows, n);

  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int k = i % n;
    const int s = k >> 1, o = k & 1;
    const float2 v = tile[i];
    if (kSaveStages) sv[base + i] = v;
    const float2 g1 = make_float2(__ldg(gains + (2 * o) * p + s),
                                  __ldg(gains + (2 * o + 1) * p + s));
    tile[i] = cmul(v, g1);
  }
  __syncthreads();
  sweep_tile(tile, coef_u, par_u, cols_u, rows, n);

  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int k = i % n;
    const int s = k >> 1, o = k & 1;
    const float2 u = tile[i];
    if (kSaveStages) su[base + i] = u;
    const float2 g2 = make_float2(__ldg(gains + (4 + 2 * o) * p + s),
                                  __ldg(gains + (5 + 2 * o) * p + s));
    out[base + i] = magnitude(cmul(u, g2));
  }
}

// ---------------------------------------------------------------------------
// register path
// ---------------------------------------------------------------------------

// Shared bytes of a register-path block: V's and U's cells (32 bytes a
// slot), the gains [8][P] and the mark words (padded to 16 bytes).
inline size_t reg_shared_bytes(int n, int cols_v, int cols_u) {
  const size_t p = n / 2, cols = cols_v + cols_u;
  return cols * p * 32 + 32 * p + ((cols + 3) & ~static_cast<size_t>(3)) * 4;
}

// What a register-path block stages, in its dynamic shared memory.
struct Staged {
  const float4* cells_v;   // [Cv][P][2]
  const float4* cells_u;   // [Cu][P][2]
  const float* gains;      // [8][P]
  const unsigned* marks_v;  // [Cv]
  const unsigned* marks_u;  // [Cu]
};

// Stage both meshes' cells cell-major, W = 2 float4 a cell (the layout of
// mesh_sweep.cuh: stage_cells<false>), U's columns right after V's, with a
// mark word a column (as mesh_sweep.cuh: stage_marked's: bit s for a slot
// holding a cell that is not the identity [1,0,0,0,0,0,1,0], tested on the
// bits; kParityBit for parity 1), and the gains [8][P].  One lane a slot, a
// column's P slots in adjacent lanes, so one ballot gathers a column's
// bits.  A thread's first gain is loaded beside its first slot, so a block
// of at least (Cv + Cu) P threads stages in one round of loads.  No
// barrier.
template <int P>
__device__ __forceinline__ Staged stage_layer(
    float4* smem, const float* __restrict__ coef_v,
    const int* __restrict__ par_v, int cols_v,
    const float* __restrict__ coef_u, const int* __restrict__ par_u,
    int cols_u, const float* __restrict__ gains) {
  constexpr unsigned kOne = 0x3f800000u;  // 1.0f
  float4* cells = smem;                   // [Cv + Cu][P][2]
  float* sg = reinterpret_cast<float*>(cells + 2 * (cols_v + cols_u) * P);
  unsigned* marks = reinterpret_cast<unsigned*>(sg + 8 * P);
  const int total = (cols_v + cols_u) * P;
  const int lane = threadIdx.x & 31;
  const bool has_gain = threadIdx.x < 8 * P;
  const float g = has_gain ? __ldg(gains + threadIdx.x) : 0.f;
  for (int e0 = threadIdx.x - lane; e0 < total; e0 += blockDim.x) {
    const int e = e0 + lane;
    bool real = false;
    int k = 0, parity = 0;
    if (e < total) {
      k = e / P;
      const int s = e - k * P;
      const bool in_v = k < cols_v;
      const float* cc = in_v
          ? coef_v + static_cast<long long>(k) * 8 * P + s
          : coef_u + static_cast<long long>(k - cols_v) * 8 * P + s;
      float c[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) c[q] = __ldg(cc + q * P);
      parity = __ldg(in_v ? par_v + k : par_u + (k - cols_v));
      cells[2 * e] = make_float4(c[0], c[1], c[2], c[3]);
      cells[2 * e + 1] = make_float4(c[4], c[5], c[6], c[7]);
      unsigned diff = 0u;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        diff |= __float_as_uint(c[q]) ^ ((q == 0 || q == 6) ? kOne : 0u);
      }
      real = diff != 0u && !(parity && s == P - 1);
    }
    const unsigned bits = __ballot_sync(0xffffffffu, real);
    if (e < total && (lane & (P - 1)) == 0) {  // slot 0 of its column
      marks[k] = ((bits >> lane) & ((1u << P) - 1u))
                 | (parity ? kParityBit : 0u);
    }
  }
  if (has_gain) sg[threadIdx.x] = g;
  for (int i = threadIdx.x + blockDim.x; i < 8 * P; i += blockDim.x) {
    sg[i] = __ldg(gains + i);
  }
  return {cells, cells + 2 * cols_v * P, sg, marks, marks + cols_v};
}

// gain `base` (0 g1, 4 g2) of channel 2 s + o, from the staged [8][P] gains
__device__ __forceinline__ float2 staged_gain(const float* sg, int p,
                                              int base, int s, int o) {
  const float* row = sg + (base + 2 * o) * p + s;
  return make_float2(row[0], row[p]);
}

// One column on a row's registers: the cells of `cc` (P staged cells, W =
// 2) on the pairs (2 s + kPar, 2 s + kPar + 1), those the mark word w marks
// live only.
template <int N, int kPar>
__device__ __forceinline__ void rotate_live(float2 (&st)[N], const float4* cc,
                                            unsigned w) {
  constexpr int P = N / 2;
#pragma unroll
  for (int s = 0; s < (kPar ? P - 1 : P); ++s) {
    if ((w >> s) & 1u) {
      float c[8];
      mesh_sweep::load_cell(cc + 2 * s, c);
      rotate(c, st[2 * s + kPar], st[2 * s + kPar + 1]);
    }
  }
}

template <int N>
__device__ __forceinline__ void sweep_row(float2 (&st)[N],
                                          const float4* cells,
                                          const unsigned* marks, int n_cols) {
  constexpr int P = N / 2;
  for (int c = 0; c < n_cols; ++c) {
    const unsigned w = marks[c];
    if (w & kParityBit) {
      rotate_live<N, 1>(st, cells + 2 * P * c, w);
    } else {
      rotate_live<N, 0>(st, cells + 2 * P * c, w);
    }
  }
}

// |g2 u| of a row's N channels into dst: N / 4 16-byte words (N / 2 8-byte
// ones at N = 2) where `vec` (dst 16-byte aligned), else N floats.
template <int N>
__device__ __forceinline__ void store_out(float* __restrict__ dst,
                                          const float (&o)[N], bool vec) {
  if (vec) {
    if constexpr (N >= 4) {
      float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
      for (int k = 0; k < N / 4; ++k) {
        d[k] = make_float4(o[4 * k], o[4 * k + 1], o[4 * k + 2], o[4 * k + 3]);
      }
    } else {
      *reinterpret_cast<float2*>(dst) = make_float2(o[0], o[1]);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < N; ++k) dst[k] = o[k];
}

// One thread a row.
template <int N, bool kSaveStages>
__global__ void __launch_bounds__(mesh_sweep::kRegRowsMax)
rfnn_fwd_reg_kernel(const float2* __restrict__ x, float* __restrict__ out,
                    float2* __restrict__ sv, float2* __restrict__ su,
                    const float* __restrict__ coef_v,
                    const int* __restrict__ par_v, int cols_v,
                    const float* __restrict__ coef_u,
                    const int* __restrict__ par_u, int cols_u,
                    const float* __restrict__ gains, int batch) {
  constexpr int P = N / 2;
  extern __shared__ float4 smem[];
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
  const bool live = row < batch;
  const bool vec = ((reinterpret_cast<uintptr_t>(x)
                     | reinterpret_cast<uintptr_t>(out)
                     | reinterpret_cast<uintptr_t>(sv)
                     | reinterpret_cast<uintptr_t>(su)) & 15) == 0;
  float2 st[N];
  // the row's loads are in flight while the cells are staged
  if (live) mesh_sweep::load_row(st, x + row * N, vec);
  const Staged sm = stage_layer<P>(smem, coef_v, par_v, cols_v, coef_u,
                                   par_u, cols_u, gains);
  __syncthreads();
  if (!live) return;
  sweep_row<N>(st, sm.cells_v, sm.marks_v, cols_v);
  if constexpr (kSaveStages) mesh_sweep::store_row(sv + row * N, st, vec);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    st[k] = cmul(st[k], staged_gain(sm.gains, P, 0, k >> 1, k & 1));
  }
  sweep_row<N>(st, sm.cells_u, sm.marks_u, cols_u);
  if constexpr (kSaveStages) mesh_sweep::store_row(su + row * N, st, vec);
  float o[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    o[k] = magnitude(cmul(st[k], staged_gain(sm.gains, P, 4, k >> 1, k & 1)));
  }
  store_out<N>(out + row * N, o, vec);
}

// One column at lane j of a row spread over P = N / 2 lanes, lane j
// holding channels 2 j and 2 j + 1 (s0, s1), with cell j's coefficients c
// (loaded ahead) and the column's parity: a parity-0 column's cell j is
// the lane's own pair; a parity-1 column's cell j pairs the lane's odd
// channel with lane j + 1's even one, which a shuffle brings and another
// takes back (lane P - 1 holds the wrap slot: no cell).  Identity cells are
// rotated like any other, without a branch.  Every lane of the warp runs
// it.
template <int N>
__device__ __forceinline__ void lane_step(float2& s0, float2& s1,
                                          const float (&c)[8], bool parity,
                                          int j) {
  constexpr int P = N / 2;
  if (!parity) {
    rotate(c, s0, s1);
    return;
  }
  float2 b;  // lane j + 1's even channel
  b.x = __shfl_down_sync(0xffffffffu, s0.x, 1);
  b.y = __shfl_down_sync(0xffffffffu, s0.y, 1);
  if (j < P - 1) rotate(c, s1, b);
  b.x = __shfl_up_sync(0xffffffffu, b.x, 1);
  b.y = __shfl_up_sync(0xffffffffu, b.y, 1);
  if (j > 0) s0 = b;
}

// The n_cols columns of a staged mesh at lane j, the next column's mark
// word and coefficients loaded while this one is applied.  A column with no
// live cell is skipped by the whole warp.
template <int N>
__device__ __forceinline__ void sweep_lanes(float2& s0, float2& s1,
                                            const float4* cells,
                                            const unsigned* marks, int n_cols,
                                            int j) {
  constexpr int P = N / 2;
  if (n_cols <= 0) return;
  unsigned w = marks[0];
  float t[8];
  mesh_sweep::load_cell(cells + 2 * j, t);
  for (int k = 0; k < n_cols; ++k) {
    const int next = k + 1 < n_cols ? k + 1 : k;
    const unsigned w_next = marks[next];
    float t_next[8];
    mesh_sweep::load_cell(cells + 2 * (P * next + j), t_next);
    if ((w & ((1u << P) - 1u)) != 0u) {
      lane_step<N>(s0, s1, t, (w & kParityBit) != 0u, j);
    }
    w = w_next;
#pragma unroll
    for (int q = 0; q < 8; ++q) t[q] = t_next[q];
  }
}

// n / 2 lanes a row, rows_per_block rows a block (whole warps).
template <int N, bool kSaveStages>
__global__ void __launch_bounds__(mesh_sweep::kRegRowsMax)
rfnn_fwd_lane_kernel(const float2* __restrict__ x, float* __restrict__ out,
                     float2* __restrict__ sv, float2* __restrict__ su,
                     const float* __restrict__ coef_v,
                     const int* __restrict__ par_v, int cols_v,
                     const float* __restrict__ coef_u,
                     const int* __restrict__ par_u, int cols_u,
                     const float* __restrict__ gains, int batch,
                     int rows_per_block) {
  constexpr int P = N / 2;
  extern __shared__ float4 smem[];
  const int j = threadIdx.x % P;           // the lane's slot
  const long long row = static_cast<long long>(blockIdx.x) * rows_per_block
                        + threadIdx.x / P;
  const bool live = row < batch;
  const long long at = row * N + 2 * j;    // the lane's channels
  const bool vec = ((reinterpret_cast<uintptr_t>(x)
                     | reinterpret_cast<uintptr_t>(sv)
                     | reinterpret_cast<uintptr_t>(su)) & 15) == 0;
  const float2 zero = make_float2(0.f, 0.f);
  float2 s0 = zero, s1 = zero;
  if (live) mesh_sweep::load_pair(s0, s1, x + at, vec);
  const Staged sm = stage_layer<P>(smem, coef_v, par_v, cols_v, coef_u,
                                   par_u, cols_u, gains);
  __syncthreads();
  const float2 g1e = staged_gain(sm.gains, P, 0, j, 0);
  const float2 g1o = staged_gain(sm.gains, P, 0, j, 1);
  const float2 g2e = staged_gain(sm.gains, P, 4, j, 0);
  const float2 g2o = staged_gain(sm.gains, P, 4, j, 1);
  // no lane leaves: the parity-1 columns' shuffles take the whole warp
  sweep_lanes<N>(s0, s1, sm.cells_v, sm.marks_v, cols_v, j);
  if (kSaveStages && live) mesh_sweep::store_pair(sv + at, s0, s1, vec);
  s0 = cmul(s0, g1e);
  s1 = cmul(s1, g1o);
  sweep_lanes<N>(s0, s1, sm.cells_u, sm.marks_u, cols_u, j);
  if (kSaveStages && live) mesh_sweep::store_pair(su + at, s0, s1, vec);
  if (live) {
    *reinterpret_cast<float2*>(out + at) =
        make_float2(magnitude(cmul(s0, g2e)), magnitude(cmul(s1, g2o)));
  }
}

template <typename Kernel>
int allow_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int N, bool kSaveStages>
int launch_reg(const float2* x, float* out, float2* sv, float2* su,
               const float* coef_v, const int* par_v, int cols_v,
               const float* coef_u, const int* par_u, int cols_u,
               const float* gains, int batch, int rows, int lanes,
               size_t smem, cudaStream_t stream) {
  const int blocks = mesh_sweep::tile_count(batch, rows);
  int err = 0;
  if (lanes == 1) {
    err = allow_shared(rfnn_fwd_reg_kernel<N, kSaveStages>, smem);
    if (err != 0) return err;
    rfnn_fwd_reg_kernel<N, kSaveStages><<<blocks, rows, smem, stream>>>(
        x, out, sv, su, coef_v, par_v, cols_v, coef_u, par_u, cols_u, gains,
        batch);
  } else {
    if constexpr (N >= 4) {
      err = allow_shared(rfnn_fwd_lane_kernel<N, kSaveStages>, smem);
      if (err != 0) return err;
      rfnn_fwd_lane_kernel<N, kSaveStages>
          <<<blocks, rows * lanes, smem, stream>>>(
              x, out, sv, su, coef_v, par_v, cols_v, coef_u, par_u, cols_u,
              gains, batch, rows);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kSaveStages>
int launch(const void* x, void* out, void* sv, void* su, const void* coef_v,
           const void* par_v, int cols_v, const void* coef_u,
           const void* par_u, int cols_u, const void* gains, int batch, int n,
           int reg, int rows, int lanes, long long smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xx = static_cast<const float2*>(x);
  auto* o = static_cast<float*>(out);
  auto* v = static_cast<float2*>(sv);
  auto* u = static_cast<float2*>(su);
  const auto* cv = static_cast<const float*>(coef_v);
  const auto* pv = static_cast<const int*>(par_v);
  const auto* cu = static_cast<const float*>(coef_u);
  const auto* pu = static_cast<const int*>(par_u);
  const auto* gn = static_cast<const float*>(gains);
  const size_t sm = static_cast<size_t>(smem);
  if (reg) {
    const bool ok = sm >= reg_shared_bytes(n, cols_v, cols_u)
        && (lanes == 1
                ? rows >= 32 && rows <= mesh_sweep::kRegRowsMax
                      && rows % 32 == 0
                : n >= 4 && lanes == n / 2 && rows >= 1
                      && rows * lanes % 32 == 0
                      && rows * lanes <= mesh_sweep::kRegRowsMax);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    switch (n) {
#define RFNN_FWD_REG(NN)                                                     \
  case NN:                                                                   \
    return launch_reg<NN, kSaveStages>(xx, o, v, u, cv, pv, cols_v, cu, pu,  \
                                       cols_u, gn, batch, rows, lanes, sm,   \
                                       s);
      RFNN_FWD_REG(2)
      RFNN_FWD_REG(4)
      RFNN_FWD_REG(8)
      RFNN_FWD_REG(16)
      RFNN_FWD_REG(32)
#undef RFNN_FWD_REG
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (lanes != 1 || rows != mesh_sweep::rows_per_tile(n)
      || sm != static_cast<size_t>(rows) * n * sizeof(float2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rfnn_fwd_kernel<kSaveStages>
      <<<mesh_sweep::tile_count(batch, rows), kThreads, sm, s>>>(
          xx, o, v, u, cv, pv, cols_v, cu, pu, cols_u, gn, batch, n, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes).  All pointers are device
// pointers; `stream` is a cudaStream_t.  The plan (givens_mesh.py:
// rfnn_fwd_plan) gives the path (`reg`), the rows a block, the lanes a row
// of the register path (1, or n / 2) and the dynamic shared bytes a block;
// the block count follows from the batch.  The caller guarantees batch > 0,
// even n >= 2 and contiguous tensors.  Each returns cudaGetLastError(),
// which also reports a refused launch (on the general path a tile above the
// 48 KB of static shared memory, n > 6144), or cudaErrorInvalidValue for a
// plan this kernel cannot run.

// B3: out only.
extern "C" int rfnn_fwd_launch(const void* x, void* out, const void* coef_v,
                               const void* par_v, int cols_v,
                               const void* coef_u, const void* par_u,
                               int cols_u, const void* gains, int batch,
                               int n, int reg, int rows, int lanes,
                               long long smem, void* stream) {
  return launch<false>(x, out, nullptr, nullptr, coef_v, par_v, cols_v,
                       coef_u, par_u, cols_u, gains, batch, n, reg, rows,
                       lanes, smem, stream);
}

// B4: out and the stage boundaries sv (post-V) and su (post-U).
extern "C" int rfnn_fwd_res_launch(const void* x, void* out, void* sv,
                                   void* su, const void* coef_v,
                                   const void* par_v, int cols_v,
                                   const void* coef_u, const void* par_u,
                                   int cols_u, const void* gains, int batch,
                                   int n, int reg, int rows, int lanes,
                                   long long smem, void* stream) {
  return launch<true>(x, out, sv, su, coef_v, par_v, cols_v, coef_u, par_u,
                      cols_u, gains, batch, n, reg, rows, lanes, smem,
                      stream);
}
