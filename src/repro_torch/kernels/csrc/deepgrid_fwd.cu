// Forward of the deep tile grid (the paper's Sec.-V multi-layer microwave
// ANN and its scale-up to large matrices): L layers of a (To x Ti) grid of
// analog tiles, for complex64 rows x [B, Ti n].  Per layer every tile
// (o, i) runs
//
//   s = g0 * in_i,  v = V s,  u = U (g1 * v),  z = g2 * u
//
// and each row sums its Ti tile outputs (the matched-line combiner):
// row_o = sum_i z_(o,i).  Layer 0's input tiles are x; layer l > 0 takes
// |row| of layer l - 1 (real, imaginary part 0; To == Ti when L > 1).  The
// last layer writes |row| (kDetectLast) or the complex rows, [B, To n] in
// channel order.
//
// Layouts: coefficients float32 [L, To, Ti, C, 8, P] (see mesh_fwd.cu; every
// mesh identity-padded to the grid's C columns), parities int32
// [L, To, Ti, C], gains float32 [L, To, Ti, 12, P]: rows 0-3 g0, 4-7 g1,
// 8-11 g2, each (even re, even im, odd re, odd im), channel 2s + o at
// column s.
//
// One entry point, four kernels by (save stages, readout):
//   kSaveStages = false  B6, replaces repro/kernels/givens_mesh.py:
//                        deepgrid_kernel (inference);
//   kSaveStages = true   B7, replaces givens_mesh.py: deepgrid_fwd_kernel
//                        (training forward; also writes every tile's post-V
//                        and post-U stage boundaries, complex64
//                        [L, B, To, Ti, n], both before their gain: the
//                        residuals of B8);
// each with either readout.  Both paths compute every value with
// mesh_sweep.cuh's expressions (rotate_cell, cmul, cadd) and sqrtf, in the
// same order, and B6 and B7 differ only in the stores: their outputs are
// the same bits.
//
// Design.  The coefficients, not the rows, are what a launch moves: the
// 4-layer 64 x 64 cascade (4 x 4 tiles of 16, Reck V, C = 29) holds 0.99 MB
// of them.  So on the register path (below) a block owns R rows chosen
// from the batch (R = ceil(B / SMs), one block an SM: 8 rows and 128
// blocks at B = 1024 on the H100's 132), and every coefficient it stages
// serves all R rows: about 127 MB cross from L2 a call at the cascade
// instead of 1 GB when a block owned one row.
//
// Register path, n in {2, 4, 8, 16, 32} (deepgrid_reg_kernel<n>): one thread
// per (row, tile), rows fastest, R To Ti threads (rounded up to a warp, at
// least 128: all of them stage and mark, at most 256).  A thread keeps its
// tile's n channels in registers and runs g0 -> V -> g1 -> U -> g2 alone,
// column after column; the cells of a column are independent (ILP), and no
// barrier falls inside a mesh's chunk.  The coefficients stream through a
// ring of shared-memory buffers by 16-byte cp.async (4-byte where they are
// not 16-byte aligned), in chunks of K columns of every tile of one mesh
// (about 64 KB; at the MNIST and tiled shapes the whole network fits and
// is staged at once), each chunk's parities beside it; every layer's gains
// are staged once.  A staged tile is padded to an odd number of 16-byte
// words, so a warp's lanes (8 rows x 4 tiles at the cascade) read 4
// distinct words in one wavefront.  After a chunk lands, one pass over it
// marks, per (tile, column), which runs of four slots (one 16-byte load of
// each coefficient row) hold a cell that is not the identity
// [1,0,0,0,0,0,1,0] (never looking at a parity-1 column's wrap slot); the
// sweep skips dead runs and dead columns, loads, FMAs and all.  The cells of
// a live run are rotated without a branch: an identity cell among them gives
// its pair back exactly (up to the sign of a zero) for finite values, so the
// skip changes no value.  Half the cascade's slots are identity padding
// (Reck V: 120 cells in 29 x 8 slots; Clements U: 16 of 29 columns).
// Barriers: two a chunk (landed; marked) and two a layer (the row combine:
// tiles write z to shared memory, threads over (row, o, channel) sum the Ti
// tiles in tile order, and the next layer re-detects |row| from there).  B7
// puts each stage boundary in shared memory as 16-byte words (swizzled by
// row), and the block writes its rows' [R, To, Ti, n] out in order after
// the next barrier, whole 512-byte runs a warp.  Tried on the H100 and not
// kept, none faster: two lanes a (row, tile), each with half the channels
// and a shuffle for the straddling cell; the next column's coefficients
// loaded ahead; three or four smaller chunk buffers; the chunks multicast
// by TMA to a cluster of two blocks.
//
// General path, any other even n (deepgrid_general_kernel): the kernel as
// it was before the register path, R = 128 / (To Ti n / 2) rows in shared
// memory (at least 1, fewer where shared memory would not hold them), 128
// threads over (row, tile, pair slot), one barrier per column
// (mesh_sweep.cuh: grid_forward_sweep), coefficients through __ldg (L1
// shares them across the block's rows).  The path is chosen by n and the
// grid's size alone (deepgrid_fwd_plan reports it); an error is returned,
// never a fallback.
//
// Bound: per row and layer, 28 flops per real cell of both meshes of every
// tile, against 8 Ti n bytes of input and 4 To n (or 8 To n) of output:
// operation-bound above a few tiles (64 x 64, L = 4, Reck V: 0.46 GFLOP at
// B = 1024, 6.9 us at the float32 peak).  What holds the register path
// above it at the cascade: the sweep, whose every thread gets each live
// coefficient from shared memory for its one row (32 bytes a cell, R
// times a block), and the chunk stream with its marks and barriers, which
// the sweep hides only in part.
// At the MNIST depth-4 shape (n = 8, one tile) a launch is bound by the
// chain of 4 x 2 x 8 dependent columns and launch latency.

#include <cstdint>

#include "mesh_sweep.cuh"

namespace {

using mesh_sweep::cadd;
using mesh_sweep::cmul;
using mesh_sweep::cp_async_commit;
using mesh_sweep::cp_async_wait;
using mesh_sweep::gain_at;
using mesh_sweep::kParityBit;
using mesh_sweep::kThreads;
using mesh_sweep::rotate_regs;

constexpr size_t kMaxShared = 232448;  // what a block may use on sm_90
constexpr int kRegThreads = 256;       // a register-path block's threads, most
constexpr size_t kChunkBytes = 65536;  // a staged chunk's target size
constexpr size_t kRingBytes = 131072;  // the chunk ring's target size
constexpr int kMaxStages = 8;          // chunk buffers at most (cp_async_wait)

// ---------------------------------------------------------------------------
// register path
// ---------------------------------------------------------------------------

// G consecutive floats of shared memory (16-, 8- or 4-byte aligned).
template <int G>
__device__ __forceinline__ void load_run(const float* p, float (&v)[G]) {
  if constexpr (G == 4) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else if constexpr (G == 2) {
    const float2 w = *reinterpret_cast<const float2*>(p);
    v[0] = w.x; v[1] = w.y;
  } else {
    v[0] = *p;
  }
}

// Shared memory of the register path, in floats: `stages` chunk buffers,
// each [tiles][stride] coefficients then [tiles][kcap] parities (int32);
// every layer's gains [L][tiles][gstride]; the cell marks [kcap][tiles];
// then float2 the tiles' outputs [R][tiles][n], the combined rows [R][To n]
// and, for B7, the stage words [R][tiles][n / 2] (float4).  A staged
// tile's stride is an odd number of 16-byte words, so lanes that read the
// same word of different tiles fall on distinct banks.
struct RegLayout {
  int stride, buf, gstride, gains, marks, work;
  __host__ __device__ RegLayout(int n, int n_layers, int tiles, int kcap,
                                int stages) {
    const int marks4 = (tiles * kcap + 3) & ~3;
    stride = kcap * 4 * n + 4;
    buf = tiles * stride + marks4;
    gstride = 6 * n + 4;
    gains = stages * buf;
    marks = gains + n_layers * tiles * gstride;
    work = marks + marks4;
  }
};

// Stage chunk j: columns [c0, c0 + kc) of layer l's V (m = 0) or U (m = 1)
// for every tile, into buffer j % stages: each tile's kc [8, P] columns in
// their global order (mesh_sweep.cuh: copy_chunk), then their parities.
__device__ __forceinline__ void stage_chunk(
    int j, float* sm, const RegLayout& lay, const float* __restrict__ coef_v,
    const int* __restrict__ par_v, const float* __restrict__ coef_u,
    const int* __restrict__ par_u, int tiles, int n_cols, int n, int kcap,
    int per_mesh, int stages) {
  const int l = j / (2 * per_mesh);
  const int m = (j / per_mesh) % 2;
  const int c0 = (j % per_mesh) * kcap;
  const int kc = n_cols - c0 < kcap ? n_cols - c0 : kcap;
  const long long layer = static_cast<long long>(l) * tiles * n_cols;
  float* buf = sm + (j % stages) * lay.buf;
  mesh_sweep::copy_chunk(buf, lay.stride,
                         reinterpret_cast<int*>(buf + tiles * lay.stride),
                         kcap, (m ? coef_u : coef_v) + layer * 4 * n,
                         (m ? par_u : par_v) + layer, tiles, n_cols, c0, kc,
                         n);
}

// Slots of a run: one 16-byte load of each coefficient row covers four
// (n >= 8); narrower meshes take a column as one run.
template <int N>
struct Runs {
  static constexpr int P = N / 2;
  static constexpr int G = P < 4 ? P : 4;  // slots a run
  static constexpr int R = P / G;          // runs a column
};

// live[k * tiles + t]: bit g set when run g of tile t's staged column k
// holds a cell that is not the identity [1,0,0,0,0,0,1,0] (a parity-1
// column's wrap slot holds none and is not looked at); kParityBit is the
// column's parity (pb[t * kcap + k]).  One thread a (tile, column), tile
// fastest: a warp's 16-byte loads fall on distinct banks.  The test is on
// the bits: a -0 counts as not the identity, and its run is swept.
template <int N>
__device__ __forceinline__ void mark_cells(const float* buf, const int* pb,
                                           int tiles, int kc, int kcap,
                                           int stride, unsigned* live) {
  constexpr int P = Runs<N>::P, G = Runs<N>::G;
  constexpr unsigned kOne = 0x3f800000u;   // 1.0f
  for (int e = threadIdx.x; e < tiles * kc; e += blockDim.x) {
    const int k = e / tiles, t = e - k * tiles;
    const float* col = buf + t * stride + k * 4 * N;
    const int par = pb[t * kcap + k];
    unsigned bits = 0u;
    if constexpr (G == 4) {
#pragma unroll
      for (int g = 0; g < P / 4; ++g) {
        unsigned diff = 0u;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const uint4 v = *reinterpret_cast<const uint4*>(col + q * P + 4 * g);
          const unsigned eye = (q == 0 || q == 6) ? kOne : 0u;
          // the wrap slot (the last run's fourth) is no cell at parity 1
          const unsigned w = (g == P / 4 - 1 && par) ? 0u : (v.w ^ eye);
          diff |= (v.x ^ eye) | (v.y ^ eye) | (v.z ^ eye) | w;
        }
        if (diff != 0u) bits |= 1u << g;
      }
    } else {
      const unsigned* u = reinterpret_cast<const unsigned*>(col);
      unsigned diff = 0u;
#pragma unroll
      for (int f = 0; f < 8 * P; ++f) {
        const int q = f / P, s = f % P;
        const unsigned eye = (q == 0 || q == 6) ? kOne : 0u;
        if (!(par && s == P - 1)) diff |= u[f] ^ eye;
      }
      if (diff != 0u) bits = 1u;
    }
    live[k * tiles + t] = bits | (par ? kParityBit : 0u);
  }
}

// One column on a tile's registers: the cells of `cc` ([8][P]) on the pairs
// (2s + kPar, 2s + kPar + 1), run by run, the runs that `live` marks live
// only.  The cells of a run are rotated without a branch, identity cells
// among them too (they give their pair back).
template <int N, int kPar>
__device__ __forceinline__ void sweep_column(float2 (&st)[N],
                                             const float* cc, unsigned live) {
  constexpr int P = Runs<N>::P, G = Runs<N>::G, RN = Runs<N>::R;
#pragma unroll
  for (int g = 0; g < RN; ++g) {
    if (!((live >> g) & 1u)) continue;
    float c[8][G];
#pragma unroll
    for (int q = 0; q < 8; ++q) load_run<G>(cc + q * P + g * G, c[q]);
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int s = g * G + u;
      if (kPar == 0 || s < P - 1) {
        const float cell[8] = {c[0][u], c[1][u], c[2][u], c[3][u],
                               c[4][u], c[5][u], c[6][u], c[7][u]};
        rotate_regs(cell, st[2 * s + kPar], st[2 * s + kPar + 1]);
      }
    }
  }
}

// The kc staged columns of a tile, the next column's marks read ahead.
template <int N>
__device__ __forceinline__ void sweep_chunk(float2 (&st)[N], const float* cf,
                                            const unsigned* live, int tiles,
                                            int kc) {
  unsigned w = live[0];
  for (int k = 0; k < kc; ++k) {
    const unsigned next = k + 1 < kc ? live[(k + 1) * tiles] : 0u;
    if ((w & ~kParityBit) != 0u) {
      const float* cc = cf + k * 4 * N;
      if (w & kParityBit) {
        sweep_column<N, 1>(st, cc, w);
      } else {
        sweep_column<N, 0>(st, cc, w);
      }
    }
    w = next;
  }
}

// st *= gain `base` (0 g0, 4 g1, 8 g2) from a tile's staged gains gt
// ([12][P]: even re, even im, odd re, odd im per gain).
template <int N>
__device__ __forceinline__ void apply_gain(float2 (&st)[N], const float* gt,
                                           int base) {
  constexpr int P = N / 2;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float* row = gt + (base + 2 * (k & 1)) * P + (k >> 1);
    st[k] = cmul(st[k], make_float2(row[0], row[P]));
  }
}

// B7's stage boundaries leave through shared memory, so that each warp
// writes whole 512-byte runs of [L, B, To, Ti, n]: thread (r, t) puts its n
// channels in sbuf as n / 2 16-byte words, word k2 at k2 ^ (r mod n / 2)
// (the rows of a warp then hit distinct banks); after the next barrier the
// block copies its rows' [R, To, Ti, n] out in order.
template <int N>
__device__ __forceinline__ void put_stage(float4* sbuf, const float2 (&st)[N],
                                          int r, int rt) {
  constexpr int W = N / 2;               // 16-byte words a (row, tile)
#pragma unroll
  for (int k2 = 0; k2 < W; ++k2) {
    sbuf[rt * W + (k2 ^ (r & (W - 1)))] =
        make_float4(st[2 * k2].x, st[2 * k2].y, st[2 * k2 + 1].x,
                    st[2 * k2 + 1].y);
  }
}

template <int N>
__device__ __forceinline__ void copy_stage(float4* __restrict__ dst,
                                           const float4* sbuf, int rows,
                                           int tiles) {
  constexpr int W = N / 2;
  for (int w = threadIdx.x; w < rows * tiles * W; w += blockDim.x) {
    const int rt = w / W, k2 = w % W;
    const int r = rt / tiles;
    dst[w] = sbuf[rt * W + (k2 ^ (r & (W - 1)))];
  }
}

// Dynamic shared bytes of a register-path block (RegLayout).
inline size_t reg_shared_bytes(int n, int n_layers, int to, int ti, int rows,
                               int kcap, int stages, bool save_stages) {
  const RegLayout lay(n, n_layers, to * ti, kcap, stages);
  const size_t tiles = static_cast<size_t>(to) * ti;
  return 4 * static_cast<size_t>(lay.work)
         + 8 * static_cast<size_t>(rows) * ((save_stages ? 2 : 1) * tiles + to)
               * n;
}

template <int N, bool kSaveStages, bool kDetectLast>
__global__ void __launch_bounds__(kRegThreads, 1)
deepgrid_reg_kernel(const float2* __restrict__ x, void* __restrict__ out,
                    float2* __restrict__ sv, float2* __restrict__ su,
                    const float* __restrict__ coef_v,
                    const int* __restrict__ par_v,
                    const float* __restrict__ coef_u,
                    const int* __restrict__ par_u,
                    const float* __restrict__ gains, int batch, int n_layers,
                    int to, int ti, int n_cols, int rows_per_block, int kcap,
                    int stages) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tiles = to * ti;
  const RegLayout lay(N, n_layers, tiles, kcap, stages);
  unsigned* live = reinterpret_cast<unsigned*>(sm + lay.marks);
  float2* work = reinterpret_cast<float2*>(sm + lay.work);  // [R][tiles][N]
  float2* rowbuf = work + rows_per_block * tiles * N;       // [R][To N]
  float4* sbuf = reinterpret_cast<float4*>(rowbuf + rows_per_block * to * N);
  const int out_w = to * N;

  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long left = batch - row0;
  const int rows = left < rows_per_block ? static_cast<int>(left)
                                         : rows_per_block;
  const int r = threadIdx.x % rows_per_block;
  const int t = threadIdx.x / rows_per_block;
  const int i = t % ti;
  const bool active = r < rows && t < tiles;
  const int per_mesh = (n_cols + kcap - 1) / kcap;
  const int n_chunks = 2 * n_layers * per_mesh;

  // a ring of `stages` chunk buffers: chunks 0 .. stages - 2 (and every
  // layer's gains, with chunk 0) in flight before the first sweep, one
  // commit group a chunk
  mesh_sweep::copy_gains(sm + lay.gains, gains, n_layers, tiles, N,
                         lay.gstride);
  for (int jj = 0; jj < stages - 1; ++jj) {
    if (jj < n_chunks) {
      stage_chunk(jj, sm, lay, coef_v, par_v, coef_u, par_u, tiles, n_cols,
                  N, kcap, per_mesh, stages);
    }
    cp_async_commit();
  }
  float2 st[N];
  int j = 0;  // the chunk to sweep next
  for (int l = 0; l < n_layers; ++l) {
    const float* gt = sm + lay.gains + (l * tiles + t) * lay.gstride;
    // this block's rows of layer l's stage boundaries, in 16-byte words
    const long long at = (static_cast<long long>(l) * batch + row0) * tiles
                         * (N / 2);
    if (active) {
      if (l == 0) {
        const float2* in = x + (row0 + r) * ti * N + i * N;
#pragma unroll
        for (int k = 0; k < N; ++k) st[k] = in[k];
      } else {
        const float2* in = rowbuf + r * out_w + i * N;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float2 v = in[k];
          st[k] = make_float2(sqrtf(v.x * v.x + v.y * v.y), 0.f);
        }
      }
    }
    for (int m = 0; m < 2; ++m) {
      for (int q = 0; q < per_mesh; ++q, ++j) {
        const int c0 = q * kcap;
        const int kc = n_cols - c0 < kcap ? n_cols - c0 : kcap;
        const float* buf = sm + (j % stages) * lay.buf;
        cp_async_wait(stages - 2);
        __syncthreads();  // chunk j (and the gains) landed; sweep j - 1 over
        if (j + stages - 1 < n_chunks) {  // into sweep j - 1's buffer
          stage_chunk(j + stages - 1, sm, lay, coef_v, par_v, coef_u, par_u,
                      tiles, n_cols, N, kcap, per_mesh, stages);
        }
        cp_async_commit();
        if (kSaveStages && m == 1 && q == 0) {  // post-V, put before this barrier
          copy_stage<N>(reinterpret_cast<float4*>(sv) + at, sbuf, rows, tiles);
        }
        mark_cells<N>(buf, reinterpret_cast<const int*>(
                               buf + tiles * lay.stride),
                      tiles, kc, kcap, lay.stride, live);
        __syncthreads();  // marks written
        if (active) {
          if (m == 0 && q == 0) apply_gain(st, gt, 0);
          sweep_chunk(st, buf + t * lay.stride, live + t, tiles, kc);
        }
      }
      if (active) {
        if constexpr (kSaveStages) put_stage(sbuf, st, r, r * tiles + t);
        apply_gain(st, gt, m ? 8 : 4);
      }
    }
    // the row combine: row o sums its Ti tile outputs, in tile order
    if (active) {
#pragma unroll
      for (int k = 0; k < N; ++k) work[(r * tiles + t) * N + k] = st[k];
    }
    __syncthreads();
    if (kSaveStages) {  // post-U, put before this barrier
      copy_stage<N>(reinterpret_cast<float4*>(su) + at, sbuf, rows, tiles);
    }
    const bool last = l == n_layers - 1;
    for (int q = threadIdx.x; q < rows * out_w; q += blockDim.x) {
      const int rr = q / out_w;
      const int c = q - rr * out_w;
      const int o = c / N, k = c - o * N;
      const float2* z = work + (rr * tiles + o * ti) * N + k;
      float2 sum = z[0];
      for (int jj = 1; jj < ti; ++jj) sum = cadd(sum, z[jj * N]);
      if (!last) {
        rowbuf[rr * out_w + c] = sum;
      } else if (kDetectLast) {
        static_cast<float*>(out)[(row0 + rr) * out_w + c] =
            sqrtf(sum.x * sum.x + sum.y * sum.y);
      } else {
        static_cast<float2*>(out)[(row0 + rr) * out_w + c] = sum;
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// general path
// ---------------------------------------------------------------------------

template <bool kSaveStages, bool kDetectLast>
__global__ void __launch_bounds__(kThreads)
deepgrid_general_kernel(const float2* __restrict__ x, void* __restrict__ out,
                        float2* __restrict__ sv, float2* __restrict__ su,
                        const float* __restrict__ coef_v,
                        const int* __restrict__ par_v,
                        const float* __restrict__ coef_u,
                        const int* __restrict__ par_u,
                        const float* __restrict__ gains, int batch, int n,
                        int n_layers, int to, int ti, int n_cols,
                        int rows_per_block) {
  extern __shared__ float2 smem[];
  const int p = n / 2;
  const int tiles = to * ti;
  const int tn = tiles * n;                    // a row's tile state
  const int row_w = (to > ti ? to : ti) * n;   // a row's input / row buffer
  float2* rowbuf = smem;                       // [R][row_w]
  float2* work = smem + rows_per_block * row_w;  // [R][tiles][n]
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long left = batch - row0;
  const int rows = left < rows_per_block ? static_cast<int>(left)
                                         : rows_per_block;
  const long long coef_layer = static_cast<long long>(tiles) * n_cols * 8 * p;
  const int par_layer = tiles * n_cols;
  const int gain_layer = tiles * 12 * p;

  const int in_w = ti * n;
  for (int i = threadIdx.x; i < rows * in_w; i += blockDim.x) {
    const int r = i / in_w;
    rowbuf[r * row_w + i - r * in_w] = x[row0 * in_w + i];
  }
  __syncthreads();

  for (int l = 0; l < n_layers; ++l) {
    const float* g = gains + l * gain_layer;
    // this block's rows in layer l's stage boundaries
    const long long stage = (static_cast<long long>(l) * batch + row0) * tn;
    // g0 on every tile's copy of its input tile; layer l > 0 re-detects
    for (int i = threadIdx.x; i < rows * tn; i += blockDim.x) {
      const int r = i / tn;
      const int q = i - r * tn;
      const int t = q / n, k = q - t * n;
      float2 v = rowbuf[r * row_w + (t % ti) * n + k];
      if (l > 0) v = make_float2(sqrtf(v.x * v.x + v.y * v.y), 0.f);
      work[i] = cmul(v, gain_at(g, t, 0, k, p));
    }
    __syncthreads();
    mesh_sweep::grid_forward_sweep(work, coef_v + l * coef_layer,
                                   par_v + l * par_layer, n_cols, rows, tiles,
                                   n);
    for (int i = threadIdx.x; i < rows * tn; i += blockDim.x) {
      const int q = i % tn;
      const int t = q / n, k = q - t * n;
      const float2 v = work[i];
      if (kSaveStages) sv[stage + i] = v;
      work[i] = cmul(v, gain_at(g, t, 4, k, p));
    }
    __syncthreads();
    mesh_sweep::grid_forward_sweep(work, coef_u + l * coef_layer,
                                   par_u + l * par_layer, n_cols, rows, tiles,
                                   n);
    for (int i = threadIdx.x; i < rows * tn; i += blockDim.x) {
      const int q = i % tn;
      const int t = q / n, k = q - t * n;
      const float2 u = work[i];
      if (kSaveStages) su[stage + i] = u;
      work[i] = cmul(u, gain_at(g, t, 8, k, p));
    }
    __syncthreads();
    // the row combine: row o sums its Ti tile outputs, in tile order
    const int out_w = to * n;
    for (int i = threadIdx.x; i < rows * out_w; i += blockDim.x) {
      const int r = i / out_w;
      const int q = i - r * out_w;
      const int o = q / n, k = q - o * n;
      const float2* z = work + r * tn + o * ti * n + k;
      float2 sum = z[0];
      for (int j = 1; j < ti; ++j) sum = cadd(sum, z[j * n]);
      rowbuf[r * row_w + q] = sum;
    }
    __syncthreads();
  }

  const int out_w = to * n;
  for (int i = threadIdx.x; i < rows * out_w; i += blockDim.x) {
    const int r = i / out_w;
    const float2 z = rowbuf[r * row_w + i - r * out_w];
    if (kDetectLast) {
      static_cast<float*>(out)[row0 * out_w + i] =
          sqrtf(z.x * z.x + z.y * z.y);
    } else {
      static_cast<float2*>(out)[row0 * out_w + i] = z;
    }
  }
}

inline size_t general_shared_bytes(int n, int to, int ti, int rows) {
  const int row_w = (to > ti ? to : ti) * n;
  return static_cast<size_t>(rows) * (row_w + to * ti * n) * sizeof(float2);
}

// ---------------------------------------------------------------------------
// launch plan and dispatch
// ---------------------------------------------------------------------------

struct Plan {
  int reg;      // 1: register path, 0: general path
  int rows;     // R, rows a block
  int blocks;
  int threads;
  int smem;     // dynamic shared bytes a block
  int kcap;     // staged columns a chunk (register path; 0 otherwise)
  int stages;   // chunk buffers in the ring (register path; 0 otherwise)
};

inline bool templated(int n) {
  return n == 2 || n == 4 || n == 8 || n == 16 || n == 32;
}

// SMs of the current device, read once per device.
inline int sm_count(int* sms) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && cached[dev] > 0) {
    *sms = cached[dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64) cached[dev] = *sms;
  return 0;
}

// The register path's R from the batch: enough rows a block that one block
// an SM covers it.  The general path keeps the rows 128 threads cover.
inline int make_plan(int batch, int n, int n_layers, int to, int ti,
                     int n_cols, bool save_stages, Plan* pl) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  const int tiles = to * ti;
  const int want = static_cast<int>((static_cast<long long>(batch) + sms - 1)
                                    / sms);
  if (templated(n) && tiles <= kRegThreads) {
    const size_t col_bytes = static_cast<size_t>(tiles) * 16 * n;
    int kcap = static_cast<int>(kChunkBytes / col_bytes);
    kcap = kcap < 1 ? 1 : (kcap > n_cols ? n_cols : kcap);
    const int n_chunks = 2 * n_layers * ((n_cols + kcap - 1) / kcap);
    int stages = static_cast<int>(kRingBytes
                                  / (col_bytes * kcap + 4 * tiles * kcap));
    stages = stages < 2 ? 2 : (stages > kMaxStages ? kMaxStages : stages);
    if (stages > n_chunks) stages = n_chunks;
    int rows = want < kRegThreads / tiles ? want : kRegThreads / tiles;
    rows = rows < 1 ? 1 : rows;
    auto bytes = [&] {
      return reg_shared_bytes(n, n_layers, to, ti, rows, kcap, stages,
                              save_stages);
    };
    while (stages > 2 && bytes() > kMaxShared) --stages;
    while (kcap > 1 && bytes() > kMaxShared) --kcap;
    while (rows > 1 && bytes() > kMaxShared) --rows;
    const size_t smem = bytes();
    if (smem <= kMaxShared) {
      // at least 128 threads: all of them stage and mark the chunks
      const int threads = (rows * tiles + 31) / 32 * 32;
      *pl = {1, rows, mesh_sweep::tile_count(batch, rows),
             threads < kThreads ? kThreads : threads, static_cast<int>(smem),
             kcap, stages};
      return 0;
    }
  }
  int rows = kThreads / (tiles * (n / 2));
  rows = rows < 1 ? 1 : rows;
  while (rows > 1 && general_shared_bytes(n, to, ti, rows) > kMaxShared) {
    --rows;
  }
  const size_t smem = general_shared_bytes(n, to, ti, rows);
  if (smem > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  *pl = {0, rows, mesh_sweep::tile_count(batch, rows), kThreads,
         static_cast<int>(smem), 0, 0};
  return 0;
}

template <typename Kernel>
int allow_shared(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <int N, bool kSaveStages, bool kDetectLast>
int launch_reg(const Plan& pl, const void* x, void* out, void* sv, void* su,
               const void* coef_v, const void* par_v, const void* coef_u,
               const void* par_u, const void* gains, int batch, int n_layers,
               int to, int ti, int n_cols, cudaStream_t stream) {
  auto kernel = deepgrid_reg_kernel<N, kSaveStages, kDetectLast>;
  const int err = allow_shared(kernel, pl.smem);
  if (err != 0) return err;
  kernel<<<pl.blocks, pl.threads, pl.smem, stream>>>(
      static_cast<const float2*>(x), out, static_cast<float2*>(sv),
      static_cast<float2*>(su), static_cast<const float*>(coef_v),
      static_cast<const int*>(par_v), static_cast<const float*>(coef_u),
      static_cast<const int*>(par_u), static_cast<const float*>(gains), batch,
      n_layers, to, ti, n_cols, pl.rows, pl.kcap, pl.stages);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSaveStages, bool kDetectLast>
int launch(const void* x, void* out, void* sv, void* su, const void* coef_v,
           const void* par_v, const void* coef_u, const void* par_u,
           const void* gains, int batch, int n, int n_layers, int to, int ti,
           int n_cols, void* stream) {
  Plan pl;
  const int err = make_plan(batch, n, n_layers, to, ti, n_cols, kSaveStages,
                            &pl);
  if (err != 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pl.reg) {
#define DEEPGRID_REG(NN)                                                      \
  case NN:                                                                    \
    return launch_reg<NN, kSaveStages, kDetectLast>(                          \
        pl, x, out, sv, su, coef_v, par_v, coef_u, par_u, gains, batch,       \
        n_layers, to, ti, n_cols, s);
    switch (n) {
      DEEPGRID_REG(2)
      DEEPGRID_REG(4)
      DEEPGRID_REG(8)
      DEEPGRID_REG(16)
      DEEPGRID_REG(32)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
#undef DEEPGRID_REG
  }
  auto kernel = deepgrid_general_kernel<kSaveStages, kDetectLast>;
  const int aerr = allow_shared(kernel, pl.smem);
  if (aerr != 0) return aerr;
  kernel<<<pl.blocks, pl.threads, pl.smem, s>>>(
      static_cast<const float2*>(x), out, static_cast<float2*>(sv),
      static_cast<float2*>(su), static_cast<const float*>(coef_v),
      static_cast<const int*>(par_v), static_cast<const float*>(coef_u),
      static_cast<const int*>(par_u), static_cast<const float*>(gains), batch,
      n, n_layers, to, ti, n_cols, pl.rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch plan of B6 (save_stages 0) or B7 for a batch and grid on the
// current device: plan[0..6] = (register path 1 / general 0, rows a block
// R, blocks, threads a block, dynamic shared bytes a block, staged columns
// a chunk, chunk buffers).  Returns 0, a CUDA error, or
// cudaErrorInvalidValue when no block of even one row fits.
extern "C" int deepgrid_fwd_plan(int batch, int n, int n_layers, int to,
                                 int ti, int n_cols, int save_stages,
                                 int* plan) {
  Plan pl;
  const int err = make_plan(batch, n, n_layers, to, ti, n_cols,
                            save_stages != 0, &pl);
  if (err != 0) return err;
  plan[0] = pl.reg;
  plan[1] = pl.rows;
  plan[2] = pl.blocks;
  plan[3] = pl.threads;
  plan[4] = pl.smem;
  plan[5] = pl.kcap;
  plan[6] = pl.stages;
  return 0;
}

// Plain C entry point (loaded with ctypes).  All pointers are device
// pointers; `stream` is a cudaStream_t.  `out` is float32 [B, To n] when
// detect_last, else complex64; `sv`/`su` (complex64 [L, B, To, Ti, n],
// 16-byte aligned) are written when save_stages (B7) and may be null
// otherwise (B6).  The caller guarantees batch > 0, even n >= 2, To == Ti
// when L > 1 and contiguous tensors.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue when a block of one row would not fit in shared
// memory.
extern "C" int deepgrid_fwd_launch(const void* x, void* out, void* sv,
                                   void* su, const void* coef_v,
                                   const void* par_v, const void* coef_u,
                                   const void* par_u, const void* gains,
                                   int batch, int n, int n_layers, int to,
                                   int ti, int n_cols, int save_stages,
                                   int detect_last, void* stream) {
  if (save_stages) {
    return detect_last
        ? launch<true, true>(x, out, sv, su, coef_v, par_v, coef_u, par_u,
                             gains, batch, n, n_layers, to, ti, n_cols, stream)
        : launch<true, false>(x, out, sv, su, coef_v, par_v, coef_u, par_u,
                              gains, batch, n, n_layers, to, ti, n_cols,
                              stream);
  }
  return detect_last
      ? launch<false, true>(x, out, sv, su, coef_v, par_v, coef_u, par_u,
                            gains, batch, n, n_layers, to, ti, n_cols, stream)
      : launch<false, false>(x, out, sv, su, coef_v, par_v, coef_u, par_u,
                             gains, batch, n, n_layers, to, ti, n_cols,
                             stream);
}
