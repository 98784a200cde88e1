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
// One template, four kernels:
//   kSaveStages = false  B6, replaces repro/kernels/givens_mesh.py:
//                        deepgrid_kernel (inference);
//   kSaveStages = true   B7, replaces givens_mesh.py: deepgrid_fwd_kernel
//                        (training forward; also writes every tile's post-V
//                        and post-U stage boundaries, complex64
//                        [L, B, To, Ti, n], both before their gain: the
//                        residuals of B8);
// each with either readout.
//
// Design: a block owns R rows, with all of a layer's To x Ti tiles in shared
// memory as float2[R][To Ti][n] and a row buffer float2[R][max(To, Ti) n]
// (the input tiles, then each layer's combined rows).  The threads map over
// (row, tile, pair slot), so all tiles of a layer sweep together with one
// barrier per column (mesh_sweep.cuh: grid_forward_sweep): 2 C barriers a
// layer, whatever the grid.  Each tile reads its own parity.  Coefficients
// stay in global memory through __ldg: at L = 4 with 4 x 4 tiles of 16 they
// take 0.5-0.9 MiB, far above the 227 KB a block may use.  Shared memory
// holds only the per-row state (3 KiB a row at 64 x 64), so R = 128 / (To Ti
// P) rows (at least 1) per block.  The layer boundary's |.| is taken in
// shared memory: activations between layers never reach device memory.
//
// Bound: per row and layer, 28 flops per pair and column of both meshes of
// every tile, against 8 Ti n bytes of input and 4 To n (or 8 To n) of
// output: operation-bound above a few tiles (64 x 64, L = 4, Clements:
// ~0.5 Mflop per row for ~0.8 KB).  At the MNIST depth-4 shape (n = 8, one
// tile) a launch is bound by its 4 x 16 barriers and launch latency.

#include "mesh_sweep.cuh"

namespace {

using mesh_sweep::cadd;
using mesh_sweep::cmul;
using mesh_sweep::gain_at;
using mesh_sweep::kThreads;

template <bool kSaveStages, bool kDetectLast>
__global__ void __launch_bounds__(kThreads)
deepgrid_fwd_kernel(const float2* __restrict__ x, void* __restrict__ out,
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

// Rows per block: 128 threads over the (tile, pair slot) items of a row.
inline int rows_per_block(int n, int tiles) {
  const int r = kThreads / (tiles * (n / 2));
  return r < 1 ? 1 : r;
}

inline size_t shared_bytes(int n, int to, int ti, int rows) {
  const int row_w = (to > ti ? to : ti) * n;
  return static_cast<size_t>(rows) * (row_w + to * ti * n) * sizeof(float2);
}

constexpr size_t kMaxShared = 232448;  // what a block may use on sm_90

template <bool kSaveStages, bool kDetectLast>
int launch(const void* x, void* out, void* sv, void* su, const void* coef_v,
           const void* par_v, const void* coef_u, const void* par_u,
           const void* gains, int batch, int n, int n_layers, int to, int ti,
           int n_cols, void* stream) {
  const int rows = rows_per_block(n, to * ti);
  const size_t smem = shared_bytes(n, to, ti, rows);
  if (smem > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = deepgrid_fwd_kernel<kSaveStages, kDetectLast>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<mesh_sweep::tile_count(batch, rows), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), out, static_cast<float2*>(sv),
      static_cast<float2*>(su), static_cast<const float*>(coef_v),
      static_cast<const int*>(par_v), static_cast<const float*>(coef_u),
      static_cast<const int*>(par_u), static_cast<const float*>(gains), batch,
      n, n_layers, to, ti, n_cols, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes).  All pointers are device
// pointers; `stream` is a cudaStream_t.  `out` is float32 [B, To n] when
// detect_last, else complex64; `sv`/`su` (complex64 [L, B, To, Ti, n]) are
// written when save_stages (B7) and may be null otherwise (B6).  The caller
// guarantees batch > 0, even n >= 2, To == Ti when L > 1 and contiguous
// tensors.  Returns cudaGetLastError(), or cudaErrorInvalidValue when a
// block's rows would not fit in shared memory.
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
