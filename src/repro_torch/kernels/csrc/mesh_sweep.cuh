// Device code shared by the mesh kernels: the forward column sweep, the
// reversed sweep of the VJP (per-cell inverse, adjoint and coefficient
// gradient terms), the row sums of a tile's gradient terms and the
// block-order reduce of per-block gradient slices.
//
// Included by mesh_fwd.cu (B1), mesh_bwd.cu (B2), rfnn_fwd.cu (B3, B4) and
// rfnn_bwd.cu (B5).  cuda_build.py hashes every header under csrc/ into each
// library's file name, so an edit here rebuilds all four libraries.
//
// Layouts (see mesh_fwd.cu): a block owns a tile of `rows` batch rows of n
// complex channels, float2[rows][n] in shared memory.  Coefficients are
// float32 [C, 8, P] (t00, t01, t10, t11) x (re, im) per pair slot, P = n / 2;
// parity[c] = 0 pairs (2s, 2s+1), 1 pairs (2s+1, 2s+2) for s < P - 1.
// Coefficients are read from global memory through __ldg and never staged:
// a Reck program has ~2n columns, and all columns of an n = 128 mesh would
// already take 256 KiB, above the 227 KiB a block may use.

#pragma once

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
      const float2 a = row[top];
      const float2 b = row[top + 1];
      const float t00r = __ldg(cc + 0 * p + s), t00i = __ldg(cc + 1 * p + s);
      const float t01r = __ldg(cc + 2 * p + s), t01i = __ldg(cc + 3 * p + s);
      const float t10r = __ldg(cc + 4 * p + s), t10i = __ldg(cc + 5 * p + s);
      const float t11r = __ldg(cc + 6 * p + s), t11i = __ldg(cc + 7 * p + s);
      float2 a2, b2;
      a2.x = t00r * a.x - t00i * a.y + t01r * b.x - t01i * b.y;
      a2.y = t00r * a.y + t00i * a.x + t01r * b.y + t01i * b.x;
      b2.x = t10r * a.x - t10i * a.y + t11r * b.x - t11i * b.y;
      b2.y = t10r * a.y + t10i * a.x + t11r * b.y + t11i * b.x;
      row[top] = a2;
      row[top + 1] = b2;
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

// The reversed sweep of columns n_cols-1 .. 0 (the VJP of forward_sweep).
// On entry `st` holds the sweep's output state and `gt` the cotangent at it;
// on exit `st` holds the input state and `gt` the cotangent at the input.
// Per column: each cell's analytic inverse adj(t)/det(t) (|det|^2 floored at
// 1e-12) rebuilds the column's input, the four conjugate products give the
// coefficient gradient terms (rows (00, 01, 10, 11) x (re, im) of
// conj(input) (x) cotangent), and the adjoint t^H carries the cotangent
// back.  The terms are summed over rows into part[c, 8, P] (store when
// `first`, else add).  The wrap slot of a parity-1 column holds no cell: its
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

      const int top = r * n + 2 * s + par;  // the pair (top, top + 1)
      const float2 a = st[top], b = st[top + 1];
      const float2 ga = gt[top], gb = gt[top + 1];
      const float2 a_in = cadd(cmul(i00, a), cmul(i01, b));
      const float2 b_in = cadd(cmul(i10, a), cmul(i11, b));

      float* tr = terms + r * m;
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

      st[top] = a_in;
      st[top + 1] = b_in;
      gt[top] = cadd(cmulc(t00, ga), cmulc(t10, gb));      // (t^H g)_a
      gt[top + 1] = cadd(cmulc(t01, ga), cmulc(t11, gb));  // (t^H g)_b
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

// The block count of a gradient sweep: the batch's row tiles, capped at one
// wave of resident blocks of `kernel` on the current device, so the count
// (and with it the summation order) depends only on B, n and the card.
// Returns -(CUDA error) on failure.
template <typename Kernel>
int wave_blocks(Kernel kernel, int tiles, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         kThreads, smem);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int wave = sms * per_sm > 0 ? sms * per_sm : 1;
  return tiles < wave ? tiles : wave;
}

}  // namespace
}  // namespace mesh_sweep
