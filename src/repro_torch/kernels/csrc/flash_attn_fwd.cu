// Kernel B9: forward softmax attention with an online softmax (flash
// attention), o = softmax(q k^T / sqrt(hd)) v, causal or not, for q
// [BH, Sq, hd] and k, v [BH, Skv, hd] (KV heads already expanded to H, the
// batch and head axes flattened), float32 or bfloat16 in and out.  Replaces
// the JAX package's Pallas TPU kernel repro/kernels/flash_attention.py:
// _kernel (its pl.pallas_call).
//
// The math is the TPU kernel's, in float32 whatever the input type: scores
// s = (q . k) * scale, masked scores (causal, key > query) set to -1e30, a
// running row max m and row sum l, p = exp(s - m_new) kept in float32 into
// the PV product, the accumulator rescaled by exp(m - m_new), and the finish
// acc / max(l, 1e-30) rounded once to the output type.
//
// Design (a first version that is simple and right; tensor cores, wgmma and
// TMA are later work): one block of 8 warps owns a 64-row query tile of one
// (batch, head); each warp owns 8 query rows and keeps their m, l and
// accumulators in registers, the head dims spread over the lanes (lane d
// holds dims d, d + 32, ...).  The query tile and each key/value tile are
// staged in shared memory as float32 (the key tile with an odd row stride,
// so lanes reading one dim of 32 different keys hit 32 banks).  Per key
// tile a warp computes its 8 rows' scores with the keys spread over the
// lanes (every key load serves 8 rows), takes the row max and sum with warp
// shuffles, writes p to a per-warp buffer and accumulates p v with the dims
// over the lanes.  In causal mode the key tiles strictly above the tile's
// last query row are never visited and the tile on the diagonal is masked
// per element.  The TPU kernel's bq/bk were its own tiling; this kernel's
// tiles are 64 query rows by 64 keys (hd <= 64) or 32 keys (hd > 64, to keep
// shared memory at 139 KB for hd = 256).
//
// Bound: 4 BH Sq Skv hd flops (half of it causal) against reading q, k, v
// and writing o once.  At TinyLlama's prefill (BH = 256, S = 1024, hd = 64,
// bf16) the bytes (134 MB, 0.040 ms at 3.35 TB/s) and the flops (34 GFLOP,
// 0.035 ms at the tensor cores' 989 TFLOP/s) are close; this kernel runs its
// flops as float32 FMAs on the CUDA cores with an operand from shared memory
// each, so shared-memory bandwidth, not HBM, sets its time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr float kMasked = -1e30f;               // the TPU kernel's NEG_INF

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared floats of one block: the query tile, the key tile (odd row
// stride), the value tile and the per-warp p buffers.
__host__ __device__ inline int smem_floats(int hd, int block_k) {
  return kBlockQ * hd + block_k * (hd | 1) + block_k * hd +
         kWarps * kRowsPerWarp * block_k;
}

// kSlots = ceil(hd / 32) head dims per lane; kKeys keys per lane in a tile.
template <typename T, int kSlots, int kKeys>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int seq_q,
                      int seq_kv, int hd, int causal, float scale) {
  constexpr int kBlockK = 32 * kKeys;
  extern __shared__ float smem[];
  const int ks = hd | 1;
  float* qs = smem;                   // [kBlockQ][hd]
  float* kt = qs + kBlockQ * hd;      // [kBlockK][ks]
  float* vt = kt + kBlockK * ks;      // [kBlockK][hd]
  float* pb = vt + kBlockK * hd;      // [kWarps][kRowsPerWarp][kBlockK]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q_base = static_cast<long long>(blockIdx.x) * seq_q * hd;
  const long long kv_base = static_cast<long long>(blockIdx.x) * seq_kv * hd;
  const int q0 = blockIdx.y * kBlockQ;
  const int q_rows = min(kBlockQ, seq_q - q0);
  const int row0 = warp * kRowsPerWarp;  // this warp's rows in the tile
  float* pw = pb + warp * kRowsPerWarp * kBlockK;

  for (int i = threadIdx.x; i < kBlockQ * hd; i += kThreads) {
    qs[i] = i < q_rows * hd
                ? load_f32(q + q_base + static_cast<long long>(q0) * hd + i)
                : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kSlots];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < kSlots; ++t) acc[r][t] = 0.f;
  }

  // causal: keys past the tile's last query row are masked for every row
  const int kv_end = causal ? min(seq_kv, q0 + q_rows) : seq_kv;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    const int k_rows = min(kBlockK, seq_kv - k0);
    __syncthreads();  // the last tile's readers are done; Q is in place
    for (int i = threadIdx.x; i < kBlockK * hd; i += kThreads) {
      const int j = i / hd;
      const int d = i - j * hd;
      float kv = 0.f, vv = 0.f;
      if (j < k_rows) {
        const long long g = kv_base + static_cast<long long>(k0 + j) * hd + d;
        kv = load_f32(k + g);
        vv = load_f32(v + g);
      }
      kt[j * ks + d] = kv;
      vt[i] = vv;
    }
    __syncthreads();

    float s[kRowsPerWarp][kKeys];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kKeys; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float kd[kKeys];
#pragma unroll
      for (int c = 0; c < kKeys; ++c) kd[c] = kt[(lane + 32 * c) * ks + d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float qd = qs[(row0 + r) * hd + d];
#pragma unroll
        for (int c = 0; c < kKeys; ++c) s[r][c] = fmaf(qd, kd[c], s[r][c]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int q_pos = q0 + row0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const int key = k0 + lane + 32 * c;
        float x;
        if (key >= seq_kv) {
          x = -INFINITY;  // no such key: contributes exactly nothing
        } else if (causal && key > q_pos) {
          x = kMasked;
        } else {
          x = s[r][c] * scale;
        }
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[r], warp_max(mx));
      const float corr = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const float p = expf(s[r][c] - m_new);
        pw[r * kBlockK + lane + 32 * c] = p;
        psum += p;
      }
      l[r] = l[r] * corr + warp_sum(psum);
      m[r] = m_new;
#pragma unroll
      for (int t = 0; t < kSlots; ++t) acc[r][t] *= corr;
    }
    __syncwarp();
    for (int j = 0; j < k_rows; ++j) {
      float vj[kSlots];
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        const int d = lane + 32 * t;
        vj[t] = d < hd ? vt[j * hd + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float p = pw[r * kBlockK + j];
#pragma unroll
        for (int t = 0; t < kSlots; ++t) acc[r][t] = fmaf(p, vj[t], acc[r][t]);
      }
    }
    __syncwarp();  // p is read before the next tile overwrites it
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int q_pos = q0 + row0 + r;
    if (q_pos >= seq_q) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* out = o + q_base + static_cast<long long>(q_pos) * hd;
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int d = lane + 32 * t;
      if (d < hd) store_from_f32(out + d, acc[r][t] / denom);
    }
  }
}

template <typename T, int kSlots>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int seq_q, int seq_kv, int hd, int causal, void* stream) {
  constexpr int kKeys = kSlots <= 2 ? 2 : 1;
  auto kernel = flash_attn_fwd_kernel<T, kSlots, kKeys>;
  const size_t smem = sizeof(float) * smem_floats(hd, 32 * kKeys);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  dim3 grid(bh, (seq_q + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seq_q, seq_kv, hd, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* o, int bh,
                 int seq_q, int seq_kv, int hd, int causal, void* stream) {
  switch ((hd + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, o, bh, seq_q, seq_kv, hd, causal, stream);
    case 2: return launch<T, 2>(q, k, v, o, bh, seq_q, seq_kv, hd, causal, stream);
    case 3: return launch<T, 3>(q, k, v, o, bh, seq_q, seq_kv, hd, causal, stream);
    case 4: return launch<T, 4>(q, k, v, o, bh, seq_q, seq_kv, hd, causal, stream);
    case 5: return launch<T, 5>(q, k, v, o, bh, seq_q, seq_kv, hd, causal, stream);
    case 6: return launch<T, 6>(q, k, v, o, bh, seq_q, seq_kv, hd, causal, stream);
    case 7: return launch<T, 7>(q, k, v, o, bh, seq_q, seq_kv, hd, causal, stream);
    case 8: return launch<T, 8>(q, k, v, o, bh, seq_q, seq_kv, hd, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  All pointers are device
// pointers to contiguous tensors; `stream` is a cudaStream_t.  q and o are
// [bh, seq_q, hd], k and v [bh, seq_kv, hd], all float32 (bf16 = 0) or all
// bfloat16 (bf16 = 1).  The caller guarantees bh, seq_q, seq_kv > 0,
// seq_q <= 65535 * 64 and 1 <= hd <= 256.  Returns cudaGetLastError() (or
// the error of raising the kernel's shared-memory limit).
extern "C" int flash_attn_fwd_launch(const void* q, const void* k,
                                     const void* v, void* o, int bh,
                                     int seq_q, int seq_kv, int hd,
                                     int causal, int bf16, void* stream) {
  if (hd < 1 || hd > 256) return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? launch_typed<__nv_bfloat16>(q, k, v, o, bh, seq_q, seq_kv, hd,
                                            causal, stream)
              : launch_typed<float>(q, k, v, o, bh, seq_q, seq_kv, hd, causal,
                                    stream);
}
