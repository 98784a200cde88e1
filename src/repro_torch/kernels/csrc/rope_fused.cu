// A2: the rotary position embedding of the port's attention
// (models/layers.py rope_qk) on q and k in one launch.  It replaces no TPU
// kernel: the JAX package's RoPE (repro/models/layers.py apply_rope) is
// plain jnp, whose elementwise chain XLA fuses by itself.  In PyTorch's eager
// mode the same chain was 29 float32 launches an attention call (the angle
// table rebuilt in every layer, two float32 casts, four products, a
// subtraction, an addition, a cat and a cast back for each of q and k), so
// this kernel was added to do it in one.
//
// Bound: device memory.  q [B, S, Hq, hd] and k [B, S, Hkv, hd] are read
// once and q', k' written once: 2 (Hq + Hkv) hd x the dtype's bytes a token.
// The angle table costs nothing in bytes: positions (4 B a token) and
// inv_freq (hd / 2 floats) are read, never a cos/sin table.  At granite-3-2b
// (32 + 8 heads of 64, bf16) that is 10,240 B a token, 98.6 us for a batch
// of 8 x 4032 tokens at 3.35 TB/s.  The design moves each byte once:
//
//   rope_kernel   one block takes rows_per_block token rows (b, s).  First
//                 its threads compute, for each row and i < hd / 2, the
//                 angle pos x inv_freq[i] and its cosf / sinf once, into
//                 shared memory; then each thread takes VEC consecutive
//                 elements of one head's first half and the matching VEC of
//                 its second half (two 16-byte loads and two 16-byte stores
//                 when both tensors are aligned and VEC divides hd / 2, one
//                 element otherwise), over all Hq + Hkv heads of the rows.
//                 Neighbouring threads take neighbouring vectors, so a warp
//                 reads whole 32-byte sectors.  The host code below takes
//                 as rows_per_block the fewest rows whose work is a whole
//                 number of rounds of the block.
//
// Arithmetic: the plain version's (models/layers.py rope_frequencies and
// apply_rope) in its order, each operation with a round-to-nearest intrinsic
// so nvcc contracts nothing into an FMA that PyTorch's separate kernels do
// not have: ang = float(pos) * inv_freq[i]; c = cosf(ang), s = sinf(ang)
// (what torch.cos / torch.sin call on the card); x1 c - x2 s and x2 c + x1 s
// in float32, rounded once to the input's dtype (round to nearest even, as
// Tensor.to).  The backward (the vector-Jacobian product) is the same
// kernel with s negated: g1 c + g2 s and g2 c - g1 s, which is what autograd
// computes through the plain version, bit for bit.  Positions are int32,
// read through a batch and a sequence stride (0 for the batch of a [S]
// vector).  The kernel allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;
constexpr int kThreads = 256;          // threads a block, every launch
constexpr int kMaxRows = 32;           // token rows a block at most
constexpr int kMaxShared = 48 * 1024;  // bytes of the angle table at most

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(f16 x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ f16 from_f<f16>(float x) {
  return __float2half_rn(x);
}

// VEC elements of T moved as one load or store (16 bytes when VEC x
// sizeof(T) is 16).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    rope_kernel(const T* __restrict__ q, const T* __restrict__ k,
                T* __restrict__ q_out, T* __restrict__ k_out,
                const int* __restrict__ pos, int64_t pos_sb, int64_t pos_ss,
                const float* __restrict__ inv_freq, int64_t n_rows, int seq,
                int hq, int hkv, int half, int rows_per_block, int negate) {
  extern __shared__ float table[];  // cos, then sin: [rows_per_block][half]
  float* cos_t = table;
  float* sin_t = table + rows_per_block * half;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int rows = static_cast<int>(
      n_rows - row0 < rows_per_block ? n_rows - row0 : rows_per_block);

  for (int t = threadIdx.x; t < rows * half; t += kThreads) {
    const int r = t / half, i = t - r * half;
    const int64_t row = row0 + r;
    const int64_t b = row / seq, s = row - b * seq;
    const float p = __int2float_rn(pos[b * pos_sb + s * pos_ss]);
    const float ang = __fmul_rn(p, inv_freq[i]);
    const float sn = sinf(ang);
    cos_t[t] = cosf(ang);
    sin_t[t] = negate ? -sn : sn;
  }
  __syncthreads();

  const int per_head = half / VEC;
  const int per_row = (hq + hkv) * per_head;
  const int64_t hd = 2 * half;
  for (int t = threadIdx.x; t < rows * per_row; t += kThreads) {
    const int r = t / per_row;
    const int rem = t - r * per_row;
    const int h = rem / per_head;
    const int j = (rem - h * per_head) * VEC;
    const int64_t row = row0 + r;
    const T* src;
    T* dst;
    if (h < hq) {
      const int64_t off = (row * hq + h) * hd;
      src = q + off;
      dst = q_out + off;
    } else {
      const int64_t off = (row * hkv + (h - hq)) * hd;
      src = k + off;
      dst = k_out + off;
    }
    const Pack<T, VEC> a = *reinterpret_cast<const Pack<T, VEC>*>(src + j);
    const Pack<T, VEC> b =
        *reinterpret_cast<const Pack<T, VEC>*>(src + half + j);
    const float* c = cos_t + r * half + j;
    const float* s = sin_t + r * half + j;
    Pack<T, VEC> o1, o2;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float x1 = to_f(a.v[e]), x2 = to_f(b.v[e]);
      o1.v[e] = from_f<T>(__fsub_rn(__fmul_rn(x1, c[e]), __fmul_rn(x2, s[e])));
      o2.v[e] = from_f<T>(__fadd_rn(__fmul_rn(x2, c[e]), __fmul_rn(x1, s[e])));
    }
    *reinterpret_cast<Pack<T, VEC>*>(dst + j) = o1;
    *reinterpret_cast<Pack<T, VEC>*>(dst + half + j) = o2;
  }
}

struct Call {
  const void *q, *k;
  void *q_out, *k_out;
  const int* pos;
  int64_t pos_sb, pos_ss;
  const float* inv_freq;
  int64_t n_rows;
  int seq, hq, hkv, half, negate;
  cudaStream_t stream;
};

bool aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// Token rows a block: the fewest whose per_row work items fill whole rounds
// of kThreads, at most kMaxRows and as many as kMaxShared holds of the
// angle table (8 bytes a row and an angle).
int rows_per_block(int per_row, int half) {
  int a = per_row, b = kThreads;
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  int rows = kThreads / a;
  if (rows > kMaxRows) rows = kMaxRows;
  if (rows > kMaxShared / (8 * half)) rows = kMaxShared / (8 * half);
  return rows < 1 ? 1 : rows;
}

template <typename T>
int run(const Call& c) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = c.half % kVec == 0 && aligned(c.q) && aligned(c.k) &&
                   aligned(c.q_out) && aligned(c.k_out);
  const int rows =
      rows_per_block((c.hq + c.hkv) * (vec ? c.half / kVec : c.half), c.half);
  const int64_t blocks = (c.n_rows + rows - 1) / rows;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = 2 * sizeof(float) * rows * c.half;
  if (vec)
    rope_kernel<T, kVec><<<blocks, kThreads, shared, c.stream>>>(
        static_cast<const T*>(c.q), static_cast<const T*>(c.k),
        static_cast<T*>(c.q_out), static_cast<T*>(c.k_out), c.pos, c.pos_sb,
        c.pos_ss, c.inv_freq, c.n_rows, c.seq, c.hq, c.hkv, c.half, rows,
        c.negate);
  else
    rope_kernel<T, 1><<<blocks, kThreads, shared, c.stream>>>(
        static_cast<const T*>(c.q), static_cast<const T*>(c.k),
        static_cast<T*>(c.q_out), static_cast<T*>(c.k_out), c.pos, c.pos_sb,
        c.pos_ss, c.inv_freq, c.n_rows, c.seq, c.hq, c.hkv, c.half, rows,
        c.negate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q' and k' for n_rows = B x S token rows of q [B, S, hq, head_dim] and
// k [B, S, hkv, head_dim], both contiguous; row b x seq + s takes the
// position pos[b pos_sb + s pos_ss].  dtype: 0 float32, 1 bfloat16, 2
// float16.  negate != 0 runs the backward (sin negated).  Returns
// cudaErrorInvalidValue, launching nothing, on shapes the kernel does not
// take (an odd head_dim, or one whose angle table for a single row exceeds
// kMaxShared), else the launch's cudaGetLastError.
int rope_launch(const void* q, const void* k, void* q_out, void* k_out,
                const int* pos, long long pos_sb, long long pos_ss,
                const float* inv_freq, long long n_rows, int seq, int hq,
                int hkv, int head_dim, int dtype, int negate, void* stream) {
  if (n_rows < 1 || seq < 1 || hq < 0 || hkv < 0 || hq + hkv < 1 ||
      head_dim < 2 || head_dim % 2 != 0 || 4 * head_dim > kMaxShared)
    return static_cast<int>(cudaErrorInvalidValue);
  Call c;
  c.q = q;
  c.k = k;
  c.q_out = q_out;
  c.k_out = k_out;
  c.pos = pos;
  c.pos_sb = pos_sb;
  c.pos_ss = pos_ss;
  c.inv_freq = inv_freq;
  c.n_rows = n_rows;
  c.seq = seq;
  c.hq = hq;
  c.hkv = hkv;
  c.half = head_dim / 2;
  c.negate = negate;
  c.stream = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return run<float>(c);
    case 1: return run<bf16>(c);
    case 2: return run<f16>(c);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
