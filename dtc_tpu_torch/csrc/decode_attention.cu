// Single-query decode attention over the packed KV cache, for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernels dtc_tpu/ops/decode_attention.py
// _decode_kernel_single (caches up to 4096 positions in one tile) and
// _decode_kernel_blocked (longer caches in 512-wide blocks): one kernel, any
// cache length.
//
// What it computes, per (batch row b, head h): the new token's query q
// (B, 1, H*D) against the cache k, v (B, S, H*D) up to the write frontier,
// columns 0 .. min(start, S-1), where start is one int32 for the batch or one
// per row. q is scaled by D^-0.5 in q's dtype; k and v are brought to q's dtype
// (an int8 cache is dequantized in registers with its (B, S, H) fp32 scales
// first); scores are fp32; the softmax is online over chunks of kChunk
// positions whose scores sit in shared memory, so any S works and a cache of
// up to kChunk positions is one exact one-pass softmax; p is cast to q's dtype
// before the fp32-accumulated P*V sum; the result is cast to q's dtype.
//
// Its bound is memory bytes: it reads each K and V row up to the frontier
// once, with 16-byte loads, and nothing past it (the TPU kernel copied the
// whole cache in). At the flagship shape (B 4, S 512, H 16, D 32, bf16) one
// layer's call at a full frontier reads K + V = 4 * 512 * 512 * 2 B * 2 =
// 2,097,152 B, about 0.63 us at 3.35 TB/s. What holds it back is latency, not
// bytes and not the launch: one block per (b, h) gives 64 blocks of 4 warps on
// 132 SMs; each 4-thread group has one position's 16-byte load in flight per
// pass, and every chunk ends in two block-wide reductions. So the body runs
// about ten times its byte bound (PERF.md). More positions in flight per
// thread and a split of S across blocks (flash-decoding) are later work.
//
// Plain C interface (ctypes): dtc_decode_attention launches on the given
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4096;

// dtype codes shared with the wrapper: 0 float32, 1 bfloat16, 2 int8.
template <int C> struct Size;
template <> struct Size<0> { static constexpr int value = 4; };
template <> struct Size<1> { static constexpr int value = 2; };
template <> struct Size<2> { static constexpr int value = 1; };

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

// Round to q's dtype and back (identity for float32).
template <int QC> __device__ __forceinline__ float round_q(float x);
template <> __device__ __forceinline__ float round_q<0>(float x) { return x; }
template <> __device__ __forceinline__ float round_q<1>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int QC> __device__ __forceinline__ float load_q(const void* p, size_t i);
template <> __device__ __forceinline__ float load_q<0>(const void* p, size_t i) {
  return static_cast<const float*>(p)[i];
}
template <> __device__ __forceinline__ float load_q<1>(const void* p, size_t i) {
  return bf16_bits_to_float(static_cast<const uint16_t*>(p)[i]);
}

template <int QC> __device__ __forceinline__ void store_q(void* p, size_t i, float x);
template <> __device__ __forceinline__ void store_q<0>(void* p, size_t i, float x) {
  static_cast<float*>(p)[i] = x;
}
template <> __device__ __forceinline__ void store_q<1>(void* p, size_t i, float x) {
  static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
}

// 16 bytes of cache elements -> floats (4 float32, 8 bfloat16 or 16 int8).
template <int KC> __device__ __forceinline__ void unpack(uint4 u, float* out);
template <> __device__ __forceinline__ void unpack<0>(uint4 u, float* out) {
  out[0] = __uint_as_float(u.x); out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z); out[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack<1>(uint4 u, float* out) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <> __device__ __forceinline__ void unpack<2>(uint4 u, float* out) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[4 * i + j] = static_cast<float>(static_cast<int>(w[i] << (24 - 8 * j)) >> 24);
    }
  }
}

__device__ __forceinline__ float block_max(float v, float* s_red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = s_red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, s_red[w]);
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* s_red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = s_red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r += s_red[w];
  return r;
}

// One block per (head, batch row). A group of TPG consecutive threads owns one
// cache position at a time; each thread of the group holds N = 16 / sizeof(KT)
// of the head's D elements (one 16-byte load).
template <int QC, int KC, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const void* __restrict__ q, const void* __restrict__ k,
                        const void* __restrict__ v, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, const int* __restrict__ start,
                        void* __restrict__ out, int S, int H, int per_row, float scale) {
  constexpr int KSIZE = Size<KC>::value;
  constexpr int N = 16 / KSIZE;
  constexpr int TPG = D / N;
  constexpr int G = kThreads / TPG;
  static_assert(D % N == 0 && TPG >= 1 && TPG <= 32, "unsupported head_dim");

  __shared__ float s_scores[kChunk];
  __shared__ float s_red[kWarps];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int g = tid / TPG;     // position group
  const int lane = tid % TPG;  // which N elements of the head
  const int HD = H * D;

  int n = (per_row ? start[b] : start[0]) + 1;  // visible columns
  n = n > S ? S : (n < 1 ? 1 : n);

  // q scaled in q's dtype, this thread's N elements.
  float qs[N];
  const size_t q_off = static_cast<size_t>(b) * HD + static_cast<size_t>(h) * D + lane * N;
#pragma unroll
  for (int i = 0; i < N; ++i) qs[i] = round_q<QC>(load_q<QC>(q, q_off + i) * scale);

  const char* kb = static_cast<const char*>(k);
  const char* vb = static_cast<const char*>(v);
  const size_t row0 = static_cast<size_t>(b) * S;

  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  float m_run = -INFINITY;
  float l_run = 0.f;
  float e[N];

  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int cn = min(kChunk, n - c0);

    // Scores for this chunk. The loop bound is the same for every thread so
    // the group shuffles below always run converged.
    float local_max = -INFINITY;
    for (int j0 = 0; j0 < cn; j0 += G) {
      const int j = j0 + g;
      const bool valid = j < cn;
      float part = 0.f;
      if (valid) {
        const size_t row = row0 + c0 + j;
        const size_t off = (row * HD + static_cast<size_t>(h) * D + lane * N) * KSIZE;
        unpack<KC>(__ldg(reinterpret_cast<const uint4*>(kb + off)), e);
        const float ks = KC == 2 ? k_scale[row * H + h] : 1.f;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float kv = round_q<QC>(KC == 2 ? e[i] * ks : e[i]);
          part = fmaf(qs[i], kv, part);
        }
      }
#pragma unroll
      for (int o = TPG / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (valid) {
        if (lane == 0) s_scores[j] = part;
        local_max = fmaxf(local_max, part);
      }
    }
    const float m_new = fmaxf(m_run, block_max(local_max, s_red));
    const float alpha = expf(m_run - m_new);

    float local_sum = 0.f;
    for (int j = tid; j < cn; j += kThreads) {
      const float p = expf(s_scores[j] - m_new);
      s_scores[j] = p;
      local_sum += p;
    }
    l_run = l_run * alpha + block_sum(local_sum, s_red);  // syncs: p visible

#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] *= alpha;
    for (int j = g; j < cn; j += G) {
      const float p = round_q<QC>(s_scores[j]);  // p in v's (= q's) dtype
      const size_t row = row0 + c0 + j;
      const size_t off = (row * HD + static_cast<size_t>(h) * D + lane * N) * KSIZE;
      unpack<KC>(__ldg(reinterpret_cast<const uint4*>(vb + off)), e);
      const float vs = KC == 2 ? v_scale[row * H + h] : 1.f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        acc[i] = fmaf(p, round_q<QC>(KC == 2 ? e[i] * vs : e[i]), acc[i]);
      }
    }
    m_run = m_new;
    __syncthreads();  // the next chunk overwrites s_scores
  }

  // Sum the groups' partial outputs (s_scores is free now: G * D <= kChunk).
#pragma unroll
  for (int i = 0; i < N; ++i) s_scores[g * D + lane * N + i] = acc[i];
  __syncthreads();
  const size_t o_off = static_cast<size_t>(b) * HD + static_cast<size_t>(h) * D;
  for (int d = tid; d < D; d += kThreads) {
    float sum = 0.f;
    for (int gg = 0; gg < G; ++gg) sum += s_scores[gg * D + d];
    store_q<QC>(out, o_off + d, sum / l_run);
  }
}

template <int QC, int KC, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int* start, void* out, int B, int S, int H,
                   int per_row, float scale, cudaStream_t stream) {
  decode_attention_kernel<QC, KC, D><<<dim3(H, B), kThreads, 0, stream>>>(
      q, k, v, ks, vs, start, out, S, H, per_row, scale);
  return cudaGetLastError();
}

template <int QC, int KC>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const float* ks,
                     const float* vs, const int* start, void* out, int B, int S, int H,
                     int per_row, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<QC, KC, 16>(q, k, v, ks, vs, start, out, B, S, H, per_row, scale, stream);
    case 32: return launch<QC, KC, 32>(q, k, v, ks, vs, start, out, B, S, H, per_row, scale, stream);
    case 64: return launch<QC, KC, 64>(q, k, v, ks, vs, start, out, B, S, H, per_row, scale, stream);
    case 128: return launch<QC, KC, 128>(q, k, v, ks, vs, start, out, B, S, H, per_row, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int dtc_decode_attention(const void* q, const void* k, const void* v,
                                    const float* k_scale, const float* v_scale,
                                    const int* start, void* out, int B, int S, int H,
                                    int D, int per_row, float scale, int q_dtype,
                                    int kv_dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype * 3 + kv_dtype) {
    case 0: return launch_d<0, 0>(D, q, k, v, k_scale, v_scale, start, out, B, S, H, per_row, scale, st);
    case 1: return launch_d<0, 1>(D, q, k, v, k_scale, v_scale, start, out, B, S, H, per_row, scale, st);
    case 2: return launch_d<0, 2>(D, q, k, v, k_scale, v_scale, start, out, B, S, H, per_row, scale, st);
    case 3: return launch_d<1, 0>(D, q, k, v, k_scale, v_scale, start, out, B, S, H, per_row, scale, st);
    case 4: return launch_d<1, 1>(D, q, k, v, k_scale, v_scale, start, out, B, S, H, per_row, scale, st);
    case 5: return launch_d<1, 2>(D, q, k, v, k_scale, v_scale, start, out, B, S, H, per_row, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* dtc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
