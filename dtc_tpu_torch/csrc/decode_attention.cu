// Single-query decode attention over the packed KV cache, for Hopper (sm_90a):
// a split-KV (flash-decoding) kernel.
//
// Replaces the JAX package's TPU kernels dtc_tpu/ops/decode_attention.py
// _decode_kernel_single (caches up to 4096 positions in one tile) and
// _decode_kernel_blocked (longer caches in 512-wide blocks): one split
// kernel (and, past one split, a small combine kernel) for any cache length,
// head dims 16 to 128 in steps of 16 (the flash kernels' set).
//
// What it computes, per (batch row b, head h): the new token's query q
// (B, 1, H*D) against the cache k, v (B, S, H*D) up to the write frontier,
// columns 0 .. n-1 with n = clamp(start + 1, 1, S), where start is one int32
// for the batch or one per row (an idle slot past the cache sees every
// column, a negative frontier column 0). q is scaled by D^-0.5 in q's dtype;
// k and v are brought to q's dtype (an int8 cache is dequantized in registers
// with its (B, S, H) fp32 scales first); scores are fp32; p is cast to q's
// dtype before the fp32-accumulated P*V sum; the result is cast to q's dtype.
//
// The schedule. A row's visible columns are cut into splits of kSplit
// positions, a compile-time constant of the instance (Geometry: 256 at bf16
// D 32, 128 at bf16 D 48 and 64, 64 at bf16 D 80 to 128), so the split
// boundaries depend on position alone: never on B, on the other rows'
// frontiers or on the SM count. One block of 256 threads per (split, head,
// row); a split past its row's frontier exits before any load. In a block a
// group of TPG threads holds one position's head row, one 16-byte chunk a
// thread. A row of 3, 5, 6, 7, 10, 12, 14, 20, 24 or 28 chunks (D 48 to 112
// in some dtypes) leaves the group's last lanes idle; they load nothing and
// take part in every shuffle with zeros, so the shuffles stay converged.
//
// Its bound is memory bytes: each K and V row up to the frontier is read
// once, nothing past it. At the flagship (B 4, S 512, H 16, D 32, bf16) a
// layer's call at a full frontier reads K + V = 4 * 512 * 512 * 2 B * 2 =
// 2,097,152 B, about 0.63 us at 3.35 TB/s: a call that small is latency,
// one DRAM round trip and the launch. So every thread issues all its K and
// V loads of the split (4 + 4 16-byte loads, 32 KB a block) before it uses
// any, in one sweep over K and V, and the splits give the card one block
// per split of every (row, head): 96 live blocks at the flagship's
// frontiers [0, 37, 511, 600] (the earlier design had 64 blocks with one
// 16-byte load a thread in flight), 1,104 at S 8192.
//
// In a split, scores are summed over the group with shuffles; the split's
// max takes one block-wide reduction; p = exp(s - max) is rounded to q's
// dtype against the split's max; l and the P*V sums are reduced over the
// block in a fixed order. A row with one split writes its output there.
// Otherwise each split writes float32 partials (max, sum, acc[D]) to a
// scratch the wrapper allocates for the call, and a second, small kernel
// (decode_combine_kernel, a block per (head, row)) combines them in split
// order: weights exp(m_j - M) in float32, sums in j order. The bits
// therefore never depend on the order the blocks ran in: two launches give
// the same bits, and a row's output does not change with the rows around
// it. Nothing outlives a call (no counters, no atomics), so calls on any
// streams, a graph replayed on any stream among them, stand alone. The
// combine is a programmatic dependent launch: its blocks are scheduled while
// the split kernel runs and wait (griddepcontrol.wait) for all of its
// partials, so the second launch costs less than a launch in sequence. A
// call whose cache holds one split launches the split kernel alone.
//
// Rounding. In bf16, p is rounded against its split's max and the partials
// are rescaled in fp32 when combined, where JAX's single-tile kernel rounds
// against the row's max. JAX's own blocked kernel (against a running max)
// and this port's earlier kernel past 4,096 positions differ from the single
// tile in the same way; all stay within 4 bf16 ulps of each head's largest
// output (parity.attention_tolerance). The plain PyTorch twin of this
// schedule is ops/decode_attention.py decode_split_twin.
//
// Plain C interface (ctypes): dtc_decode_attention launches on the given
// stream, never synchronises, allocates nothing, and returns the launches'
// error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerGroup = 4;  // positions a thread group holds of one split
constexpr int kStage = 2048;  // partial-sum floats the combine stages at once

// dtype codes shared with the wrapper: 0 float32, 1 bfloat16, 2 int8.
template <int C> struct Size;
template <> struct Size<0> { static constexpr int value = 4; };
template <> struct Size<1> { static constexpr int value = 2; };
template <> struct Size<2> { static constexpr int value = 1; };

constexpr int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// How a block covers a split: N elements a thread (one 16-byte chunk), TPG
// threads a position (kChunks of them loading), G positions a pass, kSplit
// positions a split. Mirrored by ops/decode_attention.py split_len.
template <int KC, int D> struct Geometry {
  static constexpr int kBytes = Size<KC>::value;
  static constexpr int N = 16 / kBytes;
  static constexpr int kChunks = D / N;
  static constexpr int TPG = pow2_at_least(kChunks);
  static constexpr int G = kThreads / TPG;
  static constexpr int kSplit = kPerGroup * G;
  static_assert(D % N == 0 && TPG <= 32, "unsupported head_dim");
};

// Round to q's dtype and back (identity for float32).
template <int QC> __device__ __forceinline__ float round_q(float x);
template <> __device__ __forceinline__ float round_q<0>(float x) { return x; }
template <> __device__ __forceinline__ float round_q<1>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A cache element in q's dtype: a bf16 element is one already, and a float32
// one under float32 q too.
template <int QC, int KC> __device__ __forceinline__ float to_q(float x) {
  if constexpr (KC == 1) return x;
  return round_q<QC>(x);
}

template <int QC> __device__ __forceinline__ float load_q(const void* p, size_t i);
template <> __device__ __forceinline__ float load_q<0>(const void* p, size_t i) {
  return static_cast<const float*>(p)[i];
}
template <> __device__ __forceinline__ float load_q<1>(const void* p, size_t i) {
  return __uint_as_float(static_cast<uint32_t>(static_cast<const uint16_t*>(p)[i]) << 16);
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

// Block-wide max over the warps' values (kWarps lanes of s_red); the caller
// has reduced within each warp. Max is exact, so any order gives its bits.
__device__ __forceinline__ float block_max(float x, float* s_red) {
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = s_red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, s_red[w]);
  return r;
}

template <int QC, int KC, int D>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const void* __restrict__ q, const void* __restrict__ k,
                    const void* __restrict__ v, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ start,
                    void* __restrict__ out, float* __restrict__ part, int S, int H,
                    int per_row, float scale) {
  using Geo = Geometry<KC, D>;
  constexpr int N = Geo::N, TPG = Geo::TPG, G = Geo::G, kSplit = Geo::kSplit;
  constexpr unsigned kAll = 0xffffffffu;

  __shared__ float s_red[kWarps];
  __shared__ float s_acc[kWarps][D];

  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  int n = (per_row ? start[b] : start[0]) + 1;  // visible columns
  n = n > S ? S : (n < 1 ? 1 : n);
  const int ns = (n + kSplit - 1) / kSplit;
  if (j >= ns) return;  // past the frontier: no load
  // Let the combine's blocks be scheduled now; they wait for this grid.
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  const int tid = threadIdx.x;
  const int g = tid / TPG;     // position group
  const int lane = tid % TPG;  // which chunk of the head row
  const bool active = lane < Geo::kChunks;
  const int c0 = j * kSplit;
  const int HD = H * D;
  const size_t row0 = static_cast<size_t>(b) * S;
  const size_t col = static_cast<size_t>(h) * D + lane * N;

  // Every K and V load of the split first: kPerGroup of each in flight.
  uint4 kr[kPerGroup], vr[kPerGroup];
  float ksc[kPerGroup], vsc[kPerGroup];
  const char* kb = static_cast<const char*>(k);
  const char* vb = static_cast<const char*>(v);
#pragma unroll
  for (int p = 0; p < kPerGroup; ++p) {
    const int pos = c0 + g + p * G;
    kr[p] = vr[p] = make_uint4(0u, 0u, 0u, 0u);
    ksc[p] = vsc[p] = 1.f;
    if (pos < n) {
      const size_t row = row0 + pos;
      if (active) {
        const size_t off = (row * HD + col) * Geo::kBytes;
        kr[p] = __ldg(reinterpret_cast<const uint4*>(kb + off));
        vr[p] = __ldg(reinterpret_cast<const uint4*>(vb + off));
      }
      if constexpr (KC == 2) {
        ksc[p] = __ldg(k_scale + row * H + h);
        vsc[p] = __ldg(v_scale + row * H + h);
      }
    }
  }

  // q scaled in q's dtype, this thread's N elements (zeros on idle lanes).
  float qs[N];
  const size_t q_off = static_cast<size_t>(b) * HD + col;
#pragma unroll
  for (int i = 0; i < N; ++i) qs[i] = active ? round_q<QC>(load_q<QC>(q, q_off + i) * scale) : 0.f;

  // Scores, summed over the group; every lane of a group ends with its bits.
  float e[N];
  float sc[kPerGroup];
  float m = -INFINITY;
#pragma unroll
  for (int p = 0; p < kPerGroup; ++p) {
    unpack<KC>(kr[p], e);
    float part_dot = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      part_dot = fmaf(qs[i], to_q<QC, KC>(KC == 2 ? e[i] * ksc[p] : e[i]), part_dot);
    }
#pragma unroll
    for (int o = TPG / 2; o > 0; o >>= 1) part_dot += __shfl_xor_sync(kAll, part_dot, o);
    sc[p] = part_dot;
    if (c0 + g + p * G < n) m = fmaxf(m, part_dot);
  }
#pragma unroll
  for (int o = TPG; o < 32; o <<= 1) m = fmaxf(m, __shfl_xor_sync(kAll, m, o));
  m = block_max(m, s_red);  // the split's max

  // p against the split's max, rounded to q's dtype for the P*V sum.
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  float l = 0.f;
#pragma unroll
  for (int p = 0; p < kPerGroup; ++p) {
    if (c0 + g + p * G < n) {
      const float pe = expf(sc[p] - m);
      l += pe;
      const float pr = round_q<QC>(pe);
      unpack<KC>(vr[p], e);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        acc[i] = fmaf(pr, to_q<QC, KC>(KC == 2 ? e[i] * vsc[p] : e[i]), acc[i]);
      }
    }
  }
  // Over the groups of a warp (a butterfly: every lane gets the same bits),
  // then over the warps in warp order.
#pragma unroll
  for (int o = TPG; o < 32; o <<= 1) {
    l += __shfl_xor_sync(kAll, l, o);
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] += __shfl_xor_sync(kAll, acc[i], o);
  }
  __syncthreads();  // every thread has read s_red's max
  const int warp = tid >> 5;
  if ((tid & 31) < TPG && active) {
#pragma unroll
    for (int i = 0; i < N; ++i) s_acc[warp][lane * N + i] = acc[i];
  }
  if ((tid & 31) == 0) s_red[warp] = l;
  __syncthreads();
  float a = 0.f;
  if (tid < D) {
    a = s_acc[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) a += s_acc[w][tid];
  }
  l = s_red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) l += s_red[w];

  const size_t o_off = static_cast<size_t>(b) * HD + static_cast<size_t>(h) * D;
  if (ns == 1) {
    if (tid < D) store_q<QC>(out, o_off + tid, a / l);
    return;
  }

  // Partials: acc (B, H, splits, D), then (max, sum) (B, H, splits, 2).
  const int splits = gridDim.x;
  const size_t bh = static_cast<size_t>(b) * H + h;
  float* p_acc = part + bh * splits * D;
  float* p_ml = part + static_cast<size_t>(gridDim.z) * H * splits * D + bh * splits * 2;
  if (tid < D) p_acc[static_cast<size_t>(j) * D + tid] = a;
  if (tid == 0) {
    p_ml[2 * j] = m;
    p_ml[2 * j + 1] = l;
  }
}

// The combine of a call whose cache holds more than one split, a block per
// (head, row), launched after decode_split_kernel as its programmatic
// dependent: M = max m_j, then out = sum_j acc_j w_j / sum_j l_j w_j with
// w_j = exp(m_j - M), summed in j order. A row of one split was written by
// the split kernel.
template <int QC, int KC, int D>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const int* __restrict__ start, const float* __restrict__ part,
                      void* __restrict__ out, int S, int H, int per_row) {
  constexpr int kSplit = Geometry<KC, D>::kSplit;
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ float s_red[kWarps];

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  int n = (per_row ? start[b] : start[0]) + 1;
  n = n > S ? S : (n < 1 ? 1 : n);
  const int ns = (n + kSplit - 1) / kSplit;
  // Every block waits for the split kernel's grid, a row of one split too:
  // so this grid never completes before that one, and the stream's next
  // work sees both.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (ns == 1) return;
  const int splits = (S + kSplit - 1) / kSplit;
  const size_t bh = static_cast<size_t>(b) * H + h;
  // Partials are read through L2 (__ldcg): other SMs wrote them.
  const float* p_acc = part + bh * splits * D;
  const float* p_ml = part + static_cast<size_t>(gridDim.y) * H * splits * D + bh * splits * 2;

  float big = -INFINITY;
  for (int jj = tid; jj < ns; jj += kThreads) big = fmaxf(big, __ldcg(p_ml + 2 * jj));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) big = fmaxf(big, __shfl_xor_sync(kAll, big, o));
  big = block_max(big, s_red);

  constexpr int kJ = kStage / D;  // splits a pass
  __shared__ float s_stage[kStage];
  __shared__ float s_w[kJ], s_lw[kJ];
  float num = 0.f, den = 0.f;
  for (int j0 = 0; j0 < ns; j0 += kJ) {
    const int jn = ns - j0 < kJ ? ns - j0 : kJ;
    __syncthreads();  // the last pass's reads (and block_max's) are done
#pragma unroll
    for (int u = 0; u < kStage / kThreads; ++u) {
      const int x = tid + u * kThreads;
      if (x < jn * D) s_stage[x] = __ldcg(p_acc + static_cast<size_t>(j0) * D + x);
    }
    if (tid < jn) {
      const float w = expf(__ldcg(p_ml + 2 * (j0 + tid)) - big);
      s_w[tid] = w;
      s_lw[tid] = __ldcg(p_ml + 2 * (j0 + tid) + 1) * w;
    }
    __syncthreads();
    for (int jj = 0; jj < jn; ++jj) {
      if (tid < D) num = fmaf(s_stage[jj * D + tid], s_w[jj], num);
      den += s_lw[jj];
    }
  }
  if (tid < D) {
    store_q<QC>(out, static_cast<size_t>(b) * H * D + static_cast<size_t>(h) * D + tid,
                num / den);
  }
}

template <int QC, int KC, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int* start, void* out, float* part,
                   long long part_floats, int B, int S, int H, int per_row, float scale,
                   cudaStream_t stream) {
  constexpr int L = Geometry<KC, D>::kSplit;
  const int splits = (S + L - 1) / L;
  if (splits > 1 && (part == nullptr || part_floats < static_cast<long long>(B) * H * splits * (D + 2))) {
    return cudaErrorInvalidValue;
  }
  decode_split_kernel<QC, KC, D><<<dim3(splits, H, B), kThreads, 0, stream>>>(
      q, k, v, ks, vs, start, out, part, S, H, per_row, scale);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || splits == 1) return rc;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, decode_combine_kernel<QC, KC, D>, start,
                          static_cast<const float*>(part), out, S, H, per_row);
  return rc != cudaSuccess ? rc : cudaGetLastError();
}

#define DTC_HEAD_DIMS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

template <int QC, int KC>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const float* ks,
                     const float* vs, const int* start, void* out, float* part,
                     long long part_floats, int B, int S, int H, int per_row, float scale,
                     cudaStream_t stream) {
  switch (D) {
#define DTC_CASE(d)                                                                       \
  case d:                                                                                 \
    return launch<QC, KC, d>(q, k, v, ks, vs, start, out, part, part_floats, B, S, H, \
                             per_row, scale, stream);
    DTC_HEAD_DIMS(DTC_CASE)
#undef DTC_CASE
    default: return cudaErrorInvalidValue;
  }
}

template <int KC>
int split_len(int D) {
  switch (D) {
#define DTC_CASE(d) \
  case d: return Geometry<KC, d>::kSplit;
    DTC_HEAD_DIMS(DTC_CASE)
#undef DTC_CASE
    default: return 0;
  }
}

}  // namespace

// part: float32 scratch of at least B * H * splits * (D + 2) floats (splits =
// ceil(S / split length)), the partials; may be null when one split covers
// S. Launches the split kernel, then (more than one split) the combine.
extern "C" int dtc_decode_attention(const void* q, const void* k, const void* v,
                                    const float* k_scale, const float* v_scale,
                                    const int* start, void* out, float* part,
                                    long long part_floats, int B, int S, int H, int D,
                                    int per_row, float scale, int q_dtype, int kv_dtype,
                                    void* stream) {
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DTC_ARGS D, q, k, v, k_scale, v_scale, start, out, part, part_floats, B, S, H, per_row, \
                 scale, st
  switch (q_dtype * 3 + kv_dtype) {
    case 0: return launch_d<0, 0>(DTC_ARGS);
    case 1: return launch_d<0, 1>(DTC_ARGS);
    case 2: return launch_d<0, 2>(DTC_ARGS);
    case 3: return launch_d<1, 0>(DTC_ARGS);
    case 4: return launch_d<1, 1>(DTC_ARGS);
    case 5: return launch_d<1, 2>(DTC_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DTC_ARGS
}

// The split length of the (kv dtype, head dim) instance; 0 where there is none.
extern "C" int dtc_decode_split_len(int kv_dtype, int D) {
  switch (kv_dtype) {
    case 0: return split_len<0>(D);
    case 1: return split_len<1>(D);
    case 2: return split_len<2>(D);
    default: return 0;
  }
}

extern "C" const char* dtc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
