// Layer-fused decode megakernel for Hopper (sm_90a): every layer of the
// decode block, for every batch row and a verify window of up to 8 query
// positions, in ONE launch.
//
// Replaces the JAX package's TPU kernel dtc_tpu/ops/decode_fused.py
// _fused_layers_kernel (the `decode_attention: fused_layers` backend),
// LoRA sites included.
//
// What it computes, per layer l and per row r = b * T + j (batch row b,
// window position j, T <= 8), from the residual x (B, T, d_model) in the
// compute dtype:
//   LN1 (fp32 statistics, fast variance clipped at 0, eps 1e-6) -> q, k, v
//   through `dense` (inputs and fp32 weights rounded to the compute dtype,
//   fp32 sums, the product rounded to the compute dtype, then the bias added
//   in the compute dtype) -> the window's k/v written into the cache at
//   clamp(start, 0, S - T) -> attention of position j over cache columns
//   < min(start + j, S) plus itself -> out_proj -> residual (compute dtype)
//   -> LN2 -> fc1 -> tanh GELU -> fc2 -> residual.
// LoRA sites (adapters): q, k and v on the LN1 output, out_proj before the
// residual, fc1 before the GELU and fc2 before the residual each add, where
// the site mask sets it, o = round(o + round(round(scale) *
// round(sum_k z_k * round(B[j, k])))) after the bias, with
// z = round(x_row . round(A)) over the site's whole input row (the JAX
// package's apply_lora). Row r = b * T + j reads adapter slot ids[b] of the
// resident factor stack (A (slots, L, rank, in), B (slots, L, out, rank),
// fp32) through a per-layer table of slot 0's pointers; no per-row copy.
// Without ids every row reads slot 0: one adapter shared by the batch.
// Rounding points are the TPU kernel's: q is scaled in the compute dtype;
// scores are fp32; one row max covers cache and the position itself; the
// cached part's p is rounded to the compute dtype before p.V, the position's
// own is not; an int8 cache quantizes the window's k/v per (position, head)
// and attention reads them dequantized, as a later step will read them back.
// One deliberate difference: the TPU kernel also keeps the window's earlier
// positions in registers with fp32 p; here they are read back from the cache
// like any cached column (see attention_unit), which makes a verify window
// row equal to a single-token step bit for bit.
//
// Design. The TPU kernel walks a sequential (L, B) grid and carries each
// row's residual in VMEM. Hopper blocks run in any order, and every output
// column of layer l + 1 needs whole rows of layer l, so this is one
// persistent cooperative kernel (at most two blocks per SM, all co-resident)
// whose phases are separated by a grid-wide barrier written here (an atomic
// arrival counter read with acquire loads; no relocatable device code). Per
// layer: (1) LN1 + q/k/v, (2) attention + cache write, (3) out_proj +
// residual, (4) LN2 + fc1 + GELU, (5) fc2 + residual. A dense phase gives one
// warp one output column at a time: the warp streams that column's fp32
// weight row (PyTorch's (out, in) layout, so the row is contiguous) once per
// chunk of 8 input rows staged in shared memory; each block computes the
// LayerNorm of the staged rows itself, and, with adapters, each staged
// row's z for the sites its columns belong to, from shared memory before its
// column loop (the same summation order in every block, so every block holds
// the same z bits; no extra grid barrier, A read from L2 once per block). An
// attention phase gives one block one (batch row, head). Intermediates live
// in an fp32 scratch the wrapper allocates; the kernel allocates nothing and
// never casts or copies weights.
//
// Determinism and row independence. No atomics in any sum. Each output's sum
// runs in an order fixed by the shapes (d_model, d_ff, S, D) and the row's
// own frontier, never by B, T or another row's data, so row j of a window at
// frontier f equals a single-token step at frontier f + j bit for bit, and a
// row does not change with B.
//
// Bound: bytes. At the flagship (B 4, T 1, 12 layers of d_model 512, d_ff
// 2048, fp32 weights) a call must read 151.3 MB of weights plus the K/V up
// to the frontiers, 45-60 us at 3.35 TB/s; its operations are about 0.3
// GFLOP. Each distinct adapter in the batch adds its factors' bytes (rank 8
// on all six sites: 3.5 MB over 12 layers). What holds this first version
// back is its 5 * L grid barriers and one weight row in flight per warp, and
// with adapters the z step each block runs before its columns (PERF.md has
// the measured times).
//
// Plain C interface (ctypes): dtc_fused_layers zeroes the barrier counter and
// launches on the given stream, never synchronises, and returns
// cudaGetLastError() or the launch's error.
//
// Build: one library per (compute, KV) dtype pair, selected with
// -DDTC_CD=<0|1> -DDTC_KV=<0|1|2> (the dtype codes below), each holding the
// four head-dim instances, so the pairs compile in parallel processes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#if !defined(DTC_CD) || !defined(DTC_KV)
#error "build with -DDTC_CD=<0|1> -DDTC_KV=<0|1|2> (compute and KV dtype codes)"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxT = 8;           // widest verify window (SPEC_MAX_K)
constexpr int kRowChunk = 8;       // rows per dense pass: accumulators per lane
constexpr int kScoreChunk = 512;   // cached positions whose scores sit in smem
constexpr int kWeights = 16;       // weight pointers per layer
constexpr int kDenseSmemBudget = 96 * 1024;
constexpr int kMaxBlocksPerSm = 2;
constexpr int kScratchHead = 64;   // floats before the buffers: the barrier
constexpr int kLoraSites = 6;      // q, k, v, out_proj, fc1, fc2: mask bits 0..5
constexpr int kLoraMaxRank = 64;   // LORA_MAX_RANK
constexpr int kLoraZFloats = 3 * kRowChunk * kLoraMaxRank;  // z of one row chunk
constexpr int kLoraSmemFloats = kLoraZFloats + kRowChunk;   // z, then the rows' slots
constexpr float kLnEps = 1e-6f;
constexpr float kScaleFloor = 1e-8f;  // KV_SCALE_FLOOR
constexpr unsigned long long kBarrierTimeoutNs = 5000000000ull;

static_assert(kMaxT <= kWarps, "one warp quantizes one window position");

// Weight table order, per layer.
enum {
  kLn1W = 0, kLn1B, kQW, kQB, kKW, kKB, kVW, kVB, kOW, kOB,
  kLn2W, kLn2B, kFc1W, kFc1B, kFc2W, kFc2B
};

// dtype codes shared with the wrapper: 0 float32, 1 bfloat16, 2 int8.
template <int C> struct Size;
template <> struct Size<0> { static constexpr int value = 4; };
template <> struct Size<1> { static constexpr int value = 2; };
template <> struct Size<2> { static constexpr int value = 1; };

// Round to the compute (or KV) dtype and back; identity for float32.
template <int C> __device__ __forceinline__ float rnd(float x) { return x; }
template <> __device__ __forceinline__ float rnd<1>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int C> __device__ __forceinline__ float load_t(const void* p, size_t i);
template <> __device__ __forceinline__ float load_t<0>(const void* p, size_t i) {
  return static_cast<const float*>(p)[i];
}
template <> __device__ __forceinline__ float load_t<1>(const void* p, size_t i) {
  return __uint_as_float(static_cast<uint32_t>(static_cast<const uint16_t*>(p)[i]) << 16);
}
template <> __device__ __forceinline__ float load_t<2>(const void* p, size_t i) {
  return static_cast<float>(static_cast<const int8_t*>(p)[i]);
}

// Stores a value that is already representable in the target dtype.
template <int C> __device__ __forceinline__ void store_t(void* p, size_t i, float x);
template <> __device__ __forceinline__ void store_t<0>(void* p, size_t i, float x) {
  static_cast<float*>(p)[i] = x;
}
template <> __device__ __forceinline__ void store_t<1>(void* p, size_t i, float x) {
  static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ void store_t<2>(void* p, size_t i, float x) {
  static_cast<int8_t*>(p)[i] = static_cast<int8_t>(x);
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  return 0.5f * x * (1.f + tanhf(kBeta * (x + kKappa * x * x * x)));
}

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Grid-wide barrier number `k` (1, 2, ...): every block adds one arrival and
// waits for k * gridDim.x of them. The cooperative launch guarantees that all
// blocks are resident; a barrier that waits past the timeout traps rather
// than hang the card.
__device__ __forceinline__ void grid_barrier(unsigned int* bar, unsigned int k) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int target = k * gridDim.x;
    __threadfence();
    atomicAdd(bar, 1u);
    unsigned long long t0 = 0;
    while (ld_acquire(bar) < target) {
      __nanosleep(32);
      const unsigned long long now = global_ns();
      if (t0 == 0) {
        t0 = now;
      } else if (now - t0 > kBarrierTimeoutNs) {
        __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

struct Params {
  const void* x_in;            // (B, T, dm) compute dtype
  void* x_out;                 // (B, T, dm) compute dtype
  const float* const* w;       // (L, 16) fp32 parameter pointers
  void* k_cache;               // (L, B, S, H*D) KV dtype
  void* v_cache;
  float* k_scale;              // (L, B, S, H) fp32, int8 cache only
  float* v_scale;
  const int* start;            // (1,) or (B,) write frontiers
  float* scratch;              // barrier + x, qkv, attn, g buffers
  int B, T, L, S, dm, H, dff, per_row, row_chunk;
  float att_scale;             // D^-0.5 rounded to the compute dtype
  const float* const* lw;      // (L, 2 * kLoraSites) slot 0's A, B pointers, or null
  const int* lora_ids;         // (B,) adapter slots, or null: slot 0 for every row
  int lora_mask, rank, lora_L; // sites present, rank, layers in the factor stack
  float lora_scale;            // alpha / rank rounded to the compute dtype
};

__device__ __forceinline__ int lora_slot(const Params& p, int row) {
  return p.lora_ids ? p.lora_ids[row / p.T] : 0;
}

// z[s][i][k] = round(sum_kk in[i][kk] * round(A_s[slot(i)][k][kk])) for the
// staged rows i < nr, every rank k and each site site0 + s (s < nsites) set
// in `need`. One warp per (s, i, four ranks), the four rows of A in flight
// together; each z sums its lane's stride of the input row in order, then
// across lanes, so its bits are set by K alone. Also leaves each staged
// row's adapter slot in s_slot.
template <int CD>
__device__ void lora_z(const Params& p, const float* s_in, float* s_z, int* s_slot, int r0,
                       int nr, int K, const float* const* lwl, int site0, int nsites, int need) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int R = p.rank;
  const int groups = (R + 3) / 4;
  if (threadIdx.x < nr) s_slot[threadIdx.x] = lora_slot(p, r0 + threadIdx.x);
  for (int task = warp; task < nsites * nr * groups; task += kWarps) {
    const int s = task / (nr * groups), rest = task - s * nr * groups;
    const int i = rest / groups, k0 = (rest - i * groups) * 4;
    if (!((need >> s) & 1)) continue;
    const int slot = lora_slot(p, r0 + i);
    const float* a = lwl[2 * (site0 + s)] + (static_cast<size_t>(slot) * p.lora_L * R + k0) * K;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int kk = lane * 4; kk < K; kk += 128) {
      const float4 x4 = *reinterpret_cast<const float4*>(s_in + i * K + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (k0 + q < R) {
          const float4 a4 =
              __ldg(reinterpret_cast<const float4*>(a + static_cast<size_t>(q) * K + kk));
          acc[q] = fmaf(x4.x, rnd<CD>(a4.x), acc[q]);
          acc[q] = fmaf(x4.y, rnd<CD>(a4.y), acc[q]);
          acc[q] = fmaf(x4.z, rnd<CD>(a4.z), acc[q]);
          acc[q] = fmaf(x4.w, rnd<CD>(a4.w), acc[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float t = warp_sum(acc[q]);
      if (lane == 0 && k0 + q < R) s_z[(s * kRowChunk + i) * R + k0 + q] = rnd<CD>(t);
    }
  }
}

enum Src { kFromLn = 0, kFromBuf = 1 };
enum Epi { kEpiQkv = 0, kEpiResid = 1, kEpiGelu = 2 };

// Stages rows r0 .. r0 + nr - 1 of the dense input into shared memory as
// compute-dtype values held in floats: either LayerNorm of the residual (one
// warp per row) or a copy of an fp32 scratch buffer.
template <int CD>
__device__ void stage_rows(float* s_in, int r0, int nr, int K, int src, const float* buf,
                           const float* ln_w, const float* ln_b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (src == kFromBuf) {
    for (int i = threadIdx.x; i < nr * K; i += kThreads) {
      s_in[i] = __ldcg(buf + static_cast<size_t>(r0) * K + i);
    }
    return;
  }
  for (int i = warp; i < nr; i += kWarps) {
    const float* xr = buf + static_cast<size_t>(r0 + i) * K;
    float s = 0.f, s2 = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float v = __ldcg(xr + k);
      s += v;
      s2 = fmaf(v, v, s2);
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mean = s / K;
    const float var = fmaxf(s2 / K - mean * mean, 0.f);
    const float rstd = 1.f / sqrtf(var + kLnEps);
    for (int k = lane; k < K; k += 32) {
      const float v = __ldcg(xr + k);
      s_in[i * K + k] = rnd<CD>((v - mean) * (rstd * __ldg(ln_w + k)) + __ldg(ln_b + k));
    }
  }
}

// One dense phase: out[r, j] = round(round(sum_k in[r, k] * round(W[j, k])) +
// round(b[j])), plus the LoRA delta where site `site0` (+ which, for q/k/v)
// is on, then the epilogue, for every row r and output column j. `wi` is the
// weight's index in the layer's table (q/k/v: kQW, three tables side by
// side); `lwl` the layer's LoRA table (null without adapters).
template <int CD>
__device__ void dense_phase(const Params& p, float* s_in, int K, int N, int src,
                            const float* src_buf, const float* ln_w, const float* ln_b,
                            const float* const* wl, int wi, int epi, float* out_buf,
                            bool last_layer, const float* const* lwl, int site0) {
  const int R = p.B * p.T;
  const int nsites = epi == kEpiQkv ? 3 : 1;
  const int NS = N / nsites;  // columns of one site
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWarps + warp;
  const int nw = gridDim.x * kWarps;
  const bool block_has_work = blockIdx.x * kWarps < N;
  float* s_z = s_in + p.row_chunk * max(p.dm, p.dff);
  int* s_slot = reinterpret_cast<int*>(s_z + kLoraZFloats);
  // The adapter sites this block's columns fall in (block-uniform).
  int need = 0;
  const int site_bits = lwl ? (p.lora_mask >> site0) & ((1 << nsites) - 1) : 0;
  if (site_bits) {
    for (int w = 0; w < kWarps; ++w) {
      for (int j = blockIdx.x * kWarps + w; j < N; j += nw) need |= 1 << (j / NS);
    }
    need &= site_bits;
  }
  for (int r0 = 0; r0 < R; r0 += p.row_chunk) {
    const int nr = min(p.row_chunk, R - r0);
    if (block_has_work) stage_rows<CD>(s_in, r0, nr, K, src, src_buf, ln_w, ln_b);
    __syncthreads();
    if (need) {
      lora_z<CD>(p, s_in, s_z, s_slot, r0, nr, K, lwl, site0, nsites, need);
      __syncthreads();
    }
    for (int j = gw; j < N; j += nw) {
      const int which = j / NS, jj = j - which * NS;
      const float* wrow = wl[wi + 2 * which] + static_cast<size_t>(jj) * K;
      const float bias = __ldg(wl[wi + 2 * which + 1] + jj);
      float acc[kRowChunk];
#pragma unroll
      for (int i = 0; i < kRowChunk; ++i) acc[i] = 0.f;
#pragma unroll 4
      for (int k = lane * 4; k < K; k += 128) {
        float4 w4 = __ldg(reinterpret_cast<const float4*>(wrow + k));
        w4.x = rnd<CD>(w4.x); w4.y = rnd<CD>(w4.y);
        w4.z = rnd<CD>(w4.z); w4.w = rnd<CD>(w4.w);
#pragma unroll
        for (int i = 0; i < kRowChunk; ++i) {
          if (i < nr) {
            const float4 x4 = *reinterpret_cast<const float4*>(s_in + i * K + k);
            acc[i] = fmaf(x4.x, w4.x, acc[i]);
            acc[i] = fmaf(x4.y, w4.y, acc[i]);
            acc[i] = fmaf(x4.z, w4.z, acc[i]);
            acc[i] = fmaf(x4.w, w4.w, acc[i]);
          }
        }
      }
      float mine = 0.f;
#pragma unroll
      for (int i = 0; i < kRowChunk; ++i) {
        const float t = warp_sum(acc[i]);
        if (lane == i) mine = t;
      }
      if (lane < nr) {
        const int r = r0 + lane;
        float o = rnd<CD>(rnd<CD>(mine) + rnd<CD>(bias));
        if ((need >> which) & 1) {
          // delta = sum_k z_k * round(B[j, k]) in order of k, eight loads of
          // the row of B in flight at a time.
          const float* brow = lwl[2 * (site0 + which) + 1] +
              (static_cast<size_t>(s_slot[lane]) * p.lora_L * NS + jj) * p.rank;
          const float* z = s_z + (which * kRowChunk + lane) * p.rank;
          float d = 0.f;
          for (int k0 = 0; k0 < p.rank; k0 += 8) {
            float bv[8];
#pragma unroll
            for (int q = 0; q < 8; ++q) bv[q] = k0 + q < p.rank ? __ldg(brow + k0 + q) : 0.f;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              if (k0 + q < p.rank) d = fmaf(z[k0 + q], rnd<CD>(bv[q]), d);
            }
          }
          o = rnd<CD>(o + rnd<CD>(p.lora_scale * rnd<CD>(d)));
        }
        if (epi == kEpiQkv) {
          out_buf[static_cast<size_t>(r) * N + j] = o;
        } else if (epi == kEpiGelu) {
          out_buf[static_cast<size_t>(r) * N + j] = rnd<CD>(gelu_tanh(o));
        } else {
          float* xp = out_buf + static_cast<size_t>(r) * N + j;
          const float x = rnd<CD>(__ldcg(xp) + o);
          *xp = x;
          if (last_layer) store_t<CD>(p.x_out, static_cast<size_t>(r) * N + j, x);
        }
      }
    }
    __syncthreads();  // the next chunk overwrites s_in
  }
}

// Shared memory of one attention unit, in floats.
template <int D> struct AttnSmem {
  static constexpr int q = 0;
  static constexpr int kn = q + kMaxT * D;         // window k as attention reads it
  static constexpr int vn = kn + kMaxT * D;
  static constexpr int kq = vn + kMaxT * D;        // int8 payloads to write
  static constexpr int vq = kq + kMaxT * D;
  static constexpr int ksc = vq + kMaxT * D;       // int8 scales to write
  static constexpr int vsc = ksc + kMaxT;
  static constexpr int own = vsc + kMaxT;          // each position's score on itself
  static constexpr int m = own + kMaxT;            // row max
  static constexpr int l = m + kMaxT;              // cached part's row sum
  static constexpr int red = l + kMaxT;            // (warps, T) partials
  static constexpr int sc = red + kWarps * kMaxT;  // (T, kScoreChunk) scores
  static constexpr int pv = sc + kMaxT * kScoreChunk;  // (groups, T, D) partials
  static constexpr int total = pv + kThreads * kMaxT;
};

// A cache element read through L2 only: the unit reads back positions it
// wrote itself a moment before.
template <int KC> __device__ __forceinline__ float load_cg(const void* p, size_t i);
template <> __device__ __forceinline__ float load_cg<0>(const void* p, size_t i) {
  return __ldcg(static_cast<const float*>(p) + i);
}
template <> __device__ __forceinline__ float load_cg<1>(const void* p, size_t i) {
  const unsigned short u = __ldcg(static_cast<const unsigned short*>(p) + i);
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}
template <> __device__ __forceinline__ float load_cg<2>(const void* p, size_t i) {
  return static_cast<float>(__ldcg(static_cast<const signed char*>(p) + i));
}

// Scores of the T window queries against cached position c of this (b, h):
// sequential over d, so each score is the same whatever T is.
template <int CD, int KC, int D>
__device__ __forceinline__ void cache_scores(const Params& p, const float* s_q, size_t row_off,
                                             float ks, float* s) {
  constexpr int N = 16 / Size<KC>::value;
  const char* kb = static_cast<const char*>(p.k_cache) + row_off * Size<KC>::value;
#pragma unroll
  for (int j = 0; j < kMaxT; ++j) s[j] = 0.f;
#pragma unroll
  for (int d0 = 0; d0 < D; d0 += N) {
    float e[N];
    unpack<KC>(__ldcg(reinterpret_cast<const uint4*>(kb + d0 * Size<KC>::value)), e);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float kv = rnd<CD>(KC == 2 ? e[i] * ks : e[i]);
#pragma unroll
      for (int j = 0; j < kMaxT; ++j) {
        if (j < p.T) s[j] = fmaf(s_q[j * D + d0 + i], kv, s[j]);
      }
    }
  }
}

// Attention of the T window positions of batch row b, head h, in layer l.
//
// The window's k/v (and int8 scales) go into the cache first, at the
// clamped frontier wpos = min(start, S - T). Window position j then reads
// cached positions < min(start + j, S) -- the earlier window positions
// among them, read back as a later step reads them -- with p rounded to the
// compute dtype before p.V, and itself in registers with fp32 p. Its
// operations are those of a single-token step at frontier start + j, in the
// same order, so a verify window's rows equal plain decode's bit for bit
// (greedy speculation's token identity). The TPU kernel keeps the whole
// window in registers with fp32 p; the two differ only in where p of the
// earlier window positions is rounded.
template <int CD, int KC, int D>
__device__ void attention_unit(const Params& p, float* sm, int l, int b, int h,
                               const float* qkv, float* attn) {
  using SM = AttnSmem<D>;
  const int T = p.T, S = p.S, H = p.H;
  const int HD = H * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* s_q = sm + SM::q;
  float* s_kn = sm + SM::kn;
  float* s_vn = sm + SM::vn;
  float* s_kq = sm + SM::kq;
  float* s_vq = sm + SM::vq;
  float* s_ksc = sm + SM::ksc;
  float* s_vsc = sm + SM::vsc;
  float* s_own = sm + SM::own;
  float* s_m = sm + SM::m;
  float* s_l = sm + SM::l;
  float* s_red = sm + SM::red;
  float* s_sc = sm + SM::sc;
  float* s_pv = sm + SM::pv;

  int start = p.per_row ? p.start[b] : p.start[0];
  start = max(start, 0);
  const int wpos = min(start, S - T);        // where the window is written
  const int n_max = min(start + T - 1, S);   // cached positions the last row reads
  const size_t cache_row0 = (static_cast<size_t>(l) * p.B + b) * S;  // position 0 of (l, b)

  // 1. The window's q (scaled in the compute dtype), k and v.
  for (int i = tid; i < T * D; i += kThreads) {
    const int j = i / D, d = i - j * D;
    const size_t base = static_cast<size_t>(b * T + j) * 3 * HD + h * D + d;
    s_q[i] = rnd<CD>(__ldcg(qkv + base) * p.att_scale);
    const float k = __ldcg(qkv + base + HD);
    const float v = __ldcg(qkv + base + 2 * HD);
    if (KC == 2) {
      s_kn[i] = k;  // raw, quantized below
      s_vn[i] = v;
    } else {
      s_kn[i] = rnd<CD>(rnd<KC>(k));
      s_vn[i] = rnd<CD>(rnd<KC>(v));
    }
  }
  __syncthreads();
  if (KC == 2 && warp < T) {
    // One warp per window position: per-head scale max(|x|) / 127 (floored),
    // round half to even, clip to +-127; attention reads the dequantized
    // values.
    const int j = warp;
    float ka = 0.f, va = 0.f;
    for (int d = lane; d < D; d += 32) {
      ka = fmaxf(ka, fabsf(s_kn[j * D + d]));
      va = fmaxf(va, fabsf(s_vn[j * D + d]));
    }
    const float ksc = fmaxf(warp_max(ka), kScaleFloor) / 127.f;
    const float vsc = fmaxf(warp_max(va), kScaleFloor) / 127.f;
    for (int d = lane; d < D; d += 32) {
      const float kq = fminf(fmaxf(rintf(s_kn[j * D + d] / ksc), -127.f), 127.f);
      const float vq = fminf(fmaxf(rintf(s_vn[j * D + d] / vsc), -127.f), 127.f);
      s_kq[j * D + d] = kq;
      s_vq[j * D + d] = vq;
      s_kn[j * D + d] = rnd<CD>(kq * ksc);
      s_vn[j * D + d] = rnd<CD>(vq * vsc);
    }
    if (lane == 0) {
      s_ksc[j] = ksc;
      s_vsc[j] = vsc;
    }
  }
  __syncthreads();

  // 2. The window into the cache; each position's score on itself, which
  //    starts its row max.
  for (int i = tid; i < T * D; i += kThreads) {
    const int j = i / D, d = i - j * D;
    const size_t off = (cache_row0 + wpos + j) * HD + h * D + d;
    if (KC == 2) {
      store_t<2>(p.k_cache, off, s_kq[i]);
      store_t<2>(p.v_cache, off, s_vq[i]);
      if (d == 0) {
        p.k_scale[(cache_row0 + wpos + j) * H + h] = s_ksc[j];
        p.v_scale[(cache_row0 + wpos + j) * H + h] = s_vsc[j];
      }
    } else {
      store_t<KC>(p.k_cache, off, s_kn[i]);
      store_t<KC>(p.v_cache, off, s_vn[i]);
    }
  }
  if (tid < T) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(s_q[tid * D + d], s_kn[tid * D + d], s);
    s_own[tid] = s;
    s_m[tid] = s;
  }
  __syncthreads();  // the cache writes are visible to the block from here

  // 3. Cached part, in chunks of kScoreChunk positions; row j takes the
  //    positions below min(start + j, S). Pass A: the row max; pass B:
  //    p = exp(s - max), its row sum, and p (rounded to the compute dtype)
  //    times V. A thread visits the same positions in the same order
  //    whatever T is.
  const int n_chunks = (n_max + kScoreChunk - 1) / kScoreChunk;
  float s[kMaxT];
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * kScoreChunk, cn = min(kScoreChunk, n_max - c0);
    float lmax[kMaxT];
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) lmax[j] = -INFINITY;
    for (int c = tid; c < cn; c += kThreads) {
      const size_t row = cache_row0 + c0 + c;
      const float ks = KC == 2 ? __ldcg(p.k_scale + row * H + h) : 1.f;
      cache_scores<CD, KC, D>(p, s_q, row * HD + h * D, ks, s);
#pragma unroll
      for (int j = 0; j < kMaxT; ++j) {
        if (j < T) {
          const float v = c0 + c < min(start + j, S) ? s[j] : -INFINITY;
          s_sc[j * kScoreChunk + c] = v;
          lmax[j] = fmaxf(lmax[j], v);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      const float wm = warp_max(lmax[j]);
      if (lane == 0 && j < T) s_red[warp * kMaxT + j] = wm;
    }
    __syncthreads();
    if (tid < T) {
      float m = s_m[tid];
      for (int w = 0; w < kWarps; ++w) m = fmaxf(m, s_red[w * kMaxT + tid]);
      s_m[tid] = m;
    }
    __syncthreads();
  }

  constexpr int G = kThreads / D;  // position groups in the p.V product
  const int g = tid / D, dl = tid - (tid / D) * D;
  float acc[kMaxT], lsum[kMaxT];
#pragma unroll
  for (int j = 0; j < kMaxT; ++j) {
    acc[j] = 0.f;
    lsum[j] = 0.f;
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * kScoreChunk, cn = min(kScoreChunk, n_max - c0);
    for (int c = tid; c < cn; c += kThreads) {
      if (n_chunks > 1) {  // one chunk keeps its scores from pass A
        const size_t row = cache_row0 + c0 + c;
        const float ks = KC == 2 ? __ldcg(p.k_scale + row * H + h) : 1.f;
        cache_scores<CD, KC, D>(p, s_q, row * HD + h * D, ks, s);
      } else {
#pragma unroll
        for (int j = 0; j < kMaxT; ++j) {
          if (j < T) s[j] = s_sc[j * kScoreChunk + c];
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxT; ++j) {
        if (j < T) {
          float e = 0.f;
          if (c0 + c < min(start + j, S)) {
            e = expf(s[j] - s_m[j]);
            lsum[j] += e;
          }
          s_sc[j * kScoreChunk + c] = e;
        }
      }
    }
    __syncthreads();
    for (int c = g; c < cn; c += G) {
      const size_t row = cache_row0 + c0 + c;
      float v = load_cg<KC>(p.v_cache, row * HD + h * D + dl);
      if (KC == 2) v *= __ldcg(p.v_scale + row * H + h);
      v = rnd<CD>(v);
#pragma unroll
      for (int j = 0; j < kMaxT; ++j) {
        if (j < T && c0 + c < min(start + j, S)) {
          acc[j] = fmaf(rnd<CD>(s_sc[j * kScoreChunk + c]), v, acc[j]);
        }
      }
    }
    __syncthreads();  // the next chunk overwrites s_sc
  }
  // Row sums of the cached part: thread partials, then warps in order.
#pragma unroll
  for (int j = 0; j < kMaxT; ++j) {
    const float ws = warp_sum(lsum[j]);
    if (lane == 0 && j < T) s_red[warp * kMaxT + j] = ws;
  }
#pragma unroll
  for (int j = 0; j < kMaxT; ++j) {
    if (j < T) s_pv[(g * kMaxT + j) * D + dl] = acc[j];
  }
  __syncthreads();
  if (tid < T) {
    float l_c = 0.f;
    for (int w = 0; w < kWarps; ++w) l_c += s_red[w * kMaxT + tid];
    s_l[tid] = l_c;
  }
  __syncthreads();

  // 4. Each position itself (fp32 p, not rounded), the sums, the output.
  for (int i = tid; i < T * D; i += kThreads) {
    const int j = i / D, d = i - j * D;
    float a_c = 0.f;
    for (int gg = 0; gg < G; ++gg) a_c += s_pv[(gg * kMaxT + j) * D + d];
    const float e = expf(s_own[j] - s_m[j]);
    attn[static_cast<size_t>(b * T + j) * HD + h * D + d] =
        rnd<CD>((a_c + e * s_vn[j * D + d]) / (s_l[j] + e));
  }
}

template <int CD, int KC, int D>
__global__ void __launch_bounds__(kThreads)
fused_layers_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int R = p.B * p.T;
  const int HD = p.H * D;
  unsigned int* bar = reinterpret_cast<unsigned int*>(p.scratch);
  float* xbuf = p.scratch + kScratchHead;
  float* qkv = xbuf + static_cast<size_t>(R) * p.dm;
  float* attn = qkv + static_cast<size_t>(R) * 3 * HD;
  float* gbuf = attn + static_cast<size_t>(R) * HD;
  unsigned int nbar = 0;

  for (int i = blockIdx.x * kThreads + threadIdx.x; i < R * p.dm; i += gridDim.x * kThreads) {
    xbuf[i] = load_t<CD>(p.x_in, i);
  }
  grid_barrier(bar, ++nbar);

  for (int l = 0; l < p.L; ++l) {
    const float* const* wl = p.w + static_cast<size_t>(l) * kWeights;
    const float* const* lwl = p.lw ? p.lw + static_cast<size_t>(l) * 2 * kLoraSites : nullptr;
    const bool last = l == p.L - 1;
    dense_phase<CD>(p, sm, p.dm, 3 * HD, kFromLn, xbuf, wl[kLn1W], wl[kLn1B], wl, kQW, kEpiQkv,
                    qkv, false, lwl, 0);
    grid_barrier(bar, ++nbar);
    for (int u = blockIdx.x; u < p.B * p.H; u += gridDim.x) {
      attention_unit<CD, KC, D>(p, sm, l, u / p.H, u % p.H, qkv, attn);
      __syncthreads();
    }
    grid_barrier(bar, ++nbar);
    dense_phase<CD>(p, sm, HD, p.dm, kFromBuf, attn, nullptr, nullptr, wl, kOW, kEpiResid, xbuf,
                    false, lwl, 3);
    grid_barrier(bar, ++nbar);
    dense_phase<CD>(p, sm, p.dm, p.dff, kFromLn, xbuf, wl[kLn2W], wl[kLn2B], wl, kFc1W, kEpiGelu,
                    gbuf, false, lwl, 4);
    grid_barrier(bar, ++nbar);
    dense_phase<CD>(p, sm, p.dff, p.dm, kFromBuf, gbuf, nullptr, nullptr, wl, kFc2W, kEpiResid,
                    xbuf, last, lwl, 5);
    if (!last) grid_barrier(bar, ++nbar);
  }
}

template <int CD, int KC, int D>
int attn_smem_bytes() {
  return AttnSmem<D>::total * 4;
}

int dense_row_chunk(int dm, int dff) {
  const int kmax = dm > dff ? dm : dff;
  int rc = kDenseSmemBudget / (kmax * 4);
  if (rc > kRowChunk) rc = kRowChunk;
  return rc < 1 ? 1 : rc;
}

// Grid and shared memory for these widths on the current device; the
// attribute and occupancy queries run once per (instance, widths, device).
template <int CD, int KC, int D>
cudaError_t configure(int dm, int dff, int* grid, int* smem) {
  static int c_dm = -1, c_dff = -1, c_dev = -1, c_grid = 0, c_smem = 0;
  int dev0 = 0;
  cudaError_t err0 = cudaGetDevice(&dev0);
  if (err0 != cudaSuccess) return err0;
  if (dm == c_dm && dff == c_dff && dev0 == c_dev) {
    *grid = c_grid;
    *smem = c_smem;
    return cudaSuccess;
  }
  const int kmax = dm > dff ? dm : dff;
  const int dense = (dense_row_chunk(dm, dff) * kmax + kLoraSmemFloats) * 4;
  const int attn = attn_smem_bytes<CD, KC, D>();
  *smem = dense > attn ? dense : attn;
  auto kernel = fused_layers_kernel<CD, KC, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, *smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = sms * (per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm);
  c_dm = dm; c_dff = dff; c_dev = dev; c_grid = *grid; c_smem = *smem;
  return cudaSuccess;
}

template <int CD, int KC, int D>
cudaError_t launch(Params p, cudaStream_t stream) {
  int grid = 0, smem = 0;
  cudaError_t err = configure<CD, KC, D>(p.dm, p.dff, &grid, &smem);
  if (err != cudaSuccess) return err;
  p.row_chunk = dense_row_chunk(p.dm, p.dff);
  err = cudaMemsetAsync(p.scratch, 0, kScratchHead * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_layers_kernel<CD, KC, D>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" int dtc_fused_layers(const void* x_in, void* x_out, const void* weights,
                                void* k_cache, void* v_cache, float* k_scale, float* v_scale,
                                const int* start, float* scratch, int B, int T, int L, int S,
                                int dm, int H, int D, int dff, int per_row, float att_scale,
                                int c_dtype, int kv_dtype, const void* lora_table,
                                const int* lora_ids, int lora_mask, int rank, int lora_layers,
                                float lora_scale, void* stream) {
  if (c_dtype != DTC_CD || kv_dtype != DTC_KV) return static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || T < 1 || T > kMaxT || L < 1 || S < T || H < 1 || H * D != dm || dm % 4 != 0 ||
      dff % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (lora_mask != 0 && (lora_table == nullptr || rank < 1 || rank > kLoraMaxRank ||
                         lora_layers < L || (lora_mask >> kLoraSites) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x_in = x_in;
  p.x_out = x_out;
  p.w = static_cast<const float* const*>(weights);
  p.k_cache = k_cache;
  p.v_cache = v_cache;
  p.k_scale = k_scale;
  p.v_scale = v_scale;
  p.start = start;
  p.scratch = scratch;
  p.B = B; p.T = T; p.L = L; p.S = S; p.dm = dm; p.H = H; p.dff = dff;
  p.per_row = per_row;
  p.row_chunk = 1;
  p.att_scale = att_scale;
  p.lw = lora_mask ? static_cast<const float* const*>(lora_table) : nullptr;
  p.lora_ids = lora_ids;
  p.lora_mask = lora_mask;
  p.rank = rank;
  p.lora_L = lora_layers;
  p.lora_scale = lora_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<DTC_CD, DTC_KV, 16>(p, st);
    case 32: return launch<DTC_CD, DTC_KV, 32>(p, st);
    case 64: return launch<DTC_CD, DTC_KV, 64>(p, st);
    case 128: return launch<DTC_CD, DTC_KV, 128>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch geometry the kernel takes for these widths: blocks in the grid
// and dynamic shared memory per block.
extern "C" int dtc_fused_layers_config(int dm, int dff, int D, int c_dtype, int kv_dtype,
                                       int* grid, int* smem) {
  if (c_dtype != DTC_CD || kv_dtype != DTC_KV) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16: return configure<DTC_CD, DTC_KV, 16>(dm, dff, grid, smem);
    case 32: return configure<DTC_CD, DTC_KV, 32>(dm, dff, grid, smem);
    case 64: return configure<DTC_CD, DTC_KV, 64>(dm, dff, grid, smem);
    case 128: return configure<DTC_CD, DTC_KV, 128>(dm, dff, grid, smem);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* dtc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
