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
// positions in registers with fp32 p; here they are read like any cached
// column (see attention_unit), which makes a verify window row equal to a
// single-token step bit for bit.
//
// Bound: bytes. At the flagship (B 4, T 1, 12 layers of d_model 512, d_ff
// 2048, fp32 weights) a call must read 151.3 MB of weights plus the K/V up
// to the frontiers, 45-60 us at 3.35 TB/s; its operations are about 0.3
// GFLOP (2.4 GFLOP at R = B * T = 32, 36 us on the CUDA cores' 67 TFLOP/s:
// the same order as the bytes, so the products stay on the CUDA cores).
//
// Design. Every output column of layer l + 1 needs whole rows of layer l,
// and Hopper blocks run in any order, so this is one persistent cooperative
// kernel, one block per SM (eight consumer warps that do every phase's work
// and a producer warp, in a warpgroup of its own so that setmaxnreg can give
// the consumers 232 registers where nine warps would cap them at 168 and
// spill), whose phases are separated by grid-wide barriers.
// Per layer: (Q) LN1 + q/k/v, (A) attention, (O) out_proj + residual, (F1)
// LN2 + fc1 + GELU, (F2) fc2 + residual: 5 L - 1 barriers a call. The
// first design (two blocks an SM, one block per (row, head) for attention)
// held back on six counts; what this one does about each:
//  (a) The weight stream runs ahead of the barriers. Each phase's output
//      columns are cut statically over the blocks, so a block knows every
//      weight byte it will read in the whole call, in order: tiles of up to
//      16 columns (two a consumer warp) x 512 K-values. The producer warp
//      keeps a ring of kStages tiles in shared memory filled with 1-D bulk
//      asynchronous copies (cp.async.bulk, one a column issued by its own
//      lane, completion on the stage's `full` mbarrier; the fp32 rows are
//      contiguous and 16-byte aligned, so no tensor map), refilling a stage
//      as soon as the consumers release it (its `empty` mbarrier), whatever
//      phase or layer the next tile belongs to. A block waiting at a barrier
//      has the next tiles in flight, so no phase begins with a DRAM round
//      trip for its weights, and no consumer spends time issuing copies.
//      Before, a warp began loading a column's weight row only after the
//      phase's input was staged, itself after the barrier.
//  (b) Each weight byte is read once a call, whatever B * T is (up to 32
//      rows). A phase loops over K in chunks of 512 with every row's
//      accumulators in registers (two columns a warp, 4, 8, 16 or 32 rows
//      a lane), where the first design staged at most 8 rows at once and
//      streamed the weights again for every chunk of rows. A phase stages
//      its rows once where they fit (LayerNorm statistics and LoRA z then
//      come from shared memory). Plain copies (the raw residual, the GELU
//      output, the LayerNorm parameters) go by cp.async, every copy of a
//      thread in flight, so staging is one L2 round trip after the barrier.
//  (c) Attention is spread over every SM. Each (batch row, head)'s cached
//      positions are cut into splits of a length fixed by D and the cache
//      dtype (Geometry below), never by B or another row's frontier: a unit
//      is one (row, head, split), and the units are dealt over the blocks.
//      Every thread issues all its K and V loads of the split (4 positions'
//      16-byte chunks each) before using any, as the split-KV decode kernel
//      does (csrc/decode_attention.cu). Rounding p against each split's own
//      max would move outputs past phase 9's share limit (a CPU simulation
//      at the flagship: 20% of one layer's bf16 outputs differ against a
//      limit of 10%), so the splits of a (row, head) exchange their maxima
//      first: each publishes its max and adds one to a per-(row, head)
//      counter, waits for the others, and rounds p against the row's max,
//      exactly as one block over the whole row would. A row of one split
//      exchanges nothing. Each split writes float32 partials (its sum of p
//      and of p.V, and split 0 the position's own term); the out_proj phase
//      combines them in split order while it stages its input rows, so the
//      combine adds no barrier. Before, one block took one (row, head) with
//      two passes over K and one 2-byte V load at a time: 64 of 264 blocks
//      at the flagship.
//  (d) Fewer and cheaper grid barriers: no barrier after an input copy
//      (layer 0's LN1 and residual read x_in itself), arrival by
//      red.release.gpu and a spin on ld.acquire.gpu with no sleep on the
//      fast path (a timer and a short sleep only after many polls, a trap
//      after 5 s), and one block per SM (132 arrivals, not 264).
//  (e) The barrier and per-(row, head) counters are zeroed by a
//      cudaMemsetAsync before each launch, in a scratch the wrapper
//      allocates for the call: nothing outlives a call, so calls on any
//      streams, a graph replayed on another stream among them, stand alone.
//  (f) Head dims 16 to 128 in steps of 16. A head row of D / N 16-byte
//      chunks that is not a power of two (D 48, 80, 96, 112 in some dtypes)
//      leaves a position group's last lanes idle: they load nothing, write
//      no shared memory, and take part in every shuffle with zeros.
//
// Determinism and row independence. No atomics in any sum (the counters
// only order). Each output's sum runs in an order fixed by the shapes
// (d_model, d_ff, S, D) and the row's own frontier, never by B, T, the grid
// or another row's data: a dense sum is lane-strided over K then reduced
// over the warp in a fixed tree; attention sums over a split's positions in
// a fixed tree and over the splits in split order. So two launches give the
// same bits, row j of a window at frontier f equals a single-token step at
// frontier f + j bit for bit, and a row does not change with B.
//
// Plain C interface (ctypes): dtc_fused_layers zeroes the counters and
// launches on the given stream, never synchronises, and returns
// cudaGetLastError() or the launch's error; dtc_fused_layers_scratch_floats
// sizes the scratch the wrapper allocates.
//
// Build: one library per (compute, KV) dtype pair, selected with
// -DDTC_CD=<0|1> -DDTC_KV=<0|1|2> (the dtype codes below), each holding the
// eight head-dim instances, so the pairs compile in parallel processes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#if !defined(DTC_CD) || !defined(DTC_KV)
#error "build with -DDTC_CD=<0|1> -DDTC_KV=<0|1|2> (compute and KV dtype codes)"
#endif

namespace {

// Two consumer warpgroups (eight warps) and a producer warpgroup, of which
// one warp copies. Registers are allocated per SM sub-partition, so a block
// of nine or twelve warps caps a thread at 168 (the first design spilled
// there); setmaxnreg moves them: the producers keep kProducerRegs, the
// consumers take kConsumerRegs (128 * 40 + 256 * 232 <= 65536).
constexpr int kThreads = 256;      // the consumer warps: every phase's work
constexpr int kWarps = kThreads / 32;
constexpr int kBlockThreads = kThreads + 128;  // and the producer warpgroup
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kMaxT = 8;           // widest verify window (SPEC_MAX_K)
constexpr int kMaxRows = 32;       // rows of one row block: accumulators a lane
constexpr int kKc = 512;           // K values of a weight tile and of a staged chunk
constexpr int kGroupCols = 2 * kWarps;  // columns of a weight tile: two a warp
constexpr int kStageFloats = kGroupCols * kKc;
constexpr int kStages = 4;         // weight tiles in flight
constexpr int kPerGroup = 4;       // positions a thread group holds of one split
constexpr int kWeights = 16;       // weight pointers per layer
constexpr int kCounterBase = 64;   // scratch head: [0] the grid barrier, then (B, H)
constexpr int kLoraSites = 6;      // q, k, v, out_proj, fc1, fc2: mask bits 0..5
constexpr int kLoraMaxRank = 64;   // LORA_MAX_RANK
constexpr float kLnEps = 1e-6f;
constexpr float kScaleFloor = 1e-8f;  // KV_SCALE_FLOOR
constexpr unsigned long long kBarrierTimeoutNs = 5000000000ull;
constexpr int kFastPolls = 4096;   // polls before a wait reads the timer


// Shared memory, in floats: the weight ring, then a work area that the
// dense phases (staged rows, LayerNorm statistics, LoRA z, slots) and the
// attention units (AttnSmem) take in turn, then the ring's mbarriers.
constexpr int kRingFloats = kStages * kStageFloats;
constexpr int kInFloats = kMaxRows * kKc;
constexpr int kZFloats = 3 * kMaxRows * kLoraMaxRank;
constexpr int kAreaFloats = kInFloats + 2 * kMaxRows + kZFloats + kMaxRows;
constexpr int kSmemBytes = (kRingFloats + kAreaFloats) * 4 + 2 * kStages * 8;

// Weight table order, per layer.
enum {
  kLn1W = 0, kLn1B, kQW, kQB, kKW, kKB, kVW, kVB, kOW, kOB,
  kLn2W, kLn2B, kFc1W, kFc1B, kFc2W, kFc2B
};

// The dense phases of a layer, in order.
enum { kPhQ = 0, kPhO = 1, kPhF1 = 2, kPhF2 = 3, kPhases = 4 };

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

// How an attention unit covers its split: N cache elements a thread (one
// 16-byte chunk), TPG threads a position (kChunks of them loading), G
// positions a pass, kSplit = kPerGroup * G positions a split.
template <int KC, int D> struct Geometry {
  static constexpr int kBytes = Size<KC>::value;
  static constexpr int N = 16 / kBytes;
  static constexpr int kChunks = D / N;
  static constexpr int TPG = pow2_at_least(kChunks);
  static constexpr int G = kThreads / TPG;
  static constexpr int kSplit = kPerGroup * G;
  static_assert(D % N == 0 && TPG <= 32, "unsupported head_dim");
};

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

__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

// The consumer warps' barrier (barrier 1; the producer warpgroup never joins).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

// --- ordering between blocks ------------------------------------------------

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(unsigned int* p, unsigned int v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spins (one thread) until *p >= target: plain acquire polls first; after
// kFastPolls a timer and a short sleep, and a trap past the timeout rather
// than a hung card.
__device__ __forceinline__ void spin_until(const unsigned int* p, unsigned int target) {
  unsigned int polls = 0;
  unsigned long long t0 = 0;
  while (ld_acquire(p) < target) {
    if (++polls < kFastPolls) continue;
    const unsigned long long now = global_ns();
    if (t0 == 0) {
      t0 = now;
    } else if (now - t0 > kBarrierTimeoutNs) {
      __trap();
    }
    __nanosleep(64);
  }
}

// Grid-wide barrier number `k` (1, 2, ...): every block adds one arrival
// (release: the block's writes, ordered before it by consumer_sync, travel
// with it) and waits for k * gridDim.x of them (acquire). The cooperative
// launch guarantees that all blocks are resident.
__device__ __forceinline__ void grid_barrier(unsigned int* bar, unsigned int k) {
  consumer_sync();
  if (threadIdx.x == 0) {
    red_release_add(bar, 1u);
    spin_until(bar, k * gridDim.x);
  }
  consumer_sync();
}

// --- the weight ring ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed; a
// wait that never ends traps (the launch's caller sees an error).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (tries == (1u << 26)) __trap();
  }
}

// One 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global into shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 16 bytes from global (through L2 only, as __ldcg reads: other blocks wrote
// them) into shared memory, asynchronously and without a register: a
// thread's copies are all in flight until cp_async_wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
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
  float* scratch;              // counters + buffers (Layout)
  int B, T, L, S, dm, H, dff, per_row;
  float att_scale;             // D^-0.5 rounded to the compute dtype
  const float* const* lw;      // (L, 2 * kLoraSites) slot 0's A, B pointers, or null
  const int* lora_ids;         // (B,) adapter slots, or null: slot 0 for every row
  int lora_mask, rank, lora_L; // sites present, rank, layers in the factor stack
  float lora_scale;            // alpha / rank rounded to the compute dtype
};

// The scratch, in floats from its start. Partial records are D + 4 floats
// (sum of p.V over D, then the sum of p; 16-byte aligned).
struct Layout {
  size_t head, xbuf, qkv, gbuf, mx, part, own, total;
  int splits;  // the most splits a (row, head) can have
};

__host__ __device__ inline Layout make_layout(int B, int T, int S, int dm, int H, int D, int dff,
                                              int split) {
  Layout o;
  const size_t R = static_cast<size_t>(B) * T;
  o.splits = (S + split - 1) / split;
  o.head = ((kCounterBase + static_cast<size_t>(B) * H) + 63) / 64 * 64;
  o.xbuf = o.head;
  o.qkv = o.xbuf + R * dm;
  o.gbuf = o.qkv + R * 3 * dm;
  o.mx = o.gbuf + R * dff;
  o.part = o.mx + (R * H * o.splits + 3) / 4 * 4;
  o.own = o.part + R * H * o.splits * (D + 4);
  o.total = o.own + R * H * (D + 4);
  return o;
}

__device__ __forceinline__ int lora_slot(const Params& p, int row) {
  return p.lora_ids ? p.lora_ids[row / p.T] : 0;
}

// --- the dense phases' static plan ---------------------------------------------

struct PhaseGeo {
  int K, N, lo, hi, nkc, ngroups, nrb;
};

// Computed once per block into shared memory (the hot paths read it there).
__device__ __forceinline__ PhaseGeo phase_geo(const Params& p, int ph) {
  PhaseGeo g;
  const int HD = p.dm;
  g.K = ph == kPhQ ? p.dm : ph == kPhO ? HD : ph == kPhF1 ? p.dm : p.dff;
  g.N = ph == kPhQ ? 3 * HD : ph == kPhO ? p.dm : ph == kPhF1 ? p.dff : p.dm;
  g.lo = static_cast<int>(static_cast<unsigned int>(g.N) * blockIdx.x / gridDim.x);
  g.hi = static_cast<int>(static_cast<unsigned int>(g.N) * (blockIdx.x + 1) / gridDim.x);
  g.nkc = (g.K + kKc - 1) / kKc;
  g.ngroups = (g.hi - g.lo + kGroupCols - 1) / kGroupCols;
  g.nrb = (p.B * p.T + kMaxRows - 1) / kMaxRows;
  return g;
}

// Column `col` of phase `ph`: its weight row (PyTorch's (out, in) layout, so
// contiguous) and its bias.
__device__ __forceinline__ const float* weight_row(const float* const* wl, int ph, int col,
                                                   int K, int HD, const float** bias) {
  int wi = ph == kPhQ ? kQW : ph == kPhO ? kOW : ph == kPhF1 ? kFc1W : kFc2W;
  int jj = col;
  if (ph == kPhQ) {
    wi += 2 * (col / HD);
    jj = col % HD;
  }
  *bias = wl[wi + 1] + jj;
  return wl[wi] + static_cast<size_t>(jj) * K;
}

// A position in the call's sequence of weight tiles: layer, phase, row
// block, column group, K chunk; the order the dense phases consume them in.
struct Tile {
  int l, ph, rb, cg, kc;
};

// Moves `t` to the next tile of this block (`geo`: its phases' plan);
// false past the last.
__device__ bool next_tile(const Params& p, const PhaseGeo* geo, Tile& t) {
  const PhaseGeo& g = geo[t.ph];
  if (++t.kc < g.nkc) return true;
  t.kc = 0;
  if (++t.cg < g.ngroups) return true;
  t.cg = 0;
  if (++t.rb < g.nrb) return true;
  t.rb = 0;
  do {
    if (++t.ph == kPhases) {
      t.ph = 0;
      if (++t.l == p.L) return false;
    }
  } while (geo[t.ph].hi <= geo[t.ph].lo);
  return true;
}

// The first tile of this block (`geo`: its phases' plan); false if the
// block has no columns at all.
__device__ bool first_tile(const Params& p, const PhaseGeo* geo, Tile& t) {
  t = Tile{0, 0, 0, 0, 0};
  while (geo[t.ph].hi <= geo[t.ph].lo) {
    if (++t.ph == kPhases) {
      t.ph = 0;
      if (++t.l == p.L) return false;
    }
  }
  return true;
}

// The producer warp: every tile of the call in order, each into the next
// ring stage as soon as the consumers release it (its `empty` barrier):
// lane 0 sets the stage's expected bytes on its `full` barrier, lane c
// copies column c's K chunk (the copies issued in parallel).
__device__ void produce(const Params& p, const PhaseGeo* geo, float* ring, uint64_t* full,
                        uint64_t* empty) {
  const int lane = threadIdx.x & 31;
  Tile t;
  bool more = first_tile(p, geo, t);
  for (unsigned int n = 0; more; ++n) {
    const int slot = static_cast<int>(n % kStages);
    if (n >= kStages) mbar_wait(empty + slot, (n / kStages - 1) & 1u);
    const PhaseGeo& g = geo[t.ph];
    const int c0 = g.lo + t.cg * kGroupCols;
    const int nc = min(kGroupCols, g.hi - c0);
    const int k0 = t.kc * kKc;
    const uint32_t bytes = static_cast<uint32_t>(min(kKc, g.K - k0)) * 4u;
    if (lane == 0) mbar_expect_tx(full + slot, bytes * nc);
    __syncwarp();
    if (lane < nc) {
      const float* const* wl = p.w + static_cast<size_t>(t.l) * kWeights;
      const float* bias;
      const float* src = weight_row(wl, t.ph, c0 + lane, g.K, p.dm, &bias) + k0;
      // The stage's last reads (generic proxy) come before the copy's writes.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bulk_load(ring + static_cast<size_t>(slot) * kStageFloats + lane * kKc, src, bytes,
                full + slot);
    }
    more = next_tile(p, geo, t);
  }
}

// --- the dense phases -----------------------------------------------------------

enum Src { kSrcLn = 0, kSrcCombine = 1, kSrcBuf = 2 };

// Where a dense phase's input rows come from.
template <int CD>
struct Input {
  const Params* p;
  int src;
  const float* buf;     // xbuf (LN) or gbuf; null for the residual x_in
  const float* ln_w;
  const float* ln_b;
  const float* s_mean;  // LayerNorm statistics of the row block (shared memory)
  const float* s_rstd;
  const float* part;    // attention partials (combine)
  const float* own;
  int splits;           // the most splits a (row, head) has (Layout)
  int D, split;         // head dim, positions a split

  // The raw residual value (row r, column k) LayerNorm reads.
  __device__ __forceinline__ float raw(int r, int k) const {
    const size_t i = static_cast<size_t>(r) * p->dm + k;
    return buf ? __ldcg(buf + i) : load_t<CD>(p->x_in, i);
  }

  // Staged values (compute-dtype values in floats) of row r, columns k..k+3
  // (row r - rb0 of the row block's statistics).
  __device__ __forceinline__ float4 get4(int r, int ri, int k) const {
    if (src == kSrcBuf) return ldcg4(buf + static_cast<size_t>(r) * p->dff + k);
    if (src == kSrcLn) {
      float v[4];
      if (buf) {
        const float4 x = ldcg4(buf + static_cast<size_t>(r) * p->dm + k);
        v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = raw(r, k + q);
      }
      const float4 w4 = __ldg(reinterpret_cast<const float4*>(ln_w + k));
      const float4 b4 = __ldg(reinterpret_cast<const float4*>(ln_b + k));
      const float mean = s_mean[ri], rstd = s_rstd[ri];
      return make_float4(rnd<CD>((v[0] - mean) * (rstd * w4.x) + b4.x),
                         rnd<CD>((v[1] - mean) * (rstd * w4.y) + b4.y),
                         rnd<CD>((v[2] - mean) * (rstd * w4.z) + b4.z),
                         rnd<CD>((v[3] - mean) * (rstd * w4.w) + b4.w));
    }
    // The attention output of (row r, head h), elements d..d+3: the splits'
    // sums of p.V and of p added in split order, then the position's own
    // term, divided. The own term's loads and split 0's go out together.
    const int h = k / D, d = k - h * D;
    const size_t rh = static_cast<size_t>(r) * p->H + h;
    const float* po = own + rh * (D + 4);
    const float* pa = part + rh * splits * (D + 4);
    const float4 v = ldcg4(po + d);
    const float e = __ldcg(po + D);
    const float4 x0 = ldcg4(pa + d);
    float4 a = make_float4(0.f + x0.x, 0.f + x0.y, 0.f + x0.z, 0.f + x0.w);
    float l = 0.f + __ldcg(pa + D);
    int start = p->per_row ? p->start[r / p->T] : p->start[0];
    start = max(start, 0);
    const int n_max = min(start + p->T - 1, p->S);
    const int ns = max(1, (n_max + split - 1) / split);
    for (int s = 1; s < ns; ++s) {
      const float4 x = ldcg4(pa + static_cast<size_t>(s) * (D + 4) + d);
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      l += __ldcg(pa + static_cast<size_t>(s) * (D + 4) + D);
    }
    l += e;
    return make_float4(rnd<CD>((a.x + e * v.x) / l), rnd<CD>((a.y + e * v.y) / l),
                       rnd<CD>((a.z + e * v.z) / l), rnd<CD>((a.w + e * v.w) / l));
  }
};

// LayerNorm statistics of rows rb0 .. rb0 + nr - 1: one warp a row, lane-
// strided sums then the warp's tree, so the bits are set by K alone.
template <int CD>
__device__ void ln_stats(const Input<CD>& in, int rb0, int nr, int K, float* s_mean,
                         float* s_rstd) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < nr; i += kWarps) {
    float s = 0.f, s2 = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float v = in.raw(rb0 + i, k);
      s += v;
      s2 = fmaf(v, v, s2);
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    if (lane == 0) {
      const float mean = s / K;
      const float var = fmaxf(s2 / K - mean * mean, 0.f);
      s_mean[i] = mean;
      s_rstd[i] = 1.f / sqrtf(var + kLnEps);
    }
  }
}

// z[s][i][k] = round(sum_kk in[i][kk] * round(A_s[slot(i)][k][kk])) for the
// row block's rows i < nr, every rank k and each site site0 + s (s <
// nsites) set in `need`. One warp per (s, i, four ranks), the four rows of
// A in flight together; each z sums its lane's stride of the input row in
// order, then across lanes, so its bits are set by K alone. `row4(i, kk)`
// gives row i's values kk..kk+3 (staged rows in shared memory, or the
// input in L2). Also leaves each row's adapter slot in s_slot.
template <int CD, class Row4>
__device__ void lora_z(const Params& p, Row4 row4, float* s_z, int* s_slot, int rb0, int nr,
                       int K, const float* const* lwl, int site0, int nsites, int need) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int R = p.rank;
  const int groups = (R + 3) / 4;
  if (threadIdx.x < nr) s_slot[threadIdx.x] = lora_slot(p, rb0 + threadIdx.x);
  for (int task = warp; task < nsites * nr * groups; task += kWarps) {
    const int s = task / (nr * groups), rest = task - s * nr * groups;
    const int i = rest / groups, k0 = (rest - i * groups) * 4;
    if (!((need >> s) & 1)) continue;
    const int slot = lora_slot(p, rb0 + i);
    const float* a = lwl[2 * (site0 + s)] + (static_cast<size_t>(slot) * p.lora_L * R + k0) * K;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int kk = lane * 4; kk < K; kk += 128) {
      const float4 x4 = row4(i, kk);
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
      if (lane == 0 && k0 + q < R) s_z[(s * kMaxRows + i) * R + k0 + q] = rnd<CD>(t);
    }
  }
}

// Everything a dense phase of one layer needs.
struct DenseCtx {
  float* ring;
  uint64_t* mbar;
  float* s_in;
  float* s_mean;
  float* s_rstd;
  float* s_z;
  int* s_slot;
  uint64_t* empty;         // the ring stages' release barriers
  unsigned int* consumed;  // tiles consumed by the block so far
  Layout lay;              // the scratch
  int D, split;            // head dim, positions an attention split
  const PhaseGeo* geo;     // the block's plan of each dense phase (shared memory)
};

// One column group of a row block: every K chunk's staged rows times the
// group's weight tile, the warp's two columns with RB rows of accumulators
// a lane, then the epilogue. With `whole` (RB rows of K fit the staging
// area), the group's first chunk stages the row block's entire rows (row
// stride K) for every K chunk and column group: their LayerNorm statistics
// from shared memory where `stats_here`, and their LoRA z where `need`.
// Otherwise it stages chunk by chunk (row stride kKc), once for every
// column group when K is one chunk.
template <int CD, int RB>
__device__ void dense_group(const Params& p, const DenseCtx& c, const Input<CD>& in,
                            const PhaseGeo& g, int ph, int l, int rb0, int nr, int cg,
                            bool whole, bool stats_here, const float* const* wl,
                            const float* const* lwl, int site0, int nsites, int need) {
  constexpr int kBatch = 4;  // float4s a thread has in flight while staging
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tid = threadIdx.x;
  const int HD = p.dm;
  const int c0 = g.lo + cg * kGroupCols;
  const int nc = min(kGroupCols, g.hi - c0);
  const int col0 = c0 + 2 * warp;  // the warp's two columns
  const int row = lane;            // the row this lane writes
  const bool writer = row < nr;
  const int nsc = g.N / nsites;    // columns of one LoRA site
  // The bias, and for the writing lanes the residual, loaded before the
  // products need them.
  float bias[2], prev[2] = {0.f, 0.f};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    bias[u] = 0.f;
    if (2 * warp + u < nc) {
      const float* bp;
      weight_row(wl, ph, col0 + u, g.K, HD, &bp);
      bias[u] = __ldg(bp);
      if (writer && (ph == kPhO || ph == kPhF2)) {
        const size_t i = static_cast<size_t>(rb0 + row) * g.N + col0 + u;
        prev[u] = (ph == kPhO && l == 0) ? load_t<CD>(p.x_in, i) : __ldcg(p.scratch + c.lay.xbuf + i);
      }
    }
  }
  float acc[2][RB];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int i = 0; i < RB; ++i) acc[u][i] = 0.f;
  }
  const int stride = whole ? g.K : kKc;
  for (int kc = 0; kc < g.nkc; ++kc) {
    const int k0 = kc * kKc;
    const int kn = min(kKc, g.K - k0);
    if (whole ? (cg == 0 && kc == 0) : (cg == 0 || g.nkc > 1)) {
      const int ks = whole ? 0 : k0;         // first column staged
      const int q4 = (whole ? g.K : kn) / 4;  // float4s a staged row
      const int nx = RB * q4;
      // LayerNorm parameters, where the statistics come from the staged rows:
      // in the LoRA z area, which lora_z fills only after the normalization.
      float* s_w = c.s_z;
      float* s_b = s_w + g.K;
      const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (in.src == kSrcBuf || (stats_here && in.buf)) {
        // Plain copies from L2 (the raw residual or the GELU output, and the
        // LayerNorm parameters): every one of a thread's copies in flight at
        // once, one round trip for the whole staging.
        const int np = stats_here ? 2 * q4 : 0;
        for (int x = tid; x < nx + np; x += kThreads) {
          if (x < nx) {
            const int i = x / q4, kk = (x - i * q4) * 4;
            float* dst = c.s_in + i * stride + kk;
            if (i < nr) {
              cp_async16(dst, in.buf + static_cast<size_t>(rb0 + i) * g.K + ks + kk);
            } else {
              *reinterpret_cast<float4*>(dst) = zero4;
            }
          } else {
            const int y = x - nx, w = y / q4, kk = (y - w * q4) * 4;
            cp_async16(s_w + w * g.K + kk, (w ? in.ln_b : in.ln_w) + kk);
          }
        }
        cp_async_wait();
      } else {
        // The attention combine, layer 0's LayerNorm input (x_in, in the
        // compute dtype), or rows normalized from L2 with statistics from
        // there: kBatch float4s a thread in flight before any is stored.
        if (stats_here) {
          for (int x = tid; x < q4; x += kThreads) {
            *reinterpret_cast<float4*>(s_w + 4 * x) = __ldg(reinterpret_cast<const float4*>(in.ln_w) + x);
            *reinterpret_cast<float4*>(s_b + 4 * x) = __ldg(reinterpret_cast<const float4*>(in.ln_b) + x);
          }
        }
        for (int x0 = tid; x0 < nx; x0 += kBatch * kThreads) {
          float4 v[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int x = x0 + u * kThreads, i = x / q4, kk = (x - i * q4) * 4;
            v[u] = zero4;
            if (x < nx && i < nr) {
              if (!stats_here) {
                v[u] = in.get4(rb0 + i, i, ks + kk);
              } else {
                v[u] = make_float4(in.raw(rb0 + i, kk), in.raw(rb0 + i, kk + 1),
                                   in.raw(rb0 + i, kk + 2), in.raw(rb0 + i, kk + 3));
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int x = x0 + u * kThreads, i = x / q4, kk = (x - i * q4) * 4;
            if (x < nx) *reinterpret_cast<float4*>(c.s_in + i * stride + kk) = v[u];
          }
        }
      }
      if (stats_here) {
        // The rows' statistics from shared memory (the order ln_stats
        // takes), then the normalized values in place.
        consumer_sync();
        for (int i = warp; i < nr; i += kWarps) {
          float s = 0.f, s2 = 0.f;
          for (int k = lane; k < g.K; k += 32) {
            const float v = c.s_in[i * stride + k];
            s += v;
            s2 = fmaf(v, v, s2);
          }
          s = warp_sum(s);
          s2 = warp_sum(s2);
          if (lane == 0) {
            const float mean = s / g.K;
            const float var = fmaxf(s2 / g.K - mean * mean, 0.f);
            c.s_mean[i] = mean;
            c.s_rstd[i] = 1.f / sqrtf(var + kLnEps);
          }
        }
        consumer_sync();
        for (int x = tid; x < nr * q4; x += kThreads) {
          const int i = x / q4, kk = (x - i * q4) * 4;
          float4 v = *reinterpret_cast<const float4*>(c.s_in + i * stride + kk);
          const float4 w4 = *reinterpret_cast<const float4*>(s_w + kk);
          const float4 b4 = *reinterpret_cast<const float4*>(s_b + kk);
          const float mean = c.s_mean[i], rstd = c.s_rstd[i];
          v.x = rnd<CD>((v.x - mean) * (rstd * w4.x) + b4.x);
          v.y = rnd<CD>((v.y - mean) * (rstd * w4.y) + b4.y);
          v.z = rnd<CD>((v.z - mean) * (rstd * w4.z) + b4.z);
          v.w = rnd<CD>((v.w - mean) * (rstd * w4.w) + b4.w);
          *reinterpret_cast<float4*>(c.s_in + i * stride + kk) = v;
        }
      }
      if (whole && need) {
        consumer_sync();
        lora_z<CD>(p, [&](int i, int kk) {
          return *reinterpret_cast<const float4*>(c.s_in + i * stride + kk);
        }, c.s_z, c.s_slot, rb0, nr, g.K, lwl, site0, nsites, need);
      }
    }
    consumer_sync();
    const unsigned int n = *c.consumed;
    const int slot = static_cast<int>(n % kStages);
    mbar_wait(c.mbar + slot, (n / kStages) & 1u);
    const float* stage = c.ring + static_cast<size_t>(slot) * kStageFloats;
    const int xoff = whole ? k0 : 0;  // the chunk's first column in the staged rows
    if (2 * warp < nc) {
      const bool two = 2 * warp + 1 < nc;
      const float* w0 = stage + (2 * warp) * kKc;
      const float* w1 = stage + (2 * warp + 1) * kKc;
#pragma unroll
      for (int it = 0; it < kKc / 128; ++it) {
        const int kk = lane * 4 + it * 128;
        if (kk < kn) {
          float4 a = *reinterpret_cast<const float4*>(w0 + kk);
          float4 b = two ? *reinterpret_cast<const float4*>(w1 + kk)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
          a.x = rnd<CD>(a.x); a.y = rnd<CD>(a.y); a.z = rnd<CD>(a.z); a.w = rnd<CD>(a.w);
          b.x = rnd<CD>(b.x); b.y = rnd<CD>(b.y); b.z = rnd<CD>(b.z); b.w = rnd<CD>(b.w);
#pragma unroll
          for (int i = 0; i < RB; ++i) {
            const float4 x = *reinterpret_cast<const float4*>(c.s_in + i * stride + xoff + kk);
            acc[0][i] = fmaf(x.x, a.x, acc[0][i]);
            acc[0][i] = fmaf(x.y, a.y, acc[0][i]);
            acc[0][i] = fmaf(x.z, a.z, acc[0][i]);
            acc[0][i] = fmaf(x.w, a.w, acc[0][i]);
            acc[1][i] = fmaf(x.x, b.x, acc[1][i]);
            acc[1][i] = fmaf(x.y, b.y, acc[1][i]);
            acc[1][i] = fmaf(x.z, b.z, acc[1][i]);
            acc[1][i] = fmaf(x.w, b.w, acc[1][i]);
          }
        }
      }
    }
    consumer_sync();  // the stage and the staged chunk are free
    if (tid == 0) {
      *c.consumed = n + 1;
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(c.empty + slot))
                   : "memory");
    }
  }

  // Epilogue: each column's sums over the warp, lane i keeping row i's.
  const bool last_layer = l == p.L - 1;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int col = col0 + u;
    if (2 * warp + u >= nc) continue;  // warp-uniform
    float mine = 0.f;
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const float t = warp_sum(acc[u][i]);
      if (lane == i) mine = t;
    }
    if (!writer) continue;
    const int r = rb0 + row;
    const int which = col / nsc, jj = col - which * nsc;
    float o = rnd<CD>(rnd<CD>(mine) + rnd<CD>(bias[u]));
    if ((need >> which) & 1) {
      // delta = sum_k z_k * round(B[j, k]) in order of k, eight loads of
      // the row of B in flight at a time.
      const float* brow = lwl[2 * (site0 + which) + 1] +
                          (static_cast<size_t>(c.s_slot[row]) * p.lora_L * nsc + jj) * p.rank;
      const float* z = c.s_z + (which * kMaxRows + row) * p.rank;
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
    const Layout& lay = c.lay;
    if (ph == kPhQ) {
      p.scratch[lay.qkv + static_cast<size_t>(r) * g.N + col] = o;
    } else if (ph == kPhF1) {
      p.scratch[lay.gbuf + static_cast<size_t>(r) * g.N + col] = rnd<CD>(gelu_tanh(o));
    } else {
      // Residual (prefetched): layer 0's out_proj reads x_in, every later
      // one xbuf.
      float* xp = p.scratch + lay.xbuf + static_cast<size_t>(r) * g.N + col;
      const float x = rnd<CD>(prev[u] + o);
      *xp = x;
      if (ph == kPhF2 && last_layer) store_t<CD>(p.x_out, static_cast<size_t>(r) * g.N + col, x);
    }
  }
}

// One dense phase of layer l: for each row block, its LayerNorm statistics
// and LoRA z where needed, then each column group of the block's columns.
// The kernel calls it from one place (its phase loop), so each instance
// holds one copy of it.
template <int CD>
__device__ __forceinline__ void dense_phase(const Params& p, const DenseCtx& c, int ph, int l) {
  const PhaseGeo g = c.geo[ph];
  if (g.hi <= g.lo) return;
  const float* const* wl = p.w + static_cast<size_t>(l) * kWeights;
  const float* const* lwl = p.lw ? p.lw + static_cast<size_t>(l) * 2 * kLoraSites : nullptr;
  const Layout& lay = c.lay;
  Input<CD> in;
  in.p = &p;
  in.D = c.D;
  in.split = c.split;
  in.s_mean = c.s_mean;
  in.s_rstd = c.s_rstd;
  in.part = p.scratch + lay.part;
  in.own = p.scratch + lay.own;
  in.splits = lay.splits;
  in.ln_w = in.ln_b = nullptr;
  if (ph == kPhQ || ph == kPhF1) {
    in.src = kSrcLn;
    in.buf = (ph == kPhQ && l == 0) ? nullptr : p.scratch + lay.xbuf;
    in.ln_w = wl[ph == kPhQ ? kLn1W : kLn2W];
    in.ln_b = wl[ph == kPhQ ? kLn1B : kLn2B];
  } else if (ph == kPhO) {
    in.src = kSrcCombine;
    in.buf = nullptr;
  } else {
    in.src = kSrcBuf;
    in.buf = p.scratch + lay.gbuf;
  }
  const int site0 = ph == kPhQ ? 0 : ph == kPhO ? 3 : ph == kPhF1 ? 4 : 5;
  const int nsites = ph == kPhQ ? 3 : 1;
  // The adapter sites this block's columns fall in.
  int need = 0;
  if (lwl) {
    const int site_bits = (p.lora_mask >> site0) & ((1 << nsites) - 1);
    const int NS = g.N / nsites;
    for (int s = g.lo / NS; s <= (g.hi - 1) / NS; ++s) need |= 1 << s;
    need &= site_bits;
  }
  const int R = p.B * p.T;
  for (int rb = 0; rb < g.nrb; ++rb) {
    const int rb0 = rb * kMaxRows;
    const int nr = min(kMaxRows, R - rb0);
    // dense_group stages the rows whole where rbv rows of K fit; then the
    // LayerNorm statistics come from shared memory (with the parameters
    // staged in the z area) and z from the staged rows. Otherwise both come
    // from the input in L2 first.
    const int rbv = nr <= 4 ? 4 : nr <= 8 ? 8 : nr <= 16 ? 16 : 32;
    const bool whole = rbv * g.K <= kInFloats;
    const bool stats_here = in.src == kSrcLn && whole && 2 * g.K <= kZFloats;
    if (in.src == kSrcLn && !stats_here) {
      ln_stats(in, rb0, nr, g.K, c.s_mean, c.s_rstd);
      consumer_sync();
    }
    if (need && !whole) {
      lora_z<CD>(p, [&](int i, int kk) { return in.get4(rb0 + i, i, kk); }, c.s_z, c.s_slot,
                 rb0, nr, g.K, lwl, site0, nsites, need);
      consumer_sync();
    }
    for (int cg = 0; cg < g.ngroups; ++cg) {
      if (nr <= 4) {
        dense_group<CD, 4>(p, c, in, g, ph, l, rb0, nr, cg, whole, stats_here, wl, lwl,
                           site0, nsites, need);
      } else if (nr <= 8) {
        dense_group<CD, 8>(p, c, in, g, ph, l, rb0, nr, cg, whole, stats_here, wl, lwl,
                           site0, nsites, need);
      } else if (nr <= 16) {
        dense_group<CD, 16>(p, c, in, g, ph, l, rb0, nr, cg, whole, stats_here, wl, lwl,
                            site0, nsites, need);
      } else {
        dense_group<CD, 32>(p, c, in, g, ph, l, rb0, nr, cg, whole, stats_here, wl, lwl,
                            site0, nsites, need);
      }
    }
    consumer_sync();  // the row block's z and slots are free
  }
}

// --- attention --------------------------------------------------------------------

// Shared memory of one attention unit, in floats from the work area.
template <int D> struct AttnSmem {
  static constexpr int q = 0;                      // (T, D) q, scaled and rounded
  static constexpr int kn = q + kMaxT * D;         // window k as attention reads it
  static constexpr int vn = kn + kMaxT * D;
  static constexpr int kq = vn + kMaxT * D;        // int8 payloads to write
  static constexpr int vq = kq + kMaxT * D;
  static constexpr int ksc = vq + kMaxT * D;       // int8 scales to write
  static constexpr int vsc = ksc + kMaxT;
  static constexpr int own = vsc + kMaxT;          // each position's score on itself
  static constexpr int m = own + kMaxT;            // the row max
  static constexpr int red = m + kMaxT;            // (warps, T) partials
  static constexpr int sl = red + kWarps * kMaxT;  // (warps, T) sums of p
  static constexpr int acc = sl + kWarps * kMaxT;  // (warps, T, D) sums of p.V
  static constexpr int total = acc + kWarps * kMaxT * D;
  static_assert(total <= kAreaFloats, "attention scratch exceeds the work area");
};

enum UnitMode { kUnitFull = 0, kUnitPublish = 1, kUnitFinish = 2 };

// The splits of batch row b's (row, head)s: max(1, ceil(n / split)) with n
// the cached positions the window's last row reads.
template <int KC, int D>
__device__ __forceinline__ int splits_of(const Params& p, int b, int* start_out) {
  int start = p.per_row ? p.start[b] : p.start[0];
  start = max(start, 0);
  *start_out = start;
  const int n_max = min(start + p.T - 1, p.S);
  return max(1, (n_max + Geometry<KC, D>::kSplit - 1) / Geometry<KC, D>::kSplit);
}

// One attention unit: the T window rows of batch row b, head h, against
// split s of the cached positions, in layer l.
//
// The window's k/v go into the cache at wpos = min(start, S - T) (split 0
// writes them). Window row j reads cached positions < min(start + j, S),
// and a position inside the window is read as its writer writes it
// (computed here from q/k/v, never read back from the cache in this call),
// so no block reads what another writes. Every thread loads its positions'
// K and V chunks first; scores are summed over a position group in a fixed
// tree. The split's max per row (split 0's covering the rows' own scores)
// goes to the other splits of the (row, head) through the scratch and a
// counter; p is then rounded against the row's max as the first design
// rounded it. mode kUnitPublish stops after publishing; kUnitFinish
// recomputes the same scores and finishes (a block with several units
// publishes them all first, so no block waits on a unit that its own later
// work would publish); kUnitFull does both.
template <int CD, int KC, int D>
__device__ void attention_unit(const Params& p, float* sm, int l, int b, int h, int s, int ns,
                               int start, int mode) {
  using Geo = Geometry<KC, D>;
  using SM = AttnSmem<D>;
  constexpr int N = Geo::N, TPG = Geo::TPG, G = Geo::G, P = Geo::kSplit;
  constexpr unsigned kAll = 0xffffffffu;
  const int T = p.T, S = p.S, H = p.H;
  const int HD = H * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane32 = tid & 31;
  const int g = tid / TPG;      // position group
  const int ln = tid % TPG;     // which chunk of the head row
  const bool active = ln < Geo::kChunks;
  const Layout lay = make_layout(p.B, T, S, p.dm, H, D, p.dff, P);
  float* s_q = sm + SM::q;
  float* s_kn = sm + SM::kn;
  float* s_vn = sm + SM::vn;

  const int wpos = min(start, S - T);       // where the window is written
  const int n_max = min(start + T - 1, S);  // cached positions the last row reads
  const int c0 = s * P;
  const size_t cache_row0 = (static_cast<size_t>(l) * p.B + b) * S;  // position 0 of (l, b)
  const size_t col = static_cast<size_t>(h) * D + ln * N;

  // 1. Every K and V load of the split first (positions outside the window).
  uint4 kr[kPerGroup], vr[kPerGroup];
  float ksc[kPerGroup], vsc[kPerGroup];
  const char* kb = static_cast<const char*>(p.k_cache);
  const char* vb = static_cast<const char*>(p.v_cache);
#pragma unroll
  for (int pp = 0; pp < kPerGroup; ++pp) {
    const int pos = c0 + g + pp * G;
    kr[pp] = vr[pp] = make_uint4(0u, 0u, 0u, 0u);
    ksc[pp] = vsc[pp] = 1.f;
    if (pos < n_max && (pos < wpos || pos >= wpos + T)) {
      const size_t row = cache_row0 + pos;
      if (active) {
        const size_t off = (row * HD + col) * Geo::kBytes;
        kr[pp] = __ldg(reinterpret_cast<const uint4*>(kb + off));
        vr[pp] = __ldg(reinterpret_cast<const uint4*>(vb + off));
      }
      if constexpr (KC == 2) {
        ksc[pp] = __ldg(p.k_scale + row * H + h);
        vsc[pp] = __ldg(p.v_scale + row * H + h);
      }
    }
  }

  // 2. The window's q (scaled in the compute dtype) and, where this split
  //    holds a window position or the rows' own terms, its k and v as
  //    attention reads them.
  const float* qkv = p.scratch + lay.qkv;
  const bool win = s == 0 || (wpos < min(c0 + P, n_max) && wpos + T > c0);
  for (int i = tid; i < T * D; i += kThreads) {
    const int j = i / D, d = i - j * D;
    const size_t base = static_cast<size_t>(b * T + j) * 3 * HD + h * D + d;
    s_q[i] = rnd<CD>(__ldcg(qkv + base) * p.att_scale);
    if (win) {
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
  }
  consumer_sync();
  for (int j = warp; KC == 2 && win && j < T; j += kWarps) {
    // One warp per window position: per-head scale max(|x|) / 127
    // (floored), round half to even, clip to +-127; attention reads the
    // dequantized values.
    float ka = 0.f, va = 0.f;
    for (int d = lane32; d < D; d += 32) {
      ka = fmaxf(ka, fabsf(s_kn[j * D + d]));
      va = fmaxf(va, fabsf(s_vn[j * D + d]));
    }
    const float kscl = fmaxf(warp_max(ka), kScaleFloor) / 127.f;
    const float vscl = fmaxf(warp_max(va), kScaleFloor) / 127.f;
    for (int d = lane32; d < D; d += 32) {
      const float kq = fminf(fmaxf(rintf(s_kn[j * D + d] / kscl), -127.f), 127.f);
      const float vq = fminf(fmaxf(rintf(s_vn[j * D + d] / vscl), -127.f), 127.f);
      sm[SM::kq + j * D + d] = kq;
      sm[SM::vq + j * D + d] = vq;
      s_kn[j * D + d] = rnd<CD>(kq * kscl);
      s_vn[j * D + d] = rnd<CD>(vq * vscl);
    }
    if (lane32 == 0) {
      sm[SM::ksc + j] = kscl;
      sm[SM::vsc + j] = vscl;
    }
  }
  consumer_sync();
  if (s == 0 && mode != kUnitPublish) {
    // The window into the cache.
    for (int i = tid; i < T * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      const size_t off = (cache_row0 + wpos + j) * HD + h * D + d;
      if (KC == 2) {
        store_t<2>(p.k_cache, off, sm[SM::kq + i]);
        store_t<2>(p.v_cache, off, sm[SM::vq + i]);
        if (d == 0) {
          p.k_scale[(cache_row0 + wpos + j) * H + h] = sm[SM::ksc + j];
          p.v_scale[(cache_row0 + wpos + j) * H + h] = sm[SM::vsc + j];
        }
      } else {
        store_t<KC>(p.k_cache, off, s_kn[i]);
        store_t<KC>(p.v_cache, off, s_vn[i]);
      }
    }
  }

  // 3. Scores of every row on the thread's positions, and the rows' own.
  float sc[kPerGroup][kMaxT];
  float mloc[kMaxT];
#pragma unroll
  for (int j = 0; j < kMaxT; ++j) mloc[j] = -INFINITY;
#pragma unroll
  for (int pp = 0; pp < kPerGroup; ++pp) {
    const int pos = c0 + g + pp * G;
    float kv[N];
    if (pos >= wpos && pos < wpos + T && pos < n_max) {
#pragma unroll
      for (int i = 0; i < N; ++i) kv[i] = active ? s_kn[(pos - wpos) * D + ln * N + i] : 0.f;
    } else {
      float e[N];
      unpack<KC>(kr[pp], e);
#pragma unroll
      for (int i = 0; i < N; ++i) kv[i] = rnd<CD>(KC == 2 ? e[i] * ksc[pp] : e[i]);
    }
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      float dot = 0.f;
      if (j < T && active) {
#pragma unroll
        for (int i = 0; i < N; ++i) dot = fmaf(s_q[j * D + ln * N + i], kv[i], dot);
      }
#pragma unroll
      for (int o = TPG / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(kAll, dot, o);
      sc[pp][j] = dot;
      if (j < T && pos < min(start + j, S)) mloc[j] = fmaxf(mloc[j], dot);
    }
  }
  if (s == 0) {
    // Row j's score on itself: group j, the same sum as a cached position's.
    float dot = 0.f;
    if (g < T && active) {
#pragma unroll
      for (int i = 0; i < N; ++i) dot = fmaf(s_q[g * D + ln * N + i], s_kn[g * D + ln * N + i], dot);
    }
#pragma unroll
    for (int o = TPG / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(kAll, dot, o);
    if (g < T && ln == 0) sm[SM::own + g] = dot;
  }
#pragma unroll
  for (int j = 0; j < kMaxT; ++j) {
    float m = mloc[j];
#pragma unroll
    for (int o = TPG; o < 32; o <<= 1) m = fmaxf(m, __shfl_xor_sync(kAll, m, o));
    if (lane32 == 0) sm[SM::red + warp * kMaxT + j] = m;
  }
  consumer_sync();
  if (tid < T) {
    float m = s == 0 ? sm[SM::own + tid] : -INFINITY;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, sm[SM::red + w * kMaxT + tid]);
    sm[SM::m + tid] = m;
  }
  consumer_sync();

  // 4. The row max over the splits.
  if (ns > 1) {
    float* mx = p.scratch + lay.mx;
    unsigned int* cnt = reinterpret_cast<unsigned int*>(p.scratch) + kCounterBase + b * H + h;
    if (mode != kUnitFinish) {
      if (tid < T) mx[(static_cast<size_t>(b * T + tid) * H + h) * lay.splits + s] = sm[SM::m + tid];
      consumer_sync();
      if (tid == 0) red_release_add(cnt, 1u);
    }
    if (mode == kUnitPublish) return;
    if (tid == 0) spin_until(cnt, static_cast<unsigned int>(l + 1) * ns);
    consumer_sync();
    if (tid < T) {
      float m = -INFINITY;
      const float* row = mx + (static_cast<size_t>(b * T + tid) * H + h) * lay.splits;
      for (int x = 0; x < ns; ++x) m = fmaxf(m, __ldcg(row + x));
      sm[SM::m + tid] = m;
    }
    consumer_sync();
  } else if (mode == kUnitPublish) {
    return;
  }

  // 5. p against the row max: its sum (fp32) and, rounded to the compute
  //    dtype, times V; over the thread's positions in order, the groups of
  //    a warp (a butterfly: every lane gets the same bits), then the warps
  //    in order.
#pragma unroll
  for (int j = 0; j < kMaxT; ++j) {
    if (j >= T) break;
    const float M = sm[SM::m + j];
    float a[N];
#pragma unroll
    for (int i = 0; i < N; ++i) a[i] = 0.f;
    float lj = 0.f;
#pragma unroll
    for (int pp = 0; pp < kPerGroup; ++pp) {
      const int pos = c0 + g + pp * G;
      if (pos < min(start + j, S)) {
        const float pe = expf(sc[pp][j] - M);
        lj += pe;
        const float pr = rnd<CD>(pe);
        float vv[N];
        if (pos >= wpos && pos < wpos + T) {
#pragma unroll
          for (int i = 0; i < N; ++i) vv[i] = active ? s_vn[(pos - wpos) * D + ln * N + i] : 0.f;
        } else {
          float e[N];
          unpack<KC>(vr[pp], e);
#pragma unroll
          for (int i = 0; i < N; ++i) vv[i] = rnd<CD>(KC == 2 ? e[i] * vsc[pp] : e[i]);
        }
#pragma unroll
        for (int i = 0; i < N; ++i) a[i] = fmaf(pr, vv[i], a[i]);
      }
    }
#pragma unroll
    for (int o = TPG; o < 32; o <<= 1) {
      lj += __shfl_xor_sync(kAll, lj, o);
#pragma unroll
      for (int i = 0; i < N; ++i) a[i] += __shfl_xor_sync(kAll, a[i], o);
    }
    if (lane32 < TPG && active) {
#pragma unroll
      for (int i = 0; i < N; ++i) sm[SM::acc + (warp * kMaxT + j) * D + ln * N + i] = a[i];
    }
    if (lane32 == 0) sm[SM::sl + warp * kMaxT + j] = lj;
  }
  consumer_sync();

  // 6. The split's partials; split 0 also the rows' own terms.
  float* part = p.scratch + lay.part;
  for (int i = tid; i < T * D; i += kThreads) {
    const int j = i / D, d = i - j * D;
    float a = sm[SM::acc + j * D + d];
    for (int w = 1; w < kWarps; ++w) a += sm[SM::acc + (w * kMaxT + j) * D + d];
    part[((static_cast<size_t>(b * T + j) * H + h) * lay.splits + s) * (D + 4) + d] = a;
  }
  if (tid < T) {
    float l_ = sm[SM::sl + tid];
    for (int w = 1; w < kWarps; ++w) l_ += sm[SM::sl + w * kMaxT + tid];
    part[((static_cast<size_t>(b * T + tid) * H + h) * lay.splits + s) * (D + 4) + D] = l_;
  }
  if (s == 0) {
    float* own = p.scratch + lay.own;
    for (int i = tid; i < T * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      own[(static_cast<size_t>(b * T + j) * H + h) * (D + 4) + d] = s_vn[i];
    }
    if (tid < T) {
      own[(static_cast<size_t>(b * T + tid) * H + h) * (D + 4) + D] =
          expf(sm[SM::own + tid] - sm[SM::m + tid]);
    }
  }
  consumer_sync();  // the next unit overwrites the work area
}

// The attention phase of layer l: units (row b, head h, split s) in that
// order, dealt over the blocks.
template <int CD, int KC, int D>
__device__ void attention_phase(const Params& p, float* area, int l) {
  int total = 0;
  for (int b = 0; b < p.B; ++b) {
    int st;
    total += splits_of<KC, D>(p, b, &st) * p.H;
  }
  const int mine = (total - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                   static_cast<int>(gridDim.x);
  if (mine <= 0) return;
  for (int pass = mine == 1 ? 1 : 0; pass < 2; ++pass) {
    for (int u = blockIdx.x; u < total; u += gridDim.x) {
      int b = 0, base = 0, st = 0, ns = 0;
      for (;; ++b) {
        ns = splits_of<KC, D>(p, b, &st);
        if (u < base + ns * p.H) break;
        base += ns * p.H;
      }
      const int h = (u - base) / ns, s = (u - base) - h * ns;
      if (pass == 0 && ns == 1) continue;  // nothing to publish
      const int mode = mine == 1 ? kUnitFull : pass == 0 ? kUnitPublish : kUnitFinish;
      attention_unit<CD, KC, D>(p, area, l, b, h, s, ns, st, mode);
    }
  }
}

template <int CD, int KC, int D>
__global__ void __launch_bounds__(kBlockThreads, 1)
fused_layers_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* ring = sm;
  float* area = sm + kRingFloats;
  uint64_t* mbar = reinterpret_cast<uint64_t*>(area + kAreaFloats);  // full, then empty
  unsigned int* bar = reinterpret_cast<unsigned int*>(p.scratch);

  DenseCtx c;
  c.ring = ring;
  c.mbar = mbar;
  c.s_in = area;
  c.s_mean = area + kInFloats;
  c.s_rstd = c.s_mean + kMaxRows;
  c.s_z = c.s_rstd + kMaxRows;
  c.s_slot = reinterpret_cast<int*>(c.s_z + kZFloats);
  c.lay = make_layout(p.B, p.T, p.S, p.dm, p.H, D, p.dff, Geometry<KC, D>::kSplit);
  c.D = D;
  c.split = Geometry<KC, D>::kSplit;
  __shared__ unsigned int consumed;
  __shared__ PhaseGeo geo[kPhases];
  c.empty = mbar + kStages;
  c.consumed = &consumed;
  c.geo = geo;

  if (threadIdx.x == 0) {
    consumed = 0;
    for (int ph = 0; ph < kPhases; ++ph) geo[ph] = phase_geo(p, ph);
    for (int i = 0; i < 2 * kStages; ++i) mbar_init(mbar + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x < kThreads + 32) produce(p, geo, ring, mbar, mbar + kStages);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));

  // Per layer: q/k/v, attention, out_proj, fc1, fc2, a grid barrier after
  // each but the last layer's fc2.
  unsigned int nbar = 0;
  for (int l = 0; l < p.L; ++l) {
    for (int step = 0; step < 5; ++step) {
      if (step == 1) {
        attention_phase<CD, KC, D>(p, area, l);
      } else {
        dense_phase<CD>(p, c, step == 0 ? kPhQ : step - 1, l);
      }
      if (step < 4 || l + 1 < p.L) grid_barrier(bar, ++nbar);
    }
  }
}

// Grid and shared memory on the current device; the attribute and
// occupancy queries run once per (instance, device).
template <int CD, int KC, int D>
cudaError_t configure(int* grid, int* smem) {
  static int c_dev = -1, c_grid = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  *smem = kSmemBytes;
  if (dev == c_dev) {
    *grid = c_grid;
    return cudaSuccess;
  }
  auto kernel = fused_layers_kernel<CD, KC, D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0, coop = 0;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlockThreads, kSmemBytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = sms;
  c_dev = dev;
  c_grid = sms;
  return cudaSuccess;
}

template <int CD, int KC, int D>
cudaError_t launch(Params p, cudaStream_t stream) {
  int grid = 0, smem = 0;
  cudaError_t err = configure<CD, KC, D>(&grid, &smem);
  if (err != cudaSuccess) return err;
  const Layout lay = make_layout(p.B, p.T, p.S, p.dm, p.H, D, p.dff, Geometry<KC, D>::kSplit);
  err = cudaMemsetAsync(p.scratch, 0, lay.head * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kBlockThreads);
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

#define DTC_HEAD_DIMS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

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
  p.att_scale = att_scale;
  p.lw = lora_mask ? static_cast<const float* const*>(lora_table) : nullptr;
  p.lora_ids = lora_ids;
  p.lora_mask = lora_mask;
  p.rank = rank;
  p.lora_L = lora_layers;
  p.lora_scale = lora_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define DTC_CASE(d) \
  case d:           \
    return launch<DTC_CD, DTC_KV, d>(p, st);
    DTC_HEAD_DIMS(DTC_CASE)
#undef DTC_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Floats of scratch a call at these shapes needs (counters, residual,
// q/k/v, GELU output, the attention partials); 0 at a head dim without an
// instance.
extern "C" long long dtc_fused_layers_scratch_floats(int B, int T, int S, int dm, int H, int D,
                                                     int dff, int c_dtype, int kv_dtype) {
  if (c_dtype != DTC_CD || kv_dtype != DTC_KV) return 0;
  switch (D) {
#define DTC_CASE(d) \
  case d:           \
    return static_cast<long long>(                                                 \
        make_layout(B, T, S, dm, H, d, dff, Geometry<DTC_KV, d>::kSplit).total);
    DTC_HEAD_DIMS(DTC_CASE)
#undef DTC_CASE
    default: return 0;
  }
}

// The launch geometry the kernel takes on the current device: blocks in the
// grid and dynamic shared memory per block.
extern "C" int dtc_fused_layers_config(int dm, int dff, int D, int c_dtype, int kv_dtype,
                                       int* grid, int* smem) {
  if (c_dtype != DTC_CD || kv_dtype != DTC_KV) return static_cast<int>(cudaErrorInvalidValue);
  (void)dm;
  (void)dff;
  switch (D) {
#define DTC_CASE(d) \
  case d:           \
    return configure<DTC_CD, DTC_KV, d>(grid, smem);
    DTC_HEAD_DIMS(DTC_CASE)
#undef DTC_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* dtc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
