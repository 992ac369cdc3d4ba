// Fused scanline BasicAttnBlock for Hopper (sm_90a): kernel D.
//
// Replaces s2m2_tpu/ops/fused_block.py: fused_basic_attn_block (_kernel,
// _block_body). One launch applies a whole BasicAttnBlock (reference:
// attentions.py:324-355) to every epipolar row pair of the two views:
//   z += proj(attn(LN z, the other view))  cross attention; the views share
//                                          its weights, both directions
//   z += W2 gelu(W1 LN z + b1) + b2        ffn_c
//   z += proj(attn(LN z, the same view))   self attention
//   z += W2 gelu(W1 LN z + b1) + b2        ffn
// Rows are (R, W, C) tokens: the left view's row i is row i, its right-view
// partner is row right0 + i. The 18 weights are read where the torch
// modules hold them, in the (out, in) Linear layout (K-major, as wgmma
// wants), in the order of the TPU kernel's _pack_weights.
//
// What bounds it on the H100: per launch the 2 x pairs x W tokens do 24 C E
// flops each in the linears and each pair 16 W^2 E in its four attentions,
// against one read and one write of the rows: at XL's 1/4 scale (256 pairs,
// W = 304, C = E = 384) 0.70 TFLOP against 239 MB in bf16, so the tensor
// cores bound it in both dtypes (989 TFLOP/s bf16; float32 runs as split
// TF32, three TF32 products each, 495 / 3 = 165 TFLOP/s).
//
// Design (the first port, described in PERF.md, ran one 64 x 64
// mma.sync tile for every product, a cp.async ring that drained at every
// output tile, W x W float32 scores and probabilities in global memory, a
// 2.4 MB scratch per pair slot, element-wise epilogue stores, 8 warps a
// block, exact FP32 FMAs for float32). Each point, and what this kernel
// does about it:
//  1. Tensor cores. A persistent grid of min(pairs, SMs) blocks, one per SM,
//     each walking over row pairs. A block is three warpgroups: one producer
//     (one thread issues TMA; setmaxnreg gives its registers away, so each
//     consumer thread may hold 232) and two consumer warpgroups. bf16
//     linears run on wgmma m64nNk16 (float32 accumulators) with A, the
//     activation panel, resident in 128-byte-swizzled shared memory and B,
//     the weight tile (128 output rows x 128 bytes of k), fed by TMA from
//     the (out, in) weights, which stay in L2. Phase 1 (LN, then q, k, v of
//     all 2W tokens of a pair) takes 128 rows a tile, 64 a warpgroup, with
//     N = 128; phase 2 (per tile of 64 queries: attention, proj, FFN) 64
//     rows, each warpgroup 64 of the tile's 128 columns.
//  2. One ring, never drained. The producer walks the same schedule as the
//     consumers: every weight tile of every GEMM of a pair and every K and
//     V tile of its attentions, in order, through one mbarrier ring of
//     16 KB stages (full/empty pairs; one empty arrival a consumer warp). It
//     runs on across output tiles, GEMMs and sublayers, so one tile's
//     epilogue overlaps the next tile's loads. q, k and v are one tile loop
//     over N = 3E: the producer picks the weight tensor by N tile, so the
//     LN panel is built once for all three. The consumers hand k and v of a
//     sublayer to the producer's TMA through one more mbarrier.
//  3. Scores stay on the SM. Per pair, direction, head and tile of PR
//     queries, S = Q K^T over 32-key tiles goes into registers: in bf16 by
//     each consumer warpgroup's wgmma (m64n32k16, Q from the second panel,
//     K from the ring), in float32 by split-TF32 mma.sync, the four warps
//     of a query group each taking a quarter of the k-steps and adding the
//     partial scores through shared memory in a fixed order. An online
//     float32 softmax (running max and sum, exp2 of one FFMA, as kernel A)
//     follows, and the probabilities feed P V (mma.sync) from registers.
//     K and V tiles come through the ring by TMA from a (token, head)-padded
//     q/k/v scratch. No scores or probabilities go to global memory. Each
//     warp's output accumulators are DPW / 2 registers: a bf16 head of 384
//     takes two passes over the keys of 192 columns each (96 a warp), which
//     the card ran faster than one pass of 384 (192 a warp, the scores
//     computed once) or four of 96 (ops/fused_block.py `_INSTANCES`).
//  4. Scratch per block in flight, and the rest on chip. Only q, k and v go
//     through global memory (3 x 2W x heads x HDP elements per block,
//     blocks = min(pairs, SMs)). The attention output of a tile of PR
//     queries is written into a shared panel and is the A operand of proj;
//     the residual sum goes to y, whose rows the FFN's layer norm reads back
//     (L2-hot); the FFN hidden of the tile stays in a shared panel between
//     W1 and W2. Layer-norm statistics are computed once per token.
//  5. Epilogues. Bias, GELU, rounding and the residual are applied to the
//     accumulator fragments; each warp stages 16 x 128-byte pieces of its
//     output in shared memory and stores (and reads the residual, all of a
//     lane's pieces in flight at once) as 16-byte vectors.
//  6. Fill. A block is a whole SM's worth of warps (384 threads, the
//     registers of the SM, up to 227 KB of shared memory), so 1/8 scale's
//     128 pairs keep 128 of 132 SMs busy with a full complement of warps,
//     and 1/4 scale's 256 pairs take two rounds of 132.
//  7. float32 on the tensor cores by split TF32: big = x rounded to TF32
//     (an integer add and mask), small = x - big, three m16n8k8 products
//     (small terms first), for the linears and the attention alike, reading
//     the same swizzled tiles (PR = 32 rows, 32-float chunks).
//  Geometries TMA cannot take (a weight row stride that is not a multiple
//  of 16 bytes, or a weight not 16-byte aligned) are loaded by the producer
//  warp with plain loads into the same swizzled stages ("gather"); every
//  head dim up to 512 runs, padded in the scratch and the tiles to HDP
//  (ops/fused_block.py `plan`), with zero columns that add nothing.
//  What holds it back on the card (chip_probe.py `dblock --trace`, PERF.md):
//  the consumers, not the loads (the producer waits for a free stage most
//  of the time); about half their time is the attention's serial chain of
//  waits, wgmma, softmax and P V per key tile, a fifth the epilogues.
//
// Numerics follow the TPU kernel's body step by step: float32 layer norms,
// their output rounded to the compute dtype; every product accumulated in
// float32 and its result rounded to the compute dtype; the v bias added
// after that rounding; float32 scores scaled by hd^-1/2 after the dot; the
// FFN's first product rounded, then its bias and an exact-erf GELU in
// float32, then rounded; the residual adds in the compute dtype, z + mm +
// b2 in that order. Where the rounding differs from the TPU kernel: its
// softmax is exact and two-pass over the whole row (max, sum, divide, then
// round p / sum); here it is online over key tiles and p is rounded to v's
// dtype before the final 1 / rowsum, as in kernel A: a last-bit difference
// in bf16; exp2 is the hardware's approximation (2 ulp); float32 products
// are split TF32 (about 21 bits of each operand) rather than exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cstring>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "hopper.cuh"  // mbarrier, TMA, wgmma and cp.async helpers; encoder()

// The attention instances and the kernel's geometry of ops/fused_block.py
// (`instances_header`), and the wgmma wrappers of its N tiles.
#include "fused_block_instances.h"

// A measurement build (chip_probe.py `dblock --trace`) with S2M2_D_TRACE 1:
// each block adds the cycles of its stages and waits to g_trace, which
// s2m2_fused_block_trace reads. 0 in every build the port uses.
#ifndef S2M2_D_TRACE
#define S2M2_D_TRACE 0
#endif
#if S2M2_D_TRACE
__device__ unsigned long long g_trace[1024][16];
#define S2M2_T0() long long t0_ = clock64()
#define S2M2_TRESET() t0_ = clock64()
#define S2M2_T1(slot, who) \
  if (who) g_trace[blockIdx.x][slot] += clock64() - t0_
#else
#define S2M2_T0()
#define S2M2_TRESET()
#define S2M2_T1(slot, who)
#endif

namespace {

constexpr int CONSUMERS = 256;  // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
constexpr int BN = 128;          // output columns of a weight tile
constexpr int ROW_BYTES = 128;   // bytes of k in a tile row: one swizzle row
constexpr int STAGE_BYTES = BN * ROW_BYTES;
constexpr int N_WEIGHTS = 18;
constexpr int MAX_DIM = 512;
constexpr int STG_PITCH = 144;  // staging row: 128 bytes + 16 of pad
constexpr int STG_WARP = 16 * STG_PITCH;
static_assert(S2M2_D_STAGING == 8 * STG_WARP, "staging bytes of the plan");

// the weight order of s2m2_tpu/ops/fused_block.py's _pack_weights
enum { CQ, CK, CV, CVB, CP, F1W1, F1B1, F1W2, F1B2,
       SQ, SK, SV, SVB, SP, F2W1, F2B1, F2W2, F2B2 };

struct Maps {
  CUtensorMap w[N_WEIGHTS];  // the matrices' maps (bias entries unused)
  CUtensorMap k, v;          // 4D maps of the k and v scratch
};

struct Params {
  const void* x;  // (R, W, C) input rows
  void* y;        // (R, W, C) output rows
  const void* w[N_WEIGHTS];
  void* q;        // scratch, per block: (2W, heads, HDP), compute dtype
  void* k;
  void* v;
  int n_pairs, right0, W, C, E, heads, hd, hdp, passes, stages;
  int gather;     // weights by plain loads instead of TMA
  int vec;        // x, y and the row length allow 16-byte row access
  float scale_log2;  // hd^-1/2 * log2(e)
};

// ---- small helpers ----------------------------------------------------------

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the consumers' barrier (id 1, 256 threads)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
// generic-proxy writes (shared and global) before async-proxy reads of them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// mbar_wait with a bound: a schedule the two sides disagree on traps (a
// launch error) after about 2^34 cycles instead of hanging the card
__device__ __forceinline__ void wait_full(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// Byte offset of 16-byte unit `u` (of 8) of row r in a 128-byte-swizzled
// tile whose base is 1,024-aligned: TMA's SWIZZLE_128B and wgmma's layout.
__device__ __forceinline__ int swz(int r, int u) { return r * ROW_BYTES + ((u ^ (r & 7)) << 4); }

// A panel: `rows` rows x chunks of 128 bytes of k, chunk-major
// ([chunk][rows][128 bytes], each chunk a swizzled tile). Element k of row r.
template <typename T>
__device__ __forceinline__ int panel_off(int rows, int r, int k) {
  constexpr int PER = ROW_BYTES / sizeof(T);  // elements in a chunk row
  const int c = k / PER, b = (k - c * PER) * (int)sizeof(T);
  return c * rows * ROW_BYTES + swz(r, b >> 4) + (b & 15);
}

// Shared-memory loads and stores by address (the pointers here are generic,
// and a generic access to shared memory costs more than ld/st.shared).
__device__ __forceinline__ void sts128(void* p, const uint4& v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(smem_u32(p)), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ uint4 lds128(const void* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(smem_u32(p))
               : "memory");
  return v;
}
__device__ __forceinline__ void sts2(void* p, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(smem_u32(p)), "f"(a), "f"(b)
               : "memory");
}
__device__ __forceinline__ void sts2(void* p, __nv_bfloat16 a, __nv_bfloat16 b) {
  const uint32_t v = (uint32_t)*reinterpret_cast<unsigned short*>(&a) |
                     ((uint32_t)*reinterpret_cast<unsigned short*>(&b) << 16);
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(smem_u32(p)), "r"(v) : "memory");
}
__device__ __forceinline__ void sts(void* p, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(smem_u32(p)), "f"(v) : "memory");
}
__device__ __forceinline__ void sts(void* p, __nv_bfloat16 v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(smem_u32(p)),
               "h"(*reinterpret_cast<unsigned short*>(&v))
               : "memory");
}

// ---- warp-level tensor-core products (as kernel A) ---------------------------

// four 8 x 16-byte matrices; lane l gets 4 bytes (word l % 4) of row l / 4:
// for 32-bit data, element (g, tig) of an 8 x 4 tile, the m16n8k8 TF32
// fragment layout
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// c += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a (16x8 tf32, row) * b (8x8 tf32, col), float32 accumulators
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// x = big + small to about float32 precision: big is x rounded to TF32's 10
// mantissa bits (to nearest, ties away, by integer add and mask: cvt.rna
// costs a dozen instructions here), small = x - big exactly, whose low bits
// the tensor cores drop (finite x well below FLT_MAX, as every operand here)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}
__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], big[i], small[i]);
}
__device__ __forceinline__ void split4(const uint32_t (&x)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(x[i]), big[i], small[i]);
}
// c += a * b by split TF32: the small terms first, then big * big
__device__ __forceinline__ void mma_tf32x3(float* c, const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], uint32_t bb0,
                                           uint32_t bb1, uint32_t bs0, uint32_t bs1) {
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}
// 2^x (approximate, 2 ulp; 0 at -inf)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
// float32 element k of row r of a swizzled tile
__device__ __forceinline__ float lds_f(const uint8_t* tile, int r, int k) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(smem_u32(tile + swz(r, k >> 2) + ((k & 3) << 2)))
               : "memory");
  return v;
}

// ---- geometry -----------------------------------------------------------------

// PR: rows of a panel (the queries of an attention tile, the rows of a
// phase-2 GEMM; phase 1 builds two panels, 2 PR rows); NC: warps sharing a
// tile's queries, each with 1/NC of the head's columns; BKV: keys of a
// K/V tile; KCH: k elements in a 128-byte chunk.
template <typename T> struct Geo;
template <> struct Geo<__nv_bfloat16> {
  static constexpr int PR = S2M2_D_PR_BF16, NC = S2M2_D_NC_BF16, BKV = S2M2_D_BKV_BF16;
  static constexpr int KCH = 64;
};
template <> struct Geo<float> {
  static constexpr int PR = S2M2_D_PR_F32, NC = S2M2_D_NC_F32, BKV = S2M2_D_BKV_F32;
  static constexpr int KCH = 32;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// shared memory of a block, carved from a 1,024-aligned base:
// ring (stages x 16 KB), panel 0, panel 1 (`half` bytes each), the warps'
// staging, the barriers
struct Layout {
  int half, ring, stg, bars, bytes;
  __host__ __device__ Layout(int esz, int pr, int C, int E, int hdp, int stages) {
    const int kch = ROW_BYTES / esz;
    int widest = C > E ? C : E;
    if (hdp > widest) widest = hdp;
    half = pr * cdiv(widest, kch) * ROW_BYTES;
    ring = stages * STAGE_BYTES;
    stg = ring + 2 * half;
    bars = stg + S2M2_D_STAGING;
    bytes = 1024 + bars + (2 * S2M2_D_MAX_STAGES + 2) * 8;
  }
};

// ---- the producer -----------------------------------------------------------
//
// One warp walks the consumers' schedule and fills the ring: per pair and
// sublayer, phase 1's weight tiles (q, k, v for each tile of 2 PR tokens),
// then per tile of PR queries the K and V tiles of every head and the weight
// tiles of proj, W1 and W2.

// 128 rows x 128 bytes of a row-major (N, K) weight at (n0, k0), zero past
// the edges, by plain loads into the swizzled layout (the gather mode)
template <typename T>
__device__ void gather_tile(uint8_t* st, const T* w, int N, int K, int n0, int k0, int lane) {
  constexpr int V = 16 / sizeof(T);
  for (int r = lane; r < BN; r += 32) {
    const int n = n0 + r;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      union {
        uint4 v;
        T e[V];
      } pc;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int k = k0 + u * V + j;
        pc.e[j] = n < N && k < K ? w[(size_t)n * K + k] : from_f<T>(0.f);
      }
      sts128(st + swz(r, u), pc.v);
    }
  }
}

template <typename T>
__device__ void produce(const Params& p, const Maps& m, uint8_t* ring, uint64_t* full,
                        uint64_t* empty, uint64_t* kvready) {
  using G = Geo<T>;
  constexpr int BOX = G::BKV * ROW_BYTES;    // a K/V box: BKV rows x 128 bytes
  constexpr int CPS = STAGE_BYTES / BOX;     // boxes a stage holds
  const int lane = threadIdx.x & 31;
  const int W = p.W, C = p.C, E = p.E;
  const int chunks = cdiv(p.hdp, G::KCH);
  int n = 0;        // stages filled
  int kv_sub = 0;   // sublayers whose k and v the producer has waited for

  auto slot = [&]() -> int {  // the next stage, once the consumers freed it
    const int s = n % p.stages;
    if (lane == 0 && n >= p.stages) {
      S2M2_T0();
      wait_full(&empty[s], ((n / p.stages) - 1) & 1);
      S2M2_T1(1, true);
    }
    __syncwarp();
    return s;
  };
  auto weight = [&](int mat, int rows, int cols, int n0, int k0) {
    const int s = slot();
    uint8_t* st = ring + s * STAGE_BYTES;
    if (!p.gather) {
      if (lane == 0) {
        mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load_2d(st, &m.w[mat], &full[s], k0, n0);
      }
    } else {
      gather_tile<T>(st, static_cast<const T*>(p.w[mat]), rows, cols, n0, k0, lane);
      fence_proxy_async();  // the tile, to wgmma's proxy
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[s]);
    }
    ++n;
  };
  // the (rows, cols) GEMM's weight tiles in the consumers' order
  auto gemm = [&](int mat, int rows, int cols) {
    for (int n0 = 0; n0 < rows; n0 += BN)
      for (int k0 = 0; k0 < cols; k0 += G::KCH) weight(mat, rows, cols, n0, k0);
  };
  // the boxes of one K or V tile: BKV keys x chunks [c_begin, c_end) of
  // 128 bytes of head h's columns
  auto kv = [&](const CUtensorMap* map, int h, int key0, int slab, int c_begin, int c_end) {
    for (int c0 = c_begin; c0 < c_end; c0 += CPS) {
      const int s = slot();
      const int nb = min(CPS, c_end - c0);
      if (lane == 0) {
        mbar_expect_tx(&full[s], nb * BOX);
        for (int j = 0; j < nb; ++j)
          tma_load_4d(ring + s * STAGE_BYTES + j * BOX, map, &full[s], (c0 + j) * G::KCH, h,
                      key0, slab);
      }
      ++n;
    }
  };

  for (int pair = blockIdx.x; pair < p.n_pairs; pair += gridDim.x) {
    for (int sub = 0; sub < 2; ++sub) {
      const int att = sub ? SQ : CQ;    // q, k, v, v bias, proj
      const int ffn = sub ? F2W1 : F1W1;  // w1, b1, w2, b2
      for (int r0 = 0; r0 < 2 * W; r0 += 2 * G::PR)
        for (int mat = 0; mat < 3; ++mat) gemm(att + mat, E, C);
      // k and v of this sublayer are in the scratch only once the
      // consumers say so
      if (lane == 0) wait_full(kvready, kv_sub & 1);
      __syncwarp();
      ++kv_sub;
      for (int d = 0; d < 2; ++d) {
        const int slab = 2 * blockIdx.x + (sub == 0 ? 1 - d : d);  // the keys' view
        for (int q0 = 0; q0 < W; q0 += G::PR) {
          for (int h = 0; h < p.heads; ++h)
            for (int pass = 0; pass < p.passes; ++pass)
              for (int key0 = 0; key0 < W; key0 += G::BKV) {
                kv(&m.k, h, key0, slab, 0, chunks);  // K: every column, V: the pass's
                kv(&m.v, h, key0, slab, pass * chunks / p.passes,
                   (pass + 1) * chunks / p.passes);
              }
          gemm(att + 4, C, E);
          gemm(ffn, E, C);
          gemm(ffn + 2, C, E);
        }
      }
    }
  }
}

// ---- the consumers' pieces ------------------------------------------------------

// the consumers' view of the ring: stage i is waited for once by each of
// the 256 threads and released once by each of the 8 warps
struct Ring {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int stages;
  int n;  // stages waited for

  __device__ uint8_t* wait() {
    const int s = n % stages;
    S2M2_T0();
    wait_full(&full[s], (n / stages) & 1);
    S2M2_T1(0, threadIdx.x == 0);
    ++n;
    return base + s * STAGE_BYTES;
  }
  // one arrival a warp, once all its lanes are done with the stage
  __device__ void release(int i) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[i % stages]);
  }
};

// 16 bytes global -> shared, the first `bytes` of them read, the rest zero
__device__ __forceinline__ void cp_async_bytes(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Rows [0, rows) of a panel pair (`rows` is PR or 2 PR; row r lives in
// panel r / PR, `half` bytes apart) = LN(token row_of(r)) rounded to T, the
// columns [C, kpad) zero; a row with row_of(r) == nullptr is all zero. A
// warp per token, float32 two-pass statistics (mean, then mean square
// deviation), each token read once; with 16-byte rows a warp loads RPI
// tokens before it reduces any, so their loads are in flight together.
template <typename T, class RowOf>
__device__ void layer_norm(const Params& p, RowOf row_of, int rows, uint8_t* panel, int half,
                           int kpad) {
  constexpr int PR = Geo<T>::PR;
  constexpr int V = 16 / sizeof(T);
  constexpr int UL = MAX_DIM / V / 32;  // 16-byte units a lane holds at most
  constexpr int RPI = 2;                // tokens a warp loads at once
  constexpr int WARPS = CONSUMERS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = p.C;
  S2M2_T0();
  auto put = [&](int r, int k, float v) {  // element k of row r
    sts(panel + (r / PR) * half + panel_off<T>(PR, r % PR, k), from_f<T>(v));
  };
  if (p.vec) {  // C % V == 0, rows 16-byte aligned
    const int units = C / V;
    union Piece {
      uint4 q;
      T e[V];
    };
    for (int rb = warp * RPI; rb < rows; rb += WARPS * RPI) {
      Piece pc[RPI][UL];
#pragma unroll
      for (int t = 0; t < RPI; ++t) {
        const T* src = rb + t < rows ? row_of(rb + t) : nullptr;
#pragma unroll
        for (int i = 0; i < UL; ++i) {
          const int u = lane + 32 * i;
          pc[t][i].q = src != nullptr && u < units ? *reinterpret_cast<const uint4*>(src + u * V)
                                                   : make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int t = 0; t < RPI; ++t) {
        const int r = rb + t;
        if (r >= rows) break;
        const bool live = row_of(r) != nullptr;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < UL; ++i)
#pragma unroll
          for (int j = 0; j < V; ++j) s += to_f(pc[t][i].e[j]);  // zero past C
        const float mean = warp_sum(s) / C;
        float q = 0.f;
#pragma unroll
        for (int i = 0; i < UL; ++i)
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float dd = to_f(pc[t][i].e[j]) - mean;
            if (lane + 32 * i < units) q += dd * dd;
          }
        const float rs = rsqrtf(warp_sum(q) / C + 1e-5f);
        uint8_t* dst = panel + (r / PR) * half;
#pragma unroll
        for (int i = 0; i < UL; ++i) {
          const int u = lane + 32 * i;
          if (u * V >= kpad) continue;
          Piece o;
#pragma unroll
          for (int j = 0; j < V; ++j)
            o.e[j] = from_f<T>(live && u < units ? (to_f(pc[t][i].e[j]) - mean) * rs : 0.f);
          sts128(dst + panel_off<T>(PR, r % PR, u * V), o.q);
        }
      }
    }
    S2M2_T1(9, threadIdx.x == 0);
    return;
  }
  for (int r = warp; r < rows; r += WARPS) {
    const T* src = row_of(r);
    float v[MAX_DIM / 32];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_DIM / 32; ++i) {
      const int c = lane + 32 * i;
      v[i] = src != nullptr && c < C ? to_f(src[c]) : 0.f;
      s += v[i];
    }
    const float mean = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_DIM / 32; ++i) {
      const float dd = v[i] - mean;
      if (lane + 32 * i < C) q += dd * dd;
    }
    const float rs = rsqrtf(warp_sum(q) / C + 1e-5f);
#pragma unroll
    for (int i = 0; i < MAX_DIM / 32; ++i) {
      const int c = lane + 32 * i;
      if (c < kpad) put(r, c, src != nullptr && c < C ? (v[i] - mean) * rs : 0.f);
    }
  }
}

// A warp's output: MB blocks of 16 rows x NJ tiles of 8 columns in the
// accumulator layout of mma.sync m16n8 and of wgmma (acc[(mb * NJ + j) * 4
// + e]: row 16 mb + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2).
// It leaves the warp as 16-byte pieces, 16 rows x 128 bytes at a time
// through the warp's staging: COUNT pieces a lane, piece i at piece(i).
template <typename T, int MB, int NJ>
struct Pieces {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int CW = ROW_BYTES / sizeof(T);  // columns a staging pass holds
  static constexpr int WIDTH = NJ * 8;
  static constexpr int W2 = WIDTH < CW ? WIDTH : CW;
  static constexpr int PIECES = W2 / V;             // per staged row
  static constexpr int PER_LANE = 16 * PIECES / 32;
  static constexpr int PASSES = (WIDTH + CW - 1) / CW;
  static constexpr int COUNT = MB * PASSES * PER_LANE;
  static_assert(16 * PIECES % 32 == 0, "pieces per lane");
  // (row relative to row0, column relative to col0, staged row, staged 16-byte unit)
  static __device__ __forceinline__ void piece(int i, int lane, int& row, int& col, int& rl,
                                               int& pc) {
    const int q = i % PER_LANE, pass = i / PER_LANE % PASSES, mb = i / (PER_LANE * PASSES);
    const int k = lane + 32 * q;
    rl = k / PIECES;
    pc = k - rl * PIECES;
    row = 16 * mb + rl;
    col = pass * CW + pc * V;
  }
};

// The residual a warp's epilogue will add, read ahead (before the main loop
// of its tile, so the loads are in flight while the products run):
// z[i] = fetch(row0 + row, col0 + col) of piece i.
template <typename T, int MB, int NJ, class Fetch>
__device__ __forceinline__ void epilogue_fetch(int row0, int col0, Fetch fetch,
                                               uint4 (&z)[Pieces<T, MB, NJ>::COUNT]) {
  using P = Pieces<T, MB, NJ>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < P::COUNT; ++i) {
    int row, col, rl, pc;
    P::piece(i, lane, row, col, rl, pc);
    z[i] = fetch(row0 + row, col0 + col);
  }
}

// pre(n, acc) gives each value rounded as the output wants it; the warp
// stages its rows, then hands each lane's pieces to post(row, n, piece,
// z[i]): row relative to row0, n absolute (col0 + ...).
template <typename T, int MB, int NJ, class Pre, class Post>
__device__ __forceinline__ void epilogue(const float* acc, int row0, int col0, uint8_t* stg,
                                         Pre pre, const uint4 (&z)[Pieces<T, MB, NJ>::COUNT],
                                         Post post) {
  using P = Pieces<T, MB, NJ>;
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
    for (int pass = 0; pass < P::PASSES; ++pass) {
      const int cc = pass * P::CW;
#pragma unroll
      for (int j = cc / 8; j < (P::WIDTH < cc + P::CW ? P::WIDTH : cc + P::CW) / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // a lane's two adjacent columns, one store
          const int cl = 8 * j + 2 * tig;
          const float* a = acc + (mb * NJ + j) * 4 + 2 * h;
          sts2(stg + (g + 8 * h) * STG_PITCH + (cl - cc) * (int)sizeof(T),
               from_f<T>(pre(col0 + cl, a[0])), from_f<T>(pre(col0 + cl + 1, a[1])));
        }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < P::PER_LANE; ++q) {
        const int i = (mb * P::PASSES + pass) * P::PER_LANE + q;
        int row, col, rl, pc;
        P::piece(i, lane, row, col, rl, pc);
        post(row0 + row, col0 + col, lds128(stg + rl * STG_PITCH + pc * 16), z[i]);
      }
      __syncwarp();
    }
  }
}

// ---- GEMM cores: out tile (rows x 128) = A panel x weight tile^T ----------------
//
// Both walk n_tiles output tiles of 128 columns, each over k_chunks weight
// tiles from the ring: ahead(nt) before a tile's main loop, then its
// accumulators to epi(nt, acc).

// bf16: wgmma m64nNWk16, A (this warpgroup's 64 rows, chunk stride 64 x 128
// bytes) and B (the stage, from byte b_off: NW output rows) from swizzled
// shared memory; one k chunk of wgmma in flight, its stage released when
// the next chunk's products are issued.
template <int NW, class Ahead, class Epi>
__device__ __forceinline__ void gemm_bf16(Ring& ring, const uint8_t* a, int b_off,
                                          int n_tiles, int k_chunks, Ahead ahead, Epi epi) {
  for (int nt = 0; nt < n_tiles; ++nt) {
    ahead(nt);
    float acc[NW / 2];
    for (int kc = 0; kc < k_chunks; ++kc) {
      const uint8_t* st = ring.wait();
      const uint64_t da = desc_sw128(a + kc * 64 * ROW_BYTES);
      const uint64_t db = desc_sw128(st + b_off);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)  // the first product overwrites the sums
        Wgmma<__nv_bfloat16, NW>::mma(acc, da + 2 * ks, db + 2 * ks, kc > 0 || ks > 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (kc > 0) ring.release(ring.n - 2);
    }
    wgmma_wait<0>();
    ring.release(ring.n - 1);
    fence_regs(acc);
    S2M2_T0();
    epi(nt, acc);
    S2M2_T1(8, threadIdx.x == 0);
  }
}

// float32: split TF32 on mma.sync m16n8k8; this warp's 32 rows of A (a:
// a panel of 32 rows, chunk stride 32 x 128 bytes) by its NJ x 8 columns
// from col0 of the stage.
template <int NJ, class Ahead, class Epi>
__device__ __forceinline__ void gemm_f32(Ring& ring, const uint8_t* a, int col0, int n_tiles,
                                         int k_chunks, Ahead ahead, Epi epi) {
  const int lane = threadIdx.x & 31;
  // ldmatrix rows and 16-byte units: A (x4: rows 0-7, 8-15 by k-words 0-3,
  // then 4-7) and B (x4: two 8-row n-tiles, each by k-words 0-3 and 4-7)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_u = lane >> 4;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_u = (lane >> 3) & 1;
  for (int nt = 0; nt < n_tiles; ++nt) {
    ahead(nt);
    float acc[2 * NJ * 4];
#pragma unroll
    for (int i = 0; i < 2 * NJ * 4; ++i) acc[i] = 0.f;
    for (int kc = 0; kc < k_chunks; ++kc) {
      const uint8_t* st = ring.wait();
      const uint8_t* at = a + kc * 32 * ROW_BYTES;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {  // k-steps of 8 floats: 16-byte units 2 ks, 2 ks + 1
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t x[4];
          ldmatrix_x4(x, at + swz(mt * 16 + a_row, 2 * ks + a_u));
          split4(x, ab[mt], as[mt]);
        }
#pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp) {  // two 8-column tiles a load
          uint32_t x[4], bb[4], bs[4];
          ldmatrix_x4(x, st + swz(col0 + 16 * jp + b_row, 2 * ks + b_u));
          split4(x, bb, bs);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              mma_tf32x3(acc + (mt * NJ + 2 * jp + h) * 4, ab[mt], as[mt], bb[2 * h],
                         bb[2 * h + 1], bs[2 * h], bs[2 * h + 1]);
        }
      }
      ring.release(ring.n - 1);
    }
    S2M2_T0();
    epi(nt, acc);
    S2M2_T1(8, threadIdx.x == 0);
  }
}

// a[i] with i known only at run time, by selects (an indexed local array
// would live in local memory)
template <int N>
__device__ __forceinline__ const uint8_t* pick(const uint8_t* const (&a)[N], int i) {
  const uint8_t* r = a[0];
#pragma unroll
  for (int t = 1; t < N; ++t) r = i == t ? a[t] : r;
  return r;
}

// ---- attention: one head of a tile of PR queries ----------------------------
//
// Warp (qg, ch) owns queries 16 qg .. 16 qg + 15 of the tile and output
// columns ch * DPW .. + DPW of the head; each computes its queries' whole
// scores: in bf16 each warpgroup's wgmma computes the tile's scores, in
// float32 the NC warps of a query group split Q K^T's k-steps and add their
// partial scores through xch (the consumers' staging, free here). Q: panel qp (PR
// rows, HDP columns, zero past hd). K and V tiles: kvs stages each of CPS
// boxes of BKV keys x 128 bytes (V: only the pass's columns). The output,
// divided by the row sums and rounded, goes to columns h * hd .. of panel
// op.
template <typename T, int DPW, int PASSES>
__device__ __forceinline__ void attend(Ring& ring, const Params& p, const uint8_t* qp,
                                       uint8_t* op, int h, uint8_t* xch) {
  using G = Geo<T>;
  constexpr bool BF = sizeof(T) == 2;
  constexpr int PR = G::PR, BKV = G::BKV, KCH = G::KCH;
  constexpr int BOX = BKV * ROW_BYTES, CPS = STAGE_BYTES / BOX;
  constexpr int NT = BKV / 8;  // 8-key tiles of the scores
  constexpr int NO = DPW / 8;  // 8-column tiles of the output
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  // bf16: warp w4 of warpgroup wg takes queries 16 w4 .. (its rows of the
  // warpgroup's S) and columns wg * DPW ..; float32: NC warps a query group
  const int qg = BF ? (warp & 3) : warp / G::NC;
  const int ch = BF ? warp >> 2 : warp % G::NC;
  constexpr int HDP = G::NC * DPW * PASSES;  // the padded head dim, p.hdp
  constexpr int PW = G::NC * DPW;            // columns of a pass
  constexpr int KVS = cdiv(HDP / KCH, CPS);  // stages of a K tile
  constexpr int VS = cdiv(PW / KCH, CPS);    // stages of a pass's V tile
  // ldmatrix row addresses of V (trans B, x4 order)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const float sl2 = p.scale_log2;

  // PASSES passes over the keys, each for NC x DPW of the head's columns:
  // the scores are computed once a pass, the output accumulators (DPW / 2
  // registers a thread) stay few
  for (int pass = 0; pass < PASSES; ++pass) {
  const int col0 = (pass * G::NC + ch) * DPW;
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int key0 = 0; key0 < p.W; key0 += BKV) {
    S2M2_T0();
    const uint8_t* st[KVS];
#pragma unroll
    for (int s = 0; s < KVS; ++s) st[s] = ring.wait();
    S2M2_T1(11, threadIdx.x == 0);
    S2M2_TRESET();
    float s_[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_[j][e] = 0.f;
    if constexpr (BF) {
      // S = Q K^T for all PR = 64 queries of the tile by this warpgroup's
      // wgmma (m64n64k16, Q and K from swizzled shared memory), float32
      // accumulators in the layout of mma.sync's: warp w4 holds queries
      // 16 w4 ..; both warpgroups compute it, each for its half of PV
      float (&sf)[NT * 4] = *reinterpret_cast<float(*)[NT * 4]>(&s_[0][0]);
      #pragma unroll
      for (int c = 0; c < HDP / KCH; ++c) {
        const uint64_t da = desc_sw128(qp + c * PR * ROW_BYTES);
        const uint64_t db = desc_sw128(st[c / CPS] + (c % CPS) * BOX);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          Wgmma<__nv_bfloat16, BKV>::mma(sf, da + 2 * ks, db + 2 * ks, c > 0 || ks > 0);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(sf);
    } else {
      // the NC warps of a query group each take 1/NC of the head's k-steps
      // and meet in shared memory (xch): every warp adds the NC partial
      // scores in the same order, so all hold the same scores
      constexpr int KW = HDP / 8 / G::NC;  // k-steps of 8 a warp
#pragma unroll
      for (int i = 0; i < KW; ++i) {
        const int ks = ch * KW + i;
        const int c = ks / (KCH / 8);
        const int u = 2 * (ks % (KCH / 8));  // the k-step's first 16-byte unit
        const uint8_t* box = pick(st, c / CPS) + (c % CPS) * BOX;
        uint32_t x[4], ab[4], as[4];
        ldmatrix_x4(x, qp + c * PR * ROW_BYTES + swz(qg * 16 + a_row, u + (lane >> 4)));
        split4(x, ab, as);
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          uint32_t bb[4], bs[4];
          ldmatrix_x4(x, box + swz(16 * jp + (lane & 7) + (lane >> 4) * 8,
                                   u + ((lane >> 3) & 1)));
          split4(x, bb, bs);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            mma_tf32x3(s_[2 * jp + h], ab, as, bb[2 * h], bb[2 * h + 1], bs[2 * h],
                       bs[2 * h + 1]);
        }
      }
      // [warp][j][lane] float4s; barrier 2 + qg: the group's 4 warps
      const int bar = 2 + qg;
      asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(32 * G::NC) : "memory");
#pragma unroll
      for (int j = 0; j < NT; ++j)
        sts128(xch + ((warp * NT + j) * 32 + lane) * 16,
               make_uint4(__float_as_uint(s_[j][0]), __float_as_uint(s_[j][1]),
                          __float_as_uint(s_[j][2]), __float_as_uint(s_[j][3])));
      asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(32 * G::NC) : "memory");
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int w = 0; w < G::NC; ++w) {
          const uint4 v = lds128(xch + (((qg * G::NC + w) * NT + j) * 32 + lane) * 16);
          sum.x += __uint_as_float(v.x);
          sum.y += __uint_as_float(v.y);
          sum.z += __uint_as_float(v.z);
          sum.w += __uint_as_float(v.w);
        }
        s_[j][0] = sum.x;
        s_[j][1] = sum.y;
        s_[j][2] = sum.z;
        s_[j][3] = sum.w;
      }
    }
#pragma unroll
    for (int s = 0; s < KVS; ++s) ring.release(ring.n - KVS + s);
    S2M2_T1(12, threadIdx.x == 0);
    S2M2_TRESET();

    // online softmax over this tile; a quad of lanes shares each row.
    // p = 2^(s * scale * log2(e) - m); keys past W give 0
    if (key0 + BKV > p.W) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + 8 * j + 2 * tig + (e & 1) >= p.W) s_[j][e] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY}, corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s_[j][e]);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh] * sl2);  // finite: key key0 < W
      corr[hh] = ex2(m[hh] - m_new);                    // 0 on the first tile
      m[hh] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s_[j][e] = ex2(fmaf(s_[j][e], sl2, -m[e >> 1]));
        rs[e >> 1] += s_[j][e];
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
      l[hh] = l[hh] * corr[hh] + rs[hh];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];

    S2M2_T1(13, threadIdx.x == 0);
    S2M2_TRESET();
    // O += P V on this warp's columns: V's boxes hold this pass's columns
    const uint8_t* vt[VS];
#pragma unroll
    for (int s = 0; s < VS; ++s) vt[s] = ring.wait();
    S2M2_T1(14, threadIdx.x == 0);
    S2M2_TRESET();
    if constexpr (BF) {
      // P rounded to bf16, as A fragments straight from the accumulators
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc) {
        const uint32_t a[4] = {pack_bf16(s_[2 * kc][0], s_[2 * kc][1]),
                               pack_bf16(s_[2 * kc][2], s_[2 * kc][3]),
                               pack_bf16(s_[2 * kc + 1][0], s_[2 * kc + 1][1]),
                               pack_bf16(s_[2 * kc + 1][2], s_[2 * kc + 1][3])};
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          const int col = ch * DPW + dp * 16 + a_col;  // within the pass
          const int c = col / KCH;
          uint32_t b[4];
          ldmatrix_x4_trans(b, pick(vt, c / CPS) + (c % CPS) * BOX +
                                   swz(kc * 16 + a_row, (col % KCH) >> 3));
          mma_bf16(acc[2 * dp], a, b[0], b[1]);
          mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
        }
      }
    } else {
      // k index t of an 8-key tile stands for key 2t, t + 4 for key 2t + 1,
      // so the thread's own scores are its A fragment
#pragma unroll
      for (int kc = 0; kc < NT; ++kc) {
        const float pp[4] = {s_[kc][0], s_[kc][2], s_[kc][1], s_[kc][3]};
        uint32_t pb[4], ps[4];
        split4(pp, pb, ps);
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          const int col = ch * DPW + 8 * j + g;  // within the pass
          const int c = col / KCH;
          const uint8_t* box = pick(vt, c / CPS) + (c % CPS) * BOX;
          uint32_t vb0, vs0, vb1, vs1;
          split_tf32(lds_f(box, kc * 8 + 2 * tig, col % KCH), vb0, vs0);
          split_tf32(lds_f(box, kc * 8 + 2 * tig + 1, col % KCH), vb1, vs1);
          mma_tf32x3(acc[j], pb, ps, vb0, vb1, vs0, vs1);
        }
      }
    }
    for (int s = 0; s < VS; ++s) ring.release(ring.n - VS + s);
    S2M2_T1(15, threadIdx.x == 0);
  }

  const int hd = p.hd;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = qg * 16 + g + 8 * hh;
    const float inv = 1.f / l[hh];
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * j + 2 * tig + e;
        if (col < hd)
          sts(op + panel_off<T>(PR, row, h * hd + col), from_f<T>(acc[j][2 * hh + e] * inv));
      }
  }
  }
}

// ---- the consumers' schedule ----------------------------------------------------

// out[0, V) = rnd(rnd(z + s) + bias[n ..]) for the staged piece s (bias may
// be null: rnd(z + s)); zv: z's 16 bytes as fetch_row read them, when the
// row allows 16-byte access; z and out may be the same row
template <typename T>
__device__ __forceinline__ void residual(const Params& p, const T* z, T* out,
                                         const uint4& piece, int n, const T* bias,
                                         const uint4& zv) {
  constexpr int V = 16 / sizeof(T);
  union U {
    uint4 q;
    T e[V];
  };
  U s, zz, o;
  s.q = piece;
  if (p.vec && n + V <= p.C) {
    zz.q = zv;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float v = rnd<T>(to_f(zz.e[j]) + to_f(s.e[j]));
      if (bias != nullptr) v = rnd<T>(v + to_f(bias[n + j]));
      o.e[j] = from_f<T>(v);
    }
    *reinterpret_cast<uint4*>(out) = o.q;
  } else {
    for (int j = 0; j < V && n + j < p.C; ++j) {
      float v = rnd<T>(to_f(z[j]) + to_f(s.e[j]));
      if (bias != nullptr) v = rnd<T>(v + to_f(bias[n + j]));
      out[j] = from_f<T>(v);
    }
  }
}

template <typename T, int DPW, int PASSES>
__device__ void consume(const Params& p, Ring& ring, uint8_t* p0, uint8_t* p1, int half,
                        uint8_t* staging, uint64_t* kvready) {
  using G = Geo<T>;
  constexpr bool BF = sizeof(T) == 2;
  constexpr int PR = G::PR, KCH = G::KCH, V = 16 / sizeof(T);
  const int tid = threadIdx.x, warp = tid >> 5, wg = tid >> 7, w4 = warp & 3;
  uint8_t* stg = staging + warp * STG_WARP;
  const int W = p.W, C = p.C, E = p.E, hd = p.hd, hdp = p.hdp;
  const T* x = static_cast<const T*>(p.x);
  T* y = static_cast<T*>(p.y);
  const size_t tok_elems = (size_t)p.heads * hdp;  // a token of the q/k/v scratch
  const size_t blk = (size_t)blockIdx.x * 2 * W * tok_elems;
  T* const qkv[3] = {static_cast<T*>(p.q) + blk, static_cast<T*>(p.k) + blk,
                     static_cast<T*>(p.v) + blk};
  const int kc_c = cdiv(C, KCH), kc_e = cdiv(E, KCH);
  const int kpad_c = kc_c * KCH, kpad_e = kc_e * KCH;
  const int nt_c = cdiv(C, BN), nt_e = cdiv(E, BN);
  auto rounded = [](int, float a) { return rnd<T>(a); };
  auto nothing = [](int, int) { return make_uint4(0, 0, 0, 0); };

  // C = A B^T over the rows of the panel(s): phase 1 (2 PR rows, two
  // panels) or phase 2 (PR rows, the one panel at a); fetch(row, n) reads
  // ahead what post(row, n, piece, fetched) adds
  auto gemm1 = [&](int n_tiles, int k_chunks, auto pre, auto fetch, auto post) {
    if constexpr (BF) {
      uint4 z[Pieces<T, 1, 16>::COUNT];
      const int r0 = wg * 64 + w4 * 16;
      gemm_bf16<128>(
          ring, p0 + wg * half, 0, n_tiles, k_chunks,
          [&](int nt) { epilogue_fetch<T, 1, 16>(r0, nt * BN, fetch, z); },
          [&](int nt, float* acc) { epilogue<T, 1, 16>(acc, r0, nt * BN, stg, pre, z, post); });
    } else {
      uint4 z[Pieces<T, 2, 4>::COUNT];
      const int r0 = (warp >> 2) * 32, c0 = (warp & 3) * 32;
      gemm_f32<4>(
          ring, p0 + (warp >> 2) * half, c0, n_tiles, k_chunks,
          [&](int nt) { epilogue_fetch<T, 2, 4>(r0, nt * BN + c0, fetch, z); },
          [&](int nt, float* acc) {
            epilogue<T, 2, 4>(acc, r0, nt * BN + c0, stg, pre, z, post);
          });
    }
  };
  auto gemm2 = [&](const uint8_t* a, int n_tiles, int k_chunks, auto pre, auto fetch,
                   auto post) {
    if constexpr (BF) {
      uint4 z[Pieces<T, 1, 8>::COUNT];
      gemm_bf16<64>(
          ring, a, wg * 64 * ROW_BYTES, n_tiles, k_chunks,
          [&](int nt) { epilogue_fetch<T, 1, 8>(w4 * 16, nt * BN + wg * 64, fetch, z); },
          [&](int nt, float* acc) {
            epilogue<T, 1, 8>(acc, w4 * 16, nt * BN + wg * 64, stg, pre, z, post);
          });
    } else {
      uint4 z[Pieces<T, 2, 2>::COUNT];
      gemm_f32<2>(
          ring, a, warp * 16, n_tiles, k_chunks,
          [&](int nt) { epilogue_fetch<T, 2, 2>(0, nt * BN + warp * 16, fetch, z); },
          [&](int nt, float* acc) {
            epilogue<T, 2, 2>(acc, 0, nt * BN + warp * 16, stg, pre, z, post);
          });
    }
  };

  for (int pair = blockIdx.x; pair < p.n_pairs; pair += gridDim.x) {
    const size_t view_row[2] = {(size_t)pair * W, (size_t)(p.right0 + pair) * W};
    for (int sub = 0; sub < 2; ++sub) {
      const T* zin = sub ? y : x;  // the sublayer's input rows
      const int att = sub ? SQ : CQ;
      const int ffn = sub ? F2W1 : F1W1;
      const T* vbias = static_cast<const T*>(p.w[att + 3]);
      const T* b1 = static_cast<const T*>(p.w[ffn + 1]);
      const T* b2 = static_cast<const T*>(p.w[ffn + 3]);

      // phase 1: q, k, v of the pair's 2W tokens (view 0, then view 1), 2 PR
      // at a time, into the scratch at (token, head, column < hd)
      for (int r0 = 0; r0 < 2 * W; r0 += 2 * PR) {
        S2M2_T0();
        layer_norm<T>(
            p,
            [&](int r) -> const T* {
              const int t = r0 + r;
              if (t >= 2 * W) return nullptr;
              const int view = t >= W;
              return zin + (view_row[view] + t - view * W) * C;
            },
            2 * PR, p0, half, kpad_c);
        fence_proxy_async();
        consumer_sync();
        for (int mat = 0; mat < 3; ++mat) {
          T* dst = qkv[mat];
          const bool vb = mat == 2;
          gemm1(
              nt_e, kc_c,
              [&](int n, float a) {
                float v = rnd<T>(a);
                if (vb && n < E) v = rnd<T>(v + to_f(vbias[n]));
                return v;
              },
              nothing,
              [&](int r, int n, const uint4& pc, const uint4&) {
                const int t = r0 + r;
                if (t >= 2 * W || n >= E) return;
                T* row = dst + t * tok_elems;
                if (hd % V == 0 && n + V <= E) {
                  *reinterpret_cast<uint4*>(row + (n / hd) * hdp + n % hd) = pc;
                } else {
                  for (int j = 0; j < V && n + j < E; ++j)
                    row[((n + j) / hd) * hdp + (n + j) % hd] = reinterpret_cast<const T*>(&pc)[j];
                }
              });
        }
        consumer_sync();  // the panels are free for the next rows
        S2M2_T1(4, tid == 0);
      }
      // k and v are written: the producer's TMA may read them now
      fence_proxy_async();
      consumer_sync();
      if (tid == 0) mbar_arrive(kvready);

      // phase 2, per tile of PR queries of view d: attention over every head
      // into panel 0, proj + residual into y, then the FFN on those rows
      for (int d = 0; d < 2; ++d) {
        for (int q0 = 0; q0 < W; q0 += PR) {
          for (int i = tid; i < PR * (kpad_e - E); i += CONSUMERS) {
            const int r = i / (kpad_e - E);
            sts(p0 + panel_off<T>(PR, r, E + i % (kpad_e - E)), from_f<T>(0.f));
          }
          for (int h = 0; h < p.heads; ++h) {
            // Q of head h, zero past hd and past W
            S2M2_T0();
            const int units = hdp / V;
            for (int i = tid; i < PR * units; i += CONSUMERS) {
              const int r = i / units, col = (i - r * units) * V;
              const int t = q0 + r;
              int bytes = t < W ? (hd - col) * (int)sizeof(T) : 0;
              bytes = bytes < 0 ? 0 : (bytes > 16 ? 16 : bytes);
              const T* src =
                  bytes ? qkv[0] + (size_t)(d * W + t) * tok_elems + h * hdp + col : qkv[0];
              cp_async_bytes(p1 + panel_off<T>(PR, r, col), src, bytes);
            }
            asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
            fence_proxy_async();  // Q, to wgmma's proxy
            consumer_sync();
            S2M2_T1(10, tid == 0);
            S2M2_TRESET();
            attend<T, DPW, PASSES>(ring, p, p1, p0, h, staging);
            S2M2_T1(3, tid == 0);
            fence_proxy_async();  // panel 0, to wgmma's proxy
            consumer_sync();
          }
          const size_t row0 = view_row[d] + q0;
          // the residual row's 16 bytes, where rows allow 16-byte access
          auto fetch_row = [&](const T* z) {
            return [&, z](int r, int n) {
              return p.vec && q0 + r < W && n + V <= C
                         ? *reinterpret_cast<const uint4*>(z + (row0 + r) * C + n)
                         : make_uint4(0, 0, 0, 0);
            };
          };
          S2M2_T0();
          gemm2(p0, nt_c, kc_e, rounded, fetch_row(zin),
                [&](int r, int n, const uint4& pc, const uint4& zv) {
                  if (q0 + r >= W || n >= C) return;
                  const size_t o = (row0 + r) * C + n;
                  residual<T>(p, zin + o, y + o, pc, n, nullptr, zv);
                });
          consumer_sync();  // the rows are in y; panel 0 is free
          S2M2_T1(5, tid == 0);
          {
            S2M2_T0();
            layer_norm<T>(
                p,
                [&](int r) -> const T* { return q0 + r < W ? y + (row0 + r) * C : nullptr; },
                PR, p1, half, kpad_c);
            fence_proxy_async();
            consumer_sync();
            S2M2_T1(6, tid == 0);
          }
          S2M2_TRESET();
          gemm2(
              p1, nt_e, kc_c,
              [&](int n, float a) {
                if (n >= E) return 0.f;
                const float v = rnd<T>(a) + to_f(b1[n]);
                return rnd<T>(0.5f * v * (1.f + erff(v * 0.70710678118654752f)));
              },
              nothing,
              [&](int r, int n, const uint4& pc, const uint4&) {
                if (n < kpad_e)
                  sts128(p0 + panel_off<T>(PR, r, n), pc);
              });
          fence_proxy_async();  // the hidden panel, to wgmma's proxy
          consumer_sync();
          gemm2(p0, nt_c, kc_e, rounded, fetch_row(y),
                [&](int r, int n, const uint4& pc, const uint4& zv) {
                  if (q0 + r >= W || n >= C) return;
                  const size_t o = (row0 + r) * C + n;
                  residual<T>(p, y + o, y + o, pc, n, b2, zv);
                });
          consumer_sync();
          S2M2_T1(7, tid == 0);
        }
      }
    }
  }
}

template <typename T, int DPW, int PASSES>
__global__ void __launch_bounds__(THREADS, 1)
    fused_block_kernel(const __grid_constant__ Maps maps, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout L(sizeof(T), Geo<T>::PR, p.C, p.E, p.hdp, p.stages);
  uint8_t* ring = smem;
  uint8_t* p0 = smem + L.ring;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + S2M2_D_MAX_STAGES;
  uint64_t* kvready = empty + S2M2_D_MAX_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    mbar_init(kvready, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    // the producer warpgroup gives its registers to the consumers: 2 x 128
    // x 232 + 128 x 40 of the SM's 65,536; one warp of it runs the schedule
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x < CONSUMERS + 32) produce<T>(p, maps, ring, full, empty, kvready);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    Ring r{ring, full, empty, p.stages, 0};
    S2M2_T0();
    consume<T, DPW, PASSES>(p, r, p0, p0 + L.half, L.half, smem + L.stg, kvready);
    S2M2_T1(2, threadIdx.x == 0);
  }
}

// ---- host ---------------------------------------------------------------------

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

CUtensorMapDataType tma_type(int dtype) {
  return dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// A row-major (rows, cols) weight read in boxes of 128 rows x 128 bytes into
// the 128-byte swizzle, zero past the edges; encoded once per weight (a map
// holds nothing but the address, shape, stride and box).
bool weight_map(CUtensorMap* map, const void* w, int dtype, int rows, int cols) {
  using Key = std::tuple<const void*, int, int, int>;
  static std::mutex lock;
  static std::map<Key, CUtensorMap> cache;
  const Key key{w, dtype, rows, cols};
  std::lock_guard<std::mutex> guard(lock);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return false;
  const int esz = dtype == 0 ? 4 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esz};
  const cuuint32_t box[2] = {(cuuint32_t)(ROW_BYTES / esz), (cuuint32_t)BN};
  const cuuint32_t estr[2] = {1, 1};
  if (fn(map, tma_type(dtype), 2, const_cast<void*>(w), dims, strides, box, estr,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (cache.size() > 4096) cache.clear();
  cache.emplace(key, *map);
  return true;
}

// The k or v scratch, (slabs, W, heads, hdp) with columns [hd, hdp) unused,
// read in boxes of 128 bytes of one head's columns x bkv tokens of one slab
// (a view of a block's pair); columns past hd and tokens past W read zero.
bool kv_map(CUtensorMap* map, const void* base, int dtype, int hd, int heads, int W,
            int slabs, int hdp, int bkv) {
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t esz = dtype == 0 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)W,
                              (cuuint64_t)slabs};
  const cuuint64_t strides[3] = {hdp * esz, (cuuint64_t)heads * hdp * esz,
                                 (cuuint64_t)W * heads * hdp * esz};
  const cuuint32_t box[4] = {(cuuint32_t)(ROW_BYTES / esz), 1, (cuuint32_t)bkv, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, tma_type(dtype), 4, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int DPW, int PASSES>
cudaError_t launch(const Maps& m, const Params& p, int blocks, int smem, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      fused_block_kernel<T, DPW, PASSES>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (attr != cudaSuccess) return attr;
  fused_block_kernel<T, DPW, PASSES><<<blocks, THREADS, smem, s>>>(m, p);
  return cudaGetLastError();
}

// dtype 0 float32, 1 bfloat16; dpw: the attention instance (columns a warp
// owns); a plan this build was not compiled for is refused
cudaError_t dispatch(int dtype, int dpw, int passes, const Maps& m, const Params& p, int blocks, int smem,
                     cudaStream_t s) {
#define S2M2_D_CASE(DT, DPW, PASSES)                                          \
  if (dtype == DT && dpw == DPW && passes == PASSES)                          \
    return launch<std::conditional_t<DT == 0, float, __nv_bfloat16>, DPW, PASSES>( \
        m, p, blocks, smem, s);
  S2M2_D_INSTANCES(S2M2_D_CASE)
#undef S2M2_D_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// x, y: (R, W, C) contiguous rows, pairs (i, right0 + i) for i < n_pairs;
// weights: the 18 block weights, contiguous, (out, in) Linear layout; all of
// one dtype (0 float32, 1 bfloat16). scratch: 3 x blocks x 2W x heads x hdp
// elements, 16-byte aligned (q, then k, then v). (dpw, passes, stages, smem,
// gather):
// the plan of ops/fused_block.py; smem must equal the layout's bytes, and
// gather (plain loads of the weights instead of TMA) is taken as well when
// a weight is not 16-byte aligned. Returns the cudaError_t of the launch.
extern "C" int s2m2_fused_basic_attn_block(const void* x, void* y,
                                           const void* const* weights, void* scratch,
                                           int blocks, int n_pairs, int right0, int W,
                                           int C, int E, int heads, int dtype, int dpw,
                                           int passes, int stages, int smem, int gather,
                                           void* stream) {
  if (blocks < 1 || n_pairs < 1 || right0 < n_pairs || W < 1 || C < 1 || C > MAX_DIM ||
      E < 1 || E > MAX_DIM || heads < 1 || E % heads != 0 || (dtype != 0 && dtype != 1) ||
      dpw < 1 || passes < 1 || stages < 1 || stages > S2M2_D_MAX_STAGES || !aligned16(scratch))
    return cudaErrorInvalidValue;
  const int esz = dtype == 0 ? 4 : 2;
  const int pr = dtype == 0 ? S2M2_D_PR_F32 : S2M2_D_PR_BF16;
  const int nc = dtype == 0 ? S2M2_D_NC_F32 : S2M2_D_NC_BF16;
  const int bkv = dtype == 0 ? S2M2_D_BKV_F32 : S2M2_D_BKV_BF16;
  const int hd = E / heads, hdp = nc * dpw * passes;
  const int kvs = cdiv(cdiv(hdp, ROW_BYTES / esz), STAGE_BYTES / (bkv * ROW_BYTES));
  if (hdp < hd || hdp > MAX_DIM || stages < kvs || Layout(esz, pr, C, E, hdp, stages).bytes != smem)
    return cudaErrorInvalidValue;
  Params p;
  std::memset(&p, 0, sizeof(p));
  p.x = x;
  p.y = y;
  for (int i = 0; i < N_WEIGHTS; ++i) {
    p.w[i] = weights[i];
    if (!aligned16(weights[i])) gather = 1;
  }
  if ((C * esz) % 16 != 0 || (E * esz) % 16 != 0) gather = 1;
  const size_t part = (size_t)blocks * 2 * W * heads * hdp * esz;
  p.q = scratch;
  p.k = static_cast<uint8_t*>(scratch) + part;
  p.v = static_cast<uint8_t*>(scratch) + 2 * part;
  p.n_pairs = n_pairs;
  p.right0 = right0;
  p.W = W;
  p.C = C;
  p.E = E;
  p.heads = heads;
  p.hd = hd;
  p.hdp = hdp;
  p.passes = passes;
  p.stages = stages;
  p.gather = gather;
  p.vec = (C * esz) % 16 == 0 && aligned16(x) && aligned16(y);
  p.scale_log2 = (float)(pow((double)hd, -0.5) * 1.4426950408889634);
  Maps m;
  std::memset(&m, 0, sizeof(m));
  static const int mats[12] = {CQ, CK, CV, CP, F1W1, F1W2, SQ, SK, SV, SP, F2W1, F2W2};
  if (!gather) {
    for (int i : mats) {
      const bool ec = i == CP || i == F1W2 || i == SP || i == F2W2;  // (C, E), else (E, C)
      if (!weight_map(&m.w[i], weights[i], dtype, ec ? C : E, ec ? E : C))
        return cudaErrorInvalidValue;
    }
  }
  if (!kv_map(&m.k, p.k, dtype, hd, heads, W, 2 * blocks, hdp, bkv) ||
      !kv_map(&m.v, p.v, dtype, hd, heads, W, 2 * blocks, hdp, bkv))
    return cudaErrorInvalidValue;
  return dispatch(dtype, dpw, passes, m, p, blocks, smem, static_cast<cudaStream_t>(stream));
}

#if S2M2_D_TRACE
// The cycle sums of a traced build, 1024 x 16, and zero them.
extern "C" int s2m2_fused_block_trace(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
  if (err != cudaSuccess) return err;
  static unsigned long long zero[1024][16];
  return cudaMemcpyToSymbol(g_trace, zero, sizeof(g_trace));
}
#endif

extern "C" const char* s2m2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
