// Int8 attention core for Hopper (sm_90a): kernel F.
//
// Replaces no Pallas kernel: it is the port of the JAX package's int8_attn
// opt-in, s2m2_tpu/models/quant.py:369-404 (sdpa_maybe_quantized), which
// XLA compiles there. PyTorch has no batched int8 product on CUDA
// (torch._int_mm is 2D only), so the port needs a kernel of its own. For
// (B, N, D) sequences q (B, Nq, D), k and v (B, Nk, D) in float32 or bf16,
// each sequence attending only within itself:
//
//   q_q, k_q, v_q = clip(rint(x * inv_x), -127, 127)    (static scales)
//   S   = q_q k_q^T in int32
//   e   = exp(float(S) * c - max_j float(S) * c),  c = float32(s_q s_k D^-1/2)
//   l   = sum_j e
//   p_q = rint(127 e)        (= rint(attn * 127 / pmax): pmax = 1 / l)
//   O   = p_q v_q in int32
//   out = float(O) * (float32(1 / l) * float32(s_v / 127)), cast to v's dtype
//
// JAX computes attn = softmax(score), pmax = max attn, then rint(attn *
// (127 / pmax)); the identity pmax = 1 / l gives rint(127 e) here, which
// differs only where 127 attn / pmax rounds to within a few float32 ulps
// of a half: one quantum of p there (the plain version in
// ops/int8_attention.py follows JAX's order exactly).
//
// What bounds it on the H100: its bytes (q, k, v read and the output
// written once, 3.35 TB/s) at every shape of the port; its 4 B Nq Nk D
// int8 operations (1,979 TOP/s) come near them only at N = 1216. What
// holds it above that is the exponential work (an expf and a few float
// operations per score, issue-bound, twice the scores' count where pass 1
// recomputes them), latency where few units run (152 at B = 8, N = 1216),
// and at N <= 152 the host's launch cost. The first version ran at 21-560x
// the bound: every 64-query block quantized its sequence's K twice and V
// once with scalar loads, nothing overlapped its loads, both products ran
// on mma.sync. This design:
//  - a prologue (int8_attn_quantize_kernel) reads q, k and v once with
//    16-byte loads and writes int8 Q and K rows (d padded to DP, a
//    multiple of 32) and Vt, V transposed d-major per sequence (keys padded
//    to 16), into a workspace the wrapper takes from torch;
//  - the attention kernel (int8_attn_kernel): a unit is 64 queries of one
//    sequence and one chunk of at most 128 output columns, over all keys.
//    One thread of a producer warpgroup brings the Q tile once,
//    then 128-key tiles of K (pass 1) and of K and Vt (pass 2) by TMA
//    (128-byte swizzle, rows past the sequence zero-filled) through a ring
//    of mbarrier stages; one consumer warpgroup (its registers raised by
//    setmaxnreg) runs both products on wgmma: m64n128k32 for S = Q K^T
//    from shared memory, m64nDCHk32 for P Vt with P from registers;
//  - pass 1 finds each row's largest S over all keys (an integer: exact),
//    two tiles' products a round trip; pass 2 recomputes S, forms e, l and
//    p_q in registers with no branch (a key past the sequence takes
//    exp(-inf); a 32-key step wholly past it is skipped) and no converter
//    (the int/float conversions are exact float adds), and issues P Vt,
//    whose wait comes with the next tile's S. The int32 accumulator holds
//    keys (2t, 2t+1, 8+2t, 9+2t) of each 16 where the A fragment wants
//    (4t .. 4t+3), so Vt keeps each 16 keys in that order (`vt_pos`) and P
//    is packed with no shuffle. The warpgroup index is made warp-uniform
//    (__shfl_sync) so that ptxas does not serialize the wgmma (C7520);
//  - one key tile (Nk <= 128: N = 76) takes the fused route
//    (int8_attn_fused_kernel): one launch, no prologue, no workspace; each
//    unit quantizes straight into the same swizzled shared layout;
//  - a unit owns its rows' whole sums, so the output is the same bits from
//    run to run. (Splitting pass 2's keys over more units, to give the
//    152 units of a B = 8, N = 1216 call company, was slower at every such
//    shape on the H100: each split repeats pass 1.)

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "hopper.cuh"  // mbarrier, TMA and wgmma helpers; encoder()

// the wgmma wrappers of the plan's products, written by _build.py from
// ops/int8_attention.py (`instances_header`)
#include "int8_attention_instances.h"

namespace {

constexpr int BQ = 64;        // queries a unit: one warpgroup's wgmma rows
constexpr int BKEY = 128;     // keys a tile: one 128-byte swizzle row of Vt
constexpr int KTB = 128;      // bytes of d a k tile of Q and K
constexpr int MAX_D = 512;
constexpr int MAX_STAGES = 6;
constexpr int MAX_SMEM = 232448;
// a consumer warpgroup and a producer warpgroup (one thread of it issues
// the copies); setmaxnreg moves the producer's registers to the consumers:
// (216 + 40) x 128 a block, two blocks an SM
constexpr int THREADS = 256;
constexpr int Q_TILE = BQ * KTB;      // 8 KB a k tile of Q
constexpr int K_TILE = BKEY * KTB;    // 16 KB a k tile of K

// A measurement build (chip_probe.py `fattn --trace`) with S2M2_F_TRACE 1:
// thread 0 of the consumers and the producer's thread add the cycles of
// each stage of a unit to g_trace (slots in F_TRACE of chip_probe.py),
// which s2m2_int8_attention_trace reads and zeroes. 0 in every build the
// port uses.
#ifndef S2M2_F_TRACE
#define S2M2_F_TRACE 0
#endif
#if S2M2_F_TRACE
__device__ unsigned long long g_trace[16];
#define F_T0() long long t0_ = clock64()
#define F_T1(slot)                                                         \
  do {                                                                     \
    const long long t1_ = clock64();                                       \
    if (threadIdx.x % 128 == 0) atomicAdd(&g_trace[slot], t1_ - t0_);      \
    t0_ = t1_;                                                             \
  } while (0)
#else
#define F_T0() \
  do {         \
  } while (0)
#define F_T1(slot) \
  do {             \
  } while (0)
#endif

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// two neighbouring outputs, 4- (bf16) or 8-byte (float32) aligned
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// clip(rint(x * inv), -127, 127), rounding half to even as jnp.round
__device__ __forceinline__ int8_t quant(float x, float inv) {
  const float r = rintf(__fmul_rn(x, inv));
  return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

// 8 consecutive values from 16-byte aligned memory, as floats
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&a);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
}

// Columns c0 .. c0 + 15 of a row of D values, quantized; 0 past D. vec:
// D % 8 == 0 and the row 16-byte aligned, so each 8 is one or two loads.
template <typename T>
__device__ __forceinline__ void quant16(const T* row, int c0, int D, float inv, bool vec,
                                        int8_t (&o)[16]) {
  if (vec) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float f[8];
      const bool live = c0 + 8 * h < D;
      if (live) load8(row + c0 + 8 * h, f);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[8 * h + j] = live ? quant(f[j], inv) : int8_t(0);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) o[j] = c0 + j < D ? quant(to_f(row[c0 + j]), inv) : int8_t(0);
  }
}

// The position of key kappa (0..15) within its 16 in Vt: the accumulator
// of S holds keys 2t, 2t+1, 8+2t, 9+2t of each 16 in lane t of a quad, and
// P's A fragment takes them as its k positions 4t .. 4t+3.
__device__ __forceinline__ int vt_pos(int kappa) {
  return 4 * ((kappa & 7) >> 1) + (kappa & 1) + 2 * (kappa >> 3);
}

struct QuantArgs {
  const void* q;
  const void* k;
  const void* v;
  int8_t* qi;    // (B, Nq, DP)
  int8_t* ki;    // (B, Nk, DP)
  int8_t* vt;    // (B, DP, NkP), each 16 keys in vt_pos order
  long long rows_q, rows_k;  // B Nq, B Nk
  int Nk, D, DP, NkP;
  float inv_q, inv_k, inv_v;
  long long row_blocks;  // blocks of the row part; then the Vt tiles
  int vkb, vdb;          // Vt tiles of 64 keys x 64 d a sequence
  bool vec;
};

// The prologue: blocks below row_blocks write 16 bytes of a Q or K row a
// thread; the others a 64-key x 64-d tile of Vt each, transposed through
// shared memory so that both the loads and the 16-byte stores are along
// rows.
template <typename T>
__global__ void __launch_bounds__(256) int8_attn_quantize_kernel(const QuantArgs a) {
  const int tid = threadIdx.x;
  if (blockIdx.x < a.row_blocks) {
    const int groups = a.DP / 16;
    const long long i = blockIdx.x * 256LL + tid;
    if (i >= (a.rows_q + a.rows_k) * groups) return;
    long long r = i / groups;
    const int c0 = static_cast<int>(i - r * groups) * 16;
    const T* src;
    int8_t* dst;
    float inv;
    if (r < a.rows_q) {
      src = static_cast<const T*>(a.q) + r * a.D;
      dst = a.qi + r * a.DP;
      inv = a.inv_q;
    } else {
      r -= a.rows_q;
      src = static_cast<const T*>(a.k) + r * a.D;
      dst = a.ki + r * a.DP;
      inv = a.inv_k;
    }
    union {
      int8_t b[16];
      uint4 u;
    } o;
    quant16(src, c0, a.D, inv, a.vec, o.b);
    *reinterpret_cast<uint4*>(dst + c0) = o.u;
    return;
  }
  __shared__ __align__(16) int8_t tile[64][80];  // [d][key position], 16 bytes of pad
  const long long vb = blockIdx.x - a.row_blocks;
  const int per_seq = a.vkb * a.vdb;
  const long long b = vb / per_seq;
  const int rem = static_cast<int>(vb - b * per_seq);
  const int k0 = rem / a.vdb * 64;
  const int d0 = rem % a.vdb * 64;
  {
    const int r = tid >> 2;
    const int dsub = (tid & 3) * 16;
    int8_t o[16];
    if (k0 + r < a.Nk) {
      const T* row = static_cast<const T*>(a.v) + (b * a.Nk + k0 + r) * a.D;
      quant16(row, d0 + dsub, a.D, a.inv_v, a.vec, o);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) o[j] = 0;
    }
    const int pos = (r & ~15) + vt_pos(r & 15);
#pragma unroll
    for (int j = 0; j < 16; ++j) tile[dsub + j][pos] = o[j];
  }
  __syncthreads();
  const int dr = tid >> 2;
  const int kc = (tid & 3) * 16;
  if (d0 + dr < a.DP && k0 + kc < a.NkP)
    *reinterpret_cast<uint4*>(a.vt + (b * a.DP + d0 + dr) * a.NkP + k0 + kc) =
        *reinterpret_cast<const uint4*>(&tile[dr][kc]);
}

struct AttnArgs {
  void* out;
  int Nq, Nk, D, DP;
  int dtiles;  // 128-byte k tiles of Q and K rows
  int ktiles;  // 128-key tiles
  int qblocks, chunks, stages;
  float c, out_scale;
};

// STEPS k steps of 32 bytes of one 128-byte k tile, unrolled: the
// descriptors advance 32 bytes (2 units of 16) inside the swizzle atom
template <int STEPS>
__device__ __forceinline__ void k_steps(int (&acc)[64], uint64_t da, uint64_t db, int keep) {
#pragma unroll
  for (int ks = 0; ks < STEPS; ++ks)
    Wgmma<int8_t, BKEY>::mma(acc, da + 2 * ks, db + 2 * ks, ks > 0 ? 1 : keep);
}

// S = Q K^T for one key tile: acc[j * 4 + h * 2 + e] = S(row 16 warp + g +
// 8 h, key 8 j + 2 t + e) of the tile (g = lane / 4, t = lane % 4); the k
// tiles' steps unrolled, as many as DP holds
__device__ __forceinline__ void scores(int (&acc)[64], const uint8_t* sq, const uint8_t* sk,
                                       int dtiles, int dp) {
  for (int kd = 0; kd < dtiles; ++kd) {
    const uint64_t da = desc_sw128(sq + kd * Q_TILE);
    const uint64_t db = desc_sw128(sk + kd * K_TILE);
    const int steps = min(KTB, dp - kd * KTB) / 32;
    const int keep = kd > 0;
    if (steps == 4)
      k_steps<4>(acc, da, db, keep);
    else if (steps == 3)
      k_steps<3>(acc, da, db, keep);
    else if (steps == 2)
      k_steps<2>(acc, da, db, keep);
    else
      k_steps<1>(acc, da, db, keep);
  }
}

// Each row's largest S over the tile's real keys (those below `lim`),
// folded into smax[2] (rows g and g + 8)
__device__ __forceinline__ void row_max(const int (&acc)[64], int lim, int t4, int (&smax)[2]) {
  if (lim >= BKEY) {
#pragma unroll
    for (int i = 0; i < 64; ++i) smax[(i >> 1) & 1] = max(smax[(i >> 1) & 1], acc[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if ((i >> 2) * 8 + 2 * t4 + (i & 1) < lim)
        smax[(i >> 1) & 1] = max(smax[(i >> 1) & 1], acc[i]);
  }
}

// e = exp(float(S) c - m), l += e and p_q = rint(127 e) of one key tile,
// packed into P's A fragments: k step ks (keys 32 ks ..) takes a0 (row g),
// a1 (row g + 8) of its first 16 keys, accumulator chunks 4 ks and 4 ks +
// 1, then a2, a3 of its second 16. Keys past `lim` give e = 0: with
// PARTIAL, a k step past them is skipped whole (a branch the warpgroup
// takes together) and the others select exp(-inf) = 0, with no branch, so
// a step's 16 exponentials interleave. Both conversions avoid the
// converter: rint(127 e) is the low byte of the bits of 127 e + 1.5 * 2^23
// (the add rounds half to even), and with SMALL (|S| < 2^22: DP <= 256)
// float(S) is the bits of 1.5 * 2^23 plus S less 1.5 * 2^23, both exact.
template <bool SMALL, bool PARTIAL>
__device__ __forceinline__ void probabilities(const int (&acc)[64], int lim, int t4, float c,
                                              const float (&m)[2], float (&l)[2],
                                              int (&pa)[16]) {
  constexpr float MAGIC = 12582912.f;  // 1.5 * 2^23, bits 0x4B400000
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (PARTIAL && 32 * ks >= lim) {
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[4 * ks + r] = 0;
      continue;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 4 * ks + 2 * (r >> 1);  // the first chunk of the 16 keys
      const int h = r & 1;                  // row g or g + 8
      int bits[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int jn = j + (n >> 1);
        const int a = acc[jn * 4 + h * 2 + (n & 1)];
        const float sf = SMALL ? __fsub_rn(__int_as_float(0x4B400000 + a), MAGIC)
                               : static_cast<float>(a);
        float x = __fsub_rn(__fmul_rn(sf, c), m[h]);
        if (PARTIAL && jn * 8 + 2 * t4 + (n & 1) >= lim) x = __int_as_float(0xff800000);
        const float ex = expf(x);
        l[h] += ex;
        bits[n] = __float_as_int(__fadd_rn(__fmul_rn(127.f, ex), MAGIC));
      }
      pa[4 * ks + r] = static_cast<int>(__byte_perm(__byte_perm(bits[0], bits[1], 0x0040),
                                                    __byte_perm(bits[2], bits[3], 0x0040),
                                                    0x5410));
    }
  }
}

// probabilities() for a tile of `lim` real keys
template <bool SMALL>
__device__ __forceinline__ void tile_probabilities(const int (&acc)[64], int lim, int t4,
                                                   float c, const float (&m)[2], float (&l)[2],
                                                   int (&pa)[16]) {
  if (lim >= BKEY)
    probabilities<SMALL, false>(acc, lim, t4, c, m, l, pa);
  else
    probabilities<SMALL, true>(acc, lim, t4, c, m, l, pa);
}

// rows g and g + 8: the quad's largest S, and m = float(max S) c
__device__ __forceinline__ void reduce_max(int (&smax)[2], float c, float (&m)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    smax[h] = max(smax[h], __shfl_xor_sync(0xffffffffu, smax[h], 1));
    smax[h] = max(smax[h], __shfl_xor_sync(0xffffffffu, smax[h], 2));
    m[h] = __fmul_rn(static_cast<float>(smax[h]), c);
  }
}

// the quad's sums of e for rows g and g + 8
__device__ __forceinline__ void reduce_sum(float (&l)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
}

// out = float(O) (float32(1 / l) out_scale) for the warp's 16 rows of the
// unit (first query q0) and its DCH columns from c0, cast to T; a thread's
// two neighbouring columns one store where D is even
template <typename T, int DCH>
__device__ __forceinline__ void store_rows(void* out_base, const int (&o)[DCH / 2],
                                           const float (&l)[2], float out_scale, int b,
                                           int q0, int c0, int Nq, int D, int warp, int g,
                                           int t4) {
  float scale[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) scale[h] = __fmul_rn(__frcp_rn(l[h]), out_scale);
  T* out = static_cast<T*>(out_base) + static_cast<long long>(b) * Nq * D;
  const bool pairs = D % 2 == 0;
#pragma unroll
  for (int j = 0; j < DCH / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + warp * 16 + g + 8 * h;
      const int col = c0 + j * 8 + 2 * t4;
      if (row >= Nq || col >= D) continue;
      T* dst = out + static_cast<long long>(row) * D + col;
      const float v0 = __fmul_rn(static_cast<float>(o[j * 4 + h * 2]), scale[h]);
      const float v1 = __fmul_rn(static_cast<float>(o[j * 4 + h * 2 + 1]), scale[h]);
      if (pairs) {
        store_pair(dst, v0, v1);
      } else {
        store_f(dst, v0);
        if (col + 1 < D) store_f(dst + 1, v1);
      }
    }
}

template <typename T, int DCH>
__global__ void __launch_bounds__(THREADS, 2)
    int8_attn_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, const AttnArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int stage_bytes = p.dtiles * K_TILE + DCH * BKEY;
  uint8_t* sq = smem;
  uint8_t* ring = smem + p.dtiles * Q_TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * stage_bytes);
  uint64_t* empty = full + p.stages;
  uint64_t* qbar = empty + p.stages;

  // unit (b, query block, chunk), chunk fastest: the units of one sequence
  // run together and share its K and Vt in L2
  const int chunk = blockIdx.x % p.chunks;
  const int rest = blockIdx.x / p.chunks;
  const int qb = rest % p.qblocks;
  const int b = rest / p.qblocks;
  const int q0 = qb * BQ;
  const int c0 = chunk * DCH;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, warp-uniform to the compiler (a __shfl_sync of
  // it): on a path ptxas takes for divergent, the register fences it
  // injects around wgmma serialize every wgmma of the kernel (C7520)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == 1) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != 128) return;
    F_T0();
    mbar_expect_tx(qbar, p.dtiles * Q_TILE);
    for (int kd = 0; kd < p.dtiles; ++kd)
      tma_load_3d(sq + kd * Q_TILE, &map_q, qbar, kd * KTB, q0, b);
    int kc = 0;
    for (int pass = 0; pass < 2; ++pass) {
      for (int t = 0; t < p.ktiles; ++t, ++kc) {
        const int s = kc % p.stages;
        F_T1(12);
        if (kc >= p.stages) mbar_wait(&empty[s], ((kc / p.stages) - 1) & 1);
        F_T1(11);
        uint8_t* st = ring + s * stage_bytes;
        mbar_expect_tx(&full[s], p.dtiles * K_TILE + (pass ? DCH * BKEY : 0));
        for (int kd = 0; kd < p.dtiles; ++kd)
          tma_load_3d(st + kd * K_TILE, &map_k, &full[s], kd * KTB, t * BKEY, b);
        if (pass) tma_load_3d(st + p.dtiles * K_TILE, &map_v, &full[s], t * BKEY, c0, b);
      }
    }
    F_T1(12);
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  int acc[64];
  int kc = 0;
  F_T0();
#if S2M2_F_TRACE
  const long long start_ = t0_;
  if (tid == 0) atomicAdd(&g_trace[10], 1ull);
#endif
  mbar_wait(qbar, 0);
  F_T1(1);

  // pass 1: each row's largest S over the real keys, two tiles a round
  // trip (both products in flight before the wait)
  int smax[2] = {INT_MIN, INT_MIN};
  float m[2];
  for (int t = 0; t < p.ktiles; t += 2, kc += 2) {
    const bool two = t + 1 < p.ktiles;
    const int s0 = kc % p.stages, s1 = (kc + 1) % p.stages;
    mbar_wait(&full[s0], (kc / p.stages) & 1);
    if (two) mbar_wait(&full[s1], ((kc + 1) / p.stages) & 1);
    F_T1(2);
    int acc1[64];  // with one tile left, the same tile again, unread
    wgmma_fence();
    scores(acc, sq, ring + s0 * stage_bytes, p.dtiles, p.DP);
    scores(acc1, sq, ring + (two ? s1 : s0) * stage_bytes, p.dtiles, p.DP);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(acc1);
    F_T1(3);
    mbar_arrive(&empty[s0]);
    row_max(acc, p.Nk - t * BKEY, t4, smax);
    if (two) {
      mbar_arrive(&empty[s1]);
      row_max(acc1, p.Nk - (t + 1) * BKEY, t4, smax);
    } else {
      kc -= 1;  // one tile this round
    }
    F_T1(4);
  }
  reduce_max(smax, p.c, m);

  // pass 2: e, l, p_q and O += P Vt
  int o[DCH / 2];
  int pa[16];  // P's A fragments: 4 registers a 32-key step
#pragma unroll
  for (int i = 0; i < DCH / 2; ++i) o[i] = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) pa[i] = 0;
  float l[2] = {0.f, 0.f};
  int prev = -1;
  for (int t = 0; t < p.ktiles; ++t, ++kc) {
    const int s = kc % p.stages;
    uint8_t* st = ring + s * stage_bytes;
    mbar_wait(&full[s], (kc / p.stages) & 1);
    F_T1(5);
    wgmma_fence();
    scores(acc, sq, st, p.dtiles, p.DP);
    wgmma_commit();
    wgmma_wait<0>();  // this tile's S and the previous tile's P Vt
    fence_regs(acc);
    fence_regs(o);
    fence_regs(pa);
    F_T1(6);
    if (prev >= 0) mbar_arrive(&empty[prev]);
    const int lim = p.Nk - t * BKEY;
    if (p.DP <= 256)
      tile_probabilities<true>(acc, lim, t4, p.c, m, l, pa);
    else
      tile_probabilities<false>(acc, lim, t4, p.c, m, l, pa);
    F_T1(7);
    const uint64_t dv = desc_sw128(st + p.dtiles * K_TILE);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      WgmmaRS<DCH>::mma(o, pa[4 * ks], pa[4 * ks + 1], pa[4 * ks + 2], pa[4 * ks + 3],
                        dv + 2 * ks, (t > 0 || ks > 0) ? 1 : 0);
    wgmma_commit();
    prev = s;
    F_T1(8);
  }
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(pa);
  if (prev >= 0) mbar_arrive(&empty[prev]);
  F_T1(6);
  reduce_sum(l);

  store_rows<T, DCH>(p.out, o, l, p.out_scale, b, q0, c0, p.Nq, p.D, warp, g, t4);
  F_T1(9);
#if S2M2_F_TRACE
  if (tid == 0) atomicAdd(&g_trace[0], clock64() - start_);
#endif
}

// 16 quantized bytes of row r, columns c .. c + 15, into a tile of rows of
// 128-byte k tiles (`tile` bytes each) in the 128-byte swizzle TMA writes
__device__ __forceinline__ void put16(uint8_t* base, int tile, int r, int c, const uint4& v) {
  const int j = (c & (KTB - 1)) >> 4;
  *reinterpret_cast<uint4*>(base + (c / KTB) * tile + r * KTB + ((j ^ (r & 7)) << 4)) = v;
}

struct FusedArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int Nq, Nk, D, DP, dtiles, qblocks, chunks;
  float inv_q, inv_k, inv_v, c, out_scale;
  bool vec;
};

// The one-tile route (Nk <= 128; `plan` route "fused"): one launch, no
// prologue and no workspace. A unit (64 queries of one sequence, one chunk
// of columns) quantizes its queries, the sequence's keys and its chunk of
// V with 16-byte loads straight into the swizzled shared layout TMA gives
// the other route (V transposed, each 16 keys in vt_pos order), then runs
// S, the row max, e, l, p_q and P Vt once.
template <typename T, int DCH>
__global__ void __launch_bounds__(128, 2) int8_attn_fused_kernel(const FusedArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sq = smem;
  uint8_t* sk = sq + p.dtiles * Q_TILE;
  uint8_t* sv = sk + p.dtiles * K_TILE;
  const int chunk = blockIdx.x % p.chunks;
  const int rest = blockIdx.x / p.chunks;
  const int qb = rest % p.qblocks;
  const int b = rest / p.qblocks;
  const int q0 = qb * BQ, c0 = chunk * DCH;
  const int tid = threadIdx.x;
  const T* q = static_cast<const T*>(p.q) + static_cast<long long>(b) * p.Nq * p.D;
  const T* k = static_cast<const T*>(p.k) + static_cast<long long>(b) * p.Nk * p.D;
  const T* v = static_cast<const T*>(p.v) + static_cast<long long>(b) * p.Nk * p.D;
  union Bytes16 {
    int8_t b[16];
    uint4 u;
  };
  const int groups = p.DP / 16;
  for (int i = tid; i < (BQ + BKEY) * groups; i += 128) {
    const int r = i / groups, c = (i - r * groups) * 16;
    Bytes16 x;
    x.u = make_uint4(0, 0, 0, 0);
    if (r < BQ) {
      if (q0 + r < p.Nq)
        quant16(q + static_cast<long long>(q0 + r) * p.D, c, p.D, p.inv_q, p.vec, x.b);
      put16(sq, Q_TILE, r, c, x.u);
    } else {
      if (r - BQ < p.Nk)
        quant16(k + static_cast<long long>(r - BQ) * p.D, c, p.D, p.inv_k, p.vec, x.b);
      put16(sk, K_TILE, r - BQ, c, x.u);
    }
  }
  for (int i = tid; i < BKEY * (DCH / 16); i += 128) {
    const int r = i / (DCH / 16), dd = (i - r * (DCH / 16)) * 16;
    Bytes16 x;
    x.u = make_uint4(0, 0, 0, 0);
    if (r < p.Nk) quant16(v + static_cast<long long>(r) * p.D, c0 + dd, p.D, p.inv_v, p.vec, x.b);
    const int pos = (r & ~15) + vt_pos(r & 15);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int row = dd + j;
      sv[row * KTB + ((((pos >> 4) ^ (row & 7)) << 4) | (pos & 15))] = x.b[j];
    }
  }
  fence_async_shared();  // the tiles, to wgmma's proxy
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  int acc[64];
  wgmma_fence();
  scores(acc, sq, sk, p.dtiles, p.DP);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  int smax[2] = {INT_MIN, INT_MIN};
  float m[2];
  row_max(acc, p.Nk, t4, smax);
  reduce_max(smax, p.c, m);
  float l[2] = {0.f, 0.f};
  int pa[16];
  if (p.DP <= 256)
    tile_probabilities<true>(acc, p.Nk, t4, p.c, m, l, pa);
  else
    tile_probabilities<false>(acc, p.Nk, t4, p.c, m, l, pa);
  int o[DCH / 2];
  const uint64_t dv = desc_sw128(sv);
  fence_regs(pa);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    WgmmaRS<DCH>::mma(o, pa[4 * ks], pa[4 * ks + 1], pa[4 * ks + 2], pa[4 * ks + 3],
                      dv + 2 * ks, ks > 0 ? 1 : 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(pa);
  reduce_sum(l);
  store_rows<T, DCH>(p.out, o, l, p.out_scale, b, q0, c0, p.Nq, p.D, warp, g, t4);
}

// ------------------------------------------------------------------ host

// An int8 (B, rows, cols) tensor with a row pitch of `pitch` bytes, read in
// boxes of 128 bytes x box_rows rows of one sequence into the 128-byte
// swizzle; past `cols` and `rows` zero-filled.
bool encode3d(CUtensorMap* map, const void* base, long long B, long long rows, long long cols,
              long long pitch, int box_rows) {
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(pitch),
                                 static_cast<cuuint64_t>(pitch * rows)};
  const cuuint32_t box[3] = {KTB, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of a workspace, encoded once: a map holds nothing but the
// address, shape, pitch and box, so equal keys give equal maps (the caching
// allocator hands a shape's workspace the same address call after call).
bool cached_map(CUtensorMap* map, const void* base, long long B, long long rows,
                long long cols, long long pitch, int box_rows) {
  using Key = std::tuple<const void*, long long, long long, long long, long long, int>;
  static std::mutex lock;
  static std::map<Key, CUtensorMap> cache;
  const Key key{base, B, rows, cols, pitch, box_rows};
  std::lock_guard<std::mutex> guard(lock);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  if (!encode3d(map, base, B, rows, cols, pitch, box_rows)) return false;
  if (cache.size() > 4096) cache.clear();
  cache.emplace(key, *map);
  return true;
}

long long align256(long long x) { return (x + 255) / 256 * 256; }

// The plan's geometry from the shape and its choice of stages, as
// ops/int8_attention.py `plan` computes it; false where it does not hold.
// One key tile takes the fused route: no stages, no workspace.
struct Geometry {
  int DP, NkP, dtiles, chunks, dch, qblocks, ktiles, units, smem;
  long long k_off, v_off, bytes;
  bool fused;
};

bool geometry(int B, int Nq, int Nk, int D, int stages, Geometry* g) {
  g->DP = (D + 31) / 32 * 32;
  g->NkP = (Nk + 15) / 16 * 16;
  g->dtiles = (g->DP + KTB - 1) / KTB;
  g->chunks = (g->DP + 127) / 128;
  g->dch = ((g->DP + g->chunks - 1) / g->chunks + 31) / 32 * 32;
  g->qblocks = (Nq + BQ - 1) / BQ;
  g->ktiles = (Nk + BKEY - 1) / BKEY;
  const long long units = static_cast<long long>(B) * g->qblocks * g->chunks;
  if (units > 0x7fffffffLL) return false;
  g->units = static_cast<int>(units);
  g->fused = g->ktiles == 1;
  if (g->fused) {
    g->smem = 1024 + g->dtiles * (Q_TILE + K_TILE) + g->dch * BKEY;
    g->k_off = g->v_off = g->bytes = 0;
    return stages == 0 && g->smem <= MAX_SMEM;
  }
  if (stages < 2 || stages > MAX_STAGES) return false;
  g->smem = 1024 + g->dtiles * Q_TILE + stages * (g->dtiles * K_TILE + g->dch * BKEY) +
            16 * (stages + 1);
  if (g->smem > MAX_SMEM) return false;
  g->k_off = align256(static_cast<long long>(B) * Nq * g->DP);
  g->v_off = g->k_off + align256(static_cast<long long>(B) * Nk * g->DP);
  g->bytes = g->v_off + align256(static_cast<long long>(B) * g->DP * g->NkP);
  return true;
}

// a kernel may take all of the SM's shared memory, and prefers the
// carveout that gives it all (two blocks an SM need 2 x ~110 KB)
template <typename K>
cudaError_t allow_smem(K kernel) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}
template <typename T, int DCH>
cudaError_t set_attributes() {
  static const cudaError_t err = allow_smem(int8_attn_kernel<T, DCH>);
  return err;
}
template <typename T, int DCH>
cudaError_t set_fused_attributes() {
  static const cudaError_t err = allow_smem(int8_attn_fused_kernel<T, DCH>);
  return err;
}

template <typename T, int DCH>
cudaError_t launch_fused(const FusedArgs& a, long long grid, int smem, cudaStream_t stream) {
  const cudaError_t attr = set_fused_attributes<T, DCH>();
  if (attr != cudaSuccess) return attr;
  int8_attn_fused_kernel<T, DCH><<<static_cast<unsigned>(grid), 128, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DCH>
cudaError_t launch_attn(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                        const AttnArgs& a, long long grid, int smem, cudaStream_t stream) {
  const cudaError_t attr = set_attributes<T, DCH>();
  if (attr != cudaSuccess) return attr;
  int8_attn_kernel<T, DCH>
      <<<static_cast<unsigned>(grid), THREADS, smem, stream>>>(mq, mk, mv, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, void* out, uint8_t* work, int B,
                int Nq, int Nk, int D, float inv_q, float inv_k, float inv_v, float c,
                float out_scale, int stages, const Geometry& g, cudaStream_t stream) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v);
  const bool vec = D % 8 == 0 && (any & 15) == 0;
  if (g.fused) {
    const FusedArgs a{q, k, v, out, Nq, Nk, D, g.DP, g.dtiles, g.qblocks, g.chunks,
                      inv_q, inv_k, inv_v, c, out_scale, vec};
#define S2M2_F_FUSED(DCH) \
  if (g.dch == DCH) return launch_fused<T, DCH>(a, g.units, g.smem, stream);
    S2M2_F_DCHS(S2M2_F_FUSED)
#undef S2M2_F_FUSED
    return cudaErrorInvalidValue;
  }
  QuantArgs qa;
  qa.q = q;
  qa.k = k;
  qa.v = v;
  qa.qi = reinterpret_cast<int8_t*>(work);
  qa.ki = reinterpret_cast<int8_t*>(work + g.k_off);
  qa.vt = reinterpret_cast<int8_t*>(work + g.v_off);
  qa.rows_q = static_cast<long long>(B) * Nq;
  qa.rows_k = static_cast<long long>(B) * Nk;
  qa.Nk = Nk;
  qa.D = D;
  qa.DP = g.DP;
  qa.NkP = g.NkP;
  qa.inv_q = inv_q;
  qa.inv_k = inv_k;
  qa.inv_v = inv_v;
  qa.row_blocks = ((qa.rows_q + qa.rows_k) * (g.DP / 16) + 255) / 256;
  qa.vkb = (Nk + 63) / 64;
  qa.vdb = (g.DP + 63) / 64;
  qa.vec = vec;
  const long long qblocks = qa.row_blocks + static_cast<long long>(B) * qa.vkb * qa.vdb;
  if (qblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  int8_attn_quantize_kernel<T><<<static_cast<unsigned>(qblocks), 256, 0, stream>>>(qa);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap mq, mk, mv;
  if (!cached_map(&mq, qa.qi, B, Nq, g.DP, g.DP, BQ) ||
      !cached_map(&mk, qa.ki, B, Nk, g.DP, g.DP, BKEY) ||
      !cached_map(&mv, qa.vt, B, g.DP, g.NkP, g.NkP, g.dch))
    return cudaErrorInvalidValue;
  AttnArgs a;
  a.out = out;
  a.Nq = Nq;
  a.Nk = Nk;
  a.D = D;
  a.DP = g.DP;
  a.dtiles = g.dtiles;
  a.ktiles = g.ktiles;
  a.qblocks = g.qblocks;
  a.chunks = g.chunks;
  a.stages = stages;
  a.c = c;
  a.out_scale = out_scale;
#define S2M2_F_CASE(DCH) \
  if (g.dch == DCH) return launch_attn<T, DCH>(mq, mk, mv, a, g.units, g.smem, stream);
  S2M2_F_DCHS(S2M2_F_CASE)
#undef S2M2_F_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, Nq, D), k and v (B, Nk, D), out (B, Nq, D), all contiguous, dtype 0
// float32 or 1 bf16. inv_*: float32(1 / s_*); c: float32(s_q s_k D^-1/2);
// out_scale: float32(s_v / 127). work: `work_bytes` of device memory from
// the wrapper (ops/int8_attention.py `plan`: the int8 Q, K and Vt; none on
// the fused route); stages: the plan's ring (0 on the fused route), refused
// where the geometry it gives does not hold or needs more workspace.
extern "C" int s2m2_int8_attention(const void* q, const void* k, const void* v, void* out,
                                   void* work, long long work_bytes, int B, int Nq, int Nk,
                                   int D, float inv_q, float inv_k, float inv_v, float c,
                                   float out_scale, int dtype, int stages, void* stream) {
  Geometry g;
  if (B < 1 || Nq < 1 || Nk < 1 || D < 1 || D > MAX_D ||
      !geometry(B, Nq, Nk, D, stages, &g) || g.bytes > work_bytes ||
      (g.bytes > 0 && (work == nullptr || (reinterpret_cast<uintptr_t>(work) & 255) != 0)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* w = static_cast<uint8_t*>(work);
  if (dtype == 0)
    return run<float>(q, k, v, out, w, B, Nq, Nk, D, inv_q, inv_k, inv_v, c, out_scale, stages,
                      g, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k, v, out, w, B, Nq, Nk, D, inv_q, inv_k, inv_v, c,
                              out_scale, stages, g, s);
  return cudaErrorInvalidValue;
}

namespace {
template <typename K>
int occupancy(K kernel, int threads, int smem, int* blocks) {
  const cudaError_t e = allow_smem(kernel);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
}
}  // namespace

// Blocks an SM holds at `smem` shared bytes of the attention kernel (fused
// 0) or the fused route's (fused 1), for dtype 0 float32 or 1 bf16 and
// chunk width dch (a measurement's query).
extern "C" int s2m2_int8_attention_occupancy(int dtype, int dch, int fused, int smem,
                                             int* blocks) {
#define S2M2_F_OCC(DCH)                                                                  \
  if (dch == DCH) {                                                                      \
    if (fused)                                                                           \
      return dtype == 0                                                                  \
                 ? occupancy(int8_attn_fused_kernel<float, DCH>, 128, smem, blocks)      \
                 : occupancy(int8_attn_fused_kernel<__nv_bfloat16, DCH>, 128, smem,      \
                             blocks);                                                    \
    return dtype == 0 ? occupancy(int8_attn_kernel<float, DCH>, THREADS, smem, blocks)   \
                      : occupancy(int8_attn_kernel<__nv_bfloat16, DCH>, THREADS, smem,   \
                                  blocks);                                               \
  }
  S2M2_F_DCHS(S2M2_F_OCC)
#undef S2M2_F_OCC
  return cudaErrorInvalidValue;
}

#if S2M2_F_TRACE
extern "C" int s2m2_int8_attention_trace(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
  if (err != cudaSuccess) return err;
  static const unsigned long long zero[16] = {};
  return cudaMemcpyToSymbol(g_trace, zero, sizeof(zero));
}
#endif

extern "C" const char* s2m2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
