// Int8 quantize -> int8 x int8 -> int32 tensor-core GEMM -> dequantize, for
// Hopper (sm_90a): kernel E.
//
// Replaces scripts/probe_pallas_int8.py: run (its _kernel_int8 and
// _kernel_bf16 bodies) and, with it, the body of every int8 site of
// s2m2_tpu/models/quant.py: _quantize_input, then the int8 conv or dot
// with int32 accumulation, then acc * (s_w[n] * s_x) + bias, cast to the
// input's dtype (conv2d_maybe_quantized, linear_maybe_quantized). One
// site is one pack and one GEMM launch:
//
//  - the pack reads the float activation (bf16 or float32) once and writes
//    q = clip(rint(x * inv), -127, 127), inv = float32(1 / s_x), rounding
//    half to even as jnp.round does, as
//      * token rows (M, Kp) (pack_rows_kernel), for linears;
//      * one NHWC int8 tensor (B, H, W, Cp) of an NCHW input
//        (pack_nhwc_kernel), for a convolution with C >= 32: the GEMM
//        gathers its A tiles from it (implicit GEMM), so no im2col rows
//        exist; a 1x1 stride-1 conv reads it as plain rows;
//      * explicit im2col rows (pack_im2col_kernel, columns in the (c, dy,
//        dx) order of an OIHW weight, 0 for padding taps), only for convs
//        with C < 32 (the stem's first convs), where a tap's channels are
//        less than one 32-byte k-step;
//    Kp and Cp are K and C rounded up to 32 with zero columns.
//  - gemm_kernel: C[m, n] = sum_k A[m, k] W[n, k] in int32 by wgmma
//    (m64nNk32.s32.s8.s8, both operands K-major in 128-byte-swizzled shared
//    memory, the only layout 8-bit wgmma takes), then the epilogue
//    out = cast(float(acc) * (s_w[n] * s_x) + bias[n]) with the scale
//    product taken first and no fused multiply-add, as the JAX package
//    rounds; or the raw int32 accumulators. Row-major (M, N) or NCHW output.
//    The same kernel on bf16 operands (m64nNk16.f32.bf16.bf16, float32
//    accumulation) is the probe's _kernel_bf16 body.
//
// What bounds it on the H100: a site's own work is its activation read once
// in its dtype, the int8 weight, the output written once, and 2 M N K
// operations at 1,979 TOP/s; most XL sites are bound by those bytes, the
// 3x3 convs at the 1/4 scale by the operations. What the design does about
// it:
//  - one warp-specialized block per SM, persistent over its output tiles:
//    a producer warpgroup fills a ring of 4-8 stages of 128-byte-deep k
//    tiles (mbarrier full/empty pairs) and runs on into the next tile while
//    one to three consumer warpgroups, each with a 64-row accumulator in
//    registers (setmaxnreg moves registers from the producer to them),
//    issue wgmma on the tiles as they land, one k tile of wgmma in flight,
//    then store the finished tile;
//  - row mode: A and W tiles arrive by TMA (cuTensorMapEncodeTiled, 128-byte
//    swizzle, out-of-bounds rows and k zero-filled); the weight's tensor map
//    is encoded once and cached, the activation's per launch;
//  - conv mode (implicit GEMM): the weight is (N, kh * kw * Cp) in (dy, dx,
//    c) order, by TMA, so each 128-byte k tile is 128 channels of one tap.
//    For a stride-1 conv with Cp % 128 == 0 (every wide conv of the model)
//    a block's rows are a (BM / 16) x 16 block of output pixels of one
//    image, and each k tile of A is one TMA box of a 4D map of the NHWC
//    int8 tensor at (c, wo0 + dx - pw, ho0 + dy - ph, b): TMA zero-fills
//    the taps outside the image, which is what quantizing the zero padding
//    gives, and the producer is one thread. Other convs (strides, Cp = 32
//    or 64) gather A's rows m = (b, ho, wo) with 16-byte cp.async written
//    straight into the swizzle, zero-filled the same way, each thread's
//    copies arriving on the stage's barrier as they land
//    (cp.async.mbarrier.arrive.noinc) and the consumers fencing the tile
//    into the async proxy before their wgmma reads it. The boxes take the
//    1/4-scale 3x3 convs 1.5x faster than the gather does on the H100, so
//    the gather serves only what a box cannot;
//  - the k loop stops at Kp (a multiple of 32): the last tile runs only its
//    live 32-byte k-steps;
//  - the N tile (32 to 256) and the warpgroups are chosen per site
//    (ops/int8_gemm.py `plan`, whose table `_build.py` writes into
//    int8_gemm_instances.h), so small-N sites stop running 128-wide tiles
//    of zeros; tile t is row panel t / (N tiles), so the blocks in flight
//    share row panels and A streams from device memory once;
//  - the epilogue takes s_w[n] * s_x and bias[n] from a table each
//    warpgroup fills in shared memory at the start of a tile, and each warp
//    stages its 16 rows there in chunks of 128-byte rows, so that its
//    stores are 16-byte runs along n (row-major) or along 8 pixels of a
//    channel (NCHW).
// The quantize fused into the producers' epilogues is the next step
// (ROADMAP.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "hopper.cuh"  // mbarrier, TMA, wgmma and cp.async helpers; encoder()

namespace {

// ------------------------------------------------------------------ pack

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int8_t quant(float v, float inv) {
  const float r = rintf(__fmul_rn(v, inv));  // half to even, as jnp.round
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.f), 127.f)));
}

union Pack16 {
  int8_t b[16];
  uint4 u;
};

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

// Token rows: row m of x starts at (m / inner) * outer + (m % inner) * ld,
// which covers a contiguous (M, K) matrix (inner = M) and one head of a
// (B, heads, N, d) tensor (inner = N, ld = d, outer = heads * N * d). Each
// thread writes 16 columns of one row as one 16-byte store; it reads them
// as 16-byte loads where the row allows (vec: K, ld and outer multiples of
// 8 and x 16-byte aligned), else value by value.
template <typename T>
__global__ void pack_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                                 long long M, int K, int Kp, long long inner,
                                 long long ld, long long outer, float inv, bool vec) {
  const int groups = Kp / 16;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= M * groups) return;
  const long long m = i / groups;
  const int k0 = static_cast<int>(i % groups) * 16;
  const T* src = x + (m / inner) * outer + (m % inner) * ld;
  Pack16 pk;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kb = k0 + 8 * h;
    if (vec && kb + 8 <= K) {
      float v[8];
      load8(src + kb, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) pk.b[8 * h + j] = quant(v[j], inv);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        pk.b[8 * h + j] = kb + j < K ? quant(to_f(src[kb + j]), inv) : int8_t(0);
    }
  }
  *reinterpret_cast<uint4*>(q + m * Kp + k0) = pk.u;
}

// NCHW (B, C, H, W) -> NHWC int8 (B, H, W, Cp), channels C..Cp zero: 64
// pixels x 64 channels per block, staged in shared memory. The reads run
// along pixels (8 a thread, one 16-byte load in bf16 where HW % 8 == 0),
// the writes along channels (16 a thread, one 16-byte store).
constexpr int NHWC_P = 64;
constexpr int NHWC_C = 64;

template <typename T>
__global__ void __launch_bounds__(256)
    pack_nhwc_kernel(const T* __restrict__ x, int8_t* __restrict__ q, int C, long long HW,
                     int Cp, float inv) {
  __shared__ __align__(16) int8_t tile[NHWC_P][NHWC_C + 16];
  const long long p0 = static_cast<long long>(blockIdx.x) * NHWC_P;
  const int c0 = blockIdx.y * NHWC_C;
  const long long b = blockIdx.z;
  const bool vec = HW % 8 == 0;
  for (int u = threadIdx.x; u < NHWC_C * (NHWC_P / 8); u += 256) {
    const int cl = u / (NHWC_P / 8);
    const int pg = (u % (NHWC_P / 8)) * 8;
    const int c = c0 + cl;
    const long long p = p0 + pg;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    bool live[8] = {false, false, false, false, false, false, false, false};
    if (c < C) {
      const T* src = x + (b * C + c) * HW + p;
      if (vec && p + 8 <= HW) {
        load8(src, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) live[j] = true;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (p + j < HW) {
            v[j] = to_f(src[j]);
            live[j] = true;
          }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) tile[pg + j][cl] = live[j] ? quant(v[j], inv) : int8_t(0);
  }
  __syncthreads();
  for (int u = threadIdx.x; u < NHWC_P * (NHWC_C / 16); u += 256) {
    const int pl = u / (NHWC_C / 16);
    const int cg = (u % (NHWC_C / 16)) * 16;
    const long long p = p0 + pl;
    if (p < HW && c0 + cg < Cp)
      *reinterpret_cast<uint4*>(q + (b * HW + p) * Cp + c0 + cg) =
          *reinterpret_cast<const uint4*>(&tile[pl][cg]);
  }
}

// im2col rows m_begin .. m_begin + rows of an NCHW input, in 64 x 64 tiles
// staged in shared memory: each thread quantizes 16 columns of one row
// (rows fastest across the warp, so neighbouring threads read neighbouring
// pixels of one channel), then four threads write each row's 64 bytes as
// 16-byte stores (whole sectors).
constexpr int PACK_M = 64;
constexpr int PACK_K = 64;
constexpr int PACK_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(PACK_THREADS)
    pack_im2col_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                       long long m_begin, long long rows, int C, int H, int W, int Ho,
                       int Wo, int kh, int kw, int sh, int sw, int ph, int pw, int K,
                       int Kp, float inv) {
  __shared__ __align__(16) int8_t tile[PACK_M][PACK_K + 16];
  const long long r0 = static_cast<long long>(blockIdx.x) * PACK_M;
  const int k0 = blockIdx.y * PACK_K;
  const int tid = threadIdx.x;
  {
    const int rl = tid % PACK_M;
    const int kg = (tid / PACK_M) * 16;
    const long long r = r0 + rl;
    Pack16 pk;
    pk.u = make_uint4(0, 0, 0, 0);
    if (r < rows) {
      const long long m = m_begin + r;
      const int wo = static_cast<int>(m % Wo);
      const long long t = m / Wo;
      const int ho = static_cast<int>(t % Ho);
      const long long b = t / Ho;
      const int taps = kh * kw;
      int k = k0 + kg;
      int c = k / taps;  // walk (c, dy, dx) with one division per thread
      int rem = k - c * taps;
      int dy = rem / kw;
      int dx = rem - dy * kw;
      const T* plane = x + (b * C + c) * static_cast<long long>(H) * W;
#pragma unroll
      for (int j = 0; j < 16; ++j, ++k) {
        if (k < K) {
          const int y = ho * sh - ph + dy;
          const int xx = wo * sw - pw + dx;
          if (y >= 0 && y < H && xx >= 0 && xx < W)
            pk.b[j] = quant(to_f(plane[static_cast<long long>(y) * W + xx]), inv);
        }
        if (++dx == kw) {
          dx = 0;
          if (++dy == kh) {
            dy = 0;
            plane += static_cast<long long>(H) * W;
          }
        }
      }
    }
    *reinterpret_cast<uint4*>(&tile[rl][kg]) = pk.u;
  }
  __syncthreads();
  const int rl = tid / 4;
  const int c16 = (tid % 4) * 16;
  const long long r = r0 + rl;
  if (r < rows && k0 + c16 < Kp)
    *reinterpret_cast<uint4*>(q + r * Kp + k0 + c16) =
        *reinterpret_cast<const uint4*>(&tile[rl][c16]);
}

}  // namespace

// The instance table of ops/int8_gemm.py (`_INSTANCES`) and the wgmma
// wrappers of its N tiles, written into the build directory by _build.py.
#include "int8_gemm_instances.h"

namespace {

// ------------------------------------------------------------------ GEMM
constexpr int BKB = 128;  // k tile in bytes: one 128-byte swizzle row
constexpr int KSTEP = 32;  // bytes of k per wgmma

// S k-steps of 32 bytes: the descriptors advance 32 bytes (2 units of 16)
// inside the 128-byte swizzle atom
// (keep 0: the first step overwrites the accumulators, so no instruction
// but wgmma ever writes them)
template <typename In, int BN, int S, typename Acc>
__device__ __forceinline__ void k_steps(Acc (&acc)[BN / 2], uint64_t da, uint64_t db,
                                        int keep) {
#pragma unroll
  for (int ks = 0; ks < S; ++ks)
    Wgmma<In, BN>::mma(acc, da + 2 * ks, db + 2 * ks, ks > 0 ? 1 : keep);
}

struct GemmArgs {
  long long M;  // output rows
  int N;
  int Kb;  // reduction depth in bytes, a multiple of 32
  const float* w_scale;
  float s_x;
  const float* bias;
  void* out;
  int out_kind;    // 0 float32, 1 bfloat16, 2 the raw int32 accumulators
  long long ldc;   // row-major output: row stride in elements
  long long hw;    // > 0: NCHW output, row m_base + m = b * hw + p
  long long m_base;
  // conv mode, on x, an NHWC int8 (B, H, W, Cp): conv 1 gathers A's rows
  // m = (b, ho, wo) with cp.async; conv 2 (stride 1, Cp % 128 == 0) loads
  // each tap of a (BM / 16) x 16 block of output pixels by one TMA box of
  // tma_a, a 4D map of x; tiles_w / tiles_h: such blocks across Wo and Ho
  int conv;
  const int8_t* x;
  int H, W, Cp, Ho, Wo, kw, sh, sw, ph, pw;
  int tiles_w, tiles_h;
};

template <typename In>
struct AccOf {
  using type = int;
};
template <>
struct AccOf<__nv_bfloat16> {
  using type = float;
};

__device__ __forceinline__ float acc_f(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float acc_f(float v) { return v; }
__device__ __forceinline__ int acc_raw(int v) { return v; }
__device__ __forceinline__ int acc_raw(float) { return 0; }

constexpr int STG_PITCH = 144;           // staging row: 128 bytes + 16 of pad
constexpr int STG_BYTES = 16 * STG_PITCH;  // one warp's 16 rows

template <int BM, int BN, int STAGES>
struct Smem {
  static constexpr int A_BYTES = BM * BKB;
  static constexpr int B_BYTES = BN * BKB;
  static constexpr int RING = STAGES * (A_BYTES + B_BYTES);
  static constexpr int STAGING = (BM / 16) * STG_BYTES;
  static constexpr int TABLES = (BM / 64) * 2 * BN * 4;
  static constexpr int BYTES = 1024 + RING + 16 * STAGES + STAGING + TABLES;
  static_assert(BYTES <= 232448, "shared memory");
};

// One element of the output tile, dequantized (scale = s_w[n] * s_x, taken
// first, no fused multiply-add) and written to `d` as the output dtype.
template <typename Acc>
__device__ __forceinline__ void put(uint8_t* d, Acc a, float scale, float bias, int kind,
                                   bool scaled, bool biased) {
  float v = acc_f(a);
  if (scaled) v = __fmul_rn(v, scale);
  if (biased) v = __fadd_rn(v, bias);
  if (kind == 1)
    *reinterpret_cast<__nv_bfloat16*>(d) = __float2bfloat16_rn(v);
  else if (kind == 0)
    *reinterpret_cast<float*>(d) = v;
  else
    *reinterpret_cast<int*>(d) = acc_raw(a);
}

__device__ __forceinline__ void copy_elem(uint8_t* d, const uint8_t* s, int es) {
  if (es == 2)
    *reinterpret_cast<uint16_t*>(d) = *reinterpret_cast<const uint16_t*>(s);
  else
    *reinterpret_cast<uint32_t*>(d) = *reinterpret_cast<const uint32_t*>(s);
}

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// Output tile t of a block: its row panel (m0: the first linear output row,
// or for conv mode 2 the image b and the corner (ho0, wo0) of its block of
// pixels) and its first column n0.
struct Tile {
  long long m0;
  int b, ho0, wo0, n0;
};
template <int BM, int BN>
__device__ __forceinline__ Tile tile_of(const GemmArgs& p, long long t, int ntn) {
  Tile r;
  r.n0 = static_cast<int>(t % ntn) * BN;
  const long long panel = t / ntn;
  if (p.conv == 2) {
    const long long per_image = static_cast<long long>(p.tiles_h) * p.tiles_w;
    r.b = static_cast<int>(panel / per_image);
    const int rem = static_cast<int>(panel - r.b * per_image);
    r.ho0 = rem / p.tiles_w * (BM / 16);
    r.wo0 = rem % p.tiles_w * 16;
    r.m0 = 0;
  } else {
    r.m0 = panel * BM;
    r.b = r.ho0 = r.wo0 = 0;
  }
  return r;
}

// The linear output row (b, ho, wo) of row r of tile `tl`, or -1 where the
// row lies outside the output.
template <int BM>
__device__ __forceinline__ long long row_of(const GemmArgs& p, const Tile& tl, int r) {
  if (p.conv == 2) {
    const int ho = tl.ho0 + r / 16;
    const int wo = tl.wo0 + r % 16;
    if (ho >= p.Ho || wo >= p.Wo) return -1;
    return (static_cast<long long>(tl.b) * p.Ho + ho) * p.Wo + wo;
  }
  const long long gm = tl.m0 + r;
  return gm < p.M ? gm : -1;
}

// A persistent grid: block b takes output tiles b, b + gridDim.x, ... of
// (BM = 64 * WGS) x BN, tile t at row panel t / (N tiles) and column tile
// t % (N tiles), so the blocks in flight share row panels and A streams
// from device memory once. Warpgroups 0 .. WGS - 1 consume, warpgroup WGS
// produces; the producer runs ahead into the next tile's k tiles while the
// consumers store a tile's outputs straight from their registers.
template <typename In, int BN, int WGS, int STAGES>
__global__ void __launch_bounds__(128 * (WGS + 1), 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
                const __grid_constant__ CUtensorMap tma_b, const GemmArgs p) {
  using Acc = typename AccOf<In>::type;
  constexpr int BM = 64 * WGS;
  using S = Smem<BM, BN, STAGES>;
  constexpr int KE = BKB / sizeof(In);  // k tile in elements (TMA coordinates)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sa = smem;
  uint8_t* sb = smem + STAGES * S::A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::RING);
  uint64_t* empty = full + STAGES;
  uint8_t* staging = smem + S::RING + 16 * STAGES;
  float* tables = reinterpret_cast<float*>(staging + S::STAGING);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int ntn = (p.N + BN - 1) / BN;
  const long long panels =
      p.conv == 2 ? p.M / (static_cast<long long>(p.Ho) * p.Wo) * p.tiles_h * p.tiles_w
                  : (p.M + BM - 1) / BM;
  const long long ntiles = panels * ntn;
  const int nk = (p.Kb + BKB - 1) / BKB;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], p.conv == 1 ? 129 : 1);  // gather: 128 threads + expect_tx
      mbar_init(&empty[s], 128 * WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == WGS) {
    // ---------------------------------------------------------- producer
    if constexpr (WGS >= 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int t = tid - 128 * WGS;
    int kc = 0;  // k tiles issued by this block, over all its tiles
    if (p.conv != 1) {
      if (t == 0) {
        for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
          const Tile tl = tile_of<BM, BN>(p, tile, ntn);
          for (int kt = 0; kt < nk; ++kt, ++kc) {
            const int s = kc % STAGES;
            if (kc >= STAGES) mbar_wait(&empty[s], ((kc / STAGES) - 1) & 1);
            mbar_expect_tx(&full[s], S::A_BYTES + S::B_BYTES);
            if (p.conv == 2) {  // tap (dy, dx), channels c .. c + 127 of the pixel block
              const int kb = kt * BKB;
              const int tap = kb / p.Cp;
              const int dy = tap / p.kw;
              const int dx = tap - dy * p.kw;
              tma_load_4d(sa + s * S::A_BYTES, &tma_a, &full[s], kb - tap * p.Cp,
                          tl.wo0 + dx - p.pw, tl.ho0 + dy - p.ph, tl.b);
            } else {
              tma_load_2d(sa + s * S::A_BYTES, &tma_a, &full[s], kt * KE,
                          static_cast<int>(tl.m0));
            }
            tma_load_2d(sb + s * S::B_BYTES, &tma_b, &full[s], kt * KE, tl.n0);
          }
        }
      }
    } else {
      // thread t gathers 16-byte chunk j of rows r0, r0 + 16, ...
      constexpr int RPT = BM / 16;
      const int j = t & 7;
      const int r0 = t >> 3;
      for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const long long m0 = tile / ntn * BM;
        const int n0 = static_cast<int>(tile % ntn) * BN;
        int y0[RPT], x0[RPT], by0[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const long long m = m0 + r0 + 16 * i;
          if (m < p.M) {
            const int wo = static_cast<int>(m % p.Wo);
            const long long t2 = m / p.Wo;
            const int ho = static_cast<int>(t2 % p.Ho);
            const int b = static_cast<int>(t2 / p.Ho);
            y0[i] = ho * p.sh - p.ph;
            x0[i] = wo * p.sw - p.pw;
            by0[i] = b * p.H + y0[i];
          } else {
            y0[i] = -(1 << 28);  // every tap out of bounds: zero fill
            x0[i] = 0;
            by0[i] = 0;
          }
        }
        for (int kt = 0; kt < nk; ++kt, ++kc) {
          const int s = kc % STAGES;
          if (kc >= STAGES) mbar_wait(&empty[s], ((kc / STAGES) - 1) & 1);
          if (t == 0) {
            mbar_expect_tx(&full[s], S::B_BYTES);
            tma_load_2d(sb + s * S::B_BYTES, &tma_b, &full[s], kt * KE, n0);
          }
          const int kb = kt * BKB + j * 16;
          if (kb < p.Kb) {
            const int tap = kb / p.Cp;
            const int c = kb - tap * p.Cp;
            const int dy = tap / p.kw;
            const int dx = tap - dy * p.kw;
            uint8_t* dst = sa + s * S::A_BYTES;
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              const int r = r0 + 16 * i;
              const int y = y0[i] + dy;
              const int xx = x0[i] + dx;
              const bool ok = y >= 0 && y < p.H && xx >= 0 && xx < p.W;
              const int8_t* src =
                  ok ? p.x + ((static_cast<long long>(by0[i] + dy) * p.W + xx) * p.Cp + c)
                     : p.x;
              cp_async16(dst + r * BKB + ((j ^ (r & 7)) << 4), src, ok);
            }
          }
          // the stage's barrier counts this thread's arrival when its copies
          // have landed; the thread goes on to the next k tile at once
          cp_async_arrive_noinc(&full[s]);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    // what the producer gave up, shared by the consumers (multiples of 8)
    if constexpr (WGS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    if constexpr (WGS == 3) asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n");
    const int lt = tid & 127;
    const int lane = lt & 31;
    const bool nchw = p.hw > 0;
    const int es = p.out_kind == 1 ? 2 : 4;
    const int warp = lt >> 5;  // this warp's 16 rows: wg * 64 + warp * 16 ..
    uint8_t* stg = staging + (wg * 4 + warp) * STG_BYTES;  // this warp's 16 rows
    float* t_scale = tables + wg * 2 * BN;  // this warpgroup's s_w[n] * s_x, bias[n]
    float* t_bias = t_scale + BN;
    const bool scaled = p.w_scale != nullptr;
    const bool biased = p.bias != nullptr;
    // a chunk of columns whose rows are at most 128 bytes: 64 bf16 or 32
    // four-byte outputs (BN itself when narrower)
    const int cw = min(128 / es, BN);
    const int row_bytes = cw * es;
    uint8_t* out = static_cast<uint8_t*>(p.out);
    const bool vec_rows = !nchw && (reinterpret_cast<uintptr_t>(out) & 15) == 0 &&
                          (p.ldc * es) % 16 == 0;
    const bool vec_nchw = nchw && (reinterpret_cast<uintptr_t>(out) & 15) == 0 &&
                          p.hw % 8 == 0;
    Acc acc[BN / 2];
    int kc = 0;
    for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const Tile tl = tile_of<BM, BN>(p, tile, ntn);
      const int n0 = tl.n0;
      wg_sync(wg);  // the previous tile's epilogue is done with the table
      for (int i = lt; i < BN; i += 128) {
        const int n = n0 + i;
        t_scale[i] = scaled && n < p.N ? __fmul_rn(p.w_scale[n], p.s_x) : 1.f;
        t_bias[i] = biased && n < p.N ? p.bias[n] : 0.f;
      }
      for (int kt = 0; kt < nk; ++kt, ++kc) {
        const int s = kc % STAGES;
        mbar_wait(&full[s], (kc / STAGES) & 1);
        if (p.conv == 1) fence_async_shared();  // the gathered tile, to wgmma's proxy
        const uint64_t da = desc_sw128(sa + s * S::A_BYTES + wg * 64 * BKB);
        const uint64_t db = desc_sw128(sb + s * S::B_BYTES);
        const int steps = min(BKB, p.Kb - kt * BKB) / KSTEP;
        const int keep = kt > 0;  // the tile's first product overwrites the sums
        wgmma_fence();
        if (steps == 4) {  // a whole k tile; the last one may stop short
          k_steps<In, BN, 4>(acc, da, db, keep);
        } else if (steps == 3) {
          k_steps<In, BN, 3>(acc, da, db, keep);
        } else if (steps == 2) {
          k_steps<In, BN, 2>(acc, da, db, keep);
        } else {
          k_steps<In, BN, 1>(acc, da, db, keep);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous k tile's products are done: release it
        if (kt > 0) mbar_arrive(&empty[(kc - 1) % STAGES]);
      }
      wgmma_wait<0>();
      mbar_arrive(&empty[(kc - 1) % STAGES]);
      fence_regs(acc);

      wg_sync(wg);  // the table is written

      // epilogue: each warp stages its 16 rows through shared memory, a
      // chunk of cw columns at a time, then stores them as 16-byte runs
      // along n (row-major) or along pixels (NCHW)
      const int rw = wg * 64 + warp * 16;  // the warp's first row in the tile
      for (int c0 = 0; c0 < BN && n0 + c0 < p.N; c0 += cw) {
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn) {
          if (jn * 8 < c0 || jn * 8 >= c0 + cw) continue;
          const int cl = jn * 8 - c0 + (lane & 3) * 2;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint8_t* d = stg + ((lane >> 2) + 8 * h) * STG_PITCH + cl * es;
#pragma unroll
            for (int e = 0; e < 2; ++e)
              put(d + e * es, acc[jn * 4 + h * 2 + e], t_scale[c0 + cl + e],
                  t_bias[c0 + cl + e], p.out_kind, scaled, biased);
          }
        }
        __syncwarp();
        if (!nchw) {
          const int pieces = row_bytes / 16;
          const int per = 16 / es;
          for (int i = lane; i < 16 * pieces; i += 32) {
            const int rl = i / pieces;
            const int nl = (i - rl * pieces) * per;
            const long long gm = row_of<BM>(p, tl, rw + rl);
            const int n = n0 + c0 + nl;
            if (gm < 0 || n >= p.N) continue;
            const uint8_t* src = stg + rl * STG_PITCH + nl * es;
            uint8_t* dst = out + (gm * p.ldc + n) * es;
            if (vec_rows && n + per <= p.N) {
              *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
            } else {
              for (int e = 0; e < per && n + e < p.N; ++e)
                copy_elem(dst + e * es, src + e * es, es);
            }
          }
        } else {
          // lane pair (2 cl, 2 cl + 1) writes channel cl's 16 pixels, 8 each:
          // rows h8 .. h8 + 7, image b8, first pixel p8, as one 16-byte store
          // where they are one aligned run of one image (32-bit arithmetic:
          // the entry points keep NCHW rows below 2^31)
          for (int i = lane; i < 2 * cw; i += 32) {
            const int cl = i >> 1;
            const int h8 = (i & 1) * 8;
            const int n = n0 + c0 + cl;
            if (n >= p.N) continue;
            const uint8_t* src = stg + h8 * STG_PITCH + cl * es;
            const long long g0 = row_of<BM>(p, tl, rw + h8);
            const unsigned r0 = static_cast<unsigned>(p.m_base + (g0 < 0 ? 0 : g0));
            const unsigned hw = static_cast<unsigned>(p.hw);
            const unsigned b8 = r0 / hw;
            const unsigned p8 = r0 - b8 * hw;
            if (vec_nchw && g0 >= 0 && row_of<BM>(p, tl, rw + h8 + 7) == g0 + 7 &&
                p8 % 8 == 0 && p8 + 8 <= hw) {
              uint32_t w[8];
#pragma unroll
              for (int e = 0; e < 8; ++e)
                w[e] = es == 2 ? *reinterpret_cast<const uint16_t*>(src + e * STG_PITCH)
                               : *reinterpret_cast<const uint32_t*>(src + e * STG_PITCH);
              uint8_t* dst = out + ((static_cast<long long>(b8) * p.N + n) * p.hw + p8) * es;
              if (es == 2) {
                *reinterpret_cast<uint4*>(dst) =
                    make_uint4(w[0] | (w[1] << 16), w[2] | (w[3] << 16), w[4] | (w[5] << 16),
                               w[6] | (w[7] << 16));
              } else {
                *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
                *reinterpret_cast<uint4*>(dst + 16) = make_uint4(w[4], w[5], w[6], w[7]);
              }
            } else {
              for (int e = 0; e < 8; ++e) {
                const long long g = row_of<BM>(p, tl, rw + h8 + e);
                if (g < 0) continue;
                const long long r = p.m_base + g;
                const long long b = r / p.hw;
                copy_elem(out + ((b * p.N + n) * p.hw + (r - b * p.hw)) * es,
                          src + e * STG_PITCH, es);
              }
            }
          }
        }
        __syncwarp();
      }
    }
  }
}

// ------------------------------------------------------------------ host

// A (rows, cols) matrix with a row stride in bytes, read in boxes of
// (box_rows, 128 bytes) into the 128-byte swizzle; out-of-bounds zero.
bool encode(CUtensorMap* map, const void* base, bool bf16, long long rows, long long cols,
            long long stride, int box_rows) {
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(bf16 ? BKB / 2 : BKB),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
            const_cast<void*>(base), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// An NHWC int8 (B, H, W, Cp) read in boxes of 128 channels x 16 pixels x
// box_h rows of one image, into the 128-byte swizzle; taps outside the
// image (negative or past the edge) are zero-filled.
bool encode_taps(CUtensorMap* map, const void* x, int B, int H, int W, int Cp, int box_h) {
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Cp), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(Cp),
                                 static_cast<cuuint64_t>(Cp) * W,
                                 static_cast<cuuint64_t>(Cp) * W * H};
  const cuuint32_t box[4] = {BKB, 16, static_cast<cuuint32_t>(box_h), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The weights' tensor maps, encoded once: a map holds nothing but the
// address, shape, stride and box, so equal keys give equal maps.
bool weight_map(CUtensorMap* map, const void* w, bool bf16, long long rows, long long cols,
                long long stride, int box_rows) {
  using Key = std::tuple<const void*, bool, long long, long long, long long, int>;
  static std::mutex lock;
  static std::map<Key, CUtensorMap> cache;
  const Key key{w, bf16, rows, cols, stride, box_rows};
  std::lock_guard<std::mutex> guard(lock);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  if (!encode(map, w, bf16, rows, cols, stride, box_rows)) return false;
  if (cache.size() > 8192) cache.clear();
  cache.emplace(key, *map);
  return true;
}

template <typename In, int BN, int WGS, int STAGES>
cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mb, const GemmArgs& p,
                   cudaStream_t stream) {
  constexpr int BM = 64 * WGS;
  constexpr int bytes = Smem<BM, BN, STAGES>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_kernel<In, BN, WGS, STAGES>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 132;
  }();
  const long long panels =
      p.conv == 2 ? p.M / (static_cast<long long>(p.Ho) * p.Wo) * p.tiles_h * p.tiles_w
                  : (p.M + BM - 1) / BM;
  const long long tiles = panels * ((p.N + BN - 1) / BN);
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  gemm_kernel<In, BN, WGS, STAGES><<<grid, 128 * (WGS + 1), bytes, stream>>>(ma, mb, p);
  return cudaGetLastError();
}

// op 0: int8 operands, 1: bf16. The instance must be one of the table's.
cudaError_t dispatch(int op, int bn, int wgs, int stages, const CUtensorMap& ma,
                     const CUtensorMap& mb, const GemmArgs& p, cudaStream_t stream) {
#define S2M2_GEMM_CASE(OP, BN, WGS, STAGES)                                         \
  if (op == OP && bn == BN && wgs == WGS && stages == STAGES)                       \
    return launch<std::conditional_t<OP == 0, int8_t, __nv_bfloat16>, BN, WGS, STAGES>( \
        ma, mb, p, stream);
  S2M2_GEMM_INSTANCES(S2M2_GEMM_CASE)
#undef S2M2_GEMM_CASE
  return cudaErrorInvalidValue;  // a plan this build was not compiled for
}

template <typename T>
cudaError_t launch_rows(const void* x, void* q, long long M, int K, int Kp,
                        long long inner, long long ld, long long outer, float inv,
                        cudaStream_t stream) {
  const long long n = M * (Kp / 16);
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  const bool vec = K % 8 == 0 && ld % 8 == 0 && outer % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  pack_rows_kernel<T><<<blocks, 256, 0, stream>>>(static_cast<const T*>(x),
                                                  static_cast<int8_t*>(q), M, K, Kp,
                                                  inner, ld, outer, inv, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_nhwc(const void* x, void* q, int B, int C, long long HW, int Cp, float inv,
                        cudaStream_t stream) {
  const long long pt = (HW + NHWC_P - 1) / NHWC_P;
  if (pt > 0x7fffffffLL || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(pt), (Cp + NHWC_C - 1) / NHWC_C, B);
  pack_nhwc_kernel<T><<<grid, 256, 0, stream>>>(static_cast<const T*>(x),
                                                static_cast<int8_t*>(q), C, HW, Cp, inv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_im2col(const void* x, void* q, long long m_begin, long long rows,
                          int C, int H, int W, int Ho, int Wo, int kh, int kw, int sh,
                          int sw, int ph, int pw, int K, int Kp, float inv,
                          cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((rows + PACK_M - 1) / PACK_M),
                  (Kp + PACK_K - 1) / PACK_K);
  pack_im2col_kernel<T><<<grid, PACK_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), m_begin, rows, C, H, W, Ho,
      Wo, kh, kw, sh, sw, ph, pw, K, Kp, inv);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

GemmArgs epilogue_args(long long M, int N, int Kb, const void* w_scale, float s_x,
                       const void* bias, void* out, long long ldc, long long hw,
                       long long m_base, int out_kind) {
  GemmArgs p;
  std::memset(&p, 0, sizeof(p));
  p.M = M;
  p.N = N;
  p.Kb = Kb;
  p.w_scale = static_cast<const float*>(w_scale);
  p.s_x = s_x;
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.out_kind = out_kind;
  p.ldc = ldc;
  p.hw = hw;
  p.m_base = m_base;
  return p;
}

}  // namespace

// Token rows of x (dtype 0 float32, 1 bfloat16) -> q (M, Kp) int8.
extern "C" int s2m2_quantize_rows(const void* x, void* q, long long M, int K, int Kp,
                                  long long inner, long long ld, long long outer,
                                  float inv, int dtype, void* stream) {
  if (M < 1 || K < 1 || Kp < K || Kp % 32 != 0 || inner < 1 || !aligned16(q))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_rows<float>(x, q, M, K, Kp, inner, ld, outer, inv, s);
  if (dtype == 1)
    return launch_rows<__nv_bfloat16>(x, q, M, K, Kp, inner, ld, outer, inv, s);
  return cudaErrorInvalidValue;
}

// An NCHW x (B, C, H, W) -> q (B, H, W, Cp) int8, channels C .. Cp zero.
extern "C" int s2m2_quantize_nhwc(const void* x, void* q, int B, int C, long long HW, int Cp,
                                  float inv, int dtype, void* stream) {
  if (B < 1 || C < 1 || HW < 1 || Cp < C || Cp % 32 != 0 || !aligned16(q))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_nhwc<float>(x, q, B, C, HW, Cp, inv, s);
  if (dtype == 1) return launch_nhwc<__nv_bfloat16>(x, q, B, C, HW, Cp, inv, s);
  return cudaErrorInvalidValue;
}

// im2col rows m_begin .. m_begin + rows of an NCHW x (B, C, H, W) -> q (rows, Kp).
extern "C" int s2m2_quantize_im2col(const void* x, void* q, long long m_begin,
                                    long long rows, int C, int H, int W, int Ho, int Wo,
                                    int kh, int kw, int sh, int sw, int ph, int pw,
                                    int Kp, float inv, int dtype, void* stream) {
  const int K = C * kh * kw;
  if (rows < 1 || K < 1 || Kp < K || Kp % 32 != 0 || Ho < 1 || Wo < 1 || sh < 1 ||
      sw < 1 || !aligned16(q))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_im2col<float>(x, q, m_begin, rows, C, H, W, Ho, Wo, kh, kw, sh, sw, ph,
                                pw, K, Kp, inv, s);
  if (dtype == 1)
    return launch_im2col<__nv_bfloat16>(x, q, m_begin, rows, C, H, W, Ho, Wo, kh, kw, sh,
                                        sw, ph, pw, K, Kp, inv, s);
  return cudaErrorInvalidValue;
}

// Row mode. a (M, K) and w (N, K), both int8 (op 0) or bf16 (op 1), row
// strides lda, ldb in bytes (multiples of 16), K * element size = Kb, a
// multiple of 32 bytes. w_scale (N,) float32 or null (then no scaling),
// bias (N,) float32 or null. out_kind 0 float32, 1 bfloat16, 2 the raw
// int32 accumulators (int8 only). hw > 0: out is NCHW and rows are
// m_base + m. (bn, wgs, stages): the instance, from the wrapper's plan.
extern "C" int s2m2_gemm(const void* a, long long lda, const void* w, long long ldb,
                         long long M, int N, int Kb, int op, const void* w_scale, float s_x,
                         const void* bias, void* out, long long ldc, long long hw,
                         long long m_base, int out_kind, int bn, int wgs, int stages,
                         void* stream) {
  const int es = op == 1 ? 2 : 1;
  if (hw > 0 && m_base + M >= (1LL << 31)) return cudaErrorInvalidValue;
  if (M < 1 || N < 1 || Kb < 32 || Kb % 32 != 0 || lda % 16 != 0 || ldb % 16 != 0 ||
      !aligned16(a) || !aligned16(w) || out_kind < 0 || out_kind > 2 ||
      (op == 1 && out_kind == 2) || op < 0 || op > 1)
    return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  if (!encode(&ma, a, op == 1, M, Kb / es, lda, 64 * wgs) ||
      !weight_map(&mb, w, op == 1, N, Kb / es, ldb, bn))
    return cudaErrorInvalidValue;
  const GemmArgs p = epilogue_args(M, N, Kb, w_scale, s_x, bias, out, ldc, hw, m_base,
                                   out_kind);
  return dispatch(op, bn, wgs, stages, ma, mb, p, static_cast<cudaStream_t>(stream));
}

// Conv mode (implicit GEMM), int8: x the NHWC int8 (B, H, W, Cp) of a
// quantize_nhwc, w (N, kh * kw * Cp) int8 in (dy, dx, c) order with row
// stride ldb bytes; output rows m = (b, ho, wo), M = B * Ho * Wo, with the
// epilogue of s2m2_gemm. tiled (stride 1, Cp % 128 == 0 only): A's tiles
// are (4 * wgs) x 16 blocks of output pixels, each tap one TMA box; else
// the producer gathers A's rows with cp.async.
extern "C" int s2m2_conv_gemm(const void* x, int B, int H, int W, int Cp, int Ho, int Wo,
                              int kh, int kw, int sh, int sw, int ph, int pw, const void* w,
                              long long ldb, int N, const void* w_scale, float s_x,
                              const void* bias, void* out, long long ldc, long long hw,
                              long long m_base, int out_kind, int tiled, int bn, int wgs,
                              int stages, void* stream) {
  const long long Kb = static_cast<long long>(kh) * kw * Cp;
  if (B < 1 || H < 1 || W < 1 || Cp < 32 || Cp % 32 != 0 || Ho < 1 || Wo < 1 || kh < 1 ||
      kw < 1 || sh < 1 || sw < 1 || ph < 0 || pw < 0 || N < 1 || Kb > 0x7fffffffLL ||
      ldb % 16 != 0 || !aligned16(x) || !aligned16(w) || out_kind < 0 || out_kind > 2 ||
      static_cast<long long>(B) * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if ((tiled && (sh != 1 || sw != 1 || Cp % BKB != 0 || wgs < 1 || wgs > 3)) ||
      (hw > 0 && m_base + static_cast<long long>(B) * Ho * Wo >= (1LL << 31)))
    return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  std::memset(&ma, 0, sizeof(ma));
  if ((tiled && !encode_taps(&ma, x, B, H, W, Cp, 4 * wgs)) ||
      !weight_map(&mb, w, false, N, Kb, ldb, bn))
    return cudaErrorInvalidValue;
  GemmArgs p = epilogue_args(static_cast<long long>(B) * Ho * Wo, N, static_cast<int>(Kb),
                             w_scale, s_x, bias, out, ldc, hw, m_base, out_kind);
  p.conv = tiled ? 2 : 1;
  p.tiles_w = (Wo + 15) / 16;
  p.tiles_h = (Ho + 4 * wgs - 1) / (4 * wgs);
  p.x = static_cast<const int8_t*>(x);
  p.H = H;
  p.W = W;
  p.Cp = Cp;
  p.Ho = Ho;
  p.Wo = Wo;
  p.kw = kw;
  p.sh = sh;
  p.sw = sw;
  p.ph = ph;
  p.pw = pw;
  return dispatch(0, bn, wgs, stages, ma, mb, p, static_cast<cudaStream_t>(stream));
}

extern "C" const char* s2m2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
