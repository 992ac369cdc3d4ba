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
// What bounds it on the H100: 4 B Nq Nk D int8 operations at 1,979 TOP/s
// against the bytes of q, k, v and the output once each; at the port's
// shapes (N = 76 to 1216, D = 32 to 128) the bytes bound it below N of a
// few hundred, the operations above. This first version is simple and
// right rather than fast:
//  - a block owns 64 queries of one sequence (4 warps of 16), quantizes
//    them once into shared memory, and walks the keys in tiles of 64: K
//    quantized into shared memory as rows, V transposed (d-major), so both
//    products read their B fragments as 4-byte runs;
//  - both products on int8 mma.sync m16n8k32 (IMMA, int32 accumulators);
//  - two passes over the keys: the first finds each row's largest S (an
//    integer, so the max is exact), the second recomputes S, forms e, l
//    and p_q, and multiplies P V, P going through a per-warp shared tile
//    from the accumulator layout to the A operand's;
//  - the output columns are taken 128 at a time (16 accumulator tiles a
//    warp), the second pass repeated for each, so a head of 384 costs
//    three times its Q K^T, which is cheap beside the bytes;
//  - shared rows are padded by 16 bytes, so the fragment reads are free of
//    bank conflicts.
// wgmma and TMA are the next step (ROADMAP.md, Queue 2).

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // queries a block
constexpr int BKEY = 64;     // keys a tile
constexpr int DCH = 128;     // output columns a pass
constexpr int THREADS = 128;
constexpr int MAX_D = 512;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// clip(rint(x * inv), -127, 127), rounding half to even as jnp.round
__device__ __forceinline__ int8_t quant(float x, float inv) {
  const float r = rintf(__fmul_rn(x, inv));
  return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

// d[0..3] += a (16x32 int8, row) * b (32x8 int8, col), int32 accumulators
__device__ __forceinline__ void imma(int* d, const uint32_t (&a)[4], uint32_t b0,
                                     uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int Nq, Nk, D, DP;
  float inv_q, inv_k, inv_v, c, out_scale;
};

// Quantize rows r0 .. r0 + rows of a (N, D) float sequence into shared
// int8 rows of `pitch` bytes, zero past N and past D (to DP).
template <typename T>
__device__ void load_rows(int8_t* dst, const T* src, int r0, int rows, int n, int d,
                          int dp, int pitch, float inv) {
  for (int i = threadIdx.x; i < rows * dp; i += THREADS) {
    const int r = i / dp;
    const int c = i - r * dp;
    int8_t x = 0;
    if (r0 + r < n && c < d)
      x = quant(load_f(src + static_cast<long long>(r0 + r) * d + c), inv);
    dst[r * pitch + c] = x;
  }
}

// Columns d0 .. d0 + dw of keys r0 .. r0 + BKEY of v, quantized and
// transposed: dst[dl * VPITCH + key], zero past Nk and past D.
constexpr int VPITCH = BKEY + 16;
template <typename T>
__device__ void load_vt(int8_t* dst, const T* src, int r0, int n, int d, int d0, int dw,
                        float inv) {
  for (int i = threadIdx.x; i < BKEY * dw; i += THREADS) {
    const int r = i / dw;
    const int dl = i - r * dw;
    int8_t x = 0;
    if (r0 + r < n && d0 + dl < d)
      x = quant(load_f(src + static_cast<long long>(r0 + r) * d + d0 + dl), inv);
    dst[dl * VPITCH + r] = x;
  }
}

// The warp's 16 x 64 scores of one key tile: acc[n][e] for key n-tile n
// (8 keys), element e of the m16n8 accumulator (rows g, g, g + 8, g + 8;
// keys 2 t, 2 t + 1, 2 t, 2 t + 1 within the tile).
__device__ __forceinline__ void scores(int (&acc)[BKEY / 8][4], const int8_t* sq,
                                       const int8_t* sk, int dp, int pitch, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < BKEY / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0;
  for (int ks = 0; ks < dp; ks += 32) {
    uint32_t a[4];
    a[0] = ld32(sq + g * pitch + ks + t * 4);
    a[1] = ld32(sq + (g + 8) * pitch + ks + t * 4);
    a[2] = ld32(sq + g * pitch + ks + 16 + t * 4);
    a[3] = ld32(sq + (g + 8) * pitch + ks + 16 + t * 4);
#pragma unroll
    for (int n = 0; n < BKEY / 8; ++n) {
      const int8_t* kr = sk + (n * 8 + g) * pitch + ks + t * 4;
      imma(acc[n], a, ld32(kr), ld32(kr + 16));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) int8_attention_kernel(Params p) {
  extern __shared__ __align__(16) int8_t smem[];
  const int pitch = p.DP + 16;
  int8_t* sq = smem;                          // BQ x pitch
  int8_t* sk = sq + BQ * pitch;               // BKEY x pitch
  int8_t* svt = sk + BKEY * pitch;            // DCH x VPITCH
  int8_t* sp = svt + DCH * VPITCH;            // 4 warps x 16 x VPITCH
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long seq = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const T* q = static_cast<const T*>(p.q) + seq * p.Nq * p.D;
  const T* k = static_cast<const T*>(p.k) + seq * p.Nk * p.D;
  const T* v = static_cast<const T*>(p.v) + seq * p.Nk * p.D;
  T* out = static_cast<T*>(p.out) + seq * p.Nq * p.D;
  const int8_t* wq = sq + warp * 16 * pitch;
  int8_t* wp = sp + warp * 16 * VPITCH;

  load_rows(sq, q, q0, BQ, p.Nq, p.D, p.DP, pitch, p.inv_q);

  // pass 1: each row's largest S over the real keys
  int smax[2] = {INT_MIN, INT_MIN};
  int acc[BKEY / 8][4];
  for (int k0 = 0; k0 < p.Nk; k0 += BKEY) {
    __syncthreads();  // the previous tile is read
    load_rows(sk, k, k0, BKEY, p.Nk, p.D, p.DP, pitch, p.inv_k);
    __syncthreads();
    scores(acc, wq, sk, p.DP, pitch, lane);
#pragma unroll
    for (int n = 0; n < BKEY / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + n * 8 + 2 * t + (e & 1) < p.Nk) smax[e >> 1] = max(smax[e >> 1], acc[n][e]);
  }
  float m[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    smax[h] = max(smax[h], __shfl_xor_sync(0xffffffffu, smax[h], 1));
    smax[h] = max(smax[h], __shfl_xor_sync(0xffffffffu, smax[h], 2));
    m[h] = __fmul_rn(static_cast<float>(smax[h]), p.c);
  }

  // pass 2, per 128 output columns: e, l, p_q and P V
  for (int d0 = 0; d0 < p.D; d0 += DCH) {
    const int dw = min(DCH, p.DP - d0);  // this pass's columns, a multiple of 32
    int o[DCH / 8][4];
#pragma unroll
    for (int n = 0; n < DCH / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0;
    float l[2] = {0.f, 0.f};
    for (int k0 = 0; k0 < p.Nk; k0 += BKEY) {
      __syncthreads();
      load_rows(sk, k, k0, BKEY, p.Nk, p.D, p.DP, pitch, p.inv_k);
      load_vt(svt, v, k0, p.Nk, p.D, d0, dw, p.inv_v);
      __syncthreads();
      scores(acc, wq, sk, p.DP, pitch, lane);
#pragma unroll
      for (int n = 0; n < BKEY / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = n * 8 + 2 * t + (e & 1);
          float ex = 0.f;
          if (k0 + key < p.Nk)
            ex = expf(__fsub_rn(__fmul_rn(static_cast<float>(acc[n][e]), p.c), m[e >> 1]));
          l[e >> 1] += ex;
          wp[(g + 8 * (e >> 1)) * VPITCH + key] =
              static_cast<int8_t>(rintf(__fmul_rn(127.f, ex)));
        }
      __syncwarp();
#pragma unroll
      for (int kk = 0; kk < BKEY; kk += 32) {
        uint32_t a[4];
        a[0] = ld32(wp + g * VPITCH + kk + t * 4);
        a[1] = ld32(wp + (g + 8) * VPITCH + kk + t * 4);
        a[2] = ld32(wp + g * VPITCH + kk + 16 + t * 4);
        a[3] = ld32(wp + (g + 8) * VPITCH + kk + 16 + t * 4);
#pragma unroll
        for (int n = 0; n < DCH / 8; ++n) {
          if (n * 8 >= dw) break;
          const int8_t* vr = svt + (n * 8 + g) * VPITCH + kk + t * 4;
          imma(o[n], a, ld32(vr), ld32(vr + 16));
        }
      }
      __syncwarp();  // the P tile is read before the next tile writes it
    }
    float scale[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      scale[h] = __fmul_rn(__frcp_rn(l[h]), p.out_scale);
    }
#pragma unroll
    for (int n = 0; n < DCH / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + warp * 16 + g + 8 * (e >> 1);
        const int col = d0 + n * 8 + 2 * t + (e & 1);
        if (row < p.Nq && col < p.D)
          store_f(out + static_cast<long long>(row) * p.D + col,
                  __fmul_rn(static_cast<float>(o[n][e]), scale[e >> 1]));
      }
  }
}

template <typename T>
int launch(const Params& p, int B, cudaStream_t stream) {
  const int pitch = p.DP + 16;
  const int smem = (BQ + BKEY) * pitch + DCH * VPITCH + 4 * 16 * VPITCH;
  cudaError_t err = cudaFuncSetAttribute(int8_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, (p.Nq + BQ - 1) / BQ);
  int8_attention_kernel<T><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q (B, Nq, D), k and v (B, Nk, D), out (B, Nq, D), all contiguous, dtype 0
// float32 or 1 bf16. inv_*: float32(1 / s_*); c: float32(s_q s_k D^-1/2);
// out_scale: float32(s_v / 127).
extern "C" int s2m2_int8_attention(const void* q, const void* k, const void* v, void* out,
                                   int B, int Nq, int Nk, int D, float inv_q, float inv_k,
                                   float inv_v, float c, float out_scale, int dtype,
                                   void* stream) {
  if (B < 1 || Nq < 1 || Nk < 1 || D < 1 || D > MAX_D || Nq > 65535 * BQ)
    return cudaErrorInvalidValue;
  const Params p{q, k, v, out, Nq, Nk, D, (D + 31) / 32 * 32, inv_q, inv_k, inv_v, c,
                 out_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, B, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, B, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* s2m2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
