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
// modules hold them, in the (out, in) Linear layout, in the order of the
// TPU kernel's _pack_weights.
//
// Numerics follow the TPU kernel's body step by step: float32 layer norms,
// their output rounded to the compute dtype; every product accumulated in
// float32 and its result rounded to the compute dtype; the v bias added
// after that rounding; float32 scores scaled by hd^-1/2 after the dot, an
// exact float32 softmax (max, sum, divide) over the whole row; the
// probabilities rounded to v's dtype before P V; the FFN's first product
// rounded, then its bias and an exact-erf GELU in float32, then rounded;
// the residual adds in the compute dtype, z + mm + b2 in that order.
//
// Design. The TPU kernel keeps a group of whole row pairs and all 18
// weights in VMEM. On this card a block has at most 227 KB of shared
// memory: less than one view's row at XL's 1x scale (304 x 384 bf16 = 233
// KB). The 12 C x E weight matrices (3.5 MB in bf16 at C = 384) fit the 50
// MB L2 instead. So:
//  - each thread block owns whole row pairs (a loop over pairs, grid-
//    strided) and walks the sublayers in order, with __syncthreads()
//    between stages;
//  - between stages a pair's intermediates (LN output, q, k, v, attention
//    output, FFN hidden, one head's W x W float32 scores and its rounded
//    probabilities) sit in a per-block scratch in global memory, written
//    and read by that block only;
//  - every product -- the twelve linears, Q K^T and P V -- runs through one
//    tiled GEMM: 64 x 64 output tiles over k tiles 64 deep in bf16 and 32
//    in float32, weight tiles streamed from L2; bf16 tiles through a
//    4-stage cp.async ring in shared memory, float32 tiles (and bf16 ones of
//    odd widths) through registers with the next k tile's loads in flight;
//    an epilogue applies the rounding, bias, GELU and residual of each
//    product;
//  - bf16 products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//    float32 accumulate; 8 warps of 32 x 16); float32 products on exact
//    float32 FMAs (no TF32; 4 x 4 outputs a thread);
//  - any head dim (E / heads, 1 to 512) and any W: loads whose row, column
//    or alignment does not allow a 16-byte vector fall back to masked
//    element loads, so odd sizes (head dims 4, 12, 24) run too.
//
// What bounds it: per launch the 2 x pairs x W tokens do 24 C E flops each
// in the linears, plus 16 W^2 E per pair in the attentions, against one
// read and one write of the rows: at XL's 1x scale 0.70 TFLOP against 239
// MB in bf16, so the arithmetic bounds it in both dtypes. Not done yet:
// wgmma, TMA, more than one pair per block at once (PERF.md has the times).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int BM = 64;  // GEMM output tile rows
constexpr int BN = 64;  // GEMM output tile columns
constexpr int N_WEIGHTS = 18;
constexpr int MAX_DIM = 512;  // C and E: the layer norm holds a token in 16 floats a lane

// the weight order of s2m2_tpu/ops/fused_block.py's _pack_weights
enum { CQ, CK, CV, CVB, CP, F1W1, F1B1, F1W2, F1B2,
       SQ, SK, SV, SVB, SP, F2W1, F2B1, F2W2, F2B2 };

struct Params {
  const void* x;  // (R, W, C) input rows
  void* y;        // (R, W, C) output rows
  const void* w[N_WEIGHTS];
  void* act;      // per block: 4 buffers of (2W, ld), compute dtype
  void* probs;    // per block: (W, lds), compute dtype
  float* scores;  // per block: (W, lds), float32
  int n_pairs, right0, W, C, E, heads, ld, lds;
  float scale;    // (E / heads)^-1/2
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T, as float
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
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

// ---- epilogues ------------------------------------------------------------

enum Mode { SCORES, STORE, STORE_BIAS, GELU_BIAS, RESID, RESID_BIAS };

// What a GEMM does with its float32 sum for output (m, n).
template <typename T>
struct Epi {
  int mode;
  void* out;          // SCORES: float32 (M, N) rows of ldo; STORE*, GELU_BIAS: T
  int ldo;
  const T* bias;      // (N,)
  const T* zin;       // RESID*: token m of the pair, channel n, read here
  T* zout;            // ... and written here (may equal zin)
  size_t row0, row1;  // element offsets of the pair's left and right rows
  int W, C;

  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    if (mode == SCORES) {
      static_cast<float*>(out)[(size_t)m * ldo + n] = acc;
      return;
    }
    if (mode == RESID || mode == RESID_BIAS) {
      const int view = m >= W;
      const size_t o = (view ? row1 : row0) + (size_t)(m - view * W) * C + n;
      float z = rnd<T>(to_f(zin[o]) + rnd<T>(acc));
      if (mode == RESID_BIAS) z = rnd<T>(z + to_f(bias[n]));
      zout[o] = from_f<T>(z);
      return;
    }
    float v = rnd<T>(acc);
    if (mode == STORE_BIAS) {
      v += to_f(bias[n]);
    } else if (mode == GELU_BIAS) {
      v += to_f(bias[n]);
      v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
    }
    static_cast<T*>(out)[(size_t)m * ldo + n] = from_f<T>(v);
  }
};

// ---- the tiled GEMM -------------------------------------------------------

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16 bytes of row `row`, columns [col, col + 16 / sizeof(T)) of a row-major
// matrix of `rows` x `cols` with leading dimension ld; zero past the edges
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* base, int ld, int row, int col,
                                          int rows, int cols, bool aligned) {
  constexpr int V = 16 / sizeof(T);
  using Bits = typename std::conditional<sizeof(T) == 2, uint16_t, uint32_t>::type;
  union {
    uint4 u;
    Bits e[V];
  } r;
  r.u = make_uint4(0u, 0u, 0u, 0u);
  if (row < rows) {
    const T* p = base + (size_t)row * ld + col;
    if (aligned && col + V <= cols) {
      r.u = *reinterpret_cast<const uint4*>(p);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (col + i < cols) r.e[i] = reinterpret_cast<const Bits*>(p)[i];
    }
  }
  return r.u;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
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

// 16 bytes global -> shared, asynchronous; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// The k tile (K deep) and its shared memory stages. bf16: A as [m][k]
// (row stride K + 8), B as [n][k] (K + 8) or, for KN, [k][n] (BN + 8):
// the padding puts ldmatrix's 8 row addresses in distinct banks; 4 stages,
// so 3 k tiles of cp.async copies are in flight while the tensor cores
// work on the fourth. float32: A and B both [k][.] (row stride 64 + 4), so
// the math reads 4 consecutive rows or columns as one float4; 2 stages.
template <typename T> struct Stage;
template <> struct Stage<__nv_bfloat16> {
  static constexpr int K = 64;
  static constexpr int A = BM * (K + 8);
  static constexpr int B = BN * (K + 8);  // == K * (BN + 8)
  static constexpr int N = 4;
  static constexpr int BYTES = N * (A + B) * 2;
};
template <> struct Stage<float> {
  static constexpr int K = 32;
  static constexpr int A = K * (BM + 4);
  static constexpr int B = K * (BN + 4);
  static constexpr int N = 2;
  static constexpr int BYTES = N * (A + B) * 4;
};

// out(m, n) = epi(sum_k A[m][k] * B(k, n)) for m < M, n < N, over k < K.
// A: row-major (M, K), leading dimension lda. B, row-major with leading
// dimension ldb: (N, K) when !KN (a Linear weight; K of Q K^T), (K, N) when
// KN (V of P V). Ends with __syncthreads(): its outputs are visible to the
// whole block.
//
// Two load paths, chosen per call: bf16 operands whose rows are 16-byte
// aligned and whose column extents are multiples of 8 stream through the
// 4-stage cp.async ring; everything else (float32, and bf16 head slices of
// odd widths) goes through registers, the next k tile's loads in flight
// during the current tile's math, two stages.
template <typename T, bool KN>
__device__ void gemm(const T* A, int lda, const T* B, int ldb, int M, int N, int K,
                     const Epi<T>& epi, unsigned char* smem) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int V = 16 / sizeof(T);
  constexpr int NV = 2;  // 16-byte vectors a thread loads per operand and k tile
  constexpr int BK = Stage<T>::K;
  constexpr int S = Stage<T>::N;
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + S * Stage<T>::A;
  const int tid = threadIdx.x;
  const bool a_al = aligned16(A) && lda % V == 0;
  const bool b_al = aligned16(B) && ldb % V == 0;
  const bool ring = BF && a_al && b_al && K % V == 0 && (KN ? N : K) % V == 0;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n;
  const int nk = (K + BK - 1) / BK;

  // where this thread's vectors go: (row, col) within a tile
  int ar[NV], ac[NV], br[NV], bc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int idx = tid + THREADS * i;
    ar[i] = idx >> 3;
    ac[i] = (idx & 7) * V;
    br[i] = BF || !KN ? idx >> 3 : idx >> 4;
    bc[i] = BF || !KN ? (idx & 7) * V : (idx & 15) * V;
  }

  for (int tile = 0; tile < tiles; ++tile) {
    const int m0 = tile / tiles_n * BM;
    const int n0 = tile % tiles_n * BN;
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;

    // the math of one k tile, on stage st
    auto compute = [&](int st) {
      const T* a = sA + st * Stage<T>::A;
      const T* b = sB + st * Stage<T>::B;
      if constexpr (BF) {
        const int lane = tid & 31, warp = tid >> 5;
        const int wm = warp >> 2, wn = warp & 3;  // a 2 x 4 grid of 32 x 16 warp tiles
        const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
        const int a_col = (lane >> 4) * 8;
        const int b_row = (lane & 7) + (lane >> 4) * 8;
        const int b_col = ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
          uint32_t af[2][4], bf[4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldmatrix_x4(af[mt], a + (wm * 32 + mt * 16 + a_row) * (BK + 8) + ks * 16 + a_col);
          if (KN)
            ldmatrix_x4_trans(bf, b + (ks * 16 + a_row) * (BN + 8) + wn * 16 + a_col);
          else
            ldmatrix_x4(bf, b + (wn * 16 + b_row) * (BK + 8) + ks * 16 + b_col);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc + (mt * 2 + 0) * 4, af[mt], bf[0], bf[1]);
            mma_bf16(acc + (mt * 2 + 1) * 4, af[mt], bf[2], bf[3]);
          }
        }
      } else {
        const int ty = tid >> 4, tx = tid & 15;
        const float* fa = reinterpret_cast<const float*>(a);
        const float* fb = reinterpret_cast<const float*>(b);
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) {
          const float4 av = *reinterpret_cast<const float4*>(fa + kk * (BM + 4) + ty * 4);
          const float4 bv = *reinterpret_cast<const float4*>(fb + kk * (BN + 4) + tx * 4);
          const float as[4] = {av.x, av.y, av.z, av.w};
          const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i * 4 + j] = fmaf(as[i], bs[j], acc[i * 4 + j]);
        }
      }
    };

    if (ring) {
      // k tile kt -> stage kt % S; a vector past M, N or K copies 0 bytes
      auto fetch = [&](int kt) {
        if (kt < nk) {
          const int k0 = kt * BK;
          T* a = sA + kt % S * Stage<T>::A;
          T* b = sB + kt % S * Stage<T>::B;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int am = m0 + ar[i], ak = k0 + ac[i];
            const bool a_in = am < M && ak < K;
            cp_async16(a + ar[i] * (BK + 8) + ac[i], a_in ? A + (size_t)am * lda + ak : A,
                       a_in ? 16 : 0);
            const int br_g = KN ? k0 + br[i] : n0 + br[i];
            const int bc_g = KN ? n0 + bc[i] : k0 + bc[i];
            const bool b_in = br_g < (KN ? K : N) && bc_g < (KN ? N : K);
            cp_async16(b + br[i] * (KN ? BN + 8 : BK + 8) + bc[i],
                       b_in ? B + (size_t)br_g * ldb + bc_g : B, b_in ? 16 : 0);
          }
        }
        cp_async_commit();  // an empty group past the last tile keeps the count uniform
      };
#pragma unroll
      for (int kt = 0; kt < S - 1; ++kt) fetch(kt);
      for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<S - 2>();  // this thread's copies of tile kt have landed
        __syncthreads();         // everyone's have; stage (kt - 1) % S is free
        fetch(kt + S - 1);
        compute(kt % S);
      }
      cp_async_wait<0>();
      __syncthreads();  // the next tile's copies may overwrite every stage
    } else {
      uint4 ra[NV], rb[NV];
      auto load = [&](int k0) {
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          ra[i] = load_vec(A, lda, m0 + ar[i], k0 + ac[i], M, K, a_al);
          rb[i] = KN ? load_vec(B, ldb, k0 + br[i], n0 + bc[i], K, N, b_al)
                     : load_vec(B, ldb, n0 + br[i], k0 + bc[i], N, K, b_al);
        }
      };
      auto store = [&](int st) {
        T* a = sA + st * Stage<T>::A;
        T* b = sB + st * Stage<T>::B;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          if constexpr (BF) {
            *reinterpret_cast<uint4*>(a + ar[i] * (BK + 8) + ac[i]) = ra[i];
            *reinterpret_cast<uint4*>(b + br[i] * (KN ? BN + 8 : BK + 8) + bc[i]) = rb[i];
          } else {
            const float* ea = reinterpret_cast<const float*>(&ra[i]);
#pragma unroll
            for (int q = 0; q < 4; ++q)
              reinterpret_cast<float*>(a)[(ac[i] + q) * (BM + 4) + ar[i]] = ea[q];
            if (KN) {
              *reinterpret_cast<uint4*>(reinterpret_cast<float*>(b) + br[i] * (BN + 4) +
                                        bc[i]) = rb[i];
            } else {
              const float* eb = reinterpret_cast<const float*>(&rb[i]);
#pragma unroll
              for (int q = 0; q < 4; ++q)
                reinterpret_cast<float*>(b)[(bc[i] + q) * (BN + 4) + br[i]] = eb[q];
            }
          }
        }
      };
      load(0);
      store(0);
      __syncthreads();
      for (int kt = 0; kt < nk; ++kt) {
        if (kt + 1 < nk) load((kt + 1) * BK);
        compute(kt & 1);
        if (kt + 1 < nk) store((kt + 1) & 1);
        __syncthreads();
      }
    }

    if constexpr (BF) {
      const int lane = tid & 31, warp = tid >> 5;
      const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = m0 + wm * 32 + mt * 16 + (lane >> 2) + 8 * (e >> 1);
            const int n = n0 + wn * 16 + nt * 8 + 2 * (lane & 3) + (e & 1);
            if (m < M && n < N) epi(m, n, acc[(mt * 2 + nt) * 4 + e]);
          }
    } else {
      const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = m0 + ty * 4 + i;
          const int n = n0 + tx * 4 + j;
          if (m < M && n < N) epi(m, n, acc[i * 4 + j]);
        }
    }
  }
  __syncthreads();
}

// ---- row stages -----------------------------------------------------------

// out[m] = LN(token m of the pair) rounded to T, m < 2W: a warp per token,
// float32 two-pass statistics (mean, then mean square deviation)
template <typename T>
__device__ void layer_norm_pair(const T* z, size_t row0, size_t row1, int W, int C,
                                T* out, int ldo) {
  const int lane = threadIdx.x & 31;
  for (int m = threadIdx.x >> 5; m < 2 * W; m += WARPS) {
    const int view = m >= W;
    const T* src = z + (view ? row1 : row0) + (size_t)(m - view * W) * C;
    float v[MAX_DIM / 32];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_DIM / 32; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < C ? to_f(src[c]) : 0.f;
      s += v[i];
    }
    const float mean = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_DIM / 32; ++i) {
      const float d = v[i] - mean;
      if (lane + 32 * i < C) q += d * d;
    }
    const float r = rsqrtf(warp_sum(q) / C + 1e-5f);
#pragma unroll
    for (int i = 0; i < MAX_DIM / 32; ++i) {
      const int c = lane + 32 * i;
      if (c < C) out[(size_t)m * ldo + c] = from_f<T>((v[i] - mean) * r);
    }
  }
  __syncthreads();
}

// P = softmax(S * scale) over each of the W rows, rounded to T: a warp per row
template <typename T>
__device__ void softmax_rows(const float* S, T* P, int W, int lds, float scale) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < W; r += WARPS) {
    const float* s = S + (size_t)r * lds;
    float mx = -INFINITY;
    for (int j = lane; j < W; j += 32) mx = fmaxf(mx, s[j] * scale);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < W; j += 32) sum += expf(s[j] * scale - mx);
    sum = warp_sum(sum);
    for (int j = lane; j < W; j += 32)
      P[(size_t)r * lds + j] = from_f<T>(expf(s[j] * scale - mx) / sum);
  }
  __syncthreads();
}

// ---- the block ------------------------------------------------------------

template <typename T>
struct Pair {
  const Params& p;
  size_t row0, row1;
  T *nb, *qb, *kb, *vb, *probs;
  float* scores;
  unsigned char* smem;

  __device__ Epi<T> epi(int mode, void* out, int ldo, const void* bias = nullptr,
                        const T* zin = nullptr, T* zout = nullptr) const {
    return Epi<T>{mode, out, ldo, static_cast<const T*>(bias), zin, zout,
                  row0, row1, p.W, p.C};
  }
  __device__ const T* w(int i) const { return static_cast<const T*>(p.w[i]); }

  // z_out = z_in + proj(attn(LN z_in)): cross (queries of one view, keys
  // and values of the other) or self attention, for both views
  __device__ void attention(bool cross, int wq, int wk, int wv, int wvb, int wp,
                            const T* zin, T* zout) const;
  // z += W2 gelu(W1 LN z + b1) + b2
  __device__ void ffn(int w1, int b1, int w2, int b2, T* z) const;
};

template <typename T>
__device__ void Pair<T>::attention(bool cross, int wq, int wk, int wv, int wvb, int wp,
                                   const T* zin, T* zout) const {
  const int W = p.W, C = p.C, E = p.E, M2 = 2 * W, ld = p.ld;
  const int hd = E / p.heads;
  layer_norm_pair(zin, row0, row1, W, C, nb, ld);
  gemm<T, false>(nb, ld, w(wq), C, M2, E, C, epi(STORE, qb, ld), smem);
  gemm<T, false>(nb, ld, w(wk), C, M2, E, C, epi(STORE, kb, ld), smem);
  gemm<T, false>(nb, ld, w(wv), C, M2, E, C, epi(STORE_BIAS, vb, ld, w(wvb)), smem);
  // the attention output overwrites the LN output, which is no longer read
  for (int d = 0; d < 2; ++d) {
    const size_t qo = (size_t)d * W * ld;
    const size_t kvo = (size_t)(cross ? 1 - d : d) * W * ld;
    for (int h = 0; h < p.heads; ++h) {
      gemm<T, false>(qb + qo + h * hd, ld, kb + kvo + h * hd, ld, W, W, hd,
                     epi(SCORES, scores, p.lds), smem);
      softmax_rows(scores, probs, W, p.lds, p.scale);
      gemm<T, true>(probs, p.lds, vb + kvo + h * hd, ld, W, hd, W,
                    epi(STORE, nb + qo + h * hd, ld), smem);
    }
  }
  gemm<T, false>(nb, ld, w(wp), E, M2, C, E, epi(RESID, nullptr, 0, nullptr, zin, zout),
                 smem);
}

template <typename T>
__device__ void Pair<T>::ffn(int w1, int b1, int w2, int b2, T* z) const {
  const int W = p.W, C = p.C, E = p.E, M2 = 2 * W, ld = p.ld;
  layer_norm_pair(z, row0, row1, W, C, nb, ld);
  gemm<T, false>(nb, ld, w(w1), C, M2, E, C, epi(GELU_BIAS, qb, ld, w(b1)), smem);
  gemm<T, false>(qb, ld, w(w2), E, M2, C, E, epi(RESID_BIAS, nullptr, 0, w(b2), z, z),
                 smem);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) fused_block_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];  // Stage<T>::BYTES
  const size_t buf = (size_t)2 * p.W * p.ld;
  T* act = static_cast<T*>(p.act) + blockIdx.x * 4 * buf;
  T* probs = static_cast<T*>(p.probs) + (size_t)blockIdx.x * p.W * p.lds;
  float* scores = p.scores + (size_t)blockIdx.x * p.W * p.lds;
  const T* x = static_cast<const T*>(p.x);
  T* y = static_cast<T*>(p.y);
  for (int pair = blockIdx.x; pair < p.n_pairs; pair += gridDim.x) {
    const Pair<T> pr{p, (size_t)pair * p.W * p.C, (size_t)(p.right0 + pair) * p.W * p.C,
                     act, act + buf, act + 2 * buf, act + 3 * buf, probs, scores, smem};
    pr.attention(true, CQ, CK, CV, CVB, CP, x, y);
    pr.ffn(F1W1, F1B1, F1W2, F1B2, y);
    pr.attention(false, SQ, SK, SV, SVB, SP, y, y);
    pr.ffn(F2W1, F2B1, F2W2, F2B2, y);
  }
}

int round_up8(int n) { return (n + 7) / 8 * 8; }

size_t scratch_bytes(int blocks, int W, int C, int E, size_t isz) {
  const size_t ld = round_up8(C > E ? C : E), lds = round_up8(W);
  return (size_t)blocks * (8 * W * ld * isz + W * lds * isz + W * lds * 4);
}

template <typename T>
cudaError_t launch(Params p, int blocks, void* scratch, cudaStream_t stream) {
  unsigned char* s = static_cast<unsigned char*>(scratch);
  p.act = s;
  s += (size_t)blocks * 8 * p.W * p.ld * sizeof(T);
  p.probs = s;
  s += (size_t)blocks * p.W * p.lds * sizeof(T);
  p.scores = reinterpret_cast<float*>(s);
  const cudaError_t err = cudaFuncSetAttribute(
      fused_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, Stage<T>::BYTES);
  if (err != cudaSuccess) return err;
  fused_block_kernel<T><<<blocks, THREADS, Stage<T>::BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch the launch below needs for `blocks` thread blocks.
extern "C" size_t s2m2_fused_block_scratch_bytes(int blocks, int W, int C, int E,
                                                 int dtype) {
  return scratch_bytes(blocks, W, C, E, dtype == 0 ? 4 : 2);
}

// x, y: (R, W, C) contiguous rows, pairs (i, right0 + i) for i < n_pairs;
// weights: the 18 block weights, contiguous, (out, in) Linear layout; all
// of one dtype (0 float32, 1 bfloat16). scratch: s2m2_fused_block_scratch_
// bytes(blocks, ...) bytes, 16-byte aligned. Returns the cudaError_t of the
// launch.
extern "C" int s2m2_fused_basic_attn_block(const void* x, void* y,
                                           const void* const* weights, void* scratch,
                                           int blocks, int n_pairs, int right0, int W,
                                           int C, int E, int heads, int dtype,
                                           void* stream) {
  if (blocks < 1 || n_pairs < 1 || right0 < n_pairs || W < 1 || C < 1 || C > MAX_DIM ||
      E < 1 || E > MAX_DIM || heads < 1 || E % heads != 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  Params p{};
  p.x = x;
  p.y = y;
  for (int i = 0; i < N_WEIGHTS; ++i) p.w[i] = weights[i];
  p.n_pairs = n_pairs;
  p.right0 = right0;
  p.W = W;
  p.C = C;
  p.E = E;
  p.heads = heads;
  p.ld = round_up8(C > E ? C : E);
  p.lds = round_up8(W);
  p.scale = (float)pow((double)(E / heads), -0.5);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, blocks, scratch, s);
  return launch<__nv_bfloat16>(p, blocks, scratch, s);
}

extern "C" const char* s2m2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
