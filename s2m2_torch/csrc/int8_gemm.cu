// Int8 quantize -> int8 x int8 -> int32 tensor-core GEMM -> dequantize, for
// Hopper (sm_90a): kernel E.
//
// Replaces scripts/probe_pallas_int8.py: run (its _kernel_int8 and
// _kernel_bf16 bodies) and, with it, the body of every int8 site of
// s2m2_tpu/models/quant.py: _quantize_input, then the int8 conv or dot
// with int32 accumulation, then acc * (s_w[n] * s_x) + bias, cast to the
// input's dtype (conv2d_maybe_quantized, linear_maybe_quantized). One
// site is two launches:
//
//  - quantize_pack: reads the float activation (bf16 or float32) and
//    writes int8 rows q = clip(rint(x * inv), -127, 127), inv =
//    float32(1 / s_x), rounding half to even as jnp.round does. For a
//    kh x kw / stride / padding convolution on an NCHW tensor it writes the
//    im2col rows (row m = (b, ho, wo), column k = (c, dy, dx), the order of
//    an OIHW weight flattened), with 0 for the padding taps, which is what
//    quantizing after zero padding gives. Rows are padded with zeros to
//    Kp, a multiple of 32.
//  - int8_gemm: C[m, n] = sum_k A[m, k] W[n, k] in int32 on the tensor
//    cores (mma.sync m16n8k32 s8.s8.s32; A is row-major, W is torch's
//    Linear layout (N, K), which is the "col" operand), then the epilogue
//    out = cast(float(acc) * (s_w[n] * s_x) + bias[n]) with the scale
//    product taken first and no fused multiply-add, as the JAX package
//    rounds; or the raw int32 accumulators. The output is row-major (M, N)
//    or NCHW (row m = (b, hw)), so a conv's output needs no transpose.
//
// The same GEMM, instantiated on bf16 operands (mma m16n8k16, float32
// accumulation, bf16 or float32 out), serves the probe's _kernel_bf16 body.
//
// What bounds it on the H100: most sites of the int8 forward are
// memory-bound (XL's 1x-scale projections: 45.9 GOP, 23 us at 1,979 TOP/s,
// against 179 MB of int8 in and bf16 out, 54 us at 3.35 TB/s), and a 3x3
// conv's im2col rows are K = 9 C wide, so the pack is the larger share of
// the bytes. What this version does: one 128 x 128 output tile per block
// of 8 warps (each warp 64 x 32), 128-byte deep k tiles staged in shared
// memory by cp.async in a ring of three, fragments loaded by ldmatrix from
// 144-byte shared rows (conflict-free), the blocks of one row panel
// launched together so A streams from device memory once, and the output
// tile staged in shared memory so its stores are coalesced for row-major
// and NCHW output alike; the im2col pack goes
// through 64 x 64 shared-memory tiles so that both its reads (along
// pixels) and its writes (along columns) are coalesced. wgmma with TMA,
// an implicit-GEMM conv with no im2col rows, and the quantize fused into
// the producer's epilogue are the next steps (ROADMAP.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------------ pack

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int8_t quant(float v, float inv) {
  const float r = rintf(__fmul_rn(v, inv));  // half to even, as jnp.round
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.f), 127.f)));
}

union Pack8 {
  int8_t b[8];
  uint2 u;
};

// Token rows: row m of x starts at (m / inner) * outer + (m % inner) * ld,
// which covers a contiguous (M, K) matrix (inner = M) and one head of a
// (B, heads, N, d) tensor (inner = N, ld = d, outer = heads * N * d).
template <typename T>
__global__ void pack_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                                 long long M, int K, int Kp, long long inner,
                                 long long ld, long long outer, float inv) {
  const int groups = Kp / 8;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= M * groups) return;
  const long long m = i / groups;
  const int k0 = static_cast<int>(i % groups) * 8;
  const T* src = x + (m / inner) * outer + (m % inner) * ld;
  Pack8 pk;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = k0 + j;
    pk.b[j] = k < K ? quant(to_f(src[k]), inv) : static_cast<int8_t>(0);
  }
  *reinterpret_cast<uint2*>(q + m * Kp + k0) = pk.u;
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
    union {
      int8_t b[16];
      uint4 u;
    } pk;
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

// ------------------------------------------------------------------ GEMM

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 128;         // k tile, in bytes (128 int8 or 64 bf16 values)
constexpr int SROW = BK + 16;   // shared row stride: 144 bytes, 36 words apart
constexpr int STAGES = 3;
constexpr int STAGE_BYTES = (BM + BN) * SROW;
constexpr int GEMM_SMEM = STAGES * STAGE_BYTES;  // 110,592 bytes, 2 blocks per SM
constexpr int GEMM_THREADS = 256;
static_assert(BM == BN, "the epilogue's tile is square");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 16-byte matrices; lane l gets word l % 4 of row l / 4 of each
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint8_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float acc_f(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float acc_f(float v) { return v; }

template <typename OutT, typename Acc>
__device__ __forceinline__ OutT to_out(float v, Acc raw);
template <>
__device__ __forceinline__ float to_out<float, int>(float v, int) { return v; }
template <>
__device__ __forceinline__ float to_out<float, float>(float v, float) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16, int>(float v, int) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16, float>(float v, float) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ int to_out<int, int>(float, int raw) { return raw; }

// Acc: int (int8 operands) or float (bf16 operands). OutT int: the raw
// int32 accumulators. Lengths in bytes: lda, ldb and Kb (= K * element
// size, a multiple of 32). hw > 0: NCHW output, row m_base + m = b * hw + p.
// blockIdx.x walks N, so the blocks of one row panel run together and its
// A tile comes from L2 after the first; blockIdx.y walks M.
template <typename Acc, typename OutT>
__global__ void __launch_bounds__(GEMM_THREADS)
    gemm_kernel(const uint8_t* __restrict__ A, long long lda,
                const uint8_t* __restrict__ B, long long ldb, long long M, int N, int Kb,
                const float* __restrict__ w_scale, float s_x,
                const float* __restrict__ bias, OutT* __restrict__ out, long long ldc,
                long long hw, long long m_base) {
  extern __shared__ __align__(16) uint8_t smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // 2 warps over M, 4 over N: 64 x 32 each
  const int wn = warp & 3;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const int n0 = blockIdx.x * BN;

  auto load = [&](int stage, int kb0) {
    uint8_t* as = smem + stage * STAGE_BYTES;
    uint8_t* bs = as + BM * SROW;
#pragma unroll
    for (int c = tid; c < BM * (BK / 16); c += GEMM_THREADS) {
      const int r = c >> 3;
      const int cc = (c & 7) * 16;
      const bool ok = m0 + r < M && kb0 + cc < Kb;
      cp_async16(as + r * SROW + cc, ok ? A + (m0 + r) * lda + kb0 + cc : A, ok);
    }
#pragma unroll
    for (int c = tid; c < BN * (BK / 16); c += GEMM_THREADS) {
      const int r = c >> 3;
      const int cc = (c & 7) * 16;
      const bool ok = n0 + r < N && kb0 + cc < Kb;
      cp_async16(bs + r * SROW + cc,
                 ok ? B + static_cast<long long>(n0 + r) * ldb + kb0 + cc : B, ok);
    }
  };

  Acc acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // ldmatrix row and column of this lane: A as (rows 0-7 | 8-15) x (bytes
  // 0-15 | 16-31), B as (n 0-7 | 8-15) x (bytes 0-15 | 16-31)
  const int a_row = wm * 64 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 16;
  const int b_row = wn * 32 + (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 16;

  const int nk = (Kb + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load(st, st * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();              // and every warp is done with tile kt - 1
    const int next = kt + STAGES - 1;
    if (next < nk) load(next % STAGES, next * BK);
    cp_async_commit();
    const uint8_t* as = smem + (kt % STAGES) * STAGE_BYTES;
    const uint8_t* bs = as + BM * SROW;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[4][4];
      uint32_t bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(af[mi], as + (a_row + mi * 16) * SROW + ks + a_col);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldsm_x4(bf[nj], bs + (b_row + nj * 16) * SROW + ks + b_col);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2], bf[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }

  // epilogue: the output tile goes through shared memory (the ring is free
  // now), so that the stores to device memory run along contiguous
  // addresses: along n for row-major output, along m (pixels) for NCHW
  cp_async_wait<0>();
  __syncthreads();
  // tile[ml][nl] for row-major output, tile[nl][ml] for NCHW (BM == BN):
  // either way a 16-byte run of the output is 16 contiguous bytes here
  constexpr int TS = BN + (sizeof(OutT) == 2 ? 8 : 4);  // tile row stride
  OutT* tile = reinterpret_cast<OutT*>(smem);
  const bool nchw = hw > 0;
  long long* row_b = reinterpret_cast<long long*>(smem + BM * TS * sizeof(OutT));
  long long* row_p = row_b + BM;
  if (tid < BM) {  // (image, pixel) of each row for NCHW output
    const long long gm = m_base + m0 + tid;
    row_b[tid] = hw > 0 ? gm / hw : 0;
    row_p[tid] = hw > 0 ? gm - row_b[tid] * hw : gm;
  }
  const int g = lane >> 2;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ml = wm * 64 + mi * 16 + g + half * 8;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {  // c0, c1 at (row g, cols 2t, 2t + 1); c2, c3 at g + 8
          const int nl = wn * 32 + ni * 8 + (lane & 3) * 2 + j;
          const int n = n0 + nl;
          const Acc a = acc[mi][ni][half * 2 + j];
          float v = acc_f(a);
          if (n < N) {
            if (w_scale != nullptr) v = __fmul_rn(v, __fmul_rn(w_scale[n], s_x));
            if (bias != nullptr) v = __fadd_rn(v, bias[n]);
          }
          tile[nchw ? nl * TS + ml : ml * TS + nl] = to_out<OutT>(v, a);
        }
      }
    }
  }
  __syncthreads();
  // 16-byte stores of VEC outputs where the run of VEC is whole and aligned:
  // VEC columns of a row (row-major), VEC pixels of a channel (NCHW, where
  // hw and m_base are multiples of VEC, so a run never crosses an image)
  constexpr int VEC = 16 / sizeof(OutT);
  const bool out16 = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (nchw) {
    const bool vec = out16 && hw % VEC == 0 && m_base % VEC == 0;
    for (int i = tid; i < (BM / VEC) * BN; i += GEMM_THREADS) {
      const int ml = (i % (BM / VEC)) * VEC;
      const int nl = i / (BM / VEC);
      const int n = n0 + nl;
      if (n >= N) continue;
      if (vec && m0 + ml + VEC <= M) {
        *reinterpret_cast<uint4*>(out + (row_b[ml] * N + n) * hw + row_p[ml]) =
            *reinterpret_cast<const uint4*>(&tile[nl * TS + ml]);
      } else {
        for (int e = 0; e < VEC && m0 + ml + e < M; ++e)
          out[(row_b[ml + e] * N + n) * hw + row_p[ml + e]] = tile[nl * TS + ml + e];
      }
    }
  } else {
    const bool vec = out16 && ldc % VEC == 0;
    for (int i = tid; i < BM * (BN / VEC); i += GEMM_THREADS) {
      const int ml = i / (BN / VEC);
      const int nl = (i % (BN / VEC)) * VEC;
      if (m0 + ml >= M) continue;
      OutT* dst = out + row_p[ml] * ldc + n0 + nl;
      if (vec && n0 + nl + VEC <= N) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(&tile[ml * TS + nl]);
      } else {
        for (int e = 0; e < VEC && n0 + nl + e < N; ++e) dst[e] = tile[ml * TS + nl + e];
      }
    }
  }
}

template <typename T>
cudaError_t launch_rows(const void* x, void* q, long long M, int K, int Kp,
                        long long inner, long long ld, long long outer, float inv,
                        cudaStream_t stream) {
  const long long n = M * (Kp / 8);
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  pack_rows_kernel<T><<<blocks, 256, 0, stream>>>(static_cast<const T*>(x),
                                                  static_cast<int8_t*>(q), M, K, Kp,
                                                  inner, ld, outer, inv);
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

template <typename Acc, typename OutT>
cudaError_t launch_gemm(const void* a, long long lda, const void* w, long long ldb,
                        long long M, int N, int Kb, const void* w_scale, float s_x,
                        const void* bias, void* out, long long ldc, long long hw,
                        long long m_base, cudaStream_t stream) {
  if ((M + BM - 1) / BM > 65535 || (N + BN - 1) / BN > 65535) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_kernel<Acc, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + BN - 1) / BN, static_cast<unsigned>((M + BM - 1) / BM));
  gemm_kernel<Acc, OutT><<<grid, GEMM_THREADS, GEMM_SMEM, stream>>>(
      static_cast<const uint8_t*>(a), lda, static_cast<const uint8_t*>(w), ldb, M, N,
      Kb, static_cast<const float*>(w_scale), s_x, static_cast<const float*>(bias),
      static_cast<OutT*>(out), ldc, hw, m_base);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

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

// a (M, K) int8, w (N, K) int8, K a multiple of 32, row strides lda, ldb in
// bytes (multiples of 16). w_scale (N,) float32 or null (then no scaling),
// bias (N,) float32 or null. out_kind 0 float32, 1 bfloat16, 2 the raw
// int32 accumulators. hw > 0: out is NCHW and rows are m_base + m.
extern "C" int s2m2_int8_gemm(const void* a, long long lda, const void* w,
                              long long ldb, long long M, int N, int K,
                              const void* w_scale, float s_x, const void* bias, void* out,
                              long long ldc, long long hw, long long m_base, int out_kind,
                              void* stream) {
  if (M < 1 || N < 1 || K < 32 || K % 32 != 0 || lda % 16 != 0 || ldb % 16 != 0 ||
      !aligned16(a) || !aligned16(w))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_kind == 0)
    return launch_gemm<int, float>(a, lda, w, ldb, M, N, K, w_scale, s_x, bias, out, ldc,
                                   hw, m_base, s);
  if (out_kind == 1)
    return launch_gemm<int, __nv_bfloat16>(a, lda, w, ldb, M, N, K, w_scale, s_x, bias,
                                           out, ldc, hw, m_base, s);
  if (out_kind == 2)
    return launch_gemm<int, int>(a, lda, w, ldb, M, N, K, nullptr, 0.f, nullptr, out,
                                 ldc, hw, m_base, s);
  return cudaErrorInvalidValue;
}

// a (M, K) bf16, w (N, K) bf16, K a multiple of 16, row strides in
// elements (multiples of 8): out (M, N) = a w^T with float32 accumulation,
// out_kind 0 float32, 1 bfloat16.
extern "C" int s2m2_bf16_gemm(const void* a, long long lda, const void* w, long long ldb,
                              long long M, int N, int K, void* out, long long ldc,
                              int out_kind, void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16 != 0 || lda % 8 != 0 || ldb % 8 != 0 ||
      !aligned16(a) || !aligned16(w))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_kind == 0)
    return launch_gemm<float, float>(a, lda * 2, w, ldb * 2, M, N, K * 2, nullptr, 0.f,
                                     nullptr, out, ldc, 0, 0, s);
  if (out_kind == 1)
    return launch_gemm<float, __nv_bfloat16>(a, lda * 2, w, ldb * 2, M, N, K * 2,
                                             nullptr, 0.f, nullptr, out, ldc, 0, 0, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* s2m2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
