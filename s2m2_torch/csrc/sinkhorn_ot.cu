// Fused per-row correlation + masking + dustbin Sinkhorn for Hopper
// (sm_90a): kernel C.
//
// Replaces s2m2_tpu/ops/sinkhorn.py: fused_correlation_ot (_kernel). For
// one epipolar row of f0, f1 (W, C): cv = f0 f1^T accumulated in float32;
// -1e4 where j > i under positivity; a zero dustbin row and column; log
// marginals -log 2W for pixels and log 1/2 for the dustbin; ot_iter
// Sinkhorn iterations (v over rows, then u over columns, each a max-shifted
// log-sum-exp with the sum clamped at 1e-30); prob = exp(. + log 2W) on
// [:W, :W], zeroed again where j > i. cv (unmasked) and prob are written
// in the input dtype; the Sinkhorn runs on the float32 accumulator.
//
// What bounds it: one read of f0 and f1 and one write of cv and prob (0.040
// ms at S bf16 1216x1024, 256 rows of W = 304) against 2*ot_iter sweeps and
// a final pass over the float32 (W+1)^2 row, an exponential per unmasked
// entry each (84 M at 1216x1024 under positivity: 0.020 ms of the SMs'
// 16-a-clock exponential units). The row is 372 KB at W = 304: more than
// one block's 227 KB of shared memory, so the first version of this kernel
// kept it in a global workspace that every sweep re-read from HBM. Here it stays on chip, and
// what bounds the kernel is instruction issue in the sweeps (a precise
// expf is 8 instructions) and the operand stream of the correlation.
//
// Two routes, chosen by the wrapper's `plan(W, C, dtype, positivity)`:
//
// Resident (every W whose row fits a cluster of at most 8 CTAs, W <= 608):
//  - A thread-block cluster of k CTAs of 512 threads (k in 1, 2, 4, 8: the
//    smallest that holds the row; at W = 304, 2 in bf16 and 4 in float32)
//    owns one row. CTA q holds the rows i = q + k*r of the float32 W x W
//    block in its shared memory (the slab), so the k slabs hold the whole
//    row and no workspace exists. Interleaved rows give every CTA the same
//    share of the lower triangle under positivity. The dustbin row and
//    column are zeros and are not stored: their terms enter the
//    log-sum-exps analytically (u_W for the dustbin row, v_W for the
//    dustbin column).
//  - The correlation runs straight into the slab, in passes over column
//    ranges. bf16: mma.sync m16n8k16 on the tensor cores, fragments by
//    ldmatrix, every warp two 32 x 32 tiles a pass. float32: sequential
//    FFMA over k, a thread 5 x 5 outputs: the check holds the kernel to the
//    plain version (cuBLAS's float32 product, whose error against float64
//    reaches 1.05e-4 at C = 384), and split TF32, though closer to float64
//    (3.8e-5), differed from it by up to 2.1e-4 relative in prob. The
//    operands come k-chunk by k-chunk (32 or 64 bytes of every row) through
//    a ring of up to 6 stages, dense rows in the TMA swizzle of their width:
//    by TMA (f0's slab rows as one box of a 4D map (C, k, W/k, rows), f1's
//    rows as boxes of a 3D map) where W % k == 0 and rows are 16-byte
//    multiples, by cp.async into the same layout elsewhere, element copies
//    where rows are not 16-byte multiples. The unmasked accumulators go to
//    the slab; one pass then writes cv from it in the input dtype, 16 bytes
//    a lane, and masks the slab in place (-1e4 where j > i).
//  - Column sweeps (v): items of 16 rows x 32 columns, a lane per column
//    with the values in registers: the max, then the sum of expf(x - max),
//    one exponential per entry. The items' (max, sum) pairs merge per
//    column into one partial, written to this CTA's shared memory (two
//    buffers, alternating by iteration, so one cluster barrier a sweep
//    suffices). After barrier.cluster arrive.release / wait.acquire every
//    CTA reads all k partials of every column through distributed shared
//    memory (mapa + ld.shared::cluster), in rank order, adds the dustbin
//    row's term and computes all of v, redundantly and bit-identically.
//  - Row sweeps (u) are local: items of 16 rows x 32 columns, a lane per
//    row and 16-column chunk reading float4s (slab pitch P % 8 == 4 puts 8
//    rows' float4s in distinct banks), then 8 lanes a row merge its chunks
//    and the dustbin column's term. One warp computes the dustbin row's u_W.
//  - Final pass: prob = exp(((s + u_i) + v_j) + log 2W), 4 columns a lane.
//    No CTA leaves before its peers have read its last partials: the last
//    sweep's reads are followed by a cluster arrive, the kernel ends with
//    the wait.
//  - Skipped under positivity, without changing any sum: items wholly
//    above the diagonal (j > i), and past a row's diagonal in the final
//    pass. Such an entry is -1e4 + u_i (or + v_j); the dustbin entry of the
//    same row or column is larger by about 1e4 less the spread of u and v,
//    which stay of the order of |cv| (at most C for layer-normed features,
//    384 at XL), so the entry is never the max and its expf(x - max) is
//    exactly 0 in float32 (expf reaches 0 below about -104). The masked
//    entries inside the items that cross the diagonal are swept as stored
//    (-1e4) and add exactly 0. With use_positivity off every entry is
//    swept. The correlation is never skipped: cv is returned unmasked.
//  - Precise expf and logf throughout (no fast math): the float32 prob
//    bound is 1e-6 + 1e-4 |ref|. Masks select expf's argument (-inf), never
//    its result: a select of the result compiles to a branch around each
//    expf, which serializes them.
//
// Streamed (wider rows, which no cluster can hold): the first version of
// this kernel, kept as it was: one 256-thread block per row, a SIMT correlation in 64 x 64
// tiles, the masked (W+1)^2 row in a global workspace the caller
// allocates, online log-sum-exps.
//
// Launch: cudaLaunchKernelEx with the cluster dimension attribute, after
// cudaFuncAttributeMaxDynamicSharedMemorySize; before a plan's first launch
// cudaOccupancyMaxActiveClusters must be > 0, or the entry point returns an
// error and the wrapper raises. The entry point recomputes the plan's
// shared-memory layout and refuses a plan that does not match it. A build
// with -DS2M2_C_TRACE=1 adds clock64 sums per stage (chip_probe.py ot
// --trace).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

#include "hopper.cuh"  // mbarrier, TMA and cp.async helpers; encoder()

namespace {

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ================================================================ streamed
// The first version, unchanged: the masked row in a global workspace.

namespace streamed {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int TILE = 64;  // correlation output tile
constexpr int KC = 32;    // channels per staged chunk

// running (max, sum of exp(x - max)) pairs
__device__ __forceinline__ void lse_add(float& m, float& s, float x) {
  if (x > m) {
    s = s * expf(m - x) + 1.f;
    m = x;
  } else {
    s += expf(x - m);
  }
}

__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    s = s2;
    return;
  }
  const float mx = fmaxf(m, m2);
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

__device__ __forceinline__ float lse_value(float m, float s) {
  return m + logf(fmaxf(s, 1e-30f));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
corr_ot_kernel(const T* __restrict__ f0, const T* __restrict__ f1, T* __restrict__ cv_out,
               T* __restrict__ prob_out, float* __restrict__ work, int W, int C,
               int ot_iter, int positivity) {
  __shared__ float sA[TILE][KC + 1];
  __shared__ float sB[TILE][KC + 1];
  __shared__ float red_m[NWARPS][32];
  __shared__ float red_s[NWARPS][32];
  extern __shared__ float uv[];  // u[W+1], v[W+1]

  const int L = W + 1;
  float* u = uv;
  float* v = uv + L;
  const size_t row = blockIdx.x;
  const T* a = f0 + row * W * C;
  const T* b = f1 + row * W * C;
  T* cvr = cv_out + row * W * W;
  T* pr = prob_out + row * W * W;
  float* S = work + row * L * L;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // 1. correlation, masked into the workspace
  for (int i0 = 0; i0 < W; i0 += TILE) {
    for (int j0 = 0; j0 < W; j0 += TILE) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int c0 = 0; c0 < C; c0 += KC) {
        __syncthreads();
        for (int idx = tid; idx < TILE * KC; idx += THREADS) {
          const int r = idx / KC;
          const int c = idx % KC;
          const int ci = c0 + c;
          sA[r][c] = (i0 + r < W && ci < C) ? load_f(a + (size_t)(i0 + r) * C + ci) : 0.f;
          sB[r][c] = (j0 + r < W && ci < C) ? load_f(b + (size_t)(j0 + r) * C + ci) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int c = 0; c < KC; ++c) {
          float x[4], y[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) x[i] = sA[ty + 16 * i][c];
#pragma unroll
          for (int j = 0; j < 4; ++j) y[j] = sB[tx + 16 * j][c];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ii = i0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int jj = j0 + tx + 16 * j;
          if (ii < W && jj < W) {
            store_f(cvr + (size_t)ii * W + jj, acc[i][j]);
            S[(size_t)ii * L + jj] = (positivity && jj > ii) ? -1e4f : acc[i][j];
          }
        }
      }
    }
  }
  // dustbin row and column of zeros; u starts at 0
  for (int t = tid; t < L; t += THREADS) {
    S[(size_t)W * L + t] = 0.f;
    S[(size_t)t * L + W] = 0.f;
    u[t] = 0.f;
  }
  __syncthreads();

  const float log_pix = -logf(2.f * W);
  const float log_bin = logf(0.5f);
  for (int it = 0; it < ot_iter; ++it) {
    // v_j = log_nu_j - lse_i(S[i, j] + u_i)
    for (int j0 = 0; j0 < L; j0 += 32) {
      const int j = j0 + lane;
      float m = -INFINITY, s = 0.f;
      if (j < L)
        for (int i = warp; i < L; i += NWARPS) lse_add(m, s, S[(size_t)i * L + j] + u[i]);
      red_m[warp][lane] = m;
      red_s[warp][lane] = s;
      __syncthreads();
      if (warp == 0 && j < L) {
        for (int w2 = 1; w2 < NWARPS; ++w2) lse_merge(m, s, red_m[w2][lane], red_s[w2][lane]);
        v[j] = (j == W ? log_bin : log_pix) - lse_value(m, s);
      }
      __syncthreads();
    }
    // u_i = log_mu_i - lse_j(S[i, j] + v_j)
    for (int i = warp; i < L; i += NWARPS) {
      float m = -INFINITY, s = 0.f;
      for (int j = lane; j < L; j += 32) lse_add(m, s, S[(size_t)i * L + j] + v[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
        const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
        lse_merge(m, s, m2, s2);
      }
      if (lane == 0) u[i] = (i == W ? log_bin : log_pix) - lse_value(m, s);
    }
    __syncthreads();
  }

  // 3. probabilities on [:W, :W]
  const float log2w = logf(2.f * W);
  for (int i = warp; i < W; i += NWARPS) {
    const float ui = u[i];
    for (int j = lane; j < W; j += 32) {
      const float p = (positivity && j > i)
                          ? 0.f
                          : expf(S[(size_t)i * L + j] + ui + v[j] + log2w);
      store_f(pr + (size_t)i * W + j, p);
    }
  }
}

template <typename T>
cudaError_t launch(const void* f0, const void* f1, void* cv, void* prob, float* work,
                   int rows, int W, int C, int ot_iter, int positivity,
                   cudaStream_t stream) {
  const size_t smem = 2 * (size_t)(W + 1) * sizeof(float);
  corr_ot_kernel<T><<<rows, THREADS, smem, stream>>>(
      static_cast<const T*>(f0), static_cast<const T*>(f1), static_cast<T*>(cv),
      static_cast<T*>(prob), work, W, C, ot_iter, positivity);
  return cudaGetLastError();
}

}  // namespace streamed

// ================================================================ resident

namespace resident {

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int JW = 2;           // bf16: 32 x 32 correlation tiles a warp owns per pass
constexpr int FR = 5;           // float32: a thread's rows (warp + 16 a) ...
constexpr int FC = 5;           // ... and columns (lane + 32 b) of a pass
constexpr int FFMA_ROWS = 16 * FR;
constexpr int RG = 16;          // slab rows per column-sweep item
constexpr int GMAX = 10;        // column-sweep row groups per CTA
constexpr int MAX_STAGES = 6;
constexpr int SMEM_LIMIT = 232448;
static_assert(FR * FC <= JW * 64 && NWARPS == 16, "float32 tiles reuse the bf16 accumulators");

// The shared-memory layout of one CTA, in bytes from the dynamic base; the
// wrapper's `_resident_smem` (ops/sinkhorn.py) computes the same total.
struct Layout {
  int R;       // slab rows (rows of the W x W block per CTA, the largest share)
  int MT;      // 16-row groups of the slab (correlation m-tiles, column items)
  int P;       // slab row pitch in floats: >= W, P % 8 == 4, so that 8 lanes
               // reading float4s of 8 consecutive rows hit distinct banks
  int VN;      // floats of v and of each column-partial buffer
  int NC;      // 16-column chunks of a row (row-sweep items)
  int NCP;     // row-partial pitch: NC made odd
  int R32;     // rows of the row sweeps' partials: R rounded up to 32
  int stage;   // bytes of one staging stage: 16 MT + np rows of kb bytes
  int slab, v, u, cpart, misc, uni, total;
};

__host__ __device__ inline Layout make_layout(int W, int k, int np, int stages, int kb) {
  Layout L;
  L.R = cdiv(W, k);
  L.MT = cdiv(L.R, 16);
  L.P = W + ((4 - W % 8) % 8 + 8) % 8;
  L.VN = cdiv(W + 1, 4) * 4;
  L.NC = cdiv(W, 16);
  L.NCP = L.NC | 1;
  L.R32 = 32 * cdiv(L.R, 32);
  L.stage = (16 * L.MT + np) * kb;
  L.slab = 0;
  L.v = L.slab + L.R * L.P * 4;
  L.u = L.v + L.VN * 4;
  L.cpart = L.u + 16 * L.MT * 4;
  L.misc = L.cpart + 2 * L.VN * 8;  // u_W, then the stages' mbarriers
  L.uni = L.misc + 16 + 8 * MAX_STAGES;
  // one region, used in turn by the staging stages (1024-aligned for the
  // swizzle, hence the slack), the column items' and the row items'
  // (max, sum) partials
  const int staging = stages * L.stage;
  const int col_items = 2 * L.MT * L.VN * 4;
  const int row_items = 2 * L.R32 * L.NCP * 4;
  int region = staging > col_items ? staging : col_items;
  region = region > row_items ? region : row_items;
  L.total = L.uni + 1024 + region;
  return L;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// all but the newest n groups landed (n < MAX_STAGES - 1)
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    default: cp_async_wait<4>(); break;
  }
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// c += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the float2 at this CTA's shared address `p`, read from CTA `rank` of the cluster
__device__ __forceinline__ float2 ld_cluster_f2(const float2* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  float2 x;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(x.x), "=f"(x.y)
               : "r"(remote));
  return x;
}

#ifdef S2M2_C_TRACE
// measurement build only (-DS2M2_C_TRACE=1): thread 0 of every CTA adds the
// clock64 cycles of each stage to these sums; s2m2_ot_trace reads them
__device__ unsigned long long c_trace[16];
#define C_TRACE_INIT unsigned long long c_t_last = clock64()
#define C_TRACE(slot)                                          \
  do {                                                         \
    if (threadIdx.x == 0) {                                    \
      const unsigned long long now = clock64();                \
      atomicAdd(&c_trace[slot], now - c_t_last);               \
      c_t_last = now;                                          \
    }                                                          \
  } while (0)
#else
#define C_TRACE_INIT
#define C_TRACE(slot) \
  do {                \
  } while (0)
#endif

// float <-> int with the same order, so a warp's max is one redux.sync
__device__ __forceinline__ int ordered(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int o) {
  return __int_as_float(o >= 0 ? o : o ^ 0x7fffffff);
}
__device__ __forceinline__ float warp_max(float x) {
  return unordered(__reduce_max_sync(0xffffffffu, ordered(x)));
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ void store_f4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store_f4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 w;
  w.x = *reinterpret_cast<const uint32_t*>(&lo);
  w.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = w;
}

// The staged operands: rows of kb bytes, dense, their 16-byte units in the
// TMA swizzle of that row width (SWIZZLE_64B: unit ^ bits 1-2 of the row;
// SWIZZLE_32B: unit ^ bit 2), so that ldmatrix's and the float4 loads' 8
// rows land in distinct banks. A stage starts 1024-aligned.
__device__ __forceinline__ int swz(int row, int kb) {
  return kb == 64 ? (row >> 1) & 3 : (row >> 2) & 1;
}

// v_j for j <= W from the K CTAs' (max, sum) partials of column j, read
// through distributed shared memory in rank order (so every CTA computes
// the same v), and the dustbin row's term (s = 0, u_W)
template <int K>
__device__ __forceinline__ void merge_columns(float* v, const float2* cp, float ub, int W,
                                              float log_pix, float log_bin) {
  for (int j = threadIdx.x; j <= W; j += THREADS) {
    float2 part[K];
#pragma unroll
    for (int qq = 0; qq < K; ++qq) part[qq] = ld_cluster_f2(cp + j, qq);
    float m = ub;
#pragma unroll
    for (int qq = 0; qq < K; ++qq) m = fmaxf(m, part[qq].x);
    float s = expf(ub - m);  // m is finite: it is at least u_W
#pragma unroll
    for (int qq = 0; qq < K; ++qq) s += part[qq].y * expf(part[qq].x - m);  // -inf: 0 * 0
    v[j] = (j == W ? log_bin : log_pix) - (m + logf(fmaxf(s, 1e-30f)));
  }
}

// Stages chunk `c` (kb bytes of every row) by cp.async: the 16 MT slab rows
// of f0 (rows q + k r) then `np` rows of f1 from column n0; 16-byte copies
// zero past C or past the rows, element copies when `vec` is off.
template <typename T>
__device__ __forceinline__ void load_chunk(unsigned char* st, const T* a_src, const T* b_src,
                                           int c, int MR, int np, int n0, int Rq, int q,
                                           int k, int W, int C, int kb, bool vec) {
  constexpr int EL = 16 / static_cast<int>(sizeof(T));  // elements per 16 bytes
  const int pieces = kb / 16;
  const int e_base = c * (kb / static_cast<int>(sizeof(T)));
  for (int idx = threadIdx.x; idx < (MR + np) * pieces; idx += THREADS) {
    const int rr = idx / pieces;
    const int pc = idx % pieces;
    const int e0 = e_base + pc * EL;
    const T* src;
    bool ok;
    if (rr < MR) {
      ok = rr < Rq;
      src = a_src + (size_t)(q + k * rr) * C + e0;
    } else {
      ok = n0 + rr - MR < W;
      src = b_src + (size_t)(n0 + rr - MR) * C + e0;
    }
    unsigned char* dst = st + rr * kb + ((pc ^ swz(rr, kb)) << 4);
    if (vec) {
      const bool in = ok && e0 < C;
      cp_async16(dst, in ? static_cast<const void*>(src) : a_src, in);
    } else {
      T* d = reinterpret_cast<T*>(dst);
#pragma unroll
      for (int e = 0; e < EL; ++e) d[e] = (ok && e0 + e < C) ? src[e] : T(0.f);
    }
  }
}

// Stages chunk `c` by TMA (one thread): f0's slab rows as one box of a 4D
// map (C, k, W/k, rows of the batch), f1's rows n0.. as boxes of `nbox`
// rows of a 3D map (C, W, rows); rows past W arrive as zeros.
template <typename T>
__device__ __forceinline__ void issue_chunk(unsigned char* st, uint64_t* bar,
                                            const CUtensorMap* ma, const CUtensorMap* mb,
                                            int c, int MR, int np, int nbox, int n0, int q,
                                            int row, int kb) {
  const int e0 = c * (kb / static_cast<int>(sizeof(T)));
  mbar_expect_tx(bar, (MR + np) * kb);
  tma_load_4d(st, ma, bar, e0, q, 0, row);
  for (int b0 = 0; b0 < np; b0 += nbox) tma_load_3d(st + (MR + b0) * kb, mb, bar, e0, n0 + b0, row);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
corr_ot_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
               const T* __restrict__ f0, const T* __restrict__ f1, T* __restrict__ cv_out,
               T* __restrict__ prob_out, int W, int C, int ot_iter, int positivity, int k,
               int np, int stages, int kb, int vec, int tma, int nbox) {
  constexpr bool BF16 = sizeof(T) == 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  const Layout L = make_layout(W, k, np, stages, kb);
  float* slab = reinterpret_cast<float*>(smem + L.slab);
  float* v = reinterpret_cast<float*>(smem + L.v);
  float* u = reinterpret_cast<float*>(smem + L.u);
  float2* cpart = reinterpret_cast<float2*>(smem + L.cpart);
  float* u_bin = reinterpret_cast<float*>(smem + L.misc);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.misc + 16);
  const uint32_t base = smem_u32(smem);
  unsigned char* uni = smem + (((base + L.uni + 1023) & ~1023u) - base);

  const int q = static_cast<int>(cluster_rank());
  const int row = blockIdx.x / k;
  const int Rq = (W - q + k - 1) / k;  // slab rows i = q + k*r < W
  const int P = L.P;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool pos = positivity != 0;

  C_TRACE_INIT;
  // u past this CTA's rows is -inf: the column items read u by float4s
  for (int r = tid; r < 16 * L.MT; r += THREADS) u[r] = r < Rq ? 0.f : -INFINITY;
  if (tid == 0) {
    *u_bin = 0.f;
    for (int s = 0; s < MAX_STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // ---------------------------------------------------------- correlation
  {
    const T* a_src = f0 + (size_t)row * W * C;
    const T* b_src = f1 + (size_t)row * W * C;
    const int MR = 16 * L.MT;
    const int nchunks = cdiv(C, kb / static_cast<int>(sizeof(T)));
    const int passes = cdiv(W, np);
    // ldmatrix: this lane's row within a 16-row tile and 16-byte unit within
    // a 32-byte k-step, for A and (two n8 fragments of) B; the swizzle of a
    // row depends only on its low bits, which tiles of 16 rows keep
    const int a_r = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int b_r = (lane & 7) + (lane >> 4) * 8;
    int a_x[2], b_x[2];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      a_x[ks] = ((2 * ks + (lane >> 4)) ^ swz(a_r, kb)) << 4;
      b_x[ks] = ((2 * ks + ((lane >> 3) & 1)) ^ swz(b_r, kb)) << 4;
    }
    const int fa_sw = swz(warp, kb), fb_sw = swz(lane, kb);  // float32 rows' swizzle
    for (int pass = 0; pass < passes; ++pass) {
      const int n0 = pass * np;
      const int ncols = min(np, W - n0);
      const int g0 = pass * nchunks;  // chunks staged before this pass
      // bf16: 32 x 32 tiles (jobs: two 16-row m-tiles x four n8 fragments)
      // on mma.sync, every warp JW of them, the surplus and the tiles past
      // the rows or columns repeating the last (not stored) so that no load
      // waits behind a branch. float32: a thread's 5 x 5 outputs, rows
      // warp + 16 a, columns lane + 32 b, by sequential FFMA over k.
      const int nbp = cdiv(ncols, 16);  // 16-column blocks of this pass
      const int nb2 = cdiv(nbp, 2);
      const int njobs = cdiv(L.MT, 2) * nb2;
      int a_off[JW][2], b_off[JW][2], fa_off[FR], fb_off[FC];
      if constexpr (BF16) {
#pragma unroll
        for (int jj = 0; jj < JW; ++jj) {
          const int jb = min(warp + NWARPS * jj, njobs - 1);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            a_off[jj][h] = (min(2 * (jb / nb2) + h, L.MT - 1) * 16 + a_r) * kb;
            b_off[jj][h] = (MR + min(2 * (jb % nb2) + h, nbp - 1) * 16 + b_r) * kb;
          }
        }
      } else {
#pragma unroll
        for (int a = 0; a < FR; ++a) fa_off[a] = min(warp + 16 * a, MR - 1) * kb;
#pragma unroll
        for (int b = 0; b < FC; ++b) fb_off[b] = (MR + min(lane + 32 * b, np - 1)) * kb;
      }
      float acc[JW][2][4][4];  // [job][m-tile][n8 fragment][accumulator]
#pragma unroll
      for (int jj = 0; jj < JW; ++jj)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int f = 0; f < 4; ++f)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[jj][mi][f][e] = 0.f;

      auto fetch = [&](int c) {
        const int s = (g0 + c) % stages;
        if (tma) {
          if (tid == 0)
            issue_chunk<T>(uni + s * L.stage, &full[s], &ma, &mb, c, MR, np, nbox, n0, q, row,
                           kb);
        } else {
          load_chunk(uni + s * L.stage, a_src, b_src, c, MR, np, n0, Rq, q, k, W, C, kb,
                     vec != 0);
        }
      };
      for (int s = 0; s < stages - 1; ++s) {
        if (s < nchunks) fetch(s);
        if (!tma) cp_async_commit();
      }
      for (int c = 0; c < nchunks; ++c) {
        if (!tma) cp_async_wait_dyn(stages - 2);
        __syncthreads();  // every warp is done with the stage refilled next
        if (c + stages - 1 < nchunks) fetch(c + stages - 1);
        if (!tma) cp_async_commit();
        const int s = (g0 + c) % stages;
        if (tma) mbar_wait(&full[s], ((g0 + c) / stages) & 1);
        const unsigned char* st = uni + s * L.stage;
        if constexpr (BF16) {
          for (int ks = 0; ks < kb / 32; ++ks) {
#pragma unroll
            for (int jj = 0; jj < JW; ++jj) {
              uint32_t a[2][4], b[2][4];
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                ldmatrix_x4(a[h], st + a_off[jj][h] + a_x[ks]);
                ldmatrix_x4(b[h], st + b_off[jj][h] + b_x[ks]);
              }
#pragma unroll
              for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int f = 0; f < 4; ++f)
                  mma_bf16(acc[jj][mi][f], a[mi], b[f / 2][2 * (f % 2)], b[f / 2][2 * (f % 2) + 1]);
            }
          }
        } else {
          // acc viewed as [FR][FC]: acc[a][b] = flat index a * FC + b
          float* fa = &acc[0][0][0][0];
          for (int kq = 0; kq < kb / 16; ++kq) {
            float4 av[FR], bv[FC];
#pragma unroll
            for (int a = 0; a < FR; ++a)
              av[a] = *reinterpret_cast<const float4*>(st + fa_off[a] + ((kq ^ fa_sw) << 4));
#pragma unroll
            for (int b = 0; b < FC; ++b)
              bv[b] = *reinterpret_cast<const float4*>(st + fb_off[b] + ((kq ^ fb_sw) << 4));
            // k in order, one fmaf each: the plain version's (cuBLAS's) sum
#pragma unroll
            for (int a = 0; a < FR; ++a)
#pragma unroll
              for (int b = 0; b < FC; ++b) {
                float& o = fa[a * FC + b];
                o = fmaf(av[a].x, bv[b].x, o);
                o = fmaf(av[a].y, bv[b].y, o);
                o = fmaf(av[a].z, bv[b].z, o);
                o = fmaf(av[a].w, bv[b].w, o);
              }
          }
        }
      }
      if (!tma) cp_async_wait<0>();
      __syncthreads();  // the stages are free for the next pass (or the sweeps)
      C_TRACE(8);

      // epilogue: the unmasked float32 correlation into the slab
      if constexpr (BF16) {
        const int g = lane >> 2;
        const int t4 = lane & 3;
#pragma unroll
        for (int jj = 0; jj < JW; ++jj) {
          const int jb = warp + NWARPS * jj;
          if (jb >= njobs) continue;
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
            for (int f = 0; f < 4; ++f) {
              const int nb = 2 * (jb % nb2) + f / 2;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = (2 * (jb / nb2) + mi) * 16 + g + 8 * h;
                const int j = n0 + nb * 16 + (f % 2) * 8 + 2 * t4;
                // column W of the slab (W odd) is padding, never read; r <
                // Rq also drops the m-tile past the last
                if (r < Rq && nb < nbp && j < W)
                  *reinterpret_cast<float2*>(slab + r * P + j) =
                      make_float2(acc[jj][mi][f][2 * h], acc[jj][mi][f][2 * h + 1]);
              }
            }
          }
        }
      } else {
        const float* fa = &acc[0][0][0][0];
#pragma unroll
        for (int a = 0; a < FR; ++a) {
          const int r = warp + 16 * a;
          if (r >= Rq) continue;
#pragma unroll
          for (int b = 0; b < FC; ++b) {
            const int j = n0 + lane + 32 * b;
            if (j < n0 + ncols) slab[r * P + j] = fa[a * FC + b];
          }
        }
      }
    }
  }
  __syncthreads();
  // cv (unmasked) from the slab to global memory, a row a warp, 16 bytes a
  // lane; then the slab masked in place (-1e4 where j > i)
  {
    T* cvr = cv_out + (size_t)row * W * W;
    for (int r = warp; r < Rq; r += NWARPS) {
      const int i = q + k * r;
      float* srow = slab + r * P;
      T* dst = cvr + (size_t)i * W;
      if ((W & 3) == 0) {
        for (int j = 4 * lane; j < W; j += 128) {
          float4 x = *reinterpret_cast<const float4*>(srow + j);
          store_f4(dst + j, x);
          if (pos && j + 3 > i) {
            x.x = j > i ? -1e4f : x.x;
            x.y = j + 1 > i ? -1e4f : x.y;
            x.z = j + 2 > i ? -1e4f : x.z;
            x.w = -1e4f;
            *reinterpret_cast<float4*>(srow + j) = x;
          }
        }
      } else {
        for (int j = lane; j < W; j += 32) {
          store_f(dst + j, srow[j]);
          if (pos && j > i) srow[j] = -1e4f;
        }
      }
    }
  }
  __syncthreads();
  C_TRACE(0);

  // ---------------------------------------------------------- Sinkhorn
  const float log_pix = -logf(2.f * W);
  const float log_bin = logf(0.5f);
  const int nct = cdiv(W, 32);
  const int G = cdiv(Rq, RG);
  // column tiles of item row group g: [0, ctn(g)); under positivity only the
  // tiles that reach the group's last row i (32 ct <= i)
  auto ctn = [&](int gi) {
    if (!pos) return nct;
    const int last = q + k * (min(Rq, RG * gi + RG) - 1);
    return min(nct, last / 32 + 1);
  };
  int nitems = 0;
  for (int gi = 0; gi < G; ++gi) nitems += ctn(gi);
  // row items: 16 rows (a lane each) x two 16-column chunks (a half-warp
  // each); under positivity only the 32 columns that reach the group's
  // last row
  const int RGR = cdiv(Rq, 16);
  const int NC2 = cdiv(L.NC, 2);
  auto ccn = [&](int rg) {
    if (!pos) return NC2;
    const int last = q + k * (min(Rq, 16 * rg + 16) - 1);
    return min(NC2, last / 32 + 1);
  };
  int nritems = 0;
  for (int rg = 0; rg < RGR; ++rg) nritems += ccn(rg);
  float* pm = reinterpret_cast<float*>(uni);  // column items: max, sum
  float* ps = pm + L.MT * L.VN;
  float* rpm = reinterpret_cast<float*>(uni);  // row items: max, sum
  float* rps = rpm + L.R32 * L.NCP;

  for (int it = 0; it < ot_iter; ++it) {
    float2* cp = cpart + (it & 1) * L.VN;
    // (a) column items: (max, sum of exp(x - max)) over 16 slab rows per
    // column; a lane per column, the rows' u by float4s (-inf past the rows)
    for (int n = warp; n <= nitems; n += NWARPS) {
      if (n == nitems) {  // the dustbin column: s = 0, so over this CTA's u
        float m = -INFINITY;
        for (int r = lane; r < Rq; r += 32) m = fmaxf(m, u[r]);
        m = warp_max(m);
        float s = 0.f;
        if (m > -INFINITY)
          for (int r = lane; r < Rq; r += 32) s += expf(u[r] - m);
        s = warp_sum(s);
        if (lane == 0) cp[W] = make_float2(m, s);
        continue;
      }
      int gi = 0, base_n = 0;
      while (n >= base_n + ctn(gi)) base_n += ctn(gi++);
      const int j = (n - base_n) * 32 + lane;
      const int jl = min(j, W - 1);
      const int r0 = RG * gi;
      const int nr = min(RG, Rq - r0);
      float ur[RG];
#pragma unroll
      for (int t = 0; t < RG; t += 4) {
        const float4 u4 = *reinterpret_cast<const float4*>(u + r0 + t);
        ur[t] = u4.x;
        ur[t + 1] = u4.y;
        ur[t + 2] = u4.z;
        ur[t + 3] = u4.w;
      }
      float x[RG];
#pragma unroll
      for (int t = 0; t < RG; ++t) x[t] = slab[(r0 + min(t, nr - 1)) * P + jl] + ur[t];
      float m = x[0];
#pragma unroll
      for (int t = 1; t < RG; ++t) m = fmaxf(m, x[t]);
      // the masks select expf's argument (expf(-inf) = 0), not its result:
      // a select of the result compiles to a branch around each expf,
      // which serializes them
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < RG; ++t) s += expf(t < nr ? x[t] - m : -INFINITY);
      if (j < W) {
        pm[gi * L.VN + j] = m;
        ps[gi * L.VN + j] = s;
      }
    }
    __syncthreads();
    C_TRACE(1);
    // (b) this CTA's partial per column, over its active item groups
    for (int j = tid; j < W; j += THREADS) {
      const int ct = j / 32;
      float mg[GMAX], sg[GMAX];
      float m = -INFINITY;
#pragma unroll
      for (int gi = 0; gi < GMAX; ++gi) {
        const int gc = max(0, min(gi, G - 1));
        const bool on = gi < G && ct < ctn(gi);
        mg[gi] = on ? pm[gc * L.VN + j] : -INFINITY;
        sg[gi] = on ? ps[gc * L.VN + j] : 0.f;
        m = fmaxf(m, mg[gi]);
      }
      const float ms = m > -INFINITY ? m : 0.f;  // no group: s = 0
      float s = 0.f;
#pragma unroll
      for (int gi = 0; gi < GMAX; ++gi) s += sg[gi] * expf(mg[gi] - ms);
      cp[j] = make_float2(m, s);
    }
    C_TRACE(2);
    cluster_arrive();
    cluster_wait();
    C_TRACE(3);
    // (c) v from every CTA's partials and the dustbin row's term (s = 0, u_W)
    switch (k) {
      case 1: merge_columns<1>(v, cp, *u_bin, W, log_pix, log_bin); break;
      case 2: merge_columns<2>(v, cp, *u_bin, W, log_pix, log_bin); break;
      case 4: merge_columns<4>(v, cp, *u_bin, W, log_pix, log_bin); break;
      default: merge_columns<8>(v, cp, *u_bin, W, log_pix, log_bin); break;
    }
    // the last reads of the peers' shared memory are done: they may leave
    // once every CTA has passed this arrive (the wait ends the kernel)
    if (it == ot_iter - 1) cluster_arrive();
    __syncthreads();
    C_TRACE(4);
    // (d) row items: (max, sum of exp(x - max)) over 16 columns per slab
    // row and chunk, a lane per row reading float4s; columns past W are
    // -inf. Item n == nritems: the dustbin row (all zeros), u_W from v alone
    const float vb = v[W];
    for (int n = warp; n <= nritems; n += NWARPS) {
      if (n == nritems) {
        float m = -INFINITY;
        for (int j = lane; j <= W; j += 32) m = fmaxf(m, v[j]);
        m = warp_max(m);
        float s = 0.f;
        for (int j = lane; j <= W; j += 32) s += expf(v[j] - m);
        s = warp_sum(s);
        if (lane == 0) *u_bin = log_bin - (m + logf(fmaxf(s, 1e-30f)));
        continue;
      }
      int rg = 0, base_n = 0;
      while (n >= base_n + ccn(rg)) base_n += ccn(rg++);
      const int cc = 2 * (n - base_n) + (lane >> 4);
      const int r = 16 * rg + (lane & 15);
      const float* sp = slab + min(r, Rq - 1) * P + 16 * cc;
      float x[16];
#pragma unroll
      for (int e = 0; e < 16; e += 4) {
        const float4 s4 = *reinterpret_cast<const float4*>(sp + e);
        const float4 v4 = *reinterpret_cast<const float4*>(v + 16 * cc + e);
        x[e] = s4.x + v4.x;
        x[e + 1] = s4.y + v4.y;
        x[e + 2] = s4.z + v4.z;
        x[e + 3] = s4.w + v4.w;
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) x[e] = 16 * cc + e < W ? x[e] : -INFINITY;
      float m = x[0];
#pragma unroll
      for (int e = 1; e < 16; ++e) m = fmaxf(m, x[e]);
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) s += expf(x[e] - m);
      if (cc < L.NC) {
        rpm[r * L.NCP + cc] = m;
        rps[r * L.NCP + cc] = s;
      }
    }
    __syncthreads();
    // (e) u per slab row from its chunks' partials and the dustbin column
    // (s = 0, v_W): 8 lanes a row
    for (int r0 = 0; r0 < Rq; r0 += THREADS / 8) {
      const int r = r0 + tid / 8;
      const int sub = tid & 7;
      const bool on = r < Rq;
      const int rc = min(r, Rq - 1);
      const int i = q + k * rc;
      const int ncc = pos ? min(L.NC, i / 16 + 1) : L.NC;
      float m = vb;
      for (int cc = sub; cc < ncc; cc += 8) m = fmaxf(m, rpm[rc * L.NCP + cc]);
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float s = 0.f;
      for (int cc = sub; cc < ncc; cc += 8)
        s += rps[rc * L.NCP + cc] * expf(rpm[rc * L.NCP + cc] - m);
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (on && sub == 0) u[r] = log_pix - (m + logf(fmaxf(s + expf(vb - m), 1e-30f)));
    }
    __syncthreads();
    C_TRACE(5);
  }

  // ---------------------------------------------------------- probabilities
  // exp(((s + u_i) + v_j) + log 2W); the masked entries (-1e4) give exactly
  // 0, and the columns past the row's last quad that reaches j <= i are
  // written as zeros without an exponential
  const float log2w = logf(2.f * W);
  T* pr = prob_out + (size_t)row * W * W;
  for (int r = warp; r < Rq; r += NWARPS) {
    const int i = q + k * r;
    const float ui = u[r];
    const float* srow = slab + r * P;
    T* dst = pr + (size_t)i * W;
    if ((W & 3) == 0) {
      const int n4 = pos ? min(W, 4 * (i / 4) + 4) : W;
      for (int j = 4 * lane; j < n4; j += 128) {
        const float4 s4 = *reinterpret_cast<const float4*>(srow + j);
        const float4 v4 = *reinterpret_cast<const float4*>(v + j);
        float4 p;
        p.x = expf(((s4.x + ui) + v4.x) + log2w);
        p.y = expf(((s4.y + ui) + v4.y) + log2w);
        p.z = expf(((s4.z + ui) + v4.z) + log2w);
        p.w = expf(((s4.w + ui) + v4.w) + log2w);
        store_f4(dst + j, p);
      }
      for (int j = n4 + 4 * lane; j < W; j += 128) store_f4(dst + j, make_float4(0.f, 0.f, 0.f, 0.f));
    } else {
      const int n = pos ? i + 1 : W;
      for (int j = lane; j < n; j += 32) store_f(dst + j, expf(((srow[j] + ui) + v[j]) + log2w));
      for (int j = n + lane; j < W; j += 32) store_f(dst + j, 0.f);
    }
  }
  __syncthreads();
  C_TRACE(6);
  cluster_wait();
  C_TRACE(7);
#ifdef S2M2_C_TRACE
  if (threadIdx.x == 0) atomicAdd(&c_trace[15], 1ull);
#endif
}

// a plan whose attributes were set and whose clusters were found to fit
struct Checked {
  int dtype, k, smem, device;
};
std::mutex checked_mutex;
Checked checked[64];
int n_checked = 0;

// f0 or f1 (rows x W x C) as TMA maps: A, the slab rows q + k r of row b
// as box (chunk, 1, 16 MT, 1) of (C, k, W/k, rows); B, box (chunk, nbox,
// 1) of (C, W, rows). Both in the swizzle of `kb`-byte rows.
bool encode_maps(CUtensorMap* ma, CUtensorMap* mb, const void* f0, const void* f1, bool bf16,
                 int rows, int W, int C, int k, int MR, int nbox, int kb) {
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return false;
  const CUtensorMapDataType dt =
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t isz = bf16 ? 2 : 4;
  const CUtensorMapSwizzle sw =
      kb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint32_t chunk = static_cast<cuuint32_t>(kb / isz);
  const cuuint64_t da[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(k),
                            static_cast<cuuint64_t>(W / k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t sa[3] = {C * isz, static_cast<cuuint64_t>(k) * C * isz,
                            static_cast<cuuint64_t>(W) * C * isz};
  const cuuint32_t ba[4] = {chunk, 1, static_cast<cuuint32_t>(MR), 1};
  const cuuint32_t e4[4] = {1, 1, 1, 1};
  if (fn(ma, dt, 4, const_cast<void*>(f0), da, sa, ba, e4, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  const cuuint64_t db[3] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                            static_cast<cuuint64_t>(rows)};
  const cuuint64_t sb[2] = {C * isz, static_cast<cuuint64_t>(W) * C * isz};
  const cuuint32_t bb[3] = {chunk, static_cast<cuuint32_t>(nbox), 1};
  return fn(mb, dt, 3, const_cast<void*>(f1), db, sb, bb, e4, CU_TENSOR_MAP_INTERLEAVE_NONE,
            sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
cudaError_t launch(const void* f0, const void* f1, void* cv, void* prob, int rows, int W,
                   int C, int ot_iter, int positivity, int dtype, int k, int np, int stages,
                   int kb, int smem, cudaStream_t stream) {
  auto kern = corr_ot_kernel<T>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows * k);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> lock(checked_mutex);
    bool known = false;
    for (int i = 0; i < n_checked; ++i)
      known |= checked[i].dtype == dtype && checked[i].k == k && checked[i].smem == smem &&
               checked[i].device == device;
    if (!known) {
      // the same ceiling for every plan, so setting it never shrinks it
      // under a plan checked before
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_LIMIT);
      if (err != cudaSuccess) return err;
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
      if (err != cudaSuccess) return err;
      if (clusters < 1) return cudaErrorLaunchOutOfResources;
      if (n_checked < 64) checked[n_checked++] = {dtype, k, smem, device};
    }
  }
  const bool vec = (C * static_cast<int>(sizeof(T))) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(f0) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(f1) % 16 == 0;
  // TMA where the slab rows are a box of a strided map (W % k == 0) and
  // rows are 16-byte multiples; cp.async into the same layout elsewhere
  const bool tma = vec && W % k == 0;
  const int MR = 16 * cdiv(cdiv(W, k), 16);
  const int nbox = np <= 256 ? np : np / 2;
  CUtensorMap ma, mb;
  memset(&ma, 0, sizeof(ma));
  memset(&mb, 0, sizeof(mb));
  if (tma && !encode_maps(&ma, &mb, f0, f1, sizeof(T) == 2, rows, W, C, k, MR, nbox, kb))
    return cudaErrorInvalidValue;
  err = cudaLaunchKernelEx(&cfg, kern, ma, mb, static_cast<const T*>(f0),
                           static_cast<const T*>(f1), static_cast<T*>(cv), static_cast<T*>(prob),
                           W, C, ot_iter, positivity, k, np, stages, kb, int(vec), int(tma),
                           nbox);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the plan's parameters are ones this kernel was written for, and `smem`
// is its layout's size
bool valid_plan(int W, int k, int np, int stages, int kb, int smem, int dtype) {
  if (W < 1 || (k != 1 && k != 2 && k != 4 && k != 8)) return false;
  if (stages < 2 || stages > MAX_STAGES || (kb != 32 && kb != 64)) return false;
  if (np < 16 || np % 16 || np > 2 * 256) return false;
  const Layout L = make_layout(W, k, np, stages, kb);
  if (L.total != smem || smem > SMEM_LIMIT || L.MT > GMAX || 16 * L.MT > 256) return false;
  if (dtype == 0) return 16 * L.MT <= FFMA_ROWS && np <= 32 * FC;
  return cdiv(L.MT, 2) * cdiv(np / 16, 2) <= NWARPS * JW;
}

}  // namespace resident

}  // namespace

// f0, f1: (rows, W, C) contiguous; cv, prob: (rows, W, W) in the same dtype
// (0 float32, 1 bfloat16). route 0 (streamed): work is the (rows, W+1,
// W+1) float32 workspace; the plan arguments are ignored. route 1
// (resident): work is unused; a cluster of `cluster` CTAs per row, `cols`
// correlation columns a pass, `stages` staging stages of `chunk` bytes a
// row, `smem` dynamic shared bytes (the wrapper's plan). Returns the
// cudaError_t of the launch.
extern "C" int s2m2_fused_correlation_ot(const void* f0, const void* f1, void* cv,
                                         void* prob, void* work, int rows, int W, int C,
                                         int ot_iter, int positivity, int dtype, int route,
                                         int cluster, int cols, int stages, int chunk,
                                         int smem, void* stream) {
  if (rows < 1 || W < 1 || C < 1 || ot_iter < 1 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    // u and v (dynamic) and the ~19 KB of static tiles stay under the
    // default 48 KB of shared memory
    if (2 * (W + 1) * 4 > 24 * 1024 || work == nullptr) return cudaErrorInvalidValue;
    float* wk = static_cast<float*>(work);
    if (dtype == 0)
      return streamed::launch<float>(f0, f1, cv, prob, wk, rows, W, C, ot_iter, positivity, s);
    return streamed::launch<__nv_bfloat16>(f0, f1, cv, prob, wk, rows, W, C, ot_iter,
                                           positivity, s);
  }
  if (route != 1 || !resident::valid_plan(W, cluster, cols, stages, chunk, smem, dtype) ||
      (long long)rows * cluster > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return resident::launch<float>(f0, f1, cv, prob, rows, W, C, ot_iter, positivity, dtype,
                                   cluster, cols, stages, chunk, smem, s);
  return resident::launch<__nv_bfloat16>(f0, f1, cv, prob, rows, W, C, ot_iter, positivity,
                                         dtype, cluster, cols, stages, chunk, smem, s);
}

// clusters of `cluster` resident CTAs with `smem` shared bytes that fit on
// the current device at once (cudaOccupancyMaxActiveClusters), into *out
extern "C" int s2m2_ot_max_clusters(int dtype, int cluster, int smem, int* out) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 1024);
  cfg.blockDim = dim3(resident::THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  if (dtype == 0) {
    err = cudaFuncSetAttribute(resident::corr_ot_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               resident::SMEM_LIMIT);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(out, resident::corr_ot_kernel<float>, &cfg);
  } else {
    err = cudaFuncSetAttribute(resident::corr_ot_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               resident::SMEM_LIMIT);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(out, resident::corr_ot_kernel<__nv_bfloat16>,
                                           &cfg);
  }
  return err;
}

#ifdef S2M2_C_TRACE
// the trace build's cycle sums per stage (slot 15: CTAs), then zeroed
extern "C" int s2m2_ot_trace(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, resident::c_trace, sizeof(resident::c_trace));
  if (err != cudaSuccess) return err;
  static const unsigned long long zero[16] = {};
  return cudaMemcpyToSymbol(resident::c_trace, zero, sizeof(zero));
}
#endif

extern "C" const char* s2m2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
