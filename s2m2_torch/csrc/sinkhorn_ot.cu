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
// What bounds it: the (W+1)^2 float32 row (372 KB at W = 304, 1.48 MB at
// W = 608) does not fit in the 227 KB of shared memory a block may use,
// and the 2*ot_iter+1 sweeps over it each take an exp per element. So the
// kernel is bound by the exps and by re-reading the row, not by its one
// read of the features and one write of cv and prob. What the design does:
//  - one block of 256 threads per row (B*H blocks, 256 at S 1216x1024);
//  - the correlation runs as 64x64 output tiles over 32-channel chunks of
//    f0 and f1 staged in shared memory, each thread holding a 4x4 block;
//  - the masked float32 row, dustbin included, goes to a global workspace
//    (allocated by the caller) that the sweeps re-read; a row is written
//    and read by one block only, so it stays in L2 while the block runs;
//  - u and v live in shared memory;
//  - column sweeps: lanes over 32 consecutive columns (coalesced), warps
//    over interleaved rows, partial (max, sum) pairs merged in shared
//    memory; row sweeps: a warp per row, lanes over columns, merged with
//    shuffles;
//  - the log-sum-exps are online (one exp per element unless the running
//    max moves) so each sweep reads the row once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int TILE = 64;  // correlation output tile
constexpr int KC = 32;    // channels per staged chunk

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

}  // namespace

// f0, f1: (rows, W, C) contiguous; cv, prob: (rows, W, W) in the same
// dtype (0 float32, 1 bfloat16); work: (rows, W+1, W+1) float32 scratch.
// Returns the cudaError_t of the launch.
extern "C" int s2m2_fused_correlation_ot(const void* f0, const void* f1, void* cv,
                                         void* prob, void* work, int rows, int W, int C,
                                         int ot_iter, int positivity, int dtype,
                                         void* stream) {
  // u and v (dynamic) and the ~19 KB of static tiles stay under the default
  // 48 KB of shared memory
  if (rows < 1 || W < 1 || C < 1 || ot_iter < 1 || 2 * (W + 1) * 4 > 24 * 1024)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wk = static_cast<float*>(work);
  if (dtype == 0)
    return launch<float>(f0, f1, cv, prob, wk, rows, W, C, ot_iter, positivity, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(f0, f1, cv, prob, wk, rows, W, C, ot_iter, positivity, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* s2m2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
