// Scanline (row-batched) attention for Hopper (sm_90a): kernels A and B.
//
// Replaces s2m2_tpu/ops/flash_attention.py: scanline_attention
// (_row_attn_kernel) and scanline_cross_attention (_cross_row_attn_kernel).
// q, k, v, o are (B, N, D) with B = batch x heads x image rows; each of the
// B sequences attends only within itself. Kernel B is the same kernel with
// a grid z-dimension of 2: direction 0 computes attn(qx, ky, vy), direction
// 1 attn(qy, kx, vx), in one launch.
//
// Numerics, as the TPU kernel: float32 q.k dots, scaled by D^-1/2 after the
// dot; float32 softmax; the probabilities rounded to v's dtype before PV;
// PV accumulated in float32. The softmax is online over 64-key tiles (a
// running max and sum per query), so P is rounded before the final
// 1/rowsum instead of after it: a last-bit difference in bf16 only.
//
// What bounds it: the work is 4*B*N^2*D flops against 4*B*N*D elements of
// traffic, so in float32 (67 TFLOP/s without tensor cores on an H100 SXM)
// the arithmetic bounds it at every shape of the model; in bf16 (989
// TFLOP/s on the tensor cores) the bytes do at D <= 128 with N <= 304 and
// the arithmetic at the 1216-token 2D blocks. Two kernels, chosen by what
// the wrapper can see (dtype and D):
//
// attention_mma_kernel, bf16 with D in {16, 32, 48, 64, 96, 128, 192}
// (every attention of S's main path; all but the D = 256 top scale of L,
// the D = 24 refiner bottleneck of M and the D = 384 top scale of XL,
// which take the scalar kernel): warp-level tensor-core products
// (mma.sync m16n8k16, bf16 in, float32 accumulate). A block of 4 warps
// owns 64 queries, 16 per warp; the Q fragments are loaded once into
// registers (ldmatrix), and 64-key tiles of K and V are staged in shared
// memory with 16-byte loads. S = Q K^T stays in the float32 accumulators,
// the online softmax runs on them, and they are repacked as bf16 A
// fragments of P (the accumulator layout of m16n8 equals the A layout of
// m16n8k16 two tiles at a time), so P never touches shared memory. Rows of
// the shared tiles are padded by 8 elements so ldmatrix's 8 row addresses
// fall in distinct banks. The scores never leave the chip; K and V are
// re-read once per 64-query tile, from L2 at these sizes.
//
// attention_kernel, everything else (float32, and bf16 at other D up to
// 384): scalar float32 FMAs.
//  - one block of 256 threads per (sequence, 64-query tile); the Q tile
//    sits in shared memory as float32 and 64-key tiles of K, then of V,
//    stream through one shared buffer;
//  - each thread owns a 4x4 block of the 64x64 score tile and 4 rows x
//    ceil(D/16) columns of the output accumulator in registers; rows of
//    the shared tiles have an odd float stride, so the 16 key rows a
//    half-warp reads at once fall in 16 different banks;
//  - the output accumulator's width is a template parameter NC (D <= 16*NC,
//    NC in {1,2,4,8,12,16,24}), so every D from 1 to 384 runs with the
//    accumulator in registers; columns past D are skipped.
//    Shared memory at D = 384: 2*64*385*4 + 64*65*4 = 213,760 bytes of the
//    232,448 a block may use.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // queries per block
constexpr int BK = 64;   // keys per tile
constexpr int THREADS = 256;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// P is rounded to the value dtype before PV, as the TPU kernel does.
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

struct Direction {
  const void* q;
  const void* k;
  const void* v;
  void* o;
};

// rows [first, first + 64) of a (N, D) matrix into a float tile of row
// stride ld; rows past N are zero
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* src, int first, int N, int D) {
  for (int idx = threadIdx.x; idx < BK * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx - r * D;
    dst[r * ld + c] = (first + r < N) ? load_f(src + (size_t)(first + r) * D + c) : 0.f;
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
attention_kernel(Direction d0, Direction d1, int N, int D, int ld, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;              // BQ x ld
  float* sKV = sQ + BQ * ld;     // BK x ld: the K tile, then the V tile
  float* sP = sKV + BK * ld;     // BQ x (BK + 1)

  const Direction dir = blockIdx.z == 0 ? d0 : d1;
  const size_t base = (size_t)blockIdx.y * N * D;
  const T* q = static_cast<const T*>(dir.q) + base;
  const T* k = static_cast<const T*>(dir.k) + base;
  const T* v = static_cast<const T*>(dir.v) + base;
  T* o = static_cast<T*>(dir.o) + base;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x & 15;  // keys tx + 16j; output columns tx + 16c
  const int ty = threadIdx.x >> 4;  // queries ty + 16i

  load_tile(sQ, ld, q, q0, N, D);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // the previous tile's PV is done with sKV and sP
    load_tile(sKV, ld, k, k0, N, D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < D; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sKV[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

    // online softmax; the 16 lanes of a half-warp share the query rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (k0 + tx + 16 * j < N) ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);    // finite: key k0 < N is valid
      const float corr = expf(m[i] - m_new);  // 0 on the first tile
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);  // 0 for keys past N
        rs += p;
        sP[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = round_to(p, q);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // scores are done with the K tile; sP is complete
    load_tile(sKV, ld, v, k0, N, D);
    __syncthreads();

    const int kmax = min(BK, N - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        if (col < D) {
          const float vv = sKV[kk * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < N) {
      const float inv = 1.f / l[i];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        if (col < D) store_f(o + (size_t)row * D + col, acc[i][c] * inv);
      }
    }
  }
}

template <typename T, int NC>
cudaError_t launch(Direction d0, Direction d1, int B, int N, int D, int ndir,
                   cudaStream_t stream) {
  const int ld = D | 1;  // odd float stride: conflict-free column reads
  const size_t smem = (size_t)(2 * BQ * ld + BQ * (BK + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BQ - 1) / BQ, B, ndir);
  const float scale = (float)pow((double)D, -0.5);
  attention_kernel<T, NC><<<grid, THREADS, smem, stream>>>(d0, d1, N, D, ld, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int nc, Direction d0, Direction d1, int B, int N, int D,
                     int ndir, cudaStream_t s) {
  switch (nc) {
    case 1: return launch<T, 1>(d0, d1, B, N, D, ndir, s);
    case 2: return launch<T, 2>(d0, d1, B, N, D, ndir, s);
    case 4: return launch<T, 4>(d0, d1, B, N, D, ndir, s);
    case 8: return launch<T, 8>(d0, d1, B, N, D, ndir, s);
    case 12: return launch<T, 12>(d0, d1, B, N, D, ndir, s);
    case 16: return launch<T, 16>(d0, d1, B, N, D, ndir, s);
    case 24: return launch<T, 24>(d0, d1, B, N, D, ndir, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---- bf16 tensor-core path ------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 queries

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
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// rows [first, first + 64) of a (N, D) bf16 matrix into shared memory of
// row stride LDS elements, 16 bytes at a time; rows past N are zero
template <int D, int LDS>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src, int first,
                                               int N) {
  constexpr int VEC = D / 8;
  for (int idx = threadIdx.x; idx < BK * VEC; idx += MMA_THREADS) {
    const int r = idx / VEC;
    const int c = idx % VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (first + r < N) val = reinterpret_cast<const uint4*>(src + (size_t)(first + r) * D)[c];
    *reinterpret_cast<uint4*>(dst + r * LDS + c * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
attention_mma_kernel(Direction d0, Direction d1, int N, float scale_log2) {
  constexpr int LDS = D + 8;  // padded row stride (elements)
  constexpr int KD = D / 16;  // k-steps of Q K^T
  constexpr int ND = D / 8;   // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * LDS;
  __nv_bfloat16* sV = sK + BK * LDS;

  const Direction dir = blockIdx.z == 0 ? d0 : d1;
  const size_t base = (size_t)blockIdx.y * N * D;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(dir.q) + base;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(dir.k) + base;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(dir.v) + base;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(dir.o) + base;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // accumulator rows g and g + 8
  const int tig = lane & 3;  // accumulator columns 2*tig, 2*tig + 1
  // ldmatrix row addresses: A (and trans B) x4 order, and B x4 order
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 8;

  load_tile_bf16<D, LDS>(sQ, q, q0, N);
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    ldmatrix_x4(qf[kd], sQ + (warp * 16 + a_row) * LDS + kd * 16 + a_col);

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
  float l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // the previous tile's products are done with sK, sV
    load_tile_bf16<D, LDS>(sK, k, k0, N);
    load_tile_bf16<D, LDS>(sV, v, k0, N);
    __syncthreads();

    float s[8][4];  // 16 queries x 64 keys: 8 n-tiles of 8 keys
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, sK + (np * 16 + b_row) * LDS + kd * 16 + b_col);
        mma_bf16(s[2 * np], qf[kd], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kd], b[2], b[3]);
      }
    }

    // online softmax over this tile; a quad of lanes shares each row
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = k0 + 8 * j + 2 * tig + (e & 1) < N;
        s[j][e] = valid ? s[j][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);  // finite: key k0 < N is valid
      corr[h] = exp2f(m[h] - m_new);           // 0 on the first tile
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);  // 0 for keys past N
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l[h] = l[h] * corr[h] + rs[h];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];

    // O += P V, P rounded to bf16 as A fragments straight from registers
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sV + (kc * 16 + a_row) * LDS + dp * 16 + a_col);
        mma_bf16(acc[2 * dp], a, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }

  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    if (row < N) {
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const __nv_bfloat162 val = __floats2bfloat162_rn(acc[j][2 * h] * inv[h],
                                                         acc[j][2 * h + 1] * inv[h]);
        *reinterpret_cast<__nv_bfloat162*>(o + (size_t)row * D + 8 * j + 2 * tig) = val;
      }
    }
  }
}

template <int D>
cudaError_t launch_mma(Direction d0, Direction d1, int B, int N, int ndir,
                       cudaStream_t stream) {
  const size_t smem = (size_t)(BQ + 2 * BK) * (D + 8) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(attention_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BQ - 1) / BQ, B, ndir);
  const float scale_log2 = (float)(pow((double)D, -0.5) * 1.4426950408889634);
  attention_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(d0, d1, N, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// Direction 0 uses (q0, k0, v0) -> o0; with ndir == 2, direction 1 uses
// (q1, k1, v1) -> o1. All (B, N, D) contiguous, of one dtype: 0 float32,
// 1 bfloat16. nc: the accumulator width bucket, 16*nc >= D. Returns the
// cudaError_t of the launch.
extern "C" int s2m2_scanline_attention(const void* q0, const void* k0, const void* v0,
                                       void* o0, const void* q1, const void* k1,
                                       const void* v1, void* o1, int B, int N, int D,
                                       int nc, int dtype, int ndir, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || D < 1 || D > 384 || 16 * nc < D ||
      ndir < 1 || ndir > 2)
    return cudaErrorInvalidValue;
  const Direction d0{q0, k0, v0, o0};
  const Direction d1{q1, k1, v1, o1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(nc, d0, d1, B, N, D, ndir, s);
  if (dtype == 1) {
    switch (D) {
      case 16: return launch_mma<16>(d0, d1, B, N, ndir, s);
      case 32: return launch_mma<32>(d0, d1, B, N, ndir, s);
      case 48: return launch_mma<48>(d0, d1, B, N, ndir, s);
      case 64: return launch_mma<64>(d0, d1, B, N, ndir, s);
      case 96: return launch_mma<96>(d0, d1, B, N, ndir, s);
      case 128: return launch_mma<128>(d0, d1, B, N, ndir, s);
      case 192: return launch_mma<192>(d0, d1, B, N, ndir, s);
      default: return dispatch<__nv_bfloat16>(nc, d0, d1, B, N, D, ndir, s);
    }
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* s2m2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
