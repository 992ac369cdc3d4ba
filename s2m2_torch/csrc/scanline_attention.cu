// Scanline (row-batched) attention for Hopper (sm_90a): kernels A and B.
//
// Replaces s2m2_tpu/ops/flash_attention.py: scanline_attention
// (_row_attn_kernel) and scanline_cross_attention (_cross_row_attn_kernel).
// q, k, v, o are (B, N, D) with B = batch x heads x image rows; each of the
// B sequences attends only within itself. Kernel B is the same kernel with
// a grid z-dimension of 2: direction 0 computes attn(qx, ky, vy), direction
// 1 attn(qy, kx, vx), in one launch.
//
// Numerics, as the TPU kernel: float32 q.k dots, scaled by the true D^-1/2
// after the dot; float32 softmax; the probabilities rounded to v's dtype
// before PV; PV accumulated in float32. The softmax is online over key
// tiles (a running max and sum per query), so P is rounded before the
// final 1/rowsum instead of after it: a last-bit difference in bf16 only.
//
// What bounds it: 4*B*N^2*D flops against 4*B*N*D elements of traffic, so
// about N/2 flops per byte in bf16 (152 at N = 304): below the H100's ~295,
// so the bytes bound it at the scanline shapes and the tensor cores only at
// the 1216-token 2D blocks. float32 runs on the tensor cores too, by split
// TF32 at a third of the TF32 rate (165 TFLOP/s), which makes it bound by
// operations.
//
// One kernel, every head dim up to 384, both dtypes on the tensor cores
// (warp-level mma.sync, float32 accumulators):
//  - bf16: m16n8k16 bf16 products. float32: every operand x is split into
//    big = tf32(x) and small = tf32(x - big) (cvt.rna), and each product
//    is small*big + big*small + big*big on m16n8k8 TF32, small terms first
//    (the scheme of CUTLASS's OpMultiplyAddFastF32, which PyTorch's
//    memory-efficient SDPA uses for float32); it keeps float32 accuracy.
//  - D is padded in shared memory to DP, a multiple of the 32-byte k-step
//    (16 bf16 or 8 floats), with zero columns: they add nothing to Q K^T,
//    the scale uses the true D, and output columns past D are not stored.
//  - A block owns 64 queries. Each warp owns MT 16-query m-tiles and DP /
//    WN output columns. Where the output accumulator (16*MT x DP / WN
//    floats a warp) would not fit beside the scores (bf16 DP = 384, float32
//    DP >= 192), WN warps share a query slice: each computes its 1/WN of
//    the Q K^T k-steps, the partial scores meet in shared memory, and every
//    warp of the slice adds them in the same order, so all hold the same
//    scores, running max and sum. (Doubling Q K^T in both warps instead was
//    measured slower.)
//  - Q stays in shared memory for the whole block; its fragments are read
//    with ldmatrix per k-step, or held in registers when few. K and V come
//    in tiles of BK keys through a ring of STAGES buffers filled by
//    cp.async (16-byte copies, zero-filled past N; an unrolled loop with
//    compile-time addressing when D == DP), so the next tile's loads
//    overlap this tile's products. K and V are read once per block, N / 64
//    times per sequence, mostly from L2.
//  - Scores stay in registers. bf16: the m16n8 accumulator layout of two
//    key n-tiles is the A layout of m16n8k16, so P is repacked in place.
//    TF32: the accumulator layout is not m16n8k8's A layout (a thread holds
//    keys 2t and 2t+1 of an 8-key tile; A wants keys t and t+4), so the PV
//    product permutes its k index instead: k index t stands for key 2t and
//    t + 4 for key 2t + 1, the thread's own scores are its A fragment, and
//    V's B fragment is read from rows 2t and 2t + 1 to match.
//  - The softmax is exp2 of one FFMA per score (ex2.approx); only the
//    ragged last key tile is masked, and the output is rescaled only when
//    a row's running max moved.
//  - Shared rows are padded by 16 bytes (an odd multiple of 16 bytes), so
//    ldmatrix's 8 row addresses and the TF32 path's V reads are free of
//    bank conflicts.
// The per-D choice of (warps, m-tiles, WN, BK, STAGES, blocks per SM) is
// the wrapper's table, compiled into `dispatch_*` below. At these shapes
// the kernel was bound by instruction issue and latency, not by
// shared-memory or tensor-core throughput: two m-tiles per warp (halving the ldmatrix per product) did
// not help, cheaper copy addressing did. wgmma is not used: its 64-row
// warpgroup products and asynchronous accumulators would restructure the
// kernel, and mma.sync already comes within 4x of the bytes bound at XL's
// top scale.
//
// The wrapper (s2m2_torch/ops/flash_attention.py, `plan`) chooses the
// instance from (dtype, D) and passes its padded D, queries per block and
// shared-memory bytes; the entry point refuses a combination it was not
// compiled for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

struct Direction {
  const void* q;
  const void* k;
  const void* v;
  void* o;
};

// T: element type; DP: padded head dim; NW: warps per block; MT: 16-query
// m-tiles per warp; WN: warps per query slice; BK: keys per tile; STAGES:
// K/V tiles in flight; MINB: blocks per SM the registers are capped for
template <typename T, int DP_, int NW_, int MT_, int WN_, int BK_, int STAGES_, int MINB_>
struct Inst {
  using Elem = T;
  static constexpr bool TF32 = std::is_same<T, float>::value;
  static constexpr int DP = DP_, NWARPS = NW_, MT = MT_, WN = WN_, BK = BK_;
  static constexpr int STAGES = STAGES_, MINB = MINB_;
  static constexpr int THREADS = 32 * NWARPS;
  static constexpr int BQ = 16 * MT * NWARPS / WN;  // queries per block
  static constexpr int CHUNK = 16 / sizeof(T);      // elements in 16 bytes
  static constexpr int LDS = DP + CHUNK;            // shared row stride, elements
  static constexpr int KSTEP = 2 * CHUNK;           // elements per mma k-step
  static constexpr int KSTEPS = DP / KSTEP;
  static constexpr int KW = KSTEPS / WN;            // k-steps of Q K^T per warp
  static constexpr int DPW = DP / WN;               // output columns per warp
  static constexpr bool QREG = KW * MT <= 8 && MINB == 1;  // Q fragments in registers
  // the Q tile, STAGES (K, V) tiles, and with WN > 1 each warp's partial
  // 16*MT x BK scores
  static constexpr int SMEM = (BQ + 2 * STAGES * BK) * LDS * (int)sizeof(T) +
                              (WN > 1 ? NWARPS * MT * 16 * BK * 4 : 0);
  static_assert(KSTEPS % WN == 0 && DPW % (TF32 ? 8 : 16) == 0, "columns per warp");
  static_assert(BK % 16 == 0 && STAGES >= 2 && NWARPS % WN == 0, "tiles");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// barrier `id` (1..15) for `threads` threads: the warps of one query slice
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// four 8 x 16-byte matrices; lane l gets 4 bytes (column l % 4) of row l / 4
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

// c += a (16x8 tf32, row) * b (8x8 tf32, col), float32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = big + small to about float32 precision, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// c += a * b by split TF32: the small terms first, then big * big
__device__ __forceinline__ void mma_tf32x3(float (&c)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(c, a_small, b_big[0], b_big[1]);
  mma_tf32(c, a_big, b_small[0], b_small[1]);
  mma_tf32(c, a_big, b_big[0], b_big[1]);
}

// 2^x (approximate, 2 ulp; 0 at -inf)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void split4(const uint32_t (&x)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(x[i]), big[i], small[i]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void set_zero(float* p) { *p = 0.f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16* p) { *p = __float2bfloat16(0.f); }
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// rows [first, first + ROWS) of a (N, D) matrix into shared memory of row
// stride I::LDS: 16-byte cp.async copies when `vec` (D * sizeof(T) % 16 ==
// 0 and every pointer 16-byte aligned), else element stores. Rows past N
// are zero; columns [D, DP) are not touched (zeroed once at the start).
// D == DP, the common case, takes an unrolled loop with the chunks per row
// known at compile time: its addresses cost a few instructions a copy.
template <class I, int ROWS>
__device__ __forceinline__ void load_rows(typename I::Elem* dst,
                                          const typename I::Elem* src, int first, int N,
                                          int D, bool vec) {
  if (vec && D == I::DP) {
    constexpr int CPR = I::DP / I::CHUNK;
    constexpr int TOTAL = ROWS * CPR;
#pragma unroll
    for (int i = 0; i < (TOTAL + I::THREADS - 1) / I::THREADS; ++i) {
      const int idx = threadIdx.x + i * I::THREADS;
      if (TOTAL % I::THREADS == 0 || idx < TOTAL) {
        const int r = idx / CPR;
        const int c = idx - r * CPR;
        const bool valid = first + r < N;
        cp_async16(dst + r * I::LDS + c * I::CHUNK,
                   src + (size_t)(valid ? first + r : 0) * I::DP + c * I::CHUNK, valid);
      }
    }
  } else if (vec) {
    const int cpr = D / I::CHUNK;  // 16-byte chunks per row
    for (int idx = threadIdx.x; idx < ROWS * cpr; idx += I::THREADS) {
      const int r = idx / cpr;
      const int c = idx - r * cpr;
      const bool valid = first + r < N;
      cp_async16(dst + r * I::LDS + c * I::CHUNK,
                 src + (size_t)(valid ? first + r : 0) * D + c * I::CHUNK, valid);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * D; idx += I::THREADS) {
      const int r = idx / D;
      const int c = idx - r * D;
      if (first + r < N)
        dst[r * I::LDS + c] = src[(size_t)(first + r) * D + c];
      else
        set_zero(dst + r * I::LDS + c);
    }
  }
}

template <class I>
__global__ void __launch_bounds__(I::THREADS, I::MINB)
scanline_attention_kernel(Direction d0, Direction d1, int N, int D, float scale_log2,
                          int vec) {
  using T = typename I::Elem;
  constexpr int BQ = I::BQ, BK = I::BK, LDS = I::LDS, STAGES = I::STAGES, MT = I::MT;
  constexpr int NT = BK / 8;      // 8-key n-tiles of a score tile
  constexpr int NO = I::DPW / 8;  // 8-column n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sQ = reinterpret_cast<T*>(smem_raw);  // BQ rows, then STAGES x (K, V)
  T* const sKV = sQ + BQ * LDS;                  // stage s: K at 2s*BK, V at (2s+1)*BK
  float4* const red = reinterpret_cast<float4*>(sKV + 2 * STAGES * BK * LDS);  // WN > 1

  const Direction dir = blockIdx.z == 0 ? d0 : d1;
  const size_t base = (size_t)blockIdx.y * N * D;
  const T* q = static_cast<const T*>(dir.q) + base;
  const T* k = static_cast<const T*>(dir.k) + base;
  const T* v = static_cast<const T*>(dir.v) + base;
  T* o = static_cast<T*>(dir.o) + base;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slice = warp / I::WN;
  const int row0 = 16 * MT * slice;                     // this warp's 16*MT queries
  const int col0 = (warp % I::WN) * I::DPW;             // its output columns
  const int kcol0 = (warp % I::WN) * I::KW * I::KSTEP;  // and its share of the dot
  const int g = lane >> 2;    // accumulator rows g and g + 8
  const int tig = lane & 3;   // accumulator columns 2*tig, 2*tig + 1
  // ldmatrix row addresses (columns in elements, 16 bytes apart): A (and
  // trans B) x4 order, and B x4 order
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * I::CHUNK;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * I::CHUNK;
  const bool active = q0 + row0 < N;  // a slice wholly past N only helps load
  const int ntiles = (N + BK - 1) / BK;

  // the padded columns [D, DP) of every shared row are zero for good
  if (D < I::DP) {
    const int pad = I::DP - D;
    for (int idx = threadIdx.x; idx < (BQ + 2 * STAGES * BK) * pad; idx += I::THREADS)
      set_zero(sQ + (idx / pad) * LDS + D + idx % pad);
  }
  load_rows<I, BQ>(sQ, q, q0, N, D, vec);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) {
      load_rows<I, BK>(sKV + 2 * s * BK * LDS, k, s * BK, N, D, vec);
      load_rows<I, BK>(sKV + (2 * s + 1) * BK * LDS, v, s * BK, N, D, vec);
    }
    cp_async_commit();
  }

  float acc[MT][NO][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  float m[MT][2], l[MT][2];  // running max (log2 domain, scaled) and sum
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }
  uint32_t qf[I::QREG ? I::KW : 1][MT][4];
  const T* const q_frag = sQ + (row0 + a_row) * LDS + kcol0 + a_col;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();  // tile t (and Q) have landed
    __syncthreads();              // ... for every thread; tile t-1's slot is free
    {
      const int nt = t + STAGES - 1;
      if (nt < ntiles) {
        T* slot = sKV + 2 * (nt % STAGES) * BK * LDS;
        load_rows<I, BK>(slot, k, nt * BK, N, D, vec);
        load_rows<I, BK>(slot + BK * LDS, v, nt * BK, N, D, vec);
      }
      cp_async_commit();
    }
    if (!active) continue;
    if constexpr (I::QREG) {
      if (t == 0) {
#pragma unroll
        for (int ks = 0; ks < I::KW; ++ks)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            ldmatrix_x4(qf[ks][mt], q_frag + 16 * mt * LDS + ks * I::KSTEP);
      }
    }
    const T* const sK = sKV + 2 * (t % STAGES) * BK * LDS;
    const T* const sV = sK + BK * LDS;
    const int k0 = t * BK;

    // S = Q K^T: MT x (16 queries x BK keys), NT n-tiles of 8 keys; with
    // WN > 1 this warp's k-steps only, summed over the slice's warps below.
    // Each K fragment feeds MT products.
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < I::KW; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (I::QREG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[mt][i] = qf[ks][mt][i];
        } else {
          ldmatrix_x4(a[mt], q_frag + 16 * mt * LDS + ks * I::KSTEP);
        }
      }
      if constexpr (I::TF32) {
        uint32_t a_big[MT][4], a_small[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) split4(a[mt], a_big[mt], a_small[mt]);
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          uint32_t b[4], b_big[4], b_small[4];
          ldmatrix_x4(b, sK + (np * 16 + b_row) * LDS + kcol0 + ks * I::KSTEP + b_col);
          split4(b, b_big, b_small);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_tf32x3(s[mt][2 * np], a_big[mt], a_small[mt], {b_big[0], b_big[1]},
                       {b_small[0], b_small[1]});
            mma_tf32x3(s[mt][2 * np + 1], a_big[mt], a_small[mt], {b_big[2], b_big[3]},
                       {b_small[2], b_small[3]});
          }
        }
      } else {
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, sK + (np * 16 + b_row) * LDS + kcol0 + ks * I::KSTEP + b_col);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * np], a[mt], b[0], b[1]);
            mma_bf16(s[mt][2 * np + 1], a[mt], b[2], b[3]);
          }
        }
      }
    }
    if constexpr (I::WN > 1) {
      // every warp of the slice adds the partials in the same order, so
      // all hold the same scores (and the same running max and sum)
      float4* mine = red + warp * MT * NT * 32 + lane;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mine[(mt * NT + j) * 32] =
              make_float4(s[mt][j][0], s[mt][j][1], s[mt][j][2], s[mt][j][3]);
      bar_sync(1 + slice, 32 * I::WN);
      const float4* part = red + slice * I::WN * MT * NT * 32 + lane;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float4 x = part[(mt * NT + j) * 32];
#pragma unroll
          for (int w = 1; w < I::WN; ++w) {
            const float4 y = part[((w * MT + mt) * NT + j) * 32];
            x = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
          }
          s[mt][j][0] = x.x;
          s[mt][j][1] = x.y;
          s[mt][j][2] = x.z;
          s[mt][j][3] = x.w;
        }
    }

    // online softmax over this tile; a quad of lanes shares each row.
    // p = 2^(s * scale * log2(e) - m), keys past N give 0
    if (k0 + BK > N) {  // the ragged last tile: keys past N get -inf
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * j + 2 * tig + (e & 1) >= N) s[mt][j][e] = -INFINITY;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][j][e]);
      float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[mt][h], mx[h] * scale_log2);  // finite: key k0 < N
        corr[h] = ex2(m[mt][h] - m_new);                          // 0 on the first tile
        m[mt][h] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][j][e] = ex2(fmaf(s[mt][j][e], scale_log2, -m[mt][e >> 1]));
          rs[e >> 1] += s[mt][j][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
        l[mt][h] = l[mt][h] * corr[h] + rs[h];
      }
      // rescale only where some row's max moved (corr == 1 changes nothing)
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < NO; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] *= corr[e >> 1];
      }
    }

    // O += P V on this warp's columns; each V fragment feeds MT products
    if constexpr (I::TF32) {
      // k index t of an 8-key tile stands for key 2t, t + 4 for key 2t + 1
#pragma unroll
      for (int kc = 0; kc < NT; ++kc) {
        uint32_t p_big[MT][4], p_small[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t p[4] = {__float_as_uint(s[mt][kc][0]), __float_as_uint(s[mt][kc][2]),
                                 __float_as_uint(s[mt][kc][1]), __float_as_uint(s[mt][kc][3])};
          split4(p, p_big[mt], p_small[mt]);
        }
        const T* vrow = sV + (kc * 8 + 2 * tig) * LDS + col0 + g;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          uint32_t b_big[2], b_small[2];
          split_tf32(vrow[8 * j], b_big[0], b_small[0]);
          split_tf32(vrow[LDS + 8 * j], b_big[1], b_small[1]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_tf32x3(acc[mt][j], p_big[mt], p_small[mt], b_big, b_small);
        }
      }
    } else {
      // P rounded to bf16, as A fragments straight from the accumulators
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          a[mt][0] = pack_bf16(s[mt][2 * kc][0], s[mt][2 * kc][1]);
          a[mt][1] = pack_bf16(s[mt][2 * kc][2], s[mt][2 * kc][3]);
          a[mt][2] = pack_bf16(s[mt][2 * kc + 1][0], s[mt][2 * kc + 1][1]);
          a[mt][3] = pack_bf16(s[mt][2 * kc + 1][2], s[mt][2 * kc + 1][3]);
        }
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, sV + (kc * 16 + a_row) * LDS + col0 + dp * 16 + a_col);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][2 * dp], a[mt], b[0], b[1]);
            mma_bf16(acc[mt][2 * dp + 1], a[mt], b[2], b[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (the last groups are empty)
  if (!active) return;

  const bool pairs = (D & 1) == 0;  // column pairs never straddle D
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + row0 + 16 * mt + g + 8 * h;
      if (row >= N) continue;
      const float inv = 1.f / l[mt][h];
      T* orow = o + (size_t)row * D;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const int col = col0 + 8 * j + 2 * tig;
        const float x = acc[mt][j][2 * h] * inv, y = acc[mt][j][2 * h + 1] * inv;
        if (pairs) {
          if (col < D) store2(orow + col, x, y);
        } else {
          if (col < D) store1(orow + col, x);
          if (col + 1 < D) store1(orow + col + 1, y);
        }
      }
    }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

struct Args {
  Direction d0, d1;
  int B, N, D, bq, smem, ndir;
  cudaStream_t stream;
};

template <class I>
cudaError_t launch(const Args& a) {
  if (a.bq != I::BQ || a.smem != I::SMEM) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  static unsigned long long ready = 0;  // devices this instance may use SMEM on
  if (!(ready >> dev & 1ull)) {
    err = cudaFuncSetAttribute(scanline_attention_kernel<I>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, I::SMEM);
    if (err != cudaSuccess) return err;
    ready |= 1ull << dev;
  }
  const bool vec = (a.D * (int)sizeof(typename I::Elem)) % 16 == 0 && aligned16(a.d0.q) &&
                   aligned16(a.d0.k) && aligned16(a.d0.v) && aligned16(a.d1.q) &&
                   aligned16(a.d1.k) && aligned16(a.d1.v);
  const dim3 grid((a.N + I::BQ - 1) / I::BQ, a.B, a.ndir);
  const float scale_log2 = (float)(pow((double)a.D, -0.5) * 1.4426950408889634);
  scanline_attention_kernel<I><<<grid, I::THREADS, I::SMEM, a.stream>>>(
      a.d0, a.d1, a.N, a.D, scale_log2, vec);
  return cudaGetLastError();
}

// The compiled instances: padded D -> Inst<T, DP, NW, MT, WN, BK, STAGES,
// MINB>, each the fastest of the variants timed at the model's shapes on an
// H100. The list is _INSTANCES in s2m2_torch/ops/flash_attention.py, which
// the build writes into this header (`instances_header`).
#include "scanline_attention_instances.h"
#define S2M2_CASE(DP, ...) \
  case DP:                 \
    return launch<Inst<T, DP, __VA_ARGS__>>(a);

cudaError_t dispatch_bf16(int dp, const Args& a) {
  using T = __nv_bfloat16;
  switch (dp) {
    S2M2_BF16_INSTANCES(S2M2_CASE)
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_tf32(int dp, const Args& a) {
  using T = float;
  switch (dp) {
    S2M2_TF32_INSTANCES(S2M2_CASE)
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Direction 0 uses (q0, k0, v0) -> o0; with ndir == 2, direction 1 uses
// (q1, k1, v1) -> o1. All (B, N, D) contiguous, of one dtype: 0 float32,
// 1 bfloat16. dp, bq, smem: the padded head dim, queries per block and
// shared-memory bytes of the instance the wrapper chose; a combination that
// was not compiled is refused. Returns the cudaError_t of the launch.
extern "C" int s2m2_scanline_attention(const void* q0, const void* k0, const void* v0,
                                       void* o0, const void* q1, const void* k1,
                                       const void* v1, void* o1, int B, int N, int D,
                                       int dtype, int dp, int bq, int smem, int ndir,
                                       void* stream) {
  if (B < 1 || B > 65535 || N < 1 || D < 1 || D > dp || ndir < 1 || ndir > 2)
    return cudaErrorInvalidValue;
  const Args a{{q0, k0, v0, o0}, {q1, k1, v1, o1}, B, N, D, bq, smem, ndir,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_tf32(dp, a);
  if (dtype == 1) return dispatch_bf16(dp, a);
  return cudaErrorInvalidValue;
}

extern "C" const char* s2m2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
