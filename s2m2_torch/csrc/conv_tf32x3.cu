// Float32 convolution on the tensor cores by split TF32, for Hopper
// (sm_90a): kernel G.
//
// Replaces no TPU kernel: the JAX package leaves its convolutions to XLA,
// and the port ran them on cuDNN, whose float32 convolutions (TF32 off, as
// the engine sets it) run on the CUDA cores' FFMA, at most 67 TFLOP/s and
// about half of that at the model's shapes. They were most of a float32
// forward's device time (PERF.md). G computes the same float32 result on
// the tensor cores, as kernels A, B and D do: each operand x is split into
// big = x rounded to TF32 and small = (x - big) rounded to TF32, and each
// product is three TF32 products, small * big, big * small, big * big, in
// that order into float32 sums (small * small, below float32's rounding,
// is dropped). G takes every float32 inference convolution with
// a kernel of at most 3 x 3, stride 1, dilation 1 and groups 1 that
// `ops/conv.py plan` accepts, the 1x1 ones on its flat path (below);
// everything else stays on cuDNN.
//
// What bounds it on the H100: 2 B Ho Wo N C kh kw operations against one
// read of the input and the weights and one write of the output. At the
// model's shapes (C and N 64 to 768, 64 x 76 to 512 x 608 maps) that is
// tens to hundreds of operations a byte, so the operations bound it: three
// TF32 products each at 495 TFLOP/s, 165 TFLOP/s of float32 work.
//
// Design, an implicit GEMM: M = output pixels, N = output channels, K =
// input channels x taps.
//  - A block is three warpgroups: two consumers, each with MT 64-row
//    accumulators of BN columns in registers, and a producer whose one
//    thread issues TMA (setmaxnreg hands the producer's registers to the
//    consumers). The grid is persistent: min(tiles, SMs) blocks walk the
//    output tiles, so the producer loads the next tile while the consumers
//    store the last one. A tile is 8 MT rows x 16 columns of output pixels
//    of one image by BN output channels; tile t is column tile t % (N
//    tiles) of its pixel block, so blocks in flight share input.
//  - Activations (NCHW, so M-major: TF32 wgmma takes only K-major operands
//    from shared memory): per chunk of 32 input channels one TMA box of
//    (16 + 8) x (8 MT + 3) pixels x 32 channels at (wo0 - 4, ho0 - ph),
//    whose out-of-bounds zero fill is the padding; every tap of the chunk
//    reads the same box. (A box's first column must lie on 16 bytes, or
//    the H100 faults: hence 4 columns left of the tile whatever pw is.) The
//    consumers read their fragments of it with plain loads (a channel
//    plane is 8 banks apart from the next, as the odd box height makes it,
//    so a warp's loads hit 32 banks), split them into big and small in
//    registers, and pass them as wgmma's register-sourced A operand.
//  - Weights: split once into big and small by the wrapper and laid out
//    (tap, part, N, Cp), channels innermost (`ops/conv.py split_weight`):
//    K-major per tap, the shared-memory B operand. A ring of SB stages,
//    each one TMA box of both parts of BN rows x 32 channels of one tap in
//    the 128-byte swizzle.
//  - A k tile is (chunk, tap): up to four k-steps of 8 channels, each
//    three m64nBNk8 wgmmas a 64-row accumulator; the last chunk of an odd
//    channel count runs only its live k-steps (zero-filled channels past C
//    add nothing). Each k tile's wgmmas start a partial sum that is then
//    added to the tile's float32 sum in registers (`k_tile`: the tensor
//    cores' own accumulation truncates). The two consumer warpgroups take
//    turns on the tensor cores: one splits its next fragments and adds its
//    partial sums while the other's wgmmas run.
//  - Epilogue: bias added in float32, stores straight from the
//    accumulators into the NCHW output; each warp store fills whole
//    32-byte runs of 8 pixels of 4 channels.
// The instances (MT, BN, SB) and their wgmma wrappers come from the table
// `_INSTANCES` of ops/conv.py (`instances_header`, written by _build.py
// into conv_tf32x3_instances.h); `plan` picks one per shape.
//
// The flat path (`conv1x1_tf32x3_kernel`, entry `s2m2_conv1x1_tf32x3`):
// G's instances for the float32 1x1 stride-1 convs, which ran on cuDNN's
// FFMA kernels (`sm80_xmma_fprop_implicit_gemm_f32f32...`) at about half
// the 67 TFLOP/s FFMA peak, the largest block of an XL forward left off the
// tensor cores; the JAX package leaves them to XLA as it does every conv.
// A 1x1 conv is a GEMM per image: M = output pixels taken flat over H W
// (contiguous in NCHW), N = output channels, K = input channels. What
// bounds it: 2 B H W N C operations against one read of the input and the
// weights and one write of the output; at XL's shapes (C 384 to 1536) that
// is 100 to 400 operations a byte, so the operations, at split TF32's 165
// TFLOP/s; only at C = 128 (about 64 a byte) would the bytes come near.
// Its design is G's block, warpgroups, weight ring, k tiles and epilogue,
// with other tiles: a tile is 128 MT flat pixels (which may cross image
// rows; a 64 x 76 map would leave a third of G's 16-wide column tiles
// empty) by BN channels, each consumer warpgroup's 64 MT pixels one TMA
// box of (64 MT + 8) pixels x 32 channels of the (HW, C, B) view (no halo;
// the 8 extra pixels keep a channel plane 8 banks from the next), loaded
// with the weight stage of the same chunk on one barrier. The tail of H W
// and the channels past C are zero-filled by TMA. The epilogue differs: a
// tile's output is written into shared memory and stored by one TMA store
// (which writes nothing past H W or N) while the next tile runs; storing
// from the accumulators, as G's spatial tiles do, took 13% of the time at
// C = 384 (2,048 32-byte sectors a tile through the SM's store path; H100,
// at the cost of a fourth ring stage). Its instances are `_FLAT_INSTANCES`
// of ops/conv.py (S2M2_CONV1X1_INSTANCES).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <map>
#include <mutex>
#include <tuple>

#include "hopper.cuh"  // mbarrier, TMA, wgmma helpers; encoder()

// The instance tables of ops/conv.py (spatial and flat) and the TF32 wgmma
// wrappers WgmmaTF32<BN>::mma(acc, a, b_desc, scale_d) of their N tiles.
#include "conv_tf32x3_instances.h"

namespace {

constexpr int KC = 32;  // input channels of a chunk: one 128-byte swizzle row of float32

// big = x rounded to TF32 (to nearest, ties away, as cvt.rna: an integer
// add and mask), small = x - big (exact) rounded the same way
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
}

struct ConvArgs {
  int C, H, W, N, Ho, Wo, kh, kw, ph, pw;
  int tiles_w, tiles_h, ntn, nchunks;
  long long ntiles;
  const float* bias;  // (N,) or null
  float* out;         // (B, N, Ho, Wo)
};

template <int MT, int BN, int SB>
struct Geo {
  static constexpr int TH = 8 * MT;        // output rows of a tile: 2 warpgroups x MT x 4
  static constexpr int TW = 16;            // output columns of a tile
  static constexpr int BXW = TW + 8;       // box width from wo0 - 4: kw - pw <= 5, pw <= 4
  static constexpr int BYH = TH + 3;       // box height: kh <= 4; odd, for the banks
  static constexpr int PLANE = BXW * BYH;  // floats of one channel of the box
  static constexpr int SA = 2;             // activation stages
  static constexpr int A_BYTES = KC * PLANE * 4;
  static constexpr int B_BYTES = 2 * BN * 128;  // big and small parts
  static constexpr int BYTES = 1024 + SA * A_BYTES + SB * B_BYTES + 16 * (SA + SB);
  static_assert(PLANE % 32 == 8 || PLANE % 32 == 24, "a warp's loads hit 32 banks");
  static_assert(A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0, "1024-byte aligned stages");
  static_assert(BYTES <= 232448, "shared memory");
};

// One k tile of a warpgroup: S live k-steps of 8 channels. The fragments
// of all S steps and MT row tiles are loaded and split first, then the
// 3 S MT wgmmas are issued into `part`, committed and waited for, and
// `part` is added to `acc` in float32. hal: this chunk's box at the tap
// (dy, dx) and the thread's first row, pixel and channel.
//
// Why two accumulators: the tensor cores add a wgmma's products to its
// accumulator with truncation (toward zero), not to nearest, so over the
// 3 K / 8 wgmmas of a 3 x 3 conv with K = 3,456 the error of one
// accumulator grows with K and one-sided, to about 9 times float32's
// (2.5e-5 of the largest output against cuDNN's 2.8e-6, H100). Restarted
// every k tile and added with a rounded FADD, each partial sum takes 12
// truncations of a sum of 32 channels, and the result keeps float32's
// error.
//
// PLANE: floats from one channel of the box to the next; MSTEP: floats from
// one 64-row accumulator's first pixel to the next one's (4 box rows in G's
// spatial tiles, 64 pixels in the flat ones).
template <int MT, int BN, int S, int PLANE, int MSTEP>
__device__ __forceinline__ void k_tile(float (&acc)[MT][BN / 2], const float* hal,
                                       uint64_t db, uint64_t ds) {
  uint32_t ab[MT][S][4], as[MT][S][4];
  float part[MT][BN / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int ks = 0; ks < S; ++ks) {
      // rows g and g + 8 (pixels), columns tig and tig + 4 (channels)
      const float* p = hal + mt * MSTEP + ks * 8 * PLANE;
      split_tf32(p[0], ab[mt][ks][0], as[mt][ks][0]);
      split_tf32(p[8], ab[mt][ks][1], as[mt][ks][1]);
      split_tf32(p[4 * PLANE], ab[mt][ks][2], as[mt][ks][2]);
      split_tf32(p[4 * PLANE + 8], ab[mt][ks][3], as[mt][ks][3]);
    }
  }
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < S; ++ks) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // a 32-byte k-step: 2 units of 16 bytes inside the swizzle row; the
      // k tile's first product overwrites `part`
      WgmmaTF32<BN>::mma(part[mt], as[mt][ks], db + 2 * ks, ks > 0);
      WgmmaTF32<BN>::mma(part[mt], ab[mt][ks], ds + 2 * ks, 1);
      WgmmaTF32<BN>::mma(part[mt], ab[mt][ks], db + 2 * ks, 1);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    fence_regs(part[mt]);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mt][i] += part[mt][i];
  }
}

// A k tile of `steps` live k-steps (1 to 4: the last chunk of an odd
// channel count runs only its live ones).
template <int MT, int BN, int PLANE, int MSTEP>
__device__ __forceinline__ void k_tile_live(int steps, float (&acc)[MT][BN / 2],
                                            const float* hal, uint64_t db, uint64_t ds) {
  if (steps == 4) {
    k_tile<MT, BN, 4, PLANE, MSTEP>(acc, hal, db, ds);
  } else if (steps == 3) {
    k_tile<MT, BN, 3, PLANE, MSTEP>(acc, hal, db, ds);
  } else if (steps == 2) {
    k_tile<MT, BN, 2, PLANE, MSTEP>(acc, hal, db, ds);
  } else {
    k_tile<MT, BN, 1, PLANE, MSTEP>(acc, hal, db, ds);
  }
}

template <int MT, int BN, int SB>
__global__ void __launch_bounds__(384, 1)
    conv_tf32x3_kernel(const __grid_constant__ CUtensorMap tma_x,
                       const __grid_constant__ CUtensorMap tma_w, const ConvArgs p) {
  using G = Geo<MT, BN, SB>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sa = smem;
  uint8_t* sb = smem + G::SA * G::A_BYTES;
  uint64_t* a_full = reinterpret_cast<uint64_t*>(sb + SB * G::B_BYTES);
  uint64_t* a_empty = a_full + G::SA;
  uint64_t* b_full = a_empty + G::SA;
  uint64_t* b_empty = b_full + SB;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int taps = p.kh * p.kw;
  const long long per_image = static_cast<long long>(p.tiles_h) * p.tiles_w;

  if (tid == 0) {
    for (int s = 0; s < G::SA; ++s) {
      mbar_init(&a_full[s], 1);
      mbar_init(&a_empty[s], 256);
    }
    for (int s = 0; s < SB; ++s) {
      mbar_init(&b_full[s], 1);
      mbar_init(&b_empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      int ka = 0, kb = 0;  // chunks and k tiles issued by this block
      for (long long t = blockIdx.x; t < p.ntiles; t += gridDim.x) {
        const int n0 = static_cast<int>(t % p.ntn) * BN;
        const long long panel = t / p.ntn;
        const int b = static_cast<int>(panel / per_image);
        const int rem = static_cast<int>(panel - b * per_image);
        const int ho0 = rem / p.tiles_w * G::TH;
        const int wo0 = rem % p.tiles_w * G::TW;
        for (int c = 0; c < p.nchunks; ++c, ++ka) {
          const int s = ka % G::SA;
          if (ka >= G::SA) mbar_wait(&a_empty[s], ((ka / G::SA) - 1) & 1);
          mbar_expect_tx(&a_full[s], G::A_BYTES);
          tma_load_4d(sa + s * G::A_BYTES, &tma_x, &a_full[s], wo0 - 4, ho0 - p.ph, c * KC, b);
          for (int tap = 0; tap < taps; ++tap, ++kb) {
            const int r = kb % SB;
            if (kb >= SB) mbar_wait(&b_empty[r], ((kb / SB) - 1) & 1);
            mbar_expect_tx(&b_full[r], G::B_BYTES);
            tma_load_4d(sb + r * G::B_BYTES, &tma_w, &b_full[r], c * KC, n0, 0, tap);
          }
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lt = tid & 127;
    const int warp = lt >> 5;
    const int lane = lt & 31;
    const int g = lane >> 2;   // fragment row: pixels g and g + 8
    const int tig = lane & 3;  // fragment column: channels tig and tig + 4
    const int row = wg * MT * 4 + warp;  // the warp's first output row in the tile
    // the thread's element of a box: its channel, row and pixel (the box
    // starts 4 columns left of the tile, the input pw columns left of it)
    const int lane_off = tig * G::PLANE + row * G::BXW + g + 4 - p.pw;
    float acc[MT][BN / 2];
    int ka = 0, kb = 0;
    for (long long t = blockIdx.x; t < p.ntiles; t += gridDim.x) {
      const int n0 = static_cast<int>(t % p.ntn) * BN;
      const long long panel = t / p.ntn;
      const int b = static_cast<int>(panel / per_image);
      const int rem = static_cast<int>(panel - b * per_image);
      const int ho0 = rem / p.tiles_w * G::TH;
      const int wo0 = rem % p.tiles_w * G::TW;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.f;
      }
      for (int c = 0; c < p.nchunks; ++c, ++ka) {
        const int s = ka % G::SA;
        mbar_wait(&a_full[s], (ka / G::SA) & 1);
        const float* box = reinterpret_cast<const float*>(sa + s * G::A_BYTES) + lane_off;
        const int live = p.C - c * KC;
        const int steps = live >= KC ? 4 : (live + 7) / 8;
        for (int tap = 0; tap < taps; ++tap, ++kb) {
          const int dy = tap / p.kw;
          const int dx = tap - dy * p.kw;
          const int r = kb % SB;
          mbar_wait(&b_full[r], (kb / SB) & 1);
          const float* hal = box + dy * G::BXW + dx;
          const uint8_t* stage = sb + r * G::B_BYTES;
          const uint64_t db = desc_sw128(stage);
          const uint64_t ds = desc_sw128(stage + BN * 128);
          k_tile_live<MT, BN, G::PLANE, 4 * G::BXW>(steps, acc, hal, db, ds);
          mbar_arrive(&b_empty[r]);
        }
        mbar_arrive(&a_empty[s]);
      }

      // epilogue: acc[mt][jn * 4 + h * 2 + e] is output row (pixel) g + 8 h
      // of the warp's 16, column (channel) jn * 8 + 2 tig + e
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int ho = ho0 + row + mt * 4;
        if (ho >= p.Ho) continue;
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + jn * 8 + 2 * tig + e;
            if (n >= p.N) continue;
            const float bias = p.bias != nullptr ? __ldg(p.bias + n) : 0.f;
            float* o = p.out + ((static_cast<long long>(b) * p.N + n) * p.Ho + ho) * p.Wo;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int wo = wo0 + g + 8 * h;
              if (wo < p.Wo) o[wo] = acc[mt][jn * 4 + h * 2 + e] + bias;
            }
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------- flat (1x1)

struct FlatArgs {
  int C, HW, N, ntn, nchunks, per_image;  // per_image: pixel blocks of an image
  long long ntiles;
  const float* bias;  // (N,) or null
};

template <int MT, int BN, int SB>
struct FlatGeo {
  static constexpr int HALF = 64 * MT;      // flat pixels of one consumer warpgroup
  static constexpr int TM = 2 * HALF;       // flat pixels of a tile
  static constexpr int PLANE = HALF + 8;    // floats of one channel of a warpgroup's box
  static constexpr int BOX_BYTES = KC * PLANE * 4;
  static constexpr int A_BYTES = 2 * BOX_BYTES;  // both warpgroups' boxes
  static constexpr int B_BYTES = 2 * BN * 128;   // big and small parts
  static constexpr int OUT_BYTES = BN * HALF * 4;  // a warpgroup's output box
  static constexpr int BYTES = 1024 + SB * (A_BYTES + B_BYTES) + 2 * OUT_BYTES + 16 * SB;
  static_assert(PLANE % 32 == 8 || PLANE % 32 == 24, "a warp's loads hit 32 banks");
  static_assert(BOX_BYTES % 128 == 0 && A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0 &&
                    OUT_BYTES % 1024 == 0,
                "128-byte aligned boxes, 1024-byte aligned stages");
  static_assert(BYTES <= 232448, "shared memory");
};

// TMA stores: a box of shared memory to the tensor (what lies outside it
// is not written), in bulk groups waited for by the issuing thread
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// wait until this thread's stores have read their shared memory (READ) or
// are complete
template <bool READ>
__device__ __forceinline__ void tma_store_wait() {
  if (READ) {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// y = x (B, C, HW) times w^T per image, plus bias: stage s of the ring holds
// chunk k's two activation boxes and its weight stage, on one barrier; each
// consumer warpgroup writes its output tile into its own box of shared
// memory, which one TMA store copies out while the next tile runs.
template <int MT, int BN, int SB>
__global__ void __launch_bounds__(384, 1)
    conv1x1_tf32x3_kernel(const __grid_constant__ CUtensorMap tma_x,
                          const __grid_constant__ CUtensorMap tma_w,
                          const __grid_constant__ CUtensorMap tma_y, const FlatArgs p) {
  using G = FlatGeo<MT, BN, SB>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sa = smem;
  uint8_t* sb = smem + SB * G::A_BYTES;
  uint8_t* so = sb + SB * G::B_BYTES;  // two output boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(so + 2 * G::OUT_BYTES);
  uint64_t* empty = full + SB;

  const int tid = threadIdx.x;
  const int wg = tid / 128;

  if (tid == 0) {
    for (int s = 0; s < SB; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      int k = 0;  // chunks issued by this block
      for (long long t = blockIdx.x; t < p.ntiles; t += gridDim.x) {
        const int n0 = static_cast<int>(t % p.ntn) * BN;
        const int blk = static_cast<int>(t / p.ntn);
        const int b = blk / p.per_image;
        const int p0 = (blk - b * p.per_image) * G::TM;
        // the second warpgroup's box lies past H W in an image's last tile
        // of at most 64 MT pixels: not loaded, its rows not stored
        const bool two = p0 + G::HALF < p.HW;
        for (int c = 0; c < p.nchunks; ++c, ++k) {
          const int s = k % SB;
          if (k >= SB) mbar_wait(&empty[s], ((k / SB) - 1) & 1);
          mbar_expect_tx(&full[s], (two ? G::A_BYTES : G::BOX_BYTES) + G::B_BYTES);
          uint8_t* a = sa + s * G::A_BYTES;
          tma_load_3d(a, &tma_x, &full[s], p0, c * KC, b);
          if (two) tma_load_3d(a + G::BOX_BYTES, &tma_x, &full[s], p0 + G::HALF, c * KC, b);
          tma_load_4d(sb + s * G::B_BYTES, &tma_w, &full[s], c * KC, n0, 0, 0);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lt = tid & 127;
    const int warp = lt >> 5;
    const int lane = lt & 31;
    const int g = lane >> 2;   // fragment row: pixels g and g + 8
    const int tig = lane & 3;  // fragment column: channels tig and tig + 4
    // the thread's element of its warpgroup's box: channel tig, pixel
    // warp * 16 + g of accumulator 0
    const int lane_off = wg * (G::BOX_BYTES / 4) + tig * G::PLANE + warp * 16 + g;
    // its warpgroup's output box (BN channels x HALF pixels), its element
    float* const obox = reinterpret_cast<float*>(so + wg * G::OUT_BYTES);
    float* const own = obox + 2 * tig * G::HALF + warp * 16 + g;
    float acc[MT][BN / 2];
    int k = 0;
    for (long long t = blockIdx.x; t < p.ntiles; t += gridDim.x) {
      const int n0 = static_cast<int>(t % p.ntn) * BN;
      const int blk = static_cast<int>(t / p.ntn);
      const int b = blk / p.per_image;
      const int p0 = (blk - b * p.per_image) * G::TM;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.f;
      }
      for (int c = 0; c < p.nchunks; ++c, ++k) {
        const int s = k % SB;
        mbar_wait(&full[s], (k / SB) & 1);
        const float* box = reinterpret_cast<const float*>(sa + s * G::A_BYTES) + lane_off;
        const uint8_t* stage = sb + s * G::B_BYTES;
        const int live = p.C - c * KC;
        const int steps = live >= KC ? 4 : (live + 7) / 8;
        k_tile_live<MT, BN, G::PLANE, 64>(steps, acc, box, desc_sw128(stage),
                                          desc_sw128(stage + BN * 128));
        mbar_arrive(&empty[s]);
      }

      // epilogue: acc[mt][jn * 4 + h * 2 + e] is flat pixel mt * 64 + warp *
      // 16 + g + 8 h of the warpgroup's, channel jn * 8 + 2 tig + e. Into the
      // output box once the last tile's store has read it, then stored by
      // TMA (pixels past H W and channels past N are not written).
      if (lt == 0) tma_store_wait<true>();
      warpgroup_sync(wg);
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + jn * 8 + 2 * tig + e;
          const float bias = p.bias != nullptr && n < p.N ? __ldg(p.bias + n) : 0.f;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
              own[(jn * 8 + e) * G::HALF + mt * 64 + 8 * h] = acc[mt][jn * 4 + h * 2 + e] + bias;
          }
        }
      }
      fence_async_shared();
      warpgroup_sync(wg);
      const int q0 = p0 + wg * G::HALF;
      if (lt == 0 && q0 < p.HW) tma_store_3d(&tma_y, obox, q0, n0, b);
    }
    if (lt == 0) tma_store_wait<false>();
  }
}

// ------------------------------------------------------------------ host

// The NCHW float32 input (B, C, H, W), read in boxes of bw x bh pixels x 32
// channels of one image; pixels and channels outside it are zero-filled.
bool encode_x(CUtensorMap* map, const void* x, int B, int C, int H, int W, int bw, int bh) {
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(W) * 4,
                                 static_cast<cuuint64_t>(W) * H * 4,
                                 static_cast<cuuint64_t>(W) * H * C * 4};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(bw), static_cast<cuuint32_t>(bh), KC, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(x), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The split weight (taps, 2, N, Cp), read in boxes of 32 channels x bn rows
// x both parts of one tap into the 128-byte swizzle; rows past N and
// channels past Cp are zero-filled. Encoded once per weight: a map holds
// nothing but the address, shape, stride and box.
bool encode_w(CUtensorMap* map, const void* w, int taps, int N, int Cp, int bn) {
  using Key = std::tuple<const void*, int, int, int, int>;
  static std::mutex lock;
  static std::map<Key, CUtensorMap> cache;
  const Key key{w, taps, N, Cp, bn};
  std::lock_guard<std::mutex> guard(lock);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Cp), static_cast<cuuint64_t>(N), 2,
                              static_cast<cuuint64_t>(taps)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(Cp) * 4,
                                 static_cast<cuuint64_t>(Cp) * N * 4,
                                 static_cast<cuuint64_t>(Cp) * N * 8};
  const cuuint32_t box[4] = {KC, static_cast<cuuint32_t>(bn), 2, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(w), dims, strides, box,
         estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (cache.size() > 8192) cache.clear();
  cache.emplace(key, *map);
  return true;
}

// An NCHW float32 tensor of B images of C channels and HW pixels as (HW, C,
// B), in boxes of bw flat pixels x bc channels of one image: TMA loads
// zero-fill, and stores do not write, what lies past HW or C.
bool encode_flat(CUtensorMap* map, const void* t, int B, int C, int HW, int bw, int bc) {
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(HW), static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(HW) * 4,
                                 static_cast<cuuint64_t>(HW) * C * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(bw), static_cast<cuuint32_t>(bc), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(t), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 132;
  }();
  return n;
}

template <int MT, int BN, int SB>
cudaError_t launch(const void* x, const void* w, int B, ConvArgs p, int Cp, int grid_cap,
                   cudaStream_t stream) {
  using G = Geo<MT, BN, SB>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(conv_tf32x3_kernel<MT, BN, SB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (attr != cudaSuccess) return attr;
  CUtensorMap mx, mw;
  if (!encode_x(&mx, x, B, p.C, p.H, p.W, G::BXW, G::BYH) ||
      !encode_w(&mw, w, p.kh * p.kw, p.N, Cp, BN))
    return cudaErrorInvalidValue;
  p.tiles_w = (p.Wo + G::TW - 1) / G::TW;
  p.tiles_h = (p.Ho + G::TH - 1) / G::TH;
  p.ntn = (p.N + BN - 1) / BN;
  p.ntiles = static_cast<long long>(B) * p.tiles_h * p.tiles_w * p.ntn;
  const int cap = grid_cap > 0 ? grid_cap : sm_count();
  const unsigned grid = static_cast<unsigned>(p.ntiles < cap ? p.ntiles : cap);
  conv_tf32x3_kernel<MT, BN, SB><<<grid, 384, G::BYTES, stream>>>(mx, mw, p);
  return cudaGetLastError();
}

template <int MT, int BN, int SB>
cudaError_t launch_flat(const void* x, const void* w, void* out, int B, FlatArgs p, int Cp,
                        int grid_cap, cudaStream_t stream) {
  using G = FlatGeo<MT, BN, SB>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(conv1x1_tf32x3_kernel<MT, BN, SB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (attr != cudaSuccess) return attr;
  CUtensorMap mx, mw, my;
  if (!encode_flat(&mx, x, B, p.C, p.HW, G::PLANE, KC) || !encode_w(&mw, w, 1, p.N, Cp, BN) ||
      !encode_flat(&my, out, B, p.N, p.HW, G::HALF, BN))
    return cudaErrorInvalidValue;
  p.per_image = (p.HW + G::TM - 1) / G::TM;
  p.ntn = (p.N + BN - 1) / BN;
  p.ntiles = static_cast<long long>(B) * p.per_image * p.ntn;
  const int cap = grid_cap > 0 ? grid_cap : sm_count();
  const unsigned grid = static_cast<unsigned>(p.ntiles < cap ? p.ntiles : cap);
  conv1x1_tf32x3_kernel<MT, BN, SB><<<grid, 384, G::BYTES, stream>>>(mx, mw, my, p);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// y = conv2d(x, w) + bias, stride 1, by split TF32. x: NCHW float32 (B, C,
// H, W), W a multiple of 4, 16-byte aligned; w: the split weight (kh kw, 2,
// N, Cp) float32, Cp >= C a multiple of 4; bias (N,) or null; out (B, N,
// Ho, Wo) with Ho = H + 2 ph - kh + 1, Wo = W + 2 pw - kw + 1. (mt, bn, sb):
// the instance, from the wrapper's plan; grid_cap > 0 caps the persistent
// grid (0: one block an SM).
extern "C" int s2m2_conv_tf32x3(const void* x, const void* w, const void* bias, void* out,
                                int B, int C, int H, int W, int N, int Cp, int kh, int kw,
                                int ph, int pw, int mt, int bn, int sb, int grid_cap,
                                void* stream) {
  const int Ho = H + 2 * ph - kh + 1;
  const int Wo = W + 2 * pw - kw + 1;
  if (B < 1 || C < 1 || H < 1 || W < 1 || W % 4 != 0 || N < 1 || Cp < C || Cp % 4 != 0 ||
      kh < 1 || kh > 3 || kw < 1 || kw - pw > 5 || ph < 0 || pw < 0 || pw > 4 || Ho < 1 ||
      Wo < 1 ||
      !aligned16(x) || !aligned16(w) || out == nullptr || grid_cap < 0 ||
      static_cast<long long>(B) * N * Ho * Wo >= (1LL << 40))
    return cudaErrorInvalidValue;
  ConvArgs p;
  std::memset(&p, 0, sizeof(p));
  p.C = C;
  p.H = H;
  p.W = W;
  p.N = N;
  p.Ho = Ho;
  p.Wo = Wo;
  p.kh = kh;
  p.kw = kw;
  p.ph = ph;
  p.pw = pw;
  p.nchunks = (C + KC - 1) / KC;
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define S2M2_CONV_CASE(MT, BN, SB) \
  if (mt == MT && bn == BN && sb == SB) return launch<MT, BN, SB>(x, w, B, p, Cp, grid_cap, s);
  S2M2_CONV_INSTANCES(S2M2_CONV_CASE)
#undef S2M2_CONV_CASE
  return cudaErrorInvalidValue;  // a plan this build was not compiled for
}

// y = conv2d(x, w) + bias for a 1x1 w, stride 1, no padding, by split TF32
// on the flat path. x: NCHW float32 (B, C, H, W) with HW = H W a multiple
// of 4, 16-byte aligned; w: the split weight (1, 2, N, Cp) float32, Cp >= C
// a multiple of 4; bias (N,) or null; out (B, N, H, W). (mt, bn, sb): the
// flat instance, from the wrapper's plan; grid_cap as above.
extern "C" int s2m2_conv1x1_tf32x3(const void* x, const void* w, const void* bias, void* out,
                                   int B, int C, int HW, int N, int Cp, int mt, int bn,
                                   int sb, int grid_cap, void* stream) {
  if (B < 1 || C < 1 || HW < 1 || HW % 4 != 0 || N < 1 || Cp < C || Cp % 4 != 0 ||
      !aligned16(x) || !aligned16(w) || !aligned16(out) || grid_cap < 0 ||
      static_cast<long long>(B) * N * HW >= (1LL << 40) ||
      static_cast<long long>(B) * C * HW >= (1LL << 40))
    return cudaErrorInvalidValue;
  FlatArgs p;
  std::memset(&p, 0, sizeof(p));
  p.C = C;
  p.HW = HW;
  p.N = N;
  p.nchunks = (C + KC - 1) / KC;
  p.bias = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define S2M2_CONV1X1_CASE(MT, BN, SB) \
  if (mt == MT && bn == BN && sb == SB)   \
    return launch_flat<MT, BN, SB>(x, w, out, B, p, Cp, grid_cap, s);
  S2M2_CONV1X1_INSTANCES(S2M2_CONV1X1_CASE)
#undef S2M2_CONV1X1_CASE
  return cudaErrorInvalidValue;  // a plan this build was not compiled for
}

extern "C" const char* s2m2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
