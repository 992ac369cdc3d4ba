// Native host-side preprocessing for the s2m2_torch data path.
//
// The engine consumes padded NHWC float32 frames; everything before that
// boundary (rectification remap, blurred-fill padding, normalization) runs on
// the host CPU. The reference delegates this to OpenCV's C++ kernels
// (reference: src/s2m2/core/utils/image_utils.py:108-136 uses cv2.remap);
// this is a dependency-free, multi-threaded implementation, exposed to
// Python via ctypes (see native/__init__.py, which builds it with g++ into
// build/s2m2_torch/ at first use). The arithmetic is that of
// s2m2_tpu/native/preprocess.cpp; the loops that the JAX package's copy
// shares out with OpenMP are shared out here by `parallel_for` over
// std::thread (the same contiguous ranges as schedule(static)), because a
// g++ may ship without OpenMP's runtime, and then -fopenmp fails ("cannot
// read spec file 'libgomp.spec'").

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <sched.h>
#include <thread>
#include <vector>

namespace {

// The CPUs this process may run on (its affinity mask: a container's share,
// where hardware_concurrency() would count the whole host).
int64_t cpu_count() {
  cpu_set_t set;
  if (sched_getaffinity(0, sizeof(set), &set) == 0) return std::max(1, CPU_COUNT(&set));
  return std::max(1u, std::thread::hardware_concurrency());
}

// body(i) for every i in [0, n), on up to cpu_count() threads,
// each taking one contiguous range of i; the calling thread takes the first.
// If a thread cannot be started, the calling thread runs its range too.
template <typename Body>
void parallel_for(int64_t n, Body body) {
  const int64_t t = std::min<int64_t>(cpu_count(), n);
  auto range = [&](int64_t k) {
    for (int64_t i = n * k / t, end = n * (k + 1) / t; i < end; ++i) body(i);
  };
  std::vector<std::thread> pool;
  int64_t started = 1;
  try {
    for (; started < t; ++started) pool.emplace_back(range, started);
  } catch (...) {
  }
  for (int64_t k = started; k < t; ++k) range(k);
  if (t > 0) range(0);
  for (auto& th : pool) th.join();
}

// One output row of remap_bilinear_u8. Its own function, so that the sizes
// and pointers are values in registers: the uint8 stores may alias any
// memory, and through a lambda's captures every one would force them to be
// loaded again.
void remap_row(const uint8_t* img, int h, int w, int c, const float* map_x,
               const float* map_y, int w_out, uint8_t* out, int y) {
  for (int x = 0; x < w_out; ++x) {
    const int idx = y * w_out + x;
    const float sx = map_x[idx];
    const float sy = map_y[idx];
    const int x0 = (int)std::floor(sx);
    const int y0 = (int)std::floor(sy);
    const float ax = sx - x0;
    const float ay = sy - y0;
    uint8_t* dst = out + (size_t)idx * c;
    // gather the 4 neighbors with zero border
    for (int ch = 0; ch < c; ++ch) {
      float acc = 0.f;
      for (int dy = 0; dy < 2; ++dy) {
        const int yy = y0 + dy;
        if (yy < 0 || yy >= h) continue;
        const float wy = dy ? ay : 1.f - ay;
        for (int dx = 0; dx < 2; ++dx) {
          const int xx = x0 + dx;
          if (xx < 0 || xx >= w) continue;
          const float wx = dx ? ax : 1.f - ax;
          acc += wy * wx * img[((size_t)yy * w + xx) * c + ch];
        }
      }
      dst[ch] = (uint8_t)std::lround(std::min(255.f, std::max(0.f, acc)));
    }
  }
}

}  // namespace

extern "C" {

// Bilinear remap (stereo rectification): out[y, x] = img[mapY[y,x], mapX[y,x]]
// with zero border, matching cv2.remap(INTER_LINEAR, BORDER_CONSTANT).
// img: (h, w, c) uint8, maps: (h_out, w_out) float32, out: (h_out, w_out, c).
void remap_bilinear_u8(const uint8_t* img, int h, int w, int c,
                       const float* map_x, const float* map_y,
                       int h_out, int w_out, uint8_t* out) {
  parallel_for(h_out, [=](int64_t y) {
    remap_row(img, h, w, c, map_x, map_y, w_out, out, (int)y);
  });
}

// Blurred-fill padding (reference image_pad semantics, image_utils.py:27-71):
// zero-pad to (h_new, w_new), adaptive-average-pool the padded image to
// (h/factor, w/factor), bilinearly resize (half-pixel centers) back to the
// padded size, then paste the original image into the interior.
// img: (h, w, c) float32, out: (h_new, w_new, c) float32.
void image_pad_blur_f32(const float* img, int h, int w, int c, int factor,
                        float* out, float* scratch /* >= (h/f)*(w/f)*c */) {
  const int h_new = (h + factor - 1) / factor * factor;
  const int w_new = (w + factor - 1) / factor * factor;
  const int pad_h = h_new - h, pad_w = w_new - w;
  const int hs = pad_h / 2, ws = pad_w / 2;
  const int dh = h / factor > 0 ? h / factor : 1;
  const int dw = w / factor > 0 ? w / factor : 1;

  // adaptive average pool of the zero-padded image into scratch (dh, dw, c)
  parallel_for(dh, [&](int64_t i) {
    const int ys = (int)((int64_t)i * h_new / dh);
    const int ye = (int)(((int64_t)(i + 1) * h_new + dh - 1) / dh);
    for (int j = 0; j < dw; ++j) {
      const int xs = (int)((int64_t)j * w_new / dw);
      const int xe = (int)(((int64_t)(j + 1) * w_new + dw - 1) / dw);
      float* cell = scratch + ((size_t)i * dw + j) * c;
      for (int ch = 0; ch < c; ++ch) cell[ch] = 0.f;
      for (int y = ys; y < ye; ++y) {
        const int iy = y - hs;  // position in the original image
        if (iy < 0 || iy >= h) continue;
        for (int x = xs; x < xe; ++x) {
          const int ix = x - ws;
          if (ix < 0 || ix >= w) continue;
          const float* src = img + ((size_t)iy * w + ix) * c;
          for (int ch = 0; ch < c; ++ch) cell[ch] += src[ch];
        }
      }
      const float inv = 1.f / ((ye - ys) * (xe - xs));
      for (int ch = 0; ch < c; ++ch) cell[ch] *= inv;
    }
  });

  // bilinear resize scratch (dh, dw) -> out (h_new, w_new), torch
  // align_corners=False semantics (weights from the unclamped floor)
  parallel_for(h_new, [&](int64_t y) {
    const float fy = (y + 0.5f) * dh / h_new - 0.5f;
    const float y0f = std::floor(fy);
    const int y0 = std::min(std::max((int)y0f, 0), dh - 1);
    const int y1 = std::min(std::max((int)y0f + 1, 0), dh - 1);
    const float wy = fy - y0f;
    for (int x = 0; x < w_new; ++x) {
      const float fx = (x + 0.5f) * dw / w_new - 0.5f;
      const float x0f = std::floor(fx);
      const int x0 = std::min(std::max((int)x0f, 0), dw - 1);
      const int x1 = std::min(std::max((int)x0f + 1, 0), dw - 1);
      const float wx = fx - x0f;
      float* dst = out + ((size_t)y * w_new + x) * c;
      const float* p00 = scratch + ((size_t)y0 * dw + x0) * c;
      const float* p01 = scratch + ((size_t)y0 * dw + x1) * c;
      const float* p10 = scratch + ((size_t)y1 * dw + x0) * c;
      const float* p11 = scratch + ((size_t)y1 * dw + x1) * c;
      for (int ch = 0; ch < c; ++ch) {
        const float top = p00[ch] * (1 - wx) + p01[ch] * wx;
        const float bot = p10[ch] * (1 - wx) + p11[ch] * wx;
        dst[ch] = top * (1 - wy) + bot * wy;
      }
    }
  });

  // paste the original interior
  parallel_for(h, [&](int64_t y) {
    std::memcpy(out + (((size_t)(y + hs) * w_new) + ws) * c,
                img + (size_t)y * w * c, (size_t)w * c * sizeof(float));
  });
}

// uint8 HWC -> float32 HWC (simple typed copy, threaded; feeds image_pad)
void u8_to_f32(const uint8_t* src, int64_t n, float* dst) {
  parallel_for(n, [&](int64_t i) { dst[i] = (float)src[i]; });
}

}  // extern "C"
