// Bilinear affine warps for the real-data loaders, host side (uint8 in;
// float32 [0, 1] or rounded uint8 out), across a std::thread pool.
//
// The port's own copy of the warps in native/imgproc.cpp (lines 73-258 there),
// code for code, so a build with native/build.sh's flags on one host gives the
// JAX package's bytes. It needs only g++: data/native.py builds it at first use
// with `g++ -O3 -march=native -shared -fPIC` into build/hifihr_tpu_torch/ and
// loads it with ctypes. The JPEG decode is a separate source
// (jpeg_libjpeg.cpp), since libjpeg's header is not on every host.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Bilinear affine warp of one HxWxC uint8 image into out_h x out_w float32.
// affine maps SOURCE pixel coords -> DEST coords (same convention as
// handutils.get_affine_transform); we invert internally.
static void warp_one(const uint8_t* src, int h, int w, int c,
                     const float* affine, float* dst, int out_h, int out_w) {
  // invert 3x3 (affine, last row 0 0 1)
  float a = affine[0], b = affine[1], tx = affine[2];
  float d = affine[3], e = affine[4], ty = affine[5];
  float det = a * e - b * d;
  if (std::fabs(det) < 1e-12f) det = 1e-12f;
  float ia = e / det, ib = -b / det, id = -d / det, ie = a / det;
  float itx = -(ia * tx + ib * ty), ity = -(id * tx + ie * ty);

  constexpr float kInv255 = 1.f / 255.f;
  for (int y = 0; y < out_h; y++) {
    for (int x = 0; x < out_w; x++) {
      float sx = ia * x + ib * y + itx;
      float sy = id * x + ie * y + ity;
      int x0 = (int)std::floor(sx), y0 = (int)std::floor(sy);
      float fx = sx - x0, fy = sy - y0;
      // bilinear tap weights hoisted out of the channel loop
      float w00 = (1 - fx) * (1 - fy) * kInv255;
      float w01 = fx * (1 - fy) * kInv255;
      float w10 = (1 - fx) * fy * kInv255;
      float w11 = fx * fy * kInv255;
      float* out = dst + ((size_t)y * out_w + x) * c;
      if (x0 >= 0 && x0 + 1 < w && y0 >= 0 && y0 + 1 < h) {
        // interior fast path: no per-tap bounds checks
        const uint8_t* p00 = src + ((size_t)y0 * w + x0) * c;
        const uint8_t* p10 = p00 + (size_t)w * c;
        for (int ch = 0; ch < c; ch++) {
          out[ch] = p00[ch] * w00 + p00[c + ch] * w01 + p10[ch] * w10 +
                    p10[c + ch] * w11;
        }
      } else {
        for (int ch = 0; ch < c; ch++) {
          auto sample = [&](int yy, int xx) -> float {
            if (yy < 0 || yy >= h || xx < 0 || xx >= w) return 0.f;
            return src[((size_t)yy * w + xx) * c + ch];
          };
          out[ch] = sample(y0, x0) * w00 + sample(y0, x0 + 1) * w01 +
                    sample(y0 + 1, x0) * w10 + sample(y0 + 1, x0 + 1) * w11;
        }
      }
    }
  }
}

// uint8-output variant of warp_one: bilinear in u8 domain, rounded to u8.
// Keeps the loader output uint8 end-to-end, so the host-to-device copy is 4x
// smaller than float32 (a 224^2 batch of 64 is 9.6 MB u8, 38.5 MB f32).
//
// 16.16 FIXED-POINT inner loop: the source coordinate advances by a constant
// fixed-point increment per output pixel (no per-pixel float mul/floor), the
// bilinear weights are 8-bit fractions and all taps accumulate in integers
// (max error ±1 LSB vs the float path — the float path itself truncates to
// u8). Once decoded frames are cached, this warp is the loader's per-sample
// work.
}  // extern "C" — internal helpers below don't need C linkage

template <int C>
static void warp_u8_rows(const uint8_t* src, int h, int w, const int64_t fx0,
                         const int64_t fy0, const int64_t dxx,
                         const int64_t dyx, const int64_t dxy,
                         const int64_t dyy, uint8_t* dst, int out_h,
                         int out_w) {
  for (int y = 0; y < out_h; y++) {
    int64_t sx = dxy * y + fx0;
    int64_t sy = dyy * y + fy0;
    uint8_t* out = dst + (size_t)y * out_w * C;
    for (int x = 0; x < out_w; x++, sx += dxx, sy += dyx, out += C) {
      int x0 = (int)(sx >> 16), y0 = (int)(sy >> 16);
      uint32_t fx = (uint32_t)(sx & 0xffff) >> 8;  // 0..255
      uint32_t fy = (uint32_t)(sy & 0xffff) >> 8;
      uint32_t w00 = (256 - fx) * (256 - fy), w01 = fx * (256 - fy);
      uint32_t w10 = (256 - fx) * fy, w11 = fx * fy;  // sum == 65536
      if (x0 >= 0 && x0 + 1 < w && y0 >= 0 && y0 + 1 < h) {
        const uint8_t* p00 = src + ((size_t)y0 * w + x0) * C;
        const uint8_t* p10 = p00 + (size_t)w * C;
        for (int ch = 0; ch < C; ch++) {
          uint32_t v = p00[ch] * w00 + p00[C + ch] * w01 + p10[ch] * w10 +
                       p10[C + ch] * w11;
          out[ch] = (uint8_t)((v + 32768u) >> 16);
        }
      } else {
        for (int ch = 0; ch < C; ch++) {
          auto sample = [&](int yy, int xx) -> uint32_t {
            if (yy < 0 || yy >= h || xx < 0 || xx >= w) return 0u;
            return src[((size_t)yy * w + xx) * C + ch];
          };
          uint32_t v = sample(y0, x0) * w00 + sample(y0, x0 + 1) * w01 +
                       sample(y0 + 1, x0) * w10 + sample(y0 + 1, x0 + 1) * w11;
          out[ch] = (uint8_t)((v + 32768u) >> 16);
        }
      }
    }
  }
}

static void warp_one_u8(const uint8_t* src, int h, int w, int c,
                        const float* affine, uint8_t* dst, int out_h,
                        int out_w) {
  float a = affine[0], b = affine[1], tx = affine[2];
  float d = affine[3], e = affine[4], ty = affine[5];
  float det = a * e - b * d;
  if (std::fabs(det) < 1e-12f) det = 1e-12f;
  float ia = e / det, ib = -b / det, id = -d / det, ie = a / det;
  float itx = -(ia * tx + ib * ty), ity = -(id * tx + ie * ty);

  const double FX = 65536.0;
  int64_t dxx = (int64_t)llround((double)ia * FX);
  int64_t dyx = (int64_t)llround((double)id * FX);
  int64_t dxy = (int64_t)llround((double)ib * FX);
  int64_t dyy = (int64_t)llround((double)ie * FX);
  int64_t fx0 = (int64_t)llround((double)itx * FX);
  int64_t fy0 = (int64_t)llround((double)ity * FX);
  if (c == 3) {
    warp_u8_rows<3>(src, h, w, fx0, fy0, dxx, dyx, dxy, dyy, dst, out_h, out_w);
  } else if (c == 1) {
    warp_u8_rows<1>(src, h, w, fx0, fy0, dxx, dyx, dxy, dyy, dst, out_h, out_w);
  } else {  // generic channel count: same fixed-point math, runtime c
    for (int y = 0; y < out_h; y++) {
      int64_t sx = dxy * y + fx0;
      int64_t sy = dyy * y + fy0;
      for (int x = 0; x < out_w; x++, sx += dxx, sy += dyx) {
        int x0 = (int)(sx >> 16), y0 = (int)(sy >> 16);
        uint32_t fx = (uint32_t)(sx & 0xffff) >> 8;
        uint32_t fy = (uint32_t)(sy & 0xffff) >> 8;
        uint32_t w00 = (256 - fx) * (256 - fy), w01 = fx * (256 - fy);
        uint32_t w10 = (256 - fx) * fy, w11 = fx * fy;
        uint8_t* out = dst + ((size_t)y * out_w + x) * c;
        for (int ch = 0; ch < c; ch++) {
          auto sample = [&](int yy, int xx) -> uint32_t {
            if (yy < 0 || yy >= h || xx < 0 || xx >= w) return 0u;
            return src[((size_t)yy * w + xx) * c + ch];
          };
          uint32_t v = sample(y0, x0) * w00 + sample(y0, x0 + 1) * w01 +
                       sample(y0 + 1, x0) * w10 + sample(y0 + 1, x0 + 1) * w11;
          out[ch] = (uint8_t)((v + 32768u) >> 16);
        }
      }
    }
  }
}

extern "C" {

// Batched warp across a thread pool.
// srcs: B contiguous images (h*w*c u8); affines: B 3x3 row-major f32;
// dsts: B out_h*out_w*c f32.
void warp_affine_batch(const uint8_t* srcs, int batch, int h, int w, int c,
                       const float* affines, float* dsts, int out_h, int out_w,
                       int n_threads) {
  if (n_threads <= 0)
    n_threads = std::max(1u, std::thread::hardware_concurrency());
  n_threads = std::min(n_threads, batch);
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; t++) {
    pool.emplace_back([=]() {
      for (int i = t; i < batch; i += n_threads) {
        warp_one(srcs + (size_t)i * h * w * c, h, w, c, affines + (size_t)i * 9,
                 dsts + (size_t)i * out_h * out_w * c, out_h, out_w);
      }
    });
  }
  for (auto& th : pool) th.join();
}

// Same, uint8 output.
void warp_affine_batch_u8(const uint8_t* srcs, int batch, int h, int w, int c,
                          const float* affines, uint8_t* dsts, int out_h,
                          int out_w, int n_threads) {
  if (n_threads <= 0)
    n_threads = std::max(1u, std::thread::hardware_concurrency());
  n_threads = std::min(n_threads, batch);
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; t++) {
    pool.emplace_back([=]() {
      for (int i = t; i < batch; i += n_threads) {
        warp_one_u8(srcs + (size_t)i * h * w * c, h, w, c,
                    affines + (size_t)i * 9,
                    dsts + (size_t)i * out_h * out_w * c, out_h, out_w);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
