// K5: SSIM with the 11-tap Gaussian window, forward and backward, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes SSIM's five moments with
// lax.conv_general_dilated (hifihr_tpu/losses/ssim.py), outside any Pallas
// kernel. Added because the port's plain route, one grouped F.conv2d of the
// dense 11 x 11 window over the 15 stacked channels [x, y, x^2, y^2, xy] and
// some 20 elementwise ops each way, took 28.7 ms of the flagship train
// step's 71.8 ms of device time on an H100 (two calls at (64, 224, 224, 3)),
// about 100x what the card needs for the same work.
//
// Contract (losses/ssim.py::ssim_partials_plain is the plain version):
//   x, y (B, H, W, C) fp32, NHWC contiguous, 1 <= C <= 4; win the normalised
//   11-tap Gaussian (sigma 1.5) in fp32. mu_x, mu_y, E[x^2], E[y^2], E[xy]
//   are the window's correlation over the image, zero padded (SAME);
//   sigma_x^2 = E[x^2] - mu_x^2 (and so on, as the reference computes them),
//   A1 = 2 mu_x mu_y + c1, A2 = 2 sigma_xy + c2, B1 = mu_x^2 + mu_y^2 + c1,
//   B2 = sigma_x^2 + sigma_y^2 + c2, S = A1 A2 / (B1 B2), c1 = 0.01^2,
//   c2 = 0.03^2; the value is the mean of S over B H W C.
//   Forward, when a gradient is wanted, also writes the per-pixel partials
//     a  = dS/dmu_x  = 2 mu_y (A2 - A1) / (B1 B2) + 2 mu_x S (1/B2 - 1/B1)
//     b  = dS/dE[x^2] = dS/dE[y^2] = -S / B2
//     c  = dS/dE[xy] = 2 A1 / (B1 B2)
//     a' = dS/dmu_y (only when y wants a gradient)
//   and backward computes, with G the window and g the output's gradient,
//     dx = (g / N) (G*a + 2 x (G*b) + y (G*c))
//     dy = (g / N) (G*a' + 2 y (G*b) + x (G*c))
//   (G is symmetric and the moments are zero padded, so the transpose is the
//   same separable filter over the zero-padded partial maps).
//
// What bounds it on this card: bytes. At the flagship's (64, 224, 224, 3)
// the forward reads x and y (77 MB) and writes a, b, c (116 MB), 0.058 ms at
// 3.35 TB/s; 2 x 11 taps of five maps are ~2.1 GFLOP, 0.032 ms at 67 TFLOP/s
// of fp32. The backward reads x, y, a, b, c and writes dx (231 MB, 0.069 ms).
//
// Design. The window is separable, so each moment is two 1-D passes of 11
// taps instead of 121 products. One block takes a tile of one image: 32 rows
// by 96 floats of a row (96 / C pixels, every channel), with x and y (or the
// partial maps) staged in shared memory with a 5-pixel halo, zeros outside
// the image. A row of the tile is 96 consecutive floats, so a thread takes
// one float column and reads its horizontal taps C floats apart, without
// bank conflicts. Each thread walks 16 output rows of its column: it forms
// the horizontal sums of the 26 staged rows they need one row at a time,
// keeps the last 11 in registers (rows go in chunks of 11 with each chunk's
// loop unrolled, so the ring is indexed statically) and takes the vertical
// pass from there; no horizontal result goes through shared memory. The
// passes' sums are fused multiply-adds in a fixed order. The forward writes
// one partial sum of S per block and a second launch of one block adds them
// in a fixed order: no atomics, so the value is the same from run to run. A
// thread sums its 16 values of S in fp32; the sums across threads and blocks
// are float64, so the value is the fp32 S map's mean rounded once, whatever
// the tiling.

#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 11;
constexpr int kHalo = kTaps / 2;
constexpr int kLanes = 96;  // floats of a tile row: 96 / C pixels, C channels each
constexpr int kRowsPerThread = 16;
constexpr int kGroups = 2;  // threads stacked over a tile's rows
constexpr int kTileRows = kRowsPerThread * kGroups;
constexpr int kInRows = kTileRows + 2 * kHalo;           // staged rows of a tile
constexpr int kThreadRows = kRowsPerThread + 2 * kHalo;  // staged rows one thread reads
constexpr int kMaxInLanes = kLanes + 2 * kHalo * 4;      // staged floats of a row at C = 4
constexpr int kThreads = kLanes * kGroups;
constexpr int kSumThreads = 1024;
// c1 = 0.01^2 and c2 = 0.03^2 rounded to fp32, as the reference's Python
// floats are when they meet fp32 tensors
constexpr float kC1 = 1e-4f;
constexpr float kC2 = 9e-4f;

struct Tile {
  int b, h0, lane0;  // image, first output row, first output float of a row
};

__device__ __forceinline__ Tile tile_of(int tiles_h, int tiles_w) {
  const int per_image = tiles_h * tiles_w;
  const int b = blockIdx.x / per_image;
  const int r = blockIdx.x - b * per_image;
  const int th = r / tiles_w;
  return {b, th * kTileRows, (r - th * tiles_w) * kLanes};
}

// Start s[r * in_lanes + l] = src(b, h0 - 5 + r, lane0 - 5 C + l), 0 outside
// the image, as asynchronous copies (cp.async, zero-filled where the source
// size is 0): a thread's loads are all in flight at once, where a load and
// a shared store in turn would wait on each load. stage_wait completes them.
__device__ __forceinline__ void stage(const float* __restrict__ src, Tile t, int H, int row_floats, int C,
                                      int in_lanes, float* __restrict__ s) {
  const float* img = src + (size_t)t.b * H * row_floats;
  for (int r = threadIdx.y; r < kInRows; r += kGroups) {
    const int h = t.h0 - kHalo + r;
    const bool row_ok = h >= 0 && h < H;
    for (int l = threadIdx.x; l < in_lanes; l += kLanes) {
      const int gl = t.lane0 - kHalo * C + l;
      const bool ok = row_ok && gl >= 0 && gl < row_floats;
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(s + r * in_lanes + l));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                   "l"(ok ? img + (size_t)h * row_floats + gl : img), "r"(ok ? 4 : 0));
    }
  }
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// The block's sum of v in a fixed order (warp shuffles, then the warps in
// turn); the result is thread 0's. The block is a whole number of warps.
__device__ __forceinline__ double block_sum(double v, double* warp_sums) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if ((tid & 31) == 0) warp_sums[tid >> 5] = v;
  __syncthreads();
  double total = 0.0;
  if (tid == 0) {
    for (int w = 0; w < (int)(blockDim.x * blockDim.y) / 32; ++w) total += warp_sums[w];
  }
  return total;
}

// One 11-tap horizontal pass of kN staged planes at one float column: h[m] =
// sum_k win[k] s_m[row, lane + k C] (the planes `plane` floats apart).
template <int kN>
__device__ __forceinline__ void horizontal(const float* __restrict__ s, int plane, int C, const float (&g)[kTaps],
                                           float (&h)[kN]) {
#pragma unroll
  for (int m = 0; m < kN; ++m) h[m] = 0.0f;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
#pragma unroll
    for (int m = 0; m < kN; ++m) h[m] = __fmaf_rn(g[k], s[m * plane + k * C], h[m]);
  }
}

// kMaps: 0 (the value alone), 3 (also a, b, c) or 4 (also a'). Three blocks
// an SM (96 registers; the compiler takes 138 and two blocks without the
// bound): 0.258 against 0.315 ms at (64, 224, 224, 3) on an H100.
template <int kMaps>
__global__ void __launch_bounds__(kThreads, 3)
ssim_forward_kernel(const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ win,
                    int H, int W, int C, int tiles_h, int tiles_w, double* __restrict__ partial,
                    float* __restrict__ maps, size_t plane) {
  __shared__ float sx[kInRows * kMaxInLanes];
  __shared__ float sy[kInRows * kMaxInLanes];
  __shared__ double warp_sums[kThreads / 32];
  const Tile t = tile_of(tiles_h, tiles_w);
  const int row_floats = W * C;
  const int in_lanes = kLanes + 2 * kHalo * C;
  stage(x, t, H, row_floats, C, in_lanes, sx);
  stage(y, t, H, row_floats, C, in_lanes, sy);
  float g[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) g[k] = __ldg(win + k);
  stage_wait();

  const int lane = threadIdx.x;
  const int r0 = threadIdx.y * kRowsPerThread;  // this thread's first staged row and first output row
  const int gl = t.lane0 + lane;
  const bool lane_ok = gl < row_floats;
  const size_t base = ((size_t)t.b * H + t.h0 + r0) * row_floats + gl;
  // horizontal sums of mu_x, mu_y, E[x^2], E[y^2], E[xy] of the last 11
  // staged rows, row i in slot i % 11: the rows go in chunks of 11 with the
  // chunk's loop unrolled, so every slot index is a constant
  float ring[5][kTaps];
  float acc = 0.0f;
#pragma unroll 1
  for (int c = 0; c < kThreadRows; c += kTaps) {
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      const int i = c + j;  // staged row, of this thread's
      if (i >= kThreadRows) break;
      const float* px = sx + (r0 + i) * in_lanes + lane;
      const float* py = sy + (r0 + i) * in_lanes + lane;
      float h[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const float xv = px[k * C], yv = py[k * C];
        h[0] = __fmaf_rn(g[k], xv, h[0]);
        h[1] = __fmaf_rn(g[k], yv, h[1]);
        h[2] = __fmaf_rn(g[k], xv * xv, h[2]);
        h[3] = __fmaf_rn(g[k], yv * yv, h[3]);
        h[4] = __fmaf_rn(g[k], xv * yv, h[4]);
      }
#pragma unroll
      for (int m = 0; m < 5; ++m) ring[m][j] = h[m];
      if (i < 2 * kHalo) continue;
      const int o = i - 2 * kHalo;  // output row, of this thread's; row o + k sits in slot (j + 1 + k) % 11
      float v[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
#pragma unroll
        for (int m = 0; m < 5; ++m) v[m] = __fmaf_rn(g[k], ring[m][(j + 1 + k) % kTaps], v[m]);
      }
      if (!lane_ok || t.h0 + r0 + o >= H) continue;
      const float mu1 = v[0], mu2 = v[1];
      const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu12 = mu1 * mu2;
      const float sigma1_sq = v[2] - mu1_sq, sigma2_sq = v[3] - mu2_sq, sigma12 = v[4] - mu12;
      const float a1 = 2.0f * mu12 + kC1, a2 = 2.0f * sigma12 + kC2;
      const float b1 = mu1_sq + mu2_sq + kC1, b2 = sigma1_sq + sigma2_sq + kC2;
      const float d = b1 * b2;
      const float s = (a1 * a2) / d;
      acc += s;
      if constexpr (kMaps > 0) {
        float* mp = maps + base + (size_t)o * row_floats;
        const float lean = 1.0f / b2 - 1.0f / b1;
        mp[0] = 2.0f * mu2 * (a2 - a1) / d + 2.0f * mu1 * s * lean;
        mp[plane] = -s / b2;
        mp[2 * plane] = 2.0f * a1 / d;
        if constexpr (kMaps == 4) mp[3 * plane] = 2.0f * mu1 * (a2 - a1) / d + 2.0f * mu2 * s * lean;
      }
    }
  }
  const double total = block_sum(acc, warp_sums);
  if (threadIdx.x == 0 && threadIdx.y == 0) partial[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kSumThreads)
ssim_sum_kernel(const double* __restrict__ partial, int n, long long count, float* __restrict__ out) {
  __shared__ double warp_sums[kSumThreads / 32];
  double v = 0.0;
  for (int i = threadIdx.x; i < n; i += kSumThreads) v += partial[i];
  const double total = block_sum(v, warp_sums);
  if (threadIdx.x == 0) out[0] = (float)(total / (double)count);
}

// kDy: also dy (then the maps are a, b, c, a'; else a, b, c).
template <bool kDy>
__global__ void __launch_bounds__(kThreads)
ssim_backward_kernel(const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ maps,
                     size_t plane, const float* __restrict__ win, const float* __restrict__ grad, long long count,
                     int H, int W, int C, int tiles_h, int tiles_w, float* __restrict__ dx,
                     float* __restrict__ dy) {
  constexpr int kMaps = kDy ? 4 : 3;
  extern __shared__ float s[];  // kMaps staged planes of kInRows x in_lanes
  const Tile t = tile_of(tiles_h, tiles_w);
  const int row_floats = W * C;
  const int in_lanes = kLanes + 2 * kHalo * C;
  const int splane = kInRows * in_lanes;
  for (int m = 0; m < kMaps; ++m) stage(maps + m * plane, t, H, row_floats, C, in_lanes, s + m * splane);
  float g[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) g[k] = __ldg(win + k);
  const float scale = __ldg(grad) / (float)count;
  stage_wait();

  const int lane = threadIdx.x;
  const int r0 = threadIdx.y * kRowsPerThread;
  const int gl = t.lane0 + lane;
  const bool lane_ok = gl < row_floats;
  const size_t base = ((size_t)t.b * H + t.h0 + r0) * row_floats + gl;
  float ring[kMaps][kTaps];  // as the forward's: staged row i in slot i % 11
#pragma unroll 1
  for (int c = 0; c < kThreadRows; c += kTaps) {
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      const int i = c + j;
      if (i >= kThreadRows) break;
      float h[kMaps];
      horizontal<kMaps>(s + (r0 + i) * in_lanes + lane, splane, C, g, h);
#pragma unroll
      for (int m = 0; m < kMaps; ++m) ring[m][j] = h[m];
      if (i < 2 * kHalo) continue;
      const int o = i - 2 * kHalo;
      float v[kMaps];
#pragma unroll
      for (int m = 0; m < kMaps; ++m) v[m] = 0.0f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
#pragma unroll
        for (int m = 0; m < kMaps; ++m) v[m] = __fmaf_rn(g[k], ring[m][(j + 1 + k) % kTaps], v[m]);
      }
      if (!lane_ok || t.h0 + r0 + o >= H) continue;
      const size_t off = base + (size_t)o * row_floats;
      const float xv = __ldg(x + off), yv = __ldg(y + off);
      dx[off] = scale * (v[0] + 2.0f * xv * v[1] + yv * v[2]);
      if constexpr (kDy) dy[off] = scale * (v[3] + 2.0f * yv * v[1] + xv * v[2]);
    }
  }
}

int tiles_h_of(int H) { return (H + kTileRows - 1) / kTileRows; }
int tiles_w_of(int W, int C) { return (W * C + kLanes - 1) / kLanes; }

}  // namespace

// The blocks of a forward launch: the length of its partial sums.
extern "C" int hifihr_ssim_blocks(int B, int H, int W, int C) {
  return B * tiles_h_of(H) * tiles_w_of(W, C);
}

// Each function below makes one launch on `stream`, does not synchronise,
// and returns its cudaError_t (0 on success).

// partial: hifihr_ssim_blocks doubles; maps (n_maps, B, H, W, C), n_maps 0, 3 or 4.
extern "C" int hifihr_ssim_forward(const float* x, const float* y, const float* win, int B, int H, int W, int C,
                                   int n_maps, double* partial, float* maps, void* stream) {
  if (C < 1 || C > 4) return (int)cudaErrorInvalidValue;
  const int th = tiles_h_of(H), tw = tiles_w_of(W, C);
  const size_t plane = (size_t)B * H * W * C;
  const dim3 block(kLanes, kGroups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)(B * th * tw);
  if (n_maps == 0) {
    ssim_forward_kernel<0><<<grid, block, 0, st>>>(x, y, win, H, W, C, th, tw, partial, maps, plane);
  } else if (n_maps == 3) {
    ssim_forward_kernel<3><<<grid, block, 0, st>>>(x, y, win, H, W, C, th, tw, partial, maps, plane);
  } else if (n_maps == 4) {
    ssim_forward_kernel<4><<<grid, block, 0, st>>>(x, y, win, H, W, C, th, tw, partial, maps, plane);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// out[0] = (sum of the n partials, in a fixed order) / count, rounded to fp32.
extern "C" int hifihr_ssim_sum(const double* partial, int n, long long count, float* out, void* stream) {
  ssim_sum_kernel<<<1, kSumThreads, 0, static_cast<cudaStream_t>(stream)>>>(partial, n, count, out);
  return (int)cudaGetLastError();
}

// grad: the output's gradient (one float on the device); count = B H W C;
// dy is written when with_dy (maps then hold a').
extern "C" int hifihr_ssim_backward(const float* x, const float* y, const float* maps, const float* win,
                                    const float* grad, int B, int H, int W, int C, int with_dy, float* dx,
                                    float* dy, void* stream) {
  if (C < 1 || C > 4) return (int)cudaErrorInvalidValue;
  const int th = tiles_h_of(H), tw = tiles_w_of(W, C);
  const size_t plane = (size_t)B * H * W * C;
  const long long count = (long long)plane;
  const dim3 block(kLanes, kGroups);
  const unsigned grid = (unsigned)(B * th * tw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem_plane = kInRows * (kLanes + 2 * kHalo * C) * (int)sizeof(float);
  cudaError_t err;
  if (with_dy) {
    err = cudaFuncSetAttribute(ssim_backward_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               4 * smem_plane);
    if (err != cudaSuccess) return (int)err;
    ssim_backward_kernel<true><<<grid, block, 4 * smem_plane, st>>>(x, y, maps, plane, win, grad, count, H, W, C,
                                                                    th, tw, dx, dy);
  } else {
    err = cudaFuncSetAttribute(ssim_backward_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               3 * smem_plane);
    if (err != cudaSuccess) return (int)err;
    ssim_backward_kernel<false><<<grid, block, 3 * smem_plane, st>>>(x, y, maps, plane, win, grad, count, H, W,
                                                                     C, th, tw, dx, dy);
  }
  return (int)cudaGetLastError();
}
