// K1: multisampled (MSAA) z-buffer face selection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hifihr_tpu/render/raster_msaa.py::_kernel
// (launched by rasterize_msaa_pallas). Same contract: for every pixel of a
// B x S x S image, test the samples x samples subsamples at pixel +
// ((sx + 0.5) / samples, (sy + 0.5) / samples) against every valid face
// (all three sign-normalised edge functions >= 0, so edges count as inside)
// and write
//   face_id  the covering face whose affine z-plane, evaluated at the pixel
//            centre and clamped to the face's own [zmin, zmax], is smallest;
//            strict < in ascending face order, so ties go to the lower id;
//            -1 where nothing covers
//   coverage covered subsamples (over all faces) / samples^2
//   zbuf     the chosen face's clamped centre depth, inf on background.
// The per-face records (15 floats: sign-premultiplied edge coefficients,
// z-plane, face id, zmin, zmax; invalid faces inert with e0c = -1) and the
// per-face screen bounding boxes come from the torch prep
// hifihr_tpu_torch/render/raster_msaa.py::msaa_prep, which the plain PyTorch
// version shares.
//
// What bounds it on this card (H100 80GB HBM3, 700 W): at the flagship shape
// (B=64, S=224, MANO F=1538) it reads 7.5 MB of face records and boxes and
// writes 38.5 MB of outputs, 0.0137 ms at 3.35 TB/s. The arithmetic is ~60
// fp32 operations per (pixel, tested face) pair. The faces' boxes hold 3.8 M
// pixels of the eval hand (0.003 ms at 67 TFLOP/s, so bytes bound it) and
// 18-34 M of the hand the train steps grow by step 41 (0.016-0.030 ms, so
// operations bound it there).
//
// The first version gave every 16x16 tile the whole job of culling: each
// tile read all F boxes and walked its list at all 256 pixels, 43.8 M
// (pixel, listed face) pairs on the eval hand (0.556 ms on that card). Faces
// at 224^2 are a few pixels wide, so most of those pairs were misses. This
// version is a route of three launches on one stream:
//   1. a zero fill of the per-tile face bitmasks (B x T x T x ceil(F / 32)
//      words, T = ceil(S / 16); 2.4 MB at the flagship shape);
//   2. msaa_bin_kernel, one thread per (image, face): each face sets its bit,
//      with atomicOr, in the mask of every tile its box overlaps, by the
//      first version's float comparisons (umax >= tu0 && umin < tu1 &&
//      vmax >= tv0 && vmin < tv1). Invalid faces have empty boxes (+inf /
//      -inf) and are never listed;
//   3. msaa_fine_kernel, one block per tile, one thread per pixel. It walks
//      the tile's mask words low to high and each word's set bits low to high,
//      so its list is in ascending face order and the strict < tie rule holds
//      without a sort. It stages the listed records (padded to 16 floats,
//      four 16-byte shared loads per face) and boxes in shared memory in
//      chunks of kList, and before a warp tests a face it culls the face's
//      box against the warp's own footprint (2 rows x 16 pixels of the tile);
//      the branch is uniform across the warp. The kernel is instantiated for
//      each subsample grid (1x1 to 5x5), so the subsample loops unroll.
// Culling by bounding box is exact: a face that covers a subsample of a pixel
// overlaps that pixel's tile and warp footprint, and the subsamples keep at
// least 1/(2 samples) px from the footprint's integer edges. The edge and
// depth arithmetic uses __fmul_rn / __fadd_rn in the order of the TPU kernel
// (raster_msaa.py:113-136), under -fmad=false, so no multiply-add is
// contracted and subsamples that lie exactly on an edge resolve as in the
// plain version: face_id, coverage and zbuf are bit-equal to it.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kRec = 15;
constexpr int kList = 256;  // listed faces staged in shared memory at once

__global__ void __launch_bounds__(kThreads)
msaa_bin_kernel(const float4* __restrict__ bbox,  // (B, F) umin umax vmin vmax
                int F, int T, int W,
                unsigned* __restrict__ mask) {     // (B, T, T, W), zeroed
  const int f = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (f >= F) return;
  const float4 r = bbox[(size_t)b * F + f];
  const float edge = (float)(T * kTile);
  // no tile overlaps: off screen, an empty box of an invalid face, or NaN
  if (!(r.y >= 0.0f && r.x < edge && r.w >= 0.0f && r.z < edge)) return;
  // the tiles whose float test can pass; the test below decides
  const float inv = 1.0f / (float)kTile;
  const int tx0 = (int)fmaxf(floorf(r.x * inv), 0.0f);
  const int tx1 = (int)fminf(floorf(r.y * inv), (float)(T - 1));
  const int ty0 = (int)fmaxf(floorf(r.z * inv), 0.0f);
  const int ty1 = (int)fminf(floorf(r.w * inv), (float)(T - 1));
  unsigned* mb = mask + (size_t)b * T * T * W + (f >> 5);
  const unsigned bit = 1u << (f & 31);
  for (int ty = ty0; ty <= ty1; ++ty) {
    const float tv0 = (float)(ty * kTile), tv1 = (float)(ty * kTile + kTile);
    if (!(r.w >= tv0 && r.z < tv1)) continue;
    for (int tx = tx0; tx <= tx1; ++tx) {
      const float tu0 = (float)(tx * kTile), tu1 = (float)(tx * kTile + kTile);
      if (r.y >= tu0 && r.x < tu1) atomicOr(mb + (size_t)(ty * T + tx) * W, bit);
    }
  }
}

template <int kSamples>
__global__ void __launch_bounds__(kThreads)
msaa_fine_kernel(const float* __restrict__ coef,     // (B, F, 15)
                 const float4* __restrict__ bbox,    // (B, F)
                 const unsigned* __restrict__ mask,  // (B, T, T, W)
                 int F, int S, int T, int W,
                 int* __restrict__ fid_out,          // (B, S, S)
                 float* __restrict__ cov_out,        // (B, S, S)
                 float* __restrict__ zbuf_out) {     // (B, S, S)
  // each record padded to 16 floats: four 16-byte shared loads per face
  __shared__ float4 s_rec[kList * 4];
  __shared__ float4 s_box[kList];
  __shared__ int s_ids[kList];
  __shared__ int s_warp[kWarps];

  const int b = blockIdx.z;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const int px = x0 + threadIdx.x;
  const int py = y0 + threadIdx.y;
  // the warp's footprint: threadIdx.y = 2 warp and 2 warp + 1, all 16 columns
  const float wu0 = (float)x0, wu1 = (float)(x0 + kTile);
  const float wv0 = (float)(y0 + 2 * warp), wv1 = (float)(y0 + 2 * warp + 2);

  const float step = 1.0f / (float)kSamples;
  const float half_step = 0.5f * step;
  const float U0 = __fadd_rn((float)px, half_step);  // subsample (0, 0)
  const float V0 = __fadd_rn((float)py, half_step);
  const float Uc = __fadd_rn((float)px, 0.5f);        // pixel centre
  const float Vc = __fadd_rn((float)py, 0.5f);

  float zb = __int_as_float(0x7f800000);  // +inf
  int fid = -1;
  unsigned cov = 0u;

  const float* rec_b = coef + (size_t)b * F * kRec;
  const float4* box_b = bbox + (size_t)b * F;
  const unsigned* mk = mask + ((size_t)(b * T + blockIdx.y) * T + blockIdx.x) * W;

  for (int w0 = 0; w0 < W; w0 += kThreads) {
    const int w = w0 + tid;
    const unsigned word = w < W ? mk[w] : 0u;
    // block-wide exclusive prefix count of the listed faces, word by word
    const int cnt = __popc(word);
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int base = incl - cnt, total = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const int c = s_warp[v];
      base += (v < warp) ? c : 0;
      total += c;
    }

    for (int l0 = 0; l0 < total; l0 += kList) {
      // this word's faces at list positions [l0, l0 + kList), ascending
      unsigned bits = word;
      for (int k = base; bits != 0u && k < l0 + kList; ++k) {
        const int bit = __ffs(bits) - 1;
        bits &= bits - 1u;
        if (k >= l0) s_ids[k - l0] = w * 32 + bit;
      }
      __syncthreads();
      const int n = min(kList, total - l0);
      float* s_recf = reinterpret_cast<float*>(s_rec);
      for (int e = tid; e < n * kRec; e += kThreads) {
        const int i = e / kRec, k = e - i * kRec;
        s_recf[i * 16 + k] = rec_b[(size_t)s_ids[i] * kRec + k];
      }
      for (int i = tid; i < n; i += kThreads) s_box[i] = box_b[s_ids[i]];
      __syncthreads();

      for (int i = 0; i < n; ++i) {
        const float4 r = s_box[i];
        // the same for every lane: no divergence
        if (!(r.y >= wu0 && r.x < wu1 && r.w >= wv0 && r.z < wv1)) continue;
        const float4 c0 = s_rec[4 * i], c1 = s_rec[4 * i + 1], c2 = s_rec[4 * i + 2],
                     c3 = s_rec[4 * i + 3];
        const float e0u = c0.x, e0v = c0.y, e0c = c0.z;
        const float e1u = c0.w, e1v = c1.x, e1c = c1.y;
        const float e2u = c1.z, e2v = c1.w, e2c = c2.x;
        const float zu = c2.y, zv = c2.z, zc = c2.w;
        const int face = (int)c3.x;
        const float zmin = c3.y, zmax = c3.z;

        float e0r = __fadd_rn(__fmul_rn(e0u, U0), __fadd_rn(__fmul_rn(e0v, V0), e0c));
        float e1r = __fadd_rn(__fmul_rn(e1u, U0), __fadd_rn(__fmul_rn(e1v, V0), e1c));
        float e2r = __fadd_rn(__fmul_rn(e2u, U0), __fadd_rn(__fmul_rn(e2v, V0), e2c));
        float z_c = __fadd_rn(__fmul_rn(zu, Uc), __fadd_rn(__fmul_rn(zv, Vc), zc));
        z_c = fminf(fmaxf(z_c, zmin), zmax);

        const float du0 = __fmul_rn(e0u, step), du1 = __fmul_rn(e1u, step),
                    du2 = __fmul_rn(e2u, step);
        const float dv0 = __fmul_rn(e0v, step), dv1 = __fmul_rn(e1v, step),
                    dv2 = __fmul_rn(e2v, step);

        unsigned bits_in = 0u;
#pragma unroll
        for (int sy = 0; sy < kSamples; ++sy) {
          if (sy) {
            e0r = __fadd_rn(e0r, dv0);
            e1r = __fadd_rn(e1r, dv1);
            e2r = __fadd_rn(e2r, dv2);
          }
          float a0 = e0r, a1 = e1r, a2 = e2r;
#pragma unroll
          for (int sx = 0; sx < kSamples; ++sx) {
            if (sx) {
              a0 = __fadd_rn(a0, du0);
              a1 = __fadd_rn(a1, du1);
              a2 = __fadd_rn(a2, du2);
            }
            const float m = fminf(fminf(a0, a1), a2);
            if (m >= 0.0f) bits_in |= 1u << (sy * kSamples + sx);
          }
        }
        if (bits_in != 0u && z_c < zb) {
          zb = z_c;
          fid = face;
        }
        cov |= bits_in;
      }
      __syncthreads();  // the next chunk overwrites s_ids, s_rec and s_box
    }
    __syncthreads();  // the next words overwrite s_warp
  }

  if (px < S && py < S) {
    const size_t o = ((size_t)b * S + py) * S + px;
    fid_out[o] = fid;
    cov_out[o] = __fdiv_rn((float)__popc(cov), (float)(kSamples * kSamples));
    zbuf_out[o] = zb;
  }
}

}  // namespace

// The route: zero fill of `mask` (B x T x T x ceil(F / 32) int32 scratch,
// T = ceil(S / 16)), the bin kernel, the fine kernel, in that order on
// `stream`, without synchronising. Returns the first nonzero cudaError_t (0 on
// success) and adds one to *launched (a host int) for each of them that was
// enqueued. With F = 0 only the fine kernel runs.
extern "C" int hifihr_msaa_raster(const float* coef, const float* bbox, int B,
                                  int F, int S, int samples, unsigned* mask,
                                  int* fid, float* cov, float* zbuf, void* stream,
                                  int* launched) {
  if (B == 0 || S == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = (S + kTile - 1) / kTile;
  const int W = (F + 31) / 32;
  const float4* box4 = reinterpret_cast<const float4*>(bbox);
  if (F > 0) {
    int err = (int)cudaMemsetAsync(mask, 0, sizeof(unsigned) * (size_t)B * T * T * W, st);
    if (err) return err;
    ++*launched;
    msaa_bin_kernel<<<dim3((F + kThreads - 1) / kThreads, B), kThreads, 0, st>>>(box4, F, T, W, mask);
    err = (int)cudaGetLastError();
    if (err) return err;
    ++*launched;
  }
  const dim3 grid(T, T, B), block(kTile, kTile);
  switch (samples) {  // the subsample loops unrolled for each grid size
    case 1: msaa_fine_kernel<1><<<grid, block, 0, st>>>(coef, box4, mask, F, S, T, W, fid, cov, zbuf); break;
    case 2: msaa_fine_kernel<2><<<grid, block, 0, st>>>(coef, box4, mask, F, S, T, W, fid, cov, zbuf); break;
    case 3: msaa_fine_kernel<3><<<grid, block, 0, st>>>(coef, box4, mask, F, S, T, W, fid, cov, zbuf); break;
    case 4: msaa_fine_kernel<4><<<grid, block, 0, st>>>(coef, box4, mask, F, S, T, W, fid, cov, zbuf); break;
    case 5: msaa_fine_kernel<5><<<grid, block, 0, st>>>(coef, box4, mask, F, S, T, W, fid, cov, zbuf); break;
    default: return (int)cudaErrorInvalidValue;
  }
  const int err = (int)cudaGetLastError();
  if (!err) ++*launched;
  return err;
}
