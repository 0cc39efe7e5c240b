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
// What bounds it on this card: at the flagship shape (B=64, S=224, MANO
// F=1538) the kernel reads 7.5 MB of face records and writes 38.5 MB of
// outputs (about 14 us at 3.35 TB/s); the arithmetic is ~60 fp32 operations
// per (pixel, candidate face) pair, far below the 67 TFLOP/s fp32 rate when
// each pixel only tests the faces near it. Without culling, every pixel
// would test all 1538 faces and the kernel would be bound by operations.
//
// Design: one block per 16x16 pixel tile of one image, one thread per pixel.
// The block walks the faces in chunks of 256: each thread tests one face's
// bounding box against the tile, and a ballot + block prefix sum compacts
// the overlapping faces, still in ascending order, into shared memory
// together with their records. Every thread then walks that short list from
// shared memory (broadcast reads). Culling by bounding box is exact: a face
// that covers a subsample of a tile pixel overlaps the tile, and the
// subsamples keep at least 1/(2 samples) px from the tile's integer edges.
// The edge and depth arithmetic uses __fmul_rn / __fadd_rn in the order of
// the TPU kernel (raster_msaa.py:113-136), so no multiply-add is contracted
// and subsamples that lie exactly on an edge resolve as in the plain
// version. Not yet done (later work): a coarse binning pass shared by tiles,
// and more than one pixel per thread.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kRec = 15;

__global__ void __launch_bounds__(kThreads)
msaa_raster_kernel(const float* __restrict__ coef,  // (B, F, 15)
                   const float* __restrict__ bbox,  // (B, F, 4) umin umax vmin vmax
                   int F, int S, int samples,
                   int* __restrict__ fid_out,       // (B, S, S)
                   float* __restrict__ cov_out,     // (B, S, S)
                   float* __restrict__ zbuf_out) {  // (B, S, S)
  __shared__ float s_rec[kThreads * kRec];
  __shared__ int s_warp[kWarps];

  const int b = blockIdx.z;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const int px = x0 + threadIdx.x;
  const int py = y0 + threadIdx.y;
  const float tu0 = (float)x0, tu1 = (float)(x0 + kTile);
  const float tv0 = (float)y0, tv1 = (float)(y0 + kTile);

  const float step = 1.0f / (float)samples;
  const float half_step = 0.5f * step;
  const float U0 = __fadd_rn((float)px, half_step);  // subsample (0, 0)
  const float V0 = __fadd_rn((float)py, half_step);
  const float Uc = __fadd_rn((float)px, 0.5f);        // pixel centre
  const float Vc = __fadd_rn((float)py, 0.5f);

  float zb = __int_as_float(0x7f800000);  // +inf
  int fid = -1;
  unsigned cov = 0u;

  const float* rec_b = coef + (size_t)b * F * kRec;
  const float4* box_b = reinterpret_cast<const float4*>(bbox + (size_t)b * F * 4);

  for (int f0 = 0; f0 < F; f0 += kThreads) {
    const int f = f0 + tid;
    bool hit = false;
    if (f < F) {
      const float4 r = box_b[f];
      hit = (r.y >= tu0) && (r.x < tu1) && (r.w >= tv0) && (r.z < tv1);
    }
    // block-wide exclusive prefix count keeps the list in ascending order
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int base = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_warp[w];
      base += (w < warp) ? c : 0;
      total += c;
    }
    if (hit) {
      const int slot = base + __popc(ballot & ((1u << lane) - 1u));
      const float* src = rec_b + (size_t)f * kRec;
#pragma unroll
      for (int k = 0; k < kRec; ++k) s_rec[slot * kRec + k] = src[k];
    }
    __syncthreads();

    for (int k = 0; k < total; ++k) {
      const float* c = s_rec + k * kRec;
      const float e0u = c[0], e0v = c[1], e0c = c[2];
      const float e1u = c[3], e1v = c[4], e1c = c[5];
      const float e2u = c[6], e2v = c[7], e2c = c[8];
      const float zu = c[9], zv = c[10], zc = c[11];
      const int face = (int)c[12];
      const float zmin = c[13], zmax = c[14];

      float e0r = __fadd_rn(__fmul_rn(e0u, U0), __fadd_rn(__fmul_rn(e0v, V0), e0c));
      float e1r = __fadd_rn(__fmul_rn(e1u, U0), __fadd_rn(__fmul_rn(e1v, V0), e1c));
      float e2r = __fadd_rn(__fmul_rn(e2u, U0), __fadd_rn(__fmul_rn(e2v, V0), e2c));
      float z_c = __fadd_rn(__fmul_rn(zu, Uc), __fadd_rn(__fmul_rn(zv, Vc), zc));
      z_c = fminf(fmaxf(z_c, zmin), zmax);

      const float du0 = __fmul_rn(e0u, step), du1 = __fmul_rn(e1u, step),
                  du2 = __fmul_rn(e2u, step);
      const float dv0 = __fmul_rn(e0v, step), dv1 = __fmul_rn(e1v, step),
                  dv2 = __fmul_rn(e2v, step);

      unsigned bits = 0u;
      for (int sy = 0; sy < samples; ++sy) {
        if (sy) {
          e0r = __fadd_rn(e0r, dv0);
          e1r = __fadd_rn(e1r, dv1);
          e2r = __fadd_rn(e2r, dv2);
        }
        float c0 = e0r, c1 = e1r, c2 = e2r;
        for (int sx = 0; sx < samples; ++sx) {
          if (sx) {
            c0 = __fadd_rn(c0, du0);
            c1 = __fadd_rn(c1, du1);
            c2 = __fadd_rn(c2, du2);
          }
          const float m = fminf(fminf(c0, c1), c2);
          if (m >= 0.0f) bits |= 1u << (sy * samples + sx);
        }
      }
      if (bits != 0u && z_c < zb) {
        zb = z_c;
        fid = face;
      }
      cov |= bits;
    }
    __syncthreads();  // the next chunk overwrites s_rec and s_warp
  }

  if (px < S && py < S) {
    const size_t o = ((size_t)b * S + py) * S + px;
    fid_out[o] = fid;
    cov_out[o] = __fdiv_rn((float)__popc(cov), (float)(samples * samples));
    zbuf_out[o] = zb;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Launches on `stream`
// and does not synchronise.
extern "C" int hifihr_msaa_raster(const float* coef, const float* bbox, int B,
                                  int F, int S, int samples, int* fid,
                                  float* cov, float* zbuf, void* stream) {
  if (B == 0 || S == 0) return 0;
  const dim3 grid((S + kTile - 1) / kTile, (S + kTile - 1) / kTile, B);
  const dim3 block(kTile, kTile);
  msaa_raster_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      coef, bbox, F, S, samples, fid, cov, zbuf);
  return (int)cudaGetLastError();
}
