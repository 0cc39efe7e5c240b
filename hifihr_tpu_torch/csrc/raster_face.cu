// K4: supersampled (SSAA) z-buffer face selection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hifihr_tpu/render/raster_pallas.py::_kernel
// (launched by rasterize_face_id_pallas). Same contract: for every pixel
// centre (u, v) = (col + 0.5, row + 0.5) of a B x S x S image and every face
// whose three vertices have z > 1e-6,
//   e0 = (cx - bx) (v - by) - (cy - by) (u - bx), e1 and e2 cyclically
//   (not sign-normalised: both windings count), area = (e0 + e1) + e2 per
//   pixel, w = e / (|area| > 1e-12 ? area : 1e-12) by IEEE division,
//   inside when all three w >= 0 and |area| > 1e-12,
//   z = (w0 az + w1 bz) + w2 cz,
// and write
//   face_id  the inside face with the smallest z, strict < in ascending
//            face order, so ties go to the lower id; -1 where none is inside
//   zbuf     that face's z, inf on background.
// The input is the (B, F, 9) fp32 table of face corners [a_uvz b_uvz c_uvz]
// (hifihr_tpu_torch/render/raster.py::face_triangles), which the plain
// PyTorch version select_face_id_plain reads too.
//
// What bounds it on this card: at the flagship SSAA shape (B=8, S=672, MANO
// F=1538) it reads 0.44 MB of face corners and writes 28.9 MB of outputs
// (about 9 us at 3.35 TB/s). The arithmetic is 30 fp32 operations (three
// of them divisions) per (pixel, candidate face) pair, far below the
// 67 TFLOP/s fp32 rate when each pixel tests only the faces near it; so the
// bound is the bytes, and the work is the culling.
//
// Design (K1's): one block per 16x16 pixel tile of one image, one thread
// per pixel. The block walks the faces in chunks of 256: each thread tests
// one face's validity and screen box against the tile's bounds, as the TPU
// kernel does against its 128x128 tile (raster_pallas.py:44-56), and a
// ballot + block prefix sum compacts the overlapping faces, still in
// ascending order, into shared memory as 16-float records (edge deltas,
// corners, depths, id). Every thread then walks that short list from shared
// memory (broadcast reads). Pixel centres lie 0.5 px inside the tile's
// integer edges, so a face culled by its box covers none of them (unless a
// sliver under ~1e-4 px wide reaches past its own box by rounding, which
// the TPU kernel's tile test culls too). The per-pixel arithmetic uses
// __fsub_rn / __fmul_rn / __fadd_rn / __fdiv_rn in the TPU kernel's order
// (raster_pallas.py:58-66); with -fmad=false nothing is contracted, so face
// ids equal the plain version's bit for bit. Not yet done (later work): a
// coarse binning pass shared by tiles, and more than one pixel per thread.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
face_raster_kernel(const float* __restrict__ tri,  // (B, F, 9)
                   int F, int S,
                   int* __restrict__ fid_out,      // (B, S, S)
                   float* __restrict__ zbuf_out) { // (B, S, S)
  // one record per listed face: {d0x, d0y, bx, by} {d1x, d1y, cx, cy}
  // {d2x, d2y, ax, ay} {az, bz, cz, id}
  __shared__ float4 s_rec[kThreads * 4];
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
  const float u = __fadd_rn((float)px, 0.5f);
  const float v = __fadd_rn((float)py, 0.5f);

  float zb = __int_as_float(0x7f800000);  // +inf
  int fid = -1;
  const float* tri_b = tri + (size_t)b * F * 9;

  for (int f0 = 0; f0 < F; f0 += kThreads) {
    const int f = f0 + tid;
    bool hit = false;
    float ax = 0.f, ay = 0.f, az = 0.f, bx = 0.f, by = 0.f, bz = 0.f, cx = 0.f, cy = 0.f, cz = 0.f;
    if (f < F) {
      const float* t = tri_b + (size_t)f * 9;
      ax = t[0]; ay = t[1]; az = t[2];
      bx = t[3]; by = t[4]; bz = t[5];
      cx = t[6]; cy = t[7]; cz = t[8];
      // written out, not fminf: a NaN depth must fail, as min(...) > 1e-6 does
      const bool zvalid = (az > 1e-6f) && (bz > 1e-6f) && (cz > 1e-6f);
      const float umin = fminf(fminf(ax, bx), cx), umax = fmaxf(fmaxf(ax, bx), cx);
      const float vmin = fminf(fminf(ay, by), cy), vmax = fmaxf(fmaxf(ay, by), cy);
      hit = zvalid && (umax >= tu0) && (umin < tu1) && (vmax >= tv0) && (vmin < tv1);
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
      s_rec[slot * 4 + 0] = make_float4(__fsub_rn(cx, bx), __fsub_rn(cy, by), bx, by);
      s_rec[slot * 4 + 1] = make_float4(__fsub_rn(ax, cx), __fsub_rn(ay, cy), cx, cy);
      s_rec[slot * 4 + 2] = make_float4(__fsub_rn(bx, ax), __fsub_rn(by, ay), ax, ay);
      s_rec[slot * 4 + 3] = make_float4(az, bz, cz, (float)f);  // exact below 2^24
    }
    __syncthreads();

    for (int k = 0; k < total; ++k) {
      const float4 r0 = s_rec[k * 4 + 0];
      const float4 r1 = s_rec[k * 4 + 1];
      const float4 r2 = s_rec[k * 4 + 2];
      const float4 r3 = s_rec[k * 4 + 3];
      const float e0 = __fsub_rn(__fmul_rn(r0.x, __fsub_rn(v, r0.w)),
                                 __fmul_rn(r0.y, __fsub_rn(u, r0.z)));
      const float e1 = __fsub_rn(__fmul_rn(r1.x, __fsub_rn(v, r1.w)),
                                 __fmul_rn(r1.y, __fsub_rn(u, r1.z)));
      const float e2 = __fsub_rn(__fmul_rn(r2.x, __fsub_rn(v, r2.w)),
                                 __fmul_rn(r2.y, __fsub_rn(u, r2.z)));
      const float area = __fadd_rn(__fadd_rn(e0, e1), e2);
      const bool area_ok = fabsf(area) > 1e-12f;
      const float area_safe = area_ok ? area : 1e-12f;
      const float w0 = __fdiv_rn(e0, area_safe);
      const float w1 = __fdiv_rn(e1, area_safe);
      const float w2 = __fdiv_rn(e2, area_safe);
      const bool inside = (w0 >= 0.0f) && (w1 >= 0.0f) && (w2 >= 0.0f) && area_ok;
      const float z = __fadd_rn(__fadd_rn(__fmul_rn(w0, r3.x), __fmul_rn(w1, r3.y)),
                                __fmul_rn(w2, r3.z));
      if (inside && z < zb) {
        zb = z;
        fid = (int)r3.w;
      }
    }
    __syncthreads();  // the next chunk overwrites s_rec and s_warp
  }

  if (px < S && py < S) {
    const size_t o = ((size_t)b * S + py) * S + px;
    fid_out[o] = fid;
    zbuf_out[o] = zb;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Launches on `stream`
// and does not synchronise.
extern "C" int hifihr_face_raster(const float* tri, int B, int F, int S, int* fid,
                                  float* zbuf, void* stream) {
  if (B == 0 || S == 0) return 0;
  const dim3 grid((S + kTile - 1) / kTile, (S + kTile - 1) / kTile, B);
  const dim3 block(kTile, kTile);
  face_raster_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(tri, F, S, fid,
                                                                           zbuf);
  return (int)cudaGetLastError();
}
