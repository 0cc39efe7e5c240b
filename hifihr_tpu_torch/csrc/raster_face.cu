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
// What bounds it on this card (H100 80GB HBM3): at the flagship SSAA shape
// (B=8, S=672, MANO F=1538) it reads 0.44 MB of face corners and writes
// 28.9 MB of outputs (about 9 us at 3.35 TB/s); at NIMBLE's F=11,926, 3.4 MB
// of corners. The arithmetic is 30 fp32 operations (three of them
// divisions) per (pixel, face) pair whose box holds the pixel: the bytes
// bound the eval hand, and the operations the hand the train steps grow.
// So the work is the culling.
//
// The first version (K1's first design) gave every 16x16 tile the whole
// job: each tile read all F faces' corners, 0.78 GB of L2 reads at the
// flagship shape and 7.8x that at F=11,926. This version is a route of
// three launches on one stream, K1's route fed straight from the corners:
//   1. a zero fill of per-bin face bitmasks, (B, T, T, W) 32-bit words with
//      T = ceil(S / 32) and W = ceil(F / 32). A bin is 32x32 pixels, 2x2 of
//      the fine kernel's tiles: with 16 px bins the mask at F=11,926 and
//      672^2 is 21 MB, written and read again, more than the launch's own
//      bytes bound; with 32 px bins it is 5.3 MB (0.7 MB for MANO), and the
//      fine kernel's block cull below takes back what the coarser bin lets
//      through;
//   2. face_bin_kernel, one thread per (image, face): it applies the
//      validity rule ((az > 1e-6f) && (bz > 1e-6f) && (cz > 1e-6f), written
//      out so that a NaN depth fails) and sets the face's bit, with
//      atomicOr, in every bin whose float overlap test passes
//      (umax >= bu0 && umin < bu1 && vmax >= bv0 && vmin < bv1);
//   3. face_fine_kernel, one block per 16x16 tile, one thread per pixel. It
//      walks its bin's mask words low to high and each word's set bits low
//      to high, so its list is in ascending face order and the strict < tie
//      rule holds without a sort. Each pass takes up to 256 listed faces,
//      one per thread: the thread reads the face's corners, tests its box
//      against the tile by the same float test, and a ballot and block
//      prefix count compact the faces that pass, still ascending, into
//      shared memory as 20-float records (edge deltas, corners, depths, id,
//      box). Each warp covers an 8 x 4 pixel footprint of the tile, and
//      before it tests a face it culls the face's box against that
//      footprint, then the face's nearest depth against the farthest depth
//      its lanes hold so far; both branches are uniform across the warp.
//      (8 x 4 rather than K1's 16 x 2: faces at 672^2 are a few pixels
//      wide, and a square footprint meets fewer of them.) A lane whose
//      pixel is surely outside the face skips the three divisions.
// What the measurements chose (tools/k4_variants.py: each choice undone in
// turn by a text substitution and timed beside this source on the same
// inputs in one process; the times are in PERF.md section 6): 16 px bins
// tie on small faces, lose on the hand the SSAA train step grows (faces of
// hundreds of pixels, front and back overlapping) and need four times the
// scratch; 4 fine blocks per SM are slower than 6 (40 registers, 32 bytes
// spilled); the skip of surely-outside pixels and the depth cull each pay
// on the grown hand, the depth cull at a small cost on small faces.
// Culling by box is the first version's, applied to bins, tiles and
// footprints alike: pixel centres lie 0.5 px inside the integer edges of
// each, so a face whose box misses one covers none of its pixel centres
// (unless a sliver under ~1e-4 px wide reaches past its own box by
// rounding, which the TPU kernel's tile test culls too). The per-pixel
// arithmetic uses __fsub_rn / __fmul_rn / __fadd_rn / __fdiv_rn in the TPU
// kernel's order (raster_pallas.py:58-66); with -fmad=false nothing is
// contracted, so face ids and depths equal the plain version's bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kFine = 16;              // pixels per side of a fine tile (one block)
constexpr int kBinShift = 1;           // a bin is 2^kBinShift x 2^kBinShift tiles
constexpr int kBin = kFine << kBinShift;
constexpr int kThreads = kFine * kFine;
constexpr int kWarps = kThreads / 32;
constexpr int kList = kThreads;        // listed faces examined per pass, one per thread
constexpr int kRec = 5;                // float4s per compacted face record
constexpr int kFootU = 8, kFootV = 4;  // a warp's pixel footprint
constexpr int kFineBlocksPerSM = 6;    // fine blocks resident on one SM: at most 40 registers

__global__ void __launch_bounds__(kThreads)
face_bin_kernel(const float* __restrict__ tri,  // (B, F, 9)
                int F, int T, int W,
                unsigned* __restrict__ mask) {   // (B, T, T, W), zeroed
  const int f = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (f >= F) return;
  const float* t = tri + ((size_t)b * F + f) * 9;
  const float ax = t[0], ay = t[1], az = t[2];
  const float bx = t[3], by = t[4], bz = t[5];
  const float cx = t[6], cy = t[7], cz = t[8];
  // written out, not fminf: a NaN depth must fail, as min(...) > 1e-6 does
  if (!((az > 1e-6f) && (bz > 1e-6f) && (cz > 1e-6f))) return;
  const float umin = fminf(fminf(ax, bx), cx), umax = fmaxf(fmaxf(ax, bx), cx);
  const float vmin = fminf(fminf(ay, by), cy), vmax = fmaxf(fmaxf(ay, by), cy);
  const float edge = (float)(T * kBin);
  // no bin overlaps: off screen, or a NaN box
  if (!(umax >= 0.0f && umin < edge && vmax >= 0.0f && vmin < edge)) return;
  // the bins whose float test can pass; the test below decides
  const float inv = 1.0f / (float)kBin;
  const int bx0 = (int)fmaxf(floorf(umin * inv), 0.0f);
  const int bx1 = (int)fminf(floorf(umax * inv), (float)(T - 1));
  const int by0 = (int)fmaxf(floorf(vmin * inv), 0.0f);
  const int by1 = (int)fminf(floorf(vmax * inv), (float)(T - 1));
  unsigned* mb = mask + (size_t)b * T * T * W + (f >> 5);
  const unsigned bit = 1u << (f & 31);
  for (int y = by0; y <= by1; ++y) {
    const float bv0 = (float)(y * kBin), bv1 = (float)(y * kBin + kBin);
    if (!(vmax >= bv0 && vmin < bv1)) continue;
    for (int x = bx0; x <= bx1; ++x) {
      const float bu0 = (float)(x * kBin), bu1 = (float)(x * kBin + kBin);
      if (umax >= bu0 && umin < bu1) atomicOr(mb + (size_t)(y * T + x) * W, bit);
    }
  }
}

__global__ void __launch_bounds__(kThreads, kFineBlocksPerSM)
face_fine_kernel(const float* __restrict__ tri,      // (B, F, 9)
                 const unsigned* __restrict__ mask,  // (B, T, T, W)
                 int F, int S, int T, int W,
                 int* __restrict__ fid_out,          // (B, S, S)
                 float* __restrict__ zbuf_out) {     // (B, S, S)
  // one record per face that passes the tile cull: {d0x, d0y, bx, by}
  // {d1x, d1y, cx, cy} {d2x, d2y, ax, ay} {az, bz, cz, id}
  // {umin, umax, vmin, vmax}
  __shared__ float4 s_rec[kList * kRec];
  __shared__ int s_ids[kList];
  __shared__ int s_words[kWarps];
  __shared__ int s_hits[kWarps];

  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int x0 = blockIdx.x * kFine;
  const int y0 = blockIdx.y * kFine;
  // the warp's footprint: 8 columns x 4 rows of the tile
  const int fx = x0 + (warp & 1) * kFootU;
  const int fy = y0 + (warp >> 1) * kFootV;
  const int px = fx + (lane % kFootU);
  const int py = fy + (lane / kFootU);
  const float tu0 = (float)x0, tu1 = (float)(x0 + kFine);
  const float tv0 = (float)y0, tv1 = (float)(y0 + kFine);
  const float wu0 = (float)fx, wu1 = (float)(fx + kFootU);
  const float wv0 = (float)fy, wv1 = (float)(fy + kFootV);
  const float u = __fadd_rn((float)px, 0.5f);
  const float v = __fadd_rn((float)py, 0.5f);

  float zb = __int_as_float(0x7f800000);  // +inf
  int fid = -1;
  const float* tri_b = tri + (size_t)b * F * 9;
  const unsigned* mk =
      mask + ((size_t)(b * T + (blockIdx.y >> kBinShift)) * T + (blockIdx.x >> kBinShift)) * W;

  for (int wb = 0; wb < W; wb += kThreads) {
    const int w = wb + tid;
    const unsigned word = w < W ? mk[w] : 0u;
    // block-wide exclusive prefix count of the listed faces, word by word
    const int cnt = __popc(word);
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) s_words[warp] = incl;
    __syncthreads();
    int base = incl - cnt, total = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const int c = s_words[k];
      base += (k < warp) ? c : 0;
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

      // list position tid: the face's corners and the tile cull
      bool hit = false;
      int f = 0;
      float ax = 0.f, ay = 0.f, az = 0.f, bx = 0.f, by = 0.f, bz = 0.f, cx = 0.f, cy = 0.f, cz = 0.f;
      float umin = 0.f, umax = 0.f, vmin = 0.f, vmax = 0.f;
      if (tid < n) {
        f = s_ids[tid];
        const float* t = tri_b + (size_t)f * 9;
        ax = t[0]; ay = t[1]; az = t[2];
        bx = t[3]; by = t[4]; bz = t[5];
        cx = t[6]; cy = t[7]; cz = t[8];
        umin = fminf(fminf(ax, bx), cx); umax = fmaxf(fmaxf(ax, bx), cx);
        vmin = fminf(fminf(ay, by), cy); vmax = fmaxf(fmaxf(ay, by), cy);
        hit = (umax >= tu0) && (umin < tu1) && (vmax >= tv0) && (vmin < tv1);
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_hits[warp] = __popc(ballot);
      __syncthreads();
      int slot = __popc(ballot & ((1u << lane) - 1u)), m = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        const int c = s_hits[k];
        slot += (k < warp) ? c : 0;
        m += c;
      }
      if (hit) {
        float4* r = s_rec + slot * kRec;
        r[0] = make_float4(__fsub_rn(cx, bx), __fsub_rn(cy, by), bx, by);
        r[1] = make_float4(__fsub_rn(ax, cx), __fsub_rn(ay, cy), cx, cy);
        r[2] = make_float4(__fsub_rn(bx, ax), __fsub_rn(by, ay), ax, ay);
        r[3] = make_float4(az, bz, cz, (float)f);  // exact below 2^24
        r[4] = make_float4(umin, umax, vmin, vmax);
      }
      __syncthreads();

      for (int i = 0; i < m; ++i) {
        const float4 box = s_rec[i * kRec + 4];
        // the same for every lane: no divergence
        if (!(box.y >= wu0 && box.x < wu1 && box.w >= wv0 && box.z < wv1)) continue;
        const float4 r3 = s_rec[i * kRec + 3];
        // Depth cull, uniform across the warp: at a pixel inside the face the
        // three e share the area's sign, so the weights sum to 1 within 3
        // ulp and z >= zmin (1 - 6 2^-24); the face cannot pass the strict
        // z < zb at a lane whose zb is at most zmin (1 - 2^-20), rounded.
        // Depths are positive, so their bits order as unsigned ints.
        const float znear = __fmul_rn(fminf(fminf(r3.x, r3.y), r3.z), 1.0f - 0x1p-20f);
        if (__uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(zb))) <= znear) continue;
        const float4 r0 = s_rec[i * kRec + 0];
        const float4 r1 = s_rec[i * kRec + 1];
        const float4 r2 = s_rec[i * kRec + 2];
        const float e0 = __fsub_rn(__fmul_rn(r0.x, __fsub_rn(v, r0.w)),
                                   __fmul_rn(r0.y, __fsub_rn(u, r0.z)));
        const float e1 = __fsub_rn(__fmul_rn(r1.x, __fsub_rn(v, r1.w)),
                                   __fmul_rn(r1.y, __fsub_rn(u, r1.z)));
        const float e2 = __fsub_rn(__fmul_rn(r2.x, __fsub_rn(v, r2.w)),
                                   __fmul_rn(r2.y, __fsub_rn(u, r2.z)));
        const float area = __fadd_rn(__fadd_rn(e0, e1), e2);
        const bool area_ok = fabsf(area) > 1e-12f;
        // A pixel that is surely outside skips the divisions: an edge value
        // of the other sign than the area and at least 2^-20 |area| in size
        // gives |e / area| >= 2^-20, far above the 2^-150 under which IEEE
        // division rounds to -0, so w < 0 and the test below fails too.
        // (|area| > 1e-12 keeps 2^-20 |area| normal, so it is exact.)
        const float tol = __fmul_rn(fabsf(area), 0x1p-20f);
        const bool neg = area < 0.0f;
        const bool sure_out = !area_ok || ((e0 < 0.0f) != neg && fabsf(e0) >= tol) ||
                              ((e1 < 0.0f) != neg && fabsf(e1) >= tol) ||
                              ((e2 < 0.0f) != neg && fabsf(e2) >= tol);
        if (sure_out) continue;
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
      __syncthreads();  // the next pass overwrites s_ids, s_rec and s_hits
    }
    __syncthreads();  // the next words overwrite s_words
  }

  if (px < S && py < S) {
    const size_t o = ((size_t)b * S + py) * S + px;
    fid_out[o] = fid;
    zbuf_out[o] = zb;
  }
}

}  // namespace

// The 32-bit words of the route's bin bitmasks for a (B, F, 9) input at S x S:
// B x T x T x ceil(F / 32), T = ceil(S / kBin). The caller allocates `mask`
// at this size, so the bin size is set here alone.
extern "C" long long hifihr_face_mask_words(int B, int F, int S) {
  const long long T = (S + kBin - 1) / kBin;
  return (long long)B * T * T * ((F + 31) / 32);
}

// The route: zero fill of `mask` (hifihr_face_mask_words(B, F, S) words of
// scratch), the bin kernel, the fine kernel, in that order on
// `stream`, without synchronising. Returns the first nonzero cudaError_t (0 on
// success) and adds one to *launched (a host int) for each of them that was
// enqueued. With F = 0 only the fine kernel runs.
extern "C" int hifihr_face_route(const float* tri, int B, int F, int S, unsigned* mask,
                                 int* fid, float* zbuf, void* stream, int* launched) {
  if (B == 0 || S == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = (S + kBin - 1) / kBin;
  const int W = (F + 31) / 32;
  if (F > 0) {
    int err = (int)cudaMemsetAsync(mask, 0, sizeof(unsigned) * (size_t)B * T * T * W, st);
    if (err) return err;
    ++*launched;
    face_bin_kernel<<<dim3((F + kThreads - 1) / kThreads, B), kThreads, 0, st>>>(tri, F, T, W, mask);
    err = (int)cudaGetLastError();
    if (err) return err;
    ++*launched;
  }
  const int tiles = (S + kFine - 1) / kFine;
  face_fine_kernel<<<dim3(tiles, tiles, B), kThreads, 0, st>>>(tri, mask, F, S, T, W, fid, zbuf);
  const int err = (int)cudaGetLastError();
  if (!err) ++*launched;
  return err;
}
