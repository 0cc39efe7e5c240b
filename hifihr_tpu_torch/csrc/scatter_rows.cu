// K3: batched scatter-add of per-pixel rows into a per-image table, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hifihr_tpu/render/gather_mxu.py::_bwd_kernel
// (reached through _scatter_impl, the VJP of gather_rows and the forward of
// scatter_rows). Same contract:
//   out[b, f, :] = sum over p with idx[b, p] == f of values[b, p, :]
// with rows whose idx lies outside [0, F) dropped (the renderer passes -1 for
// background pixels). The TPU form is a hi/lo bf16 one-hot matmul over lists
// of touched table blocks, good to about 2^-16 relative; none of that layout
// carries over.
//
// Determinism: the sums are fp32 atomics, so their order, and so the last
// bits of an entry, vary from run to run. An entry summed from n rows lies
// within (n - 1) * 2^-24 * sum |values| of the exact sum, far below the TPU
// kernel's own error; callers compare against the plain version within twice
// that bound.
//
// What bounds it on this card: bytes. At the flagship shape (values
// 64 x 50176 x 27 fp32 = 347 MB, idx 64 x 50176 int32 = 12.8 MB, out
// 64 x 1538 x 27 fp32 = 10.6 MB) the kernel reads only the rows of covered
// pixels (about an eighth of them for the smoke scene), so the work needs
// about 64 MB of traffic, 0.019 ms at 3.35 TB/s. The output (10.6 MB) stays in
// the 50 MB L2, where the atomics resolve.
//
// Design: one block of 256 threads per 256 consecutive pixels of one image,
// as K2. The block turns its indices into destination row offsets in shared
// memory; a tile with no covered pixel returns before it reads any gradient.
// The threads then walk the tile's contiguous 256 * D values with a stride
// of 256 (coalesced loads), skip background rows without reading them, and
// add each value into the output with one fire-and-forget atomicAdd
// (RED.ADD.F32 in L2). A face covers a handful of pixels, so few atomics meet
// on one address. This works at any table size; a shared-memory copy of the
// table would cap F * D at 227 KB and leave out NIMBLE's 11926-face tables.
// The output must be zero on entry: the wrapper allocates it with zeros.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;

__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const float* __restrict__ values,  // (B, P, D)
                    const int* __restrict__ idx,       // (B, P)
                    int F, int D, int P,
                    float* __restrict__ out) {         // (B, F, D), zeroed
  __shared__ int s_dst[kRows];
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kRows;
  const int nrows = min(kRows, P - p0);

  int any = 0;
  for (int r = threadIdx.x; r < nrows; r += kThreads) {
    const int f = idx[(size_t)b * P + p0 + r];
    const bool ok = (unsigned)f < (unsigned)F;
    s_dst[r] = ok ? f * D : -1;
    any |= ok;
  }
  if (!__syncthreads_or(any)) return;  // an all-background tile

  const float* vb = values + ((size_t)b * P + p0) * D;
  float* ob = out + (size_t)b * F * D;
  const int n = nrows * D;
  int r = threadIdx.x / D;
  int d = threadIdx.x - r * D;
  const int dr = kThreads / D;
  const int dd = kThreads - dr * D;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int dst = s_dst[r];
    if (dst >= 0) atomicAdd(ob + dst + d, __ldcs(vb + j));  // values are read once
    r += dr;
    d += dd;
    if (d >= D) {
      d -= D;
      ++r;
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Launches on `stream`
// and does not synchronise. `out` (B, F, D) must be zero-filled.
extern "C" int hifihr_scatter_rows(const float* values, const int* idx, int B,
                                   int F, int D, int P, float* out,
                                   void* stream) {
  if (B == 0 || P == 0 || D == 0 || F == 0) return 0;
  const dim3 grid((P + kRows - 1) / kRows, B);
  scatter_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      values, idx, F, D, P, out);
  return (int)cudaGetLastError();
}
