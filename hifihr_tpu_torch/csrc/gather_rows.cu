// K2: batched per-pixel row gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hifihr_tpu/render/gather_mxu.py::_fwd_kernel
// (reached through gather_rows -> _gather_impl). Same contract:
//   out[b, p, :] = table[b, idx[b, p], :], zeros where idx is outside [0, F)
// (the renderer passes -1 for background pixels). The TPU form is a hi/lo
// bf16 one-hot matmul, good to about 2^-16; this is a direct fp32 copy, so it
// is exact.
//
// What bounds it on this card: bytes. At the flagship shape (table
// 64 x 1538 x 27 fp32 = 10.6 MB, idx 64 x 50176 int32 = 12.8 MB) the kernel
// writes a 347 MB output, about 0.11 ms at 3.35 TB/s; the table stays in the
// 50 MB L2, so its re-reads cost no device-memory traffic.
//
// Design: one block of 256 threads per 256 consecutive pixels of one image.
// The block first turns its 256 indices into row offsets in shared memory
// (-1 where the pixel gets zeros); then the threads walk the block's
// contiguous 256 * D output floats with a stride of 256, so consecutive
// threads write consecutive addresses (coalesced stores) and read the table
// through the read-only path. The (row, column) position is stepped
// incrementally, so no integer division runs in the loop. Later work: keep
// the (B, P, D) tensor out of device memory by fusing the fetch with the
// barycentric interpolation that consumes it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ table,  // (B, F, D)
                   const int* __restrict__ idx,      // (B, P)
                   int F, int D, int P,
                   float* __restrict__ out) {        // (B, P, D)
  __shared__ int s_src[kRows];
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kRows;
  const int nrows = min(kRows, P - p0);
  const float* tb = table + (size_t)b * F * D;

  for (int r = threadIdx.x; r < nrows; r += kThreads) {
    const int f = idx[(size_t)b * P + p0 + r];
    s_src[r] = ((unsigned)f < (unsigned)F) ? f * D : -1;
  }
  __syncthreads();

  float* ob = out + ((size_t)b * P + p0) * D;
  const int n = nrows * D;
  int r = threadIdx.x / D;
  int d = threadIdx.x - r * D;
  const int dr = kThreads / D;
  const int dd = kThreads - dr * D;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int src = s_src[r];
    ob[j] = src >= 0 ? __ldg(tb + src + d) : 0.0f;
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
// and does not synchronise.
extern "C" int hifihr_gather_rows(const float* table, const int* idx, int B,
                                  int F, int D, int P, float* out,
                                  void* stream) {
  if (B == 0 || P == 0 || D == 0) return 0;
  const dim3 grid((P + kRows - 1) / kRows, B);
  gather_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, idx, F, D, P, out);
  return (int)cudaGetLastError();
}
