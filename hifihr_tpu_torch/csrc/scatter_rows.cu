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
// Determinism: the sums are fp32, partly in registers and partly through
// atomics, so their order, and so the last bits of an entry, vary from run to
// run. Any summation order of n terms lies within (n - 1) * 2^-24 * sum |values|
// of the exact sum, far below the TPU kernel's own error. fp32 atomics
// (red.add.f32) also flush subnormal operands and results to zero, which moves
// a sum by less than 2^-126 per addition; the plain version's index_add_ on
// the card flushes them too, while this kernel's register sums keep them.
// Callers compare the two within twice the sum of those bounds.
//
// What bounds it on this card: bytes. The work needs the indices, the rows of
// covered pixels only, and the output. The main paths give it two regimes
// (all numbers H100 80GB HBM3, 700 W):
//   - short runs: on the hand the seeded init renders (12% of pixels
//     covered), a face covers a few pixels, so runs of one face id in
//     scanline order are 1-3 pixels long; (64, 50176, 27) has a 0.0195 ms
//     bound at 3.35 TB/s;
//   - long runs: the train steps grow the hand within tens of updates
//     (68-77% of pixels covered by step 44, the largest face 14,325-38,541
//     rows at 672^2), and a scanline crosses a face in runs hundreds of
//     pixels long; (8, 451584, 27) there has a 0.084-0.095 ms bound.
// The first version made one atomicAdd per covered element. That is near
// the best in the first regime (0.050 ms on the H100 80GB HBM3 at 700 W),
// but in the second tens of thousands of atomics meet on the same few
// addresses and queue in L2: its two launches in the SSAA train step took
// 0.718-3.353 ms per step on that card.
//
// Design: one block of 256 threads per 256 * kM consecutive pixels of one
// image (kM = 2 when D <= 14, else 1). The block loads its indices into
// shared memory and counts its covered rows and its runs (a run's head is a
// covered row whose predecessor holds another id), with one barrier, as the
// first version had. A block with no covered row returns before it reads any
// gradient. Then each block takes the path that suits its own runs:
//   - mean run shorter than kLongRun rows, or rows too wide to stage
//     (D > kStage / 256, on no caller's path): the first version's path. The
//     threads walk the block's contiguous rows * D values with coalesced
//     4-byte loads, kBatch in flight per lane, and add each covered value
//     with one fire-and-forget atomicAdd (RED.ADD.F32 in L2); consecutive
//     lanes add to consecutive addresses, and background rows are never
//     read.
//   - longer runs: the block stages its covered rows in shared memory. Its
//     rows are one contiguous span of rows * D floats, read with 16-byte
//     loads that are all in flight together; a 16-byte word is read only if
//     it holds a value of a covered row (no sector of background rows alone
//     is fetched). The threads then form groups of one lane per channel,
//     each group a contiguous slice of the rows. A lane walks its slice in
//     shared memory and sums consecutive rows of one face id in a register;
//     a run that ends inside the slice is added with one atomicAdd. A run
//     that crosses into later slices is summed once: each later slice leaves
//     the part that continues the run in shared memory, and the lane that
//     holds the run's head adds those parts and makes the run's one
//     atomicAdd. So each (run, channel) pair of a block costs one atomic,
//     however long the run.
// No copy of the table is kept in shared memory, so any table size works
// (NIMBLE's 11,926-face tables included). The output must be zero on entry:
// the wrapper allocates it with zeros.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStage = 7168;  // floats of staged values: 28 KB of shared memory
constexpr int kLongRun = 4;   // mean run length from which a block sums runs
constexpr int kBatch = 4;     // loads a lane has in flight on the short-run path

// One block per kThreads * kM consecutive pixels of one image; kM = 2 when D
// is small enough to stage that many rows in one pass.
template <int kM>
__global__ void __launch_bounds__(kThreads, 8)
scatter_rows_kernel(const float* __restrict__ values,  // (B, P, D)
                    const int* __restrict__ idx,       // (B, P)
                    int F, int D, int P,
                    float* __restrict__ out) {         // (B, F, D), zeroed
  constexpr int kRows = kThreads * kM;
  extern __shared__ float s_v[];      // staged values, row-major, stride D
  __shared__ int s_f[kRows];          // face id of each row, -1 if dropped
  __shared__ float s_carry[kThreads];  // per (slice, lane): the part of a run
                                       // that continues from the slice before
  __shared__ int s_full[kThreads];     // per slice: that part fills the slice
  __shared__ int s_count[kThreads / 32];  // per warp: covered rows, runs << 16
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kRows;
  const int nrows = min(kRows, P - p0);
  const int tid = threadIdx.x;
  const int* ib = idx + (size_t)b * P + p0;
  const float* vb = values + ((size_t)b * P + p0) * D;
  float* ob = out + (size_t)b * F * D;

  // rows tid + i * kThreads: their face ids, and whether each is covered and
  // the head of a run (its predecessor from the lane before, or from idx)
  int count = 0;
#pragma unroll
  for (int i = 0; i < kM; ++i) {
    const int r = tid + i * kThreads;
    int f = r < nrows ? ib[r] : -1;
    f = (unsigned)f < (unsigned)F ? f : -1;
    s_f[r] = f;
    int prev = __shfl_up_sync(0xffffffffu, f, 1);
    if ((tid & 31) == 0) {
      prev = r > 0 && r <= nrows ? ib[r - 1] : -1;
      prev = (unsigned)prev < (unsigned)F ? prev : -1;
    }
    count += (f >= 0) + ((f >= 0 && f != prev) << 16);
  }
  count = __reduce_add_sync(0xffffffffu, count);
  if ((tid & 31) == 0) s_count[tid >> 5] = count;
  __syncthreads();
  count = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) count += s_count[w];
  const int ncov = count & 0xffff;
  if (ncov == 0) return;  // an all-background block reads no gradient

  if (D > kStage / kRows || ncov < kLongRun * (count >> 16)) {
    // short runs, or rows too wide to stage: one atomicAdd per covered
    // value, the threads walking the block's contiguous rows * D values with
    // coalesced 4-byte loads
    const int n = nrows * D;
    int r = tid / D, d = tid - r * D;
    const int dr = kThreads / D, dd = kThreads - dr * D;
    for (int j0 = tid; j0 < n; j0 += kBatch * kThreads) {
      int fk[kBatch], dk[kBatch];
      float vk[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {  // kBatch loads in flight, then the atomics
        fk[k] = j0 + k * kThreads < n ? s_f[r] : -1;
        dk[k] = d;
        vk[k] = fk[k] >= 0 ? __ldcs(vb + j0 + k * kThreads) : 0.0f;  // read once
        r += dr;
        d += dd;
        if (d >= D) {
          d -= D;
          ++r;
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (fk[k] >= 0) atomicAdd(ob + (size_t)fk[k] * D + dk[k], vk[k]);
    }
    return;
  }

  // long runs: stage the block's rows, one span of n floats, as 16-byte
  // words (4-byte loads at its unaligned ends), a word only if it holds a
  // value of a covered row
  const int n = nrows * D;
  const int head = min(n, (int)(((16u - ((uintptr_t)vb & 15u)) & 15u) >> 2));
  const int nq = (n - head) >> 2;
  for (int j = tid; j < head; j += kThreads)
    if (s_f[j / D] >= 0) s_v[j] = __ldcs(vb + j);
  const float4* v4 = reinterpret_cast<const float4*>(vb + head);
  const int j0 = head + 4 * tid;
  int r0 = j0 / D, d0 = j0 - r0 * D;  // the row and channel of the word's first value
  const int dr = 4 * kThreads / D, dd = 4 * kThreads - dr * D;
  for (int q = tid; q < nq; q += kThreads) {
    bool need = false;
#pragma unroll
    for (int k = 0, r = r0, d = d0; k < 4; ++k) {
      need |= s_f[r] >= 0;
      if (++d == D) {
        d = 0;
        ++r;
      }
    }
    if (need) {
      const float4 v = __ldcs(v4 + q);  // values are read once
      const int j = head + 4 * q;
      s_v[j] = v.x;
      s_v[j + 1] = v.y;
      s_v[j + 2] = v.z;
      s_v[j + 3] = v.w;
    }
    r0 += dr;
    d0 += dd;
    if (d0 >= D) {
      d0 -= D;
      ++r0;
    }
  }
  for (int j = head + 4 * nq + tid; j < n; j += kThreads)
    if (s_f[j / D] >= 0) s_v[j] = __ldcs(vb + j);
  __syncthreads();

  // groups of D lanes, one lane per channel, each group a slice of the rows
  const int groups = kThreads / D;
  const int span = (nrows + groups - 1) / groups;  // rows per slice
  const int g = tid / D;
  const int c = tid - g * D;
  const int lo = min(nrows, g * span);
  const int hi = min(nrows, lo + span);
  const bool on = g < groups && lo < hi;
  // the slice starts inside a run whose head lies in an earlier slice
  bool cont = on && lo > 0 && s_f[lo] >= 0 && s_f[lo - 1] == s_f[lo];
  int cur = on ? s_f[lo] : -1;  // the face of the segment being summed
  float acc = 0.0f;
  int own_f = -1;  // a run headed here that goes on past the slice
  if (on) {
    for (int r = lo; r < hi; ++r) {
      const int f = s_f[r];
      if (f != cur) {  // a run ends inside the slice
        if (cont) {
          s_carry[tid] = acc;
          cont = false;
        } else if (cur >= 0) {
          atomicAdd(ob + (size_t)cur * D + c, acc);
        }
        cur = f;
        acc = 0.0f;
      }
      if (f >= 0) acc += s_v[r * D + c];
    }
    if (cont) {  // the whole slice continues an earlier run
      s_carry[tid] = acc;
    } else if (cur >= 0) {
      if (hi < nrows && s_f[hi] == cur) {
        own_f = cur;
      } else {
        atomicAdd(ob + (size_t)cur * D + c, acc);
      }
    }
  }
  if (on && c == 0) s_full[g] = cont;
  __syncthreads();
  if (own_f >= 0) {  // add the run's parts in the later slices
    for (int k = g + 1;; ++k) {
      acc += s_carry[k * D + c];
      const int hk = min(nrows, (k + 1) * span);
      if (!(s_full[k] && hk < nrows && s_f[hk] == own_f)) break;
    }
    atomicAdd(ob + (size_t)own_f * D + c, acc);
  }
}

template <int kM>
int launch(const float* values, const int* idx, int B, int F, int D, int P, float* out,
           cudaStream_t stream) {
  constexpr int kRows = kThreads * kM;
  const size_t smem = D <= kStage / kRows ? sizeof(float) * kRows * D : 0;  // staged values
  const dim3 grid((P + kRows - 1) / kRows, B);
  scatter_rows_kernel<kM><<<grid, kThreads, smem, stream>>>(values, idx, F, D, P, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Launches on `stream`
// and does not synchronise. `out` (B, F, D) must be zero-filled.
extern "C" int hifihr_scatter_rows(const float* values, const int* idx, int B,
                                   int F, int D, int P, float* out,
                                   void* stream) {
  if (B == 0 || P == 0 || D == 0 || F == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // twice the rows per block when the stage holds them (the SSAA triangle
  // fetch's D = 9)
  if (D <= kStage / (2 * kThreads)) return launch<2>(values, idx, B, F, D, P, out, st);
  return launch<1>(values, idx, B, F, D, P, out, st);
}
