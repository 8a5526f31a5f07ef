// The RG-LRU linear recurrence over time, as a chunked scan in three passes.
//
// Replaces the TPU kernel repro/kernels/rglru_scan.py::_rglru_kernel
// (rglru_scan_pallas, with its in-block doubling _scan_block). It computes
// what repro/models/rglru.py::rglru_scan_ref computes:
//   b_t = sqrt(max(1 - a_t * a_t, 0)) * b_in_t,   h_t = a_t * h_{t-1} + b_t,
// with h_{-1} = 0, for b_in and a [B, L, D] f32, contiguous; outputs h
// [B, L, D] f32 and h_last = h[:, L-1] [B, D]. Any L >= 1 (the TPU kernel
// is right only for L a multiple of its 256-step block).
//
// Bound on an H100: bytes. a and b_in are read and h is written once:
// 12*B*L*D bytes, 252 MB at the serving path's shape (B=2, L=4096,
// D=2560), 0.075 ms at 3.35 TB/s; about 6 operations per element are
// negligible. The recurrence is sequential in time, and one thread per
// (b, d) walking all of L would leave 5,120 threads for 4,096 dependent
// steps, most of the card idle and each step waiting on a load.
//
// Design: time is cut into chunks of `chunk` steps, one thread per
// (b, chunk, d), d fastest so that a warp's loads at one step are 128
// contiguous bytes.
//   1. summary: each thread walks its chunk from h = 0 and keeps the
//      product of a and the chunk's local end state;
//   2. carry: one thread per (b, d) runs the chunks' affine maps in order
//      and writes each chunk's incoming state (B*nc*D floats, in L2);
//   3. replay: each thread walks its chunk again from its incoming state
//      and writes h; the thread of the last step writes h_last, so h_last
//      equals h[:, L-1] bit for bit.
// At the path's shape that is 327,680 threads in passes 1 and 3. Passes 1
// and 3 both read a and b_in, so the kernel moves 420 MB against the
// bound's 252 MB; a single pass with a look-back across chunks would not.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum : int { kErrShape = -1 };

__device__ __forceinline__ float gated(float a, float x) {
  return sqrtf(fmaxf(1.f - a * a, 0.f)) * x;
}

__global__ void chunk_summary(const float* __restrict__ b_in,
                              const float* __restrict__ a,
                              float* __restrict__ sum_a,
                              float* __restrict__ sum_h, int L, int D,
                              int chunk, int nc, int64_t n) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int d = (int)(idx % D);
  const int64_t bc = idx / D;                 // b * nc + c
  const int c = (int)(bc % nc), b = (int)(bc / nc);
  const int t0 = c * chunk, t1 = min(L, t0 + chunk);
  const int64_t base = (int64_t)b * L * D + d;
  float pa = 1.f, h = 0.f;
  for (int t = t0; t < t1; ++t) {
    const float at = a[base + (int64_t)t * D];
    h = at * h + gated(at, b_in[base + (int64_t)t * D]);
    pa *= at;
  }
  sum_a[idx] = pa;
  sum_h[idx] = h;
}

__global__ void chunk_carry(const float* __restrict__ sum_a,
                            const float* __restrict__ sum_h,
                            float* __restrict__ carry, int D, int nc,
                            int64_t n) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int d = (int)(idx % D), b = (int)(idx / D);
  float h = 0.f;
  for (int c = 0; c < nc; ++c) {
    const int64_t j = ((int64_t)b * nc + c) * D + d;
    carry[j] = h;
    h = sum_a[j] * h + sum_h[j];
  }
}

__global__ void chunk_replay(const float* __restrict__ b_in,
                             const float* __restrict__ a,
                             const float* __restrict__ carry,
                             float* __restrict__ h_out,
                             float* __restrict__ h_last, int L, int D,
                             int chunk, int nc, int64_t n) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int d = (int)(idx % D);
  const int64_t bc = idx / D;
  const int c = (int)(bc % nc), b = (int)(bc / nc);
  const int t0 = c * chunk, t1 = min(L, t0 + chunk);
  const int64_t base = (int64_t)b * L * D + d;
  float h = carry[idx];
  for (int t = t0; t < t1; ++t) {
    const int64_t j = base + (int64_t)t * D;
    const float at = a[j];
    h = at * h + gated(at, b_in[j]);
    h_out[j] = h;
  }
  if (c == nc - 1) h_last[(int64_t)b * D + d] = h;
}

unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// scratch holds 3 * B * nc * D floats, nc = ceil(L / chunk). Returns 0, a
// CUDA error code, or kErrShape.
int rglru_scan_fwd(const float* b_in, const float* a, float* h,
                   float* h_last, float* scratch, int B, int L, int D,
                   int chunk, void* stream) {
  if (B < 1 || L < 1 || D < 1 || chunk < 1) return kErrShape;
  const int nc = (L + chunk - 1) / chunk;
  const int64_t n_chunk = (int64_t)B * nc * D, n_row = (int64_t)B * D;
  float* sum_a = scratch;
  float* sum_h = scratch + n_chunk;
  float* carry = scratch + 2 * n_chunk;
  cudaStream_t s = (cudaStream_t)stream;
  chunk_summary<<<blocks_for(n_chunk), kThreads, 0, s>>>(
      b_in, a, sum_a, sum_h, L, D, chunk, nc, n_chunk);
  chunk_carry<<<blocks_for(n_row), kThreads, 0, s>>>(sum_a, sum_h, carry, D,
                                                     nc, n_row);
  chunk_replay<<<blocks_for(n_chunk), kThreads, 0, s>>>(
      b_in, a, carry, h, h_last, L, D, chunk, nc, n_chunk);
  return (int)cudaGetLastError();
}

const char* rglru_scan_error_string(int code) {
  if (code == kErrShape) return "bad shape (B, L, D and chunk must be >= 1)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
