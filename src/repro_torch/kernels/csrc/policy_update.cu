// One control-plane tick of the hybrid histogram policy for the whole fleet.
//
// Replaces the TPU kernel repro/kernels/histogram.py::_policy_kernel
// (policy_update_pallas). Per app row it computes what
// repro_torch/kernels/histogram.py::policy_update_plain computes, bit for
// bit: the one-hot increment of this tick's idle-time bin into the raw
// counts (or the out-of-bounds counter), the Welford CV accumulators from
// the old count, the cumulative sum over the bins, the head and tail
// percentile bins as the first bins whose scaled cumulative count reaches
// the int32 threshold, the float32 windows with margins, and the CV /
// min-samples / out-of-bounds gate. The counts are updated in place (the
// reference returns a new array): only the one recorded bin of a row is
// written.
//
// Bound on an H100 (3.35 TB/s): bytes. At a million apps and 240 bins the
// counts are 0.96 GB, read once, plus 52 bytes of per-app vectors read and
// written: about 0.30 ms per tick when every row is read whole. A row need
// only be read up to the later of its two percentile bins, so the bytes a
// tick needs depend on the data; chip_smoke.py computes that bound from the
// tick's inputs.
//
// Design: one warp per row, lanes across the bins (coalesced 128-byte
// loads). The warp walks the row in 32-bin tiles: an inclusive shuffle scan
// plus the carry gives the cumulative counts, and a ballot of the scaled
// compares finds the first hit of each threshold; the walk stops after the
// tile where both are found. The old count is read before the walk and the
// new one written after it. The bounds check on the row index replaces the
// reference's padding to the 512-app tile. What this simple design leaves
// on the table: a tick issues about 400 warp instructions a row, 64 of
// them shuffles and ballots, which the SM issues one a clock (about 0.28
// ms a tick at a million apps for those alone); a lane scanning eight
// contiguous bins itself, and a warp owning 32 rows whose scalars it loads
// and writes coalesced, would cut both.
//
// Bit-identity hazards and what is done about them:
//   * no contraction: built with -fmad=false, and every rounding op is an
//     explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn,
//     __fdiv_rn, __fsqrt_rn); cvss/n - mean*mean must not become a fused
//     op;
//   * the cumulative sums and the scaled products cum * PCT_SCALE and
//     total * numer are int32 with two's-complement wrap-around, as the
//     reference's int32 arithmetic gives (computed in unsigned, where C++
//     defines the wrap); a row whose counts pass MAX_SCALED_COUNT wraps
//     there exactly as the reference and the plain version do;
//   * the window products run left to right as in the reference.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kPctScale = 10000;   // policy_math.PCT_SCALE
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int wrap_mul(int a, unsigned b) {
  return (int)((unsigned)a * b);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
policy_update_kernel(
    int* __restrict__ counts, const int* __restrict__ oob,
    const int* __restrict__ total, const float* __restrict__ cv_sum,
    const float* __restrict__ cv_sum_sq, const int* __restrict__ bins,
    const int* __restrict__ active, int* __restrict__ o_oob,
    int* __restrict__ o_total, float* __restrict__ o_cvs,
    float* __restrict__ o_cvss, float* __restrict__ o_prewarm,
    float* __restrict__ o_keep, int* __restrict__ o_use_hist, int n,
    int n_bins, int head_numer, int tail_numer, int min_samples,
    float margin_lo, float margin_hi, float bin_f, float range_f,
    float cv_threshold, float oob_threshold) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;                  // the whole warp leaves together

  // classify this tick's bin
  const int bin = bins[row];
  const bool act = active[row] != 0;
  const bool in_b = act && bin >= 0 && bin < n_bins;
  const bool oob_hit = act && bin >= n_bins;
  const int safe = min(max(bin, 0), n_bins - 1);
  int* crow = counts + row * (int64_t)n_bins;
  const int old = in_b ? crow[safe] : 0;
  const int tot = (int)((unsigned)total[row] + (in_b ? 1u : 0u));
  const int n_oob = (int)((unsigned)oob[row] + (oob_hit ? 1u : 0u));

  // Welford accumulators from the old count
  const float inb = in_b ? 1.0f : 0.0f;
  const float cvs = __fadd_rn(cv_sum[row], inb);
  const float cvss = __fadd_rn(
      cv_sum_sq[row],
      __fmul_rn(inb, __fadd_rn(__fmul_rn(2.0f, (float)old), 1.0f)));

  // percentile bins: first bin with cum * PCT_SCALE >= threshold
  const int head_thr = max(wrap_mul(tot, (unsigned)head_numer),
                           (int)kPctScale);
  const int tail_thr = max(wrap_mul(tot, (unsigned)tail_numer),
                           (int)kPctScale);
  unsigned carry = 0;
  int head = n_bins, tail = n_bins;
  for (int base = 0; base < n_bins; base += 32) {
    const int b = base + lane;
    const bool live = b < n_bins;
    unsigned c = 0;
    if (live) c = (unsigned)crow[b] + ((in_b && b == safe) ? 1u : 0u);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, c, off);
      if (lane >= off) c += y;
    }
    c += carry;
    carry = __shfl_sync(kFull, c, 31);
    const int scaled = (int)(c * kPctScale);
    const unsigned hh = __ballot_sync(kFull, live && scaled >= head_thr);
    const unsigned th = __ballot_sync(kFull, live && scaled >= tail_thr);
    if (head == n_bins && hh) head = base + __ffs(hh) - 1;
    if (tail == n_bins && th) tail = base + __ffs(th) - 1;
    if (head < n_bins && tail < n_bins) break;   // warp-uniform
  }
  __syncwarp();                          // every lane has read the row
  if (lane == 0 && in_b) crow[safe] = old + 1;

  // windows (float32, left to right) and the gate
  const float load = __fmul_rn(__fmul_rn((float)head, bin_f), margin_lo);
  float unload = __fmul_rn(fminf(__fmul_rn((float)(tail + 1), bin_f),
                                 range_f), margin_hi);
  unload = fmaxf(unload, load);
  const float nbf = (float)n_bins;
  const float mean = __fdiv_rn(cvs, nbf);
  const float var = fmaxf(
      __fsub_rn(__fdiv_rn(cvss, nbf), __fmul_rn(mean, mean)), 0.0f);
  const float cv = mean > 0.0f
      ? __fdiv_rn(__fsqrt_rn(var), fmaxf(mean, 1e-9f)) : 0.0f;
  const int seen = (int)((unsigned)tot + (unsigned)n_oob);
  const bool heavy =
      (float)n_oob > __fmul_rn(oob_threshold, (float)max(seen, 1));
  const bool use_hist =
      seen >= min_samples && cv >= cv_threshold && tot > 0 && !heavy;
  const float prewarm = use_hist ? load : 0.0f;

  if (lane == 0) {
    o_oob[row] = n_oob;
    o_total[row] = tot;
    o_cvs[row] = cvs;
    o_cvss[row] = cvss;
    o_prewarm[row] = prewarm;
    o_keep[row] = __fsub_rn(use_hist ? unload : range_f, prewarm);
    o_use_hist[row] = use_hist ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Launch the tick on `stream`; `counts` [n, n_bins] is updated in place.
// Returns cudaGetLastError() (0 = launched), or -1 for n_bins < 1.
int policy_update(void* counts, const void* oob, const void* total,
                  const void* cv_sum, const void* cv_sum_sq,
                  const void* bins, const void* active, void* o_oob,
                  void* o_total, void* o_cvs, void* o_cvss, void* o_prewarm,
                  void* o_keep, void* o_use_hist, int n, int n_bins,
                  int head_numer, int tail_numer, int min_samples,
                  float margin_lo, float margin_hi, float bin_f,
                  float range_f, float cv_threshold, float oob_threshold,
                  void* stream) {
  if (n_bins < 1) return -1;
  if (n == 0) return 0;
  const int64_t blocks = ((int64_t)n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  policy_update_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                         (cudaStream_t)stream>>>(
      (int*)counts, (const int*)oob, (const int*)total,
      (const float*)cv_sum, (const float*)cv_sum_sq, (const int*)bins,
      (const int*)active, (int*)o_oob, (int*)o_total, (float*)o_cvs,
      (float*)o_cvss, (float*)o_prewarm, (float*)o_keep, (int*)o_use_hist,
      n, n_bins, head_numer, tail_numer, min_samples, margin_lo, margin_hi,
      bin_f, range_f, cv_threshold, oob_threshold);
  return (int)cudaGetLastError();
}

const char* policy_update_error_string(int code) {
  if (code == -1) return "n_bins must be >= 1";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
