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
// Design: a warp owns 32 consecutive rows.
//   * Lane r loads row r's vectors (bins, active, total, oob, both CV sums)
//     coalesced, reads the row's old count, and later runs the row's scalar
//     part (Welford, windows, gate) and writes its seven outputs coalesced:
//     the scalar part runs once per row, not once per lane.
//   * The warp walks its rows' counts in turn, in tiles of 256 bins: each
//     lane holds 8 contiguous bins (two 16-byte loads where the row is
//     16-byte aligned, the vec4 form; eight 4-byte loads otherwise, the
//     scalar form). The loads of the next tile (the next row's first tile
//     at 240 bins) are issued before the current tile is scanned, so a
//     whole row is in flight while the previous one is scanned.
//   * A tile's scan: each lane sums its 8 bins itself, one shuffle scan of
//     the 32 lane totals (5 shuffles) and one shuffle for the tile's total
//     give every cumulative count; each lane finds its first hit of each
//     threshold and two warp min-reductions give the row's. That is 8
//     shuffles and reductions a tile, plus 3 a row to broadcast lane r's
//     recorded bin and thresholds (the old design: 64 a row at 240 bins).
//   * The walk of a row stops after the tile where both percentiles are
//     found; a row whose thresholds are not reached is read in full. Rows
//     past n are masked, and the warp does not leave early: its lanes
//     serve other rows.
// The old count is read before the walk and the recorded bin written after
// it (the walk scans the old counts plus one at the recorded bin).
//
// Bit-identity hazards and what is done about them:
//   * no contraction: built with -fmad=false, and every rounding op is an
//     explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn,
//     __fdiv_rn, __fsqrt_rn); cvss/n - mean*mean must not become a fused
//     op;
//   * the cumulative sums and the scaled products cum * PCT_SCALE and
//     total * numer are int32 with two's-complement wrap-around, as the
//     reference's int32 arithmetic gives (computed in unsigned, where C++
//     defines the wrap, and where the sum's order does not change it); a
//     row whose counts pass MAX_SCALED_COUNT wraps there exactly as the
//     reference and the plain version do. Then cum * PCT_SCALE is not
//     monotone, so the search is a first hit over every bin read, never a
//     binary search;
//   * the window products run left to right as in the reference.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kPctScale = 10000;   // policy_math.PCT_SCALE
constexpr int kWarpsPerBlock = 4;
constexpr int kLaneBins = 8;
constexpr int kTileBins = 32 * kLaneBins;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;

__device__ __forceinline__ int wrap_mul(int a, unsigned b) {
  return (int)((unsigned)a * b);
}

// A lane's 8 bins [first, first + 8) of one row; bins past n_bins read as
// 0. kVec 4: two 16-byte loads (the row 16-byte aligned and n_bins % 4 ==
// 0, so each load lies wholly inside or outside the row); kVec 1: eight
// 4-byte loads.
template <int kVec>
__device__ __forceinline__ void load_bins(const int* row, int first,
                                          int n_bins, int (&v)[kLaneBins]) {
  if constexpr (kVec == 4) {
#pragma unroll
    for (int q = 0; q < kLaneBins; q += 4) {
      int4 x = make_int4(0, 0, 0, 0);
      if (first + q < n_bins)
        x = __ldcs(reinterpret_cast<const int4*>(row + first + q));
      v[q] = x.x;
      v[q + 1] = x.y;
      v[q + 2] = x.z;
      v[q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kLaneBins; ++k)
      v[k] = first + k < n_bins ? __ldcs(row + first + k) : 0;
  }
}

template <int kVec>
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
  const int64_t first_row =
      ((int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * 32;
  if (first_row >= n) return;            // the whole warp leaves together
  const int rows = (int)min((int64_t)32, (int64_t)n - first_row);
  const int64_t row = first_row + lane;  // lane r's row
  const bool mine = lane < rows;

  // lane r: row r's vectors, this tick's bin classified
  int bin = 0, act = 0, tot_in = 0, oob_in = 0;
  float cvs_in = 0.0f, cvss_in = 0.0f;
  if (mine) {
    bin = bins[row];
    act = active[row];
    tot_in = total[row];
    oob_in = oob[row];
    cvs_in = cv_sum[row];
    cvss_in = cv_sum_sq[row];
  }
  const bool in_b = act != 0 && bin >= 0 && bin < n_bins;
  const bool oob_hit = act != 0 && bin >= n_bins;
  const int safe = min(max(bin, 0), n_bins - 1);
  int* crow = counts + row * (int64_t)n_bins;
  const int old = in_b ? crow[safe] : 0;
  const int tot = (int)((unsigned)tot_in + (in_b ? 1u : 0u));
  const int n_oob = (int)((unsigned)oob_in + (oob_hit ? 1u : 0u));
  const int head_thr = max(wrap_mul(tot, (unsigned)head_numer),
                           (int)kPctScale);
  const int tail_thr = max(wrap_mul(tot, (unsigned)tail_numer),
                           (int)kPctScale);
  const int rec = in_b ? safe : -1;      // the bin the walk adds one to

  // the walk: step (j, t) scans row j's tile t; the next step's loads are
  // issued before this one's scan
  const int ntiles = (n_bins + kTileBins - 1) / kTileBins;
  const int lane_first = lane * kLaneBins;
  const int* wrows = counts + first_row * (int64_t)n_bins;
  int cur[kLaneBins], nxt[kLaneBins];
  load_bins<kVec>(wrows, lane_first, n_bins, cur);
  int head = n_bins, tail = n_bins;      // lane r: row r's percentile bins
  int j = 0, t = 0, hj = n_bins, tj = n_bins;
  int rec_j = __shfl_sync(kFull, rec, 0);
  int hthr_j = __shfl_sync(kFull, head_thr, 0);
  int tthr_j = __shfl_sync(kFull, tail_thr, 0);
  unsigned carry = 0;
  while (true) {
    const bool row_ends = t + 1 == ntiles;
    const int jn = row_ends ? j + 1 : j, tn = row_ends ? 0 : t + 1;
    if (jn < rows)
      load_bins<kVec>(wrows + jn * (int64_t)n_bins,
                      tn * kTileBins + lane_first, n_bins, nxt);

    // cumulative counts of this lane's bins (unsigned: int32 wrap)
    const int first = t * kTileBins + lane_first;
    unsigned s[kLaneBins], acc = 0;
#pragma unroll
    for (int k = 0; k < kLaneBins; ++k) {
      acc += (unsigned)cur[k] + (first + k == rec_j ? 1u : 0u);
      s[k] = acc;
    }
    unsigned x = acc;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    const unsigned before = carry + (x - acc);
    carry += __shfl_sync(kFull, x, 31);

    // first hits: this lane's, then the warp's
    int hh = kNone, th = kNone;
#pragma unroll
    for (int k = kLaneBins - 1; k >= 0; --k) {
      const int b = first + k;
      const int scaled = (int)((before + s[k]) * kPctScale);
      const bool live = b < n_bins;
      if (live && scaled >= hthr_j) hh = b;
      if (live && scaled >= tthr_j) th = b;
    }
    hj = min(hj, __reduce_min_sync(kFull, hh));
    tj = min(tj, __reduce_min_sync(kFull, th));

    if (row_ends || (hj < n_bins && tj < n_bins)) {   // warp-uniform
      if (lane == j) {
        head = hj;
        tail = tj;
      }
      if (++j == rows) break;
      rec_j = __shfl_sync(kFull, rec, j);
      hthr_j = __shfl_sync(kFull, head_thr, j);
      tthr_j = __shfl_sync(kFull, tail_thr, j);
      t = 0;
      carry = 0;
      hj = tj = n_bins;
      if (row_ends) {
#pragma unroll
        for (int k = 0; k < kLaneBins; ++k) cur[k] = nxt[k];
      } else {                             // stopped early: the prefetched
        load_bins<kVec>(wrows + j * (int64_t)n_bins, lane_first, n_bins,
                        cur);              // tile was this row's, not j's
      }
    } else {
      ++t;
#pragma unroll
      for (int k = 0; k < kLaneBins; ++k) cur[k] = nxt[k];
    }
  }
  __syncwarp();                          // every lane has read its rows
  if (!mine) return;
  if (in_b) crow[safe] = old + 1;

  // Welford accumulators from the old count
  const float inb = in_b ? 1.0f : 0.0f;
  const float cvs = __fadd_rn(cvs_in, inb);
  const float cvss = __fadd_rn(
      cvss_in, __fmul_rn(inb, __fadd_rn(__fmul_rn(2.0f, (float)old), 1.0f)));

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

  o_oob[row] = n_oob;
  o_total[row] = tot;
  o_cvs[row] = cvs;
  o_cvss[row] = cvss;
  o_prewarm[row] = prewarm;
  o_keep[row] = __fsub_rn(use_hist ? unload : range_f, prewarm);
  o_use_hist[row] = use_hist ? 1 : 0;
}

}  // namespace

extern "C" {

// Launch the tick on `stream`; `counts` [n, n_bins] is updated in place.
// vec 4 takes the vec4 form (counts 16-byte aligned and n_bins % 4 == 0,
// which the caller checks), vec 1 the scalar form. Returns
// cudaGetLastError() (0 = launched), or -1 for n_bins < 1 or another vec.
int policy_update(void* counts, const void* oob, const void* total,
                  const void* cv_sum, const void* cv_sum_sq,
                  const void* bins, const void* active, void* o_oob,
                  void* o_total, void* o_cvs, void* o_cvss, void* o_prewarm,
                  void* o_keep, void* o_use_hist, int n, int n_bins,
                  int head_numer, int tail_numer, int min_samples,
                  float margin_lo, float margin_hi, float bin_f,
                  float range_f, float cv_threshold, float oob_threshold,
                  int vec, void* stream) {
  if (n_bins < 1 || (vec != 1 && vec != 4)) return -1;
  if (n == 0) return 0;
  const int64_t rows_per_block = kWarpsPerBlock * 32;
  const int64_t blocks = ((int64_t)n + rows_per_block - 1) / rows_per_block;
  auto kernel = vec == 4 ? policy_update_kernel<4> : policy_update_kernel<1>;
  kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (int*)counts, (const int*)oob, (const int*)total,
      (const float*)cv_sum, (const float*)cv_sum_sq, (const int*)bins,
      (const int*)active, (int*)o_oob, (int*)o_total, (float*)o_cvs,
      (float*)o_cvss, (float*)o_prewarm, (float*)o_keep, (int*)o_use_hist,
      n, n_bins, head_numer, tail_numer, min_samples, margin_lo, margin_hi,
      bin_f, range_f, cv_threshold, oob_threshold);
  return (int)cudaGetLastError();
}

const char* policy_update_error_string(int code) {
  if (code == -1) return "n_bins must be >= 1 and vec 1 or 4";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
