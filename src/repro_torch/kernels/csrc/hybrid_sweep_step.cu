// One hybrid keep-alive policy step for S stacked configs x n apps.
//
// Replaces the TPU kernel repro/kernels/histogram.py::_sweep_step_kernel
// (fused_hybrid_sweep_step_pallas). Per (config s, app a) row it computes
// what repro_torch/core/policy_math.py::fused_hybrid_step_math computes, bit
// for bit: the warm/cold + waste verdict of the gap that just closed, the
// suffix add of the idle-time bin into the cumulative counts cum[s, a, :],
// the Welford CV accumulators, the head/tail percentile bins by the scaled
// int32 compare, the float32 windows with margins, and the CV /
// min-samples / out-of-bounds gate.
//
// The time layer (clock, residency bounds, Welford sums, waste) is float64,
// where the TPU kernel carries float32 time rebased per chunk; the decision
// layer is int32/float32 as on the TPU. On the H100 float64 time costs a few
// bytes per row next to the 1,920 bytes of cum, and it is what keeps a
// replay of float32 minute timestamps over two weeks exact: rebased float32
// idle times can round across a bin edge (ROADMAP Queue C).
//
// Design: one warp per row, lanes across the bins (coalesced 128-byte
// accesses to the row of cum). The total is read from the row's last prefix
// sum before the pass, so ONE pass over the row reads the raw count at the
// bin, applies the suffix add in place and finds both percentile bins; warp
// reductions combine the lanes. A row whose app has no event in this column
// (t_now = +inf) touches only its eight scalars, and only the suffix of a
// recorded bin is written. The bounds check on the row index replaces the
// reference's +inf padding to the 512-app tile.
//
// Bound on an H100 (3.35 TB/s): with every app active, each row's cum is
// read and written (8 bytes per bin) plus about 20 scalars: at S=1,
// n=1,000,000, n_bins=240 about 2.0 GB, 0.60 ms per launch. The bytes a
// launch really needs depend on the column (inactive rows, suffix writes);
// chip_smoke.py computes that bound from the data. What this simple design
// leaves on the table: the time loop stays outside (one launch per event
// column, so cum crosses device memory once per column instead of once per
// chunk); a later kernel keeps a tile's state on chip across columns.
//
// Bit-identity hazards and what is done about them:
//   * no contraction: built with -fmad=false, and every rounding op below is
//     an explicitly rounded intrinsic (__fmul_rn, __fsub_rn, __fdiv_rn,
//     __fsqrt_rn, and their double forms); cvss/n - mean*mean must not
//     become a fused op;
//   * floor(it / bin) is clamped in T to [-1, n_bins] before the int
//     conversion (it is +inf on first events);
//   * cum * PCT_SCALE and total * numer stay int32 (the host guards the
//     width with MAX_SCALED_COUNT);
//   * the window products run left to right as in the reference.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPctScale = 10000;     // policy_math.PCT_SCALE
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// Column layout of the config blocks (kernels/histogram.py CFG_*_COLS).
constexpr int kCfgI = 4;   // n_bins, head_numer, tail_numer, min_samples
constexpr int kCfgF = 7;   // margin_lo, margin_hi, bin_minutes, range,
                           // cv_threshold, oob_threshold, standard_keep

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
hybrid_sweep_step_kernel(
    const double* __restrict__ t_now, const double* __restrict__ prev_t,
    int* __restrict__ cum, const int* __restrict__ oob,
    const double* __restrict__ cv_sum, const double* __restrict__ cv_sum_sq,
    const double* __restrict__ prewarm, const double* __restrict__ unload_at,
    const int* __restrict__ cold, const double* __restrict__ waste,
    const int* __restrict__ cfg_i32, const float* __restrict__ cfg_f32,
    const double* __restrict__ bin_minutes,
    double* __restrict__ o_prev, int* __restrict__ o_oob,
    double* __restrict__ o_cvs, double* __restrict__ o_cvss,
    double* __restrict__ o_pre, double* __restrict__ o_unload,
    int* __restrict__ o_cold, double* __restrict__ o_waste,
    int S, int n, int n_bins) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= (int64_t)S * n) return;     // the whole warp leaves together
  const int s = (int)(row / n);
  const int a = (int)(row - (int64_t)s * n);

  const double t = t_now[a];
  const double p = prev_t[row];
  const double pre = prewarm[row];
  const double ub = unload_at[row];
  int n_oob = oob[row];
  double cvs = cv_sum[row];
  double cvss = cv_sum_sq[row];

  if (!isfinite(t)) {                    // no event: the state carries over
    if (lane == 0) {
      o_prev[row] = p;
      o_oob[row] = n_oob;
      o_cvs[row] = cvs;
      o_cvss[row] = cvss;
      o_pre[row] = pre;
      o_unload[row] = ub;
      o_cold[row] = cold[row];
      o_waste[row] = waste[row];
    }
    return;
  }

  // Verdict for the gap that just closed, under the carried bounds.
  const bool first = !isfinite(p);
  const double it = __dsub_rn(t, p);     // +inf on an app's first event
  const bool warm = (it >= pre) && (it <= ub);
  const bool is_cold = first || !warm;
  const double gap = first ? 0.0 : fmax(__dsub_rn(fmin(it, ub), pre), 0.0);

  // Bin the idle time (classify_idle_time).
  const int* ci = cfg_i32 + (int64_t)s * kCfgI;
  const float* cf = cfg_f32 + (int64_t)s * kCfgF;
  const int nb_cfg = ci[0];
  double q = floor(__ddiv_rn(it, bin_minutes[s]));
  q = fmin(fmax(q, -1.0), (double)nb_cfg);
  const int bin_idx = (int)q;
  const bool rec = !first;
  const bool in_b = rec && bin_idx >= 0 && bin_idx < nb_cfg;
  const bool oob_hit = rec && bin_idx >= nb_cfg;
  const int safe = min(max(bin_idx, 0), nb_cfg - 1);

  // Thresholds from the post-update total: the last prefix sum, plus this
  // hit (safe <= n_bins - 1, so the suffix always covers the last bin).
  int* crow = cum + row * (int64_t)n_bins;
  const int total = crow[n_bins - 1] + (in_b ? 1 : 0);
  __syncwarp();                          // every lane read it before writes
  const int head_thr = max(total * ci[1], kPctScale);
  const int tail_thr = max(total * ci[2], kPctScale);

  // One pass: raw count at the bin, suffix add in place, both searches.
  int at = 0, below = 0, head = n_bins, tail = n_bins;
  for (int b = lane; b < n_bins; b += 32) {
    int v = crow[b];
    if (b == safe) at = v;
    if (b == safe - 1) below = v;
    if (in_b && b >= safe) {
      v += 1;
      crow[b] = v;
    }
    if (head == n_bins && v * kPctScale >= head_thr) head = b;
    if (tail == n_bins && v * kPctScale >= tail_thr) tail = b;
  }
  at = __reduce_add_sync(kFull, at);
  below = __reduce_add_sync(kFull, below);
  head = __reduce_min_sync(kFull, head);
  tail = __reduce_min_sync(kFull, tail) + 1;

  // Welford accumulators from the pre-update raw count (exact integers in
  // either type).
  const double inb = in_b ? 1.0 : 0.0;
  cvs = __dadd_rn(cvs, inb);
  cvss = __dadd_rn(cvss, inb * __dadd_rn(2.0 * (double)(at - below), 1.0));
  n_oob += oob_hit ? 1 : 0;

  // Window values (float32, left to right).
  const float bin_f = cf[2];
  const float load = __fmul_rn(__fmul_rn((float)head, bin_f), cf[0]);
  float unload = __fmul_rn(fminf(__fmul_rn((float)tail, bin_f), cf[3]), cf[1]);
  unload = fmaxf(unload, load);

  // Gate in float32: CV of the bin counts, min samples, out-of-bounds share.
  const float nbf = (float)nb_cfg;
  const float mean = __fdiv_rn((float)cvs, nbf);
  const float var = fmaxf(
      __fsub_rn(__fdiv_rn((float)cvss, nbf), __fmul_rn(mean, mean)), 0.0f);
  const float cv = mean > 0.0f
      ? __fdiv_rn(__fsqrt_rn(var), fmaxf(mean, 1e-9f)) : 0.0f;
  const int seen = total + n_oob;
  const bool heavy = (float)n_oob > __fmul_rn(cf[5], (float)max(seen, 1));
  const bool use_hist =
      seen >= ci[3] && cv >= cf[4] && total > 0 && !heavy;

  if (lane == 0) {
    o_prev[row] = t;
    o_oob[row] = n_oob;
    o_cvs[row] = cvs;
    o_cvss[row] = cvss;
    o_pre[row] = (double)(use_hist ? load : 0.0f);
    o_unload[row] = (double)(use_hist ? unload : cf[6]);
    o_cold[row] = cold[row] + (is_cold ? 1 : 0);
    o_waste[row] = __dadd_rn(waste[row], gap);
  }
}

}  // namespace

extern "C" {

// Launch the step on `stream`; returns cudaGetLastError() (0 = launched).
int hybrid_sweep_step(
    const void* t_now, const void* prev_t, void* cum, const void* oob,
    const void* cv_sum, const void* cv_sum_sq, const void* prewarm,
    const void* unload_at, const void* cold, const void* waste,
    const void* cfg_i32, const void* cfg_f32, const void* bin_minutes,
    void* o_prev, void* o_oob, void* o_cvs, void* o_cvss, void* o_pre,
    void* o_unload, void* o_cold, void* o_waste,
    int S, int n, int n_bins, void* stream) {
  const int64_t rows = (int64_t)S * n;
  if (rows == 0) return 0;
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  hybrid_sweep_step_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                             (cudaStream_t)stream>>>(
      (const double*)t_now, (const double*)prev_t, (int*)cum,
      (const int*)oob, (const double*)cv_sum, (const double*)cv_sum_sq,
      (const double*)prewarm, (const double*)unload_at, (const int*)cold,
      (const double*)waste, (const int*)cfg_i32, (const float*)cfg_f32,
      (const double*)bin_minutes, (double*)o_prev, (int*)o_oob,
      (double*)o_cvs, (double*)o_cvss, (double*)o_pre, (double*)o_unload,
      (int*)o_cold, (double*)o_waste, S, n, n_bins);
  return (int)cudaGetLastError();
}

const char* hybrid_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
