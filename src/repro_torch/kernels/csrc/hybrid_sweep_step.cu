// The hybrid keep-alive policy replay for S stacked configs x n apps: one
// step (one event column), and the scan of a whole chunk of columns.
//
// Replaces the TPU kernel repro/kernels/histogram.py::_sweep_step_kernel
// (fused_hybrid_sweep_step_pallas) and the lax.scan over it in
// repro/core/simulator.py. Per (config s, app a) row and event column the
// kernels compute what repro_torch/core/policy_math.py::
// fused_hybrid_step_math computes, bit for bit: the warm/cold + waste
// verdict of the gap that just closed, the suffix add of the idle-time bin
// into the cumulative counts cum[s, a, :], the Welford CV accumulators, the
// head/tail percentile bins by the scaled int32 compare, the float32
// windows with margins, and the CV / min-samples / out-of-bounds gate. The
// scalar part of that is one set of device functions that every kernel
// here calls, as policy_math.py is the one source of it in Python: the
// verdict and the bin (verdict, classify; close_gap is both), the group
// part (welford, bin_cv), the window and the gate (decide is all three).
//
// The time layer (clock, residency bounds, Welford sums, waste) is float64,
// where the TPU kernel carries float32 time rebased per chunk; the decision
// layer is int32/float32 as on the TPU. Float64 time is what keeps a replay
// of float32 minute timestamps over two weeks exact: rebased float32 idle
// times can round across a bin edge (ROADMAP Queue C).
//
// hybrid_sweep_step_kernel (one column; the S=1 parity surface and the
// anchor the scan is held to): one warp per row, lanes across the bins
// (coalesced 128-byte accesses to the row of cum). The total is read from
// the row's last prefix sum before the pass, so ONE pass over the row reads
// the raw count at the bin, applies the suffix add in place and finds both
// percentile bins; warp reductions combine the lanes. A row with no event
// in the column (t_now = +inf) touches only its eight scalars. Bound on an
// H100 (3.35 TB/s) per launch at S=1, n=1,000,000, 240 bins with every app
// active: each row's cum read and written (8 bytes a bin) plus about 20
// scalars, about 2.0 GB, 0.60 ms; cum crosses device memory once a column.
//
// The scan (hybrid_sweep_scan_*): the time loop moves into the kernel, so a
// row's histogram crosses device memory once a chunk instead of once a
// column: read once, kept on chip across all the columns, written once;
// the eight scalars stay in registers and are written once, with one flag
// more: whether the scalar policy's forecaster guard (enough samples, OOB
// heavy) held after some event column, which selects the apps of the
// ARIMA post-pass. One warp per row; the event times come 32 columns at a
// time, one load a lane, and reach the warp by shuffles. The simulator
// carries a sweep's state factored (policy_math.HybridSweepBlock): one
// histogram per group of configs that share a bin layout, and per config
// only its bounds, cold count and waste. The host picks the form from the
// block (kernels/histogram.py::factored_scan_plan, with scan_form):
//   * factored (configs that share a layer, n_bins <= 256): one warp per
//     (group, app), the group's bins in registers as in the register form
//     below; the bin pass, the total and the Welford sums once per event
//     for the whole group, one percentile search per distinct (head, tail)
//     pair of the group, and lane L carrying the group's configs L and
//     L + 32 (CPL 1 or 2): their verdicts, windows and gates in parallel.
//     A group of more than 64 configs is split by the host into groups
//     that each carry a copy of its histogram. Against the register form
//     over the same configs, per app and event the bin pass and the
//     scalar part run once per group instead of once per config, and a
//     chunk moves one histogram per group instead of one per config;
//   * registers (every selector of the block the identity, a single config
//     among them: one histogram per config; n_bins <= 32 * BPL, BPL 2 or 8
//     bins a lane: the sweep point's 60 bins and the paper's 240; the
//     unfactored kernel over per-config rows): lane L holds bins
//     [L*BPL, (L+1)*BPL) in registers. The raw counts at
//     the bin and the one below come from shuffles (each lane's candidate
//     picked by a tree of selects), the suffix add is per lane, each
//     percentile search is a per-lane first hit and one __reduce_min_sync,
//     and the last prefix sum (the total) is carried in a register. A
//     column in which the row has no event costs one uniform branch. What
//     bounds it: instruction issue, a few hundred instructions a row and
//     column, of which the scalar part (verdict, Welford, windows, gate),
//     the same instructions in every lane, is about half. Rows of 8 lanes
//     (four rows a warp) took as long (their registers left one block an
//     SM), and so did 32 rows a warp with the scalar part a lane each and
//     the histograms in shared memory (its bin passes cost more than the
//     scalar part they spare).
//   * columns (wider rows): the host expands the block to one histogram
//     per config and replays them through the step, one launch a column.
// Every form bins an idle time with a power-of-two width (the paper's
// 1-minute bins) by a multiply with its exact reciprocal, the same double
// as the divide. Bound of a scan over W columns: the columns read once and
// the nine state tensors read and written once (cum included), against the
// least operations of the W steps (chip_smoke.py computes both from the
// data).
//
// Bit-identity hazards and what is done about them:
//   * no contraction: built with -fmad=false, and every rounding op below is
//     an explicitly rounded intrinsic (__fmul_rn, __fsub_rn, __fdiv_rn,
//     __fsqrt_rn, and their double forms); cvss/n - mean*mean must not
//     become a fused op;
//   * floor(it / bin) is clamped in T to [-1, n_bins] before the int
//     conversion (it is +inf on first events);
//   * cum * PCT_SCALE and total * numer stay int32 and wrap around as the
//     reference's do (multiplied as unsigned, so the wrap is defined C++;
//     the host guards the width with MAX_SCALED_COUNT);
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

enum : int { kErrForm = -1 };

struct Cfg {
  int nb, head_numer, tail_numer, min_samples;
  float margin_lo, margin_hi, bin_f, range, cv_thr, oob_thr, std_keep;
  double bin_minutes;
  double inv_bin;  // 1 / bin_minutes, exact where pow2 is set
  bool pow2;       // bin_minutes a power of two: it * inv_bin == it / bin
};

// A power-of-two width (the paper's 1-minute bins) has an exact
// reciprocal, and it * (1 / w) is then the same real number as it / w,
// rounded once: the same double, for one multiply instead of a divide.
// Sets pow2 and returns the reciprocal where it is set.
__device__ __forceinline__ double bin_reciprocal(double bin_minutes,
                                                 bool& pow2) {
  const long long bits = __double_as_longlong(bin_minutes);
  const int expo = (int)((bits >> 52) & 0x7ff);
  pow2 = (bits & 0x000fffffffffffffll) == 0 && expo > 1 && expo < 0x7fe;
  return pow2 ? __ddiv_rn(1.0, bin_minutes) : 0.0;
}

__device__ __forceinline__ Cfg load_cfg(const int* __restrict__ cfg_i32,
                                        const float* __restrict__ cfg_f32,
                                        const double* __restrict__ bin_min,
                                        int s) {
  const int* ci = cfg_i32 + (int64_t)s * kCfgI;
  const float* cf = cfg_f32 + (int64_t)s * kCfgF;
  Cfg c;
  c.nb = ci[0];
  c.head_numer = ci[1];
  c.tail_numer = ci[2];
  c.min_samples = ci[3];
  c.margin_lo = cf[0];
  c.margin_hi = cf[1];
  c.bin_f = cf[2];
  c.range = cf[3];
  c.cv_thr = cf[4];
  c.oob_thr = cf[5];
  c.std_keep = cf[6];
  c.bin_minutes = bin_min[s];
  c.inv_bin = bin_reciprocal(c.bin_minutes, c.pow2);
  return c;
}

// The eight scalars of a (config, app) row.
struct Row {
  double p, pre, ub, cvs, cvss, waste;
  int oob, cold;
};

struct State {
  const double *prev_t, *cv_sum, *cv_sum_sq, *prewarm, *unload_at, *waste;
  const int *oob, *cold;
};

struct Out {
  double *prev_t, *cv_sum, *cv_sum_sq, *prewarm, *unload_at, *waste;
  int *oob, *cold;
};

__device__ __forceinline__ Row load_row(const State& st, int64_t row) {
  Row r;
  r.p = st.prev_t[row];
  r.pre = st.prewarm[row];
  r.ub = st.unload_at[row];
  r.cvs = st.cv_sum[row];
  r.cvss = st.cv_sum_sq[row];
  r.waste = st.waste[row];
  r.oob = st.oob[row];
  r.cold = st.cold[row];
  return r;
}

__device__ __forceinline__ void store_row(const Out& o, int64_t row,
                                          const Row& r) {
  o.prev_t[row] = r.p;
  o.oob[row] = r.oob;
  o.cv_sum[row] = r.cvs;
  o.cv_sum_sq[row] = r.cvss;
  o.prewarm[row] = r.pre;
  o.unload_at[row] = r.ub;
  o.cold[row] = r.cold;
  o.waste[row] = r.waste;
}

// The idle-time bin of one event.
struct Hit {
  bool in_b, oob_hit;
  int safe;   // the bin clipped to [0, nb - 1]
};

// The verdict for a gap of length it (+inf on an app's first event) under
// carried bounds [pre, ub]: the cold count and the waste updated.
__device__ __forceinline__ void verdict(double it, bool first, double pre,
                                        double ub, int& cold,
                                        double& waste) {
  const bool warm = (it >= pre) && (it <= ub);
  const bool is_cold = first || !warm;
  const double gap = first ? 0.0 : fmax(__dsub_rn(fmin(it, ub), pre), 0.0);
  cold += is_cold ? 1 : 0;
  waste = __dadd_rn(waste, gap);
}

// The gap's bin (classify_idle_time) in nb bins of width bin_minutes
// (inv_bin its reciprocal where pow2).
__device__ __forceinline__ Hit classify(double it, bool first, int nb,
                                        bool pow2, double inv_bin,
                                        double bin_minutes) {
  double q = floor(pow2 ? __dmul_rn(it, inv_bin)
                        : __ddiv_rn(it, bin_minutes));
  q = fmin(fmax(q, -1.0), (double)nb);
  const int bin_idx = (int)q;
  Hit h;
  h.in_b = !first && bin_idx >= 0 && bin_idx < nb;
  h.oob_hit = !first && bin_idx >= nb;
  h.safe = min(max(bin_idx, 0), nb - 1);
  return h;
}

// The verdict for the gap that closes at t (finite) under the row's carried
// bounds (cold count and waste updated), and the gap's bin.
__device__ __forceinline__ Hit close_gap(Row& r, double t, const Cfg& c) {
  const bool first = !isfinite(r.p);
  const double it = __dsub_rn(t, r.p);   // +inf on an app's first event
  verdict(it, first, r.pre, r.ub, r.cold, r.waste);
  return classify(it, first, c.nb, c.pow2, c.inv_bin, c.bin_minutes);
}

// int32 product that wraps around as the reference's does
__device__ __forceinline__ int wrap_mul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// The scaled percentile threshold of the post-update total.
__device__ __forceinline__ int pct_threshold(int total, int numer) {
  return max(wrap_mul(total, numer), kPctScale);
}

__device__ __forceinline__ bool reaches(int cum, int thr) {
  return wrap_mul(cum, kPctScale) >= thr;
}

// After the histogram pass, the group part: the Welford accumulators from
// the bin's pre-update raw count, and the out-of-bounds count.
__device__ __forceinline__ void welford(double& cvs, double& cvss, int& oob,
                                        const Hit& h, int raw_old) {
  const double inb = h.in_b ? 1.0 : 0.0;
  cvs = __dadd_rn(cvs, inb);
  cvss = __dadd_rn(cvss, inb * __dadd_rn(2.0 * (double)raw_old, 1.0));
  oob += h.oob_hit ? 1 : 0;
}

// The CV of the nb bin counts, float32 (bin_count_cv).
__device__ __forceinline__ float bin_cv(double cvs, double cvss, int nb) {
  const float nbf = (float)nb;
  const float mean = __fdiv_rn((float)cvs, nbf);
  const float var = fmaxf(
      __fsub_rn(__fdiv_rn((float)cvss, nbf), __fmul_rn(mean, mean)), 0.0f);
  return mean > 0.0f ? __fdiv_rn(__fsqrt_rn(var), fmaxf(mean, 1e-9f))
                     : 0.0f;
}

// The window part: the float32 bounds of percentile bins head and tail,
// products left to right (window_values_from_factors).
__device__ __forceinline__ void window(int head, int tail, float bin_f,
                                       float range, float margin_lo,
                                       float margin_hi, float& load,
                                       float& unload) {
  load = __fmul_rn(__fmul_rn((float)head, bin_f), margin_lo);
  unload = __fmul_rn(fminf(__fmul_rn((float)tail, bin_f), range), margin_hi);
  unload = fmaxf(unload, load);
}

// The gate part: whether the histogram windows govern the next gap
// (use_histogram_gate_from_cv), and in consult whether the scalar policy
// consults the forecaster at this event: enough samples and the OOB counter
// heavy (forecast/replay.py::_branch_scan).
__device__ __forceinline__ bool gate(int total, int oob, float cv,
                                     int min_samples, float cv_thr,
                                     float oob_thr, bool& consult) {
  const int seen = total + oob;
  const bool heavy = (float)oob > __fmul_rn(oob_thr, (float)max(seen, 1));
  consult = seen >= min_samples && heavy;
  return seen >= min_samples && cv >= cv_thr && total > 0 && !heavy;
}

// After the histogram pass: the group part, then the window and the gate;
// the windows govern the row's next gap. Returns the forecaster guard.
__device__ __forceinline__ bool decide(Row& r, double t, const Hit& h,
                                       const Cfg& c, int total, int raw_old,
                                       int head, int tail) {
  welford(r.cvs, r.cvss, r.oob, h, raw_old);
  float load, unload;
  window(head, tail, c.bin_f, c.range, c.margin_lo, c.margin_hi, load,
         unload);
  bool consult;
  const bool use_hist = gate(total, r.oob, bin_cv(r.cvs, r.cvss, c.nb),
                             c.min_samples, c.cv_thr, c.oob_thr, consult);
  r.pre = (double)(use_hist ? load : 0.0f);
  r.ub = (double)(use_hist ? unload : c.std_keep);
  r.p = t;
  return consult;
}

// One pass of a warp over a row whose lane L owns the bins b = L mod 32:
// raw counts at the bin and below (before the add), the suffix add in
// place, both percentile searches. Results are the warp's.
__device__ __forceinline__ void strided_pass(int* crow, int n_bins,
                                             const Hit& h, int head_thr,
                                             int tail_thr, int lane,
                                             int& raw_old, int& head,
                                             int& tail) {
  int at = 0, below = 0;
  head = n_bins;
  tail = n_bins;
  for (int b = lane; b < n_bins; b += 32) {
    int v = crow[b];
    if (b == h.safe) at = v;
    if (b == h.safe - 1) below = v;
    if (h.in_b && b >= h.safe) {
      v += 1;
      crow[b] = v;
    }
    if (head == n_bins && reaches(v, head_thr)) head = b;
    if (tail == n_bins && reaches(v, tail_thr)) tail = b;
  }
  raw_old = __reduce_add_sync(kFull, at) - __reduce_add_sync(kFull, below);
  head = __reduce_min_sync(kFull, head);
  tail = __reduce_min_sync(kFull, tail) + 1;
}

// ---------------------------------------------------------------------------
// One column
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
hybrid_sweep_step_kernel(const double* __restrict__ t_now, State st,
                         int* __restrict__ cum,
                         const int* __restrict__ cfg_i32,
                         const float* __restrict__ cfg_f32,
                         const double* __restrict__ bin_minutes, Out o,
                         int S, int n, int n_bins) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= (int64_t)S * n) return;     // the whole warp leaves together
  const int s = (int)(row / n);
  const int a = (int)(row - (int64_t)s * n);

  const double t = t_now[a];
  Row r = load_row(st, row);
  if (!isfinite(t)) {                    // no event: the state carries over
    if (lane == 0) store_row(o, row, r);
    return;
  }
  const Cfg c = load_cfg(cfg_i32, cfg_f32, bin_minutes, s);
  const Hit h = close_gap(r, t, c);

  // Thresholds from the post-update total: the last prefix sum, plus this
  // hit (safe <= n_bins - 1, so the suffix always covers the last bin).
  int* crow = cum + row * (int64_t)n_bins;
  const int total = crow[n_bins - 1] + (h.in_b ? 1 : 0);
  __syncwarp();                          // every lane read it before writes
  int raw_old, head, tail;
  strided_pass(crow, n_bins, h, pct_threshold(total, c.head_numer),
               pct_threshold(total, c.tail_numer), lane, raw_old, head,
               tail);
  decide(r, t, h, c, total, raw_old, head, tail);
  if (lane == 0) store_row(o, row, r);
}

// ---------------------------------------------------------------------------
// The scan of a chunk: every column, the row on chip
// ---------------------------------------------------------------------------

// The row's event time in column `col`: the columns come 32 at a time,
// lane L loading column 32k + L, and reach the warp by a shuffle, so that
// no load of device memory lies on the chain from one column to the next.
__device__ __forceinline__ double column_time(const double* __restrict__ cols,
                                              int width, int n, int a,
                                              int col, int lane,
                                              double& block) {
  if ((col & 31) == 0) {
    const int k = col + lane;
    block = k < width ? cols[(int64_t)k * n + a] : 0.0;
  }
  return __shfl_sync(kFull, block, col & 31);
}

// v[k] for k = idx % BPL (BPL a power of two), by a tree of selects on the
// bits of idx: a runtime index into v would put v in local memory.
template <int BPL>
__device__ __forceinline__ int pick(const int (&v)[BPL], int idx) {
  int w[BPL];
#pragma unroll
  for (int k = 0; k < BPL; ++k) w[k] = v[k];
#pragma unroll
  for (int step = 1; step < BPL; step <<= 1) {
    const bool hi = idx & step;
#pragma unroll
    for (int k = 0; k < BPL; k += 2 * step) w[k] = hi ? w[k + step] : w[k];
  }
  return w[0];
}

// The register form: lane L holds bins [L*BPL, (L+1)*BPL).
template <int BPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
hybrid_sweep_scan_reg_kernel(const double* __restrict__ cols, int width,
                             State st, int* __restrict__ cum,
                             const int* __restrict__ cfg_i32,
                             const float* __restrict__ cfg_f32,
                             const double* __restrict__ bin_minutes, Out o,
                             bool* __restrict__ consulted, int S, int n,
                             int n_bins) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= (int64_t)S * n) return;     // the whole warp leaves together
  const int s = (int)(row / n);
  const int a = (int)(row - (int64_t)s * n);
  const Cfg c = load_cfg(cfg_i32, cfg_f32, bin_minutes, s);
  Row r = load_row(st, row);

  int* crow = cum + row * (int64_t)n_bins;
  const int b0 = lane * BPL;
  int v[BPL];
#pragma unroll
  for (int k = 0; k < BPL; ++k) v[k] = b0 + k < n_bins ? crow[b0 + k] : 0;
  // the last prefix sum (the in-bounds total), carried from here on
  int last = __shfl_sync(kFull, pick<BPL>(v, n_bins - 1),
                         (n_bins - 1) / BPL);

  double block = 0.0;
  bool consult = false;   // the forecaster consulted at some event column
  for (int col = 0; col < width; ++col) {
    const double t = column_time(cols, width, n, a, col, lane, block);
    if (!isfinite(t)) continue;          // uniform across the warp
    const Hit h = close_gap(r, t, c);
    // the raw counts at the bin and below it, each from its owner lane
    const int at = __shfl_sync(kFull, pick<BPL>(v, h.safe), h.safe / BPL);
    const int below = __shfl_sync(kFull, pick<BPL>(v, h.safe - 1),
                                  max(h.safe - 1, 0) / BPL);
    const int raw_old = at - (h.safe > 0 ? below : 0);
    const int total = last + (h.in_b ? 1 : 0);
    last = total;
    const int head_thr = pct_threshold(total, c.head_numer);
    const int tail_thr = pct_threshold(total, c.tail_numer);
    const int from = h.in_b ? h.safe : 0x7fffffff;   // the suffix to add to
    int head = n_bins, tail = n_bins;
#pragma unroll
    for (int k = BPL - 1; k >= 0; --k) {   // descending: the first hit wins
      const int b = b0 + k;
      v[k] += b >= from ? 1 : 0;
      const bool live = b < n_bins;
      if (live && reaches(v[k], head_thr)) head = b;
      if (live && reaches(v[k], tail_thr)) tail = b;
    }
    head = __reduce_min_sync(kFull, head);
    tail = __reduce_min_sync(kFull, tail) + 1;
    consult |= decide(r, t, h, c, total, raw_old, head, tail);
  }

#pragma unroll
  for (int k = 0; k < BPL; ++k)
    if (b0 + k < n_bins) crow[b0 + k] = v[k];
  if (lane == 0) {
    store_row(o, row, r);
    consulted[row] = consult;
  }
}

// ---------------------------------------------------------------------------
// The factored scan: a group's configs in one warp, the histogram once
// ---------------------------------------------------------------------------

// Column layout of the factored form's blocks
// (kernels/histogram.py::factored_scan_plan).
constexpr int kGrpI = 5;    // n_bins, slot0, slot1, search0, search1
constexpr int kSlotI = 3;   // config row, search, min_samples
// slot f32 columns: the kCfgF layout of the config block

// One config a lane carries: its knobs and its state.
struct Slot {
  bool live;
  int row, search, min_samples;
  float margin_lo, margin_hi, bin_f, range, cv_thr, oob_thr, std_keep;
  double pre, ub, waste;
  int cold;
  bool consult;
};

struct FactoredIn {
  const double *prev_t, *gcvs, *gcvss, *load, *unload, *waste;
  const int *goob, *cold;
  const int *grp_i32, *search_i32, *slot_i32;
  const double* grp_f64;
  const float* slot_f32;
};

struct FactoredOut {
  double *prev_t, *gcvs, *gcvss, *load, *unload, *waste;
  int *goob, *cold;
  bool* consulted;
};

// One warp per (group k, app a): the group's histogram in registers, BPL
// bins a lane as in the register form; lane L carries the group's configs
// L and L + 32 (CPL of them). Per event column, once for the warp: the
// verdicts' shared idle time, the bin, the raw counts by shuffles, the
// suffix add, the total and the Welford sums; then one percentile search
// per distinct (head, tail) numerator pair of the group (a uniform loop:
// a first hit in each lane and two __reduce_min_sync), each lane keeping
// the bins of its configs' pair; then each lane its configs' float32
// windows, gates and bounds, in parallel. Rows of configs (S of them) are
// read and written once, at the configs' own rows (slot_i32's row), so
// the caller's order is kept.
// (a minimum of one block an SM: ptxas's default register target for 256
// threads spilled the <2, 1> instantiation at 80 registers)
template <int BPL, int CPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 1)
hybrid_sweep_scan_factored_kernel(const double* __restrict__ cols, int width,
                                  FactoredIn in, int* __restrict__ gcum,
                                  FactoredOut o, int Gk, int n, int n_bins) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= (int64_t)Gk * n) return;    // the whole warp leaves together
  const int k = (int)(row / n);
  const int a = (int)(row - (int64_t)k * n);
  const int* gi = in.grp_i32 + (int64_t)k * kGrpI;
  const int nb = gi[0], slot0 = gi[1], slot1 = gi[2];
  const int search0 = gi[3], search1 = gi[4];
  const double bin_minutes = in.grp_f64[k];
  bool pow2;
  const double inv_bin = bin_reciprocal(bin_minutes, pow2);

  // the group's percentile numerators, lane L holding search0 + L (+ 32)
  int head_numer[CPL], tail_numer[CPL];
  Slot sl[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int q = search0 + lane + 32 * j;
    head_numer[j] = q < search1 ? in.search_i32[2 * q] : 0;
    tail_numer[j] = q < search1 ? in.search_i32[2 * q + 1] : 0;
    Slot& c = sl[j];
    const int slot = slot0 + lane + 32 * j;
    c.live = slot < slot1;
    c.consult = false;
    if (c.live) {
      const int* si = in.slot_i32 + (int64_t)slot * kSlotI;
      const float* sf = in.slot_f32 + (int64_t)slot * kCfgF;
      c.row = si[0];
      c.search = si[1];
      c.min_samples = si[2];
      c.margin_lo = sf[0];
      c.margin_hi = sf[1];
      c.bin_f = sf[2];
      c.range = sf[3];
      c.cv_thr = sf[4];
      c.oob_thr = sf[5];
      c.std_keep = sf[6];
      const int64_t at = (int64_t)c.row * n + a;
      c.pre = in.load[at];
      c.ub = in.unload[at];
      c.waste = in.waste[at];
      c.cold = in.cold[at];
    } else {
      c.row = c.search = c.min_samples = c.cold = 0;
      c.margin_lo = c.margin_hi = c.bin_f = c.range = 0.0f;
      c.cv_thr = c.oob_thr = c.std_keep = 0.0f;
      c.pre = c.ub = c.waste = 0.0;
    }
  }

  double p = in.prev_t[a];
  int oob = in.goob[row];
  double cvs = in.gcvs[row], cvss = in.gcvss[row];
  int* crow = gcum + row * (int64_t)n_bins;
  const int b0 = lane * BPL;
  int v[BPL];
#pragma unroll
  for (int kk = 0; kk < BPL; ++kk)
    v[kk] = b0 + kk < n_bins ? crow[b0 + kk] : 0;
  int last = __shfl_sync(kFull, pick<BPL>(v, n_bins - 1),
                         (n_bins - 1) / BPL);

  double block = 0.0;
  for (int col = 0; col < width; ++col) {
    const double t = column_time(cols, width, n, a, col, lane, block);
    if (!isfinite(t)) continue;          // uniform across the warp
    const bool first = !isfinite(p);
    const double it = __dsub_rn(t, p);   // +inf on an app's first event
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      if (sl[j].live)
        verdict(it, first, sl[j].pre, sl[j].ub, sl[j].cold, sl[j].waste);
    const Hit h = classify(it, first, nb, pow2, inv_bin, bin_minutes);
    const int at = __shfl_sync(kFull, pick<BPL>(v, h.safe), h.safe / BPL);
    const int below = __shfl_sync(kFull, pick<BPL>(v, h.safe - 1),
                                  max(h.safe - 1, 0) / BPL);
    const int raw_old = at - (h.safe > 0 ? below : 0);
    const int total = last + (h.in_b ? 1 : 0);
    last = total;
    const int from = h.in_b ? h.safe : 0x7fffffff;   // the suffix to add to
#pragma unroll
    for (int kk = 0; kk < BPL; ++kk) v[kk] += b0 + kk >= from ? 1 : 0;
    welford(cvs, cvss, oob, h, raw_old);

    int head[CPL], tail[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) head[j] = tail[j] = n_bins;
    for (int q = search0; q < search1; ++q) {        // uniform
      const int src = (q - search0) & 31;
      const int hn = __shfl_sync(kFull, (q - search0) < 32 ? head_numer[0]
                                 : head_numer[CPL - 1], src);
      const int tn = __shfl_sync(kFull, (q - search0) < 32 ? tail_numer[0]
                                 : tail_numer[CPL - 1], src);
      const int head_thr = pct_threshold(total, hn);
      const int tail_thr = pct_threshold(total, tn);
      int hb = n_bins, tb = n_bins;
#pragma unroll
      for (int kk = BPL - 1; kk >= 0; --kk) {   // descending: first hit wins
        const int b = b0 + kk;
        const bool live = b < n_bins;
        if (live && reaches(v[kk], head_thr)) hb = b;
        if (live && reaches(v[kk], tail_thr)) tb = b;
      }
      hb = __reduce_min_sync(kFull, hb);
      tb = __reduce_min_sync(kFull, tb) + 1;
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        if (sl[j].search == q) {
          head[j] = hb;
          tail[j] = tb;
        }
    }

    const float cv = bin_cv(cvs, cvss, nb);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      Slot& c = sl[j];
      if (!c.live) continue;
      float load, unload;
      window(head[j], tail[j], c.bin_f, c.range, c.margin_lo, c.margin_hi,
             load, unload);
      bool consult;
      const bool use_hist = gate(total, oob, cv, c.min_samples, c.cv_thr,
                                 c.oob_thr, consult);
      c.consult |= consult;
      c.pre = (double)(use_hist ? load : 0.0f);
      c.ub = (double)(use_hist ? unload : c.std_keep);
    }
    p = t;
  }

#pragma unroll
  for (int kk = 0; kk < BPL; ++kk)
    if (b0 + kk < n_bins) crow[b0 + kk] = v[kk];
  if (lane == 0) {
    o.goob[row] = oob;
    o.gcvs[row] = cvs;
    o.gcvss[row] = cvss;
    if (k == 0) o.prev_t[a] = p;
  }
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const Slot& c = sl[j];
    if (!c.live) continue;
    const int64_t at = (int64_t)c.row * n + a;
    o.load[at] = c.pre;
    o.unload[at] = c.ub;
    o.cold[at] = c.cold;
    o.waste[at] = c.waste;
    o.consulted[at] = c.consult;
  }
}

State make_state(const void* prev_t, const void* oob, const void* cv_sum,
                 const void* cv_sum_sq, const void* prewarm,
                 const void* unload_at, const void* cold, const void* waste) {
  State st;
  st.prev_t = (const double*)prev_t;
  st.oob = (const int*)oob;
  st.cv_sum = (const double*)cv_sum;
  st.cv_sum_sq = (const double*)cv_sum_sq;
  st.prewarm = (const double*)prewarm;
  st.unload_at = (const double*)unload_at;
  st.cold = (const int*)cold;
  st.waste = (const double*)waste;
  return st;
}

Out make_out(void* o_prev, void* o_oob, void* o_cvs, void* o_cvss,
             void* o_pre, void* o_unload, void* o_cold, void* o_waste) {
  Out o;
  o.prev_t = (double*)o_prev;
  o.oob = (int*)o_oob;
  o.cv_sum = (double*)o_cvs;
  o.cv_sum_sq = (double*)o_cvss;
  o.prewarm = (double*)o_pre;
  o.unload_at = (double*)o_unload;
  o.cold = (int*)o_cold;
  o.waste = (double*)o_waste;
  return o;
}

template <int BPL>
void launch_reg(cudaStream_t stream, const double* cols, int width,
                const State& st, int* cum, const int* ci, const float* cf,
                const double* bm, const Out& o, bool* consulted, int S,
                int n, int n_bins) {
  const int64_t blocks =
      ((int64_t)S * n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  hybrid_sweep_scan_reg_kernel<BPL><<<(unsigned)blocks, kWarpsPerBlock * 32,
                                      0, stream>>>(
      cols, width, st, cum, ci, cf, bm, o, consulted, S, n, n_bins);
}

template <int BPL, int CPL>
void launch_factored(cudaStream_t stream, const double* cols, int width,
                     const FactoredIn& in, int* gcum, const FactoredOut& o,
                     int Gk, int n, int n_bins) {
  const int64_t blocks =
      ((int64_t)Gk * n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  hybrid_sweep_scan_factored_kernel<BPL, CPL>
      <<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
          cols, width, in, gcum, o, Gk, n, n_bins);
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
      (const double*)t_now,
      make_state(prev_t, oob, cv_sum, cv_sum_sq, prewarm, unload_at, cold,
                 waste),
      (int*)cum, (const int*)cfg_i32, (const float*)cfg_f32,
      (const double*)bin_minutes,
      make_out(o_prev, o_oob, o_cvs, o_cvss, o_pre, o_unload, o_cold,
               o_waste),
      S, n, n_bins);
  return (int)cudaGetLastError();
}

// Launch the scan of `width` columns (cols [width, n] float64) on `stream`
// in the register form, `bpl` bins a lane (2 or 8; n_bins <= 32 * bpl).
// Besides the eight scalars it writes `consulted` [S, n] (bool): whether
// the forecaster guard held at some event column of the row. Returns 0, a
// CUDA error code or kErrForm.
int hybrid_sweep_scan(
    const void* cols, int width, const void* prev_t, void* cum,
    const void* oob, const void* cv_sum, const void* cv_sum_sq,
    const void* prewarm, const void* unload_at, const void* cold,
    const void* waste, const void* cfg_i32, const void* cfg_f32,
    const void* bin_minutes, void* o_prev, void* o_oob, void* o_cvs,
    void* o_cvss, void* o_pre, void* o_unload, void* o_cold, void* o_waste,
    void* consulted, int S, int n, int n_bins, int bpl, void* stream) {
  const int64_t rows = (int64_t)S * n;
  if (rows == 0) return 0;
  if (n_bins > 32 * bpl) return kErrForm;
  const State st = make_state(prev_t, oob, cv_sum, cv_sum_sq, prewarm,
                              unload_at, cold, waste);
  const Out o = make_out(o_prev, o_oob, o_cvs, o_cvss, o_pre, o_unload,
                         o_cold, o_waste);
  const double* c = (const double*)cols;
  int* cm = (int*)cum;
  const int* ci = (const int*)cfg_i32;
  const float* cf = (const float*)cfg_f32;
  const double* bm = (const double*)bin_minutes;
  bool* fl = (bool*)consulted;
  cudaStream_t sm = (cudaStream_t)stream;
  switch (bpl) {
    case 2: launch_reg<2>(sm, c, width, st, cm, ci, cf, bm, o, fl, S, n,
                          n_bins); break;
    case 8: launch_reg<8>(sm, c, width, st, cm, ci, cf, bm, o, fl, S, n,
                          n_bins); break;
    default: return kErrForm;
  }
  return (int)cudaGetLastError();
}

// Launch the factored scan of `width` columns (cols [width, n] float64) on
// `stream`: Gk groups, each a warp per app (grp_i32 [Gk, 5]: n_bins, its
// configs' slot range, its searches' range; grp_f64 [Gk]: bin width),
// search_i32 [*, 2] (head, tail numerators), slot_i32 [S, 3] (config row,
// search, min_samples), slot_f32 [S, 7] (the config block's float32
// columns). State: prev_t [n], gcum [Gk, n, n_bins] int32 (in place),
// goob/gcvs/gcvss [Gk, n]; per config load/unload/cold/waste [S, n]; out
// the same and consulted [S, n]. `bpl` bins a lane (2 or 8; n_bins <= 32 *
// bpl), `cpl` configs a lane (1 or 2; a group's configs <= 32 * cpl, which
// the host guarantees). Returns 0, a CUDA error code or kErrForm.
int hybrid_sweep_scan_factored(
    const void* cols, int width, const void* prev_t, void* gcum,
    const void* goob, const void* gcvs, const void* gcvss,
    const void* load_c, const void* unload_c, const void* cold,
    const void* waste, const void* grp_i32, const void* grp_f64,
    const void* search_i32, const void* slot_i32, const void* slot_f32,
    void* o_prev, void* o_goob, void* o_gcvs, void* o_gcvss, void* o_load,
    void* o_unload, void* o_cold, void* o_waste, void* consulted, int Gk,
    int n, int n_bins, int bpl, int cpl, void* stream) {
  if (n_bins > 32 * bpl || (bpl != 2 && bpl != 8) || (cpl != 1 && cpl != 2))
    return kErrForm;
  if ((int64_t)Gk * n == 0) return 0;
  FactoredIn in;
  in.prev_t = (const double*)prev_t;
  in.goob = (const int*)goob;
  in.gcvs = (const double*)gcvs;
  in.gcvss = (const double*)gcvss;
  in.load = (const double*)load_c;
  in.unload = (const double*)unload_c;
  in.cold = (const int*)cold;
  in.waste = (const double*)waste;
  in.grp_i32 = (const int*)grp_i32;
  in.grp_f64 = (const double*)grp_f64;
  in.search_i32 = (const int*)search_i32;
  in.slot_i32 = (const int*)slot_i32;
  in.slot_f32 = (const float*)slot_f32;
  FactoredOut o;
  o.prev_t = (double*)o_prev;
  o.goob = (int*)o_goob;
  o.gcvs = (double*)o_gcvs;
  o.gcvss = (double*)o_gcvss;
  o.load = (double*)o_load;
  o.unload = (double*)o_unload;
  o.cold = (int*)o_cold;
  o.waste = (double*)o_waste;
  o.consulted = (bool*)consulted;
  const double* c = (const double*)cols;
  int* cm = (int*)gcum;
  cudaStream_t sm = (cudaStream_t)stream;
  if (bpl == 2 && cpl == 1)
    launch_factored<2, 1>(sm, c, width, in, cm, o, Gk, n, n_bins);
  else if (bpl == 2)
    launch_factored<2, 2>(sm, c, width, in, cm, o, Gk, n, n_bins);
  else if (cpl == 1)
    launch_factored<8, 1>(sm, c, width, in, cm, o, Gk, n, n_bins);
  else
    launch_factored<8, 2>(sm, c, width, in, cm, o, Gk, n, n_bins);
  return (int)cudaGetLastError();
}

const char* hybrid_error_string(int code) {
  if (code == kErrForm)
    return "bad scan form (2 or 8 bins a lane covering n_bins; 1 or 2 "
           "configs a lane)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
