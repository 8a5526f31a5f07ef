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
// scalar part of that (close_gap, decide) is one set of device functions
// that every kernel here calls, as policy_math.py is the one source of it
// in Python.
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
// time, one load a lane, and reach the warp by shuffles. The host picks
// the form from n_bins (kernels/histogram.py::scan_form):
//   * registers (n_bins <= 32 * BPL, BPL 2 or 8 bins a lane: the sweep
//     point's 60 bins and the paper's 240): lane L holds bins
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
//   * columns (wider rows): the host replays them through the step, one
//     launch a column.
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
  // A power-of-two width (the paper's 1-minute bins) has an exact
  // reciprocal, and it * (1 / w) is then the same real number as it / w,
  // rounded once: the same double, for one multiply instead of a divide.
  const long long bits = __double_as_longlong(c.bin_minutes);
  const int expo = (int)((bits >> 52) & 0x7ff);
  c.pow2 = (bits & 0x000fffffffffffffll) == 0 && expo > 1 && expo < 0x7fe;
  c.inv_bin = c.pow2 ? __ddiv_rn(1.0, c.bin_minutes) : 0.0;
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

// The verdict for the gap that closes at t (finite) under the row's carried
// bounds (cold count and waste updated), and the gap's bin
// (classify_idle_time).
__device__ __forceinline__ Hit close_gap(Row& r, double t, const Cfg& c) {
  const bool first = !isfinite(r.p);
  const double it = __dsub_rn(t, r.p);   // +inf on an app's first event
  const bool warm = (it >= r.pre) && (it <= r.ub);
  const bool is_cold = first || !warm;
  const double gap =
      first ? 0.0 : fmax(__dsub_rn(fmin(it, r.ub), r.pre), 0.0);
  double q = floor(c.pow2 ? __dmul_rn(it, c.inv_bin)
                          : __ddiv_rn(it, c.bin_minutes));
  q = fmin(fmax(q, -1.0), (double)c.nb);
  const int bin_idx = (int)q;
  Hit h;
  h.in_b = !first && bin_idx >= 0 && bin_idx < c.nb;
  h.oob_hit = !first && bin_idx >= c.nb;
  h.safe = min(max(bin_idx, 0), c.nb - 1);
  r.cold += is_cold ? 1 : 0;
  r.waste = __dadd_rn(r.waste, gap);
  return h;
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

// After the histogram pass: the Welford accumulators from the bin's
// pre-update raw count, the out-of-bounds count, the float32 windows (left
// to right) and the gate; the windows govern the row's next gap. Returns
// whether the scalar policy consults the forecaster at this event: enough
// samples and the OOB counter heavy (forecast/replay.py::_branch_scan).
__device__ __forceinline__ bool decide(Row& r, double t, const Hit& h,
                                       const Cfg& c, int total, int raw_old,
                                       int head, int tail) {
  const double inb = h.in_b ? 1.0 : 0.0;
  r.cvs = __dadd_rn(r.cvs, inb);
  r.cvss = __dadd_rn(r.cvss, inb * __dadd_rn(2.0 * (double)raw_old, 1.0));
  r.oob += h.oob_hit ? 1 : 0;

  const float load =
      __fmul_rn(__fmul_rn((float)head, c.bin_f), c.margin_lo);
  float unload =
      __fmul_rn(fminf(__fmul_rn((float)tail, c.bin_f), c.range), c.margin_hi);
  unload = fmaxf(unload, load);

  const float nbf = (float)c.nb;
  const float mean = __fdiv_rn((float)r.cvs, nbf);
  const float var = fmaxf(
      __fsub_rn(__fdiv_rn((float)r.cvss, nbf), __fmul_rn(mean, mean)), 0.0f);
  const float cv = mean > 0.0f
      ? __fdiv_rn(__fsqrt_rn(var), fmaxf(mean, 1e-9f)) : 0.0f;
  const int seen = total + r.oob;
  const bool heavy =
      (float)r.oob > __fmul_rn(c.oob_thr, (float)max(seen, 1));
  const bool use_hist =
      seen >= c.min_samples && cv >= c.cv_thr && total > 0 && !heavy;

  r.pre = (double)(use_hist ? load : 0.0f);
  r.ub = (double)(use_hist ? unload : c.std_keep);
  r.p = t;
  return seen >= c.min_samples && heavy;
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

const char* hybrid_error_string(int code) {
  if (code == kErrForm)
    return "bad scan form (2 or 8 bins a lane, covering n_bins)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
